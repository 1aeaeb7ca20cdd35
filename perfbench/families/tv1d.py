"""1-D total-variation denoising of Boyd et al.'s ``total_variation.m``.

Instances: the example's signal at length n: x0 = 1, then ``jumps`` times
x0[ceil(idx/2) - 1 : idx] *= k with idx uniform in 1..n and k uniform in
1..``max_level``; s = x0 + ``noise`` N(0, 1).  A pool of them is drawn on
the card at set-up in a few large calls from the configuration's
``base_seed``; the run's seed then flips the sign of each signal (the
problem is odd, so the solution and every step flip alike), so every
seed gets the same work in another order.  lam is the configuration's.

Traffic ``kind``: ``solve`` calls ``admm_tpu_torch.totalvariation`` on
one signal a request.
"""

from __future__ import annotations

import torch

from benchlib import roofline
from families.common import Outcome, Spec, admm_config, rounds
from reference.tv1d import admm_tv


class Pool:
    def __init__(self, S, device):
        self.S, self.device = S, device


def make_pool(config, traffic, seed, device):
    P, n, J = traffic["pool"], config["n"], config["jumps"]
    dt = getattr(torch, config["dtype"])
    g = torch.Generator(device=device)
    g.manual_seed(config["base_seed"])
    idx = torch.randint(1, n + 1, (P, J, 1), generator=g, device=device)
    k = torch.randint(1, config["max_level"] + 1, (P, J, 1), generator=g, device=device)
    pos = torch.arange(n, device=device)
    inside = (pos >= (idx + 1) // 2 - 1) & (pos < idx)
    x0 = torch.where(inside, k, 1).to(dt).prod(dim=1)
    S = x0 + config["noise"] * torch.randn((P, n), generator=g, device=device, dtype=dt)
    g.manual_seed(seed)
    S *= torch.randint(0, 2, (P, 1), generator=g, device=device, dtype=dt) * 2 - 1
    return Pool(S, device)


def requests(config, traffic, seed, pool):
    for i, entry in enumerate(rounds(seed, traffic["pool"])):
        yield Spec(i, entry, config["lambda"])


def port(config, traffic, **changes):
    from admm_tpu_torch import totalvariation

    if traffic["kind"] != "solve":
        raise ValueError(f"tv1d has no traffic kind {traffic['kind']!r}")
    cfg = admm_config(config, **changes)
    opts = config.get("entry", {}).get("solve", {})

    def call(pool, spec):
        res = totalvariation(pool.S[spec.entry], spec.lam, cfg, device=pool.device, **opts)
        return Outcome(res.xopt[None], res.zopt[None], res.uopt[None], [res.steps],
                       res.runtime, bool(res.diverged))
    return call


def reference(config, pool, spec, stop_at=None, precision="float64"):
    return admm_tv(pool.S[spec.entry][None], [spec.lam], rho=config["rho"],
                   abstol=config["abstol"], reltol=config["reltol"],
                   maxiters=config["maxiters"], stop_at=stop_at, precision=precision)


def controls(config, traffic):
    """The control in the port's place: the reference computed in
    bfloat16.  The solve has no matrix product, so TF32 would change
    nothing; bfloat16 is the nearest precision below float32 that does."""

    def reference_bf16(pool, spec):
        x, z, u, steps = reference(config, pool, spec, precision="bfloat16")
        return Outcome(x, z, u, steps, 0.0)

    return {"reference_bf16": reference_bf16}


def layer_cost(layer, config, lanes):
    n = config["n"]
    costs = {"k4": lambda: roofline.tridiagonal_solve(n, lanes),
             "step": lambda: roofline.tv_step(n, lanes)}
    return costs[layer]() if layer in costs else None


def working_set(config):
    n = config["n"]
    return (f"working set: s, x, z, u and the solve's arrays, under 10 MB at n = {n} "
            f"(~{40 * n * 4 / 1e6:.1f} MB) against a {roofline.L2_BYTES / 2**20:.0f} MiB L2: "
            f"L2-resident, so HBM bandwidth bounds it loosely")


def counters():
    """The port's launch counter of K4, keyed by a part of its kernel's name."""
    from admm_tpu_torch.ops import tridiag

    return {"cr_tile": tridiag.cr_solve.launches}
