#!/usr/bin/env python3
"""Smoke run of the PyTorch port (admm_tpu_torch) on one CUDA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the port's GPU kernels from the sources in this checkout, checks
each against its plain PyTorch version, then drives the port's main paths
through the functions a user calls and checks what comes out:

  1. device: nvidia-smi's name and power limit, torch's device name;
  2. K1: the z/u mode of the CUDA C++ kernel ``csrc/zu_tail.cu`` against
     ``_fused_torch`` at several sizes in f32 and f64 (bar: bit-for-bit
     equal), and its time against the plain version's at n = 5000;
  2b. K1b: the tail mode of the same kernel (``fused_zu_tail``: the z/u
     pass with the engine's norms, flags, history write and freeze select
     in one launch) against ``_fused_zu_tail_torch`` at n in {1, 7, 1000,
     5000, 70000}, f32 and f64 (70000 reduces through the ticket, the
     others in one cluster), on a stepping state, a stopping one, the
     last step, frozen ones (done, k = N), nodualerror, domaxiters and a
     NaN under nanguard (bars: x, z, u, state bit for bit; the four norms
     within 1e-5 relative in f32 and 1e-12 in f64; flags and history slot
     equal, the cases built away from pnorm = perr ties; only that slot
     written; the same bits from two launches), and its time per call at
     n = 5000 f32 against the plain version's;
  3. K4: the CUDA C++ cyclic-reduction kernel (``cr_solve``) against
     ``_cr_solve_torch`` in f32 and f64 on the TV system and on a random
     diagonally dominant one, pure masked and with the hybrid dense tail
     (bar: bit-for-bit equal; the tail is the same torch.matmul call on
     the same contiguous operand in both), at the tile boundaries of the
     hybrid form too, and its time per solve against the plain version's
     at (B, n) = (1, 8192), (1, 65536), (128, 8192);
  4. the LASSO slice (the headline fat LASSO, 1500 x 5000 in float32):
     (a) 16384 steps under domaxiters, unroll 64, fused kernel: steps ==
         16384, K1b launched >= 16384 times in this run, finite xopt of
         shape (5000,);
     (b) the same without the kernel: max|xopt_a - xopt_b| <= 1e-6 ||xopt||_inf;
     (c) steps to an RMS primal residual of 1e-6 from (a)'s history,
         equal within one step to a NumPy float64 run of the same update
         sequence;
     (d) a converging run (maxiters 2000, unroll 16): steps < 2000 and
         equal with and without the kernel, or within one with the
         pnorm/perr margin of the deciding step printed (K1b sums its norms
         in another order than torch); and the same solve through a user
         ``fused_zu`` hook that calls ``fused_soft_threshold_dual`` (the
         engine's generic tail with the z/u mode, K1's path), the z/u mode
         launched at least once per step;
     (e) iter/s of (a) and (b), best of 3 each, taken in turns;
  5. the TV slice (1-D staircase signal + 0.5 noise, lambda 0.5, float32):
     (f) n = 65536, solver 'auto' (the hybrid cyclic reduction),
         maxiters 2000, standard stop: K4 launched at least once per
         step, finite xopt of shape (65536,), steps equal within one to
         a NumPy float64 run of the same update sequence;
     (g) the same run with the b-phase in the plain PyTorch version on
         the card: equal steps, max|xopt_f - xopt_g| <= 1e-6 ||xopt||_inf;
     (h) n = 8192, pure masked cyclic reduction: as (f) and (g), with
         xopt bit for bit equal between the two;
     (i) iter/s of (f) and (g), best of 3 each, taken in turns over
         2000 steps under domaxiters ((f) itself stops within ~50);
     (j) 2-D TV of a 512 x 512 blocky image: converges before maxiters,
         finite, and lowers the objective below the noisy image's;
  6. K2: the CUDA C++ GEMV-pair kernel (``gemv_pair``) against
     ``_gemv_pair_torch`` at (m, n) in {(1, 1), (7, 33), (48, 160),
     (1500, 5000), (5000, 1500)}, K in {1, 64}, f32 and bf16 streams, on
     the GEMV-pair probe's draws (for K = 64 with D^T = E^T / lambda_max,
     a chain that contracts onto one direction; ``k2_operands``) (bars:
     K = 1 max|dx| <= 1e-5 ||x||_inf in f32 and 1e-3 in bf16; K = 64
     ||dx|| / ||x|| <= 1e-4 in f32 and 2e-2 in bf16); at (1500, 5000) the
     same bits from three launches (K = 1 and 64, f32 and bf16) and, with
     bf16 streams, from an f32 b and from b rounded to bf16 beforehand;
     its time against the plain version's (CUDA events) at (1500, 5000)
     for K = 1 and K = 64 in f32 and bf16, and against
     ``torch.linalg.multi_dot([Dt, E, b])`` in f32, the one library call
     for the pair (timed as a yardstick; the port never calls it);
  7. K3: the resident fat-LASSO kernel (``resident_lasso``) through the
     prototype's entry point (``experiments/resident_iter_proto.run``:
     the headline problem, K = 64, then 8 chained launches): z and u
     against a NumPy f64 run and against ``_resident_lasso_torch`` on the
     card (bar: max|dz| <= 1e-4 ||z||_inf, same for u), and a relaunch
     from the same state giving the same bits; its history
     against run (a)'s first 64 pnorm^2 (relative 1e-3 where pnorm^2 >=
     1e-7 pnorm^2[0], and |sqrt(pn2) - pnorm| <= 1e-3 pnorm + 1e-6 ||xopt||
     at every step); µs per step of K3 and of the plain loop;
  8. the bf16-stream slice (the headline problem with
     ``stream_dtype=torch.bfloat16``):
     (k) 16384 steps under domaxiters, unroll 64: steps == 16384, K2
         launched >= 16384 times, finite xopt of shape (5000,) on the card,
         ||xopt_k - xopt_a|| <= 2e-2 ||xopt_a||;
     (l) iter/s, best of 3 over 4096 steps, bf16 and f32 taken in turns;
     (m) elasticnet (alpha 0.5), nnls and grouplasso (50 equal groups),
         maxiters 2000, the standard stop, in f32 and with bf16 streams:
         the f32 run converges before maxiters; the bf16 run is finite,
         launches K2 at least once per step, and its objective is within
         2e-2 of the f32 run's (relative to the f32 objective; for NNLS,
         whose optimum on a fat D is ~0, relative to the objective at
         z = 0).  The bf16 run's steps are printed, not held to the stop:
         the default tolerances lie below bf16's noise floor, as
         admm_tpu's own bf16 runs show.
  9. the engine variants (slice 2) on the headline problem, maxiters 2000,
     unroll 16:
     (n) rbadaptive lasso with the fused hook: K1's z/u mode launched at
         least once per step and K1b never; steps equal within one, and
         rho_final equal, to the solve without the kernel (the margin of
         the deciding step printed) and to the solve with the z/u mode's
         plain version; max|dxopt| <= 1e-5 ||xopt||_inf against both;
     (o) anderson=5 with the fused hook: K1 once per step, converges
         before maxiters, objective within 1e-4 of (d)'s plain solve;
     (p) fast weak and fasttype='strong' with bf16 streams: K2 once per
         step; dvals, avals and restarted (strong: avals) recorded;
         ||dxopt|| / ||xopt|| <= 2e-2 against f32 streams, for strong
         over its first STRONG_STEPS steps (alg 1 has no restart and LASSO
         is not strongly convex, so its run drifts in any precision);
     (q) adaptive rho with convtest and stopcond 'both', stopcond
         'hnorm', stallwindow 20, record_iterates over 200 steps under
         domaxiters and quiet=False: finite, traces of the expected
         shapes, rho moved, one printed row per step;
     (r) the synchronising calls of (n)-(p), counted with
         torch.cuda.set_sync_debug_mode("warn"): none inside a sub-step,
         at most one per chunk plus SYNCS_OUTSIDE outside the loop.
 10. the families of slices 3 and 4 at admm_tpu/benchmarks/matrix.py's
     sizes in f32, each timed over FAMILY_TIMED_STEPS steps under
     domaxiters (unroll 'auto'; the fused lasso over FL_TIMED_STEPS) and
     held to matrix.py's f32 oracle bars (its oracle settings ORACLE:
     abstol 1e-7, reltol 1e-6, stall window 100):
     (s) basis pursuit, D 512 x 2048, x_true 10% nonzero, s = D x_true:
         the reference tester's rules, ||xopt||_1 <= ||x_true||_1 and
         mean|(D xopt - s) / D xopt| <= 1e-4 (matrix.py's f32 bar);
         ||xopt_f32 - xopt_f64|| <= 1e-3 ||xopt_f64|| against the same
         solve in f64 on the card (the stall window stops both at one step
         short of the optimum, so this measures f32's drift along the
         path); ||xopt - x_true|| / ||x_true|| printed (L1 does not
         recover x_true at this density);
     (t) the fused lasso on matrix.py's staircase, n = 8192, lam1 0.1,
         lam2 0.5: lam2 = 0 within 1e-3 of the closed-form soft threshold,
         lam1 = 0 within 2e-2 of the port's totalvariation (relative
         norms);
     (u)-(w) LAD, Huber fitting and quantile regression (tau 0.8), D
         4096 x 512, s N(0, 1): objective within 1e-2, 1e-3 and 1e-2 of
         the same solve in f64 on the card;
     (x) the linear SVM (hinge, C = 1), D 4096 x 512, ell = sign(D w0 +
         0.1 noise): objective within 1e-3 of f64 on the card;
     (y) the SVM oracle of tests/test_linearsvm.py (128 + 128 points,
         separation 0.5), hinge and 0-1 loss: slope error <= 0.05 and an
         objective below the one at x = [1, -1].
     Every run of (s)-(y) on the main path: xopt on the card, no K1-K4
     launch (these families run the generic step and no kernel), no
     synchronising call inside a sub-step and at most one per chunk plus
     SYNCS_OUTSIDE.
 11. slice 5 and the spectral half of slice 7 at matrix.py's widths in
     f32 (``programs_phase``), the timed runs under domaxiters with unroll
     'auto', the others at ORACLE:
     (z1), (z2) the LP, n = 1024, D |N(0, 1)| with n/2 rows (matrix.py's
         square D is printed beside: its f32 solve diverges), s = D |x|,
         b in [0.5, 1.5), kkt_mode 'affine' and 'chol', PROGRAM_TIMED_STEPS
         timed steps: objective within 1e-4 of f64 on the card;
     (z3) the standard-form QP, P = G G^T + n I, D N(0, 1)/sqrt(n), n/2
         rows (the square D printed beside), and (z4) the bounded QP,
         n = 2048, box [-1, 1]: x within 5e-3 of f64 on the card;
     (z5) covariance selection, D (4n, n) N(0, 1), lambda 0.1, n = 256,
         eigh and ns, and (z6) n = 512, ns, ns_fast (ns_iters 14) and
         eigh: each objective within 1e-3 of the same solve in f64 on the
         card, ns and ns_fast within 1e-3 of eigh on the card, with the
         float32 matmul mode that matmul_precision('default') selects
         measured and printed;
     (z7) the max-cut SDP (A = 'diag', 10% edges, n = 512), eigh and ns
         (ns_iters 16): Z within 1e-4 of the same steps in f64 on the card;
         (z8) the dense SDP, random_sdp_instance(128, 512, 32): Z within
         1e-3 of the same steps in f64, A(X) = b within 1e4 eps of
         rounding in f32 and f64; for both, one f32 PSD projection within
         1e-5 of f64, torch's own f32 eigh and a bf16 input printed beside
         as controls;
     (z9) matrix.py's SDP gap on random_sdp_instance(16, 24, 6): eigh
         within 1e-3, ns (ns_iters 30) within 1e-2;
     (z10) matrix.py's badly scaled LP (48 x 144, scales 10^+-2) with
         precondition=True within 2e-3 of scipy's HiGHS optimum, the steps
         without preconditioning printed.
     Every run on the main path: xopt on the card, no K1-K4 launch, no
     synchronising call inside a sub-step except the eigh proxes' (one
     each, cuSOLVER's info read back; counted and printed, not held), at
     most one per chunk plus SYNCS_OUTSIDE outside.

Kernel times are device times: CUDA events around replays of a CUDA
graph that holds several calls (``graph_ms``), so that the host's time per
call, which the short calls would otherwise show, drops out; the
host-issued times are printed beside them.  Every failed check raises, so
the script exits non-zero.  It prints, on
lines before the last, the card's name and power limit and one JSON line
``{"kernels": [...]}`` with each kernel's launches on its main path, its
error against its plain version, its time, the plain version's, the
library call's where there is one, and its bound: the larger of the bytes
it must move (each input read once, each output written once) over
3.35 TB/s and its operations over 67 TFLOP/s (f32 outside the tensor
cores), the H100 SXM's data-sheet peaks; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, printing no result, when no CUDA device is visible.
The CUDA kernels build into build/kernels/ in the checkout.
"""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
KERNEL_SIZES = (64, 1000, 5000, 8192, 70000, 2**20)
HEADLINE_STEPS = 16384
# K4 cases: (lanes, n, dense_cutoff).
K4_CASES = ([(1, n, None) for n in (1, 2, 3, 7, 64, 255, 1000, 8192)]
            + [(8, 8192, None), (128, 8192, None), (1, 5000, 63), (1, 65536, 1023)]
            # The tile boundaries of the hybrid form (tiles of 512 rows or
            # more, halo 2^k - 1), the batched lanes, and one lane too long
            # for shared memory in f64.
            + [(1, 3077, 63), (3, 3072, 63), (1, 2049, 7), (3, 65537, 1023),
               (128, 8192, 1023), (3, 20000, None)])
# Timed K4 shapes: TV (h)'s pure masked solve, TV (f)'s hybrid solve (the
# one the JSON line reports), and the batched TV lanes' hybrid solve.
K4_TIMED = ((1, 8192, None), (1, 65536, 1023), (128, 8192, 1023))
TV_MAXITERS = 2000
TV_TIMED_STEPS = 2000
TV_LAM = 0.5
K1B_SIZES = (1, 7, 1000, 5000, 70000)
K1B_N = 12  # maxiters of K1b's test state
K2_SHAPES = ((1, 1), (7, 33), (48, 160), (1500, 5000), (5000, 1500))
K2_DEEP = 64
BF16_TIMED_STEPS = 4096
FAMILY_MAXITERS = 2000
VARIANT_MAXITERS = 2000  # slice 2's runs (n)-(q)
STRONG_STEPS = 10  # (p): alg 1's bar, before its momentum's drift dominates
RECORD_STEPS = 200  # (q): record_iterates under domaxiters
SYNCS_OUTSIDE = 64  # (r): the set-up's and the results' synchronising calls
# (s), (u)-(x): matrix.py times these rows over 8000 steps; cut to 2000 to
# keep the script's time (each generic step issues ~70 launches from the
# host).
FAMILY_TIMED_STEPS = 2000
FL_TIMED_STEPS = 2000  # (t): matrix.py's dense-TV rows at this width run 500-8000
BP_SHAPE = (512, 2048)
REG_SHAPE = (4096, 512)
FL_N = 8192
# matrix.py's f32 oracle settings (accuracy_matrix, _beyond_reference_accuracy).
ORACLE = dict(maxiters=20000, abstol=1e-7, reltol=1e-6, stallwindow=100, unroll="auto")
# (z1)-(z10): matrix.py's widths; its timed steps cut to keep the script's
# time (LP 16000 and bounded QP 8000 to 2000).
LP_N = 1024
QPB_N = 2048
PROGRAM_TIMED_STEPS = 2000
COVSEL_N = (256, 512)  # (z5) eigh and ns, (z6) ns and ns_fast against eigh
COVSEL_TIMED_STEPS = 200
SDP_DIAG_N = 512
SDP_DIAG_TIMED_STEPS = 40
SDP_DENSE = (128, 512, 32)
SDP_DENSE_TIMED_STEPS = 100
# H100 SXM peaks from NVIDIA's data sheet.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound(nbytes, flops):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move ``nbytes`` and do ``flops`` f32 operations, whichever is
    longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")
    print(f"  ok: {what}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device time of one call of fn over reps calls (CUDA events),
    after a warm-up."""
    import torch

    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_phase(dev):
    """K1, the z/u mode of ``csrc/zu_tail.cu``, against its plain version;
    returns (max_abs_err, ms, plain_ms, (bound_ms, bound_by))."""
    import torch

    from admm_tpu_torch.benchmarks.timing import graph_ms
    from admm_tpu_torch.ops.kernels import _fused_torch, fused_soft_threshold_dual

    print("kernel: fused_soft_threshold_dual (CUDA C++, z/u mode) vs _fused_torch")
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for n in KERNEL_SIZES:
            rng = np.random.default_rng(n)
            x = torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)
            u = torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)
            t = torch.tensor(0.37, dtype=dtype, device=dev)
            z_k, u_k = fused_soft_threshold_dual(x, u, t)
            torch.cuda.synchronize()
            z_t, u_t = _fused_torch(x, u, t)
            dz = float(torch.max(torch.abs(z_k - z_t)))
            du = float(torch.max(torch.abs(u_k - u_t)))
            print(f"  {str(dtype):14s} n={n:8d}  max_abs_diff z={dz:.3e} u'={du:.3e}")
            check(dz == 0.0 and du == 0.0 and torch.isfinite(z_k).all(),
                  f"kernel == twin bit for bit ({dtype}, n={n})")
            worst = max(worst, dz, du)

    n = 5000  # the headline's vector length, f32
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(n)).to(dev, torch.float32)
    u = torch.from_numpy(rng.standard_normal(n)).to(dev, torch.float32)
    t = torch.tensor(0.37, dtype=torch.float32, device=dev)
    kernel = lambda: fused_soft_threshold_dual(x, u, t)  # noqa: E731
    plain = lambda: _fused_torch(x, u, t)  # noqa: E731
    host = [time_ms(f, 2000) for f in (kernel, plain, plain, kernel)]
    dev_t = [graph_ms(f, 2000) for f in (kernel, plain, plain, kernel)]
    # x, u and t in, z and u out; |v| - t, max, sign, product, two adds.
    bound_ms = bound(4 * n * 4 + 4, 6 * n)
    print(f"  n=5000 f32 per call, device (graph replay): kernel {dev_t[0]:.6f} / "
          f"{dev_t[3]:.6f} ms, plain {dev_t[1]:.6f} / {dev_t[2]:.6f} ms; host-issued: "
          f"kernel {host[0]:.5f} / {host[3]:.5f} ms, plain {host[1]:.5f} / {host[2]:.5f} ms "
          f"(CUDA events, 2000 calls each); bound {bound_ms[0]:.6f} ms ({bound_ms[1]})")
    return worst, min(dev_t[0], dev_t[3]), min(dev_t[1], dev_t[2]), bound_ms


def _same(a, b):
    """Equal values, NaN where the other has NaN."""
    import torch

    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


# K1b's checks: (state k, done, abstol, the tail's flags, a NaN in x_new).
K1B_CASES = {
    "step": (3, 0, 1e-4, {}, False),
    "stop": (3, 0, 1e3, {}, False),
    "last": (K1B_N - 1, 0, 1e-4, {}, False),
    "done": (3, 1, 1e-4, {}, False),
    "k = N": (K1B_N, 0, 1e-4, {}, False),
    "nodualerror": (3, 0, 1e3, {"nodualerror": True}, False),
    "domaxiters": (3, 0, 1e3, {"domaxiters": True}, False),
    "nan": (3, 0, 1e-4, {}, True),
}


def k1b_inputs(dev, dtype, n, k, done, abstol, nan, seed=0):
    """One K1b call's operands from a seed: (x_new, x, z, u, lam, rho,
    state, hist) and the tail's tolerances."""
    import torch

    rng = np.random.default_rng(seed + n)
    vecs = [torch.from_numpy(rng.standard_normal(n)).to(dev, dtype) for _ in range(4)]
    if nan:
        vecs[0][n // 2] = float("nan")
    lam = torch.tensor(0.3, dtype=dtype, device=dev)
    rho = torch.tensor(1.7, dtype=dtype, device=dev)
    state = torch.tensor([k, done, 0], dtype=torch.int64, device=dev)
    hist = torch.full((4, K1B_N + 1), float("nan"), dtype=dtype, device=dev)
    tol = dict(perr_abs=float(np.sqrt(n)) * abstol, derr_abs=float(np.sqrt(n)) * abstol,
               reltol=1e-3)
    return [*vecs, lam, rho, state, hist], tol


def k1b_phase(dev):
    """K1b, the tail mode of ``csrc/zu_tail.cu``, against its plain version;
    returns (max_abs_err over x, z, u and the norms, ms, plain_ms,
    (bound_ms, bound_by)), the times at n = 5000 f32."""
    import torch

    from admm_tpu_torch.benchmarks.timing import graph_ms
    from admm_tpu_torch.ops.kernels import _fused_zu_tail_torch, fused_zu_tail, zu_tail_scratch

    print("kernel: fused_zu_tail (CUDA C++, tail mode K1b) vs _fused_zu_tail_torch")
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        bits = torch.int32 if dtype == torch.float32 else torch.int64
        worst_rel = 0.0
        for n in K1B_SIZES:
            for case, (k, done, abstol, flags, nan) in K1B_CASES.items():
                ops, tol = k1b_inputs(dev, dtype, n, k, done, abstol, nan)
                kw = dict(tol, domaxiters=False, nodualerror=False, nanguard=True)
                kw.update(flags)
                plain, kern, again = ([t.clone() for t in ops] for _ in range(3))
                _fused_zu_tail_torch(*plain, **kw)
                fused_zu_tail(*kern, **kw)
                fused_zu_tail(*again, **kw)
                torch.cuda.synchronize()
                what = f"({dtype}, n={n}, {case})"
                check(all(_same(a, b) for a, b in zip(kern[1:4], plain[1:4]))
                      and torch.equal(kern[6], plain[6]),
                      f"K1b x, z, u and state == plain bit for bit {what}")
                # The norms: the written column within rtol, NaN where the
                # plain version has NaN, so every other column untouched.
                hk, hp = kern[7], plain[7]
                nan_p = torch.isnan(hp)
                diff = torch.abs(hk - hp)[~nan_p]
                rel = diff / torch.abs(hp)[~nan_p]
                worst_rel = max(worst_rel, float(rel.max()) if rel.numel() else 0.0)
                worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
                check(torch.equal(torch.isnan(hk), nan_p) and bool(torch.all(rel <= rtol)),
                      f"K1b norms within {rtol} of plain, same slot {what}")
                check(all(torch.equal(a.view(bits), b.view(bits))
                          for a, b in zip(kern[1:4] + kern[7:], again[1:4] + again[7:]))
                      and torch.equal(kern[6], again[6]), f"K1b same bits on two launches {what}")
                if not nan:
                    # Away from ties: pnorm and perr (dnorm and derr) lie far
                    # more than rtol apart, so the values decide the flags.
                    col = hp[:, ~nan_p.all(0)].double().cpu().numpy()[:, 0]
                    check(abs(col[0] - col[2]) > 1e3 * rtol * col[2]
                          and (np.isnan(col[1]) or abs(col[1] - col[3]) > 1e3 * rtol * col[3]),
                          f"K1b case away from a stop tie {what}")
        print(f"  {dtype}: max relative norm error {worst_rel:.3e} over "
              f"{len(K1B_SIZES) * len(K1B_CASES)} cases")

    # Time per call at the headline's n, f32, under domaxiters on a history
    # long enough that no call of the timing freezes.
    n = 5000
    ops, tol = k1b_inputs(dev, torch.float32, n, 0, 0, 1e-4, False)
    ops[7] = torch.full((4, 10**6 + 1), float("nan"), device=dev)
    tol.update(domaxiters=True, nodualerror=False, nanguard=True)
    scratch = zu_tail_scratch(n, torch.float32, dev)
    kernel = lambda: fused_zu_tail(*ops, scratch=scratch, **tol)  # noqa: E731
    plain = lambda: _fused_zu_tail_torch(*ops, **tol)  # noqa: E731
    dev_t = [graph_ms(f, 2000) for f in (kernel, plain, plain, kernel)]
    host = time_ms(kernel, 2000)
    k, done, _ = ops[6].tolist()
    check(done == 0 and 2000 <= k < 10**6, f"K1b timing state never froze (k = {k})")
    # x_new, z, u read (the freeze keeps x by not writing it); x, z, u
    # written; ~20 operations an element.
    bound_ms = bound(6 * n * 4, 20 * n)
    print(f"  n=5000 f32 per call, device (graph replay): kernel {dev_t[0]:.6f} / "
          f"{dev_t[3]:.6f} ms, plain {dev_t[1]:.6f} / {dev_t[2]:.6f} ms; host-issued kernel "
          f"{host:.5f} ms (CUDA events, 2000 calls each); bound {bound_ms[0]:.6f} ms "
          f"({bound_ms[1]})")
    return worst, min(dev_t[0], dev_t[3]), min(dev_t[1], dev_t[2]), bound_ms


def slice_phase(dev):
    """The main path; returns K1b's launch count in run (a), the z/u mode's
    in (d)'s user-hook run, run (a) itself and (d)'s plain run."""
    import torch

    from admm_tpu_torch import ADMMConfig, Hooks, admm, lasso
    from admm_tpu_torch.benchmarks.headline import (
        make_problem, numpy_lasso_pnorm, steps_to_rms_residual)
    from admm_tpu_torch.config import matmul_precision
    from admm_tpu_torch.models.lasso import make_prox_ops
    from admm_tpu_torch.ops.kernels import fused_soft_threshold_dual as k1
    from admm_tpu_torch.ops.kernels import fused_zu_tail as k1b

    D, s, lam = make_problem()
    m, n = D.shape
    cfg = ADMMConfig(maxiters=HEADLINE_STEPS, domaxiters=True, unroll=64)
    print(f"slice: lasso {m}x{n} f32, lam={lam:.6g}, {cfg.maxiters} steps, unroll {cfg.unroll}")

    # (a) the main path, counted.
    k1b.launches = 0
    a = lasso(D, s, lam, cfg, use_fused_kernel=True, device=dev)
    torch.cuda.synchronize()
    launches = k1b.launches
    print(f"  (a) fused: steps={a.steps} K1b launches={launches} runtime={a.runtime:.4f}s "
          f"setup+solve={a.solverruntime:.4f}s")
    check(a.steps == HEADLINE_STEPS, f"(a) steps == {HEADLINE_STEPS}")
    check(launches >= HEADLINE_STEPS, f"(a) K1b launches {launches} >= {HEADLINE_STEPS}")
    check(a.xopt.device.type == "cuda" and tuple(a.xopt.shape) == (n,),
          "(a) xopt on the card with shape (5000,)")
    check(bool(torch.isfinite(a.xopt).all()) and not a.diverged, "(a) xopt finite")

    # (b) the same without the kernel.
    b = lasso(D, s, lam, cfg, use_fused_kernel=False, device=dev)
    diff = float(torch.max(torch.abs(a.xopt - b.xopt)))
    xinf = float(torch.max(torch.abs(a.xopt)))
    print(f"  (b) plain: steps={b.steps} runtime={b.runtime:.4f}s; "
          f"max|xopt_a - xopt_b| = {diff:.3e}, ||xopt||_inf = {xinf:.6g}, "
          f"ratio {diff / xinf:.3e}")
    check(b.steps == HEADLINE_STEPS, f"(b) steps == {HEADLINE_STEPS}")
    check(diff <= 1e-6 * xinf, "(b) max|xopt_fused - xopt_plain| <= 1e-6 ||xopt||_inf")

    # (c) steps to an RMS residual of 1e-6 against NumPy float64.
    steps_port = steps_to_rms_residual(a.pnorm, n)
    ref_pnorm = numpy_lasso_pnorm(D.astype(np.float64), s.astype(np.float64),
                                  lam, cfg.rho, iters=200)
    steps_np = steps_to_rms_residual(ref_pnorm, n)
    print(f"  (c) steps_to_rms_residual_1e-6: port f32 {steps_port}, "
          f"NumPy f64 {steps_np} (admm_tpu BENCH_r05.json records 60)")
    check(steps_port is not None and steps_np is not None
          and abs(steps_port - steps_np) <= 1, "(c) equal within one step")

    # (d) a converging run, stop rule on.
    cfg_d = ADMMConfig(maxiters=2000, unroll=16)
    d_fused = lasso(D, s, lam, cfg_d, use_fused_kernel=True, device=dev)
    d_plain = lasso(D, s, lam, cfg_d, use_fused_kernel=False, device=dev)
    # The same solve through a user hook: the generic tail and K1's z/u mode.
    with matmul_precision("highest"):
        prox_f, prox_g, _, data = make_prox_ops(
            torch.as_tensor(D, device=dev), torch.as_tensor(s, device=dev), lam, cfg_d)
    k1.launches = 0
    d_hook = admm(prox_f, prox_g, cfg_d, m=n, nA=n, nB=n, data=data, dtype=torch.float32,
                  hooks=Hooks(fused_zu=lambda x, u, rho, d: k1(x, u, d["lam"] / rho)))
    torch.cuda.synchronize()
    zu_launches = k1.launches
    print(f"  (d) converging: steps fused={d_fused.steps} plain={d_plain.steps} "
          f"user hook={d_hook.steps} (z/u mode launches {zu_launches})")
    check(d_fused.steps < 2000 and not d_fused.diverged, "(d) converges before 2000")
    for name, r in (("fused", d_fused), ("user hook", d_hook)):
        if r.steps != d_plain.steps:
            # The stop fell one step apart: print the margin that decided it.
            k = min(r.steps, d_plain.steps) - 1
            print(f"  (d) {name} vs plain at step {k + 1}: pnorm/perr "
                  f"{r.pnorm[k]:.9g}/{r.perr[k]:.9g} vs "
                  f"{d_plain.pnorm[k]:.9g}/{d_plain.perr[k]:.9g}, dnorm/derr "
                  f"{r.dnorm[k]:.9g}/{r.derr[k]:.9g} vs "
                  f"{d_plain.dnorm[k]:.9g}/{d_plain.derr[k]:.9g}")
        check(abs(r.steps - d_plain.steps) <= 1, f"(d) {name} and plain steps within one")
    check(zu_launches >= d_hook.steps, f"(d) z/u mode launches {zu_launches} >= steps "
          f"{d_hook.steps}")
    check(bool(torch.isfinite(d_fused.xopt).all()), "(d) xopt finite")

    # (e) iter/s, best of 3 each, in turns (a is the first fused run).
    fused_t, plain_t = [a.runtime], [b.runtime]
    for fused, times in ((False, plain_t), (True, fused_t), (True, fused_t),
                         (False, plain_t)):
        r = lasso(D, s, lam, cfg, use_fused_kernel=fused, device=dev)
        times.append(r.runtime)
    print(f"  (e) runtimes s: fused {['%.4f' % t for t in fused_t]}, "
          f"plain {['%.4f' % t for t in plain_t]}")
    print(f"  (e) iter/s best of 3: fused {HEADLINE_STEPS / min(fused_t):.1f}, "
          f"plain {HEADLINE_STEPS / min(plain_t):.1f}")
    return launches, zu_launches, a, d_plain


@contextlib.contextmanager
def counting_syncs():
    """Count the synchronising CUDA calls of a solve, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: yields a dict
    whose "steps" counts those inside the engine's sub-steps, "substeps"
    the sub-steps, "chunks" the chunks (each ends in one read of the stop
    flag) and, on exit, "solve" all of the solve's, set-up included."""
    import warnings

    import torch

    from admm_tpu_torch import engine

    got = {"steps": 0, "substeps": 0, "chunks": 0, "solve": 0}
    run_chunks = engine._run_chunks
    tally = [0, 0]  # warnings looked at, synchronising calls among them
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")

        def syncs():
            tally[1] += sum("called a synchronizing" in str(w.message) for w in seen[tally[0]:])
            tally[0] = len(seen)
            return tally[1]

        def counted(step, flags, N, K, table=None):
            def one_step():
                before = syncs()
                step()
                got["steps"] += syncs() - before
                got["substeps"] += 1

            def read():
                got["chunks"] += 1
                return flags()

            return run_chunks(one_step, read, N, K, table)

        engine._run_chunks = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield got
        finally:
            torch.cuda.set_sync_debug_mode("default")
            engine._run_chunks = run_chunks
            got["solve"] = syncs()


def lasso_objective(D, s, lam, z):
    """LASSO's objective at z in NumPy f64."""
    z = z.double().cpu().numpy()
    return 0.5 * np.sum((D @ z - s) ** 2) + lam * np.sum(np.abs(z))


def variants_phase(dev, d_plain):
    """Slice 2, the engine variants, on the headline problem (n)-(r);
    returns {kernel: {path: launches}} for K1's z/u mode and K2."""
    import contextlib as _contextlib
    import io

    import torch

    from admm_tpu_torch import ADMMConfig, Hooks, admm, lasso
    from admm_tpu_torch.benchmarks.headline import make_problem
    from admm_tpu_torch.config import matmul_precision
    from admm_tpu_torch.models.lasso import make_prox_ops
    from admm_tpu_torch.ops.gemv_pair import gemv_pair as k2
    from admm_tpu_torch.ops.kernels import _fused_torch
    from admm_tpu_torch.ops.kernels import fused_soft_threshold_dual as k1
    from admm_tpu_torch.ops.kernels import fused_zu_tail as k1b

    D, s, lam = make_problem()
    D64, s64 = D.astype(np.float64), s.astype(np.float64)
    n = D.shape[1]
    bf16 = torch.bfloat16
    launches = {"k1": {}, "k2": {}}
    syncs = {}
    print(f"slice 2: engine variants on lasso {D.shape[0]}x{n} f32, lam={lam:.6g}")

    def counted(tag, solve):
        """Run ``solve`` with every launch count at 0 just before it and
        read just after, its synchronising calls counted."""
        k1.launches = k1b.launches = k2.launches = 0
        with counting_syncs() as sy:
            r = solve()
            torch.cuda.synchronize()
        syncs[tag] = sy
        return r, k1.launches, k1b.launches, k2.launches

    # (n) residual balancing with the fused hook: K1's z/u mode each step,
    # never K1b, whose tail knows no rho update.
    cfg_n = ADMMConfig(maxiters=VARIANT_MAXITERS, unroll=16, rbadaptive=True)
    nk, zu, tail, _ = counted("n", lambda: lasso(D, s, lam, cfg_n, use_fused_kernel=True,
                                                 device=dev))
    launches["k1"]["n"] = zu
    plain = lasso(D, s, lam, cfg_n, use_fused_kernel=False, device=dev)
    # The same solve with the z/u mode's plain version in the hook's place.
    with matmul_precision("highest"):
        pf, pg, obj, data = make_prox_ops(torch.as_tensor(D, device=dev),
                                          torch.as_tensor(s, device=dev), lam, cfg_n)
    twin = admm(pf, pg, cfg_n, m=n, nA=n, nB=n, data=data, dtype=torch.float32,
                hooks=Hooks(fused_zu=lambda x, u, rho, d: _fused_torch(x, u, d["lam"] / rho)))
    xinf = float(torch.max(torch.abs(nk.xopt)))
    dx_plain = float(torch.max(torch.abs(nk.xopt - plain.xopt)))
    dx_twin = float(torch.max(torch.abs(nk.xopt - twin.xopt)))
    print(f"  (n) rbadaptive, fused: steps={nk.steps} rho_final={nk.rho_final:.9g} "
          f"z/u launches={zu} K1b launches={tail} runtime={nk.runtime:.4f}s; without the "
          f"kernel (prox_g): steps={plain.steps} rho_final={plain.rho_final:.9g}, "
          f"max|dxopt| = {dx_plain:.3e}; with the z/u mode's plain version: "
          f"steps={twin.steps} rho_final={twin.rho_final:.9g}, max|dxopt| = {dx_twin:.3e}; "
          f"||xopt||_inf = {xinf:.6g}")
    k = min(nk.steps, plain.steps) - 1
    print(f"  (n) stop margin at step {k + 1}: pnorm/perr {nk.pnorm[k]:.9g}/{nk.perr[k]:.9g} "
          f"(plain {plain.pnorm[k]:.9g}/{plain.perr[k]:.9g}), dnorm/derr "
          f"{nk.dnorm[k]:.9g}/{nk.derr[k]:.9g} (plain {plain.dnorm[k]:.9g}/"
          f"{plain.derr[k]:.9g})")
    check(nk.steps < VARIANT_MAXITERS and not nk.diverged and bool(torch.isfinite(nk.xopt).all()),
          f"(n) converges before {VARIANT_MAXITERS}, finite")
    check(zu >= nk.steps and tail == 0, f"(n) z/u mode launches {zu} >= steps {nk.steps}, "
          f"K1b launches {tail} == 0")
    check(abs(nk.steps - plain.steps) <= 1, "(n) steps equal within one to the solve without "
          "the kernel")
    check(nk.rho_final == plain.rho_final == twin.rho_final, "(n) rho_final equal")
    check(dx_plain <= 1e-5 * xinf and dx_twin <= 1e-5 * xinf,
          "(n) max|dxopt| <= 1e-5 ||xopt||_inf against both")
    check(twin.steps == nk.steps, "(n) steps equal to the z/u plain-version solve")

    # (o) Anderson acceleration with the fused hook.
    cfg_o = ADMMConfig(maxiters=VARIANT_MAXITERS, unroll=16, anderson=5)
    ok_, zu, tail, _ = counted("o", lambda: lasso(D, s, lam, cfg_o, use_fused_kernel=True,
                                                  device=dev))
    launches["k1"]["o"] = zu
    f_o = lasso_objective(D64, s64, lam, ok_.zopt)
    f_d = lasso_objective(D64, s64, lam, d_plain.zopt)
    print(f"  (o) anderson=5, fused: steps={ok_.steps} (d) plain steps={d_plain.steps}; "
          f"z/u launches={zu} K1b launches={tail}; objective {f_o:.9g} vs (d) {f_d:.9g}, "
          f"rel {abs(f_o - f_d) / abs(f_d):.3e}")
    check(ok_.steps < VARIANT_MAXITERS and not ok_.diverged, f"(o) converges before "
          f"{VARIANT_MAXITERS}")
    check(zu >= ok_.steps and tail == 0, f"(o) z/u mode launches {zu} >= steps {ok_.steps}, "
          "no K1b")
    check(abs(f_o - f_d) <= 1e-4 * abs(f_d), "(o) objective within 1e-4 of (d)'s plain solve")

    # (p) fast (alg 2, weak) and fasttype='strong' with bf16 streams: K2
    # computes the x-update each step.
    for tag, kw, bar_steps in (("p weak", dict(fast=True), VARIANT_MAXITERS),
                               ("p strong", dict(fast=True, fasttype="strong"), STRONG_STEPS)):
        cfg_p = ADMMConfig(maxiters=VARIANT_MAXITERS, unroll=16, **kw)
        r, _, _, cnt = counted(tag, lambda: lasso(D, s, lam, cfg_p, stream_dtype=bf16,
                                                  device=dev))
        launches["k2"][tag] = cnt
        f32 = lasso(D, s, lam, cfg_p, device=dev)
        rel = float(torch.linalg.norm(r.xopt - f32.xopt) / torch.linalg.norm(f32.xopt))
        traces = sorted(k for k in ("dvals", "avals", "restarted") if k in r.hist)
        print(f"  ({tag}) bf16: steps={r.steps} K2 launches={cnt} runtime={r.runtime:.4f}s "
              f"iter/s {r.steps / r.runtime:.1f}; f32: steps={f32.steps}; "
              f"||dxopt||/||xopt|| = {rel:.3e}; traces {traces}"
              + (f", restarts {int(r.restarted.sum())}" if r.restarted is not None else ""))
        check(cnt >= r.steps and bool(torch.isfinite(r.xopt).all()) and not r.diverged,
              f"({tag}) K2 launches {cnt} >= steps {r.steps}, finite")
        want = ["avals", "dvals", "restarted"] if "strong" not in tag else ["avals"]
        check(traces == want and all(len(r.trace(t)) == r.steps for t in want),
              f"({tag}) {', '.join(want)} recorded, one per step")
        if bar_steps != VARIANT_MAXITERS:
            # alg 1 has no restart and LASSO is not strongly convex, so its
            # momentum grows and the run drifts in any precision: the bar
            # holds over the first steps, before the drift dominates.
            cfg_b = ADMMConfig(maxiters=bar_steps, domaxiters=True, **kw)
            r = lasso(D, s, lam, cfg_b, stream_dtype=bf16, device=dev)
            f32 = lasso(D, s, lam, cfg_b, device=dev)
            rel = float(torch.linalg.norm(r.xopt - f32.xopt) / torch.linalg.norm(f32.xopt))
            print(f"  ({tag}) after {bar_steps} steps: ||dxopt||/||xopt|| = {rel:.3e}")
        check(rel <= 2e-2, f"({tag}) ||xopt_bf16 - xopt_f32|| <= 2e-2 ||xopt_f32|| "
              f"after {r.steps} steps")

    # (q) each once, finite, trace shapes checked.
    q_cases = {
        "adaptive": (dict(adaptive=True, convtest=True, stopcond="both"), {}),
        "hnorm": (dict(stopcond="hnorm"), dict(use_fused_kernel=True)),
        "stallwindow": (dict(stallwindow=20), dict(use_fused_kernel=True)),
        "record_iterates": (dict(maxiters=RECORD_STEPS, domaxiters=True, record_iterates=True),
                            dict(use_fused_kernel=True)),
        "quiet": (dict(quiet=False), dict(use_fused_kernel=True)),
    }
    for tag, (kw, extra) in q_cases.items():
        cfg_q = ADMMConfig(**dict(dict(maxiters=VARIANT_MAXITERS, unroll=16), **kw))
        out = io.StringIO()
        with _contextlib.redirect_stdout(out):
            r = lasso(D, s, lam, cfg_q, device=dev, **extra)
        rows = [ln for ln in out.getvalue().splitlines() if "\tpnorm " in ln]
        shapes = {k: tuple(v.shape) for k, v in r.hist.items()}
        print(f"  (q) {tag}: steps={r.steps} rho_final={r.rho_final:.9g} diverged={r.diverged} "
              f"stalled={r.stalled} runtime={r.runtime:.4f}s; traces {shapes}")
        check(bool(torch.isfinite(r.xopt).all()) and r.xopt.device.type == "cuda",
              f"(q) {tag} xopt finite on the card")
        check(all(v.shape[0] == cfg_q.maxiters for v in r.hist.values()),
              f"(q) {tag} traces of maxiters rows")
        if tag == "adaptive":
            check("Hnormsq" in r.hist and r.rho_final != cfg_q.rho, "(q) adaptive: H-norms "
                  f"recorded, rho moved to {r.rho_final:.6g}")
        elif tag == "hnorm":
            H = r.Hnormsq
            check(r.steps < cfg_q.maxiters and len(H) == r.steps and H[-1] <= cfg_q.hnormtol,
                  "(q) hnorm stops on H-norm^2 <= hnormtol")
        elif tag == "record_iterates":
            check(r.steps == RECORD_STEPS and r.wvals.shape == (RECORD_STEPS, 3 * n)
                  and r.trace("xvals").shape == (RECORD_STEPS, n)
                  and np.isfinite(r.wvals).all(), "(q) record_iterates: x/z/u/w traces of "
                  f"{RECORD_STEPS} steps, finite")
            w = r.wvals[-1]
            check(np.array_equal(w[:n], r.xopt.cpu().numpy()), "(q) the last w starts with xopt")
        elif tag == "quiet":
            check(len(rows) == r.steps and rows[-1].startswith(f"{r.steps}\t"),
                  f"(q) quiet=False printed {len(rows)} rows for {r.steps} steps")

    # (r) host reads per solve.
    for tag, sy in syncs.items():
        outside = sy["solve"] - sy["steps"] - sy["chunks"]
        print(f"  (r) ({tag}) synchronising calls: {sy['solve']} in the solve, "
              f"{sy['steps']} inside its sub-steps, {sy['chunks']} chunk reads, "
              f"{outside} outside the loop (set-up and results)")
        check(sy["steps"] == 0, f"(r) ({tag}) no synchronising call inside a sub-step")
        check(sy["solve"] <= sy["chunks"] + SYNCS_OUTSIDE,
              f"(r) ({tag}) at most one per chunk plus {SYNCS_OUTSIDE} outside the loop")
    return launches


def k2_operands(m, n, dev, dtype, K):
    """The GEMV-pair probe's draws at (m, n).  For a chain (K > 1) D^T is
    E^T / lambda, lambda the top eigenvalue of E^T E (a NumPy f64 power
    iteration): the chain then contracts onto one direction at a steady
    norm.  The probe's independent E and D^T make a chain that amplifies
    one flipped bf16 rounding of b or t some 700-fold over 64 steps, so a
    bar there would measure that chain's conditioning, not the kernel."""
    import torch

    from admm_tpu_torch.experiments.gemv_pair_probe import make_operands
    from admm_tpu_torch.ops.gemv_pair import aligned_rows

    b, E, Dt = make_operands(m, n, torch.device("cpu"), torch.float32)
    if K > 1:
        E64 = E.double().numpy()
        v = b.double().numpy()
        for _ in range(100):
            w = E64.T @ (E64 @ v)
            lam = np.linalg.norm(w) / np.linalg.norm(v)
            v = w / np.linalg.norm(w)
        Dt = torch.from_numpy((E64.T / lam).astype(np.float32))
    return (b.to(dev, dtype), aligned_rows(E.to(dev, dtype)),
            aligned_rows(Dt.to(dev, dtype)))


def k2_phase(dev):
    """K2 (CUDA C++) against its plain version; returns (max_abs_err, ms,
    plain_ms, library_ms, (bound_ms, bound_by)) of one K = 1 f32 call at
    (1500, 5000), the library call being ``torch.linalg.multi_dot``."""
    import torch

    from admm_tpu_torch.benchmarks.timing import graph_ms
    from admm_tpu_torch.experiments.gemv_pair_probe import make_operands
    from admm_tpu_torch.ops.gemv_pair import _gemv_pair_torch, aligned_rows, gemv_pair

    print("kernel: gemv_pair (CUDA C++) vs _gemv_pair_torch")
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for m, n in K2_SHAPES:
            for K in (1, K2_DEEP):
                b, E, Dt = k2_operands(m, n, dev, dtype, K)
                x = gemv_pair(b, E, Dt, K)
                torch.cuda.synchronize()
                ref = _gemv_pair_torch(b, E, Dt, K)
                dmax = float(torch.max(torch.abs(x - ref)))
                xinf = float(torch.max(torch.abs(ref)))
                rel = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
                print(f"  {str(dtype):14s} m={m:5d} n={n:5d} K={K:2d}  max_abs_diff "
                      f"{dmax:.3e} (||x||_inf {xinf:.4g}), rel norm {rel:.3e}")
                check(bool(torch.isfinite(x).all()), f"K2 finite ({dtype}, {m}x{n}, K={K})")
                if K == 1:
                    bar = 1e-5 if dtype == torch.float32 else 1e-3
                    check(dmax <= bar * xinf, f"K2 max|dx| <= {bar} ||x||_inf "
                          f"({dtype}, {m}x{n}, K=1)")
                else:
                    bar = 1e-4 if dtype == torch.float32 else 2e-2
                    check(rel <= bar, f"K2 ||dx||/||x|| <= {bar} ({dtype}, {m}x{n}, K={K})")
                worst = max(worst, dmax)

    # The same bits from every launch, and an f32 b with bf16 streams
    # rounded as b.to(bf16) rounds it.
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, K2_DEEP):
            b, E, Dt = k2_operands(1500, 5000, dev, dtype, K)
            first = gemv_pair(b, E, Dt, K)
            same = all(torch.equal(gemv_pair(b, E, Dt, K), first) for _ in range(2))
            check(same, f"K2 gives the same bits on three launches ({dtype}, K={K})")
    b, E, Dt = k2_operands(1500, 5000, dev, torch.bfloat16, 1)
    b32 = torch.from_numpy(np.random.default_rng(3).standard_normal(E.shape[1]))
    b32 = b32.to(dev, torch.float32)
    check(torch.equal(gemv_pair(b32, E, Dt), gemv_pair(b32.to(torch.bfloat16), E, Dt)),
          "K2 with bf16 streams: an f32 b gives the bits of b.to(bf16)")

    # Times at (1500, 5000) in the solver's layout (rows on 16-byte
    # boundaries), kernel and plain version and, in f32, multi_dot in turns.
    times = {}
    for dtype, K, reps in ((torch.float32, 1, 200), (torch.bfloat16, 1, 200),
                           (torch.float32, K2_DEEP, 20), (torch.bfloat16, K2_DEEP, 20)):
        b, E, Dt = make_operands(1500, 5000, dev, dtype)
        E, Dt = aligned_rows(E), aligned_rows(Dt)
        fns = {"kernel": lambda: gemv_pair(b, E, Dt, K),
               "plain": lambda: _gemv_pair_torch(b, E, Dt, K)}
        if dtype == torch.float32 and K == 1:
            fns["multi_dot"] = lambda: torch.linalg.multi_dot([Dt, E, b])
        got = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            got[name].append(graph_ms(fns[name], reps, per_graph=10 if K == 1 else 2))
        host = time_ms(fns["kernel"], reps)
        times[(dtype, K)] = {name: min(v) for name, v in got.items()}
        m, n = E.shape
        size = E.element_size()
        nbytes = K * 2 * m * n * size + n * size + n * 4  # E, Dt each step; b in, x out
        times[(dtype, K)]["bound"] = bound(nbytes, K * 4 * m * n)
        print(f"  (1500, 5000) {str(dtype):14s} K={K:2d} per call: "
              + ", ".join(f"{name} {' / '.join('%.5f' % t for t in v)} ms"
                          for name, v in got.items())
              + f" (device: CUDA events around graph replays, {reps} calls each; "
              f"host-issued kernel {host:.5f} ms); kernel {min(got['kernel']) * 1e3 / K:.2f} "
              f"us per step, {nbytes / (min(got['kernel']) * 1e-3) / 1e12:.2f} TB/s; "
              f"bound {times[(dtype, K)]['bound'][0] * 1e3 / K:.2f} us per step")
    md = times[(torch.float32, 1)]["multi_dot"]
    print(f"  per step against multi_dot f32 ({md * 1e3:.2f} us): K2 f32 K=1 "
          f"{times[(torch.float32, 1)]['kernel'] * 1e3:.2f} us, K=64 "
          f"{times[(torch.float32, K2_DEEP)]['kernel'] * 1e3 / K2_DEEP:.2f} us; "
          f"bf16 K=1 {times[(torch.bfloat16, 1)]['kernel'] * 1e3:.2f} us, K=64 "
          f"{times[(torch.bfloat16, K2_DEEP)]['kernel'] * 1e3 / K2_DEEP:.2f} us")
    f32 = times[(torch.float32, 1)]
    return worst, f32["kernel"], f32["plain"], md, f32["bound"]


def k3_phase(dev, a):
    """K3 (CUDA C++) through the prototype's entry point, against its plain
    version, NumPy f64 and run (a)'s history; returns (launches,
    max_abs_err, ms, plain_ms, (bound_ms, bound_by)) with the times per
    launch of K steps."""
    import torch

    from admm_tpu_torch.benchmarks.timing import graph_ms
    from admm_tpu_torch.experiments import resident_iter_proto as proto
    from admm_tpu_torch.ops.gemv_pair import _resident_lasso_torch, resident_lasso

    K = proto.K
    print(f"kernel: resident_lasso (CUDA C++), the headline problem, K={K}, "
          f"{proto.CALLS} chained launches")
    resident_lasso.launches = 0
    r = proto.run(dev)
    torch.cuda.synchronize()
    launches = resident_lasso.launches
    print(f"  launches {launches}; z err vs NumPy f64 {r['z_err']:.3e}, u err "
          f"{r['u_err']:.3e}, pn2 rel err at step {K} {r['pn2_err']:.3e}; "
          f"{r['us_per_iter']:.2f} us/iter, {r['iters_per_sec']:.0f} iter/s (host clock)")
    check(launches >= 1 + proto.CALLS, f"K3 launched {launches} >= {1 + proto.CALLS} times")
    check(r["z_err"] <= 1e-4 and r["u_err"] <= 1e-4,
          "K3 z, u vs NumPy f64: max|d| <= 1e-4 ||.||_inf")

    op = proto.setup(dev)
    args = (op["Dts"], op["E"], op["Dt"], op["rho"], op["kappa"], K)
    n = op["Dts"].numel()
    zp = torch.zeros(n, dtype=torch.float32, device=dev)
    up = torch.zeros_like(zp)
    _resident_lasso_torch(zp, up, *args)
    dz = float(torch.max(torch.abs(r["z"] - zp)))
    du = float(torch.max(torch.abs(r["u"] - up)))
    print(f"  vs _resident_lasso_torch on the card: max|dz| {dz:.3e}, max|du| {du:.3e}")
    check(dz <= 1e-4 * float(torch.max(torch.abs(zp)))
          and du <= 1e-4 * float(torch.max(torch.abs(up))),
          "K3 z, u vs plain: max|d| <= 1e-4 ||.||_inf")

    pn2 = r["hist"][:, 0].double().cpu().numpy()
    pnorm = np.asarray(a.pnorm[:K], np.float64)
    ref = pnorm**2
    big = ref >= 1e-7 * ref[0]
    rel = np.abs(pn2 - ref) / ref
    xnorm = float(torch.linalg.norm(a.xopt))
    gap = np.abs(np.sqrt(pn2) - pnorm) - 1e-3 * pnorm
    print(f"  history vs run (a): max rel pn2 {rel[big].max():.3e} over the {big.sum()} "
          f"steps with pnorm^2 >= 1e-7 pnorm^2[0]; max over all {K} steps of "
          f"|sqrt(pn2) - pnorm| - 1e-3 pnorm: {gap.max():.3e} (bar 1e-6 ||xopt|| = "
          f"{1e-6 * xnorm:.3e})")
    check(bool(np.all(rel[big] <= 1e-3)) and big.sum() >= 20,
          "K3 history pn2 within 1e-3 of run (a)'s pnorm^2 where pnorm^2 >= 1e-7 pnorm^2[0]")
    check(bool(np.all(gap <= 1e-6 * xnorm)),
          "K3 |sqrt(pn2) - pnorm| <= 1e-3 pnorm + 1e-6 ||xopt|| at every step")

    # A relaunch from the same state gives the same bits (fixed-order sums).
    z1, u1 = torch.zeros_like(zp), torch.zeros_like(up)
    h1 = resident_lasso(z1, u1, *args)
    z2, u2 = torch.zeros_like(zp), torch.zeros_like(up)
    h2 = resident_lasso(z2, u2, *args)
    check(torch.equal(h1, h2) and torch.equal(z1, z2) and torch.equal(u1, u2),
          "K3 gives the same bits on two launches")

    m = op["E"].shape[0]
    # E and D^T each step; z, u, D^T s in, z and u out, the history.
    bound_ms = bound(K * 2 * m * n * 4 + 5 * n * 4 + K * 8, K * (4 * m * n + 16 * n))
    zc, uc = torch.zeros_like(zp), torch.zeros_like(up)
    ks = [graph_ms(lambda: resident_lasso(zc, uc, *args), 20, per_graph=2)]
    ps = [graph_ms(lambda: _resident_lasso_torch(zc, uc, *args), 3, per_graph=1)]
    ps.append(graph_ms(lambda: _resident_lasso_torch(zc, uc, *args), 3, per_graph=1))
    ks.append(graph_ms(lambda: resident_lasso(zc, uc, *args), 20, per_graph=2))
    print(f"  per launch of {K} steps: kernel {ks[0]:.5f} / {ks[1]:.5f} ms, plain loop "
          f"{ps[0]:.5f} / {ps[1]:.5f} ms (device: CUDA events around graph replays); per step kernel "
          f"{min(ks) * 1e3 / K:.2f} us, plain {min(ps) * 1e3 / K:.2f} us; bound "
          f"{bound_ms[0] * 1e3 / K:.2f} us per step ({bound_ms[1]})")
    return launches, max(dz, du), min(ks), min(ps), bound_ms


def _family_objective(family, D, s, lam, z):
    """The objective at z in NumPy f64 (each model's own formula)."""
    z = z.double().cpu().numpy()
    fit = 0.5 * np.sum((D @ z - s) ** 2)
    if family == "elasticnet":
        return fit + lam * (0.5 * np.sum(np.abs(z)) + 0.25 * np.sum(z**2))
    if family == "grouplasso":
        return fit + lam * np.sum(np.sqrt(np.sum(z.reshape(50, -1) ** 2, axis=1)))
    return fit


def bf16_phase(dev, a):
    """The bf16-stream slice (k)-(m); returns K2's launch count in run (k)."""
    import torch

    from admm_tpu_torch import ADMMConfig, elasticnet, grouplasso, lasso, nnls
    from admm_tpu_torch.benchmarks.headline import make_problem
    from admm_tpu_torch.ops.gemv_pair import gemv_pair

    D, s, lam = make_problem()
    n = D.shape[1]
    bf16 = torch.bfloat16
    cfg = ADMMConfig(maxiters=HEADLINE_STEPS, domaxiters=True, unroll=64)
    print(f"slice: lasso {D.shape[0]}x{n} with bf16 streams, {cfg.maxiters} steps, "
          f"unroll {cfg.unroll}, fused z/u kernel")

    # (k) the main path of this slice, counted.
    gemv_pair.launches = 0
    k = lasso(D, s, lam, cfg, use_fused_kernel=True, stream_dtype=bf16, device=dev)
    torch.cuda.synchronize()
    launches = gemv_pair.launches
    rel = float(torch.linalg.norm(k.xopt - a.xopt) / torch.linalg.norm(a.xopt))
    print(f"  (k) bf16: steps={k.steps} K2 launches={launches} runtime={k.runtime:.4f}s; "
          f"||xopt_k - xopt_a|| / ||xopt_a|| = {rel:.3e}")
    check(k.steps == HEADLINE_STEPS, f"(k) steps == {HEADLINE_STEPS}")
    check(launches >= HEADLINE_STEPS, f"(k) K2 launches {launches} >= {HEADLINE_STEPS}")
    check(k.xopt.device.type == "cuda" and tuple(k.xopt.shape) == (n,),
          "(k) xopt on the card with shape (5000,)")
    check(bool(torch.isfinite(k.xopt).all()) and not k.diverged, "(k) xopt finite")
    check(rel <= 2e-2, "(k) ||xopt_bf16 - xopt_a|| <= 2e-2 ||xopt_a||")

    # (l) iter/s, best of 3 each, in turns.
    cfg_l = ADMMConfig(maxiters=BF16_TIMED_STEPS, domaxiters=True, unroll=64)
    times = {bf16: [], None: []}
    for sd in (bf16, None, None, bf16, bf16, None):
        r = lasso(D, s, lam, cfg_l, use_fused_kernel=True, stream_dtype=sd, device=dev)
        check(r.steps == BF16_TIMED_STEPS, f"(l) {BF16_TIMED_STEPS} steps")
        times[sd].append(r.runtime)
    print(f"  (l) {BF16_TIMED_STEPS}-step runtimes s: bf16 "
          f"{['%.4f' % t for t in times[bf16]]}, f32 {['%.4f' % t for t in times[None]]}")
    print(f"  (l) iter/s best of 3: bf16 {BF16_TIMED_STEPS / min(times[bf16]):.1f}, "
          f"f32 {BF16_TIMED_STEPS / min(times[None]):.1f}")

    # (m) the other three families on the same D.
    D64, s64 = D.astype(np.float64), s.astype(np.float64)
    cfg_m = ADMMConfig(maxiters=FAMILY_MAXITERS)
    solvers = {
        "elasticnet": lambda **kw: elasticnet(D, s, lam, 0.5, cfg_m, device=dev, **kw),
        "nnls": lambda **kw: nnls(D, s, cfg_m, device=dev, **kw),
        "grouplasso": lambda **kw: grouplasso(D, s, lam, 50, None, cfg_m, device=dev, **kw),
    }
    for family, solve in solvers.items():
        f32 = solve()
        gemv_pair.launches = 0
        r = solve(stream_dtype=bf16)
        torch.cuda.synchronize()
        count = gemv_pair.launches
        f_32 = _family_objective(family, D64, s64, lam, f32.zopt)
        f_16 = _family_objective(family, D64, s64, lam, r.zopt)
        scale = 0.5 * np.sum(s64**2) if family == "nnls" else abs(f_32)
        rel = abs(f_16 - f_32) / scale
        print(f"  (m) {family}: f32 steps={f32.steps} objective {f_32:.8g}; bf16 "
              f"steps={r.steps} K2 launches={count} objective {f_16:.8g}; "
              f"|df| / {'(1/2)||s||^2' if family == 'nnls' else '|f_f32|'} = {rel:.3e}")
        check(f32.steps < FAMILY_MAXITERS and not f32.diverged,
              f"(m) {family} f32 converges before {FAMILY_MAXITERS}")
        check(bool(torch.isfinite(r.zopt).all()) and not r.diverged, f"(m) {family} bf16 finite")
        check(count >= r.steps, f"(m) {family} K2 launches {count} >= steps {r.steps}")
        check(rel <= 2e-2, f"(m) {family} bf16 objective within 2e-2 of f32")
    return launches


def _tv_system(n):
    """I + rho D^T D of the 1-D TV model at rho = 1, as (dl, d, du)."""
    from admm_tpu_torch.models.totalvariation import tv_system

    return tv_system(n, 1.0)


def _random_system(n, seed=9):
    """A random diagonally dominant tridiagonal (tests/test_tridiag.py)."""
    rng = np.random.default_rng(seed)
    return (np.r_[0.0, rng.standard_normal(n - 1)], 4.0 + np.abs(rng.standard_normal(n)),
            np.r_[rng.standard_normal(n - 1), 0.0])


def k4_phase(dev):
    """K4 (CUDA C++) against its plain version; returns (max_abs_err, ms,
    plain_ms, (bound_ms, bound_by)), the times at TV (f)'s shape
    (1, 65536) with the hybrid tail."""
    import torch

    from admm_tpu_torch.benchmarks.timing import graph_ms
    from admm_tpu_torch.ops.tridiag import (
        CyclicReductionSolver, _cr_solve_torch, compact_stacks, cr_solve)

    print("kernel: cr_solve (CUDA C++) vs _cr_solve_torch")

    def problem(lanes, n, cutoff, system, dtype):
        sol = CyclicReductionSolver.from_tridiag(*system(n), dense_cutoff=cutoff,
                                                 device=dev, dtype=dtype)
        N = sol.alphas.shape[1]
        rng = np.random.default_rng(lanes * n)
        bb = torch.zeros((lanes, N), dtype=dtype, device=dev)
        bb[:, :n] = torch.from_numpy(rng.standard_normal((lanes, n))).to(dev, dtype)
        return sol, bb

    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for system in (_tv_system, _random_system):
            for lanes, n, cutoff in K4_CASES:
                sol, bb = problem(lanes, n, cutoff, system, dtype)
                x_k = cr_solve(bb, sol)
                torch.cuda.synchronize()
                x_p = _cr_solve_torch(bb, sol)
                diff = float(torch.max(torch.abs(x_k - x_p)))
                print(f"  {str(dtype):14s} {system.__name__:14s} B={lanes:3d} n={n:6d} "
                      f"cutoff={cutoff}  max_abs_diff {diff:.3e}")
                check(torch.equal(x_k, x_p) and bool(torch.isfinite(x_k).all()),
                      f"K4 == plain bit for bit ({dtype}, {system.__name__}, "
                      f"B={lanes}, n={n}, cutoff={cutoff})")
                worst = max(worst, diff)

    times = {}
    for lanes, n, cutoff in K4_TIMED:
        sol, bb = problem(lanes, n, cutoff, _tv_system, torch.float32)
        ks, ps = [], []
        for kernel in (True, False, False, True):
            fn = (lambda: cr_solve(bb, sol)) if kernel else (lambda: _cr_solve_torch(bb, sol))
            (ks if kernel else ps).append(graph_ms(fn, 200))
        host = time_ms(lambda: cr_solve(bb, sol), 200)
        # bb in, x out, the active coefficients and the tail's inverse.
        stacks = compact_stacks(sol)
        N = bb.shape[1]
        f_rows, b_rows = stacks[0].numel(), stacks[2].numel()
        M = 0 if sol.Tinv is None else sol.Tinv.shape[0]
        nbytes = (2 * bb.numel() + sum(s.numel() for s in stacks) + M * M) * 4
        bound_ms = bound(nbytes, lanes * (4 * f_rows + 5 * b_rows + 2 * M * M))
        times[(lanes, n)] = (min(ks), min(ps), bound_ms)
        print(f"  B={lanes} n={n} (N={N}) cutoff={cutoff} f32 per solve, device (CUDA "
              f"events around graph replays, 200 calls each): kernel {ks[0]:.5f} / "
              f"{ks[1]:.5f} ms, plain {ps[0]:.5f} / {ps[1]:.5f} ms; host-issued kernel "
              f"{host:.5f} ms; bound {bound_ms[0]:.6f} ms ({bound_ms[1]})")
    return worst, *times[(1, 65536)]


def staircase(n, seed=0):
    """admm_tpu/benchmarks/matrix.py's TV signal: blocks of 64 plus noise
    of standard deviation 0.5, in float32."""
    rng = np.random.default_rng(seed)
    stair = np.repeat(rng.standard_normal(max(n // 64, 1)), 64)[:n]
    return (stair + 0.5 * rng.standard_normal(n)).astype(np.float32)


def numpy_tv_steps(sig, lam, cfg):
    """Steps to the standard stop of the TV iteration in NumPy float64,
    with the update sequence and Boyd rule of admm_tpu_torch's engine
    (A = D, B = -1, c = 0) and the x-update by scipy's banded solve."""
    from scipy.linalg import solve_banded

    s = np.asarray(sig, np.float64)
    n, rho, t = s.size, cfg.rho, lam / cfg.rho
    ab = np.zeros((3, n))
    ab[0, 1:] = -rho
    ab[1] = 1.0 + rho * np.r_[1.0, 2.0 * np.ones(n - 1)]
    ab[2, :-1] = -rho

    def dmv(v):
        return v - np.r_[v[1:], 0.0]

    def drmv(v):
        return v - np.r_[0.0, v[:-1]]

    x, z, u = np.zeros(n), np.zeros(n), np.zeros(n)
    sqn_abstol = np.sqrt(n) * cfg.abstol
    for k in range(1, cfg.maxiters + 1):
        zprev = z
        x = solve_banded((1, 1), ab, s + rho * drmv(z - u))
        dx = dmv(x)
        v = u + dx
        z = np.sign(v) * np.maximum(np.abs(v) - t, 0.0)
        u = u + dx - z
        pnorm = np.linalg.norm(dx - z)
        dnorm = np.linalg.norm(rho * drmv(z - zprev))
        perr = sqn_abstol + cfg.reltol * max(np.linalg.norm(dx), np.linalg.norm(z))
        derr = sqn_abstol + cfg.reltol * np.linalg.norm(rho * drmv(u))
        if pnorm < perr and dnorm < derr:
            return k
    return cfg.maxiters


def tv_phase(dev):
    """The TV main path; returns K4's launch count in run (f)."""
    import torch

    from admm_tpu_torch import ADMMConfig, totalvariation, totalvariation2d
    from admm_tpu_torch.models.totalvariation import make_prox_ops
    from admm_tpu_torch.ops.tridiag import cr_solve

    cfg = ADMMConfig(maxiters=TV_MAXITERS, unroll="auto")
    launches = None
    signals = {}
    for n, tag, bar in ((65536, "(f)/(g)", 1e-6), (8192, "(h)", 0.0)):
        sig = staircase(n)
        *_, data, _ = make_prox_ops(torch.from_numpy(sig), TV_LAM, cfg)
        hybrid = data["cr"].Tinv is not None
        print(f"slice: totalvariation n={n} f32, lam={TV_LAM}, auto -> cr "
              f"({'hybrid, cut stride %d' % data['cr'].cut_stride if hybrid else 'masked'}), "
              f"maxiters {cfg.maxiters}")
        check(hybrid == (n > 16384), f"{tag} auto resolves to the "
              f"{'hybrid' if n > 16384 else 'pure masked'} cyclic reduction")

        cr_solve.launches = 0
        k = totalvariation(sig, TV_LAM, cfg, device=dev)
        torch.cuda.synchronize()
        count = cr_solve.launches
        if launches is None:
            launches = count  # run (f): the main path
        print(f"  {tag} kernel: steps={k.steps} launches={count} runtime={k.runtime:.4f}s "
              f"iter/s {k.steps / k.runtime:.1f}")
        check(count >= k.steps, f"{tag} K4 launches {count} >= steps {k.steps}")
        check(k.xopt.device.type == "cuda" and tuple(k.xopt.shape) == (n,),
              f"{tag} xopt on the card with shape ({n},)")
        check(bool(torch.isfinite(k.xopt).all()) and not k.diverged, f"{tag} xopt finite")
        check(k.steps < cfg.maxiters, f"{tag} converges before {cfg.maxiters}")
        steps_np = numpy_tv_steps(sig, TV_LAM, cfg)
        print(f"  {tag} steps: port f32 {k.steps}, NumPy f64 {steps_np}")
        check(abs(k.steps - steps_np) <= 1, f"{tag} steps equal NumPy f64 within one")

        p = totalvariation(sig, TV_LAM, cfg, device=dev, _plain_cr=True)
        diff = float(torch.max(torch.abs(k.xopt - p.xopt)))
        xinf = float(torch.max(torch.abs(k.xopt)))
        print(f"  {tag} plain: steps={p.steps} runtime={p.runtime:.4f}s iter/s "
              f"{p.steps / p.runtime:.1f}; max|xopt_kernel - xopt_plain| = {diff:.3e}, "
              f"||xopt||_inf = {xinf:.6g}")
        check(p.steps == k.steps, f"{tag} equal steps kernel and plain")
        check(diff <= bar * xinf, f"{tag} max|xopt_kernel - xopt_plain| <= {bar} ||xopt||_inf")
        signals[n] = sig

    # (i) iter/s of (f) and (g), best of 3 each, in turns.  (f) stops
    # after a few dozen steps, too few to time, so the rate is taken over
    # TV_TIMED_STEPS steps of the same path under domaxiters.
    sig = signals[65536]
    cfg_i = ADMMConfig(maxiters=TV_TIMED_STEPS, domaxiters=True, unroll="auto")
    kernel_t, plain_t = [], []
    for plain in (False, True, True, False, False, True):
        r = totalvariation(sig, TV_LAM, cfg_i, device=dev, _plain_cr=plain)
        check(r.steps == TV_TIMED_STEPS and bool(torch.isfinite(r.xopt).all()),
              f"(i) {TV_TIMED_STEPS} steps, finite ({'plain' if plain else 'kernel'})")
        (plain_t if plain else kernel_t).append(r.runtime)
    print(f"  (i) {TV_TIMED_STEPS}-step runtimes s: kernel {['%.4f' % t for t in kernel_t]}, "
          f"plain {['%.4f' % t for t in plain_t]}")
    print(f"  (i) iter/s best of 3: kernel {TV_TIMED_STEPS / min(kernel_t):.1f}, "
          f"plain {TV_TIMED_STEPS / min(plain_t):.1f}")

    # (j) 2-D TV of a blocky image.
    m = 512
    rng = np.random.default_rng(2)
    truth = np.ones((m, m))
    truth[m // 8: m // 2, m // 4: 3 * m // 4] = 5.0
    truth[5 * m // 8: 7 * m // 8, m // 8: m // 2] = 3.0
    S = torch.from_numpy((truth + rng.standard_normal((m, m))).astype(np.float32)).to(dev)
    cfg2 = ADMMConfig(maxiters=3000, unroll="auto")
    r = totalvariation2d(S, 1.0, cfg2)

    def objective(X):
        tv = torch.sum(torch.abs(torch.diff(X, dim=0))) + torch.sum(torch.abs(torch.diff(X, dim=1)))
        return float(0.5 * torch.sum((X - S) ** 2) + tv)

    print(f"  (j) totalvariation2d {m}x{m} f32: steps={r.steps} runtime={r.runtime:.4f}s "
          f"iter/s {r.steps / r.runtime:.1f}; objective {objective(r.xopt):.6g} "
          f"(noisy image {objective(S):.6g})")
    check(r.steps < cfg2.maxiters and not r.diverged, f"(j) converges before {cfg2.maxiters}")
    check(tuple(r.xopt.shape) == (m, m) and bool(torch.isfinite(r.xopt).all()),
          "(j) xopt finite with shape (512, 512)")
    check(objective(r.xopt) < objective(S), "(j) objective below the noisy image's")
    return launches


def svm_instance(seed, mpos, mneg, sep):
    """tests/test_linearsvm.py's instance (testers/linearsvmtest.m:130-200):
    two classes around the line x1 = x2 with margin ``sep``; (D, ell)."""
    rng = np.random.default_rng(seed)
    base_p = np.linspace(0, 2, mpos)
    base_n = np.linspace(0, 2, mneg)
    pos = np.stack([base_p + rng.random(mpos) - sep * rng.random(mpos),
                    base_p - rng.random(mpos) + sep * rng.random(mpos)], axis=1)
    neg = np.stack([base_n - rng.random(mneg) + sep * rng.random(mneg),
                    base_n + rng.random(mneg) - sep * rng.random(mneg)], axis=1)
    return np.concatenate([pos, neg], axis=0), np.concatenate([np.ones(mpos), -np.ones(mneg)])


def family_objective(family, D, s, x, tau=0.8, C=1.0):
    """Each family's objective at x in NumPy f64 (s is ell for the SVMs)."""
    x = x.double().cpu().numpy()
    r = D @ x - s
    if family == "lad":
        return np.sum(np.abs(r))
    if family == "huberfit":
        a = np.abs(r)
        return np.sum(np.where(a <= 1.0, 0.5 * r * r, a - 0.5))
    if family == "quantile":
        return np.sum(np.maximum(tau * r, (tau - 1.0) * r))
    v = s * (D @ x)
    loss = np.maximum(1.0 - v, 0.0) if family == "hinge" else np.maximum(np.sign(1.0 - v), 0.0)
    return 0.5 * np.sum(x * x) + C * np.sum(loss)


def main_path(tag, solve, eigh=False):
    """Run ``solve`` with every kernel's count (K1-K4) at 0 just before it
    and read just after, its synchronising calls counted, and check that
    none launched, that its xopt is finite on the card and that no
    synchronising call ran inside a sub-step (``eigh``: the calls of
    ``torch.linalg.eigh``, which reads cuSOLVER's info back every call,
    are counted and printed instead), and at most one per chunk plus
    SYNCS_OUTSIDE outside the loop."""
    import torch

    from admm_tpu_torch.ops.gemv_pair import gemv_pair, resident_lasso
    from admm_tpu_torch.ops.kernels import fused_soft_threshold_dual, fused_zu_tail
    from admm_tpu_torch.ops.tridiag import cr_solve

    kernels = {"K1": fused_soft_threshold_dual, "K1b": fused_zu_tail, "K2": gemv_pair,
               "K3": resident_lasso, "K4": cr_solve}
    for k in kernels.values():
        k.launches = 0
    with counting_syncs() as sy:
        r = solve()
        torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    outside = sy["solve"] - sy["steps"] - sy["chunks"]
    print(f"  ({tag}) steps={r.steps} runtime={r.runtime:.4f}s iter/s "
          f"{r.steps / r.runtime:.1f} (setup+solve {r.solverruntime:.4f}s); kernel "
          f"launches {launches}; synchronising calls: {sy['steps']} inside "
          f"{sy['substeps']} sub-steps, {sy['chunks']} chunk reads, {outside} outside the loop")
    check(r.xopt.device.type == "cuda" and bool(torch.isfinite(r.xopt).all())
          and not r.diverged, f"({tag}) xopt finite on the card")
    check(not any(launches.values()), f"({tag}) no K1-K4 launch")
    if eigh:
        print(f"  ({tag}) eigh: {sy['steps'] / sy['substeps']:.3f} synchronising calls per "
              f"sub-step (reported, not held)")
    else:
        check(sy["steps"] == 0, f"({tag}) no synchronising call inside a sub-step")
    check(sy["solve"] <= sy["chunks"] + sy["steps"] + SYNCS_OUTSIDE,
          f"({tag}) at most one per chunk plus {SYNCS_OUTSIDE} outside the loop")
    return r


def against_f64(tag, solve, bar, measure, eigh=False):
    """The converging f32 solve on the main path and the same in f64 on
    the card; checks measure(f32 run, f64 run) <= bar."""
    import torch

    r32 = main_path(tag, lambda: solve(torch.float32), eigh)
    r64 = solve(torch.float64)
    err = measure(r32, r64)
    print(f"  ({tag}) f32: steps={r32.steps} stalled={r32.stalled}; f64: steps={r64.steps} "
          f"stalled={r64.stalled}; error {err:.3e} (bar {bar})")
    check(err <= bar, f"({tag}) f32 within {bar} of f64 on the card")
    return r32, r64


def rel(a, b):
    """||a - b|| / ||b|| of two tensors, in f64."""
    import torch

    return float(torch.linalg.norm(a.double() - b.double()) / torch.linalg.norm(b.double()))


def families_phase(dev):
    """Slices 3 and 4, (s)-(y): none of their runs may launch K1-K4."""
    import torch

    from admm_tpu_torch import (ADMMConfig, basispursuit, fusedlasso, huberfit, lad, linearsvm,
                                quantile, totalvariation)

    timed = ADMMConfig(maxiters=FAMILY_TIMED_STEPS, domaxiters=True, unroll="auto")
    oracle = ADMMConfig(**ORACLE)

    print(f"slices 3 and 4: the generic step's families in f32, {FAMILY_TIMED_STEPS} timed "
          f"steps (fused lasso {FL_TIMED_STEPS}), oracle settings {ORACLE}")

    # (s) basis pursuit.
    rng = np.random.default_rng(3)
    m, n = BP_SHAPE
    D = rng.standard_normal((m, n)).astype(np.float32)
    x_true = rng.standard_normal(n) * (rng.random(n) < 0.1)
    s = (D @ x_true).astype(np.float32)
    Dd = torch.from_numpy(D).to(dev)
    sd = torch.from_numpy(s).to(dev)
    print(f"  (s) basispursuit {m}x{n}, {int(np.sum(x_true != 0))} nonzeros planted")
    main_path("s timed", lambda: basispursuit(Dd, sd, timed))
    # The stall window stops f32 and f64 at the same step short of the
    # optimum: their distance is f32's drift along the path (1.0e-4 on an
    # H100 80GB HBM3 at 700 W), so it is held at 1e-3; the tester's own
    # rules follow.
    r32, r64 = against_f64("s", lambda dt: basispursuit(Dd.to(dt), sd.to(dt), oracle),
                           1e-3, lambda a, b: rel(a.xopt, b.xopt))
    l1, l1_true = float(torch.sum(torch.abs(r32.xopt.double()))), float(np.sum(np.abs(x_true)))
    print(f"  (s) ||xopt - x_true|| / ||x_true|| = "
          f"{np.linalg.norm(r32.xopt.double().cpu().numpy() - x_true) / np.linalg.norm(x_true):.3e}"
          f"; ||xopt||_1 {l1:.6f} (f64 {float(torch.sum(torch.abs(r64.xopt))):.6f}), "
          f"||x_true||_1 {l1_true:.6f}")
    check(l1 <= l1_true * (1 + 1e-6) + 1e-8, "(s) ||xopt||_1 <= ||x_true||_1")
    # The reference tester's error (testers/problems.py basispursuittest),
    # to which matrix.py's f32 bar of 1e-4 applies.
    Dx = D.astype(np.float64) @ r32.xopt.double().cpu().numpy()
    relerror = float(np.mean(np.abs((Dx - s) / Dx)))
    print(f"  (s) mean|(D xopt - s) / D xopt| = {relerror:.3e} (bar 1e-4)")
    check(relerror <= 1e-4, "(s) the tester's constraint error within 1e-4")

    # (t) the fused lasso on the staircase.
    sig = staircase(FL_N)
    sigd = torch.from_numpy(sig).to(dev)
    print(f"  (t) fusedlasso n={FL_N}, lam1 0.1, lam2 0.5")
    main_path("t timed", lambda: fusedlasso(
        sigd, 0.1, 0.5, ADMMConfig(maxiters=FL_TIMED_STEPS, domaxiters=True, unroll="auto")))
    soft = main_path("t lam2=0", lambda: fusedlasso(sigd, 0.1, 0.0, oracle))
    truth = np.sign(sig) * np.maximum(np.abs(sig) - 0.1, 0.0)
    err = np.linalg.norm(soft.xopt.double().cpu().numpy() - truth) / np.linalg.norm(truth)
    print(f"  (t) lam2 = 0 against the soft threshold: {err:.3e} (bar 1e-3)")
    check(err <= 1e-3, "(t) lam2 = 0 within 1e-3 of the closed form")
    fused = main_path("t lam1=0", lambda: fusedlasso(sigd, 0.0, 0.5, oracle))
    tv = totalvariation(sigd, 0.5, oracle)
    err = rel(fused.xopt, tv.xopt)
    print(f"  (t) lam1 = 0 against totalvariation (steps {tv.steps}): {err:.3e} (bar 2e-2)")
    check(err <= 2e-2, "(t) lam1 = 0 within 2e-2 of totalvariation")

    # (u)-(w) the normal-equations families on one D.
    rng = np.random.default_rng(4)
    m, n = REG_SHAPE
    D = rng.standard_normal((m, n)).astype(np.float32)
    s = rng.standard_normal(m).astype(np.float32)
    D64, s64 = D.astype(np.float64), s.astype(np.float64)
    Dd, sd = torch.from_numpy(D).to(dev), torch.from_numpy(s).to(dev)
    solvers = {"lad": (lambda D_, s_, c: lad(D_, s_, c), 1e-2),
               "huberfit": (lambda D_, s_, c: huberfit(D_, s_, c), 1e-3),
               "quantile": (lambda D_, s_, c: quantile(D_, s_, 0.8, c), 1e-2)}
    for tag, (family, (solve, bar)) in zip("uvw", solvers.items()):
        print(f"  ({tag}) {family} {m}x{n}")
        main_path(f"{tag} timed", lambda: solve(Dd, sd, timed))
        against_f64(tag, lambda dt: solve(Dd.to(dt), sd.to(dt), oracle), bar,
                    lambda a, b: abs(family_objective(family, D64, s64, a.xopt)
                                     - family_objective(family, D64, s64, b.xopt))
                    / abs(family_objective(family, D64, s64, b.xopt)))

    # (x) the linear SVM at matrix.py's size.
    rng = np.random.default_rng(5)
    D = rng.standard_normal((m, n)).astype(np.float32)
    ell = np.sign(D @ rng.standard_normal(n) + 0.1 * rng.standard_normal(m)).astype(np.float32)
    D64, ell64 = D.astype(np.float64), ell.astype(np.float64)
    Dd, elld = torch.from_numpy(D).to(dev), torch.from_numpy(ell).to(dev)
    print(f"  (x) linearsvm {m}x{n}, hinge, C = 1")
    main_path("x timed", lambda: linearsvm(Dd, elld, 1.0, timed))
    against_f64("x", lambda dt: linearsvm(Dd.to(dt), elld.to(dt), 1.0, oracle), 1e-3,
                lambda a, b: abs(family_objective("hinge", D64, ell64, a.xopt)
                                 - family_objective("hinge", D64, ell64, b.xopt))
                / abs(family_objective("hinge", D64, ell64, b.xopt)))

    # (y) the linear-SVM oracle.
    D, ell = svm_instance(0, 128, 128, 0.5)
    D32, ell32 = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (D, ell))
    for loss in ("hinge", "01"):
        r = main_path(f"y {loss}", lambda: linearsvm(
            D32, ell32, 1.0, ADMMConfig(objevals=True, maxiters=1000), loss=loss))
        x = r.xopt.double().cpu().numpy()
        slope = abs(1.0 - (-x[1] / x[0]))
        f, f_ref = (family_objective(loss, D, ell, torch.from_numpy(v))
                    for v in (x, np.array([1.0, -1.0])))
        print(f"  (y) {loss}: slope error {slope:.4f} (bar 0.05), objective {f:.6f} "
              f"(at [1, -1]: {f_ref:.6f})")
        check(slope <= 0.05 and f < f_ref, f"(y) {loss}: slope within 0.05, objective below "
              "the one at [1, -1]")


def medium_precision_mode(dev):
    """What ``config.matmul_precision('default')`` (torch's 'medium') makes
    of a float32 matmul on this card, against 'highest' and f64: the
    relative error of a 512 x 512 product, and the mode it points to."""
    import torch

    from admm_tpu_torch.config import matmul_precision

    g = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.randn(512, 512, device=dev, generator=g) for _ in range(2))
    ref = a.double() @ b.double()
    errs = {}
    for mode in ("highest", "default"):
        with matmul_precision(mode):
            errs[mode] = rel(a @ b, ref)
            torch_mode = torch.get_float32_matmul_precision()
    name = ("full f32" if errs["default"] < 1e-5 else
            "TF32 (tensor cores, 10-bit mantissa)" if errs["default"] < 1.5e-3 else
            "bf16 passes")
    print(f"  matmul_precision('default') -> torch '{torch_mode}': a 512x512 f32 product is "
          f"{errs['default']:.3e} from f64 ('highest': {errs['highest']:.3e}), i.e. {name}")
    return name


def _covsel_objective(S64, lam, r):
    """tr(S X) - logdet X + lam ||Z||_1 in NumPy f64."""
    X, Z = (v.double().cpu().numpy() for v in (r.xopt, r.zopt))
    sign, logdet = np.linalg.slogdet(X)
    return np.trace(S64 @ X) - logdet + lam * np.sum(np.abs(Z)) if sign > 0 else np.inf


def _projection_controls(tag, W64):
    """Hold the port's f32 PSD projection of ``W64`` (``ops/prox.psd_project``)
    within 1e-5 of the f64 one, and print two controls beside it: torch's
    own f32 eigh (cuSOLVER's Jacobi syevj) and W rounded to bf16."""
    import torch

    from admm_tpu_torch.ops.prox import _sym, psd_project

    ref = psd_project(W64)
    port = rel(psd_project(W64.float()), ref)
    e, Q = torch.linalg.eigh(_sym(W64.float()))
    syevj = rel((Q * torch.clamp_min(e, 0.0).unsqueeze(-2)) @ Q.T, ref)
    bf16 = rel(psd_project(W64.to(torch.bfloat16).double()), ref)
    print(f"  ({tag}) one f32 PSD projection of X + U from the f64 run, against f64: "
          f"{port:.3e} (bar 1e-5); controls: torch's f32 eigh {syevj:.3e}, W in bf16 {bf16:.3e}")
    check(port <= 1e-5, f"({tag}) the f32 PSD projection within 1e-5 of f64")


def programs_phase(dev):
    """Slice 5 and the spectral half of slice 7, (z1)-(z10): none of their
    runs may launch K1-K4."""
    import torch

    from admm_tpu_torch import (ADMMConfig, covarianceselection, linearprogram,
                                quadraticprogram, sdp)
    from admm_tpu_torch.config import matmul_precision
    from admm_tpu_torch.models.sdp import random_sdp_instance

    oracle = ADMMConfig(**ORACLE)
    t0 = time.perf_counter()

    def timed(steps):
        return ADMMConfig(maxiters=steps, domaxiters=True, unroll="auto")

    def on_card(*arrays):
        return [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrays]

    print(f"slices 5 and 7 (spectral half): LP, QP, covariance selection and SDP in f32, "
          f"timed under domaxiters, oracle settings {ORACLE}")

    # (z1), (z2) the LP at matrix.py's width, affine and factored KKT.
    rng = np.random.default_rng(6)
    n = LP_N
    x_true = np.abs(rng.standard_normal(n))
    D = np.abs(rng.standard_normal((n // 2, n)))
    s, b = D @ x_true, rng.random(n) + 0.5
    Dd, sd, bd = on_card(D, s, b)
    b64 = b.astype(np.float32).astype(np.float64)
    lp_obj = lambda r: float(b64 @ r.xopt.double().cpu().numpy())  # noqa: E731
    for tag, mode in (("z1", "affine"), ("z2", "chol")):
        print(f"  ({tag}) linearprogram n={n}, D |N(0,1)| {n // 2}x{n}, kkt_mode={mode!r}")
        main_path(f"{tag} timed", lambda: linearprogram(bd, Dd, sd, timed(PROGRAM_TIMED_STEPS),
                                                        kkt_mode=mode))
        r32, r64 = against_f64(
            tag, lambda dt: linearprogram(bd.to(dt), Dd.to(dt), sd.to(dt), oracle,
                                          kkt_mode=mode), 1e-4,
            lambda a, c: abs(lp_obj(a) - lp_obj(c)) / abs(lp_obj(c)))
        print(f"  ({tag}) ||x_f32 - x_f64|| / ||x_f64|| = {rel(r32.xopt, r64.xopt):.3e}; "
              f"||D x_f32 - s|| / ||s|| = {rel(Dd @ r32.xopt, sd):.3e}")
    # matrix.py's own LP is square (n x n): print what f32 makes of it.
    Dsq = np.abs(rng.standard_normal((n, n)))
    ssq = Dsq @ x_true
    (Dsq_d, ssq_d) = on_card(Dsq, ssq)
    info = int(torch.linalg.cholesky_ex(Dsq_d.double() @ Dsq_d.double().T)[1])
    with matmul_precision("highest"):
        info32 = int(torch.linalg.cholesky_ex(Dsq_d @ Dsq_d.T)[1])
    sq = linearprogram(bd, Dsq_d, ssq_d, ADMMConfig(maxiters=200))
    print(f"  (z2) matrix.py's square {n}x{n} D: cond(D) {np.linalg.cond(Dsq):.3e}; Cholesky "
          f"of D D^T info f64 {info}, f32 {info32} (0: factored); an f32 solve stops after "
          f"{sq.steps} steps, diverged={sq.diverged}, stalled={sq.stalled} (printed, not held)")

    # (z3) the standard-form QP, (z4) the bounded QP.
    G = rng.standard_normal((n, n))
    P = G @ G.T + n * np.eye(n)
    q = rng.standard_normal(n)
    Dq = rng.standard_normal((n // 2, n)) / np.sqrt(n)
    Pd, qd, Dqd, sqd = on_card(P, q, Dq, Dq @ x_true)
    print(f"  (z3) quadraticprogram standard n={n}, P = G G^T + n I, D N(0,1)/sqrt(n) "
          f"{n // 2}x{n}")
    main_path("z3 timed", lambda: quadraticprogram(Pd, qd, 0.0, Dqd, sqd,
                                                   timed(PROGRAM_TIMED_STEPS)))
    against_f64("z3", lambda dt: quadraticprogram(Pd.to(dt), qd.to(dt), 0.0, Dqd.to(dt),
                                                  sqd.to(dt), oracle), 5e-3,
                lambda a, c: rel(a.xopt, c.xopt))
    # matrix.py's QP constraint block is square too: print its f32 error.
    Dsq = rng.standard_normal((n, n)) / np.sqrt(n)
    Dsq_d, ssq_d = on_card(Dsq, Dsq @ x_true)
    sq = [quadraticprogram(Pd.to(dt), qd.to(dt), 0.0, Dsq_d.to(dt), ssq_d.to(dt), oracle)
          for dt in (torch.float32, torch.float64)]
    print(f"  (z3) matrix.py's square {n}x{n} D: cond(D) {np.linalg.cond(Dsq):.3e}; f32 "
          f"{sq[0].steps} steps (diverged={sq[0].diverged}, stalled={sq[0].stalled}), f64 "
          f"{sq[1].steps}; "
          f"||x_f32 - x_f64|| / ||x_f64|| = {rel(sq[0].xopt, sq[1].xopt):.3e} (printed, not held)")
    n2 = QPB_N
    G = rng.standard_normal((n2, n2))
    Pb, qb = G @ G.T + n2 * np.eye(n2), rng.standard_normal(n2)
    Pbd, qbd, lbd, ubd = on_card(Pb, qb, -np.ones(n2), np.ones(n2))
    print(f"  (z4) quadraticprogram bounded n={n2}, box [-1, 1]")
    main_path("z4 timed", lambda: quadraticprogram(Pbd, qbd, 0.0, lbd, ubd,
                                                   timed(PROGRAM_TIMED_STEPS)))
    against_f64("z4", lambda dt: quadraticprogram(Pbd.to(dt), qbd.to(dt), 0.0, lbd.to(dt),
                                                  ubd.to(dt), oracle), 5e-3,
                lambda a, c: rel(a.xopt, c.xopt))

    # (z5) covariance selection at n = 256, eigh and ns; (z6) at n = 512,
    # ns and ns_fast, with eigh as their reference on the card.  Each
    # converging run is held against the same solve in f64 on the card.
    mode = medium_precision_mode(dev)
    for tag, nc, methods in (("z5", COVSEL_N[0], ("eigh", "ns")),
                             ("z6", COVSEL_N[1], ("ns", "ns_fast", "eigh"))):
        Dc = rng.standard_normal((4 * nc, nc)).astype(np.float32)
        S64 = np.cov(Dc.astype(np.float64), rowvar=False)
        (Dcd,) = on_card(Dc)
        obj = lambda r: _covsel_objective(S64, 0.1, r)  # noqa: E731
        runs = {}
        for method in methods:
            eigh = method == "eigh"
            kw = {"ns_iters": 14} if method == "ns_fast" else {}
            print(f"  ({tag}) covarianceselection n={nc}, D ({4 * nc}, {nc}), lambda 0.1, "
                  f"prox_method={method!r} {kw}")
            if tag == "z5" or not eigh:
                main_path(f"{tag} {method} timed", lambda: covarianceselection(
                    Dcd, 0.1, timed(COVSEL_TIMED_STEPS), prox_method=method, **kw), eigh)
            runs[method], _ = against_f64(
                f"{tag} {method}", lambda dt: covarianceselection(
                    Dcd.to(dt), 0.1, oracle, prox_method=method, **kw), 1e-3,
                lambda a, c: abs(obj(a) - obj(c)) / abs(obj(c)), eigh)
        ref = runs["eigh"]
        for method, r in runs.items():
            if method == "eigh":
                continue
            err = abs(obj(r) - obj(ref)) / abs(obj(ref))
            print(f"  ({tag}) {method} against eigh on the card: objective {err:.3e} (bar 1e-3),"
                  f" ||dX|| / ||X|| {rel(r.xopt, ref.xopt):.3e}, steps {r.steps} / {ref.steps}"
                  + (f"; square-root steps in {mode}" if method == "ns_fast" else ""))
            check(err <= 1e-3, f"({tag}) {method} within 1e-3 of eigh")

    # (z7) the max-cut SDP (diag constraint), eigh and ns; (z8) the dense
    # constraint stack.
    ns_ = SDP_DIAG_N
    W = np.triu(rng.random((ns_, ns_)) < 0.1, 1).astype(np.float64)
    W = W + W.T
    (Cd,) = on_card(-0.25 * (np.diag(W.sum(-1)) - W))
    ones = torch.ones(ns_, device=dev)
    sdp_obj = lambda r: float(torch.sum(Cd.double() * r.zopt.double()))  # noqa: E731
    # Held against the same steps in f64 on the card: ~4e-6 is what a
    # sound f32 run reads (Newton-Schulz here, LAPACK's f32 eigh on the
    # host), 3.5e-3 what torch's own f32 eigh (cuSOLVER's syevj) reads,
    # which is why ops/prox.sym_eigh decomposes f32 matrices in f64.
    for method, kw in (("eigh", {}), ("ns", {"ns_iters": 16})):
        print(f"  (z7) sdp max-cut n={ns_}, 10% edges, A='diag', prox_method={method!r} {kw}")
        r = main_path(f"z7 {method} timed", lambda: sdp(
            Cd, "diag", ones, timed(SDP_DIAG_TIMED_STEPS), prox_method=method, **kw),
            method == "eigh")
        r64 = sdp(Cd.double(), "diag", ones.double(), timed(SDP_DIAG_TIMED_STEPS),
                  prox_method=method, **kw)
        err = rel(r.zopt, r64.zopt)
        print(f"  (z7) {method}: <C, Z> = {sdp_obj(r):.6f}, the same steps in f64 "
              f"{sdp_obj(r64):.6f}; ||Z_f32 - Z_f64|| / ||Z_f64|| = {err:.3e} (bar 1e-4)")
        check(err <= 1e-4, f"(z7) {method}: Z within 1e-4 of the same steps in f64")
        if method == "eigh":
            _projection_controls("z7", r64.xopt + r64.uopt)
    # The dense stack's drift comes from the affine projection's rounding
    # (||C|| / rho is large beside ||X||): 3.5e-4 with LAPACK's f32 eigh on
    # the host, 1.6e-3 with torch's f32 eigh on the card.
    C, A, b, *_ = random_sdp_instance(*SDP_DENSE, rng, dtype=np.float32)
    Cd, Ad, bd_ = on_card(C, A, b)
    print(f"  (z8) sdp dense, random_sdp_instance{SDP_DENSE}: A {tuple(A.shape)}")
    r = main_path("z8 timed", lambda: sdp(Cd, Ad, bd_, timed(SDP_DENSE_TIMED_STEPS)), True)
    r64 = sdp(Cd.double(), Ad.double(), bd_.double(), timed(SDP_DENSE_TIMED_STEPS))
    err = rel(r.zopt, r64.zopt)
    print(f"  (z8) <C, Z> = {sdp_obj(r):.6f}, the same steps in f64 {sdp_obj(r64):.6f}; "
          f"||Z_f32 - Z_f64|| / ||Z_f64|| = {err:.3e} (bar 1e-3)")
    check(err <= 1e-3, "(z8) Z within 1e-3 of the same steps in f64")
    _projection_controls("z8", r64.xopt + r64.uopt)
    # X is the affine projection: A(X) = b to rounding, as a backward error.
    Af, b64 = Ad.double().reshape(Ad.shape[0], -1), bd_.double()
    normA = float(torch.linalg.matrix_norm(Af, 2))
    for res in (r, r64):
        X = res.xopt.double()
        back = float(torch.linalg.norm(Af @ X.reshape(-1) - b64)
                     / (normA * torch.linalg.norm(X) + torch.linalg.norm(b64)))
        eps = torch.finfo(res.xopt.dtype).eps
        print(f"  (z8) {res.xopt.dtype}: ||A(X) - b|| / (||A|| ||X|| + ||b||) = {back:.3e} "
              f"= {back / eps:.0f} eps (bar 1e4 eps)")
        check(back <= 1e4 * eps, f"(z8) {res.xopt.dtype}: A(X) = b within 1e4 eps")

    # (z9) matrix.py's SDP gap oracle.
    C, A, b, Xs, *_ = random_sdp_instance(16, 24, 6, rng, dtype=np.float32)
    pstar = float(np.sum(C.astype(np.float64) * Xs.astype(np.float64)))
    Cd, Ad, bd_ = on_card(C, A, b)
    for method, bar in (("eigh", 1e-3), ("ns", 1e-2)):
        r = main_path(f"z9 {method}", lambda: sdp(Cd, Ad, bd_, oracle, prox_method=method,
                                                  ns_iters=30), method == "eigh")
        gap = abs(float(np.sum(C.astype(np.float64) * r.zopt.double().cpu().numpy())) - pstar)
        gap /= max(1.0, abs(pstar))
        print(f"  (z9) sdp gap, random_sdp_instance(16, 24, 6), {method}: {gap:.3e} (bar {bar})")
        check(gap <= bar, f"(z9) {method} gap within {bar}")

    # (z10) matrix.py's badly scaled LP, preconditioned, against HiGHS.
    from scipy.optimize import linprog

    m, n = 48, 144
    D = rng.standard_normal((m, n))
    s = D @ np.abs(rng.standard_normal(n))
    b = np.abs(rng.standard_normal(n)) + 0.1
    Gs, Fs = 10.0 ** rng.uniform(-2, 2, m), 10.0 ** rng.uniform(-2, 2, n)
    Dbad = (Gs[:, None] * D * Fs[None, :]).astype(np.float32)
    sbad, bbad = (Gs * s).astype(np.float32), (Fs * b).astype(np.float32)
    out = linprog(bbad.astype(np.float64), A_eq=Dbad.astype(np.float64),
                  b_eq=sbad.astype(np.float64), bounds=[(0, None)] * n, method="highs")
    Dd, sd, bd = on_card(Dbad, sbad, bbad)
    r = main_path("z10 precondition", lambda: linearprogram(bd, Dd, sd, oracle,
                                                            precondition=True))
    plain = linearprogram(bd, Dd, sd, oracle)
    err = abs(float(bbad.astype(np.float64) @ r.xopt.double().cpu().numpy()) - out.fun)
    err /= 1.0 + abs(out.fun)
    print(f"  (z10) preconditioned LP {m}x{n} against HiGHS ({out.fun:.6f}): {err:.3e} "
          f"(bar 2e-3), {r.steps} steps (stalled={r.stalled}); without preconditioning "
          f"{plain.steps} steps (stalled={plain.stalled})")
    check(err <= 2e-3, "(z10) the preconditioned LP within 2e-3 of HiGHS")
    print(f"  (z1)-(z10) took {time.perf_counter() - t0:.1f}s")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible; this script runs only on a GPU")
    sys.path.insert(0, str(ROOT))
    import admm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from admm_tpu_torch.ops import _cuda

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi}")
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, "
          f"count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _cuda.library()
    print(f"nvcc build/load of {', '.join(_cuda.SOURCES)}: {time.perf_counter() - t0:.1f}s")
    k1_err, k1_ms, k1_plain_ms, k1_bound = kernel_phase(dev)
    k1b_err, k1b_ms, k1b_plain_ms, k1b_bound = k1b_phase(dev)
    k4_err, k4_ms, k4_plain_ms, k4_bound = k4_phase(dev)
    k2_err, k2_ms, k2_plain_ms, k2_library_ms, k2_bound = k2_phase(dev)
    k1b_launches, k1_launches, a, d_plain = slice_phase(dev)
    k3_launches, k3_err, k3_ms, k3_plain_ms, k3_bound = k3_phase(dev, a)
    k2_launches = bf16_phase(dev, a)
    k4_launches = tv_phase(dev)
    variants = variants_phase(dev, d_plain)
    families_phase(dev)
    programs_phase(dev)
    print(f"total {time.perf_counter() - t0:.1f}s")

    def row(name, route, source, replaces, launches, err, ms, plain_ms, bnd, library_ms):
        by_path = launches if isinstance(launches, dict) else None
        out = {"name": name, "route": route, "source": source, "replaces": replaces,
               "launches": sum(by_path.values()) if by_path else launches,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}
        if by_path:
            out["launches_by_path"] = by_path
        return out

    # K1: softshrink gives z only; K1b, K3: no library call runs an ADMM
    # step's tail or whole steps; K4: torch has no tridiagonal solve.  K2's
    # row is the f32 K = 1 call, the function multi_dot computes.  K1's
    # launches are those of the paths that take the z/u mode: (d)'s user
    # hook, (n) residual balancing and (o) Anderson acceleration with
    # lasso's fused hook (the main path (a) takes K1b); K2's those of the
    # bf16 paths (k) and (p).
    print(json.dumps({"kernels": [
        row("fused_soft_threshold_dual", "cuda", "admm_tpu_torch/csrc/zu_tail.cu",
            "admm_tpu/ops/kernels.py:48", {"d": k1_launches, **variants["k1"]}, k1_err, k1_ms,
            k1_plain_ms, k1_bound, None),
        row("fused_zu_tail", "cuda", "admm_tpu_torch/csrc/zu_tail.cu",
            "admm_tpu/ops/kernels.py:48", k1b_launches, k1b_err, k1b_ms, k1b_plain_ms,
            k1b_bound, None),
        row("cr_solve", "cuda", "admm_tpu_torch/csrc/cr_solve.cu",
            "experiments/pallas_cr_kernel.py:103", k4_launches, k4_err, k4_ms,
            k4_plain_ms, k4_bound, None),
        row("gemv_pair", "cuda", "admm_tpu_torch/csrc/gemv_pair.cu",
            "experiments/pallas_probe.py:52", {"k": k2_launches, **variants["k2"]}, k2_err,
            k2_ms, k2_plain_ms, k2_bound, k2_library_ms),
        row("resident_lasso", "cuda", "admm_tpu_torch/csrc/gemv_pair.cu",
            "experiments/resident_iter_proto.py:77", k3_launches, k3_err, k3_ms,
            k3_plain_ms, k3_bound, None),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
