"""The seeded generators: the same seed gives the same inputs, every seed
the same work in another order, and the port and the reference get the
same inputs."""

import itertools

import pytest
import torch

from benchlib import runner, spec
from families.common import rounds

CELLS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]
BIG = 2**31 + 987654321


def _pool_tensors(pool):
    return [v for v in vars(pool).values() if isinstance(v, torch.Tensor)]


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(small_root, name):
    c = spec.cell(name, small_root)
    cpu = torch.device("cpu")
    a = c.family.make_pool(c.config, c.traffic, BIG, cpu)
    b = c.family.make_pool(c.config, c.traffic, BIG, cpu)
    d = c.family.make_pool(c.config, c.traffic, BIG + 1, cpu)
    for x, y, z in zip(_pool_tensors(a), _pool_tensors(b), _pool_tensors(d)):
        assert torch.equal(x, y)
        assert not torch.equal(x, z)
    sa = list(itertools.islice(c.family.requests(c.config, c.traffic, BIG, a), 40))
    sb = list(itertools.islice(c.family.requests(c.config, c.traffic, BIG, b), 40))
    assert [s.entry for s in sa] == [s.entry for s in sb]
    for s, t in zip(sa, sb):
        assert torch.equal(torch.as_tensor(s.lam), torch.as_tensor(t.lam))


def test_every_seed_gets_the_same_work_in_another_order():
    one = list(itertools.islice(rounds(3, 32), 64))
    two = list(itertools.islice(rounds(2**40 + 3, 32), 64))
    assert one != two
    for r in (one, two):
        assert sorted(r[:32]) == sorted(r[32:]) == list(range(32))


@pytest.mark.parametrize("name", CELLS)
def test_seed_flips_or_permutes_the_same_problems(small_root, name):
    """Two seeds' pools hold the same problems: LASSO instances with their
    rows and columns permuted and column signs flipped, TV signals with
    their signs flipped, so each solve's work is the seed's alone in order."""
    c = spec.cell(name, small_root)
    cpu = torch.device("cpu")
    a = _pool_tensors(c.family.make_pool(c.config, c.traffic, 5, cpu))[0]
    b = _pool_tensors(c.family.make_pool(c.config, c.traffic, 2**31 + 6, cpu))[0]
    for x, y in zip(a, b):
        key = lambda t: torch.sort(t.abs().flatten()).values  # noqa: E731
        assert torch.equal(key(x), key(y))


@pytest.mark.parametrize("name", CELLS)
def test_port_and_reference_get_the_same_inputs(small_root, name, monkeypatch):
    c = spec.cell(name, small_root)
    seen = {"port": {}, "ref": {}}
    port = c.family.port(c.config, c.traffic)

    def system(pool, sp):
        seen["port"][sp.index] = (sp.entry, sp.lam)
        return port(pool, sp)

    real_ref = c.family.reference

    def reference(config, pool, sp, stop_at=None, precision="float64"):
        seen["ref"][sp.index] = (sp.entry, sp.lam)
        return real_ref(config, pool, sp, stop_at=stop_at, precision=precision)

    monkeypatch.setattr(c.family, "reference", reference)
    res = runner.run_cell(c, BIG, 0.3, False, torch.device("cpu"), 0.0, system=system,
                          log=lambda s: None)
    assert res["correct"]
    assert seen["ref"] and set(seen["ref"]) <= set(seen["port"])
    for i, (entry, lam) in seen["ref"].items():
        assert seen["port"][i][0] == entry
        assert torch.equal(torch.as_tensor(seen["port"][i][1]), torch.as_tensor(lam))
