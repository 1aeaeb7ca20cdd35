"""Run the port's code in a few processes joined by one gloo process group
on the CPU: the helper of the multi-process tests (the port's counterpart
of tests/test_multihost.py's ``_run_workers``), over the package's own
launcher ``parallel.multihost.run_ranks``.

Each worker joins the group through ``initialize_cluster`` (a file
rendezvous in the test's tmp_path, so no port is taken and xdist workers
cannot collide; a 60 s collective timeout, so a rank that stops issuing
collectives fails the others instead of hanging them) and runs the
test's code with ``mesh`` (the global mesh), ``rank`` and
``save(**arrays)`` defined.  Every worker runs one thread and the whole
run is bounded by a subprocess timeout.
"""

from pathlib import Path

import pytest

from admm_tpu_torch.parallel.multihost import SENTINEL
from admm_tpu_torch.parallel.multihost import run_ranks as _launch

_TESTS = str(Path(__file__).resolve().parent)


def run_ranks(code, tmp_path, procs=2, timeout=120, join=None):
    """Run ``code`` in ``procs`` processes (``join``: ``initialize_cluster``'s
    keywords besides the rendezvous and the 60 s collective timeout, by
    default the CPU with gloo); returns ``(rc, initialized, output,
    results)``: the first nonzero exit code, whether every worker printed
    the sentinel, their output, and each rank's saved arrays (dicts, None
    for a rank that saved nothing)."""
    join = dict(device="cpu") if join is None else join
    rc, outs, results = _launch(code, procs, tmp_path, timeout, join=dict(join, timeout=60),
                                path=[_TESTS])
    return rc, all(SENTINEL in o for o in outs), "\n--- worker ---\n".join(outs), results


def same_on_every_rank(results):
    """Every rank saved the same arrays, bit for bit (steps, histories,
    whole results: what every rank computes from all-reduced values)."""
    first = results[0]
    assert first, "rank 0 saved nothing"
    for other in results[1:]:
        assert set(other) == set(first)
        for key, val in first.items():
            assert val.shape == other[key].shape and val.tobytes() == other[key].tobytes(), key


def check(rc, initialized, output, *_):
    """Skip only when the group could not be joined; any failure after the
    sentinel fails the test (tests/test_multihost.py's policy)."""
    if rc != 0 and not initialized:
        pytest.skip("torch.distributed (gloo) unavailable in this environment:\n"
                    + output[-2000:])
    assert rc == 0, (
        "cross-process worker FAILED after initialize_cluster: a real distributed-path "
        "regression, not an environment flake:\n" + output[-4000:])
