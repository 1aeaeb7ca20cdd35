"""Problem families of the port (``admm_tpu/models`` counterparts): solver
wrappers plus the string-keyed proximal-operator registry.

Ported so far: the serial LASSO, elastic net, NNLS and group lasso, the
model problem, 1-D and 2-D total variation, basis pursuit, the fused
lasso, LAD, Huber fitting, quantile regression, the linear SVM and the
serial unwrapped-ADMM solver, the standard-form LP, the QP in both
constraint forms, covariance selection, the standard-form SDP, robust
PCA, matrix completion and sparse logistic regression; the instance
batches of every family (``batch.py``) and the regularization paths
(``paths.py``), whose lanes run as one solve.  Each
module exposes ``make_prox_ops(...)`` and a solver entry point with the
reference solver's signature plus ``device=``; ``get_prox_ops`` resolves a
family by name.
"""

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn

    return deco


def get_prox_ops(problem: str, args=None, **kwargs):
    """String-keyed prox-op factory mirroring getproxops(problem, args)
    (reference getProxOps.m:13-31; ``admm_tpu.models.get_prox_ops``).
    ``args`` may be a struct (dict) of problem arguments, exactly like the
    reference's second positional argument (validated by
    errorcheck('isstruct'), errorcheck.m:117), or the arguments may be
    passed as keywords.  Returns closures ``(prox_f, prox_g, obj)`` over
    the family's setup, which runs under full-precision matmuls like a
    solver's.  The operands go to ``device=`` (a keyword or an ``args``
    entry), or to the device of the first tensor among them, or to the
    CUDA device (``device.resolve_device``), as a solver's do.  Prefer the
    typed per-module ``make_prox_ops`` in new code."""
    from ..config import matmul_precision

    key = problem.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown problem {problem!r}; known: {sorted(_REGISTRY)}")
    if args is not None:
        from ..utils.validate import errorcheck

        kwargs = {**errorcheck(args, "isstruct", "args"), **kwargs}
    with matmul_precision("highest"):
        return _REGISTRY[key](**kwargs)


from .basispursuit import basispursuit  # noqa: E402
from .covarianceselection import covarianceselection  # noqa: E402
from .elasticnet import elasticnet  # noqa: E402
from .fusedlasso import fusedlasso  # noqa: E402
from .grouplasso import grouplasso  # noqa: E402
from .huberfit import huberfit  # noqa: E402
from .lad import lad  # noqa: E402
from .lasso import lasso  # noqa: E402
from .linearprogram import linearprogram  # noqa: E402
from .linearsvm import linearsvm  # noqa: E402
from .logreg import logreg  # noqa: E402
from .matrixcompletion import matrixcompletion  # noqa: E402
from .model import model  # noqa: E402
from .nnls import nnls  # noqa: E402
from .quadraticprogram import quadraticprogram  # noqa: E402
from .quantile import quantile  # noqa: E402
from .rpca import rpca  # noqa: E402
from .sdp import sdp  # noqa: E402
from .totalvariation import totalvariation  # noqa: E402
from .totalvariation2d import totalvariation2d  # noqa: E402
from .unwrapped import unwrappedadmm  # noqa: E402

__all__ = [
    "get_prox_ops",
    "register",
    "model",
    "lasso",
    "elasticnet",
    "grouplasso",
    "nnls",
    "basispursuit",
    "totalvariation",
    "totalvariation2d",
    "lad",
    "fusedlasso",
    "quantile",
    "huberfit",
    "linearsvm",
    "unwrappedadmm",
    "linearprogram",
    "quadraticprogram",
    "covarianceselection",
    "sdp",
    "rpca",
    "matrixcompletion",
    "logreg",
]
