"""ADMM engine configuration (port of ``admm_tpu/config.py``).

A frozen dataclass mirroring the reference's ``options`` struct / ``setopt``
resolution (reference: admm.m:51-76 for the reads, admm.m:780-971 for the
per-option documentation and defaults).  Every option name, default and
validation rule matches ``admm_tpu.config.ADMMConfig``, so one config value
means the same thing in both packages.

The config is *static*: it selects which branches the engine runs; the
port's engine runs every one of them.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Static configuration for the ADMM engine.

    Mirrors reference admm.m options (defaults at admm.m:51-76):

    - ``rho``: dual step size (admm.m:57; under ``adaptive`` this is the
      initial rho).
    - ``maxiters``: iteration cap N (admm.m:58).
    - ``domaxiters``: run all N iterations even if converged (admm.m:59).
    - ``relax``: over/under-relaxation parameter; != 1 enables relaxation in
      the z- and u-updates (admm.m:60, 515-532).
    - ``fast`` / ``fasttype``: Goldstein fast ('strong') / accelerated with
      restart ('weak', default) ADMM (admm.m:63-64, 264-298, 563-600).
    - ``restart``: accelerated-ADMM restart fraction (admm.m:282-287).
    - ``dvaltol``: accelerated-ADMM d-value stop tolerance (admm.m:290).
    - ``abstol`` / ``reltol``: Boyd stopping tolerances (admm.m:71-72).
    - ``hnormtol``: H-norm stopping tolerance (admm.m:73).
    - ``convtest`` / ``convtol``: divergence monitor on monotone H-norm
      decrease (admm.m:67-68, 686-703).
    - ``stopcond``: 'standard' | 'hnorm' | 'both' (admm.m:69, 705-722).
    - ``nodualerror``: skip the dual half of the standard stop (admm.m:70).
    - ``adaptive``: experimental adaptive rho (admm.m:51, 724-741).
    - ``objevals``: record the objective each iteration (admm.m:66, 602-605).

    Additions beyond the reference (same meaning as in ``admm_tpu``):

    - ``nanguard``: abort (results.diverged) as soon as the primal norm
      goes non-finite.
    - ``rbadaptive`` / ``rbmu`` / ``rbtau``: residual-balancing adaptive
      rho (Boyd et al. 2011, section 3.4.1).
    - ``record_iterates``: record full per-iteration x/z/u/w traces.
    - ``stallwindow`` / ``stalltol``: plateau detector for reduced
      precision.
    - ``anderson`` / ``aa_reg`` / ``aa_restart`` / ``aa_gmax``:
      safeguarded type-II Anderson acceleration.
    - ``jit``: kept for config compatibility; the port runs eagerly and
      ignores it.
    - ``unroll``: the chunk length K of the engine's host loop.  The
      engine runs K freeze-masked sub-steps between two reads of the stop
      flag by the host, so results, step counts and histories equal
      ``unroll=1`` exactly.  ``'auto'`` resolves per iteration-body class
      (``resolve_unroll``).
    - ``matmul_precision``: float32 matmul precision inside solver scope,
      mapped onto PyTorch's switches by ``matmul_precision`` below:
      ``'highest'`` -> ``torch.set_float32_matmul_precision('highest')``,
      which also sets ``torch.backends.cuda.matmul.allow_tf32 = False``
      (true f32, no TF32); ``'high'`` -> ``'high'`` (TF32 allowed); ``'default'`` ->
      ``'medium'`` (bf16 passes allowed).
    """

    rho: float = 1.0
    maxiters: int = 1000
    domaxiters: bool = False
    relax: float = 1.0
    fast: bool = False
    fasttype: str = "weak"  # 'weak' -> accelerated+restart, 'strong' -> fast
    restart: float = 0.999
    dvaltol: float = 1e-8
    abstol: float = 1e-5
    reltol: float = 1e-3
    hnormtol: float = 1e-6
    convtest: bool = False
    convtol: float = 1e-10
    stopcond: str = "standard"  # 'standard' | 'hnorm' | 'both'
    nodualerror: bool = False
    adaptive: bool = False
    rbadaptive: bool = False
    rbmu: float = 10.0
    rbtau: float = 2.0
    nanguard: bool = True
    stallwindow: int = 0
    stalltol: float = 1e-3
    anderson: int = 0
    aa_reg: float = 1e-8
    aa_restart: float = 5.0
    aa_gmax: float = 1e3
    objevals: bool = False
    quiet: bool = True
    record_iterates: bool = False
    jit: bool = True
    unroll: int | str = 1
    matmul_precision: str = "highest"

    def __post_init__(self):
        if self.stopcond not in ("standard", "hnorm", "both"):
            raise ValueError(f"stopcond must be standard|hnorm|both, got {self.stopcond!r}")
        if self.fasttype not in ("weak", "strong"):
            raise ValueError(f"fasttype must be weak|strong, got {self.fasttype!r}")
        if self.maxiters <= 0:
            raise ValueError("maxiters must be positive")
        # Reference clamps a bad restart fraction back to the default
        # (admm.m:285-287).
        if self.fast and self.fasttype == "weak" and not (0.0 < self.restart < 1.0):
            object.__setattr__(self, "restart", 0.999)
        if self.rbadaptive and self.nodualerror:
            raise ValueError("rbadaptive needs dual residuals (nodualerror=False)")
        if self.rbadaptive and self.adaptive:
            raise ValueError("choose one adaptive-rho mode: adaptive or rbadaptive")
        if self.rbadaptive and self.fast:
            raise ValueError("rbadaptive applies to the standard iteration only")
        if self.stallwindow < 0:
            raise ValueError(f"stallwindow must be >= 0, got {self.stallwindow}")
        if self.anderson < 0:
            raise ValueError(f"anderson must be >= 0, got {self.anderson}")
        if self.anderson:
            if self.fast:
                raise ValueError("anderson applies to the standard "
                                 "iteration only (fast=False)")
            if self.adaptive or self.rbadaptive:
                raise ValueError("anderson requires a fixed rho (no "
                                 "adaptive/rbadaptive)")
            if self.convtest or self.stopcond != "standard":
                raise ValueError("anderson breaks H-norm monotonicity: "
                                 "use stopcond='standard', convtest=False")
        if self.aa_reg < 0 or self.aa_restart <= 1.0 or self.aa_gmax <= 0:
            raise ValueError("need aa_reg >= 0, aa_restart > 1, aa_gmax > 0")
        if not 0.0 <= self.stalltol < 1.0:
            raise ValueError(f"stalltol must be in [0, 1), got {self.stalltol}")
        if self.matmul_precision not in ("default", "high", "highest"):
            raise ValueError(
                "matmul_precision must be default|high|highest, got "
                f"{self.matmul_precision!r}")
        if isinstance(self.unroll, str):
            if self.unroll != "auto":
                raise ValueError(
                    f"unroll must be an int >= 1 or 'auto', got {self.unroll!r}")
        elif self.unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {self.unroll}")

    @property
    def resolved(self) -> bool:
        """Whether unroll has been resolved to a concrete int."""
        return not isinstance(self.unroll, str)

    @property
    def alg(self) -> int:
        """Algorithm id, matching the reference's ``alg`` variable
        (admm.m:262-298): 0 = standard, 1 = fast (strong convexity),
        2 = accelerated with restart (weak convexity)."""
        if not self.fast:
            return 0
        return 1 if self.fasttype == "strong" else 2

    @property
    def needs_hnorm(self) -> bool:
        """Whether the H-norm machinery is needed (admm.m:302-313)."""
        return self.convtest or self.stopcond in ("hnorm", "both")

    @property
    def use_stall(self) -> bool:
        """Whether the plateau detector runs (see ``stallwindow``);
        domaxiters wins, as it does for the standard and hnorm stops."""
        return self.stallwindow > 0 and not self.domaxiters

    @property
    def dynamic_rho(self) -> bool:
        """Whether rho can change at runtime — prox builders must then use
        the rho-parameterized (eigh-folded) solve paths."""
        return self.adaptive or self.rbadaptive


# unroll='auto' resolution table, by iteration-body class.  The classes
# and values are those of admm_tpu; the values were chosen for another
# device and are to be measured again on the GPU before they are tuned:
#
# - 'gemv': bodies that are a handful of GEMVs + vector ops (lasso, lad,
#   huberfit, model, basis pursuit, serial SVM, LP/QP in affine mode).
# - 'heavy': bodies dominated by an in-loop eigh / Newton-Schulz /
#   triangular sweep, where masked redundant sub-steps cost more than the
#   host round trips they save.
# - 'batched': instance-batched lanes.
# - 'default': unknown body (engine called directly with a user prox).
_AUTO_UNROLL = {"gemv": 16, "heavy": 1, "batched": 1, "default": 4}


def resolve_unroll(config: ADMMConfig, body: str = "default") -> ADMMConfig:
    """Resolve ``unroll='auto'`` to a concrete K for the given
    iteration-body class (no-op for concrete ints)."""
    if isinstance(config.unroll, str):
        return dataclasses.replace(config, unroll=_AUTO_UNROLL[body])
    return config


_TORCH_PRECISION = {"highest": "highest", "high": "high", "default": "medium"}


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Pin float32 matmul precision for the duration of the block and
    restore the caller's settings afterwards, so that a caller's global
    TF32 setting neither leaks into a solve nor is changed by it.

    ``precision`` is an ``ADMMConfig.matmul_precision`` value; see the
    mapping in the ``ADMMConfig`` docstring.  Only the generic setting is
    written: PyTorch derives ``torch.backends.cuda.matmul.allow_tf32``
    from it ('highest' turns TF32 off), and writing both switches leaves
    PyTorch's precision state marked as mixed, after which reading the
    generic setting raises."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_TORCH_PRECISION[precision])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)
