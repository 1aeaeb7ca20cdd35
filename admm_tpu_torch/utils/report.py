"""Result reporting: text summary + convergence plots (port of
``admm_tpu/utils/report.py``; reference showresults.m).

``showresults`` renders the same text as ``admm_tpu``'s: header, objective
values, steps, runtimes, final rho, flags, final residuals and pass/fail
with its reason (showresults.m:34-166); with ``show_plots`` or
``save_plots`` it draws the stack of convergence panels (objective,
H-norm, primal and dual norms against their tolerance curves, accelerated
d-values; showresults.m:200-408).  matplotlib is imported only when a
plot is asked for, and its absence then raises ``ImportError``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..results import ADMMResults


def _num(v):
    """A Python number or numpy array of ``v`` (tensor, array or number)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return v


def showresults(
    results: ADMMResults,
    test: Optional[dict] = None,
    *,
    show_plots: bool = False,
    save_plots: Optional[str] = None,
    print_fn=print,
) -> str:
    """Render a text report (returned and printed); optionally plot."""
    lines = []
    push = lines.append
    push("=" * 64)
    push("ADMM results")
    push("=" * 64)
    if test:
        if "solver" in test:
            push(f"solver:            {test['solver']}")
        if "trueobjopt" in test:
            push(f"true objective:    {test['trueobjopt']:.10g}")
        if "testobj" in test:
            push(f"test objective:    {test['testobj']:.10g}")
    if results.objopt is not None:
        push(f"ADMM objective:    {results.objopt:.10g}")
    push(f"steps:             {results.steps}")
    push(f"runtime:           {results.runtime:.4f} s")
    if results.solverruntime:
        push(f"solver runtime:    {results.solverruntime:.4f} s")
    push(f"final rho:         {results.rho_final:.6g}")
    push(f"diverged:          {results.diverged}")
    if results.stalled:
        # Plateau stop (ADMMConfig.stallwindow): the run ended at its
        # residual floor, not via a convergence test.
        push("stalled:           True (stopped at the residual plateau)")
    pn = results.pnorm
    if pn is not None and len(pn):
        push(f"final primal norm: {pn[-1]:.6g}  (bound {results.perr[-1]:.6g})")
    dn = results.dnorm
    if dn is not None and len(dn) and np.isfinite(dn[-1]):
        push(f"final dual norm:   {dn[-1]:.6g}  (bound {results.derr[-1]:.6g})")
    if test and "failed" in test:
        push(f"PASSED: {not test['failed']}")
        if test.get("failreason"):
            push(f"reason: {test['failreason']}")
    push("=" * 64)
    text = "\n".join(lines)
    print_fn(text)

    if show_plots or save_plots:
        _plot(results, test, show_plots, save_plots)
    return text


def _pyplot(show):
    """matplotlib's pyplot, headless unless ``show``; a clear ImportError
    where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("admm_tpu_torch.utils: plotting needs matplotlib, which is not "
                          "installed; call without show_plots/save_plots for the text "
                          "report alone") from e
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot(results: ADMMResults, test, show, save):
    plt = _pyplot(show)

    # Denoising overlay: noisy signal vs true vs recovered
    # (reference showresults.m:181-198, for the TV solver).
    if test and "s" in test and np.ndim(test["s"]) == 1:
        fig0, ax0 = plt.subplots(figsize=(7, 3))
        ax0.plot(np.asarray(_num(test["s"])), alpha=0.4, label="noisy s")
        if "truexopt" in test and np.ndim(test["truexopt"]) == 1:
            ax0.plot(np.asarray(_num(test["truexopt"])), lw=1.2, label="true")
        ax0.plot(np.asarray(_num(results.xopt)), lw=1.2, label="recovered")
        ax0.legend(fontsize=8)
        ax0.set_title("signal overlay", fontsize=9)
        fig0.tight_layout()
        if save:
            from pathlib import Path as _P

            sp = _P(str(save))
            overlay = sp.with_name(sp.stem + "_signal" + (sp.suffix or ".png"))
            fig0.savefig(str(overlay), dpi=110)
        if show:
            plt.show()
        else:
            plt.close(fig0)

    # Panel spec: (title, series, scalar threshold, bound curve); the norms
    # against their per-iteration Boyd tolerance curves, the accelerated
    # d-values against the dvaltol stop line (admm.m:618-658, 706-707).
    panels = []
    if results.objevals is not None:
        panels.append(("objective", results.objevals, None, None))
    if results.Hnormsq is not None:
        panels.append(("H-norm^2", results.Hnormsq, results.config.hnormtol, None))
    panels.append(("primal norm", results.pnorm, None, results.perr))
    dn = results.dnorm
    if dn is not None and len(dn) and np.all(np.isfinite(dn)):
        panels.append(("dual norm", dn, None, results.derr))
    if results.dvals is not None:
        dvaltol = getattr(results.config, "dvaltol", None)
        panels.append(("accelerated d-values", results.dvals, dvaltol, None))

    fig, axes = plt.subplots(len(panels), 1, figsize=(7, 2.2 * len(panels)), squeeze=False)
    for ax, (title, series, thresh, bound) in zip(axes[:, 0], panels):
        series = np.asarray(series)
        pos = series[np.isfinite(series) & (series > 0)]
        logscale = len(pos) == len(series[np.isfinite(series)]) and len(pos)
        (ax.semilogy if logscale else ax.plot)(series, label=title)
        if bound is not None:
            b = np.asarray(bound)
            if len(b) == len(series) and np.any(np.isfinite(b)):
                (ax.semilogy if logscale else ax.plot)(
                    b, linestyle="--", linewidth=0.9, label="tolerance bound")
                ax.legend(fontsize=7, loc="upper right")
        if thresh is not None:
            ax.axhline(thresh, linestyle="--", linewidth=0.8)
        ax.set_title(title, fontsize=9)
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=110)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig
