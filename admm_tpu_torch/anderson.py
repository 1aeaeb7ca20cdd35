"""Safeguarded type-II Anderson acceleration (``ADMMConfig.anderson``).

``admm_tpu`` writes the window algebra four times, once per runner over
that runner's state (engine.py:744-790 and the consensus, exchange and
transpose-reduction runners).  The port writes it once, here, over a list
of leaves: each leaf keeps its own ring of residuals F and map outputs T,
and the Gram matrix and the right-hand side sum the leaves' contractions.
The core engine passes one leaf, the flattened state (x, z, u), which is
``admm_tpu``'s engine algebra exactly.

Per step, with s the state the step started from and t = T(s) the plain
sweep's output:

  * f = t - s; a residual that grew past ``aa_restart`` times the best
    since the last restart empties the window (restart);
  * f and t go into ring slot ``cnt % (m + 1)``;
  * the last m differences dF, dT in chronological order, those older than
    the restart masked to zero, give gamma from the regularised solve
    (dF dF^T + lam I) gamma = dF f, lam = aa_reg tr(dF dF^T) + eps;
  * the candidate t - gamma dT replaces the next step's start only when it
    is finite, ||gamma||_1 <= aa_gmax, the window holds a difference and
    the solve is not done (safeguard); else the plain t does.

Everything stays on the device: the solve is ``torch.linalg.solve_ex``,
which does not read its status back to the host, and every choice is a
``torch.where``.  A frozen sub-step of an unrolled chunk writes its ring
slot to a spare row past the window, as the engine's history does.
"""

from __future__ import annotations

import torch


class AndersonWindow:
    """The rings of one solve over leaves of ``sizes`` elements: for each
    leaf ``(m + 2, size)`` buffers F and T whose row m + 1 is the spare
    row of frozen sub-steps."""

    def __init__(self, cfg, sizes, *, dtype, device):
        self.cfg = cfg
        self.m = m = int(cfg.anderson)
        self.R = R = m + 1
        rows = lambda size: torch.zeros((R + 1, size), dtype=dtype, device=device)
        self.F = [rows(size) for size in sizes]
        self.T = [rows(size) for size in sizes]
        self.eps = torch.finfo(dtype).eps
        self.ring = torch.arange(R, dtype=torch.int64, device=device)
        self.cols = torch.arange(m, dtype=torch.int64, device=device)
        self.eye = torch.eye(m, dtype=dtype, device=device)
        self.spare = torch.tensor(R, dtype=torch.int64, device=device)

    def initial(self):
        """``(cnt, best)`` before the first step: an empty window and an
        infinite best residual."""
        device, dtype = self.eye.device, self.eye.dtype
        return (torch.zeros((), dtype=torch.int64, device=device),
                torch.full((), float("inf"), dtype=dtype, device=device))

    def step(self, s_in, t_out, cnt, best, *, done, frozen=None):
        """One extrapolation.  ``s_in`` and ``t_out`` are lists of tensors,
        leaf for leaf; ``cnt`` and ``best`` the window's count and best
        residual norm^2; ``done`` this step's stop flag.  Returns
        ``(next, cnt_new, best_new)``: the leaves the next step starts
        from, in ``t_out``'s shapes, and the window's new scalars, which
        the caller keeps or discards under ``frozen`` like any state.  The
        ring rows are written in place (to the spare row when ``frozen``).
        """
        cfg, m, R = self.cfg, self.m, self.R
        s = [a.reshape(-1) for a in s_in]
        t = [a.reshape(-1) for a in t_out]
        f = [ti - si for ti, si in zip(t, s)]
        fn2 = sum(torch.sum(fi * fi) for fi in f)
        grew = fn2 > (cfg.aa_restart ** 2) * best
        cnt = torch.where(grew, 0, cnt)
        best_new = torch.where(grew, fn2, torch.minimum(best, fn2))
        slot = cnt % R
        if frozen is not None:
            slot = torch.where(frozen, self.spare, slot)
        js = (cnt - m + self.ring) % R
        mk = torch.minimum(cnt, torch.full_like(cnt, m))
        live = (self.cols >= (m - mk))[:, None]
        dF, dT = [], []
        for F, T, fi, ti in zip(self.F, self.T, f, t):
            F.index_copy_(0, slot.reshape(1), fi[None])
            T.index_copy_(0, slot.reshape(1), ti[None])
            Fw, Tw = F.index_select(0, js), T.index_select(0, js)
            dF.append(torch.where(live, Fw[1:] - Fw[:-1], 0.0))
            dT.append(torch.where(live, Tw[1:] - Tw[:-1], 0.0))
        G = sum(d @ d.T for d in dF)
        lam = cfg.aa_reg * torch.trace(G) + self.eps
        gamma, _ = torch.linalg.solve_ex(G + lam * self.eye,
                                         sum(d @ fi for d, fi in zip(dF, f)))
        cand = [ti - gamma @ d for ti, d in zip(t, dT)]
        ok = torch.sum(torch.abs(gamma)) <= cfg.aa_gmax
        for c in cand:
            ok = ok & torch.all(torch.isfinite(c))
        ok = ok & (mk >= 1) & ~done
        nxt = [torch.where(ok, c, ti).reshape(a.shape) for c, ti, a in zip(cand, t, t_out)]
        return nxt, cnt + 1, best_new
