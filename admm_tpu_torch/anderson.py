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
    """The window of one solve over leaves of ``sizes`` elements.  Its rings
    (``rings``) are for each leaf ``(m + 2, size)`` buffers F and T whose
    row m + 1 is the spare row of frozen sub-steps; the caller keeps them
    with its other buffers and hands them to every ``step``."""

    def __init__(self, cfg, sizes, *, dtype, device):
        self.cfg = cfg
        self.m = m = int(cfg.anderson)
        self.R = R = m + 1
        self.sizes = list(sizes)
        self.dtype, self.device = dtype, device
        self.eps = torch.finfo(dtype).eps
        self.ring = torch.arange(R, dtype=torch.int64, device=device)
        self.cols = torch.arange(m, dtype=torch.int64, device=device)
        self.eye = torch.eye(m, dtype=dtype, device=device)
        self.spare = torch.tensor(R, dtype=torch.int64, device=device)

    def rings(self, lead=()):
        """``(F, T)``: the empty rings, one buffer per leaf in each list,
        with the leading dimensions ``lead`` (a lane axis)."""
        rows = lambda size: torch.zeros(tuple(lead) + (self.R + 1, size), dtype=self.dtype,
                                        device=self.device)
        return [rows(size) for size in self.sizes], [rows(size) for size in self.sizes]

    def initial(self, lead=()):
        """``(cnt, best)`` before the first step: an empty window and an
        infinite best residual."""
        return (torch.zeros(tuple(lead), dtype=torch.int64, device=self.device),
                torch.full(tuple(lead), float("inf"), dtype=self.dtype, device=self.device))

    def step(self, s_in, t_out, cnt, best, F, T, *, done, frozen=None, put=None):
        """One extrapolation.  ``s_in`` and ``t_out`` are lists of tensors,
        leaf for leaf; ``cnt`` and ``best`` the window's count and best
        residual norm^2; ``F`` and ``T`` the rings; ``done`` this step's
        stop flag.  Returns ``(next, cnt_new, best_new, F, T)``: the leaves
        the next step starts from, in ``t_out``'s shapes, the window's new
        scalars, which the caller keeps or discards under ``frozen`` like
        any state, and the rings with this step's row written (to the spare
        row when ``frozen``).  ``put(buf, dim, slot, rows)`` writes a row;
        the default writes in place (``index_copy_``).
        """
        cfg, m, R = self.cfg, self.m, self.R
        if put is None:
            put = lambda buf, dim, slot, val: buf.index_copy_(dim, slot, val)
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
        dF, dT, F_new, T_new = [], [], [], []
        for Fb, Tb, fi, ti in zip(F, T, f, t):
            Fb = put(Fb, 0, slot.reshape(1), fi[None])
            Tb = put(Tb, 0, slot.reshape(1), ti[None])
            F_new.append(Fb)
            T_new.append(Tb)
            Fw, Tw = Fb.index_select(0, js), Tb.index_select(0, js)
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
        return nxt, cnt + 1, best_new, F_new, T_new
