"""Structured interior-point solver for the tree QP (the reference package's
``solvers/tree_qp_ipm.py``).

The probability-weighted tree QP with slacks, solved by a Mehrotra
predictor-corrector IPM: every inequality row is stage-local, so each Newton
system is one tree-Riccati factorization (the barrier-weighted Hessian keeps
the cost's rate-coupling edges) plus per-stage eliminations of the decision
slacks. Safeguards as the reference's: centred start, σ ∈ [0, 1], optional
Gondzio centrality correctors, step-quality backoff, best-iterate tracking,
freeze on convergence.

:func:`qp_ipm_solve` is batched over trees: every tensor has a leading tree
axis where the reference ``vmap``s its per-tree function, and every
reduction the reference takes over a whole array (gap, step lengths, the
Gondzio acceptance, the primal residual) is taken per tree. It is the
independently written counterpart of the fused solve
(``solvers/tree_qp_pl.qp_ipm_solve_pl``), which the tests and
``chip_smoke.py`` hold against it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from belief_planning_tpu_torch.solvers.tree_qp import (
    StageCost,
    StagePlan,
    _idx,
    tree_lqr_factor,
    tree_lqr_forward,
    tree_lqr_linear,
)
from belief_planning_tpu_torch.tree.engine import TreeState
from belief_planning_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class QPIPMConfig:
    iters: int = 30
    reg: float = 1e-8
    tau: float = 0.99
    mu0: float = 10.0
    w_max: float = 1e12
    gap_tol: float = 1e-10
    # Slack floor of the starting point, sl = max(b − rows, sl_min): the rows
    # are evaluated at the rolled-out warm primal, so a small floor keeps the
    # start nearly primal-feasible.
    sl_min: float = 0.1
    # Gondzio multiple-centrality correctors per iteration, each a
    # factorization-reusing solve on a pure complementarity right-hand side
    # that pushes outlier products back into [bmin·σμ, bmax·σμ].
    gondzio: int = 0
    gondzio_bmin: float = 0.1
    gondzio_bmax: float = 10.0


def _bc(a, t):
    """A per-tree ``(Bt,)`` tensor shaped to broadcast against ``t``."""
    return a.reshape(a.shape + (1,) * (t.dim() - 1))


def _tree_sum(t):
    return t.reshape(t.shape[0], -1).sum(1)


def _tree_min(t):
    return t.reshape(t.shape[0], -1).amin(1)


def _tree_max(t):
    return t.reshape(t.shape[0], -1).amax(1)


def max_step(v, dv):
    """Per tree: the largest α ≤ 1 with v + α·dv ≥ 0 (NaN components pass)."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    return torch.clamp(_tree_min(ratio), max=1.0)


def qp_ipm_solve(plan: StagePlan, cost: StageCost, ts: TreeState, Fx, bx, Fu, bu, x0, OldInput,
                 cfg: QPIPMConfig = QPIPMConfig(), Fxc_override=None, b1_override=None,
                 warm_primal=None, device=None):
    """Solve the tree QP (½-form cost in ``cost``) for a batch of trees.

    ``cost`` and ``ts`` carry a leading tree axis ``Bt``; ``Fx, bx, Fu, bu``
    are shared by all trees. ``x0 (Bt, n)`` and ``OldInput (Bt, d)`` are
    accepted for the reference's signature (its Newton steps roll out from
    zero). ``Fxc_override (Bt, totalu, Nc, n)`` / ``b1_override (Bt, totalu,
    Nc)`` replace the split state rows [−dh; Fx] by generic dense rows.
    ``warm_primal = (x (Bt, totalx, n), u (Bt, totalu, d))`` starts the
    iterate there instead of at the tree's linearization. ``device``:
    ``None`` is the CUDA device (raises without one); pass ``"cpu"`` to run on
    the CPU. The dtype is ``ts``'s.

    Returns ``(x_nodes, u, s, aux)``: ``aux`` holds ``prim_res (Bt,)``,
    ``gap (Bt,)``, and the per-iteration ``gaps`` and accepted ``steps``,
    each ``(Bt, iters)``.
    """
    dev = resolve_device(device)
    ts = TreeState(*(a.to(dev) for a in ts))
    cost = StageCost(*(torch.as_tensor(c).to(dev) for c in cost))
    topo = plan.topo
    n, d = topo.n, topo.d
    totalu = topo.totalu
    dtype = ts.x_lin.dtype
    Bt = ts.x_lin.shape[0]
    ein = torch.einsum
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    Fx, bx, Fu, bu = map(as_t, (Fx, bx, Fu, bu))
    nFx = Fx.shape[0]

    # Constraint-row operators. In the standard layout only row 0 of a stage
    # varies per stage and tree (−dh from the collision linearization); rows
    # 1..nFx are the shared state-bound matrix Fx, contracted directly (the
    # split form). The override path keeps a generic dense block.
    if Fxc_override is not None:
        Fxc = as_t(Fxc_override)
        b1 = as_t(b1_override)
        Nc = Fxc.shape[-2]

        def row_mul(xv):
            """(Bt, totalu, n) → Fxc·x (Bt, totalu, Nc)."""
            return ein("tbrn,tbn->tbr", Fxc, xv)

        def row_mulT(v):
            """(Bt, totalu, Nc) → Fxcᵀ·v (Bt, totalu, n)."""
            return ein("tbrn,tbr->tbn", Fxc, v)

        def row_quad(coefs):
            """(Bt, totalu, Nc) → Σ_r coefs_r F_r F_rᵀ (Bt, totalu, n, n)."""
            return ein("tbr,tbri,tbrj->tbij", coefs, Fxc, Fxc)
    else:
        Nc = nFx + 1
        dh = ts.dh
        b1 = torch.cat([ts.h0[..., None], bx.expand(Bt, totalu, nFx)], dim=-1)

        def row_mul(xv):
            r0 = -torch.sum(dh * xv, dim=-1)
            rr = ein("rn,tbn->tbr", Fx, xv)
            return torch.cat([r0[..., None], rr], dim=-1)

        def row_mulT(v):
            return -dh * v[..., :1] + ein("rn,tbr->tbn", Fx, v[..., 1:])

        def row_quad(coefs):
            rank1 = coefs[..., 0, None, None] * dh[..., :, None] * dh[..., None, :]
            shared = ein("tbr,ri,rj->tbij", coefs[..., 1:], Fx, Fx)
            return rank1 + shared

    cx_nodes = _idx(topo.cnode_x, dev)
    leaf_term = _idx(plan.leaf_term_idx, dev)
    slack_quad = cost.slack_quad.reshape(Bt, 1, 1)
    slin = cost.slack_lin[..., None].expand(Bt, totalu, Nc)
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    eye_d = torch.eye(d, dtype=dtype, device=dev)

    # variables: x (totalx, n), u (totalu, d), s (totalu, Nc) per tree
    # rows: R1 Fxc·x − s ≤ b1 ; R2 Fu·u ≤ bu ; R3 −s ≤ 0
    x_i = ts.x_lin if warm_primal is None else as_t(warm_primal[0])
    u_i = ts.u_lin if warm_primal is None else as_t(warm_primal[1])
    s_i = torch.zeros((Bt, totalu, Nc), dtype=dtype, device=dev)

    sl1 = torch.clamp(b1 - (row_mul(x_i[:, cx_nodes]) - s_i), min=cfg.sl_min)
    sl2 = torch.clamp(bu - ein("rn,tbn->tbr", Fu, u_i), min=cfg.sl_min)
    sl3 = torch.clamp(s_i, min=cfg.sl_min)
    mtot = float(sl1[0].numel() + sl2[0].numel() + sl3[0].numel())
    w_max_eff = cfg.w_max if dtype == torch.float64 else min(cfg.w_max, 1e6)

    # rate-coupling edges pred(j) → j of the dual residual (stage 0 has none)
    pred_uu = np.asarray(topo.pred_uu).copy()
    has_edge = pred_uu >= 0
    pred_uu[0] = 0
    pe = _idx(pred_uu, dev)
    he = as_t(has_edge.astype(np.float64))[:, None]

    def factor(lam1_, sl1_, lam2_, sl2_, lam3_, sl3_):
        w1 = torch.clamp(lam1_ / sl1_, max=w_max_eff)
        w2 = torch.clamp(lam2_ / sl2_, max=w_max_eff)
        w3 = torch.clamp(lam3_ / sl3_, max=w_max_eff)
        kap = slack_quad + w1 + w3 + cfg.reg
        coefs = w1 - w1 * w1 / kap
        Qx2 = cost.Qx2 + row_quad(coefs) + cfg.reg * eye_n
        Ru2 = cost.Ru2 + ein("tbr,ri,rj->tbij", w2, Fu, Fu) + cfg.reg * eye_d
        Pterm2 = cost.Pterm2 + cfg.reg * eye_n
        fac = tree_lqr_factor(plan, cost._replace(Qx2=Qx2, Ru2=Ru2, Pterm2=Pterm2), ts)
        return fac, (w1, w2, w3, kap)

    zero_n = torch.zeros(n, dtype=dtype, device=dev)
    zero_d = torch.zeros(d, dtype=dtype, device=dev)

    def kkt_solve(fac, ws, qx, qu, qterm, qs):
        w1, w2, w3, kap = ws
        qx_eff = qx + row_mulT((w1 / kap) * qs)
        kff = tree_lqr_linear(plan, fac, qx_eff, qu, qterm, affine=False)
        dx, du = tree_lqr_forward(plan, fac, kff, zero_n, zero_d, affine=False)
        dsv = (w1 * row_mul(dx[:, cx_nodes]) - qs) / kap
        return dx, du, dsv

    def iteration(state, best):
        x_c, u_c, s_c, sl1_, lam1_, sl2_, lam2_, sl3_, lam3_ = state
        rows1 = row_mul(x_c[:, cx_nodes]) - s_c
        rows2 = ein("rn,tbn->tbr", Fu, u_c)
        r1 = rows1 + sl1_ - b1
        r2 = rows2 + sl2_ - bu
        r3 = -s_c + sl3_
        gap = (_tree_sum(sl1_ * lam1_) + _tree_sum(sl2_ * lam2_)
               + _tree_sum(sl3_ * lam3_)) / mtot

        fac, ws = factor(lam1_, sl1_, lam2_, sl2_, lam3_, sl3_)

        # dual residual P̂v + q̂ + Aᵀλ; the u-part carries the rate-coupling
        # edges (Dab2 between each stage and its predecessor)
        rd_x = ein("tbij,tbj->tbi", cost.Qx2, x_c[:, cx_nodes]) + cost.qx + row_mulT(lam1_)
        rd_u = ein("tbij,tbj->tbi", cost.Ru2, u_c) + cost.qu
        rd_u = rd_u + he * ein("tbji,tbj->tbi", cost.Dab2, u_c[:, pe])
        back = torch.zeros_like(rd_u).index_add_(
            1, pe, he * ein("tbij,tbj->tbi", cost.Dab2, u_c))
        rd_u = rd_u + back + ein("rn,tbr->tbn", Fu, lam2_)
        rd_s = slack_quad * s_c + slin - lam1_ - lam3_
        rd_term = ein("tbij,tbj->tbi", cost.Pterm2, x_c[:, leaf_term]) + cost.qterm

        def recover(dx, du, dsv, rc1, rc2, rc3, res1, res2, res3):
            drow1 = row_mul(dx[:, cx_nodes]) - dsv
            drow2 = ein("rn,tbn->tbr", Fu, du)
            dsl1 = -res1 - drow1
            dsl2 = -res2 - drow2
            dsl3 = -res3 + dsv
            dlam1 = (-rc1 - lam1_ * dsl1) / sl1_
            dlam2 = (-rc2 - lam2_ * dsl2) / sl2_
            dlam3 = (-rc3 - lam3_ * dsl3) / sl3_
            return dx, du, dsv, dsl1, dlam1, dsl2, dlam2, dsl3, dlam3

        def direction(rc1, rc2, rc3):
            ex1 = (-rc1 + lam1_ * r1) / sl1_
            ex2 = (-rc2 + lam2_ * r2) / sl2_
            ex3 = (-rc3 + lam3_ * r3) / sl3_
            qx = rd_x + row_mulT(ex1)
            qu = rd_u + ein("rn,tbr->tbn", Fu, ex2)
            qs = rd_s + (-ex1) + (-ex3)
            dx, du, dsv = kkt_solve(fac, ws, qx, qu, rd_term, qs)
            return recover(dx, du, dsv, rc1, rc2, rc3, r1, r2, r3)

        def direction_pure(rc1, rc2, rc3):
            """``direction`` with zero primal and dual residuals: the
            right-hand side of a pure centrality correction."""
            ex1 = -rc1 / sl1_
            ex2 = -rc2 / sl2_
            ex3 = -rc3 / sl3_
            qx = row_mulT(ex1)
            qu = ein("rn,tbr->tbn", Fu, ex2)
            qs = -ex1 - ex3
            dx, du, dsv = kkt_solve(fac, ws, qx, qu, torch.zeros_like(rd_term), qs)
            return recover(dx, du, dsv, rc1, rc2, rc3, 0.0, 0.0, 0.0)

        def all_step(dirs):
            (_, _, _, dsl1, dlam1, dsl2, dlam2, dsl3, dlam3) = dirs
            a = torch.minimum(max_step(sl1_, dsl1), max_step(lam1_, dlam1))
            a = torch.minimum(a, torch.minimum(max_step(sl2_, dsl2), max_step(lam2_, dlam2)))
            return torch.minimum(a, torch.minimum(max_step(sl3_, dsl3), max_step(lam3_, dlam3)))

        def gap_at(a, dirs):
            (_, _, _, dsl1, dlam1, dsl2, dlam2, dsl3, dlam3) = dirs
            return (_tree_sum((sl1_ + _bc(a, sl1_) * dsl1) * (lam1_ + _bc(a, sl1_) * dlam1))
                    + _tree_sum((sl2_ + _bc(a, sl2_) * dsl2) * (lam2_ + _bc(a, sl2_) * dlam2))
                    + _tree_sum((sl3_ + _bc(a, sl3_) * dsl3) * (lam3_ + _bc(a, sl3_) * dlam3))
                    ) / mtot

        da = direction(sl1_ * lam1_, sl2_ * lam2_, sl3_ * lam3_)
        a_aff = all_step(da)
        gap_aff = gap_at(a_aff, da)
        sigma_c = torch.clamp((gap_aff / (gap + 1e-30)) ** 3, 0.0, 1.0)
        sg = sigma_c * gap
        (_, _, _, dsl1a, dlam1a, dsl2a, dlam2a, dsl3a, dlam3a) = da
        dc = direction(sl1_ * lam1_ + dsl1a * dlam1a - _bc(sg, sl1_),
                       sl2_ * lam2_ + dsl2a * dlam2a - _bc(sg, sl2_),
                       sl3_ * lam3_ + dsl3a * dlam3a - _bc(sg, sl3_))

        # Gondzio multiple centrality correctors (see QPIPMConfig.gondzio)
        for _ in range(cfg.gondzio):
            mu_t = sg + 1e-30
            a_cur = all_step(dc)
            ab = torch.clamp(cfg.tau * a_cur + 0.3, max=1.0)
            (_, _, _, gdsl1, gdlam1, gdsl2, gdlam2, gdsl3, gdlam3) = dc
            cap = 10.0 * cfg.gondzio_bmax * mu_t

            def outlier(v, dv, lam, dlam):
                ab_, mu_, cap_ = _bc(ab, v), _bc(mu_t, v), _bc(cap, v)
                p = (v + ab_ * dv) * (lam + ab_ * dlam)
                t = torch.minimum(torch.maximum(p, cfg.gondzio_bmin * mu_), cfg.gondzio_bmax * mu_)
                # cap the correction: an uncapped p − t on a far-off-centre
                # row overflows through the 1/sl recovery and poisons the tree
                return torch.minimum(torch.maximum(p - t, -cap_), cap_)

            dd = direction_pure(outlier(sl1_, gdsl1, lam1_, gdlam1),
                                outlier(sl2_, gdsl2, lam2_, gdlam2),
                                outlier(sl3_, gdsl3, lam3_, gdlam3))
            cand = tuple(c + e for c, e in zip(dc, dd))
            a_new = all_step(cand)
            # NaN components pass max_step unnoticed (NaN < 0 is false): each
            # tree's candidate must be finite throughout to be accepted
            cand_ok = torch.ones(Bt, dtype=torch.bool, device=dev)
            for c in cand:
                cand_ok = cand_ok & torch.isfinite(c).reshape(Bt, -1).all(1)
            accept = (a_new > a_cur) & cand_ok
            dc = tuple(torch.where(_bc(accept, c), c, o) for c, o in zip(cand, dc))

        a0 = cfg.tau * all_step(dc)
        a0 = torch.where(gap < cfg.gap_tol * (1.0 + torch.abs(gap)), torch.zeros_like(a0), a0)
        grow = 10.0 * gap + 1e-10
        a1 = torch.where(gap_at(a0, dc) > grow, 0.3 * a0, a0)
        a = torch.where(gap_at(a1, dc) > grow, 0.3 * a1, a1)

        new = tuple(v + _bc(a, v) * dv for v, dv in zip(state, dc))
        bx_, bu_, bs_, bgap = best
        better = gap < bgap
        best_new = (torch.where(_bc(better, x_c), x_c, bx_),
                    torch.where(_bc(better, u_c), u_c, bu_),
                    torch.where(_bc(better, s_c), s_c, bs_), torch.where(better, gap, bgap))
        return new, best_new, gap, a

    state = (x_i, u_i, s_i, sl1, cfg.mu0 / sl1, sl2, cfg.mu0 / sl2, sl3, cfg.mu0 / sl3)
    best = (x_i, u_i, s_i, torch.full((Bt,), float("inf"), dtype=dtype, device=dev))
    gaps, steps = [], []
    for _ in range(cfg.iters):
        state, best, gap, a = iteration(state, best)
        gaps.append(gap)
        steps.append(a)
    gaps = torch.stack(gaps, dim=1)
    steps = torch.stack(steps, dim=1)
    gap_last = gaps[:, -1]
    bx_, bu_, bs_, bgap = best
    use_last = gap_last <= bgap
    x_f = torch.where(_bc(use_last, x_i), state[0], bx_)
    u_f = torch.where(_bc(use_last, u_i), state[1], bu_)
    s_f = torch.where(_bc(use_last, s_i), state[2], bs_)
    gap_f = torch.minimum(gap_last, bgap)
    rows1 = row_mul(x_f[:, cx_nodes]) - s_f
    rows2 = ein("rn,tbn->tbr", Fu, u_f)
    prim = torch.maximum(
        _tree_max(torch.clamp(rows1 - b1, min=0.0)),
        torch.maximum(_tree_max(torch.clamp(rows2 - bu, min=0.0)),
                      _tree_max(torch.clamp(-s_f, min=0.0))))
    # gaps / steps: per-iteration complementarity and accepted step length
    aux = {"prim_res": prim, "gap": gap_f, "gaps": gaps, "steps": steps}
    return x_f, u_f, s_f, aux
