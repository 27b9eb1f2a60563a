"""Fused batch-last IPM iteration for the tree QP, with its CUDA kernel (the
reference package's ``solvers/tree_qp_pl.py``).

Every per-stage quantity is batch-last and sliced into per-tree-level blocks
``(nb, l, ..., T)`` (branches of a level × steps), so all tree indexing is a
reshape of a contiguous range; the Riccati recursions run over the static
level lengths with closed-form small inverses.

One Mehrotra iteration with Gondzio correctors (residuals, barrier-weighted
tree-Riccati factor, predictor / corrector / centrality KKT solves,
fraction-to-boundary step with two 0.3× backtracks) is one call of
:func:`fused_iteration`'s step function:

- on CUDA tensors it launches the hand-written kernel
  ``csrc/tree_qp_ipm_iter.cu`` (a warp per tree, the factor in shared
  memory, a persistent grid), or raises;
- on CPU tensors it runs :func:`make_iteration`, the plain PyTorch version
  of the same iteration, which the tests hold against the JAX package.

:func:`phase_step` drives the same source's phase kernels, the counterpart
of the reference's K1 profile (``scripts/profile_ipm_kernel.py``), with
:func:`make_phase` as their plain version.

The loop over iterations and the best-iterate tracking stay in Python
(:func:`qp_ipm_solve_pl`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Any, List, NamedTuple

import numpy as np
import torch

from belief_planning_tpu_torch.solvers.layout import _small_inv_bl
from belief_planning_tpu_torch.solvers.tree_qp import StageCost, StagePlan
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig
from belief_planning_tpu_torch.utils.nvcc import build_shared_library


# ---------------------------------------------------------------------------
# Static level metadata
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LevelMeta:
    nb: int      # branches in this level
    l: int       # input stages per branch
    lx: int      # state nodes per branch (l, +1 for leaves)
    u0: int      # [u0, u1) flat stage range of the level (contiguous)
    u1: int
    x0: int      # [x0, x1) flat x-node range of the level (contiguous)
    x1: int
    leaf: bool


def build_levels(plan: StagePlan) -> List[LevelMeta]:
    topo = plan.topo
    lv = []
    for k in range(topo.NB + 1):
        lo, hi = int(topo.level_lo[k]), int(topo.level_hi[k])
        nb = hi - lo
        l = int(topo.blen[lo])
        leaf = bool(topo.is_leaf[lo])
        lx = l + (1 if leaf else 0)
        u0 = int(topo.u_off[lo])
        x0 = int(topo.x_off[lo])
        lv.append(LevelMeta(nb=nb, l=l, lx=lx, u0=u0, u1=u0 + nb * l,
                            x0=x0, x1=x0 + nb * lx, leaf=leaf))
    return lv


def _ublk(a, m: LevelMeta):
    """Flat per-stage (totalu, ..., T) → level block (nb, l, ..., T)."""
    return a[m.u0:m.u1].reshape((m.nb, m.l) + a.shape[1:])


def _xblk(a, m: LevelMeta):
    """Flat per-x-node (totalx, ..., T) → level block (nb, lx, ..., T)."""
    return a[m.x0:m.x1].reshape((m.nb, m.lx) + a.shape[1:])


def _cx_gather(levels, x_f):
    """x at the constrained nodes: flat (totalx, n, ..., T) → (totalu, n, ..., T)."""
    return torch.cat([_xblk(x_f, mt)[:, :mt.l].reshape((mt.nb * mt.l,) + x_f.shape[1:])
                      for mt in levels], dim=0)


def _succ_transitions(plan: StagePlan, A_bl, B_bl):
    """Per-stage transitions into each stage's successor node (flat stage
    order: level-major, branch-major, step-ascending)."""
    sx_all = np.zeros(plan.topo.totalu, dtype=np.int64)
    for k in range(plan.topo.NB + 1):
        sx_all[plan.stage_idx[k].T.reshape(-1)] = plan.succ_x_idx[k].T.reshape(-1)
    return A_bl[sx_all].contiguous(), B_bl[sx_all].contiguous()


# ---------------------------------------------------------------------------
# Small-matrix helpers on batch-last blocks (nb, i, j, T)
# ---------------------------------------------------------------------------


def _mm(A, B):
    return torch.einsum("bikt,bkjt->bijt", A, B)


def _mtm(A, B):
    return torch.einsum("bkit,bkjt->bijt", A, B)


def _mv(A, v):
    return torch.einsum("bikt,bkt->bit", A, v)


def _mtv(A, v):
    return torch.einsum("bkit,bkt->bit", A, v)


def _riccati_step(W_P, Qx2, Dab2, Ru2, A, B, n):
    """One backward Riccati step on a level block (the KKT solves are pure
    linear responses, so no affine part). Returns (P, K, Hinv, Acl)."""
    Pxx = W_P[:, :n, :n]
    Pxu = W_P[:, :n, n:]
    Puu = W_P[:, n:, n:]
    BtPxx = _mtm(B, Pxx)                                  # (nb, d, n, T)
    BtPxu = _mtm(B, Pxu)                                  # (nb, d, d, T)
    Huu = Ru2 + (_mm(BtPxx, B) + BtPxu + BtPxu.transpose(1, 2) + Puu)
    GtPF_x = _mm(BtPxx, A) + _mtm(Pxu, A)
    L = torch.cat([GtPF_x, Dab2.transpose(1, 2)], dim=2)  # (nb, d, nd, T)
    Hinv = _small_inv_bl(Huu)
    HL = _mm(Hinv, L)
    K = -HL
    P = -_mtm(L, HL)
    P[:, :n, :n] += Qx2 + _mtm(A, _mm(Pxx, A))
    P = 0.5 * (P + P.transpose(1, 2))
    # Acl = F + G K with F = [[A, 0], [0, 0]], G = [B; I]
    top = _mm(B, K)
    top[:, :, :n] += A
    return P, K, Hinv, torch.cat([top, K], dim=1)


def _fold0(a, m):
    """Sum groups of ``m`` consecutive rows: (nb·m, ...) → (nb, ...)."""
    r = a.reshape((a.shape[0] // m, m) + a.shape[1:])
    s = r[:, 0]
    for i in range(1, m):
        s = s + r[:, i]
    return s


def _repeat0(a, m):
    return torch.repeat_interleave(a, m, dim=0)


def _factor_blocks(levels, Qx2_f, Dab2_f, Ru2_f, Pterm2, A_st, B_st, n, d, m):
    """Backward quadratic sweep; per-level K (nb,l,d,nd,T), Hinv, Acl."""
    NB = len(levels) - 1
    K_l, Hinv_l, Acl_l = [None] * (NB + 1), [None] * (NB + 1), [None] * (NB + 1)
    W = None
    for k in range(NB, -1, -1):
        mt = levels[k]
        if k == NB:
            W = Pterm2.new_zeros((mt.nb, n + d, n + d, Pterm2.shape[-1]))
            W[:, :n, :n] = Pterm2
        else:
            W = _fold0(W, m)
        Qx2_b, Dab2_b, Ru2_b = _ublk(Qx2_f, mt), _ublk(Dab2_f, mt), _ublk(Ru2_f, mt)
        A_b, B_b = _ublk(A_st, mt), _ublk(B_st, mt)
        Ks, His, Acls = [], [], []
        for j in range(mt.l - 1, -1, -1):
            W, K, Hinv, Acl = _riccati_step(W, Qx2_b[:, j], Dab2_b[:, j],
                                            Ru2_b[:, j], A_b[:, j], B_b[:, j], n)
            Ks.append(K)
            His.append(Hinv)
            Acls.append(Acl)
        K_l[k] = torch.stack(Ks[::-1], dim=1)
        Hinv_l[k] = torch.stack(His[::-1], dim=1)
        Acl_l[k] = torch.stack(Acls[::-1], dim=1)
    return K_l, Hinv_l, Acl_l


def _linear_blocks(levels, K_l, Hinv_l, Acl_l, B_st, qx_f, qu_f, qterm, n, d, m):
    """Backward linear sweep; per-level feed-forward blocks kff (nb,l,d,T)."""
    NB = len(levels) - 1
    kff_l = [None] * (NB + 1)
    p = None
    for k in range(NB, -1, -1):
        mt = levels[k]
        if k == NB:
            p = torch.cat([qterm, qterm.new_zeros((mt.nb, d, qterm.shape[-1]))], dim=1)
        else:
            p = _fold0(p, m)
        qx_b, qu_b, B_b = _ublk(qx_f, mt), _ublk(qu_f, mt), _ublk(B_st, mt)
        kffs = []
        for j in range(mt.l - 1, -1, -1):
            l_u = qu_b[:, j] + _mtv(B_b[:, j], p[:, :n]) + p[:, n:]
            kffs.append(-_mv(Hinv_l[k][:, j], l_u))
            p = _mtv(Acl_l[k][:, j], p) + _mtv(K_l[k][:, j], qu_b[:, j])
            p[:, :n] += qx_b[:, j]
        kff_l[k] = torch.stack(kffs[::-1], dim=1)
    return kff_l


def _forward_blocks(levels, K_l, Acl_l, B_st, kff_l, n, d, m, T):
    """Forward rollout from a zero root state; flat dx (totalx,n,T), du (totalu,d,T)."""
    NB = len(levels) - 1
    xi = B_st.new_zeros((1, n + d, T))
    dx_parts, du_parts = [], []
    for k in range(NB + 1):
        mt = levels[k]
        B_b = _ublk(B_st, mt)
        us, xs = [], []
        for j in range(mt.l):
            kf = kff_l[k][:, j]
            us.append(_mv(K_l[k][:, j], xi) + kf)
            xs.append(xi[:, :n])
            xi = _mv(Acl_l[k][:, j], xi) + torch.cat([_mv(B_b[:, j], kf), kf], dim=1)
        if mt.leaf:
            xs.append(xi[:, :n])
        du_parts.append(torch.stack(us, dim=1).reshape(mt.nb * mt.l, d, T))
        dx_parts.append(torch.stack(xs, dim=1).reshape(mt.nb * mt.lx, n, T))
        if k < NB:
            xi = _repeat0(xi, m)
    return torch.cat(dx_parts, dim=0), torch.cat(du_parts, dim=0)


def _rate_edge_terms(levels, Dab2, u_c, m):
    """Rate-coupling gradient of the tree edges: edge (pred(j) → j) adds
    ``Dab2_jᵀ u_pred`` to grad_j and ``Dab2_j u_j`` to grad_pred. Within a
    branch the edge is a shift by one step; across levels it joins the
    parent's last stage and each child's first. Returns (totalu, d, T)."""

    def bmtv(Mb, vb):   # (nb, l, k, i, T), (nb, l, k, T) → (nb, l, i, T)
        return torch.einsum("blkit,blkt->blit", Mb, vb)

    def bmv(Mb, vb):    # (nb, l, i, k, T), (nb, l, k, T) → (nb, l, i, T)
        return torch.einsum("blikt,blkt->blit", Mb, vb)

    d = Dab2.shape[1]
    blocks = []
    for k, mt in enumerate(levels):
        Dab_b, u_b = _ublk(Dab2, mt), _ublk(u_c, mt)
        zslot = torch.zeros_like(u_b[:, 0:1])
        if k > 0:
            mtp = levels[k - 1]
            up_last = _repeat0(_ublk(u_c, mtp)[:, mtp.l - 1], m)     # (nb, d, T)
            first = bmtv(Dab_b[:, 0:1], up_last[:, None])
        else:
            first = zslot
        fwd = torch.cat([first, bmtv(Dab_b[:, 1:], u_b[:, :-1])], dim=1)
        if k + 1 < len(levels):
            mtc = levels[k + 1]
            child = bmv(_ublk(Dab2, mtc)[:, 0:1], _ublk(u_c, mtc)[:, 0:1])
            last = _fold0(child, m)
        else:
            last = zslot
        bwd = torch.cat([bmv(Dab_b[:, 1:], u_b[:, 1:]), last], dim=1)
        blocks.append((fwd + bwd).reshape(mt.nb * mt.l, d, -1))
    return torch.cat(blocks, dim=0)


def _barrier_factor(levels, cfg: QPIPMConfig, w_max_eff, Qx2, Ru2, Dab2, Pterm2, A_st, B_st,
                    dh, Fx, Fu, slack_quad, sl1, lam1, sl2, lam2, sl3, lam3, n, d, m):
    """Barrier weights (clamped at ``w_max_eff``) and the barrier-weighted
    tree-Riccati factor. Returns (w1, w2, w3, kap, (K_l, Hinv_l, Acl_l))."""
    dtype, dev = sl1.dtype, sl1.device
    w1 = torch.clamp(lam1 / sl1, max=w_max_eff)
    w2 = torch.clamp(lam2 / sl2, max=w_max_eff)
    w3 = torch.clamp(lam3 / sl3, max=w_max_eff)
    kap = slack_quad + w1 + w3 + cfg.reg
    coefs = w1 - w1 * w1 / kap
    # Σ_r coef_r F_r F_rᵀ over the rows [−dh; Fx]
    row_quad = coefs[:, 0:1, None] * dh[:, :, None] * dh[:, None, :]
    row_quad = row_quad + torch.einsum("srt,ri,rj->sijt", coefs[:, 1:], Fx, Fx)
    eye_n = torch.eye(n, dtype=dtype, device=dev)[:, :, None]
    eye_d = torch.eye(d, dtype=dtype, device=dev)[:, :, None]
    Qx2_eff = Qx2 + row_quad + cfg.reg * eye_n
    Ru2_eff = (Ru2 + cfg.reg * eye_d) + torch.einsum("srt,ri,rj->sijt", w2, Fu, Fu)
    Pterm2_eff = Pterm2 + cfg.reg * eye_n
    return w1, w2, w3, kap, _factor_blocks(levels, Qx2_eff, Dab2, Ru2_eff, Pterm2_eff, A_st,
                                           B_st, n, d, m)


# ---------------------------------------------------------------------------
# One fused IPM iteration: the plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


def make_iteration(plan: StagePlan, cfg: QPIPMConfig, nFx: int, nFu: int,
                   mtot: float):
    """Returns ``iterate(consts..., carry...) -> new carry + gap`` on
    batch-last tensors with trailing lane axis T (order: ``CONST_ORDER``
    then ``CARRY_ORDER``)."""
    topo = plan.topo
    n, d, m = topo.n, topo.d, topo.m
    levels = build_levels(plan)

    def cx_gather(x_f):
        return _cx_gather(levels, x_f)

    def term_gather(x_f):
        mt = levels[-1]
        return _xblk(x_f, mt)[:, mt.lx - 1]                  # (n_leaves, n, T)

    def iterate(Qx2, qx, Ru2, qu, Dab2, qterm, Pterm2, slack_lin, slack_quad,
                A_st, B_st, dh, b1, Fx, Fu, bu,
                x_c, u_c, s_c, sl1, lam1, sl2, lam2, sl3, lam3):
        dtype = x_c.dtype
        T = x_c.shape[-1]
        w_max_eff = cfg.w_max if dtype == torch.float64 else min(cfg.w_max, 1e6)
        inf = torch.tensor(float("inf"), dtype=dtype, device=x_c.device)

        def row_mul(xv):
            """(totalu, n, T) → rows (totalu, Nc, T): [−dh·x; Fx x]."""
            r0 = -torch.sum(dh * xv, dim=1, keepdim=True)
            return torch.cat([r0, torch.einsum("rn,snt->srt", Fx, xv)], dim=1)

        def row_mulT(v):
            return -dh * v[:, 0:1] + torch.einsum("rn,srt->snt", Fx, v[:, 1:])

        def fu_mul(uv):
            return torch.einsum("rd,sdt->srt", Fu, uv)

        def fu_mulT(v):
            return torch.einsum("rd,srt->sdt", Fu, v)

        def sum_lane(v):
            return v.reshape(-1, T).sum(0, keepdim=True)          # (1, T)

        def min_lane(v):
            return v.reshape(-1, T).amin(0, keepdim=True)

        cxv = cx_gather(x_c)
        r1 = row_mul(cxv) - s_c + sl1 - b1
        r2 = fu_mul(u_c) + sl2 - bu[:, :, None]
        r3 = -s_c + sl3
        gap = (sum_lane(sl1 * lam1) + sum_lane(sl2 * lam2)
               + sum_lane(sl3 * lam3)) / mtot                     # (1, T)

        # --- barrier-weighted factorization ---------------------------------
        w1, w2, w3, kap, (K_l, Hinv_l, Acl_l) = _barrier_factor(
            levels, cfg, w_max_eff, Qx2, Ru2, Dab2, Pterm2, A_st, B_st, dh, Fx, Fu,
            slack_quad, sl1, lam1, sl2, lam2, sl3, lam3, n, d, m)

        def kkt_solve(qx_r, qu_r, qterm_r, qs_r):
            qx_eff = qx_r + row_mulT((w1 / kap) * qs_r)
            kff_l = _linear_blocks(levels, K_l, Hinv_l, Acl_l, B_st,
                                   qx_eff, qu_r, qterm_r, n, d, m)
            dx, du = _forward_blocks(levels, K_l, Acl_l, B_st, kff_l, n, d, m, T)
            dsv = (w1 * row_mul(cx_gather(dx)) - qs_r) / kap
            return dx, du, dsv

        # --- dual residuals -------------------------------------------------
        def qx2_mv(M, v):
            return torch.einsum("sijt,sjt->sit", M, v)

        rd_x = qx2_mv(Qx2, cxv) + qx + row_mulT(lam1)
        rd_u = (qx2_mv(Ru2, u_c) + qu + fu_mulT(lam2)) + _rate_edge_terms(
            levels, Dab2, u_c, m)
        rd_s = slack_quad * s_c + slack_lin[:, None] - lam1 - lam3
        rd_term = qx2_mv(Pterm2, term_gather(x_c)) + qterm

        def direction(rc1, rc2, rc3, pure=False):
            """Newton direction for complementarity targets rc; ``pure`` drops
            the residual terms (Gondzio centrality rhs on the same factor)."""
            if pure:
                ex1, ex2, ex3 = -rc1 / sl1, -rc2 / sl2, -rc3 / sl3
                dx, du, dsv = kkt_solve(row_mulT(ex1), fu_mulT(ex2),
                                        torch.zeros_like(rd_term), -ex1 - ex3)
                dsl1 = -(row_mul(cx_gather(dx)) - dsv)
                dsl2 = -fu_mul(du)
                dsl3 = dsv
            else:
                ex1 = (-rc1 + lam1 * r1) / sl1
                ex2 = (-rc2 + lam2 * r2) / sl2
                ex3 = (-rc3 + lam3 * r3) / sl3
                dx, du, dsv = kkt_solve(rd_x + row_mulT(ex1), rd_u + fu_mulT(ex2),
                                        rd_term, rd_s - ex1 - ex3)
                dsl1 = -r1 - (row_mul(cx_gather(dx)) - dsv)
                dsl2 = -r2 - fu_mul(du)
                dsl3 = -r3 + dsv
            dlam1 = (-rc1 - lam1 * dsl1) / sl1
            dlam2 = (-rc2 - lam2 * dsl2) / sl2
            dlam3 = (-rc3 - lam3 * dsl3) / sl3
            return dx, du, dsv, dsl1, dlam1, dsl2, dlam2, dsl3, dlam3

        def max_step(v, dv):
            ratio = torch.where(dv < 0, -v / dv, inf)
            return torch.clamp(min_lane(ratio), max=1.0)

        def all_step(dirs):
            _, _, _, dsl1, dlam1, dsl2, dlam2, dsl3, dlam3 = dirs
            a = torch.minimum(max_step(sl1, dsl1), max_step(lam1, dlam1))
            a = torch.minimum(a, torch.minimum(max_step(sl2, dsl2), max_step(lam2, dlam2)))
            return torch.minimum(a, torch.minimum(max_step(sl3, dsl3), max_step(lam3, dlam3)))

        def gap_at(a, dirs):
            _, _, _, dsl1, dlam1, dsl2, dlam2, dsl3, dlam3 = dirs
            return (sum_lane((sl1 + a * dsl1) * (lam1 + a * dlam1))
                    + sum_lane((sl2 + a * dsl2) * (lam2 + a * dlam2))
                    + sum_lane((sl3 + a * dsl3) * (lam3 + a * dlam3))) / mtot

        da = direction(sl1 * lam1, sl2 * lam2, sl3 * lam3)
        gap_aff = gap_at(all_step(da), da)
        sigma_c = torch.clamp((gap_aff / (gap + 1e-30)) ** 3, 0.0, 1.0)
        dsl1a, dlam1a, dsl2a, dlam2a, dsl3a, dlam3a = da[3:]
        dc = direction(sl1 * lam1 + dsl1a * dlam1a - sigma_c * gap,
                       sl2 * lam2 + dsl2a * dlam2a - sigma_c * gap,
                       sl3 * lam3 + dsl3a * dlam3a - sigma_c * gap)

        # Gondzio centrality correctors, each accepted per lane only if it
        # lengthens the step and every entry of the candidate is finite (NaN
        # passes max_step unnoticed: NaN < 0 is False).
        for _ in range(cfg.gondzio):
            mu_t = sigma_c * gap + 1e-30
            a_cur = all_step(dc)
            ab = torch.clamp(cfg.tau * a_cur + 0.3, max=1.0)
            lo, hi = cfg.gondzio_bmin * mu_t, cfg.gondzio_bmax * mu_t
            cap = 10.0 * hi

            def outlier(v, dv, lam_, dlam_):
                p = (v + ab * dv) * (lam_ + ab * dlam_)
                t = torch.minimum(torch.maximum(p, lo), hi)
                return torch.minimum(torch.maximum(p - t, -cap), cap)

            dd = direction(outlier(sl1, dc[3], lam1, dc[4]),
                           outlier(sl2, dc[5], lam2, dc[6]),
                           outlier(sl3, dc[7], lam3, dc[8]), pure=True)
            cand = tuple(c + e for c, e in zip(dc, dd))
            cand_ok = torch.ones((1, T), dtype=torch.bool, device=x_c.device)
            for c in cand:
                cand_ok = cand_ok & torch.isfinite(c).reshape(-1, T).all(0, keepdim=True)
            accept = (all_step(cand) > a_cur) & cand_ok            # (1, T)
            dc = tuple(torch.where(accept, c, o) for c, o in zip(cand, dc))

        a0 = cfg.tau * all_step(dc)
        a0 = torch.where(gap < cfg.gap_tol * (1.0 + torch.abs(gap)),
                         torch.zeros_like(a0), a0)
        grow = 10.0 * gap + 1e-10
        a1 = torch.where(gap_at(a0, dc) > grow, 0.3 * a0, a0)
        a = torch.where(gap_at(a1, dc) > grow, 0.3 * a1, a1)
        carry = (x_c, u_c, s_c, sl1, lam1, sl2, lam2, sl3, lam3)
        return tuple(c + a * dv for c, dv in zip(carry, dc)) + (gap,)

    return iterate


# The profile's phases (the reference's scripts/profile_ipm_kernel.py):
# 0 = barrier weights + factor, 1 = that + one linear sweep on the raw
# (qx, qu, qterm) and the forward rollout, 2 = the full iteration.
PHASES = (0, 1, 2)


def phase_w_max(cfg: QPIPMConfig) -> float:
    """The barrier-weight clamp of phases 0 and 1 in every dtype, as the
    reference's profile sets it."""
    return min(cfg.w_max, 1e6)


def make_phase(plan: StagePlan, cfg: QPIPMConfig, nFx: int, nFu: int, mtot: float, phase: int):
    """The plain version of the phase kernels: ``run(consts..., carry...)``
    → t0 (1, T) for phases 0 (Σ K + Σ Hinv over every stage) and 1 (Σ dx +
    Σ du); phase 2 is :func:`make_iteration`'s iteration (new carry + gap)."""
    if phase not in PHASES:
        raise ValueError(f"tree_qp phase {phase}: expected one of {PHASES}")
    if phase == 2:
        return make_iteration(plan, cfg, nFx, nFu, mtot)
    topo = plan.topo
    n, d, m = topo.n, topo.d, topo.m
    levels = build_levels(plan)

    def lane_sum(blocks):
        """Σ over every non-lane axis of each block, the blocks in order: (1, T)."""
        T = blocks[0].shape[-1]
        return sum(b.reshape(-1, T).sum(0) for b in blocks).reshape(1, T)

    def run(Qx2, qx, Ru2, qu, Dab2, qterm, Pterm2, slack_lin, slack_quad,
            A_st, B_st, dh, b1, Fx, Fu, bu, x_c, u_c, s_c, sl1, lam1, sl2, lam2, sl3, lam3):
        *_, (K_l, Hinv_l, Acl_l) = _barrier_factor(
            levels, cfg, phase_w_max(cfg), Qx2, Ru2, Dab2, Pterm2, A_st, B_st, dh, Fx, Fu,
            slack_quad, sl1, lam1, sl2, lam2, sl3, lam3, n, d, m)
        if phase == 0:
            return lane_sum(K_l + Hinv_l)
        kff_l = _linear_blocks(levels, K_l, Hinv_l, Acl_l, B_st, qx, qu, qterm, n, d, m)
        dx, du = _forward_blocks(levels, K_l, Acl_l, B_st, kff_l, n, d, m, x_c.shape[-1])
        return lane_sum([dx, du])

    return run


# ---------------------------------------------------------------------------
# The CUDA kernel and its wrapper
# ---------------------------------------------------------------------------


CONST_ORDER = ["Qx2", "qx", "Ru2", "qu", "Dab2", "qterm", "Pterm2",
               "slack_lin", "slack_quad", "A_st", "B_st", "dh", "b1",
               "Fx", "Fu", "bu"]
CARRY_ORDER = ["x", "u", "s", "sl1", "lam1", "sl2", "lam2", "sl3", "lam3"]
CARRY_FIELDS = len(CARRY_ORDER)

KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tree_qp_ipm_iter.cu"
# the kernel's instantiated sizes: n, d, state rows (nFx), input rows (nFu)
KERNEL_DIMS = (4, 2, 4, 4)
PLAN_KEYS = ("scratch_elems", "blocks", "trees_per_block", "blocks_per_sm", "sms",
             "smem_bytes")


def bind_kernel_library(lib):
    """Declare the C interface of a built ``tree_qp_ipm_iter`` library."""
    for name in ("bp_tree_qp_iter_f32", "bp_tree_qp_iter_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_double), ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("bp_tree_qp_phase_f32", "bp_tree_qp_phase_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bp_tree_qp_iter_plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_longlong)]
    lib.bp_tree_qp_iter_plan.restype = ctypes.c_int
    return lib


def kernel_plan(lib, ints, B: int, dtype, device_index: int) -> dict:
    """The kernel's launch shape for ``B`` trees (``PLAN_KEYS``): the scratch
    elements it needs (one tree-major slot per resident team), the persistent
    grid, the trees (warps) a block, the resident blocks an SM, the SMs and
    the dynamic shared memory a block. Raises on dims the kernel does not
    take or a failed CUDA query."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    err = lib.bp_tree_qp_iter_plan((ctypes.c_int * len(ints))(*ints), ctypes.c_longlong(B),
                                   ctypes.c_int(int(dtype == torch.float64)),
                                   ctypes.c_int(device_index), out)
    if err == 1:
        raise ValueError("tree_qp_ipm_iter: unsupported dims or level table")
    if err != 0:
        raise RuntimeError(f"tree_qp_ipm_iter: launch plan failed: CUDA error {err}")
    return dict(zip(PLAN_KEYS, out))


class FusedIterationKernel:
    """Wrapper of ``csrc/tree_qp_ipm_iter.cu`` (replaces the reference's
    ``tree_qp_pl._make_pallas_iteration``, and with :meth:`launch_phase` the
    phase kernels of its profile, ``scripts/profile_ipm_kernel.py``), or of
    another source with its C interface. ``launches`` counts the main
    kernel's launches (the full iteration, the profile's phase 2 included)
    and ``phase_launches`` those of phase kernels 0 and 1, and nothing else;
    ``build_log`` / ``build_seconds`` are what nvcc printed and took when
    this process built the library."""

    def __init__(self, source: Path = KERNEL_SOURCE):
        self.source = Path(source)
        self.launches = 0
        self.phase_launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib = None

    def load(self):
        """Build (nvcc, at first use) and load the kernel library."""
        if self._lib is None:
            path, self.build_log, self.build_seconds = build_shared_library(self.source)
            self._lib = bind_kernel_library(ctypes.CDLL(str(path)))
        return self._lib

    def plan(self, ints, B: int, dtype, device_index: int) -> dict:
        """The launch shape of ``B`` trees (see :func:`kernel_plan`)."""
        return kernel_plan(self.load(), ints, B, dtype, device_index)

    def launch(self, ints, dbl, consts, carry, scratch):
        """Launch one iteration on the current stream; returns the new carry
        and the gap (allocated here)."""
        x_c = carry[0]
        outs = [torch.empty_like(c) for c in carry]
        gap = torch.empty((1, x_c.shape[-1]), dtype=x_c.dtype, device=x_c.device)
        lib = self.load()
        fn = lib.bp_tree_qp_iter_f64 if x_c.dtype == torch.float64 else lib.bp_tree_qp_iter_f32
        self._call(fn, (), "tree_qp_ipm_iter", ints, dbl,
                   [*consts, *carry, *outs, gap, scratch], x_c)
        self.launches += 1
        return (*outs, gap)

    def launch_phase(self, phase, ints, dbl, consts, carry, scratch):
        """Launch phase kernel 0 or 1 on the current stream; returns t0 (1, B)."""
        x_c = carry[0]
        t0 = torch.empty((1, x_c.shape[-1]), dtype=x_c.dtype, device=x_c.device)
        lib = self.load()
        fn = lib.bp_tree_qp_phase_f64 if x_c.dtype == torch.float64 else lib.bp_tree_qp_phase_f32
        # the phase kernels write t0 alone: null carry outputs
        ptrs = [t.data_ptr() for t in (*consts, *carry)] + [0] * len(carry) \
            + [t0.data_ptr(), scratch.data_ptr()]
        self._call(fn, (ctypes.c_int(phase),), f"tree_qp phase {phase}", ints, dbl, ptrs, x_c)
        self.phase_launches += 1
        return t0

    @staticmethod
    def _call(fn, lead, what, ints, dbl, ptrs, x_c):
        """Call a launcher of the library on ``x_c``'s device and current
        stream; ``ptrs`` are tensors or raw addresses."""
        ptrs = [p.data_ptr() if isinstance(p, torch.Tensor) else p for p in ptrs]
        with torch.cuda.device(x_c.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(*lead, (ctypes.c_void_p * len(ptrs))(*ptrs),
                     (ctypes.c_int * len(ints))(*ints),
                     (ctypes.c_double * len(dbl))(*dbl),
                     ctypes.c_longlong(x_c.shape[-1]), ctypes.c_int(x_c.device.index),
                     ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {err}")


KERNEL = FusedIterationKernel()


def kernel_ints(plan: StagePlan, cfg: QPIPMConfig, nFx: int, nFu: int):
    """The kernel's integer arguments: dims, then the level table."""
    topo = plan.topo
    levels = build_levels(plan)
    ints = [topo.n, topo.d, topo.m, len(levels), nFx, nFu, topo.totalu,
            topo.totalx, topo.n_branches, cfg.gondzio]
    for mt in levels:
        ints += [mt.nb, mt.l, mt.lx, mt.u0, mt.x0, int(mt.leaf)]
    return ints


def kernel_scalars(cfg: QPIPMConfig, mtot: float, dtype):
    """The kernel's floating-point arguments; the barrier-weight clamp is
    1e6 below float64, as in the plain version."""
    w_max_eff = cfg.w_max if dtype == torch.float64 else min(cfg.w_max, 1e6)
    return [cfg.reg, cfg.tau, w_max_eff, cfg.gap_tol, mtot,
            cfg.gondzio_bmin, cfg.gondzio_bmax]


def fused_iteration(plan: StagePlan, cfg: QPIPMConfig, nFx: int, nFu: int,
                    mtot: float):
    """Step function of one fused IPM iteration: ``step(consts..., carry...)``
    → new carry + gap. CUDA tensors launch the kernel (scratch allocated once
    per step function, i.e. once per solve); CPU tensors run the plain
    version."""
    return _kernel_step(plan, cfg, nFx, nFu, mtot, None)


def phase_step(plan: StagePlan, cfg: QPIPMConfig, nFx: int, nFu: int, mtot: float,
               phase: int):
    """Step function of one phase kernel of the profile: ``step(consts...,
    carry...)`` → t0 (phases 0, 1) or new carry + gap (phase 2). CUDA tensors
    launch the phase kernel (phase 2: the main path's kernel, counted as
    its launches); CPU tensors run :func:`make_phase`."""
    if phase not in PHASES:
        raise ValueError(f"tree_qp phase {phase}: expected one of {PHASES}")
    if phase == 2:
        return fused_iteration(plan, cfg, nFx, nFu, mtot)
    return _kernel_step(plan, cfg, nFx, nFu, mtot, phase)


def _kernel_step(plan, cfg, nFx, nFu, mtot, phase):
    """The step function of the main path (``phase=None``) or of phase 0 / 1."""
    topo = plan.topo
    iterate = make_iteration(plan, cfg, nFx, nFu, mtot) if phase is None \
        else make_phase(plan, cfg, nFx, nFu, mtot, phase)
    n, d, Nc = topo.n, topo.d, nFx + 1
    ints = kernel_ints(plan, cfg, nFx, nFu)
    n_leaves = len(plan.leaf_ids)
    shapes = {
        "Qx2": (topo.totalu, n, n), "qx": (topo.totalu, n), "Ru2": (topo.totalu, d, d),
        "qu": (topo.totalu, d), "Dab2": (topo.totalu, d, d), "qterm": (n_leaves, n),
        "Pterm2": (n_leaves, n, n), "slack_lin": (topo.totalu,), "slack_quad": (1,),
        "A_st": (topo.totalu, n, n), "B_st": (topo.totalu, n, d), "dh": (topo.totalu, n),
        "b1": (topo.totalu, Nc),
        "x": (topo.totalx, n), "u": (topo.totalu, d), "s": (topo.totalu, Nc),
        "sl1": (topo.totalu, Nc), "lam1": (topo.totalu, Nc), "sl2": (topo.totalu, nFu),
        "lam2": (topo.totalu, nFu), "sl3": (topo.totalu, Nc), "lam3": (topo.totalu, Nc),
    }
    shared = {"Fx": (nFx, n), "Fu": (nFu, d), "bu": (1, nFu)}
    scratch = []

    def check(args, dtype, dev, Z):
        for name, t in zip(CONST_ORDER + CARRY_ORDER, args):
            want = shared[name] if name in shared else shapes[name] + (Z,)
            if (not isinstance(t, torch.Tensor) or t.dtype != dtype or t.device != dev
                    or tuple(t.shape) != want or not t.is_contiguous()):
                got = (tuple(t.shape), t.dtype, t.device, t.is_contiguous()) \
                    if isinstance(t, torch.Tensor) else type(t)
                raise ValueError(f"tree_qp_ipm_iter: {name} must be a contiguous "
                                 f"{dtype} tensor of shape {want} on {dev}, got {got}")

    def step(*args):
        if len(args) != len(CONST_ORDER) + CARRY_FIELDS:
            raise ValueError("tree_qp_ipm_iter: expected 16 constants and 9 carry arrays")
        x_c = args[len(CONST_ORDER)]
        if not x_c.is_cuda:
            return iterate(*args)
        if x_c.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"tree_qp_ipm_iter: dtype {x_c.dtype} not supported")
        if (n, d, nFx, nFu) != KERNEL_DIMS:
            raise ValueError(f"tree_qp_ipm_iter: kernel is built for (n, d, nFx, nFu) = "
                             f"{KERNEL_DIMS}, got {(n, d, nFx, nFu)}")
        Z = x_c.shape[-1]
        check(args, x_c.dtype, x_c.device, Z)
        key = (Z, x_c.dtype, x_c.device)
        if not scratch or scratch[0] != key:
            kplan = KERNEL.plan(ints, Z, x_c.dtype, x_c.device.index)
            scratch[:] = [key, torch.empty((kplan["scratch_elems"],), dtype=x_c.dtype,
                                           device=x_c.device)]
        nc = len(CONST_ORDER)
        dbl = kernel_scalars(cfg, mtot, x_c.dtype)
        if phase is None:
            return KERNEL.launch(ints, dbl, args[:nc], args[nc:], scratch[1])
        dbl[2] = phase_w_max(cfg)
        return KERNEL.launch_phase(phase, ints, dbl, args[:nc], args[nc:], scratch[1])

    return step


# ---------------------------------------------------------------------------
# Solve driver: init + loop over fused iterations + best-iterate tracking
# ---------------------------------------------------------------------------


def _prep_consts(plan: StagePlan, cost: StageCost, A_bl, B_bl, dh_bl, h0_bl,
                 Fx, bx, Fu, bu):
    """Per-stage successor transitions + b1 assembly; ``cost`` is batch-last."""
    dtype, dev = A_bl.dtype, A_bl.device
    totalu = plan.topo.totalu
    nFx = np.asarray(Fx).shape[0]
    A_st, B_st = _succ_transitions(plan, A_bl, B_bl)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    Z = h0_bl.shape[-1]
    b1 = torch.cat([h0_bl[:, None, :],
                    as_t(bx)[None, :, None].expand(totalu, nFx, Z)], dim=1)
    return dict(
        Qx2=cost.Qx2, qx=cost.qx, Ru2=cost.Ru2, qu=cost.qu, Dab2=cost.Dab2,
        qterm=cost.qterm, Pterm2=cost.Pterm2, slack_lin=cost.slack_lin,
        slack_quad=torch.as_tensor(cost.slack_quad, dtype=dtype, device=dev).reshape(1, -1),
        A_st=A_st, B_st=B_st,
        dh=dh_bl, b1=b1.contiguous(),
        Fx=as_t(Fx).contiguous(), Fu=as_t(Fu).contiguous(),
        bu=as_t(bu).reshape(1, -1).contiguous(),
    )


class IPMSetup(NamedTuple):
    """What one fused solve iterates on: the kernel's constants (batch-last,
    ``CONST_ORDER``), the starting carry (``CARRY_ORDER``), the step function
    and the row operators of the driver."""

    const_args: list
    carry0: tuple
    step_fn: Any
    nFx_orig: int
    row_mul: Any      # (totalu, n, T) x at constrained nodes → rows (totalu, Nc, T)
    fu_mul: Any       # (totalu, d, T) → (totalu, nFu, T)
    cx_gather: Any    # flat x (totalx, n, T) → constrained nodes (totalu, n, T)
    b1: Any
    bu: Any


def setup_ipm(plan: StagePlan, cost: StageCost, A_bl, B_bl, dh_bl, h0_bl,
              Fx, bx, Fu, bu, x_warm_bl, u_warm_bl,
              cfg: QPIPMConfig = QPIPMConfig(), s_warm_bl=None) -> IPMSetup:
    """Constants, starting point and step function of :func:`qp_ipm_solve_pl`."""
    topo = plan.topo
    n = topo.n
    totalu = topo.totalu
    dtype = x_warm_bl.dtype
    Z = x_warm_bl.shape[-1]
    # A config with no state rows gets one inert padded row 0·x ≤ 1e9: never
    # active, same optimum, every shape stays positive.
    nFx_orig = np.asarray(Fx).shape[0]
    if nFx_orig == 0:
        Fx = np.zeros((1, n))
        bx = np.full((1,), 1e9)
    nFx = np.asarray(Fx).shape[0]
    nFu = np.asarray(Fu).shape[0]
    Nc = nFx + 1
    mtot = float(totalu * Nc + totalu * nFu + totalu * Nc)

    consts = _prep_consts(plan, cost, A_bl, B_bl, dh_bl, h0_bl, Fx, bx, Fu, bu)
    levels = build_levels(plan)

    def cx_gather(x_f):
        return _cx_gather(levels, x_f)

    x_i, u_i = x_warm_bl.contiguous(), u_warm_bl.contiguous()
    if s_warm_bl is None:
        s_i = x_i.new_zeros((totalu, Nc, Z))
    else:
        s_i = s_warm_bl.to(dtype)
        if s_i.shape[1] < Nc:     # caller saw the unpadded Fx (nFx_orig == 0)
            s_i = torch.cat([s_i, s_i.new_zeros((totalu, Nc - s_i.shape[1], Z))], dim=1)
        s_i = s_i.contiguous()
    dh, b1, Fx_t, Fu_t, bu_t = (consts[k] for k in ("dh", "b1", "Fx", "Fu", "bu"))

    def row_mul(xv):
        r0 = -torch.sum(dh * xv, dim=1, keepdim=True)
        return torch.cat([r0, torch.einsum("rn,snt->srt", Fx_t, xv)], dim=1)

    def fu_mul(uv):
        return torch.einsum("rd,sdt->srt", Fu_t, uv)

    sl1 = torch.clamp(b1 - (row_mul(cx_gather(x_i)) - s_i), min=cfg.sl_min)
    sl2 = torch.clamp(bu_t[:, :, None] - fu_mul(u_i), min=cfg.sl_min)
    sl3 = torch.clamp(s_i, min=cfg.sl_min)
    carry0 = (x_i, u_i, s_i, sl1.contiguous(), (cfg.mu0 / sl1).contiguous(),
              sl2.contiguous(), (cfg.mu0 / sl2).contiguous(),
              sl3.contiguous(), (cfg.mu0 / sl3).contiguous())
    return IPMSetup(const_args=[consts[k] for k in CONST_ORDER], carry0=carry0,
                    step_fn=fused_iteration(plan, cfg, nFx, nFu, mtot),
                    nFx_orig=nFx_orig, row_mul=row_mul, fu_mul=fu_mul,
                    cx_gather=cx_gather, b1=b1, bu=bu_t)


def qp_ipm_solve_pl(plan: StagePlan, cost: StageCost, A_bl, B_bl, C_bl,
                    dh_bl, h0_bl, Fx, bx, Fu, bu, x_warm_bl, u_warm_bl,
                    cfg: QPIPMConfig = QPIPMConfig(), s_warm_bl=None):
    """Fused-iteration IPM on batch-last tensors (``cost`` batch-last).
    Returns ``(x, u, s, aux)``; ``aux`` holds ``prim_res``, ``gap``, ``gaps``.

    ``s_warm_bl``: optional warm start for the slack variables (the f64
    restart passes the previous solve's s; the default zeros is the cold
    init)."""
    su = setup_ipm(plan, cost, A_bl, B_bl, dh_bl, h0_bl, Fx, bx, Fu, bu,
                   x_warm_bl, u_warm_bl, cfg, s_warm_bl)
    carry = su.carry0
    Z = carry[0].shape[-1]
    n_best = 3     # best-iterate tracking: x, u, s (+ gap)
    best = carry[:n_best]
    bgap = carry[0].new_full((Z,), float("inf"))
    gaps = []
    for _ in range(cfg.iters):
        out = su.step_fn(*su.const_args, *carry)
        gap = out[CARRY_FIELDS].reshape(-1)
        better = gap < bgap
        best = tuple(torch.where(better, c, b) for c, b in zip(carry[:n_best], best))
        bgap = torch.where(better, gap, bgap)
        carry = out[:CARRY_FIELDS]
        gaps.append(gap)
    gaps = torch.stack(gaps)
    gap_last = gaps[-1]
    use_last = gap_last <= bgap
    x_f, u_f, s_f = (torch.where(use_last, c, b) for c, b in zip(carry[:n_best], best))
    gap_f = torch.where(use_last, gap_last, bgap)

    rows1 = su.row_mul(su.cx_gather(x_f)) - s_f
    rows2 = su.fu_mul(u_f)
    lane_max = lambda v: v.reshape(-1, Z).amax(0)
    prim = torch.maximum(
        lane_max(torch.clamp(rows1 - su.b1, min=0.0)),
        torch.maximum(lane_max(torch.clamp(rows2 - su.bu[:, :, None], min=0.0)),
                      lane_max(torch.clamp(-s_f, min=0.0))))
    aux = {"prim_res": prim, "gap": gap_f, "gaps": gaps}
    if su.nFx_orig == 0:
        s_f = s_f[:, :1]          # drop the inert padded row's slack
    return x_f, u_f, s_f, aux
