"""Fused batch-last nested-CVaR IPM iteration, with its CUDA kernel (the
reference package's ``solvers/cvar_pl.py``).

One Mehrotra iteration with Gondzio correctors of the nested-CVaR tree SOCP
is one call of :func:`fused_cvar_iteration`'s step function:

- on CUDA tensors it launches the hand-written kernel
  ``csrc/cvar_ipm_iter.cu`` (a warp per tree), or raises;
- on CPU tensors it runs :func:`make_cvar_iteration`, the plain PyTorch
  version of the same iteration, which the tests hold against the JAX
  package.

The iteration keeps three structural rewrites of the reference:

- the K per-cone Woodbury columns and the predictor right-hand side share
  one backward / forward tree sweep with an extra column axis (R = K+1);
- the risk saddle decouples per branch into one (2+m)² system, solved by
  Gauss-Jordan with partial pivoting (first maximal row wins);
- the cone gradients stay factored: a per-stage dot, then the (K, totalu)
  cone mask.

The merge state transform ``S`` enters per lane through the constants
``QxC`` (SᵀQS), ``Fxl`` (Fx·S) and ``FxFx`` (their row outer products), so
the iteration is the same with and without it. The loop over iterations and
the best-iterate tracking stay in Python (:func:`cvar_ipm_solve_pl`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

from belief_planning_tpu_torch.solvers.cvar import CVaRPlan
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
from belief_planning_tpu_torch.solvers.tree_qp_pl import (
    _cx_gather,
    _factor_blocks,
    _fold0,
    _repeat0,
    _succ_transitions,
    _ublk,
    build_levels,
)
from belief_planning_tpu_torch.utils.nvcc import build_shared_library


# ---------------------------------------------------------------------------
# Small dense solves on batch-last blocks
# ---------------------------------------------------------------------------


def _gj_inv_bl(M):
    """Unpivoted Gauss-Jordan inverse of an (a, a, T) batch of matrices.

    Used on the W^½-equilibrated Woodbury capacitance, which is symmetric
    positive definite with diagonal ≥ 1, where no pivoting is needed."""
    a, _, T = M.shape
    eye = torch.eye(a, dtype=M.dtype, device=M.device)[:, :, None].expand(a, a, T)
    rows = [torch.cat([M[i:i + 1], eye[i:i + 1]], dim=1) for i in range(a)]   # (1, 2a, T)
    for i in range(a):
        ri = rows[i] / rows[i][:, i:i + 1, :]
        rows = [ri if j == i else rows[j] - rows[j][:, i:i + 1, :] * ri for j in range(a)]
    return torch.cat([r[:, a:, :] for r in rows], dim=0)


def _gj_solve_pivot_bl(A, B):
    """Solve A X = B for (nb, a, a, T) systems and (nb, a, R, T) right-hand
    sides by Gauss-Jordan with partial pivoting. The pivot row of column k is
    the first row j ≥ k whose |A[j, k]| is maximal (comparison masks and a
    first-match one-hot, NaN-propagating as the reference's)."""
    nb, a, _, T = A.shape
    dtype = A.dtype
    aug = torch.cat([A, B], dim=2)                              # (nb, a, a+R, T)
    for k in range(a):
        col = torch.abs(aug[:, :, k, :])                        # (nb, a, T)
        rowmask = (torch.arange(a, device=A.device) >= k).to(dtype)[None, :, None]
        eligible = col * rowmask
        mx = torch.amax(eligible, dim=1, keepdim=True)          # (nb, 1, T)
        eq = (eligible >= mx).to(dtype) * rowmask
        taken = torch.zeros_like(mx)
        fo_rows = []
        for j in range(a):
            fj = eq[:, j:j + 1, :] * (1.0 - taken)
            fo_rows.append(fj)
            taken = taken + fj
        fo = torch.cat(fo_rows, dim=1)                          # (nb, a, T)
        pivrow = torch.sum(fo[:, :, None, :] * aug, dim=1, keepdim=True)
        rowk = aug[:, k:k + 1]
        # swap: the selected row takes old row k, then row k takes the pivot row
        aug = torch.where(fo[:, :, None, :] > 0.5, rowk.expand_as(aug), aug)
        aug = torch.cat([aug[:, :k], pivrow, aug[:, k + 1:]], dim=1)
        rk = aug[:, k:k + 1] / aug[:, k:k + 1, k:k + 1, :]
        aug = aug - aug[:, :, k:k + 1, :] * rk
        aug = torch.cat([aug[:, :k], rk, aug[:, k + 1:]], dim=1)
    return aug[:, :, a:, :]


def _mv_mr(A, v):
    """(nb, i, k, T) @ (nb, k, R, T) → (nb, i, R, T)."""
    return torch.sum(A[:, :, :, None, :] * v[:, None, :, :, :], dim=2)


def _mtv_mr(A, v):
    """Aᵀv: (nb, k, i, T), (nb, k, R, T) → (nb, i, R, T)."""
    return torch.sum(A[:, :, :, None, :] * v[:, :, None, :, :], dim=1)


def _linear_blocks_mr(levels, K_l, Hinv_l, Acl_l, B_st, qx_f, qu_f, n, d, m):
    """Backward linear sweep with a column axis: qx_f (totalu, n, R, T),
    qu_f (totalu, d, R, T), zero terminal term. Returns per-level
    feed-forward blocks (nb, l, d, R, T)."""
    NB = len(levels) - 1
    kff_l = [None] * (NB + 1)
    R, T = qx_f.shape[2], qx_f.shape[-1]
    p = None
    for k in range(NB, -1, -1):
        mt = levels[k]
        if k == NB:
            p = qx_f.new_zeros((mt.nb, n + d, R, T))
        else:
            p = _fold0(p, m)
        qx_b, qu_b, B_b = _ublk(qx_f, mt), _ublk(qu_f, mt), _ublk(B_st, mt)
        kffs = []
        for j in range(mt.l - 1, -1, -1):
            l_u = qu_b[:, j] + _mtv_mr(B_b[:, j], p[:, :n]) + p[:, n:]
            kffs.append(-_mv_mr(Hinv_l[k][:, j], l_u))
            p = _mtv_mr(Acl_l[k][:, j], p) + _mtv_mr(K_l[k][:, j], qu_b[:, j])
            p[:, :n] += qx_b[:, j]
        kff_l[k] = torch.stack(kffs[::-1], dim=1)
    return kff_l


def _forward_blocks_mr(levels, K_l, Acl_l, B_st, kff_l, n, d, m, R, T):
    """Forward rollout with a column axis from a zero root state; flat
    dx (totalx, n, R, T), du (totalu, d, R, T)."""
    NB = len(levels) - 1
    xi = B_st.new_zeros((1, n + d, R, T))
    dx_parts, du_parts = [], []
    for k in range(NB + 1):
        mt = levels[k]
        B_b = _ublk(B_st, mt)
        us, xs = [], []
        for j in range(mt.l):
            kf = kff_l[k][:, j]
            us.append(_mv_mr(K_l[k][:, j], xi) + kf)
            xs.append(xi[:, :n])
            xi = _mv_mr(Acl_l[k][:, j], xi) + torch.cat([_mv_mr(B_b[:, j], kf), kf], dim=1)
        if mt.leaf:
            xs.append(xi[:, :n])
        du_parts.append(torch.stack(us, dim=1).reshape(mt.nb * mt.l, d, R, T))
        dx_parts.append(torch.stack(xs, dim=1).reshape(mt.nb * mt.lx, n, R, T))
        if k < NB:
            xi = _repeat0(xi, m)
    return torch.cat(dx_parts, dim=0), torch.cat(du_parts, dim=0)


# ---------------------------------------------------------------------------
# One fused CVaR IPM iteration: the plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


CONST_ORDER = ["A_st", "B_st", "dh", "b1", "pa", "csc", "cx", "cc", "QxC", "Fxl", "FxFx"]
SHARED_ORDER = ["Fu", "bu", "Rm", "mask", "maskT", "frisk", "friskT", "Ssgn", "SsgnT"]
CARRY_ORDER = ["x", "u", "s", "r", "sl1", "lam1", "sl2", "lam2", "sl3", "lam3",
               "sl4", "lam4", "sq", "lq"]
CARRY_FIELDS = len(CARRY_ORDER)


def _w_max_eff(cfg: CVaRIPMConfig, dtype):
    """The barrier-weight clamp: ``w_max`` in float64, else also ≤ ``w_max_f32``."""
    return cfg.w_max if dtype == torch.float64 else min(cfg.w_max, cfg.w_max_f32)


def make_cvar_iteration(cplan: CVaRPlan, cfg: CVaRIPMConfig, dims: dict):
    """Returns ``iterate(consts..., shared..., itv, carry...)`` → new carry +
    gap, on batch-last tensors with trailing lane axis T (orders:
    ``CONST_ORDER``, ``SHARED_ORDER``, then ``CARRY_ORDER``); ``itv`` is the
    iteration index (a number).

    dims: n, d, m, Nc, nFx, nFu, K, bdim, nrisk, nsgn, Qslack1, mtot."""
    plan = cplan.plan
    n, d, m = dims["n"], dims["d"], dims["m"]
    Nc = dims["Nc"]
    K, bdim, nrisk = dims["K"], dims["bdim"], dims["nrisk"]
    Qslack1, mtot = dims["Qslack1"], dims["mtot"]
    totalu = plan.topo.totalu
    levels = build_levels(plan)
    n_leaves = len(plan.leaf_ids)
    mu_m0 = 2 * bdim + bdim * m

    def cx_gather(x_f):
        return _cx_gather(levels, x_f)

    def iterate(A_st, B_st, dh, b1, pa, csc, cxl, cc, QxC, Fxl, FxFx,
                Fu, bu, Rm, mask, maskT, frisk, friskT, Ssgn, SsgnT, itv,
                x_c, u_c, s_c, r_c, sl1, lam1, sl2, lam2, sl3, lam3, sl4, lam4, sq, lq):
        dtype, dev = x_c.dtype, x_c.device
        T = x_c.shape[-1]
        w_max_eff = _w_max_eff(cfg, dtype)
        inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
        csc_inv = 1.0 / csc                                        # (K, T)

        def sum1(v):
            """Sum over axis 1, left to right."""
            out = v[:, 0]
            for c in range(1, v.shape[1]):
                out = out + v[:, c]
            return out

        def with_cols(f, *vs):
            """Apply a column-axis function to inputs without one."""
            return f(*(v[:, :, None] for v in vs))[:, :, 0]

        def row_mul(xv):
            """x rows (totalu, n, [R,] T) → [−dh·x; Fx x] (totalu, Nc, [R,] T)."""
            if xv.ndim == 3:
                return with_cols(row_mul, xv)
            r0 = -torch.sum(dh[:, :, None, :] * xv, dim=1, keepdim=True)
            rr = torch.sum(Fxl[None, :, :, None, :] * xv[:, None], dim=2)
            return torch.cat([r0, rr], dim=1)

        def row_mulT(v):
            """Fxcᵀ v: (totalu, Nc, [R,] T) → (totalu, n, [R,] T)."""
            if v.ndim == 3:
                return with_cols(row_mulT, v)
            out = -dh[:, :, None, :] * v[:, 0:1]
            return out + torch.sum(Fxl[None, :, :, None, :] * v[:, 1:, None], dim=1)

        def fu_mul(uv):
            return torch.einsum("rd,sdt->srt", Fu, uv)

        def fu_mulT(v):
            return torch.einsum("rd,srt->sdt", Fu, v)

        def sum_lane(v):
            return v.reshape(-1, T).sum(0, keepdim=True)            # (1, T)

        def min_lane(v):
            return v.reshape(-1, T).amin(0, keepdim=True)

        def sgn_sel(v):
            """v[sgn_idx]: (nrisk, T) → (nsgn, T)."""
            return torch.einsum("ir,rt->it", Ssgn, v)

        def sgn_scatter(v):
            """zeros(nrisk).at[sgn_idx].add(v): (nsgn, T) → (nrisk, T)."""
            return torch.einsum("ri,it->rt", SsgnT, v)

        # ---- per-stage cone pieces ----------------------------------------
        xc = cx_gather(x_c)                                        # (totalu, n, T)
        gx_stage = 2.0 * torch.einsum("sit,ijt->sjt", xc, QxC) + cxl[None]
        gu_stage = 2.0 * torch.einsum("sat,ab->sbt", u_c, Rm)
        stage_cost = (torch.sum(xc * (gx_stage - cxl[None]), dim=1) * 0.5
                      + torch.sum(xc * cxl[None], dim=1) + cc
                      + torch.sum(u_c * gu_stage, dim=1) * 0.5
                      + Qslack1 * sum1(s_c))                       # (totalu, T)

        def cone_vals(stage_cost_, r_):
            q = torch.einsum("kj,jt->kt", mask, stage_cost_) * csc_inv
            return q + torch.einsum("kr,rt->kt", frisk, r_) * csc_inv

        def gdot(xx_c, uu, ss, rr):
            """g_kᵀ v for all K cones; the inputs may carry a column axis."""
            if xx_c.ndim == 3:
                return gdot(xx_c[:, :, None], uu[:, :, None], ss[:, :, None], rr[:, None])[:, 0]
            ds = (torch.sum(gx_stage[:, :, None] * xx_c, dim=1)
                  + torch.sum(gu_stage[:, :, None] * uu, dim=1)
                  + Qslack1 * sum1(ss))                            # (totalu, R, T)
            out = torch.einsum("kj,jqt->kqt", mask, ds) * csc_inv[:, None]
            return out + torch.einsum("kr,rqt->kqt", frisk, rr) * csc_inv[:, None]

        # ---- residuals -----------------------------------------------------
        r1 = row_mul(xc) - s_c + sl1 - b1
        r2 = fu_mul(u_c) + sl2 - bu[:, :, None]
        r3 = -s_c + sl3
        r4 = -sgn_sel(r_c) + sl4
        rq = cone_vals(stage_cost, r_c) + sq
        gap = (sum_lane(sl1 * lam1) + sum_lane(sl2 * lam2) + sum_lane(sl3 * lam3)
               + sum_lane(sl4 * lam4) + sum_lane(sq * lq)) / mtot      # (1, T)

        # ---- barrier-weighted factorization --------------------------------
        clampw = lambda w: torch.clamp(w, max=w_max_eff)
        lq_eff = lq * csc_inv                                      # (K, T)
        lqs = torch.einsum("jk,kt->jt", maskT, lq_eff)             # (totalu, T)
        lam_stage = lqs.clone()
        lam_stage[0] += 1.0
        w1, w2, w3 = clampw(lam1 / sl1), clampw(lam2 / sl2), clampw(lam3 / sl3)
        w4, wq = clampw(lam4 / sl4), clampw(lq / sq)
        kap = w1 + w3 + cfg.reg
        coefs = w1 - w1 * w1 / kap
        eye_n = torch.eye(n, dtype=dtype, device=dev)[None, :, :, None]
        Qx2 = 2.0 * lqs[:, None, None, :] * QxC[None] + cfg.reg * eye_n
        Qx2 = Qx2 + coefs[:, 0:1][:, :, None, :] * dh[:, :, None, :] * dh[:, None, :, :]
        Qx2 = Qx2 + torch.sum(coefs[:, 1:][:, :, None, None, :] * FxFx[None], dim=1)
        FuFu = Fu[:, :, None] * Fu[:, None, :]
        Ru2 = 2.0 * lam_stage[:, None, None, :] * Rm[None, :, :, None]
        Ru2 = Ru2 + cfg.reg * torch.eye(d, dtype=dtype, device=dev)[None, :, :, None]
        Ru2 = Ru2 + torch.sum(w2[:, :, None, None, :] * FuFu[None, :, :, :, None], dim=1)
        Pterm2 = (cfg.reg * eye_n).expand(n_leaves, n, n, T)
        Dab2 = Qx2.new_zeros((totalu, d, d, T))
        K_l, Hinv_l, Acl_l = _factor_blocks(levels, Qx2, Dab2, Ru2, Pterm2, A_st, B_st, n, d, m)

        # ---- risk block: one (2+m)² pivoted system per branch ---------------
        # [ h_ρ   −ε     0        ] [v_ρ]   [q_ρ − q_σ    ]
        # [ 1     1+ε²  −paᵀ      ] [v_σ] = [ε·q_σ        ]
        # [ 0     ε·pa  diag(h_μ⁻)] [v_μ]   [q_μ⁻ + pa·q_σ]
        hd = cfg.reg + sgn_scatter(w4)                             # (nrisk, T)
        h_rho = hd[0:bdim]
        h_muP = hd[2 * bdim:2 * bdim + bdim * m]
        h_muM = hd[mu_m0:].reshape(bdim, m, T)
        eps = cfg.reg
        eye_m = torch.eye(m, dtype=dtype, device=dev)[None, :, :, None]
        full = lambda v, *shape: torch.full(shape, v, dtype=dtype, device=dev)
        row_rho = torch.cat([h_rho[:, None, None, :], full(-eps, bdim, 1, 1, T),
                             full(0.0, bdim, 1, m, T)], dim=2)
        row_eq = torch.cat([full(1.0, bdim, 1, 1, T), full(1.0 + eps * eps, bdim, 1, 1, T),
                            -pa[:, None, :, :]], dim=2)
        rows_mu = torch.cat([full(0.0, bdim, m, 1, T), eps * pa[:, :, None, :],
                             h_muM[:, :, None, :] * eye_m], dim=2)
        M_risk = torch.cat([row_rho, row_eq, rows_mu], dim=1)      # (bdim, 2+m, 2+m, T)

        def risk_tl(q):
            """Top-left block of the risk saddle's inverse applied to q (nrisk, R, T)."""
            R_ = q.shape[1]
            q_rho, q_sig = q[0:bdim], q[bdim:2 * bdim]
            q_muP = q[2 * bdim:2 * bdim + bdim * m]
            q_muM = q[mu_m0:].reshape(bdim, m, R_, T)
            rhs = torch.cat([(q_rho - q_sig)[:, None], (eps * q_sig)[:, None],
                             q_muM + pa[:, :, None, :] * q_sig[:, None]], dim=1)
            v = _gj_solve_pivot_bl(M_risk, rhs)                   # (bdim, 2+m, R, T)
            v_muP = q_muP / h_muP[:, None, :]
            return torch.cat([v[:, 0], v[:, 1], v_muP, v[:, 2:].reshape(bdim * m, R_, T)], dim=0)

        # ---- H0 solve (tree + rows + risk) with a column axis ---------------
        w1kap = w1 / kap

        def h0_apply(qx, qu, qs, qr):
            """Factorized solve of the row-eliminated H0 system; every input
            carries a column axis: qx (totalu, n, R, T), qu (totalu, d, R, T),
            qs (totalu, Nc, R, T), qr (nrisk, R, T)."""
            qx_eff = qx + row_mulT(w1kap[:, :, None, :] * qs)
            kff_l = _linear_blocks_mr(levels, K_l, Hinv_l, Acl_l, B_st, qx_eff, qu, n, d, m)
            xr, ur = _forward_blocks_mr(levels, K_l, Acl_l, B_st, kff_l, n, d, m,
                                        qx.shape[2], T)
            sr = (w1[:, :, None, :] * row_mul(cx_gather(xr)) - qs) / kap[:, :, None, :]
            return xr, ur, sr, -risk_tl(qr)

        def h0_apply1(qx, qu, qs, qr):
            out = h0_apply(qx[:, :, None], qu[:, :, None], qs[:, :, None], qr[:, None])
            return tuple(o[:, :, 0] if o.ndim == 4 else o[:, 0] for o in out)

        # ---- dual residual pieces ------------------------------------------
        obj_gu = torch.zeros_like(u_c)
        obj_gu[0] = 2.0 * torch.einsum("at,ab->bt", u_c[0], Rm)
        obj_s_col = torch.zeros_like(s_c)
        obj_s_col[0] = Qslack1
        obj_r = torch.zeros_like(r_c)
        obj_r[0] = 1.0
        rd_x = lqs[:, None, :] * gx_stage + row_mulT(lam1)
        rd_u = lqs[:, None, :] * gu_stage + obj_gu + fu_mulT(lam2)
        rd_s = obj_s_col + Qslack1 * lqs[:, None, :] - lam1 - lam3
        rd_r = obj_r + torch.einsum("rk,kt->rt", friskT, lq_eff) - sgn_scatter(lam4)

        def fold_cones(qx, qu, qs, qr, exq):
            """Fold the eliminated cone duals into the rhs: + Σ_k exq_k g_k."""
            exqc = exq * csc_inv
            eg = torch.einsum("jk,kt->jt", maskT, exqc)            # (totalu, T)
            return (qx + eg[:, None, :] * gx_stage, qu + eg[:, None, :] * gu_stage,
                    qs + Qslack1 * eg[:, None, :], qr + torch.einsum("rk,kt->rt", friskT, exqc))

        def direction_rhs(rc1, rc2, rc3, rc4, rcq):
            ex1 = (-rc1 + lam1 * r1) / sl1
            ex2 = (-rc2 + lam2 * r2) / sl2
            ex3 = (-rc3 + lam3 * r3) / sl3
            ex4 = (-rc4 + lam4 * r4) / sl4
            exq = (-rcq + lq * rq) / sq
            return fold_cones(rd_x + row_mulT(ex1), rd_u + fu_mulT(ex2), rd_s - ex1 - ex3,
                              rd_r - sgn_scatter(ex4), exq)

        # ---- Woodbury columns + predictor in one multi-column sweep ----------
        qx_a, qu_a, qs_a, qr_a = direction_rhs(sl1 * lam1, sl2 * lam2, sl3 * lam3,
                                               sl4 * lam4, sq * lq)
        mT = maskT[:, :, None] * csc_inv[None]                     # (totalu, K, T)
        qx_mr = torch.cat([mT[:, None] * gx_stage[:, :, None], qx_a[:, :, None]], dim=2)
        qu_mr = torch.cat([mT[:, None] * gu_stage[:, :, None], qu_a[:, :, None]], dim=2)
        qs_mr = torch.cat([(Qslack1 * mT[:, None]).expand(totalu, Nc, K, T),
                           qs_a[:, :, None]], dim=2)
        qr_mr = torch.cat([friskT[:, :, None] * csc_inv[None], qr_a[:, None]], dim=1)
        Zx, Zu, Zs, Zr = h0_apply(qx_mr, qu_mr, qs_mr, qr_mr)
        gd_all = gdot(cx_gather(Zx), Zu, Zs, Zr)                   # (K, K+1, T)
        GtZ = gd_all[:, :K]
        # Woodbury capacitance I − GᵀZ·diag(wq), equilibrated by W^½: symmetric
        # positive definite with diagonal ≥ 1, so unpivoted Gauss-Jordan is stable
        sw = torch.sqrt(wq)
        Wm_n = torch.eye(K, dtype=dtype, device=dev)[:, :, None] - GtZ * sw[:, None, :] * sw[None]
        Wm_n_inv = _gj_inv_bl(Wm_n)
        ZxK, ZuK, ZsK, ZrK = Zx[:, :, :K], Zu[:, :, :K], Zs[:, :, :K], Zr[:, :K]

        def wb_correct(ax, au, as_, ar, phi0):
            phi = torch.sum(Wm_n_inv * (sw * phi0)[None], dim=1) / sw
            corr = wq * phi
            return (ax + torch.sum(ZxK * corr[None, None], dim=2),
                    au + torch.sum(ZuK * corr[None, None], dim=2),
                    as_ + torch.sum(ZsK * corr[None, None], dim=2),
                    ar + torch.sum(ZrK * corr[None], dim=1))

        def finish_direction(dx, du, dsv, dr, pure=False):
            drow1 = row_mul(cx_gather(dx)) - dsv
            drow2 = fu_mul(du)
            dq = gdot(cx_gather(dx), du, dsv, dr)
            if pure:
                return (dx, du, dsv, dr, -drow1, -drow2, dsv, sgn_sel(dr), -dq)
            return (dx, du, dsv, dr, -r1 - drow1, -r2 - drow2, -r3 + dsv,
                    -r4 + sgn_sel(dr), -rq - dq)

        def dual_steps(rcs, dirs):
            sls, lams = (sl1, sl2, sl3, sl4, sq), (lam1, lam2, lam3, lam4, lq)
            return dirs + tuple((-rc - lam * dsl) / sl for rc, lam, dsl, sl
                                in zip(rcs, lams, dirs[4:9], sls))

        # predictor: column K of the multi-column solve, Woodbury-corrected
        rhs_pred = (sl1 * lam1, sl2 * lam2, sl3 * lam3, sl4 * lam4, sq * lq)
        da_core = wb_correct(Zx[:, :, K], Zu[:, :, K], Zs[:, :, K], Zr[:, K], gd_all[:, K])
        da = dual_steps(rhs_pred, finish_direction(*da_core))

        def max_step(v, dv):
            return torch.clamp(min_lane(torch.where(dv < 0, -v / dv, inf)), max=1.0)

        def all_step(dirs):
            a = None
            for v, lam, dsl, dlam in zip((sl1, sl2, sl3, sl4, sq), (lam1, lam2, lam3, lam4, lq),
                                         dirs[4:9], dirs[9:14]):
                f = torch.minimum(max_step(v, dsl), max_step(lam, dlam))
                a = f if a is None else torch.minimum(a, f)
            return a

        def gap_at(a, dirs):
            g = None
            for v, lam, dsl, dlam in zip((sl1, sl2, sl3, sl4, sq), (lam1, lam2, lam3, lam4, lq),
                                         dirs[4:9], dirs[9:14]):
                t = sum_lane((v + a * dsl) * (lam + a * dlam))
                g = t if g is None else g + t
            return g / mtot

        gap_aff = gap_at(all_step(da), da)
        sigma_c = torch.clamp((gap_aff / (gap + 1e-30)) ** 3, 0.0, 1.0)
        rhs_corr = tuple(rc + dsl * dlam - sigma_c * gap
                         for rc, dsl, dlam in zip(rhs_pred, da[4:9], da[9:14]))

        def solve_direction(rcs, qx, qu, qs, qr, pure):
            core = h0_apply1(qx, qu, qs, qr)
            core = wb_correct(*core, gdot(cx_gather(core[0]), *core[1:]))
            return dual_steps(rcs, finish_direction(*core, pure=pure))

        dc = solve_direction(rhs_corr, *direction_rhs(*rhs_corr), pure=False)

        # Gondzio centrality correctors: a pure complementarity rhs on the same
        # factor, accepted per lane if the step grows and every entry is finite
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

            rcs = tuple(outlier(v, dsl, lam, dlam) for v, lam, dsl, dlam
                        in zip((sl1, sl2, sl3, sl4, sq), (lam1, lam2, lam3, lam4, lq),
                               dc[4:9], dc[9:14]))
            ex1, ex2, ex3, ex4, exq = (-rc / sl for rc, sl in zip(rcs, (sl1, sl2, sl3, sl4, sq)))
            rhs = fold_cones(row_mulT(ex1), fu_mulT(ex2), -ex1 - ex3, -sgn_scatter(ex4), exq)
            dd = solve_direction(rcs, *rhs, pure=True)
            cand = tuple(c + e for c, e in zip(dc, dd))
            cand_ok = torch.ones((1, T), dtype=torch.bool, device=dev)
            for c in cand:
                cand_ok = cand_ok & torch.isfinite(c).reshape(-1, T).all(0, keepdim=True)
            accept = (all_step(cand) > a_cur) & cand_ok              # (1, T)
            dc = tuple(torch.where(accept.reshape((1,) * (c.ndim - 1) + (T,)), c, o)
                       for c, o in zip(cand, dc))

        a0 = cfg.tau * all_step(dc)
        obj_now = (0.5 * sum_lane(u_c[0:1] * obj_gu[0:1]) + r_c[0:1]
                   + Qslack1 * sum_lane(s_c[0:1]))
        a0 = torch.where(gap < cfg.gap_tol * (1.0 + torch.abs(obj_now)),
                         torch.zeros_like(a0), a0)
        if itv < cfg.early_iters:
            a0 = torch.clamp(a0, max=cfg.a_cap_early)
        grow = 10.0 * gap + 1e-9
        a1 = torch.where(gap_at(a0, dc) > grow, 0.3 * a0, a0)
        a = torch.where(gap_at(a1, dc) > grow, 0.3 * a1, a1)
        finite = torch.isfinite(a)
        for dd in dc:
            finite = finite & torch.isfinite(dd).reshape(-1, T).all(0, keepdim=True)
        a = torch.where(finite, a, torch.zeros_like(a))
        carry = (x_c, u_c, s_c, r_c, sl1, lam1, sl2, lam2, sl3, lam3, sl4, lam4, sq, lq)
        # the direction tuple is (dx, du, ds, dr, dsl1..4, dsq, dlam1..4, dlq)
        dirs = (dc[0], dc[1], dc[2], dc[3], dc[4], dc[9], dc[5], dc[10], dc[6], dc[11],
                dc[7], dc[12], dc[8], dc[13])
        out = tuple(torch.where(finite.reshape((1,) * (v.ndim - 1) + (T,)), v + a * dv, v)
                    for v, dv in zip(carry, dirs))
        return out + (gap,)

    return iterate


# ---------------------------------------------------------------------------
# The CUDA kernel and its wrapper
# ---------------------------------------------------------------------------


KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "cvar_ipm_iter.cu"


PLAN_KEYS = ("scratch_elems", "blocks", "trees_per_block", "blocks_per_sm", "sms",
             "smem_bytes")


def bind_kernel_library(lib):
    """Declare the C interface of a built ``cvar_ipm_iter`` library."""
    for name in ("bp_cvar_iter_f32", "bp_cvar_iter_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bp_cvar_iter_plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_longlong)]
    lib.bp_cvar_iter_plan.restype = ctypes.c_int
    return lib


def kernel_plan(lib, ints, B: int, dtype, device_index: int) -> dict:
    """The kernel's launch shape for ``B`` trees (``PLAN_KEYS``): the scratch
    elements it needs (one tree-major slot per resident team), the persistent
    grid, the trees (warps) a block, the resident blocks an SM, the SMs and
    the dynamic shared memory a block. Raises on dims the kernel does not
    take or a failed CUDA query."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    err = lib.bp_cvar_iter_plan((ctypes.c_int * len(ints))(*ints), ctypes.c_longlong(B),
                                ctypes.c_int(int(dtype == torch.float64)),
                                ctypes.c_int(device_index), out)
    if err == 1:
        raise ValueError("cvar_ipm_iter: unsupported dims or level table")
    if err != 0:
        raise RuntimeError(f"cvar_ipm_iter: launch plan failed: CUDA error {err}")
    return dict(zip(PLAN_KEYS, out))


class FusedCVaRIterationKernel:
    """Wrapper of ``csrc/cvar_ipm_iter.cu`` (replaces the reference's
    ``cvar_pl._make_pallas_cvar_iteration``), or of another source with its C
    interface. ``launches`` counts the kernel launches, and nothing else,
    ``launches_f64`` those of them in double;
    ``build_log`` / ``build_seconds`` are what nvcc printed and took when
    this process built the library."""

    def __init__(self, source: Path = KERNEL_SOURCE):
        self.source = Path(source)
        self.launches = 0
        self.launches_f64 = 0
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
        lib = self.load()
        x_c = carry[0]
        outs = [torch.empty_like(c) for c in carry]
        gap = torch.empty((1, x_c.shape[-1]), dtype=x_c.dtype, device=x_c.device)
        ptrs = [t.data_ptr() for t in (*consts, *carry, *outs, gap, scratch)]
        fn = lib.bp_cvar_iter_f64 if x_c.dtype == torch.float64 else lib.bp_cvar_iter_f32
        with torch.cuda.device(x_c.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
                     (ctypes.c_double * len(dbl))(*dbl), ctypes.c_longlong(x_c.shape[-1]),
                     ctypes.c_int(x_c.device.index), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"cvar_ipm_iter launch failed: CUDA error {err}")
        self.launches += 1
        self.launches_f64 += x_c.dtype == torch.float64
        return (*outs, gap)


KERNEL = FusedCVaRIterationKernel()


def kernel_ints(cplan: CVaRPlan, cfg: CVaRIPMConfig, dims: dict):
    """The kernel's integer arguments: dims, then the level table."""
    topo = cplan.plan.topo
    levels = build_levels(cplan.plan)
    ints = [dims["n"], dims["d"], dims["m"], len(levels), dims["nFx"], dims["nFu"],
            topo.totalu, topo.totalx, topo.n_branches, cfg.gondzio, dims["K"], dims["bdim"],
            dims["nrisk"], dims["nsgn"], cfg.early_iters]
    for mt in levels:
        ints += [mt.nb, mt.l, mt.lx, mt.u0, mt.x0, int(mt.leaf)]
    return ints


def kernel_scalars(cfg: CVaRIPMConfig, dims: dict, dtype, itv):
    """The kernel's floating-point arguments (the iteration index last)."""
    return [cfg.reg, cfg.tau, _w_max_eff(cfg, dtype), cfg.gap_tol, dims["mtot"],
            cfg.gondzio_bmin, cfg.gondzio_bmax, cfg.a_cap_early, dims["Qslack1"], float(itv)]


def fused_cvar_iteration(cplan: CVaRPlan, cfg: CVaRIPMConfig, dims: dict):
    """Step function of one fused CVaR IPM iteration:
    ``step(consts..., shared..., itv, carry...)`` → new carry + gap. CUDA
    tensors launch the kernel (scratch allocated once per step function,
    i.e. once per solve); CPU tensors run the plain version."""
    topo = cplan.plan.topo
    iterate = make_cvar_iteration(cplan, cfg, dims)
    n, d, m = dims["n"], dims["d"], dims["m"]
    Nc, nFx, nFu, K = dims["Nc"], dims["nFx"], dims["nFu"], dims["K"]
    bdim, nrisk, nsgn = dims["bdim"], dims["nrisk"], dims["nsgn"]
    U, X = topo.totalu, topo.totalx
    ints = kernel_ints(cplan, cfg, dims)
    lane = {
        "A_st": (U, n, n), "B_st": (U, n, d), "dh": (U, n), "b1": (U, Nc), "pa": (bdim, m),
        "csc": (K,), "cx": (n,), "cc": (1,), "QxC": (n, n), "Fxl": (nFx, n),
        "FxFx": (nFx, n, n),
        "x": (X, n), "u": (U, d), "s": (U, Nc), "r": (nrisk,), "sl1": (U, Nc),
        "lam1": (U, Nc), "sl2": (U, nFu), "lam2": (U, nFu), "sl3": (U, Nc), "lam3": (U, Nc),
        "sl4": (nsgn,), "lam4": (nsgn,), "sq": (K,), "lq": (K,),
    }
    shared = {"Fu": (nFu, d), "bu": (1, nFu), "Rm": (d, d), "mask": (K, U), "maskT": (U, K),
              "frisk": (K, nrisk), "friskT": (nrisk, K), "Ssgn": (nsgn, nrisk),
              "SsgnT": (nrisk, nsgn)}
    names = CONST_ORDER + SHARED_ORDER + CARRY_ORDER
    n_in = len(CONST_ORDER) + len(SHARED_ORDER)
    scratch = []

    def check(args, dtype, dev, Z):
        for name, t in zip(names, args):
            want = shared[name] if name in shared else lane[name] + (Z,)
            if (not isinstance(t, torch.Tensor) or t.dtype != dtype or t.device != dev
                    or tuple(t.shape) != want or not t.is_contiguous()):
                got = (tuple(t.shape), t.dtype, t.device, t.is_contiguous()) \
                    if isinstance(t, torch.Tensor) else type(t)
                raise ValueError(f"cvar_ipm_iter: {name} must be a contiguous {dtype} "
                                 f"tensor of shape {want} on {dev}, got {got}")

    def step(*args):
        if len(args) != n_in + 1 + CARRY_FIELDS:
            raise ValueError("cvar_ipm_iter: expected 11 constants, 9 shared constants, "
                             "the iteration index and 14 carry arrays")
        itv = args[n_in]
        x_c = args[n_in + 1]
        if not x_c.is_cuda:
            return iterate(*args)
        if x_c.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"cvar_ipm_iter: dtype {x_c.dtype} not supported")
        if (n, d, nFx, nFu) != (4, 2, 4, 4) or not 1 <= m <= 3:
            raise ValueError("cvar_ipm_iter: the kernel is written for n=4, d=2, nFx=4, "
                             f"nFu=4 and m<=3, got n={n}, d={d}, nFx={nFx}, nFu={nFu}, m={m}")
        Z = x_c.shape[-1]
        tensors = args[:n_in] + args[n_in + 1:]
        check(tensors, x_c.dtype, x_c.device, Z)
        key = (Z, x_c.dtype, x_c.device)
        if not scratch or scratch[0] != key:
            elems = KERNEL.plan(ints, Z, x_c.dtype, x_c.device.index)["scratch_elems"]
            scratch[:] = [key, torch.empty(elems, dtype=x_c.dtype, device=x_c.device)]
        return KERNEL.launch(ints, kernel_scalars(cfg, dims, x_c.dtype, itv),
                             tensors[:n_in], tensors[n_in:], scratch[1])

    return step


# ---------------------------------------------------------------------------
# Solve driver: constants, starting point, loop over fused iterations
# ---------------------------------------------------------------------------


def _static_maps(cplan: CVaRPlan, ralpha: float):
    """Static cone / risk index matrices (numpy): the (K, totalu) stage mask
    of each cone, the (K, nrisk) risk map, and the sign-row selector."""
    topo = cplan.plan.topo
    totalu = topo.totalu
    bdim, nrisk, m, N = cplan.bdim, cplan.nrisk, topo.m, topo.N
    K = bdim * m
    u_off = np.asarray(topo.u_off)
    stage_mask = np.zeros((K, totalu))
    f_risk = np.zeros((K, nrisk))
    kk = 0
    for idx in range(bdim):
        for i in range(m):
            c = int(cplan.child_of[idx, i])
            stage_mask[kk, u_off[c] + np.arange(N)] = 1.0
            f_risk[kk, bdim + idx] += 1.0
            f_risk[kk, 2 * bdim + cplan.slotP[idx, i]] += 1.0
            f_risk[kk, 2 * bdim + bdim * m + cplan.slotM[idx, i]] -= 1.0
            if cplan.child_nonleaf[idx, i]:
                f_risk[kk, c] += 1.0
            kk += 1
    sgn_idx = np.concatenate([np.arange(bdim), np.arange(2 * bdim, nrisk)])
    nsgn = len(sgn_idx)
    Ssgn = np.zeros((nsgn, nrisk))
    Ssgn[np.arange(nsgn), sgn_idx] = 1.0
    return stage_mask, f_risk, Ssgn, nsgn


class CVaRIPMSetup(NamedTuple):
    """What one fused CVaR solve iterates on: the kernel's constants
    (``CONST_ORDER`` then ``SHARED_ORDER``), the starting carry
    (``CARRY_ORDER``), the step function and the dims it was built for."""

    in_args: list
    carry0: tuple
    step_fn: Any
    dims: dict


def setup_cvar_ipm(cplan: CVaRPlan, A_bl, B_bl, dh_bl, h0_bl, x_lin_bl, u_lin_bl, p_bl,
                   Q, R, Qslack, xRef_bl, ralpha, Fx, bx, Fu, bu,
                   cfg: CVaRIPMConfig = CVaRIPMConfig(), S_bl=None, s_warm_bl=None,
                   r_warm_bl=None, dh0_floor=None) -> CVaRIPMSetup:
    """Constants, starting point and step function of :func:`cvar_ipm_solve_pl`."""
    plan = cplan.plan
    topo = plan.topo
    n, d, m = topo.n, topo.d, topo.m
    totalu = topo.totalu
    bdim, nrisk = cplan.bdim, cplan.nrisk
    K = bdim * m
    dtype, dev = x_lin_bl.dtype, x_lin_bl.device
    Z = x_lin_bl.shape[-1]
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64) if not torch.is_tensor(a) else a,
                                     dtype=dtype, device=dev)
    Fx_np = np.asarray(Fx, np.float64)
    nFx, nFu = Fx_np.shape[0], np.asarray(Fu).shape[0]
    Nc = nFx + 1
    Qslack1 = float(np.asarray(Qslack)[1])
    mask_np, frisk_np, Ssgn_np, nsgn = _static_maps(cplan, float(ralpha))
    mtot = float(totalu * Nc + totalu * nFu + totalu * Nc + nsgn + K)

    A_st, B_st = _succ_transitions(plan, A_bl, B_bl)
    bx_t = as_t(bx)
    bx_row = bx_t[None, :, None] if bx_t.ndim == 1 else bx_t[None]
    pa = (p_bl[:bdim].to(dtype) / ralpha).contiguous()           # (bdim, m, Z)
    Qm, Fx_t = as_t(Q), as_t(Fx_np)
    if S_bl is not None:
        S_bl = S_bl.to(dtype)
        # as cvar_ipm_solve: the quadratic goes through S, the linear term does
        # not; the collision row's x-component is floored away from zero
        QxC = torch.einsum("jit,jk,klt->ilt", S_bl, Qm, S_bl).contiguous()
        Fxl = torch.einsum("rj,jnt->rnt", Fx_t, S_bl).contiguous()
        d0 = dh_bl[:, 0, :]
        d0f = torch.sign(d0) * torch.clamp(torch.abs(d0), min=0.1)
        if dh0_floor is not None:
            fl = torch.as_tensor(dh0_floor, device=dev)
            d0f = torch.where(fl[None, :] if fl.ndim == 1 else fl, d0f, d0)
        dh_bl = dh_bl.clone()
        dh_bl[:, 0, :] = d0f
    else:
        QxC = Qm[:, :, None].expand(n, n, Z).contiguous()
        Fxl = Fx_t[:, :, None].expand(nFx, n, Z).contiguous()
    FxFx = (Fxl[:, :, None, :] * Fxl[:, None, :, :]).contiguous()
    b1 = torch.cat([h0_bl[:, None, :], bx_row.expand(totalu, nFx, Z)], dim=1).contiguous()
    cx = (-2.0 * torch.einsum("ij,jt->it", Qm, xRef_bl)).contiguous()
    cc = torch.sum(xRef_bl * torch.einsum("ij,jt->it", Qm, xRef_bl), dim=0, keepdim=True)
    shared = dict(Fu=as_t(Fu), bu=as_t(bu).reshape(1, -1), Rm=as_t(R), mask=as_t(mask_np),
                  maskT=as_t(mask_np.T), frisk=as_t(frisk_np), friskT=as_t(frisk_np.T),
                  Ssgn=as_t(Ssgn_np), SsgnT=as_t(Ssgn_np.T))
    shared = {k: v.contiguous() for k, v in shared.items()}

    # ---- starting point --------------------------------------------------
    levels = build_levels(plan)
    x_i, u_i = x_lin_bl.contiguous(), u_lin_bl.contiguous()
    s_i = (x_i.new_zeros((totalu, Nc, Z)) if s_warm_bl is None
           else s_warm_bl.to(dtype).contiguous())
    r_i = (x_i.new_zeros((nrisk, Z)) if r_warm_bl is None
           else r_warm_bl.to(dtype).contiguous())
    xc0 = _cx_gather(levels, x_i)
    rows1 = torch.cat([-torch.sum(dh_bl * xc0, dim=1, keepdim=True),
                       torch.einsum("rnt,jnt->jrt", Fxl, xc0)], dim=1) - s_i
    mu0 = 10.0
    sl1 = torch.clamp(b1 - rows1, min=cfg.sl_min)
    sl2 = torch.clamp(shared["bu"][:, :, None] - torch.einsum("rn,jnt->jrt", shared["Fu"], u_i),
                      min=cfg.sl_min)
    sl3 = torch.clamp(s_i, min=cfg.sl_min)
    sl4 = x_i.new_ones((nsgn, Z))
    # raw cone values at the start → per-cone scales
    sc0 = (torch.einsum("jnt,nmt,jmt->jt", xc0, QxC, xc0) + torch.sum(xc0 * cx[None], dim=1)
           + cc + torch.einsum("jnt,nm,jmt->jt", u_i, shared["Rm"], u_i))
    q_raw0 = torch.einsum("kj,jt->kt", shared["mask"], sc0)    # (K, Z)
    csc = torch.clamp(torch.abs(q_raw0), min=1.0)
    sq = torch.clamp(-q_raw0 / csc, min=1.0)
    consts = dict(A_st=A_st, B_st=B_st, dh=dh_bl.contiguous(), b1=b1, pa=pa, csc=csc, cx=cx,
                  cc=cc, QxC=QxC, Fxl=Fxl, FxFx=FxFx)
    in_args = [consts[k] for k in CONST_ORDER] + [shared[k] for k in SHARED_ORDER]
    carry = tuple(t.contiguous() for t in (
        x_i, u_i, s_i, r_i, sl1, mu0 / sl1, sl2, mu0 / sl2, sl3, mu0 / sl3, sl4, mu0 * sl4,
        sq, mu0 / sq))
    dims = dict(n=n, d=d, m=m, Nc=Nc, nFx=nFx, nFu=nFu, K=K, bdim=bdim, nrisk=nrisk,
                nsgn=nsgn, Qslack1=Qslack1, mtot=mtot)
    return CVaRIPMSetup(in_args=in_args, carry0=carry,
                        step_fn=fused_cvar_iteration(cplan, cfg, dims), dims=dims)


def cvar_ipm_solve_pl(cplan: CVaRPlan, A_bl, B_bl, dh_bl, h0_bl, x_lin_bl, u_lin_bl, p_bl,
                      Q, R, Qslack, xRef_bl, ralpha, Fx, bx, Fu, bu,
                      cfg: CVaRIPMConfig = CVaRIPMConfig(), S_bl=None, s_warm_bl=None,
                      r_warm_bl=None, dh0_floor=None):
    """Batch-last fused-iteration CVaR IPM. Inputs are batch-last tree arrays;
    ``xRef_bl`` is (n, Z), ``p_bl`` (n_branches, m, Z). ``S_bl`` (n, n, Z)
    applies the merge state transform per lane (cone quadratic SᵀQS, rows
    Fx·S and the dh[0] floor; the linear cone term stays untransformed);
    ``bx`` is (nFx,) shared or (nFx, Z) per lane; ``dh0_floor`` (None =
    always, else a bool or a (Z,) bool tensor) gates the floor. ``s_warm_bl``
    / ``r_warm_bl`` warm-start the slacks and risk variables. Returns
    ``(x, u, s, r, aux)`` batch-last; ``aux`` holds ``J``, ``gap``, ``gaps``.
    As the reference's fused path, it reads none of ``cfg``'s diagnostic
    options (``resid``, ``recovery``, ``neighborhood``, ``split_step``,
    ``recenter``, ``recenter_tol``, ``diag_extra``, and ``refine``,
    ``refine_dtype``, ``outer_dtype``): those act in ``cvar_ipm_solve``."""
    su = setup_cvar_ipm(cplan, A_bl, B_bl, dh_bl, h0_bl, x_lin_bl, u_lin_bl, p_bl, Q, R,
                        Qslack, xRef_bl, ralpha, Fx, bx, Fu, bu, cfg, S_bl, s_warm_bl,
                        r_warm_bl, dh0_floor)
    carry = su.carry0
    Z = carry[0].shape[-1]
    n_best = 4     # best-iterate tracking: x, u, s, r (+ gap)
    best = carry[:n_best]
    bgap = carry[0].new_full((Z,), float("inf"))
    gaps = []
    for itv in range(cfg.iters):
        out = su.step_fn(*su.in_args, itv, *carry)
        gap = out[CARRY_FIELDS].reshape(-1)
        better = gap < bgap
        best = tuple(torch.where(better, c, b) for c, b in zip(carry[:n_best], best))
        bgap = torch.where(better, gap, bgap)
        carry = out[:CARRY_FIELDS]
        gaps.append(gap)
    gaps = torch.stack(gaps)
    gap_last = gaps[-1]
    use_last = gap_last <= bgap
    x_f, u_f, s_f, r_f = (torch.where(use_last, c, b) for c, b in zip(carry[:n_best], best))
    Rm = su.in_args[len(CONST_ORDER) + SHARED_ORDER.index("Rm")]
    J = (torch.einsum("dt,de,et->t", u_f[0], Rm, u_f[0]) + r_f[0]
         + su.dims["Qslack1"] * torch.sum(s_f[0], dim=0))
    aux = {"J": J, "gap": torch.where(use_last, gap_last, bgap), "gaps": gaps}
    return x_f, u_f, s_f, r_f, aux
