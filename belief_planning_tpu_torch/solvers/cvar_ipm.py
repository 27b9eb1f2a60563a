"""Structured interior-point solver for the nested-CVaR tree SOCP (the
reference package's ``solvers/cvar_ipm.py``).

A Mehrotra predictor-corrector IPM whose Newton systems are solved
structurally:

- variables: tree states and inputs (x, u), per-node collision slacks s and
  risk variables r = [ρ; σ; μ⁺; μ⁻]; the epigraph J is eliminated, so the
  objective is the root-cone expression ``u₀ᵀRu₀ + ρ₀ + Qslack₁·Σs₀``;
- the λ-weighted Hessian is block-diagonal per stage (each stage belongs to
  one cost-to-go cone), so a Newton step is one tree-Riccati factorization
  plus linear sweeps;
- the barrier terms ``(λ_k/s_k)·∇q_k∇q_kᵀ`` of the K = bdim·m cones are
  rank-one corrections applied by a Woodbury identity whose columns come from
  affine-free response sweeps;
- decision slacks are eliminated per row; the risk variables and the risk
  recursion equalities live in a small dense KKT block (inverted with
  ``torch.linalg.inv``).

Three dtypes, as the reference's: the solve dtype ``sdt`` (the tree's: the
factor, the sweeps and the dense inverses), the outer dtype (the iterate and
every elementwise step; float64 when ``outer_dtype="f64"`` on a float32
solve) and the refinement residual dtype (``refine_dtype``). Results come
back in ``sdt``.

:func:`cvar_ipm_solve` is batched over trees: every tensor has a leading
tree axis where the reference ``vmap``s its per-tree function, and every
reduction the reference takes over a whole array is taken per tree. The
cone gradients are kept factored (stage mask × per-stage gradient), which is
the same arithmetic as the reference's dense (K, totalu, ·) arrays up to the
association of one product, since each stage belongs to at most one cone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from belief_planning_tpu_torch.solvers.cvar import CVaRPlan
from belief_planning_tpu_torch.solvers.tree_qp import (
    Factors,
    StageCost,
    _idx,
    tree_lqr_factor,
    tree_lqr_forward,
    tree_lqr_linear,
)
from belief_planning_tpu_torch.solvers.tree_qp_ipm import _bc, _tree_max, _tree_sum
from belief_planning_tpu_torch.solvers.tree_qp_ipm import max_step
from belief_planning_tpu_torch.tree.engine import TreeState
from belief_planning_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class CVaRIPMConfig:
    """Every field keeps the reference's name and default. The fused
    iteration (``solvers/cvar_pl.py``) reads ``iters``, ``reg``, ``tau``,
    ``a_cap_early``, ``early_iters``, ``w_max``, ``w_max_f32``, ``gap_tol``,
    ``sl_min`` and the Gondzio fields; ``mxu`` only chose the TPU unit for
    some contractions and changes no result. The options named in
    ``_DIAG_DEFAULTS`` are not ported and must keep their defaults."""

    iters: int = 40
    reg: float = 1e-8
    tau: float = 0.99            # fraction-to-boundary
    a_cap_early: float = 0.7     # step cap for the first (cold) iterations
    early_iters: int = 6
    w_max: float = 1e12          # clamp on barrier weights λ/s
    w_max_f32: float = 1e6       # the clamp below float64: min(w_max, w_max_f32)
    gap_tol: float = 1e-9        # freeze the iterate once the scaled gap is below
    # Iterative-refinement rounds per structured KKT solve: apply the full KKT
    # operator in closed form and re-solve on the residual.
    refine: int = 0
    # Residual dtype of refinement: "same" (the outer dtype) or "f64"
    # (mixed-precision refinement of a float32 solve).
    refine_dtype: str = "same"
    # "f64": carry the iterate and every elementwise step mechanic in float64
    # while the factor, sweeps and dense inverses stay in the solve dtype.
    outer_dtype: str = "same"
    mxu: bool = False            # TPU matrix-unit routing; no effect on the result
    sl_min: float = 0.3          # slack floor of the starting point
    resid: str = "recompute"     # diagnostic option, not ported (see _DIAG_DEFAULTS)
    recovery: str = "direct"     # diagnostic option, not ported
    # Gondzio multiple-centrality correctors per iteration: each reuses the
    # factor on a pure complementarity right-hand side that pushes outlier
    # products back into [bmin·σμ, bmax·σμ], accepted per tree if the step grows
    gondzio: int = 0
    gondzio_bmin: float = 0.1
    gondzio_bmax: float = 10.0
    neighborhood: float = 0.0    # diagnostic option, not ported
    split_step: bool = False     # diagnostic option, not ported
    recenter: int = 0            # diagnostic option, not ported
    recenter_tol: float = 1e-5
    diag_extra: bool = False     # diagnostic option, not ported


# The options of the reference's cvar_ipm_solve that serve only its
# diagnostic scripts (scripts/cvar_f32_diag.py, scripts/cvar_hard_oracle.py):
# carried residuals, stable dual recovery, the wide-neighbourhood search,
# split primal / dual steps, jam recentering and extended diagnostics. They
# are not ported; a value other than the default raises.
_DIAG_DEFAULTS = {"resid": "recompute", "recovery": "direct", "neighborhood": 0.0,
                  "split_step": False, "recenter": 0, "diag_extra": False}


def _cone_maps(cplan: CVaRPlan):
    """Static maps: each stage's cone (−1 for root stages), the (K, totalu)
    stage mask of each cone and the (K, nrisk) risk map."""
    topo = cplan.plan.topo
    totalu, N, m = topo.totalu, topo.N, topo.m
    bdim, nrisk = cplan.bdim, cplan.nrisk
    K = bdim * m
    u_off = np.asarray(topo.u_off)
    cone_of_stage = np.full(totalu, -1, dtype=np.int64)
    stage_mask = np.zeros((K, totalu))
    f_risk = np.zeros((K, nrisk))
    kk = 0
    for idx in range(bdim):
        for i in range(m):
            c = int(cplan.child_of[idx, i])
            stages = u_off[c] + np.arange(N)
            cone_of_stage[stages] = kk
            stage_mask[kk, stages] = 1.0
            f_risk[kk, bdim + idx] += 1.0                       # σ_idx
            f_risk[kk, 2 * bdim + cplan.slotP[idx, i]] += 1.0   # μ⁺
            f_risk[kk, 2 * bdim + bdim * m + cplan.slotM[idx, i]] -= 1.0
            if cplan.child_nonleaf[idx, i]:
                f_risk[kk, c] += 1.0                            # ρ_child
            kk += 1
    return cone_of_stage, stage_mask, f_risk


def cvar_ipm_solve(cplan: CVaRPlan, ts: TreeState, Q, R, Qslack, xRef, ralpha, Fx, bx, Fu, bu,
                   x0, S=None, cfg: CVaRIPMConfig = CVaRIPMConfig(), dh0_floor=None,
                   device=None):
    """Solve the CVaR tree SOCP for a batch of trees.

    ``ts`` carries a leading tree axis ``Bt``; ``xRef`` is ``(n,)`` or
    ``(Bt, n)``; ``bx`` is ``(nFx,)`` or ``(Bt, nFx)``; ``S`` (the merge
    deployment's state transform: cone quadratic SᵀQS, rows Fx·S and the
    dh[0] magnitude floor; the linear cone term stays untransformed) is
    ``(n, n)`` or ``(Bt, n, n)``; ``Q, R, Qslack, ralpha, Fx, Fu, bu`` are
    shared. ``dh0_floor``: with ``S``, ``None`` always applies the floor, a
    bool or a ``(Bt,)`` bool tensor applies it where true. ``x0 (Bt, n)`` is
    accepted for the reference's signature. ``device``: ``None`` is the CUDA
    device (raises without one); pass ``"cpu"`` to run on the CPU.

    Returns ``(x, u, s, r, aux)`` in the tree's dtype; ``aux`` holds ``J``
    and ``gap`` ``(Bt,)``, ``risk``, ``gaps (Bt, iters)`` and ``diag``, a
    dict of ``(Bt, iters)`` per-iteration diagnostics.
    """
    for name, default in _DIAG_DEFAULTS.items():
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"CVaRIPMConfig.{name}={getattr(cfg, name)!r}: the reference's diagnostic "
                "options are not ported yet (ROADMAP.md Queue A item 4b)")
    dev = resolve_device(device)
    ts = TreeState(*(a.to(dev) for a in ts))
    plan = cplan.plan
    topo = plan.topo
    n, d, m = topo.n, topo.d, topo.m
    totalu = topo.totalu
    bdim, nrisk = cplan.bdim, cplan.nrisk
    K = bdim * m
    sdt = ts.x_lin.dtype                       # solve dtype (factor, sweeps, inverses)
    dtype = torch.float64 if (cfg.outer_dtype == "f64" and sdt != torch.float64) else sdt
    rdt = torch.float64 if cfg.refine_dtype == "f64" else dtype
    Bt = ts.x_lin.shape[0]
    ein = torch.einsum
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)

    Q, R, Fx, Fu, bu = map(as_t, (Q, R, Fx, Fu, bu))
    Qslack1 = float(Qslack[1])
    xRef = as_t(xRef).expand(Bt, n)
    bx = as_t(bx)
    nFx = Fx.shape[0]
    Nc = nFx + 1

    if S is not None:
        S = as_t(S).expand(Bt, n, n)
        Qx_cone = S.transpose(-1, -2) @ Q @ S          # quadratic through S, linear not
        Fx_used = Fx @ S
    else:
        Qx_cone = Q.expand(Bt, n, n)
        Fx_used = Fx.expand(Bt, nFx, n)
    cx = -2.0 * ein("ij,tj->ti", Q, xRef)
    cconst = ein("ti,ij,tj->t", xRef, Q, xRef)

    dh = ts.dh.to(dtype)
    if S is not None:
        # dh[0] magnitude floor, which the reference applies on warm re-solves
        d0 = dh[..., 0]
        d0f = torch.sign(d0) * torch.clamp(torch.abs(d0), min=0.1)
        if dh0_floor is not None:
            fl = torch.as_tensor(dh0_floor, dtype=torch.bool, device=dev)
            d0f = torch.where(fl[:, None] if fl.ndim else fl, d0f, d0)
        dh = dh.clone()
        dh[..., 0] = d0f
    Fxc = torch.cat([-dh[..., None, :], Fx_used[:, None].expand(Bt, totalu, nFx, n)], dim=-2)
    bx_rows = bx[:, None] if bx.dim() == 2 else bx
    b1 = torch.cat([ts.h0.to(dtype)[..., None], bx_rows.expand(Bt, totalu, nFx)], dim=-1)

    # static maps ------------------------------------------------------------
    cx_nodes = _idx(topo.cnode_x, dev)
    cone_of_stage, mask_np, frisk_np = _cone_maps(cplan)
    stage_mask_raw = as_t(mask_np)                              # (K, totalu)
    f_risk_raw = as_t(frisk_np)
    cos_idx = _idx(np.maximum(cone_of_stage, 0), dev)
    has_cone = torch.as_tensor(cone_of_stage >= 0, device=dev)
    root_mask = zeros(totalu)
    root_mask[0] = 1.0
    obj_r = zeros(nrisk)
    obj_r[0] = 1.0
    obj_s = zeros(totalu, Nc)
    obj_s[0] = Qslack1

    # risk equality rows (Bt, bdim, nrisk)
    p_nonleaf = ts.p[:, :bdim].to(dtype)
    Req = zeros(Bt, bdim, nrisk)
    ib = np.arange(bdim)
    Req[:, ib, ib] = 1.0
    Req[:, ib, bdim + ib] = 1.0
    cols = _idx(2 * bdim + bdim * m + ib[:, None] * m + np.arange(m), dev)
    Req[:, _idx(ib[:, None], dev), cols] = -p_nonleaf / ralpha
    sgn_idx = _idx(np.concatenate([np.arange(bdim), np.arange(2 * bdim, nrisk)]), dev)
    nsgn = sgn_idx.numel()

    # cone evaluation ----------------------------------------------------------

    def per_stage_cost(x_nodes, u, s):
        xc = x_nodes[:, cx_nodes]
        return (ein("tbi,tij,tbj->tb", xc, Qx_cone, xc) + ein("tbi,ti->tb", xc, cx)
                + cconst[:, None] + ein("tbi,ij,tbj->tb", u, R, u)
                + Qslack1 * torch.sum(s, dim=-1))

    # Per-cone scaling: dividing cone k by c_k = max(1, |q_k(v0)|) makes every
    # cone O(1) (raw cost-to-go values are O(1e3-1e4)); exact-arithmetic
    # equivalent, it keeps the Woodbury block and barrier products finite in f32.
    q_raw0 = ein("kj,tj->tk", stage_mask_raw,
                 per_stage_cost(ts.x_lin.to(dtype), ts.u_lin.to(dtype), zeros(Bt, totalu, Nc)))
    cscale = torch.clamp(torch.abs(q_raw0), min=1.0)              # (Bt, K)
    mask_j = stage_mask_raw / cscale[..., None]                   # (Bt, K, totalu)
    f_risk_j = f_risk_raw / cscale[..., None]                     # (Bt, K, nrisk)

    def cone_vals(x_nodes, u, s, risk):
        """q̃_k(v) for the K scaled cones (Bt, K)."""
        return (ein("tkj,tj->tk", mask_j, per_stage_cost(x_nodes, u, s))
                + ein("tkr,tr->tk", f_risk_j, risk))

    def obj_val(u, s, risk):
        return (ein("ti,ij,tj->t", u[:, 0], R, u[:, 0]) + risk[:, 0]
                + Qslack1 * torch.sum(s[:, 0], dim=-1))

    # ---- the cone gradients, factored: ∇q_k = mask_j[k, j] · (gx_j, gu_j, gs) -
    class Grads:
        def __init__(self, x_nodes, u):
            xc = x_nodes[:, cx_nodes]
            self.gx = 2.0 * ein("tbi,tij->tbj", xc, Qx_cone) + cx[:, None]   # (Bt, totalu, n)
            self.gu = 2.0 * (u @ R)                                        # (Bt, totalu, d)

        def combine(self, coef):
            """Σ_k coef_k ∇q_k for ``coef (Bt, [C,] K)`` → (qx, qu, qs, qr)."""
            w = ein("t...k,tkj->t...j", coef, mask_j)[..., None]           # (Bt, [C,] totalu, 1)
            gx = self.gx if coef.dim() == 2 else self.gx[:, None]
            gu = self.gu if coef.dim() == 2 else self.gu[:, None]
            qs = (w * Qslack1).expand(w.shape[:-1] + (Nc,))
            return w * gx, w * gu, qs, ein("t...k,tkr->t...r", coef, f_risk_j)

        def dot(self, xx, uu, ss, rr):
            """(∇q_k · v)_k for ``v`` with an optional column axis → (Bt, [C,] K)."""
            xc = xx[..., cx_nodes, :]
            gx = self.gx if xc.dim() == 3 else self.gx[:, None]
            gu = self.gu if xc.dim() == 3 else self.gu[:, None]
            per = (torch.sum(gx * xc, dim=-1) + torch.sum(gu * uu, dim=-1)
                   + Qslack1 * torch.sum(ss, dim=-1))
            return ein("tkj,t...j->t...k", mask_j, per) + ein("tkr,t...r->t...k", f_risk_j, rr)

    # ---- initial point (dynamics- and risk-equality-feasible) ---------------
    x_i = ts.x_lin.to(dtype)
    u_i = ts.u_lin.to(dtype)
    s_i = zeros(Bt, totalu, Nc)
    r_i = zeros(Bt, nrisk)
    # centred start: λ = μ0/sl puts the start on the central path
    mu0 = 10.0
    rows1 = ein("tbrn,tbn->tbr", Fxc, x_i[:, cx_nodes]) - s_i
    sl1 = torch.clamp(b1 - rows1, min=cfg.sl_min)
    rows2_0 = ein("rn,tbn->tbr", Fu, u_i)
    sl2 = torch.clamp(bu - rows2_0, min=cfg.sl_min)
    sl3 = torch.clamp(s_i, min=cfg.sl_min)
    # risk sign rows start on the boundary (r = 0) with a unit slack
    sl4 = torch.ones((Bt, nsgn), dtype=dtype, device=dev)
    lam4 = mu0 * torch.ones((Bt, nsgn), dtype=dtype, device=dev)
    qv0 = cone_vals(x_i, u_i, s_i, r_i)
    sq = torch.clamp(-qv0, min=1.0)
    mtot = float(sl1[0].numel() + sl2[0].numel() + sl3[0].numel() + nsgn + K)
    # the clamp protects the solve-dtype factorization
    w_max_eff = cfg.w_max if sdt == torch.float64 else min(cfg.w_max, cfg.w_max_f32)
    clampw = lambda w: torch.clamp(w, max=w_max_eff)

    n_leaves = len(plan.leaf_ids)
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    eye_d = torch.eye(d, dtype=dtype, device=dev)

    def newton_factor(x_nodes, u, lam1_, sl1_, lam2_, sl2_, lam3_, sl3_, lam4_, sl4_, lq_, sq_):
        """Factor the KKT: per-stage quadratics, tree factor, risk block and
        Woodbury columns of the cone-gradient outer products."""
        # per-stage cone weights λ̃/c of the cone owning the stage; root → 1
        lq_eff = lq_ / cscale
        lam_stage = torch.where(has_cone, lq_eff[:, cos_idx], 0.0) + root_mask
        lam_x = lam_stage - root_mask            # the root stage has no x in its cone
        Qx2 = 2.0 * lam_x[..., None, None] * Qx_cone[:, None]
        Ru2 = 2.0 * lam_stage[..., None, None] * R
        w1 = clampw(lam1_ / sl1_)
        w2 = clampw(lam2_ / sl2_)
        w3 = clampw(lam3_ / sl3_)
        kap = w1 + w3 + cfg.reg                  # slack-row elimination denominators
        coefs = w1 - w1 * w1 / kap
        Hx_nc = Qx2 + cfg.reg * eye_n
        Qx2 = Hx_nc + ein("tbr,tbri,tbrj->tbij", coefs, Fxc, Fxc)
        Ru2 = Ru2 + ein("tbr,ri,rj->tbij", w2, Fu, Fu)
        Ru2 = Ru2 + cfg.reg * eye_d
        Pterm2 = (cfg.reg * eye_n).expand(Bt, n_leaves, n, n)
        # the factorization and its sweeps run in the solve dtype
        zs = lambda *shape: torch.zeros((Bt,) + shape, dtype=sdt, device=dev)
        cost = StageCost(Qx2=Qx2.to(sdt), qx=zs(totalu, n), Ru2=Ru2.to(sdt), qu=zs(totalu, d),
                         Daa2=zs(totalu, d, d), Dab2=zs(totalu, d, d), Pterm2=Pterm2.to(sdt),
                         qterm=zs(n_leaves, n), slack_lin=zs(totalu), slack_quad=zs())
        fac = tree_lqr_factor(plan, cost, ts)
        fac_col = Factors(*(None if f is None else f[:, None] for f in fac))

        # risk KKT block [Hr, Reqᵀ; Req, −reg·I], Hr = sign-row weights + reg
        w4 = clampw(lam4_ / sl4_)
        Hr = cfg.reg * torch.eye(nrisk, dtype=dtype, device=dev).expand(Bt, nrisk, nrisk).clone()
        Hr[:, sgn_idx, sgn_idx] += w4
        Krk = zeros(Bt, nrisk + bdim, nrisk + bdim)
        Krk[:, :nrisk, :nrisk] = Hr
        Krk[:, :nrisk, nrisk:] = Req.transpose(-1, -2)
        Krk[:, nrisk:, :nrisk] = Req
        Krk[:, nrisk:, nrisk:] = -cfg.reg * torch.eye(bdim, dtype=dtype, device=dev)
        Krk_inv = torch.linalg.inv(Krk.to(sdt)).to(dtype)[:, :nrisk, :nrisk]

        g = Grads(x_nodes, u)
        wk = w1 / kap

        def h0_apply(qx, qu, qs, qrisk):
            """H0⁻¹ on a right-hand side with an optional column axis."""
            col = qx.dim() == 4
            F = Fxc[:, None] if col else Fxc
            W, W1 = (wk[:, None], w1[:, None]) if col else (wk, w1)
            qx_eff = qx + ein("...brn,...br->...bn", F, W * qs)
            fc = fac_col if col else fac
            lead = qx_eff.shape[:-2]
            kff = tree_lqr_linear(plan, fc, qx_eff.to(sdt), qu.to(sdt),
                                  torch.zeros(lead + (n_leaves, n), dtype=sdt, device=dev),
                                  affine=False)
            xr, ur = tree_lqr_forward(plan, fc, kff, torch.zeros(n, dtype=sdt, device=dev),
                                      torch.zeros(d, dtype=sdt, device=dev), affine=False)
            xr, ur = xr.to(dtype), ur.to(dtype)
            sr = (W1 * ein("...brn,...bn->...br", F, xr[..., cx_nodes, :]) - qs) / \
                (kap[:, None] if col else kap)
            Ki = Krk_inv[:, None] if col else Krk_inv
            rr = -ein("...ij,...j->...i", Ki, qrisk)
            return xr, ur, sr, rr

        # Woodbury columns for the K cone gradients, one response solve with
        # the columns after the tree axis
        Zx, Zu, Zs, Zr = h0_apply(*g.combine(torch.eye(K, dtype=dtype, device=dev)
                                             .expand(Bt, K, K)))
        GtZ = g.dot(Zx, Zu, Zs, Zr)                                  # (Bt, col, K)
        wq = clampw(lq_ / sq_)
        # φ = (I − GᵀZ·diag(wq))⁻¹ gᵀa per Woodbury on H0 + Σ wq g gᵀ
        Wm = torch.linalg.inv((torch.eye(K, dtype=dtype, device=dev) - GtZ * wq[:, None, :])
                              .to(sdt)).to(dtype)

        def base_solve(qx2, qu2, qs2, qr2):
            """(H0 + Σ wq g gᵀ)⁻¹ on −q: the factorized tree solve and the
            Woodbury correction for the cone outer products."""
            ax, au, as_, ar = h0_apply(qx2, qu2, qs2, qr2)
            phi = ein("tij,tj->ti", Wm, g.dot(ax, au, as_, ar))
            corr = wq * phi
            return (ax + ein("tk,tkjn->tjn", corr, Zx), au + ein("tk,tkjd->tjd", corr, Zu),
                    as_ + ein("tk,tkjc->tjc", corr, Zs), ar + ein("tk,tkr->tr", corr, Zr))

        w3reg = w3 + cfg.reg

        def m_apply(dx, du, dsv, dr):
            """Closed-form apply of the full KKT operator M = H0 + Σ wq g gᵀ in
            the refinement dtype (terminal leaf nodes, which carry only reg·I,
            are left out as in the reference)."""
            c = lambda a: a.to(rdt)
            dx, du, dsv, dr = c(dx), c(du), c(dsv), c(dr)
            Fr = c(Fxc)
            gx_r, gu_r, mk, fr = c(g.gx), c(g.gu), c(mask_j), c(f_risk_j)
            xc = dx[:, cx_nodes]
            rowx = ein("tbrn,tbn->tbr", Fr, xc) - dsv
            hx = ein("tbij,tbj->tbi", c(Hx_nc), xc) + ein("tbrn,tbr->tbn", Fr, c(w1) * rowx)
            hu = ein("tbij,tbj->tbi", c(Ru2), du)
            hs = -(c(w1) * rowx) + c(w3reg) * dsv
            hr = ein("tij,tj->ti", c(Hr), dr)
            per = (torch.sum(gx_r * xc, dim=-1) + torch.sum(gu_r * du, dim=-1)
                   + Qslack1 * torch.sum(dsv, dim=-1))
            cg = c(wq) * (ein("tkj,tj->tk", mk, per) + ein("tkr,tr->tk", fr, dr))
            w = ein("tk,tkj->tj", cg, mk)[..., None]
            return (hx + w * gx_r, hu + w * gu_r, hs + w * Qslack1,
                    hr + ein("tk,tkr->tr", cg, fr))

        def kkt_solve(qx, qu, qs, qrisk, extra_g):
            """Solve (H0 + Σ wq g gᵀ) dv = −(q + Σ extra_g_k g_k) with the
            dynamics and risk equalities homogeneous, then ``refine`` rounds."""
            ex, eu, es, er = g.combine(extra_g)
            qx2, qu2, qs2, qr2 = qx + ex, qu + eu, qs + es, qrisk + er
            dx, du, dsv, dr = base_solve(qx2, qu2, qs2, qr2)
            for _ in range(cfg.refine):
                hx, hu, hs, hr = m_apply(dx, du, dsv, dr)
                # residual formed in the refinement dtype, solved as before
                res = [(h + q.to(h.dtype)).to(dtype) for h, q in
                       ((hx, qx2), (hu, qu2), (hs, qs2), (hr, qr2))]
                ex_, eu_, es_, er_ = base_solve(*res)
                dx, du, dsv, dr = dx + ex_, du + eu_, dsv + es_, dr + er_
            return dx, du, dsv, dr

        return kkt_solve, g

    def gap_of(sl1_, lam1_, sl2_, lam2_, sl3_, lam3_, sl4_, lam4_, sq_, lq_):
        return (_tree_sum(sl1_ * lam1_) + _tree_sum(sl2_ * lam2_) + _tree_sum(sl3_ * lam3_)
                + _tree_sum(sl4_ * lam4_) + _tree_sum(sq_ * lq_)) / mtot

    def iteration(it_idx, carry):
        ((x_c, u_c, s_c, r_c, sl1_, lam1_, sl2_, lam2_, sl3_, lam3_, sl4_, lam4_, sq_, lq_),
         best) = carry

        rows1 = ein("tbrn,tbn->tbr", Fxc, x_c[:, cx_nodes]) - s_c
        rows2 = ein("rn,tbn->tbr", Fu, u_c)
        qv = cone_vals(x_c, u_c, s_c, r_c)
        r1 = rows1 + sl1_ - b1
        r2 = rows2 + sl2_ - bu
        r3 = -s_c + sl3_
        r4 = -r_c[:, sgn_idx] + sl4_
        rq = qv + sq_
        gap = gap_of(sl1_, lam1_, sl2_, lam2_, sl3_, lam3_, sl4_, lam4_, sq_, lq_)

        kkt_solve, g = newton_factor(x_c, u_c, lam1_, sl1_, lam2_, sl2_, lam3_, sl3_,
                                             lam4_, sl4_, lq_, sq_)

        # dual residual: objective gradient + Aᵀλ + Σ λ_k ∇q_k
        gqx, gqu, gqs, gqr = g.combine(lq_)
        rd_x = ein("tbrn,tbr->tbn", Fxc, lam1_) + gqx
        rd_u = zeros(Bt, totalu, d)
        rd_u[:, 0] = 2.0 * (u_c[:, 0] @ R.T)
        rd_u = rd_u + ein("rn,tbr->tbn", Fu, lam2_) + gqu
        rd_s = obj_s - lam1_ - lam3_ + gqs
        rd_r = obj_r + gqr
        rd_r[:, sgn_idx] += -lam4_

        def solve_rows(qx, qu, qs, qr, exq):
            """The KKT solve and the row directions it implies."""
            dx, du, dsv, dr = kkt_solve(qx, qu, qs, qr, exq)
            drow1 = ein("tbrn,tbn->tbr", Fxc, dx[:, cx_nodes]) - dsv
            drow2 = ein("rn,tbn->tbr", Fu, du)
            return dx, du, dsv, dr, drow1, drow2, g.dot(dx, du, dsv, dr)

        def sgn_add(v):
            out = zeros(Bt, nrisk)
            out[:, sgn_idx] += v
            return out

        def direction(rcs):
            # eliminate dsl/dλ per linear family and dsq/dλq per cone:
            # dλ = (−rc − λ·dsl)/sl, dsl = −r_fam − (row direction), rc = sl∘λ + corr
            rc1, rc2, rc3, rc4, rcq = rcs
            ex1 = (-rc1 + lam1_ * r1) / sl1_
            ex2 = (-rc2 + lam2_ * r2) / sl2_
            ex3 = (-rc3 + lam3_ * r3) / sl3_
            ex4 = (-rc4 + lam4_ * r4) / sl4_
            exq = (-rcq + lq_ * rq) / sq_
            dx, du, dsv, dr, drow1, drow2, dq = solve_rows(
                rd_x + ein("tbrn,tbr->tbn", Fxc, ex1), rd_u + ein("rn,tbr->tbn", Fu, ex2),
                rd_s - ex1 - ex3, rd_r + sgn_add(-ex4), exq)
            dsl1 = -r1 - drow1
            dsl2 = -r2 - drow2
            dsl3 = -r3 + dsv
            dsl4 = -r4 + dr[:, sgn_idx]
            dsq = -rq - dq
            dlam1 = (-rc1 - lam1_ * dsl1) / sl1_
            dlam2 = (-rc2 - lam2_ * dsl2) / sl2_
            dlam3 = (-rc3 - lam3_ * dsl3) / sl3_
            dlam4 = (-rc4 - lam4_ * dsl4) / sl4_
            dlq = (-rcq - lq_ * dsq) / sq_
            return (dx, du, dsv, dr, dsl1, dlam1, dsl2, dlam2, dsl3, dlam3, dsl4, dlam4,
                    dsq, dlq)

        def direction_pure(rcs):
            """Pure complementarity correction (zero primal and dual
            residuals), for the Gondzio rounds; reuses the factorization."""
            rc1, rc2, rc3, rc4, rcq = rcs
            ex1, ex2, ex3, ex4, exq = -rc1 / sl1_, -rc2 / sl2_, -rc3 / sl3_, -rc4 / sl4_, \
                -rcq / sq_
            dx, du, dsv, dr, drow1, drow2, dq = solve_rows(
                ein("tbrn,tbr->tbn", Fxc, ex1), ein("rn,tbr->tbn", Fu, ex2), -ex1 - ex3,
                sgn_add(-ex4), exq)
            dsl1, dsl2, dsl3, dsl4, dsq = -drow1, -drow2, dsv, dr[:, sgn_idx], -dq
            return (dx, du, dsv, dr, dsl1, (-rc1 - lam1_ * dsl1) / sl1_,
                    dsl2, (-rc2 - lam2_ * dsl2) / sl2_, dsl3, (-rc3 - lam3_ * dsl3) / sl3_,
                    dsl4, (-rc4 - lam4_ * dsl4) / sl4_, dsq, (-rcq - lq_ * dsq) / sq_)

        da = direction((sl1_ * lam1_, sl2_ * lam2_, sl3_ * lam3_, sl4_ * lam4_, sq_ * lq_))
        vals = (sl1_, lam1_, sl2_, lam2_, sl3_, lam3_, sl4_, lam4_, sq_, lq_)

        def fam_steps(dirs):
            """Per-family fraction-to-boundary limits, in the order of ``vals``."""
            return [max_step(v, dv) for v, dv in zip(vals, dirs[4:])]

        def all_step(dirs):
            st = fam_steps(dirs)
            a = torch.minimum(st[0], st[1])
            for i in range(2, 10, 2):
                a = torch.minimum(a, torch.minimum(st[i], st[i + 1]))
            return a

        def gap_at(al, dirs):
            tot = 0.0
            for i in range(0, 10, 2):
                s_, l_ = vals[i], vals[i + 1]
                al_ = _bc(al, s_)
                tot = tot + _tree_sum((s_ + al_ * dirs[4 + i]) * (l_ + al_ * dirs[5 + i]))
            return tot / mtot

        a_aff = all_step(da)
        gap_aff = gap_at(a_aff, da)
        sigma_c = torch.clamp((gap_aff / (gap + 1e-30)) ** 3, 0.0, 1.0)
        sg = sigma_c * gap
        corr_c = tuple(da[4 + i] * da[5 + i] - _bc(sg, vals[i]) for i in range(0, 10, 2))
        dc = direction(tuple(vals[i] * vals[i + 1] + corr_c[i // 2] for i in range(0, 10, 2)))

        # Gondzio multiple centrality correctors (see CVaRIPMConfig.gondzio)
        for _ in range(cfg.gondzio):
            mu_t = sg + 1e-30
            a_cur = all_step(dc)
            ab = torch.clamp(cfg.tau * a_cur + 0.3, max=1.0)
            cap = 10.0 * cfg.gondzio_bmax * mu_t

            def outlier(v, dv, lam, dlam):
                ab_, mu_, cap_ = _bc(ab, v), _bc(mu_t, v), _bc(cap, v)
                p = (v + ab_ * dv) * (lam + ab_ * dlam)
                t = torch.minimum(torch.maximum(p, cfg.gondzio_bmin * mu_), cfg.gondzio_bmax * mu_)
                # cap the correction: an uncapped p − t on a far-off-centre
                # row overflows through the 1/sl recovery and poisons the tree
                return torch.minimum(torch.maximum(p - t, -cap_), cap_)

            dd = direction_pure(tuple(outlier(vals[i], dc[4 + i], vals[i + 1], dc[5 + i])
                                      for i in range(0, 10, 2)))
            cand = tuple(c + e for c, e in zip(dc, dd))
            a_new = all_step(cand)
            # NaN components pass max_step unnoticed: each tree's candidate
            # must be finite throughout to be accepted
            cand_ok = torch.ones(Bt, dtype=torch.bool, device=dev)
            for c in cand:
                cand_ok = cand_ok & torch.isfinite(c).reshape(Bt, -1).all(1)
            accept = (a_new > a_cur) & cand_ok
            dc = tuple(torch.where(_bc(accept, c), c, o) for c, o in zip(cand, dc))

        a0 = cfg.tau * all_step(dc)
        # freeze once converged (extreme barrier weights at tiny gaps would
        # otherwise corrupt later Newton systems)
        scale = 1.0 + torch.abs(obj_val(u_c, s_c, r_c))
        conv = gap < cfg.gap_tol * scale
        a0 = torch.where(conv, 0.0, a0)

        # step-quality backoff: damp (but still take) Mehrotra steps that
        # balloon complementarity
        grow = 10.0 * gap + 1e-9
        if it_idx < cfg.early_iters:
            a0 = torch.clamp(a0, max=cfg.a_cap_early)
        a1 = torch.where(gap_at(a0, dc) > grow, 0.3 * a0, a0)
        a = torch.where(gap_at(a1, dc) > grow, 0.3 * a1, a1)

        # a non-finite direction (overflowed barrier products on a cold f32
        # start) must not poison the iterate: freeze that tree instead
        finite = torch.isfinite(a)
        for c in dc:
            finite = finite & torch.isfinite(c).reshape(Bt, -1).all(1)
        a = torch.where(finite, a, 0.0)

        state = (x_c, u_c, s_c, r_c) + vals
        new = tuple(torch.where(_bc(finite, v), v + _bc(a, v) * dv, v)
                    for v, dv in zip(state, dc))
        # best-iterate tracking (returned at the end)
        bx_, bu_, bs_, br_, bgap = best
        better = gap < bgap
        best_new = tuple(torch.where(_bc(better, v), v, b)
                         for v, b in zip((x_c, u_c, s_c, r_c), (bx_, bu_, bs_, br_))) + \
            (torch.where(better, gap, bgap),)
        diag = {"gap": gap, "a": a, "a_aff": a_aff, "sigma": sigma_c,
                "wmax": torch.maximum(_tree_max(lam1_ / sl1_), _tree_max(lq_ / sq_)),
                "prim1": _tree_max(torch.abs(r1)), "rq": _tree_max(torch.abs(rq))}
        return (new, best_new), diag

    best = (x_i, u_i, s_i, r_i, torch.full((Bt,), float("inf"), dtype=dtype, device=dev))
    carry = ((x_i, u_i, s_i, r_i, sl1, mu0 / sl1, sl2, mu0 / sl2, sl3, mu0 / sl3, sl4, lam4,
              sq, mu0 / sq), best)
    diags = []
    for it in range(cfg.iters):
        carry, diag = iteration(it, carry)
        diags.append(diag)
    diag_tr = {k: torch.stack([dg[k] for dg in diags], dim=1) for k in diags[0]}
    state_f, best_f = carry
    gaps = diag_tr["gap"]
    # compare the final iterate with the best seen; return the better one
    gap_last = gaps[:, -1]
    bx_, bu_, bs_, br_, bgap = best_f
    use_last = gap_last <= bgap
    x_f, u_f, s_f, r_f = (torch.where(_bc(use_last, b), v, b)
                          for v, b in zip(state_f[:4], (bx_, bu_, bs_, br_)))
    J = obj_val(u_f, s_f, r_f)
    x_f, u_f, s_f, r_f = (v.to(sdt) for v in (x_f, u_f, s_f, r_f))
    aux = {"J": J.to(sdt), "gap": torch.where(use_last, gap_last, bgap).to(sdt), "risk": r_f,
           "gaps": gaps.to(sdt), "diag": {k: v.to(sdt) for k, v in diag_tr.items()}}
    return x_f, u_f, s_f, r_f, aux
