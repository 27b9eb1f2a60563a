"""Nested-CVaR tree SOCP: the static plan and the cone-ADMM solver (the
reference package's ``solvers/cvar.py``).

Every non-leaf branch carries a dual-CVaR risk block ``[ρ; σ; μ⁺; μ⁻]`` and
one cone per child. The reference's μ-slot aliasing quirk (child ``i`` of
branch ``idx`` uses slot ``idx + i``, so neighbouring branches share slots)
is reproduced under ``replicate_quirks`` and corrected (``idx·m + i``)
otherwise.

:func:`cvar_solve` is the structure-exploiting cone ADMM whose v-update rides
the tree-Riccati factorization of ``solvers/tree_qp.py``:

- the per-child cost-to-go cones are decomposed with per-stage epigraph
  scalars, so each becomes a stage-local rotated second-order cone and the
  ADMM penalty stays block-diagonal per stage;
- the per-cone aggregation rows and the eliminated root epigraph row are the
  only non-local rows, handled exactly by a Woodbury correction whose
  columns are precomputed from the factorized tree (affine-free
  linear-response passes);
- the z-update projects every stage's cone with :func:`ops.soc.proj_soc`,
  the hand-written CUDA kernel ``csrc/proj_soc.cu`` on the card and
  :func:`_proj_soc_batch` on the CPU.

The solver is batched over trees: the tree arrays and ``x0`` carry a
leading tree axis, the cost and bound data are shared by all trees (as a
``vmap`` over ``(ts, x0)`` would have them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from belief_planning_tpu_torch.solvers.tree_qp import (
    Factors,
    StageCost,
    StagePlan,
    _idx,
    build_stage_plan,
    tree_lqr_factor,
    tree_lqr_forward,
    tree_lqr_linear,
)
from belief_planning_tpu_torch.tree.engine import TreeState
from belief_planning_tpu_torch.tree.topology import TreeTopology
from belief_planning_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class CVaRPlan:
    plan: StagePlan
    bdim: int                      # number of non-leaf branches (= risk branches)
    nrisk: int                     # ρ, σ, μ⁺, μ⁻ count
    slotP: np.ndarray              # (bdim, m) flat μ⁺ slot per (branch, child)
    slotM: np.ndarray              # (bdim, m) flat μ⁻ slot
    child_of: np.ndarray           # (bdim, m) child branch id
    child_nonleaf: np.ndarray      # (bdim, m) bool
    n_sum_rows: int                # bdim·m per-child cone rows


def build_cvar_plan(topo: TreeTopology, replicate_quirks: bool = True) -> CVaRPlan:
    plan = build_stage_plan(topo)
    bdim = int(np.sum(~np.asarray(topo.is_leaf)))
    m = topo.m
    slotP = np.zeros((bdim, m), dtype=np.int64)
    slotM = np.zeros((bdim, m), dtype=np.int64)
    for idx in range(bdim):
        for i in range(m):
            slot = idx + i if replicate_quirks else idx * m + i
            slotP[idx, i] = slot
            slotM[idx, i] = slot
    child_of = np.asarray(topo.children[:bdim], dtype=np.int64)
    child_nonleaf = ~np.asarray(topo.is_leaf)[child_of]
    return CVaRPlan(plan=plan, bdim=bdim, nrisk=bdim * (2 + 2 * m), slotP=slotP,
                    slotM=slotM, child_of=child_of, child_nonleaf=child_nonleaf,
                    n_sum_rows=bdim * m)


@dataclass(frozen=True)
class CVaRConfig:
    rho1: float = 5.0      # state rows [−dh; Fx·S]x − s ≤ [h0; bx]
    rho2: float = 5.0      # input rows Fu u ≤ bu
    rho3: float = 5.0      # slack positivity
    rho4: float = 1.0      # per-stage rotated cones
    rho5: float = 1.0      # per-cone aggregation rows (Woodbury)
    rho_eq: float = 10.0   # risk recursion equalities
    rho_sign: float = 5.0  # ρ, μ± sign rows
    sigma: float = 1e-6
    alpha: float = 1.6
    iters: int = 400


class CVaRState(NamedTuple):
    """The ADMM iterate, each field with a leading tree axis."""

    x: Any
    u: Any
    s: Any
    t: Any       # shifted epigraph t'
    risk: Any    # (Bt, nrisk) [ρ; σ; μ⁺; μ⁻]
    z1: Any
    y1: Any
    z2: Any
    y2: Any
    z3: Any
    y3: Any
    z4: Any      # (Bt, totalu, 2+n+d) cone copies
    y4: Any
    z5: Any      # (Bt, n_sum_rows)
    y5: Any
    zeq: Any     # (Bt, bdim)
    yeq: Any
    zs: Any      # (Bt, bdim + 2·bdim·m) sign rows for [ρ; μ⁺; μ⁻]
    ys: Any


def _psd_sqrt(Q):
    """V diag(√max(w, 0)) Vᵀ; independent of the eigenvectors' signs and order."""
    w, V = torch.linalg.eigh(Q)
    return (V * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]) @ V.transpose(-1, -2)


def _proj_soc_batch(v):
    """Projection onto the SOC for (batch, k) vectors with v[:,0] the cone
    scalar: the plain version of the kernel ``csrc/proj_soc.cu``."""
    t = v[:, 0]
    u = v[:, 1:]
    nu = torch.linalg.vector_norm(u, dim=1)
    inside = nu <= t
    below = nu <= -t
    a = 0.5 * (1.0 + t / torch.clamp(nu, min=1e-30))
    proj_t = a * nu
    proj_u = a[:, None] * u
    out_t = torch.where(inside, t, torch.where(below, 0.0, proj_t))
    out_u = torch.where(inside[:, None], u, torch.where(below[:, None], 0.0, proj_u))
    return torch.cat([out_t[:, None], out_u], dim=1)


def cvar_solve(cplan: CVaRPlan, ts: TreeState, Q, R, Qslack, xRef, ralpha, Fx, bx, Fu, bu,
               x0, S=None, cfg: CVaRConfig = CVaRConfig(), dh0_floor=None, device=None):
    """Solve the nested-CVaR tree SOCP for a batch of trees.

    ``ts`` (a TreeState with a leading tree axis ``Bt``) and ``x0 (Bt, n)``
    are per tree; ``Q, R, Qslack, xRef, ralpha, Fx, bx, Fu, bu`` and ``S``
    are shared. ``dh0_floor``: ``None`` applies the dh[0] magnitude floor
    whenever ``S`` is given, a bool or a ``(Bt,)`` bool tensor applies it
    where true. ``device``: ``None`` is the CUDA device (raises without one);
    pass ``"cpu"`` to run on the CPU. The dtype is ``ts``'s.

    Returns ``(x_nodes, u, s, state, aux)`` as the reference does, batched:
    ``aux`` holds ``prim_res (Bt,)``, ``J (Bt,)``, ``risk`` and ``t``. The
    reference applies no dR terms in the CVaR program, so the Riccati runs
    without rate-coupling edges.
    """
    from belief_planning_tpu_torch.ops.soc import proj_soc   # ops.soc imports this module

    dev = resolve_device(device)
    plan = cplan.plan
    topo = plan.topo
    n, d, m = topo.n, topo.d, topo.m
    totalu = topo.totalu
    bdim, nrisk = cplan.bdim, cplan.nrisk
    ts = TreeState(*(a.to(dev) for a in ts))
    dtype = ts.x_lin.dtype
    Bt = ts.x_lin.shape[0]
    ein = torch.einsum
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)

    Q, R, xRef, Fx, bx, Fu, bu, x0 = map(as_t, (Q, R, xRef, Fx, bx, Fu, bu, x0))
    Qslack1 = as_t(Qslack)[1]
    nFx = Fx.shape[0]
    Nc = nFx + 1
    nFu = Fu.shape[0]

    Wx = _psd_sqrt(Q)
    Wu = _psd_sqrt(R)
    if S is not None:
        S = as_t(S)
        W1 = Wx @ S
        Fx_used = Fx @ S
    else:
        W1 = Wx
        Fx_used = Fx
    cx = -2.0 * (Q @ xRef)                      # linear x term inside each cone
    cconst = xRef @ Q @ xRef                    # per-node constant inside cones
    # epigraph scaling t' = tscale·t̂ balances the cone components (without
    # it the SOC projection is badly conditioned and ADMM crawls)
    tscale = cconst + 1.0
    tsqrt = torch.sqrt(tscale)

    # state rows, with the dh[0] magnitude floor when S is given
    dh = ts.dh
    if S is not None:
        d0 = dh[..., 0]
        d0f = torch.sign(d0) * torch.clamp(torch.abs(d0), min=0.1)
        if dh0_floor is not None:
            fl = torch.as_tensor(dh0_floor, dtype=torch.bool, device=dev)
            d0f = torch.where(fl[:, None] if fl.ndim else fl, d0f, d0)
        dh = dh.clone()
        dh[..., 0] = d0f
    Fxc = torch.cat([-dh[..., None, :], Fx_used.expand(Bt, totalu, nFx, n)], dim=-2)
    b1 = torch.cat([ts.h0[..., None], bx.expand(Bt, totalu, nFx)], dim=-1)

    sigma = cfg.sigma
    rho1, rho2, rho3 = cfg.rho1, cfg.rho2, cfg.rho3
    rho4, rho5 = cfg.rho4, cfg.rho5
    rho_eq, rho_sign = cfg.rho_eq, cfg.rho_sign
    kappa = sigma + rho1 + rho3                 # slack has no direct cost here

    # --- tree factorization (quadratics fixed for the whole solve) ---------
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    eye_d = torch.eye(d, dtype=dtype, device=dev)
    coef = rho1 - rho1 * rho1 / kappa
    Qx2_eff = coef * ein("...bri,...brj->...bij", Fxc, Fxc)
    Qx2_eff = Qx2_eff + (4.0 * rho4 / tscale) * (W1.T @ W1)
    Qx2_eff = Qx2_eff + sigma * eye_n
    Ru2_eff = (rho2 * (Fu.T @ Fu) + (4.0 * rho4 / tscale) * (Wu.T @ Wu)
               + sigma * eye_d).expand(Bt, totalu, d, d)
    n_leaves = len(plan.leaf_ids)
    zeros_u = zeros(Bt, totalu, d, d)
    cost = StageCost(
        Qx2=Qx2_eff, qx=zeros(Bt, totalu, n), Ru2=Ru2_eff, qu=zeros(Bt, totalu, d),
        Daa2=zeros_u, Dab2=zeros_u, Pterm2=(sigma * eye_n).expand(Bt, n_leaves, n, n),
        qterm=zeros(Bt, n_leaves, n), slack_lin=zeros(Bt, totalu), slack_quad=zeros(Bt))
    fac = tree_lqr_factor(plan, cost, ts)
    fac_col = Factors(*(None if f is None else f[:, None] for f in fac))

    cx_nodes = _idx(topo.cnode_x, dev)
    leaf_term = _idx(plan.leaf_term_idx, dev)

    # diag quadratic of the scalar blocks
    Ht = 2.0 * rho4 + sigma                     # t'
    # risk block: sigma + sign penalties + equality rank-ones
    sgn_mask = np.zeros(nrisk)
    sgn_mask[:bdim] = 1.0                       # ρ rows
    sgn_mask[2 * bdim:] = 1.0                   # μ± rows
    Hrisk = torch.diag(as_t(sigma + rho_sign * sgn_mask))
    # equality rows r_i: ρ_i + σ_i − (p_i/α)·μ⁻_{i·m + c}
    ib = np.arange(bdim)
    Req = zeros(Bt, bdim, nrisk)
    rows = _idx(ib[:, None], dev)
    cols = _idx(2 * bdim + bdim * m + ib[:, None] * m + np.arange(m), dev)
    Req[:, _idx(ib, dev), _idx(ib, dev)] = 1.0
    Req[:, _idx(ib, dev), _idx(bdim + ib, dev)] = 1.0
    Req[:, rows, cols] = -ts.p[:, :bdim] / ralpha
    Hrisk = Hrisk + rho_eq * Req.transpose(-1, -2) @ Req
    Hrisk_inv = torch.linalg.inv(Hrisk)

    # --- sum rows (Woodbury columns) --------------------------------------
    # child row (idx, i): Σ_{j∈child}(t'_j + cxᵀx_j + cconst) + Qslack1·Σ s_child
    #                     + σ_idx + μ⁺ − μ⁻ + [ρ_child] ≤ 0
    nrows5 = cplan.n_sum_rows
    u_off = np.asarray(topo.u_off)
    N = topo.N
    f_t = np.zeros((nrows5, totalu))
    f_s = np.zeros((nrows5, totalu, Nc))
    f_r = np.zeros((nrows5, nrisk))
    row_const = np.zeros((nrows5,))
    x_mask = np.zeros((nrows5, totalu))
    r = 0
    for ix in range(bdim):
        for i in range(m):
            c = int(cplan.child_of[ix, i])
            stages = u_off[c] + np.arange(N)
            x_mask[r, stages] = 1.0
            f_t[r, stages] = 1.0
            f_s[r, stages, :] = 1.0           # × Qslack1 below
            f_r[r, bdim + ix] += 1.0          # σ_idx
            f_r[r, 2 * bdim + cplan.slotP[ix, i]] += 1.0
            f_r[r, 2 * bdim + bdim * m + cplan.slotM[ix, i]] -= 1.0
            if cplan.child_nonleaf[ix, i]:
                f_r[r, c] += 1.0              # ρ_child (branchidx == branch id)
            row_const[r] = N                  # × cconst below
            r += 1
    f_t_j = as_t(f_t) * tscale                # t' = tscale·t̂
    f_s_j = as_t(f_s) * Qslack1
    f_r_j = as_t(f_r)
    const5 = as_t(row_const) * cconst         # (nrows5,)
    fx_j = as_t(x_mask)[:, :, None] * cx[None, None, :]   # (nrows5, totalu, n)

    # eliminated root epigraph: objective = t'_0 + Qslack1·Σ s_root + ρ_0
    obj_t = zeros(totalu)
    obj_t[0] = 1.0
    obj_t = obj_t * tscale
    obj_s = zeros(totalu, Nc)
    obj_s[0] = Qslack1
    obj_r = zeros(nrisk)
    obj_r[0] = 1.0

    # --- H0 apply ----------------------------------------------------------

    def h0_apply(qx, qu, qterm, qs, qt, qrisk, response: bool):
        """argmin ½vᵀH0v + ⟨q, v⟩ s.t. dynamics. ``response=True`` is the
        Woodbury columns' mode: zero constants and zero x0, right-hand sides
        with a column axis after the tree axis. Returns (x, u, s, t, risk)."""
        fc, F, Hi = (fac_col, Fxc[:, None], Hrisk_inv[:, None]) if response \
            else (fac, Fxc, Hrisk_inv)
        # slack elimination: s*(x) = (ρ1·Fxc x − qs)/κ; induced x-linear +(ρ1/κ)Fxcᵀqs
        qx_eff = qx + (rho1 / kappa) * ein("...brn,...br->...bn", F, qs)
        kff = tree_lqr_linear(plan, fc, qx_eff, qu, qterm, affine=not response)
        x_nodes, u = tree_lqr_forward(plan, fc, kff, zeros(n) if response else x0, zeros(d),
                                      affine=not response)
        s = (rho1 * ein("...brn,...bn->...br", F, x_nodes[..., cx_nodes, :]) - qs) / kappa
        t = -qt / Ht
        risk = -ein("...ij,...j->...i", Hi, qrisk)
        return x_nodes, u, s, t, risk

    def dot_rows(x_nodes, u, s, t, risk):
        """Uᵀv for the sum rows: (..., nrows5)."""
        out = ein("rjn,...jn->...r", fx_j, x_nodes[..., cx_nodes, :])
        out = out + ein("rj,...j->...r", f_t_j, t)
        out = out + ein("rjc,...jc->...r", f_s_j, s)
        return out + ein("rk,...k->...r", f_r_j, risk)

    # Woodbury columns: the response of H0 to each sum row, the nrows5 rows
    # folded into the batch of one response solve (column axis after trees)
    Zx, Zu, Zs, Zt, Zr = h0_apply(fx_j, zeros(totalu, d), zeros(n_leaves, n), f_s_j, f_t_j,
                                  f_r_j, response=True)
    UtZ = dot_rows(Zx, Zu, Zs, Zt, Zr)                        # (Bt, col, row)
    Wmat = torch.linalg.inv(torch.eye(nrows5, dtype=dtype, device=dev) - rho5 * UtZ)

    # --- ADMM state init ---------------------------------------------------
    x_i, u_i = ts.x_lin, ts.u_lin
    cone_dim = 2 + n + d

    def cone_rows(x_nodes, u, t):
        r0 = 1.0 + t
        rx = (2.0 / tsqrt) * ein("ij,...bj->...bi", W1, x_nodes[..., cx_nodes, :])
        ru = (2.0 / tsqrt) * ein("ij,...bj->...bi", Wu, u)
        rl = 1.0 - t
        rx[..., 0, :] = 0.0             # the root stage has no x rows in its cone
        return torch.cat([r0[..., None], rx, ru, rl[..., None]], dim=-1)

    def proj_cones(v):
        return proj_soc(v.reshape(-1, cone_dim)).reshape(v.shape)

    t_i = zeros(Bt, totalu)
    state = CVaRState(
        x=x_i, u=u_i, s=zeros(Bt, totalu, Nc), t=t_i, risk=zeros(Bt, nrisk),
        z1=torch.minimum(ein("...brn,...bn->...br", Fxc, x_i[..., cx_nodes, :]), b1),
        y1=zeros(Bt, totalu, Nc),
        z2=torch.minimum(ein("rn,...bn->...br", Fu, u_i), bu),
        y2=zeros(Bt, totalu, nFu),
        z3=zeros(Bt, totalu, Nc), y3=zeros(Bt, totalu, Nc),
        z4=proj_cones(cone_rows(x_i, u_i, t_i)), y4=zeros(Bt, totalu, cone_dim),
        z5=zeros(Bt, nrows5), y5=zeros(Bt, nrows5),
        zeq=zeros(Bt, bdim), yeq=zeros(Bt, bdim),
        zs=zeros(Bt, bdim + 2 * bdim * m), ys=zeros(Bt, bdim + 2 * bdim * m),
    )
    # risk indices carrying sign rows (ρ then μ±)
    sgn_rows = _idx(np.concatenate([np.arange(bdim), np.arange(2 * bdim, nrisk)]), dev)
    a_relax = cfg.alpha

    def iteration(st: CVaRState):
        w1 = st.z1 - st.y1 / rho1
        w2 = st.z2 - st.y2 / rho2
        w3 = st.z3 - st.y3 / rho3
        w4 = st.z4 - st.y4 / rho4
        w5 = st.z5 - st.y5 / rho5
        weq = st.zeq - st.yeq / rho_eq
        ws = st.zs - st.ys / rho_sign

        # linear terms of the v-update (½-form), as in the reference
        qx = -rho1 * ein("...brn,...br->...bn", Fxc, w1)
        w4x = w4[..., 1:1 + n].clone()
        w4x[..., 0, :] = 0.0                        # root cone has no x rows
        qx = qx - (2.0 * rho4 / tsqrt) * ein("ij,...bi->...bj", W1, w4x)
        qx = qx - sigma * st.x[..., cx_nodes, :]   # σ-prox on stage nodes
        qterm = -sigma * st.x[..., leaf_term, :]
        qu = (-rho2 * ein("rn,...br->...bn", Fu, w2)
              - (2.0 * rho4 / tsqrt) * ein("ij,...bi->...bj", Wu, w4[..., 1 + n:1 + n + d])
              - sigma * st.u)
        qs = rho1 * w1 - rho3 * w3 - sigma * st.s
        qt = rho4 * (1.0 - w4[..., 0]) - rho4 * (1.0 - w4[..., -1]) - sigma * st.t
        qrisk = ein("...ij,...i->...j", -rho_eq * Req, weq) - sigma * st.risk
        qrisk[..., sgn_rows] += -rho_sign * ws

        # eliminated-J objective: + t'_0 + Qslack1·Σ s_root + ρ_0
        qt = qt + obj_t
        qs = qs + obj_s
        qrisk = qrisk + obj_r

        # sum rows: ρ5/2‖Uᵀv + const5 − w5‖² → external linear ρ5 U(const5 − w5)
        tau = w5 - const5
        qx = qx + rho5 * ein("...r,rjn->...jn", -tau, fx_j)
        qs = qs + rho5 * ein("...r,rjc->...jc", -tau, f_s_j)
        qt = qt + rho5 * ((-tau) @ f_t_j)
        qrisk = qrisk + rho5 * ((-tau) @ f_r_j)

        ax, au, as_, at, ar = h0_apply(qx, qu, qterm, qs, qt, qrisk, False)
        phi = ein("...rj,...j->...r", Wmat, dot_rows(ax, au, as_, at, ar))
        corr = rho5 * phi
        x_n = ax + ein("...r,...rin->...in", corr, Zx)
        u_n = au + ein("...r,...rid->...id", corr, Zu)
        s_n = as_ + ein("...r,...ric->...ic", corr, Zs)
        t_n = at + ein("...r,...ri->...i", corr, Zt)
        r_n = ar + ein("...r,...ri->...i", corr, Zr)

        # row evaluations
        y1t = ein("...brn,...bn->...br", Fxc, x_n[..., cx_nodes, :]) - s_n
        y2t = ein("rn,...bn->...br", Fu, u_n)
        y5t = dot_rows(x_n, u_n, s_n, t_n, r_n) + const5
        yeqt = ein("...ij,...j->...i", Req, r_n)

        # relax + project + dual update
        def upd(yt, z, y, rho, proj):
            yh = a_relax * yt + (1 - a_relax) * z
            z_new = proj(yh + y / rho)
            return z_new, y + rho * (yh - z_new)

        z1, y1 = upd(y1t, st.z1, st.y1, rho1, lambda v: torch.minimum(v, b1))
        z2, y2 = upd(y2t, st.z2, st.y2, rho2, lambda v: torch.minimum(v, bu))
        z3, y3 = upd(s_n, st.z3, st.y3, rho3, lambda v: torch.clamp(v, min=0.0))
        z4, y4 = upd(cone_rows(x_n, u_n, t_n), st.z4, st.y4, rho4, proj_cones)
        z5, y5 = upd(y5t, st.z5, st.y5, rho5, lambda v: torch.clamp(v, max=0.0))
        zeq, yeq = upd(yeqt, st.zeq, st.yeq, rho_eq, torch.zeros_like)
        zs_, ys_ = upd(r_n[..., sgn_rows], st.zs, st.ys, rho_sign,
                       lambda v: torch.clamp(v, min=0.0))
        return CVaRState(x=x_n, u=u_n, s=s_n, t=t_n, risk=r_n, z1=z1, y1=y1, z2=z2, y2=y2,
                         z3=z3, y3=y3, z4=z4, y4=y4, z5=z5, y5=y5, zeq=zeq, yeq=yeq,
                         zs=zs_, ys=ys_), (y1t, y2t, y5t, yeqt)

    for _ in range(cfg.iters):
        state = iteration(state)[0]
    state, (y1t, y2t, y5t, yeqt) = iteration(state)

    lane_max = lambda v: v.reshape(Bt, -1).amax(1)
    prim = torch.maximum(
        lane_max(torch.clamp(y1t - b1, min=0.0)),
        torch.maximum(lane_max(torch.clamp(y2t - bu, min=0.0)),
                      torch.maximum(lane_max(torch.clamp(y5t, min=0.0)),
                                    lane_max(torch.abs(yeqt)))))
    # the eliminated epigraph value J = t'_0 + Qslack1·Σ s_root + ρ_0
    J = tscale * state.t[:, 0] + Qslack1 * torch.sum(state.s[:, 0], dim=-1) + state.risk[:, 0]
    aux = {"prim_res": prim, "J": J, "risk": state.risk, "t": tscale * state.t}
    return state.x, state.u, state.s, state, aux
