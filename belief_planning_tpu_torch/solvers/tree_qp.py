"""The tree QP (the reference package's ``solvers/tree_qp.py``): the static
per-level stage plan, the stage-cost assembly, the Riccati sweeps over the
tree, and the OSQP-style ADMM around them (:func:`admm_solve`).

Cost convention: ½-form ``½vᵀP̂v + q̂ᵀv`` with P̂ = 2·H_assembled, as the
reference's "multiply by two because CVX considers 1/2" followed by OSQP's
upper-triangle symmetrization. Reference quirks are kept under
``replicate_quirks=True`` (default):

- the leaf branch's last input block is w·R only (the accumulated
  rate-coupling diagonal is overwritten);
- the root input block gains the triu-symmetrized broadcast of the dR vector,
  and the scalar-broadcast OldInput linear term.

Arrays carry a leading batch axis over trees.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from belief_planning_tpu_torch.tree.engine import TreeState
from belief_planning_tpu_torch.tree.topology import TreeTopology
from belief_planning_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class StagePlan:
    """Static per-level index arrays of the Riccati sweeps."""

    topo: TreeTopology
    stage_idx: Tuple[np.ndarray, ...]     # per level (l, nb) stage ids
    succ_x_idx: Tuple[np.ndarray, ...]    # successor x-node of each stage
    xnode_idx: Tuple[np.ndarray, ...]     # x-node of each stage
    leaf_term_idx: np.ndarray             # (n_leaves,) terminal x-node ids
    leaf_ids: np.ndarray                  # (n_leaves,) leaf branch ids


def build_stage_plan(topo: TreeTopology) -> StagePlan:
    stage_idx, succ_x_idx, xnode_idx = [], [], []
    for k in range(topo.NB + 1):
        lo, hi = topo.level_lo[k], topo.level_hi[k]
        ids = np.arange(lo, hi)
        l = int(topo.blen[lo])
        si = topo.u_off[ids][None, :] + np.arange(l)[:, None]      # (l, nb)
        xi = topo.x_off[ids][None, :] + np.arange(l)[:, None]
        sx = xi + 1
        # branch-last successor: first child's first node, or the terminal node
        last = np.array([topo.x_off[b] + topo.blen[b] if topo.is_leaf[b]
                         else topo.x_off[topo.children[b, 0]] for b in ids])
        sx[l - 1, :] = last
        stage_idx.append(si.astype(np.int64))
        succ_x_idx.append(sx.astype(np.int64))
        xnode_idx.append(xi.astype(np.int64))
    leaf_ids = np.nonzero(np.asarray(topo.is_leaf))[0]
    leaf_term_idx = (topo.x_off[leaf_ids] + topo.blen[leaf_ids]).astype(np.int64)
    return StagePlan(topo=topo, stage_idx=tuple(stage_idx),
                     succ_x_idx=tuple(succ_x_idx), xnode_idx=tuple(xnode_idx),
                     leaf_term_idx=leaf_term_idx, leaf_ids=leaf_ids.astype(np.int64))


class StageCost(NamedTuple):
    """Per-stage quadratic/linear cost data (leading batch axis)."""

    Qx2: Any      # (Bt, totalu, n, n)  2·w·(dQ+Q)
    qx: Any       # (Bt, totalu, n)
    Ru2: Any      # (Bt, totalu, d, d)
    qu: Any       # (Bt, totalu, d)
    Daa2: Any     # (Bt, totalu, d, d)  zero (parent side lives in the parent's diagonal)
    Dab2: Any     # (Bt, totalu, d, d)  rate-coupling cross term of edge pred→j
    Pterm2: Any   # (Bt, n_leaves, n, n) 2·w·Qf
    qterm: Any    # (Bt, n_leaves, n)
    slack_lin: Any   # (Bt, totalu) Qslack[1]·w
    slack_quad: Any  # (Bt,) 2·Qslack[0]


def _sym_broadcast_dR(dR):
    """triu-symmetrization of the reference's row-broadcast dR add:
    S[i, j] = dR[max(i, j)]."""
    i = torch.arange(dR.shape[0], device=dR.device)
    return dR[torch.maximum(i[:, None], i[None, :])]


def assemble_stage_cost(topo: TreeTopology, ts: TreeState, Q, R, Qf, dR, Qslack,
                        xRef, OldInput, variant: str = "prox",
                        replicate_quirks: bool = True) -> StageCost:
    """Per-stage cost arrays equivalent to the reference ``buildCost``:
    ``variant="prox"`` (``BranchMPCProx``: dQ = 3Q, the input-rate coupling),
    ``"branch"`` (the live ``BranchMPC``: dQ = Q/2, the leaf branch's last
    xRef term through Qf, no rate coupling and no terminal linear row) or
    ``"robust"`` (the single-trajectory controllers': the prox assembly with
    dQ = 0 and without the quirks). ``xRef (Bt, n)``, ``OldInput (Bt, d)``."""
    if variant not in ("prox", "branch", "robust"):
        raise ValueError(f"unknown cost variant {variant!r}")
    n, d = topo.n, topo.d
    dtype, dev = ts.x_lin.dtype, ts.x_lin.device
    Bt = ts.x_lin.shape[0]
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    Q, R, Qf, dR, Qslack = map(as_t, (Q, R, Qf, dR, Qslack))
    if variant == "robust":
        dQ = Q * 0.0
        variant, replicate_quirks = "prox", False
    else:
        dQ = Q * (3.0 if variant == "prox" else 0.5)
    prox = variant == "prox"
    dRm = torch.diag(dR)

    ub = np.asarray(topo.unode_branch)
    w_u = ts.w[:, ub]                                   # (Bt, totalu)
    x_nodes = ts.x_lin[:, np.asarray(topo.cnode_x)]     # (Bt, totalu, n)

    Qx2 = 2.0 * w_u[..., None, None] * (dQ + Q)
    qx = (-2.0 * w_u[..., None] * (xRef @ Q)[:, None, :]
          - 2.0 * w_u[..., None] * (x_nodes @ dQ))
    steps = np.asarray(topo.unode_step)
    is_last = steps == np.asarray(topo.blen)[ub] - 1
    leaf_u = np.asarray(topo.is_leaf)[ub]
    mask_ll = as_t((is_last & leaf_u).astype(np.float64))

    Daa2 = ts.x_lin.new_zeros((Bt, topo.totalu, d, d))
    if prox:
        # One −w_j·dR block per input-chain edge (pred(j) → j); the parent-side
        # (u_prev²) part already sits in the parent's diagonal, so Daa2 is zero.
        has_edge = np.ones(topo.totalu, dtype=bool)
        has_edge[0] = False                  # the root's incoming edge is OldInput
        he = as_t(has_edge.astype(np.float64))[:, None, None]
        Dab2 = he * (-2.0 * w_u[..., None, None] * dRm)
        # diagonals: root w(R+dR); non-root w(R+2dR); leaf-last w·R (overwrite
        # quirk) or w(R+dR) corrected
        Ru2 = 2.0 * w_u[..., None, None] * (R + 2.0 * dRm)
        Ru2[:, 0] = 2.0 * (R + dRm)
        ll_fix = -2.0 * dRm if replicate_quirks else -dRm
        Ru2 = Ru2 + mask_ll[:, None, None] * (2.0 * w_u[..., None, None] * ll_fix)
    else:
        # the leaf branch's last row takes Qf for its xRef term
        qx = qx + mask_ll[:, None] * (-2.0 * w_u[..., None] * ((xRef @ Qf) - (xRef @ Q))[:, None, :])
        Dab2 = ts.x_lin.new_zeros((Bt, topo.totalu, d, d))
        Ru2 = 2.0 * w_u[..., None, None] * R

    qu = ts.x_lin.new_zeros((Bt, topo.totalu, d))
    if replicate_quirks:
        # scalar broadcast: qu[0:d] = −2·(OldInput·dR)
        qu[:, 0] = (-2.0 * (OldInput @ dR))[:, None]
        if prox:
            Ru2[:, 0] = Ru2[:, 0] + 2.0 * _sym_broadcast_dR(dR)
    else:
        qu[:, 0] = -2.0 * OldInput @ dRm.T
        Ru2[:, 0] = Ru2[:, 0] + 2.0 * dRm

    leaf_ids = np.nonzero(np.asarray(topo.is_leaf))[0]
    w_leaf = ts.w[:, leaf_ids]
    Pterm2 = 2.0 * w_leaf[..., None, None] * Qf
    if prox:
        qterm = -2.0 * w_leaf[..., None] * (xRef @ Qf)[:, None, :]
    else:
        qterm = ts.x_lin.new_zeros((Bt, len(leaf_ids), n))

    return StageCost(Qx2=Qx2, qx=qx, Ru2=Ru2, qu=qu, Daa2=Daa2, Dab2=Dab2,
                     Pterm2=Pterm2, qterm=qterm, slack_lin=Qslack[1] * w_u,
                     slack_quad=(2.0 * Qslack[0]).expand(Bt).clone())


# ---------------------------------------------------------------------------
# Riccati over the tree (augmented state ξ = (x, u_prev))
# ---------------------------------------------------------------------------
#
# The reference scans the stages of a level with ``lax.scan(unroll=True)``;
# here that is a Python loop over the level's ``l`` steps. Every array has
# leading batch dims (trees, and for the CVaR solver's Woodbury columns trees
# × columns) that broadcast between the factor and the right-hand sides.


def _small_inv(M):
    """Closed-form inverse of batched tiny matrices (d ≤ 3), as the
    reference's; ``torch.linalg.inv`` above that."""
    d = M.shape[-1]
    if d == 1:
        return 1.0 / M
    if d == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, e = M[..., 1, 0], M[..., 1, 1]
        det = a * e - b * c
        inv = torch.stack([torch.stack([e, -b], dim=-1),
                           torch.stack([-c, a], dim=-1)], dim=-2)
        return inv / det[..., None, None]
    if d == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        e, f, g = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        h, i, j = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
        A = f * j - g * i
        B = -(e * j - g * h)
        C = e * i - f * h
        det = a * A + b * B + c * C
        inv = torch.stack([
            torch.stack([A, -(b * j - c * i), b * g - c * f], dim=-1),
            torch.stack([B, a * j - c * h, -(a * g - c * e)], dim=-1),
            torch.stack([C, -(a * i - b * h), a * f - b * e], dim=-1),
        ], dim=-2)
        return inv / det[..., None, None]
    return torch.linalg.inv(M)


class Factors(NamedTuple):
    K: Any        # (..., totalu, d, nd)
    k_fix: Any    # unused placeholder for alignment (None)
    Hinv: Any     # (..., totalu, d, d)
    Acl: Any      # (..., totalu, nd, nd)  F + G K
    Bmat: Any     # (..., totalu, n, d)    B of the successor transition
    Amat: Any     # (..., totalu, n, n)
    hvec: Any     # (..., totalu, n)       C of the successor transition
    vec1: Any     # (..., totalu, nd)      Fᵀ P' h
    gu: Any       # (..., totalu, d)       Gᵀ P' h


def _stage_step_quad(W_P, Qx2, Daa2, Dab2, Ru2, A, B, C, n, d):
    """One backward Riccati step (quadratic part) for a batch of branches.

    W_P: (..., nd, nd) successor value quadratic. Returns (P, K, Hinv, Acl,
    vec1, gu)."""
    ein = torch.einsum
    Pxx = W_P[..., :n, :n]
    Pxu = W_P[..., :n, n:]
    Puu = W_P[..., n:, n:]
    # G = [B; I], F = [[A,0],[0,0]], h = [C; 0]
    BtPxx = ein("...nm,...nk->...mk", B, Pxx)                 # Bᵀ Pxx
    GtPG = (ein("...mn,...nk->...mk", BtPxx, B) + ein("...nm,...nk->...mk", B, Pxu)
            + ein("...nk,...nm->...km", Pxu, B) + Puu)
    Huu = Ru2 + GtPG
    GtPx = BtPxx + Pxu.transpose(-1, -2)                      # GᵀP' (x-rows)
    GtPF_x = ein("...mn,...nk->...mk", GtPx, A)
    # L = Mᵀ + GᵀP'F ; M = [[0],[Dab]] → Mᵀ has Dabᵀ in the u_prev columns
    L = torch.cat([GtPF_x, Dab2.transpose(-1, -2)], dim=-1)  # (..., d, nd)
    Hinv = _small_inv(Huu)
    K = -ein("...mk,...kl->...ml", Hinv, L)
    AtPxxA = ein("...nm,...nk,...kl->...ml", A, Pxx, A)
    Qxi = torch.zeros_like(W_P)
    Qxi[..., :n, :n] = Qx2 + AtPxxA
    Qxi[..., n:, n:] = Daa2
    P = Qxi - ein("...ml,...mk,...kj->...lj", L, Hinv, L)
    P = 0.5 * (P + P.transpose(-1, -2))                       # numerical hygiene
    # fixed linear-pass vectors: vec1 = FᵀP'h = [Aᵀ(Pxx C); 0], gu = GᵀP'h
    PxxC = ein("...nk,...k->...n", Pxx, C)
    PuxC = ein("...nk,...n->...k", Pxu, C)                    # Pxuᵀ C
    vec1 = torch.cat([ein("...nm,...n->...m", A, PxxC), torch.zeros_like(PuxC)], dim=-1)
    gu = ein("...nm,...n->...m", B, PxxC) + PuxC
    Acl = torch.zeros_like(W_P)
    Acl[..., :n, :n] = A
    G = torch.cat([B, torch.eye(d, dtype=B.dtype, device=B.device).expand(B.shape[:-2] + (d, d))],
                  dim=-2)
    Acl = Acl + G @ K
    return P, K, Hinv, Acl, vec1, gu


def _idx(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)


def tree_lqr_factor(plan: StagePlan, cost: StageCost, ts: TreeState) -> Factors:
    """Backward quadratic sweep over the tree (``cost`` and ``ts`` with the
    same leading batch dims). Returns the Factors."""
    topo = plan.topo
    n, d, m = topo.n, topo.d, topo.m
    nd = n + d
    dtype, dev = ts.x_lin.dtype, ts.x_lin.device
    bs = ts.x_lin.shape[:-2]
    U = topo.totalu
    z = lambda *shape: torch.zeros(bs + shape, dtype=dtype, device=dev)
    K_all, Hinv_all, Acl_all = z(U, d, nd), z(U, d, d), z(U, nd, nd)
    A_all, B_all, h_all = z(U, n, n), z(U, n, d), z(U, n)
    vec1_all, gu_all = z(U, nd), z(U, d)

    P_head_next = None   # (..., nb_{k+1}, nd, nd) head values of the deeper level
    for k in range(topo.NB, -1, -1):
        si = _idx(plan.stage_idx[k], dev)       # (l, nb)
        sx = _idx(plan.succ_x_idx[k], dev)
        l, nb = si.shape
        if k == topo.NB:
            W_P = z(nb, nd, nd)
            W_P[..., :n, :n] = cost.Pterm2
        else:
            W_P = P_head_next.reshape(bs + (nb, m, nd, nd)).sum(dim=-3)
        for j in range(l - 1, -1, -1):
            s, x = si[j], sx[j]
            W_P, K, Hinv, Acl, vec1, gu = _stage_step_quad(
                W_P, cost.Qx2[..., s, :, :], cost.Daa2[..., s, :, :], cost.Dab2[..., s, :, :],
                cost.Ru2[..., s, :, :], ts.A[..., x, :, :], ts.Bm[..., x, :, :],
                ts.C[..., x, :], n, d)
            K_all[..., s, :, :] = K
            Hinv_all[..., s, :, :] = Hinv
            Acl_all[..., s, :, :] = Acl
            vec1_all[..., s, :] = vec1
            gu_all[..., s, :] = gu
        A_all[..., si, :, :] = ts.A[..., sx, :, :]
        B_all[..., si, :, :] = ts.Bm[..., sx, :, :]
        h_all[..., si, :] = ts.C[..., sx, :]
        P_head_next = W_P
    return Factors(K=K_all, k_fix=None, Hinv=Hinv_all, Acl=Acl_all, Bmat=B_all, Amat=A_all,
                   hvec=h_all, vec1=vec1_all, gu=gu_all)


def tree_lqr_linear(plan: StagePlan, fac: Factors, qx_eff, qu_eff, qterm_eff,
                    affine: bool = True):
    """Backward linear sweep: per-stage feedforward k_j given current linear costs.

    qx_eff: (..., totalu, n), qu_eff: (..., totalu, d), qterm_eff:
    (..., n_leaves, n); their batch dims broadcast with the factor's.
    ``affine=False`` drops the dynamics-constant (C) contributions — the pure
    linear-response mode used for Woodbury columns in the CVaR solver.
    Returns kff (..., totalu, d)."""
    topo = plan.topo
    n, d, m = topo.n, topo.d, topo.m
    nd = n + d
    ein = torch.einsum
    dev = qx_eff.device
    bs = torch.broadcast_shapes(qx_eff.shape[:-2], qu_eff.shape[:-2], qterm_eff.shape[:-2],
                                fac.K.shape[:-3])
    kff_all = torch.zeros(bs + (topo.totalu, d), dtype=qx_eff.dtype, device=dev)
    p_head_next = None
    for k in range(topo.NB, -1, -1):
        si = _idx(plan.stage_idx[k], dev)
        l, nb = si.shape
        if k == topo.NB:
            p = torch.zeros(bs + (nb, nd), dtype=qx_eff.dtype, device=dev)
            p[..., :n] = qterm_eff
        else:
            p = p_head_next.reshape(bs + (nb, m, nd)).sum(dim=-2)
        for j in range(l - 1, -1, -1):
            s = si[j]
            qx, qu = qx_eff[..., s, :], qu_eff[..., s, :]
            K, Hinv, Acl = fac.K[..., s, :, :], fac.Hinv[..., s, :, :], fac.Acl[..., s, :, :]
            vec1, gu, B = fac.vec1[..., s, :], fac.gu[..., s, :], fac.Bmat[..., s, :, :]
            # l_u = qu + gu + Gᵀ p' ;  Gᵀ p' = Bᵀ p'_x + p'_u
            l_u = qu + ein("...nm,...n->...m", B, p[..., :n]) + p[..., n:]
            if affine:
                l_u = l_u + gu
            kff_all[..., s, :] = -ein("...mk,...k->...m", Hinv, l_u)
            # p = [qx;0] + vec1 + Aclᵀ p' + Kᵀ(qu + gu)  (Fᵀp' + KᵀGᵀp' = Aclᵀ p')
            pn = torch.cat([qx, qx.new_zeros(qx.shape[:-1] + (d,))], dim=-1)
            pn = pn + ein("...nm,...n->...m", Acl, p)
            if affine:
                pn = pn + vec1 + ein("...mk,...m->...k", K, qu + gu)
            else:
                pn = pn + ein("...mk,...m->...k", K, qu)
            p = pn
        p_head_next = p
    return kff_all


def tree_lqr_forward(plan: StagePlan, fac: Factors, kff, x0, u_old, affine: bool = True):
    """Forward rollout from ξ_root = (x0, u_old); returns (x_nodes (...,
    totalx, n), u (..., totalu, d)). ``x0 (..., n)``, ``u_old (..., d)``;
    batch dims broadcast with ``kff``'s. ``affine=False`` drops the dynamics
    constants (response mode)."""
    topo = plan.topo
    n, d, m = topo.n, topo.d, topo.m
    ein = torch.einsum
    dtype, dev = kff.dtype, kff.device
    bs = torch.broadcast_shapes(kff.shape[:-2], x0.shape[:-1], u_old.shape[:-1],
                                fac.K.shape[:-3])
    x_nodes = torch.zeros(bs + (topo.totalx, n), dtype=dtype, device=dev)
    u_all = torch.zeros(bs + (topo.totalu, d), dtype=dtype, device=dev)
    xi = torch.cat([x0.expand(bs + (n,)), u_old.expand(bs + (d,))], dim=-1)[..., None, :]
    for k in range(topo.NB + 1):
        si = _idx(plan.stage_idx[k], dev)
        xniv = _idx(plan.xnode_idx[k], dev)
        for j in range(si.shape[0]):
            s = si[j]
            K, kf, Acl = fac.K[..., s, :, :], kff[..., s, :], fac.Acl[..., s, :, :]
            B, h = fac.Bmat[..., s, :, :], fac.hvec[..., s, :]
            u_all[..., s, :] = ein("...mk,...k->...m", K, xi) + kf
            x_nodes[..., xniv[j], :] = xi[..., :n]
            # ξ' = Acl ξ + G k + h_full   (Acl ξ already contains the GKξ part)
            xi_next = ein("...nk,...k->...n", Acl, xi)
            if affine:
                xi_next[..., :n] += h
            Gk = torch.cat([ein("...nm,...m->...n", B, kf), kf.expand(xi_next.shape[:-1] + (d,))],
                           dim=-1)
            xi = xi_next + Gk
        if k < topo.NB:
            xi = torch.repeat_interleave(xi, m, dim=-2)     # all children share ξ'
        else:
            x_nodes[..., _idx(plan.leaf_term_idx, dev), :] = xi[..., :n]
    return x_nodes, u_all


# ---------------------------------------------------------------------------
# OSQP-style ADMM around the tree-LQR solve
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ADMMConfig:
    """Uniform row scaling with α=1.6 over-relaxation and an active-set
    polish phase (the reference's tuning on the overtake against its
    oracle: applied inputs to ~1e-7 at 200 + 30 iterations)."""

    rho: float = 5.0
    sigma: float = 1e-6
    alpha: float = 1.6            # over-relaxation (OSQP default)
    iters: int = 200
    rho_update_every: int = 50    # 0 = fixed rho; else adapt every k iters
    rho_min: float = 1e-3
    rho_max: float = 1e4
    row_scaling: str = "uniform"  # "uniform" | "weight" | "weight_rownorm"
    polish_iters: int = 30        # extra iterations with boosted rho on active rows
    polish_boost: float = 200.0
    act_tol: float = 1e-6


class ADMMState(NamedTuple):
    """The ADMM iterate of a batch of trees (leading axis ``Bt``)."""

    x: Any         # (Bt, totalx, n)
    u: Any         # (Bt, totalu, d)
    s: Any         # (Bt, totalu, Nc) slacks
    z1: Any        # (Bt, totalu, Nc) state-row splits
    z2: Any        # (Bt, totalu, nFu) input-row splits
    z3: Any        # (Bt, totalu, Nc) slack-positivity splits
    y1: Any        # duals of z1, z2, z3
    y2: Any
    y3: Any
    theta: Any     # (Bt,) multiplier on the per-row rho bases


def _f32_precision(fn):
    """Run ``fn`` with full-precision f32 matmuls (no TF32), as the
    reference forces them for its iterative solve; the previous setting is
    restored after."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*a, **k)
        finally:
            torch.set_float32_matmul_precision(prev)
    return wrapped


def _per_tree_max(*ts):
    """The largest entry of each tree over all of ``ts`` ``(Bt, ...)``: ``(Bt,)``."""
    return torch.stack([t.reshape(t.shape[0], -1).amax(1) for t in ts], dim=0).amax(0)


@_f32_precision
def admm_solve(plan: StagePlan, cost: StageCost, ts: TreeState, Fx, bx, Fu, bu, x0, OldInput,
               cfg: ADMMConfig = ADMMConfig(), init: ADMMState = None, w_stage=None,
               Fxc_override=None, b1_override=None, warm_duals=None, device=None):
    """Solve the tree QP by ADMM for a batch of trees. Returns ``(x_nodes, u,
    s, state, info)``, ``info`` with ``prim_res (Bt,)`` and ``rho`` (the final
    θ, ``(Bt,)``).

    Rows: state rows R1 ``[−dh; Fx]·x − s ≤ [h0; bx]`` (or the dense
    ``Fxc_override (Bt, totalu, Nc, n)`` ≤ ``b1_override (Bt, totalu, Nc)``),
    input rows R2 ``Fu·u ≤ bu``, slack positivity R3. Each row's penalty is a
    base (``cfg.row_scaling``: uniform, the branch weight ``w_stage (Bt,
    totalu)``, or that over the row norm) times ρ times a per-tree θ that
    ``rho_update_every > 0`` adapts from each tree's own residual ratio; the
    polish phase boosts ρ on each tree's detected active set. The dynamics
    are eliminated by the tree Riccati sweeps, refactored whenever ρ
    changes. ``init`` resumes from a state; ``warm_duals = (y1, y2, y3)``
    starts the duals there. ``device``: ``None`` = ``"cuda"``; pass
    ``"cpu"`` to run on the CPU. f32 matmuls run at full precision."""
    dev = resolve_device(device)
    ts = TreeState(*(a.to(dev) for a in ts))
    cost = StageCost(*(torch.as_tensor(c).to(dev) for c in cost))
    topo = plan.topo
    n, d = topo.n, topo.d
    dtype = ts.x_lin.dtype
    Bt = ts.x_lin.shape[0]
    totalu = topo.totalu
    ein = torch.einsum
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    Fx, bx, Fu, bu = map(as_t, (Fx, bx, Fu, bu))
    nFx, nFu = Fx.shape[0], Fu.shape[0]

    if Fxc_override is not None:
        Fxc = as_t(Fxc_override)
        b1 = as_t(b1_override)
    else:
        Fxc = torch.cat([-ts.dh[..., None, :], Fx.expand(Bt, totalu, nFx, n)], dim=-2)
        b1 = torch.cat([ts.h0[..., None], bx.expand(Bt, totalu, nFx)], dim=-1)
    Nc = Fxc.shape[-2]

    sigma = cfg.sigma
    cx = _idx(topo.cnode_x, dev)
    leaf_term = _idx(plan.leaf_term_idx, dev)
    if w_stage is None:
        w_stage = ts.w[:, _idx(topo.unode_branch, dev)]
    w_stage = as_t(w_stage)

    if cfg.row_scaling == "uniform":
        base1 = torch.ones((Bt, totalu, Nc), dtype=dtype, device=dev)
        base2 = torch.ones((Bt, totalu, nFu), dtype=dtype, device=dev)
    elif cfg.row_scaling == "weight":
        base1 = w_stage[..., None].expand(Bt, totalu, Nc)
        base2 = w_stage[..., None].expand(Bt, totalu, nFu)
    elif cfg.row_scaling == "weight_rownorm":
        base1 = w_stage[..., None] / torch.clamp(torch.sum(Fxc * Fxc, dim=-1), min=1e-3)
        base2 = w_stage[..., None] / torch.clamp(torch.sum(Fu * Fu, dim=1), min=1e-3)
    else:
        raise ValueError(f"unknown row_scaling {cfg.row_scaling!r}")
    base1 = base1 * cfg.rho
    base2 = base2 * cfg.rho
    base3 = base1
    slack_quad = cost.slack_quad.reshape(Bt, 1, 1)
    slack_lin = cost.slack_lin[..., None]
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    eye_d = torch.eye(d, dtype=dtype, device=dev)

    def make_factors(theta, boost1=None, boost2=None, boost3=None):
        th = theta.reshape(Bt, 1, 1)
        rho1 = base1 * th if boost1 is None else base1 * th * boost1
        rho2 = base2 * th if boost2 is None else base2 * th * boost2
        rho3 = base3 * th if boost3 is None else base3 * th * boost3
        kappa = slack_quad + sigma + rho1 + rho3
        coef = rho1 - rho1 * rho1 / kappa
        Qx2 = cost.Qx2 + ein("tbr,tbri,tbrj->tbij", coef, Fxc, Fxc) + sigma * eye_n
        Ru2 = cost.Ru2 + ein("tbr,ri,rj->tbij", rho2, Fu, Fu) + sigma * eye_d
        Pterm2 = cost.Pterm2 + sigma * eye_n
        fac = tree_lqr_factor(plan, cost._replace(Qx2=Qx2, Ru2=Ru2, Pterm2=Pterm2), ts)
        return fac, (rho1, rho2, rho3, kappa)

    theta0 = torch.ones(Bt, dtype=dtype, device=dev)
    fac, rhos = make_factors(theta0)

    if init is None:
        x_init, u_init = ts.x_lin, ts.u_lin
        s_init = torch.zeros((Bt, totalu, Nc), dtype=dtype, device=dev)
        z1 = ein("tbrn,tbn->tbr", Fxc, x_init[:, cx]) - s_init
        z2 = ein("rn,tbn->tbr", Fu, u_init)
        if warm_duals is not None:
            y1_0, y2_0, y3_0 = (as_t(y) for y in warm_duals)
        else:
            y1_0, y2_0, y3_0 = torch.zeros_like(z1), torch.zeros_like(z2), torch.zeros_like(s_init)
        state = ADMMState(x=x_init, u=u_init, s=s_init, z1=torch.minimum(z1, b1),
                          z2=torch.minimum(z2, bu), z3=torch.zeros_like(s_init),
                          y1=y1_0, y2=y2_0, y3=y3_0, theta=theta0)
    else:
        state = ADMMState(*(as_t(a) for a in init))

    def iteration(st: ADMMState, fac, rhos):
        rho1, rho2, rho3, kappa = rhos
        w1 = st.z1 - st.y1 / rho1
        w2 = st.z2 - st.y2 / rho2
        w3 = st.z3 - st.y3 / rho3
        beta = rho1 * w1 - rho3 * w3 - sigma * st.s + slack_lin
        gamma = ein("tbrn,tbr->tbn", Fxc, (rho1 / kappa) * beta - rho1 * w1)
        qx_eff = cost.qx + gamma - sigma * st.x[:, cx]
        qu_eff = cost.qu - sigma * st.u - ein("rn,tbr->tbn", Fu, rho2 * w2)
        qterm_eff = cost.qterm - sigma * st.x[:, leaf_term]
        kff = tree_lqr_linear(plan, fac, qx_eff, qu_eff, qterm_eff)
        x_nodes, u = tree_lqr_forward(plan, fac, kff, x0, OldInput)
        fxn = ein("tbrn,tbn->tbr", Fxc, x_nodes[:, cx])
        s = (rho1 * fxn - beta) / kappa
        y1t = fxn - s
        y2t = ein("rn,tbn->tbr", Fu, u)
        y3t = s
        a = cfg.alpha
        y1h = a * y1t + (1 - a) * st.z1
        y2h = a * y2t + (1 - a) * st.z2
        y3h = a * y3t + (1 - a) * st.z3
        z1 = torch.minimum(y1h + st.y1 / rho1, b1)
        z2 = torch.minimum(y2h + st.y2 / rho2, bu)
        z3 = torch.clamp(y3h + st.y3 / rho3, min=0.0)
        y1 = st.y1 + rho1 * (y1h - z1)
        y2 = st.y2 + rho2 * (y2h - z2)
        y3 = st.y3 + rho3 * (y3h - z3)
        return ADMMState(x_nodes, u, s, z1, z2, z3, y1, y2, y3, st.theta), (y1t, y2t, y3t)

    x0 = as_t(x0)
    OldInput = as_t(OldInput)
    k = cfg.rho_update_every
    if k and k > 0:
        # chunks of k iterations, each followed by one more whose state is
        # kept and whose residuals set each tree's θ
        for _ in range(max(1, cfg.iters // k)):
            for _ in range(k):
                state, _ = iteration(state, fac, rhos)
            st2, (y1t, y2t, y3t) = iteration(state, fac, rhos)
            rp = _per_tree_max(torch.abs(y1t - st2.z1), torch.abs(y2t - st2.z2),
                               torch.abs(y3t - st2.z3))
            dz1, dz2, dz3 = st2.z1 - state.z1, st2.z2 - state.z2, st2.z3 - state.z3
            rd_x = ein("tbrn,tbr->tbn", Fxc, rhos[0] * dz1)
            rd_u = ein("rn,tbr->tbn", Fu, rhos[1] * dz2)
            rd = _per_tree_max(torch.abs(rd_x), torch.abs(rd_u),
                               torch.abs(rhos[0] * dz1 - rhos[2] * dz3))
            new_theta = torch.clamp(state.theta * torch.sqrt((rp + 1e-12) / (rd + 1e-12)),
                                    cfg.rho_min, cfg.rho_max)
            state = st2._replace(theta=new_theta)
            fac, rhos = make_factors(new_theta)
    else:
        for _ in range(cfg.iters):
            state, _ = iteration(state, fac, rhos)

    if cfg.polish_iters and cfg.polish_iters > 0:
        # boost ρ on each tree's detected active set (still exact ADMM, so a
        # wrong guess costs iterations, not correctness)
        boost = lambda act: 1.0 + (cfg.polish_boost - 1.0) * act.to(dtype)
        fac, rhos = make_factors(state.theta, boost(state.y1 > cfg.act_tol),
                                 boost(state.y2 > cfg.act_tol), boost(state.y3 < -cfg.act_tol))
        for _ in range(cfg.polish_iters):
            state, _ = iteration(state, fac, rhos)

    state_f, (y1t, y2t, y3t) = iteration(state, fac, rhos)
    rp = _per_tree_max(torch.clamp(y1t - b1, min=0.0), torch.clamp(y2t - bu, min=0.0),
                       torch.clamp(-y3t, min=0.0))
    info = {"prim_res": rp, "rho": state_f.theta}
    return state_f.x, state_f.u, state_f.s, state_f, info
