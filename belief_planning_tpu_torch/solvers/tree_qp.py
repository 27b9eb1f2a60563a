"""Tree QP data: the static per-level stage plan and the stage-cost assembly
(the first part of the reference package's ``solvers/tree_qp.py``).

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

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from belief_planning_tpu_torch.tree.engine import TreeState
from belief_planning_tpu_torch.tree.topology import TreeTopology


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
    ``variant="prox"`` (``BranchMPCProx``: dQ = 3Q, the input-rate coupling)
    or ``"branch"`` (the live ``BranchMPC``: dQ = Q/2, the leaf branch's last
    xRef term through Qf, no rate coupling and no terminal linear row).
    ``xRef (Bt, n)``, ``OldInput (Bt, d)``."""
    if variant not in ("prox", "branch"):
        raise NotImplementedError(
            f"variant {variant!r}: only 'prox' and 'branch' are ported; 'robust' (the "
            "robust controller's cost) is ROADMAP.md Queue A item 5")
    prox = variant == "prox"
    n, d = topo.n, topo.d
    dtype, dev = ts.x_lin.dtype, ts.x_lin.device
    Bt = ts.x_lin.shape[0]
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    Q, R, Qf, dR, Qslack = map(as_t, (Q, R, Qf, dR, Qslack))
    dQ = Q * (3.0 if prox else 0.5)
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
