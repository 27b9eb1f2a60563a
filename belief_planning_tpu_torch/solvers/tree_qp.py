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
    """Per-stage cost arrays equivalent to the reference ``buildCost``
    (prox variant). ``xRef (Bt, n)``, ``OldInput (Bt, d)``."""
    if variant != "prox":
        raise NotImplementedError(f"variant {variant!r}: only 'prox' is ported")
    n, d = topo.n, topo.d
    dtype, dev = ts.x_lin.dtype, ts.x_lin.device
    Bt = ts.x_lin.shape[0]
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    Q, R, Qf, dR, Qslack = map(as_t, (Q, R, Qf, dR, Qslack))
    dQ = Q * 3.0
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

    # One −w_j·dR block per input-chain edge (pred(j) → j); the parent-side
    # (u_prev²) part already sits in the parent's diagonal, so Daa2 is zero.
    Daa2 = ts.x_lin.new_zeros((Bt, topo.totalu, d, d))
    has_edge = np.ones(topo.totalu, dtype=bool)
    has_edge[0] = False                  # the root's incoming edge is OldInput
    he = as_t(has_edge.astype(np.float64))[:, None, None]
    Dab2 = he * (-2.0 * w_u[..., None, None] * dRm)
    # diagonals: root w(R+dR); non-root w(R+2dR); leaf-last w·R (overwrite
    # quirk) or w(R+dR) corrected
    Ru2 = 2.0 * w_u[..., None, None] * (R + 2.0 * dRm)
    Ru2[:, 0] = 2.0 * (R + dRm)
    mask_ll = as_t((is_last & leaf_u).astype(np.float64))[:, None, None]
    ll_fix = -2.0 * dRm if replicate_quirks else -dRm
    Ru2 = Ru2 + mask_ll * (2.0 * w_u[..., None, None] * ll_fix)

    qu = ts.x_lin.new_zeros((Bt, topo.totalu, d))
    if replicate_quirks:
        # scalar broadcast: qu[0:d] = −2·(OldInput·dR)
        qu[:, 0] = (-2.0 * (OldInput @ dR))[:, None]
        Ru2[:, 0] = Ru2[:, 0] + 2.0 * _sym_broadcast_dR(dR)
    else:
        qu[:, 0] = -2.0 * OldInput @ dRm.T
        Ru2[:, 0] = Ru2[:, 0] + 2.0 * dRm

    leaf_ids = np.nonzero(np.asarray(topo.is_leaf))[0]
    w_leaf = ts.w[:, leaf_ids]
    Pterm2 = 2.0 * w_leaf[..., None, None] * Qf
    qterm = -2.0 * w_leaf[..., None] * (xRef @ Qf)[:, None, :]

    return StageCost(Qx2=Qx2, qx=qx, Ru2=Ru2, qu=qu, Daa2=Daa2, Dab2=Dab2,
                     Pterm2=Pterm2, qterm=qterm, slack_lin=Qslack[1] * w_u,
                     slack_quad=(2.0 * Qslack[0]).expand(Bt).clone())
