"""Static scenario/trajectory-tree topology.

The reference builds its tree as linked Python objects with dict-based node→QP-offset
maps rebuilt per controller (``BranchTree`` + ``inittree``, ``MPC_branch.py:65-183``).
The topology is fully determined by ``(N, NB, m)`` though — so here it is precomputed
once as flat index arrays; every runtime quantity is then a dense array indexed by
node id and all tree traversals become gathers/scatters or per-level batched ops.

Node conventions (identical to the reference's ``countx``/``countu`` BFS layout,
``MPC_branch.py:129-183``):
- branch 0 is the root with a single state node (the measured state) and a single
  input node; depth-k branches (k ≥ 1) have N state nodes and N input nodes;
- branches at depth NB (leaves) get one extra terminal state node
  (``countx += l+1``, ``MPC_branch.py:173-174``);
- branches are numbered in BFS order; children of branch b are contiguous;
- state node ``x_off[b]+t`` pairs with input node ``u_off[b]+t`` for t < blen[b];
  only these "constrained" nodes carry collision/Fx rows (``buildIneqConstr`` loops
  ``range(l)``, ``MPC_branch.py:336-344``) — the leaf terminal node carries only the
  ``Qf`` cost.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class TreeTopology:
    N: int
    NB: int
    m: int
    n: int
    d: int

    n_branches: int
    totalx: int
    totalu: int

    # per-branch arrays
    depth: np.ndarray          # (B,)
    parent: np.ndarray         # (B,) -1 for root
    children: np.ndarray       # (B, m) -1 for leaves
    is_leaf: np.ndarray        # (B,) bool
    blen: np.ndarray           # (B,) input/constrained-state count (1 or N)
    x_off: np.ndarray          # (B,) == reference ndx
    u_off: np.ndarray          # (B,) == reference ndu
    child_order: np.ndarray    # (B,) index among siblings (policy index)

    # per-state-node arrays
    xnode_branch: np.ndarray   # (totalx,)
    xnode_step: np.ndarray     # (totalx,) step within branch (terminal = blen)
    xnode_is_term: np.ndarray  # (totalx,) bool
    pred_x: np.ndarray         # (totalx,) predecessor state node (-1 for root node)
    pred_u: np.ndarray         # (totalx,) predecessor input node (-1 for root node)

    # per-input-node arrays (input node j <-> constrained state node cnode_x[j])
    cnode_x: np.ndarray        # (totalu,) state node of input node j
    unode_branch: np.ndarray   # (totalu,)
    unode_step: np.ndarray     # (totalu,)
    pred_uu: np.ndarray        # (totalu,) predecessor input node (-1 for root input)

    # per-depth branch id ranges (branches of a depth are contiguous)
    level_lo: Tuple[int, ...] = field(default=())
    level_hi: Tuple[int, ...] = field(default=())

    def level_branches(self, k: int) -> np.ndarray:
        return np.arange(self.level_lo[k], self.level_hi[k])

    @property
    def num_leaves(self) -> int:
        return int(np.sum(self.is_leaf))


def build_topology(N: int, NB: int, m: int, n: int, d: int) -> TreeTopology:
    """Construct the static topology for a (N, NB, m, n, d) configuration."""
    # branch counts per level: 1, m, m^2, ..., m^NB
    counts = [m**k for k in range(NB + 1)]
    B = int(np.sum(counts))
    depth = np.zeros(B, dtype=np.int32)
    parent = np.full(B, -1, dtype=np.int32)
    children = np.full((B, m), -1, dtype=np.int32)
    child_order = np.zeros(B, dtype=np.int32)
    blen = np.full(B, N, dtype=np.int32)
    blen[0] = 1

    level_lo, level_hi = [], []
    b = 0
    level_start = 0
    for k in range(NB + 1):
        level_lo.append(level_start)
        level_hi.append(level_start + counts[k])
        for i in range(counts[k]):
            depth[level_start + i] = k
        level_start += counts[k]

    # children assignment: BFS order — children of branch b (in id order) are
    # contiguous starting at level_lo[k+1] + (b - level_lo[k]) * m
    for k in range(NB):
        for j in range(level_lo[k], level_hi[k]):
            base = level_lo[k + 1] + (j - level_lo[k]) * m
            for i in range(m):
                c = base + i
                children[j, i] = c
                parent[c] = j
                child_order[c] = i

    is_leaf = depth == NB

    # offsets (reference countx/countu increments, MPC_branch.py:168-177)
    x_off = np.zeros(B, dtype=np.int32)
    u_off = np.zeros(B, dtype=np.int32)
    countx = 0
    countu = 0
    for j in range(B):
        x_off[j] = countx
        u_off[j] = countu
        countx += int(blen[j]) + (1 if is_leaf[j] else 0)
        countu += int(blen[j])
    totalx = countx
    totalu = countu

    xnode_branch = np.zeros(totalx, dtype=np.int32)
    xnode_step = np.zeros(totalx, dtype=np.int32)
    xnode_is_term = np.zeros(totalx, dtype=bool)
    pred_x = np.full(totalx, -1, dtype=np.int32)
    pred_u = np.full(totalx, -1, dtype=np.int32)
    cnode_x = np.zeros(totalu, dtype=np.int32)
    unode_branch = np.zeros(totalu, dtype=np.int32)
    unode_step = np.zeros(totalu, dtype=np.int32)
    pred_uu = np.full(totalu, -1, dtype=np.int32)

    for j in range(B):
        l = int(blen[j])
        ox, ou = int(x_off[j]), int(u_off[j])
        for t in range(l):
            xnode_branch[ox + t] = j
            xnode_step[ox + t] = t
            cnode_x[ou + t] = ox + t
            unode_branch[ou + t] = j
            unode_step[ou + t] = t
            if t >= 1:
                pred_x[ox + t] = ox + t - 1
                pred_u[ox + t] = ou + t - 1
                pred_uu[ou + t] = ou + t - 1
        if is_leaf[j]:
            xnode_branch[ox + l] = j
            xnode_step[ox + l] = l
            xnode_is_term[ox + l] = True
            pred_x[ox + l] = ox + l - 1
            pred_u[ox + l] = ou + l - 1
        if parent[j] >= 0:
            p = int(parent[j])
            lp = int(blen[p])
            pred_x[ox] = int(x_off[p]) + lp - 1
            pred_u[ox] = int(u_off[p]) + lp - 1
            pred_uu[ou] = int(u_off[p]) + lp - 1

    return TreeTopology(
        N=N,
        NB=NB,
        m=m,
        n=n,
        d=d,
        n_branches=B,
        totalx=totalx,
        totalu=totalu,
        depth=depth,
        parent=parent,
        children=children,
        is_leaf=is_leaf,
        blen=blen,
        x_off=x_off,
        u_off=u_off,
        child_order=child_order,
        xnode_branch=xnode_branch,
        xnode_step=xnode_step,
        xnode_is_term=xnode_is_term,
        pred_x=pred_x,
        pred_u=pred_u,
        cnode_x=cnode_x,
        unode_branch=unode_branch,
        unode_step=unode_step,
        pred_uu=pred_uu,
        level_lo=tuple(level_lo),
        level_hi=tuple(level_hi),
    )
