"""In-tree branch-axis sharding: tree-Riccati KKT solves over the ranks of
an "mp" axis (the reference package's ``parallel/tree_shard.py``).

The ensembles (``parallel/ensemble.py``) split a batch of independent trees
over ranks. This module splits one tree: the branch axis of each tree level
is distributed over the "mp" axis of a :class:`~parallel.ensemble.Mesh`, so
a single wide tree (e.g. m=4, NB=5: 1,024 leaf branches) is factored across
ranks, while the batch axis T (last) is split over "dp".

- Backward (factor and linear) sweeps: children fold into their parent by a
  sum over each parent's m children. Levels are branch-major (the children
  of one parent contiguous), so while both levels are sharded the fold is
  local. Crossing from the last sharded level into a replicated one is one
  ``all_gather`` over the "mp" group, in rank order, of the per-branch
  heads; ``_fold0`` then runs on the whole level, in the unsharded order.
- Forward sweep: the parent's state repeats to its children; entering a
  sharded level each rank keeps its own branch block, with no
  communication.

A level is sharded iff mp divides its branch count (the root only when mp
is 1). Replicated levels are computed on every rank of an mp group. Every
element goes through the ops of the unsharded level-blocked sweeps
(``solvers/tree_qp_pl._factor_blocks``, ``_linear_blocks``,
``_forward_blocks``) in the same order, so on the CPU the results are
bit-identical. On a CUDA device the batched small products (through
cuBLAS) may round a batch of another count differently, and the results
part by a few ulps (2.0e-15 on the m=4, NB=5 tree at T=256).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from belief_planning_tpu_torch.parallel.ensemble import Mesh, all_gather
from belief_planning_tpu_torch.solvers.tree_qp import StagePlan
from belief_planning_tpu_torch.solvers.tree_qp_pl import (
    LevelMeta,
    _fold0,
    _mtv,
    _mv,
    _repeat0,
    _riccati_step,
    _ublk,
    build_levels,
)

LEVEL_KEYS = ("Qx2", "Dab2", "Ru2", "A", "B", "qx", "qu")
LEAF_KEYS = ("Pterm2", "qterm")


def level_sharding(levels: Sequence[LevelMeta], mp_size: int) -> List[bool]:
    """A level is branch-sharded iff mp divides its branch count."""
    return [mt.nb >= mp_size and mt.nb % mp_size == 0 for mt in levels]


def split_ulevels(flat, levels):
    """Flat per-stage tensor ``(totalu, ..., T)`` → per-level ``(nb, l, ..., T)``."""
    return [_ublk(flat, mt) for mt in levels]


class _Comms:
    """Level crossings, shard-aware. Each method takes the CHILD level index
    k (the crossing between level k and its parent level k − 1)."""

    def __init__(self, shards: List[bool], m: int, group, mp_size: int, mp_index: int):
        self.shards = shards
        self.m = m
        self.group = group
        self.mp_size = mp_size
        self.mp_index = mp_index

    def fold_up(self, a, k: int):
        """Sum each parent's m children: child level k → parent level k − 1.
        ``a`` is ``(nb_local, ..., T)`` on sharded levels, ``(nb, ..., T)``
        otherwise."""
        if self.shards[k] and not self.shards[k - 1]:
            a = torch.cat(all_gather(a, self.group), dim=0)
        return _fold0(a, self.m)

    def repeat_down(self, xi, k: int):
        """Parent level k − 1's state → child level k (repeated to the m
        children, then this rank's branch block when entering a sharded
        level)."""
        full = _repeat0(xi, self.m)
        if self.shards[k] and not self.shards[k - 1]:
            loc = full.shape[0] // self.mp_size
            full = full[self.mp_index * loc:(self.mp_index + 1) * loc]
        return full


def _factor_local(levels, comms, Qx2_l, Dab2_l, Ru2_l, Pterm2, A_l, B_l, n, d):
    """Backward quadratic sweep on local blocks (``_factor_blocks`` with
    shard-aware level crossings)."""
    NB = len(levels) - 1
    K_l, Hinv_l, Acl_l = [None] * (NB + 1), [None] * (NB + 1), [None] * (NB + 1)
    W = None
    for k in range(NB, -1, -1):
        mt = levels[k]
        if k == NB:
            W = Pterm2.new_zeros((Pterm2.shape[0], n + d, n + d, Pterm2.shape[-1]))
            W[:, :n, :n] = Pterm2
        else:
            W = comms.fold_up(W, k + 1)
        Ks, His, Acls = [], [], []
        for j in range(mt.l - 1, -1, -1):
            W, K, Hinv, Acl = _riccati_step(W, Qx2_l[k][:, j], Dab2_l[k][:, j], Ru2_l[k][:, j],
                                            A_l[k][:, j], B_l[k][:, j], n)
            Ks.append(K)
            His.append(Hinv)
            Acls.append(Acl)
        K_l[k] = torch.stack(Ks[::-1], dim=1)
        Hinv_l[k] = torch.stack(His[::-1], dim=1)
        Acl_l[k] = torch.stack(Acls[::-1], dim=1)
    return K_l, Hinv_l, Acl_l


def _linear_local(levels, comms, K_l, Hinv_l, Acl_l, B_l, qx_l, qu_l, qterm, n, d):
    """Backward linear sweep on local blocks; feed-forward blocks kff."""
    NB = len(levels) - 1
    kff_l = [None] * (NB + 1)
    p = None
    for k in range(NB, -1, -1):
        mt = levels[k]
        if k == NB:
            p = torch.cat([qterm, qterm.new_zeros((qterm.shape[0], d, qterm.shape[-1]))], dim=1)
        else:
            p = comms.fold_up(p, k + 1)
        kffs = []
        for j in range(mt.l - 1, -1, -1):
            l_u = qu_l[k][:, j] + _mtv(B_l[k][:, j], p[:, :n]) + p[:, n:]
            kffs.append(-_mv(Hinv_l[k][:, j], l_u))
            p = _mtv(Acl_l[k][:, j], p) + _mtv(K_l[k][:, j], qu_l[k][:, j])
            p[:, :n] += qx_l[k][:, j]
        kff_l[k] = torch.stack(kffs[::-1], dim=1)
    return kff_l


def _forward_local(levels, comms, K_l, Acl_l, B_l, kff_l, n, d, T):
    """Forward rollout from a zero root state; per-level dx ``(nb_loc, lx,
    n, T)`` and du ``(nb_loc, l, d, T)`` blocks."""
    xi = B_l[0].new_zeros((1, n + d, T))
    dx_l, du_l = [], []
    for k, mt in enumerate(levels):
        if k > 0:
            xi = comms.repeat_down(xi, k)
        us, xs = [], []
        for j in range(mt.l):
            kf = kff_l[k][:, j]
            us.append(_mv(K_l[k][:, j], xi) + kf)
            xs.append(xi[:, :n])
            xi = _mv(Acl_l[k][:, j], xi) + torch.cat([_mv(B_l[k][:, j], kf), kf], dim=1)
        if mt.leaf:
            xs.append(xi[:, :n])
        du_l.append(torch.stack(us, dim=1))
        dx_l.append(torch.stack(xs, dim=1))
    return dx_l, du_l


def make_sharded_tree_kkt(plan: StagePlan, mesh: Mesh, reg: float = 0.0,
                          dp_axis: str = "dp", mp_axis: str = "mp"):
    """Branch-sharded tree-Riccati KKT solve over ``mesh``.

    Returns ``solve(blocks) -> (dx_levels, du_levels)`` on this rank's
    blocks: a dict of per-level lists as :func:`split_ulevels` makes them,
    keys Qx2, Dab2, Ru2, A, B, qx, qu of shapes ``(nb_k, l_k, ..., T)``,
    plus the leaf level's Pterm2 ``(n_leaves, n, n, T)`` and qterm
    ``(n_leaves, n, T)``, each cut to this rank's T block (over
    ``dp_axis``) and, on sharded levels, branch block (over ``mp_axis``).
    ``solve.shard(blocks)`` cuts them out of the whole tree's blocks;
    ``solve.gather(dx_levels, du_levels)`` puts the ranks' results back
    together (every rank gets the whole). ``solve.shards``: which levels are
    sharded. ``reg`` is not read, as in the reference (its Riccati step
    takes and ignores it): the KKT solves are pure linear responses.
    """
    del reg
    for ax in (dp_axis, mp_axis):
        if ax not in mesh.axis_names:
            raise ValueError(f"make_sharded_tree_kkt: the mesh has no {ax!r} axis "
                             f"({mesh.axis_names})")
    topo = plan.topo
    n, d, m = topo.n, topo.d, topo.m
    levels = build_levels(plan)
    mp_size, dp_size = mesh.shape[mp_axis], mesh.shape[dp_axis]
    mp_index, dp_index = mesh.axis_index(mp_axis), mesh.axis_index(dp_axis)
    shards = level_sharding(levels, mp_size)
    comms = _Comms(shards, m, mesh.groups[mp_axis], mp_size, mp_index)

    def cut(t, sharded):
        T = t.shape[-1]
        if T % dp_size:
            raise ValueError(f"tree KKT: batch T={T} is not a multiple of dp={dp_size}")
        tl = T // dp_size
        t = t[..., dp_index * tl:(dp_index + 1) * tl]
        if sharded:
            bl = t.shape[0] // mp_size
            t = t[mp_index * bl:(mp_index + 1) * bl]
        return t.contiguous().to(mesh.device)

    def shard(blocks):
        out = {k: [cut(b, sh) for b, sh in zip(blocks[k], shards)] for k in LEVEL_KEYS}
        out.update({k: cut(blocks[k], shards[-1]) for k in LEAF_KEYS})
        return out

    def gather(dx_l, du_l):
        def whole(t, sharded):
            if dp_size > 1:
                t = torch.cat(all_gather(t, mesh.groups[dp_axis]), dim=-1)
            if sharded and mp_size > 1:
                t = torch.cat(all_gather(t, mesh.groups[mp_axis]), dim=0)
            return t
        return ([whole(t, sh) for t, sh in zip(dx_l, shards)],
                [whole(t, sh) for t, sh in zip(du_l, shards)])

    def solve(blocks):
        T = blocks["A"][0].shape[-1]
        K_l, Hinv_l, Acl_l = _factor_local(levels, comms, blocks["Qx2"], blocks["Dab2"],
                                           blocks["Ru2"], blocks["Pterm2"], blocks["A"],
                                           blocks["B"], n, d)
        kff_l = _linear_local(levels, comms, K_l, Hinv_l, Acl_l, blocks["B"], blocks["qx"],
                              blocks["qu"], blocks["qterm"], n, d)
        return _forward_local(levels, comms, K_l, Acl_l, blocks["B"], kff_l, n, d, T)

    solve.shard = shard
    solve.gather = gather
    solve.shards = shards
    return solve
