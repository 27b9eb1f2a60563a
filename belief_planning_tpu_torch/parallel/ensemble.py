"""Scale-out: batched and rank-sharded branch-MPC ensembles (the reference
package's ``parallel/ensemble.py``).

The unit of scaling is the scenario tree: per-tree math is tiny, so
throughput comes from batching thousands of independent trees a step and
splitting that batch over ranks. The JAX package splits it over a device
mesh with ``shard_map`` and reduces the ensemble metrics with
``psum``/``pmax``; here every rank is a process of a ``torch.distributed``
group (started by ``parallel.launch.launch``), holds a contiguous block of
the batch, and reduces the metrics with ``all_reduce`` over the whole group.

Row layout: rank r of a world of W ranks holds rows ``[r·B/W, (r+1)·B/W)``
of a batch of B trees. The rank is the mesh coordinate flattened row-major
over the axes (``("dp", "mp")``), the order in which the reference's
``P(axes)`` splits the batch. B must be a multiple of W, as ``shard_map``
requires. A sharded step takes the rank's rows and returns the rank's new
carry and ``uPred``; only its metrics are global, and equal on every rank.
:func:`shard_rows` cuts a rank's block out of a global batch and
:func:`gather_rows` puts the blocks back together.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map_only

from belief_planning_tpu_torch.controllers.branch_mpc import (
    make_branch_mpc_batched_step,
    make_branch_mpc_step,
)
from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_batched_step
from belief_planning_tpu_torch.envs.batched_highway import draw_obstacles, make_batched_overtake_fused
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
from belief_planning_tpu_torch.solvers.tree_qp import ADMMConfig
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig
from belief_planning_tpu_torch.utils.device import resolve_device

@dataclass(frozen=True)
class Mesh:
    """A rank's place on named axes: its coordinate on each (the rank
    flattened row-major), a process group for each axis (the ranks that
    share every other coordinate, in coordinate order) and its device."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    coords: Tuple[int, ...]
    groups: Dict[str, Any]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]


def make_mesh(axis_sizes: Tuple[int, ...], axis_names: Tuple[str, ...] = ("dp", "mp"),
              device=None) -> Mesh:
    """Lay the ranks of the default process group out on ``axis_names``.
    Every rank must call it, with the same arguments: it builds a group for
    each line of ranks along each axis (``dist.new_group``). The world size
    must equal the product of ``axis_sizes``. ``device``: ``None`` = the
    current CUDA device (raises without CUDA); pass ``"cpu"`` for the CPU."""
    axis_sizes = tuple(int(s) for s in axis_sizes)
    axis_names = tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"make_mesh: {len(axis_sizes)} axis sizes for axes {axis_names}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; run under parallel.launch.launch")
    world = dist.get_world_size()
    if world != int(np.prod(axis_sizes)):
        raise ValueError(f"make_mesh: world size {world} is not the mesh's "
                         f"{' × '.join(map(str, axis_sizes))} = {int(np.prod(axis_sizes))}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    grid = np.arange(world).reshape(axis_sizes)
    coords = tuple(int(c) for c in np.unravel_index(rank, axis_sizes))
    groups = {}
    for a, name in enumerate(axis_names):
        lines = np.moveaxis(grid, a, -1).reshape(-1, axis_sizes[a])
        for line in lines:                      # every rank builds every group
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    return Mesh(axis_names, axis_sizes, rank, coords, groups, dev)


def local_rows(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch`` trees."""
    if batch % mesh.size:
        raise ValueError(f"batch {batch} is not a multiple of the mesh's {mesh.size} ranks")
    loc = batch // mesh.size
    return slice(mesh.rank * loc, (mesh.rank + 1) * loc)


def shard_rows(mesh: Mesh, tree):
    """This rank's contiguous block of every batch-leading tensor of
    ``tree`` (all of one batch size), on the mesh's device."""
    def cut(t):
        return t[local_rows(mesh, t.shape[0])].to(mesh.device)
    return tree_map_only(torch.Tensor, cut, tree)


def all_gather(t, group=None):
    """``t`` of every rank of ``group`` (default: all ranks), in rank order.
    Gloo gathers a CUDA tensor through host memory (its collectives on CUDA
    tensors cover ``all_reduce`` and ``broadcast``); NCCL on the card."""
    via_host = t.is_cuda and dist.get_backend(group) == "gloo"
    src = t.detach().contiguous()
    if via_host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if via_host else parts


def gather_rows(mesh: Mesh, tree):
    """Every rank's block of each batch-leading tensor of ``tree``,
    concatenated in rank order (:func:`all_gather` over the whole group)."""
    return tree_map_only(torch.Tensor, lambda t: torch.cat(all_gather(t), dim=0), tree)


def ensemble_metrics(mesh: Mesh, feasible, res, worst_name: str = "worst_res"):
    """``feasible_frac`` (the feasible trees over the trees, all ranks) and
    the worst residual over all ranks, the same on every rank."""
    sums = torch.stack([feasible.sum().to(torch.float64),
                        torch.tensor(float(feasible.numel()), dtype=torch.float64,
                                     device=feasible.device)])
    dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    worst = res.max().reshape(1).clone()
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return {"feasible_frac": sums[0] / sums[1], worst_name: worst[0]}


def make_batched_step(model, params, variant="prox", admm: ADMMConfig = ADMMConfig(),
                      device=None):
    """The one-process ensemble step: ``(topo, init_batched(batch, dtype),
    step)``, ``step(carrys, xs, zs, xRefs, policy_params) -> (carrys,
    SolveResult)`` over batch-leading tensors.

    As in the reference, ``admm`` goes to ``make_branch_mpc_step`` but its
    ``solver`` stays at the default, so each tree is solved by the IPM
    (``QPIPMConfig()``) and the ADMM config is not read."""
    return make_branch_mpc_step(model, params, variant, admm=admm, device=device)


def _shard_ensemble(mesh: Mesh, init_carry, bstep, feas_of, res_of, worst_name="worst_res"):
    """A batched controller step over this rank's rows, with the ensemble
    metrics reduced over every rank. Returns ``(init_batched(batch, dtype),
    sharded_step)``; ``init_batched`` makes this rank's carries of a
    ``batch``-tree ensemble; keyword arguments of ``sharded_step`` go to the
    step."""
    def init_batched(batch: int, dtype=torch.float32):
        rows = local_rows(mesh, batch)
        return init_carry(rows.stop - rows.start, dtype)

    def sharded_step(carrys, xs, zs, xRefs, policy_params, **step_kw):
        carrys, res = bstep(carrys, xs, zs, xRefs, policy_params, **step_kw)
        metrics = ensemble_metrics(mesh, feas_of(res), res_of(res), worst_name)
        return carrys, res.uPred, metrics

    return init_batched, sharded_step


def make_sharded_ensemble_step(model, params, mesh: Mesh, variant="prox",
                               admm: ADMMConfig = ADMMConfig()):
    """:func:`make_batched_step` over this rank's rows, on the mesh's device;
    metrics ``feasible_frac`` and ``worst_prim_res``. Returns ``(topo,
    init_batched, sharded_step)``, ``sharded_step(carrys, xs, zs, xRefs,
    policy_params) -> (carrys, uPred, metrics)``."""
    topo, init_carry, step = make_batched_step(model, params, variant, admm, device=mesh.device)
    init_batched, sharded = _shard_ensemble(mesh, init_carry, step, lambda r: r.feasible,
                                            lambda r: r.prim_res, "worst_prim_res")
    return topo, init_batched, sharded


def make_sharded_ipm_ensemble_step(model, params, mesh: Mesh, variant="prox", ipm=None):
    """The main path's QP step (``make_branch_mpc_batched_step``: the fused
    IPM iteration, the CUDA kernel on the card, its plain version on the
    CPU) over this rank's rows; default ``QPIPMConfig(iters=8, gondzio=2)``.
    Metrics ``feasible_frac`` and ``worst_res`` (the primal residual)."""
    ipm = ipm if ipm is not None else QPIPMConfig(iters=8, gondzio=2)
    topo, init_carry, bstep = make_branch_mpc_batched_step(model, params, variant, ipm=ipm,
                                                           device=mesh.device)
    init_batched, sharded = _shard_ensemble(mesh, init_carry, bstep, lambda r: r.feasible,
                                            lambda r: r.prim_res)
    return topo, init_batched, sharded


def make_sharded_cvar_ensemble_step(model, params, mesh: Mesh, ralpha=0.9, ipm=None,
                                    use_S=False):
    """The CVaR step (``make_cvar_mpc_batched_step``: the fused CVaR
    iteration, the CUDA kernel on the card) over this rank's rows; default
    ``CVaRIPMConfig(iters=24, gondzio=2)``. A tree counts as feasible when
    its gap is below 1; ``worst_res`` is the largest gap. With ``use_S``
    (the merge), the step also takes this rank's rows of the per-lane
    transform and bounds: ``sharded_step(..., S=S, bx=bx)``."""
    ipm = ipm if ipm is not None else CVaRIPMConfig(iters=24, gondzio=2)
    topo, _, init_carry, bstep = make_cvar_mpc_batched_step(model, params, ralpha, ipm=ipm,
                                                            use_S=use_S, device=mesh.device)
    init_batched, sharded = _shard_ensemble(mesh, init_carry, bstep, lambda r: r.gap < 1.0,
                                            lambda r: r.gap)
    return topo, init_batched, sharded


def rank_seed(seed: int, mesh: Mesh) -> int:
    """The seed of this rank's draws in a sharded episode: ``seed · W +
    rank`` for a world of W ranks, distinct for every (seed, rank)."""
    return seed * mesh.size + mesh.rank


def make_sharded_overtake_episode(cons, model, params, mesh: Mesh, variant="prox", ipm=None,
                                  N_lane=4, dtype=torch.float32):
    """Closed-loop overtake episodes (``envs/batched_highway.
    make_batched_overtake_fused``, K1 on the card) over this rank's worlds.
    Worlds are independent, so a world step needs no communication; the
    metrics are reduced once, at the end of the episode.

    Returns ``(topo, init_worlds, episode_sharded)``:

    - ``init_worlds(B, seed=0)``: this rank's rows of the B worlds whose
      obstacles ``draw_obstacles`` draws from a generator seeded with
      ``seed`` (the same B worlds at any world size);
    - ``episode_sharded(worlds, n_steps, seed=0, t0=0) -> (worlds, traj,
      metrics)``: the rank's lane-intent draws are uniforms from a CPU
      ``torch.Generator`` seeded with :func:`rank_seed` (``seed · W +
      rank``), as ``episode(..., seed=rank_seed(seed, mesh))`` draws them,
      so ranks draw different streams and a rank's episode equals the
      one-process episode on its worlds with that seed. ``metrics``:
      ``feasible_frac`` (feasible world steps over all ranks' world
      steps), ``collided`` (worlds that collided) and ``count`` (world
      steps), each summed over the ranks.
    """
    ipm = ipm if ipm is not None else QPIPMConfig(iters=8, gondzio=2)
    topo, init_local, episode = make_batched_overtake_fused(
        cons, model, params, variant, ipm=ipm, N_lane=N_lane, dtype=dtype, device=mesh.device)

    def init_worlds(B: int, seed: int = 0):
        rows = local_rows(mesh, B)
        z0 = draw_obstacles(B, torch.Generator().manual_seed(seed))
        return init_local(rows.stop - rows.start, z0=z0[rows])

    def episode_sharded(worlds, n_steps: int, seed: int = 0, t0: int = 0):
        worlds, traj = episode(worlds, n_steps, seed=rank_seed(seed, mesh), t0=t0)
        sums = torch.stack([traj["feasible"].sum().to(torch.float64),
                            worlds.collided.sum().to(torch.float64),
                            torch.tensor(float(traj["feasible"].numel()), dtype=torch.float64,
                                         device=worlds.x.device)])
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        metrics = {"feasible_frac": sums[0] / sums[2], "collided": sums[1], "count": sums[2]}
        return worlds, traj, metrics

    return topo, init_worlds, episode_sharded
