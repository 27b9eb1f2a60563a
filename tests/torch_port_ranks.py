"""Rank functions of the port's multi-process tests (``tests/test_torch_parallel.py``,
``tests/test_torch_tree_shard.py``).

``parallel.launch.launch`` spawns each rank and imports its function by
module path, so the functions live here, in a module that imports torch and
the port only (no JAX: every rank would import it)."""

import numpy as np
import torch

from belief_planning_tpu_torch.models.policies import highway_policy_set
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.parallel.ensemble import (
    gather_rows,
    local_rows,
    make_mesh,
    make_sharded_cvar_ensemble_step,
    make_sharded_ensemble_step,
    make_sharded_ipm_ensemble_step,
    make_sharded_overtake_episode,
    shard_rows,
)
from belief_planning_tpu_torch.parallel.tree_shard import (
    LEVEL_KEYS,
    make_sharded_tree_kkt,
    split_ulevels,
)
from belief_planning_tpu_torch.presets import init_branch_mpc
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
from belief_planning_tpu_torch.solvers.tree_qp import build_stage_plan
from belief_planning_tpu_torch.solvers.tree_qp_pl import build_levels
from belief_planning_tpu_torch.tree.topology import build_topology
from belief_planning_tpu_torch.utils.config import BranchConstants

XT = np.array([0.5, 1.8, 15.0, 0.0])
N, NB, B, EP_STEPS = 3, 1, 8, 5
F64 = torch.float64


def overtake(N=N, NB=NB):
    """The small overtake of ``tests/test_parallel.py``: ``(cons, pset, model,
    params)``."""
    cons = BranchConstants()
    pset = highway_policy_set(cons, XT)
    model = highway_model(cons, pset, N=N, dt=0.1)
    params = init_branch_mpc(4, 2, N, NB, XT, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    return cons, pset, model, params


def ensemble_states(B=B, seed=0):
    """Batch-leading f64 states ``(xs, zs, xRefs)`` (CPU)."""
    rng = np.random.default_rng(seed)
    xs = np.tile([0.0, 1.8, 20.0, 0.0], (B, 1)) + 0.1 * rng.standard_normal((B, 4))
    zs = np.tile([9.0, 1.8, 17.0, 0.0], (B, 1)) + 0.1 * rng.standard_normal((B, 4))
    xRefs = np.tile([0.0, 1.8, 18.0, 0.0], (B, 1))
    return tuple(torch.as_tensor(a, dtype=F64) for a in (xs, zs, xRefs))


# the CVaR step at IPM-6 with 2 correctors, where the port and the JAX
# package agree to 7e-13 on these states; later iterates part as late IPM
# iterates do between any two implementations (the warm step's u by 3.8e-7
# at IPM-8 and 7.6e-3 at the default IPM-24, at nodes past the root)
CVAR_IPM = CVaRIPMConfig(iters=6, gondzio=2)
ENSEMBLES = {
    "admm": (make_sharded_ensemble_step, {}),
    "ipm": (make_sharded_ipm_ensemble_step, {}),
    "cvar": (make_sharded_cvar_ensemble_step, {"ipm": CVAR_IPM}),
}


def ensemble_rank(device):
    """Each sharded ensemble step, cold then warm, on this rank's rows of
    :func:`ensemble_states`; the sharded episode; the mesh's checks."""
    cons, pset, model, params = overtake()
    mesh = make_mesh((2,), ("dp",), device=device)
    local = shard_rows(mesh, ensemble_states())
    out = {"rows": (local_rows(mesh, B).start, local_rows(mesh, B).stop)}
    for name, (make, kw) in ENSEMBLES.items():
        _, init_batched, step = make(model, params, mesh, **kw)
        carrys = init_batched(B, F64)
        c1, u1, m1 = step(carrys, *local, pset.params)
        c2, u2, m2 = step(c1, *local, pset.params)
        out[name] = {"u": (u1, u2), "metrics": (m1, m2),
                     "u_gathered": (gather_rows(mesh, u1), gather_rows(mesh, u2)),
                     "carry_gathered": gather_rows(mesh, c2)}
    _, init_worlds, episode = make_sharded_overtake_episode(cons, model, params, mesh,
                                                            dtype=F64)
    w0 = init_worlds(B, seed=0)
    w1, traj, metrics = episode(w0, EP_STEPS, seed=1)
    out["episode"] = {"z0": w0.z, "traj": traj, "collided": w1.collided, "metrics": metrics}
    errors = {}
    for what, call in (("mesh_2x2", lambda: make_mesh((2, 2), ("dp", "mp"), device=device)),
                       ("odd_batch", lambda: init_batched(B - 1, F64))):
        try:
            call()
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors
    out["coords"] = mesh.coords
    return out


def tree_kkt_rank(device, blocks, dims, mesh_shapes):
    """The branch-sharded tree KKT on ``blocks`` (the whole tree's flat
    per-stage tensors) at each mesh shape: ``{shape: (mesh coords, shards,
    local dx/du blocks, gathered dx/du blocks)}``."""
    N_, NB_, m, n, d = dims
    plan = build_stage_plan(build_topology(N_, NB_, m, n, d))
    levels = build_levels(plan)
    bl = {k: split_ulevels(blocks[k], levels) for k in LEVEL_KEYS}
    bl["Pterm2"], bl["qterm"] = blocks["Pterm2"], blocks["qterm"]
    out = {}
    for shape in mesh_shapes:
        mesh = make_mesh(shape, ("dp", "mp"), device=device)
        solve = make_sharded_tree_kkt(plan, mesh)
        dx_l, du_l = solve(solve.shard(bl))
        out[shape] = {"coords": mesh.coords, "shards": solve.shards, "local": (dx_l, du_l),
                      "whole": solve.gather(dx_l, du_l)}
    return out


def failing_rank(device):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()
    return 0
