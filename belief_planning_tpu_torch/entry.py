"""The driver's entry points (the JAX package's ``__graft_entry__.py``).

:func:`entry` is the entry step (the reference's ``entry``):
one batched receding-horizon step of the flagship configuration, the
3-policy highway overtake branch-MPC at N=8, NB=2, and its example
arguments.

As in the reference, the step is built with the flagship's ADMM config
(ρ=5, 50 iterations at fixed ρ, 10 polish iterations) but with
``make_branch_mpc_step``'s default solver, the IPM (``QPIPMConfig()``),
so the two entries compute the same function. The ADMM step itself is
``make_branch_mpc_step(..., solver="admm", admm=flagship()[3])``.

Run: ``fn, args = entry(); u = fn(*args)`` (on the card; ``entry("cpu")``
on the CPU).

:func:`dryrun_multichip` runs the flagship's sharded ensembles and the
branch-sharded tree KKT over several ranks of ``torch.distributed``:
``dryrun_multichip(2, "gloo", "cuda:0")`` puts two ranks on one card,
``dryrun_multichip(2, "gloo", "cpu")`` runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_step
from belief_planning_tpu_torch.models.policies import highway_policy_set
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.presets import init_branch_mpc
from belief_planning_tpu_torch.solvers.tree_qp import ADMMConfig
from belief_planning_tpu_torch.utils.config import BranchConstants
from belief_planning_tpu_torch.utils.device import resolve_device

ENTRY_B = 4


def flagship(N=8, NB=2, iters=50, polish=10):
    """``(model, params, pset, admm)`` of the flagship overtake."""
    cons = BranchConstants()
    xRef = np.array([0.5, 1.8, 15.0, 0.0])
    pset = highway_policy_set(cons, xRef)
    model = highway_model(cons, pset, N=N, dt=0.1)
    params = init_branch_mpc(4, 2, N, NB, xRef, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    admm = ADMMConfig(rho=5.0, iters=iters, rho_update_every=0, polish_iters=polish)
    return model, params, pset, admm


def entry(device=None):
    """``(fn, example_args)``: ``fn(carrys, xs, zs, xRefs)`` runs one step
    for a batch of trees and returns ``uPred (B, totalu, 2)``; the example
    is B=4 identical trees in f32 on ``device`` (``None`` = ``"cuda"``)."""
    dev = resolve_device(device)
    model, params, pset, admm = flagship()
    _, init_carry, step = make_branch_mpc_step(model, params, "prox", admm=admm, device=dev)
    dtype = torch.float32
    tile = lambda row: torch.as_tensor(np.tile(row, (ENTRY_B, 1)), dtype=dtype, device=dev)
    carrys = init_carry(ENTRY_B, dtype)
    xs = tile([0.0, 1.8, 20.0, 0.0])
    zs = tile([12.0, 1.8, 17.0, 0.0])
    xRefs = tile([0.0, 1.8, 18.0, 0.0])

    def fn(carrys, xs, zs, xRefs):
        _, res = step(carrys, xs, zs, xRefs, pset.params)
        return res.uPred

    return fn, (carrys, xs, zs, xRefs)


def _kkt_case(params, model, dtype, T=8, seed=1):
    """The reference dryrun's random tree-KKT blocks (``__graft_entry__.py:
    140-162``) on the flagship tree, batch-last, on the CPU."""
    from belief_planning_tpu_torch.solvers.tree_qp import build_stage_plan
    from belief_planning_tpu_torch.tree.topology import build_topology

    topo = build_topology(params.N, params.NB, model.m, params.n, params.d)
    n, d, tu, nl = topo.n, topo.d, topo.totalu, model.m ** params.NB
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype)

    def sym(shape, dim, shift):
        M = rng.normal(0, 0.1, shape)
        return t(0.5 * (M + np.swapaxes(M, -3, -2)) + shift * np.eye(dim)[:, :, None])

    bl = dict(
        Qx2=sym((tu, n, n, T), n, 2.0), Ru2=sym((tu, d, d, T), d, 1.0),
        Dab2=t(rng.normal(0, 0.05, (tu, d, d, T))),
        A=t(np.eye(n)[:, :, None] + rng.normal(0, 0.1, (tu, n, n, T))),
        B=t(rng.normal(0, 0.3, (tu, n, d, T))),
        qx=t(rng.normal(0, 1.0, (tu, n, T))),
        qu=t(rng.normal(0, 1.0, (tu, d, T))),
        Pterm2=sym((nl, n, n, T), n, 2.0),
        qterm=t(rng.normal(0, 1.0, (nl, n, T))),
    )
    return build_stage_plan(topo), bl


def _check(cond, what):
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_rank(device, n_devices: int) -> dict:
    """One rank of :func:`dryrun_multichip`: the mesh, then (a) the sharded
    IPM ensemble, (b) the sharded CVaR ensemble, (c) the branch-sharded tree
    KKT where the mesh has an "mp" axis. Returns the rank's report, with
    K1's and K2's launches in this process."""
    from belief_planning_tpu_torch.parallel.ensemble import (
        make_mesh,
        make_sharded_cvar_ensemble_step,
        make_sharded_ipm_ensemble_step,
        shard_rows,
    )
    from belief_planning_tpu_torch.solvers import cvar_pl, tree_qp_pl
    from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig

    tree_qp_pl.KERNEL.launches = 0
    cvar_pl.KERNEL.launches = 0
    model, params, pset, _ = flagship()
    if n_devices % 2 == 0 and n_devices > 2:
        mesh = make_mesh((n_devices // 2, 2), ("dp", "mp"), device=device)
    else:
        mesh = make_mesh((n_devices,), ("dp",), device=device)
    dtype = torch.float32
    B = mesh.size * 2                            # two trees a rank
    rng = np.random.default_rng(0)
    tile = lambda row: np.tile(row, (B, 1))
    xs, zs, xRefs = (torch.as_tensor(a, dtype=dtype) for a in (
        tile([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.1, (B, 4)),
        tile([10.0, 1.8, 17.0, 0.0]), tile([0.0, 1.8, 18.0, 0.0])))
    xs, zs, xRefs = shard_rows(mesh, (xs, zs, xRefs))
    report = {"rank": mesh.rank, "mesh": mesh.shape, "device": str(mesh.device),
              "backend": torch.distributed.get_backend()}

    # (a) the QP ensemble on the fused IPM iteration (K1), a cold and a warm step
    topo, init_batched, step = make_sharded_ipm_ensemble_step(model, params, mesh, "prox")
    carrys = init_batched(B, dtype)
    carrys, u, metrics = step(carrys, xs, zs, xRefs, pset.params)
    carrys, u, metrics = step(carrys, xs, zs, xRefs, pset.params)
    _check(tuple(u.shape) == (2, topo.totalu, 2), f"uPred shape {tuple(u.shape)}")
    _check(float(metrics["feasible_frac"]) >= 0.0, "feasible_frac < 0")
    _check(bool(u.isfinite().all()), "non-finite QP uPred")
    report["ipm"] = {"uPred_shape": list(u.shape), **{k: float(v) for k, v in metrics.items()}}

    # (b) the CVaR ensemble on the fused CVaR iteration (K2), reduced iterations
    ctopo, cinit, cstep = make_sharded_cvar_ensemble_step(
        model, params, mesh, ralpha=0.9, ipm=CVaRIPMConfig(iters=6, gondzio=1))
    ccarrys = cinit(B, dtype)
    ccarrys, cu, cmetrics = cstep(ccarrys, xs, zs, xRefs, pset.params)
    ccarrys, cu, cmetrics = cstep(ccarrys, xs, zs, xRefs, pset.params)
    _check(tuple(cu.shape) == (2, ctopo.totalu, 2), f"CVaR uPred shape {tuple(cu.shape)}")
    _check(bool(cu.isfinite().all()), "non-finite CVaR uPred")
    report["cvar"] = {"uPred_shape": list(cu.shape), **{k: float(v) for k, v in cmetrics.items()}}

    # (c) the branch-sharded tree KKT over "mp"
    if "mp" in mesh.axis_names:
        from belief_planning_tpu_torch.parallel.tree_shard import (
            LEVEL_KEYS,
            make_sharded_tree_kkt,
            split_ulevels,
        )
        from belief_planning_tpu_torch.solvers.tree_qp_pl import build_levels

        plan, bl = _kkt_case(params, model, dtype)
        levels = build_levels(plan)
        solve = make_sharded_tree_kkt(plan, mesh)
        blocks = {k: split_ulevels(bl[k], levels) for k in LEVEL_KEYS}
        blocks["Pterm2"], blocks["qterm"] = bl["Pterm2"], bl["qterm"]
        dx_l, du_l = solve(solve.shard(blocks))
        _check(all(bool(b.isfinite().all()) for b in du_l), "non-finite tree-KKT du")
        report["tree_kkt"] = {"shards": solve.shards,
                              "du_shapes": [list(b.shape) for b in du_l]}
    report["launches"] = {"tree_qp_ipm_iter": tree_qp_pl.KERNEL.launches,
                          "cvar_ipm_iter": cvar_pl.KERNEL.launches}
    return report


def dryrun_multichip(n_devices: int, backend: str = "gloo", device=None) -> list:
    """The JAX package's ``dryrun_multichip`` over ``n_devices`` ranks
    (``parallel.launch.launch``): each rank builds the mesh, ``(n/2, 2)`` on
    ("dp", "mp") when n is even and above 2, else ``(n,)`` on ("dp",), and
    runs :func:`dryrun_rank`: the flagship (N=8, NB=2) QP ensemble on the
    fused IPM iteration (IPM-8 with 2 correctors), the CVaR ensemble at
    ``CVaRIPMConfig(iters=6, gondzio=1)``, two trees a rank, a cold and a
    warm step each, in f32, and the branch-sharded tree KKT on random blocks
    where the mesh has "mp". It checks shapes, finite values and
    ``feasible_frac`` ≥ 0, and raises if a rank fails.

    ``backend``: ``"gloo"`` or ``"nccl"``; ``device``: ``None`` puts rank r
    on ``cuda:r``, an explicit device (``"cuda:0"``, ``"cpu"``) every rank
    on it. Returns the ranks' reports, each with its backend and device."""
    from belief_planning_tpu_torch.parallel.launch import launch

    return launch(dryrun_rank, n_devices, backend, device, args=(n_devices,))
