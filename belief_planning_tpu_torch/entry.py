"""The entry step (the JAX package's ``__graft_entry__.entry``):
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
