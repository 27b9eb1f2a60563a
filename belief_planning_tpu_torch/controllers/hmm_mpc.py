"""The HMM-belief LTV MPC controller (the reference package's
``controllers/hmm_mpc.py``): a chain LTV MPC over the belief-augmented
state ``xb = (x, b)`` with belief-gated collision rows, solved by the
tree-QP IPM or ADMM with per-stage override rows.

Kept from the reference:

- the LTV dynamics of stage i are linearized at the next node's state and
  input (``xLin[i+1], uLin[i+1]``), with the obstacles' states of step i;
- the collision rows of node t use the safety linearization of index t
  (taken at ``xLin[t+1]``) and are gated on the belief at ``xLin[t]``;
- the gate ``b > thres`` keeps all M·m rows, those below it masked (zero
  coefficients, bound ``_BIG``), so every tree has the same rows;
- ``Qf = 0`` by default and the quirk-free rate cost (``variant="robust"``).

:func:`make_hmm_mpc_step` is batched over a leading tree axis;
:func:`make_hmm_mpc_batched_step` is its IPM step with one ``xRef`` for all
trees, and :class:`HMMMPC` runs it on one tree.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from belief_planning_tpu_torch.controllers.robust_mpc import chain_state, lin_roll
from belief_planning_tpu_torch.models.hmm import HMMPredictiveModel
from belief_planning_tpu_torch.solvers.tree_qp import (
    ADMMConfig,
    admm_solve,
    assemble_stage_cost,
    build_stage_plan,
)
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig, qp_ipm_solve
from belief_planning_tpu_torch.tree.topology import build_topology
from belief_planning_tpu_torch.utils.config import MPCParams
from belief_planning_tpu_torch.utils.device import resolve_device

_BIG = 1e6


class HMMCarry(NamedTuple):
    uLin: Any         # (Bt, N, d)
    old_input: Any    # (Bt, d)


class HMMSolveResult(NamedTuple):
    xPred: Any        # (Bt, N+1, n_aug)
    uPred: Any        # (Bt, N, d)
    slack: Any        # (Bt, N, nFx + M·m)
    prim_res: Any     # (Bt,)
    feasible: Any     # (Bt,) bool


def make_hmm_mpc_step(model: HMMPredictiveModel, params: MPCParams,
                      admm: ADMMConfig = ADMMConfig(), thres: float = 0.1,
                      feas_tol: float = 1e-3, solver: str = "ipm",
                      ipm: QPIPMConfig = QPIPMConfig(), device=None):
    """Build ``(topo, init_carry(batch, dtype), step)``;
    ``step(carrys, x0s (Bt, nx), b0s (Bt, M, m), xbackups (Bt, N, M·m, nx),
    xRef) -> (carrys, HMMSolveResult)``, ``xRef`` of the augmented state,
    ``(n,)`` for all trees or ``(Bt, n)``. Solves with :func:`qp_ipm_solve`
    (``solver="ipm"``, warm-started at the rollout re-rolled through the
    linearized dynamics) or :func:`admm_solve` (``"admm"``). ``device``:
    ``None`` = ``"cuda"``; pass ``"cpu"`` to run on the CPU."""
    if solver not in ("ipm", "admm"):
        raise ValueError(f"unknown solver {solver!r}")
    dev = resolve_device(device)
    n_aug, nx, d, N = model.n, model.nx, params.d, params.N
    Mm = model.M * model.m
    topo = build_topology(N - 1, 1, 1, n_aug, d)       # a chain: N+1 states, N inputs
    plan = build_stage_plan(topo)
    assert topo.totalx == N + 1 and topo.totalu == N
    Fx, bx, Fu, bu = params.Fx, params.bx, params.Fu, params.bu
    nFx = Fx.shape[0]

    def init_carry(batch: int, dtype=torch.float32) -> HMMCarry:
        z = lambda *shape: torch.zeros((batch,) + shape, dtype=dtype, device=dev)
        return HMMCarry(uLin=z(N, d), old_input=z(d))

    def step(carrys: HMMCarry, x0s, b0s, xbackups, xRef):
        # profiler spans: bp.prep (rollout, linearization, rows, cost), bp.solve
        with record_function("bp.prep"):
            args = prep(carrys, x0s, b0s, xbackups, xRef)
        with record_function("bp.solve"):
            return solve(carrys, *args)

    def prep(carrys: HMMCarry, x0s, b0s, xbackups, xRef):
        dtype = x0s.dtype
        Bt = x0s.shape[0]
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        b0s, xbackups = as_t(b0s), as_t(xbackups)
        xRefs = as_t(xRef).expand(Bt, n_aug)
        uLin_ext = torch.cat([carrys.uLin, carrys.uLin[:, -1:]], dim=1)    # (Bt, N+1, d)
        xb0 = torch.cat([x0s, b0s.reshape(Bt, -1)], dim=-1)

        # the augmented chain's rollout (the reference's get_xLin)
        xs = [xb0]
        for i in range(N):
            xs.append(model.step(xs[-1], uLin_ext[:, i], xbackups[:, i]))
        xLin = torch.stack(xs, dim=1)                                       # (Bt, N+1, n_aug)

        # LTV at the shifted points (xLin[i+1], uLin[i+1], xbackup[i])
        A, B, C, h0s, Jhs = model.linearize(xLin[:, 1:], uLin_ext[:, 1:N + 1], xbackups)
        ts = chain_state(xLin, uLin_ext[:, :N], A, B, C)
        x_warm = lin_roll(xb0, A, B, C, uLin_ext[:, :N])

        # belief-gated collision rows of nodes 1..N−1
        Jh = Jhs.reshape(Bt, N, Mm, n_aug)
        h0 = h0s.reshape(Bt, N, Mm)
        gate = xLin[:, :N, nx:] > thres                                     # (Bt, N, M·m)
        gate[:, 0] = False
        rows = torch.where(gate[..., None], -Jh, torch.zeros_like(Jh))
        bnds = torch.where(gate, h0, torch.full_like(h0, _BIG))
        Fxc = torch.cat([as_t(Fx).expand(Bt, N, nFx, n_aug), rows], dim=2)
        b1 = torch.cat([as_t(bx).expand(Bt, N, nFx), bnds], dim=2)

        cost = assemble_stage_cost(topo, ts, params.Q, params.R, params.Qf, params.dR,
                                   params.Qslack, xRefs, carrys.old_input, variant="robust")
        return ts, cost, Fxc, b1, xb0, x_warm, uLin_ext[:, :N]

    def solve(carrys: HMMCarry, ts, cost, Fxc, b1, xb0, x_warm, u_warm):
        rows_args = (Fx, bx, Fu, bu, xb0, carrys.old_input)
        if solver == "ipm":
            x_nodes, u, s, info = qp_ipm_solve(plan, cost, ts, *rows_args, ipm,
                                               Fxc_override=Fxc, b1_override=b1,
                                               warm_primal=(x_warm, u_warm), device=dev)
        else:
            x_nodes, u, s, _, info = admm_solve(plan, cost, ts, *rows_args, admm,
                                                Fxc_override=Fxc, b1_override=b1, device=dev)
        new = HMMCarry(uLin=torch.cat([u[:, 1:], u[:, -1:]], dim=1), old_input=u[:, 0].clone())
        res = HMMSolveResult(xPred=x_nodes, uPred=u, slack=s, prim_res=info["prim_res"],
                             feasible=info["prim_res"] < feas_tol)
        return new, res

    return topo, init_carry, step


def make_hmm_mpc_batched_step(model: HMMPredictiveModel, params: MPCParams,
                              thres: float = 0.1, feas_tol: float = 1e-3,
                              ipm: QPIPMConfig = QPIPMConfig(), device=None):
    """The batched HMM-belief step on the IPM: ``(topo, init_batched(B,
    dtype), bstep)`` with ``bstep(carrys, x0s, b0s, xbackups, xRef)`` over
    batch-leading tensors and one ``xRef (n,)`` for all trees. The HMM
    program is a chain with per-stage override rows, so it runs on the
    per-tree IPM rather than the fused iteration, as in the reference."""
    return make_hmm_mpc_step(model, params, thres=thres, feas_tol=feas_tol, solver="ipm",
                             ipm=ipm, device=device)


class HMMMPC:
    """One tree's HMM controller with the reference's API:
    ``solve(x0, b0, xbackup, xRef)`` (an ``xRef`` of the plain state is
    zero-padded over the belief) returns the applied input and keeps
    ``uPred``, ``xPred`` (numpy) and ``feasible``. ``device``: ``None`` =
    ``"cuda"``; pass ``"cpu"`` to run on the CPU."""

    def __init__(self, mpcParameters: MPCParams, predictiveModel: HMMPredictiveModel,
                 admm: ADMMConfig = ADMMConfig(), dtype=torch.float64, solver: str = "ipm",
                 ipm: QPIPMConfig = QPIPMConfig(), device=None):
        self.params = mpcParameters
        self.model = predictiveModel
        self.dtype = dtype
        self.device = resolve_device(device)
        self.topo, self._init_carry, self._step = make_hmm_mpc_step(
            predictiveModel, mpcParameters, admm, solver=solver, ipm=ipm, device=self.device)
        self.carry = self._init_carry(1, dtype)
        self.N = mpcParameters.N
        self.xPred = None
        self.uPred = None
        self.feasible = 1

    @property
    def predictiveModel(self):
        return self.model

    def solve(self, x0, b0, xbackup, xRef=None):
        if xRef is None:
            xRef = self.params.xRef
        xRef = np.asarray(xRef, float)
        if xRef.shape[0] == self.model.nx:
            xRef = np.append(xRef, np.zeros(self.model.M * self.model.m))
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                                      device=self.device)[None]
        self.carry, res = self._step(self.carry, t(x0), t(b0), t(xbackup), t(xRef)[0])
        self.xPred = res.xPred[0].detach().cpu().numpy()
        self.uPred = res.uPred[0].detach().cpu().numpy()
        self.feasible = int(res.feasible[0])
        return self.uPred[0]
