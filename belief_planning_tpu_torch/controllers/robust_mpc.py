"""The robust benchmark controller (the reference package's
``controllers/robust_mpc.py``, the reference's ``robustMPC``).

One ego trajectory of ``Nx = N·NB + 2`` states must avoid every branch of
the obstacle's scenario tree at once: the tree carries only the obstacle's
rollouts, and each time step t gets one linearized collision row per
obstacle node alive at t. The ego's chain is the degenerate tree (a root
and one branch of N·NB stages) solved by the tree-QP IPM or ADMM with
per-stage override rows, padded to the m^NB scenarios of the deepest step
(a padded row has zero coefficients and the bound ``_BIG``).

Kept from the reference: the linearization runs along the previous
prediction shifted by one (a zero-input rollout from the measured state on
the first solve); the cost is the quirk-free rate cost with the old input
(``variant="robust"``); every state row has a slack. As in the JAX
package, the terminal state's box rows are dropped, and the warm iterate is
rolled through the new linearized dynamics from the measured state.

:func:`make_robust_mpc_step` is batched over a leading tree axis;
:class:`RobustMPC` runs it on one tree.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from belief_planning_tpu_torch.controllers.branch_mpc import _first
from belief_planning_tpu_torch.models.policies import cast_params
from belief_planning_tpu_torch.models.predictive import PredictiveModel
from belief_planning_tpu_torch.ops.rollout import rollout_controls
from belief_planning_tpu_torch.solvers.tree_qp import (
    ADMMConfig,
    admm_solve,
    assemble_stage_cost,
    build_stage_plan,
)
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig, qp_ipm_solve
from belief_planning_tpu_torch.tree.engine import TreeState, build_tree
from belief_planning_tpu_torch.tree.topology import build_topology
from belief_planning_tpu_torch.utils.config import BranchMPCParams
from belief_planning_tpu_torch.utils.device import resolve_device

_BIG = 1e6


class RobustCarry(NamedTuple):
    xLin: Any         # (Bt, Nx, n) linearization trajectory
    uLin: Any         # (Bt, Nu, d)
    old_input: Any    # (Bt, d)
    initialized: Any  # (Bt,) bool


class RobustSolveResult(NamedTuple):
    xPred: Any        # (Bt, Nx, n)
    uPred: Any        # (Bt, Nu, d)
    slack: Any        # (Bt, Nu, nFx + m^NB)
    zPred: Any        # (Bt, Nu, m^NB, n) obstacle nodes per time step (padded)
    zvalid: Any       # (Nu, m^NB) which of them exist
    prim_res: Any     # (Bt,)
    feasible: Any     # (Bt,) bool


def obstacle_node_map(topo_real, N: int, NB: int):
    """Per time step t of the chain, the obstacle nodes of the real tree
    alive at t: ``(ids (Nu, m^NB), valid (Nu, m^NB))``."""
    Nu = N * NB + 1
    maxz = topo_real.m ** NB
    ids = np.zeros((Nu, maxz), dtype=np.int64)
    valid = np.zeros((Nu, maxz), dtype=bool)
    counts = np.zeros(Nu, dtype=np.int64)
    valid[0, 0], counts[0] = True, 1
    for b in range(1, topo_real.n_branches):
        dep = int(topo_real.depth[b])
        for tl in range(int(topo_real.blen[b])):
            t = (dep - 1) * N + tl + 1
            ids[t, counts[t]] = topo_real.u_off[b] + tl
            valid[t, counts[t]] = True
            counts[t] += 1
    return ids, valid


def lin_roll(x0, A, B, C, u):
    """Roll ``x0 (Bt, n)`` through ``x⁺ = A x + B u + C`` over the stages of
    ``A (Bt, T, n, n)``: the states ``(Bt, T + 1, n)``, ``x0`` first."""
    xs = [x0]
    for i in range(A.shape[1]):
        xs.append(torch.einsum("bij,bj->bi", A[:, i], xs[-1])
                  + torch.einsum("bij,bj->bi", B[:, i], u[:, i]) + C[:, i])
    return torch.stack(xs, dim=1)


def chain_state(x_lin, u_lin, A, B, C):
    """The ``TreeState`` of a chain (root + one branch) with dynamics ``A,
    B, C`` into nodes 1.., no tree-built collision rows and unit weights."""
    Bt, Nx, n = x_lin.shape
    Nu, d = u_lin.shape[1], u_lin.shape[2]
    z = lambda *shape: x_lin.new_zeros((Bt,) + shape)
    return TreeState(
        x_lin=x_lin, u_lin=u_lin, z=z(Nu, n), p=z(2, 1), dp=z(2, 1, n),
        w=x_lin.new_ones((Bt, 2)),
        A=torch.cat([z(1, n, n), A], dim=1), Bm=torch.cat([z(1, n, d), B], dim=1),
        C=torch.cat([z(1, n), C], dim=1), h0=z(Nu), dh=z(Nu, n))


def make_robust_mpc_step(model: PredictiveModel, params: BranchMPCParams,
                         admm: ADMMConfig = ADMMConfig(), feas_tol: float = 1e-3,
                         solver: str = "ipm", ipm: QPIPMConfig = QPIPMConfig(), device=None):
    """Build ``(topo_chain, init_carry(batch, dtype), step)``;
    ``step(carrys, xs, zs, xRefs, policy_params) -> (carrys, RobustSolveResult)``
    on batch-leading tensors, solving with :func:`qp_ipm_solve` (``solver=
    "ipm"``, warm-started at the re-rolled previous prediction) or
    :func:`admm_solve` (``"admm"``). ``device``: ``None`` = ``"cuda"``;
    pass ``"cpu"`` to run on the CPU."""
    if solver not in ("ipm", "admm"):
        raise ValueError(f"unknown solver {solver!r}")
    dev = resolve_device(device)
    n, d, N, NB = params.n, params.d, params.N, params.NB
    topo_real = build_topology(N, NB, model.m, n, d)
    topo_chain = build_topology(N * NB, 1, 1, n, d)
    plan_chain = build_stage_plan(topo_chain)
    Nx, Nu = topo_chain.totalx, topo_chain.totalu
    ids, valid = obstacle_node_map(topo_real, N, NB)
    ids_t = torch.as_tensor(ids, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    Fx, bx, Fu, bu = params.Fx, params.bx, params.Fu, params.bu
    nFx = Fx.shape[0]

    def init_carry(batch: int, dtype=torch.float32) -> RobustCarry:
        z = lambda *shape: torch.zeros((batch,) + shape, dtype=dtype, device=dev)
        return RobustCarry(xLin=z(Nx, n), uLin=z(Nu, d), old_input=z(d),
                           initialized=torch.zeros(batch, dtype=torch.bool, device=dev))

    def step(carrys: RobustCarry, xs, zs, xRefs, policy_params):
        # profiler spans: bp.prep (scenario tree, linearization, rows, cost), bp.solve
        with record_function("bp.prep"):
            args = prep(carrys, xs, zs, xRefs, policy_params)
        with record_function("bp.solve"):
            return solve(carrys, xs, *args)

    def prep(carrys: RobustCarry, xs, zs, xRefs, policy_params):
        dtype = xs.dtype
        Bt = xs.shape[0]
        pp = cast_params(policy_params, dtype, dev)
        # the obstacle's scenario tree (its rollouts; the ego part is unused)
        ts_real = build_tree(model, topo_real, xs, zs,
                             xs.new_zeros((Bt, topo_real.totalu, d)), pp)
        zmat = ts_real.z[:, ids_t]                                   # (Bt, Nu, maxz, n)

        roll = rollout_controls(model.dyn, xs, xs.new_zeros((Bt, Nx - 1, d)), model.dt)
        x_roll = torch.cat([xs[:, None], roll], dim=1)
        xLin = torch.where(carrys.initialized[:, None, None], carrys.xLin, x_roll)
        uLin = carrys.uLin
        A, B, C, _ = model.linearize(xLin[:, :-1], uLin)
        x_warm = lin_roll(xs, A, B, C, uLin)
        ts = chain_state(xLin, uLin, A, B, C)

        # collision rows: one per (time step, obstacle node), padded
        xl = xLin[:, :Nu, None, :].expand(zmat.shape)
        h_raw, dh = model.col_raw(xl, zmat)
        h0 = h_raw - torch.einsum("btjn,btn->btj", dh, xLin[:, :Nu])
        dh = torch.where(valid_t[:, :, None], dh, torch.zeros_like(dh))
        h0 = torch.where(valid_t, h0, torch.full_like(h0, _BIG))
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        Fxc = torch.cat([as_t(Fx).expand(Bt, Nu, nFx, n), -dh], dim=2)
        b1 = torch.cat([as_t(bx).expand(Bt, Nu, nFx), h0], dim=2)

        cost = assemble_stage_cost(topo_chain, ts, params.Q, params.R, params.Qf, params.dR,
                                   params.Qslack, xRefs, carrys.old_input, variant="robust")
        return ts, cost, Fxc, b1, x_warm, uLin, zmat

    def solve(carrys: RobustCarry, xs, ts, cost, Fxc, b1, x_warm, uLin, zmat):
        Bt = xs.shape[0]
        rows = (Fx, bx, Fu, bu, xs, carrys.old_input)
        if solver == "ipm":
            x_nodes, u, s, info = qp_ipm_solve(plan_chain, cost, ts, *rows, ipm,
                                               Fxc_override=Fxc, b1_override=b1,
                                               warm_primal=(x_warm, uLin), device=dev)
        else:
            x_nodes, u, s, _, info = admm_solve(plan_chain, cost, ts, *rows, admm,
                                                Fxc_override=Fxc, b1_override=b1, device=dev)
        new = RobustCarry(xLin=torch.cat([x_nodes[:, 1:], x_nodes[:, -1:]], dim=1),
                          uLin=torch.cat([u[:, 1:], u[:, -1:]], dim=1),
                          old_input=u[:, 0].clone(),
                          initialized=torch.ones(Bt, dtype=torch.bool, device=dev))
        res = RobustSolveResult(xPred=x_nodes, uPred=u, slack=s, zPred=zmat, zvalid=valid_t,
                                prim_res=info["prim_res"],
                                feasible=info["prim_res"] < feas_tol)
        return new, res

    return topo_chain, init_carry, step


class RobustMPC:
    """One tree's robust controller with the reference's API:
    ``solve(x, z, xRef)`` returns the applied input and keeps ``uPred``,
    ``xPred`` (numpy) and ``feasible``; ``BT2array`` gives the ego
    trajectory and every obstacle branch. ``device``: ``None`` = ``"cuda"``;
    pass ``"cpu"`` to run on the CPU."""

    def __init__(self, mpcParameters: BranchMPCParams, predictiveModel: PredictiveModel,
                 policy_params, admm: ADMMConfig = ADMMConfig(), dtype=torch.float64,
                 solver: str = "ipm", ipm: QPIPMConfig = QPIPMConfig(), device=None):
        self.params = mpcParameters
        self.model = predictiveModel
        self.policy_params = policy_params
        self.dtype = dtype
        self.device = resolve_device(device)
        self.topo, self._init_carry, self._step = make_robust_mpc_step(
            predictiveModel, mpcParameters, admm, solver=solver, ipm=ipm, device=self.device)
        self.carry = self._init_carry(1, dtype)
        self.N = mpcParameters.N
        self.xPred = None
        self.uPred = None
        self.feasible = 1
        self.last = None

    @property
    def predictiveModel(self):
        return self.model

    def update_policy_params(self, policy_params):
        self.policy_params = policy_params

    def _row(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                               device=self.device).reshape(1, -1)

    def solve(self, x, z, xRef=None):
        if xRef is None:
            xRef = self.params.xRef
        self.carry, res = self._step(self.carry, self._row(x), self._row(z), self._row(xRef),
                                     self.policy_params)
        res = res._replace(zvalid=res.zvalid[None])
        self.last = _first(res)
        self.xPred = self.last.xPred
        self.uPred = self.last.uPred
        self.feasible = int(self.last.feasible)
        return self.uPred[0]

    def BT2array(self):
        """The ego trajectory and each obstacle branch's nodes in time order
        (the reference ``robustMPC.BT2array``)."""
        z, valid = self.last.zPred, self.last.zvalid
        ztraj = []
        for j in range(z.shape[1]):
            rows = [z[t, j] for t in range(z.shape[0]) if valid[t, j]]
            if rows:
                ztraj.append(np.array(rows))
        return [self.last.xPred], ztraj, [self.last.uPred], []
