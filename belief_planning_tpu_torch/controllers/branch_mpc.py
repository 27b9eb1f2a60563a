"""Branch-MPC controllers, QP path (the reference package's
``controllers/branch_mpc.py``).

One receding-horizon step over a batch of independent trees: warm-start
shift → tree build → stage-cost assembly (batch-leading) → tree-QP IPM.
Two steps share that preparation:

- :func:`make_branch_mpc_batched_step` solves with the fused IPM in the
  batch-last layout (the CUDA kernel on the card), with an optional f64
  restart;
- :func:`make_branch_mpc_step` solves each tree with the independently
  written IPM ``solvers/tree_qp_ipm.qp_ipm_solve`` (the reference's
  per-tree step under ``vmap``), the fused path's cross-check, or with the
  OSQP-style ADMM ``solvers/tree_qp.admm_solve``, whose per-stage duals the
  carry shifts and hands to the next solve.

Both take ``policy_in_axes``: policy params shared by all trees, or with
some leaves one value a tree (the closed-loop overtake retargets each
world's lane change). :class:`BranchMPC` and :class:`BranchMPCProx` wrap
the per-tree step for one tree with the reference controllers'
``solve(x, z, xRef)`` API, for the host environments.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from belief_planning_tpu_torch.models.policies import cast_params, lane_flags
from belief_planning_tpu_torch.models.predictive import PredictiveModel
from belief_planning_tpu_torch.solvers.layout import _from_bl, _to_bl, cost_to_bl
from belief_planning_tpu_torch.solvers.tree_qp import (
    ADMMConfig,
    admm_solve,
    assemble_stage_cost,
    build_stage_plan,
)
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig, qp_ipm_solve
from belief_planning_tpu_torch.solvers.tree_qp_pl import qp_ipm_solve_pl
from belief_planning_tpu_torch.tree.engine import build_tree, shift_warm_start, warm_shift_indices
from belief_planning_tpu_torch.tree.topology import TreeTopology, build_topology
from belief_planning_tpu_torch.utils.config import BranchMPCParams
from belief_planning_tpu_torch.utils.device import resolve_device


class MPCCarry(NamedTuple):
    """Warm-start state carried between receding-horizon steps (batch-leading).
    The ADMM step also carries its per-stage duals, shifted with the inputs;
    the IPM steps pass them through untouched."""

    u_lin: Any        # (Bt, totalu, d) previous solution inputs
    p: Any            # (Bt, nbr, m) previous branch probabilities (argmax shift)
    old_input: Any    # (Bt, d) previously applied input
    initialized: Any  # (Bt,) bool — False on the first solve
    y1: Any = None    # (Bt, totalu, Nc) state-row duals
    y2: Any = None    # (Bt, totalu, nFu) input-row duals
    y3: Any = None    # (Bt, totalu, Nc) slack-positivity duals


class SolveResult(NamedTuple):
    xPred: Any        # (Bt, totalx, n)
    uPred: Any        # (Bt, totalu, d)
    slack: Any        # (Bt, totalu, Nc)
    w: Any            # (Bt, nbr) branch weights
    p: Any            # (Bt, nbr, m)
    x_lin: Any        # (Bt, totalx, n) linearization trajectory used
    z: Any            # (Bt, totalu, n) obstacle nodes
    prim_res: Any     # (Bt,) primal residual
    feasible: Any     # (Bt,) bool
    gap: Any          # (Bt,) duality gap of the returned iterate


def _cast(tree, dtype):
    return type(tree)(*(a.to(dtype) for a in tree))


def _init_carry_fn(topo: TreeTopology, d: int, dev, duals=None):
    """``init_carry(batch, dtype)``; ``duals = (Nc, nFu)`` adds zero ADMM duals."""
    def init_carry(batch: int, dtype=torch.float32) -> MPCCarry:
        z = lambda *shape: torch.zeros((batch,) + shape, dtype=dtype, device=dev)
        ys = {} if duals is None else dict(y1=z(topo.totalu, duals[0]),
                                           y2=z(topo.totalu, duals[1]),
                                           y3=z(topo.totalu, duals[0]))
        return MPCCarry(
            u_lin=z(topo.totalu, d), p=z(topo.n_branches, topo.m), old_input=z(d),
            initialized=torch.zeros(batch, dtype=torch.bool, device=dev), **ys)
    return init_carry


def _new_carry(u, p, duals=(None, None, None)):
    y1, y2, y3 = duals
    return MPCCarry(u_lin=u, p=p, old_input=u[:, 0].clone(),
                    initialized=torch.ones(u.shape[0], dtype=torch.bool, device=u.device),
                    y1=y1, y2=y2, y3=y3)


def _warm_duals(topo: TreeTopology, carry: MPCCarry):
    """The carried ADMM duals shifted as the inputs are (``warm_shift_indices``),
    zero on a tree's first solve."""
    src = warm_shift_indices(topo, carry.p)
    on = carry.initialized[:, None, None]
    return tuple(torch.where(on, torch.gather(y, 1, src[..., None].expand(-1, -1, y.shape[-1])),
                             torch.zeros_like(y))
                 for y in (carry.y1, carry.y2, carry.y3))


def _prep_qp(model, topo, params, variant, replicate_quirks, pd, dev, carry: MPCCarry, x, z,
             xRef, policy_params, policy_in_axes=None):
    """Warm-start shift, tree build and stage-cost assembly in dtype ``pd``."""
    pp = cast_params(policy_params, pd, dev)
    u_lin = torch.where(carry.initialized[:, None, None],
                        shift_warm_start(topo, carry.u_lin, carry.p),
                        torch.zeros_like(carry.u_lin))
    ts = build_tree(model, topo, x.to(pd), z.to(pd), u_lin.to(pd), pp,
                    lane_flags(pp, policy_in_axes))
    cost = assemble_stage_cost(topo, ts, params.Q, params.R, params.Qf, params.dR, params.Qslack,
                               xRef.to(pd), carry.old_input.to(pd), variant=variant,
                               replicate_quirks=replicate_quirks)
    return ts, cost


def make_branch_mpc_step(
    model: PredictiveModel,
    params: BranchMPCParams,
    variant: str = "prox",
    replicate_quirks: bool = True,
    feas_tol: float = 1e-3,
    solver: str = "ipm",
    ipm: QPIPMConfig = QPIPMConfig(),
    prep_dtype=None,
    device=None,
    policy_in_axes=None,
    admm: ADMMConfig = ADMMConfig(),
) -> Tuple[TreeTopology, Any, Any]:
    """Build ``(topo, init_carry, step)``: the reference's per-tree step,
    batched over trees.

    ``step(carrys, xs, zs, xRefs, policy_params) -> (carrys, SolveResult)``
    takes batch-leading tensors (``xs (Bt, n)``) and solves each tree's QP
    in the input's dtype with :func:`qp_ipm_solve` (``solver="ipm"``,
    config ``ipm``) or :func:`admm_solve` (``solver="admm"``, config
    ``admm``; the carry's duals, shifted, start it, and its ``gap`` is NaN).
    ``policy_in_axes``: ``None`` shares the policy params across trees; a
    prefix such as ``(None, None, LaneChangeParams(x_target=0))`` marks the
    leaves that carry a leading tree axis (``policies.lane_flags``).
    ``prep_dtype``: optional wider dtype for the tree build and cost assembly
    only. ``device``: ``None`` = ``"cuda"`` (raises without CUDA); pass
    ``"cpu"`` to run on the CPU.
    """
    if solver not in ("ipm", "admm"):
        raise ValueError(f"unknown solver {solver!r}")
    dev = resolve_device(device)
    topo = build_topology(params.N, params.NB, model.m, params.n, params.d)
    plan = build_stage_plan(topo)
    duals = (params.Fx.shape[0] + 1, params.Fu.shape[0]) if solver == "admm" else None

    def step(carrys: MPCCarry, xs, zs, xRefs, policy_params):
        dt_in = xs.dtype
        pd = prep_dtype if prep_dtype is not None else dt_in
        with record_function("bp.prep"):
            ts, cost = _prep_qp(model, topo, params, variant, replicate_quirks, pd, dev, carrys,
                                xs, zs, xRefs, policy_params, policy_in_axes)
        ts, cost = _cast(ts, dt_in), _cast(cost, dt_in)
        rows = (params.Fx, params.bx, params.Fu, params.bu, xs, carrys.old_input)
        with record_function("bp.solve"):
            if solver == "ipm":
                x_nodes, u, s, info = qp_ipm_solve(plan, cost, ts, *rows, ipm, device=dev)
                ys = (carrys.y1, carrys.y2, carrys.y3)
                gap = info["gap"]
            else:
                x_nodes, u, s, st, info = admm_solve(plan, cost, ts, *rows, admm,
                                                     warm_duals=_warm_duals(topo, carrys),
                                                     device=dev)
                ys = (st.y1, st.y2, st.y3)
                gap = torch.full_like(info["prim_res"], float("nan"))
        res = SolveResult(xPred=x_nodes, uPred=u, slack=s, w=ts.w, p=ts.p, x_lin=ts.x_lin,
                          z=ts.z, prim_res=info["prim_res"],
                          feasible=info["prim_res"] < feas_tol, gap=gap)
        return _new_carry(u, ts.p, ys), res

    return topo, _init_carry_fn(topo, params.d, dev, duals), step


def make_branch_mpc_batched_step(
    model: PredictiveModel,
    params: BranchMPCParams,
    variant: str = "prox",
    replicate_quirks: bool = True,
    feas_tol: float = 1e-3,
    ipm: QPIPMConfig = QPIPMConfig(),
    prep_dtype=None,
    refine_f64: int = 0,
    refine_cfg: Optional[QPIPMConfig] = None,
    solve_dtype=None,
    device=None,
    policy_in_axes=None,
) -> Tuple[TreeTopology, Any, Any]:
    """Build ``(topo, init_carry, step)`` for a batch of independent trees.

    ``step(carrys, xs, zs, xRefs, policy_params) -> (carrys, SolveResult)``
    takes batch-leading tensors (``xs (Bt, n)``). The IPM iterations run
    batch-last through the fused iteration: the CUDA kernel on the card, its
    plain version on the CPU. ``policy_in_axes``: ``None`` shares the policy
    params across lanes; a prefix such as ``(None, None,
    LaneChangeParams(x_target=0))`` gives the marked leaves a leading lane
    axis (``policies.lane_flags``), as the JAX package's vmap in-axes do.

    ``device``: ``None`` = ``"cuda"`` (raises without CUDA); pass ``"cpu"``
    to run on the CPU.

    ``prep_dtype``: optional wider dtype for the tree build and cost assembly
    only. ``solve_dtype``: dtype of the fused solve (default: the input's).

    ``refine_f64``: number of f64 restart iterations after the solve,
    warm-started from its primal (x, u, s) with fresh duals, on f64-built QP
    data (implies ``prep_dtype=float64``); ``refine_cfg`` overrides the
    restart config. Unlike the JAX package, which has to run this phase as
    plain XLA, the restart runs through the same kernel in double on the card.
    """
    dev = resolve_device(device)
    topo = build_topology(params.N, params.NB, model.m, params.n, params.d)
    plan = build_stage_plan(topo)
    Fx, bx, Fu, bu = params.Fx, params.bx, params.Fu, params.bu
    if refine_f64 > 0 and prep_dtype is None:
        prep_dtype = torch.float64
    # the restart keeps the tuned default start (μ0=10, sl_min=0.1)
    rcfg = refine_cfg if refine_cfg is not None else QPIPMConfig(iters=refine_f64)

    def solve(ts, cost, dtype, x_warm, u_warm, cfg, s_warm=None):
        ts = _cast(ts, dtype)
        return qp_ipm_solve_pl(
            plan, cost_to_bl(_cast(cost, dtype)), _to_bl(ts.A), _to_bl(ts.Bm),
            _to_bl(ts.C), _to_bl(ts.dh), _to_bl(ts.h0), Fx, bx, Fu, bu,
            x_warm, u_warm, cfg, s_warm_bl=s_warm)

    def step(carrys: MPCCarry, xs, zs, xRefs, policy_params):
        dt_in = xs.dtype
        sd = solve_dtype if solve_dtype is not None else dt_in
        # profiler spans (bp.prep / bp.solve / bp.refine_f64): the per-layer
        # times of a step under torch.profiler; near-free when it is off
        with record_function("bp.prep"):
            ts_p, cost_p = _prep_qp(model, topo, params, variant, replicate_quirks,
                                    prep_dtype if prep_dtype is not None else dt_in, dev,
                                    carrys, xs, zs, xRefs, policy_params, policy_in_axes)
        ts_b = _cast(ts_p, sd)
        with record_function("bp.solve"):
            x_bl, u_bl, s_bl, info = solve(ts_b, cost_p, sd, _to_bl(ts_b.x_lin),
                                           _to_bl(ts_b.u_lin), ipm)
        if refine_f64 > 0:
            f64 = torch.float64
            with record_function("bp.refine_f64"):
                x_bl, u_bl, s_bl, info2 = solve(ts_p, cost_p, f64, x_bl.to(f64),
                                                u_bl.to(f64), rcfg, s_warm=s_bl.to(f64))
            info = {**info, "prim_res": info2["prim_res"], "gap": info2["gap"]}
        x_nodes = _from_bl(x_bl).to(dt_in)
        u = _from_bl(u_bl).to(dt_in)
        s = _from_bl(s_bl).to(dt_in)
        prim = info["prim_res"].to(dt_in)
        new_carry = _new_carry(u, ts_b.p.to(dt_in), (carrys.y1, carrys.y2, carrys.y3))
        res = SolveResult(xPred=x_nodes, uPred=u, slack=s, w=ts_b.w, p=ts_b.p,
                          x_lin=ts_b.x_lin, z=ts_b.z, prim_res=prim,
                          feasible=prim < feas_tol, gap=info["gap"].to(dt_in))
        return new_carry, res

    return topo, _init_carry_fn(topo, params.d, dev), step


class BranchMPC:
    """One tree's controller with the reference's API: ``solve(x, z, xRef)``
    returns the applied input and keeps ``uPred``, ``xPred`` (numpy) and
    ``feasible``; ``BT2array`` gives each branch's trajectories for plots.
    It runs :func:`make_branch_mpc_step` on a batch of one tree, the IPM in
    ``dtype``.

    ``variant='branch'`` is the reference's live ``BranchMPC`` cost,
    :class:`BranchMPCProx` the ``'prox'`` one. ``solver="admm"`` solves with
    the ADMM of config ``admm`` (a keyword). ``device``: ``None`` =
    ``"cuda"``; pass ``"cpu"`` to run on the CPU.
    """

    variant = "branch"

    def __init__(self, mpcParameters, predictiveModel: PredictiveModel, policy_params,
                 replicate_quirks: bool = True, dtype=torch.float64, solver: str = "ipm",
                 ipm: QPIPMConfig = QPIPMConfig(), prep_dtype=None, device=None,
                 admm: ADMMConfig = ADMMConfig()):
        self.params = mpcParameters
        self.model = predictiveModel
        self.policy_params = policy_params
        self.dtype = dtype
        self.device = resolve_device(device)
        self.topo, self._init_carry, self._step = make_branch_mpc_step(
            predictiveModel, mpcParameters, self.variant, replicate_quirks, solver=solver,
            ipm=ipm, prep_dtype=prep_dtype, device=self.device, admm=admm)
        self.carry = self._init_carry(1, dtype)
        self.N, self.n, self.d = mpcParameters.N, mpcParameters.n, mpcParameters.d
        self.xPred = None
        self.uPred = None
        self.feasible = 1
        self.last = None
        self.solverTime = 0.0

    @property
    def predictiveModel(self):
        return self.model

    def update_policy_params(self, policy_params):
        """Swap the policy params (e.g. a new lane-change target): data only."""
        self.policy_params = policy_params

    def _row(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                               device=self.device).reshape(1, -1)

    def solve(self, x, z, xRef=None):
        if xRef is None:
            xRef = self.params.xRef
        t0 = time.perf_counter()
        self.carry, res = self._step(self.carry, self._row(x), self._row(z), self._row(xRef),
                                     self.policy_params)
        self.last = _first(res)
        self.xPred = self.last.xPred
        self.uPred = self.last.uPred
        self.feasible = int(self.last.feasible)
        self.solverTime = time.perf_counter() - t0
        return self.uPred[0]

    def BT2array(self):
        return bt2array(self.topo, self.last)


class BranchMPCProx(BranchMPC):
    variant = "prox"


def _first(res):
    """The first tree of a batched result, each field as numpy."""
    return type(res)(*(a[0].detach().cpu().numpy() for a in res))


def bt2array(topo: TreeTopology, res):
    """Per-branch ``(xtraj, ztraj, utraj, w)`` of one tree's result (numpy
    fields), each trajectory with its parent's last point first, as the
    reference's ``BT2array``."""
    x, z, u, w = res.xPred, res.z, res.uPred, res.w
    xtraj, ztraj, utraj, ws = [], [], [], []
    for b in range(1, topo.n_branches):
        par = topo.parent[b]
        ox, ou, l = topo.x_off[b], topo.u_off[b], topo.blen[b]
        pox, pou, pl = topo.x_off[par], topo.u_off[par], topo.blen[par]
        xtraj.append(np.vstack([x[pox + pl - 1], x[ox:ox + l]]))
        ztraj.append(np.vstack([z[pou + pl - 1], z[ou:ou + l]]))
        utraj.append(np.vstack([u[pou + pl - 1], u[ou:ou + l]]))
        ws.append(w[b])
    return xtraj, ztraj, utraj, ws
