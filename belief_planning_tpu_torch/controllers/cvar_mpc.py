"""Nested-CVaR branch-MPC controllers (the reference package's
``controllers/cvar_mpc.py``).

One receding-horizon step over a batch of independent trees: warm-start
shift → tree build → CVaR IPM. With ``use_S`` the merge deployment's
per-lane shear transform ``S`` and lane bounds ``bx`` enter the solve.

- :func:`make_cvar_mpc_batched_step` solves with the fused CVaR IPM in the
  batch-last layout (the CUDA kernel on the card), with an optional f64
  restart;
- :func:`make_cvar_mpc_step` solves each tree with the independently
  written ``solvers/cvar_ipm.cvar_ipm_solve`` (the reference's per-tree
  step under ``vmap``), with its optional barrier restart.

:class:`BranchMPCCVaR` wraps the per-tree step for one tree with the
reference controller's ``solve(x, z, xRef, S, bx)`` API, for the host
environments.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from belief_planning_tpu_torch.controllers.branch_mpc import (
    MPCCarry,
    _cast,
    _first,
    _init_carry_fn,
    _new_carry,
    bt2array,
)
from belief_planning_tpu_torch.models.policies import cast_params
from belief_planning_tpu_torch.models.predictive import PredictiveModel
from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig, cvar_ipm_solve
from belief_planning_tpu_torch.solvers.cvar_pl import cvar_ipm_solve_pl
from belief_planning_tpu_torch.solvers.layout import _from_bl, _to_bl
from belief_planning_tpu_torch.tree.engine import build_tree, shift_warm_start
from belief_planning_tpu_torch.tree.topology import build_topology
from belief_planning_tpu_torch.utils.config import BranchMPCParams
from belief_planning_tpu_torch.utils.device import resolve_device


class CVaRSolveResult(NamedTuple):
    xPred: Any        # (Bt, totalx, n)
    uPred: Any        # (Bt, totalu, d)
    slack: Any        # (Bt, totalu, Nc)
    risk: Any         # (Bt, nrisk) [ρ; σ; μ⁺; μ⁻]
    w: Any            # (Bt, nbr) branch weights
    p: Any            # (Bt, nbr, m)
    z: Any            # (Bt, totalu, n) obstacle nodes
    J: Any            # (Bt,) objective
    gap: Any          # (Bt,) duality gap of the returned iterate


def _prep_cvar(model, topo, pd, dev, carry: MPCCarry, x, z, policy_params):
    """Warm-start shift and tree build in dtype ``pd``."""
    u_lin = torch.where(carry.initialized[:, None, None],
                        shift_warm_start(topo, carry.u_lin, carry.p),
                        torch.zeros_like(carry.u_lin))
    return build_tree(model, topo, x.to(pd), z.to(pd), u_lin.to(pd),
                      cast_params(policy_params, pd, dev))


def make_cvar_mpc_step(
    model: PredictiveModel,
    params: BranchMPCParams,
    ralpha: float,
    ipm: CVaRIPMConfig = CVaRIPMConfig(iters=80),
    replicate_quirks: bool = True,
    use_S: bool = False,
    prep_dtype=None,
    restart: int = 0,
    restart_cfg: Optional[CVaRIPMConfig] = None,
    device=None,
):
    """Build ``(topo, cplan, init_carry, step)``: the reference's per-tree
    step, batched over trees.

    ``step(carrys, xs, zs, xRefs, policy_params, S=None, bx=None) ->
    (carrys, CVaRSolveResult)`` takes batch-leading tensors and policy params
    shared by all trees, and solves each tree with :func:`cvar_ipm_solve`.
    With ``use_S``, ``S (Bt, n, n)`` and ``bx (Bt, nFx)`` are per tree; the
    dh[0] floor applies to trees that are warm (``carry.initialized``).

    ``restart``: iterations of a second solve started at the first solve's
    primal with fresh centred duals (recovery from a Mehrotra jam); the
    restart config flips the corrector count (4, or 2 if the solve used 4)
    unless ``restart_cfg`` is given, and its result is kept per tree where
    its gap is smaller. ``device``: ``None`` = ``"cuda"`` (raises without
    CUDA); pass ``"cpu"`` to run on the CPU.
    """
    dev = resolve_device(device)
    topo = build_topology(params.N, params.NB, model.m, params.n, params.d)
    cplan = build_cvar_plan(topo, replicate_quirks=replicate_quirks)
    rcfg = restart_cfg if restart_cfg is not None else dataclasses.replace(
        ipm, iters=restart, gondzio=4 if ipm.gondzio != 4 else 2)

    def step(carrys: MPCCarry, xs, zs, xRefs, policy_params, S=None, bx=None):
        dt_in = xs.dtype
        pd = prep_dtype if prep_dtype is not None else dt_in
        with record_function("bp.prep"):
            ts = _cast(_prep_cvar(model, topo, pd, dev, carrys, xs, zs, policy_params), dt_in)
        S_used = S.to(dt_in) if (use_S and S is not None) else None
        bx_used = params.bx if bx is None else bx.to(dt_in)

        def solve(ts_, cfg):
            return cvar_ipm_solve(cplan, ts_, params.Q, params.R, params.Qslack, xRefs, ralpha,
                                  params.Fx, bx_used, params.Fu, params.bu, xs, S=S_used,
                                  cfg=cfg, dh0_floor=carrys.initialized, device=dev)

        with record_function("bp.solve"):
            x_f, u_f, s_f, r_f, aux = solve(ts, ipm)
        if restart > 0:
            # the restart solves the same program: x_lin / u_lin feed only the
            # start and the exact-equivalent per-cone scaling
            with record_function("bp.restart"):
                x2, u2, s2, r2, aux2 = solve(ts._replace(x_lin=x_f, u_lin=u_f), rcfg)
            better = aux2["gap"] < aux["gap"]
            pick = lambda a, b: torch.where(better.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
            x_f, u_f, s_f, r_f = pick(x2, x_f), pick(u2, u_f), pick(s2, s_f), pick(r2, r_f)
            aux = {"J": pick(aux2["J"], aux["J"]), "gap": torch.minimum(aux2["gap"], aux["gap"])}
        res = CVaRSolveResult(xPred=x_f, uPred=u_f, slack=s_f, risk=r_f, w=ts.w, p=ts.p, z=ts.z,
                              J=aux["J"], gap=aux["gap"])
        return _new_carry(u_f, ts.p), res

    return topo, cplan, _init_carry_fn(topo, params.d, dev), step


def make_cvar_mpc_batched_step(
    model: PredictiveModel,
    params: BranchMPCParams,
    ralpha: float,
    ipm: CVaRIPMConfig = CVaRIPMConfig(iters=40),
    replicate_quirks: bool = True,
    use_S: bool = False,
    prep_dtype=None,
    refine_f64: int = 0,
    refine_cfg: Optional[CVaRIPMConfig] = None,
    solve_dtype=None,
    device=None,
):
    """Build ``(topo, cplan, init_carry, step)`` for a batch of independent
    trees.

    ``step(carrys, xs, zs, xRefs, policy_params, S=None, bx=None) ->
    (carrys, CVaRSolveResult)`` takes batch-leading tensors (``xs (Bt, n)``)
    and policy params shared by all lanes. With ``use_S``, ``S (Bt, n, n)``
    is the per-lane state transform and ``bx (Bt, nFx)`` the per-lane state
    bounds. The dh[0] floor of the transform applies only to lanes that are
    warm (``carry.initialized``), as in the reference.

    ``device``: ``None`` = ``"cuda"`` (raises without CUDA); pass ``"cpu"``
    to run on the CPU. ``prep_dtype``: optional wider dtype for the tree
    build. ``solve_dtype``: dtype of the fused solve (default: the input's).

    ``refine_f64``: f64 restart iterations after the solve, warm-started
    from its x, u, s and r with fresh duals on f64-built data (implies
    ``prep_dtype=float64``). The default restart config flips the Gondzio
    pattern (4 correctors, or 2 if the solve used 4). The restart runs
    through the same kernel in double on the card.
    """
    dev = resolve_device(device)
    topo = build_topology(params.N, params.NB, model.m, params.n, params.d)
    cplan = build_cvar_plan(topo, replicate_quirks=replicate_quirks)
    if refine_f64 > 0 and prep_dtype is None:
        prep_dtype = torch.float64
    rcfg = refine_cfg if refine_cfg is not None else CVaRIPMConfig(
        iters=refine_f64, gondzio=4 if ipm.gondzio != 4 else 2)

    def solve(ts, dtype, xRefs, S, bx, floor, cfg, x_warm=None, u_warm=None, s_warm=None,
              r_warm=None):
        ts = _cast(ts, dtype)
        S_bl = _to_bl(S.to(dtype)) if (use_S and S is not None) else None
        bx_used = params.bx if bx is None else _to_bl(bx.to(dtype))
        return cvar_ipm_solve_pl(
            cplan, _to_bl(ts.A), _to_bl(ts.Bm), _to_bl(ts.dh), _to_bl(ts.h0),
            _to_bl(ts.x_lin) if x_warm is None else x_warm,
            _to_bl(ts.u_lin) if u_warm is None else u_warm,
            _to_bl(ts.p), params.Q, params.R, params.Qslack, _to_bl(xRefs.to(dtype)), ralpha,
            params.Fx, bx_used, params.Fu, params.bu, cfg=cfg, S_bl=S_bl,
            s_warm_bl=s_warm, r_warm_bl=r_warm, dh0_floor=floor)

    def step(carrys: MPCCarry, xs, zs, xRefs, policy_params, S=None, bx=None):
        dt_in = xs.dtype
        sd = solve_dtype if solve_dtype is not None else dt_in
        # profiler spans (bp.prep / bp.solve / bp.refine_f64): the per-layer
        # times of a step under torch.profiler; near-free when it is off
        with record_function("bp.prep"):
            ts_p = _prep_cvar(model, topo, prep_dtype if prep_dtype is not None else dt_in, dev,
                              carrys, xs, zs, policy_params)
        ts_b = _cast(ts_p, sd)
        floor = carrys.initialized
        with record_function("bp.solve"):
            x_bl, u_bl, s_bl, r_bl, aux = solve(ts_b, sd, xRefs, S, bx, floor, ipm)
        if refine_f64 > 0:
            f64 = torch.float64
            with record_function("bp.refine_f64"):
                x_bl, u_bl, s_bl, r_bl, aux2 = solve(
                    ts_p, f64, xRefs, S, bx, floor, rcfg, x_warm=x_bl.to(f64),
                    u_warm=u_bl.to(f64), s_warm=s_bl.to(f64), r_warm=r_bl.to(f64))
            aux = {**aux, "J": aux2["J"], "gap": aux2["gap"]}
        u_f = _from_bl(u_bl).to(dt_in)
        new_carry = _new_carry(u_f, ts_b.p.to(dt_in))
        res = CVaRSolveResult(
            xPred=_from_bl(x_bl).to(dt_in), uPred=u_f, slack=_from_bl(s_bl).to(dt_in),
            risk=_from_bl(r_bl).to(dt_in), w=ts_b.w, p=ts_b.p, z=ts_b.z,
            J=aux["J"].to(dt_in), gap=aux["gap"].to(dt_in))
        return new_carry, res

    return topo, cplan, _init_carry_fn(topo, params.d, dev), step


class BranchMPCCVaR:
    """One tree's nested-CVaR controller with the reference's API:
    ``solve(x, z, xRef=None, S=None, Fx=None, bx=None)`` returns the applied
    input and keeps ``uPred`` and ``xPred`` (numpy); ``BT2array`` as
    :class:`~belief_planning_tpu_torch.controllers.branch_mpc.BranchMPC`'s.
    It runs :func:`make_cvar_mpc_step` on a batch of one tree in ``dtype``.

    With ``use_S`` a given ``S`` is the state transform of that solve; ``S=None``
    solves without one (no transform and no dh[0] floor), as the reference
    does after the merge's lane switch. ``bx`` replaces the state bounds for
    that solve. ``device``: ``None`` = ``"cuda"``; pass ``"cpu"`` to run on the
    CPU.
    """

    def __init__(self, mpcParameters, predictiveModel: PredictiveModel, policy_params,
                 ralpha: float, ipm: CVaRIPMConfig = CVaRIPMConfig(iters=80),
                 replicate_quirks: bool = True, use_S: bool = False, dtype=torch.float64,
                 prep_dtype=None, restart: int = 0,
                 restart_cfg: Optional[CVaRIPMConfig] = None, device=None):
        self.params = mpcParameters
        self.model = predictiveModel
        self.policy_params = policy_params
        self.ralpha = ralpha
        self.use_S = use_S
        self.dtype = dtype
        self.device = resolve_device(device)
        self.topo, self.cplan, self._init_carry, self._step = make_cvar_mpc_step(
            predictiveModel, mpcParameters, ralpha, ipm, replicate_quirks, use_S,
            prep_dtype=prep_dtype, restart=restart, restart_cfg=restart_cfg, device=self.device)
        self.carry = self._init_carry(1, dtype)
        self.N = mpcParameters.N
        bx = np.asarray(mpcParameters.bx).ravel()
        self.psimax = float(bx[2]) if bx.size > 2 else 0.25
        self.xPred = None
        self.uPred = None
        self.feasible = 1
        self.last = None

    @property
    def predictiveModel(self):
        return self.model

    def update_policy_params(self, policy_params):
        self.policy_params = policy_params

    def _t(self, a, shape):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                               device=self.device).reshape(shape)

    def solve(self, x, z, xRef=None, S=None, Fx=None, bx=None):
        if xRef is None:
            xRef = self.params.xRef
        n = self.params.n
        S_t = self._t(S, (1, n, n)) if (self.use_S and S is not None) else None
        bx_t = self._t(bx, (1, -1)) if bx is not None else None
        self.carry, res = self._step(self.carry, self._t(x, (1, n)), self._t(z, (1, n)),
                                     self._t(xRef, (1, n)), self.policy_params, S=S_t, bx=bx_t)
        self.last = _first(res)
        self.xPred = self.last.xPred
        self.uPred = self.last.uPred
        self.feasible = 1
        return self.uPred[0]

    def BT2array(self):
        return bt2array(self.topo, self.last)
