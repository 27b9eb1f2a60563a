"""Carry parameters over from the JAX package's objects to this package's.

The JAX package's ``BranchMPCParams`` / ``MPCParams`` / ``BranchConstants`` /
``QuadConstants`` / ``HMMConstants`` / ``CVaRIPMConfig`` / ``CVaRConfig`` /
``ADMMConfig`` hold numpy arrays, floats and ints, its ``TreeState`` and
``ADMMState`` hold arrays (numpy after ``np.asarray``), and its policy
params are NamedTuples (``MaintainParams``,
``MaintainTrackVParams``, ``BrakeParams``, ``LaneChangeParams``,
``ForwardParams``) of arrays, some with a reference line (``RefLine``) in
``psiref``, or ``None`` (the quadruped's stop policy). Its overtake worlds
(``envs.batched_highway.WorldState``) and the host environments' vehicles
(``envs.highway.Vehicle``) convert too, so that both packages start a
closed loop from one state, and its ``HMMPredictiveModel`` with its policy
tuple. These functions read them by field name (this
package imports nothing of the JAX package) and return this package's
equivalents, so both packages compute from identical numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from belief_planning_tpu_torch.controllers.branch_mpc import MPCCarry
from belief_planning_tpu_torch.envs.batched_highway import WorldState
from belief_planning_tpu_torch.envs.highway import Vehicle
from belief_planning_tpu_torch.models import policies as pol
from belief_planning_tpu_torch.models.hmm import HMMPredictiveModel
from belief_planning_tpu_torch.models.policies import (
    BrakeParams,
    ForwardParams,
    LaneChangeParams,
    MaintainParams,
    MaintainTrackVParams,
    RefLine,
)
from belief_planning_tpu_torch.solvers.cvar import CVaRConfig
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
from belief_planning_tpu_torch.solvers.tree_qp import ADMMConfig, ADMMState
from belief_planning_tpu_torch.tree.engine import TreeState
from belief_planning_tpu_torch.utils.config import (
    BranchConstants,
    BranchMPCParams,
    HMMConstants,
    MPCParams,
    QuadConstants,
)

_POLICY_PARAMS = {
    "MaintainParams": MaintainParams,
    "MaintainTrackVParams": MaintainTrackVParams,
    "BrakeParams": BrakeParams,
    "LaneChangeParams": LaneChangeParams,
    "ForwardParams": ForwardParams,
}
_CONSTANTS = {"BranchConstants": BranchConstants, "QuadConstants": QuadConstants,
              "HMMConstants": HMMConstants}
_PARAMS = {"BranchMPCParams": BranchMPCParams, "MPCParams": MPCParams}
# the policy functions by name (the HMM model carries its functions)
_POLICY_FNS = {name: getattr(pol, name) for name in (
    "maintain", "maintain_track_v", "brake", "lane_change", "quad_forward", "quad_stop")}


def convert_constants(cons):
    """A ``BranchConstants``-, ``QuadConstants``- or ``HMMConstants``-like
    dataclass → this package's class of the same name."""
    cls = _CONSTANTS[type(cons).__name__]
    return cls(**{f.name: float(getattr(cons, f.name)) for f in dataclasses.fields(cls)})


def convert_hmm_constants(cons) -> HMMConstants:
    """An ``HMMConstants``-like dataclass → this package's."""
    return convert_constants(cons)


def convert_mpc_params(params):
    """A ``BranchMPCParams``- or ``MPCParams``-like dataclass → this
    package's class of the same name (numpy params)."""
    cls = _PARAMS[type(params).__name__]
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(params, f.name)
        kw[f.name] = np.array(v, dtype=np.float64) if isinstance(v, np.ndarray) else v
    return cls(**kw)


def convert_admm_config(cfg) -> ADMMConfig:
    """An ``ADMMConfig``-like dataclass → this package's ``ADMMConfig``."""
    return ADMMConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(ADMMConfig)})


def convert_admm_state(state, device, dtype=torch.float64) -> ADMMState:
    """An ``ADMMState``-like NamedTuple (leading tree axis) → this package's,
    field by field, so both packages can start from the same iterate and
    warm duals."""
    return ADMMState(*(torch.as_tensor(np.array(getattr(state, f)), dtype=dtype, device=device)
                       for f in ADMMState._fields))


def convert_hmm_model(model, device, dtype=torch.float64) -> HMMPredictiveModel:
    """An ``HMMPredictiveModel``-like model → this package's: its sizes and
    step, its constants, its policy functions (matched by name) and their
    params (:func:`convert_policy_params`)."""
    return HMMPredictiveModel(
        nx=int(model.nx), d=int(model.d), M=int(model.M), m=int(model.m), dt=float(model.dt),
        cons=convert_constants(model.cons),
        policy_fns=tuple(_POLICY_FNS[fn.__name__] for fn in model.policy_fns),
        policy_params=convert_policy_params(model.policy_params, device, dtype))


def convert_cvar_ipm_config(cfg) -> CVaRIPMConfig:
    """A ``CVaRIPMConfig``-like dataclass → this package's ``CVaRIPMConfig``."""
    return CVaRIPMConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(CVaRIPMConfig)})


def convert_cvar_config(cfg) -> CVaRConfig:
    """A ``CVaRConfig``-like dataclass (the cone ADMM's) → this package's."""
    return CVaRConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(CVaRConfig)})


def convert_tree_state(ts, device, dtype=torch.float64) -> TreeState:
    """A ``TreeState``-like NamedTuple of arrays → this package's, field by
    field (any leading batch axes are kept)."""
    return TreeState(*(torch.as_tensor(np.array(getattr(ts, f)), dtype=dtype, device=device)
                       for f in TreeState._fields))


def convert_ref_line(line, device, dtype=torch.float64) -> RefLine:
    """A ``RefLine``-like (xs, ys) table → this package's ``RefLine``."""
    return RefLine(*(torch.as_tensor(np.array(v), dtype=dtype, device=device)
                     for v in (line.xs, line.ys)))


def convert_policy_params(policy_params, device, dtype=torch.float64):
    """A tuple of the JAX package's policy NamedTuples → this package's
    NamedTuples of tensors on ``device`` in ``dtype`` (a ``psiref`` becomes
    this package's ``RefLine``)."""
    out = []
    for p in policy_params:
        if p is None:
            out.append(None)
            continue
        cls = _POLICY_PARAMS.get(type(p).__name__)
        if cls is None:
            raise TypeError(f"no counterpart for policy params {type(p).__name__}")
        fields = p._asdict()
        vals = []
        for name in cls._fields:
            v = fields.get(name)
            if name == "psiref":
                vals.append(None if v is None else convert_ref_line(v, device, dtype))
            else:
                vals.append(torch.as_tensor(np.array(v), dtype=dtype, device=device))
        out.append(cls(*vals))
    return tuple(out)


def convert(params, cons, policy_params, device, dtype=torch.float64):
    """``(params, cons, policy_params)`` of the JAX package → this package's."""
    return (convert_mpc_params(params), convert_constants(cons),
            convert_policy_params(policy_params, device, dtype))


def convert_overtake_worlds(worlds, device, dtype=torch.float64) -> WorldState:
    """A batch of the JAX package's overtake worlds (``WorldState`` with a
    leading world axis, its carry batch-leading) → this package's: reals in
    ``dtype``, lanes as int64, flags as bool. The carry keeps the fields of
    this package's ``MPCCarry`` (the ADMM duals are not carried)."""
    t = lambda a, dt: torch.as_tensor(np.array(a), device=device).to(dt)
    c = worlds.mpc_carry
    carry = MPCCarry(u_lin=t(c.u_lin, dtype), p=t(c.p, dtype), old_input=t(c.old_input, dtype),
                     initialized=t(c.initialized, torch.bool))
    return WorldState(
        mpc_carry=carry, x=t(worlds.x, dtype), z=t(worlds.z, dtype),
        ego_lane=t(worlds.ego_lane, torch.long), obs_lane=t(worlds.obs_lane, torch.long),
        obs_des_y=t(worlds.obs_des_y, dtype), lc_target=t(worlds.lc_target, dtype),
        collided=t(worlds.collided, torch.bool))


def convert_vehicles(veh_set):
    """The JAX package's host-environment vehicles → this package's
    ``Vehicle`` list (states copied as f64 numpy arrays)."""
    return [Vehicle(state=np.array(v.state, dtype=np.float64), dt=float(v.dt),
                    v_length=float(v.v_length), v_width=float(v.v_width),
                    backupidx=int(v.backupidx), laneidx=int(v.laneidx)) for v in veh_set]
