"""Carry parameters over from the JAX package's objects to this package's.

The JAX package's ``BranchMPCParams`` / ``BranchConstants`` /
``QuadConstants`` / ``CVaRIPMConfig`` / ``CVaRConfig`` hold numpy arrays,
floats and ints, its ``TreeState`` holds arrays (numpy after ``np.asarray``),
and its policy params are NamedTuples (``MaintainParams``,
``MaintainTrackVParams``, ``BrakeParams``, ``LaneChangeParams``,
``ForwardParams``) of arrays, some with a reference line (``RefLine``) in
``psiref``, or ``None`` (the quadruped's stop policy). Its overtake worlds
(``envs.batched_highway.WorldState``) and the host environments' vehicles
(``envs.highway.Vehicle``) convert too, so that both packages start a
closed loop from one state. These functions read them by field name (this
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
from belief_planning_tpu_torch.tree.engine import TreeState
from belief_planning_tpu_torch.utils.config import BranchConstants, BranchMPCParams, QuadConstants

_POLICY_PARAMS = {
    "MaintainParams": MaintainParams,
    "MaintainTrackVParams": MaintainTrackVParams,
    "BrakeParams": BrakeParams,
    "LaneChangeParams": LaneChangeParams,
    "ForwardParams": ForwardParams,
}
_CONSTANTS = {"BranchConstants": BranchConstants, "QuadConstants": QuadConstants}


def convert_constants(cons):
    """A ``BranchConstants``- or ``QuadConstants``-like dataclass → this
    package's class of the same name."""
    cls = _CONSTANTS[type(cons).__name__]
    return cls(**{f.name: float(getattr(cons, f.name)) for f in dataclasses.fields(cls)})


def convert_mpc_params(params) -> BranchMPCParams:
    """A ``BranchMPCParams``-like dataclass → this package's (numpy) params."""
    kw = {}
    for f in dataclasses.fields(BranchMPCParams):
        v = getattr(params, f.name)
        kw[f.name] = np.array(v, dtype=np.float64) if isinstance(v, np.ndarray) else v
    return BranchMPCParams(**kw)


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
