"""Carry parameters over from the JAX package's objects to this package's.

The JAX package's ``BranchMPCParams`` / ``BranchConstants`` hold numpy arrays
and floats, and its highway policy params are NamedTuples (``MaintainParams``,
``BrakeParams``, ``LaneChangeParams``) of arrays. These functions read them
by field name (this package imports nothing of the JAX package) and return
this package's equivalents, so both packages compute from identical numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from belief_planning_tpu_torch.models.policies import (
    BrakeParams,
    LaneChangeParams,
    MaintainParams,
)
from belief_planning_tpu_torch.utils.config import BranchConstants, BranchMPCParams

_POLICY_PARAMS = {
    "MaintainParams": MaintainParams,
    "BrakeParams": BrakeParams,
    "LaneChangeParams": LaneChangeParams,
}


def convert_constants(cons) -> BranchConstants:
    """A ``BranchConstants``-like dataclass → this package's ``BranchConstants``."""
    return BranchConstants(**{f.name: float(getattr(cons, f.name))
                              for f in dataclasses.fields(BranchConstants)})


def convert_mpc_params(params) -> BranchMPCParams:
    """A ``BranchMPCParams``-like dataclass → this package's (numpy) params."""
    kw = {}
    for f in dataclasses.fields(BranchMPCParams):
        v = getattr(params, f.name)
        kw[f.name] = np.array(v, dtype=np.float64) if isinstance(v, np.ndarray) else v
    return BranchMPCParams(**kw)


def convert_policy_params(policy_params, device, dtype=torch.float64):
    """A tuple of the JAX package's highway policy NamedTuples → this
    package's NamedTuples of tensors on ``device`` in ``dtype``."""
    out = []
    for p in policy_params:
        cls = _POLICY_PARAMS.get(type(p).__name__)
        if cls is None:
            raise TypeError(f"no counterpart for policy params {type(p).__name__}")
        fields = p._asdict()
        if fields.get("psiref") is not None:
            raise NotImplementedError("reference-line (psiref) policies are not ported")
        out.append(cls(*(torch.as_tensor(np.array(fields[name]), dtype=dtype,
                                         device=device) for name in cls._fields)))
    return tuple(out)


def convert(params, cons, policy_params, device, dtype=torch.float64):
    """``(params, cons, policy_params)`` of the JAX package → this package's."""
    return (convert_mpc_params(params), convert_constants(cons),
            convert_policy_params(policy_params, device, dtype))
