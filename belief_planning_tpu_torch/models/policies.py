"""Highway backup policies ``u = policy(x, params)`` (the reference package's
``models/policies.py``, highway set).

Parameters are NamedTuples of tensors or floats, passed at call time. The
reference-line (``psiref``) variants belong to the merge scenario and are not
part of this package yet.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from belief_planning_tpu_torch.ops.softmath import softmax_pair


class MaintainParams(NamedTuple):
    Kpsi: Any


def maintain(x, p: MaintainParams):
    """Hold speed, P-control heading to 0."""
    return torch.stack([torch.zeros_like(x[..., 0]), -p.Kpsi * x[..., 3]], dim=-1)


class BrakeParams(NamedTuple):
    Kpsi: Any
    a_brake: Any   # -7 on the MPC path, -5 in the simulator
    gamma: Any     # 5 on the MPC path, 3 in the simulator


def brake(x, p: BrakeParams):
    """Smooth brake ``a = softmax_pair(a_brake, −v; γ)``, P-control heading."""
    a = softmax_pair(p.a_brake, -x[..., 2], p.gamma)
    return torch.stack([a, -p.Kpsi * x[..., 3]], dim=-1)


def brake_params_mpc(Kpsi) -> BrakeParams:
    """Constants of the reference's symbolic (MPC) path."""
    return BrakeParams(Kpsi=Kpsi, a_brake=-7.0, gamma=5.0)


class LaneChangeParams(NamedTuple):
    x_target: Any  # (4,) lane-change target state


def lane_change(x, p: LaneChangeParams):
    """State feedback toward the target with the reference's fixed LQR gains."""
    t = p.x_target
    return torch.stack([
        -0.8558 * (x[..., 2] - t[2]),
        -0.3162 * (x[..., 1] - t[1]) - 3.9889 * (x[..., 3] - t[3]),
    ], dim=-1)


PolicyFn = Callable[[Any, Any], Any]


class PolicySet(NamedTuple):
    """A backup-policy library: fns + their params (one NamedTuple each)."""

    fns: Tuple[PolicyFn, ...]
    params: Tuple[Any, ...]

    @property
    def m(self) -> int:
        return len(self.fns)


def highway_policy_set(cons, x_target) -> PolicySet:
    """The overtake demo's [maintain, brake, lane-change] set (MPC-path brake)."""
    return PolicySet(
        fns=(maintain, brake, lane_change),
        params=(
            MaintainParams(Kpsi=cons.Kpsi),
            brake_params_mpc(cons.Kpsi),
            LaneChangeParams(x_target=torch.as_tensor(x_target, dtype=torch.float64)),
        ),
    )


def cast_params(params, dtype, device):
    """Every leaf of a tuple of policy NamedTuples as a tensor of ``dtype`` on
    ``device``."""
    return tuple(
        type(p)(*(torch.as_tensor(v, dtype=dtype, device=device) for v in p))
        for p in params)
