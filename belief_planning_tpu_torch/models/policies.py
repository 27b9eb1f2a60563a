"""Backup policies ``u = policy(x, params)`` (the reference package's
``models/policies.py``: the highway, merge and quadruped sets).

Parameters are NamedTuples of tensors or floats, passed at call time. The
merge scenario's policies may carry a reference line (``psiref``, a
:class:`RefLine` lookup table) and then steer toward its heading.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from belief_planning_tpu_torch.ops.softmath import softmax_pair


class RefLine(NamedTuple):
    """Piecewise-linear lookup table (merge ramp): ``jnp.interp`` semantics,
    constant beyond the end knots, on tensors of any shape. A table with
    leading dims ``(..., K)`` (one table a lane) broadcasts against ``x``."""

    xs: Any  # (K,) knot X coordinates (ascending)
    ys: Any  # (K,) values (Y or psi)

    def __call__(self, x):
        xs = torch.as_tensor(self.xs, dtype=x.dtype, device=x.device)
        ys = torch.as_tensor(self.ys, dtype=x.dtype, device=x.device)
        if xs.dim() > 1:
            return self._per_lane(x, xs, ys)
        flat = x.reshape(-1)
        i = torch.clamp(torch.searchsorted(xs, flat.contiguous(), right=True), 1,
                        xs.shape[0] - 1)
        x0, y0 = xs[i - 1].reshape(x.shape), ys[i - 1].reshape(x.shape)
        dx, dy = xs[i].reshape(x.shape) - x0, ys[i].reshape(x.shape) - y0
        # a (near-)repeated knot takes the left value, as jnp.interp does
        dx0 = torch.abs(dx) <= _spacing_eps(x.dtype)
        f = torch.where(dx0, y0, y0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx), dx)) * dy)
        f = torch.where(x < xs[0], ys[0], f)
        return torch.where(x > xs[-1], ys[-1], f)

    @staticmethod
    def _per_lane(x, xs, ys):
        """The lookup with tables ``(..., K)`` whose leading dims broadcast
        against ``x``: each element reads its own row."""
        K = xs.shape[-1]
        shape = torch.broadcast_shapes(xs.shape[:-1], x.shape)
        xb = x.expand(shape)
        rows = lambda t: t.expand(shape + (K,)).reshape(-1, K)
        xr, yr = rows(xs), rows(ys)
        i = torch.clamp(torch.searchsorted(xr, xb.reshape(-1, 1).contiguous(), right=True), 1,
                        K - 1)
        pick = lambda t, j: t.gather(1, j).reshape(shape)
        x0, y0 = pick(xr, i - 1), pick(yr, i - 1)
        dx, dy = pick(xr, i) - x0, pick(yr, i) - y0
        dx0 = torch.abs(dx) <= _spacing_eps(x.dtype)
        f = torch.where(dx0, y0, y0 + ((xb - x0) / torch.where(dx0, torch.ones_like(dx), dx)) * dy)
        f = torch.where(xb < xs[..., 0], ys[..., 0], f)
        return torch.where(xb > xs[..., -1], ys[..., -1], f)


def _spacing_eps(dtype):
    """``np.spacing(finfo(dtype).eps)``, jnp.interp's repeated-knot test."""
    return float(np.spacing(np.finfo(str(dtype).split(".")[-1]).eps))


def _psi0(x, psiref):
    """The reference line's heading at ``x``'s X, or 0 without a line."""
    return psiref(x[..., 0]) if psiref is not None else torch.zeros_like(x[..., 0])


class MaintainParams(NamedTuple):
    Kpsi: Any
    psiref: Optional[RefLine] = None


def maintain(x, p: MaintainParams):
    """Hold speed, P-control heading to 0 (or to the ref line's heading)."""
    return torch.stack([torch.zeros_like(x[..., 0]), _psi0(x, p.psiref) - p.Kpsi * x[..., 3]],
                       dim=-1)


class MaintainTrackVParams(NamedTuple):
    Kpsi: Any
    v0: Any
    psiref: Optional[RefLine] = None


def maintain_track_v(x, p: MaintainTrackVParams):
    """Track speed ``v0`` with gain 0.5, P-control heading."""
    return torch.stack([0.5 * (p.v0 - x[..., 2]), _psi0(x, p.psiref) - p.Kpsi * x[..., 3]],
                       dim=-1)


class BrakeParams(NamedTuple):
    Kpsi: Any
    a_brake: Any   # -7 on the MPC path, -5 in the simulator
    gamma: Any     # 5 on the MPC path, 3 in the simulator
    psiref: Optional[RefLine] = None


def brake(x, p: BrakeParams):
    """Smooth brake ``a = softmax_pair(a_brake, −v; γ)``, P-control heading."""
    a = softmax_pair(p.a_brake, -x[..., 2], p.gamma)
    return torch.stack([a, _psi0(x, p.psiref) - p.Kpsi * x[..., 3]], dim=-1)


def brake_params_mpc(Kpsi, psiref=None) -> BrakeParams:
    """Constants of the reference's symbolic (MPC) path; with a ref line that
    path uses the simulator's (-5, 3)."""
    if psiref is not None:
        return brake_params_sim(Kpsi, psiref)
    return BrakeParams(Kpsi=Kpsi, a_brake=-7.0, gamma=5.0)


def brake_params_sim(Kpsi, psiref=None) -> BrakeParams:
    """Constants of the reference's numeric (simulator) path."""
    return BrakeParams(Kpsi=Kpsi, a_brake=-5.0, gamma=3.0, psiref=psiref)


class LaneChangeParams(NamedTuple):
    x_target: Any  # (4,) lane-change target state


def lane_change(x, p: LaneChangeParams):
    """State feedback toward the target with the reference's fixed LQR gains.
    A per-lane target ``(..., 4)`` broadcasts against ``x``'s leading dims."""
    t = p.x_target
    return torch.stack([
        -0.8558 * (x[..., 2] - t[..., 2]),
        -0.3162 * (x[..., 1] - t[..., 1]) - 3.9889 * (x[..., 3] - t[..., 3]),
    ], dim=-1)


class ForwardParams(NamedTuple):
    v0: Any


def quad_forward(x, p: ForwardParams):
    """Quadruped: walk forward at ``v0`` (input ``(vx, vy, ω)``)."""
    z = torch.zeros_like(x[..., 0])
    return torch.stack([p.v0 + z, z, z], dim=-1)


def quad_stop(x, p=None):
    """Quadruped: stop."""
    z = torch.zeros_like(x[..., 0])
    return torch.stack([z, z, z], dim=-1)


PolicyFn = Callable[[Any, Any], Any]


class PolicySet(NamedTuple):
    """A backup-policy library: fns + their params (one NamedTuple each)."""

    fns: Tuple[PolicyFn, ...]
    params: Tuple[Any, ...]

    @property
    def m(self) -> int:
        return len(self.fns)


def highway_policy_set(cons, x_target, mpc_path: bool = True) -> PolicySet:
    """The overtake demo's [maintain, brake, lane-change] set: the MPC path's
    brake constants, or with ``mpc_path=False`` the simulator's."""
    return PolicySet(
        fns=(maintain, brake, lane_change),
        params=(
            MaintainParams(Kpsi=cons.Kpsi),
            brake_params_mpc(cons.Kpsi) if mpc_path else brake_params_sim(cons.Kpsi),
            LaneChangeParams(x_target=torch.as_tensor(x_target, dtype=torch.float64)),
        ),
    )


def merge_policy_set(cons, v0, psiref: Optional[RefLine]) -> PolicySet:
    """The merge demo's [maintain_trackV, brake] set."""
    return PolicySet(
        fns=(maintain_track_v, brake),
        params=(MaintainTrackVParams(Kpsi=cons.Kpsi, v0=v0, psiref=psiref),
                brake_params_mpc(cons.Kpsi, psiref=psiref)),
    )


def quadruped_policy_set(v0) -> PolicySet:
    """The quadruped demo's [forward, stop] set."""
    return PolicySet(fns=(quad_forward, quad_stop), params=(ForwardParams(v0=v0), None))


def lane_flags(params, in_axes):
    """Which leaves of ``params`` (a tuple of policy NamedTuples) carry a
    leading lane axis, from a vmap in-axes prefix as the JAX package takes
    it (``policy_in_axes``): ``None`` shares a policy's params, or one
    field's, across lanes; ``0`` gives them a leading lane axis, e.g.
    ``(None, None, LaneChangeParams(x_target=0))``; a :class:`RefLine` leaf
    marked 0 is a table a lane (``xs, ys (Bt, K)``). Returns one tuple of
    bools a policy (``None`` for a ``None`` policy), or ``None`` when no leaf
    is per-lane."""
    if in_axes is None:
        return None
    if len(in_axes) != len(params):
        raise ValueError(f"policy_in_axes has {len(in_axes)} entries for {len(params)} policies")
    flags = []
    for p, ax in zip(params, in_axes):
        if p is None:
            flags.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,) * len(p)
        f = []
        for name, v, a in zip(p._fields, p, axes):
            if a is not None and a != 0:
                raise ValueError(f"policy_in_axes: {name} has axis {a!r}; only None or 0")
            f.append(a == 0 and v is not None)
        flags.append(tuple(f))
    return tuple(flags) if any(any(f) for f in flags if f is not None) else None


def lane_leaves(params, flags):
    """The per-lane leaves of ``params``, in order (see :func:`lane_flags`)."""
    if flags is None:
        return []
    return [v for p, f in zip(params, flags) if f is not None for v, fl in zip(p, f) if fl]


def with_lane_leaves(params, flags, leaves):
    """``params`` with its per-lane leaves replaced by ``leaves``, in order."""
    if flags is None:
        return params
    it = iter(leaves)
    return tuple(p if f is None else type(p)(*(next(it) if fl else v for v, fl in zip(p, f)))
                 for p, f in zip(params, flags))


def leaf_map(fn, v):
    """``fn`` on a leaf's tensor, or on each table of a :class:`RefLine`."""
    return RefLine(*(fn(a) for a in v)) if isinstance(v, RefLine) else fn(v)


def lanes_over(params, flags, lead):
    """``params`` with each per-lane leaf ``(Bt, ...)`` viewed as ``(Bt, 1,
    ..., 1, ...)``, to broadcast against states of leading dims ``lead``
    (``lead[0] == Bt``)."""
    ones = (1,) * (len(lead) - 1)
    return with_lane_leaves(params, flags, [
        leaf_map(lambda a: a.reshape(a.shape[:1] + ones + a.shape[1:]), v)
        for v in lane_leaves(params, flags)])


def cast_params(params, dtype, device):
    """Every leaf of a tuple of policy NamedTuples as a tensor of ``dtype`` on
    ``device`` (a ``None`` ref line or parameter set stays ``None``)."""
    def leaf(v):
        if v is None:
            return None
        if isinstance(v, RefLine):
            return RefLine(*(torch.as_tensor(a, dtype=dtype, device=device) for a in v))
        return torch.as_tensor(v, dtype=dtype, device=device)
    return tuple(None if p is None else type(p)(*(leaf(v) for v in p)) for p in params)
