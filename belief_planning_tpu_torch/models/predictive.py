"""Predictive model: dynamics, backup rollouts, branch probabilities and the
collision constraint (the reference package's ``models/predictive.py``:
the highway, merge and quadruped models).

Functions take states with optional leading batch dimensions; the Jacobians
(``branch_eval``'s ``dp``, ``col_raw``'s ``dh``) are per-sample
``torch.func.jacfwd`` / ``torch.func.grad`` under ``torch.func.vmap``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Tuple

import torch
from torch.func import grad, jacfwd, vmap

from belief_planning_tpu_torch.models import safety
from belief_planning_tpu_torch.models.dynamics import dubins, quad_kinematics
from belief_planning_tpu_torch.models.policies import (
    PolicySet,
    lane_leaves,
    lanes_over,
    leaf_map,
    with_lane_leaves,
)
from belief_planning_tpu_torch.ops.linearize import linearize_dynamics
from belief_planning_tpu_torch.ops.rollout import rollout_policy
from belief_planning_tpu_torch.ops.softmath import softmin, softsat


@dataclass(frozen=True)
class PredictiveModel:
    """Static model definition.

    Fields:
      dyn:        continuous dynamics ``f(x, u) -> xdot``
      n, d, N:    state/input dims, per-branch horizon
      dt:         step
      policy_fns: backup-policy fns; their params are call arguments
      bf_traj:    trajectory safety ``(obs (..., N, n), ego (..., N, n)) -> (...)``
      pair_h:     pairwise safety ``(x, z) -> scalar`` (the linearized row)
      prob_from_h: branch probability ``h (..., m) -> p (..., m)``
    """

    dyn: Callable = field(repr=False)
    n: int
    d: int
    N: int
    dt: float
    policy_fns: Tuple[Callable, ...] = field(repr=False)
    bf_traj: Callable = field(repr=False)
    pair_h: Callable = field(repr=False)
    prob_from_h: Callable = field(repr=False)

    @property
    def m(self) -> int:
        return len(self.policy_fns)

    def step(self, x, u):
        """Discrete Euler step ``x⁺ = x + f(x,u)·dt``."""
        return x + self.dyn(x, u) * self.dt

    def linearize(self, x, u):
        """``(A, B, C, xp)`` with ``C = xp − A x − B u``; batched over leading dims."""
        return linearize_dynamics(self.dyn, x, u, self.dt)

    def zpred(self, z, policy_params):
        """Obstacle rollouts under all m policies: ``(..., m, N, n)``."""
        rows = [rollout_policy(self.dyn, fn, z, p, self.N, self.dt)
                for fn, p in zip(self.policy_fns, policy_params)]
        return torch.stack(rows, dim=-3)

    def xpred(self, x, policy_params):
        """Ego rollout under policy 0 (maintain): ``(..., N, n)``."""
        return rollout_policy(self.dyn, self.policy_fns[0], x, policy_params[0],
                              self.N, self.dt)

    def branch_h(self, x, z, policy_params):
        """Per-policy trajectory safety ``(..., m)``."""
        x1 = self.xpred(x, policy_params)
        x2 = self.zpred(z, policy_params)
        return torch.stack([self.bf_traj(x2[..., i, :, :], x1)
                            for i in range(self.m)], dim=-1)

    def branch_p(self, x, z, policy_params):
        return self.prob_from_h(self.branch_h(x, z, policy_params))

    def branch_eval(self, x, z, policy_params, lanes=None):
        """``(p (..., m), dp (..., m, n))``: probabilities and their Jacobian
        with respect to the ego state. ``lanes`` (``policies.lane_flags``)
        marks the leaves of ``policy_params`` that carry a leading lane axis
        ``(x.shape[0], ...)``; each sample then gets its own lane's."""
        def single(xx, zz, *per_lane):
            pp = with_lane_leaves(policy_params, lanes, per_lane)
            f = lambda x_: self.branch_p(x_, zz, pp)
            return f(xx), jacfwd(f)(xx)
        lead = x.shape[:-1]
        k = len(lead)
        flat = lambda a: a.expand(lead + a.shape[k:]).reshape((-1,) + a.shape[k:])
        per_lane = [leaf_map(flat, v)
                    for v in lane_leaves(lanes_over(policy_params, lanes, lead), lanes)]
        return _batched(single, x, z, *per_lane)

    def col_raw(self, x, z):
        """``(h, dh)``: the pairwise margin and its gradient in ``x``."""
        def single(xx, zz):
            return self.pair_h(xx, zz), grad(self.pair_h)(xx, zz)
        return _batched(single, x, z)


def _batched(single, x, z, *flat):
    """Apply a per-sample function to ``x, z`` with any leading batch dims
    (and to ``flat``, already one row a sample)."""
    if x.ndim == 1:
        return single(x, z, *flat)
    lead = x.shape[:-1]
    outs = vmap(single)(x.reshape(-1, x.shape[-1]), z.reshape(-1, z.shape[-1]), *flat)
    return tuple(o.reshape(lead + o.shape[1:]) for o in outs)


def _branch_prob_softsat(h, s1):
    """p = normalize(exp(s1·softsat(h, 1))) over the last axis."""
    hs = softsat(h, 1.0)
    e = torch.exp(s1 * (hs - torch.amax(hs, dim=-1, keepdim=True)))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _branch_prob_plain(h, s1):
    """p = normalize(exp(s1·h)) over the last axis (the quadruped's, no softsat)."""
    e = torch.exp(s1 * (h - torch.amax(h, dim=-1, keepdim=True)))
    return e / torch.sum(e, dim=-1, keepdim=True)


def highway_model(cons, pset: PolicySet, N: int, dt: float, N_lane: int = 3) -> PredictiveModel:
    """Highway overtake model. ``N_lane=3`` is the reference's default even in
    the 4-lane demo, kept for parity. Trajectory safety blends vehicle
    collision (size ``[L+2, W+0.2]``) with the obstacle's lane-boundary margin
    (softmin γ=5); the pairwise row uses size ``[L+1, W+0.2]``."""
    LB = (cons.W / 2.0, N_lane * 3.6 - cons.W / 2.0)
    size_bf = (cons.L + 2.0, cons.W + 0.2)
    size_h = (cons.L + 1.0, cons.W + 0.2)

    def bf_traj(obs_traj, ego_traj):
        hcol = safety.veh_col(obs_traj, ego_traj, size_bf, alpha=1.0)   # (..., N)
        hlane = safety.lane_bdry_h(obs_traj, LB[0], LB[1])              # (..., N)
        return softmin(torch.cat([hcol, hlane], dim=-1), 5.0, axis=-1)

    def pair_h(x, z):
        return safety.veh_col(x, z, size_h, alpha=1.0)

    return PredictiveModel(
        dyn=dubins, n=4, d=2, N=N, dt=dt, policy_fns=pset.fns,
        bf_traj=bf_traj, pair_h=pair_h,
        prob_from_h=partial(_branch_prob_softsat, s1=cons.s1),
    )


def merge_model(cons, pset: PolicySet, N: int, dt: float) -> PredictiveModel:
    """Merge-lane model: trajectory safety is vehicle collision only (size
    ``[L+1, W+0.2]``, no lane rows, softmin γ=5); the ref-line lookup lives
    in the policy params (``RefLine``)."""
    size = (cons.L + 1.0, cons.W + 0.2)

    def bf_traj(obs_traj, ego_traj):
        return softmin(safety.veh_col(obs_traj, ego_traj, size, alpha=1.0), 5.0, axis=-1)

    def pair_h(x, z):
        return safety.veh_col(x, z, size, alpha=1.0)

    return PredictiveModel(
        dyn=dubins, n=4, d=2, N=N, dt=dt, policy_fns=pset.fns,
        bf_traj=bf_traj, pair_h=pair_h,
        prob_from_h=partial(_branch_prob_softsat, s1=cons.s1),
    )


def quadruped_model(cons, pset: PolicySet, N: int, dt: float) -> PredictiveModel:
    """Quadruped model: the 1-norm center-distance margin (the MPC path's),
    soft-minned (γ=5) over the horizon for trajectory safety, and branch
    probabilities without softsat."""
    def pair_h(x, z):
        return safety.robot_col(x, z, cons.L1, cons.W1, cons.L2, cons.W2, cons.col_tol, ord=1)

    def bf_traj(obs_traj, ego_traj):
        return softmin(pair_h(obs_traj, ego_traj), 5.0, axis=-1)

    return PredictiveModel(
        dyn=quad_kinematics, n=3, d=3, N=N, dt=dt, policy_fns=pset.fns,
        bf_traj=bf_traj, pair_h=pair_h,
        prob_from_h=partial(_branch_prob_plain, s1=cons.s1),
    )
