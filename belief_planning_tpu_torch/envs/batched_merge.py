"""The batched merge deployment in closed loop (the reference package's
``envs/batched_merge.py``): the world draw, the per-lane controller inputs
(``env_pre``), the world update (``euler``, ``env_post``) and the episode
of :func:`make_batched_merge_fused`, one batched CVaR step (the fused CVaR
iteration, the CUDA kernel on the card) per world step.

Each lane is one world: an ego on the on-ramp and an obstacle on the main
road. Until the ego has merged (``x > merge_s + 8``) its controller runs in
the ramp frame: the shear transform ``S`` (``S[1, 0] = −tan ψ₀``), a
reference state and lane bounds ``bx`` from the ramp's reference line at the
ego's X. After the merge it uses the identity, the road reference and the
default bounds. These are the per-lane ``S``, ``xRef`` and ``bx`` that
``make_cvar_mpc_batched_step(use_S=True)`` takes.

The obstacle drives backup policy 0 of the main-road model: the reference
computes an argmax-safety choice and then overrides it unconditionally, so
only the override is evaluated. The controller keeps the main-road model
throughout, as the reference does. A step draws no randomness, so an
episode is determined by its initial worlds.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_batched_step
from belief_planning_tpu_torch.envs.merge import LANE_WIDTH, merge_ref_lines
from belief_planning_tpu_torch.models.dynamics import dubins
from belief_planning_tpu_torch.models.policies import cast_params
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
from belief_planning_tpu_torch.utils.device import resolve_device


class MergeWorldState(NamedTuple):
    """A batch of merge worlds (leading axis B)."""

    mpc_carry: Any   # the controller's warm start (MPCCarry)
    x: Any           # (B, 4) ego, starts on the ramp
    z: Any           # (B, 4) obstacle on the main road
    merged: Any      # (B,) bool: the ego has switched to the main road
    collided: Any    # (B,) bool


def draw_merge_worlds(B, seed=0, v0=20.0, N_lane=2, merge_lane=1, merge_s=50.0,
                      merge_R=300.0, merge_side=0):
    """Ego and obstacle states ``(B, 4)`` (numpy, f64), drawn as the
    reference's ``init_worlds``, with numpy's generator in place of
    ``jax.random``: ego X ∈ 24 ± 6 on the ramp (Y 1.8 above the ramp line,
    heading along it), obstacle X ∈ 15 ± 5 on the main road's lane."""
    refY, refpsi = merge_ref_lines(N_lane, merge_lane, merge_s, merge_R, merge_side)
    rng = np.random.default_rng(seed)
    xs0 = 24.0 + rng.uniform(-6.0, 6.0, B)
    zs0 = 15.0 + rng.uniform(-5.0, 5.0, B)
    t = torch.as_tensor(xs0, dtype=torch.float64)
    x0 = np.stack([xs0, refY(t).numpy() + 1.8, np.full(B, v0), refpsi(t).numpy()], axis=1)
    z0 = np.stack([zs0, np.full(B, (N_lane - 0.5) * LANE_WIDTH), np.full(B, v0),
                   np.zeros(B)], axis=1)
    return x0, z0


def merge_lane_inputs(x, merged, bx_default, W, v0=20.0, N_lane=2, merge_lane=1,
                      merge_s=50.0, merge_R=300.0, merge_side=0):
    """Per-lane ``(merged, S (B, 4, 4), xRef (B, 4), bx (B, 4))`` for ego
    states ``x (B, 4)`` and the lanes' ``merged (B,)`` flags, in ``x``'s
    dtype and device. ``bx_default`` is the controller's (4,) state-row
    bound (its third entry is the heading limit ψ_max), ``W`` the vehicle
    width."""
    refY, refpsi = merge_ref_lines(N_lane, merge_lane, merge_s, merge_R, merge_side)
    bx_flat = np.asarray(bx_default, float).ravel()
    if bx_flat.size != 4:
        raise ValueError(f"merge runtime bx expects 4 state rows, got {bx_flat.size}")
    psimax = float(bx_flat[2])
    dtype, dev = x.dtype, x.device
    B = x.shape[0]
    X = x[:, 0]
    merged = merged | (X > merge_s + 8)
    y0 = refY(X)
    psi0 = refpsi(X)
    tp = torch.tan(psi0)
    eye = torch.eye(4, dtype=dtype, device=dev).expand(B, 4, 4)
    S_ramp = eye.clone()
    S_ramp[:, 1, 0] = -tp
    xRef_ramp = torch.stack([torch.zeros_like(X), -tp * X + y0 + 1.8,
                             torch.full_like(X, v0), psi0], dim=1)
    bx_ramp = torch.stack([-tp * X + y0 + LANE_WIDTH * merge_lane - W / 2,
                           tp * X - y0 - W / 2, psi0 + psimax, -psi0 + psimax], dim=1)
    xRef_road = torch.tensor([0.0, (N_lane - 0.5) * LANE_WIDTH, v0, 0.0], dtype=dtype,
                             device=dev).expand(B, 4)
    bx_road = torch.as_tensor(bx_flat, dtype=dtype, device=dev).expand(B, 4)
    m = merged[:, None]
    return (merged, torch.where(m[:, :, None], eye, S_ramp), torch.where(m, xRef_road, xRef_ramp),
            torch.where(m, bx_road, bx_ramp))


def euler(s, u, dt):
    """One Euler step of the vehicle model for states ``(B, 4)``."""
    return s + dubins(s, u) * dt


def env_post(model, policy_params, W, world: MergeWorldState, merged, new_carry, u_ego):
    """The world update after a solve: the ego applies ``u_ego (B, 2)``, the
    obstacle backup policy 0 of ``model`` (its params ``policy_params[0]``),
    both by :func:`euler`; a world has collided once ``max(|ΔX| − 4, |ΔY| −
    W) < 0``. Returns ``(new world, out)`` with ``out`` = x, z, u, merged."""
    u_obs = model.policy_fns[0](world.z, policy_params[0])
    x_new = euler(world.x, u_ego, model.dt)
    z_new = euler(world.z, u_obs, model.dt)
    dis = torch.maximum(torch.abs(x_new[:, 0] - z_new[:, 0]) - 4.0,
                        torch.abs(x_new[:, 1] - z_new[:, 1]) - W)
    new = MergeWorldState(mpc_carry=new_carry, x=x_new, z=z_new, merged=merged,
                          collided=world.collided | (dis < 0))
    return new, {"x": x_new, "z": z_new, "u": u_ego, "merged": merged}


def make_batched_merge_fused(cons, model, params, pset_params, ralpha: float = 0.1,
                             ipm: CVaRIPMConfig = CVaRIPMConfig(iters=24, gondzio=2),
                             N_lane: int = 2, merge_lane: int = 1, merge_s: float = 50.0,
                             merge_R: float = 300.0, merge_side: int = 0, v0: float = 20.0,
                             dtype=torch.float32, device=None, **step_kwargs):
    """Build ``(topo, init_worlds, episode)`` for merge worlds in closed loop.

    ``model`` / ``pset_params`` are the main-road predictive model and its
    policy params, the controller's for the whole episode. ``step_kwargs``
    go to :func:`make_cvar_mpc_batched_step` (``prep_dtype``,
    ``refine_f64``, ...). ``device``: ``None`` = ``"cuda"``; pass ``"cpu"``
    to run on the CPU.

    ``init_worlds(B, seed=0, x0=None, z0=None)`` draws worlds as
    :func:`draw_merge_worlds` with numpy's generator seeded by ``seed``, or
    takes both pinned ``x0`` and ``z0`` (B, 4). ``episode(worlds, n_steps)``
    runs ``n_steps`` world steps and returns ``(worlds, traj)``, the leaves
    of ``traj`` (B, n_steps, ...); ``episode.step_once(worlds)`` is one step
    (``env_pre`` → batched CVaR step → :func:`env_post`), returning the new
    worlds and that step's x, z, u, merged and gap."""
    dev = resolve_device(device)
    topo, _, init_carry, bstep = make_cvar_mpc_batched_step(
        model, params, ralpha, ipm=ipm, use_S=True, device=dev, **step_kwargs)
    geom = dict(N_lane=N_lane, merge_lane=merge_lane, merge_s=merge_s, merge_R=merge_R,
                merge_side=merge_side)
    pp = cast_params(pset_params, dtype, dev)

    def init_worlds(B, seed=0, x0=None, z0=None):
        if (x0 is None) != (z0 is None):
            raise ValueError("init_worlds: pass both x0 and z0, or neither")
        if x0 is None:
            x0, z0 = draw_merge_worlds(B, seed, v0=v0, **geom)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        x0, z0 = t(x0), t(z0)
        flags = torch.zeros(x0.shape[0], dtype=torch.bool, device=dev)
        return MergeWorldState(mpc_carry=init_carry(x0.shape[0], dtype), x=x0, z=z0,
                               merged=flags, collided=flags.clone())

    def step_once(worlds: MergeWorldState):
        merged, S, xRef, bx = merge_lane_inputs(worlds.x, worlds.merged, params.bx, cons.W,
                                                v0=v0, **geom)
        carrys, res = bstep(worlds.mpc_carry, worlds.x, worlds.z, xRef, pp, S=S, bx=bx)
        new, out = env_post(model, pp, cons.W, worlds, merged, carrys, res.uPred[:, 0])
        out["gap"] = res.gap
        return new, out

    def episode(worlds: MergeWorldState, n_steps: int):
        outs = []
        for _ in range(n_steps):
            worlds, out = step_once(worlds)
            outs.append(out)
        return worlds, {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]}

    episode.step_once = step_once
    return topo, init_worlds, episode
