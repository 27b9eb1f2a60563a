"""Per-lane inputs of the batched merge deployment (the reference package's
``envs/batched_merge.py``: its world draw and ``env_pre``; the fused
closed-loop episode is not ported yet).

Each lane is one world: an ego on the on-ramp and an obstacle on the main
road. Until the ego has merged (``x > merge_s + 8``) its controller runs in
the ramp frame: the shear transform ``S`` (``S[1, 0] = −tan ψ₀``), a
reference state and lane bounds ``bx`` from the ramp's reference line at the
ego's X. After the merge it uses the identity, the road reference and the
default bounds. These are the per-lane ``S``, ``xRef`` and ``bx`` that
``make_cvar_mpc_batched_step(use_S=True)`` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from belief_planning_tpu_torch.envs.merge import LANE_WIDTH, merge_ref_lines


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
