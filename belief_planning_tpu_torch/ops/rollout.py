"""Closed-loop and open-loop rollouts (the reference's ``lax.scan`` becomes a
Python loop). States may carry leading batch dimensions."""

from __future__ import annotations

from typing import Callable

import torch


def rollout_policy(dyn: Callable, policy: Callable, x0, params, N: int, dt: float):
    """``N`` Euler steps of ``x⁺ = x + dyn(x, policy(x, params))·dt``; returns
    the N successor states, shape ``(..., N, n)``."""
    x = x0
    xs = []
    for _ in range(N):
        x = x + dyn(x, policy(x, params)) * dt
        xs.append(x)
    return torch.stack(xs, dim=-2)


def rollout_controls(dyn: Callable, x0, us, dt: float):
    """Open-loop rollout under ``us (..., N, d)``; returns ``(..., N, n)``."""
    x = x0
    xs = []
    for k in range(us.shape[-2]):
        x = x + dyn(x, us[..., k, :]) * dt
        xs.append(x)
    return torch.stack(xs, dim=-2)
