"""Continuous-time dynamics ``f(x, u) -> xdot`` (leading batch dims allowed)."""

from __future__ import annotations

import torch


def dubins(x, u):
    """Vehicle state ``(X, Y, v, ψ)``, input ``(a, r)``:
    ``ẋ = [v·cosψ, v·sinψ, a, r]``."""
    return torch.stack([x[..., 2] * torch.cos(x[..., 3]),
                        x[..., 2] * torch.sin(x[..., 3]), u[..., 0], u[..., 1]],
                       dim=-1)


def quad_kinematics(x, u):
    """Quadruped body-frame kinematics, state ``(X, Y, θ)``, input
    ``(vx, vy, ω)``: ``ẋ = [vx·cosθ − vy·sinθ, vx·sinθ + vy·cosθ, ω]``."""
    c = torch.cos(x[..., 2])
    s = torch.sin(x[..., 2])
    return torch.stack([u[..., 0] * c - u[..., 1] * s, u[..., 0] * s + u[..., 1] * c,
                        u[..., 2]], dim=-1)
