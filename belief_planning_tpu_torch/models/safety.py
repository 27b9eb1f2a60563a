"""Safety (barrier) functions, h ≥ 0 ⇔ safe; the MPC (unclipped) path."""

from __future__ import annotations

import torch

from belief_planning_tpu_torch.ops.softmath import softmin


def _expblend(dx, dy, alpha):
    """``(dx·e^{αdx} + dy·e^{αdy}) / (e^{αdx} + e^{αdy})``, max-stabilised."""
    tx = alpha * dx
    ty = alpha * dy
    t = torch.maximum(tx, ty)
    ex = torch.exp(tx - t)
    ey = torch.exp(ty - t)
    return (dx * ex + dy * ey) / (ex + ey)


def _abs(x):
    """``|x|`` whose derivative at 0 is +1, as ``jnp.abs``'s is (``torch.abs``'s
    is 0). Ego and obstacle on the same lane centre give ΔY = 0 exactly, and
    the collision row's gradient must then match the reference."""
    return torch.where(x >= 0, x, -x)


def veh_col(x1, x2, size, alpha=1.0):
    """Smooth rectangle-collision margin between two vehicle states
    ``(..., ≥2)``: soft max of ``|ΔX|−size[0]`` and ``|ΔY|−size[1]``."""
    dx = _abs(x1[..., 0] - x2[..., 0]) - size[0]
    dy = _abs(x1[..., 1] - x2[..., 1]) - size[1]
    return _expblend(dx, dy, alpha)


def lane_bdry_h(x, lb=0.0, ub=7.2, gamma=5.0):
    """Soft distance to the road boundaries ``softmin(y−lb, ub−y; γ)``."""
    y = x[..., 1]
    return softmin(torch.stack([y - lb, ub - y], dim=0), gamma, axis=0)
