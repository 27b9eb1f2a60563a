"""Safety (barrier) functions, h ≥ 0 ⇔ safe. The MPC path is unclipped; the
environments' numeric path clips the vehicle margins to ±5 (``clip``).

The quadruped's center-distance margin takes the 1-norm on the MPC path and
the 2-norm in the reference's environment, selected by ``ord``."""

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


def veh_col(x1, x2, size, alpha=1.0, clip=None):
    """Smooth rectangle-collision margin between two vehicle states
    ``(..., ≥2)``: soft max of ``|ΔX|−size[0]`` and ``|ΔY|−size[1]``, each
    clipped to ``±clip`` when it is given (the numeric path's 5)."""
    dx = _abs(x1[..., 0] - x2[..., 0]) - size[0]
    dy = _abs(x1[..., 1] - x2[..., 1]) - size[1]
    if clip is not None:
        dx = torch.clamp(dx, -clip, clip)
        dy = torch.clamp(dy, -clip, clip)
    return _expblend(dx, dy, alpha)


def lane_bdry_h(x, lb=0.0, ub=7.2, gamma=5.0):
    """Soft distance to the road boundaries ``softmin(y−lb, ub−y; γ)``."""
    y = x[..., 1]
    return softmin(torch.stack([y - lb, ub - y], dim=0), gamma, axis=0)


def robot_col(x1, x2, L1, W1, L2, W2, tol, ord=1):
    """Quadruped center-distance margin ``‖p1 − p2‖ − (L1+L2)/2 − tol`` over
    the positions of states ``(..., ≥2)``; ``ord`` 1 or 2."""
    diff = x1[..., 0:2] - x2[..., 0:2]
    if ord == 1:
        dist = torch.sum(_abs(diff), dim=-1)
    else:
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return dist - (L1 + L2) / 2.0 - tol


def robot_col_corners(x1, x2, L1, W1, L2, W2, tol, alpha=1.0):
    """Rotated-rectangle margin: 6 points of robot 2's outline in robot 1's
    body frame, each point's soft-max rectangle margin, soft-minned (γ=3)."""
    corners = torch.tensor([[L2 / 2, W2 / 2], [L2 / 2, -W2 / 2], [-L2 / 2, W2 / 2],
                            [-L2 / 2, -W2 / 2], [0.0, -W2 / 2], [0.0, W2 / 2]],
                           dtype=x1.dtype, device=x1.device)
    d0 = x2[..., 0:2] - x1[..., 0:2]

    def rot(theta):
        c, s = torch.cos(theta), torch.sin(theta)
        return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)

    pts2 = torch.einsum("...ij,kj->...ki", rot(x2[..., 2]), corners) + d0[..., None, :]
    pts1 = torch.einsum("...ij,...kj->...ki", rot(-x1[..., 2]), pts2)
    dx = _abs(pts1[..., 0]) - L1 / 2.0 - tol
    dy = _abs(pts1[..., 1]) - W1 / 2.0 - tol
    return softmin(_expblend(dx, dy, alpha), 3.0, axis=-1)
