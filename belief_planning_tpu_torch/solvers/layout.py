"""Batch-last layout helpers for the fused solver.

The solver keeps the batch axis LAST, ``(nodes, i, j, B)``: in the CUDA
kernel, with one thread per tree, element ``e`` of lane ``t`` sits at
``e*B + t`` so a warp's loads are contiguous.
"""

from __future__ import annotations

import torch

from belief_planning_tpu_torch.solvers.tree_qp import StageCost


def _to_bl(a):
    """(B, ...) → (..., B), contiguous."""
    return torch.movedim(a, 0, -1).contiguous()


def _from_bl(a):
    """(..., B) → (B, ...), contiguous."""
    return torch.movedim(a, -1, 0).contiguous()


def cost_to_bl(cost: StageCost) -> StageCost:
    """A batch-leading StageCost as batch-last; ``slack_quad`` stays (B,)."""
    return StageCost(*(c if name == "slack_quad" else _to_bl(c)
                       for name, c in zip(StageCost._fields, cost)))


def _small_inv_bl(M):
    """Closed-form inverse of (..., i, j, Z) tiny matrices (j ≤ 3), not LU."""
    d = M.shape[-2]
    if d == 1:
        return 1.0 / M
    if d == 2:
        a, b = M[..., 0, 0, :], M[..., 0, 1, :]
        c, e = M[..., 1, 0, :], M[..., 1, 1, :]
        det = a * e - b * c
        inv = torch.stack([torch.stack([e, -b], dim=-2),
                           torch.stack([-c, a], dim=-2)], dim=-3)
        return inv / det[..., None, None, :]
    if d == 3:
        a, b, c = M[..., 0, 0, :], M[..., 0, 1, :], M[..., 0, 2, :]
        e, f, g = M[..., 1, 0, :], M[..., 1, 1, :], M[..., 1, 2, :]
        h, i, j = M[..., 2, 0, :], M[..., 2, 1, :], M[..., 2, 2, :]
        A = f * j - g * i
        B = -(e * j - g * h)
        C = e * i - f * h
        det = a * A + b * B + c * C
        inv = torch.stack([
            torch.stack([A, -(b * j - c * i), b * g - c * f], dim=-2),
            torch.stack([B, a * j - c * h, -(a * g - c * e)], dim=-2),
            torch.stack([C, -(a * i - b * h), a * f - b * e], dim=-2),
        ], dim=-3)
        return inv / det[..., None, None, :]
    raise NotImplementedError("batch-last inverse only for d<=3")
