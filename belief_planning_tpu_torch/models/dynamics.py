"""Continuous-time dynamics ``f(x, u) -> xdot`` (leading batch dims allowed)."""

from __future__ import annotations

import torch


def dubins(x, u):
    """Vehicle state ``(X, Y, v, ψ)``, input ``(a, r)``:
    ``ẋ = [v·cosψ, v·sinψ, a, r]``."""
    return torch.stack([x[..., 2] * torch.cos(x[..., 3]),
                        x[..., 2] * torch.sin(x[..., 3]), u[..., 0], u[..., 1]],
                       dim=-1)
