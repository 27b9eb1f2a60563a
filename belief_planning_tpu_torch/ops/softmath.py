"""Soft-math operators (the reference package's ``ops/softmath.py``).

Exp-weighted soft operators ``Σ e^{±γx} x / Σ e^{±γx}`` (not log-sum-exp),
stabilised by subtracting the largest exponent.
"""

from __future__ import annotations

import torch


def softsat(x, s):
    """Saturating squash to (0, 1): ``0.5·(tanh(s·x/2) + 1)``."""
    return 0.5 * (torch.tanh(0.5 * s * x) + 1.0)


def _soft(x, t, axis):
    if axis is None:
        t = t - torch.amax(t)
        w = torch.exp(t)
        return torch.sum(w * x) / torch.sum(w)
    t = t - torch.amax(t, dim=axis, keepdim=True)
    w = torch.exp(t)
    return torch.sum(w * x, dim=axis) / torch.sum(w, dim=axis)


def softmin(x, gamma=1.0, axis=None):
    """Exp-weighted soft minimum ``Σ e^{-γx} x / Σ e^{-γx}``."""
    return _soft(x, -gamma * x, axis)


def softmax(x, gamma=1.0, axis=None):
    """Exp-weighted soft maximum ``Σ e^{γx} x / Σ e^{γx}``."""
    return _soft(x, gamma * x, axis)


def softmax_pair(a, b, gamma=1.0):
    """Two-argument softmax; ``a`` and ``b`` broadcast against each other."""
    a, b = torch.broadcast_tensors(torch.as_tensor(a, dtype=b.dtype, device=b.device), b)
    return softmax(torch.stack([a, b], dim=0), gamma, axis=0)
