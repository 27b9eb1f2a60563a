"""Batched linearization of the Euler step with ``torch.func.jacfwd``."""

from __future__ import annotations

from typing import Callable

from torch.func import jacfwd, vmap


def discrete_step(dyn: Callable, x, u, dt: float):
    """Forward-Euler discrete dynamics ``x⁺ = x + f(x, u)·dt``."""
    return x + dyn(x, u) * dt


def linearize_dynamics(dyn: Callable, x, u, dt: float):
    """Linearize ``x⁺ = A x + B u + C`` about ``(x, u)``; returns
    ``(A, B, C, xp)`` with ``C = xp − A·x − B·u``. ``x`` and ``u`` may carry
    leading batch dimensions (vmapped)."""

    def f(xi, ui):
        return discrete_step(dyn, xi, ui, dt)

    def single(xi, ui):
        A = jacfwd(f, argnums=0)(xi, ui)
        B = jacfwd(f, argnums=1)(xi, ui)
        xp = f(xi, ui)
        C = xp - A @ xi - B @ ui
        return A, B, C, xp

    if x.ndim == 1:
        return single(x, u)
    batch_shape = x.shape[:-1]
    n, d = x.shape[-1], u.shape[-1]
    A, B, C, xp = vmap(single)(x.reshape(-1, n), u.reshape(-1, d))
    return (A.reshape(batch_shape + (n, n)), B.reshape(batch_shape + (n, d)),
            C.reshape(batch_shape + (n,)), xp.reshape(batch_shape + (n,)))
