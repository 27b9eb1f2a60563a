"""HMM belief predictive model (the reference package's ``models/hmm.py``).

The ego plans over a belief-augmented state ``xb = (x, b)``, ``b (M, m)``
a belief over each uncontrolled agent's backup policy. The belief follows
an HMM whose transition matrix is driven by each policy's safety
(:func:`backup_trans`); the controller gates its collision rows on it.

Functions take leading batch dimensions; the Jacobians are per-sample
``torch.func.jacfwd`` under ``torch.func.vmap``, as ``ops/linearize.py``
takes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Tuple

import torch
from torch.func import jacfwd, vmap

from belief_planning_tpu_torch.models.dynamics import dubins
from belief_planning_tpu_torch.models.policies import cast_params
from belief_planning_tpu_torch.models.safety import lane_bdry_h, veh_col
from belief_planning_tpu_torch.ops.softmath import softmin_pair, softsat


def backup_trans(h, cons):
    """HMM transition matrix ``(..., m, m)`` from per-policy safety ``h (...,
    m)``: ``(1−tran_diag)·1·(softsat(h, s1)ᵀ/Σ) + tran_diag·I``."""
    s = softsat(h, cons.s1)
    row = s / torch.sum(s, dim=-1, keepdim=True)
    mm = h.shape[-1]
    eye = torch.eye(mm, dtype=h.dtype, device=h.device)
    return (1.0 - cons.tran_diag) * row[..., None, :].expand(h.shape[:-1] + (mm, mm)) \
        + cons.tran_diag * eye


def backup_input_prob(cbfcond, cons):
    """Observation weight ``P(u | CBF condition) = softsat(cond − c2, s2)``."""
    return softsat(cbfcond - cons.c2, cons.s2)


@dataclass(frozen=True)
class HMMPredictiveModel:
    """Belief-augmented predictive model. State ``xb = [x (nx,), b.ravel()
    (M·m,)]``, ``n = nx + M·m``; ``xbackup (M·m, nx)`` holds each obstacle's
    per-policy predicted state at the current step."""

    nx: int
    d: int
    M: int
    m: int
    dt: float
    cons: object = field(repr=False)
    policy_fns: Tuple[Callable, ...] = field(repr=False)
    policy_params: Tuple = field(repr=False)

    @property
    def n(self) -> int:
        return self.nx + self.M * self.m

    def split(self, xb):
        return xb[..., :self.nx], xb[..., self.nx:].reshape(xb.shape[:-1] + (self.M, self.m))

    def safety(self, xb, xbackup):
        """Per-obstacle, per-policy safety ``(..., M, m)``: softmin of the
        size-normalized ego–backup margin and the backup state's lane
        margin."""
        c = self.cons
        x = xb[..., :self.nx]
        hcol = veh_col(x[..., None, :], xbackup, (c.L + 1.0, c.W + 0.2), normalize=True)
        hlane = lane_bdry_h(xbackup, c.ylb, c.yub)
        h = softmin_pair(hcol, hlane, c.col_alpha)
        return h.reshape(h.shape[:-1] + (self.M, self.m))

    def step(self, xb, u, xbackup):
        """Augmented dynamics: an Euler ego step and the HMM belief update."""
        x, b = self.split(xb)
        xp = x + dubins(x, u) * self.dt
        H = backup_trans(self.safety(xb, xbackup), self.cons)       # (..., M, m, m)
        bp = torch.einsum("...i,...ij->...j", b, H)
        return torch.cat([xp, bp.reshape(bp.shape[:-2] + (-1,))], dim=-1)

    def _linearize_one(self, xb, u, xbackup):
        """``linearize`` of one sample."""
        A = jacfwd(self.step, argnums=0)(xb, u, xbackup)
        B = jacfwd(self.step, argnums=1)(xb, u, xbackup)
        C = self.step(xb, u, xbackup) - A @ xb - B @ u
        hfun = lambda xx: self.safety(xx, xbackup).reshape(-1)
        Jh = jacfwd(hfun)(xb)                                       # (M·m, n)
        h0 = hfun(xb) - Jh @ xb
        return (A, B, C, h0.reshape(self.M, self.m), Jh.reshape(self.M, self.m, self.n))

    def linearize(self, xb, u, xbackup):
        """``(A, B, C, h0, Jh)``: the augmented step's Jacobians and the
        linearized safety rows ``h ≈ h0 + Jh·xb``. ``xb (..., n)``, ``u
        (..., d)`` and ``xbackup (..., M·m, nx)`` share their leading dims."""
        if xb.dim() == 1:
            return self._linearize_one(xb, u, xbackup)
        lead = xb.shape[:-1]
        outs = vmap(self._linearize_one)(xb.reshape(-1, xb.shape[-1]), u.reshape(-1, u.shape[-1]),
                                         xbackup.reshape((-1,) + xbackup.shape[-2:]))
        return tuple(o.reshape(lead + o.shape[1:]) for o in outs)

    def generate_backup_traj(self, z_all, N, device=None):
        """Each obstacle ``z_all (..., M, nx)`` rolled ``N`` steps under each
        policy: ``(..., N, M·m, nx)`` (obstacle-major)."""
        pp = cast_params(self.policy_params, z_all.dtype, z_all.device if device is None
                         else device)
        rows = []
        for i in range(self.M):
            for fn, p in zip(self.policy_fns, pp):
                x, xs = z_all[..., i, :], []
                for _ in range(N):
                    x = x + dubins(x, fn(x, p)) * self.dt
                    xs.append(x)
                rows.append(torch.stack(xs, dim=-2))
        return torch.stack(rows, dim=-2)


def backup_traj_with_sensitivity(dyn_closed, x0, N, dt, f0):
    """Euler rollout of ``ẋ = dyn_closed(x)`` with its sensitivity ``Q̇ =
    J·Q`` from ``Q = I``, and ``Qt = ẋ − f0``, each recorded before its
    step: ``(xs (..., N, nx), QQ (..., N, nx, nx), Qt (..., N, nx))``.
    ``x0 (..., nx)`` may carry leading batch dims."""
    nx = x0.shape[-1]
    lead = x0.shape[:-1]
    x = x0.reshape(-1, nx)
    Qm = torch.eye(nx, dtype=x0.dtype, device=x0.device).expand(x.shape[0], nx, nx)
    jac = vmap(jacfwd(dyn_closed))
    xs, QQ, Qt = [], [], []
    for _ in range(N):
        xdot = dyn_closed(x)
        J = jac(x)
        xs.append(x)
        QQ.append(Qm)
        Qt.append(xdot - f0)
        x = x + xdot * dt
        Qm = Qm + (J @ Qm) * dt
    shape = lambda t: t.reshape(lead + t.shape[1:])
    return (shape(torch.stack(xs, 1)), shape(torch.stack(QQ, 1)), shape(torch.stack(Qt, 1)))
