"""A small dense QP solver for the host environments (this package's copy of
the reference package's ``oracle/qp.solve_qp``, in NumPy alone).

Solves ``min ½ zᵀP z + qᵀz  s.t.  A z ≤ b,  G z = g`` with a Mehrotra
predictor-corrector interior-point method. P must be PSD (it may be
singular: a small static regularization keeps the KKT system solvable).
The HMM highway environment solves each obstacle's backup-CBF QP (three
variables) with it. Where the reference factors the KKT matrix once an
iteration with SciPy's LU and solves twice, this copy calls
``numpy.linalg.solve`` (the same LAPACK LU with partial pivoting) for each
direction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class QPSolution:
    z: np.ndarray
    y_eq: Optional[np.ndarray]
    lam: Optional[np.ndarray]
    s: Optional[np.ndarray]
    iterations: int
    status: str           # "optimal" | "max_iter"
    gap: float


def _max_step(v, dv):
    neg = dv < 0
    if not np.any(neg):
        return 1.0
    return min(1.0, float(np.min(-v[neg] / dv[neg])))


def solve_qp(P, q, A=None, b=None, G=None, g=None, tol: float = 1e-9, max_iter: int = 60,
             reg: float = 1e-10) -> QPSolution:
    P = np.asarray(P, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64).ravel()
    nz = q.shape[0]
    has_ineq = A is not None and A.shape[0] > 0
    has_eq = G is not None and G.shape[0] > 0
    A = np.asarray(A, dtype=np.float64) if has_ineq else np.zeros((0, nz))
    b = np.asarray(b, dtype=np.float64).ravel() if has_ineq else np.zeros(0)
    G = np.asarray(G, dtype=np.float64) if has_eq else np.zeros((0, nz))
    g = np.asarray(g, dtype=np.float64).ravel() if has_eq else np.zeros(0)
    mi, me = A.shape[0], G.shape[0]

    def kkt(Hzz):
        K = np.zeros((nz + me, nz + me))
        K[:nz, :nz] = Hzz + reg * np.eye(nz)
        K[:nz, nz:] = G.T
        K[nz:, :nz] = G
        K[nz:, nz:] = -reg * np.eye(me)
        return K

    if mi == 0:
        # equality-constrained: one KKT solve
        sol = np.linalg.solve(kkt(P), np.concatenate([-q, g]))
        return QPSolution(sol[:nz], sol[nz:], np.zeros(0), np.zeros(0), 1, "optimal", 0.0)

    z = np.zeros(nz)
    y = np.zeros(me)
    s = np.ones(mi)
    lam = np.ones(mi)
    status = "max_iter"
    gap = np.inf
    it = 0
    for it in range(1, max_iter + 1):
        r_dual = P @ z + q + G.T @ y + A.T @ lam
        r_eq = G @ z - g
        r_ineq = A @ z + s - b
        gap = float(np.dot(s, lam) / mi)
        small = lambda r, ref: np.linalg.norm(r, np.inf) < tol * (1 + np.linalg.norm(ref, np.inf))
        if (small(r_dual, q) and (me == 0 or small(r_eq, g)) and small(r_ineq, b)
                and gap < tol):
            status = "optimal"
            break

        K = kkt(P + (A.T * (lam / s)) @ A)

        def solve_dir(rd, re, ri, rc):
            # eliminate (ds, dlam): ds = −ri − A dz, dlam = (−rc − λ·ds)/s
            rhs_z = -rd - A.T @ ((-rc + lam * ri) / s)
            sol = np.linalg.solve(K, np.concatenate([rhs_z, -re]))
            dz, dy = sol[:nz], sol[nz:]
            ds = -ri - A @ dz
            return dz, dy, ds, (-rc - lam * ds) / s

        # predictor, then the corrector with σ = (μ_aff/μ)³
        dz_a, dy_a, ds_a, dlam_a = solve_dir(r_dual, r_eq, r_ineq, s * lam)
        alpha_aff = min(_max_step(s, ds_a), _max_step(lam, dlam_a))
        mu = gap
        mu_aff = float(np.dot(s + alpha_aff * ds_a, lam + alpha_aff * dlam_a) / mi)
        sigma = (mu_aff / mu) ** 3 if mu > 0 else 0.0
        rc = s * lam + ds_a * dlam_a - sigma * mu
        dz, dy, ds, dlam = solve_dir(r_dual, r_eq, r_ineq, rc)
        alpha = 0.99 * min(_max_step(s, ds), _max_step(lam, dlam))
        z += alpha * dz
        y += alpha * dy
        s += alpha * ds
        lam += alpha * dlam

    return QPSolution(z, y, lam, s, it, status, gap)
