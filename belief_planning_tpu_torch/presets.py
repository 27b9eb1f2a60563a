"""Scenario parameter factories (the reference package's ``presets.py``)."""

from __future__ import annotations

import numpy as np

from belief_planning_tpu_torch.utils.config import BranchMPCParams, MPCParams


def init_branch_mpc(n, d, N, NB, xRef, am, rm, N_lane, W) -> BranchMPCParams:
    """Highway branch-MPC parameters (reference ``Init_MPC.py:40-72``)."""
    Fx = np.array([
        [0., 1., 0., 0.],
        [0., -1., 0., 0.],
        [0., 0., 0., 1.],
        [0., 0., 0., -1.],
    ])
    bx = np.array([N_lane * 3.6 - W / 2, -W / 2, 0.25, 0.25])
    Fu = np.kron(np.eye(2), np.array([1., -1.])).T
    bu = np.array([am, am, rm, rm])
    Q = np.diag([0., 3., 3., 10.])
    R = np.diag([1., 100.])
    Qslack = np.array([0., 300.])
    return BranchMPCParams(
        n=n, d=d, N=N, NB=NB, Q=Q, R=R, Fx=Fx, bx=bx, Fu=Fu, bu=bu,
        xRef=np.asarray(xRef, float), slacks=True, Qslack=Qslack, timeVarying=True,
    )


def init_quad_branch_mpc(n, d, N, NB, xRef, vxm, vym, rm) -> BranchMPCParams:
    """Quadruped branch-MPC parameters (reference ``Init_MPC.py:74-94``): no
    state rows (``Fx`` of shape (0, n)), the asymmetric forward-velocity
    bound vx ∈ [0, vxm] and the rate cost ``dR = [0.9, 5, 1]``."""
    Fx = np.empty((0, n))
    bx = np.empty((0,))
    Fu = np.kron(np.eye(3), np.array([1., -1.])).T
    bu = np.array([vxm, 0., vym, vym, rm, rm])
    Q = np.diag([1., 1., 1.])
    R = np.diag([1., 100., 1.])
    dR = np.array([0.9, 5., 1.])
    Qslack = np.array([0., 300.])
    return BranchMPCParams(
        n=n, d=d, N=N, NB=NB, Q=Q, R=R, dR=dR, Fx=Fx, bx=bx, Fu=Fu, bu=bu,
        xRef=np.asarray(xRef, float), slacks=True, Qslack=Qslack, timeVarying=True,
    )


def init_mpc_params(nx, d, N, M, m, ydes, vdes, am, rm, N_lane, W) -> MPCParams:
    """The HMM belief controller's parameters (reference ``Init_MPC.py:7-34``)
    over the belief-augmented state ``(x, b)`` of ``nx + M·m`` entries: the
    state rows and weights act on ``x`` alone, and the braking bound is half
    the acceleration bound."""
    Fx = np.array([
        [0., 1., 0., 0.],
        [0., -1., 0., 0.],
        [0., 0., 0., 1.],
        [0., 0., 0., -1.],
    ])
    Fx = np.hstack((Fx, np.zeros((Fx.shape[0], m * M))))
    bx = np.array([N_lane * 3.6 - W / 2, -W / 2, 0.25, 0.25])
    Fu = np.kron(np.eye(2), np.array([1., -1.])).T
    bu = np.array([am, 0.5 * am, rm, rm])
    Qx = np.diag([0., 0.5, 0.2, 5.])
    Q = np.zeros((nx + M * m, nx + M * m))
    Q[:nx, :nx] = Qx
    R = np.diag([30., 100.])
    xRef = np.append(np.array([0., ydes, vdes, 0.]), np.zeros(M * m))
    Qslack = np.array([0., 1000.])
    return MPCParams(
        n=nx + M * m, d=d, N=N, M=M, m=m, Q=Q, R=R, Fx=Fx, bx=bx, Fu=Fu, bu=bu,
        xRef=xRef, slacks=True, Qslack=Qslack, timeVarying=True,
    )
