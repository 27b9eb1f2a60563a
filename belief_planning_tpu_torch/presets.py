"""Scenario parameter factories (the reference package's ``presets.py``)."""

from __future__ import annotations

import numpy as np

from belief_planning_tpu_torch.utils.config import BranchMPCParams


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
