"""The highway merge (the reference package's ``envs/merge.py``): the
on-ramp geometry and the closed-loop environment on the host.

The ego starts on an on-ramp (a straight segment, then an arc) that joins the
main road; its reference line, as ``RefLine`` lookup tables over the ramp's X
coordinate, gives the per-lane shear transform ``S``, the reference state
and the lane bounds of the merge deployment (:class:`HighwayMergeEnv`, and
``envs/batched_merge.py`` over many worlds).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from belief_planning_tpu_torch.envs.highway import V0, ModelCalls, Vehicle
from belief_planning_tpu_torch.models.policies import RefLine

LANE_WIDTH = 3.6


def merge_geometry(N_lane, merge_lane, merge_s, merge_R, merge_side=0):
    """Ramp reference-line tables ``(X1, X2, Y1, Y2, psi1, psi2)``: the
    straight segment (1) and the arc (2), sampled every 0.5 m."""
    lw = LANE_WIDTH
    theta = np.arccos(1 - lw * merge_lane / merge_R)
    if merge_side == 0:
        arc_center = np.array([merge_s + merge_R * np.sin(theta),
                               (N_lane - merge_lane) * lw + merge_R])
        lane_start = np.array([merge_s - merge_s * np.cos(theta),
                               N_lane * lw + np.sin(theta) * merge_s])
    else:
        arc_center = np.array([merge_s + merge_R * np.sin(theta),
                               merge_lane * lw - merge_R])
        lane_start = np.array([merge_s - merge_s * np.cos(theta),
                               -np.sin(theta) * merge_s - lw * merge_lane])

    s1 = np.linspace(0, merge_s, num=int(merge_s / 0.5), endpoint=False)
    s2 = merge_s + np.linspace(0, merge_R * theta, num=int(merge_R * theta / 0.5))
    if merge_side == 0:
        X1 = lane_start[0] + s1 * np.cos(theta)
        Y1 = lane_start[1] - s1 * np.sin(theta)
        psi1 = -np.ones_like(s1) * theta
        psi2 = (s2 - s2[-1]) / merge_R
        X2 = arc_center[0] + np.sin(psi2) * merge_R
        Y2 = arc_center[1] - np.cos(psi2) * merge_R
    else:
        X1 = lane_start[0] + s1 * np.cos(theta)
        Y1 = lane_start[1] + s1 * np.sin(theta)
        psi1 = np.ones_like(s1) * theta
        psi2 = (s2[-1] - s2) / merge_R
        X2 = arc_center[0] - np.sin(psi2) * merge_R
        Y2 = arc_center[1] + np.cos(psi2) * merge_R - merge_lane * lw
    return X1, X2, Y1, Y2, psi1, psi2


def merge_ref_lines(N_lane, merge_lane, merge_s, merge_R, merge_side=0):
    """``(refY, refpsi)`` lookup tables over the ramp X coordinate (numpy knots)."""
    X1, X2, Y1, Y2, psi1, psi2 = merge_geometry(N_lane, merge_lane, merge_s, merge_R,
                                                merge_side)
    X = np.append(X1, X2)
    order = np.argsort(X)
    return (RefLine(xs=X[order], ys=np.append(Y1, Y2)[order]),
            RefLine(xs=X[order], ys=np.append(psi1, psi2)[order]))


class HighwayMergeEnv:
    """The merge world on the host: vehicle 0, the ego, starts on the ramp
    and is driven by ``mpc``, a ``BranchMPCCVaR`` built with ``use_S=True``;
    the others drive on the main road. ``models`` and ``policy_param_sets``
    are per lane, ``[main road, ramp]``: a vehicle past ``merge_s + 8`` has
    switched to lane 0, the main road.

    Before the switch the ego's solve runs in the ramp frame (the shear
    ``S``, the reference state and bounds ``bx`` from the ramp's reference
    line at its X); after it, with ``S`` the identity and the default
    ``bx``. The controller keeps the main-road model throughout, and each
    other vehicle computes its argmax-safety backup and then applies backup
    0, both as in the reference. ``seed`` seeds the (unused) generator.
    """

    def __init__(self, NV, N_lane, mpc, models, policy_param_sets, merge_lane=2, merge_s=50,
                 merge_R=300, merge_side=0, dt=0.05, cons=None, seed=0):
        self.dt = dt
        self.NV = NV
        self.laneID = [1] + [0] * (NV - 1)
        self.N_lane = N_lane
        self.merge_lane = merge_lane
        self.merge_s = merge_s
        self.merge_R = merge_R
        self.merge_side = merge_side
        self.models = models
        self.policy_param_sets = policy_param_sets
        self.mpc = mpc
        self.cons = cons
        self.LB = [cons.W / 2, N_lane * 3.6 - cons.W / 2]
        self.rng = np.random.default_rng(seed)
        self.calls = ModelCalls(mpc.device)
        self.refY, self.refpsi = merge_ref_lines(N_lane, merge_lane, merge_s, merge_R, merge_side)
        theta = np.arccos(1 - LANE_WIDTH * merge_lane / merge_R)
        self.merge_end = merge_s + merge_R * np.sin(theta)
        x0 = np.array([[24., 13., V0, -0.2], [15., 5.4, V0, 0.]])
        self.veh_set: List[Vehicle] = [Vehicle(x0[i].copy(), dt=self.dt) for i in range(NV)]

    def _model_u(self, lane, idx, x):
        return self.calls.policy_u(self.models[lane].policy_fns[idx],
                                   self.policy_param_sets[lane][idx], x)

    def _ref(self, line, X):
        return float(line(torch.tensor(X, dtype=torch.float64)))

    def step(self, t_):
        """One closed-loop step; returns as ``HighwayEnv.step``."""
        NV, cons = self.NV, self.cons
        n = 4
        u_set = [None] * NV
        xx_set = [None] * NV
        u0_set = [None] * NV
        x_set = [None] * NV
        branches = [None] * NV

        for i in range(NV):
            z = self.veh_set[i].state
            if z[0] > self.merge_s + 8:
                self.laneID[i] = 0
            lane = self.laneID[i]
            zp = self.calls.zpred(self.models[lane], z, self.policy_param_sets[lane])
            branches[i] = zp
            xx_set[i] = np.concatenate([zp[j] for j in range(self.models[lane].m)], axis=1)

        idx0 = self.veh_set[0].backupidx
        x1 = xx_set[0][:, idx0 * n:(idx0 + 1) * n]
        for i in range(NV):
            if i != 0:
                hi = self.calls.col_margin(x1, branches[i], (cons.L + 1, cons.W + 0.2))
                if self.laneID[i] == 0:       # main road: lane rows on its own branches
                    hi = np.minimum(hi, self.calls.lane_margin(branches[i], self.LB[0],
                                                               self.LB[1]))
                self.veh_set[i].backupidx = int(np.argmax(hi))
            # as in the reference, the choice is overridden by backup 0
            self.veh_set[i].backupidx = 0
            u0_set[i] = self._model_u(self.laneID[i], self.veh_set[i].backupidx,
                                      self.veh_set[i].state)

        x = self.veh_set[0].state
        if self.laneID[0] == 0:
            S = np.eye(4)
            xRef = np.array([0., (self.N_lane - 0.5) * 3.6, V0, 0.])
            # the default bx, passed explicitly after the switch
            bx = np.asarray(self.mpc.params.bx, float).ravel()
        else:
            y0 = self._ref(self.refY, x[0])
            psi0 = self._ref(self.refpsi, x[0])
            S = np.array([[1., 0, 0, 0], [-np.tan(psi0), 1., 0, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]])
            xRef = np.array([0., -np.tan(psi0) * x[0] + y0 + 1.8, V0, psi0])
            bx = np.array([
                -np.tan(psi0) * x[0] + y0 + 3.6 * self.merge_lane - cons.W / 2,
                np.tan(psi0) * x[0] - y0 - cons.W / 2,
                psi0 + self.mpc.psimax,
                -psi0 + self.mpc.psimax,
            ])
        self.mpc.solve(x, self.veh_set[1].state, xRef, S=S, bx=bx)

        u_set[0] = self.mpc.uPred[0]
        xPred, zPred, uPred, branch_w = self.mpc.BT2array()
        self.veh_set[0].step(u_set[0])
        x_set[0] = self.veh_set[0].state
        for i in range(1, NV):
            u_set[i] = u0_set[i]
            self.veh_set[i].step(u_set[i])
            x_set[i] = self.veh_set[i].state
        return u_set, x_set, xx_set, xPred, zPred, branch_w
