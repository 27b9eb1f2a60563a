"""The HMM-belief highway environment (the reference package's
``envs/hmm_highway.py``).

NV vehicles on an N_lane road. The ego (vehicle 0) runs the HMM-belief
controller (:class:`~belief_planning_tpu_torch.controllers.hmm_mpc.HMMMPC`);
every other vehicle tracks its lane with an LQR-like controller filtered
through a backup-CBF QP: a three-variable QP (the two inputs and a slack)
that keeps ``ḣ ≥ −αh`` along its chosen backup's rollout for the road
boundary and every other vehicle, by the rollout's sensitivity matrices.
After each step the ego's belief over that vehicle's backups is updated,
``b ← normalize((b·H(h)) ∘ P(u | CBF condition))``, the vehicle switches
backup at random by the transition matrix's row, and a vehicle more than
15 m from the ego is respawned near it (``replace_veh``).

The loop is NumPy with the reference's seeded ``numpy.random.Generator``,
so its draws are the reference's; the rollouts with sensitivities, the
margins, the transition matrix and the observation weight are this
package's functions, in f64 on the controller's device; the CBF QPs are
solved on the host by ``envs/small_qp.solve_qp``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from belief_planning_tpu_torch.envs.highway import ModelCalls
from belief_planning_tpu_torch.envs.small_qp import solve_qp
from belief_planning_tpu_torch.models.dynamics import dubins
from belief_planning_tpu_torch.models.hmm import (
    backup_input_prob,
    backup_traj_with_sensitivity,
    backup_trans,
)
from belief_planning_tpu_torch.models.safety import veh_col

V0 = 15.0
LANE_WIDTH = 3.6
EPS = 1e-6   # forward-difference step of the margins' gradients


def veh_con(x, x0, umax, ignore_x=True):
    """LQR-like lane-tracking controller with saturation."""
    if ignore_x:
        u = np.array([
            -0.8558 * (x[2] - x0[2]),
            -0.3162 * (x[1] - x0[1]) - 3.9889 * (x[3] - x0[3]),
        ])
    else:
        u = np.array([
            -0.3162 * (x[0] - x0[0]) - 0.8558 * (x[2] - x0[2]),
            -0.3162 * (x[1] - x0[1]) - 3.9889 * (x[3] - x0[3]),
        ])
    return np.clip(u, -umax, umax)


def x_bdry(x, bdry, width):
    """The nearer road boundary's margin and its gradient."""
    dy1 = x[1] - bdry[0] - width / 2
    dy2 = bdry[1] - x[1] - width / 2
    if dy1 < dy2:
        return dy1, np.array([0., 1., 0., 0.])
    return dy2, np.array([0., -1., 0., 0.])


class _Veh:
    def __init__(self, state, dt, backupidx=0, laneidx=0):
        self.state = np.asarray(state, float)
        self.dt = dt
        self.v_length = 4.0
        self.v_width = 2.4
        self.backupidx = backupidx
        self.laneidx = laneidx

    def step(self, u):
        x = self.state
        self.state = x + np.array(
            [x[2] * np.cos(x[3]), x[2] * np.sin(x[3]), u[0], u[1]]
        ) * self.dt


class _HMMCalls(ModelCalls):
    """The environment's model calls: NumPy in, NumPy out, f64 on ``device``."""

    def margins(self, x1, x2, size, alpha=1.0):
        """Clipped normalized margins of ``x1 (K, 4)`` against ``x2 (K, 4)``
        and their forward differences in X and Y: ``(h (K,), dh (K, 4))``,
        each difference taken as the reference takes it, ``(h(x + ε·e_k) −
        h(x)) / ε``."""
        x1, x2 = self.t(x1), self.t(x2)
        shifted = torch.stack([x1, x1, x1], dim=0)
        shifted[1, :, 0] += EPS
        shifted[2, :, 1] += EPS
        h = self.np(veh_col(shifted, x2, size, alpha=alpha, clip=5.0, normalize=True))
        dh = np.zeros((x1.shape[0], 4))
        dh[:, 0] = (h[1] - h[0]) / EPS
        dh[:, 1] = (h[2] - h[0]) / EPS
        return h[0], dh

    def rollouts(self, fn, p, x0, N, dt, f0):
        """Each row of ``x0 (V, 4)`` rolled ``N`` steps under ``fn`` with
        sensitivities: ``(xs (V, N, 4), QQ (V, N, 4, 4), Qt (V, N, 4))``."""
        pp = self.params((p,))[0]
        out = backup_traj_with_sensitivity(lambda x: dubins(x, fn(x, pp)), self.t(x0), N, dt,
                                           self.t(f0))
        return tuple(self.np(a) for a in out)


class HMMHighwayEnv:
    """The HMM-belief highway world: ``NV`` vehicles, vehicle 0 the ego
    driven by ``mpc`` (an ``HMMMPC``); ``seed`` seeds the placement, the
    lane changes, the backup switches and the respawns."""

    def __init__(self, NV, mpc, N_lane=6, seed=0):
        self.dt = mpc.model.dt
        self.NV = NV
        self.N_lane = N_lane
        self.mpc = mpc
        self.model = mpc.model
        self.cons = self.model.cons
        self.m = self.model.m
        self.rng = np.random.default_rng(seed)
        self.calls = _HMMCalls(mpc.device)
        self.b = np.ones((NV - 1, self.m)) / self.m
        self.f0 = np.array([V0, 0., 0., 0.])
        self.veh_set: List[_Veh] = []
        self.desired_x = [None] * NV
        for i in range(NV):
            lane = int(self.rng.random() * N_lane)
            while True:
                Y = (lane + 0.5) * LANE_WIDTH + self.rng.normal(0, 0.1)
                X = self.rng.random() * 30.0
                if all(not (abs(Y - v.state[1]) <= 3 and abs(X - v.state[0]) <= 8)
                       for v in self.veh_set):
                    break
            self.veh_set.append(_Veh([X, Y, V0, 0.], self.dt, 0, lane))
            v_des = V0 if i == 0 else V0 + self.rng.normal(0, 5)
            lane_des = self.rng.integers(N_lane)
            self.desired_x[i] = np.array([0., lane_des * LANE_WIDTH + LANE_WIDTH / 2, v_des, 0.])

    def _backup_rollouts(self, Nsteps):
        """``rolls[i][j] = (xs, QQ, Qt)``: vehicle i under policy j."""
        states = np.stack([v.state for v in self.veh_set])
        per_pol = [self.calls.rollouts(fn, p, states, Nsteps, self.dt, self.f0)
                   for fn, p in zip(self.model.policy_fns, self.model.policy_params)]
        return [[tuple(a[i] for a in per_pol[j]) for j in range(self.m)]
                for i in range(self.NV)]

    def step(self, t_=0):
        """One closed-loop step; returns ``(u_set, states)``."""
        NV, m, cons = self.NV, self.m, self.cons
        umax = np.array([cons.am, cons.rm])
        Nmpc = self.mpc.N
        Nroll = int(self.dt * Nmpc / self.dt) + int(2 / self.dt) + 2

        # lane bookkeeping
        for i in range(NV):
            v = self.veh_set[i]
            if abs(v.state[1] - (1.8 + v.laneidx * 3.6)) < 0.4:
                if i == 0:
                    mindis, idx = 1000.0, 0
                    for ii in range(1, NV):
                        dd = abs(self.veh_set[ii].state[0] - v.state[0])
                        if self.veh_set[ii].laneidx != v.laneidx and dd < mindis:
                            mindis, idx = dd, ii
                    if mindis < 4:
                        v.laneidx = self.veh_set[idx].laneidx
                elif self.rng.uniform() <= 0.05:
                    if v.laneidx == 0:
                        v.laneidx = 1
                    elif v.laneidx == self.N_lane - 1:
                        v.laneidx = self.N_lane - 2
                    else:
                        v.laneidx += 1 if self.rng.uniform() <= 0.5 else -1

        rolls = self._backup_rollouts(Nroll)
        u0_set = [None] * NV
        for i in range(NV):
            v = self.veh_set[i]
            x0 = v.state.copy()
            x0[1] = 1.8 + v.laneidx * 3.6
            x0[2] = self.veh_set[0].state[2] + 0.5 * (self.veh_set[0].state[0] - v.state[0])
            x0[3] = 0.0
            u0_set[i] = veh_con(v.state, x0, umax)

        # the ego's MPC over the belief-augmented state
        xbackup_steps = np.zeros((Nmpc, (NV - 1) * m, 4))
        for i in range(1, NV):
            for j in range(m):
                xbackup_steps[:, (i - 1) * m + j] = rolls[i][j][0][:Nmpc]
        Ydes = 1.8 + self.veh_set[0].laneidx * 3.6
        xRef = np.array([0., Ydes, V0, 0.])
        self.mpc.solve(self.veh_set[0].state, self.b, xbackup_steps, xRef)
        u_set = [self.mpc.uPred[0]]
        self.veh_set[0].step(u_set[0])

        # the other vehicles: backup-CBF QPs, belief update, backup switch
        g = np.array([[0., 0.], [0., 0.], [1., 0.], [0., 1.]])
        for i in range(1, NV):
            v = self.veh_set[i]
            x = v.state
            fi = np.array([x[2] * np.cos(x[3]), x[2] * np.sin(x[3]), 0., 0.])
            xs_i, QQ_i, Qt_i = rolls[i][v.backupidx]
            ts = list(range(0, xs_i.shape[0], 3))
            # the margins against each other vehicle's chosen backup, all t at once
            col = {}
            for jv in range(NV):
                if jv != i:
                    vj = self.veh_set[jv]
                    size = ((v.v_length + vj.v_length) / 2 + 1, (v.v_width + vj.v_width) / 2 + 0.2)
                    col[jv] = self.calls.margins(xs_i[ts], rolls[jv][vj.backupidx][0][ts], size)
            A_rows, b_rows = [], []
            for k, t in enumerate(ts):
                h, dhb = x_bdry(xs_i[t], [0, self.N_lane * LANE_WIDTH], v.v_width)
                if h < 0.5:
                    dhdx = dhb @ QQ_i[t]
                    if np.linalg.norm(dhdx @ g) > 1e-6:
                        A_rows.append(-(dhdx @ g))
                        b_rows.append(dhdx @ (fi - self.f0) - dhb @ Qt_i[t] + cons.alpha * h)
                for jv in range(NV):
                    if jv == i:
                        continue
                    h, dh = float(col[jv][0][k]), col[jv][1][k]
                    if h < 2:
                        dhdx = dh @ QQ_i[t]
                        if np.linalg.norm(dhdx @ g) > 1e-6:
                            A_rows.append(-(dhdx @ g))
                            b_rows.append(dhdx @ (fi - self.f0) + cons.alpha * h - dh @ Qt_i[t])
            if A_rows:
                A = np.array(A_rows)
                A = np.hstack([A, -np.ones((A.shape[0], 1))])
                A_full = np.vstack([
                    A,
                    np.hstack([np.eye(2), np.zeros((2, 1))]),
                    np.hstack([-np.eye(2), np.zeros((2, 1))]),
                    np.array([[0., 0., -1.]]),
                ])
                b_full = np.concatenate([np.array(b_rows), umax, umax, [0.0]])
                P = np.diag([1., 1., 0.])
                q = np.append(-u0_set[i], 1e6)
                sol = solve_qp(P, q, A=A_full, b=b_full, tol=1e-8, max_iter=40)
                u_i = sol.z[:2] if sol.status == "optimal" else u0_set[i]
            else:
                u_i = np.clip(u0_set[i], -umax, umax)
            u_set.append(u_i)
            v.step(u_i)

            if abs(v.state[0] - self.veh_set[0].state[0]) > 15:
                self.replace_veh(i)
            else:
                self._update_belief(i, v, u_i, rolls, Nmpc)
        return u_set, [v.state for v in self.veh_set]

    def _update_belief(self, i, v, u_i, rolls, Nmpc):
        """The ego's belief over vehicle i's backups, then its random switch."""
        m, cons, calls = self.m, self.cons, self.calls
        ego = self.veh_set[0]
        xdot = calls.np(dubins(calls.t(v.state), calls.t(u_i)))
        size = ((v.v_length + ego.v_length) / 2, (v.v_width + ego.v_width) / 2)
        xp = self.mpc.xPred
        xp_ego = np.stack([xp[min(tt, xp.shape[0] - 1), :4] for tt in range(Nmpc)])
        # every (policy, step) margin against the ego's plan in one call
        xs_all = np.concatenate([rolls[i][j][0][:Nmpc] for j in range(m)])
        h_all, dh_all = calls.margins(xs_all, np.tile(xp_ego, (m, 1)), size,
                                      alpha=cons.col_alpha)
        hi = np.zeros(m)
        cbfcond = np.zeros(m)
        for j in range(m):
            _, QQ_j, Qt_j = rolls[i][j]
            hij = h_all[j * Nmpc:(j + 1) * Nmpc]
            dhij = np.array([dh_all[j * Nmpc + tt] @ (QQ_j[tt] @ (xdot - self.f0) - Qt_j[tt])
                             for tt in range(Nmpc)])
            hi[j] = np.min(hij)
            cbfcond[j] = np.mean(hij + dhij)
        H = calls.np(backup_trans(calls.t(hi), cons))
        bi = self.b[i - 1].copy() @ H
        obs = calls.np(backup_input_prob(calls.t(cbfcond), cons))
        for j in range(m):
            bi[j] = bi[j] * float(obs[j])
        self.b[i - 1] = bi / np.sum(bi)
        probs = np.maximum(H[v.backupidx], 0)
        probs = probs / probs.sum()
        v.backupidx = int(self.rng.choice(m, p=probs))

    def replace_veh(self, idx, direction=2):
        """Respawn vehicle ``idx`` near the ego (0: ahead, 1: behind, else
        anywhere within 15 m) in a lane next to the ego's; at most 20 draws.
        Returns whether it placed the vehicle."""
        if idx == 0:
            return False
        ego = self.veh_set[0]
        if direction == 0:
            LB, UB = ego.state[0] + 8, ego.state[0] + 13
        elif direction == 1:
            LB, UB = ego.state[0] - 13, ego.state[0] - 5
        else:
            LB, UB = ego.state[0] - 15, ego.state[0] + 15
        if ego.laneidx == 0:
            lane = 1
        elif ego.laneidx == self.N_lane - 1:
            lane = self.N_lane - 2
        else:
            lane = ego.laneidx + (1 if self.rng.uniform() <= 0.5 else -1)
        for _ in range(20):
            Y = (lane + 0.5) * LANE_WIDTH + self.rng.normal(0, 0.1)
            X = self.rng.random() * (UB - LB) + LB
            ok = all(not (abs(Y - self.veh_set[i].state[1]) <= 2.2
                          and abs(X - self.veh_set[i].state[0]) <= 5)
                     for i in range(self.NV) if i != idx)
            if ok:
                self.veh_set[idx] = _Veh([X, Y, ego.state[2], 0.], self.dt, 0, lane)
                self.b[idx - 1] = np.ones(self.m) / self.m
                return True
        return False
