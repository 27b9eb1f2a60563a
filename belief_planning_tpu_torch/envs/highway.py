"""The highway overtake environment in closed loop, one world on the host
(the reference package's ``envs/highway.py``).

The ego runs a single-tree controller (``BranchMPC``, ``BranchMPCProx`` or
``BranchMPCCVaR``); every other vehicle applies the backup policy of
largest safety over its rollouts, on the numeric path (clipped vehicle
margins, the lane rows evaluated on the ego's branch, the simulator's brake
constants), and rolls a random lane intent every 10 steps that, as in the
reference, is recorded but never applied. The loop is NumPy with a seeded
``numpy.random.Generator``, so its draws are exactly the reference's; the
rollouts, policies and margins are this package's functions, in f64 on the
controller's device.

``respawn=True`` brings a vehicle that is more than 15 m from the ego back
near it (``replace_veh``); vehicles beyond the second are placed by the same
sampler. The controller's reference and lane-change target follow the ego
and vehicle 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from belief_planning_tpu_torch.models import policies as pol
from belief_planning_tpu_torch.models.safety import lane_bdry_h, veh_col

V0 = 20.0
LANE_WIDTH = 3.6


@dataclass
class Vehicle:
    """A vehicle's true state ``(X, Y, v, ψ)`` with an Euler step."""

    state: np.ndarray
    dt: float
    v_length: float = 4.0
    v_width: float = 2.4
    backupidx: int = 0
    laneidx: int = 0

    def step(self, u):
        x = self.state
        dxdt = np.array([x[2] * np.cos(x[3]), x[2] * np.sin(x[3]), u[0], u[1]])
        self.state = x + dxdt * self.dt


class ModelCalls:
    """The host loop's calls of the port's model functions: NumPy in, NumPy
    out, computed in f64 on ``device``."""

    def __init__(self, device):
        self.device = device

    def t(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64,
                               device=self.device)

    def params(self, pp):
        return pol.cast_params(pp, torch.float64, self.device)

    @staticmethod
    def np(a):
        return a.detach().cpu().numpy()

    def zpred(self, model, z, pp):
        """``(m, N, n)`` rollouts of ``z`` under each policy."""
        return self.np(model.zpred(self.t(z), self.params(pp)))

    def policy_u(self, fn, p, x):
        return self.np(fn(self.t(x), self.params((p,))[0]))

    def col_margin(self, x1, branches, size):
        """Each branch's least clipped vehicle margin ``(m,)`` between the
        ego branch ``x1 (N, n)`` and ``branches (m, N, n)``."""
        return self.np(veh_col(self.t(x1)[None], self.t(branches), size, clip=5.0).amin(dim=-1))

    def lane_margin(self, traj, lb, ub):
        """The least lane-boundary margin of ``traj (..., N, n)``: ``(...)``."""
        return self.np(lane_bdry_h(self.t(traj), lb, ub).amin(dim=-1))


class HighwayEnv:
    """The overtake world: vehicle 0 is the ego driven by ``mpc``, vehicle 1
    the obstacle it overtakes (``NV`` vehicles in all). ``lc_target`` is the
    ego's initial lane-change target; ``seed`` seeds the lane intent and the
    respawn sampler."""

    def __init__(self, NV, mpc, cons, lc_target, N_lane=6, seed=0, respawn=False):
        self.dt = mpc.model.dt
        self.NV = NV
        self.N_lane = N_lane
        self.mpc = mpc
        self.cons = cons
        self.m = mpc.model.m
        self.LB = [cons.W / 2, N_lane * 3.6 - cons.W / 2]
        self.rng = np.random.default_rng(seed)
        self.respawn = respawn
        self.calls = ModelCalls(mpc.device)
        x0 = np.array([[0., 1.8, V0, 0.], [5., 5.4, V0, 0.]])
        self.veh_set: List[Vehicle] = [
            Vehicle(x0[i].copy(), dt=self.dt, laneidx=int(round((x0[i, 1] - 1.8) / 3.6)))
            for i in range(min(NV, 2))
        ]
        # vehicles beyond the second: placed by the respawn sampler, or
        # staggered behind the ego when it finds no room
        for i in range(2, NV):
            self.veh_set.append(Vehicle(x0[1].copy(), dt=self.dt))
            if not self.replace_veh(i, 2):
                lane = (i - 1) % N_lane
                self.veh_set[i] = Vehicle(np.array([-8. * (i - 1), 1.8 + 3.6 * lane, V0, 0.]),
                                          dt=self.dt, laneidx=lane)
        self.desired_x = [np.array([0., self.veh_set[i].state[1], V0, 0.]) for i in range(NV)]
        self.lc_target = np.asarray(lc_target, float)
        self._sim_pset = pol.highway_policy_set(cons, self.lc_target, mpc_path=False)

    def _with_probability(self, P):
        return self.rng.uniform() <= P

    def replace_veh(self, idx, direction=2):
        """Respawn vehicle ``idx`` near the ego: ``direction`` 0 ahead (+8..+13
        m), 1 behind (−13..−5 m), else anywhere (±15 m); in a lane next to the
        ego's; at most 20 draws, each checked against the other vehicles.
        ``desired_x`` is kept, as in the reference. Returns whether it
        placed the vehicle."""
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
            lane = ego.laneidx - 1 if self._with_probability(0.5) else ego.laneidx + 1
        for _ in range(20):
            Y = (lane + 0.5) * LANE_WIDTH + self.rng.normal(0, 0.1)
            X = self.rng.random() * (UB - LB) + LB
            ok = all(
                not (abs(Y - self.veh_set[i].state[1]) <= 2.2
                     and abs(X - self.veh_set[i].state[0]) <= 5)
                for i in range(len(self.veh_set)) if i != idx
            )
            if ok:
                self.veh_set[idx] = Vehicle(np.array([X, Y, ego.state[2], 0.]), dt=self.dt,
                                            backupidx=0, laneidx=lane)
                return True
        return False

    def _sim_policy_u(self, idx, x):
        return self.calls.policy_u(self._sim_pset.fns[idx], self._sim_pset.params[idx], x)

    def step(self, t_):
        """One closed-loop step. Returns ``(u_set, x_set, xx_set, xPred,
        zPred, branch_w)``: each vehicle's input and new state, its backup
        rollouts ``(N, m·n)``, and the controller's branches (``BT2array``)."""
        NV, m, cons = self.NV, self.m, self.cons
        n = 4
        u_set = [None] * NV
        xx_set = [None] * NV
        u0_set = [None] * NV
        x_set = [None] * NV
        branches = [None] * NV

        # 1. backup rollouts and lane bookkeeping
        for i in range(NV):
            z = self.veh_set[i].state
            zp = branches[i] = self.calls.zpred(self.mpc.model, z, self.mpc.policy_params)
            xx_set[i] = np.concatenate([zp[j] for j in range(m)], axis=1)  # (N, m*n)
            newlane = int(round((z[1] - 1.8) / 3.6))
            if t_ == 0 or (newlane != self.veh_set[i].laneidx
                           and abs(z[1] - 1.8 - 3.6 * newlane) < 1.4):
                self.veh_set[i].laneidx = newlane
                self.desired_x[i][1] = 1.8 + newlane * 3.6
                if i == 1:
                    # retarget the ego's lane-change backup around the obstacle
                    l0, l1 = self.veh_set[0].laneidx, self.veh_set[1].laneidx
                    if l0 < l1:
                        tgt_lane = l1 - 1
                    elif l0 > l1:
                        tgt_lane = l1 + 1
                    else:
                        tgt_lane = l1 - 1 if l1 > 0 else l1 + 1
                    xRef_lc = np.array([0., 1.8 + 3.6 * tgt_lane, V0, 0.])
                    self.lc_target = xRef_lc
                    new_params = list(self.mpc.policy_params)
                    new_params[2] = pol.LaneChangeParams(x_target=xRef_lc)
                    self.mpc.update_policy_params(tuple(new_params))
                    self._sim_pset = pol.highway_policy_set(cons, xRef_lc, mpc_path=False)
            if t_ % 10 == 0 and i != 0:
                if self._with_probability(0.5):
                    li = self.veh_set[i].laneidx
                    if li == 0:
                        self.desired_x[i][1] = 5.4
                    elif li == self.N_lane - 1:
                        self.desired_x[i][1] = 1.8 + (self.N_lane - 2) * 3.6
                    elif self._with_probability(0.5):
                        self.desired_x[i][1] = 1.8 + (li - 1) * 3.6
                    else:
                        self.desired_x[i][1] = 1.8 + (li + 1) * 3.6

        # 2. each other vehicle's backup: the largest least margin
        idx0 = self.veh_set[0].backupidx
        x1 = xx_set[0][:, idx0 * n:(idx0 + 1) * n]
        for i in range(NV):
            if i != 0:
                hi = np.minimum(self.calls.col_margin(x1, branches[i], (cons.L + 1, cons.W + 0.2)),
                                self.calls.lane_margin(x1, self.LB[0], self.LB[1]))
                self.veh_set[i].backupidx = int(np.argmax(hi))
            u0_set[i] = self._sim_policy_u(self.veh_set[i].backupidx, self.veh_set[i].state)

        # 3. the overtake reference
        ego, obs = self.veh_set[0], self.veh_set[1]
        Ydes = 1.8 + ego.laneidx * 3.6 if ego.state[0] < obs.state[0] else obs.state[1]
        if abs(ego.state[1] - Ydes) < 1 and ego.state[0] > obs.state[0] + 3:
            vdes = V0
        else:
            vdes = obs.state[2] + 1 * (obs.state[0] + 1.5 - ego.state[0])
        xRef = np.array([0., Ydes, vdes, 0.])

        # 4. solve, apply the inputs
        self.mpc.solve(ego.state, obs.state, xRef)
        u_set[0] = self.mpc.uPred[0]
        xPred, zPred, uPred, branch_w = self.mpc.BT2array()
        ego.step(u_set[0])
        x_set[0] = ego.state
        for i in range(1, NV):
            u_set[i] = u0_set[i]
            self.veh_set[i].step(u_set[i])
            x_set[i] = self.veh_set[i].state
            if self.respawn and abs(self.veh_set[i].state[0] - self.veh_set[0].state[0]) > 15:
                if not self.replace_veh(i, 0):
                    self.replace_veh(i, 2)
                x_set[i] = self.veh_set[i].state
        return u_set, x_set, xx_set, xPred, zPred, branch_w


def highway_sim(env, T):
    """Run ``env`` for ``T`` seconds (``round(T / dt)`` steps), recording as
    the reference's ``Highway_sim``: ``(state_rec (NV, steps, 4), input_rec
    (NV, steps, 2), backup_rec, backup_choice_rec, xPred_rec, zPred_rec,
    branch_w_rec, collision)``. ``collision`` is set when two vehicles'
    rectangles overlap before a step. Any env with ``veh_set``, ``NV``,
    ``dt`` and ``step(t)`` runs here (``HighwayMergeEnv`` too)."""
    collision = False
    N = int(round(T / env.dt))
    state_rec = np.zeros([env.NV, N, 4])
    backup_rec = [[None] * N for _ in range(env.NV)]
    backup_choice_rec = [[None] * N for _ in range(env.NV)]
    xPred_rec = [None] * N
    zPred_rec = [None] * N
    branch_w_rec = [None] * N
    input_rec = np.zeros([env.NV, N, 2])
    for i in range(env.NV):
        state_rec[i][0] = env.veh_set[i].state
    for t in range(N):
        if not collision:
            for i in range(env.NV):
                for j in range(env.NV):
                    if i != j:
                        vi, vj = env.veh_set[i], env.veh_set[j]
                        dis = max(
                            abs(vi.state[0] - vj.state[0]) - 0.5 * (vi.v_length + vj.v_length),
                            abs(vi.state[1] - vj.state[1]) - 0.5 * (vi.v_width + vj.v_width),
                        )
                        if dis < 0:
                            collision = True
        u_set, x_set, xx_set, xPred, zPred, branch_w = env.step(t)
        xPred_rec[t] = xPred
        zPred_rec[t] = zPred
        branch_w_rec[t] = branch_w
        for i in range(env.NV):
            input_rec[i][t] = u_set[i]
            state_rec[i][t] = x_set[i]
            backup_rec[i][t] = xx_set[i]
            backup_choice_rec[i][t] = env.veh_set[i].backupidx
    return (state_rec, input_rec, backup_rec, backup_choice_rec,
            xPred_rec, zPred_rec, branch_w_rec, collision)
