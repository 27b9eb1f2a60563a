"""The quadruped environment in closed loop (the reference package's
``envs/quadruped.py``): two robots, the ego running ``BranchMPCProx``
toward a goal, the other walking with forward/stop backups.

Kept from the reference:

- the obstacle's sticky policy: it keeps ``forward`` while that rollout's
  least margin to the ego's branch exceeds 0.5, else takes the largest; the
  margin is the environment's 2-norm ``robot_col`` while the controller's
  tree uses the 1-norm;
- the goal-seeking reference: a step of at most 5 m toward the goal, the
  heading wrapped to within π of the goal's; ``ref_mode="ros"`` takes the
  reference's ROS variant instead, ``arctan2(dx[0], dx[1])`` (its argument
  order) with the goal itself as ``xRef``.

The loop is NumPy; the rollouts, policies and margins are this package's
functions, in f64 on the controller's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from belief_planning_tpu_torch.envs.highway import ModelCalls
from belief_planning_tpu_torch.models.safety import robot_col


@dataclass
class Robot:
    """A robot's true state ``(X, Y, θ)`` with an Euler step of its
    body-frame kinematics."""

    state: np.ndarray
    dt: float
    L: float = 1.0
    W: float = 0.5
    backupidx: int = 0

    def step(self, u):
        th = self.state[2]
        dxdt = np.array([
            u[0] * np.cos(th) - u[1] * np.sin(th),
            u[1] * np.cos(th) + u[0] * np.sin(th),
            u[2],
        ])
        self.state = self.state + dxdt * self.dt


def _wrap_to(psi, ref):
    while psi - ref > np.pi:
        psi -= 2 * np.pi
    while psi - ref < -np.pi:
        psi += 2 * np.pi
    return psi


class QuadEnv:
    """The two-robot world: robot 0 the ego driven by ``mpc`` toward
    ``x_des``; robot 1 starts at ``(2.5, 2.5, −π/2)``."""

    def __init__(self, NR, mpc, x_des, cons, ref_mode="default"):
        if ref_mode not in ("default", "ros"):
            raise ValueError(f"unknown ref_mode {ref_mode!r}")
        self.dt = mpc.model.dt
        self.NR = NR
        self.mpc = mpc
        self.cons = cons
        self.m = mpc.model.m
        self.ref_mode = ref_mode
        self.calls = ModelCalls(mpc.device)
        x0 = np.array([[0., 1.8, 0.], [2.5, 2.5, -np.pi / 2]])
        self.robot_set: List[Robot] = [Robot(x0[0].copy(), dt=self.dt, L=cons.L1, W=cons.W1)]
        for i in range(1, NR):
            self.robot_set.append(Robot(x0[i].copy(), dt=self.dt, L=cons.L2, W=cons.W2))
        self.desired_x = [np.asarray(x_des, float)] + [x0[i].copy() for i in range(1, NR)]

    def _sim_policy_u(self, idx, x):
        return self.calls.policy_u(self.mpc.model.policy_fns[idx], self.mpc.policy_params[idx], x)

    def _xref(self, ego):
        """The goal-seeking reference of ``ref_mode``."""
        goal = self.desired_x[0]
        dx = goal[0:2] - ego.state[0:2]
        nrm = np.linalg.norm(dx)
        dxc = dx / nrm * min(nrm, 5.0) if nrm > 0 else dx
        ros = self.ref_mode == "ros"
        if np.linalg.norm(dxc) > 0.1:
            psiRef = np.arctan2(dxc[0], dxc[1]) if ros else np.arctan2(dxc[1], dxc[0])
            psiRef = _wrap_to(psiRef, goal[2])
        else:
            psiRef = ego.state[2]
        if ros:
            xRef = goal.copy()
        else:
            xRef = ego.state.copy()
            xRef[0:2] += dxc
        xRef[2] = psiRef
        return xRef

    def step(self, t_):
        """One closed-loop step: ``(u_set, x_set, xx_set, xPred, zPred)``,
        each robot's input, new state and backup rollouts ``(N, m·3)``, and
        the controller's branches."""
        NR, m, cons = self.NR, self.m, self.cons
        n = 3
        u_set, x_set, u0_set = [None] * NR, [None] * NR, [None] * NR
        zps = [self.calls.zpred(self.mpc.model, r.state, self.mpc.policy_params)
               for r in self.robot_set]
        xx_set = [np.concatenate([zp[j] for j in range(m)], axis=1) for zp in zps]

        idx0 = self.robot_set[0].backupidx
        x1 = self.calls.t(xx_set[0][:, idx0 * n:(idx0 + 1) * n])
        for i in range(NR):
            r = self.robot_set[i]
            if i != 0:
                ego = self.robot_set[0]
                hcol = robot_col(x1[None], self.calls.t(zps[i]), ego.L, ego.W, r.L, r.W,
                                 cons.col_tol, ord=2)
                hi = self.calls.np(hcol.amin(dim=-1))
                r.backupidx = 0 if hi[0] > 0.5 else int(np.argmax(hi))   # sticky forward
            u0_set[i] = self._sim_policy_u(r.backupidx, r.state)

        ego = self.robot_set[0]
        self.mpc.solve(ego.state, self.robot_set[1].state, self._xref(ego))
        u_set[0] = self.mpc.uPred[0]
        xPred, zPred, uPred, branch_w = self.mpc.BT2array()
        ego.step(u_set[0])
        x_set[0] = ego.state
        for i in range(1, NR):
            u_set[i] = u0_set[i]
            self.robot_set[i].step(u_set[i])
            x_set[i] = self.robot_set[i].state
        return u_set, x_set, xx_set, xPred, zPred


def robot_sim(env, T):
    """Run ``env`` for ``T`` seconds (``round(T / dt)`` steps), recording as
    the reference's ``Robot_sim``: ``(state_rec (NR, steps, 3), input_rec
    (NR, steps, 3), backup_rec, backup_choice_rec, xPred_rec, zPred_rec)``."""
    N = int(round(T / env.dt))
    state_rec = np.zeros([env.NR, N, 3])
    backup_rec = [[None] * N for _ in range(env.NR)]
    backup_choice_rec = [[None] * N for _ in range(env.NR)]
    xPred_rec = [None] * N
    zPred_rec = [None] * N
    input_rec = np.zeros([env.NR, N, 3])
    for i in range(env.NR):
        state_rec[i][0] = env.robot_set[i].state
    for t in range(N):
        u_set, x_set, xx_set, xPred, zPred = env.step(t)
        xPred_rec[t] = xPred
        zPred_rec[t] = zPred
        for i in range(env.NR):
            input_rec[i][t] = u_set[i]
            state_rec[i][t] = x_set[i]
            backup_rec[i][t] = xx_set[i]
            backup_choice_rec[i][t] = env.robot_set[i].backupidx
    return state_rec, input_rec, backup_rec, backup_choice_rec, xPred_rec, zPred_rec
