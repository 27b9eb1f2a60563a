"""The port's merge lane-switch gate's loop, shared by the gate
(``tests/test_torch_reference_scale.py::test_merge_reference_scale_lane_switch``)
and ``scripts/torch_port_merge_gate_step.py``: the merge demo
(``main_branch.py:56-88``) in the port, the gate's oracle and controller,
its ``HighwayMergeEnv``, and ``DualSolveMPC``, what the env drives.

The oracle's QCQP has the JAX gate's 800 iterations (``BP_ORACLE_ITERS``
overrides it for forensics); where it does not end ``optimal`` there, the
step is solved again from the oracle as it stood, at ORACLE_RETRY_ITERS
(``solve_oracle``). No JAX: the oracle is NumPy and SciPy only.
"""

import copy
import os

import numpy as np
import torch

from belief_planning_tpu.oracle.qcqp import QCQPSolution
from belief_planning_tpu.oracle.reference_cvar import OracleCVaRController

from belief_planning_tpu_torch.controllers.cvar_mpc import BranchMPCCVaR
from belief_planning_tpu_torch.envs.merge import HighwayMergeEnv, merge_ref_lines
from belief_planning_tpu_torch.models.policies import merge_policy_set
from belief_planning_tpu_torch.models.predictive import merge_model
from belief_planning_tpu_torch.presets import init_branch_mpc
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
from belief_planning_tpu_torch.utils.config import BranchConstants
from torch_port_cvar_hard_oracle import PortModelAdapter

# N_lane, merge_lane, merge_s, merge_R, merge_side
MERGE_ROAD = (2, 1, 50, 300, 0)
# the oracle's budget on a step where its QCQP stops at 800 iterations
# (step 24 or 26 of the port's trajectory, with the CPU's thread counts)
ORACLE_RETRY_ITERS = 3000


def merge_demo_setup(N=40, NB=1):
    """The merge demo's constants, its normal and merge policy sets and
    models, and the MPC parameters."""
    am, rm, dt = 7.0, 0.3, 0.1
    v0 = 20.0
    cons = BranchConstants(am=am, rm=rm)
    _, refpsi = merge_ref_lines(*MERGE_ROAD)
    psets = merge_policy_set(cons, v0, None), merge_policy_set(cons, v0, refpsi)
    models = tuple(merge_model(cons, ps, N=N, dt=dt) for ps in psets)
    params = init_branch_mpc(4, 2, N, NB, np.array([0.5, 1.8, 15.0, 0.0]), am, rm,
                             MERGE_ROAD[0], cons.W)
    return cons, psets, models, params


def merge_gate_controllers(params, model, pset, device="cpu"):
    """The merge gate's oracle and the port's controller (IPM-480 with 2
    Gondzio correctors, a 120-iteration restart, f64)."""
    oracle = OracleCVaRController(params, PortModelAdapter(model, pset.params), ralpha=0.1)
    mpc = BranchMPCCVaR(params, model, pset.params, ralpha=0.1, use_S=True,
                        ipm=CVaRIPMConfig(iters=480, gondzio=2), restart=120,
                        dtype=torch.float64, device=device)
    return oracle, mpc


def merge_gate_env(mpc, cons, psets, models):
    N_lane, merge_lane, merge_s, merge_R, merge_side = MERGE_ROAD
    return HighwayMergeEnv(NV=2, N_lane=N_lane, mpc=mpc, models=list(models),
                           policy_param_sets=[ps.params for ps in psets],
                           merge_lane=merge_lane, merge_s=merge_s, merge_R=merge_R,
                           merge_side=merge_side, dt=0.1, cons=cons, seed=0)


def oracle_tree_p(oracle, m):
    """Branch probabilities of the oracle's current tree in BFS order, the
    engine's ``carry.p`` layout (n_branches, m); leaves, which never feed
    the warm shift, get uniform filler (``tests/test_reference_scale.py``'s
    ``_oracle_tree_p``)."""
    if getattr(oracle, "BT", None) is None:
        return None
    ps = []
    for br in oracle.branches_bfs():
        p = getattr(br, "p", None)
        ps.append(np.full(m, 1.0 / m) if p is None else np.asarray(p, float).ravel())
    return np.stack(ps)


def solve_oracle(oracle, prog, iters, retry_iters=ORACLE_RETRY_ITERS):
    """The oracle's solve of ``prog`` (x, z, xRef, S, Fx, bx) at tol 1e-8 and
    ``iters`` iterations; where its QCQP does not end ``optimal``, the step
    solved again from a copy of the oracle as it stood, at ``retry_iters``.
    Returns the oracle that solved, its input and whether it retried."""
    before = copy.deepcopy(oracle)
    u = oracle.solve(**prog, tol=1e-8, max_iter=iters)
    sol = oracle.solution
    if isinstance(sol, QCQPSolution) and sol.status == "optimal":
        return oracle, u, False
    return before, before.solve(**prog, tol=1e-8, max_iter=retry_iters), True


class StepReached(Exception):
    """Raised by ``DualSolveMPC.solve`` at its ``stop_at`` step."""


class DualSolveMPC:
    """What the merge env drives: each ``solve`` runs the oracle and the
    port's controller on the same (x, z, xRef, S, bx); the controller first
    from its own warm start (the free series, unless ``free`` is false),
    then from the oracle's previous solution (the forced series, whose input
    is applied), as ``tests/test_reference_scale.py``'s ``_DualSolveMPC``.

    At step ``stop_at`` it keeps the step's program, the forced warm start,
    the controller's carry and a copy of the oracle in ``program``, solves
    nothing and raises ``StepReached``."""

    def __init__(self, mpc, oracle, free=True, stop_at=None, progress=None):
        self._mpc = mpc
        self._oracle = oracle
        self.free, self.stop_at = free, stop_at
        self.progress = (bool(os.environ.get("BP_GATE_PROGRESS")) if progress is None
                         else progress)
        self.errs, self.errs_free, self.gaps, self.oq, self.retried = [], [], [], [], []
        self.program = None

    def solve(self, x, z, xRef=None, S=None, Fx=None, bx=None):
        t = len(self.errs)
        o = self._oracle
        prev_u = None if o.uPred is None else np.asarray(o.uPred).copy()
        prev_old = np.asarray(o.OldInput).copy() if prev_u is not None else None
        prev_p = oracle_tree_p(o, self._mpc.topo.m) if prev_u is not None else None
        prog = dict(x=x, z=z, xRef=xRef, S=S, Fx=Fx, bx=bx)
        if t == self.stop_at:
            self.program = dict(prog, prev_u=prev_u, prev_p=prev_p, prev_old=prev_old,
                                carry=self._mpc.carry, oracle=copy.deepcopy(o))
            raise StepReached
        self._oracle, u_o, retried = solve_oracle(
            o, prog, int(os.environ.get("BP_ORACLE_ITERS", "800")))
        self.retried.append(retried)
        assert self._oracle.feasible, (f"oracle failed at step {t}: "
                                       f"{self._oracle.solution.status} "
                                       f"pr={self._oracle.solution.prim_res:.2e}")
        self.oq.append(self._oracle.quality)
        if prev_u is not None:
            c = self._mpc.carry
            if self.free:
                u_free = self._mpc.solve(**prog)
                self.errs_free.append(np.abs(np.asarray(u_free) - u_o).max())
            tt = lambda a: torch.as_tensor(a, dtype=c.u_lin.dtype, device=c.u_lin.device)[None]
            self._mpc.carry = c._replace(u_lin=tt(prev_u), p=tt(prev_p), old_input=tt(prev_old))
        elif self.free:
            self.errs_free.append(0.0)
        u_j = self._mpc.solve(**prog)
        self.errs.append(np.abs(np.asarray(u_j) - u_o).max())
        self.gaps.append(float(self._mpc.last.gap))
        if self.progress:
            free = f" free={self.errs_free[-1]:.3e}" if self.free else ""
            print(f"[gate] t={t} forced={self.errs[-1]:.3e}{free} gap={self.gaps[-1]:.2e} "
                  f"tier={self.oq[-1]}/{self._oracle.solution.status} "
                  f"oracle_iters={self._oracle.solution.iterations}"
                  f"{' (retried)' if retried else ''}", flush=True)
        return u_j

    def __getattr__(self, name):
        return getattr(self._mpc, name)
