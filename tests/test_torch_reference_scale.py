"""Reference-scale closed-loop gates of the port (slow: ``-m slow``), the
counterparts of two gates of ``tests/test_reference_scale.py``, at the
reference demos' exact sizes, against the dense f64 NumPy oracle whose model
calls the port's model computes (``PortModelAdapter``), on the CPU in f64:

- overtake prox-QP (``:170``): ``BranchMPCProx`` at IPM-30, N=8, NB=2, 100
  closed-loop steps, both worlds driven by their own inputs: max deviation
  of the applied input < 1e-3 (``BASELINE.md``);
- merge lane switch (``:378``): ``BranchMPCCVaR`` (IPM-480 with 2 Gondzio
  correctors and a 120-iteration restart, use_S) on ``HighwayMergeEnv``,
  N=40, NB=1, 30 steps across the laneID switch, teacher-forced through the
  env (each solve also runs the oracle on the same inputs and the engine's
  warm start is the oracle's previous solution), with the JAX gate's bars:
  1e-3 on tight steps, 1e-2 and at most 8 loose steps over all, and the
  free-running series' envelope (max < 2, median < 0.1);
- the parity episode's fork (``scripts/torch_port_f32_parity_episode.py``):
  the demo overtake at B=1, the parity-grade mode (``refine10``: an f32
  IPM-8 solve and a 10-iteration f64 restart) against the f64 IPM-40 loop,
  on the loop's states (the reference script's "teacher-forced" series, in
  which each step still re-linearizes around the mode's own warm start).
  The JAX package (``backend="pl_xla"``, the plain fused layout on the CPU)
  and the port part from their f64 loops at the same step by the same
  O(1e-2): a warm start 1e-7 off flips the linearization there. With the
  warm start forced as well, the port's mode stays within 1e-5 of its loop.

Run: ``python -m pytest tests/test_torch_reference_scale.py -m slow``
(the JAX package's quadruped gate's port is in ``test_torch_quad_env.py``;
its overtake CVaR gate is not ported yet)."""

import os

import numpy as np
import pytest
import torch

from belief_planning_tpu.oracle.reference_cvar import OracleCVaRController
from belief_planning_tpu.oracle.reference_tree import OracleBranchController

from belief_planning_tpu_torch.controllers.branch_mpc import BranchMPCProx
from belief_planning_tpu_torch.controllers.cvar_mpc import BranchMPCCVaR
from belief_planning_tpu_torch.envs.merge import HighwayMergeEnv, merge_ref_lines
from belief_planning_tpu_torch.models.policies import highway_policy_set, merge_policy_set
from belief_planning_tpu_torch.models.predictive import highway_model, merge_model
from belief_planning_tpu_torch.presets import init_branch_mpc
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig
from belief_planning_tpu_torch.utils.config import BranchConstants

from tests.test_reference_scale import _closed_loop, _oracle_tree_p
from tests.test_torch_admm_oracle import PortModelAdapter
from tests.test_torch_port_scripts import SCRIPTS

pytestmark = pytest.mark.slow

F64 = torch.float64


def overtake_demo_setup(N=8, NB=2):
    """The demo overtake (``main_branch.py:24-48``) in the port."""
    am, rm, dt, N_lane = 6.0, 0.3, 0.1, 4
    xRef = np.array([0.5, 1.8, 15.0, 0.0])
    cons = BranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2, am=am, rm=rm,
                           J_c=20, s_c=1, ylb=0.0, yub=7.2, L=4, W=2.5, col_alpha=5, Kpsi=0.1)
    pset = highway_policy_set(cons, xRef)
    model = highway_model(cons, pset, N=N, dt=dt)
    params = init_branch_mpc(4, 2, N, NB, xRef, am, rm, N_lane, cons.W)
    return cons, pset, model, params


def test_overtake_reference_scale_prox():
    cons, pset, model, params = overtake_demo_setup()
    oracle = OracleBranchController(params, PortModelAdapter(model, pset.params), "prox")
    mpc = BranchMPCProx(params, model, pset.params, ipm=QPIPMConfig(iters=30), device="cpu")
    x0, z0 = np.array([0.0, 1.8, 20.0, 0.0]), np.array([9.0, 1.8, 17.0, 0.0])
    errs = _closed_loop(oracle, mpc, cons, model.dt, 100, x0, z0, params.xRef)
    print(f"\novertake prox gate: max {errs.max():.3e} at step {int(errs.argmax())}")
    assert errs.max() < 1e-3, f"max closed-loop deviation {errs.max():.2e} " \
                              f"at step {int(errs.argmax())}"


class DualSolveMPC:
    """What the merge env drives: each ``solve`` runs the oracle and the
    port's controller on the same (x, z, xRef, S, bx); the controller first
    from its own warm start (the free series), then from the oracle's
    previous solution (the forced series, whose input is applied), as
    ``tests/test_reference_scale.py``'s ``_DualSolveMPC``."""

    def __init__(self, mpc, oracle):
        self._mpc = mpc
        self._oracle = oracle
        self.errs, self.errs_free, self.gaps, self.oq = [], [], [], []

    def solve(self, x, z, xRef=None, S=None, Fx=None, bx=None):
        prev_u = None if self._oracle.uPred is None else np.asarray(self._oracle.uPred).copy()
        prev_old = np.asarray(self._oracle.OldInput).copy() if prev_u is not None else None
        prev_p = (_oracle_tree_p(self._oracle, self._mpc.topo.m)
                  if prev_u is not None else None)
        # the JAX gate's oracle budget; BP_ORACLE_ITERS overrides it for forensics
        u_o = self._oracle.solve(x, z, xRef=xRef, S=S, Fx=Fx, bx=bx, tol=1e-8,
                                 max_iter=int(os.environ.get("BP_ORACLE_ITERS", "800")))
        assert self._oracle.feasible, (f"oracle failed: {self._oracle.solution.status} "
                                       f"pr={self._oracle.solution.prim_res:.2e}")
        self.oq.append(self._oracle.quality)
        if prev_u is not None:
            c = self._mpc.carry
            u_free = self._mpc.solve(x, z, xRef=xRef, S=S, Fx=Fx, bx=bx)
            self.errs_free.append(np.abs(np.asarray(u_free) - u_o).max())
            t = lambda a: torch.as_tensor(a, dtype=c.u_lin.dtype, device=c.u_lin.device)[None]
            self._mpc.carry = c._replace(u_lin=t(prev_u), p=t(prev_p), old_input=t(prev_old))
        else:
            self.errs_free.append(0.0)
        u_j = self._mpc.solve(x, z, xRef=xRef, S=S, Fx=Fx, bx=bx)
        self.errs.append(np.abs(np.asarray(u_j) - u_o).max())
        self.gaps.append(float(self._mpc.last.gap))
        if os.environ.get("BP_GATE_PROGRESS"):
            print(f"[gate] t={len(self.errs) - 1} forced={self.errs[-1]:.3e} "
                  f"free={self.errs_free[-1]:.3e} gap={self.gaps[-1]:.2e} "
                  f"tier={self.oq[-1]}/{self._oracle.solution.status}", flush=True)
        return u_j

    def __getattr__(self, name):
        return getattr(self._mpc, name)


def test_merge_reference_scale_lane_switch():
    N, NB = 40, 1
    am, rm, dt = 7.0, 0.3, 0.1
    N_lane, merge_lane, merge_s, merge_R, merge_side = 2, 1, 50, 300, 0
    v0 = 20.0
    cons = BranchConstants(am=am, rm=rm)
    _, refpsi = merge_ref_lines(N_lane, merge_lane, merge_s, merge_R, merge_side)
    pset_normal = merge_policy_set(cons, v0, None)
    pset_merge = merge_policy_set(cons, v0, refpsi)
    model_normal = merge_model(cons, pset_normal, N=N, dt=dt)
    model_merge = merge_model(cons, pset_merge, N=N, dt=dt)
    params = init_branch_mpc(4, 2, N, NB, np.array([0.5, 1.8, 15.0, 0.0]), am, rm, N_lane,
                             cons.W)
    oracle = OracleCVaRController(params, PortModelAdapter(model_normal, pset_normal.params),
                                  ralpha=0.1)
    mpc = BranchMPCCVaR(params, model_normal, pset_normal.params, ralpha=0.1, use_S=True,
                        ipm=CVaRIPMConfig(iters=480, gondzio=2), restart=120, dtype=F64,
                        device="cpu")
    dual = DualSolveMPC(mpc, oracle)
    env = HighwayMergeEnv(NV=2, N_lane=N_lane, mpc=dual, models=[model_normal, model_merge],
                          policy_param_sets=[pset_normal.params, pset_merge.params],
                          merge_lane=merge_lane, merge_s=merge_s, merge_R=merge_R,
                          merge_side=merge_side, dt=dt, cons=cons, seed=0)
    lane_ids = []
    for t in range(30):
        env.step(t)
        lane_ids.append(env.laneID[0])
    errs, errs_free = np.array(dual.errs), np.array(dual.errs_free)
    gaps, oq = np.array(dual.gaps), np.array(dual.oq)
    print(f"\nmerge gate forced errs:   {errs.round(8).tolist()}")
    print(f"merge gate unforced errs: {errs_free.round(8).tolist()}")
    print(f"merge gate gaps:          {gaps.round(8).tolist()}")
    print(f"merge gate oracle tiers:  {oq.tolist()}")
    assert lane_ids[0] == 1 and lane_ids[-1] == 0, \
        f"episode never crossed the laneID switch: {lane_ids}"
    tight = (gaps < 1e-5) & (oq == "tight")
    n_loose = int((~tight).sum())
    assert tight.any(), "no tight steps"
    assert errs[tight].max() < 1e-3, (f"max per-step deviation {errs[tight].max():.2e} on a "
                                      f"tight step; gaps={gaps.round(8).tolist()}")
    assert errs.max() < 1e-2 and n_loose <= 8, (
        f"jam/inaccuracy envelope violated: max forced {errs.max():.2e}, {n_loose} non-tight "
        f"steps; gaps={gaps.round(8).tolist()}")
    assert errs_free.max() < 2.0, f"unforced max {errs_free.max():.2e}"
    assert np.nanmedian(errs_free) < 0.1, f"unforced median {np.nanmedian(errs_free):.2e}"


FORK_STEPS = 26


def _jax_refine10_forced_series():
    """The JAX package's f64 IPM-40 loop and its refine10 mode forced on the
    loop's states (``scripts/f32_parity_episode.py`` on ``pl_xla``)."""
    import jax
    import jax.numpy as jnp

    from belief_planning_tpu.controllers.branch_mpc import make_branch_mpc_batched_step
    from belief_planning_tpu.models.policies import highway_policy_set as j_highway_set
    from belief_planning_tpu.models.predictive import highway_model as j_highway_model
    from belief_planning_tpu.presets import init_branch_mpc as j_init
    from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig
    from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants

    xRef, dt = np.array([0.5, 1.8, 15.0, 0.0]), 0.1
    cons = JBranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2, am=6.0, rm=0.3,
                            J_c=20, s_c=1, ylb=0.0, yub=7.2, L=4, W=2.5, col_alpha=5, Kpsi=0.1)
    pset = j_highway_set(cons, xRef)
    model = j_highway_model(cons, pset, N=8, dt=dt)
    params = j_init(4, 2, 8, 2, xRef, 6.0, 0.3, 4, cons.W)

    def episode(dtype, ipm, refine=0, forced=None, sd=None):
        _, init_carry, step = make_branch_mpc_batched_step(model, params, "prox", ipm=ipm,
                                                           backend="pl_xla", refine_f64=refine,
                                                           solve_dtype=sd)
        js = jax.jit(step)
        carry = jax.tree.map(lambda a: jnp.broadcast_to(a, (1,) + a.shape), init_carry(dtype))
        x, z = np.array([0.0, 1.8, 20.0, 0.0]), np.array([9.0, 1.8, 17.0, 0.0])
        us, states = [], []
        for k in range(FORK_STEPS):
            if forced is not None:
                x, z = forced[k]
            states.append((x.copy(), z.copy()))
            carry, res = js(carry, jnp.asarray(x[None], dtype), jnp.asarray(z[None], dtype),
                            jnp.asarray(xRef[None], dtype), pset.params)
            u = np.asarray(res.uPred[0, 0], np.float64)
            us.append(u)
            x = x + np.array([x[2] * np.cos(x[3]), x[2] * np.sin(x[3]), u[0], u[1]]) * dt
            z = z + np.array([z[2] * np.cos(z[3]), z[2] * np.sin(z[3]), 0.0,
                              -cons.Kpsi * z[3]]) * dt
        return np.asarray(us), states

    u64, states = episode(jnp.float64, JQPIPMConfig(iters=40))
    uf, _ = episode(jnp.float64, JQPIPMConfig(iters=8, gondzio=2), 10, states, jnp.float32)
    return np.abs(uf - u64).max(axis=1)


def test_parity_episode_fork_is_the_references(monkeypatch):
    import importlib.util

    monkeypatch.syspath_prepend(SCRIPTS)
    spec = importlib.util.spec_from_file_location(
        "torch_port_f32_parity_episode", f"{SCRIPTS}/torch_port_f32_parity_episode.py")
    ep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ep)
    cons, pset, model, params = ep.demo()
    from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_batched_step

    def make_step(mode):
        _, ipm, refine, sd = mode
        _, init_carry, step = make_branch_mpc_batched_step(model, params, "prox", ipm=ipm,
                                                           refine_f64=refine, solve_dtype=sd,
                                                           device="cpu")
        return init_carry, step

    episode = ep.make_episode(make_step, pset, cons.Kpsi, FORK_STEPS, "cpu")
    u64, _, states, carries = episode(ep.REFERENCE)
    forced = np.abs(episode(ep.MODES["refine10"], forced_states=states)[0] - u64).max(axis=1)
    warm = np.abs(episode(ep.MODES["refine10"], forced_states=states,
                          forced_carries=carries)[0] - u64).max(axis=1)
    j_forced = _jax_refine10_forced_series()
    print(f"\nrefine10 on the f64 loop's states, by step: port {forced.round(8).tolist()}"
          f"\n  JAX package {j_forced.round(8).tolist()}\n  port, warm starts forced too "
          f"{warm.round(10).tolist()}")
    fork = int(np.argmax(forced > 1e-3))
    assert forced.max() > 1e-3 and fork == int(np.argmax(j_forced > 1e-3))
    assert forced[:fork].max() < 1e-5 and j_forced[:fork].max() < 1e-5
    assert abs(forced[fork] - j_forced[fork]) < 1e-3
    assert warm.max() < 1e-5
