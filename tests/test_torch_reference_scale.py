"""Reference-scale closed-loop gates of the port (slow: ``-m slow``), the
counterparts of three gates of ``tests/test_reference_scale.py``, at the
reference demos' exact sizes, against the dense f64 NumPy oracle whose model
calls the port's model computes (``PortModelAdapter``), on the CPU in f64:

- overtake prox-QP (``:170``): ``BranchMPCProx`` at IPM-30, N=8, NB=2, 100
  closed-loop steps, both worlds driven by their own inputs: max deviation
  of the applied input < 1e-3 (``BASELINE.md``);
- overtake CVaR (``:183-257``): ``BranchMPCCVaR`` at IPM-100 with 2 Gondzio
  correctors and a 60-iteration restart, ralpha 0.9, N=8, NB=2, 100 steps
  (``BP_GATE_STEPS``), the oracle at tol 1e-9 and 300 iterations, with the
  JAX gate's bars: the teacher-forced series (the engine on the oracle's
  state and previous solution) < 1e-3 on tight steps, its max < 5e-3 with
  at most 12 loose and max(2, steps // 12) failed-oracle steps; the free
  closed loop's median < 1e-3, max < 0.1, at most one step in 10 above 1e-2
  (``scripts/torch_port_cvar_overtake_gate_diag.py`` prints its series);
- merge lane switch (``:378``): ``BranchMPCCVaR`` (IPM-480 with 2 Gondzio
  correctors and a 120-iteration restart, use_S) on ``HighwayMergeEnv``,
  N=40, NB=1, 30 steps across the laneID switch, teacher-forced through the
  env (each solve also runs the oracle on the same inputs and the engine's
  warm start is the oracle's previous solution), with the JAX gate's bars:
  1e-3 on tight steps, 1e-2 and at most 8 loose steps over all, and the
  free-running series' envelope (max < 2, median < 0.1). The oracle's QCQP
  has the JAX gate's 800 iterations; where it stops there (step 24 or 26
  of the port's trajectory, with the CPU's thread counts) the step is
  solved again from the oracle as it stood with ORACLE_RETRY_ITERS (the
  gate's loop: ``scripts/torch_port_merge_gate.py``; one step re-solved by
  three engines: ``scripts/torch_port_merge_gate_step.py``);
- the QP parity episode's fork (``scripts/torch_port_f32_parity_episode.py``):
  the demo overtake at B=1, the parity-grade mode (``refine10``: an f32
  IPM-8 solve and a 10-iteration f64 restart) against the f64 IPM-40 loop,
  on the loop's states (the reference script's "teacher-forced" series, in
  which each step still re-linearizes around the mode's own warm start).
  The JAX package (``backend="pl_xla"``, the plain fused layout on the CPU)
  and the port part from their f64 loops at the same step by the same
  O(1e-2): a warm start 1e-7 off flips the linearization there. With the
  warm start forced as well, the port's mode stays within 1e-5 of its loop;
- the CVaR parity episode's parting (``test_cvar_parity_episode_parting``,
  ``scripts/torch_port_cvar_parity_episode.py``): its refine10 against its
  f64 IPM-40 loop with states and warm starts forced, in both packages on
  the port's loop's programs, the oracle's verdict on which of the two is
  converged, and the packages' refine10 within 1e-3 of each other on the
  steps where a 1e-7 nudge of the ego's speed moves neither by 1e-4.

Run: ``python -m pytest tests/test_torch_reference_scale.py -m slow``
(the JAX package's quadruped gate's port is in ``test_torch_quad_env.py``)."""

import os

import numpy as np
import pytest
import torch

from belief_planning_tpu.oracle.reference_cvar import OracleCVaRController
from belief_planning_tpu.oracle.reference_tree import OracleBranchController

from belief_planning_tpu_torch.controllers.branch_mpc import BranchMPCProx
from belief_planning_tpu_torch.controllers.cvar_mpc import BranchMPCCVaR
from belief_planning_tpu_torch.models.policies import highway_policy_set
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.presets import init_branch_mpc
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig
from belief_planning_tpu_torch.utils.config import BranchConstants

from tests.test_reference_scale import _closed_loop
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


class _CarryArrays:
    """A port carry seen as the JAX package's unbatched one: its fields read
    as numpy arrays of the one tree, and ``_replace`` takes arrays (numpy or
    JAX) and gives back a view of the port's batched carry with them."""

    def __init__(self, carry):
        self.carry = carry

    def __getattr__(self, name):
        return np.asarray(getattr(self.carry, name)[0])

    def _replace(self, **fields):
        c = self.carry
        return _CarryArrays(c._replace(**{
            k: torch.as_tensor(np.asarray(v), dtype=getattr(c, k).dtype)[None]
            for k, v in fields.items()}))


class CarryAsArraysMPC:
    """The port's ``BranchMPCCVaR`` with its carry as :class:`_CarryArrays`,
    so that ``tests/test_reference_scale._closed_loop(..., forced_series=True)``
    can force its warm start as it does the JAX controller's."""

    def __init__(self, mpc):
        self._mpc = mpc

    @property
    def carry(self):
        return _CarryArrays(self._mpc.carry)

    @carry.setter
    def carry(self, view):
        self._mpc.carry = view.carry

    def __getattr__(self, name):
        return getattr(self._mpc, name)


def test_overtake_reference_scale_cvar():
    """The port's counterpart of ``tests/test_reference_scale.py``'s CVaR
    gate (``:183-257``), with its configuration and its bars: the
    teacher-forced series gates tight steps at 1e-3, the free closed loop is
    held to the bifurcation-aware envelope, failed-oracle steps are excluded
    (nan) and must stay rare."""
    cons, pset, model, params = overtake_demo_setup()
    oracle = OracleCVaRController(params, PortModelAdapter(model, pset.params), ralpha=0.9)
    mpc = BranchMPCCVaR(params, model, pset.params, ralpha=0.9,
                        ipm=CVaRIPMConfig(iters=100, gondzio=2), restart=60, dtype=F64,
                        device="cpu")
    x0, z0 = np.array([0.0, 1.8, 20.0, 0.0]), np.array([9.0, 1.8, 17.0, 0.0])
    n_steps = int(os.environ.get("BP_GATE_STEPS", "100"))
    errs, errs_forced, gaps, oq = _closed_loop(
        oracle, CarryAsArraysMPC(mpc), cons, model.dt, n_steps, x0, z0, params.xRef,
        forced_series=True, tol=1e-9, max_iter=300)
    print(f"\novertake CVaR gate forced errs:   {errs_forced.round(8).tolist()}")
    print(f"overtake CVaR gate unforced errs: {errs.round(8).tolist()}")
    print(f"overtake CVaR gate engine gaps:   {gaps.round(10).tolist()}")
    print(f"overtake CVaR gate oracle tiers:  {oq.tolist()}")
    failed = oq == "failed"
    n_failed = int(failed.sum())
    tight = (gaps < 1e-5) & (oq == "tight")
    n_loose = int((~tight & ~failed).sum())
    assert tight.any(), "no tight steps"
    assert errs_forced[tight].max() < 1e-3, (
        f"max teacher-forced deviation {errs_forced[tight].max():.2e} on a tight step")
    assert np.nanmax(errs_forced) < 5e-3 and n_loose <= 12 \
        and n_failed <= max(2, n_steps // 12), (
        f"jam/inaccuracy envelope violated: max forced {np.nanmax(errs_forced):.2e}, "
        f"{n_loose} loose + {n_failed} failed-oracle steps")
    n_spiky = int(np.nansum(errs > 1e-2))
    assert np.nanmedian(errs) < 1e-3, f"unforced median {np.nanmedian(errs):.2e}"
    assert np.nanmax(errs) < 0.1 and n_spiky <= len(errs) // 10, (
        f"unforced envelope violated: max {np.nanmax(errs):.2e}, "
        f"{n_spiky}/{len(errs)} steps above 1e-2")


def load_script(monkeypatch, name):
    """``scripts/<name>.py`` as a module, the scripts' folder on the path."""
    import importlib.util

    monkeypatch.syspath_prepend(SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, f"{SCRIPTS}/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_merge_reference_scale_lane_switch(monkeypatch):
    mg = load_script(monkeypatch, "torch_port_merge_gate")
    cons, psets, models, params = mg.merge_demo_setup()
    oracle, mpc = mg.merge_gate_controllers(params, models[0], psets[0])
    dual = mg.DualSolveMPC(mpc, oracle)
    env = mg.merge_gate_env(dual, cons, psets, models)
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
    print(f"merge gate oracle retried at {mg.ORACLE_RETRY_ITERS}: "
          f"{np.flatnonzero(dual.retried).tolist()}")
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


def _jax_overtake_demo():
    """The demo overtake in the JAX package: ``(cons, pset, model, params,
    xRef, dt)``."""
    from belief_planning_tpu.models.policies import highway_policy_set as j_highway_set
    from belief_planning_tpu.models.predictive import highway_model as j_highway_model
    from belief_planning_tpu.presets import init_branch_mpc as j_init
    from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants

    xRef, dt = np.array([0.5, 1.8, 15.0, 0.0]), 0.1
    cons = JBranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2, am=6.0, rm=0.3,
                            J_c=20, s_c=1, ylb=0.0, yub=7.2, L=4, W=2.5, col_alpha=5, Kpsi=0.1)
    pset = j_highway_set(cons, xRef)
    model = j_highway_model(cons, pset, N=8, dt=dt)
    params = j_init(4, 2, 8, 2, xRef, 6.0, 0.3, 4, cons.W)
    return cons, pset, model, params, xRef, dt


def _jax_refine10_forced_series():
    """The JAX package's f64 IPM-40 loop and its refine10 mode forced on the
    loop's states (``scripts/f32_parity_episode.py`` on ``pl_xla``)."""
    import jax
    import jax.numpy as jnp

    from belief_planning_tpu.controllers.branch_mpc import make_branch_mpc_batched_step
    from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig

    cons, pset, model, params, xRef, dt = _jax_overtake_demo()

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
    ep = load_script(monkeypatch, "torch_port_f32_parity_episode")
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


PARTING_STEPS = 100
PARTING_ORACLE_STEPS = 8        # parting steps the oracle solves, spread over the episode
PARTING_NUDGE = 1e-7            # relative change of the ego's speed: about an f32 ulp


def _jax_cvar_parting(states, carries, nudge):
    """The JAX package's f64 IPM-40 + 2 CVaR step (``make_cvar_mpc_batched_step``
    with ``use_pallas=False``, the plain fused layout) and its refine10 mode
    on the given states and warm starts (the port's f64 loop's: port
    carries, a batch of one), refine10 with the ego's speed scaled by
    1 + ``nudge``, the same two with refine10's solve in f64, and the JAX
    package's own f64 loop. Returns the input series by name: ``ipm40``,
    ``refine10``, ``refine10_nudged``, ``refine10_f64``,
    ``refine10_f64_nudged``, ``own_loop``."""
    import jax
    import jax.numpy as jnp

    from belief_planning_tpu.controllers.branch_mpc import MPCCarry as JMPCCarry
    from belief_planning_tpu.controllers.cvar_mpc import make_cvar_mpc_batched_step as j_make
    from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig

    cons, pset, model, params, xRef, dt = _jax_overtake_demo()
    arr = lambda a: jnp.asarray(a.double().numpy() if a.is_floating_point() else a.numpy())
    j_carries = [JMPCCarry(*(arr(getattr(c, f)) for f in
                             ("u_lin", "p", "old_input", "initialized"))) for c in carries]

    def episode(ipm, refine=0, sd=None, forced=None):
        _, _, init_carry, step = j_make(model, params, ralpha=0.9, ipm=ipm, use_pallas=False,
                                        refine_f64=refine, solve_dtype=sd)
        js = jax.jit(step)
        carry = jax.tree.map(lambda a: jnp.broadcast_to(a, (1,) + a.shape),
                             init_carry(jnp.float64))
        x, z = np.array([0.0, 1.8, 20.0, 0.0]), np.array([9.0, 1.8, 17.0, 0.0])
        us = []
        for k in range(len(states)):
            if forced is not None:
                (x, z), carry = forced[k], j_carries[k]
            carry, res = js(carry, jnp.asarray(x[None]), jnp.asarray(z[None]),
                            jnp.asarray(xRef[None]), pset.params)
            u = np.asarray(res.uPred[0, 0], np.float64)
            us.append(u)
            x = x + np.array([x[2] * np.cos(x[3]), x[2] * np.sin(x[3]), u[0], u[1]]) * dt
            z = z + np.array([z[2] * np.cos(z[3]), z[2] * np.sin(z[3]), 0.0,
                              -cons.Kpsi * z[3]]) * dt
        return np.asarray(us)

    ipm40, ipm24 = JCVaRIPMConfig(iters=40, gondzio=2), JCVaRIPMConfig(iters=24, gondzio=2)
    nudged = [(x * np.array([1, 1, 1 + nudge, 1]), z) for x, z in states]
    return {"ipm40": episode(ipm40, forced=states),
            "refine10": episode(ipm24, 10, jnp.float32, states),
            "refine10_nudged": episode(ipm24, 10, jnp.float32, nudged),
            "refine10_f64": episode(ipm24, 10, None, states),
            "refine10_f64_nudged": episode(ipm24, 10, None, nudged),
            "own_loop": episode(ipm40)}


def oracle_on_carry(params, adapter, x, z, xRef, carry, x0, z0):
    """The NumPy oracle's applied input on the program an engine step
    solves: states ``(x, z)`` and the warm start ``carry`` (a batch of one),
    its tree built at ``(x0, z0)`` and then moved to that warm start
    (``uLin``, the branches' ``p`` for the argmax shift, ``OldInput``)."""
    o = OracleCVaRController(params, adapter, ralpha=0.9)
    if bool(carry.initialized[0]):
        o.inittree(x0, z0)
        o.buildIneqConstr()
        u = carry.u_lin[0].double().numpy()
        o.uPred, o.uLin = u.copy(), np.vstack((u, u[-1]))
        o.OldInput = carry.old_input[0].double().numpy().copy()
        for br, p in zip(o.branches_bfs(), carry.p[0].double().numpy()):
            br.p = p.copy()
    u_o = o.solve(x, z, xRef, tol=1e-9, max_iter=300)
    return u_o, o.solution.status, float(getattr(o.solution, "gap", np.nan))


def test_cvar_parity_episode_parting(monkeypatch):
    """The CVaR parity episode's refine10 mode (an f32 IPM-24 + 2 solve and
    a 10-iteration f64 restart) against its f64 IPM-40 + 2 loop, on the
    loop's states and warm starts, in both packages on the CPU in f64: the
    demo overtake, B=1, ralpha 0.9, 100 steps. The JAX package's steps are
    handed the port's loop's states and warm starts, so both packages solve
    identical programs. Both part on at least 90 of the 100 steps, by
    amounts of the same size (medians within 20 %); the NumPy oracle, on
    PARTING_ORACLE_STEPS of the parting steps spread over the episode, is
    nearer IPM-40 every time: refine10's restart stops short of
    convergence. Where it stops is chaotic in each package: scaling the
    ego's speed by 1 + 1e-7 (about one f32 rounding of the solve's input)
    moves refine10 by more than 1e-2 on some step, in the JAX package and
    in the port. On the well-conditioned steps, where that nudge moves
    neither package's refine10 by 1e-4, the two packages' refine10 agree to
    1e-3. With refine10's solve in f64 (the same IPM-24 + 2 and 10-iteration
    restart, no f32), both packages still part from IPM-40 (median > 1e-2:
    the restart, not f32, moves the answer away), and agree with each other
    to 1e-3 on that mode's well-conditioned steps."""
    ep = load_script(monkeypatch, "torch_port_f32_parity_episode")
    ce = load_script(monkeypatch, "torch_port_cvar_parity_episode")
    cons, pset, model, params = ep.demo()
    from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_batched_step

    def make_step(mode):
        _, ipm, refine, sd = mode
        _, _, init_carry, step = make_cvar_mpc_batched_step(model, params, ralpha=0.9, ipm=ipm,
                                                            refine_f64=refine, solve_dtype=sd,
                                                            device="cpu")
        return init_carry, step

    episode = ep.make_episode(make_step, pset, cons.Kpsi, PARTING_STEPS, "cpu")
    refine10 = ce.MODES["refine10"]
    u64, _, states, carries = episode(ce.REFERENCE)
    uw = episode(refine10, forced_states=states, forced_carries=carries)[0]
    port = np.abs(uw - u64).max(axis=1)
    nudged = [(x * np.array([1, 1, 1 + PARTING_NUDGE, 1]), z) for x, z in states]
    self_port = np.abs(episode(refine10, forced_states=nudged, forced_carries=carries)[0]
                       - uw).max(axis=1)
    refine10_f64 = (refine10[0], refine10[1], refine10[2], None)
    uw64 = episode(refine10_f64, forced_states=states, forced_carries=carries)[0]
    self_port64 = np.abs(episode(refine10_f64, forced_states=nudged, forced_carries=carries)[0]
                         - uw64).max(axis=1)
    j = _jax_cvar_parting(states, carries, PARTING_NUDGE)
    dist = lambda a, b: np.abs(a - b).max(axis=1)
    jax_, self_jax = dist(j["refine10"], j["ipm40"]), dist(j["refine10_nudged"], j["refine10"])
    parted, j_parted = np.flatnonzero(port > 1e-2), np.flatnonzero(jax_ > 1e-2)
    apart = dist(uw, j["refine10"])
    ipm40_apart = dist(u64, j["ipm40"])
    loops_apart = dist(u64, j["own_loop"])
    well = (self_port < 1e-4) & (self_jax < 1e-4)
    port64, jax64 = dist(uw64, u64), dist(j["refine10_f64"], j["ipm40"])
    self_jax64 = dist(j["refine10_f64_nudged"], j["refine10_f64"])
    apart64 = dist(uw64, j["refine10_f64"])
    well64 = (self_port64 < 1e-4) & (self_jax64 < 1e-4)
    print(f"\nrefine10 vs f64 IPM-40 on the port's loop's states and warm starts, by step:"
          f"\n  port {port.round(8).tolist()}\n  JAX package {jax_.round(8).tolist()}"
          f"\n  parted > 1e-2: port {parted.tolist()}, JAX package {j_parted.tolist()}"
          f"\n  medians {np.median(port):.4f} / {np.median(jax_):.4f}"
          f"\n  speed scaled by 1 + {PARTING_NUDGE:g}, refine10 moves by (port) "
          f"{self_port.round(8).tolist()}\n    (JAX package) {self_jax.round(8).tolist()}"
          f"\n    medians {np.median(self_port):.3e} / {np.median(self_jax):.3e}"
          f"\n  refine10, port vs JAX package: {apart.round(8).tolist()}"
          f"\n    median {np.median(apart):.3e}, max {apart.max():.3e}; on the "
          f"{int(well.sum())} well-conditioned steps {np.flatnonzero(well).tolist()}: max "
          f"{apart[well].max() if well.any() else np.nan:.3e}"
          f"\n  f64 IPM-40 on the same programs, port vs JAX package: median "
          f"{np.median(ipm40_apart):.3e}, max {ipm40_apart.max():.3e} (step "
          f"{int(ipm40_apart.argmax())}), over 1e-6 on {int((ipm40_apart > 1e-6).sum())} steps"
          f"\n  the two f64 IPM-40 loops, each on its own trajectory: "
          f"{loops_apart.round(8).tolist()}"
          f"\n  refine10 with its solve in f64, from IPM-40: medians {np.median(port64):.4f} / "
          f"{np.median(jax64):.4f}; the nudge moves it by medians "
          f"{np.median(self_port64):.3e} / {np.median(self_jax64):.3e}; port vs JAX package "
          f"median {np.median(apart64):.3e}, max {apart64.max():.3e}, on the "
          f"{int(well64.sum())} well-conditioned steps max "
          f"{apart64[well64].max() if well64.any() else np.nan:.3e}", flush=True)
    adapter = PortModelAdapter(model, pset.params)
    sample = parted[np.linspace(0, parted.size - 1, PARTING_ORACLE_STEPS).round().astype(int)]
    nearer = []
    for k in sample:
        (x, z), c = states[k], carries[k]
        u_o, status, gap = oracle_on_carry(params, adapter, x, z, ep.XREF, c, ep.X0, ep.Z0)
        d_ref, d_64 = np.abs(uw[k] - u_o).max(), np.abs(u64[k] - u_o).max()
        nearer.append("refine10" if d_ref < d_64 else "IPM-40")
        print(f"  step {k}: oracle {status} gap {gap:.1e}: |refine10 - oracle| {d_ref:.3e}, "
              f"|IPM-40 - oracle| {d_64:.3e}: {nearer[-1]} is nearer", flush=True)
    assert parted.size >= 0.9 * PARTING_STEPS and j_parted.size >= 0.9 * PARTING_STEPS
    assert abs(np.median(port) / np.median(jax_) - 1) < 0.2
    assert nearer == ["IPM-40"] * len(sample)
    assert self_port.max() > 1e-2 and self_jax.max() > 1e-2
    for name, ok, d in (("refine10", well, apart), ("refine10, f64 solve", well64, apart64)):
        assert ok.any(), f"{name}: no well-conditioned step"
        assert d[ok].max() < 1e-3, (
            f"{name} parts between the packages by {d[ok].max():.3e} on a "
            f"well-conditioned step ({int(np.flatnonzero(ok)[d[ok].argmax()])})")
    assert np.median(port64) > 1e-2 and np.median(jax64) > 1e-2
