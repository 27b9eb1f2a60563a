"""The study scripts' engine side against the JAX package on the CPU, in
f64, at small trees:

- ``scripts/torch_port_qp_iter_study.py``'s closed loop (the overtake of
  ``tests/test_controller_parity.simulate_closed_loop`` at N=4, NB=2, 3
  steps, IPM-8 with 2 Gondzio correctors) against that function: the port's
  applied inputs within 1e-7 of the JAX package's, and the oracle's (its
  model calls computed by the port's model) within 1e-9 of the oracle's on
  the JAX model (its calls jitted: eagerly they take minutes a step);
- ``scripts/torch_port_cvar_iter_study.py``'s warm-started ``BranchMPCCVaR``
  (IPM-10) along one oracle trajectory (N=4, NB=1, 3 steps) against the
  JAX package's controller along the same states: u within 1e-7, the gaps
  to rtol 1e-8 (``tests/test_torch_cvar_mpc.py``'s bars). At IPM-12 the
  gaps are chaotic in the reference itself: a 2.2e-16 relative change of
  the start's speed moves the JAX package's own 12th gap by up to 6.6e-3
  relative, its 10th by 2.3e-10 (``scripts/torch_port_ipm_chaos.py
  cvar_study``).

Each JAX side runs once, in a module fixture."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def load(name):
    import sys

    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


QP_STEPS, QP_N, QP_NB = 3, 4, 2


class JittedModel:
    """A JAX model whose four calls the oracle makes run under ``jax.jit``
    (eagerly they are most of the closed loop's time)."""

    def __init__(self, model):
        self._model = model
        for name in ("linearize", "branch_eval", "zpred", "col_eval"):
            setattr(self, name, jax.jit(getattr(model, name)))

    def __getattr__(self, name):
        return getattr(self._model, name)


@pytest.fixture(scope="module")
def qp_jax():
    import tests.test_controller_parity as T
    from belief_planning_tpu.oracle.reference_tree import OracleModelAdapter
    from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "OracleModelAdapter",
                   lambda model, pp: OracleModelAdapter(JittedModel(model), pp))
        u_o, u_j, _, _ = T.simulate_closed_loop(n_steps=QP_STEPS, N=QP_N, NB=QP_NB,
                                                ipm=JQPIPMConfig(iters=8, gondzio=2))
    return u_o, u_j


def test_qp_iter_study_closed_loop(qp_jax):
    qs = load("torch_port_qp_iter_study")
    from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

    u_o = qs.oracle_inputs(QP_STEPS, QP_N, QP_NB)
    u_j = qs.engine_inputs(QPIPMConfig(iters=8, gondzio=2), QP_STEPS, "cpu", QP_N, QP_NB)
    j_o, j_j = qp_jax
    assert u_j.shape == j_j.shape == (QP_STEPS, 2)
    assert np.abs(u_j - j_j).max() < 1e-7
    assert np.abs(u_o - j_o).max() < 1e-9
    # the study's verdict at this size, as the JAX package's parity test has it
    assert np.abs(u_o - u_j).max() < 1e-3


CVAR_STEPS, CVAR_N, CVAR_NB, CVAR_ITERS = 3, 4, 1, 10


@pytest.fixture(scope="module")
def cvar_study():
    cs = load("torch_port_cvar_iter_study")
    traj = cs.oracle_trajectory(CVAR_STEPS, CVAR_N, CVAR_NB)

    from belief_planning_tpu.controllers.cvar_mpc import BranchMPCCVaR as JBranchMPCCVaR
    from belief_planning_tpu.models.policies import highway_policy_set
    from belief_planning_tpu.models.predictive import highway_model
    from belief_planning_tpu.presets import init_branch_mpc
    from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig
    from belief_planning_tpu.utils.config import BranchConstants

    cons = BranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2, am=6.0, rm=0.3,
                           J_c=20, s_c=1, ylb=0.0, yub=7.2, L=4, W=2.5, col_alpha=5, Kpsi=0.1)
    xt = np.array([0.5, 1.8, 15.0, 0.0])
    pset = highway_policy_set(cons, xt)
    model = highway_model(cons, pset, N=CVAR_N, dt=0.1)
    params = init_branch_mpc(4, 2, CVAR_N, CVAR_NB, xt, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    mpc = JBranchMPCCVaR(params, model, pset.params, ralpha=0.9,
                         ipm=JCVaRIPMConfig(iters=CVAR_ITERS), dtype=jnp.float64)
    us, gaps = [], []
    for x, z, _ in traj:
        us.append(np.asarray(mpc.solve(x, z, xRef=cs.XREF), np.float64).copy())
        gaps.append(float(np.asarray(mpc.last.gap).ravel()[0]))
    return cs, traj, np.asarray(us), np.asarray(gaps)


def test_cvar_iter_study_warm_steps(cvar_study):
    cs, traj, j_u, j_gaps = cvar_study
    u, gaps = cs.warm_steps(traj, CVAR_ITERS, 0, torch.float64, "cpu", CVAR_N, CVAR_NB)
    assert u.shape == j_u.shape == (CVAR_STEPS, 2)
    assert np.abs(u - j_u).max() < 1e-7
    np.testing.assert_allclose(gaps, j_gaps, rtol=1e-8)
    # the study's line: the warm steps' errors against the oracle's inputs
    errs = np.abs(u - np.asarray([u_o for _, _, u_o in traj])).max(axis=1)
    assert np.isfinite(errs).all()
