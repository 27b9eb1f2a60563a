"""The quadruped host loop (``envs/quadruped.py``: ``QuadEnv`` +
``robot_sim`` on the port's ``BranchMPCProx``) against the JAX package's
(CPU, f64, each package on its own closed loop):

- ``tests/test_envs.py``'s configuration (N=6, NB=2, dt = 0.2; IPM-12, so
  that both packages compare before the late iterates' chaos and the port's
  plain solves stay cheap), 5 steps in each ``ref_mode`` ("default" and the ROS variant's
  ``arctan2(dx[0], dx[1])``): states and inputs < 1e-6, backup choices
  equal, branches (``BT2array``) < 1e-6;
- the reference-scale gate (slow, out of tier-1): the demo's N=25, NB=2 for
  40 steps (``examples/main_quadruped.py``, IPM-30 as
  ``tests/test_reference_scale.py``), max closed-loop deviation < 1e-3,
  ``PARITY.md``'s quadruped gate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from belief_planning_tpu.controllers.branch_mpc import BranchMPCProx as JBranchMPCProx
from belief_planning_tpu.controllers.branch_mpc import make_branch_mpc_step as j_make_step
from belief_planning_tpu.envs.quadruped import QuadEnv as JQuadEnv
from belief_planning_tpu.envs.quadruped import robot_sim as j_robot_sim
from belief_planning_tpu.models.policies import quadruped_policy_set as j_quad_set
from belief_planning_tpu.models.predictive import quadruped_model as j_quad_model
from belief_planning_tpu.presets import init_quad_branch_mpc as j_init_quad
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig
from belief_planning_tpu.utils.config import QuadConstants as JQuadConstants

from belief_planning_tpu_torch.controllers.branch_mpc import BranchMPCProx
from belief_planning_tpu_torch.convert import convert
from belief_planning_tpu_torch.envs.quadruped import QuadEnv, robot_sim
from belief_planning_tpu_torch.models.policies import quadruped_policy_set
from belief_planning_tpu_torch.models.predictive import quadruped_model
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

from tests.test_torch_tree_admm import FAST_XLA

torch.set_num_threads(1)

X_DES = np.array([5., -3., 0.])
DEMO = dict(s1=2, s2=3, c2=0.5, alpha=1, R=1.2, vxm=0.2, vym=0.1, rm=0.5, L1=0.5, W1=0.3,
            L2=1.0, W2=0.6, col_tol=0.2, col_alpha=5)


def _loops(N, steps, cons, ipm_iters, modes=("default", "ros")):
    """Both packages' closed loops of ``steps`` steps for each mode."""
    pset = j_quad_set(v0=0.2)
    model = j_quad_model(cons, pset, N=N, dt=0.2)
    params = j_init_quad(3, 3, N, 2, np.array([5., 5., 0.]), vxm=0.2, vym=0.1, rm=0.5)
    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = quadruped_model(tcons, quadruped_policy_set(0.2), N=N, dt=0.2)
    jmpc = JBranchMPCProx(params, model, pset.params, dtype=jnp.float64,
                          ipm=JQPIPMConfig(iters=ipm_iters))
    jmpc._step = jax.jit(j_make_step(model, params, "prox", ipm=JQPIPMConfig(iters=ipm_iters))[2],
                         compiler_options=FAST_XLA)
    tmpc = BranchMPCProx(tparams, tmodel, tpp, ipm=QPIPMConfig(iters=ipm_iters), device="cpu")
    out = {}
    for mode in modes:
        # each loop starts cold (one compiled step a package for both modes)
        jmpc.carry, tmpc.carry = jmpc._init_carry(jnp.float64), tmpc._init_carry(1, torch.float64)
        T = steps * 0.2
        out[mode] = (j_robot_sim(JQuadEnv(NR=2, mpc=jmpc, x_des=X_DES, cons=cons, ref_mode=mode),
                                 T),
                     robot_sim(QuadEnv(NR=2, mpc=tmpc, x_des=X_DES, cons=tcons, ref_mode=mode),
                               T))
    return out


@pytest.fixture(scope="module")
def loops():
    return _loops(6, 5, JQuadConstants(), ipm_iters=12)


@pytest.mark.parametrize("mode", ["default", "ros"])
def test_quad_env_matches_jax(loops, mode):
    jrec, trec = loops[mode]
    assert trec[0].shape == (2, 5, 3)
    assert np.abs(trec[0] - jrec[0]).max() < 1e-6
    assert np.abs(trec[1] - jrec[1]).max() < 1e-6
    assert trec[3] == jrec[3]
    for jx, tx in zip(jrec[4], trec[4]):          # the ego's branches, each step
        assert all(np.abs(a - b).max() < 1e-6 for a, b in zip(tx, jx))
    assert trec[1][0, :, 0].max() <= 0.2 + 1e-6 and trec[1][0, :, 0].min() >= -1e-6


def test_ref_modes_differ(loops):
    """The ROS variant's reference (the goal, the swapped arctan2) steers
    elsewhere than the default one."""
    assert np.abs(loops["ros"][1][0] - loops["default"][1][0]).max() > 1e-3


@pytest.mark.slow
def test_quad_env_reference_scale_gate():
    out = _loops(25, 40, JQuadConstants(**DEMO), ipm_iters=30, modes=("default",))
    jrec, trec = out["default"]
    dev = np.abs(trec[0] - jrec[0]).max()
    assert dev < 1e-3, f"max closed-loop deviation {dev:.2e}"
