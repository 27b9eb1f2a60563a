"""The robust controller (``controllers/robust_mpc.py``) against the JAX
package's (CPU, f64), at the closed loop of ``tests/test_robust_mpc.py``'s
oracle test (N=4, NB=2: 9 stages of 4 box rows and 9 padded collision rows;
the obstacle offset to y = 2.1 so the optimum is unique): 5 receding-horizon
steps on the IPM (100 iterations), each package driven by its own inputs,
applied inputs < 1e-7 and predictions < 1e-6; then one step on the ADMM
(the entry's config) from the same carry, u < 1e-7. ``BT2array`` and the
obstacle-node map (``zPred``, ``zvalid``) equal the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from belief_planning_tpu.controllers.robust_mpc import RobustMPC as JRobustMPC
from belief_planning_tpu.controllers.robust_mpc import make_robust_mpc_step as j_make_step
from belief_planning_tpu.models.policies import highway_policy_set as j_highway_set
from belief_planning_tpu.models.predictive import highway_model as j_highway_model
from belief_planning_tpu.presets import init_branch_mpc as j_init_branch_mpc
from belief_planning_tpu.solvers.tree_qp import ADMMConfig as JADMMConfig
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig
from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants

from belief_planning_tpu_torch.controllers.robust_mpc import RobustMPC
from belief_planning_tpu_torch.convert import convert, convert_admm_config
from belief_planning_tpu_torch.models import policies as tpol
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

from tests.test_torch_tree_admm import FAST_XLA

torch.set_num_threads(1)

N, NB, STEPS = 4, 2, 5
XT = np.array([0.5, 1.8, 15.0, 0.0])
ADMM = dict(rho=5.0, iters=50, rho_update_every=0, polish_iters=10)


@pytest.fixture(scope="module")
def loops():
    def fast(jmpc, **kw):
        """The JAX controller with its step compiled under ``FAST_XLA``."""
        jmpc._step = jax.jit(j_make_step(model, params, **kw)[2], compiler_options=FAST_XLA)
        return jmpc

    cons = JBranchConstants()
    pset = j_highway_set(cons, XT)
    model = j_highway_model(cons, pset, N=N, dt=0.1)
    params = j_init_branch_mpc(4, 2, N, NB, XT, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = highway_model(tcons, tpol.highway_policy_set(tcons, XT), N=N, dt=0.1)
    mpcs = {"j": fast(JRobustMPC(params, model, pset.params, dtype=jnp.float64,
                                 ipm=JQPIPMConfig(iters=100)), ipm=JQPIPMConfig(iters=100)),
            "t": RobustMPC(tparams, tmodel, tpp, ipm=QPIPMConfig(iters=100), device="cpu")}
    dt = model.dt

    def f(s, u):
        return s + np.array([s[2] * np.cos(s[3]), s[2] * np.sin(s[3]), u[0], u[1]]) * dt

    out = {}
    for k, mpc in mpcs.items():
        x, z = np.array([0.0, 1.8, 20.0, 0.0]), np.array([10.0, 2.1, 16.0, 0.0])
        us, xps, bts = [], [], []
        for _ in range(STEPS):
            u = np.asarray(mpc.solve(x, z, np.array([0.0, 1.8, 18.0, 0.0])))
            us.append(u)
            xps.append(np.asarray(mpc.xPred))
            bts.append(mpc.BT2array())
            x, z = f(x, u), f(z, np.array([0.0, -cons.Kpsi * z[3]]))
        out[k] = dict(u=np.array(us), xPred=np.array(xps), bt=bts, feasible=mpc.feasible,
                      last=mpc.last, state=(x, z, mpc.carry))
    # one ADMM step from the IPM loop's carry, on the same states
    x, z, jcarry = out["j"]["state"]
    jadmm = fast(JRobustMPC(params, model, pset.params, admm=JADMMConfig(**ADMM),
                            dtype=jnp.float64, solver="admm"),
                 admm=JADMMConfig(**ADMM), solver="admm")
    tadmm = RobustMPC(tparams, tmodel, tpp, admm=convert_admm_config(JADMMConfig(**ADMM)),
                      solver="admm", device="cpu")
    jadmm.carry, tadmm.carry = jcarry, out["t"]["state"][2]
    xRef = np.array([0.0, 1.8, 18.0, 0.0])
    out["admm"] = (np.asarray(jadmm.solve(x, z, xRef)), tadmm.solve(x, z, xRef), jadmm, tadmm)
    return out


def test_robust_loop_matches_jax(loops):
    j, t = loops["j"], loops["t"]
    assert np.abs(t["u"] - j["u"]).max() < 1e-7
    assert np.abs(t["xPred"] - j["xPred"]).max() < 1e-6
    assert j["feasible"] == t["feasible"] == 1


def test_robust_rows_and_bt2array(loops):
    j, t = loops["j"], loops["t"]
    assert t["last"].zPred.shape == (N * NB + 1, 3 ** NB, 4)
    assert np.array_equal(t["last"].zvalid, np.asarray(j["last"].zvalid))
    assert np.abs(t["last"].zPred - np.asarray(j["last"].zPred)).max() < 1e-12
    (jx, jz, ju, _), (tx, tz, tu, _) = j["bt"][-1], t["bt"][-1]
    assert len(tz) == len(jz) == 3 ** NB
    assert all(np.abs(a - b).max() < 1e-12 for a, b in zip(tz, jz))
    assert np.abs(tx[0] - jx[0]).max() < 1e-6


def test_robust_admm_step_matches_jax(loops):
    ju, tu, jm, tm = loops["admm"]
    assert np.abs(tu - ju).max() < 1e-7
    assert np.abs(tm.xPred - np.asarray(jm.xPred)).max() < 1e-6
