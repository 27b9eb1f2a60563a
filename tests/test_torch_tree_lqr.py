"""The port's tree LQR (factor, linear sweep, forward rollout) against the JAX
package's, on the overtake tree of ``tests/test_tree_qp.py`` (N=4, NB=2, 3
trees, f64, the prox stage cost with its rate couplings), built by the port
(``test_torch_tree.py`` holds that build against the JAX package's) and
handed to both: every field within 1e-9 of its magnitude, in both
``affine`` modes. Also the closed-form small inverse for d = 1, 2, 3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.solvers.tree_qp import StageCost as JStageCost
from belief_planning_tpu.solvers.tree_qp import _small_inv as j_small_inv
from belief_planning_tpu.solvers.tree_qp import build_stage_plan as j_build_stage_plan
from belief_planning_tpu.solvers.tree_qp import tree_lqr_factor as j_factor
from belief_planning_tpu.solvers.tree_qp import tree_lqr_forward as j_forward
from belief_planning_tpu.solvers.tree_qp import tree_lqr_linear as j_linear
from belief_planning_tpu.tree.engine import TreeState as JTreeState
from belief_planning_tpu.tree.topology import build_topology as j_build_topology

from belief_planning_tpu_torch.convert import convert
from belief_planning_tpu_torch.models.policies import highway_policy_set
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.solvers.tree_qp import (
    _small_inv,
    assemble_stage_cost,
    build_stage_plan,
    tree_lqr_factor,
    tree_lqr_forward,
    tree_lqr_linear,
)
from belief_planning_tpu_torch.tree.engine import build_tree
from belief_planning_tpu_torch.tree.topology import build_topology

from tests.test_tree_qp import overtake_setup

torch.set_num_threads(1)

LQR_TOL = 1e-9
N, NB, B = 4, 2, 3
FACTOR_FIELDS = ["K", "Hinv", "Acl", "Bmat", "Amat", "hvec", "vec1", "gu"]


@pytest.fixture(scope="module")
def lqr():
    """Factor, both linear sweeps and both rollouts of 3 trees through the
    JAX package (one jit) and the port, on the same trees and costs."""
    cons, pset, model, params = overtake_setup(N=N, NB=NB)
    jplan = j_build_stage_plan(j_build_topology(N, NB, model.m, 4, 2))
    rng = np.random.default_rng(31)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, [0.3, 0.3, 1.0, 0.05], (B, 4))
    zs = np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, [1.0, 0.5, 1.0, 0.05], (B, 4))
    topo = build_topology(N, NB, model.m, 4, 2)
    u_lin = rng.normal(0, [1.0, 0.1], (B, topo.totalu, 2))
    u_old = rng.normal(0, [1.0, 0.1], (B, 2))
    xRef = np.array([0.0, 1.8, 18.0, 0.0])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = highway_model(tcons, highway_policy_set(tcons, tpp[2].x_target), N=N, dt=0.1)
    ts = build_tree(tmodel, topo, t(xs), t(zs), t(u_lin), tpp)
    cost = assemble_stage_cost(topo, ts, tparams.Q, tparams.R, tparams.Qf, tparams.dR,
                               tparams.Qslack, t(np.tile(xRef, (B, 1))), t(u_old))

    def one(ts, cost, x, uo):
        fac = j_factor(jplan, cost, ts)
        out = {"fac": fac._replace(k_fix=0.0)}
        for affine in (True, False):
            kff = j_linear(jplan, fac, cost.qx, cost.qu, cost.qterm, affine=affine)
            out[f"kff_{affine}"] = kff
            out[f"fwd_{affine}"] = j_forward(jplan, fac, kff, x, uo, affine=affine)
        return out

    jout = jax.jit(jax.vmap(one))(JTreeState(*(a.numpy() for a in ts)),
                                  JStageCost(*(c.numpy() for c in cost)), xs, u_old)
    plan = build_stage_plan(topo)
    fac = tree_lqr_factor(plan, cost, ts)
    tout = {"fac": fac}
    for affine in (True, False):
        kff = tree_lqr_linear(plan, fac, cost.qx, cost.qu, cost.qterm, affine=affine)
        tout[f"kff_{affine}"] = kff
        tout[f"fwd_{affine}"] = tree_lqr_forward(plan, fac, kff, t(xs), t(u_old), affine=affine)
    return jout, tout


def _close(got, want, name):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= LQR_TOL, (name, err)


@pytest.mark.parametrize("field", FACTOR_FIELDS)
def test_tree_lqr_factor(lqr, field):
    jout, tout = lqr
    _close(getattr(tout["fac"], field), getattr(jout["fac"], field), field)


@pytest.mark.parametrize("affine", [True, False])
def test_tree_lqr_linear_and_forward(lqr, affine):
    jout, tout = lqr
    _close(tout[f"kff_{affine}"], jout[f"kff_{affine}"], "kff")
    for name, got, want in zip(("x_nodes", "u"), tout[f"fwd_{affine}"], jout[f"fwd_{affine}"]):
        _close(got, want, name)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_small_inv(dim):
    rng = np.random.default_rng(dim)
    M = rng.normal(size=(5, 4, dim, dim)) + 3.0 * np.eye(dim)
    want = np.asarray(j_small_inv(jnp.asarray(M)))
    got = _small_inv(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got @ M, np.broadcast_to(np.eye(dim), M.shape), atol=1e-12)
