"""The slice as a whole: two warm-started receding-horizon steps of the port's
``make_branch_mpc_batched_step`` (CPU, f64, plain fused iteration) against
the JAX package's ``make_branch_mpc_batched_step(backend="pl_xla")`` on the
same seeded states, with parameters carried across by ``convert``. Bars:
u < 1e-7, x < 1e-6 (``tests/test_tree_qp_pl.py``), matching ``feasible``
and ``prim_res``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.controllers.branch_mpc import (
    make_branch_mpc_batched_step as j_make_step,
)
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig

from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_batched_step
from belief_planning_tpu_torch.convert import convert
from belief_planning_tpu_torch.models.policies import highway_policy_set
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

from tests.test_tree_qp import overtake_setup

torch.set_num_threads(1)

N, NB, B, STEPS = 4, 2, 8, 2
ITERS, GONDZIO = 8, 2


def _states():
    rng = np.random.default_rng(3)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.1, (B, 4))
    zs = np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
    xRefs = np.tile([0.0, 1.8, 18.0, 0.0], (B, 1))
    return xs, zs, xRefs


@pytest.fixture(scope="module")
def runs():
    cons, pset, model, params = overtake_setup(N=N, NB=NB)
    _, init_carry, step = j_make_step(model, params, "prox",
                                      ipm=JQPIPMConfig(iters=ITERS, gondzio=GONDZIO),
                                      backend="pl_xla")
    step = jax.jit(step)
    xs, zs, xRefs = _states()
    c = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), init_carry(jnp.float64))
    jres = []
    for _ in range(STEPS):
        c, r = step(c, jnp.asarray(xs), jnp.asarray(zs), jnp.asarray(xRefs), pset.params)
        jres.append(jax.tree.map(np.asarray, r))

    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = highway_model(tcons, highway_policy_set(tcons, tpp[2].x_target), N=N, dt=0.1)
    _, tinit, tstep = make_branch_mpc_batched_step(
        tmodel, tparams, "prox", ipm=QPIPMConfig(iters=ITERS, gondzio=GONDZIO), device="cpu")
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    tc = tinit(B, torch.float64)
    tres = []
    for _ in range(STEPS):
        tc, r = tstep(tc, t(xs), t(zs), t(xRefs), tpp)
        tres.append(r)
    return jres, tres


@pytest.mark.parametrize("k", range(STEPS))
def test_step_matches_jax(runs, k):
    jr, tr = runs[0][k], runs[1][k]
    du = np.abs(tr.uPred.numpy() - jr.uPred).max()
    dx = np.abs(tr.xPred.numpy() - jr.xPred).max()
    assert du < 1e-7, du
    assert dx < 1e-6, dx
    assert np.array_equal(tr.feasible.numpy(), jr.feasible)
    assert np.abs(tr.prim_res.numpy() - jr.prim_res).max() < 1e-9


@pytest.mark.parametrize("field", ["slack", "w", "p", "x_lin", "z"])
def test_step_outputs_match_jax(runs, field):
    for jr, tr in zip(*runs):
        assert np.abs(getattr(tr, field).numpy() - getattr(jr, field)).max() < 1e-6, field


def test_carry_feeds_next_step(runs):
    """The second step is warm-started: its linearization trajectory comes
    from the shifted first solution, not from zeros."""
    tr0, tr1 = runs[1]
    assert not torch.equal(tr1.x_lin, tr0.x_lin)
    assert bool(tr1.feasible.all())
