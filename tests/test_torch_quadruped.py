"""The quadruped slice against the JAX package, f64, inputs from numpy
seeds: the kinematics and the collision margins (``robot_col`` with both
norms, ``robot_col_corners``) to 1e-12, with their gradients on a tie
(ΔX = 0 or ΔY = 0 exactly, where ``|x|``'s derivative must be +1 as
``jnp.abs``'s is); ``quadruped_model``'s ``branch_eval`` and ``zpred`` to
1e-9; the preset; and two warm-started steps of the port's
``make_branch_mpc_batched_step`` (CPU, the plain fused iteration) against
the JAX package's (``backend="pl_xla"``) at ``quad_setup(N=5, NB=2)``,
B=8, IPM-8 with 2 correctors, u < 1e-7 and x < 1e-6. The quadruped has no
state rows: both packages solve it with one inert padded row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from belief_planning_tpu.controllers.branch_mpc import (
    make_branch_mpc_batched_step as j_make_step,
)
from belief_planning_tpu.models import dynamics as jdyn
from belief_planning_tpu.models import safety as jsaf
from belief_planning_tpu.presets import init_quad_branch_mpc as j_init_quad
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig

from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_batched_step
from belief_planning_tpu_torch.convert import convert
from belief_planning_tpu_torch.models import dynamics as tdyn
from belief_planning_tpu_torch.models import safety as tsaf
from belief_planning_tpu_torch.models.policies import quadruped_policy_set
from belief_planning_tpu_torch.models.predictive import quadruped_model
from belief_planning_tpu_torch.presets import init_quad_branch_mpc
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

from tests.test_tree_qp import quad_setup

torch.set_num_threads(1)

N, NB, B, STEPS = 5, 2, 8, 2
ITERS, GONDZIO = 8, 2
SIZES = (0.5, 0.3, 1.0, 0.6, 0.2)          # L1, W1, L2, W2, col_tol (QuadConstants)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(a_torch, b_jax, tol=1e-12):
    a, b = a_torch.detach().numpy(), np.asarray(b_jax)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol, err


def _states(seed, k=16):
    rng = np.random.default_rng(seed)
    return (np.array([0.0, 1.8, 0.0]) + rng.normal(0, [1.0, 1.0, 0.5], (k, 3)),
            np.array([2.5, 2.5, -np.pi / 2]) + rng.normal(0, [1.0, 1.0, 0.5], (k, 3)))


def test_quad_kinematics():
    x, _ = _states(1)
    u = np.random.default_rng(2).normal(0, 0.3, (16, 3))
    _close(tdyn.quad_kinematics(_t(x), _t(u)), jax.jit(jax.vmap(jdyn.quad_kinematics))(x, u))


MARGINS = {
    "robot_col_1": (lambda a, b: tsaf.robot_col(a, b, *SIZES, ord=1),
                    lambda a, b: jsaf.robot_col(a, b, *SIZES, ord=1)),
    "robot_col_2": (lambda a, b: tsaf.robot_col(a, b, *SIZES, ord=2),
                    lambda a, b: jsaf.robot_col(a, b, *SIZES, ord=2)),
    "robot_col_corners": (lambda a, b: tsaf.robot_col_corners(a, b, *SIZES, alpha=1.0),
                          lambda a, b: jsaf.robot_col_corners(a, b, *SIZES, alpha=1.0)),
}


@pytest.mark.parametrize("name", sorted(MARGINS))
def test_collision_margin(name):
    tf, jf = MARGINS[name]
    x, z = _states(3)
    _close(tf(_t(x), _t(z)), jax.jit(jax.vmap(jf))(x, z))


@pytest.mark.parametrize("name", sorted(MARGINS))
def test_collision_gradient_on_a_tie(name):
    """ΔX = 0 or ΔY = 0 exactly (and, for the corners, a sample point on the
    ego's axis): the margin's gradient in the ego state matches the
    reference's."""
    tf, jf = MARGINS[name]
    x = np.array([[1.0, 2.0, 0.0], [1.0, 2.0, 0.3], [0.0, 0.5, 0.0], [2.0, -1.0, 0.0]])
    z = np.array([[1.0, 4.0, 0.0], [3.5, 2.0, -0.2], [0.0, 2.5, 0.0], [2.0, 1.5, 0.0]])
    jg = jax.jit(jax.vmap(jax.grad(jf)))(x, z)
    tg = torch.stack([grad(tf)(_t(x[i]), _t(z[i])) for i in range(len(x))])
    _close(tg, jg)


def test_quadruped_tree_build():
    """``branch_eval`` (p and ∂p/∂x) and ``zpred`` to 1e-9, and the collision
    row (``col_raw``) to 1e-12, on seeded states."""
    cons, pset, jm, params = quad_setup(N=N, NB=NB)
    _, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tm = quadruped_model(tcons, quadruped_policy_set(tpp[0].v0), N=N, dt=0.2)
    x, z = _states(4, 6)
    p, dp = tm.branch_eval(_t(x), _t(z), tpp)
    jp, jdp = jax.jit(jax.vmap(lambda a, b: jm.branch_eval(a, b, pset.params)))(x, z)
    _close(p, jp, 1e-9)
    _close(dp, jdp, 1e-9)
    _close(tm.zpred(_t(z), tpp), jax.jit(jax.vmap(lambda b: jm.zpred(b, pset.params)))(z), 1e-9)
    h, dh = tm.col_raw(_t(x), _t(z))
    jh, jdh = jax.jit(jax.vmap(jm.col_raw))(x, z)
    _close(h, jh)
    _close(dh, jdh)


def test_preset_matches_jax():
    want = j_init_quad(3, 3, 25, 2, np.array([5.0, 5.0, 0.0]), 0.2, 0.1, 0.5)
    got = init_quad_branch_mpc(3, 3, 25, 2, np.array([5.0, 5.0, 0.0]), 0.2, 0.1, 0.5)
    for f in ("Q", "R", "Qf", "dR", "Qslack", "Fx", "bx", "Fu", "bu", "xRef"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.Fx.shape == (0, 3) and got.bx.shape == (0,)


@pytest.fixture(scope="module")
def runs():
    cons, pset, model, params = quad_setup(N=N, NB=NB)
    _, init_carry, step = j_make_step(model, params, "prox",
                                      ipm=JQPIPMConfig(iters=ITERS, gondzio=GONDZIO),
                                      backend="pl_xla")
    step = jax.jit(step)
    rng = np.random.default_rng(0)
    xs = np.array([0.0, 1.8, 0.0]) + rng.normal(0, 0.3, (B, 3))
    zs = np.array([2.5, 2.5, -np.pi / 2]) + rng.normal(0, 0.3, (B, 3))
    xRefs = np.tile([5.0, 5.0, 0.0], (B, 1))
    c = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), init_carry(jnp.float64))
    jres = []
    for _ in range(STEPS):
        c, r = step(c, jnp.asarray(xs), jnp.asarray(zs), jnp.asarray(xRefs), pset.params)
        jres.append(jax.tree.map(np.asarray, r))

    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = quadruped_model(tcons, quadruped_policy_set(tpp[0].v0), N=N, dt=0.2)
    _, tinit, tstep = make_branch_mpc_batched_step(
        tmodel, tparams, "prox", ipm=QPIPMConfig(iters=ITERS, gondzio=GONDZIO), device="cpu")
    tc = tinit(B, torch.float64)
    tres = []
    for _ in range(STEPS):
        tc, r = tstep(tc, _t(xs), _t(zs), _t(xRefs), tpp)
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
    assert tr.slack.shape == jr.slack.shape == (B, 31, 1)   # the padded row's slack dropped
    assert np.abs(tr.slack.numpy() - jr.slack).max() < 1e-6
