"""The port's formulas against the JAX package's, on the same seeded inputs
(f64): topology index arrays identical; soft-math, dynamics, policies, safety
and rollouts to 1e-12; linearization Jacobians to 1e-9 against JAX and 1e-6
against finite differences (PARITY.md tolerances)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from belief_planning_tpu.models import dynamics as jdyn
from belief_planning_tpu.models import policies as jpol
from belief_planning_tpu.models import safety as jsaf
from belief_planning_tpu.ops import linearize as jlin
from belief_planning_tpu.ops import rollout as jroll
from belief_planning_tpu.ops import softmath as jsm
from belief_planning_tpu.tree.topology import build_topology as j_build_topology
from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants

from belief_planning_tpu_torch.convert import convert_constants, convert_policy_params
from belief_planning_tpu_torch.models import dynamics as tdyn
from belief_planning_tpu_torch.models import policies as tpol
from belief_planning_tpu_torch.models import safety as tsaf
from belief_planning_tpu_torch.ops import linearize as tlin
from belief_planning_tpu_torch.ops import rollout as troll
from belief_planning_tpu_torch.ops import softmath as tsm
from belief_planning_tpu_torch.tree.topology import build_topology as t_build_topology

torch.set_num_threads(1)

FORMULA_TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(a_torch, b_jax, tol=FORMULA_TOL):
    a = a_torch.detach().numpy()
    b = np.asarray(b_jax)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol, err


def _states(seed, k=16):
    rng = np.random.default_rng(seed)
    x = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, [3.0, 1.0, 2.0, 0.2], (k, 4))
    return x


@pytest.mark.parametrize("N,NB,m", [(4, 2, 3), (8, 2, 3), (5, 1, 2), (3, 3, 2)])
def test_topology_identical(N, NB, m):
    jt = j_build_topology(N, NB, m, 4, 2)
    tt = t_build_topology(N, NB, m, 4, 2)
    for f in jt.__dataclass_fields__:
        a, b = getattr(jt, f), getattr(tt, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


@pytest.mark.parametrize("op", ["softsat", "softmin", "softmax", "softmax_pair"])
def test_softmath(op):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, (7, 5))
    if op == "softsat":
        _close(tsm.softsat(_t(x), 1.7), jsm.softsat(jnp.asarray(x), 1.7))
    elif op == "softmin":
        _close(tsm.softmin(_t(x), 5.0, axis=1), jsm.softmin(jnp.asarray(x), 5.0, axis=1))
        _close(tsm.softmin(_t(x), 2.0), jsm.softmin(jnp.asarray(x), 2.0))
    elif op == "softmax":
        _close(tsm.softmax(_t(x), 3.0, axis=0), jsm.softmax(jnp.asarray(x), 3.0, axis=0))
    else:
        for v in x[:, 0]:
            _close(tsm.softmax_pair(-7.0, _t(v), 5.0), jsm.softmax_pair(-7.0, jnp.asarray(v), 5.0))


def test_dubins():
    x = _states(2)
    u = np.random.default_rng(3).normal(0, 1, (16, 2))
    for xi, ui in zip(x, u):
        _close(tdyn.dubins(_t(xi), _t(ui)), jdyn.dubins(jnp.asarray(xi), jnp.asarray(ui)))
    _close(tdyn.dubins(_t(x), _t(u)), np.stack([jdyn.dubins(a, b) for a, b in zip(x, u)]))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_highway_policies(i):
    jc = JBranchConstants()
    xt = np.array([0.5, 5.4, 15.0, 0.0])
    jset = jpol.highway_policy_set(jc, xt)
    tparams = convert_policy_params(jset.params, "cpu")
    tset = tpol.highway_policy_set(convert_constants(jc), xt)
    x = _states(4)
    got = tset.fns[i](_t(x), tparams[i])
    want = np.stack([jset.fns[i](jnp.asarray(xi), jset.params[i]) for xi in x])
    _close(got, want)


@pytest.mark.parametrize("fn", ["veh_col", "lane_bdry_h"])
def test_safety(fn):
    x1, x2 = _states(5), _states(6)
    if fn == "veh_col":
        size = (5.0, 2.7)
        _close(tsaf.veh_col(_t(x1), _t(x2), size), jsaf.veh_col(x1, x2, size, alpha=1.0))
    else:
        _close(tsaf.lane_bdry_h(_t(x1), 1.25, 9.55), jsaf.lane_bdry_h(x1, 1.25, 9.55))


def test_collision_gradient_on_a_tie():
    """Ego and obstacle on the same lane centre (ΔY = 0 exactly): the
    collision row's gradient matches the reference's."""
    from belief_planning_tpu.models.predictive import highway_model as j_highway_model
    from belief_planning_tpu_torch.models.predictive import highway_model as t_highway_model

    jc = JBranchConstants()
    xt = np.array([0.5, 5.4, 15.0, 0.0])
    jm = j_highway_model(jc, jpol.highway_policy_set(jc, xt), N=4, dt=0.1)
    tc = convert_constants(jc)
    tm = t_highway_model(tc, tpol.highway_policy_set(tc, xt), N=4, dt=0.1)
    x = np.array([[0.0, 1.8, 20.0, 0.0], [3.0, 1.8, 18.0, 0.1]])
    z = np.array([[9.0, 1.8, 17.0, 0.0], [3.0, 5.4, 17.0, 0.0]])
    h, dh = tm.col_raw(_t(x), _t(z))
    col_raw = jax.jit(jm.col_raw)
    for i in range(2):
        jh, jdh = col_raw(jnp.asarray(x[i]), jnp.asarray(z[i]))
        _close(h[i], jh)
        _close(dh[i], jdh)


def test_rollouts():
    jc = JBranchConstants()
    jset = jpol.highway_policy_set(jc, np.array([0.5, 5.4, 15.0, 0.0]))
    tparams = convert_policy_params(jset.params, "cpu")
    tset = tpol.highway_policy_set(convert_constants(jc), np.array([0.5, 5.4, 15.0, 0.0]))
    x0 = _states(7, 3)
    for i in range(3):
        want = jax.vmap(lambda xi: jroll.rollout_policy(jdyn.dubins, jset.fns[i], xi,
                                                        jset.params[i], 6, 0.1))(x0)
        _close(troll.rollout_policy(tdyn.dubins, tset.fns[i], _t(x0), tparams[i], 6, 0.1), want)
    us = np.random.default_rng(8).normal(0, 1, (5, 2))
    _close(troll.rollout_controls(tdyn.dubins, _t(x0[0]), _t(us), 0.1),
           jroll.rollout_controls(jdyn.dubins, x0[0], us, 0.1))


def test_linearize_vs_jax_and_finite_differences():
    x = _states(9, 12)
    u = np.random.default_rng(10).normal(0, 1, (12, 2))
    A, B, C, xp = tlin.linearize_dynamics(tdyn.dubins, _t(x), _t(u), 0.1)
    jA, jB, jC, jxp = jax.jit(lambda a, b: jlin.linearize_dynamics(jdyn.dubins, a, b, 0.1))(x, u)
    for a, b in ((A, jA), (B, jB), (C, jC), (xp, jxp)):
        _close(a, b, 1e-9)
    # central finite differences of the Euler step
    eps = 1e-6
    f = lambda xx, uu: tlin.discrete_step(tdyn.dubins, xx, uu, 0.1)
    for k in range(4):
        e = torch.zeros(4, dtype=torch.float64)
        e[k] = eps
        fd = (f(_t(x) + e, _t(u)) - f(_t(x) - e, _t(u))) / (2 * eps)
        assert (A[..., :, k] - fd).abs().max() < 1e-6
    for k in range(2):
        e = torch.zeros(2, dtype=torch.float64)
        e[k] = eps
        fd = (f(_t(x), _t(u) + e) - f(_t(x), _t(u) - e)) / (2 * eps)
        assert (B[..., :, k] - fd).abs().max() < 1e-6
