"""The port's per-tree controller steps against the JAX package's under
``vmap``, on the same seeded states with parameters carried by ``convert``,
two receding-horizon steps each (the second warm-started from the first).

- ``make_branch_mpc_step(solver="ipm")`` on the overtake tree (N=4, NB=2,
  3 trees, f64, IPM-10): u < 1e-7, x < 1e-6, prim_res and feasibility, the
  bars of ``tests/test_tree_qp_pl.py:80``.
- ``make_cvar_mpc_step`` with ``restart`` on the merge deployment (N=3,
  NB=1, 3 trees, per-tree S and bx, the dh[0] floor on the warm step, f64):
  u < 1e-7, x and risk < 1e-6, gap and J within rtol 1e-8. IPM-6 without
  correctors leaves every merge tree at its starting point (the merge's gaps
  climb over the first iterations), and the default restart, 8 iterations
  with 4 correctors, is kept on one tree of the first step and on two of the
  second. A longer solve reaches the jam where the reference's own late
  iterates are chaotic (``scripts/torch_port_ipm_chaos.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.controllers.branch_mpc import make_branch_mpc_step as j_make_branch_step
from belief_planning_tpu.controllers.cvar_mpc import make_cvar_mpc_step as j_make_cvar_step
from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig

from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_step
from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_step
from belief_planning_tpu_torch.convert import convert, convert_cvar_ipm_config
from belief_planning_tpu_torch.models import policies as tpol
from belief_planning_tpu_torch.models.predictive import highway_model, merge_model
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

from tests.test_torch_cuda import cvar_problem
from tests.test_torch_cvar_mpc import _jax_setup
from tests.test_tree_qp import overtake_setup

torch.set_num_threads(1)

B, STEPS = 3, 2
f64 = torch.float64
np_ = lambda t: jnp.asarray(t.numpy())


def _jax_steps(step, carry, args, in_axes):
    """``STEPS`` steps of the vmapped JAX step from the broadcast ``carry``."""
    step = jax.jit(jax.vmap(step, in_axes=in_axes))
    c = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), carry)
    out = []
    for _ in range(STEPS):
        c, r = step(c, *args)
        out.append(jax.tree.map(np.asarray, r))
    return out


def _port_steps(init, step, args, **kw):
    c, out = init(B, f64), []
    for _ in range(STEPS):
        c, r = step(c, *args, **kw)
        out.append(r)
    return out


@pytest.fixture(scope="module")
def qp_steps():
    cons, pset, model, params = overtake_setup(N=4, NB=2)
    ipm = dict(iters=10)
    rng = np.random.default_rng(3)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.1, (B, 4))
    zs = np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
    xRefs = np.tile([0.0, 1.8, 18.0, 0.0], (B, 1))
    _, jinit, jstep = j_make_branch_step(model, params, "prox", solver="ipm",
                                         ipm=JQPIPMConfig(**ipm))
    jres = _jax_steps(jstep, jinit(jnp.float64), (xs, zs, xRefs, pset.params), (0, 0, 0, 0, None))

    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = highway_model(tcons, tpol.PolicySet(fns=(tpol.maintain, tpol.brake,
                                                      tpol.lane_change), params=tpp), N=4, dt=0.1)
    _, tinit, tstep = make_branch_mpc_step(tmodel, tparams, "prox", solver="ipm",
                                           ipm=QPIPMConfig(**ipm), device="cpu")
    t = lambda a: torch.as_tensor(a, dtype=f64)
    return jres, _port_steps(tinit, tstep, (t(xs), t(zs), t(xRefs), tpp))


@pytest.mark.parametrize("k", range(STEPS))
def test_branch_step_matches_jax(qp_steps, k):
    jr, tr = (seq[k] for seq in qp_steps)
    assert np.abs(tr.uPred.numpy() - jr.uPred).max() < 1e-7
    assert np.abs(tr.xPred.numpy() - jr.xPred).max() < 1e-6
    assert np.abs(tr.slack.numpy() - jr.slack).max() < 1e-6
    np.testing.assert_allclose(tr.prim_res.numpy(), jr.prim_res, rtol=1e-6, atol=1e-9)
    assert np.array_equal(tr.feasible.numpy(), jr.feasible)


@pytest.fixture(scope="module")
def cvar_steps():
    """``(JAX results, port results, port results without the restart)``."""
    cons, pset, model, params = _jax_setup("merge")
    jcfg = JCVaRIPMConfig(iters=6)
    _, _, jinit, jstep = j_make_cvar_step(model, params, 0.1, ipm=jcfg, use_S=True, restart=8)
    _, _, _, _, _, xs, zs, xRefs, S, bx, _ = cvar_problem("merge", 3, 1, B)
    jres = _jax_steps(jstep, jinit(jnp.float64),
                      (np_(xs), np_(zs), np_(xRefs), pset.params, np_(S), np_(bx)),
                      (0, 0, 0, 0, None, 0, 0))

    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = merge_model(tcons, tpol.PolicySet(fns=(tpol.maintain_track_v, tpol.brake),
                                               params=tpp), N=3, dt=0.1)
    out = []
    for restart in (8, 0):
        _, _, tinit, tstep = make_cvar_mpc_step(tmodel, tparams, 0.1,
                                                ipm=convert_cvar_ipm_config(jcfg), use_S=True,
                                                restart=restart, device="cpu")
        out.append(_port_steps(tinit, tstep, (xs, zs, xRefs, tpp), S=S, bx=bx))
    return jres, out[0], out[1]


@pytest.mark.parametrize("k", range(STEPS))
def test_cvar_step_with_restart_matches_jax(cvar_steps, k):
    jr, tr, t_plain = (seq[k] for seq in cvar_steps)
    # the restart is kept on some trees and not on others
    kept = tr.gap < t_plain.gap
    assert bool(kept.any()) and not bool(kept.all())
    assert np.abs(tr.uPred.numpy()[:, 0] - jr.uPred[:, 0]).max() < 1e-7
    assert np.abs(tr.uPred.numpy() - jr.uPred).max() < 1e-7
    assert np.abs(tr.xPred.numpy() - jr.xPred).max() < 1e-6
    assert np.abs(tr.risk.numpy() - jr.risk).max() < 1e-6
    np.testing.assert_allclose(tr.gap.numpy(), jr.gap, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tr.J.numpy(), jr.J, rtol=1e-8, atol=1e-10)
