"""The ADMM branch-MPC step and the entry step against the JAX package
(CPU, f64):

- ``make_branch_mpc_step(solver="admm")`` against the JAX package's per-tree
  step under ``vmap``: the overtake at N=4, NB=2, the entry's ADMM config
  (ρ=5, 50 iterations at fixed ρ, 10 polish), 3 trees, a cold step and a
  warm one with the duals carried and shifted: u < 1e-7, x < 1e-6, the
  carried duals < 1e-6;
- ``entry()`` against ``__graft_entry__.entry()`` on the same example
  arguments cast to f64 (N=8, NB=2, B=4): u < 1e-7 (``chip_smoke.py`` runs
  it in f32 on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from belief_planning_tpu.controllers.branch_mpc import make_branch_mpc_step as j_make_step
from belief_planning_tpu.solvers.tree_qp import ADMMConfig as JADMMConfig

from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_step
from belief_planning_tpu_torch.convert import convert, convert_admm_config
from belief_planning_tpu_torch.entry import entry
from belief_planning_tpu_torch.models import policies as tpol
from belief_planning_tpu_torch.models.predictive import highway_model

from tests.test_torch_tree_admm import FAST_XLA
from tests.test_tree_qp import overtake_setup

torch.set_num_threads(1)

N, NB, B = 4, 2, 3
F64 = torch.float64
ADMM = dict(rho=5.0, iters=50, rho_update_every=0, polish_iters=10)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def steps():
    cons, pset, model, params = overtake_setup(N=N, NB=NB)
    rng = np.random.default_rng(4)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.1, (B, 4))
    zs = np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
    xRefs = np.tile([0.0, 1.8, 18.0, 0.0], (B, 1))
    # the second step: the states moved on, the carry's p and duals shifted
    xs2, zs2 = xs + np.array([2.0, 0.0, 0.0, 0.0]), zs + np.array([1.7, 0.0, 0.0, 0.0])

    _, jinit, jstep = j_make_step(model, params, "prox", JADMMConfig(**ADMM), solver="admm")
    jstep = jax.jit(jax.vmap(jstep, in_axes=(0, 0, 0, 0, None)), compiler_options=FAST_XLA)
    c = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jinit(jnp.float64))
    jout = []
    for x, z in ((xs, zs), (xs2, zs2)):
        c, r = jstep(c, jnp.asarray(x), jnp.asarray(z), jnp.asarray(xRefs), pset.params)
        jout.append((_np(c), _np(r)))

    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    fns = (tpol.maintain, tpol.brake, tpol.lane_change)
    tmodel = highway_model(tcons, tpol.PolicySet(fns=fns, params=tpp), N=N, dt=0.1)
    _, tinit, tstep = make_branch_mpc_step(tmodel, tparams, "prox", solver="admm", device="cpu",
                                           admm=convert_admm_config(JADMMConfig(**ADMM)))
    t = lambda a: torch.as_tensor(a, dtype=F64)
    tc = tinit(B, F64)
    tout = []
    for x, z in ((xs, zs), (xs2, zs2)):
        tc, r = tstep(tc, t(x), t(z), t(xRefs), tpp)
        tout.append((tc, r))
    return jout, tout


@pytest.mark.parametrize("k", range(2))
def test_admm_step_matches_jax(steps, k):
    (jc, jr), (tc, tr) = steps[0][k], steps[1][k]
    assert np.abs(tr.uPred.numpy() - jr.uPred).max() < 1e-7
    assert np.abs(tr.xPred.numpy() - jr.xPred).max() < 1e-6
    for f in ("y1", "y2", "y3"):
        assert np.abs(getattr(tc, f).numpy() - getattr(jc, f)).max() < 1e-6, f
    assert np.array_equal(tr.feasible.numpy(), jr.feasible)
    assert tr.gap.isnan().all()


def test_duals_are_carried(steps):
    """The warm step starts from the shifted duals: they are non-zero."""
    tc = steps[1][0][0]
    assert tc.y1.abs().max() > 0 and tc.y2.abs().max() > 0


def test_entry_matches_jax():
    jfn, jargs = graft.entry()
    fn, args = entry(device="cpu")
    ju = np.asarray(jax.jit(jfn, compiler_options=FAST_XLA)(
        *jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jargs)))
    carrys, *rest = args
    carrys64 = type(carrys)(*(f if f is None or not f.is_floating_point() else f.to(F64)
                              for f in carrys))
    u = fn(carrys64, *(a.to(F64) for a in rest))
    assert u.shape == ju.shape
    assert np.abs(u.numpy() - ju).max() < 1e-7
