"""The HMM belief path against the JAX package (CPU, f64; the model carried
over by ``convert_hmm_model``):

- the pieces, < 1e-12: ``backup_trans``, ``backup_input_prob``, the
  augmented ``step`` and ``linearize`` (A, B, C, h0, Jh), with a sample
  whose ego and obstacle share the lane centre (ΔY = 0 exactly, where the
  margin's |·| takes the reference's derivative), ``generate_backup_traj``
  and ``backup_traj_with_sensitivity``;
- ``make_hmm_mpc_batched_step`` against the JAX package's (its
  ``jit(vmap(make_hmm_mpc_step))``) at
  ``tests/test_hmm.py``'s batched inputs (M=1, N=6, B=3, IPM-12, two
  steps): u < 1e-9, x < 1e-8; the ADMM step (400 iterations) finds the
  IPM-30's optimum, u < 1e-6 (``tests/test_torch_hmm_admm.py`` holds the
  ADMM step to the JAX package's);
- ``HMMHighwayEnv`` with ``HMMMPC`` at ``tests/test_hmm.py``'s env config
  (NV=3, M=2, N=5, six lanes, seed 0; the default IPM), 3 steps: states <
  1e-6, beliefs < 1e-8, backup choices equal and the generator's next draw
  equal;
- ``envs/small_qp.solve_qp`` against the oracle's ``solve_qp`` on every CBF
  QP the environment solved: z < 1e-12, same status and iterations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.controllers.hmm_mpc import HMMMPC as JHMMMPC
from belief_planning_tpu.controllers.hmm_mpc import make_hmm_mpc_step as j_step
from belief_planning_tpu.envs.hmm_highway import HMMHighwayEnv as JHMMHighwayEnv
from belief_planning_tpu.models import hmm as jhmm
from belief_planning_tpu.models.dynamics import dubins as j_dubins
from belief_planning_tpu.oracle.qp import solve_qp as oracle_solve_qp
from belief_planning_tpu.solvers.tree_qp import ADMMConfig as JADMMConfig
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig

from belief_planning_tpu_torch.controllers.hmm_mpc import (
    HMMMPC,
    make_hmm_mpc_batched_step,
    make_hmm_mpc_step,
)
from belief_planning_tpu_torch.convert import convert_hmm_model, convert_mpc_params
from belief_planning_tpu_torch.envs import hmm_highway
from belief_planning_tpu_torch.models import hmm as thmm
from belief_planning_tpu_torch.models.dynamics import dubins
from belief_planning_tpu_torch.solvers.tree_qp import ADMMConfig
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

from tests.test_hmm import hmm_setup
from tests.test_torch_tree_admm import FAST_XLA

torch.set_num_threads(1)

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---- the pieces --------------------------------------------------------------

def _piece_inputs():
    rng = np.random.default_rng(2)
    K = 4
    xb = np.concatenate([np.array([0.0, 1.8, 15.0, 0.0]) + rng.normal(0, [1, 0.3, 1, 0.05], (K, 4)),
                         rng.uniform(0.2, 0.8, (K, 2))], axis=1)
    xb[:, 4:] /= xb[:, 4:].sum(axis=1, keepdims=True)
    u = rng.normal(0, [1.0, 0.1], (K, 2))
    xbk = np.array([12.0, 1.8, 14.0, 0.0]) + rng.normal(0, [2, 0.5, 1, 0.05], (K, 2, 4))
    xb[0, 1] = xbk[0, 0, 1] = 1.8          # ΔY = 0 on the first policy's row
    return xb, u, xbk


@pytest.fixture(scope="module")
def pieces():
    cons, model, params = hmm_setup()
    tmodel = convert_hmm_model(model, "cpu")
    xb, u, xbk = _piece_inputs()
    h = np.random.default_rng(6).normal(0, 1.0, (5, 2))
    j = jax.jit(lambda xb, u, xbk, h: (
        jax.vmap(lambda hh: jhmm.backup_trans(hh, cons))(h),
        jhmm.backup_input_prob(h, cons),
        jax.vmap(model.step)(xb, u, xbk),
        jax.vmap(model.linearize)(xb, u, xbk),
        model.generate_backup_traj(xbk[0], 7)), compiler_options=FAST_XLA)(xb, u, xbk, h)
    t = (thmm.backup_trans(_t(h), tmodel.cons), thmm.backup_input_prob(_t(h), tmodel.cons),
         tmodel.step(_t(xb), _t(u), _t(xbk)), tmodel.linearize(_t(xb), _t(u), _t(xbk)),
         tmodel.generate_backup_traj(_t(xbk[0]), 7))
    # the rollout with sensitivities, under each policy, from two starts
    x0s = np.array([[0.0, 1.8, 15.0, 0.0], [3.0, 5.2, 13.0, 0.04]])
    f0 = np.array([15.0, 0.0, 0.0, 0.0])
    sens = []
    for jfn, jp, tfn, tp in zip(model.policy_fns, model.policy_params, tmodel.policy_fns,
                                tmodel.policy_params):
        jr = jax.jit(jax.vmap(lambda x0: jhmm.backup_traj_with_sensitivity(
            lambda x: j_dubins(x, jfn(x, jp)), x0, 10, 0.1, jnp.asarray(f0))),
            compiler_options=FAST_XLA)(x0s)
        tr = thmm.backup_traj_with_sensitivity(lambda x: dubins(x, tfn(x, tp)), _t(x0s), 10, 0.1,
                                               _t(f0))
        sens.append((_np(jr), tr))
    return dict(j=_np(j), t=t, sens=sens)


def _leaves(tree):
    return tree if isinstance(tree, (tuple, list)) else (tree,)


@pytest.mark.parametrize("piece", ["backup_trans", "backup_input_prob", "step", "linearize",
                                   "generate_backup_traj"])
def test_pieces_match_jax(pieces, piece):
    k = ["backup_trans", "backup_input_prob", "step", "linearize",
         "generate_backup_traj"].index(piece)
    for a, b in zip(_leaves(pieces["t"][k]), _leaves(pieces["j"][k])):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() < 1e-12


def test_linearize_at_zero_lateral_gap(pieces):
    """ΔY = 0 exactly on sample 0: Jh's Y column is the reference's, not 0."""
    Jh_t, Jh_j = pieces["t"][3][4][0], pieces["j"][3][4][0]
    assert abs(Jh_j[0, 0, 1]) > 1e-3
    assert abs(Jh_t[0, 0, 1].item() - Jh_j[0, 0, 1]) < 1e-12


def test_backup_traj_with_sensitivity_matches_jax(pieces):
    for jr, tr in pieces["sens"]:
        for a, b in zip(tr, jr):
            assert a.shape == b.shape
            assert np.abs(a.numpy() - b).max() < 1e-12


# ---- the controller ----------------------------------------------------------

def _mpc_inputs(B=3):
    """``tests/test_hmm.py::test_hmm_batched_step_matches_per_lane``'s inputs."""
    rng = np.random.default_rng(3)
    x0s = np.array([0., 1.8, 15., 0.]) + rng.normal(0, 0.2, (B, 4))
    b0s = rng.uniform(0.2, 0.8, (B, 1, 2))
    b0s /= b0s.sum(axis=2, keepdims=True)
    z = np.array([14., 1.8, 10., 0.])
    xbk = np.zeros((B, 6, 2, 4))
    for t in range(6):
        xbk[:, t, 0] = z + np.array([10., 0, 0, 0]) * 0.1 * (t + 1)
        xbk[:, t, 1] = z + np.array([8., 0, 0, 0]) * 0.1 * (t + 1)
    xbk += rng.normal(0, 0.05, xbk.shape)
    xRef = np.concatenate([np.array([0., 1.8, 15., 0.]), np.zeros(2)])
    return x0s, b0s, xbk, xRef


@pytest.fixture(scope="module")
def mpc_steps():
    cons, model, params = hmm_setup(N=6)
    tmodel, tparams = convert_hmm_model(model, "cpu"), convert_mpc_params(params)
    args = _mpc_inputs()
    # the JAX package's batched step is jit(vmap(step, xRef shared)); built so
    # here to compile it under FAST_XLA
    _, jinit1, jstep1 = j_step(model, params, solver="ipm", ipm=JQPIPMConfig(iters=12))
    jstep = jax.jit(jax.vmap(jstep1, in_axes=(0, 0, 0, 0, None)), compiler_options=FAST_XLA)
    jinit = lambda B, dt: jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jinit1(dt))
    _, tinit, tstep = make_hmm_mpc_batched_step(tmodel, tparams, ipm=QPIPMConfig(iters=12),
                                                device="cpu")
    jc, tc = jinit(3, jnp.float64), tinit(3, F64)
    out = []
    for _ in range(2):
        jc, jr = jstep(jc, *(jnp.asarray(a) for a in args))
        tc, tr = tstep(tc, *(_t(a) for a in args))
        out.append((_np(jr), tr))
    # the ADMM path: converged, it finds the IPM's optimum
    _, ainit, astep = make_hmm_mpc_step(tmodel, tparams, ADMMConfig(iters=400), solver="admm",
                                        device="cpu")
    _, iinit, istep = make_hmm_mpc_step(tmodel, tparams, solver="ipm", ipm=QPIPMConfig(iters=30),
                                        device="cpu")
    out.append(tuple(step(init(3, F64), *(_t(a) for a in args))[1]
                     for init, step in ((ainit, astep), (iinit, istep))))
    return out


@pytest.mark.parametrize("k", range(2), ids=["ipm_cold", "ipm_warm"])
def test_hmm_step_matches_jax(mpc_steps, k):
    jr, tr = mpc_steps[k]
    assert np.abs(tr.uPred.numpy() - jr.uPred).max() < 1e-9
    assert np.abs(tr.xPred.numpy() - jr.xPred).max() < 1e-8
    assert np.array_equal(tr.feasible.numpy(), jr.feasible)
    np.testing.assert_allclose(tr.prim_res.numpy(), jr.prim_res, rtol=1e-6, atol=1e-9)
    assert bool(tr.feasible.all())


def test_hmm_admm_step_finds_the_ipm_optimum(mpc_steps):
    """``solver="admm"`` (``ADMMConfig(iters=400)``) against the IPM-30 on the
    same trees: u < 1e-6, both feasible."""
    ra, ri = mpc_steps[2]
    assert (ra.uPred - ri.uPred).abs().max().item() < 1e-6
    assert bool(ra.feasible.all()) and bool(ri.feasible.all())


# ---- the environment ---------------------------------------------------------

@pytest.fixture(scope="module")
def envs():
    cons, model, params = hmm_setup(M=2, N=5)
    jmpc = JHMMMPC(params, model, admm=JADMMConfig(iters=120, polish_iters=15),
                   dtype=jnp.float64)
    jmpc._step = jax.jit(j_step(model, params, JADMMConfig(iters=120, polish_iters=15))[2],
                         compiler_options=FAST_XLA)
    tmpc = HMMMPC(convert_mpc_params(params), convert_hmm_model(model, "cpu"), device="cpu")
    jenv = JHMMHighwayEnv(NV=3, mpc=jmpc, N_lane=6, seed=0)
    tenv = hmm_highway.HMMHighwayEnv(NV=3, mpc=tmpc, N_lane=6, seed=0)
    qps = []
    real = hmm_highway.solve_qp

    def recording(P, q, **kw):
        sol = real(P, q, **kw)
        qps.append(((P, q), kw, sol))
        return sol

    hmm_highway.solve_qp = recording
    try:
        rec = {"j": [], "t": []}
        for t in range(3):
            for k, env in (("j", jenv), ("t", tenv)):
                u_set, states = env.step(t)
                rec[k].append((np.array(u_set), np.array(states), env.b.copy(),
                               [v.backupidx for v in env.veh_set]))
    finally:
        hmm_highway.solve_qp = real
    return dict(rec=rec, qps=qps, draws=(jenv.rng.random(), tenv.rng.random()))


def test_hmm_env_matches_jax(envs):
    for (ju, js, jb, jc), (tu, ts, tb, tc) in zip(envs["rec"]["j"], envs["rec"]["t"]):
        assert np.abs(ts - js).max() < 1e-6
        assert np.abs(tu - ju).max() < 1e-6
        assert np.abs(tb - jb).max() < 1e-8
        assert tc == jc
    assert envs["draws"][0] == envs["draws"][1]
    assert np.allclose(envs["rec"]["t"][-1][2].sum(axis=1), 1.0, atol=1e-12)


def test_small_qp_matches_oracle(envs):
    assert envs["qps"], "the environment solved no CBF QP"
    for (P, q), kw, sol in envs["qps"]:
        ref = oracle_solve_qp(P, q, **kw)
        assert sol.status == ref.status and sol.iterations == ref.iterations
        assert np.abs(sol.z - ref.z).max() < 1e-12
