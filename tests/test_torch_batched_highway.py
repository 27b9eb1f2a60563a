"""The closed-loop overtake ensemble against the JAX package (CPU, f64, the
plain fused iteration), with the small overtake config (N=3, NB=1):

- per-lane policy params: ``make_branch_mpc_batched_step(policy_in_axes=
  (None, None, LaneChangeParams(x_target=0)))``, one lane-change target a
  lane, two warm-started steps (u < 1e-7, x < 1e-6); shared and per-lane
  params give bit-identical trees and steps when every lane has the same
  target;
- the world step's closures (``pre``, ``post``) against ``_make_env_logic``'s
  on hand-set worlds at t = 0, 7 and 10, given the JAX side's draws: reals
  to 1e-12, lanes equal;
- the fused episode against the JAX package's, from its worlds and with its
  draws (computed here from its key chain), u, x, z < 1e-6 (the JAX
  package's own bar between its couplings, ``tests/test_batched_env.py``);
  the port's two couplings agree to 1e-6;
- ``assemble_stage_cost(variant="branch")`` against the JAX package's, to
  1e-12, with and without the reference's quirks, and ``variant="robust"``;
- ``make_batched_overtake(solver="admm")`` builds and steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.controllers.branch_mpc import (
    make_branch_mpc_batched_step as j_make_step,
)
from belief_planning_tpu.envs.batched_highway import WorldState as JWorldState
from belief_planning_tpu.envs.batched_highway import _make_env_logic as j_env_logic
from belief_planning_tpu.envs.batched_highway import (
    make_batched_overtake_fused as j_make_fused,
)
from belief_planning_tpu.models.policies import LaneChangeParams as JLaneChangeParams
from belief_planning_tpu.models.policies import highway_policy_set as j_highway_set
from belief_planning_tpu.models.predictive import highway_model as j_highway_model
from belief_planning_tpu.presets import init_branch_mpc as j_init_branch_mpc
from belief_planning_tpu.solvers.tree_qp import assemble_stage_cost as j_assemble
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig
from belief_planning_tpu.tree.engine import build_tree as j_build_tree
from belief_planning_tpu.tree.topology import build_topology as j_build_topology
from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants

from belief_planning_tpu_torch.controllers.branch_mpc import make_branch_mpc_batched_step
from belief_planning_tpu_torch.convert import convert, convert_overtake_worlds, convert_tree_state
from belief_planning_tpu_torch.envs.batched_highway import (
    WorldState,
    make_batched_overtake,
    make_batched_overtake_fused,
    make_env_logic,
)
from belief_planning_tpu_torch.models.policies import LaneChangeParams, highway_policy_set
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.solvers.tree_qp import ADMMConfig, assemble_stage_cost
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig
from belief_planning_tpu_torch.tree.topology import build_topology

torch.set_num_threads(1)

N, NB, N_LANE = 3, 1, 4
IPM = dict(iters=8, gondzio=2)
B_STEP, B_EP, T_EP = 6, 4, 6
F64 = torch.float64


def _jax_setup():
    cons = JBranchConstants()
    xt = np.array([0.5, 1.8, 15.0, 0.0])
    pset = j_highway_set(cons, xt)
    model = j_highway_model(cons, pset, N=N, dt=0.1)
    params = j_init_branch_mpc(4, 2, N, NB, xt, am=6.0, rm=0.3, N_lane=N_LANE, W=cons.W)
    return cons, pset, model, params


def _port(cons, pset, params):
    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = highway_model(tcons, highway_policy_set(tcons, tpp[2].x_target), N=N, dt=0.1)
    return tparams, tcons, tpp, tmodel


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    cons, pset, model, params = _jax_setup()
    return dict(j=(cons, pset, model, params), t=_port(cons, pset, params))


# ---- per-lane policy params ------------------------------------------------

def _step_inputs():
    rng = np.random.default_rng(5)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, [0.3, 0.3, 1.0, 0.05], (B_STEP, 4))
    zs = np.array([9.0, 5.4, 17.0, 0.0]) + rng.normal(0, [1.0, 0.5, 1.0, 0.05], (B_STEP, 4))
    xRefs = np.tile([0.0, 1.8, 18.0, 0.0], (B_STEP, 1))
    lanes = np.array([0, 1, 2, 3, 1, 2])
    targets = np.stack([np.zeros(B_STEP), 1.8 + 3.6 * lanes, np.full(B_STEP, 20.0),
                        np.zeros(B_STEP)], axis=1)
    return xs, zs, xRefs, targets


@pytest.fixture(scope="module")
def per_lane(setup):
    cons, pset, model, params = setup["j"]
    tparams, tcons, tpp, tmodel = setup["t"]
    xs, zs, xRefs, targets = _step_inputs()
    jaxes = (None, None, JLaneChangeParams(x_target=0))
    _, jinit, jstep = j_make_step(model, params, "prox", ipm=JQPIPMConfig(**IPM),
                                  backend="pl_xla", policy_in_axes=jaxes)
    jstep = jax.jit(jstep)
    jpp = (pset.params[0], pset.params[1], JLaneChangeParams(x_target=jnp.asarray(targets)))
    c = jax.tree.map(lambda a: jnp.broadcast_to(a, (B_STEP,) + a.shape), jinit(jnp.float64))
    jres = []
    for _ in range(2):
        c, r = jstep(c, jnp.asarray(xs), jnp.asarray(zs), jnp.asarray(xRefs), jpp)
        jres.append(_np(r))

    axes = (None, None, LaneChangeParams(x_target=0))
    _, tinit, tstep = make_branch_mpc_batched_step(tmodel, tparams, "prox",
                                                   ipm=QPIPMConfig(**IPM), device="cpu",
                                                   policy_in_axes=axes)
    tpp_lane = (tpp[0], tpp[1], LaneChangeParams(x_target=_t(targets)))
    tc = tinit(B_STEP, F64)
    tres = []
    for _ in range(2):
        tc, r = tstep(tc, _t(xs), _t(zs), _t(xRefs), tpp_lane)
        tres.append(r)
    return dict(jres=jres, tres=tres, tinit=tinit, tstep=tstep, tmodel=tmodel, tparams=tparams,
                tpp=tpp)


@pytest.mark.parametrize("k", range(2))
def test_per_lane_step_matches_jax(per_lane, k):
    jr, tr = per_lane["jres"][k], per_lane["tres"][k]
    assert np.abs(tr.uPred.numpy() - jr.uPred).max() < 1e-7
    assert np.abs(tr.xPred.numpy() - jr.xPred).max() < 1e-6
    for f in ("p", "w", "z", "x_lin"):
        assert np.abs(getattr(tr, f).numpy() - getattr(jr, f)).max() < 1e-9, f
    assert np.array_equal(tr.feasible.numpy(), jr.feasible)


def test_targets_reach_each_lane(per_lane):
    """Each lane's own target reaches its tree: lanes with equal states but
    different targets get different branch probabilities."""
    tstep, tinit, tpp = per_lane["tstep"], per_lane["tinit"], per_lane["tpp"]
    x = torch.tensor([[0.0, 1.8, 20.0, 0.0]] * 2, dtype=F64)
    z = torch.tensor([[8.0, 5.4, 17.0, 0.0]] * 2, dtype=F64)
    tg = torch.tensor([[0.0, 1.8, 20.0, 0.0], [0.0, 9.0, 20.0, 0.0]], dtype=F64)
    xr = torch.tensor([[0.0, 1.8, 18.0, 0.0]] * 2, dtype=F64)
    _, r = tstep(tinit(2, F64), x, z, xr, (tpp[0], tpp[1], LaneChangeParams(x_target=tg)))
    assert not torch.allclose(r.p[0], r.p[1])


def test_shared_and_per_lane_params_bit_identical(per_lane):
    """With every lane's target equal to the shared one, the per-lane path
    gives the shared path's trees and steps bit for bit."""
    tmodel, tparams, tpp = per_lane["tmodel"], per_lane["tparams"], per_lane["tpp"]
    xs, zs, xRefs, _ = _step_inputs()
    _, init_s, step_s = make_branch_mpc_batched_step(tmodel, tparams, "prox",
                                                     ipm=QPIPMConfig(**IPM), device="cpu")
    step_l, init_l = per_lane["tstep"], per_lane["tinit"]
    lane_pp = (tpp[0], tpp[1],
               LaneChangeParams(x_target=tpp[2].x_target.expand(B_STEP, 4).clone()))
    cs, cl = init_s(B_STEP, F64), init_l(B_STEP, F64)
    for _ in range(2):
        cs, rs = step_s(cs, _t(xs), _t(zs), _t(xRefs), tpp)
        cl, rl = step_l(cl, _t(xs), _t(zs), _t(xRefs), lane_pp)
        for f in rs._fields:
            assert torch.equal(getattr(rs, f), getattr(rl, f)), f


# ---- the world step's closures ---------------------------------------------

T_PRE = (0, 7, 10)


def _pre_worlds():
    """Hand-set worlds: the initial one; ego and obstacle close in one lane; an
    obstacle between lanes; one that has reached lane 2; one in the top lane;
    an ego past the obstacle; each in f64 numpy."""
    x = np.tile([0.0, 1.8, 20.0, 0.0], (B_STEP, 1))
    z = np.tile([12.0, 5.4, 17.0, 0.0], (B_STEP, 1))
    x[1, 1], z[1, 0] = 5.4, 3.0
    z[2, 1] = 1.8 + 3.6 * 2 - 1.5
    z[3, 1] = 9.0 + 0.3
    z[4, 1], z[4, 3] = 1.8 + 3.6 * 3, 0.05
    x[5, 0], x[5, 1], z[5, 0] = 20.0, 5.6, 15.0
    ego_lane = np.array([0, 1, 0, 0, 0, 1])
    obs_lane = np.array([1, 1, 1, 1, 3, 1])
    lc = np.tile([0.5, 1.8, 15.0, 0.0], (B_STEP, 1))
    lc[2] = [0.0, 9.0, 20.0, 0.0]
    return dict(x=x, z=z, ego_lane=ego_lane, obs_lane=obs_lane, obs_des_y=z[:, 1].copy(),
                lc_target=lc, collided=np.array([False] * B_STEP))


@pytest.fixture(scope="module")
def closures(setup):
    cons, pset, model, params = setup["j"]
    tparams, tcons, tpp, tmodel = setup["t"]
    jl = j_env_logic(cons, model, N_LANE, jnp.float64)
    jpre = jax.jit(jax.vmap(jl.pre, in_axes=(0, 0, None)))
    jpost = jax.jit(jax.vmap(jl.post))
    jdraws = jax.jit(jax.vmap(_key_draws))
    w = _pre_worlds()
    jw = JWorldState(mpc_carry=None, x=jnp.asarray(w["x"]), z=jnp.asarray(w["z"]),
                     ego_lane=jnp.asarray(w["ego_lane"], jnp.int32),
                     obs_lane=jnp.asarray(w["obs_lane"], jnp.int32),
                     obs_des_y=jnp.asarray(w["obs_des_y"]), lc_target=jnp.asarray(w["lc_target"]),
                     collided=jnp.asarray(w["collided"]))
    tw = WorldState(mpc_carry=None, x=_t(w["x"]), z=_t(w["z"]), ego_lane=_t(w["ego_lane"]),
                    obs_lane=_t(w["obs_lane"]), obs_des_y=_t(w["obs_des_y"]),
                    lc_target=_t(w["lc_target"]), collided=_t(w["collided"]))
    tl = make_env_logic(tcons, tmodel, N_LANE, F64, "cpu")
    u = np.random.default_rng(7).normal(0, [2.0, 0.1], (B_STEP, 2))
    out = {}
    for t in T_PRE:
        keys = jax.random.split(jax.random.key(100 + t), B_STEP)
        jxref, jaux = jpre(jw, keys, t)
        txref, taux = tl.pre(tw, _t(jdraws(keys)), t)
        jnew, _ = jpost(jw, jaux, None, jnp.asarray(u), jnp.ones(B_STEP, bool))
        tnew, _ = tl.post(tw, taux, None, _t(u), torch.ones(B_STEP, dtype=torch.bool))
        out[t] = dict(j=(_np(jxref), _np(jaux), _np(jnew)), t=(txref, taux, tnew))
    return out


def _key_draws(key):
    """The two uniforms the JAX package's ``pre`` draws from a world's key."""
    k1, k2 = jax.random.split(key)
    return jnp.stack([jax.random.uniform(k1), jax.random.uniform(k2)])


@pytest.mark.parametrize("t", T_PRE)
def test_pre_matches_jax(closures, t):
    (jxref, jaux, _), (txref, taux, _) = closures[t]["j"], closures[t]["t"]
    assert np.abs(txref.numpy() - jxref).max() < 1e-12
    for f in ("obs_des_y", "lc_target", "u_obs"):
        assert np.abs(getattr(taux, f).numpy() - getattr(jaux, f)).max() < 1e-12, f
    for f in ("ego_lane", "obs_lane"):
        assert np.array_equal(getattr(taux, f).numpy(), getattr(jaux, f)), f


@pytest.mark.parametrize("t", T_PRE)
def test_post_matches_jax(closures, t):
    jnew, tnew = closures[t]["j"][2], closures[t]["t"][2]
    for f in ("x", "z", "obs_des_y", "lc_target"):
        assert np.abs(getattr(tnew, f).numpy() - getattr(jnew, f)).max() < 1e-12, f
    for f in ("ego_lane", "obs_lane", "collided"):
        assert np.array_equal(getattr(tnew, f).numpy(), getattr(jnew, f)), f


def test_pre_covers_the_branches(closures):
    """The hand-set worlds reach what they are set for: lane updates at t=0
    and on the lane-2 world only later, a retarget, lane intent only at
    t ∈ {0, 10}, more than one backup, the finished overtake's 20 m/s."""
    aux = {t: closures[t]["t"][1] for t in T_PRE}
    assert aux[7].obs_lane[3] == 2 and aux[7].obs_lane[2] == 1
    assert aux[7].lc_target[3, 1] == pytest.approx(1.8 + 3.6 * 1)
    w = _pre_worlds()
    assert np.array_equal(aux[7].obs_des_y.numpy(), w["obs_des_y"])
    moved = [bool((aux[t].obs_des_y.numpy() != w["obs_des_y"]).any()) for t in (0, 10)]
    assert any(moved)
    us = torch.cat([aux[t].u_obs for t in T_PRE])
    assert len({round(float(a), 9) for a in us[:, 0]}) > 1
    assert closures[7]["t"][0][5, 2] == pytest.approx(20.0)


# ---- the episodes ----------------------------------------------------------

@pytest.fixture(scope="module")
def episodes(setup):
    cons, pset, model, params = setup["j"]
    tparams, tcons, tpp, tmodel = setup["t"]
    _, jinit, jepisode = j_make_fused(cons, model, params, "prox", ipm=JQPIPMConfig(**IPM),
                                      backend="pl_xla", dtype=jnp.float64)
    jw0 = jinit(B_EP, jax.random.key(0))
    jw1, jtraj = jax.jit(jepisode, static_argnums=2)(jw0, jax.random.key(1), T_EP)
    # the JAX episode's per-world key chains, as its episode splits them
    keys_b = jax.random.split(jax.random.key(1), B_EP)
    keys_tb = jnp.swapaxes(jax.vmap(lambda k: jax.random.split(k, T_EP))(keys_b), 0, 1)
    draws = _t(jax.jit(jax.vmap(jax.vmap(_key_draws)))(keys_tb))

    cfg = QPIPMConfig(**IPM)
    _, tinit, tepisode = make_batched_overtake_fused(tcons, tmodel, tparams, "prox", ipm=cfg,
                                                     dtype=F64, device="cpu")
    _, pinit, pepisode = make_batched_overtake(tcons, tmodel, tparams, "prox", ipm=cfg,
                                               dtype=F64, device="cpu")
    tw0 = convert_overtake_worlds(jw0, "cpu")
    tw1, ttraj = tepisode(tw0, T_EP, draws=draws)
    pw1, ptraj = pepisode(pinit(B_EP, z0=tw0.z), T_EP, draws=draws)
    return dict(j=(_np(jw1), _np(jtraj)), t=(tw1, ttraj), p=(pw1, ptraj), tw0=tw0, tinit=tinit,
                tepisode=tepisode)


@pytest.mark.parametrize("field", ["u", "x", "z"])
def test_fused_episode_matches_jax(episodes, field):
    jtraj, ttraj = episodes["j"][1], episodes["t"][1]
    assert ttraj[field].shape == (B_EP, T_EP, 2 if field == "u" else 4)
    assert np.abs(ttraj[field].numpy() - jtraj[field]).max() < 1e-6, field


def test_fused_episode_worlds_match_jax(episodes):
    jw, tw = episodes["j"][0], episodes["t"][0]
    for f in ("ego_lane", "obs_lane", "collided"):
        assert np.array_equal(getattr(tw, f).numpy(), getattr(jw, f)), f
    for f in ("obs_des_y", "lc_target"):
        assert np.abs(getattr(tw, f).numpy() - getattr(jw, f)).max() < 1e-6, f
    assert np.array_equal(episodes["t"][1]["feasible"].numpy(), episodes["j"][1]["feasible"])


@pytest.mark.parametrize("field", ["u", "x", "z"])
def test_couplings_agree(episodes, field):
    """The per-tree coupling (``make_branch_mpc_step``) follows the fused one."""
    assert np.abs(episodes["p"][1][field].numpy() - episodes["t"][1][field].numpy()).max() < 1e-6


def test_init_worlds_and_episode_api(setup, episodes):
    """``init_worlds`` draws the obstacle from its seed (or generator), the
    ego starts in lane 0; ``episode`` draws its uniforms from its seed and
    ``step_once`` is one of its steps."""
    tinit, tepisode = episodes["tinit"], episodes["tepisode"]
    a, b = tinit(3, seed=4), tinit(3, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.z, b.z) and not torch.equal(a.z, tinit(3, seed=5).z)
    assert torch.equal(a.x[:, 1], torch.full((3,), 1.8, dtype=F64))
    assert a.ego_lane.tolist() == [0, 0, 0] and a.obs_lane.tolist() == [1, 1, 1]
    w0 = episodes["tw0"]
    g = torch.Generator().manual_seed(9)
    draws = torch.rand((1, B_EP, 2), generator=g, dtype=F64)
    w1, traj = tepisode(w0, 1, seed=9)
    w1b, out = tepisode.step_once(w0, 0, draws[0])
    assert torch.equal(traj["u"][:, 0], out["u"]) and torch.equal(w1.x, w1b.x)
    # the per-tree coupling on the ADMM builds, and its worlds carry the duals
    tparams, tcons, _, tmodel = setup["t"]
    admm = ADMMConfig(iters=2, rho_update_every=0, polish_iters=0)
    topo, ainit, aepisode = make_batched_overtake(tcons, tmodel, tparams, "prox", dtype=F64,
                                                  solver="admm", admm=admm, device="cpu")
    aw0 = ainit(2, seed=4)
    assert aw0.mpc_carry.y1.shape == (2, topo.totalu, 5) and not aw0.mpc_carry.y1.any()
    aw1, atraj = aepisode(aw0, 1, seed=9)
    assert atraj["u"].isfinite().all() and aw1.mpc_carry.y2.shape == (2, topo.totalu, 4)


# ---- the live BranchMPC's cost ---------------------------------------------

@pytest.fixture(scope="module")
def branch_costs(setup):
    """The live BranchMPC's cost of the same trees (N=3, NB=2, a non-zero
    rate weight dR and a Qf of its own) in both packages, with and without
    the reference's quirks."""
    cons, pset, model, params = setup["j"]
    tparams, _, _, _ = setup["t"]
    NBc = 2
    topo = j_build_topology(N, NBc, model.m, 4, 2)
    xs, zs, xRefs, _ = _step_inputs()
    rng = np.random.default_rng(8)
    u_lin = rng.normal(0, [1.0, 0.1], (B_STEP, topo.totalu, 2))
    old = rng.normal(0, [1.0, 0.1], (B_STEP, 2))
    dR = np.array([0.7, 3.0])
    Qf = np.diag([0.0, 5.0, 2.0, 7.0])

    def jcost(x, z, u, xRef, o):
        ts = j_build_tree(model, topo, x, z, u, pset.params)
        return ts, [j_assemble(topo, ts, params.Q, params.R, Qf, dR, params.Qslack, xRef, o,
                               variant=v, replicate_quirks=q)
                    for v, q in (("branch", True), ("branch", False), ("robust", True))]

    jts, jcs = jax.jit(jax.vmap(jcost))(xs, zs, u_lin, xRefs, old)
    tts = convert_tree_state(jts, "cpu")
    ttopo = build_topology(N, NBc, 3, 4, 2)
    tcost = lambda variant, q: assemble_stage_cost(ttopo, tts, tparams.Q, tparams.R, Qf, dR,
                                                   tparams.Qslack, _t(xRefs), _t(old),
                                                   variant=variant, replicate_quirks=q)
    return dict(j=dict(zip((True, False, "robust"), jcs)), tcost=tcost)


@pytest.mark.parametrize("quirks", [True, False])
def test_branch_cost_matches_jax(branch_costs, quirks):
    jc, tc = branch_costs["j"][quirks], branch_costs["tcost"]("branch", quirks)
    for f in tc._fields:
        ja = np.broadcast_to(np.asarray(getattr(jc, f)), getattr(tc, f).shape)
        assert np.abs(getattr(tc, f).numpy() - ja).max() < 1e-12, f
    assert not np.any(tc.Dab2.numpy()) and not np.any(tc.qterm.numpy())
    # the robust controllers' cost (the prox assembly, dQ = 0, no quirks,
    # whatever replicate_quirks says) on the same trees
    jr, tr = branch_costs["j"]["robust"], branch_costs["tcost"]("robust", quirks)
    for f in tr._fields:
        ja = np.broadcast_to(np.asarray(getattr(jr, f)), getattr(tr, f).shape)
        assert np.abs(getattr(tr, f).numpy() - ja).max() < 1e-12, f
