"""The single-tree controllers and the host environments against the JAX
package (CPU, f64, parameters carried by ``convert``, states by
``convert_vehicles``):

- ``BranchMPC`` (the live cost, ``variant="branch"``): two receding-horizon
  ``solve`` calls and ``BT2array``, IPM-10, u < 1e-7, x < 1e-6;
- ``HighwayEnv`` + ``highway_sim`` with ``BranchMPCProx`` (the overtake, N=4,
  NB=1, three vehicles, respawn on, seed 3, the third vehicle moved close
  behind the ego in the JAX env and carried over): 5 steps; states < 1e-6, the
  controller's inputs < 1e-7 and branches (``BT2array``) < 1e-6, backup
  choices, ``lc_target`` and the generator's next draw equal;
- ``HighwayMergeEnv`` with ``BranchMPCCVaR`` (``use_S``, N=4, NB=1, IPM-8
  with 2 correctors): 3 steps; the bars ``tests/test_torch_cvar_mpc.py``
  holds the CVaR step to (u < 1e-7, x < 1e-6, gap rtol 1e-8), states
  < 1e-6; ``S=None`` on a ``use_S`` controller solves without the
  transform;
- the port's ``make_batched_merge_fused`` against the port's host merge
  env from the same start, at ``tests/test_batched_env.py``'s bars (u, x <
  1e-3 at B=1; with a second, shifted world at B=2, finite and world 0's
  u < 3e-3)."""

import numpy as np
import pytest
import torch

from belief_planning_tpu.controllers.branch_mpc import BranchMPC as JBranchMPC
from belief_planning_tpu.controllers.branch_mpc import BranchMPCProx as JBranchMPCProx
from belief_planning_tpu.controllers.cvar_mpc import BranchMPCCVaR as JBranchMPCCVaR
from belief_planning_tpu.envs.highway import HighwayEnv as JHighwayEnv
from belief_planning_tpu.envs.highway import highway_sim as j_highway_sim
from belief_planning_tpu.envs.merge import HighwayMergeEnv as JHighwayMergeEnv
from belief_planning_tpu.envs.merge import merge_ref_lines as j_merge_ref_lines
from belief_planning_tpu.models.policies import highway_policy_set as j_highway_set
from belief_planning_tpu.models.policies import merge_policy_set as j_merge_set
from belief_planning_tpu.models.predictive import highway_model as j_highway_model
from belief_planning_tpu.models.predictive import merge_model as j_merge_model
from belief_planning_tpu.presets import init_branch_mpc as j_init_branch_mpc
from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig
from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants

from belief_planning_tpu_torch.controllers.branch_mpc import BranchMPC, BranchMPCProx
from belief_planning_tpu_torch.controllers.cvar_mpc import BranchMPCCVaR
from belief_planning_tpu_torch.convert import (
    convert,
    convert_cvar_ipm_config,
    convert_policy_params,
    convert_vehicles,
)
from belief_planning_tpu_torch.envs.batched_merge import make_batched_merge_fused
from belief_planning_tpu_torch.envs.highway import HighwayEnv, highway_sim
from belief_planning_tpu_torch.envs.merge import HighwayMergeEnv
from belief_planning_tpu_torch.models import policies as tpol
from belief_planning_tpu_torch.models.predictive import highway_model, merge_model
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

torch.set_num_threads(1)

N, NB = 4, 1
QP_IPM = dict(iters=10)
CVAR_IPM = dict(iters=8, gondzio=2)
HW_STEPS, MERGE_STEPS = 5, 3
XT = np.array([0.5, 1.8, 15.0, 0.0])


def _overtake():
    cons = JBranchConstants()
    pset = j_highway_set(cons, XT)
    model = j_highway_model(cons, pset, N=N, dt=0.1)
    params = j_init_branch_mpc(4, 2, N, NB, XT, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = highway_model(tcons, tpol.highway_policy_set(tcons, XT), N=N, dt=0.1)
    return (cons, pset, model, params), (tcons, tpp, tmodel, tparams)


# ---- BranchMPC (the live cost) -----------------------------------------------

@pytest.fixture(scope="module")
def branch_solves():
    (cons, pset, model, params), (tcons, tpp, tmodel, tparams) = _overtake()
    jm = JBranchMPC(params, model, pset.params, ipm=JQPIPMConfig(**QP_IPM))
    tm = BranchMPC(tparams, tmodel, tpp, ipm=QPIPMConfig(**QP_IPM), device="cpu")
    states = [(np.array([0.0, 1.8, 20.0, 0.0]), np.array([9.0, 5.4, 17.0, 0.0]),
               np.array([0.0, 1.8, 18.0, 0.0])),
              (np.array([2.0, 1.9, 19.5, 0.01]), np.array([10.7, 5.3, 17.0, 0.0]), None)]
    out = []
    for x, z, xRef in states:
        ju, tu = jm.solve(x, z, xRef), tm.solve(x, z, xRef)
        out.append(dict(j=(np.asarray(ju), jm.uPred, jm.xPred, jm.feasible, jm.BT2array()),
                        t=(tu, tm.uPred, tm.xPred, tm.feasible, tm.BT2array())))
    return out


@pytest.mark.parametrize("k", range(2))
def test_branch_mpc_solve_matches_jax(branch_solves, k):
    (ju, juP, jxP, jfeas, jbt), (tu, tuP, txP, tfeas, tbt) = (branch_solves[k]["j"],
                                                             branch_solves[k]["t"])
    assert isinstance(tu, np.ndarray) and tu.shape == (2,)
    assert np.abs(tu - ju).max() < 1e-7
    assert np.abs(tuP - juP).max() < 1e-7
    assert np.abs(txP - jxP).max() < 1e-6
    assert tfeas == jfeas
    assert len(tbt[0]) == len(jbt[0]) == 3
    for part in range(3):                            # x, z, u trajectories
        for a, b in zip(tbt[part], jbt[part]):
            assert a.shape == b.shape and np.abs(a - b).max() < 1e-6
    assert np.abs(np.array(tbt[3]) - np.array(jbt[3])).max() < 1e-9


# ---- HighwayEnv + highway_sim with BranchMPCProx ---------------------------

@pytest.fixture(scope="module")
def highway_runs():
    (cons, pset, model, params), (tcons, tpp, tmodel, tparams) = _overtake()
    jm = JBranchMPCProx(params, model, pset.params, ipm=JQPIPMConfig(**QP_IPM))
    tm = BranchMPCProx(tparams, tmodel, tpp, ipm=QPIPMConfig(**QP_IPM), device="cpu")
    jenv = JHighwayEnv(NV=3, mpc=jm, cons=cons, lc_target=XT, N_lane=4, seed=3, respawn=True)
    tenv = HighwayEnv(NV=3, mpc=tm, cons=tcons, lc_target=XT, N_lane=4, seed=3, respawn=True)
    start = (convert_vehicles(jenv.veh_set), [v.state.copy() for v in tenv.veh_set])
    # the third vehicle close behind the ego in its lane (it brakes, then
    # maintains), set in the JAX env and carried over
    jenv.veh_set[2].state = np.array([-4.5, 1.8, 21.0, 0.0])
    tenv.veh_set = convert_vehicles(jenv.veh_set)
    jrec = j_highway_sim(jenv, HW_STEPS * 0.1)
    trec = highway_sim(tenv, HW_STEPS * 0.1)
    return dict(jrec=jrec, trec=trec, jenv=jenv, tenv=tenv, start=start)


def test_highway_env_starts_as_jax(highway_runs):
    """Both place the third vehicle with the same draws; the vehicles
    convert field by field."""
    jstart, tstart = highway_runs["start"]
    assert len(jstart) == 3
    for jv, ts in zip(jstart, tstart):
        assert np.array_equal(jv.state, ts)
    for jv, tv in zip(convert_vehicles(highway_runs["jenv"].veh_set), highway_runs["tenv"].veh_set):
        assert np.abs(jv.state - tv.state).max() < 1e-6
        assert (jv.dt, jv.v_length, jv.v_width, jv.backupidx, jv.laneidx) == (
            tv.dt, tv.v_length, tv.v_width, tv.backupidx, tv.laneidx)


def test_highway_sim_matches_jax(highway_runs):
    jrec, trec = highway_runs["jrec"], highway_runs["trec"]
    (js, ju, jb, jc, jxp, jzp, jw, jcol), (ts, tu, tb, tc, txp, tzp, tw, tcol) = jrec, trec
    assert ts.shape == (3, HW_STEPS, 4)
    assert np.abs(ts - js).max() < 1e-6
    assert np.abs(tu[0] - ju[0]).max() < 1e-7
    assert np.abs(tu - ju).max() < 1e-6
    assert tc == jc
    assert {c for row in tc for c in row} == {0, 1}
    assert tcol == jcol
    for t in range(HW_STEPS):
        assert np.abs(np.array(tw[t]) - np.array(jw[t])).max() < 1e-9
        for a, b in zip(txp[t] + tzp[t], jxp[t] + jzp[t]):
            assert np.abs(a - b).max() < 1e-6
        for i in range(3):
            assert np.abs(tb[i][t] - jb[i][t]).max() < 1e-9


def test_highway_env_state_matches_jax(highway_runs):
    """``lc_target``, lanes and the generator's next draw agree; the
    controller holds the same lane-change target."""
    jenv, tenv = highway_runs["jenv"], highway_runs["tenv"]
    assert np.array_equal(tenv.lc_target, jenv.lc_target)
    assert [v.laneidx for v in tenv.veh_set] == [v.laneidx for v in jenv.veh_set]
    assert [v.backupidx for v in tenv.veh_set] == [v.backupidx for v in jenv.veh_set]
    for a, b in zip(tenv.desired_x, jenv.desired_x):
        assert np.array_equal(a, b)
    assert np.asarray(tenv.mpc.policy_params[2].x_target).tolist() == tenv.lc_target.tolist()
    assert tenv.rng.uniform() == jenv.rng.uniform()


# ---- HighwayMergeEnv with BranchMPCCVaR ------------------------------------

def _merge_setup():
    cons = JBranchConstants(am=7.0)
    geom = (2, 1, 50, 300, 0)
    _, refpsi = j_merge_ref_lines(*geom)
    pset_n, pset_m = j_merge_set(cons, 20.0, None), j_merge_set(cons, 20.0, refpsi)
    models = [j_merge_model(cons, p, N=N, dt=0.1) for p in (pset_n, pset_m)]
    params = j_init_branch_mpc(4, 2, N, NB, XT, am=7.0, rm=0.3, N_lane=2, W=cons.W)
    tparams, tcons, tpp_n = convert(params, cons, pset_n.params, "cpu")
    tpp_m = convert_policy_params(pset_m.params, "cpu")
    fns = (tpol.maintain_track_v, tpol.brake)
    tmodels = [merge_model(tcons, tpol.PolicySet(fns=fns, params=p), N=N, dt=0.1)
               for p in (tpp_n, tpp_m)]
    return ((cons, geom, (pset_n, pset_m), models, params),
            (tcons, (tpp_n, tpp_m), tmodels, tparams))


def _merge_env(cls, mpc, cons, geom, models, psets):
    N_lane, merge_lane, merge_s, merge_R, merge_side = geom
    return cls(NV=2, N_lane=N_lane, mpc=mpc, models=models, policy_param_sets=psets,
               merge_lane=merge_lane, merge_s=merge_s, merge_R=merge_R, merge_side=merge_side,
               dt=0.1, cons=cons)


@pytest.fixture(scope="module")
def merge_runs():
    (cons, geom, psets, models, params), (tcons, tpps, tmodels, tparams) = _merge_setup()
    jcfg = JCVaRIPMConfig(**CVAR_IPM)
    jm = JBranchMPCCVaR(params, models[0], psets[0].params, ralpha=0.1, ipm=jcfg, use_S=True)
    tm = BranchMPCCVaR(tparams, tmodels[0], tpps[0], ralpha=0.1,
                       ipm=convert_cvar_ipm_config(jcfg), use_S=True, device="cpu")
    jenv = _merge_env(JHighwayMergeEnv, jm, cons, geom, models, [p.params for p in psets])
    tenv = _merge_env(HighwayMergeEnv, tm, tcons, geom, tmodels, list(tpps))
    x0 = np.stack([v.state.copy() for v in tenv.veh_set])
    steps = []
    for t in range(MERGE_STEPS):
        jo, to = jenv.step(t), tenv.step(t)
        steps.append(dict(j=(jo, np.asarray(jm.last.gap), jm.xPred, jm.uPred),
                          t=(to, tm.last.gap, tm.xPred, tm.uPred)))
    return dict(steps=steps, x0=x0, tenv=tenv, tparams=tparams, tmodels=tmodels, tpps=tpps,
                tcons=tcons, cfg=convert_cvar_ipm_config(jcfg), geom=geom)


@pytest.mark.parametrize("k", range(MERGE_STEPS))
def test_merge_env_step_matches_jax(merge_runs, k):
    st = merge_runs["steps"][k]
    (jo, jgap, jxP, juP), (to, tgap, txP, tuP) = st["j"], st["t"]
    assert np.abs(tuP[0] - juP[0]).max() < 1e-7
    assert np.abs(tuP - juP).max() < 1e-7
    assert np.abs(txP - jxP).max() < 1e-6
    np.testing.assert_allclose(tgap, jgap, rtol=1e-8, atol=1e-10)
    for a, b in zip(to[1], jo[1]):                     # each vehicle's new state
        assert np.abs(a - b).max() < 1e-6
    for a, b in zip(to[2], jo[2]):                     # backup rollouts
        assert np.abs(a - b).max() < 1e-9


def test_merge_cvar_s_none_passes_through(merge_runs):
    """``S=None`` on a ``use_S`` controller solves as a controller without
    the transform does (no dh[0] floor)."""
    r = merge_runs
    x, z = r["x0"]
    xRef = np.array([0.0, 5.4, 20.0, 0.0])
    mk = lambda use_S: BranchMPCCVaR(r["tparams"], r["tmodels"][0], r["tpps"][0], ralpha=0.1,
                                     ipm=r["cfg"], use_S=use_S, device="cpu")
    a, b = mk(True), mk(False)
    for _ in range(2):
        ua, ub = a.solve(x, z, xRef, S=None), b.solve(x, z, xRef)
        assert np.array_equal(ua, ub) and np.array_equal(a.xPred, b.xPred)


def test_batched_merge_matches_host_env(merge_runs):
    """The port's batched merge episode from the host env's start follows the
    port's host env (``tests/test_batched_env.py:145-158``'s bars)."""
    r = merge_runs
    N_lane, merge_lane, merge_s, merge_R, merge_side = r["geom"]
    _, init_w, episode = make_batched_merge_fused(
        r["tcons"], r["tmodels"][0], r["tparams"], r["tpps"][0], ralpha=0.1, ipm=r["cfg"],
        N_lane=N_lane, merge_lane=merge_lane, merge_s=merge_s, merge_R=merge_R,
        merge_side=merge_side, dtype=torch.float64, device="cpu")
    host_u = np.stack([s["t"][0][0][0] for s in r["steps"]])
    host_x = np.stack([s["t"][0][1][0] for s in r["steps"]])
    x0 = r["x0"]
    _, traj = episode(init_w(1, x0=x0[0:1], z0=x0[1:2]), MERGE_STEPS)
    assert np.abs(traj["u"][0].numpy() - host_u).max() < 1e-3
    assert np.abs(traj["x"][0].numpy() - host_x).max() < 1e-3
    xs0 = np.stack([x0[0], x0[0] + np.array([3.0, -0.4, 0.0, 0.0])])
    _, traj_b = episode(init_w(2, x0=xs0, z0=np.stack([x0[1], x0[1]])), MERGE_STEPS)
    assert bool(traj_b["x"].isfinite().all())
    assert np.abs(traj_b["u"][0].numpy() - host_u).max() < 3e-3
