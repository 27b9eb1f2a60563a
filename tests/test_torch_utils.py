"""The port's timing and checkpoint utilities (``utils/timing.py``,
``utils/checkpoint.py``) on the CPU:

- ``StageTimer`` and ``EventLog`` as ``tests/test_subsystems.py:37`` drives
  them; ``trace`` writes a Chrome trace;
- carries round-trip between the packages bit for bit: a carry the JAX
  package's ``save_carry`` writes loads in the port's ``load_carry`` (the
  reference's unbatched fields into the port's batch of one), and one the
  port writes loads in the JAX package's, extras included;
- a resumed ``HighwayEnv`` (``save_env_state`` / ``load_env_state``)
  reproduces the run without the break (``tests/test_subsystems.py:69``,
  1e-9), and so does an ``HMMHighwayEnv`` (beliefs and generator state);
  a ``QuadEnv`` snapshot restores its robots and carry."""

import json
import os

import numpy as np
import pytest
import torch

from belief_planning_tpu.controllers.branch_mpc import MPCCarry as JMPCCarry
from belief_planning_tpu.utils.checkpoint import load_carry as j_load_carry
from belief_planning_tpu.utils.checkpoint import save_carry as j_save_carry

from belief_planning_tpu_torch.controllers.branch_mpc import BranchMPCProx, MPCCarry
from belief_planning_tpu_torch.envs.highway import HighwayEnv
from belief_planning_tpu_torch.models.policies import highway_policy_set
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.presets import init_branch_mpc
from belief_planning_tpu_torch.utils.checkpoint import (
    load_carry,
    load_env_state,
    save_carry,
    save_env_state,
)
from belief_planning_tpu_torch.utils.config import BranchConstants
from belief_planning_tpu_torch.utils.timing import EventLog, StageTimer, block_until_ready, trace

torch.set_num_threads(1)

TOTALU, NBR, M, D, NC, NFU = 7, 3, 3, 2, 5, 4       # the N=3, NB=1 overtake's carry


def test_stage_timer_and_event_log(tmp_path):
    t = StageTimer()
    with t.stage("build"):
        _ = np.zeros(10)
    with t.stage("solve", block_on=torch.zeros(3)):
        _ = np.zeros(10)
    with t.stage("solve"):
        _ = np.zeros(10)
    s = t.summary()
    assert s["solve"]["count"] == 2 and s["build"]["count"] == 1
    assert s["solve"]["total_s"] >= 0 and s["solve"]["mean_ms"] >= 0
    assert "solve" in t.report()

    log = EventLog(str(tmp_path / "events.jsonl"))
    log.log("solve", prim_res=1e-5, feasible=1)
    log.log("collision", agents=[0, 1])
    assert len(log.of_kind("solve")) == 1
    lines = (tmp_path / "events.jsonl").read_text().splitlines()
    assert [json.loads(ln)["kind"] for ln in lines] == ["solve", "collision"]


def test_block_until_ready_waits_only_for_cuda(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    tree = {"a": (torch.ones(2), [torch.zeros(1)]), "b": None}
    assert block_until_ready(tree) is tree
    assert calls == []


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "tr" / "trace.json"
    assert path.exists()
    assert "traceEvents" in json.loads(path.read_text())


def _random_carry(rng, lead=()):
    f = lambda *s: rng.standard_normal(lead + s)
    return dict(u_lin=f(TOTALU, D), p=f(NBR, M), old_input=f(D),
                initialized=np.ones(lead, dtype=bool), y1=f(TOTALU, NC), y2=f(TOTALU, NFU),
                y3=f(TOTALU, NC))


def test_carry_from_jax_loads_bit_for_bit(tmp_path):
    c = _random_carry(np.random.default_rng(0))
    path = str(tmp_path / "jax.npz")
    j_save_carry(path, JMPCCarry(**c), extra={"step": np.array(7)})
    template = MPCCarry(**{k: torch.zeros((1,) + v.shape, dtype=torch.bool if v.dtype == bool
                                          else torch.float64) for k, v in c.items()})
    got, extras = load_carry(path, template, "cpu")
    for k, v in c.items():
        t = getattr(got, k)
        assert t.shape == (1,) + v.shape and t.dtype == getattr(template, k).dtype
        assert np.array_equal(t.numpy()[0], v)
    assert int(extras["step"]) == 7
    # an IPM controller's carry has no duals: they stay None
    got, _ = load_carry(path, template._replace(y1=None, y2=None, y3=None), "cpu")
    assert got.y1 is None and np.array_equal(got.u_lin.numpy()[0], c["u_lin"])


def test_carry_from_port_loads_bit_for_bit(tmp_path):
    c = _random_carry(np.random.default_rng(1), lead=(1,))
    path = str(tmp_path / "port.npz")
    save_carry(path, MPCCarry(**{k: torch.as_tensor(v) for k, v in c.items()}),
               extra={"beliefs": np.arange(3.0)})
    template = JMPCCarry(**{k: np.zeros(v.shape[1:], dtype=v.dtype) for k, v in c.items()})
    got, extras = j_load_carry(path, template)
    for k, v in c.items():
        assert np.array_equal(np.asarray(getattr(got, k)), v[0])
    assert np.array_equal(extras["beliefs"], np.arange(3.0))
    # and back into the port, unchanged
    save_carry(path, got)
    back, _ = load_carry(path, MPCCarry(**{k: torch.as_tensor(v) for k, v in c.items()}), "cpu")
    for k, v in c.items():
        assert np.array_equal(getattr(back, k).numpy(), v)


def test_load_carry_defaults_to_cuda(tmp_path):
    path = str(tmp_path / "c.npz")
    save_carry(path, MPCCarry(u_lin=torch.zeros(1, 2), p=torch.zeros(1, 1), old_input=torch.zeros(1, 2),
                              initialized=torch.zeros(1, dtype=torch.bool)))
    template = MPCCarry(u_lin=torch.ones(1, 2), p=torch.ones(1, 1), old_input=torch.ones(1, 2),
                        initialized=torch.ones(1, dtype=torch.bool))
    if torch.cuda.is_available():
        assert load_carry(path, template)[0].u_lin.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            load_carry(path, template)


def _highway_env(seed=0):
    cons = BranchConstants()
    xt = np.array([0.5, 1.8, 15.0, 0.0])
    pset = highway_policy_set(cons, xt)
    model = highway_model(cons, pset, N=3, dt=0.1)
    params = init_branch_mpc(4, 2, 3, 1, xt, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    mpc = BranchMPCProx(params, model, pset.params, device="cpu")
    return HighwayEnv(NV=2, mpc=mpc, cons=cons, lc_target=xt, N_lane=4, seed=seed)


def test_highway_env_resume_determinism(tmp_path):
    """Resuming from a checkpoint reproduces the run without the break."""
    path = str(tmp_path / "snap.npz")
    env_a = _highway_env(seed=3)
    for t in range(2):
        env_a.step(t)
    save_env_state(path, env_a)
    for t in range(2, 4):
        env_a.step(t)
    final_a = env_a.veh_set[0].state.copy()

    env_b = _highway_env(seed=3)
    env_b.step(0)                       # move the fresh env away first
    load_env_state(path, env_b, env_b.mpc.carry)
    for t in range(2, 4):
        env_b.step(t)
    assert np.abs(final_a - env_b.veh_set[0].state).max() < 1e-9
    assert env_a.rng.random() == env_b.rng.random()


def test_hmm_env_resume_determinism(tmp_path):
    from belief_planning_tpu_torch.controllers.hmm_mpc import HMMMPC
    from belief_planning_tpu_torch.envs.hmm_highway import HMMHighwayEnv
    from belief_planning_tpu_torch.models import policies as pol
    from belief_planning_tpu_torch.models.hmm import HMMPredictiveModel
    from belief_planning_tpu_torch.presets import init_mpc_params
    from belief_planning_tpu_torch.utils.config import HMMConstants

    def env():                          # tests/test_hmm.py's env: NV=3, M=2, N=5
        cons = HMMConstants(am=6.0, rm=0.3)
        model = HMMPredictiveModel(nx=4, d=2, M=2, m=2, dt=0.1, cons=cons,
                                   policy_fns=(pol.maintain, pol.brake),
                                   policy_params=(pol.MaintainParams(Kpsi=cons.Kpsi),
                                                  pol.brake_params_sim(cons.Kpsi)))
        params = init_mpc_params(4, 2, 5, 2, 2, ydes=1.8, vdes=15.0, am=6.0, rm=0.3,
                                 N_lane=6, W=2.4)
        return HMMHighwayEnv(NV=3, mpc=HMMMPC(params, model, device="cpu"), N_lane=6, seed=0)

    path = str(tmp_path / "hmm.npz")
    env_a = env()
    env_a.step(0)
    save_env_state(path, env_a)
    env_a.step(1)
    env_b = env()
    load_env_state(path, env_b, env_b.mpc.carry)
    assert np.array_equal(env_b.b, np.load(path)["extra.beliefs"])
    env_b.step(1)
    for va, vb in zip(env_a.veh_set, env_b.veh_set):
        assert np.abs(va.state - vb.state).max() < 1e-9
        assert (va.backupidx, va.laneidx) == (vb.backupidx, vb.laneidx)
    assert np.abs(env_a.b - env_b.b).max() < 1e-9
    assert env_a.rng.random() == env_b.rng.random()


def test_quad_env_snapshot_restores_robots(tmp_path):
    from belief_planning_tpu_torch.envs.quadruped import QuadEnv
    from belief_planning_tpu_torch.models.policies import quadruped_policy_set
    from belief_planning_tpu_torch.models.predictive import quadruped_model
    from belief_planning_tpu_torch.presets import init_quad_branch_mpc
    from belief_planning_tpu_torch.utils.config import QuadConstants

    cons = QuadConstants()
    pset = quadruped_policy_set(0.2)
    params = init_quad_branch_mpc(3, 3, 4, 1, np.array([5., 5., 0.]), 0.2, 0.1, 0.5)
    mpc = BranchMPCProx(params, quadruped_model(cons, pset, N=4, dt=0.2), pset.params,
                        device="cpu")
    env = QuadEnv(NR=2, mpc=mpc, x_des=np.array([5., -3., 0.]), cons=cons)
    env.robot_set[1].backupidx = 1
    mpc.carry = mpc.carry._replace(u_lin=torch.full_like(mpc.carry.u_lin, 0.25))
    path = str(tmp_path / "quad.npz")
    save_env_state(path, env)
    states = [r.state.copy() for r in env.robot_set]
    for r in env.robot_set:
        r.state = r.state + 1.0
        r.backupidx = 0
    carry = load_env_state(path, env, mpc._init_carry(1, torch.float64))
    assert all(np.array_equal(r.state, s) for r, s in zip(env.robot_set, states))
    assert [r.backupidx for r in env.robot_set] == [0, 1]
    assert mpc.carry is carry and torch.equal(carry.u_lin, torch.full_like(carry.u_lin, 0.25))
    assert "extra.laneidx" not in np.load(path) and os.path.getsize(path) > 0
