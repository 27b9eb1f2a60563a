"""The closed-loop merge episode: the port's ``make_batched_merge_fused``
(CPU, f64, the plain fused CVaR iteration) against the JAX package's
(``use_pallas=False``), teacher-forced step by step as
``tests/test_batched_env.py`` does: before every step both sides get the
same worlds (the JAX side's, the controller's warm start included), so they
solve the same programs. N=4, NB=1, pinned f64 worlds: one drawn as
``init_worlds`` draws, one that merges after the first step, one whose
obstacle overlaps the ego (collides at once), one farther along the ramp.
Bars: the applied input u0 < 1e-7 after 8 IPM iterations (late CVaR
iterates are chaotic in the reference itself, ROADMAP Queue C), and the
world update (x, z, merged, collided) from the same u to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.envs.batched_merge import make_batched_merge_fused as j_make
from belief_planning_tpu.models.policies import merge_policy_set as j_merge_set
from belief_planning_tpu.models.predictive import merge_model as j_merge_model
from belief_planning_tpu.presets import init_branch_mpc as j_init_branch_mpc
from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig
from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants

from belief_planning_tpu_torch.controllers.branch_mpc import MPCCarry
from belief_planning_tpu_torch.convert import convert, convert_cvar_ipm_config
from belief_planning_tpu_torch.envs.batched_merge import (
    MergeWorldState,
    draw_merge_worlds,
    env_post,
    make_batched_merge_fused,
)
from belief_planning_tpu_torch.envs.merge import merge_ref_lines
from belief_planning_tpu_torch.models import policies as tpol
from belief_planning_tpu_torch.models.predictive import merge_model

torch.set_num_threads(1)

N, NB, STEPS = 4, 1, 3
IPM = dict(iters=8, gondzio=2)


def _worlds():
    x0, z0 = draw_merge_worlds(4, seed=0)
    refY, refpsi = merge_ref_lines(2, 1, 50.0, 300.0, 0)
    X = torch.tensor(57.5, dtype=torch.float64)      # on the ramp, merges after step 0
    x0[1] = [57.5, refY(X).item() + 1.8, 20.0, refpsi(X).item()]
    x0[3, 0] += 10.0                                 # farther along the ramp
    x0[3, 1] = refY(torch.tensor(x0[3, 0], dtype=torch.float64)).item() + 1.8
    z0[2] = x0[2] + np.array([1.0, 0.5, 0.0, 0.0])   # overlaps the ego
    return x0, z0


@pytest.fixture(scope="module")
def run():
    cons = JBranchConstants(am=7.0)
    pset = j_merge_set(cons, 20.0, None)
    model = j_merge_model(cons, pset, N=N, dt=0.1)
    params = j_init_branch_mpc(4, 2, N, NB, np.array([0.5, 1.8, 15.0, 0.0]), am=7.0, rm=0.3,
                               N_lane=2, W=cons.W)
    jcfg = JCVaRIPMConfig(**IPM)
    _, jinit, jepisode = j_make(cons, model, params, pset.params, ralpha=0.1, ipm=jcfg,
                                use_pallas=False, dtype=jnp.float64)
    jstep = jax.jit(jepisode.step_once)

    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = merge_model(tcons, tpol.PolicySet(fns=(tpol.maintain_track_v, tpol.brake),
                                               params=tpp), N=N, dt=0.1)
    _, tinit, tepisode = make_batched_merge_fused(
        tcons, tmodel, tparams, tpp, ralpha=0.1, ipm=convert_cvar_ipm_config(jcfg),
        dtype=torch.float64, device="cpu")

    x0, z0 = _worlds()
    jw = jinit(4, jax.random.key(0), x0=x0, z0=z0)
    t = lambda a: torch.as_tensor(np.array(a))
    steps = []
    for _ in range(STEPS):
        # the port starts from the JAX side's worlds (teacher forcing)
        tw = MergeWorldState(
            mpc_carry=MPCCarry(*(t(getattr(jw.mpc_carry, f)) for f in MPCCarry._fields[:4])),
            x=t(jw.x), z=t(jw.z), merged=t(jw.merged), collided=t(jw.collided))
        tnew, tout = tepisode.step_once(tw)
        jnew, jout = jstep(jw)
        # the port's world update from the JAX side's input
        tpost, _ = env_post(tmodel, tpp, tcons.W, tw, tout["merged"], tnew.mpc_carry,
                            t(jout["u"]))
        steps.append(dict(tout=tout, jout=jax.tree.map(np.asarray, jout), tpost=tpost,
                          jnew=jax.tree.map(np.asarray, jnew)))
        jw = jnew
    ep_worlds, traj = tepisode(tinit(4, x0=x0, z0=z0), 2)
    return dict(steps=steps, tinit=tinit, traj=traj, ep_worlds=ep_worlds, x0=x0, z0=z0)


@pytest.mark.parametrize("k", range(STEPS))
def test_step_input_matches_jax(run, k):
    st = run["steps"][k]
    du = np.abs(st["tout"]["u"].numpy() - st["jout"]["u"]).max()
    assert du < 1e-7, du
    np.testing.assert_allclose(st["tout"]["gap"].numpy(), st["jout"]["gap"], rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("k", range(STEPS))
def test_world_update_matches_jax(run, k):
    """Given the same u, the new x, z, merged and collided agree to 1e-12."""
    st = run["steps"][k]
    for f in ("x", "z"):
        assert np.abs(getattr(st["tpost"], f).numpy() - getattr(st["jnew"], f)).max() < 1e-12, f
    for f in ("merged", "collided"):
        assert np.array_equal(getattr(st["tpost"], f).numpy(), getattr(st["jnew"], f)), f


def test_flags_switch_and_stay(run):
    """World 1 merges after the first step and world 2 collides at once; both
    flags, once set, stay set."""
    merged = np.stack([s["jnew"].merged for s in run["steps"]])
    collided = np.stack([s["jnew"].collided for s in run["steps"]])
    assert not merged[0, 1] and merged[1:, 1].all()
    assert collided[:, 2].all()
    assert (np.diff(merged.astype(int), axis=0) >= 0).all()
    assert (np.diff(collided.astype(int), axis=0) >= 0).all()


def test_episode_leaves_and_worlds(run):
    """``episode`` stacks each step's outputs as (B, n_steps, ...) leaves;
    ``init_worlds`` draws as ``draw_merge_worlds`` with its seed, or takes
    the pinned states."""
    traj = run["traj"]
    assert traj["x"].shape == (4, 2, 4) and traj["u"].shape == (4, 2, 2)
    assert traj["merged"].shape == (4, 2) and traj["gap"].shape == (4, 2)
    assert bool(traj["x"].isfinite().all())
    assert torch.equal(run["ep_worlds"].x, traj["x"][:, -1])
    w = run["tinit"](3, seed=5)
    x0, z0 = draw_merge_worlds(3, seed=5)
    assert np.array_equal(w.x.numpy(), x0) and np.array_equal(w.z.numpy(), z0)
    assert not bool(w.merged.any()) and not bool(w.collided.any())
    with pytest.raises(ValueError):
        run["tinit"](3, x0=x0)
