"""The slice as a whole: warm-started receding-horizon steps of the port's
``make_cvar_mpc_batched_step`` (CPU, f64, plain fused iteration) against the
JAX package's (``use_pallas=False``) on the same seeded states, with
parameters carried across by ``convert``: the merge deployment with per-lane
``S`` and ``bx`` (N=3, NB=1, m=2, ralpha=0.1) and the CVaR overtake (N=3,
NB=1, m=3, ralpha=0.9), two steps each. Bar: the applied input u0 < 1e-7,
u < 1e-7, x < 1e-6 and the returned gap. ``_run`` is shared with
``test_torch_cvar_refine.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.controllers.cvar_mpc import (
    make_cvar_mpc_batched_step as j_make_step,
)
from belief_planning_tpu.models.policies import highway_policy_set as j_highway_set
from belief_planning_tpu.models.policies import merge_policy_set as j_merge_set
from belief_planning_tpu.models.predictive import highway_model as j_highway_model
from belief_planning_tpu.models.predictive import merge_model as j_merge_model
from belief_planning_tpu.presets import init_branch_mpc as j_init_branch_mpc
from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig
from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants

from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_batched_step
from belief_planning_tpu_torch.convert import convert, convert_cvar_ipm_config
from belief_planning_tpu_torch.models import policies as tpol
from belief_planning_tpu_torch.models.predictive import highway_model, merge_model

from tests.test_torch_cuda import cvar_problem

torch.set_num_threads(1)

N, B, STEPS = 3, 4, 2
IPM = dict(iters=8, gondzio=2)


def _jax_setup(kind):
    if kind == "merge":
        cons = JBranchConstants(am=7.0)
        pset = j_merge_set(cons, 20.0, None)
        model = j_merge_model(cons, pset, N=N, dt=0.1)
        params = j_init_branch_mpc(4, 2, N, 1, np.array([0.5, 1.8, 15.0, 0.0]), am=7.0,
                                   rm=0.3, N_lane=2, W=cons.W)
    else:
        cons = JBranchConstants()
        xt = np.array([0.5, 1.8, 15.0, 0.0])
        pset = j_highway_set(cons, xt)
        model = j_highway_model(cons, pset, N=N, dt=0.1)
        params = j_init_branch_mpc(4, 2, N, 1, xt, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    return cons, pset, model, params


def _run(kind, **kw):
    ralpha = 0.1 if kind == "merge" else 0.9
    use_S = kind == "merge"
    cons, pset, model, params = _jax_setup(kind)
    jcfg = JCVaRIPMConfig(**IPM)
    _, _, jinit, jstep = j_make_step(model, params, ralpha, ipm=jcfg, use_pallas=False,
                                     use_S=use_S, **kw)
    jstep = jax.jit(jstep)
    _, _, _, _, _, xs, zs, xRefs, S, bx, _ = cvar_problem(kind, N, 1, B)
    extra = dict(S=S, bx=bx) if use_S else {}
    jextra = {k: jnp.asarray(v.numpy()) for k, v in extra.items()}
    c = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jinit(jnp.float64))
    jres = []
    for _ in range(STEPS):
        c, r = jstep(c, jnp.asarray(xs.numpy()), jnp.asarray(zs.numpy()),
                     jnp.asarray(xRefs.numpy()), pset.params, **jextra)
        jres.append(jax.tree.map(np.asarray, r))

    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    fns = (tpol.maintain_track_v, tpol.brake) if kind == "merge" else \
        (tpol.maintain, tpol.brake, tpol.lane_change)
    make = merge_model if kind == "merge" else highway_model
    tmodel = make(tcons, tpol.PolicySet(fns=fns, params=tpp), N=N, dt=0.1)
    _, _, tinit, tstep = make_cvar_mpc_batched_step(
        tmodel, tparams, ralpha, ipm=convert_cvar_ipm_config(jcfg), use_S=use_S,
        device="cpu", **kw)
    tc = tinit(B, torch.float64)
    tres = []
    for _ in range(STEPS):
        tc, r = tstep(tc, xs, zs, xRefs, tpp, **extra)
        tres.append(r)
    return jres, tres


@pytest.fixture(scope="module")
def runs():
    return {kind: _run(kind) for kind in ("merge", "overtake")}


@pytest.mark.parametrize("kind", ["merge", "overtake"])
@pytest.mark.parametrize("k", range(STEPS))
def test_step_matches_jax(runs, kind, k):
    jr, tr = runs[kind][0][k], runs[kind][1][k]
    assert np.abs(tr.uPred.numpy()[:, 0] - jr.uPred[:, 0]).max() < 1e-7
    assert np.abs(tr.uPred.numpy() - jr.uPred).max() < 1e-7
    assert np.abs(tr.xPred.numpy() - jr.xPred).max() < 1e-6
    np.testing.assert_allclose(tr.gap.numpy(), jr.gap, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("field", ["slack", "risk", "w", "p", "z", "J"])
def test_step_outputs_match_jax(runs, field):
    for jrs, trs in runs.values():
        for jr, tr in zip(jrs, trs):
            assert np.abs(getattr(tr, field).numpy() - getattr(jr, field)).max() < 1e-6, field

