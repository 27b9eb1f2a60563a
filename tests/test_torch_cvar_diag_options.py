"""The diagnostic options of the port's ``cvar_ipm_solve`` (``resid=
"carried"``, ``recovery="stable"``, ``neighborhood``, ``split_step``,
``recenter`` with ``recenter_tol``, ``diag_extra``) against the JAX
package's ``cvar_ipm_solve`` under ``vmap``, one case an option, on trees
the port builds in f64 and hands to both:

- ``merge``: the merge deployment (N=3, NB=1, m=2, ralpha 0.1, per-tree S
  and bx, the dh[0] floor on alternate trees), 3 trees;
- ``hard``: the hard cold-start batch of ``scripts/cvar_f32_diag.py`` (the
  overtake, m=3, ralpha 0.9, seed 0, obstacle 12 m ahead) at N=3, NB=1,
  its trees 11 to 14, none converged after 10 iterations. Late CVaR
  iterates are chaotic in the reference itself (ROADMAP.md Queue C): on
  about a quarter of the 32 trees the reference's own jitted solves, with
  and without ``FAST_XLA``, place the 10th step ``a`` up to 1e-2 apart
  (and on trees 2 and 24 its jitted and eager gaps part by 1e-7 and 1e-5),
  so the bars below are held on trees where the reference reproduces
  itself to them.

Ten iterations in f64: every gap within rtol 1e-8 (atol 1e-10), u within
1e-7, the diagnostics within rtol 1e-7 (the residual maxima prim1 and rq
atol 1e-6), the same diagnostic keys. Each case also shows that its option
acted: ``diag_extra`` adds the reference's extended keys; carried
residuals, stable recovery and split steps change the gaps against the
default solve; the neighbourhood search shortens steps (``nbr_cuts``) and
``recenter`` restarts the barrier (``recenters``) within the 10 iterations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.solvers.cvar import build_cvar_plan as j_build_cvar_plan
from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig
from belief_planning_tpu.solvers.cvar_ipm import cvar_ipm_solve as j_cvar_ipm_solve
from belief_planning_tpu.tree.engine import TreeState as JTreeState
from belief_planning_tpu.tree.topology import build_topology as j_build_topology

from belief_planning_tpu_torch.models.policies import cast_params, highway_policy_set
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.presets import init_branch_mpc
from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig, cvar_ipm_solve
from belief_planning_tpu_torch.tree.engine import build_tree
from belief_planning_tpu_torch.tree.topology import build_topology
from belief_planning_tpu_torch.utils.config import BranchConstants

from tests.test_torch_cuda import cvar_problem
from tests.test_torch_tree_admm import FAST_XLA

torch.set_num_threads(1)

N, NB, ITERS = 3, 1, 10
F64 = torch.float64
HARD_TREES = slice(11, 15)
CASES = {
    "diag_extra": ("merge", dict(diag_extra=True)),
    "resid_carried": ("hard", dict(resid="carried")),
    "recovery_stable": ("merge", dict(recovery="stable")),
    "split_step": ("hard", dict(split_step=True)),
    "neighborhood": ("hard", dict(neighborhood=0.3)),
    "recenter": ("hard", dict(recenter=2, recenter_tol=0.5)),
}


def hard_batch(B=32, seed=0):
    """The hard cold-start batch of ``scripts/cvar_f32_diag.py``: ``(xs, zs)``."""
    rng = np.random.default_rng(seed)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
    xs[:, 1] = np.clip(xs[:, 1], 1.3, 13.1)
    xs[:, 3] = np.clip(xs[:, 3], -0.2, 0.2)
    zs = np.array([12.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.5, (B, 4))
    zs[:, 1] = np.clip(zs[:, 1], 1.3, 13.1)
    zs[:, 3] = np.clip(zs[:, 3], -0.2, 0.2)
    return xs, zs


def _hard_problem():
    cons = BranchConstants(s1=2, s2=3, c2=0.5, tran_diag=0.3, alpha=1, R=1.2, am=6.0, rm=0.3,
                           J_c=20, s_c=1, ylb=0.0, yub=7.2, L=4, W=2.5, col_alpha=5, Kpsi=0.1)
    xt = np.array([0.5, 1.8, 15.0, 0.0])
    pset = highway_policy_set(cons, xt)
    model = highway_model(cons, pset, N=N, dt=0.1)
    params = init_branch_mpc(4, 2, N, NB, xt, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    xs, zs = (torch.as_tensor(a[HARD_TREES], dtype=F64) for a in hard_batch())
    xRefs = torch.as_tensor([0.0, 1.8, 18.0, 0.0], dtype=F64).expand(xs.shape[0], 4)
    return params, pset, model, 0.9, xs, zs, xRefs, None, None, None


def _problem(kind):
    if kind == "hard":
        params, pset, model, ralpha, xs, zs, xRefs, S, bx, floor = _hard_problem()
    else:
        params, _, pset, model, ralpha, xs, zs, xRefs, S, bx, floor = cvar_problem(kind, N, NB, 3)
    topo = build_topology(N, NB, model.m, 4, 2)
    ts = build_tree(model, topo, xs, zs, torch.zeros(xs.shape[0], topo.totalu, 2, dtype=F64),
                    cast_params(pset.params, F64, "cpu"))
    return dict(params=params, ralpha=ralpha, xs=xs, xRefs=xRefs, S=S, bx=bx, floor=floor, ts=ts,
                cplan=build_cvar_plan(topo),
                jplan=j_build_cvar_plan(j_build_topology(N, NB, model.m, 4, 2)))


def _jax_solve(pb, opts):
    p, use_S, B = pb["params"], pb["S"] is not None, pb["xs"].shape[0]
    cfg = JCVaRIPMConfig(iters=ITERS, **opts)
    jts = JTreeState(**{k: jnp.asarray(getattr(pb["ts"], k).numpy())
                        for k in JTreeState._fields})

    def one(ts, S, bx, xr, fl):
        return j_cvar_ipm_solve(pb["jplan"], ts, p.Q, p.R, p.Qslack, xr, pb["ralpha"], p.Fx, bx,
                                p.Fu, p.bu, ts.x_lin[0], S=S if use_S else None, cfg=cfg,
                                dh0_floor=fl if use_S else None)

    np_ = lambda t: jnp.asarray(t.numpy())
    out = jax.jit(jax.vmap(one), compiler_options=FAST_XLA)(
        jts, np_(pb["S"]) if use_S else jnp.zeros((B, 4, 4)),
        np_(pb["bx"]) if use_S else jnp.broadcast_to(jnp.asarray(p.bx), (B, 4)),
        np_(pb["xRefs"]), np_(pb["floor"]) if use_S else jnp.zeros(B, bool))
    return jax.tree.map(np.asarray, out)


def _port_solve(pb, opts):
    p = pb["params"]
    return cvar_ipm_solve(pb["cplan"], pb["ts"], p.Q, p.R, p.Qslack, pb["xRefs"], pb["ralpha"],
                          p.Fx, p.bx if pb["bx"] is None else pb["bx"], p.Fu, p.bu, pb["xs"],
                          S=pb["S"], cfg=CVaRIPMConfig(iters=ITERS, **opts),
                          dh0_floor=pb["floor"], device="cpu")


@pytest.fixture(scope="module")
def problems():
    return {kind: _problem(kind) for kind in ("merge", "hard")}


@pytest.fixture(scope="module")
def defaults(problems):
    """The port's default solve of each problem (what each option changes)."""
    return {kind: _port_solve(pb, {}) for kind, pb in problems.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_option_matches_jax_and_acts(problems, defaults, name):
    kind, opts = CASES[name]
    pb = problems[kind]
    jx, ju, _, _, jaux = _jax_solve(pb, opts)
    x, u, _, _, aux = _port_solve(pb, opts)
    B = pb["xs"].shape[0]
    g = aux["gaps"].numpy()
    assert g.shape == jaux["gaps"].shape == (B, ITERS)
    np.testing.assert_allclose(g, jaux["gaps"], rtol=1e-8, atol=1e-10)
    assert np.abs(u.numpy() - ju).max() < 1e-7
    assert np.abs(x.numpy() - jx).max() < 1e-6
    assert set(aux["diag"]) == set(jaux["diag"])
    for k, v in aux["diag"].items():
        atol = 1e-6 if k in ("prim1", "rq") else 1e-10
        np.testing.assert_allclose(v.numpy(), jaux["diag"][k], rtol=1e-7, atol=atol, err_msg=k)

    # the option acted within the 10 iterations
    base = defaults[kind][4]
    if name == "diag_extra":
        assert set(aux["diag"]) - set(base["diag"]) >= {
            "a1s", "a1l", "a2s", "a2l", "a3s", "a3l", "a4s", "a4l", "aqs", "aql", "cmin",
            "cmax", "nfin", "slmin", "lmax", "nfa", "finK", "finW", "finZ", "finF", "condW"}
        assert torch.equal(aux["gaps"], base["gaps"])
    elif name == "neighborhood":
        assert int(aux["nbr_cuts"].sum()) > 0
    elif name == "recenter":
        assert int(aux["recenters"].sum()) > 0
    else:
        assert not torch.equal(aux["gaps"], base["gaps"])
