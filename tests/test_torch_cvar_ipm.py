"""The port's independent CVaR IPM (``solvers/cvar_ipm.cvar_ipm_solve``,
batched over trees) against the JAX package's ``cvar_ipm_solve`` under
``vmap``, on identical trees (built by the port in f64 and handed to both):
the CVaR overtake (N=3, NB=1, m=3, ralpha 0.9) and the merge deployment
(m=2, ralpha 0.1, per-tree S, bx and a mixed dh[0] floor), 3 trees each.

Cases: the default; S with the floor and one refinement round; 2 Gondzio
correctors; ``outer_dtype="f64"`` on a float32 solve (the diagnostic
options: ``tests/test_torch_cvar_diag_options.py``). Bars in f64: every gap within rtol 1e-8 (atol
1e-10), the root input within 1e-7, the diagnostics within rtol 1e-7. Late
CVaR iterates are chaotic in the reference itself, so each run stops before
the step where the JAX package's own jitted and eager runs part: the 10th
step of the default case (root u 6.5e-6 apart) and the 9th with Gondzio
correctors (3.6e-6, and their 10th gaps by 0.74 relative;
``scripts/torch_port_ipm_chaos.py cvar``).
The float32 solve is held to rtol 1e-6 over 5 iterations: the two packages
round the float32 factor differently.

Then, in the port alone: the pin of the fused CVaR path (``cvar_ipm_solve_pl``,
plain version of K2's iteration) against ``cvar_ipm_solve`` (first 10 gaps
rtol 1e-8, root u < 2e-2, ``tests/test_cvar_pl.py:71``), and the restart's
selection at IPM-12 against a restart written out by hand
(``test_torch_ipm_steps.py`` holds the per-tree steps against the JAX
package's)."""

import dataclasses

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

from belief_planning_tpu_torch.controllers.cvar_mpc import make_cvar_mpc_step
from belief_planning_tpu_torch.models.policies import cast_params
from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig, cvar_ipm_solve
from belief_planning_tpu_torch.solvers.cvar_pl import cvar_ipm_solve_pl
from belief_planning_tpu_torch.solvers.layout import _from_bl, _to_bl
from belief_planning_tpu_torch.tree.engine import build_tree
from belief_planning_tpu_torch.tree.topology import build_topology

from tests.test_torch_cuda import cvar_problem

torch.set_num_threads(1)

N, NB, B = 3, 1, 3
# name: (configuration, options, iterations, solve dtype)
CASES = {
    "default": ("overtake", {}, 9, torch.float64),
    "S_floor_refine": ("merge", dict(refine=1), 10, torch.float64),
    "gondzio": ("overtake", dict(gondzio=2), 8, torch.float64),
    "outer_f64": ("merge", dict(outer_dtype="f64"), 5, torch.float32),
}


def _problem(kind):
    params, _, pset, model, ralpha, xs, zs, xRefs, S, bx, floor = cvar_problem(kind, N, NB, B)
    topo = build_topology(N, NB, model.m, 4, 2)
    ts = build_tree(model, topo, xs, zs, torch.zeros(B, topo.totalu, 2, dtype=torch.float64),
                    cast_params(pset.params, torch.float64, "cpu"))
    return dict(params=params, pset=pset, model=model, ralpha=ralpha, xs=xs, zs=zs, xRefs=xRefs,
                S=S, bx=bx, floor=floor, ts=ts, cplan=build_cvar_plan(topo),
                jplan=j_build_cvar_plan(j_build_topology(N, NB, model.m, 4, 2)))


def _jax_solve(pb, opts, iters, dtype):
    p, use_S = pb["params"], pb["S"] is not None
    cfg = JCVaRIPMConfig(iters=iters, **opts)
    npd = np.float64 if dtype == torch.float64 else np.float32
    jts = JTreeState(**{k: jnp.asarray(getattr(pb["ts"], k).numpy().astype(npd))
                        for k in JTreeState._fields})

    def one(ts, S, bx, xr, fl):
        return j_cvar_ipm_solve(pb["jplan"], ts, p.Q, p.R, p.Qslack, xr, pb["ralpha"], p.Fx, bx,
                                p.Fu, p.bu, ts.x_lin[0], S=S if use_S else None, cfg=cfg,
                                dh0_floor=fl if use_S else None)

    np_ = lambda t: jnp.asarray(t.numpy())
    out = jax.jit(jax.vmap(one))(
        jts, np_(pb["S"]) if use_S else jnp.zeros((B, 4, 4)),
        np_(pb["bx"]) if use_S else jnp.broadcast_to(jnp.asarray(p.bx), (B, 4)),
        np_(pb["xRefs"]), np_(pb["floor"]) if use_S else jnp.zeros(B, bool))
    return jax.tree.map(np.asarray, out)


def _port_solve(pb, opts, iters, dtype):
    p = pb["params"]
    ts = type(pb["ts"])(*(a.to(dtype) for a in pb["ts"]))
    return cvar_ipm_solve(pb["cplan"], ts, p.Q, p.R, p.Qslack, pb["xRefs"], pb["ralpha"], p.Fx,
                          p.bx if pb["bx"] is None else pb["bx"], p.Fu, p.bu, pb["xs"], S=pb["S"],
                          cfg=CVaRIPMConfig(iters=iters, **opts), dh0_floor=pb["floor"],
                          device="cpu")


@pytest.fixture(scope="module")
def problems():
    return {kind: _problem(kind) for kind in ("overtake", "merge")}


def solve_both(problems, cases):
    """Each case through the JAX package and the port: ``{name: (jax, port)}``."""
    out = {}
    for name, (kind, opts, iters, dtype) in cases.items():
        pb = problems[kind]
        out[name] = (_jax_solve(pb, opts, iters, dtype), _port_solve(pb, opts, iters, dtype))
    return out


def check_against_jax(run, iters, dtype):
    (jx, ju, js, jr, jaux), (x, u, s, r, aux) = run
    assert u.dtype == s.dtype == aux["gaps"].dtype == aux["J"].dtype == dtype
    g = aux["gaps"].double().numpy()
    assert g.shape == jaux["gaps"].shape == (B, iters)
    if dtype == torch.float32:
        np.testing.assert_allclose(g, jaux["gaps"], rtol=1e-6)
        return
    np.testing.assert_allclose(g, jaux["gaps"], rtol=1e-8, atol=1e-10)
    assert np.abs(u.numpy()[:, 0] - ju[:, 0]).max() < 1e-7
    assert np.abs(u.numpy() - ju).max() < 1e-7
    assert np.abs(x.numpy() - jx).max() < 1e-6
    assert np.abs(r.numpy() - jr).max() < 1e-6
    np.testing.assert_allclose(aux["gap"].numpy(), jaux["gap"], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(aux["J"].numpy(), jaux["J"], rtol=1e-8, atol=1e-10)
    assert set(aux["diag"]) == set(jaux["diag"])
    for k, v in aux["diag"].items():
        # prim1 and rq are residual maxima: roundoff of O(10) row values
        atol = 1e-6 if k in ("prim1", "rq") else 1e-10
        np.testing.assert_allclose(v.numpy(), jaux["diag"][k], rtol=1e-7, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def runs(problems):
    return solve_both(problems, CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_jax(runs, name):
    _, _, iters, dtype = CASES[name]
    check_against_jax(runs[name], iters, dtype)


@pytest.mark.parametrize("kind", ["overtake", "merge"])
def test_independent_solver_pins_the_fused_solve(problems, kind):
    """The fused CVaR solve (plain version of K2's iteration) against the
    independent solver on the same trees, IPM-40."""
    pb = problems[kind]
    p, ts = pb["params"], pb["ts"]
    cfg = CVaRIPMConfig(iters=40)
    x, u, s, r, aux = cvar_ipm_solve(pb["cplan"], ts, p.Q, p.R, p.Qslack, pb["xRefs"],
                                     pb["ralpha"], p.Fx, p.bx if pb["bx"] is None else pb["bx"],
                                     p.Fu, p.bu, pb["xs"], S=pb["S"], cfg=cfg,
                                     dh0_floor=pb["floor"], device="cpu")
    bl = lambda a: None if a is None else _to_bl(a)
    _, u_bl, _, _, aux_pl = cvar_ipm_solve_pl(
        pb["cplan"], bl(ts.A), bl(ts.Bm), bl(ts.dh), bl(ts.h0), bl(ts.x_lin), bl(ts.u_lin),
        bl(ts.p), p.Q, p.R, p.Qslack, bl(pb["xRefs"]), pb["ralpha"], p.Fx,
        p.bx if pb["bx"] is None else bl(pb["bx"]), p.Fu, p.bu, cfg=cfg, S_bl=bl(pb["S"]),
        dh0_floor=pb["floor"])
    np.testing.assert_allclose(aux["gaps"][:, :10].numpy(), aux_pl["gaps"].T[:, :10].numpy(),
                               rtol=1e-8, atol=1e-10)
    assert (u[:, 0] - _from_bl(u_bl)[:, 0]).abs().max().item() < 2e-2


def test_step_restart_keeps_the_better_solve(problems):
    """``make_cvar_mpc_step`` with ``restart``: per tree, the result of the
    solve or of the restart, whichever has the smaller gap; the restart is a
    second solve from the first one's primal with the flipped corrector count."""
    pb = problems["merge"]
    ipm = CVaRIPMConfig(iters=12, gondzio=2)
    kw = dict(ipm=ipm, use_S=True, device="cpu")
    f64 = torch.float64
    _, cplan, init, step = make_cvar_mpc_step(pb["model"], pb["params"], pb["ralpha"], **kw)
    _, _, _, step_r = make_cvar_mpc_step(pb["model"], pb["params"], pb["ralpha"], restart=6, **kw)
    args = (init(B, f64), pb["xs"], pb["zs"], pb["xRefs"], pb["pset"].params)
    c1, r1 = step(*args, S=pb["S"], bx=pb["bx"])
    _, r2 = step_r(*args, S=pb["S"], bx=pb["bx"])
    assert torch.equal(c1.initialized, torch.ones(B, dtype=torch.bool))
    assert bool((r2.gap <= r1.gap).all())
    # the restart by hand: the first solve's primal, fresh duals, 4 correctors
    p = pb["params"]
    ts = build_tree(pb["model"], cplan.plan.topo, pb["xs"], pb["zs"],
                    torch.zeros(B, cplan.plan.topo.totalu, 2, dtype=f64),
                    cast_params(pb["pset"].params, f64, "cpu"))
    ts = ts._replace(x_lin=r1.xPred, u_lin=r1.uPred)
    rcfg = dataclasses.replace(ipm, iters=6, gondzio=4)
    _, u_h, _, _, aux_h = cvar_ipm_solve(cplan, ts, p.Q, p.R, p.Qslack, pb["xRefs"],
                                         pb["ralpha"], p.Fx, pb["bx"], p.Fu, p.bu, pb["xs"],
                                         S=pb["S"], cfg=rcfg, dh0_floor=torch.zeros(B, dtype=bool),
                                         device="cpu")
    better = aux_h["gap"] < r1.gap
    want_u = torch.where(better[:, None, None], u_h, r1.uPred)
    assert torch.equal(r2.uPred, want_u)
    assert torch.equal(r2.gap, torch.minimum(aux_h["gap"], r1.gap))
