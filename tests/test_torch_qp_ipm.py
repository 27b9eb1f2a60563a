"""The port's independent tree-QP IPM (``solvers/tree_qp_ipm.qp_ipm_solve``,
batched over trees) against the JAX package's ``qp_ipm_solve`` under
``vmap``, on identical trees and costs (the overtake tree of
``tests/test_tree_qp.py``, N=4, NB=2, 3 trees, f64, built by the port, which
``test_torch_tree.py`` holds against the JAX package's build): a cold start, a warm
primal, 2 Gondzio correctors and a dense ``Fxc_override`` block. Bars (the
JAX package's own pins): every gap of the 10 iterations within rtol 1e-8
(atol 1e-10, where the gaps reach roundoff), u < 1e-7, x < 1e-6.

Then the pin of the fused path, in the port alone: the per-tree step
``make_branch_mpc_step`` against the fused batched step (plain version of
the iteration) over two receding-horizon steps at the same bars
(``tests/test_tree_qp_pl.py:80``), and a batch of 3 distinct trees against
three one-tree solves (1e-12: every reduction is per tree)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.solvers.tree_qp import StageCost as JStageCost
from belief_planning_tpu.solvers.tree_qp import build_stage_plan as j_build_stage_plan
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig
from belief_planning_tpu.solvers.tree_qp_ipm import qp_ipm_solve as j_qp_ipm_solve
from belief_planning_tpu.tree.engine import TreeState as JTreeState
from belief_planning_tpu.tree.topology import build_topology as j_build_topology

from belief_planning_tpu_torch.controllers.branch_mpc import (
    make_branch_mpc_batched_step,
    make_branch_mpc_step,
)
from belief_planning_tpu_torch.convert import convert
from belief_planning_tpu_torch.models import policies as tpol
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.solvers.tree_qp import assemble_stage_cost, build_stage_plan
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig, qp_ipm_solve
from belief_planning_tpu_torch.tree.engine import build_tree
from belief_planning_tpu_torch.tree.topology import build_topology

from tests.test_tree_qp import overtake_setup

torch.set_num_threads(1)

N, NB, B, ITERS = 4, 2, 3, 10
CASES = ("cold", "warm", "gondzio", "override")


def _override(ts, params, rng):
    """A dense per-stage row block: the split rows [−dh; Fx] plus one extra
    seeded row per stage, with its bound."""
    dh, h0 = np.asarray(ts.dh), np.asarray(ts.h0)
    extra = rng.normal(0, 0.3, (B, dh.shape[1], 1, 4))
    Fxc = np.concatenate([-dh[:, :, None, :],
                          np.broadcast_to(params.Fx, (B, dh.shape[1]) + params.Fx.shape),
                          extra], axis=2)
    b1 = np.concatenate([h0[..., None], np.broadcast_to(params.bx, h0.shape + (4,)),
                         np.full(h0.shape + (1,), 30.0)], axis=2)
    return Fxc, b1


@pytest.fixture(scope="module")
def case():
    cons, pset, model, params = overtake_setup(N=N, NB=NB)
    topo = j_build_topology(N, NB, model.m, 4, 2)
    jplan = j_build_stage_plan(topo)
    rng = np.random.default_rng(3)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.1, (B, 4))
    zs = np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
    xRef = np.array([0.0, 1.8, 18.0, 0.0])

    t = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
    tmodel, tparams, tpp = _port_model(params, cons, pset)
    ttopo = build_topology(N, NB, 3, 4, 2)
    tts = build_tree(tmodel, ttopo, t(xs), t(zs),
                     torch.zeros(B, topo.totalu, 2, dtype=torch.float64), tpp)
    tcost = assemble_stage_cost(ttopo, tts, tparams.Q, tparams.R, tparams.Qf, tparams.dR,
                                tparams.Qslack, t(np.tile(xRef, (B, 1))),
                                torch.zeros(B, 2, dtype=torch.float64))
    ts = JTreeState(*(a.numpy() for a in tts))
    cost = JStageCost(*(c.numpy() for c in tcost))
    warm = (np.asarray(ts.x_lin) + rng.normal(0, 0.05, ts.x_lin.shape),
            np.asarray(ts.u_lin) + rng.normal(0, [0.3, 0.02], ts.u_lin.shape))
    Fxc, b1 = _override(ts, params, rng)

    def jsolve(cfg, override):
        def one(ts_, cost_, x, wx, wu, F, b):
            kw = dict(Fxc_override=F, b1_override=b) if override else {}
            return j_qp_ipm_solve(jplan, cost_, ts_, params.Fx, params.bx, params.Fu, params.bu,
                                  x, jnp.zeros(2), cfg, warm_primal=(wx, wu), **kw)
        return jax.jit(jax.vmap(one))

    plain = jsolve(JQPIPMConfig(iters=ITERS), False)
    jout = {
        "cold": plain(ts, cost, xs, ts.x_lin, ts.u_lin, Fxc, b1),
        "warm": plain(ts, cost, xs, *warm, Fxc, b1),
        "gondzio": jsolve(JQPIPMConfig(iters=ITERS, gondzio=2), False)(
            ts, cost, xs, ts.x_lin, ts.u_lin, Fxc, b1),
        "override": jsolve(JQPIPMConfig(iters=ITERS), True)(
            ts, cost, xs, ts.x_lin, ts.u_lin, Fxc, b1),
    }
    plan = build_stage_plan(ttopo)
    args = (plan, tcost, tts, params.Fx, params.bx, params.Fu, params.bu, t(xs),
            torch.zeros(B, 2, dtype=torch.float64))
    cfg = QPIPMConfig(iters=ITERS)
    tout = {
        "cold": qp_ipm_solve(*args, cfg, device="cpu"),
        "warm": qp_ipm_solve(*args, cfg, warm_primal=(t(warm[0]), t(warm[1])), device="cpu"),
        "gondzio": qp_ipm_solve(*args, QPIPMConfig(iters=ITERS, gondzio=2), device="cpu"),
        "override": qp_ipm_solve(*args, cfg, Fxc_override=t(Fxc), b1_override=t(b1),
                                 device="cpu"),
    }
    return dict(jout=jout, tout=tout, args=args, params=params, pset=pset, cons=cons,
                model=model)


@pytest.mark.parametrize("name", CASES)
def test_solve_matches_jax(case, name):
    jx, ju, js, jaux = (np.asarray(a) if not isinstance(a, dict) else a
                        for a in case["jout"][name])
    x, u, s, aux = case["tout"][name]
    g, jg = aux["gaps"].numpy(), np.asarray(jaux["gaps"])
    assert g.shape == jg.shape == (B, ITERS)
    np.testing.assert_allclose(g, jg, rtol=1e-8, atol=1e-10)
    assert np.abs(u.numpy() - ju).max() < 1e-7
    assert np.abs(x.numpy() - jx).max() < 1e-6
    assert np.abs(s.numpy() - js).max() < 1e-6
    # accepted step lengths, while the gap is above roundoff (below it the
    # fraction-to-boundary ratios are noise in either package)
    live = jg > 1e-6
    assert np.abs(aux["steps"].numpy() - np.asarray(jaux["steps"]))[live].max() < 1e-6
    np.testing.assert_allclose(aux["prim_res"].numpy(), np.asarray(jaux["prim_res"]),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(aux["gap"].numpy(), np.asarray(jaux["gap"]),
                               rtol=1e-8, atol=1e-10)


def test_batch_of_trees_is_independent(case):
    """Three distinct trees in one batch against three one-tree solves: every
    reduction (gap, step lengths, Gondzio acceptance, prim_res) is per tree."""
    plan, cost, ts, *rest = case["args"]
    x0, uo = rest[4], rest[5]
    cfg = QPIPMConfig(iters=ITERS, gondzio=2)
    whole = qp_ipm_solve(plan, cost, ts, *rest[:4], x0, uo, cfg, device="cpu")
    for i in range(B):
        one = lambda tup: type(tup)(*(a[i:i + 1] for a in tup))
        part = qp_ipm_solve(plan, one(cost), one(ts), *rest[:4], x0[i:i + 1], uo[i:i + 1], cfg,
                            device="cpu")
        for a, b in zip(part[:3], whole[:3]):
            assert (a[0] - b[i]).abs().max().item() <= 1e-12
        for key in ("gaps", "steps", "prim_res", "gap"):
            assert (part[3][key][0] - whole[3][key][i]).abs().max().item() <= 1e-12


def _port_model(params, cons, pset):
    params, cons, pp = convert(params, cons, pset.params, "cpu")
    fns = (tpol.maintain, tpol.brake, tpol.lane_change)
    return highway_model(cons, tpol.PolicySet(fns=fns, params=pp), N=N, dt=0.1), params, pp


def test_per_tree_step_pins_the_fused_step(case):
    """The fused batched step (plain version of K1's iteration) against the
    independent per-tree step: two receding-horizon steps with the warm
    carry, 8 trees, IPM-14 (``tests/test_tree_qp_pl.py``'s pin)."""
    model, params, pp = _port_model(case["params"], case["cons"], case["pset"])
    ipm = QPIPMConfig(iters=14)
    Bp = 8
    rng = np.random.default_rng(3)
    f64 = torch.float64
    xs = torch.as_tensor(np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.1, (Bp, 4)), dtype=f64)
    zs = torch.as_tensor(np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.2, (Bp, 4)), dtype=f64)
    xRefs = torch.as_tensor(np.tile([0.0, 1.8, 18.0, 0.0], (Bp, 1)), dtype=f64)
    outs = []
    for make in (make_branch_mpc_step, make_branch_mpc_batched_step):
        _, init, step = make(model, params, "prox", ipm=ipm, device="cpu")
        c, seq = init(Bp, f64), []
        for _ in range(2):
            c, r = step(c, xs, zs, xRefs, pp)
            seq.append(r)
        outs.append(seq)
    for rb, rp in zip(*outs):
        assert (rb.uPred - rp.uPred).abs().max().item() < 1e-7
        assert (rb.xPred - rp.xPred).abs().max().item() < 1e-6
        assert torch.equal(rb.feasible, rp.feasible)
    assert bool(outs[0][-1].feasible.all())
    assert outs[0][-1].prim_res.max().item() < 1e-7
