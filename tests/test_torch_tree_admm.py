"""The port's tree-QP ADMM (``solvers/tree_qp.admm_solve``, batched over
trees) against the JAX package's under ``vmap``, on identical trees and
costs: the overtake tree of ``tests/test_tree_qp.py`` (N=4, NB ∈ {1, 2}, 3
trees, f64), built by the port and handed to the JAX side. Bars:

- 2 iterations at fixed ρ without polish: u, x, s and the duals < 1e-10; at
  NB=1 with the options: ``row_scaling="weight_rownorm"`` with a given
  ``w_stage``, a dense ``Fxc_override`` block with one extra row a stage,
  and warm duals;
- the entry step's config (ρ=5, 50 iterations at fixed ρ, 10 polish): u <
  1e-7, x < 1e-6.

``tests/test_torch_admm_oracle.py`` holds the solve to the NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.solvers.tree_qp import ADMMConfig as JADMMConfig
from belief_planning_tpu.solvers.tree_qp import StageCost as JStageCost
from belief_planning_tpu.solvers.tree_qp import admm_solve as j_admm_solve
from belief_planning_tpu.solvers.tree_qp import build_stage_plan as j_build_stage_plan
from belief_planning_tpu.tree.engine import TreeState as JTreeState
from belief_planning_tpu.tree.topology import build_topology as j_build_topology

from belief_planning_tpu_torch.convert import convert, convert_admm_config
from belief_planning_tpu_torch.models import policies as tpol
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.solvers.tree_qp import (
    ADMMConfig,
    admm_solve,
    assemble_stage_cost,
    build_stage_plan,
)
from belief_planning_tpu_torch.tree.engine import build_tree
from belief_planning_tpu_torch.tree.topology import build_topology

from tests.test_tree_qp import overtake_setup

torch.set_num_threads(1)

# XLA compile options for the JAX sides: about 40 % less compile time, the
# same results to the last bits these tests can see
FAST_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}

N, B = 4, 3
F64 = torch.float64
CONFIGS = {
    "iters2": dict(iters=2, rho_update_every=0, polish_iters=0),
    "entry": dict(rho=5.0, iters=50, rho_update_every=0, polish_iters=10),
}
BARS = {"iters2": (1e-10, 1e-10), "entry": (1e-7, 1e-6)}


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _problem(NB, xs, zs):
    """The port's trees and costs of the overtake at ``NB`` for states
    ``xs, zs (B, 4)``, and the JAX package's setup."""
    cons, pset, model, params = overtake_setup(N=N, NB=NB)
    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    fns = (tpol.maintain, tpol.brake, tpol.lane_change)
    tmodel = highway_model(tcons, tpol.PolicySet(fns=fns, params=tpp), N=N, dt=0.1)
    topo = build_topology(N, NB, 3, 4, 2)
    Bt = xs.shape[0]
    ts = build_tree(tmodel, topo, _t(xs), _t(zs), torch.zeros(Bt, topo.totalu, 2, dtype=F64), tpp)
    cost = assemble_stage_cost(topo, ts, params.Q, params.R, params.Qf, params.dR, params.Qslack,
                               _t(np.tile(params.xRef, (Bt, 1))), torch.zeros(Bt, 2, dtype=F64))
    return dict(plan=build_stage_plan(topo), ts=ts, cost=cost, params=params, tmodel=tmodel,
                tpp=tpp, x0=_t(xs), old=torch.zeros(Bt, 2, dtype=F64))


def _port_solve(p, cfg, **kw):
    pr = p["params"]
    return admm_solve(p["plan"], p["cost"], p["ts"], pr.Fx, pr.bx, pr.Fu, pr.bu, p["x0"], p["old"],
                      cfg, device="cpu", **kw)


def _states(NB):
    rng = np.random.default_rng(3 + NB)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.1, (B, 4))
    zs = np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
    return xs, zs


def _options(p, rng):
    """A dense row block (the split rows plus one seeded row a stage), stage
    weights and warm duals."""
    dh, h0 = p["ts"].dh.numpy(), p["ts"].h0.numpy()
    pr = p["params"]
    U = dh.shape[1]
    Fxc = np.concatenate([-dh[:, :, None, :], np.broadcast_to(pr.Fx, (B, U) + pr.Fx.shape),
                          rng.normal(0, 0.3, (B, U, 1, 4))], axis=2)
    b1 = np.concatenate([h0[..., None], np.broadcast_to(pr.bx, (B, U, 4)),
                         np.full((B, U, 1), 30.0)], axis=2)
    w_stage = rng.uniform(0.2, 1.0, (B, U))
    duals = (rng.uniform(0, 1, (B, U, 6)), rng.uniform(0, 1, (B, U, 4)),
             -rng.uniform(0, 1, (B, U, 6)))
    return Fxc, b1, w_stage, duals


@pytest.fixture(scope="module")
def solves():
    out = {}
    for NB in (1, 2):
        p = _problem(NB, *_states(NB))
        pr = p["params"]
        jplan = j_build_stage_plan(j_build_topology(N, NB, 3, 4, 2))
        jts = JTreeState(*(a.numpy() for a in p["ts"]))
        jcost = JStageCost(*(c.numpy() for c in p["cost"]))
        Fxc, b1, w_stage, duals = _options(p, np.random.default_rng(11))
        for name, kw in CONFIGS.items():
            use = NB == 1 and name == "iters2"        # the options ride on this solve
            kw = dict(kw, row_scaling="weight_rownorm") if use else kw

            def one(ts_, c_, x, F, b, w, y1, y2, y3, cfg=JADMMConfig(**kw), use=use):
                extra = (dict(w_stage=w, Fxc_override=F, b1_override=b, warm_duals=(y1, y2, y3))
                         if use else {})
                return j_admm_solve(jplan, c_, ts_, pr.Fx, pr.bx, pr.Fu, pr.bu, x, jnp.zeros(2),
                                    cfg, **extra)
            jout = jax.jit(jax.vmap(one), compiler_options=FAST_XLA)(
                jts, jcost, p["x0"].numpy(), Fxc, b1, w_stage, *duals)
            tkw = (dict(w_stage=_t(w_stage), Fxc_override=_t(Fxc), b1_override=_t(b1),
                        warm_duals=tuple(_t(y) for y in duals)) if use else {})
            out[NB, name] = (jax.tree.map(np.asarray, jout),
                             _port_solve(p, convert_admm_config(JADMMConfig(**kw)), **tkw))
    return out


CASES = [(1, "iters2"), (1, "entry"), (2, "iters2"), (2, "entry")]


@pytest.mark.parametrize("NB,name", CASES)
def test_admm_matches_jax(solves, NB, name):
    (jx, ju, js, jst, jinfo), (x, u, s, st, info) = solves[NB, name]
    tol_u, tol_x = BARS[name]
    assert np.abs(u.numpy() - ju).max() < tol_u
    assert np.abs(x.numpy() - jx).max() < tol_x
    assert np.abs(s.numpy() - js).max() < tol_x
    for f in ("z1", "z2", "z3", "y1", "y2", "y3"):
        assert np.abs(getattr(st, f).numpy() - getattr(jst, f)).max() < 1e3 * tol_x, f
    np.testing.assert_allclose(info["prim_res"].numpy(), jinfo["prim_res"], rtol=1e-6,
                               atol=tol_x)
