"""The port's tree build, warm-start shift, stage plan and stage-cost
assembly against the JAX package's, on a cold and a warm-shifted step of the
small overtake config (N=4, NB=2, f64): 1e-9 (PARITY.md tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.solvers.tree_qp import assemble_stage_cost as j_assemble
from belief_planning_tpu.solvers.tree_qp import build_stage_plan as j_build_stage_plan
from belief_planning_tpu.tree.engine import build_tree as j_build_tree
from belief_planning_tpu.tree.engine import warm_shift_indices as j_warm_shift_indices
from belief_planning_tpu.tree.topology import build_topology as j_build_topology

from belief_planning_tpu_torch.convert import convert
from belief_planning_tpu_torch.models.policies import highway_policy_set
from belief_planning_tpu_torch.models.predictive import highway_model
from belief_planning_tpu_torch.solvers.tree_qp import assemble_stage_cost, build_stage_plan
from belief_planning_tpu_torch.tree.engine import build_tree, shift_warm_start, warm_shift_indices
from belief_planning_tpu_torch.tree.topology import build_topology

from tests.test_tree_qp import overtake_setup

torch.set_num_threads(1)

TREE_TOL = 1e-9
N, NB, B = 4, 2, 6


def _inputs():
    rng = np.random.default_rng(11)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, [0.3, 0.3, 1.0, 0.05], (B, 4))
    zs = np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, [1.0, 0.5, 1.0, 0.05], (B, 4))
    xRefs = np.tile([0.0, 1.8, 18.0, 0.0], (B, 1))
    return xs, zs, xRefs


@pytest.fixture(scope="module")
def steps():
    """Cold step (zero warm start) and a warm-shifted step (random previous
    inputs, the cold step's probabilities), through both packages."""
    cons, pset, model, params = overtake_setup(N=N, NB=NB)
    topo = j_build_topology(N, NB, model.m, 4, 2)

    def jprep(u_prev, p_prev, init, x, z, xRef, old):
        src = j_warm_shift_indices(topo, p_prev)
        u_lin = jnp.where(init, u_prev[src], jnp.zeros_like(u_prev))
        ts = j_build_tree(model, topo, x, z, u_lin, pset.params)
        cost = j_assemble(topo, ts, params.Q, params.R, params.Qf, params.dR, params.Qslack,
                          xRef, old, variant="prox", replicate_quirks=True)
        return ts, cost

    jprep = jax.jit(jax.vmap(jprep))
    tparams, tcons, tpp = convert(params, cons, pset.params, "cpu")
    tmodel = highway_model(tcons, highway_policy_set(tcons, tpp[2].x_target), N=N, dt=0.1)
    ttopo = build_topology(N, NB, tmodel.m, 4, 2)

    def tprep(u_prev, p_prev, init, x, z, xRef, old):
        u_lin = torch.where(init[:, None, None], shift_warm_start(ttopo, u_prev, p_prev),
                            torch.zeros_like(u_prev))
        ts = build_tree(tmodel, ttopo, x, z, u_lin, tpp)
        cost = assemble_stage_cost(ttopo, ts, tparams.Q, tparams.R, tparams.Qf, tparams.dR,
                                   tparams.Qslack, xRef, old)
        return ts, cost

    xs, zs, xRefs = _inputs()
    u0 = np.zeros((B, topo.totalu, 2))
    p0 = np.zeros((B, topo.n_branches, topo.m))
    ts_c, cost_c = jprep(u0, p0, np.zeros(B, bool), xs, zs, xRefs, np.zeros((B, 2)))
    u1 = np.random.default_rng(12).normal(0, [1.0, 0.1], (B, topo.totalu, 2))
    p1 = np.asarray(ts_c.p)
    ts_w, cost_w = jprep(u1, p1, np.ones(B, bool), xs, zs, xRefs, u1[:, 0])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    out = {}
    for name, (u, p, init, old, jres) in {
            "cold": (u0, p0, np.zeros(B, bool), np.zeros((B, 2)), (ts_c, cost_c)),
            "warm": (u1, p1, np.ones(B, bool), u1[:, 0], (ts_w, cost_w))}.items():
        tres = tprep(t(u), t(p), torch.as_tensor(init), t(xs), t(zs), t(xRefs), t(old))
        out[name] = (jres, tres)
    return out


def _assert_fields(jtuple, ttuple, fields):
    for f in fields:
        a = getattr(ttuple, f).numpy()
        b = np.asarray(getattr(jtuple, f))
        assert a.shape == b.shape, (f, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= TREE_TOL, (f, err)


@pytest.mark.parametrize("step", ["cold", "warm"])
def test_build_tree(steps, step):
    (jts, _), (tts, _) = steps[step]
    _assert_fields(jts, tts, ["x_lin", "u_lin", "z", "p", "dp", "w", "A", "Bm", "C", "h0", "dh"])


@pytest.mark.parametrize("step", ["cold", "warm"])
def test_assemble_stage_cost(steps, step):
    (_, jcost), (_, tcost) = steps[step]
    _assert_fields(jcost, tcost, ["Qx2", "qx", "Ru2", "qu", "Daa2", "Dab2", "Pterm2",
                                  "qterm", "slack_lin", "slack_quad"])


def test_warm_shift_indices_first_argmax():
    """Ties in the probabilities take the first maximum in both frameworks."""
    topo = j_build_topology(N, NB, 3, 4, 2)
    rng = np.random.default_rng(13)
    p = rng.integers(0, 3, (5, topo.n_branches, topo.m)).astype(float) / 2.0
    want = np.stack([np.asarray(j_warm_shift_indices(topo, jnp.asarray(pi))) for pi in p])
    got = warm_shift_indices(build_topology(N, NB, 3, 4, 2), torch.as_tensor(p)).numpy()
    assert np.array_equal(got, want)


def test_stage_plan_identical():
    jp = j_build_stage_plan(j_build_topology(8, 2, 3, 4, 2))
    tp = build_stage_plan(build_topology(8, 2, 3, 4, 2))
    for f in ("stage_idx", "succ_x_idx", "xnode_idx"):
        for a, b in zip(getattr(jp, f), getattr(tp, f)):
            assert np.array_equal(a, b), f
    assert np.array_equal(jp.leaf_term_idx, tp.leaf_term_idx)
    assert np.array_equal(jp.leaf_ids, tp.leaf_ids)
