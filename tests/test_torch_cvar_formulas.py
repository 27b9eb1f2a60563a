"""The merge configuration's building blocks against the JAX package, f64:
the CVaR plan (exact), the ramp geometry and reference-line tables (exact),
``RefLine`` lookups, the merge policies with and without a reference line,
the merge model's branch probabilities and their Jacobian (1e-12), the
per-lane merge inputs, and the small Gauss-Jordan solves of the CVaR
iteration (1e-12), including a system that needs a row swap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.envs import merge as jmerge
from belief_planning_tpu.models import policies as jpol
from belief_planning_tpu.models.predictive import merge_model as j_merge_model
from belief_planning_tpu.solvers import cvar_pl as jcv
from belief_planning_tpu.solvers.cvar import build_cvar_plan as j_build_cvar_plan
from belief_planning_tpu.tree.topology import build_topology as j_build_topology
from belief_planning_tpu.utils.config import BranchConstants as JBranchConstants

from belief_planning_tpu_torch.convert import convert_constants, convert_policy_params
from belief_planning_tpu_torch.envs import merge as tmerge
from belief_planning_tpu_torch.envs.batched_merge import draw_merge_worlds, merge_lane_inputs
from belief_planning_tpu_torch.models import policies as tpol
from belief_planning_tpu_torch.models.predictive import merge_model
from belief_planning_tpu_torch.solvers import cvar_pl
from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan
from belief_planning_tpu_torch.tree.topology import build_topology

torch.set_num_threads(1)

TOL = 1e-12
# the merge demo's geometry (two lanes, ramp joining lane 1 at 50 m, radius 300 m)
MERGE_GEOMETRY = dict(N_lane=2, merge_lane=1, merge_s=50.0, merge_R=300.0, merge_side=0)
GEOMS = [dict(MERGE_GEOMETRY), dict(N_lane=3, merge_lane=1, merge_s=40.0, merge_R=250.0,
                                    merge_side=1)]


@pytest.mark.parametrize("N,NB,m", [(3, 1, 2), (3, 1, 3), (3, 2, 3), (40, 1, 2)])
@pytest.mark.parametrize("quirks", [True, False])
def test_cvar_plan_identical(N, NB, m, quirks):
    jp = j_build_cvar_plan(j_build_topology(N, NB, m, 4, 2), replicate_quirks=quirks)
    tp = build_cvar_plan(build_topology(N, NB, m, 4, 2), replicate_quirks=quirks)
    for f in ("bdim", "nrisk", "n_sum_rows"):
        assert getattr(jp, f) == getattr(tp, f), f
    for f in ("slotP", "slotM", "child_of", "child_nonleaf"):
        assert np.array_equal(np.asarray(getattr(jp, f)), getattr(tp, f)), f
    for a, b in zip(jcv._static_maps(jp, 0.1), cvar_pl._static_maps(tp, 0.1)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("geo", GEOMS, ids=["demo", "side1"])
def test_merge_tables_identical(geo):
    for a, b in zip(jmerge.merge_geometry(**geo), tmerge.merge_geometry(**geo)):
        assert np.array_equal(a, b)
    for jl, tl in zip(jmerge.merge_ref_lines(**geo), tmerge.merge_ref_lines(**geo)):
        assert np.array_equal(jl.xs, tl.xs) and np.array_equal(jl.ys, tl.ys)


def _ref_lines():
    return jmerge.merge_ref_lines(**MERGE_GEOMETRY), tmerge.merge_ref_lines(**MERGE_GEOMETRY)


def test_ref_line_lookup_and_gradient():
    (jY, jpsi), (tY, tpsi) = _ref_lines()
    # inside, on knots, beyond both ends, and a repeated knot
    xs = np.concatenate([np.linspace(-20.0, 120.0, 301), tY.xs[:5], [tY.xs[-1] + 3.0]])
    for jl, tl in ((jY, tY), (jpsi, tpsi)):
        want = np.asarray(jax.vmap(jl)(jnp.asarray(xs)))
        got = tl(torch.as_tensor(xs)).numpy()
        assert np.abs(got - want).max() < TOL
        jg = np.asarray(jax.vmap(jax.grad(jl))(jnp.asarray(xs)))
        tg = torch.func.vmap(torch.func.grad(tl))(torch.as_tensor(xs)).numpy()
        assert np.abs(tg - jg).max() < TOL
    dup = jpol.RefLine(xs=np.array([0.0, 1.0, 1.0, 2.0]), ys=np.array([0.0, 1.0, 5.0, 6.0]))
    tdup = tpol.RefLine(xs=dup.xs, ys=dup.ys)
    q = np.array([0.5, 1.0, 1.5, -1.0, 3.0])
    assert np.abs(tdup(torch.as_tensor(q)).numpy() - np.asarray(jax.vmap(dup)(q))).max() < TOL


@pytest.mark.parametrize("with_ref", [False, True], ids=["plain", "psiref"])
def test_merge_policies(with_ref):
    (_, jpsi), _ = _ref_lines()
    jcons = JBranchConstants(am=7.0)
    jset = jpol.merge_policy_set(jcons, 20.0, jpsi if with_ref else None)
    tparams = convert_policy_params(jset.params, "cpu")
    rng = np.random.default_rng(4)
    xs = np.array([20.0, 8.0, 19.0, -0.1]) + rng.normal(0, [15.0, 1.0, 2.0, 0.05], (16, 4))
    for jfn, jp, tfn, tp in zip(jset.fns, jset.params, (tpol.maintain_track_v, tpol.brake),
                                tparams):
        want = np.asarray(jax.vmap(lambda x: jfn(x, jp))(jnp.asarray(xs)))
        got = tfn(torch.as_tensor(xs), tp).numpy()
        assert np.abs(got - want).max() < TOL
    if with_ref:
        assert tparams[1].a_brake.item() == -5.0 and tparams[1].gamma.item() == 3.0
    jm = jpol.maintain(jnp.asarray(xs[0]), jpol.MaintainParams(Kpsi=0.1, psiref=jpsi))
    tm = tpol.maintain(torch.as_tensor(xs[:1]),
                       tpol.MaintainParams(Kpsi=0.1, psiref=tpol.RefLine(jpsi.xs, jpsi.ys)))
    assert np.abs(tm.numpy()[0] - np.asarray(jm)).max() < TOL


@pytest.mark.parametrize("with_ref", [False, True], ids=["plain", "psiref"])
def test_merge_model_branch_eval(with_ref):
    (_, jpsi), _ = _ref_lines()
    jcons = JBranchConstants(am=7.0)
    jset = jpol.merge_policy_set(jcons, 20.0, jpsi if with_ref else None)
    jmodel = j_merge_model(jcons, jset, N=6, dt=0.1)
    tcons = convert_constants(jcons)
    tparams = convert_policy_params(jset.params, "cpu")
    tmodel = merge_model(tcons, tpol.PolicySet(fns=(tpol.maintain_track_v, tpol.brake),
                                               params=tparams), N=6, dt=0.1)
    x0, z0 = draw_merge_worlds(6, seed=2)
    p, dp = jax.jit(jax.vmap(lambda x, z: jmodel.branch_eval(x, z, jset.params)))(x0, z0)
    tp_, tdp = tmodel.branch_eval(torch.as_tensor(x0), torch.as_tensor(z0), tparams)
    assert np.abs(tp_.numpy() - np.asarray(p)).max() < TOL
    assert np.abs(tdp.numpy() - np.asarray(dp)).max() < TOL
    h, dh = jax.vmap(jmodel.col_raw)(x0, z0)
    th, tdh = tmodel.col_raw(torch.as_tensor(x0), torch.as_tensor(z0))
    assert np.abs(th.numpy() - np.asarray(h)).max() < TOL
    assert np.abs(tdh.numpy() - np.asarray(dh)).max() < TOL


def test_merge_lane_inputs():
    """Per-lane S, xRef and bx of the merge deployment: the reference's
    ``env_pre`` formulas on the ramp, identity / road reference / default
    bounds after the merge (or beyond merge_s + 8)."""
    (jY, jpsi), _ = _ref_lines()
    cons = JBranchConstants(am=7.0)
    bx0 = np.array([2 * 3.6 - cons.W / 2, -cons.W / 2, 0.25, 0.25])
    x0, _ = draw_merge_worlds(5, seed=3)
    x0[3, 0] = 60.0                                    # beyond merge_s + 8
    merged_in = torch.tensor([False, False, True, False, False])
    merged, S, xRef, bx = merge_lane_inputs(torch.as_tensor(x0), merged_in, bx0, cons.W)
    assert merged.tolist() == [False, False, True, True, False]
    for i in range(5):
        X = x0[i, 0]
        y0, psi0 = float(jY(X)), float(jpsi(X))
        tp = np.tan(psi0)
        if merged[i]:
            S_w, xr_w, bx_w = np.eye(4), np.array([0.0, 1.5 * 3.6, 20.0, 0.0]), bx0
        else:
            S_w = np.eye(4)
            S_w[1, 0] = -tp
            xr_w = np.array([0.0, -tp * X + y0 + 1.8, 20.0, psi0])
            bx_w = np.array([-tp * X + y0 + 3.6 - cons.W / 2, tp * X - y0 - cons.W / 2,
                             psi0 + 0.25, -psi0 + 0.25])
        assert np.abs(S[i].numpy() - S_w).max() < TOL
        assert np.abs(xRef[i].numpy() - xr_w).max() < TOL
        assert np.abs(bx[i].numpy() - bx_w).max() < TOL


def test_world_draw_on_the_ramp():
    (jY, jpsi), _ = _ref_lines()
    x0, z0 = draw_merge_worlds(64, seed=0)
    assert np.all(np.abs(x0[:, 0] - 24.0) <= 6.0) and np.all(np.abs(z0[:, 0] - 15.0) <= 5.0)
    assert np.abs(x0[:, 1] - (np.asarray(jax.vmap(jY)(x0[:, 0])) + 1.8)).max() < TOL
    assert np.abs(x0[:, 3] - np.asarray(jax.vmap(jpsi)(x0[:, 0]))).max() < TOL
    assert np.all(z0[:, 1] == 1.5 * 3.6) and np.all(x0[:, 2] == 20.0)


def test_gj_inverse():
    rng = np.random.default_rng(0)
    G = rng.normal(0, 1, (6, 6, 5))
    M = np.eye(6)[:, :, None] + np.einsum("ikt,jkt->ijt", G, G)     # SPD, diagonal ≥ 1
    want = np.asarray(jcv._gj_inv_bl(jnp.asarray(M)))
    got = cvar_pl._gj_inv_bl(torch.as_tensor(M)).numpy()
    assert np.abs(got - want).max() < TOL
    assert np.abs(np.einsum("ijt,jkt->ikt", M, got) - np.eye(6)[:, :, None]).max() < 1e-10


def test_gj_pivoted_solve_with_row_swaps():
    rng = np.random.default_rng(1)
    A = rng.normal(0, 1, (3, 5, 5, 4))
    A[:, 0, 0, :] = 1e-3                    # a tiny leading pivot: every system must swap
    A[0, :, 0, 1] = 2.0                     # a tie in column 0: the first maximal row wins
    A[0, 0, 0, 1] = 1.0
    Bm = rng.normal(0, 1, (3, 5, 7, 4))
    want = np.asarray(jcv._gj_solve_pivot_bl(jnp.asarray(A), jnp.asarray(Bm)))
    got = cvar_pl._gj_solve_pivot_bl(torch.as_tensor(A), torch.as_tensor(Bm)).numpy()
    assert np.abs(got - want).max() < TOL
    assert np.abs(np.einsum("bijt,bjrt->birt", A, got) - Bm).max() < 1e-10
