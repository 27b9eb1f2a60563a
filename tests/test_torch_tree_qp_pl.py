"""The port's fused IPM iteration (plain version) and solve driver against
the JAX package's level-blocked iteration (``make_iteration``, the Pallas
kernel's body, run as plain XLA) on identical QP data and carry (small
overtake config N=4, NB=2, f64, Gondzio=2). The CUDA kernel is held against
the plain version in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.solvers import tree_qp_pl as jpl
from belief_planning_tpu.solvers.layout import _small_inv_bl as j_small_inv_bl
from belief_planning_tpu.solvers.tree_qp import StageCost as JStageCost
from belief_planning_tpu.solvers.tree_qp import build_stage_plan as j_build_stage_plan
from belief_planning_tpu.solvers.tree_qp_ipm import QPIPMConfig as JQPIPMConfig
from belief_planning_tpu.tree.topology import build_topology as j_build_topology

from belief_planning_tpu_torch.solvers import tree_qp_pl as tpl
from belief_planning_tpu_torch.solvers.layout import _small_inv_bl
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

from tests.test_torch_cuda import GONDZIO, ITER_TOL, NAMES, NB, N, qp_data

torch.set_num_threads(1)



@pytest.fixture(scope="module")
def case():
    params, plan, cost_bl, tsb = qp_data()
    cfg = QPIPMConfig(iters=6, gondzio=GONDZIO)
    su = tpl.setup_ipm(plan, cost_bl, tsb["A"], tsb["Bm"], tsb["dh"], tsb["h0"],
                       params.Fx, params.bx, params.Fu, params.bu, tsb["x"], tsb["u"], cfg)
    nFx, nFu = params.Fx.shape[0], params.Fu.shape[0]
    mtot = float(plan.topo.totalu * (2 * (nFx + 1) + nFu))
    plain = tpl.make_iteration(plan, cfg, nFx, nFu, mtot)
    carries = {"init": su.carry0}
    c = su.carry0
    for _ in range(3):
        c = plain(*su.const_args, *c)[:tpl.CARRY_FIELDS]
    carries["iter4"] = c
    # the JAX side, on the same numbers
    jplan = j_build_stage_plan(j_build_topology(N, NB, 3, 4, 2))
    jcfg = JQPIPMConfig(iters=6, gondzio=GONDZIO)
    jiter = jax.jit(jpl.make_iteration(jplan, jcfg, nFx, nFu, mtot))
    np_ = lambda a: np.asarray(a.numpy())
    jcost = JStageCost(*(np_(c) for c in cost_bl))
    jconsts = jpl._prep_consts(jplan, jcost, np_(tsb["A"]), np_(tsb["Bm"]), np_(tsb["dh"]),
                               np_(tsb["h0"]), params.Fx, params.bx, params.Fu, params.bu)
    jargs = [jconsts[k] for k in jpl.CONST_ORDER]
    jout = {k: [np.asarray(o) for o in jiter(*jargs, *(np_(x) for x in cy))]
            for k, cy in carries.items()}
    jsolve = jax.jit(lambda A, Bm, C, dh, h0, x, u: jpl.qp_ipm_solve_pl(
        jplan, jcost, A, Bm, C, dh, h0, params.Fx, params.bx, params.Fu, params.bu, x, u,
        cfg=jcfg, use_pallas=False))
    jres = jsolve(np_(tsb["A"]), np_(tsb["Bm"]), np_(tsb["C"]), np_(tsb["dh"]), np_(tsb["h0"]),
                  np_(tsb["x"]), np_(tsb["u"]))
    return dict(params=params, plan=plan, cost_bl=cost_bl, tsb=tsb, cfg=cfg, su=su, plain=plain,
                carries=carries, jconsts=jconsts, jout=jout, jres=jres, jplan=jplan)


def _scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_prep_consts_identical(case):
    consts = dict(zip(tpl.CONST_ORDER, case["su"].const_args))
    for k in tpl.CONST_ORDER:
        assert np.array_equal(consts[k].numpy(), np.asarray(case["jconsts"][k])), k


def test_build_levels_identical(case):
    jl = jpl.build_levels(case["jplan"])
    tl = tpl.build_levels(case["plan"])
    assert [tuple(vars(m).values()) for m in jl] == [tuple(vars(m).values()) for m in tl]


@pytest.mark.parametrize("carry", ["init", "iter4"])
def test_iterate_matches_jax(case, carry):
    """One fused iteration with Gondzio=2: every output field within 1e-10 of
    its magnitude."""
    out = case["plain"](*case["su"].const_args, *case["carries"][carry])
    for name, a, b in zip(NAMES, out, case["jout"][carry]):
        err = _scaled(a.numpy(), b)
        assert err <= ITER_TOL, (name, err)


def test_solve_matches_jax(case):
    """The solve driver (init, best-iterate tracking, prim_res) against JAX's
    ``pl_xla`` solve: the fused-solver bars u < 1e-7, x < 1e-6."""
    tsb, p = case["tsb"], case["params"]
    x, u, s, aux = tpl.qp_ipm_solve_pl(case["plan"], case["cost_bl"], tsb["A"], tsb["Bm"],
                                       tsb["C"], tsb["dh"], tsb["h0"], p.Fx, p.bx, p.Fu, p.bu,
                                       tsb["x"], tsb["u"], case["cfg"])
    jx, ju, js, jaux = case["jres"]
    assert np.abs(u.numpy() - np.asarray(ju)).max() < 1e-7
    assert np.abs(x.numpy() - np.asarray(jx)).max() < 1e-6
    assert np.abs(s.numpy() - np.asarray(js)).max() < 1e-6
    assert np.abs(aux["prim_res"].numpy() - np.asarray(jaux["prim_res"])).max() < 1e-9
    assert _scaled(aux["gaps"].numpy(), jaux["gaps"]) < 1e-8


def _jax_profile_phase(jplan, cfg, phase):
    """The JAX profile's phase body (``scripts/profile_ipm_kernel.py``,
    ``make_phase_fn``) assembled from the JAX package's level blocks, in the
    inputs' dtype: ``body(consts..., carry...)`` → t0 (1, T) of phase 0
    (Σ K + Σ Hinv) or 1 (Σ dx + Σ du). The carry and its 1e-30 nudge of
    sl1, which only chain the profile's scan, are left out."""
    levels = jpl.build_levels(jplan)
    n, d, m = jplan.topo.n, jplan.topo.d, jplan.topo.m

    def cheap_touch(blocks):
        acc = None
        for a in blocks:
            s = jnp.sum(a, axis=tuple(range(a.ndim - 1)), keepdims=False)
            s = s.reshape(1, -1) if s.ndim == 1 else s
            acc = s if acc is None else acc + s
        return acc

    def body(Qx2, qx, Ru2, qu, Dab2, qterm, Pterm2, slack_lin, slack_quad, A_st, B_st, dh, b1,
             Fx, Fu, bu, x_c, u_c, s_c, sl1, lam1, sl2_, lam2_, sl3, lam3):
        dtype, T = x_c.dtype, x_c.shape[-1]
        w_max_eff = min(cfg.w_max, 1e6)
        FxFx = Fx[:, :, None] * Fx[:, None, :]
        FuFu = Fu[:, :, None] * Fu[:, None, :]
        clampw = lambda w: jnp.minimum(w, w_max_eff)
        w1 = clampw(lam1 / sl1)
        w2 = clampw(lam2_ / sl2_)
        w3 = clampw(lam3 / sl3)
        kap = slack_quad + w1 + w3 + cfg.reg
        coefs = w1 - w1 * w1 / kap
        eye_n = jnp.eye(n, dtype=dtype)[None, :, :, None]
        out0 = coefs[:, 0:1][:, :, None, :] * dh[:, :, None, :] * dh[:, None, :, :]
        Qx2_eff = Qx2 + out0 + jnp.sum(
            coefs[:, 1:][:, :, None, None, :] * FxFx[None, :, :, :, None], axis=1) \
            + cfg.reg * eye_n
        Ru2_eff = Ru2 + cfg.reg * jnp.eye(d, dtype=dtype)[None, :, :, None]
        Ru2_eff = Ru2_eff + jnp.sum(w2[:, :, None, None, :] * FuFu[None, :, :, :, None], axis=1)
        Pterm2_eff = Pterm2 + cfg.reg * eye_n
        K_l, Hinv_l, Acl_l = jpl._factor_blocks(levels, Qx2_eff, Dab2, Ru2_eff, Pterm2_eff,
                                                A_st, B_st, n, d, m, cfg.reg)
        if phase == 0:
            return cheap_touch(list(K_l) + list(Hinv_l))
        kff_l = jpl._linear_blocks(levels, K_l, Hinv_l, Acl_l, B_st, qx, qu, qterm, n, d, m)
        dx, du = jpl._forward_blocks(levels, K_l, Hinv_l, Acl_l, B_st, kff_l, n, d, m, dtype, T)
        return cheap_touch([dx, du])

    return jax.jit(body)


@pytest.mark.parametrize("carry", ["init", "iter4"])
@pytest.mark.parametrize("phase", [0, 1])
def test_phase_matches_jax_profile(case, phase, carry):
    """The plain phases (the phase kernels' plain version) against the JAX
    profile's phase body on the same constants and carry: t0 within 1e-10
    of its magnitude."""
    su, p = case["su"], case["params"]
    nFx, nFu = p.Fx.shape[0], p.Fu.shape[0]
    mtot = float(case["plan"].topo.totalu * (2 * (nFx + 1) + nFu))
    cy = case["carries"][carry]
    got = tpl.make_phase(case["plan"], case["cfg"], nFx, nFu, mtot, phase)(*su.const_args, *cy)
    jcfg = JQPIPMConfig(iters=6, gondzio=GONDZIO)
    jargs = [case["jconsts"][k] for k in jpl.CONST_ORDER] + [np.asarray(c.numpy()) for c in cy]
    want = _jax_profile_phase(case["jplan"], jcfg, phase)(*jargs)
    err = _scaled(got.numpy(), want)
    assert err <= ITER_TOL, (phase, carry, err)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_small_inv_closed_form(d):
    rng = np.random.default_rng(d)
    M = rng.normal(0, 1, (5, d, d, 7)) + 3 * np.eye(d)[None, :, :, None]
    assert np.abs(_small_inv_bl(torch.as_tensor(M)).numpy()
                  - np.asarray(j_small_inv_bl(jnp.asarray(M)))).max() < 1e-12


def test_rate_edge_terms_match_jax(case):
    rng = np.random.default_rng(5)
    totalu = case["plan"].topo.totalu
    Dab2 = rng.normal(0, 1, (totalu, 2, 2, 3))
    u = rng.normal(0, 1, (totalu, 2, 3))
    got = tpl._rate_edge_terms(tpl.build_levels(case["plan"]), torch.as_tensor(Dab2),
                               torch.as_tensor(u), 3)
    want = jax.jit(lambda D, v: jpl._rate_edge_terms(jpl.build_levels(case["jplan"]), D, v, 3))(
        Dab2, u)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-12


def test_no_state_rows_gets_one_inert_row(case):
    """A config without state rows (Fx of shape (0, n)) is solved with one
    inert padded row 0·x ≤ 1e9: the same solve as passing that row
    explicitly, with the padded row's slack dropped from the output."""
    tsb, p = case["tsb"], case["params"]
    b1 = case["su"].b1
    args = (case["plan"], case["cost_bl"], tsb["A"], tsb["Bm"], tsb["C"], tsb["dh"], tsb["h0"])
    cfg = QPIPMConfig(iters=3, gondzio=GONDZIO)
    x0, u0, s0, a0 = tpl.qp_ipm_solve_pl(*args, np.empty((0, 4)), np.empty((0,)), p.Fu, p.bu,
                                         tsb["x"], tsb["u"], cfg)
    x1, u1, s1, a1 = tpl.qp_ipm_solve_pl(*args, np.zeros((1, 4)), np.full((1,), 1e9), p.Fu,
                                         p.bu, tsb["x"], tsb["u"], cfg)
    assert b1.shape[1] == 5 and s0.shape[1] == 1 and s1.shape[1] == 2
    assert torch.equal(x0, x1) and torch.equal(u0, u1) and torch.equal(s0, s1[:, :1])
    assert torch.equal(a0["prim_res"], a1["prim_res"])
