"""The port's fused CVaR iteration (plain version) and solve driver against
the JAX package's (``make_cvar_iteration`` and ``cvar_ipm_solve_pl`` with
``use_pallas=False``, which the JAX package pins to its Pallas kernel body)
on identical inputs: the merge configuration (N=3, NB=1, m=2) with per-lane
``S``, ``bx`` and dh[0] floor, and without ``S``; f64. The CUDA kernel is
held against the plain version in ``test_torch_cuda.py`` and
``test_torch_cvar_kernel_cpu_build.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.solvers import cvar_pl as jcv
from belief_planning_tpu.solvers.cvar import build_cvar_plan as j_build_cvar_plan
from belief_planning_tpu.solvers.cvar_ipm import CVaRIPMConfig as JCVaRIPMConfig
from belief_planning_tpu.tree.topology import build_topology as j_build_topology

from belief_planning_tpu_torch.models.policies import cast_params
from belief_planning_tpu_torch.solvers import cvar_pl
from belief_planning_tpu_torch.solvers.cvar import build_cvar_plan
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig
from belief_planning_tpu_torch.solvers.layout import _to_bl
from belief_planning_tpu_torch.tree.engine import build_tree
from belief_planning_tpu_torch.tree.topology import build_topology

from tests.test_torch_cuda import CVAR_NAMES, ITER_TOL, cvar_problem

torch.set_num_threads(1)

N, NB, B, M = 3, 1, 4, 2
SOLVE_ITERS = 8


def _np(a):
    return np.asarray(a.numpy() if torch.is_tensor(a) else a)


@pytest.fixture(scope="module")
def case():
    params, _, pset, model, ralpha, xs, zs, xRefs, S, bx, floor = cvar_problem("merge", N, NB, B)
    topo = build_topology(N, NB, M, 4, 2)
    cplan = build_cvar_plan(topo)
    f64 = torch.float64
    ts = build_tree(model, topo, xs, zs, torch.zeros(B, topo.totalu, 2, dtype=f64),
                    cast_params(pset.params, f64, "cpu"))
    tsb = {k: _to_bl(getattr(ts, k)) for k in ("A", "Bm", "dh", "h0", "x_lin", "u_lin", "p")}
    inputs = dict(params=params, ralpha=ralpha, tsb=tsb, xRef=_to_bl(xRefs), S=_to_bl(S),
                  bx=_to_bl(bx), floor=floor)
    jtopo = j_build_topology(N, NB, M, 4, 2)
    jplan = j_build_cvar_plan(jtopo)

    def setups(cfg, with_S):
        kw = dict(S_bl=inputs["S"], dh0_floor=floor) if with_S else {}
        return cvar_pl.setup_cvar_ipm(
            cplan, tsb["A"], tsb["Bm"], tsb["dh"], tsb["h0"], tsb["x_lin"], tsb["u_lin"],
            tsb["p"], params.Q, params.R, params.Qslack, inputs["xRef"], ralpha, params.Fx,
            inputs["bx"] if with_S else params.bx, params.Fu, params.bu, cfg, **kw)

    # one iteration, on the port's own constants and carries, through JAX's body
    iters = {}
    for gz in (0, 2):
        cfg = CVaRIPMConfig(iters=SOLVE_ITERS, gondzio=gz)
        jcfg = JCVaRIPMConfig(iters=SOLVE_ITERS, gondzio=gz)
        su_S, su_0 = setups(cfg, True), setups(cfg, False)
        plain = cvar_pl.make_cvar_iteration(cplan, cfg, su_S.dims)
        jiter = jax.jit(jcv.make_cvar_iteration(jplan, jcfg, su_S.dims))
        for name, su in (("S", su_S), ("noS", su_0)):
            carries = {"init": su.carry0}
            c = su.carry0
            for itv in range(3):
                c = plain(*su.in_args, itv, *c)[:cvar_pl.CARRY_FIELDS]
            carries["iter4"] = c
            for cname, cy in carries.items():
                for itv in (3, 7):              # both sides of early_iters = 6
                    jout = jiter(*map(_np, su.in_args), jnp.full((1, 1), float(itv)),
                                 *map(_np, cy))
                    iters[(gz, name, cname, itv)] = (su, cy, plain, [np.asarray(o) for o in jout])
    # the full solve through JAX's driver
    jcfg = JCVaRIPMConfig(iters=SOLVE_ITERS, gondzio=2)
    jsolve = jax.jit(lambda A, Bm, dh, h0, x, u, p, xr, bxx, SS, fl: jcv.cvar_ipm_solve_pl(
        jplan, A, Bm, dh, h0, x, u, p, params.Q, params.R, params.Qslack, xr, ralpha, params.Fx,
        bxx, params.Fu, params.bu, cfg=jcfg, use_pallas=False, S_bl=SS, dh0_floor=fl))
    jres = jsolve(*(_np(tsb[k]) for k in ("A", "Bm", "dh", "h0", "x_lin", "u_lin", "p")),
                  _np(inputs["xRef"]), _np(inputs["bx"]), _np(inputs["S"]), _np(floor))
    return dict(inputs=inputs, cplan=cplan, iters=iters, jres=jres, jplan=jplan)


def _scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_static_maps_identical(case):
    for quirks in (True, False):
        jp = j_build_cvar_plan(j_build_topology(N, 2, 3, 4, 2), replicate_quirks=quirks)
        tp = build_cvar_plan(build_topology(N, 2, 3, 4, 2), replicate_quirks=quirks)
        for a, b in zip(jcv._static_maps(jp, 0.9), cvar_pl._static_maps(tp, 0.9)):
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("key", [(gz, s, c, itv) for gz in (0, 2) for s in ("S", "noS")
                                 for c in ("init", "iter4") for itv in (3, 7)],
                         ids=lambda k: "-".join(map(str, k)))
def test_iterate_matches_jax(case, key):
    """One fused iteration: every output field within 1e-10 of its magnitude."""
    su, cy, plain, jout = case["iters"][key]
    out = plain(*su.in_args, key[3], *cy)
    for name, a, b in zip(CVAR_NAMES, out, jout):
        err = _scaled(a.numpy(), b)
        assert err <= ITER_TOL, (name, err)


def test_transform_constants(case):
    """The per-lane constants that the merge transform builds: the cone
    quadratic SᵀQS, and the dh[0] floor on exactly the lanes it is asked for."""
    inp = case["inputs"]
    p = inp["params"]
    su = cvar_pl.setup_cvar_ipm(
        case["cplan"], *(inp["tsb"][k] for k in ("A", "Bm", "dh", "h0", "x_lin", "u_lin", "p")),
        p.Q, p.R, p.Qslack, inp["xRef"], inp["ralpha"], p.Fx, inp["bx"], p.Fu, p.bu,
        CVaRIPMConfig(), S_bl=inp["S"], dh0_floor=inp["floor"])
    consts = dict(zip(cvar_pl.CONST_ORDER, su.in_args))
    S = _np(inp["S"])
    np.testing.assert_allclose(consts["QxC"].numpy(), np.einsum("jit,jk,klt->ilt", S, p.Q, S),
                               rtol=0, atol=1e-12)
    d0 = _np(inp["tsb"]["dh"])[:, 0]
    floored = np.sign(d0) * np.maximum(0.1, np.abs(d0))
    want = np.where(_np(inp["floor"])[None], floored, d0)
    assert np.array_equal(consts["dh"].numpy()[:, 0], want)


def test_solve_matches_jax(case):
    """The solve driver with per-lane S, bx and dh[0] floor against JAX's
    (Gondzio=2): every gap to rtol 1e-8, then u < 1e-7, x < 1e-6 and the
    objective."""
    inp = case["inputs"]
    p = inp["params"]
    x, u, s, r, aux = cvar_pl.cvar_ipm_solve_pl(
        case["cplan"], *(inp["tsb"][k] for k in ("A", "Bm", "dh", "h0", "x_lin", "u_lin", "p")),
        p.Q, p.R, p.Qslack, inp["xRef"], inp["ralpha"], p.Fx, inp["bx"], p.Fu, p.bu,
        CVaRIPMConfig(iters=SOLVE_ITERS, gondzio=2), S_bl=inp["S"], dh0_floor=inp["floor"])
    jx, ju, js, jr, jaux = case["jres"]
    np.testing.assert_allclose(aux["gaps"].numpy(), np.asarray(jaux["gaps"]), rtol=1e-8,
                               atol=1e-10)
    assert np.abs(u.numpy() - np.asarray(ju)).max() < 1e-7
    assert np.abs(x.numpy() - np.asarray(jx)).max() < 1e-6
    assert np.abs(s.numpy() - np.asarray(js)).max() < 1e-6
    assert np.abs(r.numpy() - np.asarray(jr)).max() < 1e-6
    assert np.abs(aux["J"].numpy() - np.asarray(jaux["J"])).max() < 1e-7


def test_config_defaults_match_jax():
    assert dataclasses.asdict(CVaRIPMConfig()) == dataclasses.asdict(JCVaRIPMConfig())
