"""The port's cone-ADMM CVaR solver against the JAX package's, in f64:

- ``_psd_sqrt`` to 1e-12, on matrices with a zero and a repeated eigenvalue;
- ``_proj_soc_batch`` (the plain version of the kernel ``csrc/proj_soc.cu``)
  to 1e-15 of each input row's magnitude, tie rows included (‖u‖ = t, ‖u‖ = −t,
  u = 0 with t < 0, t = 0);
- ``cvar_solve`` on the CVaR overtake (N=3, NB=1, m=3, ralpha 0.9), 2
  trees, without ``S`` and with a shared ``S`` and a per-tree dh[0] floor:
  x, u, s, t, risk, z4, y4, ``prim_res`` and ``J`` within 1e-9 of their
  magnitude after ``iters=2`` (three ADMM iterations), and within 1e-7
  after ``iters=30``.

The solve is sensitive to rounding: its Woodbury correction cancels large
terms, so a first iteration already parts by ~2e-10 between any two
implementations, and later iterations amplify that. The JAX package's own
jitted and eager runs of this problem part by 4.6e-10 after ``iters=2``,
9.8e-10 after 4 and 2.7e-8 after 30, the port from the jitted run by
4.9e-10 / 1.4e-9 / 1.9e-8 (``scripts/torch_port_admm_chaos.py``). So the
1e-9 bar holds at ``iters=2``; after 30 iterations, once the cones and
sign rows have settled, the bar is 1e-7: above the reference's own spread,
far below what a wrong dual update, relaxation or clamp moves.
The JAX side is jitted once per case in a module fixture."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu.solvers.cvar import CVaRConfig as JCVaRConfig
from belief_planning_tpu.solvers.cvar import _proj_soc_batch as j_proj_soc_batch
from belief_planning_tpu.solvers.cvar import _psd_sqrt as j_psd_sqrt
from belief_planning_tpu.solvers.cvar import build_cvar_plan as j_build_cvar_plan
from belief_planning_tpu.solvers.cvar import cvar_solve as j_cvar_solve
from belief_planning_tpu.tree.engine import build_tree as j_build_tree
from belief_planning_tpu.tree.topology import build_topology as j_build_topology

from belief_planning_tpu_torch.convert import convert_cvar_config, convert_tree_state
from belief_planning_tpu_torch.ops.soc import proj_soc
from belief_planning_tpu_torch.solvers.cvar import (
    _proj_soc_batch,
    _psd_sqrt,
    build_cvar_plan,
    cvar_solve,
)
from belief_planning_tpu_torch.tree.topology import build_topology

from tests.test_torch_cuda import soc_rows
from tests.test_tree_qp import overtake_setup

torch.set_num_threads(1)

SOLVE_TOL = {2: 1e-9, 30: 1e-7}
N, NB, B, RALPHA = 3, 1, 2, 0.9
FIELDS = ["x", "u", "s", "t", "risk", "z4", "y4", "prim_res", "J"]


@pytest.fixture(scope="module")
def solves():
    """Both cases through both packages: (JAX, port) outputs by case."""
    cons, pset, model, params = overtake_setup(N=N, NB=NB)
    topo = j_build_topology(N, NB, model.m, 4, 2)
    jcplan = j_build_cvar_plan(topo)
    rng = np.random.default_rng(41)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
    zs = np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.5, (B, 4))
    u_lin = rng.normal(0, [0.5, 0.05], (B, topo.totalu, 2))
    S = np.eye(4)
    S[1, 0] = -0.15
    floor = np.arange(B) % 2 == 0
    cplan = build_cvar_plan(build_topology(N, NB, model.m, 4, 2))
    ts = jax.jit(jax.vmap(lambda x, z, ul: j_build_tree(model, topo, x, z, ul, pset.params)))(
        xs, zs, u_lin)
    jcfg = JCVaRConfig(rho4=10.0, rho5=10.0, rho_eq=10.0, rho_sign=10.0)
    out = {}
    for case, S_, floor_ in (("no_S", None, None), ("S_floor", S, floor)):
        # one jit per case serves every iteration count (a traced loop bound)
        def one(ts, x, fl, iters, S_=S_, use_floor=floor_ is not None):
            xn, un, sn, st, aux = j_cvar_solve(
                jcplan, ts, params.Q, params.R, params.Qslack, params.xRef, RALPHA,
                params.Fx, params.bx, params.Fu, params.bu, x, S=S_,
                cfg=dataclasses.replace(jcfg, iters=iters),
                dh0_floor=fl if use_floor else None)
            return {"x": xn, "u": un, "s": sn, "t": st.t, "risk": st.risk, "z4": st.z4,
                    "y4": st.y4, "prim_res": aux["prim_res"], "J": aux["J"]}

        fl_in = floor if floor_ is not None else np.zeros(B, bool)
        jsolve = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, None)))
        for iters in SOLVE_TOL:
            jres = jsolve(ts, xs, fl_in, iters)
            x, u, s, st, aux = cvar_solve(
                cplan, convert_tree_state(ts, "cpu"), params.Q, params.R, params.Qslack,
                params.xRef, RALPHA, params.Fx, params.bx, params.Fu, params.bu,
                torch.as_tensor(xs), S=S_,
                cfg=convert_cvar_config(dataclasses.replace(jcfg, iters=iters)),
                dh0_floor=None if floor_ is None else torch.as_tensor(floor_), device="cpu")
            tres = {"x": x, "u": u, "s": s, "t": st.t, "risk": st.risk, "z4": st.z4,
                    "y4": st.y4, "prim_res": aux["prim_res"], "J": aux["J"]}
            out[case, iters] = (jres, tres)
    return out


@pytest.mark.parametrize("iters", sorted(SOLVE_TOL))
@pytest.mark.parametrize("case", ["no_S", "S_floor"])
def test_cvar_solve_matches_jax(solves, case, iters):
    jres, tres = solves[case, iters]
    for f in FIELDS:
        want = np.asarray(jres[f])
        got = tres[f].numpy()
        assert got.shape == want.shape, (f, got.shape, want.shape)
        assert np.isfinite(got).all(), f
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
        assert err <= SOLVE_TOL[iters], (case, iters, f, err)


def test_psd_sqrt_matches_jax():
    rng = np.random.default_rng(42)
    V, _ = np.linalg.qr(rng.normal(size=(4, 4)))
    mats = [np.diag([0.0, 3.0, 3.0, 10.0]),                     # the overtake's Q
            V @ np.diag([2.0, 2.0, 5.0, 0.0]) @ V.T,            # repeated, rotated
            np.diag([1.0, 100.0])]
    for M in mats:
        want = np.asarray(j_psd_sqrt(jnp.asarray(M)))
        got = _psd_sqrt(torch.as_tensor(M)).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        np.testing.assert_allclose(got @ got, M, atol=1e-12 * np.abs(M).max())


def test_proj_soc_batch_matches_jax():
    v = soc_rows(np.random.default_rng(43))
    want = np.asarray(j_proj_soc_batch(jnp.asarray(v)))
    got = _proj_soc_batch(torch.as_tensor(v)).numpy()
    row_mag = np.abs(v).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 1e-15 * np.maximum(row_mag, 1e-300)).all()
    np.testing.assert_array_equal(got[-6:-3], want[-6:-3])   # kept / zeroed exactly
    assert np.array_equal(got[-5], np.zeros(8)) and np.array_equal(got[-4], np.zeros(8))


def test_proj_soc_on_cpu_is_the_plain_version():
    v = torch.as_tensor(soc_rows(np.random.default_rng(44)))
    assert torch.equal(proj_soc(v), _proj_soc_batch(v))
