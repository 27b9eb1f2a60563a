"""The CUDA kernels (K1 with its profile phases, K2, the SOC projection, the
shared-row probe K5) against their plain PyTorch versions on the card, the
wrappers' checks, and the independent IPM solvers on the card against the
CPU.
Needs a CUDA card (skips without one) and no JAX, so on a machine with the
card and without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Also holds the JAX-free QP and CVaR data builders that the other port tests
share."""

import numpy as np
import pytest
import torch

from belief_planning_tpu_torch.envs.batched_merge import draw_merge_worlds, merge_lane_inputs
from belief_planning_tpu_torch.models.policies import (
    cast_params,
    highway_policy_set,
    merge_policy_set,
    quadruped_policy_set,
)
from belief_planning_tpu_torch.models.predictive import highway_model, merge_model, quadruped_model
from belief_planning_tpu_torch.ops import shared_rows as sr
from belief_planning_tpu_torch.ops import soc
from belief_planning_tpu_torch.presets import init_branch_mpc, init_quad_branch_mpc
from belief_planning_tpu_torch.solvers import cvar_pl
from belief_planning_tpu_torch.solvers import tree_qp_pl as tpl
from belief_planning_tpu_torch.solvers.cvar import _proj_soc_batch, build_cvar_plan
from belief_planning_tpu_torch.solvers.cvar_ipm import CVaRIPMConfig, cvar_ipm_solve
from belief_planning_tpu_torch.solvers.layout import _to_bl, cost_to_bl
from belief_planning_tpu_torch.solvers.tree_qp import assemble_stage_cost, build_stage_plan
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig, qp_ipm_solve
from belief_planning_tpu_torch.tree.engine import build_tree
from belief_planning_tpu_torch.tree.topology import build_topology
from belief_planning_tpu_torch.utils.config import BranchConstants, QuadConstants

torch.set_num_threads(1)

N, NB, B = 4, 2, 6
ITER_TOL = 1e-10          # one fused iteration, scaled by the field's magnitude
GONDZIO = 2
NAMES = tpl.CARRY_ORDER + ["gap"]


def qp_batch(device="cpu"):
    """Real QP data from the port's tree build and cost assembly, f64,
    batch-leading: ``(params, plan, cost, ts, xs)``."""
    cons = BranchConstants()
    xRef = np.array([0.5, 1.8, 15.0, 0.0])
    model = highway_model(cons, highway_policy_set(cons, xRef), N=N, dt=0.1)
    params = init_branch_mpc(4, 2, N, NB, xRef, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    topo = build_topology(N, NB, 3, 4, 2)
    rng = np.random.default_rng(21)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, [0.3, 0.3, 1.0, 0.05], (B, 4))
    zs = np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, [1.0, 0.5, 1.0, 0.05], (B, 4))
    f64 = torch.float64
    t = lambda a: torch.as_tensor(a, dtype=f64, device=device)
    ts = build_tree(model, topo, t(xs), t(zs),
                    torch.zeros(B, topo.totalu, 2, dtype=f64, device=device),
                    cast_params(highway_policy_set(cons, xRef).params, f64, device))
    cost = assemble_stage_cost(topo, ts, params.Q, params.R, params.Qf, params.dR, params.Qslack,
                               t(np.tile([0.0, 1.8, 18.0, 0.0], (B, 1))),
                               torch.zeros(B, 2, dtype=f64, device=device))
    return params, build_stage_plan(topo), cost, ts, t(xs)


def qp_data(dtype=torch.float64, device="cpu"):
    """:func:`qp_batch`'s data cast to ``dtype``, batch-last: ``(params,
    plan, cost_bl, batch-last tree arrays)``."""
    params, plan, cost, ts, _ = qp_batch(device)
    cost = type(cost)(*(c.to(dtype) for c in cost))
    bl = lambda a: _to_bl(a.to(dtype))
    return params, plan, cost_to_bl(cost), \
        dict(A=bl(ts.A), Bm=bl(ts.Bm), C=bl(ts.C), dh=bl(ts.dh), h0=bl(ts.h0),
             x=bl(ts.x_lin), u=bl(ts.u_lin))


QUAD_N = 5


def quad_problem(B=B, N=QUAD_N, seed=0, device="cpu"):
    """The quadruped's reference configuration (``scripts/bench_configs.py:
    193-222``: v0 = 0.2, dt = 0.2, NB=2) at horizon N, with B states drawn
    as there: ``(cons, pset, model, params, xs, zs, xRefs)``, f64."""
    cons = QuadConstants()
    pset = quadruped_policy_set(0.2)
    model = quadruped_model(cons, pset, N=N, dt=0.2)
    xRef = np.array([5.0, 5.0, 0.0])
    params = init_quad_branch_mpc(3, 3, N, 2, xRef, cons.vxm, cons.vym, cons.rm)
    rng = np.random.default_rng(seed)
    xs = np.array([0.0, 1.8, 0.0]) + rng.normal(0, 0.3, (B, 3))
    zs = np.array([2.5, 2.5, -np.pi / 2]) + rng.normal(0, 0.3, (B, 3))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    return cons, pset, model, params, t(xs), t(zs), t(np.tile(xRef, (B, 1)))


def quad_setup(nFx, dtype=torch.float64, device="cpu", B=B, N=QUAD_N):
    """K1's inputs on the quadruped's QP (tree build and cost in f64, cast to
    ``dtype``), for the instantiation with ``nFx`` state rows: 1 is the
    solve's (its empty Fx padded to one inert row by ``setup_ipm``), 0 the
    same with that row taken out again (the collision row alone). Returns
    ``(plan, cfg, mtot, setup)``; the rate cost dR makes Dab2 non-zero."""
    _, pset, model, params, xs, zs, xRefs = quad_problem(B, N, device=device)
    topo = build_topology(N, 2, 2, 3, 3)
    f64 = torch.float64
    ts = build_tree(model, topo, xs, zs, torch.zeros(B, topo.totalu, 3, dtype=f64, device=device),
                    cast_params(pset.params, f64, device))
    cost = assemble_stage_cost(topo, ts, params.Q, params.R, params.Qf, params.dR, params.Qslack,
                               xRefs, torch.zeros(B, 3, dtype=f64, device=device))
    cost = cost_to_bl(type(cost)(*(c.to(dtype) for c in cost)))
    bl = lambda a: _to_bl(a.to(dtype))
    plan = build_stage_plan(topo)
    cfg = QPIPMConfig(iters=8, gondzio=GONDZIO)
    su = tpl.setup_ipm(plan, cost, bl(ts.A), bl(ts.Bm), bl(ts.dh), bl(ts.h0), params.Fx,
                       params.bx, params.Fu, params.bu, bl(ts.x_lin), bl(ts.u_lin), cfg)
    if nFx == 0:
        rows = {"s", "sl1", "lam1", "sl3", "lam3", "b1"}
        one = lambda n, c: c[:, :1].contiguous() if n in rows else (c[:0] if n == "Fx" else c)
        su = su._replace(const_args=[one(n, c) for n, c in zip(tpl.CONST_ORDER, su.const_args)],
                         carry0=tuple(one(n, c) for n, c in zip(tpl.CARRY_ORDER, su.carry0)),
                         step_fn=None)
    mtot = float(topo.totalu * (2 * (nFx + 1) + 6))
    return plan, cfg, mtot, su


CVAR_NAMES = cvar_pl.CARRY_ORDER + ["gap"]


def cvar_problem(kind, N=3, NB=1, B=4, seed=0, device="cpu"):
    """A small CVaR problem of either configuration, JAX-free, built in f64:
    ``(params, cons, pset, model, ralpha, xs, zs, xRefs, S, bx, floor)``.

    ``"merge"``: the merge deployment (m=2, ralpha=0.1), worlds drawn as the
    reference's ``init_worlds``, per-lane shear ``S`` and bounds ``bx`` of
    the ramp, and the dh[0] floor on every other lane. ``"overtake"``: the
    CVaR overtake (m=3, ralpha=0.9), states drawn as ``bench_cvar.py``,
    shared bounds and no transform."""
    from belief_planning_tpu_torch.utils.config import BranchConstants, QuadConstants

    f64 = torch.float64
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=f64, device=device)
    if kind == "merge":
        cons = BranchConstants(am=7.0)
        pset = merge_policy_set(cons, 20.0, None)
        model = merge_model(cons, pset, N=N, dt=0.1)
        params = init_branch_mpc(4, 2, N, NB, np.array([0.5, 1.8, 15.0, 0.0]), am=7.0,
                                 rm=0.3, N_lane=2, W=cons.W)
        xs, zs = draw_merge_worlds(B, seed)
        _, S, xRefs, bx = merge_lane_inputs(t(xs), torch.zeros(B, dtype=torch.bool,
                                                                device=device), params.bx, cons.W)
        floor = torch.arange(B, device=device) % 2 == 0
        return params, cons, pset, model, 0.1, t(xs), t(zs), xRefs, S, bx, floor
    cons = BranchConstants()
    xt = np.array([0.5, 1.8, 15.0, 0.0])
    pset = highway_policy_set(cons, xt)
    model = highway_model(cons, pset, N=N, dt=0.1)
    params = init_branch_mpc(4, 2, N, NB, xt, am=6.0, rm=0.3, N_lane=4, W=cons.W)
    rng = np.random.default_rng(seed)
    xs = np.array([0.0, 1.8, 20.0, 0.0]) + rng.normal(0, 0.2, (B, 4))
    zs = np.array([9.0, 1.8, 17.0, 0.0]) + rng.normal(0, 0.5, (B, 4))
    xRefs = np.tile([0.0, 1.8, 18.0, 0.0], (B, 1))
    return params, cons, pset, model, 0.9, t(xs), t(zs), t(xRefs), None, None, None


def cvar_setup(kind, dtype=torch.float64, device="cpu", N=3, NB=1, B=4, gondzio=GONDZIO,
               iters=8):
    """The fused CVaR solve's real inputs for :func:`cvar_problem`: tree
    build in f64, cast to ``dtype``, then the solver's setup. Returns
    ``(cplan, cfg, setup, plain iterate)``."""
    params, _, pset, model, ralpha, xs, zs, xRefs, S, bx, floor = cvar_problem(
        kind, N, NB, B, device=device)
    topo = build_topology(N, NB, model.m, 4, 2)
    cplan = build_cvar_plan(topo)
    f64 = torch.float64
    ts = build_tree(model, topo, xs, zs, torch.zeros(B, topo.totalu, 2, dtype=f64, device=device),
                    cast_params(pset.params, f64, device))
    bl = lambda a: _to_bl(a.to(dtype))
    cfg = CVaRIPMConfig(iters=iters, gondzio=gondzio)
    su = cvar_pl.setup_cvar_ipm(
        cplan, bl(ts.A), bl(ts.Bm), bl(ts.dh), bl(ts.h0), bl(ts.x_lin), bl(ts.u_lin), bl(ts.p),
        params.Q, params.R, params.Qslack, bl(xRefs), ralpha, params.Fx,
        params.bx if bx is None else bl(bx), params.Fu, params.bu, cfg,
        S_bl=None if S is None else bl(S), dh0_floor=floor)
    return cplan, cfg, su, cvar_pl.make_cvar_iteration(cplan, cfg, su.dims)


def soc_rows(rng, k=8, rows=64):
    """Random rows for the SOC projection and its tie rows."""
    v = rng.normal(size=(rows, k)) * rng.uniform(0.1, 10.0, (rows, 1))
    ties = np.zeros((6, k))
    ties[0, :3] = [5.0, 3.0, 4.0]       # ‖u‖ = t exactly: kept
    ties[1, :3] = [-5.0, 3.0, 4.0]      # ‖u‖ = −t: zeroed
    ties[2, 0] = -2.0                   # u = 0, t < 0: zeroed
    ties[3, 1:] = rng.normal(size=k - 1)   # t = 0, u ≠ 0: halved
    # ties[4]: t = 0, u = 0 (kept); ties[5]: u = 0, t > 0 (kept)
    ties[5, 0] = 1.5
    return np.concatenate([v, ties])


def _setup(dtype, device):
    params, plan, cost_bl, tsb = qp_data(dtype, device)
    cfg = QPIPMConfig(iters=6, gondzio=GONDZIO)
    su = tpl.setup_ipm(plan, cost_bl, tsb["A"], tsb["Bm"], tsb["dh"], tsb["h0"],
                       params.Fx, params.bx, params.Fu, params.bu, tsb["x"], tsb["u"], cfg)
    plain = tpl.make_iteration(plan, cfg, 4, 4, float(plan.topo.totalu * 14))
    return su, plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


def test_kernel_matches_plain_f64(cuda_device):
    """f64: every output field within 1e-10 of its magnitude; one launch."""
    su, plain = _setup(torch.float64, cuda_device)
    before = tpl.KERNEL.launches
    got = su.step_fn(*su.const_args, *su.carry0)
    assert tpl.KERNEL.launches == before + 1
    ref = plain(*su.const_args, *su.carry0)
    for name, a, b in zip(NAMES, got, ref):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= ITER_TOL, (name, err)


def test_kernel_matches_plain_f32(cuda_device):
    """f32: as accurate as the plain version in f32. Against the plain
    version in f64 on the same (upcast) inputs, the kernel's error in every
    field is at most 2 × the plain f32 version's + 1e-6 × the magnitude
    (operation order and FMA contraction differ; f32 rounding is amplified
    by the barrier-weighted factor's conditioning)."""
    su, plain = _setup(torch.float32, cuda_device)
    got = su.step_fn(*su.const_args, *su.carry0)
    ref = plain(*su.const_args, *su.carry0)
    up = lambda ts: [t.double() for t in ts]
    ref64 = plain(*up(su.const_args), *up(su.carry0))
    for name, g, r, r64 in zip(NAMES, got, ref, ref64):
        e_kernel = (g.double() - r64).abs().max().item()
        e_plain = (r.double() - r64).abs().max().item()
        assert e_kernel <= 2 * e_plain + 1e-6 * r64.abs().max().item(), name


@pytest.mark.parametrize("Bn", [1, 2001])
def test_kernel_matches_plain_at_ragged_batches(cuda_device, Bn):
    """f64 at B=1 (one tree in one block) and B=2001 (not a multiple of the
    trees a block: the last block is part-full), the lanes of the B=6 data
    repeated with each repeat's multipliers scaled apart; within 1e-10."""
    su, plain = _setup(torch.float64, cuda_device)
    idx = torch.arange(Bn, device=cuda_device) % B
    scale = 1.0 + 1e-3 * torch.arange(Bn, dtype=torch.float64, device=cuda_device)
    consts = [c if name in ("Fx", "Fu", "bu") else c[..., idx].contiguous()
              for name, c in zip(tpl.CONST_ORDER, su.const_args)]
    carry = [(c[..., idx] * (scale if name.startswith("lam") else 1.0)).contiguous()
             for name, c in zip(tpl.CARRY_ORDER, su.carry0)]
    got = su.step_fn(*consts, *carry)
    ref = plain(*consts, *carry)
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape[-1] == Bn
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= ITER_TOL, (name, Bn, err)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    su, _ = _setup(torch.float64, cuda_device)
    args = list(su.const_args) + list(su.carry0)
    bad_shape = args.copy()
    bad_shape[0] = args[0][:-1]                              # Qx2 missing a stage
    bad_dtype = args.copy()
    bad_dtype[len(tpl.CONST_ORDER)] = args[len(tpl.CONST_ORDER)].float()
    strided = args.copy()
    strided[1] = args[1].transpose(0, 1).contiguous().transpose(0, 1)   # qx, not contiguous
    cpu_const = args.copy()
    cpu_const[0] = args[0].cpu()
    before = tpl.KERNEL.launches
    for bad in (bad_shape, bad_dtype, strided, cpu_const):
        with pytest.raises(ValueError):
            su.step_fn(*bad)
    assert tpl.KERNEL.launches == before


QUAD_KERNEL_DIMS = [dm for dm in tpl.KERNEL_DIMS if dm[0] == 3]


@pytest.mark.parametrize("dims", QUAD_KERNEL_DIMS, ids=str)
@pytest.mark.parametrize("Bn", [6, 2001])
def test_quadruped_kernel_matches_plain_f64(cuda_device, dims, Bn):
    """K1 at the quadruped's dims (3, 3, nFx, 6), f64: every field within
    1e-10 of its magnitude, one launch counted at those dims; at B=2001 the
    B=6 lanes are repeated with each repeat's multipliers scaled apart."""
    plan, cfg, mtot, su = quad_setup(dims[2], device=cuda_device)
    idx = torch.arange(Bn, device=cuda_device) % B
    scale = 1.0 + 1e-3 * torch.arange(Bn, dtype=torch.float64, device=cuda_device)
    consts = [c if name in ("Fx", "Fu", "bu") else c[..., idx].contiguous()
              for name, c in zip(tpl.CONST_ORDER, su.const_args)]
    carry = [(c[..., idx] * (scale if name.startswith("lam") else 1.0)).contiguous()
             for name, c in zip(tpl.CARRY_ORDER, su.carry0)]
    before = tpl.KERNEL.dims_launches[dims]
    got = tpl.fused_iteration(plan, cfg, dims[2], 6, mtot)(*consts, *carry)
    assert tpl.KERNEL.dims_launches[dims] == before + 1
    ref = tpl.make_iteration(plan, cfg, dims[2], 6, mtot)(*consts, *carry)
    for name, a, b in zip(NAMES, got, ref):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= ITER_TOL, (name, dims, Bn, err)


@pytest.mark.parametrize("dims", QUAD_KERNEL_DIMS, ids=str)
def test_quadruped_kernel_matches_plain_f32(cuda_device, dims):
    """f32 at the quadruped's dims: as accurate as the plain version in f32
    (the bar of :func:`test_kernel_matches_plain_f32`)."""
    plan, cfg, mtot, su = quad_setup(dims[2], torch.float32, cuda_device)
    got = tpl.fused_iteration(plan, cfg, dims[2], 6, mtot)(*su.const_args, *su.carry0)
    plain = tpl.make_iteration(plan, cfg, dims[2], 6, mtot)
    ref = plain(*su.const_args, *su.carry0)
    up = lambda ts: [t.double() for t in ts]
    ref64 = plain(*up(su.const_args), *up(su.carry0))
    for name, g, r, r64 in zip(NAMES, got, ref, ref64):
        e_kernel = (g.double() - r64).abs().max().item()
        e_plain = (r.double() - r64).abs().max().item()
        assert e_kernel <= 2 * e_plain + 1e-6 * r64.abs().max().item(), (name, dims)


def test_kernel_raises_for_unbuilt_dims(cuda_device):
    """CUDA tensors at dims no library is built for raise before any launch
    (here the quadruped with nFu = 5): no plain fallback on the card."""
    plan, cfg, mtot, su = quad_setup(1, device=cuda_device)
    consts = dict(zip(tpl.CONST_ORDER, su.const_args))
    consts["Fu"], consts["bu"] = consts["Fu"][:5], consts["bu"][:, :5]
    carry = dict(zip(tpl.CARRY_ORDER, su.carry0))
    carry["sl2"], carry["lam2"] = carry["sl2"][:, :5], carry["lam2"][:, :5]
    before = tpl.KERNEL.launches
    with pytest.raises(ValueError, match="built for"):
        tpl.fused_iteration(plan, cfg, 1, 5, mtot)(*consts.values(), *carry.values())
    assert tpl.KERNEL.launches == before


@pytest.mark.parametrize("kind,NB", [("merge", 1), ("overtake", 2)])
@pytest.mark.parametrize("itv", [0, 7])
def test_cvar_kernel_matches_plain_f64(cuda_device, kind, NB, itv):
    """CVaR kernel, f64: every output field within 1e-10 of its magnitude
    (merge: per-lane S, bx and dh[0] floor); one launch."""
    cplan, cfg, su, plain = cvar_setup(kind, torch.float64, cuda_device, NB=NB)
    before = cvar_pl.KERNEL.launches
    got = su.step_fn(*su.in_args, itv, *su.carry0)
    assert cvar_pl.KERNEL.launches == before + 1
    ref = plain(*su.in_args, itv, *su.carry0)
    for name, a, b in zip(CVAR_NAMES, got, ref):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= ITER_TOL, (name, err)


@pytest.mark.parametrize("kind,NB", [("merge", 1), ("overtake", 2)])
@pytest.mark.parametrize("B", [1, 2001])
def test_cvar_kernel_matches_plain_at_ragged_batches(cuda_device, kind, NB, B):
    """CVaR kernel, f64, at B=1 and at B=2001: more trees than the
    persistent grid holds, so its blocks walk over the batch in rounds and
    the last round's block is part-full; every field within 1e-10 of its
    magnitude, one launch."""
    cplan, cfg, su, plain = cvar_setup(kind, torch.float64, cuda_device, NB=NB, B=B)
    plan = cvar_pl.KERNEL.plan(cvar_pl.kernel_ints(cplan, cfg, su.dims), B, torch.float64,
                               su.carry0[0].device.index)
    assert B == 1 or (B % plan["trees_per_block"] != 0
                      and plan["blocks"] * plan["trees_per_block"] < B)
    before = cvar_pl.KERNEL.launches
    got = su.step_fn(*su.in_args, 1, *su.carry0)
    assert cvar_pl.KERNEL.launches == before + 1
    ref = plain(*su.in_args, 1, *su.carry0)
    for name, a, b in zip(CVAR_NAMES, got, ref):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= ITER_TOL, (name, B, err)


@pytest.mark.parametrize("kind", ["merge", "overtake"])
def test_cvar_kernel_matches_plain_f32(cuda_device, kind):
    """CVaR kernel, f32: as accurate as the plain version in f32 (against the
    plain version in f64 on the same upcast inputs, the kernel's error in
    every field is at most 2 × the plain f32 version's + 1e-6 × the
    magnitude)."""
    _, _, su, plain = cvar_setup(kind, torch.float32, cuda_device)
    got = su.step_fn(*su.in_args, 0, *su.carry0)
    ref = plain(*su.in_args, 0, *su.carry0)
    up = lambda ts: [t.double() for t in ts]
    ref64 = plain(*up(su.in_args), 0, *up(su.carry0))
    for name, g, r, r64 in zip(CVAR_NAMES, got, ref, ref64):
        e_kernel = (g.double() - r64).abs().max().item()
        e_plain = (r.double() - r64).abs().max().item()
        assert e_kernel <= 2 * e_plain + 1e-6 * r64.abs().max().item(), name


def test_cvar_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    _, _, su, _ = cvar_setup("merge", torch.float64, cuda_device)
    args = list(su.in_args) + [0] + list(su.carry0)
    nc = len(cvar_pl.CONST_ORDER) + len(cvar_pl.SHARED_ORDER)
    bad_shape = args.copy()
    bad_shape[0] = args[0][:-1]                             # A_st missing a stage
    bad_dtype = args.copy()
    bad_dtype[nc + 1] = args[nc + 1].float()                # x in f32
    strided = args.copy()
    strided[2] = args[2].transpose(0, 1).contiguous().transpose(0, 1)   # dh, not contiguous
    cpu_shared = args.copy()
    cpu_shared[len(cvar_pl.CONST_ORDER)] = args[len(cvar_pl.CONST_ORDER)].cpu()   # Fu
    before = cvar_pl.KERNEL.launches
    for bad in (bad_shape, bad_dtype, strided, cpu_shared):
        with pytest.raises(ValueError):
            su.step_fn(*bad)
    assert cvar_pl.KERNEL.launches == before


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14), (torch.float32, 1e-6)])
def test_soc_kernel_matches_plain(cuda_device, dtype, tol):
    """SOC projection: every row within ``tol`` of its input row's magnitude
    (f64 1e-14, f32 1e-6), the tie rows kept or zeroed exactly; one launch."""
    v = torch.as_tensor(soc_rows(np.random.default_rng(60), rows=4000), dtype=dtype,
                        device=cuda_device)
    before = soc.KERNEL.launches
    got = soc.proj_soc(v)
    assert soc.KERNEL.launches == before + 1
    ref = _proj_soc_batch(v)
    row_mag = v.abs().amax(1, keepdim=True).clamp(min=1e-300)
    assert bool(((got - ref).abs() <= tol * row_mag).all())
    assert torch.equal(got[-6:-3], ref[-6:-3])


def test_soc_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    v = torch.ones((8, 8), dtype=torch.float64, device=cuda_device)
    before = soc.KERNEL.launches
    for bad in (v.t(), v[:, :1].expand(8, 8), v.half(), v[:0], v.reshape(4, 2, 8),
                torch.ones((8, 17), dtype=torch.float64, device=cuda_device)):
        with pytest.raises(ValueError):
            soc.proj_soc(bad)
    assert soc.KERNEL.launches == before


@pytest.mark.parametrize("phase", [0, 1])
def test_phase_kernel_matches_plain_f64(cuda_device, phase):
    """The K1 profile's phase 0 (Σ K + Σ Hinv) and phase 1 (Σ dx + Σ du)
    within 1e-10 of each value's magnitude; one launch each."""
    su, _ = _setup(torch.float64, cuda_device)
    plan = build_stage_plan(build_topology(N, NB, 3, 4, 2))
    cfg = QPIPMConfig(iters=6, gondzio=GONDZIO)
    mtot = float(plan.topo.totalu * 14)
    before = tpl.KERNEL.phase_launches
    got = tpl.phase_step(plan, cfg, 4, 4, mtot, phase)(*su.const_args, *su.carry0)
    assert tpl.KERNEL.phase_launches == before + 1
    ref = tpl.make_phase(plan, cfg, 4, 4, mtot, phase)(*su.const_args, *su.carry0)
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    assert err <= ITER_TOL, (phase, err)


def test_phase_2_is_the_main_kernel(cuda_device):
    """The profile's phase 2 launches the main path's kernel, counted as its
    launches, with the main path's result."""
    su, _ = _setup(torch.float64, cuda_device)
    plan = build_stage_plan(build_topology(N, NB, 3, 4, 2))
    cfg = QPIPMConfig(iters=6, gondzio=GONDZIO)
    mtot = float(plan.topo.totalu * 14)
    before = (tpl.KERNEL.launches, tpl.KERNEL.phase_launches)
    got = tpl.phase_step(plan, cfg, 4, 4, mtot, 2)(*su.const_args, *su.carry0)
    assert (tpl.KERNEL.launches, tpl.KERNEL.phase_launches) == (before[0] + 1, before[1])
    want = tpl.fused_iteration(plan, cfg, 4, 4, mtot)(*su.const_args, *su.carry0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _probe_inputs(device, B=4096, nodes=25, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(4, 4)), dtype=torch.float32, device=device),
            torch.as_tensor(rng.normal(size=(nodes, 4, B)), dtype=torch.float32, device=device))


@pytest.mark.parametrize("mode", sr.MODES)
def test_shared_rows_kernel_matches_plain(cuda_device, mode):
    """K5 against the plain version in f64 (64 chained products, B=4096 × 25
    nodes): fma and 3xtf32 as accurate as the plain f32 version (≤ 2 × its
    error + 1e-6 × the magnitude); bf16 within 2⁻⁷·Σ|Fx|·|cur| of every output
    and different from the f32 result. One launch."""
    Fx, dx = _probe_inputs(cuda_device)
    p64, cur = sr.shared_rows_plain(Fx.double(), dx.double(), 64, return_cur=True)
    before = dict(sr.KERNEL.launches)
    got = sr.shared_rows(Fx, dx, 64, mode)
    torch.cuda.synchronize()
    assert sr.KERNEL.launches[mode] == before[mode] + 1
    err = (got.double() - p64).abs()
    if mode == "bf16":
        bar = 2.0 ** -7 * torch.einsum("rk,nkb->nrb", Fx.double().abs(), cur.abs())
        assert bool((err <= bar).all())
        assert bool((got != sr.shared_rows_plain(Fx, dx, 64)).any())
    else:
        e_plain = (sr.shared_rows_plain(Fx, dx, 64).double() - p64).abs().max().item()
        assert err.max().item() <= 2 * e_plain + 1e-6 * p64.abs().max().item()


def test_shared_rows_fma_f64_matches_plain(cuda_device):
    Fx, dx = (t.double() for t in _probe_inputs(cuda_device, B=1000, nodes=7))
    ref = sr.shared_rows_plain(Fx, dx, 64)
    got = sr.shared_rows(Fx, dx, 64, "fma", tile=64)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-14


def test_shared_rows_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    Fx, dx = _probe_inputs(cuda_device, B=64, nodes=3)
    before = dict(sr.KERNEL.launches)
    bad = [(Fx, dx.double(), 8, "bf16", 128), (Fx, dx[:, :3], 8, "fma", 128),
           (Fx, dx.transpose(0, 2).contiguous().transpose(0, 2), 8, "fma", 128),
           (Fx.cpu(), dx, 8, "fma", 128), (Fx, dx, 0, "fma", 128), (Fx, dx, 8, "fma", 48),
           (Fx, dx, 8, "fma", 1024), (Fx.t(), dx, 8, "3xtf32", 128), (Fx, dx, 8, "bf16", 96),
           (Fx, dx, 8, "3xtf32", 32)]
    for args in bad:
        with pytest.raises(ValueError):
            sr.shared_rows(*args)
    assert sr.KERNEL.launches == before


def test_qp_ipm_solve_on_the_card_matches_the_cpu(cuda_device):
    """``qp_ipm_solve`` (f64, 2 Gondzio correctors) on the card against the
    same call on the CPU: the first 6 gaps within rtol 1e-10."""
    p, plan, cost, ts, xs = qp_batch("cpu")
    cfg = QPIPMConfig(iters=6, gondzio=2)
    args = (p.Fx, p.bx, p.Fu, p.bu, xs, torch.zeros(B, 2, dtype=torch.float64))
    on_cpu = qp_ipm_solve(plan, cost, ts, *args, cfg, device="cpu")
    on_card = qp_ipm_solve(plan, cost, ts, *args, cfg)
    assert on_card[1].is_cuda
    np.testing.assert_allclose(on_card[3]["gaps"].cpu().numpy(), on_cpu[3]["gaps"].numpy(),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kind", ["merge", "overtake"])
def test_cvar_ipm_solve_on_the_card_matches_the_cpu(cuda_device, kind):
    """``cvar_ipm_solve`` (f64, 2 Gondzio correctors) on the card against the
    same call on the CPU: the first 6 gaps within rtol 1e-10."""
    params, _, pset, model, ralpha, xs, zs, xRefs, S, bx, floor = cvar_problem(kind, 3, 1, 4)
    topo = build_topology(3, 1, model.m, 4, 2)
    ts = build_tree(model, topo, xs, zs, torch.zeros(4, topo.totalu, 2, dtype=torch.float64),
                    cast_params(pset.params, torch.float64, "cpu"))
    cfg = CVaRIPMConfig(iters=6, gondzio=2)
    args = (build_cvar_plan(topo), ts, params.Q, params.R, params.Qslack, xRefs, ralpha,
            params.Fx, params.bx if bx is None else bx, params.Fu, params.bu, xs)
    on_cpu = cvar_ipm_solve(*args, S=S, cfg=cfg, dh0_floor=floor, device="cpu")
    on_card = cvar_ipm_solve(*args, S=S, cfg=cfg, dh0_floor=floor)
    assert on_card[1].is_cuda
    np.testing.assert_allclose(on_card[4]["gaps"].cpu().numpy(), on_cpu[4]["gaps"].numpy(),
                               rtol=1e-10, atol=1e-12)
