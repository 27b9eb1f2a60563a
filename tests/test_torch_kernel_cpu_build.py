"""The CUDA kernel's source, compiled for the CPU, against the plain version.

The kernel (``belief_planning_tpu_torch/csrc/tree_qp_ipm_iter.cu``) runs only
on a card: a warp per tree, warp barriers and shuffles, dynamic shared memory
and a persistent grid. ``STUB`` of ``test_torch_cvar_kernel_cpu_build.py``
emulates those with one fiber per CUDA thread, so g++ builds the
source into a shared library that the same ctypes interface drives on CPU
tensors; device d is an emulated card of d + 1 SMs. This holds the kernel
source's iteration against ``make_iteration`` on real QP data (N=4, NB=2,
Gondzio=2), and its profile phases 0 and 1 against ``make_phase``: f64 to
1e-10 of each field's magnitude (g++ without FMA contraction). Also at B=1,
at a B that leaves the last round of a block part-full, in blocks of 2 trees
spread over 4 emulated SMs, and with trees of one block that take different
per-tree decisions. The quadruped's two instantiations, (3, 3, 1, 6) (its
solve, one inert padded row) and (3, 3, 0, 6) (no state row, a null Fx),
are built the same way and held to the plain version at N=5 with the rate
coupling Dab2 non-zero, including ragged batches and the phase kernels.
The builds stay in the test's temporary directory.
``tests/test_torch_soc_kernel_cpu_build.py`` takes ``STUB`` from here.
"""

import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from belief_planning_tpu_torch.solvers import tree_qp_pl as tpl
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

from tests.test_torch_cuda import ITER_TOL, NAMES, qp_data, quad_setup
from tests.test_torch_cvar_kernel_cpu_build import SMEM, SMEM_EMU, STUB

torch.set_num_threads(1)

LAUNCH = re.compile(r"(tree_qp_kernel<[^<>;]*>)\s*<<<([^,]+),([^,]+),([^,]+),[^;]*>>>\(P\);")
LOOP = r"emu_launch(\2,\3,\4, [&P] { \1(P); });"


def build_cpu_kernel(out_dir: Path, source: str, flags=("-O1", "-ffp-contract=off"),
                     dims=tpl.KERNEL_DIMS[0]):
    """g++ build of the kernel source with ``STUB``, instantiated for
    ``dims`` = (n, d, nFx, nFu); returns the bound library. Asserts the
    build is clean (no warning)."""
    gxx = shutil.which("g++")
    assert len(LAUNCH.findall(source)) == 3, "the three kernel launch statements not found"
    assert SMEM.search(source), "dynamic shared memory declaration not found"
    (out_dir / "cuda_runtime.h").write_text(STUB)
    (out_dir / "k.cpp").write_text(SMEM.sub(SMEM_EMU, LAUNCH.sub(LOOP, source)))
    r = subprocess.run([gxx, *flags, *tpl.dims_defines(dims),
                        "-std=c++20", "-pthread", "-shared", "-fPIC", "-Wall",
                        "-Wno-unknown-pragmas", "-I", str(out_dir), "-o", str(out_dir / "k.so"),
                        str(out_dir / "k.cpp")], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "warning" not in r.stderr, r.stderr[-4000:]
    return tpl.bind_kernel_library(ctypes.CDLL(str(out_dir / "k.so")))


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    return build_cpu_kernel(tmp_path_factory.mktemp("kernel_cpu"), tpl.KERNEL_SOURCE.read_text())


def qp_setup(B=None, cfg=QPIPMConfig(iters=6, gondzio=2)):
    """The fused solve's setup on :func:`qp_data` (f64), with its lanes
    repeated to ``B`` trees and every repeat's multipliers scaled by its own
    factor, so that no two trees are the same: ``(plan, cfg, mtot, setup)``."""
    params, plan, cost_bl, tsb = qp_data()
    su = tpl.setup_ipm(plan, cost_bl, tsb["A"], tsb["Bm"], tsb["dh"], tsb["h0"],
                       params.Fx, params.bx, params.Fu, params.bu, tsb["x"], tsb["u"], cfg)
    mtot = float(plan.topo.totalu * 14)
    if B is not None:
        Z = su.carry0[0].shape[-1]
        idx = torch.arange(B) % Z
        scale = 1.0 + 0.01 * torch.arange(B, dtype=torch.float64)
        shared = {"Fx", "Fu", "bu"}
        consts = [c if n in shared else c[..., idx].contiguous()
                  for n, c in zip(tpl.CONST_ORDER, su.const_args)]
        carry = [c[..., idx] * (scale if n.startswith("lam") else 1.0)
                 for n, c in zip(tpl.CARRY_ORDER, su.carry0)]
        su = su._replace(const_args=consts, carry0=tuple(c.contiguous() for c in carry))
    return plan, cfg, mtot, su


def run_cpu_kernel(lib, plan, cfg, mtot, consts, carry, device=0, phase=None):
    """One launch of the CPU build on CPU tensors, on the emulated card
    ``device`` (``device + 1`` SMs): the iteration (new carry and gap) or
    phase kernel 0 / 1 (t0, null carry outputs). The scratch starts as NaN,
    so a read before a write shows. The row counts are those of ``consts``'
    Fx and Fu (an empty Fx passes a null pointer, which the kernel must not
    read)."""
    ints = tpl.kernel_ints(plan, cfg, consts[tpl.CONST_ORDER.index("Fx")].shape[0],
                           consts[tpl.CONST_ORDER.index("Fu")].shape[0])
    dtype = carry[0].dtype
    Z = carry[0].shape[-1]
    kplan = tpl.kernel_plan(lib, ints, Z, dtype, device)
    assert kplan["sms"] == device + 1 and kplan["blocks"] <= kplan["sms"]
    scratch = torch.full((kplan["scratch_elems"],), float("nan"), dtype=dtype)
    gap = torch.empty((1, Z), dtype=dtype)
    dbl = tpl.kernel_scalars(cfg, mtot, dtype)
    if phase is None:
        outs = [torch.empty_like(c) for c in carry]
        ptrs = [t.data_ptr() for t in (*consts, *carry, *outs, gap, scratch)]
        fn = lib.bp_tree_qp_iter_f64 if dtype == torch.float64 else lib.bp_tree_qp_iter_f32
        lead = ()
    else:
        outs = []
        ptrs = [t.data_ptr() for t in (*consts, *carry)] + [0] * len(carry) \
            + [gap.data_ptr(), scratch.data_ptr()]
        dbl[2] = tpl.phase_w_max(cfg)
        fn = lib.bp_tree_qp_phase_f64 if dtype == torch.float64 else lib.bp_tree_qp_phase_f32
        lead = (phase,)
    err = fn(*lead, (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
             (ctypes.c_double * len(dbl))(*dbl), Z, device, None)
    assert err == 0
    return (*outs, gap)


def _assert_matches(got, ref, what):
    for name, a, b in zip(NAMES, got, ref):
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err <= ITER_TOL, (name, what, err)


@pytest.mark.parametrize("phase", [0, 1])
def test_phase_kernels_match_plain(cpu_kernel, phase):
    """The profile's phase 0 (Σ K + Σ Hinv) and phase 1 (Σ dx + Σ du) of the
    source against their plain versions, at 1e-10 of each value's magnitude."""
    plan, cfg, mtot, su = qp_setup()
    (got,) = run_cpu_kernel(cpu_kernel, plan, cfg, mtot, su.const_args, su.carry0, phase=phase)
    ref = tpl.make_phase(plan, cfg, 4, 4, mtot, phase)(*su.const_args, *su.carry0)
    assert got.shape == ref.shape == (1, su.carry0[0].shape[-1])
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    assert err <= ITER_TOL, (phase, err)


@pytest.mark.parametrize("advance", [0, 3])
def test_kernel_source_matches_plain(cpu_kernel, advance):
    plan, cfg, mtot, su = qp_setup()
    plain = tpl.make_iteration(plan, cfg, 4, 4, mtot)
    carry = su.carry0
    for _ in range(advance):
        carry = plain(*su.const_args, *carry)[:tpl.CARRY_FIELDS]
    got = run_cpu_kernel(cpu_kernel, plan, cfg, mtot, su.const_args, carry)
    _assert_matches(got, plain(*su.const_args, *carry), advance)


@pytest.mark.parametrize("B,device,shape", [(1, 0, (1, 1)), (11, 0, (7, 1)), (7, 3, (2, 4))])
def test_kernel_source_matches_plain_at_ragged_batches(cpu_kernel, B, device, shape):
    """B=1 (one team in one block); B=11 on one emulated SM, 7 trees a
    block (as many as f64 shared memory holds at this size), so the block
    takes two rounds, the second with 4 of its 7 trees;
    B=7 on 4 emulated SMs: 2 trees a block over 4 blocks (the card's launch
    shape at B=256), the last block with one tree past B. The teams past B
    neither read nor write and stall no barrier."""
    plan, cfg, mtot, su = qp_setup(B)
    kplan = tpl.kernel_plan(cpu_kernel, tpl.kernel_ints(plan, cfg, 4, 4), B, torch.float64,
                            device)
    assert (kplan["trees_per_block"], kplan["blocks"]) == shape
    got = run_cpu_kernel(cpu_kernel, plan, cfg, mtot, su.const_args, su.carry0, device)
    assert all(g.shape[-1] == B for g in got)
    plain = tpl.make_iteration(plan, cfg, 4, 4, mtot)
    _assert_matches(got, plain(*su.const_args, *su.carry0), B)


def test_trees_of_one_block_take_their_own_decisions(cpu_kernel):
    """One block of 8 trees: tree 2's multipliers are scaled so that its gap
    is under gap_tol, so it freezes (its carry stays), while the others step;
    every tree matches the plain version."""
    plan, cfg, mtot, su = qp_setup(8)
    carry = [c.clone() for c in su.carry0]
    for i, name in enumerate(tpl.CARRY_ORDER):
        if name.startswith("lam"):
            carry[i][..., 2] *= 1e-12
    plain = tpl.make_iteration(plan, cfg, 4, 4, mtot)
    ref = plain(*su.const_args, *carry)
    gap = ref[-1][0]
    assert gap[2] < cfg.gap_tol and bool((gap[[0, 1, 3]] > cfg.gap_tol).all())
    got = run_cpu_kernel(cpu_kernel, plan, cfg, mtot, su.const_args, carry)
    _assert_matches(got, ref, "decisions")
    assert all(torch.equal(g[..., 2], c[..., 2]) for g, c in zip(got, carry))
    assert not torch.equal(got[1][..., 0], carry[1][..., 0])


def test_phase_entry_takes_only_phases_0_and_1(cpu_kernel):
    """Phase 2, the full iteration, is launched through the main entry point
    alone; the phase entry point refuses it and any other number."""
    plan, cfg, mtot, su = qp_setup()
    for phase in (2, -1, 3):
        with pytest.raises(AssertionError):
            run_cpu_kernel(cpu_kernel, plan, cfg, mtot, su.const_args, su.carry0, phase=phase)


def test_kernel_rejects_bad_level_table(cpu_kernel):
    _, plan, _, _ = qp_data()
    ints = tpl.kernel_ints(plan, QPIPMConfig(), 4, 4)
    assert tpl.kernel_plan(cpu_kernel, ints, 4, torch.float64, 0)["scratch_elems"] > 0
    for pos, val in ((8, ints[8] + 1), (4, 3), (5, 5)):   # branch count, nFx=3, nFu=5
        bad = list(ints)
        bad[pos] = val
        with pytest.raises(ValueError):
            tpl.kernel_plan(cpu_kernel, bad, 4, torch.float64, 0)


# ---- the quadruped's instantiations: n=3, d=3, nFu=6, nFx 1 (the solve's, one
# inert row) or 0 (the collision row alone), N=5 (31 stages), a non-zero rate
# coupling Dab2 from dR ----------------------------------------------------------

QUAD_DIMS = [dm for dm in tpl.KERNEL_DIMS if dm[0] == 3]


@pytest.fixture(scope="module")
def quad_kernels(tmp_path_factory):
    """The g++ builds of both quadruped instantiations, side by side."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    src = tpl.KERNEL_SOURCE.read_text()
    with ThreadPoolExecutor(len(QUAD_DIMS)) as ex:
        libs = ex.map(lambda dm: build_cpu_kernel(tmp_path_factory.mktemp("quad"), src, dims=dm),
                      QUAD_DIMS)
        return dict(zip(QUAD_DIMS, libs))


def quad_case(dims, B):
    """:func:`tests.test_torch_cuda.quad_setup` with its B=6 lanes repeated
    to ``B`` trees, each repeat's multipliers scaled by its own factor."""
    plan, cfg, mtot, su = quad_setup(dims[2])
    idx = torch.arange(B) % su.carry0[0].shape[-1]
    scale = 1.0 + 0.01 * torch.arange(B, dtype=torch.float64)
    consts = [c if n in ("Fx", "Fu", "bu") else c[..., idx].contiguous()
              for n, c in zip(tpl.CONST_ORDER, su.const_args)]
    carry = tuple((c[..., idx] * (scale if n.startswith("lam") else 1.0)).contiguous()
                  for n, c in zip(tpl.CARRY_ORDER, su.carry0))
    return plan, cfg, mtot, consts, carry


@pytest.mark.parametrize("dims", QUAD_DIMS, ids=str)
@pytest.mark.parametrize("B,device,advance", [(6, 0, 0), (6, 0, 3), (11, 0, 0), (7, 3, 0)])
def test_quadruped_source_matches_plain(quad_kernels, dims, B, device, advance):
    """f64 at 1e-10 of each field's magnitude, at the first iteration and a
    later one; B=11 on one emulated SM leaves the last round part-full, B=7
    over 4 emulated SMs is the card's B=256 shape. With nFx=0 the Fx pointer
    is null."""
    plan, cfg, mtot, consts, carry = quad_case(dims, B)
    plain = tpl.make_iteration(plan, cfg, dims[2], dims[3], mtot)
    for _ in range(advance):
        carry = plain(*consts, *carry)[:tpl.CARRY_FIELDS]
    got = run_cpu_kernel(quad_kernels[dims], plan, cfg, mtot, consts, carry, device)
    _assert_matches(got, plain(*consts, *carry), (dims, B, device, advance))


@pytest.mark.parametrize("dims", QUAD_DIMS, ids=str)
@pytest.mark.parametrize("phase", [0, 1])
def test_quadruped_phase_kernels_match_plain(quad_kernels, dims, phase):
    plan, cfg, mtot, consts, carry = quad_case(dims, 6)
    (got,) = run_cpu_kernel(quad_kernels[dims], plan, cfg, mtot, consts, carry, phase=phase)
    ref = tpl.make_phase(plan, cfg, dims[2], dims[3], mtot, phase)(*consts, *carry)
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    assert err <= ITER_TOL, (dims, phase, err)


@pytest.mark.parametrize("dims", QUAD_DIMS, ids=str)
def test_quadruped_build_takes_only_its_dims(quad_kernels, dims):
    """Each library plans its own dims and refuses the overtake's, the other
    quadruped set's and a negative row count."""
    plan, cfg, _, _, _ = quad_case(dims, 6)
    lib = quad_kernels[dims]
    ints = tpl.kernel_ints(plan, cfg, dims[2], dims[3])
    assert tpl.kernel_plan(lib, ints, 4, torch.float64, 0)["scratch_elems"] > 0
    _, oplan, _, _ = qp_data()
    for bad in (tpl.kernel_ints(oplan, cfg, 4, 4), tpl.kernel_ints(plan, cfg, 1 - dims[2], 6),
                tpl.kernel_ints(plan, cfg, -1, 6)):
        with pytest.raises(ValueError):
            tpl.kernel_plan(lib, bad, 4, torch.float64, 0)
