"""The CUDA kernel's source, compiled for the CPU, against the plain version.

The kernel (``belief_planning_tpu_torch/csrc/tree_qp_ipm_iter.cu``) runs only
on a card. Its arithmetic is plain C++ apart from the CUDA keywords and the
launch, so with those stubbed (``__device__`` etc. defined away, the
``<<<…>>>`` launch replaced by a loop over blocks and threads) g++ builds it
into a shared library that the same ctypes interface drives on CPU tensors.
This holds the kernel source's iteration against ``make_iteration`` on real
QP data (N=4, NB=2, Gondzio=2), and its profile phases 0 and 1 against
``make_phase``: f64 to 1e-10 of each field's magnitude (g++ without FMA
contraction). The build stays in the test's temporary directory.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from belief_planning_tpu_torch.solvers import tree_qp_pl as tpl
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig

from tests.test_torch_cuda import ITER_TOL, NAMES, qp_data

torch.set_num_threads(1)

STUB = """#pragma once
#include <cmath>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __grid_constant__
#define __launch_bounds__(x)
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
struct EmuIdx { unsigned x; };
static EmuIdx blockIdx, threadIdx, blockDim;
using std::isfinite;
"""
LAUNCH = re.compile(r"(tree_qp_\w+_kernel<T, 4, 2(?:, \d)?>)\s*<<<[^;]*>>>\(P\);")
LOOP = (r"for (unsigned bx = 0; bx < blocks; ++bx) "
        r"for (unsigned tx = 0; tx < (unsigned)kThreads; ++tx) { blockIdx.x = bx; "
        r"threadIdx.x = tx; blockDim.x = kThreads; \1(P); }")


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("kernel_cpu")
    src = tpl.KERNEL_SOURCE.read_text()
    assert LAUNCH.search(src), "kernel launch statement not found"
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "k.cpp").write_text(LAUNCH.sub(LOOP, src))
    r = subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                        "-Wall", "-Wno-unknown-pragmas", "-I", str(d), "-o", str(d / "k.so"),
                        str(d / "k.cpp")], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "warning" not in r.stderr, r.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "k.so"))
    for name in ("bp_tree_qp_iter_f32", "bp_tree_qp_iter_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_double), ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("bp_tree_qp_phase_f32", "bp_tree_qp_phase_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bp_tree_qp_iter_scratch.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.bp_tree_qp_iter_scratch.restype = ctypes.c_longlong
    return lib


def _run(lib, plan, cfg, mtot, consts, carry):
    ints = tpl.kernel_ints(plan, cfg, 4, 4)
    dtype = carry[0].dtype
    Z = carry[0].shape[-1]
    elems = lib.bp_tree_qp_iter_scratch((ctypes.c_int * len(ints))(*ints))
    assert elems > 0
    outs = [torch.empty_like(c) for c in carry]
    gap = torch.empty((1, Z), dtype=dtype)
    scratch = torch.full((elems, Z), float("nan"), dtype=dtype)
    ptrs = [t.data_ptr() for t in (*consts, *carry, *outs, gap, scratch)]
    dbl = tpl.kernel_scalars(cfg, mtot, dtype)
    fn = lib.bp_tree_qp_iter_f64 if dtype == torch.float64 else lib.bp_tree_qp_iter_f32
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
             (ctypes.c_double * len(dbl))(*dbl), Z, 0, None)
    assert err == 0
    return (*outs, gap)


def _run_phase(lib, phase, plan, cfg, mtot, consts, carry):
    """One phase kernel of the source (0 or 1: t0 only, null carry outputs)."""
    ints = tpl.kernel_ints(plan, cfg, 4, 4)
    Z = carry[0].shape[-1]
    elems = lib.bp_tree_qp_iter_scratch((ctypes.c_int * len(ints))(*ints))
    t0 = torch.empty((1, Z), dtype=torch.float64)
    scratch = torch.full((elems, Z), float("nan"), dtype=torch.float64)
    ptrs = [t.data_ptr() for t in (*consts, *carry)] + [0] * len(carry) \
        + [t0.data_ptr(), scratch.data_ptr()]
    dbl = tpl.kernel_scalars(cfg, mtot, torch.float64)
    dbl[2] = tpl.phase_w_max(cfg)
    err = lib.bp_tree_qp_phase_f64(phase, (ctypes.c_void_p * len(ptrs))(*ptrs),
                                   (ctypes.c_int * len(ints))(*ints),
                                   (ctypes.c_double * len(dbl))(*dbl), Z, 0, None)
    assert err == 0
    return t0


@pytest.mark.parametrize("phase", [0, 1])
def test_phase_kernels_match_plain(cpu_kernel, phase):
    """The profile's phase 0 (Σ K + Σ Hinv) and phase 1 (Σ dx + Σ du) of the
    source against their plain versions, at 1e-10 of each value's magnitude."""
    params, plan, cost_bl, tsb = qp_data()
    cfg = QPIPMConfig(iters=6, gondzio=2)
    su = tpl.setup_ipm(plan, cost_bl, tsb["A"], tsb["Bm"], tsb["dh"], tsb["h0"],
                       params.Fx, params.bx, params.Fu, params.bu, tsb["x"], tsb["u"], cfg)
    mtot = float(plan.topo.totalu * 14)
    got = _run_phase(cpu_kernel, phase, plan, cfg, mtot, su.const_args, su.carry0)
    ref = tpl.make_phase(plan, cfg, 4, 4, mtot, phase)(*su.const_args, *su.carry0)
    assert got.shape == ref.shape == (1, su.carry0[0].shape[-1])
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    assert err <= ITER_TOL, (phase, err)


@pytest.mark.parametrize("advance", [0, 3])
def test_kernel_source_matches_plain(cpu_kernel, advance):
    params, plan, cost_bl, tsb = qp_data()
    cfg = QPIPMConfig(iters=6, gondzio=2)
    su = tpl.setup_ipm(plan, cost_bl, tsb["A"], tsb["Bm"], tsb["dh"], tsb["h0"],
                       params.Fx, params.bx, params.Fu, params.bu, tsb["x"], tsb["u"], cfg)
    mtot = float(plan.topo.totalu * 14)
    plain = tpl.make_iteration(plan, cfg, 4, 4, mtot)
    carry = su.carry0
    for _ in range(advance):
        carry = plain(*su.const_args, *carry)[:tpl.CARRY_FIELDS]
    got = _run(cpu_kernel, plan, cfg, mtot, su.const_args, carry)
    ref = plain(*su.const_args, *carry)
    for name, a, b in zip(NAMES, got, ref):
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err <= ITER_TOL, (name, err)


def test_phase_entry_takes_only_phases_0_and_1(cpu_kernel):
    """Phase 2, the full iteration, is launched through the main entry point
    alone; the phase entry point refuses it and any other number."""
    params, plan, cost_bl, tsb = qp_data()
    cfg = QPIPMConfig(iters=6, gondzio=2)
    su = tpl.setup_ipm(plan, cost_bl, tsb["A"], tsb["Bm"], tsb["dh"], tsb["h0"],
                       params.Fx, params.bx, params.Fu, params.bu, tsb["x"], tsb["u"], cfg)
    for phase in (2, -1, 3):
        with pytest.raises(AssertionError):
            _run_phase(cpu_kernel, phase, plan, cfg, float(plan.topo.totalu * 14),
                       su.const_args, su.carry0)


def test_kernel_rejects_bad_level_table(cpu_kernel):
    _, plan, _, _ = qp_data()
    ints = tpl.kernel_ints(plan, QPIPMConfig(), 4, 4)
    ints[8] += 1                       # branch count disagrees with the level table
    assert cpu_kernel.bp_tree_qp_iter_scratch((ctypes.c_int * len(ints))(*ints)) == -1
