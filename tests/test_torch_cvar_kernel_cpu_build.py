"""The CVaR kernel's source, compiled for the CPU, against the plain version.

The kernel (``belief_planning_tpu_torch/csrc/cvar_ipm_iter.cu``) runs only on
a card. Its arithmetic is plain C++ apart from the CUDA keywords and the
launch, so with those stubbed (as in ``test_torch_kernel_cpu_build.py``) g++
builds it into a shared library that the same ctypes interface drives on CPU
tensors. This holds the kernel source's iteration against
``make_cvar_iteration`` on real CVaR data in f64 at 1e-10 of each field's
magnitude (g++ without FMA contraction): the merge configuration with
per-lane ``S``, ``bx`` and dh[0] floor (two levels, m=2) and the overtake
(three levels, m=3), Gondzio=2, at the first iteration and after three.
The build stays in the test's temporary directory.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from belief_planning_tpu_torch.solvers import cvar_pl

from tests.test_torch_cuda import CVAR_NAMES, ITER_TOL, cvar_setup
from tests.test_torch_kernel_cpu_build import STUB

torch.set_num_threads(1)

LAUNCH = re.compile(r"cvar_ipm_iter_kernel<T>\s*<<<[^;]*>>>\(P\);")
LOOP = ("for (unsigned bx = 0; bx < blocks; ++bx) "
        "for (unsigned tx = 0; tx < (unsigned)kThreads; ++tx) { blockIdx.x = bx; "
        "threadIdx.x = tx; blockDim.x = kThreads; cvar_ipm_iter_kernel<T>(P); }")


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("cvar_kernel_cpu")
    src = cvar_pl.KERNEL_SOURCE.read_text()
    assert LAUNCH.search(src), "kernel launch statement not found"
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "k.cpp").write_text(LAUNCH.sub(LOOP, src))
    r = subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                        "-Wall", "-Wno-unknown-pragmas", "-I", str(d), "-o", str(d / "k.so"),
                        str(d / "k.cpp")], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "warning" not in r.stderr, r.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "k.so"))
    for name in ("bp_cvar_iter_f32", "bp_cvar_iter_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_double), ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bp_cvar_iter_scratch.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.bp_cvar_iter_scratch.restype = ctypes.c_longlong
    return lib


def _run(lib, cplan, cfg, su, itv, carry):
    ints = cvar_pl.kernel_ints(cplan, cfg, su.dims)
    dtype = carry[0].dtype
    Z = carry[0].shape[-1]
    elems = lib.bp_cvar_iter_scratch((ctypes.c_int * len(ints))(*ints))
    assert elems > 0
    outs = [torch.empty_like(c) for c in carry]
    gap = torch.empty((1, Z), dtype=dtype)
    scratch = torch.full((elems, Z), float("nan"), dtype=dtype)
    ptrs = [t.data_ptr() for t in (*su.in_args, *carry, *outs, gap, scratch)]
    dbl = cvar_pl.kernel_scalars(cfg, su.dims, dtype, itv)
    fn = lib.bp_cvar_iter_f64 if dtype == torch.float64 else lib.bp_cvar_iter_f32
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
             (ctypes.c_double * len(dbl))(*dbl), Z, 0, None)
    assert err == 0
    return (*outs, gap)


@pytest.mark.parametrize("kind,NB", [("merge", 1), ("overtake", 2)])
@pytest.mark.parametrize("advance", [0, 3])
def test_kernel_source_matches_plain(cpu_kernel, kind, NB, advance):
    cplan, cfg, su, plain = cvar_setup(kind, NB=NB)
    carry = su.carry0
    for itv in range(advance):
        carry = plain(*su.in_args, itv, *carry)[:cvar_pl.CARRY_FIELDS]
    for itv in (advance, cfg.early_iters + 1):        # both sides of the early step cap
        got = _run(cpu_kernel, cplan, cfg, su, itv, carry)
        ref = plain(*su.in_args, itv, *carry)
        for name, a, b in zip(CVAR_NAMES, got, ref):
            err = (a - b).abs().max().item() / b.abs().max().item()
            assert err <= ITER_TOL, (name, itv, err)


def test_kernel_rejects_dims_it_is_not_written_for(cpu_kernel):
    cplan, cfg, su, _ = cvar_setup("merge")
    ints = cvar_pl.kernel_ints(cplan, cfg, su.dims)
    scratch = lambda v: cpu_kernel.bp_cvar_iter_scratch((ctypes.c_int * len(v))(*v))
    assert scratch(ints) > 0
    for pos, val in ((4, 3), (2, 4), (8, ints[8] + 1)):   # nFx=3, m=4, wrong branch count
        bad = list(ints)
        bad[pos] = val
        assert scratch(bad) == -1, pos
