"""The SOC projection kernel's source, compiled for the CPU, against the plain
version.

The kernel (``belief_planning_tpu_torch/csrc/proj_soc.cu``) runs only on a
card. With the CUDA keywords stubbed and the launch replaced by a loop over
blocks and threads (as in ``test_torch_kernel_cpu_build.py``), g++ builds it
into a shared library that the same ctypes interface drives on CPU tensors.
This holds it against ``_proj_soc_batch`` on random rows and the tie rows
(‖u‖ = t, ‖u‖ = −t, u = 0 with t < 0, t = 0) at the CVaR ADMM's row length
k = 8 and at k = 1 and 16: f64 within 1e-15 of each input row's magnitude
(g++ without FMA contraction), f32 within 1e-6. The build stays in the test's
temporary directory.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from belief_planning_tpu_torch.ops import soc
from belief_planning_tpu_torch.solvers.cvar import _proj_soc_batch

from tests.test_torch_cuda import soc_rows
from tests.test_torch_kernel_cpu_build import STUB

torch.set_num_threads(1)

LAUNCH = re.compile(r"proj_soc_kernel<T>\s*<<<[^;]*>>>\(([^;]*)\);")
LOOP = (r"for (unsigned bx = 0; bx < blocks; ++bx) "
        r"for (unsigned tx = 0; tx < (unsigned)kThreads; ++tx) { blockIdx.x = bx; "
        r"threadIdx.x = tx; blockDim.x = kThreads; proj_soc_kernel<T>(\1); }")
ROW_TOL = {torch.float64: 1e-15, torch.float32: 1e-6}


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("soc_kernel_cpu")
    src = soc.KERNEL_SOURCE.read_text()
    assert LAUNCH.search(src), "kernel launch statement not found"
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "k.cpp").write_text(LAUNCH.sub(LOOP, src))
    r = subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                        "-Wall", "-Wno-unknown-pragmas", "-I", str(d), "-o", str(d / "k.so"),
                        str(d / "k.cpp")], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "warning" not in r.stderr, r.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "k.so"))
    for name in ("bp_proj_soc_f32", "bp_proj_soc_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bp_proj_soc_max_k.restype = ctypes.c_int
    return lib


def _run(lib, v):
    out = torch.full_like(v, float("nan"))
    fn = lib.bp_proj_soc_f64 if v.dtype == torch.float64 else lib.bp_proj_soc_f32
    err = fn(v.data_ptr(), out.data_ptr(), v.shape[0], v.shape[1], 0, None)
    assert err == 0
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [8, 1, 16])
def test_kernel_source_matches_plain(cpu_kernel, dtype, k):
    v = torch.as_tensor(soc_rows(np.random.default_rng(50 + k), k=max(k, 3))[:, :k], dtype=dtype)
    v = v.contiguous()
    got = _run(cpu_kernel, v)
    ref = _proj_soc_batch(v)
    row_mag = v.abs().amax(1, keepdim=True).clamp(min=1e-300)
    assert ((got - ref).abs() <= ROW_TOL[dtype] * row_mag).all()
    if k >= 3:     # the tie rows: kept or zeroed exactly
        assert torch.equal(got[-6:-3], ref[-6:-3])


def test_kernel_rejects_what_it_does_not_take(cpu_kernel):
    assert cpu_kernel.bp_proj_soc_max_k() == 16
    v = torch.zeros((4, 17), dtype=torch.float64)
    out = torch.empty_like(v)
    for rows, k in ((4, 17), (4, 0), (0, 8)):
        assert cpu_kernel.bp_proj_soc_f64(v.data_ptr(), out.data_ptr(), rows, k, 0, None) != 0
