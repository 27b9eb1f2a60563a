"""The SOC projection kernel's source, compiled for the CPU, against the plain
version.

The kernel (``belief_planning_tpu_torch/csrc/proj_soc.cu``) runs only on a
card. ``STUB`` of ``test_torch_cvar_kernel_cpu_build.py`` emulates its
launches with one ``std::thread`` per CUDA thread, its shuffles through an
exchange array between warp barriers, its 16-byte vectors and streaming
loads as plain structs and reads, and device d as a card of d + 1 SMs with
one resident block an SM; g++ builds the source into a shared library that
the same ctypes interface drives on CPU tensors.

This holds both paths against ``_proj_soc_batch`` on random rows and the
tie rows (‖u‖ = t, ‖u‖ = −t, u = 0 with t < 0, t = 0): the team path (k = 8
at 16-byte aligned pointers, 2 lanes a row in f32 and 4 in f64) and the
general path (k = 1 and 16, and k = 8 at a view 8 or 4 bytes off alignment);
at row counts that leave the last warp and the last block part-full and
that take the team path's grid several strides over one emulated SM, or
spread it over four; f64 within 1e-15 of each input row's magnitude (g++
without FMA contraction), f32 within 1e-6, the tie rows exact. The build
stays in the test's temporary directory.
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
from tests.test_torch_cvar_kernel_cpu_build import STUB

torch.set_num_threads(1)

LAUNCH = re.compile(r"(proj_soc(?:_team)?_kernel<T>)\s*<<<([^,]+),([^,]+),([^,]+),[^;]*>>>"
                    r"\(([^;]*)\);")
LOOP = r"emu_launch(\2,\3,\4, [&] { \1(\5); });"
ROW_TOL = {torch.float64: 1e-15, torch.float32: 1e-6}


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("soc_kernel_cpu")
    src = soc.KERNEL_SOURCE.read_text()
    assert len(LAUNCH.findall(src)) == 2, "the two kernel launch statements not found"
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "k.cpp").write_text(LAUNCH.sub(LOOP, src))
    r = subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC",
                        "-ffp-contract=off", "-Wall", "-Wno-unknown-pragmas", "-I", str(d),
                        "-o", str(d / "k.so"), str(d / "k.cpp")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "warning" not in r.stderr, r.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "k.so"))
    for name in ("bp_proj_soc_f32", "bp_proj_soc_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bp_proj_soc_path.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.bp_proj_soc_path.restype = ctypes.c_int
    lib.bp_proj_soc_max_k.restype = ctypes.c_int
    return lib


def _run(lib, v, device=0, path=None):
    out = torch.full_like(v, float("nan"))
    if path is not None:
        assert lib.bp_proj_soc_path(v.data_ptr(), out.data_ptr(), v.shape[1]) == path
    fn = lib.bp_proj_soc_f64 if v.dtype == torch.float64 else lib.bp_proj_soc_f32
    err = fn(v.data_ptr(), out.data_ptr(), v.shape[0], v.shape[1], device, None)
    assert err == 0
    return out


def _check(got, v, ties=True):
    ref = _proj_soc_batch(v)
    row_mag = v.abs().amax(1, keepdim=True).clamp(min=1e-300)
    assert ((got - ref).abs() <= ROW_TOL[v.dtype] * row_mag).all()
    if ties:       # the tie rows: kept or zeroed exactly
        assert torch.equal(got[-6:-3], ref[-6:-3])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [8, 1, 16])
def test_kernel_source_matches_plain(cpu_kernel, dtype, k):
    v = torch.as_tensor(soc_rows(np.random.default_rng(50 + k), k=max(k, 3))[:, :k], dtype=dtype)
    v = v.contiguous()
    _check(_run(cpu_kernel, v, path=int(k == 8)), v, ties=k >= 3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows,device", [(6, 0), (23, 0), (1000, 0), (1000, 3)])
def test_team_path_part_full(cpu_kernel, dtype, rows, device):
    """The team path at k = 8: the tie rows alone (a part-full warp); 17 + 6
    rows (the last warp part-full, its last team's lanes beside idle ones);
    994 + 6 rows, more than one block's stride of 1,024 vectors, so one
    emulated SM's block strides (f32: twice, the second part-full; f64:
    four times) or four SMs' blocks share the rows."""
    v = soc_rows(np.random.default_rng(rows + device), rows=rows - 6)
    v = torch.as_tensor(v, dtype=dtype)
    _check(_run(cpu_kernel, v, device=device, path=1), v)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_general_path_on_an_unaligned_view(cpu_kernel, dtype):
    """k = 8 at a view one scalar past a 16-byte boundary (8 B in f64, 4 B in
    f32) takes the general path, and so does k = 5; 300 rows leave the last
    256-thread block part-full."""
    rows = 300
    v = torch.as_tensor(soc_rows(np.random.default_rng(9), rows=rows - 6), dtype=dtype)
    buf = torch.empty(rows * 8 + 1, dtype=dtype)
    off = buf[1:].view(rows, 8)
    off.copy_(v)
    assert off.data_ptr() % 16 != 0 and off.is_contiguous()
    _check(_run(cpu_kernel, off, path=0), off)
    v5 = v[:, :5].contiguous()
    _check(_run(cpu_kernel, v5, path=0), v5)


def test_kernel_rejects_what_it_does_not_take(cpu_kernel):
    assert cpu_kernel.bp_proj_soc_max_k() == 16
    v = torch.zeros((4, 17), dtype=torch.float64)
    out = torch.empty_like(v)
    for rows, k in ((4, 17), (4, 0), (0, 8)):
        assert cpu_kernel.bp_proj_soc_f64(v.data_ptr(), out.data_ptr(), rows, k, 0, None) != 0
