"""K5, the shared-row contraction probe: the plain version
(``ops/shared_rows.shared_rows_plain``) against the reference kernel's body,
and the kernel source's ``fma`` path compiled for the CPU against the plain
version.

The reference kernel (``scripts/mxu_probe.py:61-88``) is a closure inside that
script's ``main()`` and cannot be imported, so its ``vpu`` body (the
broadcast multiply-sum, ``:68-76``) and its HIGHEST-precision dot are
rebuilt here in ``jax.numpy`` line for line, over every node, with the same
chain ``cur = dx + 1e-9·acc``. Bars: 1e-12 of the output's magnitude in f64;
in f32, 2 × the rounding bound of a 4-term f32 dot (4·u·Σ|Fx|·|cur|, u =
2⁻²⁴) per output. The bf16 plain mode is held to a JAX dot of
bf16-rounded operands at the same f32 bar.

The kernel source (``csrc/shared_rows_probe.cu``) built by g++ with the CUDA
keywords stubbed, the tensor-core modes left out (``BP_SHARED_ROWS_FMA_ONLY``)
and the launch replaced by a loop over blocks and threads: f64 within 1e-12
of the plain version's magnitude (g++ without FMA contraction; the kernel's
fma() calls round once where the plain version rounds twice), f32 as
accurate as the plain version in f32 (error against f64 ≤ 2 × the plain
f32's + 1e-6 × the magnitude)."""

import ctypes
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from belief_planning_tpu_torch.ops import shared_rows as sr

torch.set_num_threads(1)

NODES, LANES, INNER = 5, 48, 8
U32 = 2.0 ** -24


def _inputs(dtype):
    rng = np.random.default_rng(7)
    Fx = rng.normal(size=(4, 4))
    dx = rng.normal(size=(NODES, 4, LANES)) * 10.0 ** rng.uniform(-2, 2, (NODES, 1, LANES))
    return Fx.astype(dtype), dx.astype(dtype)


def _jax_body(mode, dtype):
    """The reference kernel body over all nodes: ``vpu`` (broadcast
    multiply-sum), ``hi`` (HIGHEST dot) or ``bf16`` (bf16-rounded operands)."""

    def run(Fxv, dxv):
        acc = jnp.zeros((NODES, 4, LANES), dtype)
        for _ in range(INNER):
            cur = dxv + 1e-9 * acc[:, :4, :]
            rs = []
            for nd in range(NODES):
                if mode == "vpu":
                    rs.append(jnp.sum(Fxv[:, :, None] * cur[nd][None, :, :], axis=1))
                elif mode == "hi":
                    rs.append(jnp.dot(Fxv, cur[nd], precision=jax.lax.Precision.HIGHEST,
                                      preferred_element_type=dtype))
                else:
                    rs.append(jnp.dot(Fxv.astype(jnp.bfloat16), cur[nd].astype(jnp.bfloat16),
                                      preferred_element_type=jnp.float32))
            acc = jnp.stack(rs, axis=0)
        return acc

    return jax.jit(run)


def _f32_bar(Fx, dx):
    """2 × the rounding bound of a 4-term f32 dot, per output."""
    _, cur = sr.shared_rows_plain(torch.as_tensor(Fx, dtype=torch.float64),
                                  torch.as_tensor(dx, dtype=torch.float64), INNER,
                                  return_cur=True)
    mag = torch.einsum("rk,nkb->nrb", torch.as_tensor(np.abs(Fx), dtype=torch.float64),
                       cur.abs())
    return (2 * 4 * U32 * mag).numpy()


@pytest.fixture(scope="module")
def jax_out():
    """The reference body's outputs, once per (mode, dtype)."""
    cases = [("vpu", np.float64), ("hi", np.float64), ("vpu", np.float32), ("hi", np.float32),
             ("bf16", np.float32)]
    return {(m, dt): np.asarray(_jax_body(m, dt)(*map(jnp.asarray, _inputs(dt))))
            for m, dt in cases}


@pytest.mark.parametrize("jmode", ["vpu", "hi"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_matches_reference_body(jax_out, jmode, dtype):
    Fx, dx = _inputs(dtype)
    want = jax_out[(jmode, dtype)]
    got = sr.shared_rows_plain(torch.as_tensor(Fx), torch.as_tensor(dx), INNER).numpy()
    assert got.dtype == dtype
    if dtype == np.float64:
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    else:
        assert (np.abs(got.astype(np.float64) - want) <= _f32_bar(Fx, dx)).all()


def test_plain_bf16_matches_rounded_reference_dot(jax_out):
    """The bf16 mode rounds both operands of every product to bf16 and sums
    in f32, as the reference's default-precision dot does."""
    Fx, dx = _inputs(np.float32)
    want = jax_out[("bf16", np.float32)]
    got = sr.shared_rows_plain(torch.as_tensor(Fx), torch.as_tensor(dx), INNER, "bf16").numpy()
    assert (np.abs(got.astype(np.float64) - want) <= _f32_bar(Fx, dx)).all()
    exact = sr.shared_rows_plain(torch.as_tensor(Fx), torch.as_tensor(dx), INNER).numpy()
    assert not np.array_equal(got, exact)


def test_plain_3xtf32_is_f32_grade():
    """Three TF32 passes over a big + small split are within the f32 bar of
    the exact product, and TF32 rounding is round-to-nearest, ties away."""
    Fx, dx = _inputs(np.float32)
    got = sr.shared_rows_plain(torch.as_tensor(Fx), torch.as_tensor(dx), INNER, "3xtf32")
    exact = sr.shared_rows_plain(torch.as_tensor(Fx, dtype=torch.float64),
                                 torch.as_tensor(dx, dtype=torch.float64), INNER)
    assert ((got.double() - exact).abs().numpy() <= 4 * _f32_bar(Fx, dx)).all()
    one = torch.tensor([1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 3 * 2.0 ** -11), 3.0])
    assert sr._round_tf32(one).tolist() == [1 + 2.0 ** -10, 1.0, -(1 + 2 * 2.0 ** -10), 3.0]


def test_wrapper_on_cpu_runs_the_plain_mode():
    Fx, dx = (torch.as_tensor(a) for a in _inputs(np.float32))
    before = dict(sr.KERNEL.launches)
    for mode in sr.MODES:
        assert torch.equal(sr.shared_rows(Fx, dx, INNER, mode),
                           sr.shared_rows_plain(Fx, dx, INNER, mode))
    with pytest.raises(ValueError):
        sr.shared_rows(Fx, dx, INNER, "tf32")
    assert sr.KERNEL.launches == before


STUB = """#pragma once
#include <cmath>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1)
  : x(a), y(b), z(c) {} };
static dim3 blockIdx, threadIdx, blockDim;
"""
LAUNCH = re.compile(r"shared_rows_fma_kernel<T><<<grid, tile, 0, .*?>>>\(([^;]*)\);", re.S)
LOOP = (r"for (unsigned by = 0; by < grid.y; ++by) for (unsigned bx = 0; bx < grid.x; ++bx) "
        r"for (int tx = 0; tx < tile; ++tx) { blockIdx = dim3(bx, by); threadIdx = dim3(tx); "
        r"blockDim = dim3(tile); shared_rows_fma_kernel<T>(\1); }")


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("shared_rows_cpu")
    src = sr.KERNEL_SOURCE.read_text()
    assert LAUNCH.search(src), "kernel launch statement not found"
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "k.cpp").write_text(LAUNCH.sub(LOOP, src))
    r = subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                        "-DBP_SHARED_ROWS_FMA_ONLY", "-Wall", "-Wno-unknown-pragmas",
                        "-I", str(d), "-o", str(d / "k.so"), str(d / "k.cpp")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "warning" not in r.stderr, r.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "k.so"))
    ptrs = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.bp_shared_rows_f32.argtypes = [ctypes.c_int] + ptrs
    lib.bp_shared_rows_fma_f64.argtypes = ptrs
    lib.bp_shared_rows_f32.restype = lib.bp_shared_rows_fma_f64.restype = ctypes.c_int
    return lib


def _run(lib, Fx, dx, tile=32, mode=0):
    out = torch.full_like(dx, float("nan"))
    args = (Fx.data_ptr(), dx.data_ptr(), out.data_ptr(), dx.shape[2], dx.shape[0], INNER, tile,
            0, None)
    err = (lib.bp_shared_rows_fma_f64(*args) if dx.dtype == torch.float64
           else lib.bp_shared_rows_f32(mode, *args))
    assert err == 0
    return out


def test_kernel_source_fma_f64_matches_plain(cpu_kernel):
    Fx, dx = (torch.as_tensor(a) for a in _inputs(np.float64))
    got, ref = _run(cpu_kernel, Fx, dx), sr.shared_rows_plain(Fx, dx, INNER)
    assert (got - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()


def test_kernel_source_fma_f32_is_as_accurate_as_plain(cpu_kernel):
    Fx, dx = (torch.as_tensor(a) for a in _inputs(np.float32))
    got, ref = _run(cpu_kernel, Fx, dx, tile=64), sr.shared_rows_plain(Fx, dx, INNER)
    ref64 = sr.shared_rows_plain(Fx.double(), dx.double(), INNER)
    e_kernel = (got.double() - ref64).abs().max().item()
    e_plain = (ref.double() - ref64).abs().max().item()
    assert e_kernel <= 2 * e_plain + 1e-6 * ref64.abs().max().item()


def test_kernel_source_rejects_what_it_does_not_take(cpu_kernel):
    Fx, dx = (torch.as_tensor(a) for a in _inputs(np.float32))
    out = torch.empty_like(dx)
    base = [Fx.data_ptr(), dx.data_ptr(), out.data_ptr(), LANES, NODES, INNER, 32, 0, None]
    for i, bad in ((6, 48), (6, 1024), (5, 0), (3, 0)):
        args = list(base)
        args[i] = bad
        assert cpu_kernel.bp_shared_rows_f32(0, *args) != 0
    # the tensor-core modes are left out of this build
    assert cpu_kernel.bp_shared_rows_f32(1, *base) != 0
    assert cpu_kernel.bp_shared_rows_f32(2, *base) != 0
