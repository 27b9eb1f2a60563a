"""The CVaR kernel's source, compiled for the CPU, against the plain version.

The kernel (``belief_planning_tpu_torch/csrc/cvar_ipm_iter.cu``) runs only on
a card. Its arithmetic is plain C++ apart from the CUDA keywords, the
barriers, the warp shuffles, shared memory and the launch. ``STUB`` emulates
those, so g++ builds the source into a shared library that the same ctypes
interface drives on CPU tensors: a launch runs the blocks of the grid one
after another on the calling thread, each as one fiber per CUDA thread (a
stack of its own, switched by a few lines of x86-64 assembly); a fiber runs
until it waits at ``__syncthreads`` (the block's barrier) or ``__syncwarp``
(its warp's), and the last to arrive releases the others, so no thread
spins or sleeps; a shuffle goes through a per-block exchange array between
two waits of the warp's barrier; dynamic shared memory is a per-block
buffer. Device
d is an emulated card of d + 1 SMs with one resident block an SM: on device
0 the persistent grid walks over the batch in rounds when B > 8, and on
device 3 a small batch spreads over 4 blocks of 2 trees, as B=256 does over
a real card's SMs.

This holds the kernel source's iteration against ``make_cvar_iteration`` on
real CVaR data in f64 at 1e-10 of each field's magnitude (g++ without FMA
contraction): the merge configuration with per-lane ``S``, ``bx`` and dh[0]
floor (two levels, m=2) and the overtake (three levels, m=3), Gondzio=2, at
the first iteration and after three; at B=1 and at a B that leaves the last
round of blocks part-full; in blocks of 2 trees, the last part-full; and
with a risk saddle whose first pivot column has a tie, or holds a NaN. The build stays in the test's temporary directory.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from belief_planning_tpu_torch.solvers import cvar_pl

from tests.test_torch_cuda import CVAR_NAMES, ITER_TOL, cvar_setup

torch.set_num_threads(1)

STUB = """#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __grid_constant__
#define __launch_bounds__(...)
#define __align__(x) alignas(x)
typedef void* cudaStream_t;
// the 16-byte vectors and the streaming loads and stores of the SOC kernel
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
template <class V> inline V __ldcs(const V* p) { return *p; }
template <class V> inline void __stcs(V* p, V v) { *p = v; }
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
// the emulated card `device`: device + 1 SMs, an H100's 227 KB of shared
// memory a block
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int device) {
  *v = a == cudaDevAttrMultiProcessorCount ? device + 1 : 232448;
  return cudaSuccess;
}
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
struct EmuIdx { unsigned x; };
inline EmuIdx threadIdx, blockIdx, blockDim, gridDim;
// A block runs on the calling thread as one fiber a CUDA thread: a fiber runs
// until it waits at a barrier (__syncthreads, or __syncwarp for its warp),
// then the next runnable fiber of the block runs; the last to arrive at a
// barrier releases the others. emu_switch saves the callee-saved registers
// and the stack pointer of one fiber (x86-64 System V) and resumes another.
extern "C" void emu_switch(void** save_sp, void* next_sp);
asm(R"(
  .text
  .p2align 4
  .hidden emu_switch
  .globl emu_switch
  .type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_switch, .-emu_switch
)");
struct EmuBlock {
  static constexpr size_t kStack = 1 << 20;   // bytes a fiber (touched as used)
  struct Fiber {
    void* sp = nullptr;
    int waiting = 0;                          // 1: at the block barrier, 2: at its warp's
    bool done = false;
  };
  unsigned n;
  std::vector<Fiber> fib;
  std::unique_ptr<char[]> stacks;
  void* sched_sp = nullptr;
  unsigned cur = 0, at_block = 0;
  std::vector<unsigned> at_warp;
  std::vector<unsigned long long> xch;
  std::vector<unsigned char> smem;
  std::function<void()> body;
  EmuBlock(unsigned threads, size_t bytes)
      : n(threads), fib(threads), stacks(new char[threads * kStack]),
        at_warp((threads + 31) / 32), xch(threads), smem(bytes) {}
};
inline EmuBlock* emu_block;
[[noreturn]] inline void emu_fiber_main() {
  EmuBlock* b = emu_block;
  b->body();
  b->fib[b->cur].done = true;
  emu_switch(&b->fib[b->cur].sp, b->sched_sp);
  __builtin_unreachable();
}
// arrive at a barrier of `members` fibers (kind 1: the block, 2: the warp of
// fiber `cur`); the last to arrive releases the others and goes on
inline void emu_arrive(int kind) {
  EmuBlock* b = emu_block;
  const unsigned me = b->cur, w = me / 32;
  unsigned& count = kind == 1 ? b->at_block : b->at_warp[w];
  const unsigned lo = kind == 1 ? 0 : 32 * w;
  const unsigned hi = kind == 1 ? b->n : std::min(b->n, lo + 32);
  if (++count == hi - lo) {
    count = 0;
    for (unsigned t = lo; t < hi; ++t) b->fib[t].waiting = 0;
    return;
  }
  b->fib[me].waiting = kind;
  emu_switch(&b->fib[me].sp, b->sched_sp);
}
inline void __syncthreads() { emu_arrive(1); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_arrive(2); }
template <class V> V emu_shfl(V v, unsigned src) {
  static_assert(sizeof(V) <= sizeof(unsigned long long), "shuffle of at most 8 bytes");
  const unsigned t = threadIdx.x;
  std::memcpy(&emu_block->xch[t], &v, sizeof(V));
  __syncwarp();
  V r;
  std::memcpy(&r, &emu_block->xch[t / 32 * 32 + src], sizeof(V));
  __syncwarp();
  return r;
}
// the shuffles of whole warps (width 32, the kernels' teams)
template <class V> V __shfl_xor_sync(unsigned, V v, int m, int = 32) {
  return emu_shfl(v, (threadIdx.x % 32) ^ (unsigned)m);
}
template <class V> V __shfl_sync(unsigned, V v, int src, int = 32) {
  return emu_shfl(v, (unsigned)src);
}
template <class F> void emu_launch(unsigned blocks, unsigned threads, size_t smem, F body) {
  gridDim.x = blocks;
  blockDim.x = threads;
  for (unsigned b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    EmuBlock blk(threads, smem);
    blk.body = body;
    emu_block = &blk;
    for (unsigned t = 0; t < threads; ++t) {
      // a fresh stack: emu_fiber_main's return slot (16-byte aligned below
      // it), its entry as emu_switch's return address, six zeroed registers
      auto top = reinterpret_cast<uintptr_t>(blk.stacks.get() + (t + 1) * EmuBlock::kStack);
      auto* sp = reinterpret_cast<void**>((top & ~uintptr_t(15)) - 8);
      *--sp = reinterpret_cast<void*>(&emu_fiber_main);
      for (int r = 0; r < 6; ++r) *--sp = nullptr;
      blk.fib[t].sp = sp;
    }
    for (unsigned left = threads; left > 0;) {
      bool ran = false;
      for (unsigned t = 0; t < threads; ++t) {
        EmuBlock::Fiber& f = blk.fib[t];
        if (f.done || f.waiting) continue;
        blk.cur = t;
        threadIdx.x = t;
        emu_switch(&blk.sched_sp, f.sp);
        ran = true;
        if (f.done) --left;
      }
      if (!ran) {
        std::fprintf(stderr, "emu_launch: every fiber of block %u waits at a barrier\\n", b);
        std::abort();
      }
    }
  }
}
using std::isfinite;
"""
LAUNCH = re.compile(r"cvar_ipm_iter_kernel<T>\s*<<<([^,]+),([^,]+),([^,]+),[^;]*>>>\(P\);")
LOOP = r"emu_launch(\1,\2,\3, [&P] { cvar_ipm_iter_kernel<T>(P); });"
SMEM = re.compile(r"extern __shared__ __align__\(16\) unsigned char smem_raw\[\];")
SMEM_EMU = "unsigned char* smem_raw = emu_block->smem.data();"


def build_cpu_kernel(out_dir: Path, source: str, flags=("-O1", "-ffp-contract=off")):
    """g++ build of the kernel source with ``STUB``; returns the bound
    library. Asserts the build is clean (no warning)."""
    gxx = shutil.which("g++")
    assert LAUNCH.search(source), "kernel launch statement not found"
    assert SMEM.search(source), "dynamic shared memory declaration not found"
    (out_dir / "cuda_runtime.h").write_text(STUB)
    (out_dir / "k.cpp").write_text(SMEM.sub(SMEM_EMU, LAUNCH.sub(LOOP, source)))
    r = subprocess.run([gxx, *flags, "-std=c++20", "-pthread", "-shared", "-fPIC", "-Wall",
                        "-Wno-unknown-pragmas", "-I", str(out_dir), "-o", str(out_dir / "k.so"),
                        str(out_dir / "k.cpp")], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "warning" not in r.stderr, r.stderr[-4000:]
    return cvar_pl.bind_kernel_library(ctypes.CDLL(str(out_dir / "k.so")))


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    return build_cpu_kernel(tmp_path_factory.mktemp("cvar_kernel_cpu"),
                            cvar_pl.KERNEL_SOURCE.read_text())


def run_cpu_kernel(lib, cplan, cfg, su, itv, carry, device=0):
    """One launch of the CPU build on CPU tensors, on the emulated card
    ``device`` (``device + 1`` SMs); returns the new carry and the gap. The
    scratch starts as NaN, so a read before a write shows."""
    ints = cvar_pl.kernel_ints(cplan, cfg, su.dims)
    dtype = carry[0].dtype
    Z = carry[0].shape[-1]
    plan = cvar_pl.kernel_plan(lib, ints, Z, dtype, device)
    assert plan["sms"] == device + 1 and plan["blocks"] <= plan["sms"]
    outs = [torch.empty_like(c) for c in carry]
    gap = torch.empty((1, Z), dtype=dtype)
    scratch = torch.full((plan["scratch_elems"],), float("nan"), dtype=dtype)
    ptrs = [t.data_ptr() for t in (*su.in_args, *carry, *outs, gap, scratch)]
    dbl = cvar_pl.kernel_scalars(cfg, su.dims, dtype, itv)
    fn = lib.bp_cvar_iter_f64 if dtype == torch.float64 else lib.bp_cvar_iter_f32
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
             (ctypes.c_double * len(dbl))(*dbl), Z, device, None)
    assert err == 0
    return (*outs, gap)


def _assert_matches(got, ref, what):
    """Every field within ITER_TOL of its magnitude; NaN exactly where the
    plain version has NaN."""
    for name, a, b in zip(CVAR_NAMES, got, ref):
        nan = b.isnan()
        assert torch.equal(a.isnan(), nan), (name, what, "NaN pattern")
        a, b = a[~nan], b[~nan]
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err <= ITER_TOL, (name, what, err)


@pytest.mark.parametrize("kind,NB", [("merge", 1), ("overtake", 2)])
@pytest.mark.parametrize("advance", [0, 3])
def test_kernel_source_matches_plain(cpu_kernel, kind, NB, advance):
    cplan, cfg, su, plain = cvar_setup(kind, NB=NB)
    carry = su.carry0
    for itv in range(advance):
        carry = plain(*su.in_args, itv, *carry)[:cvar_pl.CARRY_FIELDS]
    for itv in (advance, cfg.early_iters + 1):        # both sides of the early step cap
        got = run_cpu_kernel(cpu_kernel, cplan, cfg, su, itv, carry)
        _assert_matches(got, plain(*su.in_args, itv, *carry), itv)


@pytest.mark.parametrize("kind,B", [("merge", 1), ("overtake", 1), ("merge", 11),
                                    ("overtake", 11)])
def test_kernel_source_matches_plain_at_ragged_batches(cpu_kernel, kind, B):
    """B=1 (one team in one block) and B=11: 8 trees a block on the
    emulated SM, so the block takes two rounds, the second with 3 of its 8
    trees; the teams past B neither read nor write and stall no barrier."""
    cplan, cfg, su, plain = cvar_setup(kind, NB=1 if kind == "merge" else 2, B=B)
    got = run_cpu_kernel(cpu_kernel, cplan, cfg, su, 1, su.carry0)
    assert all(g.shape[-1] == B for g in got)
    _assert_matches(got, plain(*su.in_args, 1, *su.carry0), B)


@pytest.mark.parametrize("kind", ["merge", "overtake"])
def test_kernel_source_matches_plain_in_blocks_of_two_trees(cpu_kernel, kind):
    """B=7 on an emulated card of 4 SMs: 2 trees a block over 4 blocks (the
    card's launch shape at B=256), the last block with one tree past B."""
    cplan, cfg, su, plain = cvar_setup(kind, NB=1 if kind == "merge" else 2, B=7)
    ints = cvar_pl.kernel_ints(cplan, cfg, su.dims)
    plan = cvar_pl.kernel_plan(cpu_kernel, ints, 7, torch.float64, 3)
    assert (plan["trees_per_block"], plan["blocks"]) == (2, 4)
    got = run_cpu_kernel(cpu_kernel, cplan, cfg, su, 1, su.carry0, device=3)
    _assert_matches(got, plain(*su.in_args, 1, *su.carry0), "blocks of two")


@pytest.mark.parametrize("case", ["tie", "nan"])
def test_risk_saddle_pivot_tie_and_nan_match_plain(cpu_kernel, case):
    """The risk saddle's first pivot column is [h_rho, 1, 0, ...]; with
    h_rho = 1 exactly (sl4 = 1, lam4 = 1 - reg on lane 1's first branch) both
    rows tie and the first wins, in the kernel as in the plain version. With a
    NaN in lam4 on lane 2, the NaN reaches the saddle (and the gap); that lane
    keeps its carry and reports a NaN gap, and the other lanes are untouched."""
    cplan, cfg, su, plain = cvar_setup("overtake", NB=2)
    carry = [c.clone() for c in su.carry0]
    sl4, lam4 = CVAR_NAMES.index("sl4"), CVAR_NAMES.index("lam4")
    if case == "tie":
        carry[sl4][0, 1] = 1.0
        carry[lam4][0, 1] = 1.0 - cfg.reg
        assert cfg.reg + (carry[lam4][0, 1] / carry[sl4][0, 1]).item() == 1.0
    else:
        carry[lam4][0, 2] = float("nan")
    got = run_cpu_kernel(cpu_kernel, cplan, cfg, su, 0, carry)
    ref = plain(*su.in_args, 0, *carry)
    _assert_matches(got, ref, case)
    if case == "nan":
        assert bool(ref[-1][0, 2].isnan()) and bool(ref[-1][0, :2].isfinite().all())
        for new, old in zip(got[:-1], carry):
            assert torch.equal(new[..., 2].isnan(), old[..., 2].isnan())
            keep = ~old[..., 2].isnan()
            assert torch.equal(new[..., 2][keep], old[..., 2][keep])


def test_kernel_rejects_dims_it_is_not_written_for(cpu_kernel):
    cplan, cfg, su, _ = cvar_setup("merge")
    ints = cvar_pl.kernel_ints(cplan, cfg, su.dims)
    assert cvar_pl.kernel_plan(cpu_kernel, ints, 4, torch.float64, 0)["scratch_elems"] > 0
    for pos, val in ((4, 3), (2, 4), (8, ints[8] + 1)):   # nFx=3, m=4, wrong branch count
        bad = list(ints)
        bad[pos] = val
        with pytest.raises(ValueError):
            cvar_pl.kernel_plan(cpu_kernel, bad, 4, torch.float64, 0)
