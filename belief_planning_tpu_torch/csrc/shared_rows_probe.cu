// shared_rows_probe.cu -- the shared-row contraction probe on Hopper (sm_90a):
// does a tensor core pay for a K=4, N=4 product whose left operand every lane
// shares?
//
// Replaces the TPU kernel of scripts/mxu_probe.py (the pallas_call at :92,
// body :61-88), which times the "split form" of the IPM's constraint rows,
// rr = Fx @ x (belief_planning_tpu/solvers/tree_qp_ipm.py:143-151): Fx
// (nFx = 4, n = 4) is the same for every lane, x is lane-major. For every
// node nd and lane t, `inner` times:
//
//     cur = dx[nd, :, t] + 1e-9 * acc[nd, :, t]      (chains the repetitions)
//     acc[nd, :, t] = Fx @ cur
//
// and out = acc. Its plain PyTorch version is shared_rows_plain in
// belief_planning_tpu_torch/ops/shared_rows.py. One template per unit, one
// mode per reference mode:
//
//   fma    (reference "vpu"): one thread per (lane, node), Fx in registers,
//          exact f32 FMAs; each thread's 4 output rows are independent chains.
//   bf16   (reference "mxu", the TPU's default one-pass dot): wgmma m64n16k16
//          with bf16 operands and f32 accumulation. The chain update stays in
//          f32; cur and Fx are rounded to bf16 before each product, as the
//          reference's default dot does.
//   3xtf32 (reference "mxu_hi", HIGHEST): wgmma m64n16k8 in TF32, each
//          operand split a = big + small with big = tf32(a), small =
//          tf32(a - big), summed as (small*big + big*small) + big*big, the
//          plain version's order: an f32-grade product on tensor cores.
//
// Tensor-core design. A block is one warpgroup (4 warps). A chain is 64 lanes
// (wgmma's M) of p nodes packed into K and N: A[lane, c] is cur of the node
// and row that A column c holds, D[lane, c] is acc of the node and row that D
// column c holds, and B (shared memory, written once a block) holds Fx[r, k]
// where B row (node, k) meets D column (node, r), zero off the block
// diagonal. The packing is ops/shared_rows.py's wgmma_packing:
//   bf16, p = 4 (K = N = 16): A and D column c hold node c / 4, row c % 4. A
//     register j of m64nNk16 holds the two bf16 at the (row, column) places
//     of D registers 2j and 2j + 1, so the f32 accumulator becomes the next
//     product's A operand in registers, with no shuffle (the reuse
//     FlashAttention-3 makes of P for P.V). A quarter of the MACs are real
//     (an mma.sync m16n8k16 a node: a sixteenth).
//   3xtf32, p = 2 (K = 8): A column c holds node c / 4, row c % 4; D column
//     c of each 8-column half holds node c % 2, row c / 2. A thread's D
//     registers 2h + s (row g + 8h, columns 2t and 2t + 1) then hold nodes
//     s = 0, 1 at row t, which are its A registers h + 2s (columns t and
//     t + 4): no shuffle either. The three passes take two products a step,
//     big * [small | big] into both halves (N = 16), then small * [big | 0]
//     added: the halves are d1 = big*small + small*big and d2 = big*big. Half
//     the K columns are real (mma.sync m16n8k8 a node: half, and 4 of 8 N
//     columns).
// A is in registers; B's descriptor reads an unswizzled K-major layout (8-row
// x 16-byte core matrices, 128 B apart along K and 256 B apart along N). A
// work item is (a tile of `tile` lanes, i.e. tile / 64 chains, and one node
// group); a persistent grid of as many blocks as fit on the card walks over
// the items, lane tiles fastest. An item's dx rows are read lane-major, 64
// lanes = 256 contiguous bytes a row, as 16-byte vectors with the streaming
// hint, into shared memory (rows padded to 68 / 72 floats, so that the
// fragment reads hit 32 distinct banks), and out goes back the same way. The
// chains of an item are independent: each step waits once for all of their
// products (wgmma.wait_group 0), then each chain forms its A operand while
// the chains before it multiply, so one chain's latency hides behind the
// others'. Waiting for each chain alone (wait_group<chains - 1>) makes
// ptxas serialize the wgmmas (C7514) and measured no faster.
//
// What bounds it on an H100 (at the main path's width, B = 32768, 97 nodes,
// inner 64): the fma mode's 6.5e9 useful flops take 0.097 ms at the 67 TFLOP/s
// f32 rate, above the 0.030 ms of its 102 MB of traffic. The tensor-core
// modes' useful flops take 0.0066 ms (bf16, 989 TFLOP/s dense) and 0.013 ms
// (TF32, 495 TFLOP/s, counted once as the function needs them), so both are
// bound by bytes. The serial chain leaves them far from that: every step a
// thread forms its A operand (an FMA and a conversion a value, three more
// for the TF32 split), and every product is a wgmma of N = 16, a shape that
// costs the tensor cores of an SM tens of cycles whatever its work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The modes of bp_shared_rows_f32.
enum { kModeFma = 0, kModeBf16 = 1, kMode3xTf32 = 2 };

namespace {

constexpr int kN = 4;             // n = nFx = 4, the reference's shapes
constexpr int kMaxTile = 512;     // lanes per block (fma), per work item (tensor cores)
constexpr int kChainLanes = 64;   // lanes a tensor-core chain: wgmma's M

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// ---- fma: one thread per (lane, node) ------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kMaxTile)
shared_rows_fma_kernel(const T* __restrict__ Fx, const T* __restrict__ dx, T* __restrict__ out,
                       int B, int inner) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const long long node = blockIdx.y;
  if (lane >= B) return;
  T f[kN * kN];
#pragma unroll
  for (int i = 0; i < kN * kN; ++i) f[i] = Fx[i];
  const T* d = dx + node * kN * B + lane;
  T dv[kN], acc[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    dv[k] = d[(long long)k * B];
    acc[k] = T(0);
  }
  const T chain = T(1e-9);
  for (int it = 0; it < inner; ++it) {
    T cur[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) cur[k] = fma_t(chain, acc[k], dv[k]);
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      T s = f[r * kN] * cur[0];
#pragma unroll
      for (int k = 1; k < kN; ++k) s = fma_t(f[r * kN + k], cur[k], s);
      acc[r] = s;
    }
  }
  T* o = out + node * kN * B + lane;
#pragma unroll
  for (int r = 0; r < kN; ++r) o[(long long)r * B] = acc[r];
}

#ifndef BP_SHARED_ROWS_FMA_ONLY
// ---- tensor cores: wgmma, a warpgroup a work item --------------------------------------

constexpr int kWarpgroup = 128;   // threads of a block
constexpr float kChain = 1e-9f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;   // the value of `a` goes to the upper half, `b` to the lower
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// round to TF32 (10 mantissa bits), to nearest with ties away from zero, as
// cvt.rna.tf32.f32 does for finite values and as the plain version's
// _round_tf32 does, in two integer instructions (cvt.rna takes four)
__device__ __forceinline__ uint32_t to_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// A shared-memory matrix descriptor, no swizzle: bits 0-13 the address / 16,
// 16-29 the byte offset between core matrices along K / 16, 32-45 along N / 16
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// the byte offset of B's row n (N) at byte kb of its K extent, in that layout
__device__ __forceinline__ int core_offset(int n, int kb) {
  return (n >> 3) * 256 + (kb >> 4) * 128 + (n & 7) * 16 + (kb & 15);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of an accumulator across the
// wgmma fences and waits
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 16, f32) = A (64 x 16, bf16, registers) . B (16 x 16, bf16, shared)
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

// D (64 x 16, f32) (+)= A (64 x 8, tf32, registers) . B (8 x 16, tf32, shared)
template <int Accumulate>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(Accumulate));
}

// Fragment places (PTX ISA, wgmma register fragments; per warp w of the
// warpgroup, g = lane / 4, t = lane % 4): D register 4q + 2h + e holds (row
// 16w + g + 8h, column 8q + 2t + e); bf16 A register 2q + h holds columns
// 8q + 2t, 8q + 2t + 1 of row 16w + g + 8h; tf32 A register h + 2s holds
// (row 16w + g + 8h, column t + 4s). A mode's chain state is kAcc f32
// accumulator registers, from which value(i) gives the chain's acc at D
// register i; prepare forms the next A operand from it, and issue<P> issues
// the mode's P-th wgmma of a step.
template <int MODE> struct Tc;

template <> struct Tc<kModeBf16> {
  static constexpr int kP = 4;        // nodes a chain
  static constexpr int kRegs = 8;     // D registers a thread
  static constexpr int kAcc = 8;      // accumulator registers a thread: D
  static constexpr int kA = 4;        // A registers a thread
  static constexpr int kPasses = 1;   // wgmmas a step
  static constexpr int kPitch = 68;   // staged row pitch in floats
  // the staged row (node in the group * 4 + row of the node) and lane of D register i
  static __device__ __forceinline__ int row(int i, int t) { return 8 * (i >> 2) + 2 * t + (i & 1); }
  static __device__ __forceinline__ int lane(int i, int w, int g) {
    return 16 * w + g + 8 * ((i >> 1) & 1);
  }
  // B: word `tid` of 128 holds columns 2 (tid % 8), +1 of B row n = tid / 8
  static __device__ __forceinline__ void fill_b(const float* Fx, uint32_t* bsm, int tid) {
    const int n = tid >> 3, kk = 2 * (tid & 7);
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[e] = ((kk + e) >> 2) == (n >> 2) ? Fx[(n & 3) * kN + ((kk + e) & 3)] : 0.f;
    bsm[core_offset(n, 2 * kk) >> 2] = pack_bf16(v[0], v[1]);
  }
  static __device__ __forceinline__ float value(const float (&acc)[kAcc], int i) { return acc[i]; }
  static __device__ __forceinline__ void prepare(const float (&acc)[kAcc], const float (&dv)[kRegs],
                                                 uint32_t (&a)[kA]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[j] = pack_bf16(fmaf(kChain, acc[2 * j], dv[2 * j]),
                       fmaf(kChain, acc[2 * j + 1], dv[2 * j + 1]));
  }
  template <int P>
  static __device__ __forceinline__ void issue(float (&acc)[kAcc], const uint32_t (&a)[kA],
                                               uint64_t desc, uint64_t) {
    wgmma_bf16(acc, a, desc);
  }
};

// 3xtf32: D is 64 x 16, two 8-column halves: d1 (registers 0-3) = big*small
// + small*big and d2 (4-7) = big*big, summed in f32 as the plain version sums
// the passes. Two products a step: A = big times B = [small | big] (d1 and
// d2 at once), then A = small times B = [big | 0] accumulated.
template <> struct Tc<kMode3xTf32> {
  static constexpr int kP = 2;
  static constexpr int kRegs = 4;
  static constexpr int kAcc = 8;
  static constexpr int kA = 8;        // big (0-3) and small (4-7)
  static constexpr int kPasses = 2;
  static constexpr int kPitch = 72;
  static __device__ __forceinline__ int row(int i, int t) { return 4 * (i & 1) + t; }
  static __device__ __forceinline__ int lane(int i, int w, int g) { return 16 * w + g + 8 * (i >> 1); }
  // B = [small | big] (words 0-127) and [big | 0] (128-255), each 16 rows of
  // N by 8 columns of K: word e of a matrix holds B row n = e / 8 (its half
  // n / 8), column kk = e % 8, of the packed Fx^T (row n % 8)
  static __device__ __forceinline__ void fill_b(const float* Fx, uint32_t* bsm, int tid) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int word = tid + 128 * u, m = word >> 7, n = (word >> 3) & 15, kk = word & 7;
      const int nn = n & 7;
      const float v = (kk >> 2) == (nn & 1) ? Fx[(nn >> 1) * kN + (kk & 3)] : 0.f;
      const uint32_t big = to_tf32(v), small = to_tf32(v - __uint_as_float(big));
      const uint32_t val = m == 0 ? (n < 8 ? small : big) : (n < 8 ? big : 0u);
      bsm[128 * m + (core_offset(n, 4 * kk) >> 2)] = val;
    }
  }
  static __device__ __forceinline__ float value(const float (&acc)[kAcc], int i) {
    return acc[i] + acc[4 + i];
  }
  static __device__ __forceinline__ void prepare(const float (&acc)[kAcc], const float (&dv)[kRegs],
                                                 uint32_t (&a)[kA]) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float c = fmaf(kChain, value(acc, 2 * h + s), dv[2 * h + s]);
        a[h + 2 * s] = to_tf32(c);
        a[4 + h + 2 * s] = to_tf32(c - __uint_as_float(a[h + 2 * s]));
      }
  }
  template <int P>
  static __device__ __forceinline__ void issue(float (&acc)[kAcc], const uint32_t (&a)[kA],
                                               uint64_t b0, uint64_t b1) {
    if constexpr (P == 0) wgmma_tf32<0>(acc, a, b0);        // big * [small | big]
    if constexpr (P == 1) wgmma_tf32<1>(acc, a + 4, b1);    // + small * [big | 0]
  }
};

template <int MODE, int G>
__global__ void __launch_bounds__(kWarpgroup)
shared_rows_wgmma_kernel(const float* __restrict__ Fx, const float* __restrict__ dx,
                         float* __restrict__ out, int B, int nodes, int inner, int vec) {
  using M = Tc<MODE>;
  constexpr int kRows = kN * M::kP;                        // staged rows a chain
  constexpr int kVecs = G * kRows * (kChainLanes / 4);     // 16-byte vectors an item
  __shared__ __align__(128) uint32_t bsm[256];
  __shared__ __align__(16) float stage[G * kRows * M::kPitch];
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  M::fill_b(Fx, bsm, tid);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
  __syncthreads();
  const uint64_t desc0 = smem_desc(bsm), desc1 = smem_desc(bsm + 128);
  const int tiles = (B + G * kChainLanes - 1) / (G * kChainLanes);
  const long long items = (long long)tiles * ((nodes + M::kP - 1) / M::kP);
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int lane0 = (int)(item % tiles) * (G * kChainLanes);
    const int node0 = (int)(item / tiles) * M::kP;
    for (int v = tid; v < kVecs; v += kWarpgroup) {
      const int c = v / (kRows * 16), row = (v >> 4) % kRows, q = v & 15;
      const int lane = lane0 + c * kChainLanes + 4 * q, node = node0 + row / kN;
      float4 x = {0.f, 0.f, 0.f, 0.f};
      if (node < nodes) {
        const float* src = dx + ((long long)node * kN + row % kN) * B + lane;
        if (vec) {
          if (lane < B) x = __ldcs(reinterpret_cast<const float4*>(src));
        } else {
          x.x = lane < B ? src[0] : 0.f;
          x.y = lane + 1 < B ? src[1] : 0.f;
          x.z = lane + 2 < B ? src[2] : 0.f;
          x.w = lane + 3 < B ? src[3] : 0.f;
        }
      }
      *reinterpret_cast<float4*>(&stage[(c * kRows + row) * M::kPitch + 4 * q]) = x;
    }
    __syncthreads();
    float dv[G][M::kRegs], acc[G][M::kAcc];
    uint32_t a[G][M::kA];
#pragma unroll
    for (int c = 0; c < G; ++c) {
#pragma unroll
      for (int i = 0; i < M::kRegs; ++i)
        dv[c][i] = stage[(c * kRows + M::row(i, t)) * M::kPitch + M::lane(i, w, g)];
#pragma unroll
      for (int i = 0; i < M::kAcc; ++i) acc[c][i] = 0.f;
    }
    for (int it = 0; it < inner; ++it) {
      // every chain's previous products have landed; each chain forms its A
      // operand and issues its products while the chains before it
      // multiply, and one commit closes the step
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < G; ++c) pin(acc[c]);
#pragma unroll
      for (int c = 0; c < G; ++c) {
        M::prepare(acc[c], dv[c], a[c]);
        wg_fence();
        M::template issue<0>(acc[c], a[c], desc0, desc1);
        if constexpr (M::kPasses > 1) M::template issue<1>(acc[c], a[c], desc0, desc1);
      }
      wg_commit();
    }
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < G; ++c) pin(acc[c]);
    __syncthreads();                      // every fragment read before the stage is rewritten
#pragma unroll
    for (int c = 0; c < G; ++c)
#pragma unroll
      for (int i = 0; i < M::kRegs; ++i)
        stage[(c * kRows + M::row(i, t)) * M::kPitch + M::lane(i, w, g)] = M::value(acc[c], i);
    __syncthreads();
    for (int v = tid; v < kVecs; v += kWarpgroup) {
      const int c = v / (kRows * 16), row = (v >> 4) % kRows, q = v & 15;
      const int lane = lane0 + c * kChainLanes + 4 * q, node = node0 + row / kN;
      if (node >= nodes || lane >= B) continue;
      const float4 x = *reinterpret_cast<const float4*>(&stage[(c * kRows + row) * M::kPitch + 4 * q]);
      float* dst = out + ((long long)node * kN + row % kN) * B + lane;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(dst), x);
      } else {
        dst[0] = x.x;
        if (lane + 1 < B) dst[1] = x.y;
        if (lane + 2 < B) dst[2] = x.z;
        if (lane + 3 < B) dst[3] = x.w;
      }
    }
    __syncthreads();                      // the stage is read before the next item's loads
  }
}

template <int MODE, int G>
int launch_tc(const float* f, const float* d, float* o, int B, int nodes, int inner, int device,
              cudaStream_t s) {
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shared_rows_wgmma_kernel<MODE, G>,
                                                      kWarpgroup, 0);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)((B + G * kChainLanes - 1) / (G * kChainLanes)) *
                          ((nodes + Tc<MODE>::kP - 1) / Tc<MODE>::kP);
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(items < fit ? items : fit);
  const int vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(o) % 16 == 0;
  shared_rows_wgmma_kernel<MODE, G><<<blocks, kWarpgroup, 0, s>>>(f, d, o, B, nodes, inner, vec);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_tc_mode(int chains, const float* f, const float* d, float* o, int B, int nodes,
                   int inner, int device, cudaStream_t s) {
  switch (chains) {
    case 1: return launch_tc<MODE, 1>(f, d, o, B, nodes, inner, device, s);
    case 2: return launch_tc<MODE, 2>(f, d, o, B, nodes, inner, device, s);
    case 3: return launch_tc<MODE, 3>(f, d, o, B, nodes, inner, device, s);
    case 4: return launch_tc<MODE, 4>(f, d, o, B, nodes, inner, device, s);
    case 5: return launch_tc<MODE, 5>(f, d, o, B, nodes, inner, device, s);
    case 6: return launch_tc<MODE, 6>(f, d, o, B, nodes, inner, device, s);
    case 7: return launch_tc<MODE, 7>(f, d, o, B, nodes, inner, device, s);
    case 8: return launch_tc<MODE, 8>(f, d, o, B, nodes, inner, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // BP_SHARED_ROWS_FMA_ONLY

// fma: `tile` lanes a block, a multiple of 32 from 32 to 512; the tensor-core
// modes: `tile` lanes a work item, a multiple of 64 from 64 to 512
bool bad_shape(int mode, int B, int nodes, int inner, int tile) {
  const int unit = mode == kModeFma ? 32 : kChainLanes;
  return B < 1 || nodes < 1 || nodes > 65535 || inner < 1 || tile < unit || tile > kMaxTile ||
         tile % unit != 0;
}

template <typename T>
int launch_fma(const void* Fx, const void* dx, void* out, int B, int nodes, int inner, int tile,
               int device, void* stream) {
  if (bad_shape(kModeFma, B, nodes, inner, tile)) return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((B + tile - 1) / tile), (unsigned)nodes);
  shared_rows_fma_kernel<T><<<grid, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Fx), static_cast<const T*>(dx), static_cast<T*>(out), B, inner);
  return (int)cudaGetLastError();
}

}  // namespace

// Fx: (4, 4) row-major; dx, out: (nodes, 4, B) contiguous, on CUDA device
// `device`; out must not overlap the inputs. `tile`: in the fma mode the
// lanes a block covers, one thread each (a multiple of 32, at most 512); in
// the tensor-core modes the lanes a warpgroup's work item covers, 64 a chain
// (a multiple of 64, at most 512). Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); does not synchronize. A build
// with BP_SHARED_ROWS_FMA_ONLY checks the tensor-core modes' arguments and
// then returns cudaErrorNotSupported.
extern "C" int bp_shared_rows_f32(int mode, const void* Fx, const void* dx, void* out, int B,
                                  int nodes, int inner, int tile, int device, void* stream) {
  if (mode == kModeFma)
    return launch_fma<float>(Fx, dx, out, B, nodes, inner, tile, device, stream);
  if ((mode != kModeBf16 && mode != kMode3xTf32) || bad_shape(mode, B, nodes, inner, tile))
    return (int)cudaErrorInvalidValue;
#ifndef BP_SHARED_ROWS_FMA_ONLY
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int chains = tile / kChainLanes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(Fx);
  const float* d = static_cast<const float*>(dx);
  float* o = static_cast<float*>(out);
  return mode == kModeBf16 ? launch_tc_mode<kModeBf16>(chains, f, d, o, B, nodes, inner, device, s)
                           : launch_tc_mode<kMode3xTf32>(chains, f, d, o, B, nodes, inner, device,
                                                         s);
#else
  return (int)cudaErrorNotSupported;
#endif
}

// The fma mode in double (the CPU build's check against the plain version).
extern "C" int bp_shared_rows_fma_f64(const void* Fx, const void* dx, void* out, int B, int nodes,
                                      int inner, int tile, int device, void* stream) {
  return launch_fma<double>(Fx, dx, out, B, nodes, inner, tile, device, stream);
}
