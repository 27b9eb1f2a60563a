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
//   bf16   (reference "mxu", the TPU's default one-pass dot): one warp per 16
//          lanes of a node, mma.sync.m16n8k16 with bf16 operands and f32
//          accumulation. The chain update stays in f32; cur and Fx are rounded
//          to bf16 before each product, as the reference's default dot does.
//   3xtf32 (reference "mxu_hi", HIGHEST): the same warp tiling on
//          mma.sync.m16n8k8 in TF32, each operand split a = big + small with
//          big = tf32(a), small = tf32(a - big), summed as
//          small*big + big*small + big*big: an f32-grade product on tensor cores.
//
// Tensor-core layout: lanes on M, n on K, nFx on N, so out[lane, r] =
// sum_k cur[lane, k] * Fx[r, k]; Fx is the B fragment, loaded once, and the
// chained cur is the A fragment. Only K columns 0..3 and N columns 0..3 are
// real: the padded A and B entries are held at zero every step (2x waste on K
// for tf32, 4x for bf16, 2x on N). In m16n8k16 the C fragment of (row, col)
// sits in the same thread and register slot as the A fragment of (row, col)
// for col < 8, so the bf16 chain feeds back without data movement; in
// m16n8k8 (tf32) the A fragment holds column tig where C holds 2tig and
// 2tig + 1, so each step moves the accumulator by two quad shuffles.
//
// What bounds it on an H100 (at the main path's width, B = 32768, 97 nodes,
// inner 64): the fma mode's 6.5e9 useful flops take 0.097 ms at the 67 TFLOP/s
// f32 rate, above the 0.030 ms of its 102 MB of traffic. The tensor-core modes'
// useful flops take 0.0066 ms (bf16, 989 TFLOP/s dense) and 0.039 ms (three
// tf32 passes, 495 TFLOP/s), so the bf16 mode is bound by bytes. The padding,
// the per-step conversions and the serial chain (every step waits for the
// previous mma) are what this simple design leaves on the table; wgmma, TMA
// and a layout that wastes less are for a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kN = 4;             // n = nFx = 4, the reference's shapes
constexpr int kMaxTile = 512;     // lanes per block

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
// ---- tensor cores: one warp per 16 lanes of a node --------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;   // the value of `a` goes to the upper half, `b` to the lower
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  // A registers 2 and 3 (K columns 8..15) and B register 1 (K rows 8..15) are padding: zero
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  // A registers 2 and 3 (K columns 4..7) and B register 1 (K rows 4..7) are padding: zero
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u));
}

// Fragment coordinates (PTX ISA, mma.m16n8k16 / m16n8k8): g = lane / 4 and
// t = lane % 4 of the warp. C: (row g, cols 2t, 2t+1) in c[0], c[1] and
// (row g+8, same cols) in c[2], c[3]. bf16 A register 0 / 1: (row g / g+8,
// cols 2t, 2t+1); B register 0: (K rows 2t, 2t+1, col g). tf32 A register
// 0 / 1: (row g / g+8, col t); B register 0: (K row t, col g).
__global__ void __launch_bounds__(2 * kMaxTile)
shared_rows_bf16_kernel(const float* __restrict__ Fx, const float* __restrict__ dx,
                        float* __restrict__ out, int B, int inner) {
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const int g = lid >> 2, t = lid & 3;
  const long long node = blockIdx.y;
  const int lane0 = (blockIdx.x * (blockDim.x >> 5) + wid) * 16;
  if (lane0 >= B) return;                       // uniform over the warp
  const bool real = t < 2;                      // K columns (and C columns) 2t, 2t+1 < 4
  const uint32_t b0 = (real && g < kN) ? pack_bf16(Fx[g * kN + 2 * t], Fx[g * kN + 2 * t + 1])
                                       : 0u;
  const int la = lane0 + g, lb = lane0 + g + 8;
  const float* d = dx + node * kN * B;
  float dv[4] = {0.f, 0.f, 0.f, 0.f};           // (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
  if (real) {
    if (la < B) { dv[0] = d[(long long)(2 * t) * B + la]; dv[1] = d[(long long)(2 * t + 1) * B + la]; }
    if (lb < B) { dv[2] = d[(long long)(2 * t) * B + lb]; dv[3] = d[(long long)(2 * t + 1) * B + lb]; }
  }
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < inner; ++it) {
    float cur[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i] = real ? fmaf(1e-9f, c[i], dv[i]) : 0.f;
    mma_bf16(c, pack_bf16(cur[0], cur[1]), pack_bf16(cur[2], cur[3]), b0);
  }
  if (real) {
    float* o = out + node * kN * B;
    if (la < B) { o[(long long)(2 * t) * B + la] = c[0]; o[(long long)(2 * t + 1) * B + la] = c[1]; }
    if (lb < B) { o[(long long)(2 * t) * B + lb] = c[2]; o[(long long)(2 * t + 1) * B + lb] = c[3]; }
  }
}

__global__ void __launch_bounds__(2 * kMaxTile)
shared_rows_3xtf32_kernel(const float* __restrict__ Fx, const float* __restrict__ dx,
                          float* __restrict__ out, int B, int inner) {
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const int g = lid >> 2, t = lid & 3;
  const long long node = blockIdx.y;
  const int lane0 = (blockIdx.x * (blockDim.x >> 5) + wid) * 16;
  if (lane0 >= B) return;                       // uniform over the warp
  // B fragment (K row t, col g) = Fx[g][t], split into big + small
  const float fx = g < kN ? Fx[g * kN + t] : 0.f;
  const uint32_t fb = to_tf32(fx);
  const uint32_t fs = to_tf32(fx - __uint_as_float(fb));
  const int la = lane0 + g, lb = lane0 + g + 8;
  const float* d = dx + node * kN * B + (long long)t * B;
  const float da = la < B ? d[la] : 0.f;        // A fragment (g, t) and (g+8, t)
  const float db = lb < B ? d[lb] : 0.f;
  // the C columns 2t', 2t'+1 that hold column t live in quad member t' = t / 2
  const int src = (lid & ~3) | (t >> 1);
  const bool odd = t & 1;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < inner; ++it) {
    const float v0 = __shfl_sync(0xffffffffu, c[0], src), v1 = __shfl_sync(0xffffffffu, c[1], src);
    const float v2 = __shfl_sync(0xffffffffu, c[2], src), v3 = __shfl_sync(0xffffffffu, c[3], src);
    const float ca = fmaf(1e-9f, odd ? v1 : v0, da);
    const float cb = fmaf(1e-9f, odd ? v3 : v2, db);
    const uint32_t ab = to_tf32(ca), bb = to_tf32(cb);
    const uint32_t as = to_tf32(ca - __uint_as_float(ab)), bs = to_tf32(cb - __uint_as_float(bb));
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = 0.f;
    mma_tf32(c, as, bs, fb);                    // small * big
    mma_tf32(c, ab, bb, fs);                    // big * small
    mma_tf32(c, ab, bb, fb);                    // big * big
  }
  if (t < 2) {                                  // C columns 2t, 2t+1 < 4 are real
    float* o = out + node * kN * B;
    if (la < B) { o[(long long)(2 * t) * B + la] = c[0]; o[(long long)(2 * t + 1) * B + la] = c[1]; }
    if (lb < B) { o[(long long)(2 * t) * B + lb] = c[2]; o[(long long)(2 * t + 1) * B + lb] = c[3]; }
  }
}
#endif  // BP_SHARED_ROWS_FMA_ONLY

bool bad_shape(int B, int nodes, int inner, int tile) {
  return B < 1 || nodes < 1 || nodes > 65535 || inner < 1 || tile < 32 || tile > kMaxTile ||
         tile % 32 != 0;
}

template <typename T>
int launch_fma(const void* Fx, const void* dx, void* out, int B, int nodes, int inner, int tile,
               int device, void* stream) {
  if (bad_shape(B, nodes, inner, tile)) return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((B + tile - 1) / tile), (unsigned)nodes);
  shared_rows_fma_kernel<T><<<grid, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Fx), static_cast<const T*>(dx), static_cast<T*>(out), B, inner);
  return (int)cudaGetLastError();
}

}  // namespace

// The modes of bp_shared_rows_f32.
enum { kModeFma = 0, kModeBf16 = 1, kMode3xTf32 = 2 };

// Fx: (4, 4) row-major; dx, out: (nodes, 4, B) contiguous, on CUDA device
// `device`; out must not overlap the inputs. `tile` is the lanes a block
// covers (a multiple of 32, at most 512): one thread each in the fma mode,
// one warp per 16 in the tensor-core modes. Launches on `stream` and returns
// the cudaError_t of the launch (0 on success); does not synchronize.
extern "C" int bp_shared_rows_f32(int mode, const void* Fx, const void* dx, void* out, int B,
                                  int nodes, int inner, int tile, int device, void* stream) {
  if (mode == kModeFma)
    return launch_fma<float>(Fx, dx, out, B, nodes, inner, tile, device, stream);
#ifndef BP_SHARED_ROWS_FMA_ONLY
  if ((mode != kModeBf16 && mode != kMode3xTf32) || bad_shape(B, nodes, inner, tile))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((unsigned)((B + tile - 1) / tile), (unsigned)nodes);
  const dim3 block((unsigned)(2 * tile));      // tile / 16 warps
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(Fx);
  const float* d = static_cast<const float*>(dx);
  float* o = static_cast<float*>(out);
  if (mode == kModeBf16)
    shared_rows_bf16_kernel<<<grid, block, 0, s>>>(f, d, o, B, inner);
  else
    shared_rows_3xtf32_kernel<<<grid, block, 0, s>>>(f, d, o, B, inner);
  return (int)cudaGetLastError();
#else
  return (int)cudaErrorInvalidValue;
#endif
}

// The fma mode in double (the CPU build's check against the plain version).
extern "C" int bp_shared_rows_fma_f64(const void* Fx, const void* dx, void* out, int B, int nodes,
                                      int inner, int tile, int device, void* stream) {
  return launch_fma<double>(Fx, dx, out, B, nodes, inner, tile, device, stream);
}
