// proj_soc.cu -- batched projection of rows (t, u) onto the second-order cone
// {(t, u): ||u|| <= t}, on Hopper (sm_90a).
//
// Replaces the TPU kernel belief_planning_tpu/ops/pallas_kernels.py:
// proj_soc_pallas (body _soc_kernel), the z-update of the CVaR cone ADMM
// (one cone per tree stage). Its plain PyTorch version is _proj_soc_batch in
// belief_planning_tpu_torch/solvers/cvar.py. The formula is _soc_kernel's:
// nu = sqrt(sum u*u); the row is kept where nu <= t ("inside", tested
// first), zeroed where nu <= -t ("below"), and otherwise scaled by
// a = 0.5 * (1 + t / max(nu, 1e-30)): (a * nu, a * u).
//
// What bounds it on an H100: memory traffic. Each row is read once and
// written once, 2 * k scalars; at the CVaR ADMM's shape (32768 trees x 97
// stages, k = 8) that is 407 MB in f64 (the ADMM's dtype) and 203 MB in f32,
// 0.121 / 0.061 ms at 3.35 TB/s, and far more than the 50 MB L2 holds. Its
// arithmetic (about 3k + 10 operations a row) is ~100x below the card's rate.
//
// Two paths, chosen by the launch (bp_proj_soc_path says which one a call
// takes):
//
//   team (k = 8, both pointers 16-byte aligned: the ADMM's cone rows). A row
//     is 32 B (f32) or 64 B (f64), read by a team of 2 or 4 consecutive lanes,
//     one 16-byte vector each, so a warp's load is 512 contiguous bytes and
//     every 32-byte sector is used whole. The team sums its partial ||u||^2
//     with __shfl_xor_sync (a butterfly: every lane ends with the same bits,
//     as x + y == y + x), lane 0 of the team broadcasts t with __shfl_sync,
//     and each lane writes its own vector back. Loads and stores carry the
//     streaming hint (__ldcs / __stcs): nothing is read twice. A grid of as
//     many 256-thread blocks as fit on the card (cudaOccupancy...) strides
//     over the rows, each thread holding kUnroll = 4 loads in flight: 64 B a
//     thread, 64 KB an SM at 4 blocks an SM (the __launch_bounds__ minimum)
//     and 128 KB at 8, against the ~20 KB an SM that 3.35 TB/s over ~800 ns
//     of latency asks for.
//   general (any other k from 1 to kMaxK, or a pointer that is not 16-byte
//     aligned): one thread per row, the row in registers (the first design).
//
// The order of the sum ||u||^2 differs between the paths and from the plain
// version by a few ulps of ||u||; rows whose squares sum exactly (the tie
// rows ||u|| = |t| of small integers, u = 0) give the same bits on all three.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kThreads = 256;
constexpr int kTeamK = 8;        // the team path's row length (the ADMM's cone rows)
constexpr int kUnroll = 4;       // 16-byte loads a thread holds in flight
constexpr unsigned kFull = 0xffffffffu;

// max(nu, 1e-30) that keeps a NaN, as jnp.maximum / torch.clamp do
template <typename T>
__device__ __forceinline__ T clamp_den(T nu) {
  return (nu != nu || nu > T(1e-30)) ? nu : T(1e-30);
}

// ---- general: one thread per row -----------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
proj_soc_kernel(const T* __restrict__ v, T* __restrict__ out, long long rows, int k) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* vr = v + r * k;
  T* orow = out + r * k;
  T u[kMaxK];
  const T t = vr[0];
  T ss = T(0);
#pragma unroll
  for (int i = 1; i < kMaxK; ++i) {
    if (i < k) {
      u[i] = vr[i];
      ss += u[i] * u[i];
    }
  }
  const T nu = sqrt(ss);
  const bool inside = nu <= t;
  const bool below = nu <= -t;
  const T a = T(0.5) * (T(1) + t / clamp_den(nu));
  const T scale = inside ? T(1) : (below ? T(0) : a);
  orow[0] = inside ? t : (below ? T(0) : a * nu);
#pragma unroll
  for (int i = 1; i < kMaxK; ++i)
    if (i < k) orow[i] = u[i] * scale;
}

// ---- team: 16 bytes a lane, kTeamK * sizeof(T) / 16 lanes a row ----------------------
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using V = float4;
  static __device__ __forceinline__ void get(const V& a, float (&e)[4]) {
    e[0] = a.x; e[1] = a.y; e[2] = a.z; e[3] = a.w;
  }
  static __device__ __forceinline__ V make(const float (&e)[4]) { return V{e[0], e[1], e[2], e[3]}; }
};
template <> struct Vec16<double> {
  using V = double2;
  static __device__ __forceinline__ void get(const V& a, double (&e)[2]) { e[0] = a.x; e[1] = a.y; }
  static __device__ __forceinline__ V make(const double (&e)[2]) { return V{e[0], e[1]}; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
proj_soc_team_kernel(const T* __restrict__ v, T* __restrict__ out, long long rows) {
  using W = Vec16<T>;
  using V = typename W::V;
  constexpr int kPer = 16 / (int)sizeof(T);     // scalars a lane holds: 4 (f32), 2 (f64)
  constexpr int kTeam = kTeamK / kPer;          // lanes a row: 2 (f32), 4 (f64)
  const V* vin = reinterpret_cast<const V*>(v);
  V* vout = reinterpret_cast<V*>(out);
  const long long nvec = rows * kTeam;
  const int lane = threadIdx.x & 31;
  const int head = lane & ~(kTeam - 1);         // the team's lane 0: its first scalar is t
  const bool is_head = lane == head;
  const long long chunk = (long long)kThreads * kUnroll;
  // the bound is the same for the whole block, so whole warps run the
  // shuffles; a team lies wholly inside or wholly outside the rows (nvec and
  // every index of a team's lane 0 are multiples of kTeam)
  for (long long base = (long long)blockIdx.x * chunk; base < nvec;
       base += (long long)gridDim.x * chunk) {
    V x[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = base + (long long)j * kThreads + threadIdx.x;
      if (i < nvec) {
        x[j] = __ldcs(vin + i);
      } else {
        T z[kPer] = {};
        x[j] = W::make(z);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = base + (long long)j * kThreads + threadIdx.x;
      T e[kPer];
      W::get(x[j], e);
      // this lane's part of ||u||^2, then the team's sum
      T ss = is_head ? T(0) : e[0] * e[0];
#pragma unroll
      for (int q = 1; q < kPer; ++q) ss += e[q] * e[q];
#pragma unroll
      for (int m = 1; m < kTeam; m <<= 1) ss += __shfl_xor_sync(kFull, ss, m);
      const T t = __shfl_sync(kFull, e[0], head);
      const T nu = sqrt(ss);
      const bool inside = nu <= t;
      const bool below = nu <= -t;
      const T a = T(0.5) * (T(1) + t / clamp_den(nu));
      const T scale = inside ? T(1) : (below ? T(0) : a);
      T o[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) o[q] = e[q] * scale;
      if (is_head) o[0] = inside ? t : (below ? T(0) : a * nu);
      if (i < nvec) __stcs(vout + i, W::make(o));
    }
  }
}

bool team_path(const void* v, const void* out, int k) {
  return k == kTeamK && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <typename T>
int launch(const void* v, void* out, long long rows, int k, int device, void* stream) {
  if (rows < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (team_path(v, out, k)) {
    int sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, proj_soc_team_kernel<T>,
                                                        kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    const long long vecs = rows * (kTeamK * (long long)sizeof(T) / 16);
    const long long chunks = (vecs + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const unsigned blocks = (unsigned)(chunks < fit ? chunks : fit);
    proj_soc_team_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<T*>(out), rows);
  } else {
    const unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
    proj_soc_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<T*>(out), rows, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// v, out: (rows, k) row-major, contiguous, on CUDA device `device`; out must
// not overlap v. Launches on `stream` and returns the cudaError_t of the
// launch (0 on success); does not synchronize.
extern "C" int bp_proj_soc_f32(const void* v, void* out, long long rows, int k, int device,
                               void* stream) {
  return launch<float>(v, out, rows, k, device, stream);
}

extern "C" int bp_proj_soc_f64(const void* v, void* out, long long rows, int k, int device,
                               void* stream) {
  return launch<double>(v, out, rows, k, device, stream);
}

// the path a launch with these pointers and row length takes: 1 team, 0 general
extern "C" int bp_proj_soc_path(const void* v, const void* out, int k) {
  return team_path(v, out, k) ? 1 : 0;
}

// the largest row length k the kernel takes
extern "C" int bp_proj_soc_max_k() { return kMaxK; }
