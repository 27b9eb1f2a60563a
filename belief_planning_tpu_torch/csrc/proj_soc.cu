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
// Design: one thread per row, the row held in registers (a compile-time
// maximum of kMaxK entries, fully unrolled; the wrapper raises above it).
// The array is row-major (rows, k): a thread reads its row's k consecutive
// words, so a warp reads 32 * k consecutive words and every 32-byte sector
// it touches is used whole (through L1).
//
// What bounds it on an H100: memory traffic. Each row is read once and
// written once, 2 * k scalars; at the CVaR ADMM's shape (32768 trees x 97
// stages, k = 8, f32) that is 204 MB, 0.061 ms at 3.35 TB/s. Its arithmetic
// (about 3k + 10 operations a row) is ~100x below the card's f32 rate.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kThreads = 256;

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
  // max(nu, 1e-30) that keeps a NaN, as jnp.maximum / torch.clamp do
  const T den = (nu != nu || nu > T(1e-30)) ? nu : T(1e-30);
  const T a = T(0.5) * (T(1) + t / den);
  const T scale = inside ? T(1) : (below ? T(0) : a);
  orow[0] = inside ? t : (below ? T(0) : a * nu);
#pragma unroll
  for (int i = 1; i < kMaxK; ++i)
    if (i < k) orow[i] = u[i] * scale;
}

template <typename T>
int launch(const void* v, void* out, long long rows, int k, int device, void* stream) {
  if (rows < 1 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
  proj_soc_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<T*>(out), rows, k);
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

// the largest row length k the kernel takes
extern "C" int bp_proj_soc_max_k() { return kMaxK; }
