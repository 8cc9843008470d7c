// Batched dense Cholesky factor and solve of the condensed IPM's KKT
// matrices, for Hopper (sm_90a).  Plain C ABI, bound from Python with
// ctypes (fsae_mpc_tpu_torch/ops/kernels/chol.py); every entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
//
// Replaces the TPU Pallas kernels of fsae_mpc_tpu/ops/pallas/chol.py:
//   chol_factor_f32  <- factor_lanes (:98), body _factor_kernel (:44)
//   chol_solve_f32   <- solve_lanes (:116), body _solve_kernel (:64)
//
// Design.  On the TPU the batch rode the 128 vector lanes and one grid
// step factored 128 instances in VMEM.  Here one block takes one
// instance, and the matrix (n = 84 for the dynamic LTV QP: 80 controls
// and 4 slacks) lives in shared memory for the whole factorisation.
//
//   chol_factor_f32: left-looking, as the Pallas body: for column j, the
//     threads of the block (one per row i >= j) form
//       c_i = K_ij - sum_{k<j} L_ik L_jk,
//     then every row is scaled by rsqrt(c_j).  The lower triangle is kept
//     packed column-major in shared memory, so the threads of a warp read
//     consecutive addresses of a column and L_jk is a broadcast: 14.3 KB
//     at n = 84, so that 15 blocks fit an SM and B = 1024 runs in one
//     wave.  Only the lower triangle of K is used; L's upper triangle is
//     written as zeros.
//   chol_solve_f32: one warp per instance.  The lower triangle of L
//     (packed, 14 KB at n = 84) and the right-hand side are staged in
//     shared memory (coalesced loads of the whole matrix, eight in flight
//     per lane, so staging is not one memory latency per row); forward
//     substitution takes a warp-reduced dot product per row (L_jk, k < j,
//     as the Pallas
//     body), back substitution updates the remaining right-hand side with
//     row j of L after each x_j (the transpose of the Pallas body's
//     column dot product, so that it, too, reads rows of L), dividing by
//     L_jj in both sweeps.
//
// What bounds them.  The factor moves n^2 floats in and out per instance
// and does n^3/3 multiply-adds; the solve reads the lower triangle once.
// Both are bound by device-memory bytes at the main path's widths
// (chip_smoke.py prints the bounds); a first version that is far from
// them is expected: the column loop has two block barriers per column.
//
// Numerics.  Built without --use_fast_math.  A pivot c_j that is not
// positive (or NaN) becomes NaN before the rsqrt, exactly as the Pallas
// body does, so an indefinite instance comes out NaN from column j on and
// is never clamped: the IPM's finite-iterate rejection and regularisation
// escalation (fsae_mpc_tpu/ops/ipm.py:805-834) key on it.  Instances never
// share a block or a warp, so the poison cannot reach a neighbour.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_SMEM = 48 * 1024;
constexpr int LOADS = 8;  // global loads in flight per thread while staging

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__global__ void chol_factor_kernel(const float* __restrict__ K,
                                   float* __restrict__ L, int n) {
  // lower triangle, packed column-major: column k at S + off(k),
  // off(k) = k*n - k*(k-1)/2, L_ik at S[off(k) + i - k]
  extern __shared__ float S[];
  __shared__ float piv_s;
  const size_t base = (size_t)blockIdx.x * n * n;
  const float* Kb = K + base;
  float* Lb = L + base;
  const int nn = n * n;
  for (int t0 = threadIdx.x; t0 < nn; t0 += LOADS * blockDim.x) {
    float v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = t0 + u * blockDim.x;
      v[u] = t < nn ? Kb[t] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = t0 + u * blockDim.x;
      const int i = t / n, j = t - i * n;
      if (t < nn && j <= i) S[j * n - j * (j - 1) / 2 + i - j] = v[u];
    }
  }
  __syncthreads();

  const int i = threadIdx.x;  // one row per thread, blockDim.x >= n
  int offj = 0;               // off(j)
  for (int j = 0; j < n; ++j) {
    float c = 0.0f;
    if (i >= j && i < n) {
      float s = 0.0f;
      int offk = 0;
      for (int k = 0; k < j; ++k) {
        s += S[offk + i - k] * S[offk + j - k];
        offk += n - k;
      }
      c = S[offj + i - j] - s;
      if (i == j) piv_s = c;
    }
    __syncthreads();
    const float p = piv_s;
    const float d = rsqrtf(p > 0.0f ? p : nan_f());
    if (i >= j && i < n) S[offj + i - j] = c * d;
    __syncthreads();
    offj += n - j;
  }

  for (int t = threadIdx.x; t < nn; t += blockDim.x) {
    const int r = t / n, c = t - r * n;
    Lb[t] = c <= r ? S[c * n - c * (c - 1) / 2 + r - c] : 0.0f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void chol_solve_kernel(const float* __restrict__ L,
                                  const float* __restrict__ rhs,
                                  float* __restrict__ x, int n) {
  extern __shared__ float sm[];
  float* T = sm;                    // row j of L at T + j * (j + 1) / 2
  float* y = T + n * (n + 1) / 2;   // rhs -> y -> x
  const int lane = threadIdx.x;
  const float* Lb = L + (size_t)blockIdx.x * n * n;
  const int nn = n * n;
  for (int t0 = lane; t0 < nn; t0 += LOADS * 32) {
    float v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = t0 + u * 32;
      v[u] = t < nn ? Lb[t] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = t0 + u * 32;
      const int j = t / n, k = t - j * n;
      if (t < nn && k <= j) T[j * (j + 1) / 2 + k] = v[u];
    }
  }
  for (int k = lane; k < n; k += 32) y[k] = rhs[(size_t)blockIdx.x * n + k];
  __syncwarp();

  // forward substitution  L y = b
  for (int j = 0; j < n; ++j) {
    const float* row = T + j * (j + 1) / 2;
    float s = 0.0f;
    for (int k = lane; k < j; k += 32) s += row[k] * y[k];
    s = warp_sum(s);
    if (lane == 0) y[j] = (y[j] - s) / row[j];
    __syncwarp();
  }
  // back substitution  L' x = y
  for (int j = n - 1; j >= 0; --j) {
    const float* row = T + j * (j + 1) / 2;
    const float xj = y[j] / row[j];
    __syncwarp();
    if (lane == 0) y[j] = xj;
    for (int k = lane; k < j; k += 32) y[k] -= row[k] * xj;
    __syncwarp();
  }
  for (int k = lane; k < n; k += 32) x[(size_t)blockIdx.x * n + k] = y[k];
}

}  // namespace

extern "C" int chol_factor_f32(const float* K, float* L, int batch, int n,
                               void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = (n + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (size_t)n * (n + 1) / 2;
  if (threads > MAX_THREADS || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  chol_factor_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(K, L,
                                                                    n);
  return (int)cudaGetLastError();
}

extern "C" int chol_solve_f32(const float* L, const float* rhs, float* x,
                              int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)n * (n + 1) / 2 + n);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  chol_solve_kernel<<<batch, 32, smem, (cudaStream_t)stream>>>(L, rhs, x, n);
  return (int)cudaGetLastError();
}
