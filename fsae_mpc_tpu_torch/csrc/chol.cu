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
//   chol_factor_f32: right-looking and blocked, 128 threads a block.  The
//     lower triangle is kept in shared memory as 4x4 tiles, packed tile
//     column by tile column, row-major inside a tile (14.8 KB at n = 84;
//     an n that is not a multiple of 4 is padded with identity rows,
//     which the factorisation leaves as they are).  For each panel, one
//     tile column (4 columns of L):
//       1. warp 0 factors the panel: each lane holds rows of it in
//          registers; column by column, the pivot and the multipliers of
//          the diagonal tile go round the warp by __shfl_sync, so the
//          panel needs no block barrier;
//       2. after one barrier, every thread takes a row of a tile of the
//          trailing lower triangle (four lanes a tile) and applies the
//          rank-4 update A -= L_i L_j', reading the panel tiles from
//          shared memory as float4 rows: a warp's rows are consecutive
//          there, so the accesses are free of bank conflicts; then one
//          more barrier.
//     Two barriers a panel, 42 at n = 84.  K is read coalesced, its
//     lower triangle only (float4 rows where n is a multiple of 4), and L
//     leaves coalesced, zeros included.  Only the lower triangle of K is
//     used; L's upper triangle is written as zeros.
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
// and does n^3/6 multiply-adds; the solve reads the lower triangle once.
// Both are bound by device-memory bytes at the main path's widths
// (chip_smoke.py prints the bounds).  Eight factor blocks an SM
// (registers capped at 64, 15.3 KB of shared memory) hold B = 1024 in
// one wave; what holds the factor above its bound is that the blocks of
// that wave load, factor and store in step, so the three phases' times
// add up (tools/kernel_variants.py splits them), and the factor phase is
// bound by shared-memory traffic and the 21 panels' dependent steps.
//
// Numerics.  Built without --use_fast_math.  A pivot c_j that is not
// positive (or NaN) becomes NaN before the rsqrt, exactly as the Pallas
// body does, so an indefinite instance comes out NaN from column j on and
// is never clamped: the IPM's finite-iterate rejection and regularisation
// escalation (fsae_mpc_tpu/ops/ipm.py:805-834) key on it.  Instances never
// share a block or a warp, so the poison cannot reach a neighbour.
//
// Planted faults.  Built with -DCHOL_PLANT=n, the factor carries one
// deliberate fault; chip_smoke.py builds those copies beside the real one
// and requires its checks to fail them.  Without the macro the fault
// sites compile to nothing.
//   1  one tile of the trailing update is skipped in panel 2
//   2  a pivot that is not positive is clamped to 1e-6 instead of NaN

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef CHOL_PLANT
#define CHOL_PLANT 0
#endif
#define PLANT(n) (CHOL_PLANT == (n))

namespace {

constexpr int MAX_SMEM = 48 * 1024;
constexpr int LOADS = 8;  // global loads in flight per thread while staging
constexpr int FAC_THREADS = 128;
constexpr int FAC_SLOTS = 5;  // panel rows a lane holds: n up to 160
constexpr int FAC_LOADS = 8;  // float4 loads in flight per thread

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// Floats of the tile-packed lower triangle of an n x n matrix: nt = n/4
// tile rows, rounded up.
__host__ __device__ inline int tiles_of(int n) {
  const int nt = (n + 3) >> 2;
  return nt * (nt + 1) / 2;
}

// Offset of tile (tr, tc), tc <= tr: the tiles of columns < tc come first.
__device__ __forceinline__ int tile_off(int tr, int tc, int nt) {
  return 16 * (tc * nt - tc * (tc - 1) / 2 + tr - tc);
}

// Offset of entry (i, j), j <= i.
__device__ __forceinline__ int entry_off(int i, int j, int nt) {
  return tile_off(i >> 2, j >> 2, nt) + ((i & 3) << 2) + (j & 3);
}

__device__ __forceinline__ float& at4(float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// v - (a . b), the rank-4 update of one entry
__device__ __forceinline__ float sub_dot4(float v, float4 a, float4 b) {
  return v - (a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w);
}

__global__ void __launch_bounds__(FAC_THREADS, 8)
chol_factor_kernel(const float* __restrict__ K, float* __restrict__ L,
                   int n, bool vec) {
  extern __shared__ __align__(16) float sm[];
  const int nt = (n + 3) >> 2, np = 4 * nt, ntiles = nt * (nt + 1) / 2;
  float* S = sm;                                   // the tiles
  unsigned short* pairs = reinterpret_cast<unsigned short*>(S + 16 * ntiles);
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * n * n;
  const float* Kb = K + base;
  float* Lb = L + base;

  // tile index -> (tr, tc), for the trailing update
  for (int t = tid; t < ntiles; t += FAC_THREADS) {
    int tc = 0, rem = t;
    while (rem >= nt - tc) rem -= nt - tc++;
    pairs[t] = (unsigned short)(((tc + rem) << 8) | tc);
  }
  // the lower triangle of K, in batches of loads in flight, a flat walk over
  // (row, quad of columns) or (row, column), with no divide per element
  if (vec) {
    const int nq = n >> 2, total = n * nq;
    int i = tid / nq, q = tid - i * nq;            // this thread's first
    const int di = FAC_THREADS / nq, dq = FAC_THREADS - di * nq;
    for (int t0 = tid; t0 < total; t0 += FAC_LOADS * FAC_THREADS) {
      float4 v[FAC_LOADS];
      int row[FAC_LOADS], quad[FAC_LOADS];
#pragma unroll
      for (int u = 0; u < FAC_LOADS; ++u) {
        row[u] = i;
        quad[u] = q;
        if (t0 + u * FAC_THREADS < total && q <= (i >> 2))
          v[u] = reinterpret_cast<const float4*>(Kb + (size_t)i * n)[q];
        q += dq;
        i += di;
        if (q >= nq) { q -= nq; ++i; }
      }
#pragma unroll
      for (int u = 0; u < FAC_LOADS; ++u)
        if (t0 + u * FAC_THREADS < total && quad[u] <= (row[u] >> 2))
          reinterpret_cast<float4*>(S + tile_off(row[u] >> 2, quad[u], nt))
              [row[u] & 3] = v[u];
    }
  } else {
    // identity rows past n (their lower triangle: 1 on the diagonal)
    for (int t = tid; t < (np - n) * np; t += FAC_THREADS) {
      const int i = n + t / np, j = t - (i - n) * np;
      if (j <= i) S[entry_off(i, j, nt)] = i == j ? 1.0f : 0.0f;
    }
    const int total = n * n;
    int i = tid / n, j = tid - i * n;
    const int di = FAC_THREADS / n, dj = FAC_THREADS - di * n;
    for (int t0 = tid; t0 < total; t0 += LOADS * FAC_THREADS) {
      float v[LOADS];
      int row[LOADS], col[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        row[u] = i;
        col[u] = j;
        if (t0 + u * FAC_THREADS < total && j <= i)
          v[u] = Kb[(size_t)i * n + j];
        j += dj;
        i += di;
        if (j >= n) { j -= n; ++i; }
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        if (t0 + u * FAC_THREADS < total && col[u] <= row[u])
          S[entry_off(row[u], col[u], nt)] = v[u];
    }
  }
  __syncthreads();

  for (int p = 0; p < nt; ++p) {
    const int j0 = 4 * p;
    if (tid < 32) {
      // 1. the panel: lane l holds rows j0 + l + 32 s; rows j0..j0+3 (the
      // diagonal tile) are lanes 0-3 of slot 0
      float4 a[FAC_SLOTS] = {};                   // rows past np: zeros
#pragma unroll
      for (int s = 0; s < FAC_SLOTS; ++s) {
        const int i = j0 + tid + 32 * s;
        if (i < np)
          a[s] = reinterpret_cast<const float4*>(S + tile_off(i >> 2, p, nt))
              [i & 3];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float piv = __shfl_sync(0xffffffffu, at4(a[0], c), c);
        const float d = rsqrtf(piv > 0.0f ? piv : PLANT(2) ? 1e-6f : nan_f());
#pragma unroll
        for (int s = 0; s < FAC_SLOTS; ++s) at4(a[s], c) *= d;
#pragma unroll
        for (int c2 = c + 1; c2 < 4; ++c2) {
          const float m = __shfl_sync(0xffffffffu, at4(a[0], c), c2);
#pragma unroll
          for (int s = 0; s < FAC_SLOTS; ++s)
            at4(a[s], c2) -= at4(a[s], c) * m;
        }
      }
#pragma unroll
      for (int s = 0; s < FAC_SLOTS; ++s) {
        const int i = j0 + tid + 32 * s;
        if (i < np)
          reinterpret_cast<float4*>(S + tile_off(i >> 2, p, nt))[i & 3] = a[s];
      }
    }
    __syncthreads();
    // 2. the trailing update: tiles (tr, tc), p < tc <= tr, are the tile
    // columns after p, contiguous from tile column p + 1 on.  Four lanes
    // take a tile, a row each, so a warp's rows of A and of L_i are
    // consecutive in shared memory, and L_j is a broadcast.
    const int first = (p + 1) * nt - (p + 1) * p / 2;
    if (first < ntiles) {
      const int r = tid & 3;
      for (int t = first + (tid >> 2); t < ntiles; t += FAC_THREADS / 4) {
        const int tr = pairs[t] >> 8, tc = pairs[t] & 0xff;
        if (PLANT(1) && p == 2 && tr == nt - 1 && tc == 5) continue;
        float4* A = reinterpret_cast<float4*>(S + 16 * t) + r;
        const float4 li =
            reinterpret_cast<const float4*>(S + tile_off(tr, p, nt))[r];
        const float4* Lj =
            reinterpret_cast<const float4*>(S + tile_off(tc, p, nt));
        float4 v = *A;
        v.x = sub_dot4(v.x, li, Lj[0]);
        v.y = sub_dot4(v.y, li, Lj[1]);
        v.z = sub_dot4(v.z, li, Lj[2]);
        v.w = sub_dot4(v.w, li, Lj[3]);
        *A = v;
      }
      __syncthreads();
    }
  }

  // L, zeros above the diagonal, in the layout of K
  if (vec) {
    const int nq = n >> 2;
    int i = tid / nq, q = tid - i * nq;
    const int di = FAC_THREADS / nq, dq = FAC_THREADS - di * nq;
    for (int t = tid; t < n * nq; t += FAC_THREADS) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q <= (i >> 2)) {
        v = reinterpret_cast<const float4*>(S + tile_off(i >> 2, q, nt))[i & 3];
        if (q == (i >> 2)) {                       // the diagonal tile
          const int r = i & 3;
          if (r < 3) v.w = 0.0f;
          if (r < 2) v.z = 0.0f;
          if (r < 1) v.y = 0.0f;
        }
      }
      reinterpret_cast<float4*>(Lb + (size_t)i * n)[q] = v;
      q += dq;
      i += di;
      if (q >= nq) { q -= nq; ++i; }
    }
  } else {
    int i = tid / n, j = tid - i * n;
    const int di = FAC_THREADS / n, dj = FAC_THREADS - di * n;
    for (int t = tid; t < n * n; t += FAC_THREADS) {
      Lb[t] = j <= i ? S[entry_off(i, j, nt)] : 0.0f;
      j += dj;
      i += di;
      if (j >= n) { j -= n; ++i; }
    }
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
  if (batch <= 0 || n <= 0 || n > 32 * FAC_SLOTS)
    return (int)cudaErrorInvalidValue;
  const int ntiles = tiles_of(n);
  const size_t smem = sizeof(float) * 16 * ntiles
                      + sizeof(unsigned short) * ntiles;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // float4 rows where every row of K and L starts on 16 bytes
  const bool vec = n % 4 == 0 && ((uintptr_t)K | (uintptr_t)L) % 16 == 0;
  chol_factor_kernel<<<batch, FAC_THREADS, smem, (cudaStream_t)stream>>>(
      K, L, n, vec);
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
