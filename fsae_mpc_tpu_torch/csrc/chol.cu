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
// and 4 slacks; n = 163 for Hermite-Simpson collocation at N = 40: 162
// controls and 1 slack) lives in shared memory for the whole
// factorisation.  Both kernels take 1 <= n <= 192 (MAX_N).  A lane holds
// SLOTS rows of a 32-row panel, a template parameter: 5 for n <= 160
// (the build the n = 84 path has always run, with its registers and
// time) and 6 for 161 <= n <= 192.  Above 48 KB of dynamic shared memory
// a launch opts in (cudaFuncAttributeMaxDynamicSharedMemorySize), once
// per kernel instance and per larger size: K6 at n = 163 takes 56,826
// bytes (861 tiles), at n = 192 77,616 (1,176 tiles); K7 54,768 and
// 75,648 bytes.
//
//   chol_factor_f32: right-looking and blocked, 128 threads a block.  The
//     lower triangle is kept in shared memory as 4x4 tiles, packed tile
//     column by tile column, row-major inside a tile (14.8 KB at n = 84;
//     an n that is not a multiple of 4 is padded with identity rows,
//     which the factorisation leaves as they are; a tile's (row, column)
//     pair is packed in 16 bits, 8 each, for up to 48 tile rows).  For
//     each panel, one
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
//   chol_solve_f32: one warp per instance; lane l owns rows l + 32 p (p <
//     SLOTS), and keeps their entries of y and x in registers
//     for both sweeps.  The lower triangle of L alone (packed row by row,
//     14 KB at n = 84, half the bytes of the whole matrix) is staged in
//     shared memory by 4-byte cp.async copies, a flat walk over its
//     entries (coalesced, no divide per element), one commit group per
//     panel of 32 rows, all in flight at once.  Both sweeps go a panel at
//     a time: the columns (forward) or rows (back) of the panels already
//     done enter as one dot product per row, off the chain; then the
//     panel's own steps run in axpy form: step j broadcasts y_j from its
//     owner lane by __shfl_sync, and each lane below (forward) or above
//     (back) it does one FMA with L_ij (L_ji) times 1/L_jj, which it reads
//     from shared memory off the chain (the other lanes an FMA with 0, so
//     that no divergent branch splits the warp between two shuffles).  A
//     step is one shuffle and one FMA: no reduction, no divide and no
//     shared-memory round trip on the chain.  The forward sweep waits only
//     for its panel's copies; on the H100 the issue of the copies takes as
//     long as the transfer, so the sweeps in fact start once the last copy
//     is issued.  The reciprocals 1/L_jj are taken once per row as its
//     panel lands.
//
// What bounds them.  The factor moves n^2 floats in and out per instance
// and does n^3/6 multiply-adds; the solve reads the lower triangle once
// and does n^2 multiply-adds.  Both are bound by device-memory bytes at
// the main path's widths (chip_smoke.py prints the bounds).  Eight factor
// blocks an SM (registers capped at 64, 15.3 KB of shared memory) hold
// B = 1024 in one wave (at n = 163 shared memory holds four blocks an
// SM, so B = 1024 takes two waves, at n = 192 two blocks, four waves);
// what holds the factor above its bound is that the
// blocks of that wave load, factor and store in step, so the three
// phases' times add up (tools/kernel_variants.py splits them), and the
// factor phase is bound by shared-memory traffic and the 21 panels'
// dependent steps.  The solve is one warp a block, B = 1024 blocks in one
// wave: its time is one block's latency, the loads (at about half the
// memory rate) plus the 2n dependent steps of the sweeps (at n = 163 only
// four blocks of 55 KB fit an SM: two waves of latency-bound warps).
//
// Numerics.  Built without --use_fast_math.  A pivot c_j that is not
// positive (or NaN) becomes NaN before the rsqrt, exactly as the Pallas
// body does, so an indefinite instance comes out NaN from column j on and
// is never clamped: the IPM's finite-iterate rejection and regularisation
// escalation (fsae_mpc_tpu/ops/ipm.py:805-834) key on it.  The solve
// multiplies by 1/L_jj where the Pallas body divides by L_jj; a NaN in L
// makes that instance's x NaN.  Instances never share a block or a warp,
// so the poison cannot reach a neighbour.
//
// Planted faults.  Built with -DCHOL_PLANT=n, the factor or the solve
// carries one deliberate fault; chip_smoke.py builds those copies beside
// the real one and requires its checks to fail them.  Without the macro
// the fault sites compile to nothing.
//   1  one tile of the factor's trailing update is skipped in panel 2
//   2  a pivot that is not positive is clamped to 1e-6 instead of NaN
//   3  the solve skips column 40's update in the forward sweep
//   4  the solve's back sweep reads column j of L in place of row j
//   5  the factor's panel leaves its sixth slot (rows j0 + 160 + lane)
//      unwritten: only the n > 160 build has that slot
//   6  the solve's back sweep drops rows 160 and on from the earlier
//      panels' dot products: only n > 160 has such rows

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef CHOL_PLANT
#define CHOL_PLANT 0
#endif
#define PLANT(n) (CHOL_PLANT == (n))

namespace {

constexpr int MAX_N = 192;
constexpr int DEFAULT_SMEM = 48 * 1024;  // above it a launch opts in
constexpr int LOADS = 8;  // global loads in flight per thread while staging
constexpr int FAC_THREADS = 128;
constexpr int FAC_LOADS = 8;  // float4 loads in flight per thread
// rows of a 32-row panel a lane holds: 5 up to n = 160, 6 up to MAX_N
constexpr int slots_of(int n) { return n <= 160 ? 5 : 6; }

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

// eight blocks an SM at n <= 160 (64 registers a thread); above, shared
// memory holds at most four blocks an SM, so the six-slot build may take
// more registers
template <int SLOTS>
__global__ void __launch_bounds__(FAC_THREADS, SLOTS == 5 ? 8 : 4)
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
      float4 a[SLOTS] = {};                       // rows past np: zeros
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
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
        for (int s = 0; s < SLOTS; ++s) at4(a[s], c) *= d;
#pragma unroll
        for (int c2 = c + 1; c2 < 4; ++c2) {
          const float m = __shfl_sync(0xffffffffu, at4(a[0], c), c2);
#pragma unroll
          for (int s = 0; s < SLOTS; ++s)
            at4(a[s], c2) -= at4(a[s], c) * m;
        }
      }
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int i = j0 + tid + 32 * s;
        if (i < np && !(PLANT(5) && s == 5))
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

// Offset of row i of the packed lower triangle (row-major, no padding).
// Lanes on 32 consecutive rows read column j at tri(i) + j: triangular
// numbers of 32 consecutive integers fall in 32 distinct banks, so the
// forward sweep's column reads are free of bank conflicts, as are the
// back sweep's row reads.
__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

template <int SLOTS>
__global__ void __launch_bounds__(32)
chol_solve_kernel(const float* __restrict__ L, const float* __restrict__ rhs,
                  float* __restrict__ x, int n) {
  extern __shared__ float sm[];
  float* T = sm;                  // row i of L at T + tri(i)
  float* D = T + tri(n);          // 1 / L_ii
  float* V = D + n;               // y by row (forward), then x (back)
  const int lane = threadIdx.x;
  const float* Lb = L + (size_t)blockIdx.x * n * n;
  // the lower triangle, a cp.async group per panel of 32 rows (empty
  // groups past n), all in flight at once: a flat walk over the packed
  // entries t = tri(i) + k, lane-consecutive, (i, k) advanced without a
  // divide
#pragma unroll
  for (int p = 0; p < SLOTS; ++p) {
    const int t1 = tri(min(n, 32 * (p + 1)));
    int i = 32 * p, k = lane;
    while (k > i) k -= ++i;
    for (int t = tri(32 * p) + lane; t < t1; t += 32) {
      __pipeline_memcpy_async(T + t, Lb + (size_t)i * n + k, 4);
      k += 32;
      while (k > i) k -= ++i;
    }
    __pipeline_commit();
  }
  // lane l owns rows l + 32 p: its entries of y and x stay in registers
  // (the panel loops unroll, so p is static; the steps inside a panel stay
  // a loop unrolled by 4, which ran faster than fully unrolled sweeps)
  float y[SLOTS];
#pragma unroll
  for (int p = 0; p < SLOTS; ++p) {
    const int i = 32 * p + lane;
    y[p] = i < n ? rhs[(size_t)blockIdx.x * n + i] : 0.0f;
  }

  // forward substitution L y = b, a panel of rows at a time as it lands:
  // the columns of the panels before enter as one dot product per row
  // (off the chain), then the panel's own columns in axpy form, step j
  // broadcasting y_j L_jj (not yet divided) from its owner lane.  Every
  // lane does each step's FMA, with 0 where its row has no L_ij: no
  // divergent branch between two shuffles.
#pragma unroll
  for (int p = 0; p < SLOTS; ++p) {
    if (32 * p >= n) break;
    __pipeline_wait_prior(SLOTS - 1 - p);
    __syncwarp();
    const int i = 32 * p + lane;
    const bool own = i < n;
    const float* Ti = T + tri(min(i, n - 1));
    if (own) {
      D[i] = 1.0f / Ti[i];
      float acc = 0.0f;
      for (int k = 0; k < 32 * p; ++k)
        if (!(PLANT(3) && k == 40)) acc += Ti[k] * V[k];
      y[p] -= acc;
    }
    __syncwarp();
    const int steps = min(32, n - 32 * p);
#pragma unroll 4
    for (int jj = 0; jj < steps; ++jj) {
      const int j = 32 * p + jj;
      const float raw = __shfl_sync(0xffffffffu, y[p], jj);
      const float lij = Ti[j];
      const float c = lane > jj && !(PLANT(3) && j == 40) ? lij * D[j] : 0.0f;
      y[p] = fmaf(-c, raw, y[p]);
    }
    if (own) {
      y[p] *= D[i];
      V[i] = y[p];
    }
    __syncwarp();
  }

  // back substitution L' x = y, the last panel first: the rows of the
  // panels after enter as one dot product per row, then the panel's own
  // rows j of L in axpy form
#pragma unroll
  for (int p = SLOTS - 1; p >= 0; --p) {
    if (32 * p >= n) continue;
    const int i = 32 * p + lane;
    const bool own = i < n;
    const int ic = min(i, n - 1);
    if (own) {
      float acc = 0.0f;
      for (int j = 32 * (p + 1); j < n; ++j)
        if (!(PLANT(6) && j >= 160)) acc += T[tri(j) + i] * V[j];
      y[p] -= acc;
    }
#pragma unroll 4
    for (int jj = min(31, n - 1 - 32 * p); jj >= 0; --jj) {
      const int j = 32 * p + jj;
      const float raw = __shfl_sync(0xffffffffu, y[p], jj);
      const float lji = PLANT(4) ? T[tri(ic) + j] : T[tri(j) + ic];
      const float c = lane < jj ? lji * D[j] : 0.0f;
      y[p] = fmaf(-c, raw, y[p]);
    }
    if (own) {
      y[p] *= D[i];
      V[i] = y[p];
      x[(size_t)blockIdx.x * n + i] = y[p];
    }
    __syncwarp();
  }
}

// Opt in to more than 48 KB of dynamic shared memory, once per kernel
// instance and per larger size (``opted``: the largest set so far).
template <class Kern>
int opt_in(Kern kern, size_t smem, int& opted) {
  if (smem <= (size_t)DEFAULT_SMEM || (int)smem <= opted) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == 0) opted = (int)smem;
  return err;
}

template <int SLOTS>
int launch_factor(const float* K, float* L, int batch, int n, size_t smem,
                  bool vec, cudaStream_t st) {
  static int opted = 0;
  auto kern = chol_factor_kernel<SLOTS>;
  if (const int err = opt_in(kern, smem, opted)) return err;
  kern<<<batch, FAC_THREADS, smem, st>>>(K, L, n, vec);
  return (int)cudaGetLastError();
}

template <int SLOTS>
int launch_solve(const float* L, const float* rhs, float* x, int batch,
                 int n, size_t smem, cudaStream_t st) {
  static int opted = 0;
  auto kern = chol_solve_kernel<SLOTS>;
  if (const int err = opt_in(kern, smem, opted)) return err;
  kern<<<batch, 32, smem, st>>>(L, rhs, x, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chol_factor_f32(const float* K, float* L, int batch, int n,
                               void* stream) {
  if (batch <= 0 || n <= 0 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const int ntiles = tiles_of(n);
  const size_t smem = sizeof(float) * 16 * ntiles
                      + sizeof(unsigned short) * ntiles;
  // float4 rows where every row of K and L starts on 16 bytes
  const bool vec = n % 4 == 0 && ((uintptr_t)K | (uintptr_t)L) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return slots_of(n) == 5 ? launch_factor<5>(K, L, batch, n, smem, vec, st)
                          : launch_factor<6>(K, L, batch, n, smem, vec, st);
}

extern "C" int chol_solve_f32(const float* L, const float* rhs, float* x,
                              int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)tri(n) + 2 * n);
  const cudaStream_t st = (cudaStream_t)stream;
  return slots_of(n) == 5 ? launch_solve<5>(L, rhs, x, batch, n, smem, st)
                          : launch_solve<6>(L, rhs, x, batch, n, smem, st);
}
