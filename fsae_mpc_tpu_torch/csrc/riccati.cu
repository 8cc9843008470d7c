// Block-Riccati sweeps of the stage-wise interior-point QP solver, for
// Hopper (sm_90a).  Plain C ABI, bound from Python with ctypes
// (fsae_mpc_tpu_torch/ops/kernels/riccati.py); every entry point launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
//
// Replaces the TPU Pallas kernels of fsae_mpc_tpu/ops/pallas/riccati.py:
//   riccati_assemble_factor_f32  <- assemble_factor_lanes (:277),
//                                   body _assemble_factor_kernel (:187)
//   riccati_apply_bwd_f32        <- apply_lanes backward sweep (:386/:422),
//                                   body _bwd_kernel (:338)
//   riccati_apply_fwd_f32        <- apply_lanes forward sweep (:386/:437),
//                                   body _fwd_kernel (:363)
//   riccati_factor_f32           <- factor_lanes (:140), body
//                                   _factor_kernel (:80)
//
// Design.  On the TPU the batch rode the 128 vector lanes and the stage
// loop was the sequential grid axis, with the Riccati carry in VMEM
// scratch.  Here the batch-first layout of the Python API is kept, so one
// instance's data is contiguous, and every sweep is block-cooperative per
// instance:
//
//   K1 assemble_factor: one block of 128 threads per instance, in
//     chunks of whole stages (or, for a long stage, of its rows) from the
//     last stage to the first.  Warps 1-3 stage chunk c + 2 (its rows
//     C | D | Ws | Dr and its A, B) into a ring of four shared-memory
//     buffers with cp.async, coalesced, 16 bytes a copy where the range
//     allows, and assemble chunk c: the assembly is independent across
//     stages, so they split the chunk's (stage, Gram entry) pairs, each
//     an r-term dot product over the rows z = [c | e | w] weighted by Dr,
//     into a tile of Qb, Rb, Mq, Lx, Lu, Hss (which leave as contiguous
//     runs).  Meanwhile warp 0 runs the sequential recursion over chunk
//     c - 1 from the other tile, its lanes owning entries of P, W, WA, V
//     and G.  One block barrier a chunk.
//   K2 apply_bwd: one block per instance (and per KB right-hand sides),
//     a segment of 8 lanes (16 at nx = 9) per rhs, lane j owning entry j
//     of the p carry.  The factor blocks and the rhs' rx, ru, re are
//     staged into a ring of two shared-memory buffers, a chunk of stages
//     at a time, from the last stage to the first, two chunks in flight.
//     Everything off the carry chain (Kg = Hu^-1 G once per instance,
//     Wd = re W' and re M - ru per rhs, A' and B's columns) is computed
//     by all threads per chunk into a record the chain reads with vector
//     loads; the chain exchanges its carry by warp shuffles, with no
//     barrier per stage.  Two block barriers a chunk.
//   K3 apply_fwd: one block per instance (and per KB right-hand sides);
//     a thread owns one (rhs, row) entry of the dx carry.  The factor
//     blocks and the rhs' re, h, w are staged into a ring of three
//     shared-memory buffers a chunk of stages at a time, two chunks
//     ahead, so each factor block is read once per instance, not once
//     per rhs.  The carry passes through shared memory (two buffers, one
//     barrier per stage).
//   K4 factor (once per cold solve): K1 without the assembly.  One block
//     of 128 threads per instance; warps 1-3 stage chunks of whole stages
//     (Qb, Rb, M, A, B) from the last stage down into a ring of three
//     buffers with cp.async, two chunks ahead, while warp 0 runs the
//     recursion over the chunk in hand.  One block barrier a chunk.
//
// K1 and K4 run one recursion, RiccatiWarp::stage.  Instances never share
// arithmetic in any sweep, so a NaN-poisoned instance cannot reach its
// neighbours.
//
// What bounds it.  Each sweep moves its inputs once and its outputs once
// (K1 ~80 KB an instance at N=40, nx=7, r=20, ns=4; K2 ~43 KB and K3
// ~40 KB at K=5; K4 ~31 KB), ~24 us, ~13 us, ~15 us and ~10 us for B=1024
// at the card's memory rate; the arithmetic is tiny (~2 kFLOP per stage
// and rhs).  What holds them above that is latency: each stage of the
// recursions is a chain of dependent dot products (and, in K1 and K3,
// barriers), and the staging needs several chunks in flight per SM to
// cover device-memory latency.  Hence the rings, the chunk sizes
// (AF_STAGE_FLOATS, BWD_SMEM_FLOATS, FWD_STAGE_FLOATS, F4_STAGE_FLOATS)
// and eight resident blocks per SM (K1, K4: registers capped at 64); at
// B=1024 the sweeps run in one wave.

// Planted faults.  Built with -DRICCATI_PLANT=n (n = 1..8), K1, K2, K3 or
// K4 carries one deliberate fault (see PLANT below); chip_smoke.py builds
// those copies beside the real one and requires its comparisons to fail
// them.  Without the macro the fault sites compile to nothing.
//
// Numerics.  Built without --use_fast_math: a non-SPD 2x2 pivot (det <= 0
// or Hu00 <= 0) must come out NaN (K1, K4), never clamped, because the IPM's
// inertia escalation keys on non-finite iterates
// (fsae_mpc_tpu/ops/riccati.py:1009-1019).  P is symmetrised at every
// stage.  nvcc's default FMA contraction stays on: these sweeps hold no
// error-free transforms, and the tolerances against the plain PyTorch
// versions are stated where they are compared.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RICCATI_PLANT
#define RICCATI_PLANT 0
#endif
// fault n is compiled in only under -DRICCATI_PLANT=n:
//   1  K1 drops row 3 of stage 17 from the assembly
//   2  K1 stages its second chunk one stage late
//   3  K3 does not advance the dx carry at stage 17
//   4  K3 swaps right-hand sides 0 and 1 of instance 5
//   5  K2 does not advance the p carry at stage 17
//   6  K2 swaps right-hand sides 0 and 1 of instance 5
//   7  K4 stages its second chunk one stage late
//   8  K4 does not advance P at stage 17
#define PLANT(n) (RICCATI_PLANT == (n))

namespace {

constexpr int NU = 2;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// Closed-form symmetric 2x2 inverse with NaN poison (mirrors
// _factor_kernel :112-122).
__device__ __forceinline__ void inv2_poison(const float (&Hu)[NU][NU],
                                            float (&Hi)[NU][NU]) {
  const float a = Hu[0][0];
  const float b2 = 0.5f * (Hu[0][1] + Hu[1][0]);
  const float c = Hu[1][1];
  float det = a * c - b2 * b2;
  if (!(det > 0.0f && a > 0.0f)) det = nan_f();
  const float idet = 1.0f / det;
  Hi[0][0] = c * idet;
  Hi[0][1] = -b2 * idet;
  Hi[1][0] = -b2 * idet;
  Hi[1][1] = a * idet;
}

// ---------------------------------------------------------------------------
// Staging through shared memory (K1, K2, K3, K4)
// ---------------------------------------------------------------------------

// Floats past the last 16-byte boundary of a global address.
__device__ __forceinline__ int misalign(const float* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

// Where stage_async puts src in the region at dst (16-byte aligned): at
// the same offset mod 16 bytes as src, so the aligned body of the range
// moves 16 bytes a copy.
__device__ __forceinline__ float* staged(float* dst, const float* src) {
  return dst + misalign(src);
}

// Issue cp.async copies of the n floats at src into the shared region dst
// (16-byte aligned, region(n) floats), spread over threads tid of nthr:
// coalesced 16-byte copies for the aligned body, 4-byte ones for the
// ragged head and tail.  The caller commits and waits.
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int n, int tid, int nthr) {
  float* d = staged(dst, src);
  const int head = min(n, (4 - misalign(src)) & 3);
  const int nvec = (n - head) >> 2;
  for (int i = tid; i < head; i += nthr)
    __pipeline_memcpy_async(d + i, src + i, 4);
  for (int i = tid; i < nvec; i += nthr)
    __pipeline_memcpy_async(d + head + 4 * i, src + head + 4 * i, 16);
  for (int i = head + 4 * nvec + tid; i < n; i += nthr)
    __pipeline_memcpy_async(d + i, src + i, 4);
}

// Shared-memory floats of a staged region of n floats: slack for the
// offset, rounded up to keep the next region 16-byte aligned.
__host__ __device__ constexpr int region(int n) { return (n + 3 + 3) & ~3; }

// ---------------------------------------------------------------------------
// The backward Riccati recursion on one warp (K1, K4)
// ---------------------------------------------------------------------------
//
// One stage from its blocks in shared memory: W = Qb + P, V = W B + M,
// Hu = Rb + B'V + M'B, G = V'A, P <- sym(A'WA - G'Hu^-1 G) (P = 0 past the
// last stage); writes the stage's W, G and Hu^-1.  Lane l owns the
// upper-triangle entries l + 32 t of P and W (Qb is symmetric: its upper
// triangle is read), and the entries l + 32 t of WA = W A (row-major).  W,
// WA, V and G pass between the lanes through the warp's record in shared
// memory (rec_floats(NX) floats), three __syncwarp a stage.

// Entry (i, j) of A'WA - G' Hu^-1 G, with WA = W A and G in shared memory.
template <int NX>
__device__ __forceinline__ float p_entry(const float* Ak, const float* WAr,
                                         const float* Gr, float h00,
                                         float h01, float h10, float h11,
                                         int i, int j) {
  const float kg0 = h00 * Gr[j] + h01 * Gr[NX + j];
  const float kg1 = h10 * Gr[j] + h11 * Gr[NX + j];
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < NX; ++m) acc += Ak[m * NX + i] * WAr[m * NX + j];
  return acc - (Gr[i] * kg0 + Gr[NX + i] * kg1);
}

// Floats of the recursion's record: W, WA (nx, nx), V (nx, nu), G (nu, nx).
__host__ __device__ constexpr int rec_floats(int nx) {
  return (2 * nx * nx + 4 * nx + 3) & ~3;
}

template <int NX>
struct RiccatiWarp {
  static constexpr int TRI = NX * (NX + 1) / 2;
  static constexpr int NT = (TRI + 31) / 32;
  static constexpr int NE = (NX * NX + 31) / 32;
  int lane;
  int ui[NT], uj[NT];
  float pv[NT];

  __device__ explicit RiccatiWarp(int lane_) : lane(lane_) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      int a = 0, rem = min(lane + 32 * t, TRI - 1);
      while (rem >= NX - a) rem -= NX - a++;
      ui[t] = a;
      uj[t] = a + rem;
      pv[t] = 0.0f;
    }
  }

  // ``advance`` false keeps P as it was (a planted fault of K4).
  __device__ __forceinline__ void stage(
      const float* Qk, const float* Rk, const float* Mk, const float* Ak,
      const float* Bk, float* rec, float* __restrict__ W_out,
      float* __restrict__ G_out, float* __restrict__ Huinv_out,
      bool advance = true) {
    float* Wr = rec;
    float* WAr = Wr + NX * NX;
    float* Vr = WAr + NX * NX;       // V = W B + M, (nx, nu)
    float* Gr = Vr + NX * NU;        // G = V' A, (nu, nx)
#pragma unroll
    for (int t = 0; t < NT; ++t) {          // W = Qb + P
      if (lane + 32 * t < TRI) {
        const int i = ui[t], j = uj[t];
        const float w = Qk[i * NX + j] + pv[t];
        Wr[i * NX + j] = w;
        Wr[j * NX + i] = w;
        W_out[i * NX + j] = w;
        if (i != j) W_out[j * NX + i] = w;
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < NE; ++t) {          // WA = W A
      const int e = lane + 32 * t;
      if (e < NX * NX) {
        const int i = e / NX, j = e - i * NX;
        float a2 = 0.0f;
#pragma unroll
        for (int m = 0; m < NX; ++m) a2 += Wr[i * NX + m] * Ak[m * NX + j];
        WAr[e] = a2;
      }
    }
    if (lane < NX * NU) {                   // V = W B + M
      const int i = lane / NU, u = lane - i * NU;
      float a2 = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) a2 += Wr[i * NX + j] * Bk[j * NU + u];
      Vr[lane] = a2 + Mk[lane];
    }
    __syncwarp();
    float hu = 0.0f;                        // Hu = Rb + B'V + M'B
    if (lane < NU * NU) {
      const int u = lane / NU, v = lane - u * NU;
      hu = Rk[lane];
#pragma unroll
      for (int i = 0; i < NX; ++i) hu += Bk[i * NU + u] * Vr[i * NU + v];
#pragma unroll
      for (int i = 0; i < NX; ++i) hu += Mk[i * NU + u] * Bk[i * NU + v];
    }
    float Hu[NU][NU], Hi[NU][NU];
    Hu[0][0] = __shfl_sync(0xffffffffu, hu, 0);
    Hu[0][1] = __shfl_sync(0xffffffffu, hu, 1);
    Hu[1][0] = __shfl_sync(0xffffffffu, hu, 2);
    Hu[1][1] = __shfl_sync(0xffffffffu, hu, 3);
    inv2_poison(Hu, Hi);
    if (lane < NU * NX) {                   // G = V' A
      const int u = lane / NX, j = lane - u * NX;
      float a2 = 0.0f;
#pragma unroll
      for (int i = 0; i < NX; ++i) a2 += Vr[i * NU + u] * Ak[i * NX + j];
      Gr[lane] = a2;
      G_out[lane] = a2;
    }
    if (lane < NU * NU)
      Huinv_out[lane] = lane == 0   ? Hi[0][0]
                        : lane == 1 ? Hi[0][1]
                        : lane == 2 ? Hi[1][0]
                                    : Hi[1][1];
    __syncwarp();
    if (!advance) return;
#pragma unroll
    for (int t = 0; t < NT; ++t) {          // P = sym(A'WA - G'Hu^-1 G)
      if (lane + 32 * t < TRI) {
        const int i = ui[t], j = uj[t];
        const float pij = p_entry<NX>(Ak, WAr, Gr, Hi[0][0], Hi[0][1],
                                      Hi[1][0], Hi[1][1], i, j);
        pv[t] = i == j ? pij
                       : 0.5f * (pij + p_entry<NX>(Ak, WAr, Gr, Hi[0][0],
                                                   Hi[0][1], Hi[1][0],
                                                   Hi[1][1], j, i));
      }
    }
  }
};

// ---------------------------------------------------------------------------
// K1: fused quadform assembly + factor sweep, one block per instance
// ---------------------------------------------------------------------------
//
// The assembly is the Gram matrix Z' diag(Dr) Z of each stage's rows
// z = [c (nx) | e (nu) | w (ns)]: its upper triangle (E entries) holds
// Qb - diag(qbd), Mq, Lx, Rb - diag(rbd), Lu and Hss.  A chunk is a
// contiguous run of rows: ch whole stages, or (for a long stage, ch == 1)
// rc of one stage's rows, whose partial sums stay in registers until the
// stage's last rows are in.  Chunks go from the last stage to the first,
// the order of the recursion.
//
// Warps 1-3 (the producers) stage chunk c + AF_AHEAD (its rows, A and B)
// into a ring of AF_RING buffers and assemble chunk c into one of two
// tiles, while warp 0 runs the recursion over chunk c - 1 from the other
// tile; one block barrier a chunk.

constexpr int AF_THREADS = 128;
constexpr int AF_PRODUCERS = AF_THREADS - 32;
constexpr int AF_ITEMS = 4;            // (stage, entry) pairs a producer holds
constexpr int AF_AHEAD = 2;            // chunks in flight past the one assembled
constexpr int AF_RING = AF_AHEAD + 2;  // staging buffers
constexpr int AF_STAGE_FLOATS = 1536;  // one staging buffer

template <int NX, int NS>
struct AfShape {
  static constexpr int M = NX + NU + NS;   // width of a row z
  static constexpr int E = M * (M + 1) / 2;
};

// Shared-memory layout of K1 (offsets in floats, 16-byte aligned).
struct AfLayout {
  int C, D, Ws, Dr, A, B, buf;       // in a staging buffer; buf: its size
  int Q, R, Mq, Lx, Lu, Hss, tile;   // in an assembled tile; tile: its size
  int tiles, rec, pairs, total;
  __host__ __device__ AfLayout(int ch, int rows, int nx, int ns) {
    C = 0;
    D = C + region(rows * nx);
    Ws = D + region(rows * NU);
    Dr = Ws + region(rows * ns);
    A = Dr + region(rows);
    B = A + region(ch * nx * nx);
    buf = B + region(ch * nx * NU);
    Q = 0;
    R = Q + ch * nx * nx;
    Mq = R + ch * NU * NU;
    Lx = Mq + ch * nx * NU;
    Lu = Lx + ch * nx * ns;
    Hss = Lu + ch * NU * ns;
    tile = (Hss + ch * ns * ns + 3) & ~3;
    tiles = AF_RING * buf;
    rec = tiles + 2 * tile;                           // W, WA, V, G
    pairs = rec + rec_floats(nx);
    const int m = nx + NU + ns;
    total = pairs + (m * (m + 1) / 2 + 1) / 2;
  }
};

// Chunk c: stages [k0, k0 + ch), rows [q0, q0 + rc) of each.
struct AfChunk {
  int k0, ch, q0, rc;
  bool last;   // holds the stages' last rows
  __device__ AfChunk(int c, int N, int r, int ch_max, int rc_max) {
    const int nq = (r + rc_max - 1) / rc_max;
    const int ng = (N + ch_max - 1) / ch_max;
    k0 = (ng - 1 - c / nq) * ch_max;
    ch = min(ch_max, N - k0);
    q0 = c % nq * rc_max;
    rc = min(rc_max, r - q0);
    last = q0 + rc == r;
  }
};

template <int NX, int NS>
__global__ void __launch_bounds__(AF_THREADS, 8)
assemble_factor_kernel(
    const float* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ Ws, const float* __restrict__ Dr,
    const float* __restrict__ qbd, const float* __restrict__ rbd,
    const float* __restrict__ Ad, const float* __restrict__ Bd,
    float* __restrict__ Huinv, float* __restrict__ G, float* __restrict__ W,
    float* __restrict__ Mq_out, float* __restrict__ Lx_out,
    float* __restrict__ Lu_out, float* __restrict__ Hss_out, int N, int r,
    int ch_max, int rc_max) {
  using S = AfShape<NX, NS>;
  extern __shared__ __align__(16) float sm[];
  const AfLayout L(ch_max, ch_max * rc_max, NX, NS);
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  unsigned short* pairs = reinterpret_cast<unsigned short*>(sm + L.pairs);

  // the upper triangle of the Gram matrix, row by row: entry -> (a, c)
  for (int e = tid; e < S::E; e += AF_THREADS) {
    int a = 0, rem = e;
    while (rem >= S::M - a) rem -= S::M - a++;
    pairs[e] = (unsigned short)((a << 8) | (a + rem));
  }

  const int nchunk = (N + ch_max - 1) / ch_max * ((r + rc_max - 1) / rc_max);
  const int pt = tid - 32;   // producer thread
  auto row0_of = [&](int c, const AfChunk& x) {
    int64_t row0 = (b * N + x.k0) * r + x.q0;
    if (PLANT(2) && c == 1) row0 += r;
    return row0;
  };
  auto issue = [&](int c) {
    const AfChunk x(c, N, r, ch_max, rc_max);
    const int64_t row0 = row0_of(c, x), s0 = b * N + x.k0;
    const int rows = x.ch * x.rc;
    float* buf = sm + c % AF_RING * L.buf;
    stage_async(buf + L.C, C + row0 * NX, rows * NX, pt, AF_PRODUCERS);
    stage_async(buf + L.D, D + row0 * NU, rows * NU, pt, AF_PRODUCERS);
    stage_async(buf + L.Ws, Ws + row0 * NS, rows * NS, pt, AF_PRODUCERS);
    stage_async(buf + L.Dr, Dr + row0, rows, pt, AF_PRODUCERS);
    stage_async(buf + L.A, Ad + s0 * NX * NX, x.ch * NX * NX, pt,
                AF_PRODUCERS);
    stage_async(buf + L.B, Bd + s0 * NX * NU, x.ch * NX * NU, pt,
                AF_PRODUCERS);
  };

  if (tid >= 32) {
    for (int c = 0; c < AF_AHEAD; ++c) {
      if (c < nchunk) issue(c);
      __pipeline_commit();     // (an empty group past the last chunk)
    }
    __pipeline_wait_prior(AF_AHEAD - 1);   // chunk 0 is in
  }
  __syncthreads();

  // producers: partial Gram sums; warp 0: the recursion's lanes
  float acc[AF_ITEMS];
#pragma unroll
  for (int t = 0; t < AF_ITEMS; ++t) acc[t] = 0.0f;
  RiccatiWarp<NX> rw(tid & 31);

  for (int c = 0; c <= nchunk; ++c) {
    if (tid >= 32) {
      if (c >= 1) {                   // chunk c-1's stages leave, coalesced
        const AfChunk x(c - 1, N, r, ch_max, rc_max);
        if (x.last) {
          const float* T = sm + L.tiles + ((c - 1) & 1) * L.tile;
          const int64_t s0 = b * N + x.k0;
          for (int i = pt; i < x.ch * NX * NU; i += AF_PRODUCERS)
            Mq_out[s0 * NX * NU + i] = T[L.Mq + i];
          for (int i = pt; i < x.ch * NX * NS; i += AF_PRODUCERS)
            Lx_out[s0 * NX * NS + i] = T[L.Lx + i];
          for (int i = pt; i < x.ch * NU * NS; i += AF_PRODUCERS)
            Lu_out[s0 * NU * NS + i] = T[L.Lu + i];
          for (int i = pt; i < x.ch * NS * NS; i += AF_PRODUCERS)
            Hss_out[s0 * NS * NS + i] = T[L.Hss + i];
        }
      }
      if (c < nchunk) {               // assemble chunk c into tile c & 1
        const AfChunk x(c, N, r, ch_max, rc_max);
        const int64_t row0 = row0_of(c, x);
        float* buf = sm + c % AF_RING * L.buf;
        float* T = sm + L.tiles + (c & 1) * L.tile;
        const float* Ct = staged(buf + L.C, C + row0 * NX);
        const float* Dt = staged(buf + L.D, D + row0 * NU);
        const float* Wt = staged(buf + L.Ws, Ws + row0 * NS);
        const float* dt = staged(buf + L.Dr, Dr + row0);
#pragma unroll
        for (int t = 0; t < AF_ITEMS; ++t) {
          const int item = pt + t * AF_PRODUCERS;
          if (item < x.ch * S::E) {
            const int s = item / S::E;
            const int pr = pairs[item - s * S::E];
            const int a = pr >> 8, cc = pr & 0xff;
            // columns a and cc of the rows z: first entry and row stride
            const float* za = a < NX ? Ct + a
                              : a < NX + NU ? Dt + (a - NX)
                                            : Wt + (a - NX - NU);
            const int sa = a < NX ? NX : a < NX + NU ? NU : NS;
            const float* zc = cc < NX ? Ct + cc
                              : cc < NX + NU ? Dt + (cc - NX)
                                             : Wt + (cc - NX - NU);
            const int sc = cc < NX ? NX : cc < NX + NU ? NU : NS;
            const int k = x.k0 + s;
            const int q1 = (s + 1) * x.rc;
            float sum = 0.0f;
#pragma unroll 4
            for (int row = s * x.rc; row < q1; ++row) {
              if (PLANT(1) && k == 17 && x.q0 + row - s * x.rc == 3) continue;
              sum += za[row * sa] * (zc[row * sc] * dt[row]);
            }
            acc[t] += sum;
            if (x.last) {
              float v = acc[t];
              acc[t] = 0.0f;
              if (cc < NX) {                          // Qb
                if (a == cc) v += __ldg(qbd + (b * N + k) * NX + a);
                T[L.Q + s * NX * NX + a * NX + cc] = v;
                T[L.Q + s * NX * NX + cc * NX + a] = v;
              } else if (a < NX && cc < NX + NU) {    // Mq
                T[L.Mq + s * NX * NU + a * NU + (cc - NX)] = v;
              } else if (a < NX) {                    // Lx
                T[L.Lx + s * NX * NS + a * NS + (cc - NX - NU)] = v;
              } else if (cc < NX + NU) {              // Rb
                const int u = a - NX, w = cc - NX;
                if (u == w) v += __ldg(rbd + (b * N + k) * NU + u);
                T[L.R + s * NU * NU + u * NU + w] = v;
                T[L.R + s * NU * NU + w * NU + u] = v;
              } else if (a < NX + NU) {               // Lu
                T[L.Lu + s * NU * NS + (a - NX) * NS + (cc - NX - NU)] = v;
              } else {                                // Hss
                const int i = a - NX - NU, j = cc - NX - NU;
                T[L.Hss + s * NS * NS + i * NS + j] = v;
                T[L.Hss + s * NS * NS + j * NS + i] = v;
              }
            }
          }
        }
      }
      if (c + AF_AHEAD < nchunk) issue(c + AF_AHEAD);
      __pipeline_commit();
      __pipeline_wait_prior(AF_AHEAD - 1);   // chunk c + 1 is in
    } else if (c >= 1) {
      // warp 0: the backward recursion over chunk c-1's stages
      const AfChunk x(c - 1, N, r, ch_max, rc_max);
      if (x.last) {
        float* buf = sm + (c - 1) % AF_RING * L.buf;
        const float* T = sm + L.tiles + ((c - 1) & 1) * L.tile;
        const int64_t s0 = b * N + x.k0;
        const float* As = staged(buf + L.A, Ad + s0 * NX * NX);
        const float* Bs = staged(buf + L.B, Bd + s0 * NX * NU);
        for (int s = x.ch - 1; s >= 0; --s) {
          const int64_t sk = s0 + s;
          rw.stage(T + L.Q + s * NX * NX, T + L.R + s * NU * NU,
                   T + L.Mq + s * NX * NU, As + s * NX * NX,
                   Bs + s * NX * NU, sm + L.rec, W + sk * NX * NX,
                   G + sk * NU * NX, Huinv + sk * NU * NU);
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K4: factor sweep from given Qb, Rb, M, one block per instance
// ---------------------------------------------------------------------------
//
// K1's pipeline without the assembly.  Warps 1-3 (the producers) stage
// chunk c + F4_AHEAD -- ch whole stages of Qb, Rb, M, A and B -- into a
// ring of F4_RING buffers, from the last chunk of stages to the first,
// while warp 0 runs K1's recursion (RiccatiWarp) over chunk c straight
// from its buffer; one block barrier a chunk.

constexpr int F4_THREADS = 128;
constexpr int F4_PRODUCERS = F4_THREADS - 32;
constexpr int F4_AHEAD = 2;            // chunks in flight past the one in use
constexpr int F4_RING = F4_AHEAD + 1;  // staging buffers
constexpr int F4_STAGE_FLOATS = 1536;  // one staging buffer

// Shared-memory layout of K4 (offsets in floats, 16-byte aligned): the
// ring of staging buffers, each the five stage blocks ch stages long, then
// the recursion's record.
struct F4Layout {
  int Q, R, M, A, B, buf, rec, total;
  __host__ __device__ F4Layout(int ch, int nx) {
    Q = 0;
    R = Q + region(ch * nx * nx);
    M = R + region(ch * NU * NU);
    A = M + region(ch * nx * NU);
    B = A + region(ch * nx * nx);
    buf = B + region(ch * nx * NU);
    rec = F4_RING * buf;
    total = rec + rec_floats(nx);
  }
};

template <int NX>
__global__ void __launch_bounds__(F4_THREADS, 8)
factor_kernel(const float* __restrict__ Ad, const float* __restrict__ Bd,
              const float* __restrict__ Qb, const float* __restrict__ Rb,
              const float* __restrict__ Mm, float* __restrict__ Huinv,
              float* __restrict__ G, float* __restrict__ W, int N,
              int ch_max) {
  extern __shared__ __align__(16) float sm[];
  const F4Layout L(ch_max, NX);
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int nchunk = (N + ch_max - 1) / ch_max;
  // chunk c: stages [k0, k0 + ch), the last chunk of stages first
  auto k0_of = [&](int c) { return max(0, N - (c + 1) * ch_max); };
  auto ch_of = [&](int c) { return N - c * ch_max - k0_of(c); };
  auto src_of = [&](int c) {            // the first stage staged for chunk c
    int64_t s0 = b * N + k0_of(c);
    if (PLANT(7) && c == 1) s0 += 1;
    return s0;
  };
  auto issue = [&](int c) {
    const int ch = ch_of(c), pt = tid - 32;
    const int64_t s0 = src_of(c);
    float* buf = sm + c % F4_RING * L.buf;
    stage_async(buf + L.Q, Qb + s0 * NX * NX, ch * NX * NX, pt, F4_PRODUCERS);
    stage_async(buf + L.R, Rb + s0 * NU * NU, ch * NU * NU, pt, F4_PRODUCERS);
    stage_async(buf + L.M, Mm + s0 * NX * NU, ch * NX * NU, pt, F4_PRODUCERS);
    stage_async(buf + L.A, Ad + s0 * NX * NX, ch * NX * NX, pt, F4_PRODUCERS);
    stage_async(buf + L.B, Bd + s0 * NX * NU, ch * NX * NU, pt, F4_PRODUCERS);
  };

  if (tid >= 32) {
    for (int c = 0; c < F4_AHEAD; ++c) {
      if (c < nchunk) issue(c);
      __pipeline_commit();     // (an empty group past the last chunk)
    }
  }
  RiccatiWarp<NX> rw(tid & 31);
  for (int c = 0; c < nchunk; ++c) {
    if (tid >= 32) __pipeline_wait_prior(F4_AHEAD - 1);   // chunk c is in
    __syncthreads();           // ... and warp 0 is done with chunk c - 1
    if (tid >= 32) {
      // chunk c + F4_AHEAD goes where chunk c - 1 was
      if (c + F4_AHEAD < nchunk) issue(c + F4_AHEAD);
      __pipeline_commit();
    } else {
      const int k0 = k0_of(c);
      const int64_t s0 = src_of(c);
      float* buf = sm + c % F4_RING * L.buf;
      const float* Qs = staged(buf + L.Q, Qb + s0 * NX * NX);
      const float* Rs = staged(buf + L.R, Rb + s0 * NU * NU);
      const float* Ms = staged(buf + L.M, Mm + s0 * NX * NU);
      const float* As = staged(buf + L.A, Ad + s0 * NX * NX);
      const float* Bs = staged(buf + L.B, Bd + s0 * NX * NU);
      for (int s = ch_of(c) - 1; s >= 0; --s) {
        const int64_t sk = b * N + k0 + s;
        rw.stage(Qs + s * NX * NX, Rs + s * NU * NU, Ms + s * NX * NU,
                 As + s * NX * NX, Bs + s * NX * NU, sm + L.rec,
                 W + sk * NX * NX, G + sk * NU * NX, Huinv + sk * NU * NU,
                 !(PLANT(8) && k0 + s == 17));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2: backward linear-term sweep, one instance and KB right-hand sides a block
// ---------------------------------------------------------------------------
//
// The recursion, per rhs, from the last stage to the first (p = 0 past it):
//   w = rx + p,  h = (Wd - w) B + (re M - ru),  p <- h Kg + (w - Wd) A,
// with Kg = Hu^-1 G and Wd = re W'.  Only w, h and p hang on the carry, so
// each chunk of stages goes in two phases:
//   precompute  all threads, from the chunk's staged blocks, an item a row
//               of a stage: Kg (once per instance), A' and the columns of
//               B, and Wd and re M - ru for every rhs (each factor row
//               read once), into a record laid out for the chain's vector
//               loads;
//   chain       a segment of SEG lanes per rhs, lane j owning p_j; the
//               lanes' d = Wd - w go round the segment by __shfl_sync, so a
//               stage needs no barrier, and the next stage's record loads
//               into a second set of registers while this one runs.
// The staging ring holds two chunks: chunk c + 2 is issued into chunk c's
// buffer once c's precompute has read it, so two chunks are in flight
// while the chain runs.  Two block barriers a chunk.  rhs tensors are
// (B, K, N, n), the factor blocks (B, N, ...).

constexpr int BWD_WARPS = 4;             // most warps a block
constexpr int BWD_AHEAD = 2;             // chunks in flight past the one in use
constexpr int BWD_SMEM_FLOATS = 6912;    // 27 KB a block: 8 blocks an SM

__host__ __device__ constexpr int bwd_seg(int nx) { return nx <= 8 ? 8 : 16; }
__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Shared-memory layout of K2 (offsets in floats, 16-byte aligned): the
// ring of BWD_AHEAD staging buffers, each the six factor regions then KB
// rhs' rx, ru, re regions, all ch stages long; then the chain's record:
// A' (nx rows padded to nxp), B's two columns (padded), Kg as (Kg0_j, Kg1_j)
// pairs, and per rhs the (rx_j, Wd_j) pairs and (re M - ru) pairs.
struct BwdLayout {
  int hi, g, w, a, b, m, fac, rx, ru, re, rhs, buf;
  int at, bc, kg, rw, cv, rec, total;
  __host__ __device__ BwdLayout(int ch, int kb, int nx) {
    const int nxp = pad4(nx);
    hi = 0;
    g = hi + region(ch * NU * NU);
    w = g + region(ch * NU * nx);
    a = w + region(ch * nx * nx);
    b = a + region(ch * nx * nx);
    m = b + region(ch * nx * NU);
    fac = m + region(ch * nx * NU);
    rx = 0;
    ru = rx + region(ch * nx);
    re = ru + region(ch * NU);
    rhs = re + region(ch * nx);
    buf = fac + kb * rhs;
    at = BWD_AHEAD * buf;
    bc = at + ch * nx * nxp;
    kg = bc + ch * NU * nxp;
    rw = pad4(kg + ch * nx * NU);     // rhs q's pairs at rw + q * rec
    cv = rw + pad4(ch * nx * NU);
    rec = pad4(ch * nx * NU) + pad4(ch * NU);
    total = rw + kb * rec;
  }
};

__device__ __forceinline__ void ld4(float* d, float4 v) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// The rhs whose inputs the pair (instance bb, rhs k) reads: rhs 0 and 1 of
// instance 5 trade places under a planted fault.
__device__ __forceinline__ int src_rhs(bool swap, int64_t bb, int k, int K) {
  return swap && bb == 5 && k < 2 && K >= 2 ? 1 - k : k;
}

template <int NX>
__global__ void __launch_bounds__(BWD_WARPS * 32)
apply_bwd_kernel(const float* __restrict__ Huinv, const float* __restrict__ G,
                 const float* __restrict__ W, const float* __restrict__ Ad,
                 const float* __restrict__ Bd, const float* __restrict__ Mm,
                 const float* __restrict__ rx, const float* __restrict__ ru,
                 const float* __restrict__ re, float* __restrict__ h_out,
                 float* __restrict__ w_out, int K, int N, int kb_max,
                 int ch_max) {
  constexpr int SEG = bwd_seg(NX), RPW = 32 / SEG, NXP = pad4(NX);
  extern __shared__ __align__(16) float sm[];
  const BwdLayout L(ch_max, kb_max, NX);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int64_t b = blockIdx.x;
  const int kk0 = blockIdx.y * kb_max, kb = min(kb_max, K - kk0);
  // chain lanes: rhs kq of the block, row j of its carry; the lanes past
  // the carry or past the block's rhs mirror a real one and write nothing
  const int lane = tid & 31, j = lane % SEG;
  const int kq = (tid >> 5) * RPW + lane / SEG;
  const bool active = j < NX && kq < kb;
  const int jj = min(j, NX - 1), kqc = min(kq, kb - 1);
  const int kk = kk0 + kqc;

  // chunk c: stages [k0, k0 + ch), the last chunk of stages first
  auto k0_of = [&](int c) { return max(0, N - (c + 1) * ch_max); };
  auto ch_of = [&](int c) { return N - c * ch_max - k0_of(c); };
  auto v0_of = [&](int q, int k0) {      // rhs stage index of slot q's inputs
    return (b * K + src_rhs(PLANT(6), b, kk0 + q, K)) * N + k0;
  };
  auto issue = [&](int c) {
    const int k0 = k0_of(c), ch = ch_of(c);
    const int64_t s0 = b * N + k0;
    float* f = sm + c % BWD_AHEAD * L.buf;
    stage_async(f + L.hi, Huinv + s0 * NU * NU, ch * NU * NU, tid, nthr);
    stage_async(f + L.g, G + s0 * NU * NX, ch * NU * NX, tid, nthr);
    stage_async(f + L.w, W + s0 * NX * NX, ch * NX * NX, tid, nthr);
    stage_async(f + L.a, Ad + s0 * NX * NX, ch * NX * NX, tid, nthr);
    stage_async(f + L.b, Bd + s0 * NX * NU, ch * NX * NU, tid, nthr);
    stage_async(f + L.m, Mm + s0 * NX * NU, ch * NX * NU, tid, nthr);
    for (int q = 0; q < kb; ++q) {
      const int64_t v0 = v0_of(q, k0);
      float* rr = f + L.fac + q * L.rhs;
      stage_async(rr + L.rx, rx + v0 * NX, ch * NX, tid, nthr);
      stage_async(rr + L.ru, ru + v0 * NU, ch * NU, tid, nthr);
      stage_async(rr + L.re, re + v0 * NX, ch * NX, tid, nthr);
    }
  };

  float* AT = sm + L.at;                             // A'[s][j][i]
  float* BC = sm + L.bc;                             // B[s][i][u] at [s][u][i]
  float2* KG = reinterpret_cast<float2*>(sm + L.kg);  // [s][j]
  const int nchunk = (N + ch_max - 1) / ch_max;
  for (int c = 0; c < BWD_AHEAD; ++c) {
    if (c < nchunk) issue(c);
    __pipeline_commit();       // (an empty group past the last chunk)
  }
  float p = 0.0f;
  for (int c = 0; c < nchunk; ++c) {
    __pipeline_wait_prior(BWD_AHEAD - 1);   // chunk c is in
    __syncthreads();
    const int k0 = k0_of(c), ch = ch_of(c);
    const int64_t s0 = b * N + k0;
    float* f = sm + c % BWD_AHEAD * L.buf;
    const float* Hs = staged(f + L.hi, Huinv + s0 * NU * NU);
    const float* Gs = staged(f + L.g, G + s0 * NU * NX);
    const float* Ws = staged(f + L.w, W + s0 * NX * NX);
    const float* As = staged(f + L.a, Ad + s0 * NX * NX);
    const float* Bs = staged(f + L.b, Bd + s0 * NX * NU);
    const float* Ms = staged(f + L.m, Mm + s0 * NX * NU);
    // precompute: item (s, i < NX), row i of stage s's blocks for every
    // rhs; item (s, NX), re M - ru for every rhs
    for (int e = tid; e < ch * (NX + 1); e += nthr) {
      const int s = e / (NX + 1), i = e - s * (NX + 1);
      if (i < NX) {
        const float* Ar = As + s * NX * NX + i * NX;
        const float* Br = Bs + s * NX * NU + i * NU;
        const float* Hi = Hs + s * NU * NU;
        const float* Gk = Gs + s * NU * NX;
        const float* Wr = Ws + s * NX * NX + i * NX;
#pragma unroll
        for (int jx = 0; jx < NX; ++jx) AT[(s * NX + jx) * NXP + i] = Ar[jx];
        BC[(s * NU + 0) * NXP + i] = Br[0];
        BC[(s * NU + 1) * NXP + i] = Br[1];
        KG[s * NX + i] = make_float2(Hi[0] * Gk[i] + Hi[1] * Gk[NX + i],
                                     Hi[2] * Gk[i] + Hi[3] * Gk[NX + i]);
        float wr[NX];
#pragma unroll
        for (int jx = 0; jx < NX; ++jx) wr[jx] = Wr[jx];
        for (int q = 0; q < kb; ++q) {
          const int64_t v0 = v0_of(q, k0);
          float* rr = f + L.fac + q * L.rhs;
          const float* rek = staged(rr + L.re, re + v0 * NX) + s * NX;
          const float* rxs = staged(rr + L.rx, rx + v0 * NX) + s * NX;
          float acc = 0.0f;                          // Wd = re W'
#pragma unroll
          for (int jx = 0; jx < NX; ++jx) acc += rek[jx] * wr[jx];
          reinterpret_cast<float2*>(sm + L.rw + q * L.rec)[s * NX + i] =
              make_float2(rxs[i], acc);
        }
      } else {
        const float* Mk = Ms + s * NX * NU;
        float mk[NX * NU];
#pragma unroll
        for (int t = 0; t < NX * NU; ++t) mk[t] = Mk[t];
        for (int q = 0; q < kb; ++q) {
          const int64_t v0 = v0_of(q, k0);
          float* rr = f + L.fac + q * L.rhs;
          const float* rek = staged(rr + L.re, re + v0 * NX) + s * NX;
          const float* rus = staged(rr + L.ru, ru + v0 * NU) + s * NU;
          float c0 = 0.0f, c1 = 0.0f;                // re M - ru
#pragma unroll
          for (int ix = 0; ix < NX; ++ix) {
            c0 += rek[ix] * mk[ix * NU + 0];
            c1 += rek[ix] * mk[ix * NU + 1];
          }
          reinterpret_cast<float2*>(sm + L.cv + q * L.rec)[s] =
              make_float2(c0 - rus[0], c1 - rus[1]);
        }
      }
    }
    __syncthreads();
    // chunk c's buffer is read: chunk c + BWD_AHEAD goes there
    if (c + BWD_AHEAD < nchunk) issue(c + BWD_AHEAD);
    __pipeline_commit();

    // the chain of rhs kq over the chunk's stages, last to first; two
    // records in registers, the next stage's loading while one runs
    const float2* RW = reinterpret_cast<const float2*>(sm + L.rw + kqc * L.rec);
    const float2* CV = reinterpret_cast<const float2*>(sm + L.cv + kqc * L.rec);
    struct Rec {
      float a[NXP], b0[NXP], b1[NXP];   // A[:, j], B[:, 0], B[:, 1]
      float2 rw, cv, kg;                // (rx_j, Wd_j), re M - ru, Kg[:, j]
    };
    auto fetch = [&](Rec& r, int s) {
      const float4* at =
          reinterpret_cast<const float4*>(AT + (s * NX + jj) * NXP);
      const float4* bc = reinterpret_cast<const float4*>(BC + s * NU * NXP);
#pragma unroll
      for (int t = 0; t < NXP / 4; ++t) {
        ld4(r.a + 4 * t, at[t]);
        ld4(r.b0 + 4 * t, bc[t]);
        ld4(r.b1 + 4 * t, bc[NXP / 4 + t]);
      }
      r.rw = RW[s * NX + jj];
      r.cv = CV[s];
      r.kg = KG[s * NX + jj];
    };
    auto step = [&](const Rec& r, int s) {
      const float w = r.rw.x + p;
      const float d = r.rw.y - w;                  // Wd - w
      float h0 = 0.0f, h1 = 0.0f, sa = 0.0f;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const float di = __shfl_sync(0xffffffffu, d, i, SEG);
        h0 += di * r.b0[i];
        h1 += di * r.b1[i];
        sa += di * r.a[i];
      }
      h0 += r.cv.x;                                // + re M - ru
      h1 += r.cv.y;
      const int k = k0 + s;
      // p <- h Kg + (w - Wd) A
      if (!(PLANT(5) && k == 17)) p = (h0 * r.kg.x + h1 * r.kg.y) - sa;
      if (active) {
        const int64_t v = (b * K + kk) * N + k;
        w_out[v * NX + j] = w;
        if (j < NU) h_out[v * NU + j] = j == 0 ? h0 : h1;
      }
    };
    Rec ra, rb;
    int s = ch - 1;
    fetch(ra, s);
    while (true) {
      if (s > 0) fetch(rb, s - 1);
      step(ra, s);
      if (--s < 0) break;
      if (s > 0) fetch(ra, s - 1);
      step(rb, s);
      if (--s < 0) break;
    }
  }
}

// ---------------------------------------------------------------------------
// K3: forward rollout sweep, one instance and KB right-hand sides a block
// ---------------------------------------------------------------------------
//
// Thread tid = kq * nx + i owns entry i of the dx carry of right-hand side
// kk0 + kq of instance b.  rhs tensors are (B, K, N, n), the factor blocks
// (B, N, ...).  Chunks of ch stages are staged into a ring of FWD_RING
// buffers, FWD_AHEAD chunks ahead.  At K=1 a block is one warp with nx lanes at
// work: packing several instances into it leaves fewer warps per SM to
// issue the staging and the carry chains, and ran slower.

constexpr int FWD_MAX_THREADS = 1024;
constexpr int FWD_AHEAD = 2;           // chunks in flight past the one in use
constexpr int FWD_RING = FWD_AHEAD + 1;
constexpr int FWD_STAGE_FLOATS = 2048;  // factor blocks + rhs per buffer

// Shared-memory layout of K3 (offsets in floats, 16-byte aligned): the
// ring of staging buffers, each the six factor regions then KB rhs' re,
// h, w regions, all ch stages long; then the carry's two buffers.
struct FwdLayout {
  int hi, g, w, a, b, m, fac, re, h, wv, rhs, buf, dx, total;
  __host__ __device__ FwdLayout(int ch, int kb, int nx) {
    hi = 0;
    g = hi + region(ch * NU * NU);
    w = g + region(ch * NU * nx);
    a = w + region(ch * nx * nx);
    b = a + region(ch * nx * nx);
    m = b + region(ch * nx * NU);
    fac = m + region(ch * nx * NU);
    re = 0;
    h = re + region(ch * nx);
    wv = h + region(ch * NU);
    rhs = wv + region(ch * nx);
    buf = fac + kb * rhs;
    dx = FWD_RING * buf;
    total = dx + 2 * kb * nx;
  }
};

template <int NX>
__global__ void __launch_bounds__(FWD_MAX_THREADS)
apply_fwd_kernel(const float* __restrict__ Huinv, const float* __restrict__ G,
                 const float* __restrict__ W, const float* __restrict__ Ad,
                 const float* __restrict__ Bd, const float* __restrict__ Mm,
                 const float* __restrict__ re, const float* __restrict__ h_in,
                 const float* __restrict__ w_in, float* __restrict__ du_out,
                 float* __restrict__ dx_out, float* __restrict__ dlam_out,
                 int K, int N, int kb_max, int ch_max) {
  extern __shared__ __align__(16) float sm[];
  const FwdLayout L(ch_max, kb_max, NX);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int64_t b = blockIdx.x;
  const int kk0 = blockIdx.y * kb_max, kb = min(kb_max, K - kk0);
  const int kq = tid / NX, i = tid - kq * NX;
  const bool active = kq < kb;
  const int kk = kk0 + kq;

  auto issue = [&](int c) {
    const int k0 = c * ch_max, ch = min(ch_max, N - k0);
    const int64_t s0 = b * N + k0;
    float* f = sm + c % FWD_RING * L.buf;
    stage_async(f + L.hi, Huinv + s0 * NU * NU, ch * NU * NU, tid, nthr);
    stage_async(f + L.g, G + s0 * NU * NX, ch * NU * NX, tid, nthr);
    stage_async(f + L.w, W + s0 * NX * NX, ch * NX * NX, tid, nthr);
    stage_async(f + L.a, Ad + s0 * NX * NX, ch * NX * NX, tid, nthr);
    stage_async(f + L.b, Bd + s0 * NX * NU, ch * NX * NU, tid, nthr);
    stage_async(f + L.m, Mm + s0 * NX * NU, ch * NX * NU, tid, nthr);
    for (int q = 0; q < kb; ++q) {
      const int64_t v0 = (b * K + src_rhs(PLANT(4), b, kk0 + q, K)) * N + k0;
      float* rr = f + L.fac + q * L.rhs;
      stage_async(rr + L.re, re + v0 * NX, ch * NX, tid, nthr);
      stage_async(rr + L.h, h_in + v0 * NU, ch * NU, tid, nthr);
      stage_async(rr + L.wv, w_in + v0 * NX, ch * NX, tid, nthr);
    }
  };

  float* carry = sm + L.dx + kq * NX;
  if (tid < kb_max * NX) sm[L.dx + tid] = 0.0f;   // dx_0 = 0
  const int nchunk = (N + ch_max - 1) / ch_max;
  for (int c = 0; c < FWD_AHEAD; ++c) {
    if (c < nchunk) issue(c);
    __pipeline_commit();       // (an empty group past the last chunk)
  }
  for (int c = 0; c < nchunk; ++c) {
    // chunk c + FWD_AHEAD goes where chunk c - 1 was
    if (c + FWD_AHEAD < nchunk) issue(c + FWD_AHEAD);
    __pipeline_commit();
    __pipeline_wait_prior(FWD_AHEAD);      // chunk c is in
    __syncthreads();
    const int k0 = c * ch_max, ch = min(ch_max, N - k0);
    float* f = sm + c % FWD_RING * L.buf;
    float* rr = f + L.fac + kq * L.rhs;
    const int64_t s0 = b * N + k0;
    const int64_t v0 = (b * K + src_rhs(PLANT(4), b, kk, K)) * N + k0;
    for (int s = 0; s < ch; ++s) {
      const int k = k0 + s;
      const float* dx = carry + (k & 1) * kb_max * NX;
      float* xn = carry + ((k + 1) & 1) * kb_max * NX;
      const int64_t v = (b * K + kk) * N + k;
      float du0 = 0.0f, du1 = 0.0f;
      if (active) {
        const float* Hi = staged(f + L.hi, Huinv + s0 * NU * NU) + s * NU * NU;
        const float* Gk = staged(f + L.g, G + s0 * NU * NX) + s * NU * NX;
        const float* A = staged(f + L.a, Ad + s0 * NX * NX) + s * NX * NX;
        const float* Bk = staged(f + L.b, Bd + s0 * NX * NU) + s * NX * NU;
        const float* hk = staged(rr + L.h, h_in + v0 * NU) + s * NU;
        const float* rek = staged(rr + L.re, re + v0 * NX) + s * NX;
        float t0 = hk[0], t1 = hk[1];              // t = dx G' + h
#pragma unroll
        for (int j = 0; j < NX; ++j) t0 += dx[j] * Gk[j];
#pragma unroll
        for (int j = 0; j < NX; ++j) t1 += dx[j] * Gk[NX + j];
        du0 = -(t0 * Hi[0] + t1 * Hi[1]);           // du = -t Hu^-1'
        du1 = -(t0 * Hi[2] + t1 * Hi[3]);
        float acc = rek[i];                         // dx <- dx A' + du B' + re
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += dx[j] * A[i * NX + j];
        acc += du0 * Bk[i * NU + 0] + du1 * Bk[i * NU + 1];
        if (PLANT(3) && k == 17) acc = dx[i];
        xn[i] = acc;
        dx_out[v * NX + i] = acc;
        if (i < NU) du_out[v * NU + i] = i == 0 ? du0 : du1;
      }
      __syncthreads();
      if (active) {
        const float* Wk = staged(f + L.w, W + s0 * NX * NX) + s * NX * NX;
        const float* Mk = staged(f + L.m, Mm + s0 * NX * NU) + s * NX * NU;
        const float* wk = staged(rr + L.wv, w_in + v0 * NX) + s * NX;
        float acc = -wk[i];                         // dlam = dx W' + du M' - w
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += xn[j] * Wk[i * NX + j];
        acc += du0 * Mk[i * NU + 0] + du1 * Mk[i * NU + 1];
        dlam_out[v * NX + i] = acc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

#define DISPATCH_NX(NXV, ...)                       \
  switch (NXV) {                                    \
    case 5: { constexpr int NX = 5; __VA_ARGS__; } break; \
    case 7: { constexpr int NX = 7; __VA_ARGS__; } break; \
    case 9: { constexpr int NX = 9; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;     \
  }

extern "C" int riccati_factor_f32(const float* Ad, const float* Bd,
                                  const float* Qb, const float* Rb,
                                  const float* M, float* Huinv, float* G,
                                  float* W, int batch, int N, int nx,
                                  void* stream) {
  if (batch <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // one instance a block; a chunk: as many whole stages as a staging
  // buffer holds
  const int per_stage = 2 * nx * nx + 2 * nx * NU + NU * NU;
  const int ch = max(1, min(N, F4_STAGE_FLOATS / per_stage));
  const size_t smem = sizeof(float) * F4Layout(ch, nx).total;
  DISPATCH_NX(nx, {
    auto kern = factor_kernel<NX>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    kern<<<batch, F4_THREADS, smem, st>>>(Ad, Bd, Qb, Rb, M, Huinv, G, W, N,
                                          ch);
  });
  return (int)cudaGetLastError();
}

extern "C" int riccati_assemble_factor_f32(
    const float* C, const float* D, const float* Ws, const float* Dr,
    const float* qbd, const float* rbd, const float* Ad, const float* Bd,
    float* Huinv, float* G, float* W, float* Mq, float* Lx, float* Lu,
    float* Hss, int batch, int N, int r, int nx, int ns, void* stream) {
  if (batch <= 0 || N <= 0 || r <= 0) return (int)cudaErrorInvalidValue;
  if (ns != 1 && ns != 2 && ns != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // a chunk: as many whole stages (rows, A, B) as a staging buffer holds
  // and the producers' item slots cover, or a run of one long stage's rows
  const int m = nx + NU + ns, E = m * (m + 1) / 2;
  const int per_stage = r * (m + 1) + nx * nx + nx * NU;
  int ch = 1, rc = r;
  if (per_stage <= AF_STAGE_FLOATS)
    ch = max(1, min(min(N, AF_STAGE_FLOATS / per_stage),
                    AF_ITEMS * AF_PRODUCERS / E));
  else
    rc = max(1, (AF_STAGE_FLOATS - nx * nx - nx * NU) / (m + 1));
  const size_t smem = sizeof(float) * AfLayout(ch, ch * rc, nx, ns).total;
#define LAUNCH_AF(NSV)                                                     \
  DISPATCH_NX(nx, {                                                        \
    auto kern = assemble_factor_kernel<NX, NSV>;                           \
    if (smem > 48 * 1024)                                                  \
      cudaFuncSetAttribute(kern,                                           \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                           (int)smem);                                     \
    kern<<<batch, AF_THREADS, smem, st>>>(C, D, Ws, Dr, qbd, rbd, Ad, Bd,  \
                                          Huinv, G, W, Mq, Lx, Lu, Hss, N, \
                                          r, ch, rc);                      \
  })
  if (ns == 1) {
    LAUNCH_AF(1);
  } else if (ns == 2) {
    LAUNCH_AF(2);
  } else {
    LAUNCH_AF(4);
  }
#undef LAUNCH_AF
  return (int)cudaGetLastError();
}

extern "C" int riccati_apply_bwd_f32(const float* Huinv, const float* G,
                                     const float* W, const float* Ad,
                                     const float* Bd, const float* M,
                                     const float* rx, const float* ru,
                                     const float* re, float* h, float* w,
                                     int batch, int K, int N, int nx,
                                     void* stream) {
  if (batch <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // one instance and KB rhs a block, a segment of lanes per rhs; chunks
  // as long as the block's shared memory allows
  const int rpw = 32 / bwd_seg(nx);
  const int kb = min(K, BWD_WARPS * rpw);
  const int threads = (kb + rpw - 1) / rpw * 32;
  int ch = N;
  while (ch > 1 && BwdLayout(ch, kb, nx).total > BWD_SMEM_FLOATS) --ch;
  const size_t smem = sizeof(float) * BwdLayout(ch, kb, nx).total;
  const dim3 grid(batch, (K + kb - 1) / kb);
  DISPATCH_NX(nx, {
    auto kern = apply_bwd_kernel<NX>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    kern<<<grid, threads, smem, st>>>(Huinv, G, W, Ad, Bd, M, rx, ru, re, h,
                                      w, K, N, kb, ch);
  });
  return (int)cudaGetLastError();
}

extern "C" int riccati_apply_fwd_f32(const float* Huinv, const float* G,
                                     const float* W, const float* Ad,
                                     const float* Bd, const float* M,
                                     const float* re, const float* h,
                                     const float* w, float* du, float* dx,
                                     float* dlam, int batch, int K, int N,
                                     int nx, void* stream) {
  if (batch <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // one instance and KB rhs a block
  const int kb = min(K, max(1, FWD_MAX_THREADS / nx));
  const int threads = (kb * nx + 31) / 32 * 32;
  const int per_stage = 2 * nx * nx + 4 * nx + NU * NU + kb * (2 * nx + NU);
  const int ch = max(1, min(N, FWD_STAGE_FLOATS / per_stage));
  const size_t smem = sizeof(float) * FwdLayout(ch, kb, nx).total;
  const dim3 grid(batch, (K + kb - 1) / kb);
  DISPATCH_NX(nx, {
    auto kern = apply_fwd_kernel<NX>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    kern<<<grid, threads, smem, st>>>(Huinv, G, W, Ad, Bd, M, re, h, w, du,
                                      dx, dlam, K, N, kb, ch);
  });
  return (int)cudaGetLastError();
}
