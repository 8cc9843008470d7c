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
// scratch.  Here one thread owns one QP instance (apply: one instance and
// one right-hand side) and runs the whole stage loop itself; the carry
// (P, p or dx) and the per-stage blocks live in registers (nx <= 9,
// nu == 2, ns <= 4, templated so every loop unrolls).  Threads never
// talk to each other, so a NaN-poisoned instance cannot reach its
// neighbours.
//
// What bounds it.  All tensors are batch-first, as at the Python API:
// thread b reads instance b's contiguous per-stage blocks, so the 32
// threads of a warp touch 32 addresses one block apart -- the loads are
// not coalesced and each sweep is latency-bound on device-memory (L2)
// reads, with 1024 instances filling only 8-16 of the 132 SMs at one
// thread each.  A batch-last layout (stage blocks interleaved across
// instances, as the TPU kernels had them) would coalesce the reads; that
// is a later change.  The arithmetic is tiny (~2 kFLOP per stage).
//
// Numerics.  Built without --use_fast_math: a non-SPD 2x2 pivot (det <= 0
// or Hu00 <= 0) must come out NaN, never clamped, because the IPM's
// inertia escalation keys on non-finite iterates
// (fsae_mpc_tpu/ops/riccati.py:1009-1019).  P is symmetrised at every
// stage.  nvcc's default FMA contraction stays on: these sweeps hold no
// error-free transforms, and the tolerances against the plain PyTorch
// versions are stated where they are compared.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NU = 2;
constexpr int THREADS = 64;

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

// One backward Riccati stage from the assembled blocks: W = Qb + P,
// V = W B + M, Hu = Rb + B'V + M'B, G = V'A, P <- sym(A'WA - G'Hu^-1 G).
// Qb is overwritten with W.  Writes Huinv, G, W for this stage.
template <int NX>
__device__ __forceinline__ void riccati_stage(
    float (&P)[NX][NX], float (&Qb)[NX][NX], const float (&Rb)[NU][NU],
    const float (&M)[NX][NU], const float* __restrict__ A,
    const float* __restrict__ B, float* __restrict__ huinv_out,
    float* __restrict__ g_out, float* __restrict__ w_out) {
  float (&W)[NX][NX] = Qb;
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) W[i][j] += P[i][j];

  float Bk[NX][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int u = 0; u < NU; ++u) Bk[i][u] = B[i * NU + u];

  float V[NX][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += W[i][j] * Bk[j][u];
      V[i][u] = acc + M[i][u];
    }

  float Hu[NU][NU];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int v = 0; v < NU; ++v) {
      float acc = Rb[u][v];
#pragma unroll
      for (int i = 0; i < NX; ++i) acc += Bk[i][u] * V[i][v];
#pragma unroll
      for (int i = 0; i < NX; ++i) acc += M[i][u] * Bk[i][v];
      Hu[u][v] = acc;
    }
  float Hi[NU][NU];
  inv2_poison(Hu, Hi);

  // G = V' A  (nu, nx), row-major
  float G[NU][NX];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < NX; ++i) acc += V[i][u] * A[i * NX + j];
      G[u][j] = acc;
    }

  // Kg = Hu^-1 G  (nu, nx)
  float Kg[NU][NX];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int j = 0; j < NX; ++j) Kg[u][j] = Hi[u][0] * G[0][j] + Hi[u][1] * G[1][j];

  // WA = W A, then P_new = A' WA - G' Kg, symmetrised
  float WA[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) acc += W[i][k] * A[k * NX + j];
      WA[i][j] = acc;
    }
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) acc += A[k * NX + i] * WA[k][j];
      P[i][j] = acc - (G[0][i] * Kg[0][j] + G[1][i] * Kg[1][j]);
    }
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = i + 1; j < NX; ++j) {
      const float s = 0.5f * (P[i][j] + P[j][i]);
      P[i][j] = s;
      P[j][i] = s;
    }

#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int v = 0; v < NU; ++v) huinv_out[u * NU + v] = Hi[u][v];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int j = 0; j < NX; ++j) g_out[u * NX + j] = G[u][j];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) w_out[i * NX + j] = W[i][j];
}

// ---------------------------------------------------------------------------
// K4: factor sweep from given Qb, Rb, M
// ---------------------------------------------------------------------------

template <int NX>
__global__ void __launch_bounds__(THREADS)
factor_kernel(const float* __restrict__ Ad, const float* __restrict__ Bd,
              const float* __restrict__ Qb, const float* __restrict__ Rb,
              const float* __restrict__ Mm, float* __restrict__ Huinv,
              float* __restrict__ G, float* __restrict__ W, int batch,
              int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float P[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = 0.0f;

  for (int k = N - 1; k >= 0; --k) {
    const int64_t s = (int64_t)b * N + k;
    float Q[NX][NX], R[NU][NU], M[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) Q[i][j] = Qb[s * NX * NX + i * NX + j];
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int v = 0; v < NU; ++v) R[u][v] = Rb[s * NU * NU + u * NU + v];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int u = 0; u < NU; ++u) M[i][u] = Mm[s * NX * NU + i * NU + u];
    riccati_stage<NX>(P, Q, R, M, Ad + s * NX * NX, Bd + s * NX * NU,
                      Huinv + s * NU * NU, G + s * NU * NX, W + s * NX * NX);
  }
}

// ---------------------------------------------------------------------------
// K1: fused quadform assembly + factor sweep
// ---------------------------------------------------------------------------

template <int NX, int NS>
__global__ void __launch_bounds__(THREADS)
assemble_factor_kernel(
    const float* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ Ws, const float* __restrict__ Dr,
    const float* __restrict__ qbd, const float* __restrict__ rbd,
    const float* __restrict__ Ad, const float* __restrict__ Bd,
    float* __restrict__ Huinv, float* __restrict__ G, float* __restrict__ W,
    float* __restrict__ Mq_out, float* __restrict__ Lx_out,
    float* __restrict__ Lu_out, float* __restrict__ Hss_out, int batch,
    int N, int r) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float P[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = 0.0f;

  for (int k = N - 1; k >= 0; --k) {
    const int64_t s = (int64_t)b * N + k;
    float Q[NX][NX], R[NU][NU], M[NX][NU], Lx[NX][NS], Lu[NU][NS],
        Hss[NS][NS];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) Q[i][j] = 0.0f;
#pragma unroll
      for (int u = 0; u < NU; ++u) M[i][u] = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) Lx[i][j] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) {
#pragma unroll
      for (int v = 0; v < NU; ++v) R[u][v] = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) Lu[u][j] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) Hss[i][j] = 0.0f;

    const float* Ck = C + s * r * NX;
    const float* Dk = D + s * r * NU;
    const float* Wk = Ws + s * r * NS;
    const float* drk = Dr + s * r;
    for (int q = 0; q < r; ++q) {
      const float d = drk[q];
      float c[NX], cd[NX], e[NU], ed[NU], w[NS], wd[NS];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        c[i] = Ck[q * NX + i];
        cd[i] = c[i] * d;
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        e[u] = Dk[q * NU + u];
        ed[u] = e[u] * d;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        w[j] = Wk[q * NS + j];
        wd[j] = w[j] * d;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) Q[i][j] += c[i] * cd[j];
#pragma unroll
        for (int u = 0; u < NU; ++u) M[i][u] += c[i] * ed[u];
#pragma unroll
        for (int j = 0; j < NS; ++j) Lx[i][j] += c[i] * wd[j];
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
#pragma unroll
        for (int v = 0; v < NU; ++v) R[u][v] += e[u] * ed[v];
#pragma unroll
        for (int j = 0; j < NS; ++j) Lu[u][j] += e[u] * wd[j];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int j = 0; j < NS; ++j) Hss[i][j] += w[i] * wd[j];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) Q[i][i] += qbd[s * NX + i];
#pragma unroll
    for (int u = 0; u < NU; ++u) R[u][u] += rbd[s * NU + u];

#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int u = 0; u < NU; ++u) Mq_out[s * NX * NU + i * NU + u] = M[i][u];
#pragma unroll
      for (int j = 0; j < NS; ++j) Lx_out[s * NX * NS + i * NS + j] = Lx[i][j];
    }
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int j = 0; j < NS; ++j) Lu_out[s * NU * NS + u * NS + j] = Lu[u][j];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j)
        Hss_out[s * NS * NS + i * NS + j] = Hss[i][j];

    riccati_stage<NX>(P, Q, R, M, Ad + s * NX * NX, Bd + s * NX * NU,
                      Huinv + s * NU * NU, G + s * NU * NX, W + s * NX * NX);
  }
}

// ---------------------------------------------------------------------------
// K2: backward linear-term sweep (Kg = Hu^-1 G folded in)
// ---------------------------------------------------------------------------
//
// Thread t = b * K + kk owns instance b, right-hand side kk.  rx/re/w are
// (B, K, N, nx), ru/h (B, K, N, nu); the factor blocks are (B, N, ...).

template <int NX>
__global__ void __launch_bounds__(THREADS)
apply_bwd_kernel(const float* __restrict__ Huinv, const float* __restrict__ G,
                 const float* __restrict__ W, const float* __restrict__ Ad,
                 const float* __restrict__ Bd, const float* __restrict__ Mm,
                 const float* __restrict__ rx, const float* __restrict__ ru,
                 const float* __restrict__ re, float* __restrict__ h_out,
                 float* __restrict__ w_out, int batch, int K, int N) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * K) return;
  const int b = t / K;
  float p[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) p[i] = 0.0f;

  for (int k = N - 1; k >= 0; --k) {
    const int64_t s = (int64_t)b * N + k;        // factor-block stage index
    const int64_t v = (int64_t)t * N + k;        // rhs stage index
    const float* A = Ad + s * NX * NX;
    const float* B = Bd + s * NX * NU;
    const float* M = Mm + s * NX * NU;
    const float* Wk = W + s * NX * NX;
    float w[NX], re_k[NX], Wd[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      w[i] = rx[v * NX + i] + p[i];
      re_k[i] = re[v * NX + i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {               // Wd = re W'
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += re_k[j] * Wk[i * NX + j];
      Wd[i] = acc;
    }
    float h[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u) {               // h = (Wd - w) B + re M - ru
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < NX; ++i) acc += (Wd[i] - w[i]) * B[i * NU + u];
#pragma unroll
      for (int i = 0; i < NX; ++i) acc += re_k[i] * M[i * NU + u];
      h[u] = acc - ru[v * NU + u];
    }
    const float* Hi = Huinv + s * NU * NU;
    const float* Gk = G + s * NU * NX;
#pragma unroll
    for (int j = 0; j < NX; ++j) {               // p = h Kg + (w - Wd) A
      const float kg0 = Hi[0] * Gk[j] + Hi[1] * Gk[NX + j];
      const float kg1 = Hi[2] * Gk[j] + Hi[3] * Gk[NX + j];
      float acc = h[0] * kg0 + h[1] * kg1;
#pragma unroll
      for (int i = 0; i < NX; ++i) acc += (w[i] - Wd[i]) * A[i * NX + j];
      p[j] = acc;
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) h_out[v * NU + u] = h[u];
#pragma unroll
    for (int i = 0; i < NX; ++i) w_out[v * NX + i] = w[i];
  }
}

// ---------------------------------------------------------------------------
// K3: forward rollout sweep
// ---------------------------------------------------------------------------

template <int NX>
__global__ void __launch_bounds__(THREADS)
apply_fwd_kernel(const float* __restrict__ Huinv, const float* __restrict__ G,
                 const float* __restrict__ W, const float* __restrict__ Ad,
                 const float* __restrict__ Bd, const float* __restrict__ Mm,
                 const float* __restrict__ re, const float* __restrict__ h_in,
                 const float* __restrict__ w_in, float* __restrict__ du_out,
                 float* __restrict__ dx_out, float* __restrict__ dlam_out,
                 int batch, int K, int N) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * K) return;
  const int b = t / K;
  float dx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = 0.0f;

  for (int k = 0; k < N; ++k) {
    const int64_t s = (int64_t)b * N + k;
    const int64_t v = (int64_t)t * N + k;
    const float* A = Ad + s * NX * NX;
    const float* B = Bd + s * NX * NU;
    const float* M = Mm + s * NX * NU;
    const float* Wk = W + s * NX * NX;
    const float* Hi = Huinv + s * NU * NU;
    const float* Gk = G + s * NU * NX;
    float tt[NU], du[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u) {               // t = dx G' + h
      float acc = h_in[v * NU + u];
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += dx[j] * Gk[u * NX + j];
      tt[u] = acc;
    }
#pragma unroll
    for (int u = 0; u < NU; ++u)                 // du = -t Hu^-1'
      du[u] = -(tt[0] * Hi[u * NU + 0] + tt[1] * Hi[u * NU + 1]);
    float xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {               // dx <- dx A' + du B' + re
      float acc = re[v * NX + i];
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += dx[j] * A[i * NX + j];
      acc += du[0] * B[i * NU + 0] + du[1] * B[i * NU + 1];
      xn[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {               // dlam = dx W' + du M' - w
      float acc = -w_in[v * NX + i];
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += xn[j] * Wk[i * NX + j];
      acc += du[0] * M[i * NU + 0] + du[1] * M[i * NU + 1];
      dlam_out[v * NX + i] = acc;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      dx[i] = xn[i];
      dx_out[v * NX + i] = xn[i];
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) du_out[v * NU + u] = du[u];
  }
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

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
  DISPATCH_NX(nx, factor_kernel<NX><<<blocks_for(batch), THREADS, 0, st>>>(
                      Ad, Bd, Qb, Rb, M, Huinv, G, W, batch, N));
  return (int)cudaGetLastError();
}

extern "C" int riccati_assemble_factor_f32(
    const float* C, const float* D, const float* Ws, const float* Dr,
    const float* qbd, const float* rbd, const float* Ad, const float* Bd,
    float* Huinv, float* G, float* W, float* Mq, float* Lx, float* Lu,
    float* Hss, int batch, int N, int r, int nx, int ns, void* stream) {
  if (batch <= 0 || N <= 0 || r <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH_AF(NSV)                                                    \
  DISPATCH_NX(nx, assemble_factor_kernel<NX, NSV>                         \
                      <<<blocks_for(batch), THREADS, 0, st>>>(            \
                          C, D, Ws, Dr, qbd, rbd, Ad, Bd, Huinv, G, W, Mq, \
                          Lx, Lu, Hss, batch, N, r))
  switch (ns) {
    case 1: LAUNCH_AF(1); break;
    case 4: LAUNCH_AF(4); break;
    default: return (int)cudaErrorInvalidValue;
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
  DISPATCH_NX(nx, apply_bwd_kernel<NX>
                      <<<blocks_for(batch * K), THREADS, 0, st>>>(
                          Huinv, G, W, Ad, Bd, M, rx, ru, re, h, w, batch, K,
                          N));
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
  DISPATCH_NX(nx, apply_fwd_kernel<NX>
                      <<<blocks_for(batch * K), THREADS, 0, st>>>(
                          Huinv, G, W, Ad, Bd, M, re, h, w, du, dx, dlam,
                          batch, K, N));
  return (int)cudaGetLastError();
}
