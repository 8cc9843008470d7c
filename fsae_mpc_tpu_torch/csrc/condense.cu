// Fused horizon condensing of the dense LTV-MPC QP, for Hopper (sm_90a).
// Plain C ABI, bound from Python with ctypes
// (fsae_mpc_tpu_torch/ops/kernels/condense.py); the entry point launches on
// the stream it is given, allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
//
// Replaces the TPU Pallas kernel of fsae_mpc_tpu/ops/pallas/condense.py:
//   condense_f32  <- condense_lanes (:112), body _condense_kernel (:49)
//
// It computes, per instance, for stages i = 0..N-1 (phi_{-1} = I,
// G_{-1} = 0, delta_{-1} = 0):
//   phi_i   = A_i phi_{i-1}                          -> A_bar[i] (nx, nx)
//   G_i     = A_i G_{i-1}, then columns i*nu..(i+1)*nu-1 set to B_i
//                                                    -> B_bar[i] (nx, N*nu)
//   delta_i = A_i delta_{i-1} + d_i                  -> d_bar[i] (nx)
// in the layouts of ops/condense.py:condense (batch first, row-major).
//
// Design.  On the TPU the batch rode the 128 vector lanes, the stage loop
// was the sequential grid axis and the carry sat in VMEM scratch.  Here
// one block runs one instance.  The carry [G | phi | delta] is a matrix of
// nx rows and N*nu + nx + 1 columns, and every stage multiplies it from
// the left by A_i, so its columns never mix: thread c owns column c in
// registers for the whole horizon (88 threads at N=40, nx=7, nu=2).  The
// instance's Ad/Bd/dd slab (11 KB at those widths) is staged in shared
// memory once, with coalesced loads; A_i is then read as a broadcast.
//
// What bounds it.  B_bar is over 80% of the bytes (nx * N * N*nu floats
// per instance) and each of its rows is written by consecutive threads to
// consecutive addresses, so the stores coalesce; the arithmetic is
// 2 * nx^2 * (N*nu + nx + 1) FLOP per stage.  The kernel is bound by
// device-memory bytes (chip_smoke.py prints the bound).
//
// Numerics.  The same products as the plain version, summed in column
// order j = 0..nx-1; nvcc's default FMA contraction stays on, so results
// differ from the plain version in the last bits (tolerance stated in
// chip_smoke.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_SMEM = 48 * 1024;
constexpr int LOADS = 8;  // global loads in flight per thread while staging

// Copy cnt floats from device memory to shared memory with the threads of
// the block, LOADS loads in flight per thread.
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src,
                                      int cnt) {
  for (int t0 = threadIdx.x; t0 < cnt; t0 += LOADS * blockDim.x) {
    float v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = t0 + u * blockDim.x;
      v[u] = t < cnt ? src[t] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = t0 + u * blockDim.x;
      if (t < cnt) dst[t] = v[u];
    }
  }
}

template <int NX>
__global__ void condense_kernel(const float* __restrict__ Ad,
                                const float* __restrict__ Bd,
                                const float* __restrict__ dd,
                                float* __restrict__ A_bar,
                                float* __restrict__ B_bar,
                                float* __restrict__ d_bar, int N, int nu) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int ncu = N * nu;
  const int nA = N * NX * NX, nB = N * NX * nu, nD = N * NX;
  float* sA = smem;
  float* sB = sA + nA;
  float* sD = sB + nB;
  const float* gA = Ad + (size_t)b * nA;
  const float* gB = Bd + (size_t)b * nB;
  const float* gD = dd + (size_t)b * nD;
  stage(sA, gA, nA);
  stage(sB, gB, nB);
  stage(sD, gD, nD);
  __syncthreads();

  const int c = threadIdx.x;
  if (c >= ncu + NX + 1) return;  // no barrier follows
  const bool is_g = c < ncu;
  const bool is_phi = !is_g && c < ncu + NX;
  const int pc = c - ncu;           // column of phi (is_phi)
  const int blk = is_g ? c / nu : -1;
  const int cu = is_g ? c - blk * nu : 0;

  float col[NX];
#pragma unroll
  for (int r = 0; r < NX; ++r) col[r] = (is_phi && r == pc) ? 1.0f : 0.0f;

  float* oB = B_bar + (size_t)b * N * NX * ncu;
  float* oA = A_bar + (size_t)b * N * NX * NX;
  float* oD = d_bar + (size_t)b * N * NX;
  for (int i = 0; i < N; ++i) {
    const float* A = sA + i * NX * NX;
    float nw[NX];
#pragma unroll
    for (int r = 0; r < NX; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += A[r * NX + j] * col[j];
      nw[r] = acc;
    }
    if (blk == i) {
#pragma unroll
      for (int r = 0; r < NX; ++r) nw[r] = sB[(i * NX + r) * nu + cu];
    } else if (!is_g && !is_phi) {
#pragma unroll
      for (int r = 0; r < NX; ++r) nw[r] += sD[i * NX + r];
    }
#pragma unroll
    for (int r = 0; r < NX; ++r) col[r] = nw[r];

    if (is_g) {
#pragma unroll
      for (int r = 0; r < NX; ++r) oB[((size_t)i * NX + r) * ncu + c] = col[r];
    } else if (is_phi) {
#pragma unroll
      for (int r = 0; r < NX; ++r) oA[(i * NX + r) * NX + pc] = col[r];
    } else {
#pragma unroll
      for (int r = 0; r < NX; ++r) oD[i * NX + r] = col[r];
    }
  }
}

template <int NX>
int launch(const float* Ad, const float* Bd, const float* dd, float* A_bar,
           float* B_bar, float* d_bar, int batch, int N, int nu,
           cudaStream_t st) {
  const int cols = N * nu + NX + 1;
  const int threads = (cols + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (size_t)N * NX * (NX + nu + 1);
  if (threads > MAX_THREADS || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  condense_kernel<NX><<<batch, threads, smem, st>>>(Ad, Bd, dd, A_bar, B_bar,
                                                    d_bar, N, nu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int condense_f32(const float* Ad, const float* Bd,
                            const float* dd, float* A_bar, float* B_bar,
                            float* d_bar, int batch, int N, int nx, int nu,
                            void* stream) {
  if (batch <= 0 || N <= 0 || nu <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nx) {
    case 5: return launch<5>(Ad, Bd, dd, A_bar, B_bar, d_bar, batch, N, nu, st);
    case 7: return launch<7>(Ad, Bd, dd, A_bar, B_bar, d_bar, batch, N, nu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
