// K6: Psi1 of one ARD-RBF kernel under q(X), f32.
//
// Replaces dp_gp_lvm_tpu/ops/pallas/psi.py:_psi1_kernel (wrapper
// psi1_pallas). For every row n and inducing point m
//
//   Psi1_nm = var w_n exp(min(log_norm_n - 1/2 sum_q a_nq (mu_nq - z_mq)^2, 0))
//   a_nq = alpha_q / (alpha_q s_nq + 1),  log_norm_n = -1/2 sum_q log(alpha_q s_nq + 1)
//
// Bound on the H100: at the widths the models use (N ~ 1e3, M <= 128) the
// N*M outputs are a few hundred KB and the N*M exponentials a few
// microseconds of SFU time, so a launch's latency is above either; at
// large N it is the bytes of the (N, M) output. What the design does:
//   * one pass, no reduction, so no partial buffers and nothing to sum;
//   * Z (transposed) and the block's per-row a, mu, log_norm are staged in
//     shared memory once; thread i of a block owns output i of the block's
//     ROWS x M tile, so neighbouring threads write neighbouring addresses
//     and read neighbouring z;
//   * the exponent is taken in its direct form, a sum of non-positive
//     terms (the TPU kernel's expanded row - 2 cross + zsq cancels in
//     f32); the min(., 0) clamp of the reference is kept.
// w may be null (no row weights).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 16;  // rows of a block

__global__ void __launch_bounds__(THREADS)
psi1_kernel(const float* __restrict__ var, const float* __restrict__ ard,
            const float* __restrict__ mu, const float* __restrict__ s,
            const float* __restrict__ w, const float* __restrict__ z,
            float* __restrict__ out, int N, int M, int Q) {
  extern __shared__ float sm[];
  float* z_sh = sm;                 // [Q][M] z transposed
  float* a_sh = z_sh + Q * M;       // [ROWS][Q] alpha / (alpha s + 1)
  float* mu_sh = a_sh + ROWS * Q;   // [ROWS][Q]
  float* ln_sh = mu_sh + ROWS * Q;  // [ROWS] log normaliser
  float* sc_sh = ln_sh + ROWS;      // [ROWS] var * w_n

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, N - row0);
  for (int i = tid; i < Q * M; i += THREADS) {
    const int q = i / M, m = i % M;
    z_sh[i] = z[(long long)m * Q + q];
  }
  const float v = var[0];
  for (int r = tid; r < nrows; r += THREADS) {
    const long long n = row0 + r;
    float ln = 0.f;
    for (int q = 0; q < Q; ++q) {
      const float a = ard[q];
      const float u = a * s[n * Q + q] + 1.f;
      a_sh[r * Q + q] = a / u;
      mu_sh[r * Q + q] = mu[n * Q + q];
      ln -= 0.5f * logf(u);
    }
    ln_sh[r] = ln;
    sc_sh[r] = w ? v * w[n] : v;
  }
  __syncthreads();

  float* out_b = out + (long long)row0 * M;
  for (int i = tid; i < nrows * M; i += THREADS) {
    const int r = i / M, m = i % M;
    float quad = 0.f;
    for (int q = 0; q < Q; ++q) {
      const float df = mu_sh[r * Q + q] - z_sh[q * M + m];
      quad = fmaf(a_sh[r * Q + q] * df, df, quad);
    }
    out_b[i] = sc_sh[r] * expf(fminf(ln_sh[r] - 0.5f * quad, 0.f));
  }
}

}  // namespace

extern "C" int psi1_f32(const float* var, const float* ard, const float* mu,
                        const float* s, const float* w, const float* z,
                        float* out, int N, int M, int Q, cudaStream_t stream) {
  const size_t floats = (size_t)Q * M + 2 * (size_t)ROWS * Q + 2 * ROWS;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      psi1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + ROWS - 1) / ROWS;
  psi1_kernel<<<blocks, THREADS, smem, stream>>>(var, ard, mu, s, w, z, out, N,
                                                 M, Q);
  return (int)cudaGetLastError();
}
