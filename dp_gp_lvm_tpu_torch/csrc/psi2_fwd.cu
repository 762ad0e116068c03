// K4 and K5: the Psi2 forward alone, f32. One kernel body, two entry
// points:
//
//   psi2_batched_f32  (K4) replaces
//     dp_gp_lvm_tpu/ops/pallas/psi.py:_psi2_batched_kernel
//     (wrapper psi2_batched_pallas): the per-atom stack (T, M, M);
//   psi2_single_f32   (K5) replaces
//     dp_gp_lvm_tpu/ops/pallas/psi.py:_psi2_kernel (wrapper psi2_pallas):
//     one kernel's (M, M), the T = 1 case of the same grid.
//
// The TPU file keeps two bodies with identical math; here the atom is
// blockIdx.y and K5 launches a grid of height one.
//
//   Psi2_t = var_t^2 sum_n w_n exp(min(expo_tnml, 0))                (M, M)
//
// Bound on the H100: operations (N*T*M(M+1)/2 exponentials and their
// Q-long pair exponents), as for the Psi2 half of psi_suffstats.cu, whose
// design this follows:
//   * Psi2 is symmetric: each thread owns one 4x4 tile of the upper
//     triangle in registers and mirrors it on the write-out;
//   * the pair exponent is taken in its direct form
//       expo = log_norm_n - 1/4 sum_q alpha_q (z_mq - z_lq)^2
//                         - 1/4 sum_q b_nq (2 mu_nq - z_mq - z_lq)^2,
//     a sum of non-positive terms, all products in full f32 (no tensor
//     cores, no TF32);
//   * rows are staged RS at a time in shared memory; rows past the end of
//     a chunk get zero weight;
//   * each block (N-chunk c, atom t) writes its partial sums to part[c]
//     and a second kernel sums the chunks in chunk order: no atomics, the
//     same bits on every run.
// At T = 1 the grid is under-filled: M = 50 gives 91 tiles, so 91 of a
// block's 128 threads work, and N = 1000 gives 63 blocks for 132 SMs.
#include <cuda_runtime.h>

namespace {

constexpr int RS = 16;  // rows staged in shared memory per pass

struct Dims {
  int T, N, M, Q, M4, T4, NT, rows_per_chunk;
};

__device__ __forceinline__ void upper_tile(int k, int t4, int& tm, int& tl) {
  int row = 0;
  while (k >= t4 - row) {
    k -= t4 - row;
    ++row;
  }
  tm = row;
  tl = row + k;
}

__global__ void psi2_kernel(const float* __restrict__ var,
                            const float* __restrict__ ard,
                            const float* __restrict__ mu,
                            const float* __restrict__ s,
                            const float* __restrict__ w,
                            const float* __restrict__ z,
                            float* __restrict__ part, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const int chunk = blockIdx.x, t = blockIdx.y;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int M = d.M, M4 = d.M4, Q = d.Q;

  float* z_sh = sm;                // [Q][M4] z_t transposed, zero padded
  float* al_sh = z_sh + Q * M4;    // [Q]
  float* sb_sh = al_sh + Q;        // [RS][Q] sqrt(b)
  float* sbm_sh = sb_sh + RS * Q;  // [RS][Q] sqrt(b) * 2 mu
  float* ln_sh = sbm_sh + RS * Q;  // [RS] log normaliser
  float* w_sh = ln_sh + RS;        // [RS]

  for (int i = tid; i < Q * M4; i += nth) {
    const int q = i / M4, m = i % M4;
    z_sh[i] = m < M ? z[((long long)t * M + m) * Q + q] : 0.f;
  }
  for (int q = tid; q < Q; q += nth) al_sh[q] = ard[(long long)t * Q + q];
  __syncthreads();

  // this thread's tile and the n-independent part of its exponents
  const bool has_tile = tid < d.NT;
  int m0 = 0, l0 = 0;
  float le[4][4], acc[4][4];
  if (has_tile) {
    int tm, tl;
    upper_tile(tid, d.T4, tm, tl);
    m0 = 4 * tm;
    l0 = 4 * tl;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      le[i][j] = 0.f;
      acc[i][j] = 0.f;
    }
  if (has_tile) {
    for (int q = 0; q < Q; ++q) {
      const float a = al_sh[q];
      const float4 zm = *reinterpret_cast<const float4*>(z_sh + q * M4 + m0);
      const float4 zl = *reinterpret_cast<const float4*>(z_sh + q * M4 + l0);
      const float zmv[4] = {zm.x, zm.y, zm.z, zm.w};
      const float zlv[4] = {zl.x, zl.y, zl.z, zl.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float df = zmv[i] - zlv[j];
          le[i][j] = fmaf(a * df, df, le[i][j]);
        }
    }
  }

  const int row0 = chunk * d.rows_per_chunk;
  const int row_end = min(d.N, row0 + d.rows_per_chunk);
  for (int base = row0; base < row_end; base += RS) {
    __syncthreads();  // the previous stage's readers are done
    for (int r = tid; r < RS; r += nth) {
      const int n = base + r;
      const bool ok = n < row_end;
      float ln = 0.f;
      for (int q = 0; q < Q; ++q) {
        const float a = al_sh[q];
        const float sv = ok ? s[(long long)n * Q + q] : 1.f;
        const float mv = ok ? mu[(long long)n * Q + q] : 0.f;
        const float u = 2.f * a * sv + 1.f;
        const float sb = sqrtf(a / u);
        ln -= 0.5f * logf(u);
        sb_sh[r * Q + q] = sb;
        sbm_sh[r * Q + q] = sb * 2.f * mv;
      }
      ln_sh[r] = ln;
      w_sh[r] = ok ? w[n] : 0.f;
    }
    __syncthreads();

    if (has_tile) {
      for (int r = 0; r < RS; ++r) {
        float quad[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) quad[i][j] = 0.f;
        for (int q = 0; q < Q; ++q) {
          const float sb = sb_sh[r * Q + q], sbm = sbm_sh[r * Q + q];
          const float4 zm = *reinterpret_cast<const float4*>(z_sh + q * M4 + m0);
          const float4 zl = *reinterpret_cast<const float4*>(z_sh + q * M4 + l0);
          const float pm[4] = {fmaf(-sb, zm.x, sbm), fmaf(-sb, zm.y, sbm),
                               fmaf(-sb, zm.z, sbm), fmaf(-sb, zm.w, sbm)};
          const float pl[4] = {sb * zl.x, sb * zl.y, sb * zl.z, sb * zl.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float df = pm[i] - pl[j];
              quad[i][j] = fmaf(df, df, quad[i][j]);
            }
        }
        const float ln = ln_sh[r], wr = w_sh[r];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float expo = ln - 0.25f * (le[i][j] + quad[i][j]);
            acc[i][j] = fmaf(wr, expf(fminf(expo, 0.f)), acc[i][j]);
          }
      }
    }
  }

  // partial sums of this (chunk, atom)
  if (has_tile) {
    float* p2 = part + ((long long)chunk * d.T + t) * M * M;
    const float v = var[t], v2 = v * v;
    const bool diag = m0 == l0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + i, l = l0 + j;
        if (m < M && l < M) {
          p2[m * M + l] = v2 * acc[i][j];
          if (!diag) p2[l * M + m] = v2 * acc[i][j];
        }
      }
  }
}

// out = sum over chunks of part, in chunk order
__global__ void reduce_chunks(const float* __restrict__ part, int chunks,
                              long long P, float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < P;
       i += (long long)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int c = 0; c < chunks; ++c) a += part[c * P + i];
    out[i] = a;
  }
}

int launch(const float* var, const float* ard, const float* mu, const float* s,
           const float* w, const float* z, float* part, float* out, int T,
           int N, int M, int Q, int rows_per_chunk, int chunks,
           cudaStream_t stream) {
  Dims d;
  d.T = T; d.N = N; d.M = M; d.Q = Q;
  d.T4 = (M + 3) / 4;
  d.M4 = 4 * d.T4;
  d.NT = d.T4 * (d.T4 + 1) / 2;
  d.rows_per_chunk = rows_per_chunk;
  int threads = ((d.NT + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t floats = (size_t)Q * d.M4 + Q + 2 * (size_t)RS * Q + 2 * RS;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      psi2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  psi2_kernel<<<dim3(chunks, T), threads, smem, stream>>>(var, ard, mu, s, w, z,
                                                          part, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long P = (long long)T * M * M;
  const int rthreads = 256;
  long long rblocks = (P + rthreads - 1) / rthreads;
  if (rblocks > 4096) rblocks = 4096;
  reduce_chunks<<<(int)rblocks, rthreads, 0, stream>>>(part, chunks, P, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psi2_batched_f32(const float* var, const float* ard,
                                const float* mu, const float* s,
                                const float* w, const float* z, float* part,
                                float* out, int T, int N, int M, int Q,
                                int rows_per_chunk, int chunks,
                                cudaStream_t stream) {
  return launch(var, ard, mu, s, w, z, part, out, T, N, M, Q, rows_per_chunk,
                chunks, stream);
}

extern "C" int psi2_single_f32(const float* var, const float* ard,
                               const float* mu, const float* s, const float* w,
                               const float* z, float* part, float* out, int N,
                               int M, int Q, int rows_per_chunk, int chunks,
                               cudaStream_t stream) {
  return launch(var, ard, mu, s, w, z, part, out, 1, N, M, Q, rows_per_chunk,
                chunks, stream);
}
