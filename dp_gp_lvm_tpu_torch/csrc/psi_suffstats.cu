// K1: fused per-atom sufficient statistics of the DP-GP-LVM bound, f32.
//
// Replaces dp_gp_lvm_tpu/ops/pallas/psi.py:_suffstats_batched_kernel
// (wrapper suffstats_batched_pallas). For every atom t it computes
//
//   Psi2_t   = var_t^2 sum_n w_n exp(min(expo_tnml, 0))          (M, M)
//   P1Y_t    = sum_n var_t w_n exp(min(e1_tnm, 0)) y_n^T          (M, D)
//
// in one pass over the rows; the (T, N, M) Psi1 tensor never reaches
// device memory.
//
// Bound on the H100: operations, not bytes. The inputs are a few hundred
// KB; the work is N*T*M(M+1)/2 exponentials and Q-long reductions of the
// pair exponent (c4 widths: 42.6 M exp, ~0.9 GFLOP), i.e. the FP32 pipes
// and the SFU (exp). What the design does about it:
//   * Psi2 is symmetric: each thread owns one 4x4 tile of the upper
//     triangle (tiles with tm <= tl), keeps its 16 sums in registers and
//     mirrors them on the write-out, which halves the exponentials.
//   * The pair exponent is taken in its direct form
//       expo = log_norm_n - 1/4 sum_q alpha_q (z_mq - z_lq)^2
//                         - 1/4 sum_q b_nq (2 mu_nq - z_mq - z_lq)^2,
//     a sum of non-positive terms with no cancellation, so f32 keeps its
//     relative precision (the reference's expanded quadratic form
//     cancels; the n-independent first sum is kept in registers per
//     block). No tensor cores and no TF32: every product is full f32.
//   * Rows are staged RS at a time in shared memory; Psi1 for the staged
//     rows is formed there and contracted at once with the staged Y rows
//     into a (M, D) accumulator in shared memory.
//   * The TPU grid accumulated into one output block in grid order. CUDA
//     blocks run concurrently, so each block (atom t, N-chunk c) writes
//     its partial sums to part[c] and a second kernel sums the chunks in
//     a fixed order: no atomics, the same bits on every run.
#include <cuda_runtime.h>

namespace {

constexpr int RS = 16;  // rows staged in shared memory per pass

struct Dims {
  int T, N, M, Q, D, M4, T4, NT, rows_per_chunk;
};

struct Segments {  // where the chunk-reduced result goes
  float* out[4];
  long long off[5];
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

__global__ void suffstats_kernel(const float* __restrict__ var,
                                 const float* __restrict__ ard,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ s,
                                 const float* __restrict__ w,
                                 const float* __restrict__ z,
                                 const float* __restrict__ y,
                                 float* __restrict__ part, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const int chunk = blockIdx.x, t = blockIdx.y;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int M = d.M, M4 = d.M4, Q = d.Q, D = d.D;

  float* z_sh = sm;                  // [Q][M4] z_t transposed, zero padded
  float* al_sh = z_sh + Q * M4;      // [Q]
  float* sb_sh = al_sh + Q;          // [RS][Q] sqrt(b)
  float* sbm_sh = sb_sh + RS * Q;    // [RS][Q] sqrt(b) * 2 mu
  float* a1_sh = sbm_sh + RS * Q;    // [RS][Q] alpha / (alpha s + 1)
  float* mu_sh = a1_sh + RS * Q;     // [RS][Q]
  float* ln_sh = mu_sh + RS * Q;     // [RS] Psi2 log normaliser
  float* l1_sh = ln_sh + RS;         // [RS] Psi1 log normaliser
  float* w_sh = l1_sh + RS;          // [RS]
  float* p1_sh = w_sh + RS;          // [RS][M] var * w * Psi1 row
  float* y_sh = p1_sh + RS * M;      // [RS][D]
  float* acc_sh = y_sh + RS * D;     // [M][D] P1Y accumulator

  const float v = var[t];
  for (int i = tid; i < Q * M4; i += nth) {
    const int q = i / M4, m = i % M4;
    z_sh[i] = m < M ? z[((long long)t * M + m) * Q + q] : 0.f;
  }
  for (int q = tid; q < Q; q += nth) al_sh[q] = ard[(long long)t * Q + q];
  for (int i = tid; i < M * D; i += nth) acc_sh[i] = 0.f;
  __syncthreads();

  // this thread's Psi2 tile and its n-independent exponent part
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
    // per-row scalars; rows past the end get zero weight
    for (int r = tid; r < RS; r += nth) {
      const int n = base + r;
      const bool ok = n < row_end;
      float ln = 0.f, l1 = 0.f;
      for (int q = 0; q < Q; ++q) {
        const float a = al_sh[q];
        const float sv = ok ? s[(long long)n * Q + q] : 1.f;
        const float mv = ok ? mu[(long long)n * Q + q] : 0.f;
        const float u = 2.f * a * sv + 1.f;
        const float u1 = a * sv + 1.f;
        const float sb = sqrtf(a / u);
        ln -= 0.5f * logf(u);
        l1 -= 0.5f * logf(u1);
        sb_sh[r * Q + q] = sb;
        sbm_sh[r * Q + q] = sb * 2.f * mv;
        a1_sh[r * Q + q] = a / u1;
        mu_sh[r * Q + q] = mv;
      }
      ln_sh[r] = ln;
      l1_sh[r] = l1;
      w_sh[r] = ok ? w[n] : 0.f;
    }
    for (int i = tid; i < RS * D; i += nth) {
      const int r = i / D, n = base + r;
      y_sh[i] = n < row_end ? y[(long long)n * D + (i % D)] : 0.f;
    }
    __syncthreads();

    // Psi1 rows of the stage
    for (int i = tid; i < RS * M; i += nth) {
      const int r = i / M, m = i % M;
      float quad = 0.f;
      for (int q = 0; q < Q; ++q) {
        const float df = mu_sh[r * Q + q] - z_sh[q * M4 + m];
        quad = fmaf(a1_sh[r * Q + q] * df, df, quad);
      }
      const float e1 = fminf(l1_sh[r] - 0.5f * quad, 0.f);
      p1_sh[i] = v * w_sh[r] * expf(e1);
    }

    // Psi2 tile over the staged rows
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
    __syncthreads();  // p1_sh complete

    // P1Y += Psi1^T Y over the staged rows (each element has one owner)
    for (int i = tid; i < M * D; i += nth) {
      const int m = i / D, dd = i % D;
      float a = acc_sh[i];
      for (int r = 0; r < RS; ++r) a = fmaf(p1_sh[r * M + m], y_sh[r * D + dd], a);
      acc_sh[i] = a;
    }
    __syncthreads();  // stage buffers free for the next pass
  }

  // partial sums of this (chunk, atom)
  const long long P = (long long)d.T * M * M + (long long)d.T * M * D;
  float* p2 = part + chunk * P + (long long)t * M * M;
  float* p1y = part + chunk * P + (long long)d.T * M * M + (long long)t * M * D;
  if (has_tile) {
    const float v2 = v * v;
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
  for (int i = tid; i < M * D; i += nth) p1y[i] = acc_sh[i];
}

// out = sum over chunks of part, in chunk order, scattered to segments
__global__ void reduce_chunks(const float* __restrict__ part, int chunks,
                              long long P, Segments seg) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < P;
       i += (long long)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int c = 0; c < chunks; ++c) a += part[c * P + i];
    int k = 0;
    while (i >= seg.off[k + 1]) ++k;
    seg.out[k][i - seg.off[k]] = a;
  }
}

}  // namespace

extern "C" int psi_suffstats_f32(const float* var, const float* ard,
                                 const float* mu, const float* s,
                                 const float* w, const float* z,
                                 const float* y, float* part, float* psi2,
                                 float* p1y, int T, int N, int M, int Q, int D,
                                 int rows_per_chunk, int chunks,
                                 cudaStream_t stream) {
  Dims d;
  d.T = T; d.N = N; d.M = M; d.Q = Q; d.D = D;
  d.T4 = (M + 3) / 4;
  d.M4 = 4 * d.T4;
  d.NT = d.T4 * (d.T4 + 1) / 2;
  d.rows_per_chunk = rows_per_chunk;
  int threads = ((d.NT + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t floats = (size_t)Q * d.M4 + Q + 4 * RS * Q + 3 * RS +
                        (size_t)RS * M + (size_t)RS * D + (size_t)M * D;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      suffstats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  suffstats_kernel<<<dim3(chunks, T), threads, smem, stream>>>(
      var, ard, mu, s, w, z, y, part, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Segments seg;
  seg.out[0] = psi2;
  seg.out[1] = p1y;
  seg.out[2] = nullptr;
  seg.out[3] = nullptr;
  seg.off[0] = 0;
  seg.off[1] = (long long)T * M * M;
  seg.off[2] = seg.off[1] + (long long)T * M * D;
  seg.off[3] = seg.off[2];
  seg.off[4] = seg.off[2];
  const long long P = seg.off[2];
  const int rthreads = 256;
  long long rblocks = (P + rthreads - 1) / rthreads;
  if (rblocks > 4096) rblocks = 4096;
  reduce_chunks<<<(int)rblocks, rthreads, 0, stream>>>(part, chunks, P, seg);
  return (int)cudaGetLastError();
}
