// K2: fused analytic Psi2 pullback over the DP atom stack, f32.
//
// Replaces dp_gp_lvm_tpu/ops/pallas/psi.py:_psi2_bwd_batched_kernel
// (wrapper psi2_bwd_batched_pallas); the derivation is in
// dp_gp_lvm_tpu/kernels/ard_rbf_vjp.py. With
//   W_tnml = var_t^2 w_n exp(min(expo,0)) 1[expo<0] G_tml
// it returns, per atom (summed over rows):
//   gvar_m (T,M)  = sum_n sum_l w_n exp(min(expo,0)) G      (unmasked)
//   gard   (T,Q), gz (T,M,Q)   without the E0 pull, V (T,M,M) = sum_n W
// and, per row (summed over atoms): gmu, gs (N,Q) and gw (N,)
//   gw_n = sum_t var_t^2 <exp(min(expo_tn,0)), G_t>.
// The n-independent E0 pulls are finished outside from V, in plain torch,
// as the JAX package does.
//
// Bound on the H100: operations. Per (atom, row) the M x M exponent tile
// costs M^2 exponentials and ~2Q M^2 FLOPs, and its pullback another
// ~2Q M^2 FLOPs (the (M,M) x (M,Q) contraction W_sym Z). What the design
// does about it:
//   * Atoms are looped inside the block, as on the TPU, so the per-row
//     outputs gmu, gs, gw have one owner and need no cross-block sum.
//   * A block works one row at a time (the TPU held a (B, M, M) tile in
//     64 MB of VMEM; a block here has 227 KB). The row's W tile lives in
//     shared memory with a padded stride (M+1) so that row and column
//     reads are free of bank conflicts; V is summed in registers.
//   * Reductions over the tile (row sums via warp shuffles, column sums,
//     W_sym Z, per-q sums) run in a fixed order: no atomics anywhere.
//   * The exponent is taken in its direct form (see psi_suffstats.cu),
//     all products in full f32, no tensor cores.
//   * Per-atom accumulators are written per N-chunk to part[c] and a
//     second kernel sums the chunks in chunk order.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;        // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_M = 128;          // V registers: (MAX_M/WARPS) x (MAX_M/32)
constexpr int VK = MAX_M / WARPS;
constexpr int VJ = MAX_M / 32;

struct Dims {
  int T, N, M, Q, rows_per_chunk;
};

struct Segments {
  float* out[4];
  long long off[5];
};

__global__ void __launch_bounds__(THREADS)
psi2_bwd_kernel(const float* __restrict__ var, const float* __restrict__ ard,
                const float* __restrict__ mu, const float* __restrict__ s,
                const float* __restrict__ w, const float* __restrict__ z,
                const float* __restrict__ g, float* __restrict__ part,
                float* __restrict__ gmu, float* __restrict__ gs,
                float* __restrict__ gw, Dims d) {
  extern __shared__ float sm[];
  const int chunk = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int T = d.T, M = d.M, Q = d.Q, RC = d.rows_per_chunk;
  const int MP = M + 1;  // padded stride

  float* z_sh = sm;                 // [Q][MP]  z_t transposed
  float* le_sh = z_sh + Q * MP;     // [M][MP]  sum_q alpha (z_m - z_l)^2
  float* w_sh = le_sh + M * MP;     // [M][MP]  W tile of the current row
  float* pz_sh = w_sh + M * MP;     // [M][Q]   sqrt(b) (2 mu - z_m)
  float* sz_sh = pz_sh + M * Q;     // [Q][MP]  sqrt(b) z_l
  float* p_sh = sz_sh + Q * MP;     // [M] sum_l exp(min(expo,0)) G
  float* wr_sh = p_sh + M;          // [M] sum_l W_ml
  float* r_sh = wr_sh + M;          // [M] sum_l (W_ml + W_lm)
  float* gv_sh = r_sh + M;          // [M] gvar partial of the atom
  float* wsz_sh = gv_sh + M;        // [M][Q] sum_l (W_ml + W_lm) z_lq
  float* gz_sh = wsz_sh + M * Q;    // [M][Q] gz partial of the atom
  float* al_sh = gz_sh + M * Q;     // [Q]
  float* ga_sh = al_sh + Q;         // [Q] gard partial of the atom
  float* mu_r = ga_sh + Q;          // [RC][Q]
  float* s_r = mu_r + RC * Q;       // [RC][Q]
  float* b_r = s_r + RC * Q;        // [RC][Q] b of the current atom
  float* u_r = b_r + RC * Q;        // [RC][Q] u of the current atom
  float* gmu_r = u_r + RC * Q;      // [RC][Q]
  float* gs_r = gmu_r + RC * Q;     // [RC][Q]
  float* w_r = gs_r + RC * Q;       // [RC]
  float* ln_r = w_r + RC;           // [RC]
  float* gw_r = ln_r + RC;          // [RC]

  const int row0 = chunk * RC;
  const int nrows = min(RC, d.N - row0);
  for (int i = tid; i < nrows * Q; i += THREADS) {
    mu_r[i] = mu[(long long)row0 * Q + i];
    s_r[i] = s[(long long)row0 * Q + i];
    gmu_r[i] = 0.f;
    gs_r[i] = 0.f;
  }
  for (int r = tid; r < nrows; r += THREADS) {
    w_r[r] = w[row0 + r];
    gw_r[r] = 0.f;
  }

  const long long P = (long long)T * (M + Q + M * Q + M * M);
  float* part_c = part + chunk * P;

  for (int t = 0; t < T; ++t) {
    __syncthreads();  // previous atom's readers are done
    const float v = var[t], v2 = v * v;
    for (int i = tid; i < Q * M; i += THREADS) {
      const int q = i / M, m = i % M;
      z_sh[q * MP + m] = z[((long long)t * M + m) * Q + q];
    }
    for (int q = tid; q < Q; q += THREADS) {
      al_sh[q] = ard[(long long)t * Q + q];
      ga_sh[q] = 0.f;
    }
    for (int i = tid; i < M * Q; i += THREADS) gz_sh[i] = 0.f;
    for (int m = tid; m < M; m += THREADS) gv_sh[m] = 0.f;
    __syncthreads();
    for (int r = tid; r < nrows; r += THREADS) {
      float ln = 0.f;
      for (int q = 0; q < Q; ++q) {
        const float a = al_sh[q];
        const float u = 2.f * a * s_r[r * Q + q] + 1.f;
        u_r[r * Q + q] = u;
        b_r[r * Q + q] = a / u;
        ln -= 0.5f * logf(u);
      }
      ln_r[r] = ln;
    }
    for (int i = tid; i < M * M; i += THREADS) {
      const int m = i / M, l = i % M;
      float acc = 0.f;
      for (int q = 0; q < Q; ++q) {
        const float df = z_sh[q * MP + m] - z_sh[q * MP + l];
        acc = fmaf(al_sh[q] * df, df, acc);
      }
      le_sh[m * MP + l] = acc;
    }
    float vacc[VK][VJ];
#pragma unroll
    for (int k = 0; k < VK; ++k)
#pragma unroll
      for (int j = 0; j < VJ; ++j) vacc[k][j] = 0.f;

    for (int r = 0; r < nrows; ++r) {
      __syncthreads();  // le_sh / row scalars ready; last row's readers done
      const float wn = w_r[r], ln = ln_r[r];
      for (int i = tid; i < M * Q; i += THREADS) {
        const int m = i / Q, q = i % Q;
        const float sb = sqrtf(b_r[r * Q + q]);
        const float zq = z_sh[q * MP + m];
        pz_sh[i] = sb * (2.f * mu_r[r * Q + q] - zq);
        sz_sh[q * MP + m] = sb * zq;
      }
      __syncthreads();

      // W tile: warp owns rows m = warp + k*WARPS, lane owns l = lane + 32 j
#pragma unroll
      for (int k = 0; k < VK; ++k) {
        const int m = warp + k * WARPS;
        if (m < M) {
          float psum = 0.f, wsum = 0.f;
#pragma unroll
          for (int j = 0; j < VJ; ++j) {
            const int l = lane + 32 * j;
            if (l < M) {
              float quad = 0.f;
              for (int q = 0; q < Q; ++q) {
                const float df = pz_sh[m * Q + q] - sz_sh[q * MP + l];
                quad = fmaf(df, df, quad);
              }
              const float expo = ln - 0.25f * (le_sh[m * MP + l] + quad);
              const float e = expf(fminf(expo, 0.f));
              const float gg = g[((long long)t * M + m) * M + l];
              const float wv = expo < 0.f ? v2 * wn * e * gg : 0.f;
              w_sh[m * MP + l] = wv;
              vacc[k][j] += wv;
              psum = fmaf(e, gg, psum);
              wsum += wv;
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            psum += __shfl_xor_sync(0xffffffffu, psum, o);
            wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
          }
          if (lane == 0) {
            p_sh[m] = psum;
            wr_sh[m] = wsum;
          }
        }
      }
      __syncthreads();

      // R = row + column sums of W; W_sym Z; gvar partial
      for (int i = tid; i < M * Q + M; i += THREADS) {
        if (i < M * Q) {
          const int m = i / Q, q = i % Q;
          float a = 0.f;
          for (int l = 0; l < M; ++l)
            a = fmaf(w_sh[m * MP + l] + w_sh[l * MP + m], z_sh[q * MP + l], a);
          wsz_sh[i] = a;
        } else {
          const int m = i - M * Q;
          float col = 0.f;
          for (int l = 0; l < M; ++l) col += w_sh[l * MP + m];
          r_sh[m] = wr_sh[m] + col;
          gv_sh[m] = fmaf(wn, p_sh[m], gv_sh[m]);
        }
      }
      __syncthreads();

      // per-q pulls of the row, gz pulls, gw
      for (int i = tid; i < Q + M * Q + 1; i += THREADS) {
        if (i < Q) {
          const int q = i;
          float A = 0.f, U = 0.f, rz = 0.f, rz2 = 0.f;
          for (int m = 0; m < M; ++m) {
            const float zq = z_sh[q * MP + m];
            A += wr_sh[m];
            U = fmaf(wsz_sh[m * Q + q], zq, U);
            rz = fmaf(r_sh[m], zq, rz);
            rz2 = fmaf(r_sh[m] * zq, zq, rz2);
          }
          U *= 0.5f;
          const float mq = mu_r[r * Q + q], b = b_r[r * Q + q];
          const float u = u_r[r * Q + q], sq = s_r[r * Q + q];
          const float gb = -mq * mq * A + mq * rz - 0.25f * rz2 - 0.5f * U;
          gmu_r[r * Q + q] += b * (-2.f * mq * A + rz);
          gs_r[r * Q + q] += gb * (-2.f * b * b) - A * b;
          ga_sh[q] += gb / (u * u) - A * sq / u;
        } else if (i < Q + M * Q) {
          const int j = i - Q, m = j / Q, q = j % Q;
          const float b = b_r[r * Q + q], mq = mu_r[r * Q + q];
          const float rm = r_sh[m];
          gz_sh[j] += rm * b * mq - 0.5f * z_sh[q * MP + m] * rm * b -
                      0.5f * wsz_sh[j] * b;
        } else {
          float ps = 0.f;
          for (int m = 0; m < M; ++m) ps += p_sh[m];
          gw_r[r] += v2 * ps;
        }
      }
    }
    __syncthreads();

    // this atom's partials: [gvar_m (T,M) | gard (T,Q) | gz (T,M,Q) | V]
    float* pv = part_c + (long long)t * M;
    float* pa = part_c + (long long)T * M + (long long)t * Q;
    float* pz = part_c + (long long)T * (M + Q) + (long long)t * M * Q;
    float* pV = part_c + (long long)T * (M + Q + M * Q) + (long long)t * M * M;
    for (int m = tid; m < M; m += THREADS) pv[m] = gv_sh[m];
    for (int q = tid; q < Q; q += THREADS) pa[q] = ga_sh[q];
    for (int i = tid; i < M * Q; i += THREADS) pz[i] = gz_sh[i];
#pragma unroll
    for (int k = 0; k < VK; ++k) {
      const int m = warp + k * WARPS;
#pragma unroll
      for (int j = 0; j < VJ; ++j) {
        const int l = lane + 32 * j;
        if (m < M && l < M) pV[m * M + l] = vacc[k][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * Q; i += THREADS) {
    gmu[(long long)row0 * Q + i] = gmu_r[i];
    gs[(long long)row0 * Q + i] = gs_r[i];
  }
  for (int r = tid; r < nrows; r += THREADS) gw[row0 + r] = gw_r[r];
}

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

extern "C" int psi2_bwd_f32(const float* var, const float* ard,
                            const float* mu, const float* s, const float* w,
                            const float* z, const float* g, float* part,
                            float* gvar_m, float* gard, float* gz, float* V,
                            float* gmu, float* gs, float* gw, int T, int N,
                            int M, int Q, int rows_per_chunk, int chunks,
                            cudaStream_t stream) {
  if (M > MAX_M) return (int)cudaErrorInvalidValue;
  Dims d;
  d.T = T; d.N = N; d.M = M; d.Q = Q; d.rows_per_chunk = rows_per_chunk;
  const int MP = M + 1;
  const size_t floats = (size_t)Q * MP + 2 * (size_t)M * MP + (size_t)M * Q +
                        (size_t)Q * MP + 4 * (size_t)M + 2 * (size_t)M * Q +
                        2 * (size_t)Q + (size_t)rows_per_chunk * (6 * Q + 3);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      psi2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  psi2_bwd_kernel<<<chunks, THREADS, smem, stream>>>(var, ard, mu, s, w, z, g,
                                                     part, gmu, gs, gw, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Segments seg;
  seg.out[0] = gvar_m;
  seg.out[1] = gard;
  seg.out[2] = gz;
  seg.out[3] = V;
  seg.off[0] = 0;
  seg.off[1] = (long long)T * M;
  seg.off[2] = seg.off[1] + (long long)T * Q;
  seg.off[3] = seg.off[2] + (long long)T * M * Q;
  seg.off[4] = seg.off[3] + (long long)T * M * M;
  const long long P = seg.off[4];
  const int rthreads = 256;
  long long rblocks = (P + rthreads - 1) / rthreads;
  if (rblocks > 4096) rblocks = 4096;
  reduce_chunks<<<(int)rblocks, rthreads, 0, stream>>>(part, chunks, P, seg);
  return (int)cudaGetLastError();
}
