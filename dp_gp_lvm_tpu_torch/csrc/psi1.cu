// K6: Psi1 of one ARD-RBF kernel under q(X), f32.
//
// Replaces dp_gp_lvm_tpu/ops/pallas/psi.py:_psi1_kernel (wrapper
// psi1_pallas). For every row n and inducing point m
//
//   Psi1_nm = var w_n exp(min(log_norm_n - 1/2 sum_q a_nq (mu_nq - z_mq)^2, 0))
//   a_nq = alpha_q / (alpha_q s_nq + 1),  log_norm_n = -1/2 sum_q log(alpha_q s_nq + 1)
//
// Bound on the H100: the bytes of the (N, M) output at large N (4.2 MB at
// N = 8192, M = 128: 1.3 us at 3.35 TB/s), against 2 FP32 instructions
// per output and q (0.6 us there); at the models' widths (c2: N = 1000,
// M = 50) the launch. What the design does:
//   * One warp computes one row of a column tile of COLS = 128 columns at
//     a time, each lane four adjacent columns; the grid's y axis walks
//     the column tiles, so any M runs. A block is WARPS warps; the grid
//     holds about one wave of resident blocks (ops/psi.py::k6_geometry)
//     and each warp walks its steps of S rows grid-stride.
//   * The block's tile of Z is read once, coalesced, and stored
//     transposed in shared memory; where Q is fixed at compile time
//     (Q = 10, the latent width of c2 and c4) each lane then holds its
//     four columns' z for every q in registers over all its rows, else it
//     reads them from the tile row by row.
//   * Each warp prepares the S rows of its step itself, a lane per
//     (row, q), with __syncwarp and no block barrier: sa_q =
//     sqrt(a_nq log2(e) / 2), c_q = sa_q mu_nq, and ln2_n = log2(e)
//     log_norm_n summed in q order by the row's lane. S is the fewest rows
//     that let one wave of blocks take all rows in one step each.
//   * The exponent in its direct form, a sum of non-positive terms (the
//     TPU kernel's expanded row - 2 cross + zsq cancels in f32): per
//     output and q two FP32 instructions, d = fma(-sa_q, z_mq, c_q) and
//     quad = fma(d, d, quad); the row's (sa, c) pairs are one shared-
//     memory broadcast per two q for the whole warp. Then
//     out = var w_n 2^min(ln2_n - quad, 0), the reference's clamp before
//     var w multiplies, by ex2.approx.ftz (results below 2^-126 flush
//     to zero).
//   * 16-byte stores where M % 4 == 0, 8-byte where M is even, else
//     scalar; columns past M are not stored.
//   * No reduction: every output is written once, by one lane, so no
//     atomics and the same bits on every launch.
// w may be null (no row weights).
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 128;          // columns of a tile, four per lane
constexpr int MAX_STEP_ROWS = 8;   // most rows a warp prepares at once
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// shared-memory layout, offsets in floats: the z tile [Q][COLS] and then,
// per warp, [S][RI] (sa, c) pairs, [S][Q] log2 u and [S] (ln2, var w)
struct Layout {
  int RI, logs, scal, warp, z_tile, total;
};

__host__ __device__ Layout layout(int Q, int S) {
  Layout l;
  l.RI = round4(2 * Q);
  l.logs = S * l.RI;
  l.scal = l.logs + 2 * ((S * Q + 1) / 2);
  l.warp = round4(l.scal + 2 * S);
  l.z_tile = Q * COLS;
  l.total = l.z_tile + WARPS * l.warp;
  return l;
}

// 2^x; results below 2^-126 flush to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// columns c0..c0+3 of a row, those below M
__device__ __forceinline__ void store4(float* row, int c0, int M,
                                       const float (&o)[4]) {
  if ((M & 3) == 0) {
    if (c0 < M)
      *reinterpret_cast<float4*>(row + c0) = make_float4(o[0], o[1], o[2],
                                                         o[3]);
  } else if ((M & 1) == 0) {
    if (c0 < M) *reinterpret_cast<float2*>(row + c0) = make_float2(o[0], o[1]);
    if (c0 + 2 < M)
      *reinterpret_cast<float2*>(row + c0 + 2) = make_float2(o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < M) row[c0 + j] = o[j];
  }
}

// QC: Q fixed at compile time (z in registers, the q loop unrolled); 0
// takes it from Q_ (z read from the shared tile)
template <int QC>
__global__ void __launch_bounds__(THREADS)
psi1_kernel(const float* __restrict__ var, const float* __restrict__ ard,
            const float* __restrict__ mu, const float* __restrict__ s,
            const float* __restrict__ w, const float* __restrict__ z,
            float* __restrict__ out, int N, int M, int Q_, int S) {
  static_assert(QC % 2 == 0, "the fixed width is read two q at a time");
  extern __shared__ __align__(16) float sm[];
  const int Q = QC ? QC : Q_;
  const Layout lay = layout(Q, S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* wb = sm + lay.z_tile + warp * lay.warp;

  // the block's tile of Z, read once in its own order (coalesced) and
  // stored transposed, [q][COLS]; columns past M are zero
  const int m0 = blockIdx.y * COLS;
  for (int i = threadIdx.x; i < Q * COLS; i += THREADS) {
    const int m = i / Q;
    sm[(i - m * Q) * COLS + m] =
        m0 + m < M ? __ldg(z + (long long)m0 * Q + i) : 0.f;
  }
  __syncthreads();
  float zr[4][QC ? QC : 1];
  if constexpr (QC > 0) {
#pragma unroll
    for (int q = 0; q < QC; ++q) {
      const float4 zv = *reinterpret_cast<const float4*>(sm + q * COLS
                                                         + 4 * lane);
      zr[0][q] = zv.x;
      zr[1][q] = zv.y;
      zr[2][q] = zv.z;
      zr[3][q] = zv.w;
    }
  }
  const float v = __ldg(var);

  const long long steps = (N + S - 1) / S;
  for (long long g = (long long)blockIdx.x * WARPS + warp; g < steps;
       g += (long long)gridDim.x * WARPS) {
    const long long n0 = g * S;
    const int nb = (int)min((long long)S, N - n0);
    const float wn = lane < nb && w ? __ldg(w + n0 + lane) : 1.f;
    // pair p of the step is (row p / Q, q p % Q): mu and s at n0 Q + p
    for (int p = lane; p < nb * Q; p += 32) {
      const int r = p / Q, q = p - r * Q;
      const float a = __ldg(ard + q);
      const float u = fmaf(a, __ldg(s + n0 * Q + p), 1.f);
      const float sa = sqrtf(a / u * (0.5f * LOG2E));
      wb[r * lay.RI + 2 * q] = sa;
      wb[r * lay.RI + 2 * q + 1] = sa * __ldg(mu + n0 * Q + p);
      wb[lay.logs + p] = log2f(u);
    }
    __syncwarp();
    if (lane < nb) {
      float l2 = 0.f;
      for (int q = 0; q < Q; ++q) l2 += wb[lay.logs + lane * Q + q];
      wb[lay.scal + 2 * lane] = -0.5f * l2;
      wb[lay.scal + 2 * lane + 1] = v * wn;
    }
    __syncwarp();

    for (int r = 0; r < nb; ++r) {
      const float* rr = wb + r * lay.RI;
      float quad[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (QC > 0) {
#pragma unroll
        for (int q = 0; q < QC; q += 2) {
          const float4 p = *reinterpret_cast<const float4*>(rr + 2 * q);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float d0 = fmaf(-p.x, zr[j][q], p.y);
            quad[j] = fmaf(d0, d0, quad[j]);
            const float d1 = fmaf(-p.z, zr[j][q + 1], p.w);
            quad[j] = fmaf(d1, d1, quad[j]);
          }
        }
      } else {
#pragma unroll 2
        for (int q = 0; q < Q; ++q) {
          const float2 p = *reinterpret_cast<const float2*>(rr + 2 * q);
          const float4 zv = *reinterpret_cast<const float4*>(sm + q * COLS
                                                             + 4 * lane);
          const float zq[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float d = fmaf(-p.x, zq[j], p.y);
            quad[j] = fmaf(d, d, quad[j]);
          }
        }
      }
      const float2 ls = *reinterpret_cast<const float2*>(wb + lay.scal
                                                         + 2 * r);
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = ls.y * exp2_ftz(fminf(ls.x - quad[j], 0.f));
      store4(out + (n0 + r) * M, m0 + 4 * lane, M, o);
    }
    __syncwarp();  // the step's rows free for the next
  }
}

template <class F>
int with_kernel(int Q, F&& f) {
  return Q == 10 ? f(psi1_kernel<10>) : f(psi1_kernel<0>);
}

bool valid(int M, int Q, int S) {
  return M >= 1 && Q >= 1 && S >= 1 && S <= MAX_STEP_ROWS;
}

// the block's shared memory; above the default (from Q = 81 on) the kernel
// must be allowed more
template <class K>
int shared_bytes(K kernel, int Q, int S, size_t& smem) {
  smem = (size_t)layout(Q, S).total * sizeof(float);
  if (smem <= SMEM_DEFAULT) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// blocks of K6 that fit on one SM at (Q, S), 0 where none fits, or minus
// a CUDA error
extern "C" int psi1_blocks_per_sm(int Q, int S) {
  if (!valid(1, Q, S)) return -(int)cudaErrorInvalidValue;
  int max_smem = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  return with_kernel(Q, [&](auto kernel) {
    if ((size_t)layout(Q, S).total * sizeof(float) > (size_t)max_smem)
      return 0;
    size_t smem = 0;
    const int e = shared_bytes(kernel, Q, S, smem);
    if (e != 0) return -e;
    int blocks = 0;
    const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, THREADS, smem);
    return occ == cudaSuccess ? blocks : -(int)occ;
  });
}

// K6: out (N, M) on a grid of row_blocks x ceil(M / 128) blocks, S rows a
// warp step
extern "C" int psi1_f32(const float* var, const float* ard, const float* mu,
                        const float* s, const float* w, const float* z,
                        float* out, int N, int M, int Q, int S, int row_blocks,
                        cudaStream_t stream) {
  if (!valid(M, Q, S) || N < 1 || row_blocks < 1)
    return (int)cudaErrorInvalidValue;
  return with_kernel(Q, [&](auto kernel) {
    size_t smem = 0;
    const int e = shared_bytes(kernel, Q, S, smem);
    if (e != 0) return e;
    const dim3 grid(row_blocks, (M + COLS - 1) / COLS);
    kernel<<<grid, THREADS, smem, stream>>>(var, ard, mu, s, w, z, out, N, M,
                                            Q, S);
    return (int)cudaGetLastError();
  });
}
