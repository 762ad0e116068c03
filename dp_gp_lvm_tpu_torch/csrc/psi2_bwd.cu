// K2: fused analytic Psi2 pullback over the DP atom stack, f32.
//
// Replaces dp_gp_lvm_tpu/ops/pallas/psi.py:_psi2_bwd_batched_kernel
// (wrapper psi2_bwd_batched_pallas); the derivation is in
// dp_gp_lvm_tpu/kernels/ard_rbf_vjp.py. Per atom t and row n, with
//   expo_ml = ln_n - (le_ml + quad_ml) / 4,   E = exp(min(expo, 0)),
//   W_ml = var_t^2 w_n E_ml 1[expo_ml < 0] G_ml,
// it returns, per atom (summed over rows):
//   gvar_m (T,M)  = sum_n w_n sum_l E G      (unmasked)
//   gard   (T,Q), gz (T,M,Q)   without the E0 pull, V (T,M,M) = sum_n W
// and, per row (summed over atoms): gmu, gs (N,Q) and gw (N,)
//   gw_n = sum_t var_t^2 <E_tn, G_t>       (unmasked, unweighted).
// The n-independent E0 pulls are finished outside from V, in plain torch,
// as the JAX package does.
//
// Bound on the H100: FP32 operations. Per (atom, row) the M x M tile costs
// M^2 exponentials, ~2Q FLOPs each for the exponent and ~Q more for the
// (W + W^T) Z contraction; the bytes are the inputs and outputs once. What
// the design does about it:
//   * Atoms are on the grid, (chunks, T): block (c, t) loads G_t, Z_t and
//     alpha_t once into shared memory and builds le_ml = sum_q alpha_q
//     (z_mq - z_lq)^2 there, then walks its chunk of rows.
//   * The exponent is symmetric bit for bit: quad_ml = sum_q (c_mq +
//     c_lq)^2 with c_lq = sqrt(b_q) (mu_q - z_lq) staged per row, and
//     le_ml is built from +-(z_m - z_l). So E_ml and E_lm are the same
//     bits, and W_ml + W_lm = var^2 w_n (E o mask)_ml (G_ml + G_lm): the
//     thread that owns row m of the tile has it without reading any other
//     thread's W, and V = G o S with S = var^2 sum_n w_n (E o mask).
//   * Thread (m, j) owns row m of the tile and a slice of LC columns: its
//     S entries live in registers across rows, and per row it sums p_m,
//     the row sum of W + W^T and its Z contraction. It walks RN = 2 rows
//     at once (1 where Q > QF), so each load of z_l, le_ml and G serves
//     two exponents. The 3Q+2 per-row scalars that cross threads (A, U_q,
//     rz_q, rz2_q, the gw term) are summed by a recursive-halving warp
//     shuffle (31 shuffles for 32 values) and one shared-memory stage per
//     batch of B rows: two block barriers per B rows, none per row.
//   * LC = 16 columns at M <= 64 (256 threads, 2 blocks and 16 warps per
//     SM at ~125 registers), 32 at M <= 128 (512 threads, one block).
//   * Q <= QF = 10 (every configuration) runs in one pass with a row's
//     Q-vectors in registers. A larger Q runs one generic instantiation:
//     the exponent sums its Q terms from shared memory, and the block walks
//     its rows once per QC = 8 columns of the gradients, holding only those
//     in registers. Shared memory bounds Q (at M = 128, Q <= 40).
//   * G_t and le hold the whole M x M tile, so M <= MAX_M. Past that, or
//     past the Q that bound allows, the tiled form at the end of this file
//     (entry psi2_bwd_tiled_f32) gives each block 32 rows of the tile and
//     walks the columns in panels, so its shared memory does not grow with
//     M: the same pair loop, the row scalars' shares summed over the
//     panels in the block and over the ranges by its own second kernel.
//   * Partials: per (chunk, atom) [gvar_m | gard | gz | S], per (atom, row)
//     [gmu | gs | gw]. A second kernel sums the chunks (PARTS contiguous
//     chunk ranges per element, then the ranges in order), forms V = G o S,
//     and sums the atoms of each row in atom order. No atomics: the same
//     bits on every run.
//   * The exponent is taken in its direct form (the expanded form cancels
//     in f32), all products in full f32 on the CUDA cores, no tensor cores.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_M = 128;
constexpr int PARTS = 8;            // chunk ranges per element, second pass
constexpr int FIN_THREADS = 32 * PARTS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int QF = 10;              // largest Q of the one-pass kernels
constexpr int QC = 8;               // gradient columns per pass, Q > QF

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int round32(int x) { return (x + 31) & ~31; }

// rows between two block barriers: the row stage must fit beside the tiles
// at M = 128
template <bool CH>
__host__ __device__ constexpr int batch_rows() {
  return CH ? 2 : 8;
}

// rows of the chunk a thread walks at once: two share each load of the
// tiles; one where Q > QF keeps the passes within 128 registers
template <bool CH>
__host__ __device__ constexpr int rows_at_once() {
  return CH ? 1 : 2;
}

struct Dims {
  int T, N, M, Q, rows_per_chunk;
};

// shared-memory layout of the main kernel, offsets in floats (16-byte
// aligned): Q-vector stride QP, tile row stride MP, row-info stride RI,
// tile-row slices L, warps NW
struct Layout {
  int QP, MP, RI, L, NW;
  int g, le, z, al, c, ri, st, ga, cb, total;
};

// QT: gradient columns a pass holds in registers; CH: Q > QT, in passes
template <int QT, int LC, bool CH>
__host__ __device__ Layout layout(int M, int Q) {
  constexpr int B = batch_rows<CH>();
  // per-row scalars padded to whole warps
  constexpr int NV = round32(3 * QT + 2);
  Layout s;
  // Q-vectors padded to float4s, and to whole passes where CH
  s.QP = CH ? QT * ((Q + QT - 1) / QT) : round4(QT);
  s.MP = M | 1;  // odd: row and column reads of a tile are conflict-free
  s.RI = round4(5 * s.QP + 2);
  s.L = (M + LC - 1) / LC;
  s.NW = round32(M * s.L) / 32;
  s.g = 0;
  s.le = s.g + round4(M * s.MP);
  s.z = s.le + round4(M * s.MP);
  s.al = s.z + M * s.QP;
  s.c = s.al + s.QP;
  s.ri = s.c + B * M * s.QP;
  s.st = s.ri + 3 * B * s.RI;
  s.ga = s.st + B * s.NW * NV;
  s.total = s.ga + round4(B * QT);
  // the slices' [gvar | gz] partials of a pass: from le on in one pass,
  // after everything where later passes read the tiles again
  const int comb = s.L * M * (QT + 1);
  s.cb = CH ? s.total : s.le;
  if (s.cb + comb > s.total) s.total = s.cb + comb;
  return s;
}

// v[o + i] += v[o + i + W] of the partner lane (lane ^ W), for i < W, after
// the halves were swapped on lanes with bit W set: one step of a
// recursive-halving sum, the same order on every run
template <int W, int NV>
__device__ __forceinline__ void halve(float (&v)[NV], int o, bool up) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = up ? v[o + i] : v[o + i + W];
    const float keep = up ? v[o + i + W] : v[o + i];
    v[o + i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// dst[k] = sum over the warp of v[k] for k < NV (a multiple of 32): lane i
// writes dst[32 h + i]; 31 shuffles per 32 values
template <int NV>
__device__ __forceinline__ void warp_scatter_sum(float (&v)[NV], int lane,
                                                 float* dst) {
#pragma unroll
  for (int o = 0; o < NV; o += 32) {
    halve<16>(v, o, lane & 16);
    halve<8>(v, o, lane & 8);
    halve<4>(v, o, lane & 4);
    halve<2>(v, o, lane & 2);
    halve<1>(v, o, lane & 1);
    dst[o + lane] = v[o];
  }
}

// dst = src[0, QS) from 16-byte-aligned shared memory, into registers
template <int QS>
__device__ __forceinline__ void load_vec(const float* src, float (&dst)[QS]) {
#pragma unroll
  for (int q = 0; q < QS; q += 4) {
    const float4 x = *reinterpret_cast<const float4*>(src + q);
    dst[q] = x.x;
    dst[q + 1] = x.y;
    dst[q + 2] = x.z;
    dst[q + 3] = x.w;
  }
}

// sum_q (a_q + b_q)^2 over [0, QP), QP a multiple of 4, in q order
__device__ __forceinline__ float quad_sum(const float* a, const float* b,
                                          int QP) {
  float quad = 0.f;
  for (int q = 0; q < QP; q += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + q);
    const float4 y = *reinterpret_cast<const float4*>(b + q);
    const float t0 = x.x + y.x, t1 = x.y + y.y;
    const float t2 = x.z + y.z, t3 = x.w + y.w;
    quad = fmaf(t0, t0, quad);
    quad = fmaf(t1, t1, quad);
    quad = fmaf(t2, t2, quad);
    quad = fmaf(t3, t3, quad);
  }
  return quad;
}

// 256-thread blocks, two per SM (~125 registers); 512-thread blocks, one
template <int QT, int LC, bool CH>
__global__ void __launch_bounds__(LC == 16 ? 256 : 512, LC == 16 ? 2 : 1)
psi2_bwd_kernel(const float* __restrict__ var, const float* __restrict__ ard,
                const float* __restrict__ mu, const float* __restrict__ s,
                const float* __restrict__ w, const float* __restrict__ z,
                const float* __restrict__ g, float* __restrict__ part,
                float* __restrict__ rowpart, Dims d) {
  constexpr int B = batch_rows<CH>(), RN = rows_at_once<CH>();
  extern __shared__ __align__(16) float sm[];
  const int T = d.T, N = d.N, M = d.M, Q = d.Q;
  const Layout lay = layout<QT, LC, CH>(M, Q);
  const int QP = lay.QP, MP = lay.MP, RI = lay.RI, NW = lay.NW;
  constexpr int QS = round4(QT), NV = round32(3 * QT + 2);
  float* g_sh = sm + lay.g;    // [M][MP] G_t; S of the block at the end
  float* le_sh = sm + lay.le;  // [M][MP] sum_q alpha (z_m - z_l)^2
  float* z_sh = sm + lay.z;    // [M][QP] z_t, zero-padded
  float* al_sh = sm + lay.al;  // [QP] alpha_t, zero-padded
  float* c_sh = sm + lay.c;    // [B][M][QP] c of the batch's rows
  float* ri_sh = sm + lay.ri;  // [3][B][RI] b | sqrt b | mu | s | u | ln | w
  float* st_sh = sm + lay.st;  // [B][NW][NV] per-warp sums of row scalars
  float* ga_sh = sm + lay.ga;  // [B][QT] gard terms of the last batch

  const int chunk = blockIdx.x, t = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int row0 = chunk * d.rows_per_chunk;
  const int nrows = min(d.rows_per_chunk, N - row0);
  const int nbatch = (nrows + B - 1) / B;
  const float v = var[t], v2 = v * v;

  for (int i = tid; i < M * M; i += nthreads)
    g_sh[(i / M) * MP + i % M] = g[(long long)t * M * M + i];
  for (int i = tid; i < M * QP; i += nthreads) {
    const int l = i / QP, q = i % QP;
    z_sh[i] = q < Q ? z[((long long)t * M + l) * Q + q] : 0.f;
  }
  for (int q = tid; q < QP; q += nthreads)
    al_sh[q] = q < Q ? ard[(long long)t * Q + q] : 0.f;
  __syncthreads();

  for (int i = tid; i < M * M; i += nthreads) {
    const int m = i / M, l = i % M;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < (CH ? Q : QT); ++q) {
      const float df = z_sh[m * QP + q] - z_sh[l * QP + q];
      acc = fmaf(al_sh[q] * df, df, acc);
    }
    le_sh[m * MP + l] = acc;
  }

  // row info of batch k into ri_sh[k % 3]
  auto prep_rows = [&](int k) {
    const int r0 = k * B, nb = min(B, nrows - r0);
    float* ri = ri_sh + (k % 3) * B * RI;
    for (int i = tid; i < nb * QP; i += nthreads) {
      const int b = i / QP, q = i % QP;
      const long long n = row0 + r0 + b;
      const float a = al_sh[q];
      const float sv = q < Q ? s[n * Q + q] : 0.f;
      const float u = fmaf(2.f * a, sv, 1.f);
      const float bq = a / u;
      float* r = ri + b * RI;
      r[q] = bq;
      r[QP + q] = sqrtf(bq);
      r[2 * QP + q] = q < Q ? mu[n * Q + q] : 0.f;
      r[3 * QP + q] = sv;
      r[4 * QP + q] = u;
    }
    for (int b = tid; b < nb; b += nthreads) {
      const long long n = row0 + r0 + b;
      float ln = 0.f;
      for (int q = 0; q < Q; ++q)
        ln -= 0.5f * logf(fmaf(2.f * al_sh[q], s[n * Q + q], 1.f));
      ri[b * RI + 5 * QP] = ln * LOG2E;
      ri[b * RI + 5 * QP + 1] = w[n];
    }
  };

  const bool active = tid < M * lay.L;
  const int m = active ? tid % M : 0;
  const int l0 = active ? (tid / M) * LC : 0;
  const int lc = active ? min(LC, M - l0) : 0;
  const long long P = (long long)T * (M + Q + M * Q + M * M);
  float* pc = part + chunk * P;
  float S[LC];
#pragma unroll
  for (int k = 0; k < LC; ++k) S[k] = 0.f;

  // one pass per QT gradient columns [q0, q0 + qn) where CH, else one;
  // S, gvar and gw in the first
  for (int q0 = 0; q0 < (CH ? Q : 1); q0 += QT) {
    const bool first = !CH || q0 == 0;
    const int qn = CH ? min(QT, Q - q0) : Q;
    float gz[QT];
#pragma unroll
    for (int q = 0; q < QT; ++q) gz[q] = 0.f;
    float gvacc = 0.f, gard_acc = 0.f;
    if (nbatch > 0) prep_rows(0);
    __syncthreads();

    for (int bt = 0; bt <= nbatch; ++bt) {
      // (1) the last batch's row scalars -> its rows' gmu, gs, gw and gard
      if (bt > 0) {
        const int pr0 = (bt - 1) * B, pnb = min(B, nrows - pr0);
        const int per = qn + (first ? 1 : 0);
        const float* ri = ri_sh + ((bt - 1) % 3) * B * RI;
        for (int i = tid; i < pnb * per; i += nthreads) {
          const int b = i / per, q = i % per;
          const float* st = st_sh + b * NW * NV;
          const float* r = ri + b * RI;
          float* rp =
              rowpart + ((long long)t * N + row0 + pr0 + b) * (2 * Q + 1);
          if (q == qn) {
            float ps = 0.f;
            for (int wi = 0; wi < NW; ++wi) ps += st[wi * NV + 3 * QT + 1];
            rp[2 * Q] = v2 * ps;
            continue;
          }
          float A = 0.f, rz = 0.f, rz2 = 0.f, U = 0.f;
          for (int wi = 0; wi < NW; ++wi) {
            const float* sw = st + wi * NV;
            A += sw[0];
            rz += sw[1 + q];
            rz2 += sw[1 + QT + q];
            U += sw[1 + 2 * QT + q];
          }
          const float f = v2 * r[5 * QP + 1];
          A *= 0.5f * f;
          rz *= f;
          rz2 *= f;
          U *= 0.5f * f;
          const int qq = q0 + q;
          const float bq = r[qq], mq = r[2 * QP + qq];
          const float sq = r[3 * QP + qq], uq = r[4 * QP + qq];
          const float gb = -mq * mq * A + mq * rz - 0.25f * rz2 - 0.5f * U;
          rp[qq] = bq * (-2.f * mq * A + rz);
          rp[Q + qq] = gb * (-2.f * bq * bq) - A * bq;
          ga_sh[b * QT + q] = gb / (uq * uq) - A * sq / uq;
        }
      }
      // (2) stage c of batch bt, row info of batch bt + 1
      if (bt < nbatch) {
        const int nb = min(B, nrows - bt * B);
        const float* ri = ri_sh + (bt % 3) * B * RI;
        for (int i = tid; i < nb * M; i += nthreads) {
          const int b = i / M, l = i - b * M;
          const float* r = ri + b * RI;
#pragma unroll
          for (int q = 0; q < (CH ? QP : QS); ++q)
            c_sh[i * QP + q] = r[QP + q] * (r[2 * QP + q] - z_sh[l * QP + q]);
        }
        if (bt + 1 < nbatch) prep_rows(bt + 1);
      }
      __syncthreads();
      if (bt > 0 && tid < qn) {
        const int pnb = min(B, nrows - (bt - 1) * B);
        for (int b = 0; b < pnb; ++b) gard_acc += ga_sh[b * QT + tid];
      }
      if (bt == nbatch) break;

      // (3) the rows of batch bt; no block barrier between them
      const int nb = min(B, nrows - bt * B);
      const float* ri = ri_sh + (bt % 3) * B * RI;
      for (int b = 0; b < nb; b += RN) {
        // RN rows at once share the loads of z_l, le and G; a missing last
        // row repeats the one before it at weight 0 and is not written
        const float* cr[RN];
        const float* rr[RN];
        float ln2[RN], wn[RN], cm[RN][QS];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int bj = min(b + j, nb - 1);
          cr[j] = c_sh + bj * M * QP;
          rr[j] = ri + bj * RI;
          ln2[j] = rr[j][5 * QP];
          wn[j] = b + j < nb ? rr[j][5 * QP + 1] : 0.f;
          if (!CH) load_vec(cr[j] + m * QP, cm[j]);
        }
        float p[RN], rsum[RN], wsz[RN][QT];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          p[j] = rsum[j] = 0.f;
#pragma unroll
          for (int q = 0; q < QT; ++q) wsz[j][q] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < LC; ++k) {
          if (k < lc) {
            const int l = l0 + k;
            float zl[QS];
            load_vec(z_sh + l * QP + q0, zl);
            const float le = le_sh[m * MP + l];
            const float g1 = g_sh[m * MP + l];
            const float gsum = g1 + g_sh[l * MP + m];
#pragma unroll
            for (int j = 0; j < RN; ++j) {
              float quad = 0.f;
              if (CH) {
                quad = quad_sum(cr[j] + m * QP, cr[j] + l * QP, QP);
              } else {
                float cl[QS];
                load_vec(cr[j] + l * QP, cl);
#pragma unroll
                for (int q = 0; q < QT; ++q) {
                  const float tq = cm[j][q] + cl[q];
                  quad = fmaf(tq, tq, quad);
                }
              }
              const float ex = fmaf(-0.25f * LOG2E, le + quad, ln2[j]);
              const float e = exp2f(fminf(ex, 0.f));
              p[j] = fmaf(e, g1, p[j]);
              const float em = ex < 0.f ? e : 0.f;
              if (first) S[k] = fmaf(wn[j], em, S[k]);
              const float ws = em * gsum;
              rsum[j] += ws;
#pragma unroll
              for (int q = 0; q < QT; ++q)
                wsz[j][q] = fmaf(ws, zl[q], wsz[j][q]);
            }
          }
        }
        // this thread's share of each row: gvar, gz and the row scalars
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          if (b + j >= nb) break;
          const float* r = rr[j];
          const float f = v2 * wn[j];
          if (first) gvacc = fmaf(wn[j], p[j], gvacc);
          float vals[NV];
          vals[0] = rsum[j];
#pragma unroll
          for (int q = 0; q < QT; ++q) {
            const int qq = q0 + q;
            const float zq = z_sh[m * QP + qq];
            gz[q] = fmaf(f * r[qq], rsum[j] * (r[2 * QP + qq] - 0.5f * zq) -
                                        0.5f * wsz[j][q], gz[q]);
            vals[1 + q] = rsum[j] * zq;
            vals[1 + QT + q] = rsum[j] * zq * zq;
            vals[1 + 2 * QT + q] = wsz[j][q] * zq;
          }
          vals[3 * QT + 1] = p[j];
#pragma unroll
          for (int k = 3 * QT + 2; k < NV; ++k) vals[k] = 0.f;
          warp_scatter_sum<NV>(vals, lane, st_sh + ((b + j) * NW + warp) * NV);
        }
      }
      __syncthreads();
    }

    // slices -> block partials of the pass, [gvar | gz] summed in slice
    // order, once every thread has read its last gard terms
    __syncthreads();
    float* comb = sm + lay.cb;
    if (active) {
      float* cp = comb + (tid / M * M + m) * (QT + 1);
      cp[0] = gvacc;
#pragma unroll
      for (int q = 0; q < QT; ++q) cp[1 + q] = gz[q];
    }
    __syncthreads();
    for (int i = tid; i < M * (qn + 1); i += nthreads) {
      const int mm = i / (qn + 1), k = i % (qn + 1);
      if (k == 0 && !first) continue;
      float a = 0.f;
      for (int j = 0; j < lay.L; ++j) a += comb[(j * M + mm) * (QT + 1) + k];
      if (k == 0)
        pc[(long long)t * M + mm] = a;
      else
        pc[(long long)T * (M + Q) + ((long long)t * M + mm) * Q + q0 + k - 1] =
            a;
    }
    if (tid < qn) pc[(long long)T * M + t * Q + q0 + tid] = gard_acc;
  }

  // S into g_sh: every read of G is done
  if (active) {
#pragma unroll
    for (int k = 0; k < LC; ++k)
      if (k < lc) g_sh[m * MP + l0 + k] = S[k];
  }
  __syncthreads();
  float* pS = pc + (long long)T * (M + Q + M * Q) + (long long)t * M * M;
  for (int i = tid; i < M * M; i += nthreads)
    pS[i] = g_sh[(i / M) * MP + i % M];
}

struct Outputs {
  float *gvar_m, *gard, *gz, *V, *gmu, *gs, *gw;
};

// blocks [0, atom_blocks): element e of [gvar_m | gard | gz | S] summed over
// the chunks, V = var^2 G o S; the rest: row i of [gmu | gs | gw] summed
// over the atoms in atom order
__global__ void __launch_bounds__(FIN_THREADS)
finish_kernel(const float* __restrict__ part,
              const float* __restrict__ rowpart, const float* __restrict__ var,
              const float* __restrict__ g, Outputs o, Dims d, int chunks,
              int atom_blocks) {
  const int T = d.T, N = d.N, M = d.M, Q = d.Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if ((int)blockIdx.x < atom_blocks) {
    __shared__ float red[PARTS][32];
    const long long off1 = (long long)T * M, off2 = off1 + (long long)T * Q;
    const long long off3 = off2 + (long long)T * M * Q;
    const long long P = off3 + (long long)T * M * M;
    const long long e = (long long)blockIdx.x * 32 + lane;
    const int per = (chunks + PARTS - 1) / PARTS;
    const int c0 = warp * per, c1 = min(chunks, c0 + per);
    float a = 0.f;
    if (e < P)
      for (int c = c0; c < c1; ++c) a += part[c * P + e];
    red[warp][lane] = a;
    __syncthreads();
    if (warp != 0 || e >= P) return;
    float tot = 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) tot += red[p][lane];
    if (e < off1) {
      o.gvar_m[e] = tot;
    } else if (e < off2) {
      o.gard[e - off1] = tot;
    } else if (e < off3) {
      o.gz[e - off2] = tot;
    } else {
      const long long r = e - off3;
      const float vt = var[r / ((long long)M * M)];
      o.V[r] = vt * vt * g[r] * tot;
    }
    return;
  }
  const int R = 2 * Q + 1;
  const long long i =
      (long long)(blockIdx.x - atom_blocks) * FIN_THREADS + tid;
  if (i >= (long long)N * R) return;
  float a = 0.f;
  for (int t = 0; t < T; ++t) a += rowpart[(long long)t * N * R + i];
  const long long n = i / R;
  const int k = (int)(i % R);
  if (k < Q)
    o.gmu[n * Q + k] = a;
  else if (k < 2 * Q)
    o.gs[n * Q + k - Q] = a;
  else
    o.gw[n] = a;
}

// one instantiation of the main kernel
template <int QT_, int LC_, bool CH_>
struct Variant {
  static constexpr int QT = QT_, LC = LC_;
  static constexpr bool CH = CH_;
};

// f(Variant) for the instantiation that serves Q in slices of lc columns:
// one pass at Q <= QF (lc 16 or 32), passes of QC columns beyond (lc 32)
template <class F>
int dispatch(int Q, int lc, F&& f) {
  if (Q < 1 || (lc != 16 && lc != 32) || (Q > QF && lc != 32))
    return -(int)cudaErrorInvalidValue;
  if (Q > QF) return f(Variant<QC, 32, true>{});
  return lc == 16 ? f(Variant<QF, 16, false>{}) : f(Variant<QF, 32, false>{});
}

template <class V>
size_t smem_bytes(int M, int Q) {
  return (size_t)layout<V::QT, V::LC, V::CH>(M, Q).total * sizeof(float);
}

// ---------------------------------------------------------------------------
// The tiled form: M past one block's tile (MAX_M), or a Q whose single-tile
// block fits no SM. Block (chunk, atom, range a) owns the TR rows m of range
// a, a lane each, and walks the columns in panels of P (a multiple of TLC):
// shared memory holds only the panel's G_ml, G_ml + G_lm and le_ml of its
// rows, z of its rows and of the panel's columns, and c of the batch's rows
// against the panel's columns (against its rows too where Q > QF), so none
// of it grows with M. Its 256 threads are (row, slice j of the panel's L =
// P / TLC slices of TLC columns, row slot rs of RS = 8 / L): slot rs walks
// rows rs, rs + RS, ... of each batch of B, so the RS threads of a pair
// share the panel's tiles and each holds its own share of S in registers.
// Thread (m, j, rs) forms W_ml + W_lm from its own exponent; the pair loop
// is the single-tile kernel's, with c_m built in registers.
//   * Panels outer, rows inner. When a panel ends, S is summed over the row
//     slots in slot order and written. Each thread's share of gvar_m and gz
//     stays in its own slots of shared memory across the panels (registers
//     hold S). Every row scalar (gmu, gs, gw, gard) is linear in the pair
//     sums: a panel adds its share to the range's [gmu | gs | gw] of the row
//     in panel order (the first panel writes it) and its gard terms to one
//     sum. No atomics, and no other block touches any of them.
//   * cp.async: while a batch computes, the old [gmu | gs | gw] of its rows
//     and the mu, s and w of the batch after next arrive, so no read of
//     device memory waits between two block barriers. A panel's tiles of G
//     and z are read once, when it starts (four times a block at M = 256).
//   * The exponent is K1's, raised by ex2.approx.ftz as K1 does: E_ml is the
//     forward pass's bits.
//   * Q <= QF: P = 64, B = 16 rows between two block barriers, four a
//     thread, two at once; 110 KB of shared memory, two 256-thread blocks
//     (16 warps) an SM at 128 registers. Q > QF: passes of QC gradient
//     columns (each walks the panels again), B = 4, one block an SM.
//   * Grid (chunks, T, ranges); ops/psi.py::k2_tiled_geometry chooses the
//     chunks for whole waves. finish_tiled sums the chunks in chunk order
//     and the ranges in range order.

constexpr int TR = 32;                 // rows of a tiled range: a lane each
constexpr int TLC = 32;                // columns of a tiled thread's slice
constexpr int TILED_THREADS = 256;
constexpr int TILED_WARPS = TILED_THREADS / 32;
// the panel width: the widest multiple of TLC at which two blocks fit an
// SM at Q <= QF (at 128 one does; at 32 two do, and ran slower on an H100
// at M = 256)
constexpr int TILED_PANEL = 64;

// rows between two block barriers
template <bool CH>
__host__ __device__ constexpr int tiled_batch_rows() {
  return CH ? 4 : 16;
}

// rows of a batch a thread walks at once, sharing each load of the tiles
template <bool CH>
__host__ __device__ constexpr int tiled_rows_at_once() {
  return CH ? 1 : 2;
}

struct TiledDims {
  int T, N, M, Q, A, rows_per_chunk;
};

// shared-memory layout of the tiled kernel, offsets in floats (16-byte
// aligned): Q-vector stride QP, row-info stride RI, a row's [gmu | gs |
// gw] (and its mu | s | w) RW
struct TiledLayout {
  int QP, RI, RW;
  int g, gs, le, zr, zp, al, u, gz, ri, st, ga, rb, raw, total;
};

// at Q <= QF every offset but the last two is a constant
template <int QT, bool CH>
__host__ __device__ TiledLayout tiled_layout(int Q) {
  constexpr int B = tiled_batch_rows<CH>(), P = TILED_PANEL;
  constexpr int NV = round32(3 * QT + 2);
  constexpr int L = P / TLC, RS = TILED_WARPS / L;
  constexpr int PP = P | 1;  // odd: a warp's reads down a column are
                             // conflict-free
  constexpr int tile = round4(TR * PP);
  TiledLayout s;
  s.QP = CH ? QT * ((Q + QT - 1) / QT) : round4(QT);
  s.RI = round4(5 * s.QP + 2);
  s.RW = 2 * Q + 1;
  s.g = 0;                             // [TR][PP] G_ml of the panel
  s.gs = s.g + tile;                   // [TR][PP] G_ml + G_lm
  s.le = s.gs + tile;                  // [TR][PP] sum_q alpha (z_m - z_l)^2
  s.zr = s.le + tile;                  // [TR][QP] z of the range's rows
  s.zp = s.zr + TR * s.QP;             // [P][QP] z of the panel's columns
  s.al = s.zp + P * s.QP;              // [QP] alpha_t
  // c of the batch, [B][(TR +) P][QP]; when a panel ends the row slots'
  // shares of S, [RS - 1][TR][PP]
  s.u = s.al + s.QP;
  int un = B * (CH ? TR + P : P) * s.QP;
  if ((RS - 1) * TR * PP > un) un = (RS - 1) * TR * PP;
  s.gz = s.u + round4(un);         // [QT + 1][threads] each thread's gvar, gz
  s.ri = s.gz + (QT + 1) * TILED_THREADS;  // [3][B][RI] b|sqrt b|mu|s|u|ln|w
  s.st = s.ri + 3 * B * s.RI;      // [B][L][NV] warp sums of the row scalars
  s.ga = s.st + B * L * NV;        // [B][QT] gard terms of the last batch
  s.rb = s.ga + round4(B * QT);    // [B][RW] old [gmu | gs | gw] of a batch
  s.raw = s.rb + round4(B * s.RW);  // [B Q | B Q | B] mu, s, w of a batch
  s.total = s.raw + round4(B * s.RW);
  return s;
}

// *dst = *src by cp.async (4 bytes, through no register); complete after
// cp_async_wait_all
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^x as K1's exponent takes it (ex2.approx.ftz: exp2f but for a result
// below 2^-126, which flushes to 0), so E is the forward pass's bits
__device__ __forceinline__ float tiled_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// mu, s and w of rows [n0, n0 + nb) into raw [B Q | B Q | B] by cp.async
template <int B>
__device__ __forceinline__ void tiled_fetch_rows(float* raw, const float* mu,
                                                 const float* s,
                                                 const float* w, long long n0,
                                                 int nb, int Q) {
  for (int i = threadIdx.x; i < nb * Q; i += TILED_THREADS) {
    cp_async4(raw + i, mu + n0 * Q + i);
    cp_async4(raw + B * Q + i, s + n0 * Q + i);
  }
  for (int b = threadIdx.x; b < nb; b += TILED_THREADS)
    cp_async4(raw + 2 * B * Q + b, w + n0 + b);
}

// row info [b | sqrt b | mu | s | u | ln | w] (stride RI) of the nb rows in
// raw into ri, as the single-tile kernel's prep_rows
template <int B>
__device__ __forceinline__ void tiled_prep_rows(float* ri, const float* raw,
                                                const float* al, int nb,
                                                int Q, int QP, int RI) {
  const float* rmu = raw;
  const float* rsv = raw + B * Q;
  for (int i = threadIdx.x; i < nb * QP; i += TILED_THREADS) {
    const int b = i / QP, q = i % QP;
    const float a = al[q];
    const float sv = q < Q ? rsv[b * Q + q] : 0.f;
    const float u = fmaf(2.f * a, sv, 1.f);
    const float bq = a / u;
    float* r = ri + b * RI;
    r[q] = bq;
    r[QP + q] = sqrtf(bq);
    r[2 * QP + q] = q < Q ? rmu[b * Q + q] : 0.f;
    r[3 * QP + q] = sv;
    r[4 * QP + q] = u;
  }
  for (int b = threadIdx.x; b < nb; b += TILED_THREADS) {
    float ln = 0.f;
    for (int q = 0; q < Q; ++q)
      ln -= 0.5f * logf(fmaf(2.f * al[q], rsv[b * Q + q], 1.f));
    ri[b * RI + 5 * QP] = ln * LOG2E;
    ri[b * RI + 5 * QP + 1] = raw[2 * B * Q + b];
  }
}

template <int QT, bool CH>
__global__ void __launch_bounds__(TILED_THREADS, 2)
psi2_bwd_tiled_kernel(const float* __restrict__ var,
                      const float* __restrict__ ard,
                      const float* __restrict__ mu,
                      const float* __restrict__ s,
                      const float* __restrict__ w,
                      const float* __restrict__ z,
                      const float* __restrict__ g, float* __restrict__ part,
                      float* __restrict__ rowpart, TiledDims d) {
  constexpr int B = tiled_batch_rows<CH>(), RN = tiled_rows_at_once<CH>();
  constexpr int LC = TLC, NT = TILED_THREADS;
  constexpr int QS = round4(QT), NV = round32(3 * QT + 2);
  extern __shared__ __align__(16) float sm[];
  constexpr int P = TILED_PANEL, L = P / TLC, RS = TILED_WARPS / L;
  constexpr int PP = P | 1;
  constexpr int CW = CH ? TR + P : P;
  const int T = d.T, N = d.N, M = d.M, Q = d.Q, A = d.A;
  const TiledLayout lay = tiled_layout<QT, CH>(Q);
  const int QP = lay.QP, RI = lay.RI, RW = lay.RW;
  float* g_sh = sm + lay.g;
  float* gs_sh = sm + lay.gs;
  float* le_sh = sm + lay.le;
  float* zr_sh = sm + lay.zr;
  float* zp_sh = sm + lay.zp;
  float* al_sh = sm + lay.al;
  float* u_sh = sm + lay.u;
  float* ri_sh = sm + lay.ri;
  float* st_sh = sm + lay.st;
  float* ga_sh = sm + lay.ga;
  float* rb_sh = sm + lay.rb;
  float* raw_sh = sm + lay.raw;

  const int chunk = blockIdx.x, t = blockIdx.y, a = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = warp % L, rs = warp / L;  // slice of the panel, row slot
  float* gz_sh = sm + lay.gz + tid;  // [QT + 1][NT] this thread's gvar, gz
  const int row0 = chunk * d.rows_per_chunk;
  const int nrows = min(d.rows_per_chunk, N - row0);
  const int nbatch = (nrows + B - 1) / B;
  const int mr0 = a * TR, mr = min(TR, M - mr0);  // the range's rows
  const int panels = (M + P - 1) / P;
  // thread (ml, j, rs): row mr0 + ml of the tile, columns [l0, l0 + lc) of
  // each panel; a lane past a ragged last range owns no column and adds
  // zeros to the warp sums
  const int ml = lane, m = mr0 + ml, l0 = j * LC;
  const bool owns = ml < mr;
  const long long gq = (long long)A * T * Q;
  const long long PC = (long long)T * M + gq + (long long)T * M * Q +
                       (long long)T * M * M;
  const long long off_gz = (long long)T * M + gq;
  const long long off_S = off_gz + (long long)T * M * Q;
  float* pc = part + chunk * PC;
  // the range's [gmu | gs | gw] of this chunk's rows
  float* rows_out =
      rowpart + (((long long)a * T + t) * N + row0) * (long long)RW;

  for (int i = tid; i < TR * QP; i += NT) {
    const int r = i / QP, q = i % QP;
    zr_sh[i] = r < mr && q < Q ? z[((long long)t * M + mr0 + r) * Q + q] : 0.f;
  }
  for (int q = tid; q < QP; q += NT)
    al_sh[q] = q < Q ? ard[(long long)t * Q + q] : 0.f;
  const float v2 = var[t] * var[t];
  const float* g_t = g + (long long)t * M * M;

  float S[LC];
#pragma unroll
  for (int k = 0; k < LC; ++k) S[k] = 0.f;

  // one pass per QT gradient columns [q0, q0 + qn) where CH, else one;
  // S, gvar and gw in the first
  for (int q0 = 0; q0 < (CH ? Q : 1); q0 += QT) {
    const bool first = !CH || q0 == 0;
    const int qn = CH ? min(QT, Q - q0) : Q;
    float gard_acc = 0.f;

    for (int p = 0; p < panels; ++p) {
      const int lc = owns ? max(0, min(LC, M - p * P - l0)) : 0;
      __syncthreads();
      if (p == 0) {  // no thread reads another's sums before the pass ends
#pragma unroll
        for (int q = 0; q <= QT; ++q) gz_sh[q * NT] = 0.f;
      }
      // the panel's tiles of G, z of its columns, le
      for (int i = tid; i < TR * P; i += NT) {
        const int r = i / P, c = i % P, l = p * P + c;
        const bool in = r < mr && l < M;
        const float g1 = in ? g_t[(long long)(mr0 + r) * M + l] : 0.f;
        g_sh[r * PP + c] = g1;
        gs_sh[r * PP + c] =
            g1 + (in ? g_t[(long long)l * M + mr0 + r] : 0.f);
      }
      for (int i = tid; i < P * QP; i += NT) {
        const int c = i / QP, q = i % QP, l = p * P + c;
        zp_sh[i] = l < M && q < Q ? z[((long long)t * M + l) * Q + q] : 0.f;
      }
      tiled_fetch_rows<B>(raw_sh, mu, s, w, row0, min(B, nrows), Q);
      cp_async_wait_all();
      __syncthreads();
      for (int i = tid; i < TR * P; i += NT) {
        const int r = i / P, c = i % P;
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < (CH ? Q : QT); ++q) {
          const float df = zr_sh[r * QP + q] - zp_sh[c * QP + q];
          acc = fmaf(al_sh[q] * df, df, acc);
        }
        le_sh[r * PP + c] = acc;
      }
      tiled_prep_rows<B>(ri_sh, raw_sh, al_sh, min(B, nrows), Q, QP, RI);
      if (nbatch > 1) {
        __syncthreads();
        tiled_fetch_rows<B>(raw_sh, mu, s, w, row0 + B, min(B, nrows - B),
                            Q);
        cp_async_wait_all();
      }
      __syncthreads();

      for (int bt = 0; bt <= nbatch; ++bt) {
        // (1) the last batch's row scalars -> the panel's share of its rows'
        // gmu, gs, gw (added to the earlier panels') and gard
        if (bt > 0) {
          const int pr0 = (bt - 1) * B, pnb = min(B, nrows - pr0);
          const int per = qn + (first ? 1 : 0);
          const float* ri = ri_sh + ((bt - 1) % 3) * B * RI;
          for (int i = tid; i < pnb * per; i += NT) {
            const int b = i / per, q = i % per;
            const float* st = st_sh + b * L * NV;
            const float* r = ri + b * RI;
            const float* old = rb_sh + b * RW;
            float* rp = rows_out + (long long)(pr0 + b) * RW;
            if (q == qn) {
              float ps = 0.f;
              for (int jj = 0; jj < L; ++jj) ps += st[jj * NV + 3 * QT + 1];
              rp[2 * Q] = (p > 0 ? old[2 * Q] : 0.f) + v2 * ps;
              continue;
            }
            float Asum = 0.f, rz = 0.f, rz2 = 0.f, U = 0.f;
            for (int jj = 0; jj < L; ++jj) {
              const float* sw = st + jj * NV;
              Asum += sw[0];
              rz += sw[1 + q];
              rz2 += sw[1 + QT + q];
              U += sw[1 + 2 * QT + q];
            }
            const float f = v2 * r[5 * QP + 1];
            Asum *= 0.5f * f;
            rz *= f;
            rz2 *= f;
            U *= 0.5f * f;
            const int qq = q0 + q;
            const float bq = r[qq], mq = r[2 * QP + qq];
            const float sq = r[3 * QP + qq], uq = r[4 * QP + qq];
            const float gb =
                -mq * mq * Asum + mq * rz - 0.25f * rz2 - 0.5f * U;
            rp[qq] = (p > 0 ? old[qq] : 0.f) + bq * (-2.f * mq * Asum + rz);
            rp[Q + qq] = (p > 0 ? old[Q + qq] : 0.f) +
                         (gb * (-2.f * bq * bq) - Asum * bq);
            ga_sh[b * QT + q] = gb / (uq * uq) - Asum * sq / uq;
          }
        }
        // (2) stage c of batch bt, row info of batch bt + 1
        if (bt < nbatch) {
          const int nb = min(B, nrows - bt * B);
          const float* ri = ri_sh + (bt % 3) * B * RI;
          for (int i = tid; i < nb * CW; i += NT) {
            const int b = i / CW, x = i - b * CW;
            const float* r = ri + b * RI;
            const float* zx = CH && x < TR ? zr_sh + x * QP
                                           : zp_sh + (x - (CH ? TR : 0)) * QP;
#pragma unroll
            for (int q = 0; q < (CH ? QP : QS); ++q)
              u_sh[i * QP + q] = r[QP + q] * (r[2 * QP + q] - zx[q]);
          }
          if (bt + 1 < nbatch)
            tiled_prep_rows<B>(ri_sh + ((bt + 1) % 3) * B * RI, raw_sh, al_sh,
                               min(B, nrows - (bt + 1) * B), Q, QP, RI);
        }
        __syncthreads();
        if (bt > 0 && tid < qn) {
          const int pnb = min(B, nrows - (bt - 1) * B);
          for (int b = 0; b < pnb; ++b) gard_acc += ga_sh[b * QT + tid];
        }
        if (bt == nbatch) break;

        // (3) while the batch computes: its rows' old [gmu | gs | gw] and
        // the row inputs of batch bt + 2
        const int nb = min(B, nrows - bt * B);
        if (p > 0)
          for (int i = tid; i < nb * RW; i += NT)
            cp_async4(rb_sh + i, rows_out + (long long)bt * B * RW + i);
        if (bt + 2 < nbatch)
          tiled_fetch_rows<B>(raw_sh, mu, s, w, row0 + (bt + 2) * B,
                              min(B, nrows - (bt + 2) * B), Q);

        // (4) the slot's rows of batch bt, RN at once; no block barrier
        // between them
        const float* ri = ri_sh + (bt % 3) * B * RI;
#pragma unroll 1
        for (int i0 = 0; i0 < B / RS; i0 += RN) {
          if (rs + RS * i0 >= nb) break;
          // a missing row repeats the step's first at weight 0 and is not
          // written
          const float* cr[RN];
          const float* rr[RN];
          float ln2[RN], wn[RN], cm[RN][QS];
#pragma unroll
          for (int jj = 0; jj < RN; ++jj) {
            const int b = rs + RS * (i0 + jj);
            const int bs = b < nb ? b : rs + RS * i0;
            cr[jj] = u_sh + bs * CW * QP;
            rr[jj] = ri + bs * RI;
            ln2[jj] = rr[jj][5 * QP];
            wn[jj] = b < nb ? rr[jj][5 * QP + 1] : 0.f;
            if (!CH) {
              float sb[QS], mb[QS], zm[QS];
              load_vec(rr[jj] + QP, sb);
              load_vec(rr[jj] + 2 * QP, mb);
              load_vec(zr_sh + ml * QP, zm);
#pragma unroll
              for (int q = 0; q < QS; ++q) cm[jj][q] = sb[q] * (mb[q] - zm[q]);
            }
          }
          float pr[RN], rsum[RN], wsz[RN][QT];
#pragma unroll
          for (int jj = 0; jj < RN; ++jj) {
            pr[jj] = rsum[jj] = 0.f;
#pragma unroll
            for (int q = 0; q < QT; ++q) wsz[jj][q] = 0.f;
          }
#pragma unroll
          for (int k = 0; k < LC; ++k) {
            if (k < lc) {
              const int lp = l0 + k;
              float zl[QS];
              load_vec(zp_sh + lp * QP + q0, zl);
              const float le = le_sh[ml * PP + lp];
              const float g1 = g_sh[ml * PP + lp];
              const float gsum = gs_sh[ml * PP + lp];
#pragma unroll
              for (int jj = 0; jj < RN; ++jj) {
                float quad = 0.f;
                if (CH) {
                  quad = quad_sum(cr[jj] + ml * QP, cr[jj] + (TR + lp) * QP,
                                  QP);
                } else {
                  float cl[QS];
                  load_vec(cr[jj] + lp * QP, cl);
#pragma unroll
                  for (int q = 0; q < QT; ++q) {
                    const float tq = cm[jj][q] + cl[q];
                    quad = fmaf(tq, tq, quad);
                  }
                }
                const float ex = fmaf(-0.25f * LOG2E, le + quad, ln2[jj]);
                const float e = tiled_exp2(fminf(ex, 0.f));
                pr[jj] = fmaf(e, g1, pr[jj]);
                const float em = ex < 0.f ? e : 0.f;
                if (first) S[k] = fmaf(wn[jj], em, S[k]);
                const float ws = em * gsum;
                rsum[jj] += ws;
#pragma unroll
                for (int q = 0; q < QT; ++q)
                  wsz[jj][q] = fmaf(ws, zl[q], wsz[jj][q]);
              }
            }
          }
          // this thread's share of each row: gvar, gz and the row scalars
#pragma unroll
          for (int jj = 0; jj < RN; ++jj) {
            const int b = rs + RS * (i0 + jj);
            if (b >= nb) break;
            const float* r = rr[jj];
            const float f = v2 * wn[jj];
            if (first) gz_sh[0] = fmaf(wn[jj], pr[jj], gz_sh[0]);
            float vals[NV], zrow[QS];
            load_vec(zr_sh + ml * QP + q0, zrow);
            vals[0] = rsum[jj];
#pragma unroll
            for (int q = 0; q < QT; ++q) {
              const int qq = q0 + q;
              const float zq = zrow[q];
              gz_sh[(1 + q) * NT] =
                  fmaf(f * r[qq], rsum[jj] * (r[2 * QP + qq] - 0.5f * zq) -
                                      0.5f * wsz[jj][q], gz_sh[(1 + q) * NT]);
              vals[1 + q] = rsum[jj] * zq;
              vals[1 + QT + q] = rsum[jj] * zq * zq;
              vals[1 + 2 * QT + q] = wsz[jj][q] * zq;
            }
            vals[3 * QT + 1] = pr[jj];
#pragma unroll
            for (int k = 3 * QT + 2; k < NV; ++k) vals[k] = 0.f;
            warp_scatter_sum<NV>(vals, lane, st_sh + (b * L + j) * NV);
          }
        }
        cp_async_wait_all();
        __syncthreads();
      }

      // the panel's S, summed over the row slots in slot order
      if (first) {
        if (rs > 0) {
#pragma unroll
          for (int k = 0; k < LC; ++k)
            if (k < lc) u_sh[((rs - 1) * TR + ml) * PP + l0 + k] = S[k];
        }
        __syncthreads();
        if (rs == 0) {
          float* pS = pc + off_S + ((long long)t * M + m) * M + p * P + l0;
#pragma unroll
          for (int k = 0; k < LC; ++k) {
            if (k < lc) {
              float acc = S[k];
              for (int r = 1; r < RS; ++r)
                acc += u_sh[((r - 1) * TR + ml) * PP + l0 + k];
              pS[k] = acc;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < LC; ++k) S[k] = 0.f;
      }
    }

    // threads -> the range's [gvar | gz] of the pass, in (slot, slice) order
    __syncthreads();
    for (int i = tid; i < mr * (qn + 1); i += NT) {
      const int mm = i / (qn + 1), k = i % (qn + 1);
      if (k == 0 && !first) continue;
      const float* gk = sm + lay.gz + k * NT + mm;
      float acc = 0.f;
      for (int x = 0; x < TILED_WARPS; ++x) acc += gk[x * TR];
      if (k == 0)
        pc[(long long)t * M + mr0 + mm] = acc;
      else
        pc[off_gz + ((long long)t * M + mr0 + mm) * Q + q0 + k - 1] = acc;
    }
    if (tid < qn)
      pc[(long long)T * M + ((long long)a * T + t) * Q + q0 + tid] = gard_acc;
  }
}

// blocks [0, atom_blocks): output element e of [gvar_m | gard | gz | V]
// summed over the chunks (gard also over the ranges, range order inside
// each chunk), V = var^2 G o S; the rest: row i of [gmu | gs | gw] summed
// over the atoms and ranges, atom by atom in range order
__global__ void __launch_bounds__(FIN_THREADS)
finish_tiled_kernel(const float* __restrict__ part,
                    const float* __restrict__ rowpart,
                    const float* __restrict__ var,
                    const float* __restrict__ g, Outputs o, TiledDims d,
                    int chunks, int atom_blocks) {
  const int T = d.T, N = d.N, M = d.M, Q = d.Q, A = d.A;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if ((int)blockIdx.x < atom_blocks) {
    __shared__ float red[PARTS][32];
    const long long off1 = (long long)T * M, off2 = off1 + (long long)T * Q;
    const long long off3 = off2 + (long long)T * M * Q;
    const long long O = off3 + (long long)T * M * M;
    const long long gq = (long long)A * T * Q;
    const long long P = O - (long long)T * Q + gq;  // partials a chunk
    const long long e = (long long)blockIdx.x * 32 + lane;
    const int per = (chunks + PARTS - 1) / PARTS;
    const int c0 = warp * per, c1 = min(chunks, c0 + per);
    float acc = 0.f;
    if (e < off1 || (e >= off2 && e < O)) {
      const long long pe = e < off1 ? e : e - (long long)T * Q + gq;
      for (int c = c0; c < c1; ++c) acc += part[c * P + pe];
    } else if (e < off2) {
      for (int c = c0; c < c1; ++c)
        for (int ra = 0; ra < A; ++ra)
          acc += part[c * P + off1 + ra * (long long)T * Q + (e - off1)];
    }
    red[warp][lane] = acc;
    __syncthreads();
    if (warp != 0 || e >= O) return;
    float tot = 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) tot += red[p][lane];
    if (e < off1) {
      o.gvar_m[e] = tot;
    } else if (e < off2) {
      o.gard[e - off1] = tot;
    } else if (e < off3) {
      o.gz[e - off2] = tot;
    } else {
      const long long r = e - off3;
      const float vt = var[r / ((long long)M * M)];
      o.V[r] = vt * vt * g[r] * tot;
    }
    return;
  }
  const int R2 = 2 * Q + 1;
  const long long i =
      (long long)(blockIdx.x - atom_blocks) * FIN_THREADS + tid;
  if (i >= (long long)N * R2) return;
  float acc = 0.f;
  for (int t = 0; t < T; ++t)
    for (int ra = 0; ra < A; ++ra)
      acc += rowpart[((long long)ra * T + t) * N * R2 + i];
  const long long n = i / R2;
  const int k = (int)(i % R2);
  if (k < Q)
    o.gmu[n * Q + k] = acc;
  else if (k < 2 * Q)
    o.gs[n * Q + k - Q] = acc;
  else
    o.gw[n] = acc;
}

// f(Variant) for the tiled instantiation that serves Q: one pass at
// Q <= QF, passes of QC columns beyond
template <class F>
int tiled_dispatch(int Q, F&& f) {
  if (Q > QF) return f(Variant<QC, TLC, true>{});
  return f(Variant<QF, TLC, false>{});
}

template <class V>
size_t tiled_smem_bytes(int Q) {
  return (size_t)tiled_layout<V::QT, V::CH>(Q).total * sizeof(float);
}

// the tiled kernel's shared memory (all of the SM's at two blocks) and
// carveout, or a CUDA error
template <class V>
cudaError_t tiled_attributes(size_t smem) {
  const auto kernel = psi2_bwd_tiled_kernel<V::QT, V::CH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

// threads of a block, or 0 where they exceed the kernel's launch bounds
template <class V>
int block_threads(int M, int Q) {
  const int threads = layout<V::QT, V::LC, V::CH>(M, Q).NW * 32;
  return threads <= (V::LC == 16 ? 256 : 512) ? threads : 0;
}

}  // namespace

// blocks of the main kernel that fit on one SM at (M, Q, lc), 0 where its
// shared memory exceeds a block's, or minus a CUDA error
extern "C" int psi2_bwd_blocks_per_sm(int M, int Q, int lc) {
  if (M < 1 || M > MAX_M) return -(int)cudaErrorInvalidValue;
  int max_smem = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -(int)e;
  return dispatch(Q, lc, [&](auto variant) {
    using V = decltype(variant);
    const auto kernel = psi2_bwd_kernel<V::QT, V::LC, V::CH>;
    const size_t smem = smem_bytes<V>(M, Q);
    const int threads = block_threads<V>(M, Q);
    if (threads == 0) return -(int)cudaErrorInvalidValue;
    if (smem > (size_t)max_smem) return 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return -(int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
    return err == cudaSuccess ? blocks : -(int)err;
  });
}

// part: chunks x T (M + Q + MQ + M^2) floats; rowpart: T x N x (2Q + 1)
extern "C" int psi2_bwd_f32(const float* var, const float* ard,
                            const float* mu, const float* s, const float* w,
                            const float* z, const float* g, float* part,
                            float* rowpart, float* gvar_m, float* gard,
                            float* gz, float* V, float* gmu, float* gs,
                            float* gw, int T, int N, int M, int Q, int lc,
                            int rows_per_chunk, int chunks,
                            cudaStream_t stream) {
  if (M < 1 || M > MAX_M || T < 1 || N < 1 || chunks < 1 ||
      (long long)rows_per_chunk * chunks < N)
    return (int)cudaErrorInvalidValue;
  Dims d;
  d.T = T; d.N = N; d.M = M; d.Q = Q; d.rows_per_chunk = rows_per_chunk;
  const int err = dispatch(Q, lc, [&](auto variant) {
    using Var = decltype(variant);
    const auto kernel = psi2_bwd_kernel<Var::QT, Var::LC, Var::CH>;
    const size_t smem = smem_bytes<Var>(M, Q);
    const int threads = block_threads<Var>(M, Q);
    if (threads == 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(chunks, T), threads, smem, stream>>>(
        var, ard, mu, s, w, z, g, part, rowpart, d);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err < 0 ? -err : err;

  Outputs o;
  o.gvar_m = gvar_m; o.gard = gard; o.gz = gz; o.V = V;
  o.gmu = gmu; o.gs = gs; o.gw = gw;
  const long long P = (long long)T * (M + Q + M * Q + M * M);
  const long long atom_blocks = (P + 31) / 32;
  const long long row_blocks =
      ((long long)N * (2 * Q + 1) + FIN_THREADS - 1) / FIN_THREADS;
  finish_kernel<<<(unsigned)(atom_blocks + row_blocks), FIN_THREADS, 0,
                  stream>>>(part, rowpart, var, g, o, d, chunks,
                            (int)atom_blocks);
  return (int)cudaGetLastError();
}

// blocks of the tiled kernel that fit on one SM at Q (its shared memory
// does not depend on M), 0 where none fits, or minus a CUDA error
extern "C" int psi2_bwd_tiled_blocks_per_sm(int Q) {
  if (Q < 1) return -(int)cudaErrorInvalidValue;
  int max_smem = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -(int)e;
  return tiled_dispatch(Q, [&](auto variant) {
    using V = decltype(variant);
    const size_t smem = tiled_smem_bytes<V>(Q);
    if (smem > (size_t)max_smem) return 0;
    cudaError_t err = tiled_attributes<V>(smem);
    if (err != cudaSuccess) return -(int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, psi2_bwd_tiled_kernel<V::QT, V::CH>, TILED_THREADS, smem);
    return err == cudaSuccess ? blocks : -(int)err;
  });
}

// the tiled instantiation that serves Q and what the loaded module says of
// it: out = [QT, CH, registers a thread, local memory bytes a thread (the
// stack frame, spills included)]; returns a CUDA error
extern "C" int psi2_bwd_tiled_attributes(int Q, int* out) {
  if (Q < 1) return (int)cudaErrorInvalidValue;
  return tiled_dispatch(Q, [&](auto variant) {
    using V = decltype(variant);
    cudaFuncAttributes a;
    const cudaError_t e =
        cudaFuncGetAttributes(&a, psi2_bwd_tiled_kernel<V::QT, V::CH>);
    if (e != cudaSuccess) return (int)e;
    out[0] = V::QT;
    out[1] = V::CH;
    out[2] = a.numRegs;
    out[3] = (int)a.localSizeBytes;
    return 0;
  });
}

// K2 in the tiled form, panels of TILED_PANEL columns. part: chunks x (T M + A T Q
// + T M Q + T M^2) floats; rowpart: A x T x N x (2Q + 1), A = ceil(M / TR)
extern "C" int psi2_bwd_tiled_f32(const float* var, const float* ard,
                                  const float* mu, const float* s,
                                  const float* w, const float* z,
                                  const float* g, float* part,
                                  float* rowpart, float* gvar_m, float* gard,
                                  float* gz, float* V, float* gmu, float* gs,
                                  float* gw, int T, int N, int M, int Q,
                                  int rows_per_chunk, int chunks,
                                  cudaStream_t stream) {
  const int A = M >= 1 ? (M + TR - 1) / TR : 0;
  if (M < 1 || A > 65535 || T < 1 || T > 65535 || N < 1 || chunks < 1 ||
      (long long)rows_per_chunk * chunks < N || Q < 1)
    return (int)cudaErrorInvalidValue;
  TiledDims d;
  d.T = T; d.N = N; d.M = M; d.Q = Q; d.A = A;
  d.rows_per_chunk = rows_per_chunk;
  const int err = tiled_dispatch(Q, [&](auto variant) {
    using Var = decltype(variant);
    const size_t smem = tiled_smem_bytes<Var>(Q);
    cudaError_t e = tiled_attributes<Var>(smem);
    if (e != cudaSuccess) return (int)e;
    psi2_bwd_tiled_kernel<Var::QT, Var::CH>
        <<<dim3(chunks, T, A), TILED_THREADS, smem, stream>>>(
            var, ard, mu, s, w, z, g, part, rowpart, d);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;

  Outputs o;
  o.gvar_m = gvar_m; o.gard = gard; o.gz = gz; o.V = V;
  o.gmu = gmu; o.gs = gs; o.gw = gw;
  const long long O = (long long)T * (M + Q + M * Q + (long long)M * M);
  const long long atom_blocks = (O + 31) / 32;
  const long long row_blocks =
      ((long long)N * (2 * Q + 1) + FIN_THREADS - 1) / FIN_THREADS;
  finish_tiled_kernel<<<(unsigned)(atom_blocks + row_blocks), FIN_THREADS, 0,
                        stream>>>(part, rowpart, var, g, o, d, chunks,
                                  (int)atom_blocks);
  return (int)cudaGetLastError();
}
