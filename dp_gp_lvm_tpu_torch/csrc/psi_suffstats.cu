// K1, K4 and K5: the Psi2 forward of the ARD-RBF kernel, f32, one kernel
// body with two entry points. For every atom t
//
//   Psi2_t   = var_t^2 sum_n w_n exp(min(expo_tnml, 0))          (M, M)
//   P1Y_t    = sum_n var_t w_n exp(min(e1_tnm, 0)) y_n^T          (M, D)
//
//   psi_suffstats_f32 (K1) replaces
//     dp_gp_lvm_tpu/ops/pallas/psi.py:_suffstats_batched_kernel (wrapper
//     suffstats_batched_pallas): both, in one pass over the rows; the
//     (T, N, M) Psi1 tensor never reaches device memory;
//   psi2_batched_f32 (K4) replaces _psi2_batched_kernel (wrapper
//     psi2_batched_pallas): the Psi2 stack alone; at T = 1 it is K5, which
//     replaces _psi2_kernel (wrapper psi2_pallas): one kernel's Psi2.
//
// K4 and K5 run the body with P1Y = false (D = 0 on the host), which
// compiles out the Y rows, the scaled Psi1 rows, the Psi1^T Y tiles and
// their half of the partials and of the chunk reduction.
//
// Bound on the H100: FP32 issue and shared-memory bandwidth, not bytes.
// The inputs are a few hundred KB; per (atom, row) the upper triangle of
// Psi2 costs M(M+1)/2 exponentials of a Q-term quadratic form (c4
// widths: 42.6 M pairs in all), the Psi1^T Y contraction M*D FMAs. What
// the design does about it:
//   * The pair exponent is K2's (csrc/psi2_bwd.cu), bit for bit:
//       expo * log2(e) = ln_n log2(e) - log2(e)/4 (le_ml + quad_ml),
//       le_ml = sum_q alpha_q (z_mq - z_lq)^2   (n-independent, registers)
//       quad_ml = sum_q (c_mq + c_lq)^2,  c_lq = sqrt(b_q) (mu_q - z_lq),
//     a sum of non-positive terms with no cancellation (the reference's
//     expanded quadratic form cancels in f32), clamped at 0 and raised
//     by ex2.approx.ftz (K2 takes exp2f; the two differ only where
//     exp2f returns a subnormal, below 2^-126). With c staged per row the
//     inner loop issues one FADD and one FFMA per pair and q, and two
//     16-byte shared loads per 16 pairs and q; those loads keep shared
//     memory about as busy as the FP32 pipes.
//   * Psi2 is symmetric: a thread owns one 4x4 tile of the upper
//     triangle and keeps its 16 sums in registers; the partials hold only
//     those tiles and the chunk reduction mirrors them.
//   * A block is G groups of NT = T4 (T4 + 1) / 2 tile owners (T4 =
//     ceil(M / 4)), each group walking its own rows of every stage with
//     its own accumulators; G is chosen from the kernel's occupancy so
//     that whole warps do useful work (ops/psi.py::k1_geometry). The
//     groups' tiles are summed in shared memory, in group order, at the
//     end of the block.
//   * Rows are staged RS = G x rows-per-group at a time, in a pipeline
//     with one block barrier per stage: a stage's row scalars are
//     prepared two stages ahead (a lane per (row, q), two rows a warp at
//     Q <= 16, the row's log sums then taken in q order), its c and Psi1
//     rows (scaled by var w_n) built one (row, m) per thread one stage
//     ahead, beside the Psi2 and Psi1^T Y work of the stage before it.
//   * Psi1^T Y (P1Y only): each thread owns a 4 (m) x 4 (d) tile of the
//     (M, D) accumulator in registers across the whole row loop (one
//     16-byte load of Psi1 and one of Y feed 16 FMAs) and writes it once.
//     A D too wide for one tile per thread walks the rows again per pass.
//   * Q = 10 at M4 = 64 or 128 (every configuration's widths; for Psi2
//     alone also 52, c2's M = 50) runs an instantiation with both fixed,
//     so shared-memory offsets are immediates and the q loops unroll;
//     other shapes run the generic one.
//   * The TPU grid accumulated into one output block in grid order. CUDA
//     blocks run concurrently, so each block (N-chunk c, atom t) writes
//     its partial sums to part[c] and a second kernel sums the chunks in
//     a fixed order: no atomics, the same bits on every run. No tensor
//     cores and no TF32: every product is full f32.
//   * A block holds the whole M x M triangle, so M <= MAX_M (a thread a
//     4x4 tile: 528 at M = 128, 2080 at 256). Past that, or where a Q
//     leaves no block that fits an SM, the tiled form at the end of this
//     file (entries *_tiled_f32) puts the pairs of super-tiles of TP x TP
//     on the grid, the same pair work a block, with the same pair
//     exponent and row pipeline, and K1's Psi1^T Y in a kernel of its own;
//     the TPU kernel sized its row block to VMEM instead
//     (ops/pallas/psi.py:583-607).
#include <cuda_runtime.h>

namespace {

constexpr int MAX_M = 128;
constexpr int MAX_THREADS = 576;  // launch bounds (96 registers, says ptxas)
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

struct Dims {
  int T, N, M, Q, D, G, RS, rows_per_chunk;
};

// shared-memory layout, offsets in floats (16-byte aligned); D = 0 is the
// Psi2-only body, without Y and Psi1 rows
struct Layout {
  int T4, M4, D4, NT, RI, threads;
  int z, al, ri, y, c, p1, total;
};

__host__ __device__ Layout layout(int M, int Q, int D, int G, int RS) {
  Layout s;
  s.T4 = (M + 3) / 4;
  s.M4 = 4 * s.T4;
  s.D4 = round4(D);
  s.NT = s.T4 * (s.T4 + 1) / 2;
  // per q (sqrt b, mu, a1, -) | log u1 | log u2 | w, l1 log2(e), ln log2(e)
  s.RI = round4(6 * Q + 3);
  s.threads = ((G * s.NT + 31) / 32) * 32;
  s.z = 0;                   // [Q][M4] z_t transposed, zero-padded
  s.al = s.z + Q * s.M4;     // [Q] alpha_t
  s.ri = s.al + round4(Q);   // [3][RS][RI] row scalars, three stages
  s.y = s.ri + 3 * RS * s.RI;          // [3][RS][D4] Y rows, three stages
  s.c = s.y + 3 * RS * s.D4;           // [2][RS][Q][M4] c, two stages
  s.p1 = s.c + 2 * RS * Q * s.M4;      // [2][RS][M4] var w Psi1, two stages
  s.total = s.p1 + (D > 0 ? 2 * RS * s.M4 : 0);
  // the groups' tiles, summed at the end over the same memory
  const int red = (G - 1) * 16 * s.NT;
  if (red > s.total) s.total = red;
  return s;
}

__device__ __forceinline__ void upper_tile(int k, int t4, int& tm, int& tl) {
  int row = 0;
  while (k >= t4 - row) {
    k -= t4 - row;
    ++row;
  }
  tm = row;
  tl = row + k;
}

// 2^x; results below 2^-126 flush to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void unpack(const float4 v, float (&a)[4]) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// QC, MC: Q and M4 fixed at compile time (the widths every configuration
// runs), so that shared-memory offsets are immediates and the q loops
// unroll; 0 takes them from d. P1Y: Psi1^T Y beside Psi2 (K1), else Psi2
// alone (K4, K5; d.D = 0)
template <int QC, int MC, bool P1Y>
__global__ void __launch_bounds__(MAX_THREADS)
suffstats_kernel(const float* __restrict__ var, const float* __restrict__ ard,
                 const float* __restrict__ mu, const float* __restrict__ s,
                 const float* __restrict__ w, const float* __restrict__ z,
                 const float* __restrict__ y, float* __restrict__ part,
                 Dims d) {
  extern __shared__ __align__(16) float sm[];
  const int T = d.T, M = d.M, Q = QC ? QC : d.Q, D = d.D, G = d.G;
  const int RS = d.RS;
  const Layout lay = layout(M, Q, D, G, RS);
  const int M4 = MC ? MC : lay.M4, D4 = lay.D4, NT = lay.NT, RI = lay.RI;
  float* z_sh = sm + lay.z;
  float* al_sh = sm + lay.al;
  float* c_sh = sm + lay.c;
  float* p1_sh = sm + lay.p1;

  const int chunk = blockIdx.x, t = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int row0 = chunk * d.rows_per_chunk;
  const int nrows = min(d.rows_per_chunk, d.N - row0);
  const int nstage = (nrows + RS - 1) / RS;
  const float v = var[t];

  // Row scalars and Y rows of stage st into buffer st % 3. A row takes a
  // segment of SEG lanes, a lane per q; the segment's first lane then
  // sums the row's logs in q order (as K2 takes ln).
  const int SEG = Q <= 16 ? 16 : 32, lane_q = lane % SEG;
  const int row_slots = nwarps * (32 / SEG);
  const int ydr = P1Y ? nthreads / D4 : 0;  // steps of nthreads
  const int ydd = P1Y ? nthreads % D4 : 0;
  const int bdr = nthreads / M4, bdm = nthreads % M4;
  const int my_row = warp * (32 / SEG) + lane / SEG;
  auto prep = [&](int st) {
    const int r0 = st * RS, nb = min(RS, nrows - r0);
    float* ri = sm + lay.ri + (st % 3) * RS * RI;
    float* ys = sm + lay.y + (st % 3) * RS * D4;
    for (int rb = 0; rb < nb; rb += row_slots) {  // uniform across a warp
      const int r = rb + my_row;
      const long long n = row0 + r0 + r;
      float* rr = ri + r * RI;
      const float wn = r < nb && lane_q == 0 && w ? w[n] : 1.f;
      if (r < nb) {
        for (int q = lane_q; q < Q; q += SEG) {
          const float a = ard[(long long)t * Q + q];
          const float sv = s[n * Q + q];
          const float u2 = fmaf(2.f * a, sv, 1.f);
          rr[4 * q] = sqrtf(a / u2);
          rr[4 * q + 1] = mu[n * Q + q];
          if constexpr (P1Y) {
            const float u1 = fmaf(a, sv, 1.f);
            rr[4 * q + 2] = a / u1;
            rr[4 * Q + q] = logf(u1);
          }
          rr[5 * Q + q] = logf(u2);
        }
      }
      __syncwarp();
      if (r < nb && lane_q == 0) {
        float l1 = 0.f, ln = 0.f;
#pragma unroll 4
        for (int q = 0; q < Q; ++q) {
          if constexpr (P1Y) l1 -= 0.5f * rr[4 * Q + q];
          ln -= 0.5f * rr[5 * Q + q];
        }
        rr[6 * Q] = wn;
        if constexpr (P1Y) rr[6 * Q + 1] = l1 * LOG2E;
        rr[6 * Q + 2] = ln * LOG2E;
      }
    }
    if constexpr (P1Y) {
      // four loads in flight per thread; (row, column) of element i0 + k
      // nthreads stepped without dividing
      int yr = tid / D4, yd = tid % D4;
      for (int i0 = tid; i0 < nb * D4; i0 += 4 * nthreads) {
        float yv[4];
        int r = yr, dd = yd;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          yv[k] = r < nb && dd < D
                      ? y[(long long)(row0 + r0 + r) * D + dd] : 0.f;
          r += ydr;
          dd += ydd;
          if (dd >= D4) {
            dd -= D4;
            ++r;
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (i0 + k * nthreads < nb * D4) ys[i0 + k * nthreads] = yv[k];
        yr = r;
        yd = dd;
      }
    }
  };

  // c and (P1Y) the Psi1 rows of stage st into buffer st % 2, from its
  // row scalars; one (row, m) per thread, stepped without dividing
  auto build = [&](int st) {
    const int nb = min(RS, nrows - st * RS);
    const float* ri = sm + lay.ri + (st % 3) * RS * RI;
    float* cb = c_sh + (st % 2) * RS * Q * M4;
    float* pb = p1_sh + (st % 2) * RS * M4;
    for (int r = tid / M4, m = tid % M4; r < nb;) {
      const float* rr = ri + r * RI;
      float* cr = cb + r * Q * M4 + m;
      float quad1 = 0.f;
#pragma unroll 4
      for (int q = 0; q < Q; ++q) {
        const float4 v4 = *reinterpret_cast<const float4*>(rr + 4 * q);
        const float df = v4.y - z_sh[q * M4 + m];
        cr[q * M4] = v4.x * df;
        if constexpr (P1Y) quad1 = fmaf(v4.z * df, df, quad1);
      }
      if constexpr (P1Y) {
        const float e1 = fmaf(-0.5f * LOG2E, quad1, rr[6 * Q + 1]);
        pb[r * M4 + m] =
            m < M ? v * rr[6 * Q] * exp2_ftz(fminf(e1, 0.f)) : 0.f;
      }
      r += bdr;
      m += bdm;
      if (m >= M4) {
        m -= M4;
        ++r;
      }
    }
  };

  for (int i = tid; i < Q * M4; i += nthreads) {
    const int q = i / M4, m = i % M4;
    z_sh[i] = m < M ? z[((long long)t * M + m) * Q + q] : 0.f;
  }
  for (int q = tid; q < Q; q += nthreads) al_sh[q] = ard[(long long)t * Q + q];
  if (nstage > 0) prep(0);  // the first pass's first two stages
  if (nstage > 1) prep(1);
  __syncthreads();

  // this thread's Psi2 tile: group g, upper-triangle tile k
  const int g = tid / NT, k = tid % NT;
  const bool has_tile = g < G;
  int m0 = 0, l0 = 0;
  if (has_tile) {
    int tm, tl;
    upper_tile(k, lay.T4, tm, tl);
    m0 = 4 * tm;
    l0 = 4 * tl;
  }
  float le[4][4], acc[4][4];
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
      float zm[4], zl[4];
      unpack(*reinterpret_cast<const float4*>(z_sh + q * M4 + m0), zm);
      unpack(*reinterpret_cast<const float4*>(z_sh + q * M4 + l0), zl);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float df = zm[i] - zl[j];
          le[i][j] = fmaf(a * df, df, le[i][j]);
        }
    }
  }

  // Psi1^T Y passes: this thread's 4 x 4 tile of pass p is tile
  // tid + p * nthreads of the (M4 / 4) x (D4 / 4) grid; Psi2 alone takes
  // one walk of the rows
  const int dt4 = D4 / 4, np1 = lay.T4 * dt4;
  const long long PB = 16LL * NT + round4(M * D);
  float* pc = part + ((long long)chunk * T + t) * PB;
  for (int pass = 0; P1Y ? pass * nthreads < np1 : pass < 1; ++pass) {
    const int pt = tid + pass * nthreads;
    const bool has_p1 = P1Y && pt < np1;
    const int pm0 = has_p1 ? 4 * (pt / dt4) : 0;
    const int pd0 = has_p1 ? 4 * (pt % dt4) : 0;
    const bool psi2_pass = pass == 0 && has_tile;
    float py[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) py[i][j] = 0.f;

    // stage st is prepared two stages ahead and built one ahead, beside
    // the rows of the stage before it: one block barrier per stage
    if (pass > 0) {
      if (nstage > 0) prep(0);
      if (nstage > 1) prep(1);
      __syncthreads();
    }
    if (nstage > 0) build(0);
    __syncthreads();
    for (int st = 0; st < nstage; ++st) {
      if (st + 1 < nstage) build(st + 1);
      if (st + 2 < nstage) prep(st + 2);
      const int nb = min(RS, nrows - st * RS);
      const float* ri = sm + lay.ri + (st % 3) * RS * RI;
      const float* ys = sm + lay.y + (st % 3) * RS * D4;
      const float* cb = c_sh + (st % 2) * RS * Q * M4;
      const float* pb = p1_sh + (st % 2) * RS * M4;

      // the group's rows of the stage into the Psi2 tile, every row into
      // the Psi1^T Y tile
      if (psi2_pass) {
        for (int r = g; r < nb; r += G) {
          const float* pm = cb + r * Q * M4 + m0;
          const float* pl = cb + r * Q * M4 + l0;
          float quad[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) quad[i][j] = 0.f;
#pragma unroll (QC ? QC : 2)
          for (int q = 0; q < Q; ++q, pm += M4, pl += M4) {
            float cm[4], cl[4];
            unpack(*reinterpret_cast<const float4*>(pm), cm);
            unpack(*reinterpret_cast<const float4*>(pl), cl);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float tq = cm[i] + cl[j];
                quad[i][j] = fmaf(tq, tq, quad[i][j]);
              }
          }
          const float ln2 = ri[r * RI + 6 * Q + 2], wr = ri[r * RI + 6 * Q];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float ex = fmaf(-0.25f * LOG2E, le[i][j] + quad[i][j], ln2);
              acc[i][j] = fmaf(wr, exp2_ftz(fminf(ex, 0.f)), acc[i][j]);
            }
        }
      }
      if (has_p1) {
#pragma unroll 4
        for (int r = 0; r < nb; ++r) {
          float pv[4], yv[4];
          unpack(*reinterpret_cast<const float4*>(pb + r * M4 + pm0), pv);
          unpack(*reinterpret_cast<const float4*>(ys + r * D4 + pd0), yv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) py[i][j] = fmaf(pv[i], yv[j], py[i][j]);
        }
      }
      __syncthreads();  // stage st's buffers free, st + 1 built
    }
    if (has_p1) {
      float* p1y = pc + 16LL * NT;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = pm0 + i, dd = pd0 + j;
          if (m < M && dd < D) p1y[(long long)m * D + dd] = py[i][j];
        }
    }
  }

  // the groups' tiles summed in group order; group 0 writes the partial
  float* red = sm;
  if (has_tile && g > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[((g - 1) * 16 + 4 * i + j) * NT + k] = acc[i][j];
  }
  __syncthreads();
  if (has_tile && g == 0) {
    const float v2 = v * v;
    float4* p2 = reinterpret_cast<float4*>(pc + 16LL * k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = acc[i][j];
        for (int gg = 1; gg < G; ++gg)
          a += red[((gg - 1) * 16 + 4 * i + j) * NT + k];
        o[j] = v2 * a;
      }
      p2[i] = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// psi2 and (P1Y) p1y = the chunks' partials summed in chunk order; each
// stored upper-triangle tile entry is written to (m, l) and mirrored to
// (l, m)
template <bool P1Y>
__global__ void reduce_chunks(const float* __restrict__ part, int chunks,
                              Dims d, float* __restrict__ psi2,
                              float* __restrict__ p1y) {
  const int M = d.M, D = d.D;
  const int T4 = (M + 3) / 4, NT = T4 * (T4 + 1) / 2;
  const long long PB = 16LL * NT + round4(M * D);
  const long long P = (long long)d.T * PB;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P) return;
  float a = 0.f;
  // deeper for K4 and K5, which sum up to ~130 chunks (K5 at N = 8192)
#pragma unroll (P1Y ? 4 : 16)
  for (int c = 0; c < chunks; ++c) a += part[c * P + e];
  const int t = (int)(e / PB);
  const long long r = e % PB;
  if constexpr (P1Y) {
    if (r >= 16LL * NT) {
      if (r - 16LL * NT < (long long)M * D)
        p1y[(long long)t * M * D + (r - 16LL * NT)] = a;
      return;
    }
  }
  int tm, tl;
  upper_tile((int)(r / 16), T4, tm, tl);
  const int m = 4 * tm + (int)(r % 16) / 4, l = 4 * tl + (int)(r % 4);
  if (m >= M || l >= M) return;
  float* o = psi2 + (long long)t * M * M;
  o[(long long)m * M + l] = a;
  o[(long long)l * M + m] = a;
}

// f(kernel) for the instantiation that serves (Q, M); Psi2 alone also
// fixes c2_sparse_oil's M4 = 52 (its step and server launch K5 there)
template <bool P1Y, class F>
int with_width(int M, int Q, F&& f) {
  const int M4 = 4 * ((M + 3) / 4);
  if (Q == 10 && M4 == 64) return f(suffstats_kernel<10, 64, P1Y>);
  if (Q == 10 && M4 == 128) return f(suffstats_kernel<10, 128, P1Y>);
  if constexpr (!P1Y) {
    if (Q == 10 && M4 == 52) return f(suffstats_kernel<10, 52, false>);
  }
  return f(suffstats_kernel<0, 0, P1Y>);
}

// ... and for (Q, M, D): D = 0 is the Psi2-only body
template <class F>
int with_kernel(int M, int Q, int D, F&& f) {
  return D > 0 ? with_width<true>(M, Q, f) : with_width<false>(M, Q, f);
}

bool valid(int M, int Q, int D, int G, int RS) {
  return M >= 1 && M <= MAX_M && Q >= 1 && D >= 0 && G >= 1 && RS >= G &&
         RS % G == 0 && layout(M, Q, D, G, RS).threads <= MAX_THREADS;
}

int launch(const float* var, const float* ard, const float* mu,
           const float* s, const float* w, const float* z, const float* y,
           float* part, float* psi2, float* p1y, int T, int N, int M, int Q,
           int D, int G, int RS, int rows_per_chunk, int chunks,
           cudaStream_t stream) {
  if (!valid(M, Q, D, G, RS) || T < 1 || N < 1 || chunks < 1 ||
      (long long)rows_per_chunk * (chunks - 1) >= N ||
      (long long)rows_per_chunk * chunks < N)
    return (int)cudaErrorInvalidValue;
  Dims d;
  d.T = T; d.N = N; d.M = M; d.Q = Q; d.D = D; d.G = G; d.RS = RS;
  d.rows_per_chunk = rows_per_chunk;
  const Layout lay = layout(M, Q, D, G, RS);
  const size_t smem = (size_t)lay.total * sizeof(float);
  const int err = with_kernel(M, Q, D, [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(chunks, T), lay.threads, smem, stream>>>(
        var, ard, mu, s, w, z, y, part, d);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;

  const long long P = (long long)T * (16LL * lay.NT + round4(M * D));
  const int rthreads = 256;
  const unsigned rblocks = (unsigned)((P + rthreads - 1) / rthreads);
  if (D > 0)
    reduce_chunks<true><<<rblocks, rthreads, 0, stream>>>(part, chunks, d,
                                                          psi2, p1y);
  else
    reduce_chunks<false><<<rblocks, rthreads, 0, stream>>>(part, chunks, d,
                                                           psi2, p1y);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tiled form: M past one block's tile (MAX_M), or a Q whose single-tile
// block fits no SM. Psi2's upper triangle is cut into super-tiles of TP x
// TP, S = ceil(M / TP) ranges a side. Three kernels: the pair body
// (suffstats_tiled_kernel: Psi2 alone, for K1, K4 and K5), for K1 the
// Psi1^T Y kernel (p1y_tiled_kernel), and the chunk reduction.
//
// The pair body. Block (chunk, atom, k) stages the z and c rows of two
// ranges, a and b, as TW = 2 TP columns, and every block owns the same
// pair work:
//   * an off-diagonal super-tile (a, b), a < b: its 256 4x4 tiles, one a
//     thread (4096 pairs);
//   * or the upper triangles of two diagonal super-tiles (a, a) and (b, b),
//     b = a + 1 (4160 pairs): warps 0-6 own 224 of their 240 strictly upper
//     4x4 tiles, one a thread; the last warp owns the 32 diagonal 4x4 tiles
//     (their 10 pairs m <= l each) and the other 16 strictly upper tiles
//     cut into halves of 2 x 4 rows, 18 pairs a thread, in a branch that
//     is uniform across the warp. With S odd the last diagonal super-tile
//     pairs with none: its b half lies past M (zero columns, computed, not
//     written).
//   Why pairs of diagonal super-tiles rather than a cut of the list of the
//   triangle's 4x4 tiles: the two ranges of such a pair are the two staged
//   ranges of an off-diagonal block, so every block stages 2 TP columns,
//   and the shared memory still leaves two blocks an SM; a cut list
//   straddles super-tiles (three or four ranges staged) and leaves a short
//   last block (at M = 256 the 2080 tiles are 8.125 blocks of 256). The
//   blocks' pairs differ by 1/TP (1.6%), so the chunks count blocks for
//   whole waves; a grid of one super-tile a block left the diagonal blocks'
//   threads half idle.
//   * The pair exponent, the row scalars and the row pipeline are the
//     single-tile kernel's (the tiled K2 in csrc/psi2_bwd.cu shares E's
//     bits). A row's 16 (18) exponentials are issued beside the next row's
//     quadratic forms, in one basic block, and summed in row order.
//   * Bound on the H100: FP32 issue. The body holds two 256-thread blocks
//     an SM, 107 registers a thread at Q = 10. Psi1^T Y in the same body
//     (its Y rows, Psi1 rows and sums spread over the blocks) took the cap
//     of 128 and cost 0.9-1.0 ms of 6.8 on an H100 at M = 256, T = 20,
//     N = 8192, D = 60, more than its own kernel below takes.
//
// The Psi1^T Y kernel. Block (chunk, atom, range a) sums, over the chunk's
// rows, the var w Psi1 row of range a's TP columns against Y, a 4 x 4 tile
// of (m, d) a thread (64 columns of Y a walk of the rows); each Psi1
// element is computed once (the pair body would compute it in each of
// range a's S blocks), never reaching device memory. Four blocks an SM (64
// registers a thread): under a bound of 256 threads alone ptxas chose 48
// registers and kept three values across the IEEE division's slow-path
// calls on the stack (12 B of spill stores at Q = 10).
//
// Partials per (chunk, atom, super-tile) and per (chunk, atom, range) go
// to reduce_tiled, which sums the chunks in chunk order and mirrors.

constexpr int TP = 64;                       // super-tile width: a range
constexpr int TT4 = TP / 4;                  // 4x4 tiles along its side
constexpr int TILED_THREADS = TT4 * TT4;     // a 4x4 tile of (a, b) a thread
constexpr int TW = 2 * TP;                   // staged columns: range a | b
constexpr int STRICT = TT4 * (TT4 - 1) / 2;  // strictly upper 4x4 tiles
constexpr int EDGE0 = TILED_THREADS - 32;    // the last warp's first thread
constexpr int NPAIR = 18;                    // pair registers of a thread
static_assert(2 * STRICT == EDGE0 + 16 && 2 * TT4 == 32,
              "the last warp of a diagonal pair takes its 32 diagonal 4x4 "
              "tiles and the halves of 16 strictly upper ones");
constexpr int PY_ROWS = 32;   // rows the Psi1^T Y kernel stages at once
constexpr int PY_COLS = 64;   // columns of Y a walk of its rows: 16 x 4

struct TiledDims {
  int T, N, M, Q, D, S, RS, rows_per_chunk, chunks;
};

// shared-memory layout of the pair body, offsets in floats
struct TiledLayout {
  int RI;
  int z, al, ri, c, total;
};

__host__ __device__ TiledLayout tiled_layout(int Q, int RS) {
  TiledLayout s;
  // per q (sqrt b, mu, log u2, -) | w, -, ln log2(e); the logs are the
  // prep's, summed in q order into ln
  s.RI = round4(4 * Q + 3);
  s.z = 0;                           // [Q][TW] z_t of ranges a and b
  s.al = s.z + Q * TW;               // [Q] alpha_t
  s.ri = s.al + round4(Q);           // [3][RS][RI] row scalars
  s.c = s.ri + 3 * RS * s.RI;        // [2][RS][Q][TW] c
  s.total = s.c + 2 * RS * Q * TW;
  return s;
}

// floats of the Psi1^T Y kernel's shared memory: z_t of the range [Q][TP],
// per staged row (a1, mu and log u1 per q, w, l1 log2(e)), the var w Psi1
// rows [PY_ROWS][TP] and the Y rows [PY_ROWS][PY_COLS]
__host__ __device__ int p1y_row_floats(int Q) { return round4(3 * Q + 2); }

__host__ __device__ int p1y_smem_floats(int Q) {
  return Q * TP + PY_ROWS * p1y_row_floats(Q) + PY_ROWS * TP +
         PY_ROWS * PY_COLS;
}

// blocks of an atom's grid: the off-diagonal super-tiles, then the
// diagonal ones in pairs (the last alone for an odd S)
__host__ __device__ int tiled_blocks(int S) {
  return S * (S - 1) / 2 + (S + 1) / 2;
}

// ranges (a, b) of block k and whether it holds diagonal super-tiles
__device__ __forceinline__ void tiled_block(int k, int S, int& ra, int& rb,
                                            bool& diag) {
  const int off = S * (S - 1) / 2;
  diag = k >= off;
  if (diag) {
    ra = 2 * (k - off);
    rb = ra + 1;
    return;
  }
  ra = 0;
  while (k >= S - 1 - ra) {
    k -= S - 1 - ra;
    ++ra;
  }
  rb = ra + 1 + k;
}

// row tm, column tl (tm < tl) of strictly upper tile k of a t4 x t4 grid
__device__ __forceinline__ void strict_tile(int k, int t4, int& tm,
                                            int& tl) {
  int row = 0;
  while (k >= t4 - 1 - row) {
    k -= t4 - 1 - row;
    ++row;
  }
  tm = row;
  tl = row + 1 + k;
}

// one row's pairs into the sums: E = 2^min(expo log2(e), 0), expo log2(e)
// = ln_n log2(e) - log2(e)/4 (le + quad), weighted by the row's w
template <int NP>
__device__ __forceinline__ void add_row(const float (&le)[NPAIR],
                                        float (&acc)[NPAIR],
                                        const float (&quad)[NP], float ln2,
                                        float wr) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const float ex = fmaf(-0.25f * LOG2E, le[p] + quad[p], ln2);
    acc[p] = fmaf(wr, exp2_ftz(fminf(ex, 0.f)), acc[p]);
  }
}

// The partials: a TP x TP block per (chunk, atom, super-tile), row-major
// (the diagonal super-tiles' entries below their diagonal are never written
// nor read), then, after every chunk's, TP x D of Psi1^T Y per (chunk,
// atom, range).

template <int QC>
__global__ void __launch_bounds__(TILED_THREADS, 2)
suffstats_tiled_kernel(const float* __restrict__ var,
                       const float* __restrict__ ard,
                       const float* __restrict__ mu,
                       const float* __restrict__ s,
                       const float* __restrict__ w,
                       const float* __restrict__ z, float* __restrict__ part,
                       TiledDims d) {
  extern __shared__ __align__(16) float sm[];
  constexpr int NTH = TILED_THREADS;
  const int T = d.T, M = d.M, Q = QC ? QC : d.Q, S = d.S;
  const int RS = d.RS;
  const TiledLayout lay = tiled_layout(Q, RS);
  const int RI = lay.RI;
  float* z_sh = sm + lay.z;
  float* al_sh = sm + lay.al;
  float* c_sh = sm + lay.c;

  const int chunk = blockIdx.x, t = blockIdx.y;
  int ra, rb;
  bool diag;
  tiled_block(blockIdx.z, S, ra, rb, diag);
  const bool has_b = rb < S;  // false: the lone diagonal super-tile
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = chunk * d.rows_per_chunk;
  const int nrows = min(d.rows_per_chunk, d.N - row0);
  const int nstage = (nrows + RS - 1) / RS;

  // row scalars of stage st into buffer st % 3, as the single-tile
  // kernel's prep: a row takes a segment of SEG lanes, a lane per q; the
  // segment's first lane then sums the row's logs in q order
  const int SEG = Q <= 16 ? 16 : 32, lane_q = lane % SEG;
  const int row_slots = (NTH / 32) * (32 / SEG);
  const int my_row = warp * (32 / SEG) + lane / SEG;
  auto prep = [&](int st) {
    const int r0 = st * RS, nb = min(RS, nrows - r0);
    float* ri = sm + lay.ri + (st % 3) * RS * RI;
    for (int rb0 = 0; rb0 < nb; rb0 += row_slots) {  // uniform across a warp
      const int r = rb0 + my_row;
      const long long n = row0 + r0 + r;
      float* rr = ri + r * RI;
      const float wn = r < nb && lane_q == 0 && w ? w[n] : 1.f;
      if (r < nb) {
        for (int q = lane_q; q < Q; q += SEG) {
          const float a = ard[(long long)t * Q + q];
          const float u2 = fmaf(2.f * a, s[n * Q + q], 1.f);
          rr[4 * q] = sqrtf(a / u2);
          rr[4 * q + 1] = mu[n * Q + q];
          rr[4 * q + 2] = logf(u2);
        }
      }
      __syncwarp();
      if (r < nb && lane_q == 0) {
        float ln = 0.f;
#pragma unroll 4
        for (int q = 0; q < Q; ++q) ln -= 0.5f * rr[4 * q + 2];
        rr[4 * Q] = wn;
        rr[4 * Q + 2] = ln * LOG2E;
      }
      __syncwarp();
    }
  };

  // c of the staged columns, of stage st into buffer st % 2; one (row,
  // column) per thread
  static_assert(NTH % TW == 0, "a thread keeps its column across rows");
  auto build = [&](int st) {
    const int nb = min(RS, nrows - st * RS);
    const float* ri = sm + lay.ri + (st % 3) * RS * RI;
    float* cb = c_sh + (st % 2) * RS * Q * TW;
    const int j = tid % TW;
    for (int r = tid / TW; r < nb; r += NTH / TW) {
      const float* rr = ri + r * RI;
      float* cr = cb + r * Q * TW + j;
#pragma unroll 4
      for (int q = 0; q < Q; ++q) {
        const float2 v2 = *reinterpret_cast<const float2*>(rr + 4 * q);
        cr[q * TW] = v2.x * (v2.y - z_sh[q * TW + j]);
      }
    }
  };

  for (int i = tid; i < Q * TW; i += NTH) {
    const int q = i / TW, j = i % TW;
    const int m = j < TP ? ra * TP + j : rb * TP + j - TP;
    z_sh[i] = m < M ? z[((long long)t * M + m) * Q + q] : 0.f;
  }
  for (int q = tid; q < Q; q += NTH) al_sh[q] = ard[(long long)t * Q + q];
  if (nstage > 0) prep(0);
  if (nstage > 1) prep(1);
  __syncthreads();

  // This thread's pairs, in staged columns. A 4x4 tile: rows m0, columns
  // l0; in the last warp of a diagonal pair ("edge"), the diagonal 4x4
  // tile at m0 (pairs i <= j) and the 2 x 4 half tile of rows h0, columns
  // l0. Pair p: 4i + j of the tile; the diagonal tile's in (i, j) order,
  // then 10 + 4i + j of the half tile.
  const bool edge = diag && tid >= EDGE0;
  int m0, l0, h0 = 0;
  if (!diag) {
    m0 = 4 * (tid / TT4);
    l0 = TP + 4 * (tid % TT4);
  } else {
    const int k = edge ? EDGE0 + (lane >> 1) : tid;
    int tm, tl;
    strict_tile(k % STRICT, TT4, tm, tl);
    const int base = k / STRICT * TP;
    m0 = base + 4 * tm;
    l0 = base + 4 * tl;
    if (edge) {
      h0 = m0 + 2 * (lane & 1);
      m0 = lane / TT4 * TP + 4 * (lane % TT4);
    }
  }
  float le[NPAIR], acc[NPAIR];
#pragma unroll
  for (int p = 0; p < NPAIR; ++p) {
    le[p] = 0.f;
    acc[p] = 0.f;
  }
  for (int q = 0; q < Q; ++q) {
    const float a = al_sh[q];
    const float* zq = z_sh + q * TW;
    float zm[4], zl[4];
    unpack(*reinterpret_cast<const float4*>(zq + m0), zm);
    unpack(*reinterpret_cast<const float4*>(zq + l0), zl);
    if (!edge) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float df = zm[i] - zl[j];
          le[4 * i + j] = fmaf(a * df, df, le[4 * i + j]);
        }
    } else {
      int p = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = i; j < 4; ++j, ++p) {
          const float df = zm[i] - zm[j];
          le[p] = fmaf(a * df, df, le[p]);
        }
      const float2 zh = *reinterpret_cast<const float2*>(zq + h0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d0 = zh.x - zl[j], d1 = zh.y - zl[j];
        le[10 + j] = fmaf(a * d0, d0, le[10 + j]);
        le[14 + j] = fmaf(a * d1, d1, le[14 + j]);
      }
    }
  }

  if (nstage > 0) build(0);
  __syncthreads();
  for (int st = 0; st < nstage; ++st) {
    if (st + 1 < nstage) build(st + 1);
    if (st + 2 < nstage) prep(st + 2);
    const int nb = min(RS, nrows - st * RS);
    const float* ri = sm + lay.ri + (st % 3) * RS * RI;
    const float* cb = c_sh + (st % 2) * RS * Q * TW;

    // the quadratic forms of row r's pairs
    auto quad_full = [&](int r, float (&quad)[16]) {
      const float* pm = cb + r * Q * TW + m0;
      const float* pl = cb + r * Q * TW + l0;
#pragma unroll
      for (int p = 0; p < 16; ++p) quad[p] = 0.f;
#pragma unroll (QC ? QC : 2)
      for (int q = 0; q < Q; ++q, pm += TW, pl += TW) {
        float cm[4], cl[4];
        unpack(*reinterpret_cast<const float4*>(pm), cm);
        unpack(*reinterpret_cast<const float4*>(pl), cl);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float tq = cm[i] + cl[j];
            quad[4 * i + j] = fmaf(tq, tq, quad[4 * i + j]);
          }
      }
    };
    auto quad_edge = [&](int r, float (&quad)[NPAIR]) {
      const float* pm = cb + r * Q * TW + m0;
      const float* ph = cb + r * Q * TW + h0;
      const float* pl = cb + r * Q * TW + l0;
#pragma unroll
      for (int p = 0; p < NPAIR; ++p) quad[p] = 0.f;
#pragma unroll (QC ? QC : 2)
      for (int q = 0; q < Q; ++q, pm += TW, ph += TW, pl += TW) {
        float cm[4], cl[4];
        unpack(*reinterpret_cast<const float4*>(pm), cm);
        unpack(*reinterpret_cast<const float4*>(pl), cl);
        const float2 ch = *reinterpret_cast<const float2*>(ph);
        int p = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = i; j < 4; ++j, ++p) {
            const float tq = cm[i] + cm[j];
            quad[p] = fmaf(tq, tq, quad[p]);
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float t0 = ch.x + cl[j], t1 = ch.y + cl[j];
          quad[10 + j] = fmaf(t0, t0, quad[10 + j]);
          quad[14 + j] = fmaf(t1, t1, quad[14 + j]);
        }
      }
    };
    // a row's exponentials are issued beside the next row's quadratic
    // forms (one basic block), the sums still taken in row order
    auto walk = [&](auto&& quad_of, auto& qp, auto& qc) {
      if (nb < 1) return;
      quad_of(0, qp);
      float lnp = ri[4 * Q + 2], wp = ri[4 * Q];
      for (int r = 1; r < nb; ++r) {
        quad_of(r, qc);
        add_row(le, acc, qp, lnp, wp);
#pragma unroll
        for (int p = 0; p < (int)(sizeof(qp) / sizeof(float)); ++p)
          qp[p] = qc[p];
        lnp = ri[r * RI + 4 * Q + 2];
        wp = ri[r * RI + 4 * Q];
      }
      add_row(le, acc, qp, lnp, wp);
    };
    if (!edge) {
      float qp[16], qc[16];
      walk(quad_full, qp, qc);
    } else {
      float qp[NPAIR], qc[NPAIR];
      walk(quad_edge, qp, qc);
    }
    __syncthreads();  // stage st's buffers free, st + 1 built
  }

  // the pairs' Psi2 partials: staged (jm, jl) is entry (jm % TP, jl % TP)
  // of super-tile (range of jm, range of jl); a range past M is not written
  const long long nst = (long long)S * (S + 1) / 2;
  float* p2 = part + ((long long)chunk * T + t) * nst * TP * TP;
  auto at = [&](int jm, int jl) {
    const int am = jm < TP ? ra : rb, bl = jl < TP ? ra : rb;
    const long long tile = am * S - am * (am - 1) / 2 + (bl - am);
    return p2 + tile * TP * TP + (jm % TP) * TP + jl % TP;
  };
  const float v = var[t], v2 = v * v;
  if (!edge) {
    if (l0 < TP || has_b) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(at(m0 + i, l0)) =
            make_float4(v2 * acc[4 * i], v2 * acc[4 * i + 1],
                        v2 * acc[4 * i + 2], v2 * acc[4 * i + 3]);
    }
  } else {
    if (m0 < TP || has_b) {
      int p = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = i; j < 4; ++j, ++p) *at(m0 + i, m0 + j) = v2 * acc[p];
    }
    if (has_b) {  // the half tiles lie in range b
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float4*>(at(h0 + i, l0)) = make_float4(
            v2 * acc[10 + 4 * i], v2 * acc[11 + 4 * i],
            v2 * acc[12 + 4 * i], v2 * acc[13 + 4 * i]);
    }
  }
}

// Psi1^T Y of the tiled form into the partials' second half: block
// (chunk, atom t, range a). A stage of PY_ROWS rows: their scalars (a lane
// per (row, q), then a thread per row sums the logs in q order, as the
// single-tile kernel's prep), their var w Psi1 over the range's columns
// and their Y columns of the walk, then each thread's 4 x 4 tile of
// (m, d) takes the stage's rows in row order.
template <int QC>
__global__ void __launch_bounds__(TILED_THREADS, 4)
p1y_tiled_kernel(const float* __restrict__ var,
                 const float* __restrict__ ard,
                 const float* __restrict__ mu, const float* __restrict__ s,
                 const float* __restrict__ w, const float* __restrict__ z,
                 const float* __restrict__ y, float* __restrict__ part,
                 TiledDims d) {
  extern __shared__ __align__(16) float sm[];
  constexpr int NTH = TILED_THREADS;
  const int T = d.T, M = d.M, Q = QC ? QC : d.Q, D = d.D, S = d.S;
  const int RR = p1y_row_floats(Q);
  float* z_sh = sm;                      // [Q][TP]
  float* rs_sh = z_sh + Q * TP;          // [PY_ROWS][RR]
  float* p1_sh = rs_sh + PY_ROWS * RR;   // [PY_ROWS][TP]
  float* y_sh = p1_sh + PY_ROWS * TP;    // [PY_ROWS][PY_COLS]

  const int chunk = blockIdx.x, t = blockIdx.y, ra = blockIdx.z;
  const int tid = threadIdx.x;
  const int row0 = chunk * d.rows_per_chunk;
  const int nrows = min(d.rows_per_chunk, d.N - row0);
  const float v = var[t];
  for (int i = tid; i < Q * TP; i += NTH) {
    const int q = i / TP, m = ra * TP + i % TP;
    z_sh[i] = m < M ? z[((long long)t * M + m) * Q + q] : 0.f;
  }
  const int m0 = 4 * (tid % TT4), d0 = 4 * (tid / TT4);
  const long long nst = (long long)S * (S + 1) / 2;
  float* out = part + (long long)d.chunks * T * nst * TP * TP +
               (((long long)chunk * T + t) * S + ra) * TP * D;

  for (int dw = 0; dw < D; dw += PY_COLS) {  // a walk of 64 columns of Y
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r0 = 0; r0 < nrows; r0 += PY_ROWS) {
      const int nb = min(PY_ROWS, nrows - r0);
      const long long n0 = row0 + r0;
      __syncthreads();  // the stage before it read; z staged
      for (int i = tid; i < nb * Q; i += NTH) {
        const int r = i / Q, q = i % Q;
        const float a = ard[(long long)t * Q + q];
        const float u1 = fmaf(a, s[(n0 + r) * Q + q], 1.f);
        float* rr = rs_sh + r * RR;
        rr[q] = a / u1;
        rr[Q + q] = mu[(n0 + r) * Q + q];
        rr[2 * Q + q] = logf(u1);
      }
      for (int i = tid; i < nb * PY_COLS; i += NTH) {
        const int r = i / PY_COLS, dd = dw + i % PY_COLS;
        y_sh[i] = dd < D ? y[(n0 + r) * D + dd] : 0.f;
      }
      __syncthreads();
      for (int r = tid; r < nb; r += NTH) {
        float* rr = rs_sh + r * RR;
        float l1 = 0.f;
#pragma unroll 4
        for (int q = 0; q < Q; ++q) l1 -= 0.5f * rr[2 * Q + q];
        rr[3 * Q] = w ? w[n0 + r] : 1.f;
        rr[3 * Q + 1] = l1 * LOG2E;
      }
      __syncthreads();
      // Psi1 as the pair body's single-tile kernel builds it
      for (int i = tid; i < nb * TP; i += NTH) {
        const int r = i / TP, j = i % TP;
        const float* rr = rs_sh + r * RR;
        float quad1 = 0.f;
#pragma unroll 4
        for (int q = 0; q < Q; ++q) {
          const float df = rr[Q + q] - z_sh[q * TP + j];
          quad1 = fmaf(rr[q] * df, df, quad1);
        }
        const float e1 = fmaf(-0.5f * LOG2E, quad1, rr[3 * Q + 1]);
        p1_sh[i] = ra * TP + j < M
                       ? v * rr[3 * Q] * exp2_ftz(fminf(e1, 0.f)) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < nb; ++r) {
        float pv[4], yv[4];
        unpack(*reinterpret_cast<const float4*>(p1_sh + r * TP + m0), pv);
        unpack(*reinterpret_cast<const float4*>(y_sh + r * PY_COLS + d0),
               yv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], yv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (dw + d0 + j < D) out[(m0 + i) * D + dw + d0 + j] = acc[i][j];
  }
}

// psi2 (T, M, M) and (P1Y) p1y (T, M, D): each element the chunks' partials
// of its super-tile summed in chunk order; (m, l) below the diagonal reads
// (l, m), so Psi2 comes out symmetric
template <bool P1Y>
__global__ void reduce_tiled(const float* __restrict__ part, TiledDims d,
                             float* __restrict__ psi2,
                             float* __restrict__ p1y) {
  const int T = d.T, M = d.M, D = d.D, S = d.S, chunks = d.chunks;
  const long long nst = (long long)S * (S + 1) / 2;
  const long long P2 = (long long)T * nst * TP * TP;  // a chunk's Psi2
  const long long PY = (long long)T * S * TP * D;     // a chunk's Psi1^T Y
  const long long n2 = (long long)T * M * M;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n2) {
    const int t = (int)(e / ((long long)M * M));
    const long long r = e % ((long long)M * M);
    int m = (int)(r / M), l = (int)(r % M);
    if (m > l) {
      const int k = m;
      m = l;
      l = k;
    }
    const long long a = m / TP, b = l / TP;
    const long long tile = a * S - a * (a - 1) / 2 + (b - a);
    const long long off =
        ((long long)t * nst + tile) * TP * TP + (m % TP) * TP + l % TP;
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < chunks; ++c) acc += part[c * P2 + off];
    psi2[e] = acc;
    return;
  }
  if constexpr (P1Y) {
    const long long e2 = e - n2;
    if (e2 >= (long long)T * M * D) return;
    const int t = (int)(e2 / ((long long)M * D));
    const int m = (int)(e2 % ((long long)M * D) / D), dd = (int)(e2 % D);
    const long long off = chunks * P2 +
                          ((long long)t * S + m / TP) * TP * D +
                          (long long)(m % TP) * D + dd;
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < chunks; ++c) acc += part[off + c * PY];
    p1y[e2] = acc;
  }
}

// f(pair body, Psi1^T Y kernel) of the tiled instantiations that serve Q
// (Q = 10 fixed, as every configuration's)
template <class F>
int with_tiled_kernels(int Q, F&& f) {
  return Q == 10 ? f(suffstats_tiled_kernel<10>, p1y_tiled_kernel<10>)
                 : f(suffstats_tiled_kernel<0>, p1y_tiled_kernel<0>);
}

int launch_tiled(const float* var, const float* ard, const float* mu,
                 const float* s, const float* w, const float* z,
                 const float* y, float* part, float* psi2, float* p1y, int T,
                 int N, int M, int Q, int D, int RS, int rows_per_chunk,
                 int chunks, cudaStream_t stream) {
  const int S = (M + TP - 1) / TP;
  if (M < 1 || Q < 1 || D < 0 || RS < 1 || T < 1 || T > 65535 || N < 1 ||
      chunks < 1 || tiled_blocks(S) > 65535 ||
      (long long)rows_per_chunk * (chunks - 1) >= N ||
      (long long)rows_per_chunk * chunks < N)
    return (int)cudaErrorInvalidValue;
  TiledDims d;
  d.T = T; d.N = N; d.M = M; d.Q = Q; d.D = D; d.S = S; d.RS = RS;
  d.rows_per_chunk = rows_per_chunk; d.chunks = chunks;
  const size_t smem = (size_t)tiled_layout(Q, RS).total * sizeof(float);
  const size_t smem1 = (size_t)p1y_smem_floats(Q) * sizeof(float);
  const int err = with_tiled_kernels(Q, [&](auto body, auto p1y_kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        body, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    body<<<dim3(chunks, T, (unsigned)tiled_blocks(S)), TILED_THREADS, smem,
           stream>>>(var, ard, mu, s, w, z, part, d);
    e = cudaGetLastError();
    if (e != cudaSuccess || D == 0) return (int)e;
    e = cudaFuncSetAttribute(p1y_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem1);
    if (e != cudaSuccess) return (int)e;
    p1y_kernel<<<dim3(chunks, T, S), TILED_THREADS, smem1, stream>>>(
        var, ard, mu, s, w, z, y, part, d);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  const long long outs = (long long)T * M * M + (long long)T * M * D;
  const int rthreads = 256;
  const unsigned rblocks = (unsigned)((outs + rthreads - 1) / rthreads);
  if (D > 0)
    reduce_tiled<true><<<rblocks, rthreads, 0, stream>>>(part, d, psi2, p1y);
  else
    reduce_tiled<false><<<rblocks, rthreads, 0, stream>>>(part, d, psi2,
                                                          p1y);
  return (int)cudaGetLastError();
}

}  // namespace

// blocks of the main kernel (Psi2 alone at D = 0) that fit on one SM with
// G groups and RS staged rows, 0 where none fits, or minus a CUDA error
extern "C" int psi_suffstats_blocks_per_sm(int M, int Q, int D, int G,
                                           int RS) {
  if (!valid(M, Q, D, G, RS)) return -(int)cudaErrorInvalidValue;
  const Layout lay = layout(M, Q, D, G, RS);
  const size_t smem = (size_t)lay.total * sizeof(float);
  int max_smem = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  if (smem > (size_t)max_smem) return 0;
  return with_kernel(M, Q, D, [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return -(int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      lay.threads, smem);
    return e == cudaSuccess ? blocks : -(int)e;
  });
}

// K1. part: chunks x T x (16 NT + round4(M D)) floats, NT = T4 (T4 + 1) / 2;
// w may be null (every row weight 1)
extern "C" int psi_suffstats_f32(const float* var, const float* ard,
                                 const float* mu, const float* s,
                                 const float* w, const float* z,
                                 const float* y, float* part, float* psi2,
                                 float* p1y, int T, int N, int M, int Q, int D,
                                 int G, int RS, int rows_per_chunk, int chunks,
                                 cudaStream_t stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  return launch(var, ard, mu, s, w, z, y, part, psi2, p1y, T, N, M, Q, D, G,
                RS, rows_per_chunk, chunks, stream);
}

// K4, the Psi2 stack (T, M, M), and K5 at T = 1. part: chunks x T x 16 NT
// floats
extern "C" int psi2_batched_f32(const float* var, const float* ard,
                                const float* mu, const float* s,
                                const float* w, const float* z, float* part,
                                float* psi2, int T, int N, int M, int Q, int G,
                                int RS, int rows_per_chunk, int chunks,
                                cudaStream_t stream) {
  return launch(var, ard, mu, s, w, z, nullptr, part, psi2, nullptr, T, N, M,
                Q, 0, G, RS, rows_per_chunk, chunks, stream);
}

// blocks of the tiled pair body that fit on one SM with RS staged rows, 0
// where none fits (or, D > 0, where the Psi1^T Y kernel's block does not),
// or minus a CUDA error
extern "C" int psi_suffstats_tiled_blocks_per_sm(int Q, int D, int RS) {
  if (Q < 1 || D < 0 || RS < 1) return -(int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tiled_layout(Q, RS).total * sizeof(float);
  int max_smem = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  if (smem > (size_t)max_smem ||
      (D > 0 && (size_t)p1y_smem_floats(Q) * sizeof(float) > (size_t)max_smem))
    return 0;
  return with_tiled_kernels(Q, [&](auto body, auto) {
    cudaError_t e = cudaFuncSetAttribute(
        body, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return -(int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, body,
                                                      TILED_THREADS, smem);
    return e == cudaSuccess ? blocks : -(int)e;
  });
}

// the tiled instantiations that serve Q and what the loaded module says of
// them: out = [QC, registers and local memory bytes a thread (the stack
// frame, spills included) of the pair body, the same of the Psi1^T Y
// kernel]; returns a CUDA error
extern "C" int psi_suffstats_tiled_attributes(int Q, int* out) {
  if (Q < 1) return (int)cudaErrorInvalidValue;
  return with_tiled_kernels(Q, [&](auto body, auto p1y_kernel) {
    cudaFuncAttributes a, b;
    cudaError_t e = cudaFuncGetAttributes(&a, body);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&b, p1y_kernel);
    if (e != cudaSuccess) return (int)e;
    out[0] = Q == 10 ? 10 : 0;
    out[1] = a.numRegs;
    out[2] = (int)a.localSizeBytes;
    out[3] = b.numRegs;
    out[4] = (int)b.localSizeBytes;
    return 0;
  });
}

// K1 in the tiled form: the pair body, the Psi1^T Y kernel, the reduction.
// part: chunks x T x S(S+1)/2 x TP^2 floats of Psi2, then chunks x T x S x
// TP x D of Psi1^T Y (S = ceil(M / TP), TP = 64)
extern "C" int psi_suffstats_tiled_f32(const float* var, const float* ard,
                                       const float* mu, const float* s,
                                       const float* w, const float* z,
                                       const float* y, float* part,
                                       float* psi2, float* p1y, int T, int N,
                                       int M, int Q, int D, int RS,
                                       int rows_per_chunk, int chunks,
                                       cudaStream_t stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  return launch_tiled(var, ard, mu, s, w, z, y, part, psi2, p1y, T, N, M, Q,
                      D, RS, rows_per_chunk, chunks, stream);
}

// K4 and K5 in the tiled form. part: chunks x T x S(S+1)/2 x TP^2 floats
extern "C" int psi2_batched_tiled_f32(const float* var, const float* ard,
                                      const float* mu, const float* s,
                                      const float* w, const float* z,
                                      float* part, float* psi2, int T, int N,
                                      int M, int Q, int RS,
                                      int rows_per_chunk, int chunks,
                                      cudaStream_t stream) {
  return launch_tiled(var, ard, mu, s, w, z, nullptr, part, psi2, nullptr, T,
                      N, M, Q, 0, RS, rows_per_chunk, chunks, stream);
}
