// Mamba-2 chunked SSD (state-space duality) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py:24 (_ssd_kernel)
// and the body of its wrapper ssd (:77). Per (batch, head) and chunk of L
// positions, with cum = cumsum(dt * A) inside the chunk:
//   y_i   = exp(cum_i) C_i prev^T + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   next  = exp(cum_last) prev + (x * exp(cum_last - cum) * dt)^T B
// where prev is the f32 (P, N) state left by the chunks before. Only y is
// written, in x's dtype.
//
// Bound on the H100: per (batch, head, chunk) 2 L N P operations for the
// chunk state, 2 L N P for C prev^T and about L^2 (N + P) for the pairs
// j <= i, against (L P + 2 L N) input elements, so at mamba2-370m's shape
// (L 256, P 64, N 128, batch 4 x 2048, 32 heads) it is bound by operations:
// 21.5 GFLOP, 0.32 ms at the 67 TFLOP/s of FP32 FMA and 0.022 ms at the
// 989 TFLOP/s of the bf16 tensor cores.
//
// Design. On the TPU the chunks of one (batch, head) run in order on one
// core, carrying the state in VMEM. Here only the state passing is
// sequential, and it is elementwise over P N, so one call runs three
// kernels on the caller's stream:
//   (a) chunk state: grid (batch x head, chunk, 64-wide column tile of P).
//       A parallel cumsum of dt A (warp scans), then the chunk's own
//       contribution (x * exp(cum_last - cum) * dt)^T B, written transposed
//       as (N, P) f32 to a workspace, and exp(cum_last) beside it.
//   (b) state passing: grid (batch x head, slices of P N). Walks the chunks
//       in order and overwrites each contribution with the state its chunk
//       starts from: prev_0 = 0, prev_c = exp(cum_last,c-1) prev_c-1 +
//       contrib_c-1. f32 throughout.
//   (c) chunk scan: grid (64-row tile of the chunk, batch x head, chunk,
//       column tile of P), the row tiles with the most column tiles issued
//       first. Each CTA recomputes the chunk's cumsum (the same function as
//       (a), so the same values), forms exp(cum_i) C prev^T, then walks the
//       64-wide column tiles j0 <= i0: C B^T, the gate (C B^T) exp(cum_i -
//       cum_j) dt_j masked to j <= i, and gate x.
// At mamba2-370m's shape that is 1024 CTAs for (a) and 4096 for (c), where a
// CTA per (batch, head) gave 128. The workspace (batch x head x chunks x N x
// P f32, 33.5 MB there) and the decays are allocated by the wrapper.
//
// f32 inputs (FP32 FMA, register-tiled): a CTA of 256 threads owns a 64 x 64
// output tile; each thread a 4 x 4 micro-tile, laid out so that the float4
// reads of one warp instruction fall on distinct banks or broadcast. In the
// diagonal tile a warp skips the column groups above its 8 rows.
// Every product reads float4 from shared-memory rows padded by 16 bytes
// (4 + 4 float4 per 64 FMA), the tiles staged by 16-byte cp.async copies that
// zero-fill past the ends. (c) takes 103 KB of shared memory at chunk 256,
// so two CTAs (16 warps) share an SM. expf and no fast-math: the plain
// version is held to 1e-4, which rules out TF32.
//
// bf16 inputs (tensor cores): mma.sync m16n8k16 bf16 x bf16 -> f32 with
// ldmatrix operands; 4 warps of 16 rows in (c), 8 warps of 16 state rows in
// (a). C B^T stays in registers; the gate is formed there and packed to bf16
// as the A operand of gate x (the m16n8 accumulator layout is the m16n8k16
// A layout), with x through ldmatrix.trans. In the diagonal tile a warp skips
// the 16-column groups wholly above its rows. The roundings, every other sum
// and product being f32:
//   - the gate (C B^T) exp(cum_i - cum_j) dt_j is rounded to bf16 before
//     gate x (models/ssm.py::ssd_chunked rounds its gate to x's dtype too);
//   - x exp(cum_last - cum) dt is rounded to bf16 before its product with B
//     in the chunk state;
//   - the f32 state prev is rounded to bf16 as the operand of C prev^T.
// The stored state, its passing and all accumulators stay f32.
//
// B and C are read per group (head h uses group h / (H/G)), never repeated.
// No atomics: every output element is summed by one thread in a fixed order,
// so two calls on the same inputs give bit-identical y.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kRows = 64;         // chunk positions per tile (rows i, columns j, rows l)
constexpr int kPT = 64;           // columns of P per CTA
constexpr int kNT = 128;          // the largest N the kernels take (zero-padded below it)
constexpr int kMaxSmem = 232448;  // the 227 KB a block may opt in to

struct Dims {
  int S, H, P, G, N, L;  // sequence, heads, head dim, groups, state dim, chunk
  int nc, ptiles, rtiles, BH, Lp;  // chunks, column tiles of P, row tiles, batch x heads, max(L, 64)
};

// ---------------------------------------------------------------- helpers --
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_size 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// NR rows x W columns of a row-major global tile into shared memory (row
// stride RS elements). Element (r, c) is copied when r < nrows and c < ncols,
// and zero-filled otherwise. W and ncols are multiples of 16 bytes.
template <typename T, int NR, int W, int RS, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t row_stride, int nrows,
                                          int ncols, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = W / kVec;
  for (int e = tid; e < NR * kChunks; e += NT) {
    const int r = e / kChunks, c = (e % kChunks) * kVec;
    const bool in = r < nrows && c < ncols;
    cp_async16(dst + r * RS + c, in ? src + r * row_stride + c : src, in);
  }
}

// The chunk's decay sums in shared memory: cum_l = sum_{t<=l} dt_t a, kept
// as hi_l + lo_l (hi the float nearest to the double sum, lo the rest), so
// that the exponent cum_i - cum_j = (hi_i - hi_j) + (lo_i - lo_j) carries
// the rounding of neither a long f32 sum nor the difference of two sums of
// a few hundred (an f32 ulp there is 3e-5, which would reach the 1e-4 bound
// once multiplied into y). dt_l beside them; all three 0 for L <= l < Lp.
struct Scan {
  double* part;  // (8,): the warp totals of the scan
  float* hi;     // (Lp,)
  float* lo;     // (Lp,)
  float* dt;     // (Lp,)
  __device__ Scan(float* base, int Lp)
      : part(reinterpret_cast<double*>(base)), hi(base + 16), lo(hi + Lp), dt(lo + Lp) {}
  __device__ float seg(int i, int j) const { return (hi[i] - hi[j]) + (lo[i] - lo[j]); }
  __device__ float at(int i) const { return hi[i] + lo[i]; }
};
constexpr int kScanFloats = 16;  // + 3 Lp: the floats a Scan takes

// Fills a Scan: the products dt a rounded to f32 as the reference forms
// them, summed in double by warp scans of shuffles and a scan of the warp
// totals (sums of a few thousand f32 terms of a chunk are exact in double,
// so the order does not matter, and every CTA of a chunk gets the same values).
template <int NT>
__device__ void chunk_cumsum(const Scan& sc, const float* dtb, int64_t dstride, float a, int L,
                             int Lp, int tid) {
  constexpr int NW = NT / 32;
  const int lane = tid & 31, warp = tid >> 5;
  double carry = 0.0;
  for (int base = 0; base < Lp; base += NT) {
    const int l = base + tid;
    const float d = l < L ? dtb[l * dstride] : 0.f;
    double v = static_cast<double>(d * a);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) sc.part[warp] = v;
    __syncthreads();
    if (warp == 0) {
      double t = lane < NW ? sc.part[lane] : 0.0;
#pragma unroll
      for (int o = 1; o < NW; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += u;
      }
      if (lane < NW) sc.part[lane] = t;
    }
    __syncthreads();
    v += carry + (warp ? sc.part[warp - 1] : 0.0);
    if (l < Lp) {
      const float hi = l < L ? static_cast<float>(v) : 0.f;
      sc.dt[l] = d;
      sc.hi[l] = hi;
      sc.lo[l] = l < L ? static_cast<float>(v - static_cast<double>(hi)) : 0.f;
    }
    carry += sc.part[NW - 1];
    __syncthreads();
  }
}

struct Tile {
  int b, h, g, c, bh, pt, rt;
};

// blockIdx.x -> (row tile, batch x head, chunk, column tile of P), the row
// tiles last-first so that the tiles with the most column tiles start first
__device__ __forceinline__ Tile decode(const Dims& d, bool row_tiles) {
  int idx = blockIdx.x;
  Tile t;
  const int per = d.BH * d.nc * d.ptiles;
  t.rt = row_tiles ? d.rtiles - 1 - idx / per : 0;
  idx %= per;
  t.pt = idx % d.ptiles;
  idx /= d.ptiles;
  t.c = idx % d.nc;
  t.bh = idx / d.nc;
  t.b = t.bh / d.H;
  t.h = t.bh % d.H;
  t.g = t.h / (d.H / d.G);
  return t;
}

// the chunk's first row of x (and y), B and C, and of dt
template <typename T>
struct Rows {
  const T* x;
  const T* B;
  const T* C;
  const float* dt;
  int64_t xs, bs;  // row strides: H P and G N elements
  __device__ Rows(const T* x_, const T* B_, const T* C_, const float* dt_, const Dims& d,
                  const Tile& t) {
    xs = static_cast<int64_t>(d.H) * d.P;
    bs = static_cast<int64_t>(d.G) * d.N;
    const int64_t pos = static_cast<int64_t>(t.b) * d.S + static_cast<int64_t>(t.c) * d.L;
    x = x_ + pos * xs + static_cast<int64_t>(t.h) * d.P + t.pt * kPT;
    B = B_ + pos * bs + static_cast<int64_t>(t.g) * d.N;
    C = C_ + pos * bs + static_cast<int64_t>(t.g) * d.N;
    dt = dt_ + pos * d.H + t.h;
  }
};

// the chunk's slice of the workspace: (N, P) f32, state transposed
__device__ __forceinline__ int64_t state_offset(const Dims& d, const Tile& t) {
  return (static_cast<int64_t>(t.bh) * d.nc + t.c) * d.N * d.P + t.pt * kPT;
}

// ------------------------------------------------------------ (b) passing --
// states holds each chunk's contribution; overwrite it with the state the
// chunk starts from. One thread per 4 elements of a (batch, head)'s P N.
__global__ void __launch_bounds__(256)
ssd_state_passing(float* __restrict__ states, const float* __restrict__ decay, int nc, int np4,
                  int blocks_per_bh) {
  const int bh = blockIdx.x / blocks_per_bh;
  const int e = (blockIdx.x % blocks_per_bh) * 256 + threadIdx.x;
  if (e >= np4) return;
  float4* st = reinterpret_cast<float4*>(states) + static_cast<int64_t>(bh) * nc * np4 + e;
  const float* dk = decay + static_cast<int64_t>(bh) * nc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 4) {  // four loads in flight before the dependent chain
    float4 t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c0 + u < nc) t[u] = st[static_cast<int64_t>(c0 + u) * np4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= nc) break;
      st[static_cast<int64_t>(c0 + u) * np4] = s;
      const float k = dk[c0 + u];
      s = make_float4(s.x * k + t[u].x, s.y * k + t[u].y, s.z * k + t[u].z, s.w * k + t[u].w);
    }
  }
}

// ------------------------------------------- f32: register-tiled FP32 FMA --
namespace fm {

constexpr int kThreads = 256;
constexpr int CRS = kNT + 4;    // C and B rows (floats, +16 B)
constexpr int XRS = kPT + 4;    // x and state rows
constexpr int GRS = kRows + 4;  // gate rows (+16 B)

__device__ __forceinline__ float lane4(const float4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

size_t state_smem(int Lp) {
  return (static_cast<size_t>(kRows) * (CRS + XRS) + 4u * Lp + kScanFloats) * sizeof(float);
}

// (a) contrib^T (N, P) = B^T (x * w), w = exp(cum_last - cum) dt. Thread
// (tn, tp) owns state rows 4 tn + m and 64 + 4 tn + m (m < 4) x columns
// 4 tp .. 4 tp + 3.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_f32(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    float* __restrict__ states, float* __restrict__ decay, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                 // (64, CRS)
  float* Xs = Bs + kRows * CRS;     // (64, XRS)
  const Scan sc(Xs + kRows * XRS, d.Lp);
  float* w = sc.dt + d.Lp;          // (Lp,)

  const int tid = threadIdx.x, tp = tid & 15, tn = tid >> 4;
  const Tile t = decode(d, false);
  const Rows<float> R(x, Bm, Bm, dt, d, t);
  const int pw = min(kPT, d.P - t.pt * kPT);
  chunk_cumsum<kThreads>(sc, R.dt, d.H, A[t.h], d.L, d.Lp, tid);
  for (int l = tid; l < d.Lp; l += kThreads) w[l] = l < d.L ? expf(sc.seg(d.L - 1, l)) * sc.dt[l] : 0.f;
  if (t.pt == 0 && tid == 0) decay[static_cast<int64_t>(t.bh) * d.nc + t.c] = expf(sc.at(d.L - 1));

  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
  for (int l0 = 0; l0 < d.L; l0 += kRows) {
    const int nl = min(kRows, d.L - l0);
    __syncthreads();  // w is written; the previous tile is consumed
    load_tile<float, kRows, kNT, CRS, kThreads>(Bs, R.B + l0 * R.bs, R.bs, nl, d.N, tid);
    load_tile<float, kRows, kPT, XRS, kThreads>(Xs, R.x + l0 * R.xs, R.xs, nl, pw, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const int lend = (nl + 3) & ~3;
#pragma unroll 4
    for (int l = 0; l < lend; ++l) {
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + l * CRS + 4 * tn);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + l * CRS + 64 + 4 * tn);
      float4 xv = *reinterpret_cast<const float4*>(Xs + l * XRS + 4 * tp);
      const float wl = w[l0 + l];
      xv = make_float4(xv.x * wl, xv.y * wl, xv.z * wl, xv.w * wl);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float bv = lane4(m < 4 ? b0 : b1, m & 3);
        acc[m][0] = fmaf(bv, xv.x, acc[m][0]);
        acc[m][1] = fmaf(bv, xv.y, acc[m][1]);
        acc[m][2] = fmaf(bv, xv.z, acc[m][2]);
        acc[m][3] = fmaf(bv, xv.w, acc[m][3]);
      }
    }
  }
  if (4 * tp >= pw) return;
  float* out = states + state_offset(d, t) + 4 * tp;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int n = (m < 4 ? 0 : 64) + 4 * tn + (m & 3);
    if (n < d.N)
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(n) * d.P) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
}

size_t scan_smem(int Lp) {
  const size_t region = static_cast<size_t>(kRows) * (CRS + XRS) > static_cast<size_t>(kNT) * XRS
                            ? static_cast<size_t>(kRows) * (CRS + XRS)
                            : static_cast<size_t>(kNT) * XRS;
  return (static_cast<size_t>(kRows) * CRS + region + static_cast<size_t>(kRows) * GRS +
          3u * Lp + kScanFloats) * sizeof(float);
}

// (c) y for 64 rows i of a chunk x 64 columns p. Thread (tr, tc) owns rows
// 4 tr + k (k < 4): columns tc + 16 l of the gate and 4 tc .. 4 tc + 3 of y.
// A warp's two row groups lie 4 rows apart, which puts its float4 reads of
// C and of the gate on disjoint banks.
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_scan_f32(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ states,
                   float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                 // (64, CRS): C of the row tile
  float* Ps = Cs + kRows * CRS;     // (kNT, XRS): prev^T; then B (64, CRS) and x (64, XRS)
  float* Bs = Ps;
  float* Xs = Bs + kRows * CRS;
  float* Gs = Ps + (kRows * (CRS + XRS) > kNT * XRS ? kRows * (CRS + XRS) : kNT * XRS);
  const Scan sc(Gs + kRows * GRS, d.Lp);

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15, warp = tid >> 5;
  const Tile t = decode(d, true);
  const Rows<float> R(x, Bm, Cm, dt, d, t);
  const int i0 = t.rt * kRows;
  const int pw = min(kPT, d.P - t.pt * kPT);
  load_tile<float, kRows, kNT, CRS, kThreads>(Cs, R.C + i0 * R.bs, R.bs, d.L - i0, d.N, tid);
  if (t.c > 0)
    load_tile<float, kNT, kPT, XRS, kThreads>(Ps, states + state_offset(d, t), d.P, d.N, pw, tid);
  cp_async_commit();
  chunk_cumsum<kThreads>(sc, R.dt, d.H, A[t.h], d.L, d.Lp, tid);
  cp_async_wait_all();
  __syncthreads();

  float yacc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) yacc[k][0] = yacc[k][1] = yacc[k][2] = yacc[k][3] = 0.f;
  if (t.c > 0) {  // exp(cum_i) C_i prev^T
#pragma unroll 1
    for (int n = 0; n < d.N; n += 4) {
      float4 cv[4], pv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cv[k] = *reinterpret_cast<const float4*>(Cs + (4 * tr + k) * CRS + n);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        pv[m] = *reinterpret_cast<const float4*>(Ps + (n + m) * XRS + 4 * tc);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float c = lane4(cv[k], m);
          yacc[k][0] = fmaf(c, pv[m].x, yacc[k][0]);
          yacc[k][1] = fmaf(c, pv[m].y, yacc[k][1]);
          yacc[k][2] = fmaf(c, pv[m].z, yacc[k][2]);
          yacc[k][3] = fmaf(c, pv[m].w, yacc[k][3]);
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float e = expf(sc.at(i0 + 4 * tr + k));
      yacc[k][0] *= e;
      yacc[k][1] *= e;
      yacc[k][2] *= e;
      yacc[k][3] *= e;
    }
  }

  for (int jt = 0; jt <= t.rt; ++jt) {
    const int j0 = jt * kRows;
    const int nj = min(kRows, d.L - j0);
    __syncthreads();  // prev^T, or the previous B, x and gate, are consumed
    load_tile<float, kRows, kNT, CRS, kThreads>(Bs, R.B + j0 * R.bs, R.bs, nj, d.N, tid);
    load_tile<float, kRows, kPT, XRS, kThreads>(Xs, R.x + j0 * R.xs, R.xs, nj, pw, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // in the diagonal tile, warp w (rows 8 w .. 8 w + 7) needs the columns
    // j <= 8 w + 7 only: the first lmax of its column groups tc + 16 l, and
    // the first 8 w + 8 terms of gate x
    const bool diag = jt == t.rt;
    const int lmax = diag ? ((8 * warp + 7) >> 4) + 1 : 4;
    const int jend = diag ? min((nj + 3) & ~3, 8 * warp + 8) : (nj + 3) & ~3;

    // s = C B^T over the 4 x 4 micro-tile
    float s[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k][0] = s[k][1] = s[k][2] = s[k][3] = 0.f;
#pragma unroll 1
    for (int n = 0; n < d.N; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cv[k] = *reinterpret_cast<const float4*>(Cs + (4 * tr + k) * CRS + n);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (l < lmax) bv[l] = *reinterpret_cast<const float4*>(Bs + (tc + 16 * l) * CRS + n);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (l >= lmax) continue;
          float a = s[k][l];
          a = fmaf(cv[k].x, bv[l].x, a);
          a = fmaf(cv[k].y, bv[l].y, a);
          a = fmaf(cv[k].z, bv[l].z, a);
          a = fmaf(cv[k].w, bv[l].w, a);
          s[k][l] = a;
        }
    }
    // gate = s exp(cum_i - cum_j) dt_j for j <= i, else 0
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + 4 * tr + k;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int j = j0 + tc + 16 * l;
        if (l < lmax) Gs[(4 * tr + k) * GRS + tc + 16 * l] =
            j <= i ? s[k][l] * expf(sc.seg(i, j)) * sc.dt[j] : 0.f;
      }
    }
    __syncthreads();

    // y += gate x
#pragma unroll 1
    for (int j = 0; j < jend; j += 4) {
      float4 gv[4], xv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        gv[k] = *reinterpret_cast<const float4*>(Gs + (4 * tr + k) * GRS + j);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        xv[m] = *reinterpret_cast<const float4*>(Xs + (j + m) * XRS + 4 * tc);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float g = lane4(gv[k], m);
          yacc[k][0] = fmaf(g, xv[m].x, yacc[k][0]);
          yacc[k][1] = fmaf(g, xv[m].y, yacc[k][1]);
          yacc[k][2] = fmaf(g, xv[m].z, yacc[k][2]);
          yacc[k][3] = fmaf(g, xv[m].w, yacc[k][3]);
        }
    }
  }

  if (4 * tc >= pw) return;
  float* yb = y + (R.x - x) + 4 * tc;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + 4 * tr + k;
    if (i < d.L)
      *reinterpret_cast<float4*>(yb + i * R.xs) =
          make_float4(yacc[k][0], yacc[k][1], yacc[k][2], yacc[k][3]);
  }
}

}  // namespace fm

// ---------------------------------------------------- bf16: tensor cores --
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int CRS = kNT + 8;  // C and B rows (bf16, +16 B: ldmatrix rows on distinct banks)
constexpr int XRS = kPT + 8;  // x and state rows

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// byte offset of this lane's ldmatrix.trans row for a row-major (k, n) tile
// read as the col-major B operand of two n-blocks: rows k 0-15, columns 0-15
__device__ __forceinline__ uint32_t trans_b_off(int lane, int rs) {
  return (((lane & 7) + ((lane >> 3) & 1) * 8) * rs + (lane >> 4) * 8) * 2;
}

constexpr int kStateThreads = 256;  // 8 warps x 16 state rows n
constexpr int kScanThreads = 128;   // 4 warps x 16 rows i

size_t state_smem(int Lp) {
  return static_cast<size_t>(kRows) * (CRS + XRS) * sizeof(bf16) +
         (4u * Lp + kScanFloats) * sizeof(float);
}

// (a) contrib^T (N, P) = B^T bf16(x * w) on the tensor cores: M = n, N = p,
// K = l. B (l, n) row-major is the A operand through ldmatrix.trans.
__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     float* __restrict__ states, float* __restrict__ decay, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);  // (64, CRS)
  bf16* Xs = Bs + kRows * CRS;                   // (64, XRS)
  const Scan sc(reinterpret_cast<float*>(Xs + kRows * XRS), d.Lp);
  float* w = sc.dt + d.Lp;                       // (Lp,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile t = decode(d, false);
  const Rows<bf16> R(x, Bm, Bm, dt, d, t);
  const int pw = min(kPT, d.P - t.pt * kPT);
  chunk_cumsum<kStateThreads>(sc, R.dt, d.H, A[t.h], d.L, d.Lp, tid);
  for (int l = tid; l < d.Lp; l += kStateThreads)
    w[l] = l < d.L ? expf(sc.seg(d.L - 1, l)) * sc.dt[l] : 0.f;
  if (t.pt == 0 && tid == 0) decay[static_cast<int64_t>(t.bh) * d.nc + t.c] = expf(sc.at(d.L - 1));

  const bool active = warp * 16 < d.N;
  // A: rows k = l (0-15 with the k halves in lanes 16-31), columns m = n
  const uint32_t a_addr =
      smem_addr(Bs + ((lane & 7) + ((lane >> 4) << 3)) * CRS + warp * 16 + ((lane >> 3) & 1) * 8);
  const uint32_t x_addr = smem_addr(Xs) + trans_b_off(lane, XRS);
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int l0 = 0; l0 < d.L; l0 += kRows) {
    const int nl = min(kRows, d.L - l0);
    __syncthreads();  // w is written; the previous tile is consumed
    load_tile<bf16, kRows, kNT, CRS, kStateThreads>(Bs, R.B + l0 * R.bs, R.bs, nl, d.N, tid);
    load_tile<bf16, kRows, kPT, XRS, kStateThreads>(Xs, R.x + l0 * R.xs, R.xs, nl, pw, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    // x w, rounded to bf16 in place
#pragma unroll 1
    for (int e = tid; e < kRows * kPT / 2; e += kStateThreads) {
      const int r = e / (kPT / 2), q = (e % (kPT / 2)) * 2;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(Xs + r * XRS + q);
      const float2 f = __bfloat1622float2(*p);
      const float wl = w[l0 + r];
      *p = __floats2bfloat162_rn(f.x * wl, f.y * wl);
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_trans(a, a_addr + kk * 16 * CRS * 2);
#pragma unroll
      for (int n2 = 0; n2 < kPT / 16; ++n2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, x_addr + kk * 16 * XRS * 2 + n2 * 32);
        mma_bf16(acc[2 * n2], a, bf[0], bf[1]);
        mma_bf16(acc[2 * n2 + 1], a, bf[2], bf[3]);
      }
    }
  }
  if (!active) return;
  const int n0 = warp * 16 + (lane >> 2), n1 = n0 + 8;
  float* out = states + state_offset(d, t);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int p = nb * 8 + (lane & 3) * 2;
    if (p >= pw) continue;
    if (n0 < d.N)
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(n0) * d.P + p) =
          make_float2(acc[nb][0], acc[nb][1]);
    if (n1 < d.N)
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(n1) * d.P + p) =
          make_float2(acc[nb][2], acc[nb][3]);
  }
}

size_t scan_smem(int Lp) {
  const size_t region = static_cast<size_t>(kRows) * (CRS + XRS) > static_cast<size_t>(kNT) * XRS
                            ? static_cast<size_t>(kRows) * (CRS + XRS)
                            : static_cast<size_t>(kNT) * XRS;
  return (static_cast<size_t>(kRows) * CRS + region) * sizeof(bf16) +
         (3u * Lp + kScanFloats) * sizeof(float);
}

// (c) y for 64 rows i of a chunk x 64 columns p; warp w owns rows 16 w ..
// 16 w + 15. S = C B^T, the gate and y stay in registers.
__global__ void __launch_bounds__(kScanThreads)
ssd_chunk_scan_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const float* __restrict__ states,
                    bf16* __restrict__ y, Dims d) {
  constexpr int kRegion = kRows * (CRS + XRS) > kNT * XRS ? kRows * (CRS + XRS) : kNT * XRS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // (64, CRS)
  bf16* Ps = Cs + kRows * CRS;                   // (kNT, XRS): bf16(prev^T); then B and x
  bf16* Bs = Ps;                                 // (64, CRS)
  bf16* Xs = Bs + kRows * CRS;                   // (64, XRS)
  const Scan sc(reinterpret_cast<float*>(Ps + kRegion), d.Lp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile t = decode(d, true);
  const Rows<bf16> R(x, Bm, Cm, dt, d, t);
  const int i0 = t.rt * kRows;
  const int pw = min(kPT, d.P - t.pt * kPT);
  load_tile<bf16, kRows, kNT, CRS, kScanThreads>(Cs, R.C + i0 * R.bs, R.bs, d.L - i0, d.N, tid);
  cp_async_commit();
  if (t.c > 0) {  // prev^T (N, P) f32 -> bf16, zero-padded to (kNT, kPT)
    const float* st = states + state_offset(d, t);
    for (int e = tid; e < kNT * kPT / 4; e += kScanThreads) {
      const int n = e / (kPT / 4), q = (e % (kPT / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < d.N && q < pw) v = *reinterpret_cast<const float4*>(st + static_cast<int64_t>(n) * d.P + q);
      uint32_t* p = reinterpret_cast<uint32_t*>(Ps + n * XRS + q);
      p[0] = pack_bf16(v.x, v.y);
      p[1] = pack_bf16(v.z, v.w);
    }
  }
  chunk_cumsum<kScanThreads>(sc, R.dt, d.H, A[t.h], d.L, d.Lp, tid);
  cp_async_wait_all();
  __syncthreads();

  const int kn = (d.N + 15) / 16;  // 16-wide k-steps over the state dim
  const int r0 = i0 + warp * 16 + (lane >> 2), r1 = r0 + 8;  // this lane's rows
  const uint32_t c_addr = smem_addr(Cs + (warp * 16 + (lane & 15)) * CRS + (lane >> 4) * 8);
  // B (j, n) as the col-major B operand of C B^T: two n-blocks of 8 rows j x two k halves
  const uint32_t b_addr =
      smem_addr(Bs + ((lane & 7) + ((lane >> 4) << 3)) * CRS + ((lane >> 3) & 1) * 8);
  const uint32_t p_addr = smem_addr(Ps) + trans_b_off(lane, XRS);
  const uint32_t x_addr = smem_addr(Xs) + trans_b_off(lane, XRS);

  float yacc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;
  if (t.c > 0) {  // exp(cum_i) C_i bf16(prev)^T
    for (int kk = 0; kk < kn; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, c_addr + kk * 32);
#pragma unroll
      for (int n2 = 0; n2 < kPT / 16; ++n2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, p_addr + kk * 16 * XRS * 2 + n2 * 32);
        mma_bf16(yacc[2 * n2], a, bf[0], bf[1]);
        mma_bf16(yacc[2 * n2 + 1], a, bf[2], bf[3]);
      }
    }
    const float e0 = expf(sc.at(r0)), e1 = expf(sc.at(r1));
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      yacc[n][0] *= e0;
      yacc[n][1] *= e0;
      yacc[n][2] *= e1;
      yacc[n][3] *= e1;
    }
  }

  for (int jt = 0; jt <= t.rt; ++jt) {
    const int j0 = jt * kRows;
    const int nj = min(kRows, d.L - j0);
    __syncthreads();  // prev^T, or the previous B and x, are consumed
    load_tile<bf16, kRows, kNT, CRS, kScanThreads>(Bs, R.B + j0 * R.bs, R.bs, nj, d.N, tid);
    load_tile<bf16, kRows, kPT, XRS, kScanThreads>(Xs, R.x + j0 * R.xs, R.xs, nj, pw, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    // in the diagonal tile, 16-column groups above the warp's rows are all zero
    const int groups = jt == t.rt ? warp + 1 : kRows / 16;

    float sacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
    for (int kk = 0; kk < kn; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, c_addr + kk * 32);
#pragma unroll
      for (int n2 = 0; n2 < kRows / 16; ++n2) {
        if (n2 >= groups) break;
        uint32_t bf[4];
        ldsm_x4(bf, b_addr + n2 * 16 * CRS * 2 + kk * 32);
        mma_bf16(sacc[2 * n2], a, bf[0], bf[1]);
        mma_bf16(sacc[2 * n2 + 1], a, bf[2], bf[3]);
      }
    }
    // gate = s exp(cum_i - cum_j) dt_j for j <= i, else 0, in place
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + n * 8 + (lane & 3) * 2 + e;
        const float dj = sc.dt[j];
        sacc[n][e] = j <= r0 ? sacc[n][e] * expf(sc.seg(r0, j)) * dj : 0.f;
        sacc[n][2 + e] = j <= r1 ? sacc[n][2 + e] * expf(sc.seg(r1, j)) * dj : 0.f;
      }
    // y += bf16(gate) x: the gate's accumulator layout is the A operand
#pragma unroll
    for (int kt = 0; kt < kRows / 16; ++kt) {
      if (kt >= groups) break;
      const uint32_t a[4] = {pack_bf16(sacc[2 * kt][0], sacc[2 * kt][1]),
                             pack_bf16(sacc[2 * kt][2], sacc[2 * kt][3]),
                             pack_bf16(sacc[2 * kt + 1][0], sacc[2 * kt + 1][1]),
                             pack_bf16(sacc[2 * kt + 1][2], sacc[2 * kt + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < kPT / 16; ++n2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, x_addr + kt * 16 * XRS * 2 + n2 * 32);
        mma_bf16(yacc[2 * n2], a, bf[0], bf[1]);
        mma_bf16(yacc[2 * n2 + 1], a, bf[2], bf[3]);
      }
    }
  }

  bf16* yb = y + (R.x - x);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int p = n * 8 + (lane & 3) * 2;
    if (p >= pw) continue;
    if (r0 < d.L)
      *reinterpret_cast<uint32_t*>(yb + r0 * R.xs + p) = pack_bf16(yacc[n][0], yacc[n][1]);
    if (r1 < d.L)
      *reinterpret_cast<uint32_t*>(yb + r1 * R.xs + p) = pack_bf16(yacc[n][2], yacc[n][3]);
  }
}

}  // namespace tc

// ------------------------------------------------------------------ launch --
template <typename Kernel>
cudaError_t allow_smem(Kernel k) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

// the five kernel functions, in the order ssd_smem_limits reports them
cudaError_t allow_all() {
  cudaError_t e;
  if ((e = allow_smem(fm::ssd_chunk_state_f32)) != cudaSuccess) return e;
  if ((e = allow_smem(tc::ssd_chunk_state_bf16)) != cudaSuccess) return e;
  if ((e = allow_smem(ssd_state_passing)) != cudaSuccess) return e;
  if ((e = allow_smem(fm::ssd_chunk_scan_f32)) != cudaSuccess) return e;
  return allow_smem(tc::ssd_chunk_scan_bf16);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// x, y (B, S, H, P) and Bm, Cm (B, S, G, N) contiguous in dtype (0 = float32,
// 1 = bfloat16); dt (B, S, H) and A (H,) float32. states is a float32
// workspace of B H (S / L) N P elements and decay one of B H (S / L). L is
// the chunk length: at most 64 or a multiple of 64. P and N are multiples of
// 8, N is at most 128, and every pointer is 16-byte aligned; other shapes are
// refused with cudaErrorInvalidValue (or cudaErrorMisalignedAddress).
extern "C" int ssd_forward(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, void* y, void* states, void* decay, int Bsz, int S,
                           int H, int P, int G, int N, int L, int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || L <= 0 || H % G != 0 ||
      S % L != 0 || (L > kRows && L % kRows != 0) || P % 8 != 0 || N % 8 != 0 || N > kNT ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {x, dt, A, Bm, Cm, static_cast<const void*>(y),
                        static_cast<const void*>(states), static_cast<const void*>(decay)})
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  Dims d{S, H, P, G, N, L, S / L, (P + kPT - 1) / kPT, (L + kRows - 1) / kRows, Bsz * H,
         L > kRows ? L : kRows};
  const int64_t blocks_a = static_cast<int64_t>(d.BH) * d.nc * d.ptiles;
  const int np4 = N * P / 4, per_bh = (np4 + 255) / 256;
  const size_t smem_a = dtype == 0 ? fm::state_smem(d.Lp) : tc::state_smem(d.Lp);
  const size_t smem_c = dtype == 0 ? fm::scan_smem(d.Lp) : tc::scan_smem(d.Lp);
  if (blocks_a * d.rtiles > 0x7fffffff || static_cast<int64_t>(d.BH) * per_bh > 0x7fffffff ||
      smem_a > static_cast<size_t>(kMaxSmem) || smem_c > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_all();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(states);
  float* dk = static_cast<float*>(decay);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const unsigned ga = static_cast<unsigned>(blocks_a);
  const unsigned gc = static_cast<unsigned>(blocks_a * d.rtiles);
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* Bf = static_cast<const float*>(Bm);
    fm::ssd_chunk_state_f32<<<ga, fm::kThreads, smem_a, s>>>(xf, dtf, Af, Bf, st, dk, d);
  } else {
    using tc::bf16;
    tc::ssd_chunk_state_bf16<<<ga, tc::kStateThreads, smem_a, s>>>(
        static_cast<const bf16*>(x), dtf, Af, static_cast<const bf16*>(Bm), st, dk, d);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ssd_state_passing<<<static_cast<unsigned>(d.BH * per_bh), 256, 0, s>>>(st, dk, d.nc, np4,
                                                                         per_bh);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (dtype == 0) {
    fm::ssd_chunk_scan_f32<<<gc, fm::kThreads, smem_c, s>>>(
        static_cast<const float*>(x), dtf, Af, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), st, static_cast<float*>(y), d);
  } else {
    using tc::bf16;
    tc::ssd_chunk_scan_bf16<<<gc, tc::kScanThreads, smem_c, s>>>(
        static_cast<const bf16*>(x), dtf, Af, static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), st, static_cast<bf16*>(y), d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The largest dynamic shared memory each kernel function may use, in the
// order chunk state f32, chunk state bf16, state passing, chunk scan f32,
// chunk scan bf16 (out holds 5 ints). Sets the 227 KB opt-in first, as
// ssd_forward does.
extern "C" int ssd_smem_limits(int* out) {
  cudaError_t e = allow_all();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes a;
  const void* fns[5] = {reinterpret_cast<const void*>(fm::ssd_chunk_state_f32),
                        reinterpret_cast<const void*>(tc::ssd_chunk_state_bf16),
                        reinterpret_cast<const void*>(ssd_state_passing),
                        reinterpret_cast<const void*>(fm::ssd_chunk_scan_f32),
                        reinterpret_cast<const void*>(tc::ssd_chunk_scan_bf16)};
  for (int i = 0; i < 5; ++i) {
    if ((e = cudaFuncGetAttributes(&a, fns[i])) != cudaSuccess) return static_cast<int>(e);
    out[i] = a.maxDynamicSharedSizeBytes;
  }
  return 0;
}
