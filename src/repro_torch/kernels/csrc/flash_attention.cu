// Flash attention forward (tiled online softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:26
// (_flash_kernel), its core wrapper flash_attention (:79) and the GQA
// wrapper ops.flash_attention (src/repro/kernels/ops.py:26). For each query
// row it computes softmax(scale * q k^T) v over the kv rows with the running
// max m, denominator l and accumulator in f32:
//   s = scale * q.k;  causal: s = -1e30 where col > row (absolute positions)
//   m' = max(m, max_j s);  p = exp(s - m');  c = exp(m - m')
//   l = l c + sum_j p;  acc = acc c + p v;  out = acc / max(l, 1e-30)
// in the exp2 form: s is scaled by scale * log2(e) once, and exp2f takes the
// differences. kv tiles that lie wholly above the diagonal are skipped, as on
// the TPU.
//
// Bound on the H100: 4 S T D operations per (batch, head) (half of it when
// causal) against 2 (S + T) D elements moved, so at gemma-2b's geometry
// (S = T = 2048, D = 256) it is compute-bound in both types: 68.7 GFLOP for
// the causal call at batch 4 x 8 heads, 0.069 ms at the bf16 tensor cores'
// 989 TFLOP/s and 1.03 ms at the 67 TFLOP/s of FP32 FMA (the f32 bound of
// 2e-5 rules out TF32).
//
// bf16 path (tensor cores): one CTA of 8 warps per 128 query rows of one
// (batch, q head), 16 rows per warp. Q stays in shared memory for the whole
// CTA; K and V pass through a two-stage ring of 64-row tiles filled by
// 16-byte cp.async copies (zero-filled past T), so the next tile loads while
// this one computes. Rows are padded by 16 bytes, which puts the 8 rows of
// every ldmatrix on distinct banks (198 KB at D 256). S = Q K^T runs as
// mma.sync m16n8k16 bf16 x bf16 -> f32 with ldmatrix operands and stays in
// registers; the row max and sum take the two quad shuffles of the m16n8
// layout. P is rounded to bf16 in registers and used directly as the A
// operand of P V (the m16n8 accumulator layout is the m16n8k16 A layout),
// with V through ldmatrix.trans; the denominator sums the f32 P. Rounding P
// to bf16 is the one arithmetic difference from the reference's f32 P. The
// O accumulator lives in registers (16 x D f32 per warp: 128 a thread at
// D 256). A warp skips a kv tile wholly above its own 16 rows, and masks
// only tiles that cross the diagonal or the ragged edge.
//
// f32 path (register-tiled FP32 FMA): one CTA of 256 threads per 64 query
// rows, kv tiles of 32 rows double-buffered by cp.async. Shared memory feeds
// an SM's registers 128 B a clock against its 128 FMA a clock, so every
// float read from it must serve 4 FMA or more. A warp owns 8 query rows x the
// 32 kv columns of a tile as four 8 x 8 micro-tiles of S; the 8 lanes of a
// micro-tile each sum one eighth of D from float4 reads (4 FMA a float), and
// a three-step shuffle transpose-reduce leaves each lane one whole row of 8
// scores, whose softmax runs in registers (the row's max and sum over its
// four lanes by two shuffles). P goes through shared memory (transposed, so
// a float4 read serves four rows) to the threads that own O: each owns up
// to 8 rows x 8 columns of O in registers (D / 4 values a thread).
//
// Both paths read kv head h / (Nq/Nkv) in place instead of repeating kv to
// Nq heads, mask ragged S and T, issue the query tiles last-first (the long
// causal rows of every head start first), and launch on the caller's stream.
// Each output row is computed by one CTA in a fixed order: no atomics, so
// the result is deterministic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, s, h;  // elements between batches, positions and heads
};

// ---------------------------------------------------------------- helpers --
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_size 0 writes zeros (rows past the end)
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

// rows [row0, row0 + NR) of a (rows, D) tile into shared memory with row
// stride RS elements; rows at or past `nrows` are zero-filled
template <typename T, int D, int RS, int NR>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t row_stride, int row0,
                                          int nrows, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;  // 16-byte chunks per row
  constexpr int kTotal = NR * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + kThreads - 1) / kThreads; ++i) {
    const int e = tid + i * kThreads;
    if (kTotal % kThreads != 0 && e >= kTotal) break;
    const int r = e / kChunks, c = e % kChunks;
    const bool in = row0 + r < nrows;
    const T* g = src + (in ? static_cast<int64_t>(row0 + r) * row_stride : 0) + c * kVec;
    cp_async16(dst + r * RS + c * kVec, g, in);
  }
}

// the number of kv tiles a query tile [q0, q0 + BQ) needs
__device__ __forceinline__ int kv_tiles(int q0, int BQ, int BK, int S, int Tk, int causal) {
  const int all = (Tk + BK - 1) / BK;
  if (!causal) return all;
  const int last_row = min(q0 + BQ, S) - 1;
  return min(all, last_row / BK + 1);
}

// ---------------------------------------------------- bf16: tensor cores --
namespace tc {

constexpr int BQ = 128, BK = 64;

template <int D>
struct Cfg {
  static constexpr int RS = D + 8;  // padded row, bf16 elements (+16 B)
  static constexpr size_t kSmem = static_cast<size_t>(BQ + 4 * BK) * RS * 2;
};

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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Nq, int rep,
           int S, int Tk, Strides qs, Strides ks, float sl2, int causal) {
  constexpr int RS = Cfg<D>::RS;
  constexpr int NB = BK / 8;  // n-blocks of S
  constexpr int ND = D / 8;   // n-blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = Qs + BQ * RS;  // stage st: K at ring + 2 st BK RS, V after it

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.x / Nq, hq = blockIdx.x % Nq, hk = hq / rep;
  const __nv_bfloat16* qb = q + b * qs.b + hq * qs.h;
  __nv_bfloat16* ob = o + b * qs.b + hq * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * ks.b + hk * ks.h;
  const int n_tiles = kv_tiles(q0, BQ, BK, S, Tk, causal);

  load_tile<__nv_bfloat16, D, RS, BQ>(Qs, qb, qs.s, q0, S, tid);
  load_tile<__nv_bfloat16, D, RS, BK>(ring, kb, ks.s, 0, Tk, tid);
  load_tile<__nv_bfloat16, D, RS, BK>(ring + BK * RS, vb, ks.s, 0, Tk, tid);
  cp_async_commit();

  // per-lane ldmatrix offsets (bytes): Q as A (rows 0-15, k halves), K as B
  // (two n-blocks of 8 kv rows x two k halves), V as B through .trans (two
  // k halves of 8 kv rows x two n-blocks of 8 columns)
  const uint32_t q_addr =
      smem_addr(Qs + (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 8);
  const uint32_t k_off = ((lane & 7) + ((lane >> 4) << 3)) * RS * 2 + ((lane >> 3) & 1) * 16;
  const uint32_t v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * RS * 2 + (lane >> 4) * 16;
  const uint32_t ring_addr = smem_addr(ring);

  const int wrow0 = q0 + warp * 16;          // the warp's first row
  const int r0 = wrow0 + (lane >> 2), r1 = r0 + 8;  // this lane's two rows
  const int ccol = (lane & 3) * 2;            // this lane's column pair in an n-block

  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this lane's partial sums

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * BK;
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (it + 1 < n_tiles) {
      __nv_bfloat16* st = ring + ((it + 1) & 1) * 2 * BK * RS;
      load_tile<__nv_bfloat16, D, RS, BK>(st, kb, ks.s, j0 + BK, Tk, tid);
      load_tile<__nv_bfloat16, D, RS, BK>(st + BK * RS, vb, ks.s, j0 + BK, Tk, tid);
      cp_async_commit();
    }
    if (wrow0 >= S || (causal && j0 > wrow0 + 15)) continue;  // nothing for this warp
    const uint32_t k_addr = ring_addr + (it & 1) * 2 * BK * RS * 2 + k_off;
    const uint32_t v_addr = ring_addr + ((it & 1) * 2 + 1) * BK * RS * 2 + v_off;

    // S = Q K^T (16 x BK per warp)
    float sacc[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4(bf, k_addr + n2 * 16 * RS * 2 + kk * 32);
        mma_bf16(sacc[2 * n2], a, bf[0], bf[1]);
        mma_bf16(sacc[2 * n2 + 1], a, bf[2], bf[3]);
      }
    }

    // scale (log2 units), mask, online softmax over the two rows
    const bool masked = (causal && j0 + BK - 1 > wrow0) || j0 + BK > Tk;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s0 = sacc[n][e] * sl2, s1 = sacc[n][2 + e] * sl2;
        if (masked) {
          const int col = j0 + n * 8 + ccol + e;
          if (col >= Tk) {
            s0 = s1 = -INFINITY;  // padding: no weight at all
          } else if (causal) {
            if (col > r0) s0 = kNegInf;
            if (col > r1) s1 = kNegInf;
          }
        }
        sacc[n][e] = s0;
        sacc[n][2 + e] = s1;
        mx0 = fmaxf(mx0, s0);
        mx1 = fmaxf(mx1, s1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sacc[n][e] = exp2f(sacc[n][e] - mn0);
        sacc[n][2 + e] = exp2f(sacc[n][2 + e] - mn1);
        ps0 += sacc[n][e];
        ps1 += sacc[n][2 + e];
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= c0;
      oacc[n][1] *= c0;
      oacc[n][2] *= c1;
      oacc[n][3] *= c1;
    }

    // O += P V, P rounded to bf16 in registers as the A operand
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t a[4] = {pack_bf16(sacc[2 * t][0], sacc[2 * t][1]),
                             pack_bf16(sacc[2 * t][2], sacc[2 * t][3]),
                             pack_bf16(sacc[2 * t + 1][0], sacc[2 * t + 1][1]),
                             pack_bf16(sacc[2 * t + 1][2], sacc[2 * t + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < ND / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, v_addr + t * 16 * RS * 2 + n2 * 32);
        mma_bf16(oacc[2 * n2], a, bf[0], bf[1]);
        mma_bf16(oacc[2 * n2 + 1], a, bf[2], bf[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + ccol;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * qs.s + col) =
          pack_bf16(oacc[n][0] / d0, oacc[n][1] / d0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * qs.s + col) =
          pack_bf16(oacc[n][2] / d1, oacc[n][3] / d1);
  }
}

}  // namespace tc

// ------------------------------------------- f32: register-tiled FP32 FMA --
namespace fm {

constexpr int BQ = 64, BK = 32, PS = BQ + 4;  // PS: row stride of P^T (floats)

template <int D>
struct Cfg {
  static constexpr int RS = D + 4;                  // padded row, floats (+16 B)
  static constexpr int TC = D / 4 < 32 ? D / 4 : 32;  // threads across O's columns
  static constexpr int NC = D / (4 * TC);           // float4 columns a thread owns
  static constexpr int OR = BQ / (kThreads / TC);   // O rows a thread owns
  static constexpr size_t kSmem =
      (static_cast<size_t>(BQ + 4 * BK) * RS + BK * PS + 2 * BQ) * sizeof(float);
};

// One step of a transpose-reduce over the lanes that differ in bit MASK: of
// the 2H partial sums a lane holds, it keeps one half (the upper one if
// `upper`) and adds the partner's copy of that half, so the partners end
// with disjoint halves, each fully summed over the two lanes.
template <int H, int MASK>
__device__ __forceinline__ void fold(float* a, bool upper) {
#pragma unroll
  for (int e = 0; e < H; ++e) {
    const float send = upper ? a[e] : a[H + e];
    const float keep = upper ? a[H + e] : a[e];
    a[e] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, int Nq, int rep, int S, int Tk, Strides qs, Strides ks,
          float sl2, int causal) {
  constexpr int RS = Cfg<D>::RS, TC = Cfg<D>::TC, NC = Cfg<D>::NC, OR = Cfg<D>::OR;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // (BQ, RS)
  float* ring = Qs + BQ * RS;         // 2 stages of K (BK, RS) then V (BK, RS)
  float* Ps = ring + 4 * BK * RS;     // (BK, PS): P transposed
  float* corr = Ps + BK * PS;         // (BQ,) rescale of the tile
  float* lsum = corr + BQ;            // (BQ,) final denominators

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.x / Nq, hq = blockIdx.x % Nq, hk = hq / rep;
  const float* qb = q + b * qs.b + hq * qs.h;
  float* ob = o + b * qs.b + hq * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * ks.b + hk * ks.h;
  const int n_tiles = kv_tiles(q0, BQ, BK, S, Tk, causal);

  load_tile<float, D, RS, BQ>(Qs, qb, qs.s, q0, S, tid);
  load_tile<float, D, RS, BK>(ring, kb, ks.s, 0, Tk, tid);
  load_tile<float, D, RS, BK>(ring + BK * RS, vb, ks.s, 0, Tk, tid);
  cp_async_commit();

  // S: warp w owns query rows 8 w .. 8 w + 7 and all BK kv columns, as four
  // 8 x 8 micro-tiles (column group cg). The 8 lanes of a micro-tile (ds)
  // each sum one eighth of D (16-byte chunks ds, ds + 8, ...), so every
  // float read from shared memory feeds 4 FMA (one byte per FMA, what the
  // SM's 128 B/clock of shared-memory reads can feed its 128 FMA/clock); a
  // transpose-reduce then leaves lane ds with row ds of its micro-tile.
  const int cg = lane >> 3, ds = lane & 7;
  const int srow = warp * 8 + ds;  // the lane's S row (tile-local) after the reduce
  float m = kNegInf, l = 0.f;      // that row's max and denominator
  // O micro-tile: rows orow + i (i < OR), float4 columns oc + TC n (n < NC)
  const int orow = (tid / TC) * OR, oc = tid % TC;
  float4 oacc[OR][NC];
#pragma unroll
  for (int i = 0; i < OR; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) oacc[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * BK;
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; tile it - 1 and its P are done with
    if (it + 1 < n_tiles) {
      float* st = ring + ((it + 1) & 1) * 2 * BK * RS;
      load_tile<float, D, RS, BK>(st, kb, ks.s, j0 + BK, Tk, tid);
      load_tile<float, D, RS, BK>(st + BK * RS, vb, ks.s, j0 + BK, Tk, tid);
      cp_async_commit();
    }
    const float* Ks = ring + (it & 1) * 2 * BK * RS;
    const float* Vs = Ks + BK * RS;

    // partial S over this lane's chunks of D
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
#pragma unroll 2
    for (int cc = 0; cc < D / 32; ++cc) {
      const int d4 = 4 * (ds + 8 * cc);
      float4 kv[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(Ks + (cg * 8 + jj) * RS + d4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (warp * 8 + i) * RS + d4);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float a = acc[i * 8 + jj];
          a = fmaf(qv.x, kv[jj].x, a);
          a = fmaf(qv.y, kv[jj].y, a);
          a = fmaf(qv.z, kv[jj].z, a);
          a = fmaf(qv.w, kv[jj].w, a);
          acc[i * 8 + jj] = a;
        }
      }
    }
    fold<32, 4>(acc, ds & 4);
    fold<16, 2>(acc, ds & 2);
    fold<8, 1>(acc, ds & 1);  // acc[0..7]: row srow, kv columns cg * 8 + 0..7

    // scale (log2 units), mask, online softmax over the row's four lanes
    const bool masked = (causal && j0 + BK - 1 > q0 + warp * 8) || j0 + BK > Tk;
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float s = acc[jj] * sl2;
      if (masked) {
        const int col = j0 + cg * 8 + jj;
        if (col >= Tk) s = -INFINITY;  // padding: no weight at all
        else if (causal && col > q0 + srow) s = kNegInf;
      }
      acc[jj] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float mn = fmaxf(m, mx);
    const float c = exp2f(m - mn);
    m = mn;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float p = exp2f(acc[jj] - mn);
      Ps[(cg * 8 + jj) * PS + srow] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    l = l * c + sum;
    if (cg == 0) corr[srow] = c;
    __syncthreads();

    // O = O c + P V
#pragma unroll
    for (int i = 0; i < OR; ++i) {
      const float ci = corr[orow + i];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        oacc[i][n].x *= ci;
        oacc[i][n].y *= ci;
        oacc[i][n].z *= ci;
        oacc[i][n].w *= ci;
      }
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[OR];
      if constexpr (OR % 4 == 0) {
#pragma unroll
        for (int i = 0; i < OR; i += 4) {
          const float4 t = *reinterpret_cast<const float4*>(Ps + j * PS + orow + i);
          p[i] = t.x;
          p[i + 1] = t.y;
          p[i + 2] = t.z;
          p[i + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < OR; ++i) p[i] = Ps[j * PS + orow + i];
      }
      float4 vv[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n)
        vv[n] = *reinterpret_cast<const float4*>(Vs + j * RS + 4 * (oc + TC * n));
#pragma unroll
      for (int i = 0; i < OR; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          oacc[i][n].x = fmaf(p[i], vv[n].x, oacc[i][n].x);
          oacc[i][n].y = fmaf(p[i], vv[n].y, oacc[i][n].y);
          oacc[i][n].z = fmaf(p[i], vv[n].z, oacc[i][n].z);
          oacc[i][n].w = fmaf(p[i], vv[n].w, oacc[i][n].w);
        }
    }
  }

  if (cg == 0) lsum[srow] = fmaxf(l, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < OR; ++i) {
    const int row = q0 + orow + i;
    if (row >= S) continue;
    const float d = lsum[orow + i];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float4 a = oacc[i][n];
      *reinterpret_cast<float4*>(ob + row * qs.s + 4 * (oc + TC * n)) =
          make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
    }
  }
}

}  // namespace fm

// ------------------------------------------------------------------ launch --
template <typename T, int D, typename Kernel>
int launch(Kernel kernel, size_t smem, int BQ, const void* q, const void* k, const void* v,
           void* o, int B, int Nq, int Nkv, int S, int Tk, Strides qs, Strides ks, float sl2,
           int causal, cudaStream_t s) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int q_tiles = (S + BQ - 1) / BQ;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // x: (batch, q head), y: query tiles (the kernel reverses y, so the last,
  // longest causal tiles of every head are issued first)
  const dim3 grid(static_cast<unsigned>(B * Nq), static_cast<unsigned>(q_tiles));
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(o), Nq, Nq / Nkv,
                                      S, Tk, qs, ks, sl2, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(int dtype, const void* q, const void* k, const void* v, void* o, int B, int Nq,
             int Nkv, int S, int Tk, Strides qs, Strides ks, float sl2, int causal,
             cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(fm::flash_f32<D>, fm::Cfg<D>::kSmem, fm::BQ, q, k, v, o, B, Nq, Nkv,
                            S, Tk, qs, ks, sl2, causal, s);
  return launch<__nv_bfloat16, D>(tc::flash_bf16<D>, tc::Cfg<D>::kSmem, tc::BQ, q, k, v, o, B,
                                  Nq, Nkv, S, Tk, qs, ks, sl2, causal, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// q and o (B, S, Nq, D) share strides q_s*; k and v (B, T, Nkv, D) share
// strides k_s*; the last axis is contiguous. dtype 0 = float32, 1 = bfloat16.
// Pointers must be 16-byte aligned and the strides of every axis longer than
// one a multiple of 16 bytes (the cp.async copies).
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       int B, int Nq, int Nkv, int S, int Tk, int D,
                                       int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                       int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                       float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || Nq <= 0 || Nkv <= 0 || Nq % Nkv != 0 || S <= 0 || Tk <= 0 ||
      (D != 32 && D != 64 && D != 128 && D != 256) || (dtype != 0 && dtype != 1) ||
      static_cast<int64_t>(B) * Nq > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t vec = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      (B > 1 && (q_sb % vec || k_sb % vec)) || (S > 1 && q_ss % vec) ||
      (Tk > 1 && k_ss % vec) || (Nq > 1 && q_sh % vec) || (Nkv > 1 && k_sh % vec))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh};
  const float sl2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dispatch<32>(dtype, q, k, v, o, B, Nq, Nkv, S, Tk, qs, ks, sl2, causal, s);
    case 64: return dispatch<64>(dtype, q, k, v, o, B, Nq, Nkv, S, Tk, qs, ks, sl2, causal, s);
    case 128: return dispatch<128>(dtype, q, k, v, o, B, Nq, Nkv, S, Tk, qs, ks, sl2, causal, s);
    default: return dispatch<256>(dtype, q, k, v, o, B, Nq, Nkv, S, Tk, qs, ks, sl2, causal, s);
  }
}
