// Flash attention forward (tiled online softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:26
// (_flash_kernel), its core wrapper flash_attention (:79) and the GQA
// wrapper ops.flash_attention (src/repro/kernels/ops.py:26). For each query
// row it computes softmax(scale * q k^T) v over the kv rows with the running
// max m, denominator l and accumulator in f32:
//   s = scale * q.k;  causal: s = -1e30 where col > row
//   m' = max(m, max_j s);  p = exp(s - m');  c = exp(m - m')
//   l = l c + sum_j p;  acc = acc c + p v;  out = acc / max(l, 1e-30)
// kv tiles that lie wholly above the diagonal are skipped, as on the TPU.
//
// Bound on the H100: 4 S T D operations per (batch, head) (half of it when
// causal) against 2 (S + T) D elements moved, so at gemma-2b's geometry
// (S = T = 2048, D = 256) it is compute-bound: about 68.7 GFLOP for the
// causal call at batch 4 x 8 heads. In f32 that is the 67 TFLOP/s FMA rate
// (the f32 bound of 2e-5 rules out TF32); in bf16 the tensor cores' rate.
//
// Design (simple first): one CTA of 256 threads per (batch, q head, tile of
// 64 query rows). Q, the accumulator and the current K and V tiles live in
// shared memory as f32 (bf16 inputs are widened on load); each product is
// one output element per thread-iteration. A warp reads one query row
// (broadcast) against 32 consecutive key rows whose shared-memory rows are
// padded by one float, so its lanes hit 32 banks. kv tiles are 64 rows for
// head dims up to 128 and 32 rows at 256, which keeps the block under the
// 227 KB of shared memory (205,696 B at D 256). GQA reads kv head
// h / (Nq/Nkv) in place instead of repeating kv to Nq heads. Query tiles
// are issued last-first so that the long causal rows start early. Ragged
// edges (S or T not a multiple of the tile) are masked. No tensor cores,
// no TMA: those are for a later redesign.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ __forceinline__ int block_k(int D) { return D <= 128 ? 64 : 32; }

size_t smem_bytes(int D) {
  const int BK = block_k(D);
  const size_t floats = static_cast<size_t>(kBlockQ) * D      // Q tile
                        + static_cast<size_t>(BK) * (D + 1)   // K tile (padded rows)
                        + static_cast<size_t>(BK) * D         // V tile
                        + static_cast<size_t>(kBlockQ) * D    // accumulator
                        + static_cast<size_t>(kBlockQ) * BK   // scores / probabilities
                        + 3u * kBlockQ;                       // m, l, correction
  return floats * sizeof(float);
}

struct Strides {
  int64_t b, s, h;  // elements between batches, positions and heads
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Nq, int rep, int S, int Tk, int D, Strides qs, Strides ks,
             float scale, int causal) {
  extern __shared__ float smem[];
  const int BK = block_k(D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int b = blockIdx.y / Nq, hq = blockIdx.y % Nq, hk = hq / rep;
  const int KP = D + 1;

  float* Qs = smem;                  // (BQ, D)
  float* Ks = Qs + kBlockQ * D;      // (BK, KP)
  float* Vs = Ks + BK * KP;          // (BK, D)
  float* Os = Vs + BK * D;           // (BQ, D)
  float* Ps = Os + kBlockQ * D;      // (BQ, BK)
  float* m = Ps + kBlockQ * BK;      // (BQ,)
  float* l = m + kBlockQ;            // (BQ,)
  float* corr = l + kBlockQ;         // (BQ,)

  const T* qb = q + b * qs.b + hq * qs.h;
  T* ob = o + b * qs.b + hq * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * ks.b + hk * ks.h;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int i = e / D, d = e % D;
    Qs[e] = q0 + i < S ? to_f32(qb[(q0 + i) * qs.s + d]) : 0.f;
    Os[e] = 0.f;
  }
  for (int i = tid; i < kBlockQ; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const int last_row = q0 + kBlockQ - 1;
  for (int j0 = 0; j0 < Tk && (!causal || j0 <= last_row); j0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = j0 + j < Tk;
      Ks[j * KP + d] = in ? to_f32(kb[(j0 + j) * ks.s + d]) : 0.f;
      Vs[e] = in ? to_f32(vb[(j0 + j) * ks.s + d]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kBlockQ * BK; e += kThreads) {
      const int i = e / BK, j = e % BK;
      const float* qr = Qs + i * D;
      const float* kr = Ks + j * KP;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += qr[d] * kr[d];
      float s = acc * scale;
      if (causal && j0 + j > q0 + i) s = kNegInf;
      if (j0 + j >= Tk) s = -INFINITY;  // padding: no weight at all
      Ps[e] = s;
    }
    __syncthreads();
    for (int i = warp; i < kBlockQ; i += kWarps) {
      float* pr = Ps + i * BK;
      float mx = kNegInf;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[i] = c;
        l[i] = l[i] * c + sum;
        m[i] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < kBlockQ * D; e += kThreads) {
      const int i = e / D, d = e % D;
      const float* pr = Ps + i * BK;
      float acc = 0.f;
      for (int j = 0; j < BK; ++j) acc += pr[j] * Vs[j * D + d];
      Os[e] = Os[e] * corr[i] + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int i = e / D, d = e % D;
    if (q0 + i < S) store(ob + (q0 + i) * qs.s + d, Os[e] / fmaxf(l[i], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Nq, int Nkv, int S,
           int Tk, int D, Strides qs, Strides ks, float scale, int causal, cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((S + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(B * Nq));
  flash_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Nq, Nq / Nkv, S, Tk, D, qs, ks, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q and o (B, S, Nq, D) share strides q_s*; k and v (B, T, Nkv, D) share
// strides k_s*; the last axis is contiguous. dtype 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       int B, int Nq, int Nkv, int S, int Tk, int D,
                                       int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                       int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                       float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || Nq <= 0 || Nkv <= 0 || Nq % Nkv != 0 || S <= 0 || Tk <= 0 ||
      (D != 32 && D != 64 && D != 128 && D != 256) || B * Nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, B, Nq, Nkv, S, Tk, D, qs, ks, scale, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Nq, Nkv, S, Tk, D, qs, ks, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
