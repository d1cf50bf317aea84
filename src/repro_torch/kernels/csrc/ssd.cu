// Mamba-2 chunked SSD (state-space duality) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py:24 (_ssd_kernel)
// and the body of its wrapper ssd (:77). For one (batch, head) pair it runs
// the chunks of the sequence in order, carrying the f32 state (P, N):
//   cum   = cumsum(dt * A)                                  (L,)
//   y     = ((C B^T) * Lmat * dt^T) x,  Lmat[i,j] = exp(cum_i - cum_j), j <= i
//   y    += exp(cum) * (C state^T)
//   state = exp(cum_last) * state + (x * exp(cum_last - cum) * dt)^T B
// Only y is written, in x's dtype; every product and sum is f32.
//
// Bound on the H100: per (batch, head, chunk) 2L^2 N + 2L^2 P + 4 L N P
// operations against (L P + 2 L N) input elements, so at the mamba2-370m
// shape (L 256, P 64, N 128) it is compute-bound (about 34 GFLOP against
// 0.14 GB per call at batch 4 x 2048).
//
// Design (simple first): one CTA of 256 threads per (batch, head), so the
// sequential chunk loop of the TPU grid becomes a loop inside the block and
// the state never leaves shared memory. At chunk 256 the f32 L x L gate and
// the L x N tiles of B and C do not fit a block's 227 KB, so the chunk is
// walked in row tiles of up to 64 (the queries i) against column tiles of up
// to 64 (the keys j <= i); each tile product is one output element per
// thread-iteration, reading shared memory whose rows are padded by one
// float so that a warp's 32 lanes hit 32 banks. B and C are read per group
// (head h uses group h / (H/G)), never repeated to H heads. expf, not
// __expf, and no fast-math: the plain version is held to 1e-4.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
           int S, int H, int P, int G, int N, int L) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / G);
  const int NP = N + 1;                 // padded row of B, C and the state
  const int TL = L < kTile ? L : kTile;  // tile edge within a chunk
  const int TP = TL + 1;                 // padded row of the gate tile

  float* st = smem;                 // state (P, NP)
  float* cR = st + P * NP;          // C rows of the current row tile (TL, NP)
  float* bC = cR + TL * NP;         // B rows of the current column tile (TL, NP)
  float* xC = bC + TL * NP;         // x rows of the current column tile (TL, P)
  float* gt = xC + TL * P;          // gate tile (TL, TP)
  float* ya = gt + TL * TP;         // y accumulator of the row tile (TL, P)
  float* cum = ya + TL * P;         // (L,)
  float* dts = cum + L;             // (L,)

  const int64_t xs = static_cast<int64_t>(H) * P;   // x / y row stride (one position)
  const int64_t bs = static_cast<int64_t>(G) * N;   // B / C row stride
  const T* xb = x + static_cast<int64_t>(b) * S * xs + static_cast<int64_t>(h) * P;
  T* yb = y + static_cast<int64_t>(b) * S * xs + static_cast<int64_t>(h) * P;
  const T* Bb = Bm + static_cast<int64_t>(b) * S * bs + static_cast<int64_t>(g) * N;
  const T* Cb = Cm + static_cast<int64_t>(b) * S * bs + static_cast<int64_t>(g) * N;
  const float* dtb = dt + static_cast<int64_t>(b) * S * H + h;
  const float a = A[h];

  for (int e = tid; e < P * N; e += kThreads) st[(e / N) * NP + e % N] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    for (int i = tid; i < L; i += kThreads) dts[i] = dtb[static_cast<int64_t>(c0 + i) * H];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run += dts[i] * a;
        cum[i] = run;
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < L; i0 += TL) {
      for (int e = tid; e < TL * N; e += kThreads) {
        const int i = e / N, n = e % N;
        cR[i * NP + n] = to_f32(Cb[static_cast<int64_t>(c0 + i0 + i) * bs + n]);
      }
      __syncthreads();
      // inter-chunk term: the state as it stood before this chunk
      for (int e = tid; e < TL * P; e += kThreads) {
        const int i = e / P, p = e % P;
        const float* cr = cR + i * NP;
        const float* sr = st + p * NP;
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc += cr[n] * sr[n];
        ya[e] = acc * expf(cum[i0 + i]);
      }
      // intra-chunk term over the column tiles at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += TL) {
        __syncthreads();
        for (int e = tid; e < TL * N; e += kThreads) {
          const int j = e / N, n = e % N;
          bC[j * NP + n] = to_f32(Bb[static_cast<int64_t>(c0 + j0 + j) * bs + n]);
        }
        for (int e = tid; e < TL * P; e += kThreads) {
          const int j = e / P, p = e % P;
          xC[e] = to_f32(xb[static_cast<int64_t>(c0 + j0 + j) * xs + p]);
        }
        __syncthreads();
        for (int e = tid; e < TL * TL; e += kThreads) {
          const int i = e / TL, j = e % TL;
          const int gi = i0 + i, gj = j0 + j;
          float v = 0.f;
          if (gj <= gi) {
            const float* cr = cR + i * NP;
            const float* br = bC + j * NP;
            float acc = 0.f;
            for (int n = 0; n < N; ++n) acc += cr[n] * br[n];
            v = acc * expf(cum[gi] - cum[gj]) * dts[gj];
          }
          gt[i * TP + j] = v;
        }
        __syncthreads();
        for (int e = tid; e < TL * P; e += kThreads) {
          const int i = e / P, p = e % P;
          const float* gr = gt + i * TP;
          float acc = 0.f;
          for (int j = 0; j < TL; ++j) acc += gr[j] * xC[j * P + p];
          ya[e] += acc;
        }
      }
      __syncthreads();
      for (int e = tid; e < TL * P; e += kThreads) {
        const int i = e / P, p = e % P;
        store(yb + static_cast<int64_t>(c0 + i0 + i) * xs + p, ya[e]);
      }
      __syncthreads();
    }

    // state update, after every row of the chunk has read the old state
    const float last = cum[L - 1];
    const float decay = expf(last);
    for (int e = tid; e < P * N; e += kThreads) st[(e / N) * NP + e % N] *= decay;
    for (int j0 = 0; j0 < L; j0 += TL) {
      __syncthreads();
      for (int e = tid; e < TL * N; e += kThreads) {
        const int j = e / N, n = e % N;
        bC[j * NP + n] = to_f32(Bb[static_cast<int64_t>(c0 + j0 + j) * bs + n]);
      }
      for (int e = tid; e < TL * P; e += kThreads) {
        const int j = e / P, p = e % P;
        const float w = expf(last - cum[j0 + j]) * dts[j0 + j];
        xC[e] = to_f32(xb[static_cast<int64_t>(c0 + j0 + j) * xs + p]) * w;
      }
      __syncthreads();
      for (int e = tid; e < P * N; e += kThreads) {
        const int p = e / N, n = e % N;
        float acc = 0.f;
        for (int j = 0; j < TL; ++j) acc += xC[j * P + p] * bC[j * NP + n];
        st[p * NP + n] += acc;
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int P, int N, int L) {
  const int TL = L < kTile ? L : kTile;
  const size_t floats = static_cast<size_t>(P) * (N + 1) + 2u * TL * (N + 1) + 2u * TL * P +
                        static_cast<size_t>(TL) * (TL + 1) + 2u * L;
  return floats * sizeof(float);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, void* y,
           int Bsz, int S, int H, int P, int G, int N, int L, cudaStream_t s) {
  const size_t smem = smem_bytes(P, N, L);
  cudaError_t e = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_kernel<T><<<dim3(static_cast<unsigned>(Bsz * H)), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y), S, H, P, G, N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y (B, S, H, P) and Bm, Cm (B, S, G, N) contiguous in dtype (0 = float32,
// 1 = bfloat16); dt (B, S, H) and A (H,) float32. L is the chunk length: at
// most one tile (64) or a multiple of it. Shapes whose shared memory exceeds
// the 227 KB a block may use are refused by cudaFuncSetAttribute.
extern "C" int ssd_forward(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, void* y, int Bsz, int S, int H, int P, int G, int N,
                           int L, int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || L <= 0 || H % G != 0 ||
      S % L != 0 || (L > kTile && L % kTile != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, A, Bm, Cm, y, Bsz, S, H, P, G, N, L, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, Bsz, S, H, P, G, N, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
