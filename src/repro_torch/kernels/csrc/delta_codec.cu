// Block-quantised checkpoint delta codec for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/delta_encode.py:
//   _encode_kernel (line 24): per row of (nblocks, block),
//       d = f32(new) - f32(prev); scale = max(max|d|, 1e-30) / 127;
//       codes = int8(clip(round_half_even(d / scale), -127, 127))
//   _decode_kernel (line 32): out = dtype(f32(prev) + f32(code) * scale[row])
//
// Bound on the H100: both are pure streams. Encode reads 2 x 4 B and writes
// 1 B per f32 element (plus 4 B per row); decode reads 1 + 4 B and writes
// 4 B. At the 1-layer gemma-2b stream (619,526 rows of 1024) that is about
// 5.7 GB per call, so HBM bandwidth sets the floor and the arithmetic is
// noise.
//
// Design: one CTA per row, 256 threads, 4 consecutive elements per thread
// (one 16-byte load for f32, 8 bytes for bf16), so a 1024-wide row is one
// fully coalesced sweep. The row's amax is a warp-shuffle max followed by a
// max over the 8 warps in shared memory; max is exact in any order, so the
// result matches the plain version bit for bit. rintf rounds half to even as
// jnp.round / torch.round do (roundf would not), the division is IEEE
// (__fdiv_rn; the file is never built with fast-math), and decode keeps the
// multiply and the add as two roundings (__fmul_rn, __fadd_rn) so nvcc
// cannot contract them into an FMA that would differ from the plain version.
//
// Rows may be any multiple of 4 elements up to 1024 (the codec uses 1024).
// The host side is a plain C interface loaded with ctypes; every launch
// returns cudaGetLastError() so a refused launch is reported to the caller.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kMaxBlock = kThreads * kVec;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const T* __restrict__ new_, const T* __restrict__ prev,
              int8_t* __restrict__ codes, float* __restrict__ scales, int block) {
  __shared__ float warp_max[kThreads / 32];
  const int64_t row = blockIdx.x;
  const int col = threadIdx.x * kVec;
  const bool active = col < block;
  const int64_t off = row * block + col;

  float d[kVec] = {0.f, 0.f, 0.f, 0.f};
  float amax = 0.f;
  if (active) {
    float a[kVec], b[kVec];
    load4(new_ + off, a);
    load4(prev + off, b);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      d[i] = __fsub_rn(a[i], b[i]);
      amax = fmaxf(amax, fabsf(d[i]));
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, s));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float scale = __fdiv_rn(fmaxf(amax, 1e-30f), 127.0f);
  if (threadIdx.x == 0) scales[row] = scale;
  if (active) {
    char4 q;
    int8_t* qv = reinterpret_cast<int8_t*>(&q);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float r = rintf(__fdiv_rn(d[i], scale));
      r = fminf(fmaxf(r, -127.0f), 127.0f);
      qv[i] = static_cast<int8_t>(r);
    }
    *reinterpret_cast<char4*>(codes + off) = q;
  }
}

template <typename P, typename O>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scales,
              const P* __restrict__ prev, O* __restrict__ out, int block) {
  const int64_t row = blockIdx.x;
  const int col = threadIdx.x * kVec;
  if (col >= block) return;
  const int64_t off = row * block + col;
  const float scale = scales[row];
  const char4 q = *reinterpret_cast<const char4*>(codes + off);
  const int8_t* qv = reinterpret_cast<const int8_t*>(&q);
  float p[kVec], o[kVec];
  load4(prev + off, p);
#pragma unroll
  for (int i = 0; i < kVec; ++i) o[i] = __fadd_rn(p[i], __fmul_rn(static_cast<float>(qv[i]), scale));
  store4(out + off, o);
}

int check_shape(int64_t nblocks, int block) {
  if (nblocks <= 0 || nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (block <= 0 || block > kMaxBlock || block % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// dtype codes shared with the Python wrapper: 0 = float32, 1 = bfloat16.
extern "C" int delta_encode(const void* new_, const void* prev, void* codes, void* scales,
                            int64_t nblocks, int block, int dtype, void* stream) {
  if (int e = check_shape(nblocks, block)) return e;
  const dim3 grid(static_cast<unsigned>(nblocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    encode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(new_), static_cast<const float*>(prev),
        static_cast<int8_t*>(codes), static_cast<float*>(scales), block);
  } else if (dtype == 1) {
    encode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(new_), static_cast<const __nv_bfloat16*>(prev),
        static_cast<int8_t*>(codes), static_cast<float*>(scales), block);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int delta_decode(const void* codes, const void* scales, const void* prev, void* out,
                            int64_t nblocks, int block, int prev_dtype, int out_dtype,
                            void* stream) {
  if (int e = check_shape(nblocks, block)) return e;
  const dim3 grid(static_cast<unsigned>(nblocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  if (prev_dtype == 0 && out_dtype == 0) {
    decode_kernel<float, float><<<grid, kThreads, 0, s>>>(
        c, sc, static_cast<const float*>(prev), static_cast<float*>(out), block);
  } else if (prev_dtype == 0 && out_dtype == 1) {
    decode_kernel<float, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        c, sc, static_cast<const float*>(prev), static_cast<__nv_bfloat16*>(out), block);
  } else if (prev_dtype == 1 && out_dtype == 0) {
    decode_kernel<__nv_bfloat16, float><<<grid, kThreads, 0, s>>>(
        c, sc, static_cast<const __nv_bfloat16*>(prev), static_cast<float*>(out), block);
  } else if (prev_dtype == 1 && out_dtype == 1) {
    decode_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        c, sc, static_cast<const __nv_bfloat16*>(prev), static_cast<__nv_bfloat16*>(out), block);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
