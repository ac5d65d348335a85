// The reduce head shared by the round-epilogue kernels (sm_90a).
//
// weighted_reduce.cu and fused_epilogue.cu both start from the same two
// steps, and this header holds them so that the two stay bit-identical:
//
//  1. every block normalises the client weights into shared memory,
//     wn[c] = w[c] / max(sum(w), 1e-12), summing w in one fixed order;
//  2. every thread accumulates VEC neighbouring columns of a row-major
//     [C, ld] buffer in float32, c = 0..C-1 in order, with fmaf.
//
// The [C, ld] buffer may be a column range of a wider one: row c of the
// range starts ld elements after row c - 1, and the range is `cols` wide.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fedml {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;
// shared memory holds C normalised weights plus kWarps + 1 scratch floats;
// 8192 clients stay inside the 48 KB a block gets without opting in
constexpr int kMaxClients = 8192;

enum DtypeCode { kF32 = 0, kBF16 = 1, kI32 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int32_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ void store_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// round a float32 to T and back: the identity for float32, one bfloat16
// rounding for bfloat16
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Step 1: wn[0..C) = w / max(sum(w), 1e-12) in shared memory; `smem` holds
// C + kWarps + 1 floats.  Every thread of the block must call it.
__device__ __forceinline__ void normalise_weights(const float* __restrict__ w,
                                                  int C, float* smem) {
  float* wn = smem;
  float* scratch = smem + C;
  float part = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) part += w[c];
  part = warp_sum(part);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = part;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? scratch[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) scratch[kWarps] = fmaxf(v, 1e-12f);
  }
  __syncthreads();
  const float denom = scratch[kWarps];
  for (int c = threadIdx.x; c < C; c += kThreads) wn[c] = w[c] / denom;
  __syncthreads();
}

// Step 2: acc[i] = sum_c wn[c] * x[c, VEC*g + i] for pack g of the range;
// ld_packs is the row stride in packs of VEC.
template <typename Tin, int VEC>
__device__ __forceinline__ void accumulate(const Pack<Tin, VEC>* __restrict__ src,
                                           int64_t ld_packs, int64_t g,
                                           const float* wn, int C,
                                           float (&acc)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const Pack<Tin, VEC> p = src[static_cast<int64_t>(c) * ld_packs + g];
    const float wc = wn[c];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wc, to_f32(p.v[i]), acc[i]);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline int grid_for(int64_t groups) {
  const int64_t want = (groups + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

inline size_t smem_bytes(int C) {
  return static_cast<size_t>(C + kWarps + 1) * sizeof(float);
}

}  // namespace fedml
