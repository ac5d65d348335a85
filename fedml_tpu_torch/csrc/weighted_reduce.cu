// Weighted reduce over the client axis, written for Hopper (sm_90a).
//
// Replaces fedml_tpu/ops/epilogue.py::_reduce_kernel, the Pallas kernel that
// fedml_tpu's weighted_reduce launches once per leaf through
// _leaf_pallas_call.  It computes, for x laid out as [C, D] row-major,
//
//     out[d] = sum_{c=0..C-1} (w[c] / max(sum(w), 1e-12)) * x[c, d]
//
// accumulated in float32 and cast to the output type: float32 -> float32,
// bfloat16 -> bfloat16, int32 -> float32 (a weighted mean of integers is
// fractional).
//
// What bounds it: bytes.  It must read C*D inputs once and write D outputs,
// C*D*in_bytes + D*out_bytes; its 2*C*D floating-point operations are two
// orders of magnitude below the card's rate for that traffic.  At the
// federated round's shape (ResNet-56's 860,026 float32 variables, C = 10
// clients) that is 37.8 MB: about 11.3 us at the 3.35 TB/s of an H100 SXM.
//
// What the design does about it: one coalesced read pass and no
// intermediate buffer.  Each thread owns VEC neighbouring columns (16 bytes
// of one row), walks c = 0..C-1 in order with the running sums in registers,
// and writes its VEC outputs once; neighbouring threads read neighbouring
// 16-byte chunks, so every warp load is fully coalesced.  Every block
// normalises the weights into shared memory itself, so the whole reduce is
// one launch.  The caller lays all leaves of one dtype out as one [C, D]
// buffer, so a round costs one launch per dtype where the TPU version made
// one pallas_call per leaf (287 for ResNet-56).
//
// Plain C interface for ctypes.  The launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kThreads)
weighted_reduce_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                       Tout* __restrict__ out, int C, int64_t groups) {
  extern __shared__ float smem[];
  float* wn = smem;           // [C] normalised weights
  float* scratch = smem + C;  // [kWarps + 1]

  // sum(w) in one fixed order, the same in every block
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

  // groups = D / VEC packs per row; the grid-stride bound masks the tail
  const Pack<Tin, VEC>* src = reinterpret_cast<const Pack<Tin, VEC>*>(x);
  Pack<Tout, VEC>* dst = reinterpret_cast<Pack<Tout, VEC>*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const Pack<Tin, VEC> p = src[static_cast<int64_t>(c) * groups + g];
      const float wc = wn[c];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wc, to_f32(p.v[i]), acc[i]);
    }
    Pack<Tout, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) store_f32(acc[i], &o.v[i]);
    dst[g] = o;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename Tin, typename Tout>
int launch(const void* x, const float* w, void* out, int C, int64_t D,
           cudaStream_t stream) {
  // 16-byte packs when every row starts 16-byte aligned, else one column
  // per thread (any D)
  constexpr int kVec = 16 / sizeof(Tin);
  static_assert(kVec * sizeof(Tout) <= 16, "output pack wider than input");
  const bool vec = D % kVec == 0 && aligned16(x) && aligned16(out);
  const int64_t groups = vec ? D / kVec : D;
  const int64_t want = (groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const size_t smem = static_cast<size_t>(C + kWarps + 1) * sizeof(float);
  if (vec) {
    weighted_reduce_kernel<Tin, Tout, kVec><<<blocks, kThreads, smem, stream>>>(
        static_cast<const Tin*>(x), w, static_cast<Tout*>(out), C, groups);
  } else {
    weighted_reduce_kernel<Tin, Tout, 1><<<blocks, kThreads, smem, stream>>>(
        static_cast<const Tin*>(x), w, static_cast<Tout*>(out), C, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fedml_weighted_reduce_max_clients() { return kMaxClients; }

// x: [C, D] in the type named by dtype; w: [C] float32; out: [D] (float32
// for kF32 and kI32, bfloat16 for kBF16).  All three on `device`.
int fedml_weighted_reduce(const void* x, const float* w, void* out, int C,
                          long long D, int dtype, int device, void* stream) {
  if (C < 1 || C > kMaxClients || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float, float>(x, w, out, C, D, s);
    case kBF16:
      return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, C, D, s);
    case kI32:
      return launch<int32_t, float>(x, w, out, C, D, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
