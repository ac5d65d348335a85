// Weighted reduce over the client axis, written for Hopper (sm_90a).
//
// Replaces fedml_tpu/ops/epilogue.py::_reduce_kernel, the Pallas kernel that
// fedml_tpu's weighted_reduce launches once per leaf through
// _leaf_pallas_call.  It computes, for x laid out as [C, D] row-major with
// row stride ld >= D (a column range of a wider buffer when ld > D),
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
// one pallas_call per leaf (287 for ResNet-56).  The normalisation and the
// accumulation are reduce_head.cuh's, shared with fused_epilogue.cu.
//
// Plain C interface for ctypes.  The launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include "reduce_head.cuh"

namespace {

using namespace fedml;

template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kThreads)
weighted_reduce_kernel(const Tin* __restrict__ x, int64_t ld_packs,
                       const float* __restrict__ w, Tout* __restrict__ out,
                       int C, int64_t groups) {
  extern __shared__ float smem[];
  normalise_weights(w, C, smem);

  // groups = D / VEC packs per row; the grid-stride bound masks the tail
  const Pack<Tin, VEC>* src = reinterpret_cast<const Pack<Tin, VEC>*>(x);
  Pack<Tout, VEC>* dst = reinterpret_cast<Pack<Tout, VEC>*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    float acc[VEC];
    accumulate<Tin, VEC>(src, ld_packs, g, smem, C, acc);
    Pack<Tout, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) store_f32(acc[i], &o.v[i]);
    dst[g] = o;
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, int64_t ld, const float* w, void* out, int C,
           int64_t D, cudaStream_t stream) {
  // 16-byte packs when every row of the range starts 16-byte aligned (D,
  // ld and both pointers), else one column per thread (any D, any ld)
  constexpr int kVec = 16 / sizeof(Tin);
  static_assert(kVec * sizeof(Tout) <= 16, "output pack wider than input");
  const bool vec = D % kVec == 0 && ld % kVec == 0 && aligned16(x) &&
                   aligned16(out);
  const int64_t groups = vec ? D / kVec : D;
  const int blocks = grid_for(groups);
  const size_t smem = smem_bytes(C);
  if (vec) {
    weighted_reduce_kernel<Tin, Tout, kVec><<<blocks, kThreads, smem, stream>>>(
        static_cast<const Tin*>(x), ld / kVec, w, static_cast<Tout*>(out), C,
        groups);
  } else {
    weighted_reduce_kernel<Tin, Tout, 1><<<blocks, kThreads, smem, stream>>>(
        static_cast<const Tin*>(x), ld, w, static_cast<Tout*>(out), C, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fedml_weighted_reduce_max_clients() { return fedml::kMaxClients; }

// x: [C, D] in the type named by dtype, row stride ld >= D elements; w: [C]
// float32; out: [D] contiguous (float32 for kF32 and kI32, bfloat16 for
// kBF16).  All three on `device`.
int fedml_weighted_reduce(const void* x, long long ld, const float* w,
                          void* out, int C, long long D, int dtype,
                          int device, void* stream) {
  if (C < 1 || C > fedml::kMaxClients || D < 1 || ld < D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fedml::kF32:
      return launch<float, float>(x, ld, w, out, C, D, s);
    case fedml::kBF16:
      return launch<__nv_bfloat16, __nv_bfloat16>(x, ld, w, out, C, D, s);
    case fedml::kI32:
      return launch<int32_t, float>(x, ld, w, out, C, D, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
