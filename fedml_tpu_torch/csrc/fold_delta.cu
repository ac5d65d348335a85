// The fed-LLM adapter fold, written for Hopper (sm_90a).
//
// Replaces fedml_tpu/ops/epilogue.py::_delta_kernel, the Pallas kernel that
// fold_delta launches once per adapter leaf through _leaf_pallas_call:
//
//     out = T(f32(a) + lr * d)
//
// with a the adapter leaf (float32 or bfloat16, T its type), d the float32
// aggregated delta of the same shape and lr the server rate (1 for the sync
// fold, 0 for the re-merge), a float32 from the host.  The product and the
// sum are the correctly rounded IEEE ones, written out as __fmul_rn and
// __fadd_rn (the source also builds with -fmad=false), so they are never
// contracted into an fma: the kernel gives the bits of the JAX package's
// jnp fallback, which rounds the product before the sum, and of the plain
// version fold_delta_reference.
//
// Segments: one launch folds every leaf of one adapter type.  Leaf s is the
// row (a_off, d_off, out_off, len, first_chunk) of an int64 [S, 5] table on
// the card: its values start a_off elements after the a pointer, d_off
// after d and out_off after out, and its ceil(len / kChunk) chunks are the
// blocks first_chunk, first_chunk + 1, ...  A block finds its leaf by a
// binary search over first_chunk.  The adapters of a model live in one
// buffer per type with a view per leaf, so the offsets are those views'
// places in the buffers, and a leaf may start at any element.
//
// out may be a itself (an in-place fold): each element of a and out is read
// and written by one thread only, so a and out carry no __restrict__.
//
// What bounds it: bytes, and at the fed-LLM plane's size the launch.  Per
// element it reads a and d and writes out, 12 bytes in float32; at rank 4 on
// BERT-tiny (11,112 values over 10 leaves) that is 133 kB, 0.04 us at the
// 3.35 TB/s of an H100 SXM, far below a launch's few microseconds, and two
// float32 operations per element are nothing to the card's rate.
//
// What the design does about it: one launch per adapter type for all the
// leaves (the TPU version makes one pallas_call per leaf, 10 here), blocks
// of 256 threads that each own 4 neighbouring values (16-byte loads of a,
// d and out where the chunk is full and the three places are aligned,
// masked scalar accesses otherwise), and no intermediate buffer.
//
// Plain C interface for ctypes.  The launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include "reduce_head.cuh"

namespace {

using fedml::Pack;
using fedml::store_f32;
using fedml::to_f32;

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kChunk = kThreads * kVec;   // 1,024 values per block
constexpr int kCols = 5;

struct Segment {
  int64_t a_off, d_off, out_off, len, first_chunk;
};

// The segment that owns `chunk`: the last s with first_chunk[s] <= chunk.
__device__ __forceinline__ Segment find_segment(const int64_t* __restrict__ table,
                                                int n_seg, int64_t chunk) {
  int lo = 0, hi = n_seg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[kCols * mid + 4] <= chunk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int64_t* r = table + kCols * lo;
  return Segment{r[0], r[1], r[2], r[3], r[4]};
}

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ float fold(float a, float d, float lr) {
  return __fadd_rn(a, __fmul_rn(lr, d));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_delta_kernel(const T* a, const float* __restrict__ d, T* out,
                  const int64_t* __restrict__ table, int n_seg, float lr) {
  const int64_t chunk = blockIdx.x;
  const Segment s = find_segment(table, n_seg, chunk);
  const int64_t start = (chunk - s.first_chunk) * kChunk;
  const int64_t left = s.len - start;
  const int n = left < kChunk ? static_cast<int>(left) : kChunk;
  const T* ap = a + s.a_off + start;
  const float* dp = d + s.d_off + start;
  T* op = out + s.out_off + start;
  const int base = threadIdx.x * kVec;

  if (n == kChunk && aligned(ap, sizeof(T) * kVec) && aligned(dp, 16) &&
      aligned(op, sizeof(T) * kVec)) {
    const Pack<T, kVec> av = reinterpret_cast<const Pack<T, kVec>*>(ap)[threadIdx.x];
    const Pack<float, kVec> dv =
        reinterpret_cast<const Pack<float, kVec>*>(dp)[threadIdx.x];
    Pack<T, kVec> o;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      store_f32(fold(to_f32(av.v[i]), dv.v[i], lr), &o.v[i]);
    }
    reinterpret_cast<Pack<T, kVec>*>(op)[threadIdx.x] = o;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int j = base + i;
      if (j < n) store_f32(fold(to_f32(ap[j]), dp[j], lr), &op[j]);
    }
  }
}

}  // namespace

extern "C" {

int fedml_fold_delta_chunk() { return kChunk; }

int fedml_fold_delta_table_cols() { return kCols; }

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a, out: the adapter values of one type (a_dtype: 0 float32, 1 bfloat16;
// out may be a); d: float32; table: int64 [n_seg, 5] on the card, n_chunks
// blocks of kChunk in all; lr: the server rate.  All on `device`.
int fedml_fold_delta(const void* a, const float* d, void* out,
                     const int64_t* table, int n_seg, long long n_chunks,
                     float lr, int a_dtype, int device, void* stream) {
  if (n_seg < 1 || n_chunks < 1 || n_chunks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n_chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a_dtype) {
    case fedml::kF32:
      fold_delta_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(a), d, static_cast<float*>(out), table,
          n_seg, lr);
      break;
    case fedml::kBF16:
      fold_delta_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a), d,
          static_cast<__nv_bfloat16*>(out), table, n_seg, lr);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
