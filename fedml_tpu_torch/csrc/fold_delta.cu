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
// One launch folds every leaf of one adapter type.  Leaf s is a segment
// (a_off, d_off, out_off, len, first_chunk): its values start a_off
// elements after the a pointer, d_off after d and out_off after out, and
// its ceil(len / kChunk) chunks are the blocks first_chunk, first_chunk +
// 1, ...  How a block learns its segment is the launch form, chosen by the
// wrapper (ops/epilogue.fold_plan); the arithmetic is the same in both:
//
//  * flat: the leaves tile a, d and out in one order with no gaps (the
//    layout of ops/epilogue.flat_tree, which the fed-LLM round's adapters,
//    deltas and results all have), so the fold is one range of len values
//    from three base pointers, and a block reads no table at all;
//  * table: any other layout: the int64 [S, 5] rows in device memory,
//    which a block binary-searches for its first_chunk.
//
// out may be a itself (an in-place fold): each element of a and out is read
// and written by one thread only, so a and out carry no __restrict__.
//
// What bounds it: bytes, and at the fed-LLM plane's size the launch and one
// round trip to device memory.  Per element it reads a and d and writes
// out, 12 bytes in float32; at rank 4 on BERT-tiny (11,112 values over 10
// leaves) that is 133 kB, 0.04 us at the 3.35 TB/s of an H100 SXM, far
// below a launch's microsecond, and two float32 operations per element are
// nothing to the card's rate.  So the design keeps everything ahead of the
// data loads off device memory on the fed-LLM path: a flat block's first
// loads are a and d themselves.  The table the first version searched on
// every block (about five dependent loads from an L2 that the rest of a
// round has evicted) serves only layouts that no path of the port makes.
//
// Blocks of 128 threads that each own 4 neighbouring values (16-byte loads
// of a, d and out where the chunk is full and the three places are aligned,
// masked scalar accesses otherwise): 22 blocks at 11,112 values, not 11 of
// 1,024, so twice the SMs issue the loads.  No intermediate buffer.
//
// Plain C interface for ctypes.  The launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include "reduce_head.cuh"

namespace {

using fedml::Pack;
using fedml::store_f32;
using fedml::to_f32;

constexpr int kThreads = 128;
constexpr int kVec = 4;
constexpr int kChunk = kThreads * kVec;   // 512 values per block
constexpr int kCols = 5;

struct Segment {
  int64_t a_off, d_off, out_off, len, first_chunk;
};

// One range of len values from the three base pointers.
struct FlatRange {
  long long len;

  __device__ __forceinline__ Segment find(int64_t) const {
    return Segment{0, 0, 0, len, 0};
  }
};

// Any number of segments: an int64 [n_seg, kCols] table in device memory.
struct DeviceTable {
  const int64_t* table;
  int n_seg;

  // the last row whose first_chunk is at most chunk, by binary search
  __device__ __forceinline__ Segment find(int64_t chunk) const {
    const int64_t* __restrict__ t = table;
    int lo = 0, hi = n_seg - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t[kCols * mid + 4] <= chunk) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int64_t* r = t + kCols * lo;
    return Segment{r[0], r[1], r[2], r[3], r[4]};
  }
};

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ float fold(float a, float d, float lr) {
  return __fadd_rn(a, __fmul_rn(lr, d));
}

template <typename T, typename Layout>
__global__ void __launch_bounds__(kThreads)
fold_delta_kernel(const T* a, const float* __restrict__ d, T* out, float lr,
                  const __grid_constant__ Layout layout) {
  const int64_t chunk = blockIdx.x;
  const Segment s = layout.find(chunk);
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

template <typename Layout>
int launch(const void* a, const float* d, void* out, float lr, int a_dtype,
           long long n_chunks, const Layout& layout, int device,
           void* stream) {
  if (n_chunks < 1 || n_chunks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n_chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a_dtype) {
    case fedml::kF32:
      fold_delta_kernel<float, Layout><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(a), d, static_cast<float*>(out), lr,
          layout);
      break;
    case fedml::kBF16:
      fold_delta_kernel<__nv_bfloat16, Layout><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a), d,
          static_cast<__nv_bfloat16*>(out), lr, layout);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fedml_fold_delta_chunk() { return kChunk; }

int fedml_fold_delta_table_cols() { return kCols; }

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Both forms: a, out: the adapter values of one type (a_dtype: 0
// float32, 1 bfloat16; out may be a); d: float32; lr: the server rate; on
// `device`.

// flat: len values from a, d and out on, ceil(len / kChunk) blocks
int fedml_fold_delta_flat(const void* a, const float* d, void* out,
                          long long len, float lr, int a_dtype, int device,
                          void* stream) {
  if (len < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(a, d, out, lr, a_dtype, (len + kChunk - 1) / kChunk,
                FlatRange{len}, device, stream);
}

// table: an int64 [n_seg, 5] table on `device`; n_chunks blocks in all
int fedml_fold_delta_table(const void* a, const float* d, void* out,
                           const int64_t* table, int n_seg,
                           long long n_chunks, float lr, int a_dtype,
                           int device, void* stream) {
  if (n_seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(a, d, out, lr, a_dtype, n_chunks, DeviceTable{table, n_seg},
                device, stream);
}

}  // extern "C"
