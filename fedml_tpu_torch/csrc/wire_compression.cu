// Blocked int8 wire codec, written for Hopper (sm_90a).
//
// Replaces fedml_tpu/ops/wire_compression.py::_quant_kernel and
// ::_dequant_kernel, the Pallas kernels behind quantize_int8_blocked and
// dequantize_int8_blocked.  For each block of kBlock = 512 values of a
// float32 vector:
//
//     scale = max|x| / 127
//     inv   = scale > 0 ? 1 / max(scale, 1e-30) : 0
//     q     = clamp(round_half_even(x * inv), -127, 127)      (int8)
//
// and the inverse, out = float(q) * scale.  Every division and product is
// the correctly rounded IEEE one (__fdiv_rn, __fmul_rn; rintf rounds half
// to even like jnp.round), so the kernels give the plain versions' bits.
// A row that holds a NaN or an infinity keeps it as jnp.max and torch.amax
// do: its scale is NaN (a NaN in the row) or inf, so inv is 0, every q of
// the row 0 (a NaN product casts to 0, as it does in both plain versions),
// and the row decodes to NaN.  A diverged update stays visible on the wire.
//
// Segments: the vector is cut into S segments (one per model leaf, or one
// for a flat delta) and the blocks restart at every segment start, as the
// JAX package's one pallas_call per leaf restarts them.  Segment s is the
// row (in_off, len, out_off, row_off) of an int64 [S, 4] table on the
// card: its values start at in_off of the input and out_off of the output,
// and its ceil(len / 512) blocks own the scales from row_off on, packed
// segment after segment.  So a whole model's per-leaf encode or decode is
// one launch.  The Pallas [32, 512] grid tiles and the 32-row padding are
// TPU layout; here a block that is not full is masked (its padding counts
// as 0 in the max, as the JAX package's zero padding does).
//
// What bounds them: bytes.  The quantize reads 4D bytes and writes
// D + 4*ceil(D/512); the dequantize reads D + 4*ceil(D/512) and writes 4D.
// Their few operations per value are far below the card's rate.  At
// ResNet-56's 860,026 variables that is about 4.3 MB, some 1.3 us at the
// 3.35 TB/s of an H100 SXM, so a launch costs more than the traffic.
//
// What the design does about it: one launch for a whole model, one CUDA
// block of 128 threads per 512-value row, each thread owning 4 neighbouring
// values (one 16-byte load or store where the row is full and aligned,
// masked scalar accesses otherwise), the row's max-abs by warp shuffles and
// 4 words of shared memory.  No intermediate buffer: each value is read
// once and written once.  Each block finds its segment by a binary search
// over the table's row_off column.
//
// Plain C interface for ctypes.  The launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;
constexpr int kThreads = 128;
constexpr int kVec = kBlock / kThreads;   // 4 values per thread
constexpr int kWarps = kThreads / 32;

struct Segment {
  int64_t in_off, len, out_off, row_off;
};

// The segment that owns `row`: the last s with row_off[s] <= row.
__device__ __forceinline__ Segment find_segment(const int64_t* __restrict__ table,
                                                int n_seg, int64_t row) {
  int lo = 0, hi = n_seg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[4 * mid + 3] <= row) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return Segment{table[4 * lo], table[4 * lo + 1], table[4 * lo + 2],
                 table[4 * lo + 3]};
}

// max(a, b) that keeps a NaN of either side, as jnp.max and torch.amax
// do; fmaxf drops it.
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const int64_t* __restrict__ table,
                int n_seg, int8_t* __restrict__ q, float* __restrict__ scales) {
  __shared__ float warp_max[kWarps];
  const int64_t row = blockIdx.x;
  const Segment s = find_segment(table, n_seg, row);
  const int64_t start = (row - s.row_off) * kBlock;
  const int64_t left = s.len - start;
  const int n = left < kBlock ? static_cast<int>(left) : kBlock;
  const float* src = x + s.in_off + start;
  int8_t* dst = q + s.out_off + start;
  const int base = threadIdx.x * kVec;

  float v[kVec];
  const bool full = n == kBlock;
  if (full && aligned(src, 16)) {
    const float4 f = reinterpret_cast<const float4*>(src)[threadIdx.x];
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = base + i < n ? src[base + i] : 0.f;
  }

  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) m = max_keep_nan(m, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = max_keep_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = max_keep_nan(amax, warp_max[w]);

  const float scale = __fdiv_rn(amax, 127.0f);
  const float inv = scale > 0.f ? __fdiv_rn(1.0f, fmaxf(scale, 1e-30f)) : 0.f;
  int8_t out[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float r = rintf(__fmul_rn(v[i], inv));   // NaN: inf * 0, NaN * 0
    out[i] = r != r ? int8_t{0}
                    : static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (full && aligned(dst, 4)) {
    reinterpret_cast<char4*>(dst)[threadIdx.x] =
        make_char4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (base + i < n) dst[base + i] = out[i];
    }
  }
  if (threadIdx.x == 0) scales[row] = scale;
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  const int64_t* __restrict__ table, int n_seg,
                  float* __restrict__ out) {
  const int64_t row = blockIdx.x;
  const Segment s = find_segment(table, n_seg, row);
  const int64_t start = (row - s.row_off) * kBlock;
  const int64_t left = s.len - start;
  const int n = left < kBlock ? static_cast<int>(left) : kBlock;
  const int8_t* src = q + s.in_off + start;
  float* dst = out + s.out_off + start;
  const float scale = scales[row];
  const int base = threadIdx.x * kVec;

  const bool full = n == kBlock;
  if (full && aligned(src, 4) && aligned(dst, 16)) {
    const char4 c = reinterpret_cast<const char4*>(src)[threadIdx.x];
    reinterpret_cast<float4*>(dst)[threadIdx.x] = make_float4(
        __fmul_rn(static_cast<float>(c.x), scale),
        __fmul_rn(static_cast<float>(c.y), scale),
        __fmul_rn(static_cast<float>(c.z), scale),
        __fmul_rn(static_cast<float>(c.w), scale));
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (base + i < n) {
        dst[base + i] = __fmul_rn(static_cast<float>(src[base + i]), scale);
      }
    }
  }
}

// The launch's checks: a grid of n_rows blocks fits, and the device is set.
int prepare(int n_seg, long long n_rows, int device) {
  if (n_seg < 1 || n_rows < 1 || n_rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

extern "C" {

int fedml_wire_block() { return kBlock; }

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: float32 values; table: int64 [n_seg, 4] on the card; n_rows blocks of
// 512 in all; q: int8, as long as x; scales: float32 [n_rows].
int fedml_quantize_int8(const float* x, const int64_t* table, int n_seg,
                        long long n_rows, int8_t* q, float* scales, int device,
                        void* stream) {
  const int err = prepare(n_seg, n_rows, device);
  if (err != 0) return err;
  quantize_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, table, n_seg, q,
                                                         scales);
  return static_cast<int>(cudaGetLastError());
}

// q: int8 values; scales: float32 [n_rows]; table as above; out: float32,
// as long as q.
int fedml_dequantize_int8(const int8_t* q, const float* scales,
                          const int64_t* table, int n_seg, long long n_rows,
                          float* out, int device, void* stream) {
  const int err = prepare(n_seg, n_rows, device);
  if (err != 0) return err;
  dequantize_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(q, scales, table,
                                                           n_seg, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
