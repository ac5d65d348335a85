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
// JAX package's one pallas_call per leaf restarts them.  Segment s holds
// the values from in_off of the input and out_off of the output, and its
// ceil(len / 512) rows own the scales from row_off on, packed segment
// after segment.  So a whole model's per-leaf encode or decode is one
// launch.  The Pallas [32, 512] grid tiles and the 32-row padding are TPU
// layout; here a row that is not full is masked (its padding counts as 0
// in the max, as the JAX package's zero padding does).
//
// What bounds them: bytes.  The quantize reads 4D bytes and writes
// D + 4*ceil(D/512); the dequantize reads D + 4*ceil(D/512) and writes 4D.
// Their few operations per value are far below the card's rate.  At
// ResNet-56's 860,026 variables that is about 4.3 MB, some 1.3 us at the
// 3.35 TB/s of an H100 SXM, so a launch, and every device-memory round trip
// ahead of the data, costs more than the traffic.
//
// What the designs do about it.  Both: one launch for a whole model, no
// intermediate buffer, each value read once and written once, and nothing
// read ahead of the data but what the row needs, in one of three launch
// forms.  One segment (the uplink, each error-feedback residual, a fed-LLM
// upload): its offsets are launch arguments.  Up to 2,048 scale rows (the
// broadcast's 287 leaves, 1,902 rows; the adapter leaves of the fed-LLM
// path): each row's first value by value in a __grid_constant__ parameter
// of 8 KB, 4 bytes a row; a row reads its two words from the constant bank.
// A layout past that capacity: an int64 [S, 4] table on the card (row:
// in_off, len, out_off, row_off), binary-searched per row (find_segment).
// The quantize (_quant_kernel's port): a warp a row, several rows a block,
// 16 values a lane as four 16-byte loads where the row is full and aligned;
// the row's max-abs is an integer max of the values' bits with the sign
// cleared, which orders NaN above inf above every finite value as jnp.max
// keeps them, and needs shuffles only: no shared memory, no barrier.  The
// dequantize (_dequant_kernel's port) reads nothing ahead of its data but
// the scale: a block of 128 threads a row, 4 values a thread (one 4-byte
// load, one float4 store).

// Plain C interface for ctypes.  The launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlock = 512;
constexpr int kThreads = 128;

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

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The quantize: a warp a row, kQVec values a lane, and kQRows rows a
// block (profile_streaming.py --qrows times others as builds).
constexpr int kQVec = kBlock / 32;             // values a lane
constexpr int kQRows = 4;
constexpr int kQThreads = kQRows * 32;         // threads a block
static_assert(kQThreads <= 1024, "the quantize's rows");

// scale = max|x| / 127 and q for the n <= 512 values of one row, by the
// warp of the row (`lane` 0 .. 31).  Lane `lane` takes the float4s lane,
// lane + 32, ... of the row, so every warp load covers 512 neighbouring
// bytes.
__device__ __forceinline__ void quant_row(const float* __restrict__ src,
                                          int8_t* __restrict__ dst, int n,
                                          float* __restrict__ scale_out,
                                          int lane) {
  constexpr int kLoads = kQVec / 4;
  float v[kQVec];
  const bool fast = n == kBlock && aligned(src, 16);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int at = lane + k * 32;
    if (fast) {
      const float4 f = reinterpret_cast<const float4*>(src)[at];
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[4 * k + i] = 4 * at + i < n ? src[4 * at + i] : 0.f;
      }
    }
  }

  // |x| as bits: NaN (exponent all ones, a payload) > inf > finite, and
  // the padding's 0 below all, so the row's max keeps a NaN or an inf
  unsigned bits = 0u;
#pragma unroll
  for (int i = 0; i < kQVec; ++i) {
    bits = max(bits, __float_as_uint(v[i]) & 0x7fffffffu);
  }
  bits = __reduce_max_sync(0xffffffffu, bits);

  const float scale = __fdiv_rn(__uint_as_float(bits), 127.0f);
  const float inv = scale > 0.f ? __fdiv_rn(1.0f, fmaxf(scale, 1e-30f)) : 0.f;
  int8_t out[kQVec];
#pragma unroll
  for (int i = 0; i < kQVec; ++i) {
    const float r = rintf(__fmul_rn(v[i], inv));   // NaN: inf * 0, NaN * 0
    out[i] = r != r ? int8_t{0}
                    : static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  const bool fast_out = n == kBlock && aligned(dst, 4);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int at = lane + k * 32;
    if (fast_out) {
      reinterpret_cast<char4*>(dst)[at] = make_char4(
          out[4 * k], out[4 * k + 1], out[4 * k + 2], out[4 * k + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * at + i < n) dst[4 * at + i] = out[4 * k + i];
      }
    }
  }
  if (lane == 0) *scale_out = scale;
}

// One segment: row r holds values 512 r .., whose offsets are launch
// arguments.  Nothing is read ahead of the data.
__global__ void __launch_bounds__(kQThreads)
quantize_flat_kernel(const float* __restrict__ x, int64_t total,
                     int64_t n_rows, int8_t* __restrict__ q,
                     float* __restrict__ scales) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kQRows +
                      threadIdx.x / 32;
  if (row >= n_rows) return;
  const int64_t start = row * kBlock;
  const int64_t left = total - start;
  quant_row(x + start, q + start, left < kBlock ? static_cast<int>(left)
                                                : kBlock,
            scales + row, threadIdx.x % 32);
}

// The dequantize: a warp or a block per row, kDqVec values a thread (4:
// one 4-byte load of q and one float4 store where the row is full and
// aligned, 16: one 16-byte load and four float4 stores; masked scalar
// accesses otherwise).  4 measures faster on the H100: four times the
// blocks, each as short.
constexpr int kDqVec = 4;
constexpr int kDqTpr = kBlock / kDqVec;        // threads a row
constexpr int kDqRows = kThreads / kDqTpr;     // rows a block
static_assert(kDqVec == 4 || kDqVec == 16, "the dequantize's loads");

// out[i] = f32(q[i]) * scale for the n < 512 values of one row, by the
// kDqTpr threads of the row (`lane` 0 .. kDqTpr - 1).
__device__ __forceinline__ void dequant_row(const int8_t* __restrict__ src,
                                            float* __restrict__ dst, int n,
                                            float scale, int lane) {
  const int base = lane * kDqVec;
  if (n == kBlock && aligned(src, kDqVec) && aligned(dst, 16)) {
    if constexpr (kDqVec == 16) {
      const int4 raw = reinterpret_cast<const int4*>(src)[lane];
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      float4* d = reinterpret_cast<float4*>(dst + base);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d[i] = make_float4(__fmul_rn(static_cast<float>(b[4 * i]), scale),
                           __fmul_rn(static_cast<float>(b[4 * i + 1]), scale),
                           __fmul_rn(static_cast<float>(b[4 * i + 2]), scale),
                           __fmul_rn(static_cast<float>(b[4 * i + 3]), scale));
      }
    } else {
      const char4 c = reinterpret_cast<const char4*>(src)[lane];
      reinterpret_cast<float4*>(dst)[lane] = make_float4(
          __fmul_rn(static_cast<float>(c.x), scale),
          __fmul_rn(static_cast<float>(c.y), scale),
          __fmul_rn(static_cast<float>(c.z), scale),
          __fmul_rn(static_cast<float>(c.w), scale));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kDqVec; ++i) {
      if (base + i < n) {
        dst[base + i] = __fmul_rn(static_cast<float>(src[base + i]), scale);
      }
    }
  }
}

// One segment (the uplink, a residual): row r holds values 512 r ..,
// whose offsets are launch arguments.  Nothing is read ahead of the data.
__global__ void __launch_bounds__(kThreads)
dequantize_flat_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scales,
                       float* __restrict__ out, int64_t total,
                       int64_t n_rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kDqRows +
                      threadIdx.x / kDqTpr;
  if (row >= n_rows) return;
  const int64_t start = row * kBlock;
  const int64_t left = total - start;
  dequant_row(q + start, out + start, left < kBlock ? static_cast<int>(left)
                                                    : kBlock,
              scales[row], threadIdx.x % kDqTpr);
}

// The most scale rows the by-value form takes: one 8 KB parameter, the
// broadcast's 1,902 rows on ResNet-56 and room to spare.
constexpr int kRowsCapacity = 2048;

// Several segments, passed by value: row r of the scales holds the values
// start[r] .. start[r + 1] - 1 (start[n_rows] is the total), 4 bytes a
// row.  Segments lie back to back, so a row's start and its length are
// all a segment's offsets give it.  The parameter lies in the constant
// bank: a row reads its two words, the same for every thread of the row,
// and no device memory ahead of its data.  (A binary search over the
// segments' offsets and first rows there, ten dependent reads for 287
// segments, cost the H100 more than the parameter's extra bytes; a warp
// reading 32 coarse rows at once, more again: the constant cache serves
// one address at a time.)
struct RowsByValue {
  uint32_t start[kRowsCapacity + 1];
};
static_assert(sizeof(RowsByValue) + 32 <= 32764, "parameter bytes");

__global__ void __launch_bounds__(kThreads)
dequantize_rows_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scales,
                       float* __restrict__ out, int n_rows,
                       const __grid_constant__ RowsByValue rows) {
  const int row = blockIdx.x * kDqRows + threadIdx.x / kDqTpr;
  if (row >= n_rows) return;
  const int64_t start = rows.start[row];
  dequant_row(q + start, out + start,
              static_cast<int>(rows.start[row + 1] - rows.start[row]),
              scales[row], threadIdx.x % kDqTpr);
}

// A layout past the by-value capacity: the int64 [S, 4] table on the card,
// searched per row (find_segment).
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  const int64_t* __restrict__ table, int n_seg, int64_t n_rows,
                  float* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kDqRows +
                      threadIdx.x / kDqTpr;
  if (row >= n_rows) return;
  const Segment s = find_segment(table, n_seg, row);
  const int64_t start = (row - s.row_off) * kBlock;
  const int64_t left = s.len - start;
  dequant_row(q + s.in_off + start, out + s.out_off + start,
              left < kBlock ? static_cast<int>(left) : kBlock, scales[row],
              threadIdx.x % kDqTpr);
}

// The quantize's other two forms.  By value, as the dequantize's: row r
// holds values start[r] .. start[r + 1] - 1, read from the constant bank.
__global__ void __launch_bounds__(kQThreads)
quantize_rows_kernel(const float* __restrict__ x, int n_rows,
                     int8_t* __restrict__ q, float* __restrict__ scales,
                     const __grid_constant__ RowsByValue rows) {
  const int row = blockIdx.x * kQRows + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int64_t start = rows.start[row];
  quant_row(x + start, q + start,
            static_cast<int>(rows.start[row + 1] - rows.start[row]),
            scales + row, threadIdx.x % 32);
}

// Past the by-value capacity: the device table, searched per row.
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const float* __restrict__ x, const int64_t* __restrict__ table,
                int n_seg, int64_t n_rows, int8_t* __restrict__ q,
                float* __restrict__ scales) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kQRows +
                      threadIdx.x / 32;
  if (row >= n_rows) return;
  const Segment s = find_segment(table, n_seg, row);
  const int64_t start = (row - s.row_off) * kBlock;
  const int64_t left = s.len - start;
  quant_row(x + s.in_off + start, q + s.out_off + start,
            left < kBlock ? static_cast<int>(left) : kBlock, scales + row,
            threadIdx.x % 32);
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
// 512 in all; q: int8, as long as x; scales: float32 [n_rows].  For layouts
// past the by-value capacity.
int fedml_quantize_int8(const float* x, const int64_t* table, int n_seg,
                        long long n_rows, int8_t* q, float* scales, int device,
                        void* stream) {
  const int err = prepare(n_seg, n_rows, device);
  if (err != 0) return err;
  quantize_kernel<<<static_cast<unsigned>((n_rows + kQRows - 1) / kQRows),
                    kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, table, n_seg, n_rows, q, scales);
  return static_cast<int>(cudaGetLastError());
}

// One segment of `total` values from 0: n_rows = ceil(total / 512) scales.
int fedml_quantize_int8_flat(const float* x, long long total,
                             long long n_rows, int8_t* q, float* scales,
                             int device, void* stream) {
  const int err = prepare(1, n_rows, device);
  if (err != 0) return err;
  if (total < 1 || (total + kBlock - 1) / kBlock != n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  quantize_flat_kernel<<<static_cast<unsigned>((n_rows + kQRows - 1) /
                                               kQRows),
                         kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, total, n_rows, q, scales);
  return static_cast<int>(cudaGetLastError());
}

// By value: start as for fedml_dequantize_int8_rows; n_rows <=
// kRowsCapacity.
int fedml_quantize_int8_rows(const float* x, const uint32_t* start,
                             long long n_rows, int8_t* q, float* scales,
                             int device, void* stream) {
  const int err = prepare(1, n_rows, device);
  if (err != 0) return err;
  if (n_rows > kRowsCapacity) return static_cast<int>(cudaErrorInvalidValue);
  RowsByValue rows;
  memcpy(rows.start, start, sizeof(uint32_t) * (n_rows + 1));
  quantize_rows_kernel
      <<<static_cast<unsigned>((n_rows + kQRows - 1) / kQRows), kQThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(x, static_cast<int>(n_rows), q,
                                              scales, rows);
  return static_cast<int>(cudaGetLastError());
}

// q: int8 values; scales: float32 [n_rows]; table as above; out: float32,
// as long as q.  For layouts past the by-value capacity.
int fedml_dequantize_int8(const int8_t* q, const float* scales,
                          const int64_t* table, int n_seg, long long n_rows,
                          float* out, int device, void* stream) {
  const int err = prepare(n_seg, n_rows, device);
  if (err != 0) return err;
  dequantize_kernel<<<static_cast<unsigned>((n_rows + kDqRows - 1) / kDqRows),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, scales, table, n_seg, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

// One segment of `total` values from 0: n_rows = ceil(total / 512) scales.
int fedml_dequantize_int8_flat(const int8_t* q, const float* scales,
                               long long total, long long n_rows, float* out,
                               int device, void* stream) {
  const int err = prepare(1, n_rows, device);
  if (err != 0) return err;
  if (total < 1 || (total + kBlock - 1) / kBlock != n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dequantize_flat_kernel<<<static_cast<unsigned>((n_rows + kDqRows - 1) /
                                                 kDqRows),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, scales, out, total, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// The most scale rows the by-value form takes.
int fedml_dequantize_rows_capacity() { return kRowsCapacity; }

// By value: start, the n_rows + 1 first values of the scale rows (the
// last the total), in host memory; n_rows <= kRowsCapacity.
int fedml_dequantize_int8_rows(const int8_t* q, const float* scales,
                               const uint32_t* start, long long n_rows,
                               float* out, int device, void* stream) {
  const int err = prepare(1, n_rows, device);
  if (err != 0) return err;
  if (n_rows > kRowsCapacity) return static_cast<int>(cudaErrorInvalidValue);
  RowsByValue rows;
  memcpy(rows.start, start, sizeof(uint32_t) * (n_rows + 1));
  dequantize_rows_kernel
      <<<static_cast<unsigned>((n_rows + kDqRows - 1) / kDqRows), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(q, scales, out,
                                              static_cast<int>(n_rows), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
