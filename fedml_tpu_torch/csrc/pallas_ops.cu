// The aggregation and serving kernels of ops/pallas_ops.py, written for
// Hopper (sm_90a).
//
// Replaces the three Pallas kernels of fedml_tpu/ops/pallas_ops.py:
//
//  * _wavg_kernel (weighted_average_flat): [C, D] stacked client updates
//    and weights [C] -> float32 [D],
//        wn[c]  = float(w[c]) / max(float(sum(w)), 1e-12)
//        out[d] = sum_c wn[c] * float(x[c, d])
//    The sum of the weights is taken in double in one fixed order and
//    rounded once to float32, so integer weights (sample counts) give
//    float(exact integer sum), the normaliser JAX's int32 sum gives; the
//    division is the correctly rounded float32 one.  The columns accumulate
//    with fmaf in client order.  JAX's fallback is a [1, C] x [C, D]
//    product (`w @ stacked`) whose summation order XLA picks, so the two
//    agree within the error of a float32 sum of C terms, not bit for bit.
//
//  * _qmask_kernel (quantize_mask): SecAgg's fused quantize and mask add,
//        out[i] = uint32(int32(round_half_even(x[i] * scale))) + mask[i]
//    modulo 2^32.  __float2int_rn saturates out-of-range values to
//    INT32_MIN / INT32_MAX and maps NaN to 0, as XLA's conversion does;
//    the add wraps as unsigned 32-bit arithmetic.  The uint32 words travel
//    as int32 tensors with the same bits (PyTorch has no uint32 add).
//
//  * _int8_mm_kernel (int8_matmul): the serving path's int8 weight product,
//        out[m, n] = (sum_k float(x[m, k]) * float(q[k, n])) * s[n]
//    with x float32 or bfloat16 [M, K] (row stride ldx), q int8 [K, N]
//    row-major and s float32 [N]: the product summed first, then scaled,
//    as the Pallas kernel and its jnp fallback do.
//
// What bounds them, at the shapes chip_smoke.py drives:
//
//  * the weighted average: bytes.  C*D inputs read once and D outputs
//    written, 2*C*D operations: at ResNet-56's 860,026 variables and 10
//    clients, 37.84 MB, about 11.3 us at 3.35 TB/s.
//  * quantize-mask: bytes, 12 per element (x and the mask in, the word
//    out): 10.32 MB at 860,026 parameters, about 3.1 us.
//  * the int8 product: at decode batch M = 1, the int8 weights' bytes (each
//    weight is used once); at M = 64 the float32 operations on the CUDA
//    cores (2*M*K*N), since this kernel does not use the tensor cores.
//
// What the designs do about it:
//
//  * weighted average: one coalesced read pass, no intermediate buffer.
//    Each thread owns 4 neighbouring columns (one 16-byte float32 load or
//    one 8-byte bfloat16 load per client row) when every row starts
//    aligned, else one column (coalesced 4-byte loads across the warp),
//    and walks the clients in order with the sums in registers.  Every
//    block normalises the weights into shared memory itself, so the whole
//    average is one launch.
//  * quantize-mask: one pass, 16-byte loads and stores of 4 elements per
//    thread where all three buffers are aligned, a scalar tail.
//  * int8 product: a tiled product on the CUDA cores.  A block owns a
//    BM x 64 output tile (BM = 16 for decode batches up to 16, else 64),
//    and walks its share of K in steps of 32: the q tile crosses memory as
//    int8 (16-byte loads) and is converted to float32 once, into shared
//    memory, beside the x tile; each of the 256 threads then accumulates
//    TM x 4 outputs with fmaf from shared memory, while the next step's
//    tiles are already on their way into registers.  Decode shapes have few
//    output tiles (12 for a 768 x 768 matrix), so K is split across blocks
//    until the grid covers the SMs twice; the splits' partial sums go to a
//    scratch buffer and a second kernel adds them in split order and
//    scales, so the result does not depend on the blocks' timing.
//
// Plain C interface for ctypes.  Launches go on the caller's stream,
// allocate nothing and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
// the weighted average keeps C normalised weights in shared memory
constexpr int kMaxClients = 8192;

enum DtypeCode { kF32 = 0, kBF16 = 1, kF64 = 2, kI32 = 3, kI64 = 4 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(double v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(int32_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(int64_t v) {
  return static_cast<float>(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

inline int grid_for(int64_t items) {
  const int64_t want = (items + kThreads - 1) / kThreads;
  return static_cast<int>(want < 1 ? 1 : (want < kMaxBlocks ? want
                                                              : kMaxBlocks));
}

// ------------------------------------------------------ weighted average
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// wn[0..C) = float(w[c]) / max(float(sum(w)), 1e-12) into shared memory.
// The sum runs in double in a fixed order (each thread's strided share,
// then a fixed shuffle tree), exact for integer weights below 2^53.
template <typename Tw>
__device__ __forceinline__ void normalise(const Tw* __restrict__ w, int C,
                                          float* wn, double* scratch) {
  double part = 0.0;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    part += static_cast<double>(w[c]);
  }
  part = warp_sum(part);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = part;
  __syncthreads();
  if (warp == 0) {
    double v = lane < kThreads / 32 ? scratch[lane] : 0.0;
    v = warp_sum(v);
    if (lane == 0) {
      // max(sum, 1e-12) that keeps a NaN sum, as jnp.maximum does
      const float sf = static_cast<float>(v);
      scratch[kThreads / 32] = (sf != sf || sf > 1e-12f) ? sf : 1e-12f;
    }
  }
  __syncthreads();
  const float norm = static_cast<float>(scratch[kThreads / 32]);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    wn[c] = __fdiv_rn(to_f32(w[c]), norm);
  }
  __syncthreads();
}

template <typename Tin, typename Tw, int VEC>
__global__ void __launch_bounds__(kThreads)
wavg_kernel(const Tin* __restrict__ x, const Tw* __restrict__ w,
            float* __restrict__ out, int C, int64_t D) {
  extern __shared__ float wn[];
  __shared__ double scratch[kThreads / 32 + 1];
  normalise(w, C, wn, scratch);

  const int64_t groups = D / VEC;   // VEC > 1 only when VEC divides D
  const int64_t ld = groups;        // row stride in packs
  const Pack<Tin, VEC>* src = reinterpret_cast<const Pack<Tin, VEC>*>(x);
  Pack<float, VEC>* dst = reinterpret_cast<Pack<float, VEC>*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const Pack<Tin, VEC> p = src[static_cast<int64_t>(c) * ld + g];
      const float wc = wn[c];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wc, to_f32(p.v[i]), acc[i]);
    }
    Pack<float, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o.v[i] = acc[i];
    dst[g] = o;
  }
}

template <typename Tin, typename Tw>
int launch_wavg(const void* x, const void* w, float* out, int C, int64_t D,
                cudaStream_t stream) {
  // 4 columns a thread when every row starts aligned to the pack
  constexpr int kVec = 4;
  const bool vec = D % kVec == 0 && aligned(x, sizeof(Tin) * kVec) &&
                   aligned(out, 16);
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  const Tin* xs = static_cast<const Tin*>(x);
  const Tw* ws = static_cast<const Tw*>(w);
  if (vec) {
    wavg_kernel<Tin, Tw, kVec><<<grid_for(D / kVec), kThreads, smem,
                                 stream>>>(xs, ws, out, C, D);
  } else {
    wavg_kernel<Tin, Tw, 1><<<grid_for(D), kThreads, smem, stream>>>(
        xs, ws, out, C, D);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int dispatch_wavg_weights(const void* x, const void* w, int w_dtype,
                          float* out, int C, int64_t D, cudaStream_t s) {
  switch (w_dtype) {
    case kF32: return launch_wavg<Tin, float>(x, w, out, C, D, s);
    case kF64: return launch_wavg<Tin, double>(x, w, out, C, D, s);
    case kI32: return launch_wavg<Tin, int32_t>(x, w, out, C, D, s);
    case kI64: return launch_wavg<Tin, int64_t>(x, w, out, C, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --------------------------------------------------------- quantize-mask
__device__ __forceinline__ int32_t qmask_one(float x, int32_t m, float scale) {
  const int32_t q = __float2int_rn(__fmul_rn(x, scale));
  return static_cast<int32_t>(static_cast<uint32_t>(q) +
                              static_cast<uint32_t>(m));
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
qmask_kernel(const Tin* __restrict__ x, const int32_t* __restrict__ mask,
             int32_t* __restrict__ out, float scale, int64_t n, bool vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  int64_t done = 0;
  if (vec) {
    // 4 elements a thread: 16-byte loads of x (float32; 8 bytes of
    // bfloat16) and the mask, one 16-byte store
    const int64_t groups = n / 4;
    const Pack<Tin, 4>* xp = reinterpret_cast<const Pack<Tin, 4>*>(x);
    const int4* mp = reinterpret_cast<const int4*>(mask);
    int4* op = reinterpret_cast<int4*>(out);
    for (int64_t g = first; g < groups; g += stride) {
      const Pack<Tin, 4> a = xp[g];
      const int4 m = mp[g];
      op[g] = make_int4(qmask_one(to_f32(a.v[0]), m.x, scale),
                        qmask_one(to_f32(a.v[1]), m.y, scale),
                        qmask_one(to_f32(a.v[2]), m.z, scale),
                        qmask_one(to_f32(a.v[3]), m.w, scale));
    }
    done = groups * 4;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    out[i] = qmask_one(to_f32(x[i]), mask[i], scale);
  }
}

template <typename Tin>
int launch_qmask(const void* x, const int32_t* mask, int32_t* out, float scale,
                 int64_t n, cudaStream_t stream) {
  const bool vec = aligned(x, sizeof(Tin) * 4) && aligned(mask, 16) &&
                   aligned(out, 16);
  qmask_kernel<Tin><<<grid_for(vec ? (n + 3) / 4 : n), kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), mask, out, scale, n, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------- int8 weight product
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // K per shared-memory step
constexpr int kQPad = 4;       // row padding of the q tile (bank spread)

template <typename Tx, int TM, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const Tx* __restrict__ x, int64_t ldx,
               const int8_t* __restrict__ q, const float* __restrict__ s,
               float* __restrict__ out, int M, int K, int N, int chunk) {
  constexpr int BM = 16 * TM;
  constexpr int kXPer = BM * kBK / kThreads;   // x values a thread stages
  __shared__ float xs[kBK][BM + 1];
  __shared__ __align__(16) float qs[kBK][kBN + kQPad];
  const int tid = threadIdx.x;
  const int tx = tid & 15;     // columns 4*tx .. 4*tx + 3 of the tile
  const int ty = tid >> 4;     // rows TM*ty .. TM*ty + TM - 1
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  // the q tile, kBK rows of 64 int8, is 128 pieces of 16 bytes: thread
  // tid < 128 loads row qr's piece qp
  const bool q_loader = tid < kBK * 4;
  const int qr = tid >> 2, qp = tid & 3;

  // one K-step's operands in registers: the next step's are loaded while
  // this step's are multiplied from shared memory.  Rows past this
  // split's share and columns past N read as 0.
  float qv[16];
  float xv[kXPer];
  auto load = [&](int k0) {
    if (q_loader) {
      const int k = k0 + qr;
      const int c = n0 + qp * 16;
      const int8_t* row = q + static_cast<int64_t>(k) * N;
      if (VEC && k < k_end && c + 16 <= N) {
        const int4 raw = *reinterpret_cast<const int4*>(row + c);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 16; ++i) qv[i] = static_cast<float>(b[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          qv[i] = (k < k_end && c + i < N) ? static_cast<float>(row[c + i])
                                           : 0.f;
        }
      }
    }
    // neighbouring threads read neighbouring k of one row of x
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kThreads;
      const int gm = m0 + i / kBK, gk = k0 + i % kBK;
      xv[j] = (gm < M && gk < k_end)
                  ? to_f32(x[static_cast<int64_t>(gm) * ldx + gk])
                  : 0.f;
    }
  };
  auto store = [&]() {
    if (q_loader) {
      float4* dst = reinterpret_cast<float4*>(&qs[qr][qp * 16]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dst[i] = make_float4(qv[4 * i], qv[4 * i + 1], qv[4 * i + 2],
                             qv[4 * i + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kThreads;
      xs[i % kBK][i / kBK] = xv[j];   // transposed: xs[k][m]
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    store();
    __syncthreads();
    if (k0 + kBK < k_end) load(k0 + kBK);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&qs[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = xs[kk][ty * TM + i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  // one split: scale and write the output; several: write this split's
  // partial sums, [split, M, N], for split_sum_kernel
  const bool split = gridDim.z > 1;
  float* dst = split ? out + static_cast<int64_t>(blockIdx.z) * M * N : out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) {
        dst[static_cast<int64_t>(m) * N + n] =
            split ? acc[i][j] : __fmul_rn(acc[i][j], s[n]);
      }
    }
  }
}

// out[m, n] = (sum over splits, in split order, of part[split, m, n]) * s[n]
__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ part, const float* __restrict__ s,
                 float* __restrict__ out, int splits, int64_t mn, int N) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < mn; i += stride) {
    // the splits' loads go out 8 at a time, the adds stay in split order
    float acc = part[i];
    int k = 1;
    for (; k + 8 <= splits; k += 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = part[(k + j) * mn + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, v[j]);
    }
    for (; k < splits; ++k) acc = __fadd_rn(acc, part[k * mn + i]);
    out[i] = __fmul_rn(acc, s[i % N]);
  }
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n < 1) {
      n = 132;
    }
    cached[device] = n;
  }
  return cached[device];
}

// rows of an output tile: 16 for decode batches up to 16, else 64
inline int tile_m(int M) { return M <= 16 ? 16 : 64; }

// K per split: the splits multiply the output tiles until the grid covers
// the SMs about twice; a split's share is a whole number of kBK steps
int plan_chunk(int M, int K, int N, int device) {
  const int64_t tiles = static_cast<int64_t>((N + kBN - 1) / kBN) *
                        ((M + tile_m(M) - 1) / tile_m(M));
  const int64_t want = 2LL * sm_count(device);
  const int steps = (K + kBK - 1) / kBK;
  int64_t splits = (want + tiles - 1) / tiles;
  if (splits < 1) splits = 1;
  if (splits > steps) splits = steps;
  const int per = static_cast<int>((steps + splits - 1) / splits);
  return per * kBK;
}

template <typename Tx, int TM>
int launch_mm(const void* x, int64_t ldx, const int8_t* q, const float* s,
              float* out, float* part, int M, int K, int N, int chunk,
              int splits, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  const bool vec = N % 16 == 0 && aligned(q, 16);
  float* dst = splits > 1 ? part : out;
  const Tx* xs = static_cast<const Tx*>(x);
  if (vec) {
    int8_mm_kernel<Tx, TM, true><<<grid, kThreads, 0, stream>>>(
        xs, ldx, q, s, dst, M, K, N, chunk);
  } else {
    int8_mm_kernel<Tx, TM, false><<<grid, kThreads, 0, stream>>>(
        xs, ldx, q, s, dst, M, K, N, chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t mn = static_cast<int64_t>(M) * N;
  split_sum_kernel<<<grid_for(mn), kThreads, 0, stream>>>(part, s, out, splits,
                                                          mn, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fedml_wavg_max_clients() { return kMaxClients; }

// x: [C, D] contiguous, float32 (x_dtype 0) or bfloat16 (1); w: [C] of
// float32 (0), float64 (2), int32 (3) or int64 (4); out: float32 [D].  All
// on `device`.
int fedml_weighted_average(const void* x, int x_dtype, const void* w,
                           int w_dtype, float* out, int C, long long D,
                           int device, void* stream) {
  if (C < 1 || C > kMaxClients || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32: return dispatch_wavg_weights<float>(x, w, w_dtype, out, C, D, s);
    case kBF16:
      return dispatch_wavg_weights<__nv_bfloat16>(x, w, w_dtype, out, C, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: [n] float32 (0) or bfloat16 (1); mask and out: [n] 32-bit words
// (uint32 bits in int32); scale: the float32 fixed-point scale.
int fedml_quantize_mask(const void* x, int x_dtype, const int32_t* mask,
                        int32_t* out, float scale, long long n, int device,
                        void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32: return launch_qmask<float>(x, mask, out, scale, n, s);
    case kBF16: return launch_qmask<__nv_bfloat16>(x, mask, out, scale, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The split plan of an [M, K] x [K, N] product on `device`: K per split
// (`chunk`); the splits are ceil(K / chunk).  The caller gives
// fedml_int8_matmul a float32 scratch of splits * M * N when splits > 1.
int fedml_int8_matmul_chunk(int M, int K, int N, int device) {
  if (M < 1 || K < 1 || N < 1) return -1;
  return plan_chunk(M, K, N, device);
}

// x: [M, K] float32 (0) or bfloat16 (1), row stride ldx >= K; q: int8
// [K, N] contiguous; s: float32 [N]; out: float32 [M, N] contiguous;
// part: float32 [splits, M, N] scratch (unused when splits == 1).
int fedml_int8_matmul(const void* x, int x_dtype, long long ldx,
                      const int8_t* q, const float* s, float* out,
                      float* part, int M, int K, int N, int chunk, int device,
                      void* stream) {
  if (M < 1 || K < 1 || N < 1 || ldx < K || chunk < kBK || chunk % kBK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int splits = (K + chunk - 1) / chunk;
  if (M > 65535 * 16 || (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = tile_m(M) == 16;
  switch (x_dtype) {
    case kF32:
      return small ? launch_mm<float, 1>(x, ldx, q, s, out, part, M, K, N,
                                         chunk, splits, st)
                   : launch_mm<float, 4>(x, ldx, q, s, out, part, M, K, N,
                                         chunk, splits, st);
    case kBF16:
      return small ? launch_mm<__nv_bfloat16, 1>(x, ldx, q, s, out, part, M,
                                                 K, N, chunk, splits, st)
                   : launch_mm<__nv_bfloat16, 4>(x, ldx, q, s, out, part, M,
                                                 K, N, chunk, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
