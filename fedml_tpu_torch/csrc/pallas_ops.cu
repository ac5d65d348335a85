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
//    as the Pallas kernel and its jnp fallback do.  The sums run in another
//    order than theirs, within K * 2^-24 * (|x| @ |q|) * s.
//
// What bounds them, at the shapes chip_smoke.py drives:
//
//  * the weighted average: bytes.  C*D inputs read once and D outputs
//    written, 2*C*D operations: at ResNet-56's 860,026 variables and 10
//    clients, 37.84 MB, about 11.3 us at 3.35 TB/s.
//  * quantize-mask: bytes, 12 per element (x and the mask in, the word
//    out): 10.32 MB at 860,026 parameters, about 3.1 us.
//  * the int8 product: bytes at both decode batches, once it runs on the
//    tensor cores.  Each weight is read once (int8), x and the outputs
//    once: one GPT-2-small decode step's 72 products move 85.9 MB at M = 1
//    and 127.7 MB at M = 64, 0.026 and 0.038 ms at 3.35 TB/s.  Every int8
//    value is exact in bfloat16, so float32 x split into three bf16 parts
//    (exact for every finite x, split3) gives exact products on the tensor
//    cores: 3 x 10.87 GFLOP at M = 64,
//    0.033 ms at the dense bf16 rate (on the CUDA cores the same work took
//    0.162 ms at the float32 rate).  What a product costs in practice is its
//    launch and one round trip to device memory for 0.59 or 2.36 MB of
//    weights.
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
//  * int8 product: one launch a product, no buffer in device memory.  K is
//    split across the blocks of a thread-block cluster (2 to 16, a power
//    of two near the size that puts two blocks on every SM, and no more
//    than the card holds at once); each block keeps its partial sums on
//    chip and writes each float4 of them into the shared memory of the
//    block of the cluster that owns it; after one cluster barrier each
//    block adds its 1/S share over the blocks in rank order, scales by s
//    and writes it: no atomics, the same bits from call to call, and no
//    block waits on a remote load.  Decode batches of M <= kGemvMaxM (8)
//    take the CUDA cores (int8_gemv_kernel): no row of padding, 8 columns a
//    thread, one 8-byte load of q a row with several rows in flight, x
//    through the L1 cache, fmaf in float32.  Larger M takes the tensor
//    cores (int8_mm_tc_kernel): 32 x 128 output tiles, 8 warps of 16 x 32,
//    mma.sync m16n8k16 with float32 sums; x staged in shared memory as bf16
//    parts (three of float32 x, split as it is staged; in a chunk that holds
//    a nonzero |x| < 2^-110 the lower two scaled up by 2^8 and 2^16 against
//    q scaled down as much, so that subnormal bits survive; bf16 x as it
//    is), read with ldmatrix; q loaded straight
//    into registers a chunk ahead and converted to bf16 there (a byte
//    permute under 2^23 and a subtraction, exact), its columns permuted so
//    that four 4-byte words a thread give the B fragments of four n-tiles.
//    The threshold, the tile rows (32 against 16 and 64) and the cluster
//    sizes (up to 16 against 8) are the fastest of those profile_int8.py
//    timed on the H100 (the threshold through builds with another
//    kGemvMaxM, --gemv-max-m).  What is
//    left per product is latency: the launch, one round trip to device
//    memory for q and x, the staging of x, and the cluster's exchange.
//
// Plain C interface for ctypes.  Launches go on the caller's stream,
// allocate nothing and return cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

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
constexpr int kSplitMax = 16;   // blocks of a cluster that split K (past 8:
                                // non-portable)
// the tensor-core path: a block holds kMmBM rows of x and 128 columns of
// q; its warps take 32 columns and kMmBM / kMmMGroups rows each; x is
// staged 64 k at a time
constexpr int kMmBM = 32;
constexpr int kMmMGroups = kMmBM >= 32 ? 2 : 1;   // warps along M
constexpr int kMmThreads = 128 * kMmMGroups;
constexpr int kMmWarpTiles = kMmBM / 16 / kMmMGroups;   // m16 tiles a warp
constexpr int kMmBN = 128;
constexpr int kMmXC = 64;
constexpr int kMmLdx = kMmXC + 8;   // bf16 a staged row: 16 bytes of padding
constexpr int kMmStage = 3 * kMmBM * kMmLdx;   // bf16 of the staged parts
constexpr int kMmRecv = kMmBM * kMmBN / 4 + kSplitMax;   // float4 received
constexpr int kMmPairs = kMmBM * kMmXC / 2 / kMmThreads;   // x pairs a thread
// the CUDA-core path, for M up to kGemvMaxM: 256 threads, 8 columns each
// (one 8-byte load of q a row), 16 threads a row, so 16 rows a pass
constexpr int kGemvMaxM = 8;
static_assert(kGemvMaxM >= 0 && kGemvMaxM <= 16, "the CUDA-core kernels' rows");
constexpr int kGvThreads = 256;
constexpr int kGvBN = 128;
constexpr int kGvCols = 8;
constexpr int kGvTpr = kGvBN / kGvCols;
constexpr int kGvRows = kGvThreads / kGvTpr;
constexpr int kGvWarps = kGvThreads / 32;
static_assert(kGvTpr == 16, "a warp holds two row groups (the shuffle by 16)");

enum MmPath { kPathCores = 1, kPathTensor = 2 };

// Byte J of a word of int8 values, as float32, exactly: the word has its
// sign bits flipped (each byte v + 128, unsigned), the byte goes under the
// exponent of 2^23, and 2^23 + 128 comes off.  A permute and an add: the
// conversion instruction runs at a quarter of their rate.
__device__ __forceinline__ float s8_to_f32(uint32_t flipped, int j) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540 | j)),
      8388736.0f);
}

// Two float32 values that bfloat16 holds exactly, as one bf16x2 word (a in
// the low half): their top halves.
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v with its low 16 bits cleared: bfloat16's value of v rounded toward 0
__device__ __forceinline__ float bf16_rz(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

// x = hi + (mid + lo / up) / up, each part a bfloat16 value: hi = bf16(x),
// mid = (x - hi) * up truncated to bfloat16, lo = the rest times up, with
// up 1 or 2^8.  Exact for finite |x| >= 2^-110 at up = 1 (the remainders
// are exact in float32 and fit bfloat16's 8 bits), and for every finite x,
// subnormals included, at up = 2^8: scaled up, the parts' lowest bit stays
// at or above 2^-133, bfloat16's least subnormal.  The tensor-core kernel
// takes up = 2^8 for a staged chunk of x that holds a nonzero |x| < 2^-110
// (kTinyX) and multiplies that chunk's mid and lo by q * 2^-8 and q *
// 2^-16, exact in bfloat16, so each product is the unscaled part's; other
// chunks skip the scaling of q.  mid is truncated so that hi + mid / up
// lies between hi and x: the passes' partial sums never pass x, so none
// overflows where x does not (x at the float32 maximum, hi + bf16(x - hi)
// would be 2^128).  A finite x that rounds past bfloat16's largest value
// takes hi truncated too; a non-finite x is hi alone, so x * q gives the
// plain version's inf or NaN.
constexpr float kPartScale = 256.f;   // 2^8: mid's scale, and lo's over mid
constexpr float kTinyX = 0x1p-110f;   // below, a chunk's parts are scaled
// v * up, up = kPartScale where SCALED, else v
template <bool SCALED>
__device__ __forceinline__ float scale_up(float v) {
  if constexpr (SCALED) return __fmul_rn(v, kPartScale);
  return v;
}

template <bool SCALED>
__device__ __forceinline__ void split3(float x, float& hi, float& mid,
                                       float& lo) {
  hi = bf16_rn(x);
  if (isinf(hi) && isfinite(x)) hi = bf16_rz(x);
  if (!isfinite(hi)) {
    mid = lo = 0.f;
    return;
  }
  const float r = scale_up<SCALED>(__fsub_rn(x, hi));
  mid = bf16_rz(r);
  lo = bf16_rn(scale_up<SCALED>(__fsub_rn(r, mid)));
}

__device__ __forceinline__ bool tiny_x(float v) {
  return v != 0.f && fabsf(v) < kTinyX;
}

// split3 of two neighbouring values, as bf16x2 words (x0 in the low
// halves): the roundings to nearest two at a time, the rare non-finite
// part or one past bfloat16's range one at a time.
template <bool SCALED>
__device__ __forceinline__ void split3_pair(float x0, float x1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  const float h0 = __low2float(h2), h1 = __high2float(h2);
  if (!isfinite(h0) || !isfinite(h1)) {
    float a0, b0, c0, a1, b1, c1;
    split3<SCALED>(x0, a0, b0, c0);
    split3<SCALED>(x1, a1, b1, c1);
    hi = bf16x2_bits(a0, a1);
    mid = bf16x2_bits(b0, b1);
    lo = bf16x2_bits(c0, c1);
    return;
  }
  const float r0 = scale_up<SCALED>(__fsub_rn(x0, h0));
  const float r1 = scale_up<SCALED>(__fsub_rn(x1, h1));
  const float m0 = bf16_rz(r0), m1 = bf16_rz(r1);
  const __nv_bfloat162 l2 =
      __floats2bfloat162_rn(scale_up<SCALED>(__fsub_rn(r0, m0)),
                            scale_up<SCALED>(__fsub_rn(r1, m1)));
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  mid = bf16x2_bits(m0, m1);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

// A bf16x2 word times 2^-8, exactly for the int8 values it holds.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w) {
  const __nv_bfloat162 v = __hmul2(
      *reinterpret_cast<const __nv_bfloat162*>(&w),
      __float2bfloat162_rn(1.f / kPartScale));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16 x 16, row) * b (16 x 8, col): bf16 products, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The cluster's barrier, split into arrive and wait.  Every kernel arrives
// (relaxed) as it starts and waits before its first write to another
// block's shared memory, which then runs for certain; the second phase
// (arrive with release, wait with acquire) makes those writes visible.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The end of both paths: a tile's n4 float4 sums (rows m0.., columns
// n0.., BN / 4 a row) split over the S blocks of the cluster, which split
// K.  Block r owns sums [r * per, (r + 1) * per).  Each block writes each
// of its partial sums into the owner's recv buffer, slot [its rank][e -
// owner * per], through distributed shared memory; after one barrier the
// owner adds its slots over the blocks in rank order, scales by s and
// writes out.  No block reads another's memory, so none waits on a
// remote load, and no block needs the others after the barrier.  No
// atomics: the result is the same from run to run.
struct TileShare {
  int S, rank, n4, per;
  float4 sc;   // the scales of this thread's first slot, loaded early
};

// The share of a tile of n4 sums, BN / 4 a row, from column n0; made as
// the kernel starts, so that the first slot's scales are on their way
// from device memory during the product.
template <int BN>
__device__ __forceinline__ TileShare tile_share(cg::cluster_group& cluster,
                                                int n4, const float* s,
                                                int n0, int N) {
  TileShare t;
  t.S = static_cast<int>(cluster.num_blocks());
  t.rank = static_cast<int>(cluster.block_rank());
  t.n4 = n4;
  t.per = (n4 + t.S - 1) / t.S;
  t.sc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int e = t.rank * t.per + threadIdx.x;
  const int n = n0 + 4 * (e % (BN / 4));
  if (threadIdx.x < t.per && e < n4) {
    const float a[4] = {n < N ? __ldg(s + n) : 0.f,
                        n + 1 < N ? __ldg(s + n + 1) : 0.f,
                        n + 2 < N ? __ldg(s + n + 2) : 0.f,
                        n + 3 < N ? __ldg(s + n + 3) : 0.f};
    t.sc = make_float4(a[0], a[1], a[2], a[3]);
  }
  return t;
}

__device__ __forceinline__ void push_sum(cg::cluster_group& cluster,
                                         float4* recv, const TileShare& t,
                                         int e, float4 v) {
  const int owner = e / t.per;
  cluster.map_shared_rank(recv, owner)[t.rank * t.per + e - owner * t.per] =
      v;
}

template <int NT, int BN>
__device__ __forceinline__ void sum_share_store(
    const float4* recv, const TileShare& t, const float* __restrict__ s,
    float* __restrict__ out, int m0, int n0, int N, bool vec_out) {
  cluster_arrive();
  cluster_wait();
  const int cnt = min(t.per, t.n4 - t.rank * t.per);
  for (int slot = threadIdx.x; slot < cnt; slot += NT) {
    float4 sum = recv[slot];
    for (int b = 1; b < t.S; ++b) {
      const float4 v = recv[b * t.per + slot];
      sum.x = __fadd_rn(sum.x, v.x);
      sum.y = __fadd_rn(sum.y, v.y);
      sum.z = __fadd_rn(sum.z, v.z);
      sum.w = __fadd_rn(sum.w, v.w);
    }
    const int e = t.rank * t.per + slot;
    const int r = e / (BN / 4), n = n0 + 4 * (e % (BN / 4));
    if (n >= N) continue;
    const float4 sc = slot == threadIdx.x
                          ? t.sc
                          : make_float4(s[n], n + 1 < N ? s[n + 1] : 0.f,
                                        n + 2 < N ? s[n + 2] : 0.f,
                                        n + 3 < N ? s[n + 3] : 0.f);
    float* dst = out + static_cast<int64_t>(m0 + r) * N + n;
    if (vec_out) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(__fmul_rn(sum.x, sc.x), __fmul_rn(sum.y, sc.y),
                      __fmul_rn(sum.z, sc.z), __fmul_rn(sum.w, sc.w));
    } else {
      const float a[4] = {__fmul_rn(sum.x, sc.x), __fmul_rn(sum.y, sc.y),
                          __fmul_rn(sum.z, sc.z), __fmul_rn(sum.w, sc.w)};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (n + u < N) dst[u] = a[u];
      }
    }
  }
}

// The tensor-core path.  Block (n-tile, split, m-tile) owns columns n0 ..
// n0 + 127, rows m0 .. m0 + 63 and the K rows [k_begin, k_end) of this
// split.  x is staged 64 k at a time into shared memory as PASSES bf16
// parts ([PASSES][64][kMmLdx]; 3 parts of float32 x, bf16 x itself), the
// next chunk already in registers.  q goes straight from device memory
// into registers, one 4-byte word (row k, 4 neighbouring columns) a load,
// a chunk ahead, and is converted to bf16 there.  mma.sync's B operand
// wants pairs of neighbouring k for one column, so the columns are
// permuted: in n-tile j of warp w, the fragment's column g (lane 4 g + t)
// is column 32 w + 4 g + j, and a thread's four words give all four
// n-tiles' fragments by byte j of each; its sums then land on 8
// neighbouring columns, 32 w + 8 t .. + 7, of rows g and g + 8.  Each k16
// step runs PASSES products into the same float32 sums, hi then mid then
// lo; a chunk that holds a tiny x (kTinyX) has its parts scaled up and
// multiplies mid and lo by q scaled down as much (split3).
template <typename Tx, int PASSES, bool VEC>
__global__ void __launch_bounds__(kMmThreads)
int8_mm_tc_kernel(const Tx* __restrict__ x, int64_t ldx,
                  const int8_t* __restrict__ q, const float* __restrict__ s,
                  float* __restrict__ out, int M, int K, int N, int chunk,
                  bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float4* recv = reinterpret_cast<float4*>(smem + 2 * kMmStage);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp & 3, mh = warp >> 2;   // 32 columns, 2 m16 tiles
  const int n0 = blockIdx.x * kMmBN;
  const int m0 = blockIdx.z * kMmBM;
  const int k_begin = blockIdx.y * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int wcol = n0 + wc * 32 + 4 * g;
  // this warp's m16 tiles that hold rows of x
  const int row0 = mh * (kMmBM / kMmMGroups);
  const int m_tiles = min(kMmWarpTiles, max(0, (M - m0 - row0 + 15) / 16));
  const TileShare ts = tile_share<kMmBN>(
      cluster, min(kMmBM, M - m0) * (kMmBN / 4), s, n0, N);

  // row k's word at columns wcol .. wcol + 3; 0 past the split or past N
  auto q_word = [&](int k) -> uint32_t {
    if (k >= k_end) return 0u;
    const int8_t* row = q + static_cast<int64_t>(k) * N + wcol;
    if (VEC && wcol + 4 <= N) return __ldg(reinterpret_cast<const uint32_t*>(row));
    uint32_t w = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (wcol + j < N) {
        w |= static_cast<uint32_t>(static_cast<uint8_t>(row[j])) << (8 * j);
      }
    }
    return w;
  };
  // a chunk's words: k16 step kk, rows k0 + 2t, + 1, + 8, + 9
  auto load_q = [&](int kc, uint32_t (&w)[16]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = kc + 16 * kk + 2 * t;
      w[4 * kk] = q_word(k);
      w[4 * kk + 1] = q_word(k + 1);
      w[4 * kk + 2] = q_word(k + 8);
      w[4 * kk + 3] = q_word(k + 9);
    }
  };
  // x's chunk: kMmBM rows x 32 pairs of neighbouring k, kMmPairs a thread,
  // neighbouring threads on neighbouring pairs of one row
  float xv[kMmPairs][2];
  auto load_x = [&](int kc) {
#pragma unroll
    for (int j = 0; j < kMmPairs; ++j) {
      const int p = tid + j * kMmThreads;
      const int m = m0 + (p >> 5), k = kc + 2 * (p & 31);
      const Tx* row = x + static_cast<int64_t>(m) * ldx;
      xv[j][0] = (m < M && k < k_end) ? to_f32(row[k]) : 0.f;
      xv[j][1] = (m < M && k + 1 < k_end) ? to_f32(row[k + 1]) : 0.f;
    }
  };
  // whether this thread's values of the chunk need scaled parts
  auto tiny_chunk = [&]() {
    bool t = false;
#pragma unroll
    for (int j = 0; j < kMmPairs; ++j) t |= tiny_x(xv[j][0]) | tiny_x(xv[j][1]);
    return PASSES > 1 && t;
  };
  // scaled: std::true_type or std::false_type (two builds of the loop
  // bodies, so that a chunk with no tiny x runs none of the scaling)
  auto store_x = [&](auto scaled) {
#pragma unroll
    for (int j = 0; j < kMmPairs; ++j) {
      const int p = tid + j * kMmThreads;
      const int at = (p >> 5) * kMmLdx + 2 * (p & 31);
      if constexpr (PASSES == 1) {
        *reinterpret_cast<uint32_t*>(xs + at) = bf16x2_bits(xv[j][0], xv[j][1]);
      } else {
        uint32_t hi, mid, lo;
        split3_pair<decltype(scaled)::value>(xv[j][0], xv[j][1], hi, mid, lo);
        *reinterpret_cast<uint32_t*>(xs + at) = hi;
        *reinterpret_cast<uint32_t*>(xs + kMmBM * kMmLdx + at) = mid;
        *reinterpret_cast<uint32_t*>(xs + 2 * kMmBM * kMmLdx + at) = lo;
      }
    }
  };

  float acc[kMmWarpTiles][4][4];
#pragma unroll
  for (int i = 0; i < kMmWarpTiles; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    }
  }
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  auto compute = [&](int kc, const uint32_t (&w)[16], auto scaled) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kc + 16 * kk < k_end) {
        const uint32_t f0 = w[4 * kk] ^ 0x80808080u;
        const uint32_t f1 = w[4 * kk + 1] ^ 0x80808080u;
        const uint32_t f2 = w[4 * kk + 2] ^ 0x80808080u;
        const uint32_t f3 = w[4 * kk + 3] ^ 0x80808080u;
        uint32_t b[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j][0] = bf16x2_bits(s8_to_f32(f0, j), s8_to_f32(f1, j));
          b[j][1] = bf16x2_bits(s8_to_f32(f2, j), s8_to_f32(f3, j));
        }
        // the passes outermost: a sum's next product comes 16 later; in a
        // scaled chunk q goes to q * 2^-8 for mid and q * 2^-16 for lo
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          if constexpr (decltype(scaled)::value) {
            if (p > 0) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                b[j][0] = scale_bf16x2(b[j][0]);
                b[j][1] = scale_bf16x2(b[j][1]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kMmWarpTiles; ++i) {
            if (i < m_tiles) {
              uint32_t a[4];
              ldsm_x4(a, xs + (p * kMmBM + row0 + 16 * i + a_row) * kMmLdx +
                             16 * kk + a_col);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
              }
            }
          }
        }
      }
    }
  };

  uint32_t wa[16], wb[16];
  load_q(k_begin, wa);
  load_x(k_begin);
  // the barrier ahead of each store also tells every thread whether the
  // chunk holds a tiny x
  auto stage_and_compute = [&](int kc, const uint32_t (&w)[16],
                               uint32_t (&next)[16]) {
    const bool scaled = __syncthreads_or(tiny_chunk());
    if (scaled) {
      store_x(std::true_type{});
    } else {
      store_x(std::false_type{});
    }
    __syncthreads();
    const int k1 = kc + kMmXC;
    if (k1 < k_end) {
      load_q(k1, next);
      load_x(k1);
    }
    if (scaled) {
      compute(kc, w, std::true_type{});
    } else {
      compute(kc, w, std::false_type{});
    }
    return k1 < k_end;
  };
  for (int kc = k_begin; kc < k_end; kc += 2 * kMmXC) {
    if (!stage_and_compute(kc, wa, wb)) break;
    if (!stage_and_compute(kc + kMmXC, wb, wa)) break;
  }

  // each float4 of sums to the block of the cluster that owns it: row
  // row0 + 16 i + g + 8 h, columns wc * 32 + 8 t + 4 c .. + 3
  cluster_wait();
#pragma unroll
  for (int i = 0; i < kMmWarpTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * i + g + 8 * h;
      if (m0 + row < M) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          push_sum(cluster, recv, ts, row * (kMmBN / 4) + wc * 8 + 2 * t + c,
                   make_float4(acc[i][0][2 * h + c], acc[i][1][2 * h + c],
                               acc[i][2][2 * h + c], acc[i][3][2 * h + c]));
        }
      }
    }
  }
  sum_share_store<kMmThreads, kMmBN>(recv, ts, s, out, m0, n0, N, vec_out);
}

// The CUDA-core path, for decode batches of M <= MT rows.  Block (n-tile,
// split) owns columns n0 .. n0 + 127 and the K rows [k_begin, k_end);
// thread (row group rg, column group ct) walks rows k_begin + rg + 16 i
// with its 8 columns' weights one 8-byte load a row, kBatch rows in flight
// (the next batch loads while this one is multiplied), and keeps MT x 8
// float32 sums.  x's values come through the L1 cache, one load for the
// 16 threads of a row.  The two row groups of a warp add by a shuffle, the
// 8 warps in shared memory in warp order, the cluster's blocks as in the
// tensor-core path.
template <typename Tx, int MT, bool VEC>
__global__ void __launch_bounds__(kGvThreads)
int8_gemv_kernel(const Tx* __restrict__ x, int64_t ldx,
                 const int8_t* __restrict__ q, const float* __restrict__ s,
                 float* __restrict__ out, int M, int K, int N, int chunk,
                 bool vec_out) {
  constexpr int kBatch = MT <= 4 ? 4 : (MT <= 8 ? 2 : 1);
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);   // [warps][MT][kGvBN]
  float4* recv = reinterpret_cast<float4*>(red + kGvWarps * MT * kGvBN);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = tid / kGvTpr, ct = tid % kGvTpr;
  const int n0 = blockIdx.x * kGvBN, col = n0 + ct * kGvCols;
  const int k_begin = blockIdx.y * chunk;
  const int k_end = min(K, k_begin + chunk);
  const TileShare ts = tile_share<kGvBN>(cluster, M * (kGvBN / 4), s, n0, N);

  float acc[MT][kGvCols];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < kGvCols; ++c) acc[m][c] = 0.f;
  }
  uint2 qv[kBatch];
  float xv[kBatch][MT];
  auto load = [&](int kb) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = kb + rg + kGvRows * u;
      qv[u] = make_uint2(0u, 0u);
#pragma unroll
      for (int m = 0; m < MT; ++m) xv[u][m] = 0.f;
      if (k < k_end) {
        const int8_t* row = q + static_cast<int64_t>(k) * N + col;
        if (VEC && col + kGvCols <= N) {
          qv[u] = __ldg(reinterpret_cast<const uint2*>(row));
        } else {
          uint32_t w[2] = {0u, 0u};
#pragma unroll
          for (int j = 0; j < kGvCols; ++j) {
            if (col + j < N) {
              w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[j]))
                          << (8 * (j % 4));
            }
          }
          qv[u] = make_uint2(w[0], w[1]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < M) xv[u][m] = to_f32(x[static_cast<int64_t>(m) * ldx + k]);
        }
      }
    }
  };

  if (k_begin < k_end) {
    load(k_begin);
    for (int kb = k_begin;; kb += kGvRows * kBatch) {
      uint2 qc[kBatch];
      float xc[kBatch][MT];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        qc[u] = qv[u];
#pragma unroll
        for (int m = 0; m < MT; ++m) xc[u][m] = xv[u][m];
      }
      const int next = kb + kGvRows * kBatch;
      if (next < k_end) load(next);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const uint32_t f0 = qc[u].x ^ 0x80808080u, f1 = qc[u].y ^ 0x80808080u;
        float w[kGvCols];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[j] = s8_to_f32(f0, j);
          w[4 + j] = s8_to_f32(f1, j);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int c = 0; c < kGvCols; ++c) {
            acc[m][c] = fmaf(xc[u][m], w[c], acc[m][c]);
          }
        }
      }
      if (next >= k_end) break;
    }
  }

  // row groups 2 w and 2 w + 1 share warp w: lanes l and l + 16
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < kGvCols; ++c) {
      acc[m][c] = __fadd_rn(acc[m][c],
                            __shfl_xor_sync(0xffffffffu, acc[m][c], 16));
    }
  }
  if (lane < 16) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float4* dst = reinterpret_cast<float4*>(
          red + (warp * MT + m) * kGvBN + ct * kGvCols);
      dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
  __syncthreads();
  // the warps' sums added in warp order, each float4 to its owner
  cluster_wait();
  for (int e = tid; e < ts.n4; e += kGvThreads) {
    const float4* src = reinterpret_cast<const float4*>(red) + e;
    float4 v = src[0];
#pragma unroll
    for (int w = 1; w < kGvWarps; ++w) {
      const float4 u = src[w * MT * (kGvBN / 4)];
      v.x = __fadd_rn(v.x, u.x);
      v.y = __fadd_rn(v.y, u.y);
      v.z = __fadd_rn(v.z, u.z);
      v.w = __fadd_rn(v.w, u.w);
    }
    push_sum(cluster, recv, ts, e, v);
  }
  sum_share_store<kGvThreads, kGvBN>(recv, ts, s, out, 0, n0, N, vec_out);
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

// A product's launch: the path, its kernel, the grid and the cluster.
struct MmPlan {
  int path;        // kPathCores or kPathTensor
  int mt;          // the CUDA-core kernel's rows: 1, 2, 4, 8 (or 16)
  int splits;      // blocks of a cluster: they split K
  int chunk;       // K a split, a multiple of 16
  int tiles_n, tiles_m;
  size_t smem;
  const void* kern;
};

// The CUDA-core kernel of mt rows; those past kGemvMaxM are not built (a
// build with another kGemvMaxM, as profile_int8.py makes, builds them).
template <typename Tx, bool VEC>
const void* gemv_kernel_for(int mt) {
  if constexpr (kGemvMaxM > 8) {
    if (mt == 16) return reinterpret_cast<const void*>(&int8_gemv_kernel<Tx, 16, VEC>);
  }
  if constexpr (kGemvMaxM > 4) {
    if (mt == 8) return reinterpret_cast<const void*>(&int8_gemv_kernel<Tx, 8, VEC>);
  }
  if constexpr (kGemvMaxM > 2) {
    if (mt == 4) return reinterpret_cast<const void*>(&int8_gemv_kernel<Tx, 4, VEC>);
  }
  if constexpr (kGemvMaxM > 1) {
    if (mt == 2) return reinterpret_cast<const void*>(&int8_gemv_kernel<Tx, 2, VEC>);
  }
  return reinterpret_cast<const void*>(&int8_gemv_kernel<Tx, 1, VEC>);
}

const void* mm_kernel_for(int path, int dtype, int mt, bool vec) {
  const bool bf = dtype == kBF16;
  if (path == kPathCores) {
    if (bf) return vec ? gemv_kernel_for<__nv_bfloat16, true>(mt)
                       : gemv_kernel_for<__nv_bfloat16, false>(mt);
    return vec ? gemv_kernel_for<float, true>(mt)
               : gemv_kernel_for<float, false>(mt);
  }
  if (bf) {
    return vec ? reinterpret_cast<const void*>(&int8_mm_tc_kernel<__nv_bfloat16, 1, true>)
               : reinterpret_cast<const void*>(&int8_mm_tc_kernel<__nv_bfloat16, 1, false>);
  }
  return vec ? reinterpret_cast<const void*>(&int8_mm_tc_kernel<float, 3, true>)
             : reinterpret_cast<const void*>(&int8_mm_tc_kernel<float, 3, false>);
}

// How many clusters of `cs` blocks of `kern` the card holds at once (0
// where it holds none or refuses the size), cached a kernel, device and
// size; the kernel's shared-memory and cluster attributes are set at its
// first query.  Guarded: the cross-silo plane calls from several threads.
std::mutex g_cluster_mutex;
int active_clusters(const void* kern, int threads, size_t smem, int cs,
                    int device) {
  struct Entry {
    const void* kern;
    int device, cs, n;
  };
  static Entry cache[256];
  static int used = 0;
  std::lock_guard<std::mutex> lock(g_cluster_mutex);
  bool seen = false;
  for (int i = 0; i < used; ++i) {
    if (cache[i].kern == kern && cache[i].device == device) {
      seen = true;
      if (cache[i].cs == cs) return cache[i].n;
    }
  }
  if (!seen &&
      (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem)) != cudaSuccess ||
       cudaFuncSetAttribute(kern,
                            cudaFuncAttributeNonPortableClusterSizeAllowed,
                            1) != cudaSuccess)) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, cs, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) n = 0;
  cudaGetLastError();   // a refused size is no error of the launch
  if (used < 256) cache[used++] = Entry{kern, device, cs, n};
  return n;
}

// The plan of an [M, K] x [K, N] product: decode batches up to kGemvMaxM
// take the CUDA cores, the rest the tensor cores.  K is split across a
// cluster of a power-of-two size, up to kSplitMax, near the size at which
// the grid covers the SMs twice, in whole k16 steps, and no larger than
// lets every cluster be resident at once; 0 or a CUDA error code.
int plan_mm(int M, int K, int N, int dtype, const int8_t* q, int device,
            MmPlan& p) {
  p = MmPlan{};
  const int path = M <= kGemvMaxM ? kPathCores : kPathTensor;
  p.path = path;
  // q's rows in whole 8-byte (CUDA cores) or 4-byte (tensor cores) loads
  const bool vec = path == kPathCores ? (N % 8 == 0 && aligned(q, 8))
                                      : (N % 4 == 0 && aligned(q, 4));
  const int sms = sm_count(device);
  int threads;
  if (path == kPathCores) {
    p.mt = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
    p.tiles_n = (N + kGvBN - 1) / kGvBN;
    p.tiles_m = 1;
    p.smem = sizeof(float) * kGvWarps * p.mt * kGvBN +
             sizeof(float4) * (p.mt * kGvBN / 4 + kSplitMax);
    threads = kGvThreads;
  } else {
    p.mt = 0;
    p.tiles_n = (N + kMmBN - 1) / kMmBN;
    p.tiles_m = (M + kMmBM - 1) / kMmBM;
    p.smem = sizeof(__nv_bfloat16) * kMmStage + sizeof(float4) * kMmRecv;
    threads = kMmThreads;
  }
  if (p.tiles_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  p.kern = mm_kernel_for(path, dtype, p.mt, vec);
  const int64_t tiles = static_cast<int64_t>(p.tiles_n) * p.tiles_m;
  const int64_t want = (2 * sms + tiles - 1) / tiles;
  const int steps = (K + 15) / 16;
  int splits = 1;
  while (2 * splits <= kSplitMax && 2 * splits <= steps &&
         4 * splits <= 3 * want) {
    splits *= 2;
  }
  while (splits > 1 && active_clusters(p.kern, threads, p.smem, splits,
                                       device) < tiles) {
    splits /= 2;
  }
  if (active_clusters(p.kern, threads, p.smem, splits, device) < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.chunk = ((steps + splits - 1) / splits) * 16;
  p.splits = (K + p.chunk - 1) / p.chunk;
  return 0;
}

int launch_mm(const MmPlan& p, const void* x, int64_t ldx, const int8_t* q,
              const float* s, float* out, int M, int K, int N, bool vec_out,
              cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles_n, p.splits, p.tiles_m);
  cfg.blockDim = dim3(p.path == kPathCores ? kGvThreads : kMmThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<void**>(&x), &ldx, const_cast<int8_t**>(&q),
                  const_cast<float**>(&s), &out, &M, &K, &N,
                  const_cast<int*>(&p.chunk), &vec_out};
  return static_cast<int>(cudaLaunchKernelExC(&cfg, p.kern, args));
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

int fedml_int8_gemv_max_m() { return kGemvMaxM; }

// The plan of an [M, K] x [K, N] product with x of x_dtype on `device`:
// plan[0] the path (1 the CUDA cores, 2 the tensor cores), plan[1] the
// blocks of a cluster, which split K, plan[2] K a split, plan[3] the blocks
// in all, as fedml_int8_matmul makes it.  For reports.
int fedml_int8_matmul_plan(int M, int K, int N, int x_dtype, int device,
                           int* plan) {
  if (M < 1 || K < 1 || N < 1 || (x_dtype != kF32 && x_dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  MmPlan p;
  const int rc = plan_mm(M, K, N, x_dtype, nullptr, device, p);
  if (rc != 0) return rc;
  plan[0] = p.path;
  plan[1] = p.splits;
  plan[2] = p.chunk;
  plan[3] = p.tiles_n * p.splits * p.tiles_m;
  return 0;
}

// x: [M, K] float32 (0) or bfloat16 (1), row stride ldx >= K; q: int8
// [K, N] contiguous; s: float32 [N]; out: float32 [M, N] contiguous.  One
// launch, on the CUDA cores for M <= kGemvMaxM, else on the tensor cores.
int fedml_int8_matmul(const void* x, int x_dtype, long long ldx,
                      const int8_t* q, const float* s, float* out, int M,
                      int K, int N, int device, void* stream) {
  if (M < 1 || K < 1 || N < 1 || ldx < K ||
      (x_dtype != kF32 && x_dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  MmPlan p;
  const int rc = plan_mm(M, K, N, x_dtype, q, device, p);
  if (rc != 0) return rc;
  const bool vec_out = N % 4 == 0 && aligned(s, 16) && aligned(out, 16);
  return launch_mm(p, x, static_cast<int64_t>(ldx), q, s, out, M, K, N,
                   vec_out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
