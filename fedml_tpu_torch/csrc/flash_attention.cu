// Flash-attention forward with its softmax residuals, written for Hopper
// (sm_90a).
//
// Replaces fedml_tpu/ops/pallas_attention.py::_flash_kernel_residuals (body
// _flash_kernel), the Pallas kernel that flash_attention_residuals launches
// through pl.pallas_call.  For q [B, H, T, D] and k, v [B, H, Tk, D], float32
// or bfloat16, it computes in float32
//
//     s      = (q * scale) k^T,  scale = 1/sqrt(D)   (q scaled first, as the
//                                                      TPU kernel does)
//     mask   = k_pos < t_valid  [and q_pos >= k_pos when causal]
//     m, l   = row max of s over the unmasked keys, and sum of exp(s - m)
//     o      = (sum_k exp(s - m) v) / max(l, 1e-12)   in q's type
//
// by the online-softmax recurrence over key tiles: a masked score is -1e30
// and its p is 0, the running (m, l, o) are rescaled by exp(m_old - m_new)
// when a tile raises the row max.  l and m come out as float32 [B*H, T].
//
// What bounds it: at the language model's shapes (D = 64, T = 80 or 512,
// bfloat16) the bytes it must move — q, k, v read once, o, l, m written
// once — and the causal half of 4*T*T*D operations per head are both below
// a microsecond on an H100; the card's tensor cores would be bound by the
// bytes.  This first kernel does not reach that bound: it computes both
// products with float32 FMAs from shared memory, and those shapes give 128
// blocks of four warps, one per SM, so it is bound by its instruction issue
// and the latency a single warp per scheduler cannot hide, not by the
// card's limits.  mma.sync or wgmma on bfloat16 tiles, more warps per
// block, TMA loads and a deeper pipeline are a later step.
//
// What the design does about the TPU kernel's shape: the Pallas grid runs
// (BH, q tile, k tile) in order on one core and carries the accumulators in
// VMEM across the k axis; blocks on Hopper run in parallel and in no order,
// so one block owns a (bh, 64-query tile) pair and walks the key tiles
// itself, with the running m, l and o in registers and each 64-key tile of
// k and v staged in shared memory.  Key tiles wholly above the causal
// diagonal, or wholly past t_valid, are never loaded (the TPU kernel still
// DMAs them).  A ragged T or Tk is masked inside the block, so any length
// runs; q, k, v and o are read and written through (b, h, t) strides, so
// the [B, T, H, D] layout of the model's projections needs no copy.  Each
// tile's loads are 16 bytes a thread, all issued before the first is used;
// the wrapper hands the kernel rows that start 16-byte aligned (it copies a
// tensor whose rows do not).
//
// Thread layout: 128 threads, thread (r, c) = (tid / 8, tid % 8) owns query
// rows 4r..4r+3, keys c + 8j of each tile in s = q k^T, and output columns
// c + 8j; the 8 threads of a row group meet by warp shuffles for the row
// max and sum.  Shared-memory rows of q and k are padded by one float so the
// 8 keys a thread reads at one d fall in distinct banks.
//
// Plain C interface for ctypes.  The launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;                 // query rows of a block
constexpr int kBK = 64;                 // keys of a tile
constexpr int kColGroups = 8;           // threads sharing one row group
constexpr int kRows = kBQ / (kThreads / kColGroups);   // 4 rows a thread
constexpr int kKeys = kBK / kColGroups;                // 8 keys a thread
constexpr int kLdP = kBK + 1;
constexpr float kNegInf = -1e30f;

enum DtypeCode { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* l;
  float* m;
  int H, T, Tk;
  int kv_end;           // min(t_valid, Tk): keys at or past it are masked
  int causal;
  float scale;
  long long qs[3], ks[3], vs[3], os[3];   // (b, h, t) strides, in elements
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// max and sum over the 8 lanes of a row group (lanes 8g .. 8g + 7)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 1; off < kColGroups; off <<= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 1; off < kColGroups; off <<= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// One tile of ROWS rows of a [T, D] slab (row stride ld elements, every
// row 16-byte aligned) on its way to shared memory as float32, in groups of
// at most 8 16-byte loads a thread (32 registers): fetch(g) issues group
// g's loads before any is used, so a thread waits for the memory once per
// group, not once per element; store(g) converts, scales and writes them
// to rows of stride lds floats.  Rows at or past n read as zeros.
template <typename T, int D, int ROWS>
struct Tile {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunksPerRow = D / kPer;
  static constexpr int kIters = ROWS * kChunksPerRow / kThreads;
  static constexpr int kGroup = kIters < 8 ? kIters : 8;
  static constexpr int kGroups = kIters / kGroup;
  static_assert(ROWS * kChunksPerRow % kThreads == 0, "ragged tile");
  static_assert(kIters % kGroup == 0, "ragged group");
  struct alignas(16) Chunk {
    T v[kPer];
  };
  Chunk buf[kGroup];

  __device__ __forceinline__ static int row_of(int it) {
    return (threadIdx.x + it * kThreads) / kChunksPerRow;
  }
  __device__ __forceinline__ static int col_of(int it) {
    return (threadIdx.x + it * kThreads) % kChunksPerRow * kPer;
  }

  __device__ __forceinline__ void fetch(const T* src, long long ld, int t0,
                                        int n, int g) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int it = g * kGroup + i, t = t0 + row_of(it);
      if (t < n) {
        buf[i] = *reinterpret_cast<const Chunk*>(src + t * ld + col_of(it));
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int lds, float scale,
                                        int t0, int n, int g) const {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int it = g * kGroup + i, row = row_of(it);
      const bool ok = t0 + row < n;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        dst[row * lds + col_of(it) + j] =
            ok ? to_f32(buf[i].v[j]) * scale : 0.0f;
      }
    }
  }

  // the whole tile, group after group
  __device__ __forceinline__ void load(const T* src, long long ld, int t0,
                                       int n, float* dst, int lds,
                                       float scale) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      fetch(src, ld, t0, n, g);
      store(dst, lds, scale, t0, n, g);
    }
  }
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kLdP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / kColGroups;   // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][kLd], scaled q
  float* Ks = Qs + kBQ * kLd;             // [kBK][kLd]
  float* Vs = Ks + kBK * kLd;             // [kBK][D]
  float* Ps = Vs + kBK * D;               // [kBQ][kLdP], the tile's p

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int row0 = (tid / kColGroups) * kRows;
  const int c = tid % kColGroups;

  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[1];
  T* o = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];

  // the q tile in float32, times the scale (rows past T are zeros)
  Tile<T, D, kBQ>().load(q, a.qs[2], q0, a.T, Qs, kLd, a.scale);

  float acc[kRows][kCols];
  float m_run[kRows], l_run[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // live key tiles: those holding a key below kv_end and, when causal, at
  // or below the tile's last query row
  const int q_last = min(q0 + kBQ, a.T) - 1;
  int n_tiles = (a.kv_end + kBK - 1) / kBK;
  if (a.causal) n_tiles = min(n_tiles, q_last / kBK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    {
      // the tile's first group of k (and all of v, where each fits in one
      // group with rows of up to 128 bytes) loads while the last tile's
      // P·V finishes
      using KV = Tile<T, D, kBK>;
      constexpr bool kBoth = sizeof(T) * D <= 128;
      static_assert(!kBoth || KV::kGroups == 1, "v must fit in one group");
      KV ktile, vtile;
      ktile.fetch(k, a.ks[2], k0, a.Tk, 0);
      if constexpr (kBoth) vtile.fetch(v, a.vs[2], k0, a.Tk, 0);
      __syncthreads();        // the last tile's P·V is done with Ks, Vs, Ps
      ktile.store(Ks, kLd, 1.0f, k0, a.Tk, 0);
#pragma unroll
      for (int g = 1; g < KV::kGroups; ++g) {
        ktile.fetch(k, a.ks[2], k0, a.Tk, g);
        ktile.store(Ks, kLd, 1.0f, k0, a.Tk, g);
      }
      if constexpr (kBoth) {
        vtile.store(Vs, D, 1.0f, k0, a.Tk, 0);
      } else {
        vtile.load(v, a.vs[2], k0, a.Tk, Vs, D, 1.0f);
      }
    }
    __syncthreads();

    // s = (q scale) k^T for rows row0 + i and keys c + 8j
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(row0 + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        kv[j] = Ks[(c + kColGroups * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    // mask, then the online-softmax step of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + row0 + i;
      bool ok[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kp = k0 + c + kColGroups * j;
        ok[j] = kp < a.kv_end && (!a.causal || qp >= kp);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float new_m = fmaxf(m_run[i], group_max(mx));
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = ok[j] ? expf(s[i][j] - new_m) : 0.0f;
        psum += p;
        Ps[(row0 + i) * kLdP + c + kColGroups * j] = p;
      }
      const float alpha = expf(m_run[i] - new_m);
      l_run[i] = l_run[i] * alpha + group_sum(psum);
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
      m_run[i] = new_m;
    }
    __syncthreads();

    // o += p v for columns c + 8j
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(row0 + i) * kLdP + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = Vs[kk * D + c + kColGroups * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + row0 + i;
    if (qp >= a.T) continue;
    const float denom = fmaxf(l_run[i], 1e-12f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      store_f32(acc[i][j] / denom, o + qp * a.os[2] + c + kColGroups * j);
    }
    if (c == 0) {
      a.l[static_cast<long long>(bh) * a.T + qp] = l_run[i];
      a.m[static_cast<long long>(bh) * a.T + qp] = m_run[i];
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block gets dynamic shared memory only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (a.T + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// every row of q, k and v starts 16-byte aligned: the tile loads need it
template <typename T>
bool rows_aligned16(const Args& a) {
  const long long per = 16 / sizeof(T);
  bool ok = reinterpret_cast<uintptr_t>(a.q) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  for (int i = 0; i < 3; ++i) {
    ok = ok && a.qs[i] % per == 0 && a.ks[i] % per == 0 &&
         a.vs[i] % per == 0;
  }
  return ok;
}

template <typename T>
int launch_d(const Args& a, int bh, int D, cudaStream_t stream) {
  if (!rows_aligned16<T>(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32:
      return launch<T, 32>(a, bh, stream);
    case 64:
      return launch<T, 64>(a, bh, stream);
    case 128:
      return launch<T, 128>(a, bh, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int fedml_flash_attention_block_q() { return kBQ; }

// q: [B, H, T, D], k and v: [B, H, Tk, D], o: like q, in the type named by
// dtype, each with unit stride over D and the (b, h, t) strides of
// strides[0..2] (q), [3..5] (k), [6..8] (v), [9..11] (o); every row of q,
// k and v 16-byte aligned; l, m: contiguous float32 [B*H, T].  All on
// `device`.
int fedml_flash_attention(const void* q, const void* k, const void* v,
                          void* o, float* l, float* m, int B, int H, int T,
                          int Tk, int D, const long long* strides,
                          int t_valid, int causal, float scale, int dtype,
                          int device, void* stream) {
  if (B < 1 || H < 1 || T < 1 || Tk < 1 ||
      (T + kBQ - 1) / kBQ > 65535 ||
      static_cast<long long>(B) * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.l = l;
  a.m = m;
  a.H = H;
  a.T = T;
  a.Tk = Tk;
  a.kv_end = t_valid < 0 ? 0 : (t_valid < Tk ? t_valid : Tk);
  a.causal = causal;
  a.scale = scale;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_d<float>(a, B * H, D, s);
    case kBF16:
      return launch_d<__nv_bfloat16>(a, B * H, D, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
