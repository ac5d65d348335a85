// Flash-attention forward with its softmax residuals, written for Hopper
// (sm_90a).
//
// Replaces fedml_tpu/ops/pallas_attention.py::_flash_kernel_residuals (body
// _flash_kernel), the Pallas kernel that flash_attention_residuals launches
// through pl.pallas_call.  For q [B, H, T, D] and k, v [B, H, Tk, D], float32
// or bfloat16, D one of 16, 32, 64 and 128, it computes in float32
//
//     s      = (q k^T) * scale,  scale = 1/sqrt(D)
//     mask   = k_pos < t_valid  [and q_pos >= k_pos when causal]
//     m, l   = row max of s over the unmasked keys, and sum of exp(s - m)
//     o      = (sum_k exp(s - m) v) / max(l, 1e-12)   in q's type
//
// by the online-softmax recurrence over 64-key tiles: a masked score is
// -1e30 and its p is 0, the running (m, l, o) are rescaled by
// exp(m_old - m_new) when a tile raises the row max.  l and m come out as
// float32 [B*H, T].  Keys at or past t_valid, and key tiles wholly above the
// causal diagonal, are never loaded; a ragged T or Tk is masked inside the
// block, so any length runs; q, k, v and o are read and written through
// (b, h, t) strides, so the [B, T, H, D] layout of the model's projections
// needs no copy (every row must start 16-byte aligned: the wrapper copies a
// tensor whose rows do not).
//
// What bounds it on this card: at the language model's shapes (D = 64,
// T = 80 or 512, bfloat16, causal) the bytes it must move (q, k, v read
// once, o, l, m written once: 2.7 and 4.3 MB) take about a microsecond at
// 3.35 TB/s and its products a twentieth of that on the tensor cores, less
// than a launch.  So the kernel is bound by latency: the launch, one round
// trip to device memory, and the chain of products, exponentials and
// shuffles that the longest block walks, one key tile after another (8
// tiles of 64 keys for the last query rows at T = 512, 1 or 2 at T = 80).
// The design shortens that chain and fills the card:
//
//  * bfloat16 (flash_fwd_mma_kernel): both products on the tensor cores,
//    mma.sync m16n8k16 with bfloat16 operands and float32 sums.  A block
//    owns 32 query rows (kWarps = 2 warps of 16 rows) of one (b, h) and
//    holds two such groups of warps (kSplit = 2, 128 threads): group 0
//    walks the first half of the block's live 64-key tiles, group 1 the
//    rest, and at the end group 1 hands its running (m, l, o) through
//    shared memory to the thread of group 0 that holds the same fragments,
//    which merges them, as merge_attention_partials does.  That halves the
//    longest chain (4 tiles at T = 512).  The grid is (B*H, query tiles),
//    causal tiles handed out longest first.  Thread and fragment layout
//    (lane = 4 g + t): a warp's q fragments are read once with ldmatrix
//    and stay in registers; s = q k^T takes k's [key][d] rows from shared
//    memory with ldmatrix as the column-major B operand, and leaves each
//    thread the scores of rows g and g + 8 at keys 8j + 2t, 8j + 2t + 1 of
//    the tile's eight n8 tiles.  The products of bfloat16 values are exact
//    in float32, and the scale is applied to the float32 sums, as the plain
//    version does; p = 2^((s - m) log2 e) on the special-function unit.
//    Those C fragments of two adjacent n8 tiles are the A fragment of one
//    m16k16 product, so p never leaves the registers: the row max and sum
//    need two shuffles across the 4 lanes of a quad.  To keep p v near
//    float32, p is split into bfloat16 parts, p_hi = bf16(p) and p_lo =
//    bf16(p - p_hi) (their sum is p to 2^-16 of it; p_hi alone only to
//    2^-8), each multiplied by the same v fragment (ldmatrix.trans of v's
//    [key][d] rows); the low parts cost as many products as the high
//    ones.  On an H100 they bring the share of o's bfloat16 values that
//    round otherwise than the plain version's from 34-37 % to 0.2 % (an
//    all-float32 FMA walk: 0.0006-0.012 %), for 1.2 us of 15.5 at T = 512.
//    k and v arrive by 16-byte cp.async copies into each group's two
//    shared-memory stages, tile j + 1 in flight while tile j is
//    multiplied; rows of shared memory are padded by 16 bytes, so the 8
//    rows an ldmatrix reads fall in distinct banks.
//    Only the diagonal tile and the tile holding t_valid take the masked
//    path (mma_tile<D, true>), which also skips the n8 pairs wholly above
//    a warp's rows; every other tile runs without masks or guards.
//  * float32 (flash_fwd_kernel): both products with float32 FMAs from
//    shared memory (the tensor cores would round to TF32); 128 threads,
//    thread (r, c) = (tid / 8, tid % 8) owns query rows 4r..4r+3, keys
//    c + 8j of each tile and output columns c + 8j, and the 8 threads of a
//    row group meet by warp shuffles; p goes through shared memory.
//
// What the design does about the TPU kernel's shape: the Pallas grid runs
// (BH, q tile, k tile) in order on one core and carries the accumulators in
// VMEM across the k axis; blocks on Hopper run in parallel and in no order,
// so one block owns a (bh, query tile) pair and walks the key tiles itself,
// with the running m, l and o in registers.
//
// Plain C interface for ctypes.  The launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ------------------------------------------------- float32: fmaf kernel
constexpr int kThreads = 128;
constexpr int kBQ = 64;                 // query rows of a block
constexpr int kBK = 64;                 // keys of a tile
constexpr int kColGroups = 8;           // threads sharing one row group
constexpr int kRows = kBQ / (kThreads / kColGroups);   // 4 rows a thread
constexpr int kKeys = kBK / kColGroups;                // 8 keys a thread
constexpr int kLdP = kBK + 1;

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

// One tile of ROWS rows of a float32 [T, D] slab (row stride ld elements,
// every row 16-byte aligned) on its way to shared memory, in groups of at
// most 8 16-byte loads a thread (32 registers): fetch(g) issues group g's
// loads before any is used, so a thread waits for the memory once per
// group, not once per element; store(g) scales and writes them to rows of
// stride lds floats.  Rows at or past n read as zeros.
template <int D, int ROWS>
struct Tile {
  static constexpr int kPer = 4;
  static constexpr int kChunksPerRow = D / kPer;
  static constexpr int kIters = ROWS * kChunksPerRow / kThreads;
  static constexpr int kGroup = kIters < 8 ? kIters : 8;
  static constexpr int kGroups = kIters / kGroup;
  static_assert(ROWS * kChunksPerRow % kThreads == 0, "ragged tile");
  static_assert(kIters % kGroup == 0, "ragged group");
  float4 buf[kGroup];

  __device__ __forceinline__ static int row_of(int it) {
    return (threadIdx.x + it * kThreads) / kChunksPerRow;
  }
  __device__ __forceinline__ static int col_of(int it) {
    return (threadIdx.x + it * kThreads) % kChunksPerRow * kPer;
  }

  __device__ __forceinline__ void fetch(const float* src, long long ld,
                                        int t0, int n, int g) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int it = g * kGroup + i, t = t0 + row_of(it);
      if (t < n) {
        buf[i] = *reinterpret_cast<const float4*>(src + t * ld + col_of(it));
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int lds, float scale,
                                        int t0, int n, int g) const {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int it = g * kGroup + i, row = row_of(it);
      const bool ok = t0 + row < n;
      float* d = dst + row * lds + col_of(it);
      d[0] = ok ? buf[i].x * scale : 0.0f;
      d[1] = ok ? buf[i].y * scale : 0.0f;
      d[2] = ok ? buf[i].z * scale : 0.0f;
      d[3] = ok ? buf[i].w * scale : 0.0f;
    }
  }

  // the whole tile, group after group
  __device__ __forceinline__ void load(const float* src, long long ld,
                                       int t0, int n, float* dst, int lds,
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

// s = (q * scale) k^T: q is scaled as it is staged, as the TPU kernel does
template <int D>
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

  const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const float* v = static_cast<const float*>(a.v) + b * a.vs[0] + h * a.vs[1];
  float* o = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];

  // the q tile, times the scale (rows past T are zeros)
  Tile<D, kBQ>().load(q, a.qs[2], q0, a.T, Qs, kLd, a.scale);

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
      using KV = Tile<D, kBK>;
      constexpr bool kBoth = sizeof(float) * D <= 128;
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
      o[qp * a.os[2] + c + kColGroups * j] = acc[i][j] / denom;
    }
    if (c == 0) {
      a.l[static_cast<long long>(bh) * a.T + qp] = l_run[i];
      a.m[static_cast<long long>(bh) * a.T + qp] = m_run[i];
    }
  }
}

template <int D>
int launch(const Args& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block gets dynamic shared memory only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (a.T + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------- bfloat16: tensor-core kernel
constexpr int kWarps = 2;         // warps of a group, 16 query rows each
constexpr int kSplit = 2;         // groups of warps sharing the key tiles
constexpr int kGroupThreads = 32 * kWarps;
constexpr int kMmaThreads = kGroupThreads * kSplit;
constexpr int kMmaBQ = 16 * kWarps;
constexpr int kMmaBK = 64;        // keys of a tile
constexpr int kNT = kMmaBK / 8;   // n8 tiles of a key tile
constexpr float kLog2e = 1.44269504088896341f;

// bf16 per shared-memory row: 16 bytes of padding put the 8 rows an
// ldmatrix reads in distinct banks for every D (row strides of 9, 5, 3
// and 17 chunks of 16 bytes)
template <int D>
__host__ __device__ constexpr int mma_ld() {
  return D + 8;
}

template <int D>
constexpr size_t mma_smem_bytes() {
  // q, then for each warp group two stages of k and two of v
  return sizeof(__nv_bfloat16) * mma_ld<D>() *
         (kMmaBQ + kSplit * 4 * kMmaBK);
}

// c += a (16 x 16, row) * b (16 x 8, col): bf16 products, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory is addressed by 32-bit offsets computed once, so the loop
// does not convert generic pointers again and again.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// the threads of warp group `group` meet (barrier 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kGroupThreads)
               : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, one row address a lane
// (lanes 8i .. 8i + 7 give matrix i's rows); .trans hands each thread the
// transposed element pairs.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 2^x on the special-function unit (relative error under 2^-22; results
// below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as the high and the low bfloat16 parts of an A-fragment
// register (x0 in the low half): hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Rows [t0, t0 + ROWS) of a bf16 [n, D] slab (row stride ld elements,
// every row 16-byte aligned) into shared-memory rows of mma_ld<D>() bf16
// at byte offset dst, by 16-byte cp.async copies of THREADS threads (this
// one is `tid`); rows at or past n are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           long long ld, int t0, int n,
                                           int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kIters = (ROWS * kChunks + THREADS - 1) / THREADS;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * THREADS;
    if (ROWS * kChunks % THREADS != 0 && i >= ROWS * kChunks) break;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = t0 + r < n;
    cp_async16(dst + 2 * (r * mma_ld<D>() + c),
               src + (ok ? t0 + r : 0) * ld + c, ok);
  }
}

// max and sum of N values, as a tree (log2 N dependent steps, not N)
template <int N>
__device__ __forceinline__ float tree_max(float (&v)[N]) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] = fmaxf(v[j], v[j + w]);
  }
  return v[0];
}
template <int N>
__device__ __forceinline__ float tree_sum(float (&v)[N]) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] += v[j + w];
  }
  return v[0];
}

// What a warp carries across key tiles: its q fragments, o's C fragments
// (rows g and g + 8 at columns 8n + 2t, 8n + 2t + 1: acc[n][0..1] and
// acc[n][2..3]), and for the two rows the running max and this thread's
// part of the running sum.
template <int D>
struct MmaState {
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
  float m[2], l[2];
};

// Where a warp is: its first and last query row, its lane's quad row g and
// column t, and the byte offsets of the rows its lane hands ldmatrix.
struct WarpCtx {
  int w0, w_last, g, t;
  uint32_t k_lane, v_lane;
  int kv_end, causal;
  float scale;
};

// One key tile of keys k0 .. k0 + kMmaBK - 1, staged at byte offsets kt
// and vt.  kEdge: the tile holds kv_end or crosses the warp's causal
// diagonal, so it is masked, and its n8 pairs wholly above the warp's
// rows are skipped; every other tile runs without either.
template <int D, bool kEdge>
__device__ __forceinline__ void mma_tile(MmaState<D>& st, const WarpCtx& c,
                                         uint32_t kt, uint32_t vt, int k0) {
  constexpr int kLdB = 2 * mma_ld<D>();   // bytes per shared-memory row
  constexpr int kSteps = D / 16;          // k16 steps of q k^T over d
  constexpr int kDT = D / 8;              // n8 tiles of o over d
  bool live[kNT / 2];
#pragma unroll
  for (int jp = 0; jp < kNT / 2; ++jp) {
    live[jp] = !kEdge || !c.causal || k0 + 16 * jp <= c.w_last;
  }

  // s = q k^T: n8 tile j holds keys k0 + 8j .. k0 + 8j + 7
  float s[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
  }
#pragma unroll
  for (int s16 = 0; s16 < kSteps; ++s16) {
    uint32_t kb[kNT / 2][4];        // every fragment first, then the MMAs
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      if (live[jp]) ldsm_x4(kb[jp], kt + c.k_lane + 16 * jp * kLdB + 32 * s16);
    }
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      if (live[jp]) {
        mma_bf16(s[2 * jp], st.qf[s16], kb[jp][0], kb[jp][1]);
        mma_bf16(s[2 * jp + 1], st.qf[s16], kb[jp][2], kb[jp][3]);
      }
    }
  }

  // scale as the plain version does, mask, and the online-softmax step of
  // rows g (r = 0) and g + 8 (r = 1): p = 2^((s - m) log2 e)
  auto masked = [&](int j, int e) {
    const int kp = k0 + 8 * j + 2 * c.t + (e & 1);
    const int qp = c.w0 + c.g + 8 * (e >> 1);
    return kp >= c.kv_end || (c.causal && kp > qp);
  };
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= c.scale;
      if (kEdge && masked(j, e)) s[j][e] = kNegInf;
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[kNT];
#pragma unroll
    for (int j = 0; j < kNT; ++j) v[j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
    float mx = tree_max(v);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float new_m = fmaxf(st.m[r], mx);
    alpha[r] = ex2((st.m[r] - new_m) * kLog2e);
    st.m[r] = new_m;
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2((s[j][e] - st.m[e >> 1]) * kLog2e);
      s[j][e] = kEdge && masked(j, e) ? 0.0f : p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[kNT];
#pragma unroll
    for (int j = 0; j < kNT; ++j) v[j] = s[j][2 * r] + s[j][2 * r + 1];
    st.l[r] = st.l[r] * alpha[r] + tree_sum(v);
  }
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
    st.acc[n][0] *= alpha[0];
    st.acc[n][1] *= alpha[0];
    st.acc[n][2] *= alpha[1];
    st.acc[n][3] *= alpha[1];
  }

  // o += p v: keys 16kk .. 16kk + 15 are n8 tiles 2kk and 2kk + 1 of s,
  // whose C fragments are the A fragment of one m16k16 product
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    if (!live[kk]) continue;                             // p is 0 there
    uint32_t vb[kDT / 2][4];
#pragma unroll
    for (int n2 = 0; n2 < kDT / 2; ++n2) {
      ldsm_x4_trans(vb[n2], vt + c.v_lane + 16 * kk * kLdB + 32 * n2);
    }
    uint32_t ph[4], pl[4];
    split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
    split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
    split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
    split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
    // the high parts into every n8 tile of o, then the low parts: no
    // product waits on the one before it
#pragma unroll
    for (int n2 = 0; n2 < kDT / 2; ++n2) {
      mma_bf16(st.acc[2 * n2], ph, vb[n2][0], vb[n2][1]);
      mma_bf16(st.acc[2 * n2 + 1], ph, vb[n2][2], vb[n2][3]);
    }
#pragma unroll
    for (int n2 = 0; n2 < kDT / 2; ++n2) {
      mma_bf16(st.acc[2 * n2], pl, vb[n2][0], vb[n2][1]);
      mma_bf16(st.acc[2 * n2 + 1], pl, vb[n2][2], vb[n2][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(Args a) {
  constexpr int kLdB = 2 * mma_ld<D>();   // bytes per shared-memory row
  constexpr int kStageB = kMmaBK * kLdB;  // bytes of one k or v stage
  constexpr int kDT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / kWarps, gwarp = warp % kWarps;
  const int gtid = threadIdx.x % kGroupThreads;
  // q, then each group's two stages of k and two of v
  const uint32_t qs = smem_u32(smem_raw);
  const uint32_t ks = qs + kMmaBQ * kLdB + group * 4 * kStageB;
  const uint32_t vs = ks + 2 * kStageB;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // causal: the query tiles with the most key tiles are handed out first
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kMmaBQ;
  WarpCtx c;
  c.w0 = q0 + 16 * gwarp;
  c.w_last = c.w0 + 15;
  c.g = lane >> 2;
  c.t = lane & 3;
  c.k_lane = ((lane & 7) + 8 * (lane >> 4)) * kLdB + 16 * ((lane >> 3) & 1);
  c.v_lane = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLdB + 16 * (lane >> 4);
  c.kv_end = a.kv_end;
  c.causal = a.causal;
  c.scale = a.scale;
  const bool warp_live = c.w0 < a.T;

  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs[0] + h * a.vs[1];
  bf16* o = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];

  // live key tiles: those holding a key below kv_end and, when causal, at
  // or below the block's last query row; group 0 walks the first half of
  // them, group 1 the rest, and their partial results merge at the end
  const int q_last = min(q0 + kMmaBQ, a.T) - 1;
  int n_tiles = (a.kv_end + kMmaBK - 1) / kMmaBK;
  if (a.causal) n_tiles = min(n_tiles, q_last / kMmaBK + 1);
  const int lo = (n_tiles * group + kSplit - 1) / kSplit;
  const int cnt = (n_tiles * (group + 1) + kSplit - 1) / kSplit - lo;

  MmaState<D> st;
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[n][e] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m[r] = kNegInf;
    st.l[r] = 0.0f;
  }

  if (n_tiles > 0) {
    stage_rows<D, kMmaBQ, kMmaThreads>(qs, q, a.qs[2], q0, a.T, threadIdx.x);
    if (cnt > 0) {
      const int k1 = lo * kMmaBK;
      stage_rows<D, kMmaBK, kGroupThreads>(ks, k, a.ks[2], k1, a.kv_end, gtid);
      stage_rows<D, kMmaBK, kGroupThreads>(vs, v, a.vs[2], k1, a.kv_end, gtid);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();      // q and each group's first tile are in
    if (warp_live) {
      const uint32_t q_lane = qs + (16 * gwarp + (lane & 7)
                                    + 8 * ((lane >> 3) & 1)) * kLdB
                              + 16 * (lane >> 4);
#pragma unroll
      for (int s16 = 0; s16 < D / 16; ++s16) {
        ldsm_x4(st.qf[s16], q_lane + 32 * s16);
      }
    }
  }

  for (int i = 0; i < cnt; ++i) {
    if (i > 0) {
      cp_async_wait_all();
      group_sync(group);  // tile i is in; the group is done with i - 1
    }
    if (i + 1 < cnt) {
      const int k1 = (lo + i + 1) * kMmaBK;
      const uint32_t next = ((i + 1) & 1) * kStageB;
      stage_rows<D, kMmaBK, kGroupThreads>(ks + next, k, a.ks[2], k1,
                                           a.kv_end, gtid);
      stage_rows<D, kMmaBK, kGroupThreads>(vs + next, v, a.vs[2], k1,
                                           a.kv_end, gtid);
      cp_async_commit();
    }
    if (!warp_live) continue;
    const int k0 = (lo + i) * kMmaBK;
    const uint32_t cur = (i & 1) * kStageB;
    if (k0 + kMmaBK > a.kv_end || (a.causal && k0 + kMmaBK - 1 > c.w0)) {
      mma_tile<D, true>(st, c, ks + cur, vs + cur, k0);
    } else {
      mma_tile<D, false>(st, c, ks + cur, vs + cur, k0);
    }
  }

  // group 1 hands its (m, l, o) to the thread of group 0 that holds the
  // same fragments, through its own stages, and group 0 merges them
  constexpr int kFields = 4 + 4 * kDT;
  static_assert(kFields * kGroupThreads * 4 <= 4 * kStageB, "xchg room");
  float* x = reinterpret_cast<float*>(smem_raw + kMmaBQ * kLdB +
                                      4 * kStageB) + gtid;
  __syncthreads();      // every group is done with its stages
  if (group == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      x[r * kGroupThreads] = st.m[r];
      x[(2 + r) * kGroupThreads] = st.l[r];
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[(4 + 4 * n + e) * kGroupThreads] = st.acc[n][e];
      }
    }
  }
  __syncthreads();
  if (group == 1) return;
  float w0[2], w1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = x[r * kGroupThreads];
    const float new_m = fmaxf(st.m[r], m1);
    w0[r] = ex2((st.m[r] - new_m) * kLog2e);
    w1[r] = ex2((m1 - new_m) * kLog2e);
    st.m[r] = new_m;
    st.l[r] = st.l[r] * w0[r] + x[(2 + r) * kGroupThreads] * w1[r];
  }
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      st.acc[n][e] = st.acc[n][e] * w0[e >> 1] +
                     x[(4 + 4 * n + e) * kGroupThreads] * w1[e >> 1];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = st.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qp = c.w0 + c.g + 8 * r;
    if (qp >= a.T) continue;
    const float inv = 1.0f / fmaxf(l, 1e-12f);
    bf16* orow = o + qp * a.os[2] + 2 * c.t;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(st.acc[n][2 * r] * inv,
                                st.acc[n][2 * r + 1] * inv);
    }
    if (c.t == 0) {
      a.l[static_cast<long long>(bh) * a.T + qp] = l;
      a.m[static_cast<long long>(bh) * a.T + qp] = st.m[r];
    }
  }
}

template <int D>
int launch_mma(const Args& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  if constexpr (smem > 48 * 1024) {
    // above 48 KB a block gets dynamic shared memory only after opting in
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(bh, (a.T + kMmaBQ - 1) / kMmaBQ);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(a);
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

int launch_f32(const Args& a, int bh, int D, cudaStream_t stream) {
  if (!rows_aligned16<float>(a) || (a.T + kBQ - 1) / kBQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 16:
      return launch<16>(a, bh, stream);
    case 32:
      return launch<32>(a, bh, stream);
    case 64:
      return launch<64>(a, bh, stream);
    case 128:
      return launch<128>(a, bh, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_bf16(const Args& a, int bh, int D, cudaStream_t stream) {
  if (!rows_aligned16<__nv_bfloat16>(a) ||
      (a.T + kMmaBQ - 1) / kMmaBQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 16:
      return launch_mma<16>(a, bh, stream);
    case 32:
      return launch_mma<32>(a, bh, stream);
    case 64:
      return launch_mma<64>(a, bh, stream);
    case 128:
      return launch_mma<128>(a, bh, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

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
      return launch_f32(a, B * H, D, s);
    case kBF16:
      return launch_bf16(a, B * H, D, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
