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
// What bounds it on this card: at the language models' shapes (D = 64,
// causal; T = 80 or 512 in bfloat16, T = 32 in float32) the bytes it must
// move (q, k, v read once, o, l, m written once: 2.7, 4.3 and 0.26 MB)
// take about a microsecond or less at 3.35 TB/s and its products a
// twentieth of that on the tensor cores (float32: 1.1 MFLOP, 0.02 us on
// the CUDA cores), less than a launch.  So the kernel is bound by
// latency: the launch, one round trip to device memory, and the chain of
// products, exponentials and shuffles that the longest block walks, one
// key tile after another (8 tiles of 64 keys for the last query rows at
// T = 512, 1 or 2 at T = 80, one at T = 32).
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
//  * float32 (flash_fwd_kernel): both products with float32 FMAs (the
//    tensor cores would round to TF32), sized for the fed-LLM plane's
//    short sequences ([4 * 2, 32, 64] at its eval: 8 (b, h) pairs).  A
//    block owns 16 query rows (4 warps of 4 rows: 16 blocks at T = 32,
//    where 64-row blocks made 8 on 132 SMs, half their rows padding), and
//    8 lanes share a row: lane c computes the scores of keys c + 8j, each
//    one fmaf chain over d = 0 .. D-1 in order from q (scaled as it
//    lands) and k rows in shared memory, as the plain version's float32
//    product sums them (a split of d over the lanes summed by shuffles,
//    though more accurate, strays from its bits by more than the
//    tolerance at scores of 200); the row's max and sum meet by three
//    xor shuffles; p v takes key 8j + src's p from lane src by a shuffle
//    (no trip through shared memory, no barrier), and lane c owns o's
//    columns (c + 8i) * 4.  q, k and v go straight into shared memory by
//    16-byte cp.async copies, one 64-key tile ahead while the last is
//    used, and only the keys the block can see: the tile is as long as
//    the sequence up to 64 keys (one group of copies at T = 32), and each
//    warp walks its keys in groups of 8 up to its last row's causal
//    diagonal or t_valid (16 or 32 keys at T = 32, not 64).  One barrier
//    a tile, and one more before a stage is refilled.  The 64-key tiles,
//    the sums and their order are the first version's, and the masked
//    keys it skips added only zeros there, so o, l and m keep its bits.
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

// ------------------------------------------------- cp.async, both kernels
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
// all but the last committed group have landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// ------------------------------------------------- float32: fmaf kernel
constexpr int kRowLanes = 8;                       // lanes sharing one row
constexpr int kF32Warps = 4;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kWarpRows = 32 / kRowLanes;          // 4 query rows a warp
constexpr int kF32BQ = kWarpRows * kF32Warps;      // 16 query rows a block
constexpr int kF32BK = 64;                         // keys of a tile
constexpr int kKeysPerLane = kF32BK / kRowLanes;   // lane c: keys c + 8j

// max and sum over the 8 lanes of a row group (lanes 8g .. 8g + 7)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 1; off < kRowLanes; off <<= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 1; off < kRowLanes; off <<= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// floats of a shared-memory row of q, k or v: 16 bytes of padding put the
// 8 rows that a row group's lanes read at once (keys c + 8j) in distinct
// banks (row strides of 5, 9, 17 and 33 chunks of 16 bytes)
template <int D>
__host__ __device__ constexpr int f32_ld() {
  return D + 4;
}

// Lane c's output columns of a D-wide row: kPieces pieces of kW floats,
// piece i at column (c + 8 i) kW, so the 8 lanes of a row group read 8 kW
// neighbouring floats a piece (no bank conflict; the 4 groups of a warp
// read the same v row at once: a broadcast).
template <int D>
struct Slice {
  static constexpr int kW = D >= 32 ? 4 : 2;
  static constexpr int kPieces = D / (kW * kRowLanes);
  static constexpr int kN = kW * kPieces;          // D / 8 floats a lane
  static_assert(kPieces >= 1 && D % (kW * kRowLanes) == 0, "head dim");

  __device__ __forceinline__ static void load(const float* row, int c,
                                              float (&x)[kN]) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const float* p = row + (c + kRowLanes * i) * kW;
      if constexpr (kW == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        x[4 * i] = v.x;
        x[4 * i + 1] = v.y;
        x[4 * i + 2] = v.z;
        x[4 * i + 3] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(p);
        x[2 * i] = v.x;
        x[2 * i + 1] = v.y;
      }
    }
  }

  __device__ __forceinline__ static void store(float* row, int c,
                                               const float (&x)[kN]) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      float* p = row + (c + kRowLanes * i) * kW;
      if constexpr (kW == 4) {
        *reinterpret_cast<float4*>(p) =
            make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
      } else {
        *reinterpret_cast<float2*>(p) = make_float2(x[2 * i], x[2 * i + 1]);
      }
    }
  }
};

// s[j] = q_row . k_row(c + 8j) for the first NJ of the lane's keys: one
// fmaf chain a key over d = 0 .. D-1 in order, as the products of the
// plain version's float32 matrix product are summed; q (already scaled)
// and k read as float4 from shared memory
template <int D, int NJ>
__device__ __forceinline__ void scores(const float* qrow, const float* krow,
                                       float (&s)[kKeysPerLane]) {
  constexpr int kLd = f32_ld<D>();
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(
          krow + j * kRowLanes * kLd + d);
      s[j] = fmaf(qv.x, kv.x, s[j]);
      s[j] = fmaf(qv.y, kv.y, s[j]);
      s[j] = fmaf(qv.z, kv.z, s[j]);
      s[j] = fmaf(qv.w, kv.w, s[j]);
    }
  }
}

// rows of a shared-memory key tile: the keys a block can see, in whole
// groups of 8, up to a full tile (T = 32 takes 32 rows, not 64)
__host__ __device__ inline int f32_tile_rows(int kv_max) {
  const int r = (kv_max + kRowLanes - 1) / kRowLanes * kRowLanes;
  return r < kF32BK ? (r < kRowLanes ? kRowLanes : r) : kF32BK;
}

// keys any block of the launch can see: below kv_end and, when causal, at
// or below the last query row
__host__ __device__ inline int f32_kv_max(int causal, int kv_end, int T) {
  return causal ? (kv_end < T ? kv_end : T) : kv_end;
}

// s = (q * scale) k^T: q is scaled as it lands, as the TPU kernel does
template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_kernel(Args a) {
  using S = Slice<D>;
  constexpr int kLd = f32_ld<D>();
  constexpr int kRowPieces = D / 4;          // 16-byte pieces of a row
  extern __shared__ __align__(16) float f32_smem[];
  // q [kF32BQ][kLd], then one or two stages of a k tile and a v tile
  const int tile_rows = f32_tile_rows(f32_kv_max(a.causal, a.kv_end, a.T));
  const int tile = tile_rows * kLd;
  float* Qs = f32_smem;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // causal blocks with the most key tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = lane % kRowLanes;
  const int r_blk = warp * kWarpRows + lane / kRowLanes;   // row in block
  const int w0 = q0 + warp * kWarpRows;
  const int qp = q0 + r_blk;                 // this lane's query row
  const bool warp_live = w0 < a.T;

  // keys the block loads, keys the warp's rows may see, keys this row sees
  const int q_last = min(q0 + kF32BQ, a.T) - 1;
  const int kv_lim = a.causal ? min(a.kv_end, q_last + 1) : a.kv_end;
  const int n_tiles = (kv_lim + tile_rows - 1) / tile_rows;
  const int warp_hi =
      a.causal ? min(a.kv_end, min(w0 + kWarpRows, a.T)) : a.kv_end;
  const int row_hi = a.causal ? min(a.kv_end, qp + 1) : a.kv_end;

  const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const float* v = static_cast<const float*>(a.v) + b * a.vs[0] + h * a.vs[1];
  float* o = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];

  // key tile t into stage t % 2 by 16-byte cp.async copies straight into
  // shared memory: its rows below kv_lim, then zeros up to the next whole
  // group of 8 keys (a warp runs whole groups)
  const long long k_ld = a.ks[2], v_ld = a.vs[2];
  const uint32_t stage0 = smem_u32(Qs + kF32BQ * kLd);
  auto issue = [=](int t) {
    const int k0 = t * tile_rows;
    const int real = min(tile_rows, kv_lim - k0);
    const int rows = min(tile_rows, (real + kRowLanes - 1) / kRowLanes *
                                        kRowLanes);
    const uint32_t ks = stage0 + sizeof(float) * (t & 1) * 2 * tile;
    const uint32_t vs = ks + sizeof(float) * tile;
    for (int i = tid; i < rows * kRowPieces; i += kF32Threads) {
      const int r = i / kRowPieces, p = i % kRowPieces;
      const bool ok = r < real;
      const long long t_ = ok ? k0 + r : 0;
      const uint32_t off = sizeof(float) * (r * kLd + p * 4);
      cp_async16(ks + off, k + t_ * k_ld + p * 4, ok);
      cp_async16(vs + off, v + t_ * v_ld + p * 4, ok);
    }
  };
  // the block's q rows (zeros past T) in the same group as tile 0
  const uint32_t qs_u = smem_u32(Qs);
  const long long q_ld = a.qs[2];
  if (n_tiles > 0) {
    for (int i = tid; i < kF32BQ * kRowPieces; i += kF32Threads) {
      const int r = i / kRowPieces, p = i % kRowPieces;
      const bool ok = q0 + r < a.T;
      cp_async16(qs_u + sizeof(float) * (r * kLd + p * 4),
                 q + (ok ? q0 + r : 0) * q_ld + p * 4, ok);
    }
    issue(0);
    cp_async_commit();
  }

  float acc[S::kN];
#pragma unroll
  for (int e = 0; e < S::kN; ++e) acc[e] = 0.0f;
  float m_run = kNegInf, l_run = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      issue(t + 1);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    if (t == 0) {
      // each thread scales the q pieces it copied itself
      for (int i = tid; i < kF32BQ * kRowPieces; i += kF32Threads) {
        float* p = Qs + (i / kRowPieces) * kLd + (i % kRowPieces) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] *= a.scale;
      }
    }
    __syncthreads();
    const int k0 = t * tile_rows;
    const int lim = warp_live ? min(tile_rows, warp_hi - k0) : 0;
    if (lim > 0) {
      const float* ks = Qs + kF32BQ * kLd + (t & 1) * 2 * tile;
      const float* vs = ks + tile;
      const int nj = (lim + kRowLanes - 1) / kRowLanes;
      // s for keys c + 8j, each lane a chain over d a key
      float s[kKeysPerLane];
      const float* qrow = Qs + r_blk * kLd;
      const float* krow = ks + c * kLd;
      switch (nj) {
        case 1: scores<D, 1>(qrow, krow, s); break;
        case 2: scores<D, 2>(qrow, krow, s); break;
        case 3: scores<D, 3>(qrow, krow, s); break;
        case 4: scores<D, 4>(qrow, krow, s); break;
        case 5: scores<D, 5>(qrow, krow, s); break;
        case 6: scores<D, 6>(qrow, krow, s); break;
        case 7: scores<D, 7>(qrow, krow, s); break;
        default: scores<D, 8>(qrow, krow, s); break;
      }
      // mask, then the online-softmax step of each row
      bool ok[kKeysPerLane];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        if (j < nj) {
          ok[j] = k0 + c + kRowLanes * j < row_hi;
          if (!ok[j]) s[j] = kNegInf;
          mx = fmaxf(mx, s[j]);
        }
      }
      const float new_m = fmaxf(m_run, group_max(mx));
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        if (j < nj) {
          s[j] = ok[j] ? expf(s[j] - new_m) : 0.0f;
          psum += s[j];
        }
      }
      const float alpha = expf(m_run - new_m);
      l_run = l_run * alpha + group_sum(psum);
#pragma unroll
      for (int e = 0; e < S::kN; ++e) acc[e] *= alpha;
      m_run = new_m;
      // o += p v on the lane's columns, keys in order: key 8j + src's p
      // comes from lane src of the row group
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        if (j < nj) {
#pragma unroll
          for (int src = 0; src < kRowLanes; ++src) {
            const float p = __shfl_sync(0xffffffffu, s[j], src, kRowLanes);
            float vx[S::kN];
            S::load(vs + (kRowLanes * j + src) * kLd, c, vx);
#pragma unroll
            for (int e = 0; e < S::kN; ++e) acc[e] = fmaf(p, vx[e], acc[e]);
          }
        }
      }
    }
    if (t + 1 < n_tiles) __syncthreads();   // the stage is free again
  }

  if (qp >= a.T) return;
  const float denom = fmaxf(l_run, 1e-12f);
#pragma unroll
  for (int e = 0; e < S::kN; ++e) acc[e] = acc[e] / denom;
  S::store(o + qp * a.os[2], c, acc);
  if (c == 0) {
    a.l[static_cast<long long>(bh) * a.T + qp] = l_run;
    a.m[static_cast<long long>(bh) * a.T + qp] = m_run;
  }
}

template <int D>
int launch(const Args& a, int bh, cudaStream_t stream) {
  // q, and two stages where a block walks more than one key tile
  const int kv_max = f32_kv_max(a.causal, a.kv_end, a.T);
  const int rows = f32_tile_rows(kv_max);
  const size_t smem = sizeof(float) * f32_ld<D>() *
                      (kF32BQ + (kv_max > rows ? 4 : 2) * rows);
  if (smem > 48 * 1024) {
    // above 48 KB a block gets dynamic shared memory only after opting in
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(bh, (a.T + kF32BQ - 1) / kF32BQ);
  flash_fwd_kernel<D><<<grid, kF32Threads, smem, stream>>>(a);
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
  // o is written by 16-byte stores too (8-byte ones at D = 16)
  if (!rows_aligned16<float>(a) || reinterpret_cast<uintptr_t>(a.o) % 16 ||
      a.os[0] % 4 || a.os[1] % 4 || a.os[2] % 4 ||
      (a.T + kF32BQ - 1) / kF32BQ > 65535) {
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
