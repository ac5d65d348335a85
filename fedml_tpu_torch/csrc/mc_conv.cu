// Multi-client SAME convolution, forward and weight gradient, written for
// Hopper (sm_90a).
//
// Replaces the two Pallas kernels of fedml_tpu/ops/pallas_mc_conv.py:
//
//   fwd_mma_kernel and fwd_wgmma_kernel (bfloat16), fwd_kernel (float32)
//                <- _fwd_kernel (:71, launched by _mc_conv_fwd).  For K
//                   clients, each with its own weights,
//                   y[k, b, oy, ox, co] = sum over (dy, dx, ci) of
//                   x[k, b, oy*sh + dy - pt, ox*sw + dx - pl, ci]
//                     * w[k, dy, dx, ci, co]
//                   with x read as 0 outside [0, H) x [0, W) (SAME padding:
//                   pt = ph / 2, pl = pw / 2 of the total pads).  x is
//                   [K, B, H, W, Ci] and w [K, kh, kw, Ci, Co], float32 or
//                   bfloat16; the products and sums are float32 and y,
//                   [K, B, OH, OW, Co], has x's type.
//   wgrad_mma_kernel and wgrad_wgmma_kernel (bfloat16), wgrad_kernel
//   (float32), each followed by sum_splits_kernel where a client's pixels
//   are split over more blocks than one reduction holds
//                <- _wgrad_kernel (:85, launched by _mc_conv_wgrad).
//                   dw[k, dy, dx, ci, co] = sum over (b, oy, ox) of the
//                   same shifted x times g[k, b, oy, ox, co], in float32.
//
// Each is an implicit GEMM per client.  The forward's is [M, D] x [D, Co]
// with M = B*OH*OW output pixels and depth D = kh*kw*Ci; the rows of the
// [M, D] operand (the im2col patches) are read from x inside the block at
// each tap's offset, with the halo zero, so neither a padded copy of x nor
// the patches ever reach device memory (the JAX wrapper pads x with
// jnp.pad; the TPU kernel builds the patches in VMEM).  The weight
// gradient is, per tap, [Ci, M] x [M, Co]: a long reduction over M into a
// small output.
//
// What bounds them on an H100 ("NVIDIA H100 80GB HBM3, 700.00 W"), at
// ResNet-56's shapes in bfloat16 (K = 10 clients, batch 32): by the
// compulsory bytes and the bf16 tensor-core rate every shape is bound by
// its bytes, 1.2-6.3 us (a 3x3 16 -> 16 conv on 32x32 moves 21 MB; its
// 1.51 GFLOP take 1.5 us at 989 TFLOP/s).  Measured (profile_mc_conv.py,
// cold L2), the kernels take 11-33 us, 9-26 % of that bound, and what
// holds them is how fast each SM gets its tiles into shared memory: a
// tile's cp.async copies stall their issuing warps for about as long as
// the tensor cores take for the tile (at 8x8 64 -> 64 about 0.8 and 0.9
// us), so a kernel's time is about a tile's copies plus its products
// times the tiles of its busiest SM, after a start of 2-3 us (the first
// copies from device memory).  Deeper rings (4 stages), other tile sizes
// and half the copies change nothing; on mma.sync the products
// themselves were the other half (latency-bound chains of ldmatrix and
// mma.sync, and 4 float32 adds per mma in the weight gradient), which
// wgmma removes at 8x8 64 -> 64.  float32 inputs, which the tensor cores
// would round to TF32, run on the float32 units with fmaf.
//
// What the design does about that:
//  * Forward, bfloat16: one block per (client, tile of up to 64 output
//    channels) keeps its weights in shared memory (73.7 KB at 3x3 64 ->
//    64, read once a block instead of once a tile) and walks its share of
//    that client's 128-pixel output tiles (two 8x8 images), their input
//    regions streamed through a ring of 3 cp.async buffers, the next
//    tiles' copies in flight while the tensor cores work.  Blocks share
//    the card's slots evenly.  fwd_mma_kernel: mma.sync m16n8k16, each
//    warp 32 pixels x up to 32 channels, the next step's fragments loaded
//    during the current one's products.  fwd_wgmma_kernel, where an output
//    row is 8 pixels (8x8 images, stride 1): the region is staged
//    channel-chunk-major, so a tap's 64-pixel A is 8 core matrices at one
//    output row's stride, and wgmma m64n64k16 reads A and B from shared
//    memory, a tile's 36 products issued back to back.
//  * Weight gradient, bfloat16, every stride: a block stages each tile (64
//    to 256 output pixels) once, x's region for all the block's input
//    channels and g, and all its warps take their work from that one copy.
//    wgrad_mma_kernel: 8 warps of (16 ci x 16 co x every tap) warp tiles
//    and pixel groups; ldmatrix takes one row address a lane, so a
//    16-pixel step gathers pixels from two image rows (8x8 images) or
//    every other column (stride 2) with no padding, and strided convs run
//    on the tensor cores; two steps chain in the tensor cores before each
//    IEEE float32 add.  wgrad_wgmma_kernel, 3x3 stride 1 with Ci and Co
//    multiples of 64 (8x8 64 -> 64): 3 warpgroups, one a kernel row, each
//    a 64 x 64 accumulator per tap, A (x^T at the tap's offset) and B (g)
//    from shared memory, staged channel-chunk-major.  The M reduction: the
//    blocks that split one client's pixels form a thread-block cluster (up
//    to 16, as many as the card holds at once) and add their float32 sums
//    through distributed shared memory in rank order, in one launch; only
//    where a client needs more blocks than that (few clients, long M) do T
//    > 1 clusters write float32 partials that sum_splits_kernel adds in
//    order.
//  * The stem's 3 channels are no 16-byte copy a pixel: its image rows are
//    (3 x 32 bf16), so they go whole into a raw ring with cp.async and are
//    spread into the region layout in shared memory (stage_raw,
//    expand_raw).
//  * float32, and bfloat16 shapes the tensor-core kernels do not take (Co
//    not a multiple of 8 for the gradient, kernel sizes other than 1x1,
//    2x2 and 3x3 for it, an image row too long for a tile): fwd_kernel
//    gathers the patch rows 16 depth values at a time into float32 shared
//    memory (the next chunk's loads in flight during the products);
//    wgrad_kernel stages each band's region and g as float32, and a thread
//    shares each g value across a row of 3 taps whose x values slide along
//    the row; both multiply 4 x 4 register tiles with fmaf.  Its M
//    reduction writes S float32 partials that sum_splits_kernel adds in
//    order 0..S-1.  No atomics anywhere: results are the same from run to
//    run.
//
// -fmad=false (the repo's flag for every source, ops/cuda_build.py) stops
// nvcc from contracting a separate product and sum; it does not split an
// explicit fmaf or touch the tensor cores, so it costs these kernels
// nothing: their products are fmaf or mma, and their only separate float
// sums (the mma partials, the groups' and the splits' partials) are sums.
//
// Plain C interface for ctypes.  Every launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;     // depth of a forward chunk
constexpr int kPad = 4;     // floats of padding after a shared-memory row

enum DtypeCode { kF32 = 0, kBF16 = 1 };

struct Geom {
  int B, H, W, Ci, OH, OW, Co, kh, kw, sh, sw, pt, pl;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// acc[i][j] += a[i] * b[j]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// ------------------------------------------ the forward on the float32 units
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
           Geom g) {
  constexpr int kTX = BN / 4;                // threads along Co
  constexpr int kTY = kThreads / kTX;        // threads along M
  constexpr int kBM = 4 * kTY;               // output pixels of a block
  constexpr int kLda = kBM + kPad;
  constexpr int kLdb = BN + kPad;
  constexpr int kARows = kBM * kBK / kThreads;   // patch values a thread loads
  constexpr int kBVals = BN * kBK / kThreads;    // weight values a thread loads
  constexpr int kRowStep = kThreads / kBK;
  __shared__ __align__(16) float As[kBK * kLda];   // [depth][pixel]
  __shared__ __align__(16) float Bs[kBK * kLdb];   // [depth][channel]

  const int k = blockIdx.z;
  const int M = g.B * g.OH * g.OW;
  const int D = g.kh * g.kw * g.Ci;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const T* xk = x + static_cast<long long>(k) * g.B * g.H * g.W * g.Ci;
  const T* wk = w + static_cast<long long>(k) * D * g.Co;
  T* yk = y + static_cast<long long>(k) * M * g.Co;

  // the patch values this thread gathers: depth column a_col of each
  // chunk, rows a_row0 + i * kRowStep; each row's (b*H, oy*sh - pt,
  // ox*sw - pl), with rows past M placed far outside the image
  const int a_col = threadIdx.x % kBK;
  const int a_row0 = threadIdx.x / kBK;
  int r_bh[kARows], r_iy[kARows], r_ix[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int m = m0 + a_row0 + i * kRowStep;
    if (m < M) {
      const int b = m / (g.OH * g.OW);
      const int rem = m - b * g.OH * g.OW;
      const int oy = rem / g.OW;
      const int ox = rem - oy * g.OW;
      r_bh[i] = b * g.H;
      r_iy[i] = oy * g.sh - g.pt;
      r_ix[i] = ox * g.sw - g.pl;
    } else {
      r_bh[i] = 0;
      r_iy[i] = -(1 << 30);
      r_ix[i] = 0;
    }
  }

  float a_reg[kARows], b_reg[kBVals];
  auto fetch = [&](int d0) {
    const int d = d0 + a_col;
    const bool d_ok = d < D;
    int c = 0, dy = 0, dx = 0;
    if (d_ok) {
      const int tap = d / g.Ci;
      c = d - tap * g.Ci;
      dy = tap / g.kw;
      dx = tap - dy * g.kw;
    }
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int iy = r_iy[i] + dy, ix = r_ix[i] + dx;
      const bool ok = d_ok && static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
      a_reg[i] = ok ? to_f32(xk[((r_bh[i] + iy) * g.W + ix) * g.Ci + c]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBVals; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int dd = d0 + e / BN, n = n0 + e % BN;
      b_reg[i] = (dd < D && n < g.Co) ? to_f32(wk[dd * g.Co + n]) : 0.0f;
    }
  };

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  float acc[4][4] = {};
  fetch(0);
  for (int d0 = 0; d0 < D; d0 += kBK) {
#pragma unroll
    for (int i = 0; i < kARows; ++i) As[a_col * kLda + a_row0 + i * kRowStep] = a_reg[i];
#pragma unroll
    for (int i = 0; i < kBVals; ++i) {
      const int e = threadIdx.x + i * kThreads;
      Bs[(e / BN) * kLdb + e % BN] = b_reg[i];
    }
    __syncthreads();
    if (d0 + kBK < D) fetch(d0 + kBK);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      outer4(acc, *reinterpret_cast<const float4*>(As + kk * kLda + ty * 4),
             *reinterpret_cast<const float4*>(Bs + kk * kLdb + tx * 4));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.Co) store_f32(acc[i][j], yk + static_cast<long long>(m) * g.Co + n);
    }
  }
}


// ------------------------------------------ tensor-core pieces of both paths
constexpr int kLoads = 8;             // loads in flight a thread
constexpr size_t kMaxSmem = 232448;   // what one block may take on sm_90

// n / d for 0 <= n, d with n * d < 2^32 (every use below: n < 2^20, d <
// 2^12), by a multiply: m = ceil(2^32 / d), n / d = hi32(n * m).  m is 0
// for d = 1.
struct FastDiv {
  uint32_t d, m;
};

FastDiv fast_div(int d) {
  FastDiv f;
  f.d = static_cast<uint32_t>(d);
  f.m = d == 1 ? 0u : static_cast<uint32_t>((0x100000000ULL + d - 1) / d);
  return f;
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return f.m == 0 ? n
                  : static_cast<int>(__umulhi(static_cast<uint32_t>(n), f.m));
}

// c += a (16 x 16, row) * b (16 x 8, col): bf16 products, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` (0 or 1) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending > 0) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
}

// Four 8 x 8 bf16 matrices from shared memory, one row address a lane
// (lanes 8i .. 8i + 7 give matrix i's rows); .trans hands each thread the
// transposed element pairs.  Addresses are shared-window byte offsets.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// The B fragments (16 x 8, col) of NF n-fragments from a k-major tile whose
// row k holds the n values, `ld` bytes apart, from the byte address of row
// 0, column 0: b[j] for n-fragment j, columns 8j.
template <int NF>
__device__ __forceinline__ void load_b(uint32_t (&b)[NF][2], uint32_t k0_row,
                                       int ld, int lane) {
  if (NF == 1) {
    uint32_t r[2];
    ldsm_x2_trans(r, k0_row + (lane & 15) * ld);
    b[0][0] = r[0];
    b[0][1] = r[1];
  } else {
#pragma unroll
    for (int j = 0; j < NF; j += 2) {
      // matrices: (k 0-7, n 8j), (k 8-15, n 8j), (k 0-7, n 8j+8), (k 8-15, n 8j+8)
      uint32_t r[4];
      ldsm_x4_trans(r, k0_row + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
                           16 * (j + (lane >> 4)));
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
  }
}

// How both tensor-core kernels cut one client's output pixels into tiles,
// set by the host (make_tiles).  A tile is R consecutive output rows of one
// image, or, where a whole image has fewer pixels than the tile, `imgs`
// whole images; either way its pixels are consecutive in [B, OH, OW] order.
// Its input region, staged in shared memory, is [imgs][rh][RW] pixels:
// region pixel (i, r, c) is x[b0 + i, iy0 + r * sy, c * sx - pl], zero
// outside the image.  A 1 x 1 kernel strided s reads every s-th row and
// column only, so its region steps s (sy = sh) and output rows sit one
// region row apart (ysh = 1); other kernels read every row (sy = 1) and
// output rows sit sh region rows apart.
struct Tiles {
  int R;          // output rows of an image in a tile
  int imgs;       // images in a tile (R = OH when more than 1)
  int bands;      // tiles of an image, ceil(OH / R)
  int count;      // tiles of one client
  int P;          // output pixels of a full tile, imgs * R * OW
  int Pp;         // P rounded up to 16, the tensor cores' pixel step
  int sy, sx;     // input rows / columns between region rows / columns
  int ysh, xsw;   // region rows / columns between output rows / columns
  int rh, RW;     // region rows of one image, region columns
  FastDiv rpix;   // rh * RW
  FastDiv rw;     // RW
};

// count 0 when an output row is longer than the tile
Tiles make_tiles(const Geom& g, int target) {
  Tiles t{};
  const int npix = g.OH * g.OW;
  if (npix <= target) {
    t.R = g.OH;
    t.imgs = target / npix < g.B ? target / npix : g.B;
    t.bands = 1;
    t.count = (g.B + t.imgs - 1) / t.imgs;
  } else {
    t.R = target / g.OW;
    if (t.R < 1) return Tiles{};
    t.imgs = 1;
    t.bands = (g.OH + t.R - 1) / t.R;
    t.count = g.B * t.bands;
  }
  t.P = t.imgs * t.R * g.OW;
  t.Pp = (t.P + 15) / 16 * 16;
  t.sy = g.kh == 1 ? g.sh : 1;
  t.sx = g.kw == 1 ? g.sw : 1;
  t.ysh = g.kh == 1 ? 1 : g.sh;
  t.xsw = g.kw == 1 ? 1 : g.sw;
  t.rh = (t.R - 1) * t.ysh + g.kh;
  t.RW = (g.OW - 1) * t.xsw + g.kw;
  t.rpix = fast_div(t.rh * t.RW);
  t.rw = fast_div(t.RW);
  return t;
}

// Tile pixel p's region pixel at tap (0, 0); p < P.
__host__ __device__ __forceinline__ int region_pixel(const Geom& g,
                                                     const Tiles& t, int p) {
  const int per_img = t.R * g.OW;
  const int img = p / per_img, rem = p - img * per_img;
  const int oy = rem / g.OW, ox = rem - oy * g.OW;
  return (img * t.rh + oy * t.ysh) * t.RW + ox * t.xsw;
}

// Where tile `tile` of a client lies: its first image and image count, the
// input row of its region row 0, the [B, OH, OW] index of its pixel 0 and
// its valid pixels (a last band may be short, a last run of images too).
struct TileAt {
  int b0, n_img, iy0, base, valid;
};

__device__ __forceinline__ TileAt tile_at(const Geom& g, const Tiles& t,
                                          int tile) {
  TileAt a;
  if (t.bands == 1) {
    a.b0 = tile * t.imgs;
    a.n_img = min(t.imgs, g.B - a.b0);
    a.iy0 = -g.pt;
    a.base = a.b0 * g.OH * g.OW;
    a.valid = a.n_img * g.OH * g.OW;
  } else {
    const int b = tile / t.bands, oy0 = (tile - b * t.bands) * t.R;
    a.b0 = b;
    a.n_img = 1;
    a.iy0 = oy0 * g.sh - g.pt;
    a.base = (b * g.OH + oy0) * g.OW;
    a.valid = min(t.R, g.OH - oy0) * g.OW;
  }
  return a;
}

// Stage a tile's input region, channels [ch0, ch0 + 8 * chunks.d), into
// dst ([imgs][rh][RW][ld] bf16; channels at or past Ci, and pixels outside
// the image or past the tile's images, zero).  16-byte cp.async copies
// where Ci is a multiple of 8, else kLoads scalar loads a thread in flight
// before their stores.
template <int NT>
__device__ __forceinline__ void stage_region(
    __nv_bfloat16* __restrict__ dst, const __nv_bfloat16* __restrict__ xk,
    const Geom& g, const Tiles& t, const TileAt& a, int ch0, FastDiv chunks,
    int ld) {
  const int rpix = t.imgs * t.rh * t.RW;
  if ((g.Ci & 7) == 0) {
    const int total = rpix * static_cast<int>(chunks.d);
    for (int e = threadIdx.x; e < total; e += NT) {
      const int pix = fdiv(e, chunks), cc = e - pix * static_cast<int>(chunks.d);
      const int i = fdiv(pix, t.rpix), rr = pix - i * t.rpix.d;
      const int r = fdiv(rr, t.rw), c = rr - r * t.rw.d;
      const int iy = a.iy0 + r * t.sy, ix = c * t.sx - g.pl, ch = ch0 + cc * 8;
      const bool ok = i < a.n_img && ch < g.Ci &&
                      static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
      cp_async16(dst + pix * ld + cc * 8,
                 ok ? xk + (((a.b0 + i) * g.H + iy) * g.W + ix) * g.Ci + ch : xk,
                 ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    const int width = 8 * static_cast<int>(chunks.d);
    const int total = rpix * width;
    for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * NT) {
      __nv_bfloat16 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * NT;
        const int pix = e / width, ch = ch0 + e - pix * width;
        const int i = fdiv(pix, t.rpix), rr = pix - i * t.rpix.d;
        const int r = fdiv(rr, t.rw), c = rr - r * t.rw.d;
        const int iy = a.iy0 + r * t.sy, ix = c * t.sx - g.pl;
        const bool ok = e < total && i < a.n_img && ch < g.Ci &&
                        static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                        static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
        v[u] = ok ? xk[(((a.b0 + i) * g.H + iy) * g.W + ix) * g.Ci + ch] : zero;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * NT;
        if (e < total) dst[(e / width) * ld + e % width] = v[u];
      }
    }
  }
}

// Where Ci is not a multiple of 8 (the stem's 3 channels) a pixel is no
// 16-byte copy, but an image row of W * Ci bf16 is when W * Ci is a
// multiple of 8: the tile's rows go whole into a raw buffer ([imgs][rh][W *
// Ci], zero for rows outside the image or past the tile's images) with
// cp.async, and expand_raw then spreads them into the region layout.
__host__ __device__ __forceinline__ bool raw_rows(const Geom& g) {
  return (g.Ci & 7) != 0 && (g.W * g.Ci) % 8 == 0;
}

template <int NT>
__device__ __forceinline__ void stage_raw(__nv_bfloat16* __restrict__ raw,
                                          const __nv_bfloat16* __restrict__ xk,
                                          const Geom& g, const Tiles& t,
                                          const TileAt& a) {
  const int row8 = g.W * g.Ci / 8;
  const int total = t.imgs * t.rh * row8;
  for (int e = threadIdx.x; e < total; e += NT) {
    const int row = e / row8, cc = e - row * row8;
    const int i = row / t.rh, r = row - i * t.rh;
    const int iy = a.iy0 + r * t.sy;
    const bool ok = i < a.n_img &&
                    static_cast<unsigned>(iy) < static_cast<unsigned>(g.H);
    cp_async16(raw + e * 8,
               ok ? xk + (((a.b0 + i) * g.H + iy) * g.W) * g.Ci + cc * 8 : xk,
               ok);
  }
}

// The region ([imgs][rh][RW][ld], channels [ch0, ch0 + width)) from a raw
// buffer; zero at or past Ci and outside the image's columns.
template <int NT>
__device__ __forceinline__ void expand_raw(__nv_bfloat16* __restrict__ dst,
                                           const __nv_bfloat16* __restrict__ raw,
                                           const Geom& g, const Tiles& t,
                                           int ch0, int width, int ld) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const int rpix = t.imgs * t.rh * t.RW;
  for (int pix = threadIdx.x; pix < rpix; pix += NT) {
    const int row = fdiv(pix, t.rw), c = pix - row * t.rw.d;
    const int ix = c * t.sx - g.pl;
    const bool in = static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
    const __nv_bfloat16* src = raw + (row * g.W + (in ? ix : 0)) * g.Ci;
    for (int ch = 0; ch < width; ch += 8) {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int cc = ch0 + ch + u;
        v[u] = in && cc < g.Ci ? src[cc] : zero;
      }
      *reinterpret_cast<uint4*>(dst + pix * ld + ch) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

// ------------------------------------ the bfloat16 forward on the tensor cores
// A block's shape on this path, set by the host (plan_fwd and the launch).
struct FwdPlan {
  Tiles t;
  int Cs;        // Ci rounded up to 16: the depth of a tap in shared memory
  int ldr;       // Cs + 8: bf16 per pixel of a staged region
  int bn;        // output channels of a block, 8 per n-fragment
  int ldw;       // bn + 8 (24 at bn 8): bf16 per row of the staged weights
  int co_tiles;  // ceil(Co / bn)
  int nb;        // blocks per (client, channel tile); block j takes tiles
                 // j, j + nb, j + 2 nb, ...
  int stages;    // regions in flight: 2 or 3
  FastDiv c8;    // 16-byte chunks of a staged pixel, Cs / 8
  bool raw;      // rows staged whole, then expanded (raw_rows)
  bool wg;       // the wgmma kernel (output rows of 8 pixels)
  int region;    // bf16 of one staged region, imgs * rh * RW * ldr (* Cs,
                 // chunk-major, for the wgmma kernel)
  int slot;      // bf16 of one ring slot: a region, or raw rows
  size_t smem;   // bytes of dynamic shared memory; 0: no tensor-core path
};

// One block: client k, output channels [co0, co0 + bn), and the tiles j,
// j + nb, ... of that client's pixels (a tile: 128 output pixels).
// The block's weights, [tap * Cs + c][n] (w's own layout), are copied into
// shared memory once and stay there; the tiles' input regions stream
// through a ring of `stages` buffers with cp.async, the next ones in flight
// while the tensor cores work on the current one.  MW x WN warps each
// multiply MF m-fragments of 16 pixels by NF n-fragments of 8 channels
// with mma.sync, walking the taps and 16 channels at a time: ldmatrix
// reads the A fragment straight from the region at the tap's offset (the
// im2col matrix is never formed) and, transposed, the B fragments from
// the weights.  The depth (kh * kw * Ci <= 576 at ResNet-56) accumulates in
// the tensor cores.
template <int MW, int MF, int WN, int NF>
__global__ void __launch_bounds__(32 * MW * WN)
fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ y, Geom g, FwdPlan q) {
  constexpr int kNT = 32 * MW * WN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int taps = g.kh * g.kw;
  const int kps = taps * q.Cs;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kps][ldw]
  // the ring of staged tiles: regions ([imgs * rh * RW][ldr]) or, for raw
  // rows, raw buffers behind the one region they expand into
  __nv_bfloat16* Rs = Ws + kps * q.ldw;
  __nv_bfloat16* ring = q.raw ? Rs + q.region : Rs;

  const int k = blockIdx.y / q.co_tiles;
  const int co0 = (blockIdx.y - k * q.co_tiles) * q.bn;
  const __nv_bfloat16* xk = x + static_cast<long long>(k) * g.B * g.H * g.W * g.Ci;
  const __nv_bfloat16* wk = w + static_cast<long long>(k) * taps * g.Ci * g.Co;
  __nv_bfloat16* yk = y + static_cast<long long>(k) * g.B * g.OH * g.OW * g.Co;
  const int first = blockIdx.x;
  const int n_tiles = first < q.t.count ? (q.t.count - first + q.nb - 1) / q.nb : 0;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // the weights, [tap * Cs + c][n] = w[k, tap, c, co0 + n]: 8 channels a
  // 16-byte copy where Co allows it
  if ((g.Co & 7) == 0) {
    const int n8 = q.bn >> 3;
    for (int e = threadIdx.x; e < kps * n8; e += kNT) {
      const int kp = e / n8, nc = e - kp * n8;
      const int tap = kp / q.Cs, c = kp - tap * q.Cs, co = co0 + nc * 8;
      const bool ok = c < g.Ci && co < g.Co;
      cp_async16(Ws + kp * q.ldw + nc * 8,
                 ok ? wk + (tap * g.Ci + c) * g.Co + co : wk, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kps * q.bn; e += kNT) {
      const int kp = e / q.bn, n = e - kp * q.bn;
      const int tap = kp / q.Cs, c = kp - tap * q.Cs, co = co0 + n;
      Ws[kp * q.ldw + n] =
          (c < g.Ci && co < g.Co) ? wk[(tap * g.Ci + c) * g.Co + co] : zero;
    }
  }
  auto stage = [&](int i) {
    if (i < n_tiles) {
      const TileAt a = tile_at(g, q.t, first + i * q.nb);
      __nv_bfloat16* dst = ring + (i % q.stages) * q.slot;
      if (q.raw) {
        stage_raw<kNT>(dst, xk, g, q.t, a);
      } else {
        stage_region<kNT>(dst, xk, g, q.t, a, 0, q.c8, q.ldr);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s + 1 < q.stages; ++s) stage(s);   // the weights go with 0

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % MW, wn = warp / MW;
  const int gq = lane >> 2, tq = lane & 3;
  // the byte offset in a region, at tap (0, 0), of the fragment row this
  // lane hands ldmatrix (pixel (lane & 7) + 8 * ((lane >> 3) & 1) of the
  // m-fragment, channels from 8 * (lane >> 4)); rows past the tile's
  // pixels read pixel 0 and are never stored
  uint32_t a_off[MF];
#pragma unroll
  for (int j = 0; j < MF; ++j) {
    const int p = (wm * MF + j) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int pix = p < q.t.P ? region_pixel(g, q.t, p) : 0;
    a_off[j] = 2u * (pix * q.ldr + 8 * (lane >> 4));
  }
  const uint32_t ws0 = smem_addr(Ws) + 2u * wn * NF * 8;
  const uint32_t rs0 = smem_addr(Rs);
  const int row_bytes = 2 * q.ldw;
  const int co_lane = co0 + wn * NF * 8 + 2 * tq;
  const bool pairs = (g.Co & 1) == 0;
  const int n_steps = taps * (q.Cs / 16);
  // a step's region offset grows 32 bytes a step, and jumps at the end of
  // a tap to the next column (wrap_c) and at the end of a row of taps to
  // the next region row (wrap_x)
  const uint32_t wrap_c = 2u * (q.ldr - q.Cs);
  const uint32_t wrap_x = 2u * (q.t.RW - g.kw) * q.ldr;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait(q.stages - 2);
    __syncthreads();
    if (q.raw) {
      expand_raw<kNT>(Rs, ring + (i % q.stages) * q.slot, g, q.t, 0, q.Cs,
                      q.ldr);
      __syncthreads();
    }
    stage(i + q.stages - 1);
    const uint32_t rb = rs0 + (q.raw ? 0u : 2u * (i % q.stages) * q.slot);
    float acc[MF][NF][4] = {};
    // the steps (tap, 16 channels), the next one's fragments loaded while
    // the current one's products run: off is the next step's tap and
    // channel offset in the region, c and dx its channel and column
    uint32_t a0[MF][4], a1[MF][4], b0[NF][2], b1[NF][2];
    uint32_t off = 0, wrow = ws0;
    int c = 0, dx = 0;
    auto load = [&](uint32_t (&a)[MF][4], uint32_t (&b)[NF][2]) {
      load_b<NF>(b, wrow, row_bytes, lane);
#pragma unroll
      for (int j = 0; j < MF; ++j) ldsm_x4(a[j], rb + a_off[j] + off);
      wrow += 16 * row_bytes;
      off += 32;
      c += 16;
      if (c == q.Cs) {
        c = 0;
        off += wrap_c;
        if (++dx == g.kw) {
          dx = 0;
          off += wrap_x;
        }
      }
    };
    auto products = [&](const uint32_t (&a)[MF][4], const uint32_t (&b)[NF][2]) {
#pragma unroll
      for (int j = 0; j < MF; ++j) {
#pragma unroll
        for (int n = 0; n < NF; ++n) mma_bf16(acc[j][n], a[j], b[n][0], b[n][1]);
      }
    };
    load(a0, b0);
    for (int st = 0; st < n_steps; st += 2) {
      if (st + 1 < n_steps) load(a1, b1);
      products(a0, b0);
      if (st + 1 < n_steps) {
        if (st + 2 < n_steps) load(a0, b0);
        products(a1, b1);
      }
    }
    const TileAt at = tile_at(g, q.t, first + i * q.nb);
#pragma unroll
    for (int j = 0; j < MF; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wm * MF + j) * 16 + gq + 8 * h;
        if (p >= at.valid) continue;
        __nv_bfloat16* yp = yk + (at.base + p) * g.Co;
#pragma unroll
        for (int n = 0; n < NF; ++n) {
          const int co = co_lane + n * 8;
          const float v0 = acc[j][n][2 * h], v1 = acc[j][n][2 * h + 1];
          if (pairs && co + 1 < g.Co) {
            *reinterpret_cast<__nv_bfloat162*>(yp + co) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (co < g.Co) yp[co] = __float2bfloat16_rn(v0);
            if (co + 1 < g.Co) yp[co + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// The tensor-core forward's plan; smem 0 when it does not fit (an output
// row longer than a tile, or a region and the weights past a block's
// shared memory), and the shape then takes the float32-unit kernel.  Tiles
// are 128 output pixels (two 8x8 images); 4 warps along the pixels, 2
// along the channels where a block takes 64 (each warp 32 pixels x 32
// channels).  nb is set at launch, from the occupancy.
FwdPlan plan_fwd(const Geom& g) {
  FwdPlan q{};
  q.Cs = (g.Ci + 15) / 16 * 16;
  q.ldr = q.Cs + 8;
  q.bn = g.Co <= 8 ? 8 : g.Co <= 16 ? 16 : g.Co <= 32 ? 32 : 64;
  q.ldw = q.bn == 8 ? 24 : q.bn + 8;
  q.co_tiles = (g.Co + q.bn - 1) / q.bn;
  q.c8 = fast_div(q.Cs / 8);
  q.t = make_tiles(g, 128);
  if (q.t.count == 0) return q;
  q.wg = g.OW == 8 && g.OH % 8 == 0 && g.sh == 1 && g.sw == 1 &&
         (g.Ci & 7) == 0 && g.Co % 64 == 0;
  const size_t w_bytes = 2ull * g.kh * g.kw * q.Cs * (q.wg ? 64 : q.ldw);
  q.raw = !q.wg && raw_rows(g);
  q.region = q.t.imgs * q.t.rh * q.t.RW * (q.wg ? q.Cs : q.ldr);
  q.slot = q.raw ? q.t.imgs * q.t.rh * g.W * g.Ci : q.region;
  for (q.stages = 3; q.stages >= 2; --q.stages) {
    q.smem = w_bytes + 2ull * (q.stages * q.slot + (q.raw ? q.region : 0));
    if (q.smem <= kMaxSmem) return q;
  }
  q.smem = 0;
  return q;
}

// Launch a forward kernel: its shared memory set, every (client, channel
// tile) given an equal share of the card's block slots, and its tiles
// dealt to its blocks, the same number to each.
template <typename Kern>
int launch_fwd_on_card(Kern kern, int threads, const void* x, const void* w,
                       void* y, const Geom& g, int K, FwdPlan q, int sms,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(q.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      q.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int groups = K * q.co_tiles;
  int share = sms * per_sm / groups;
  if (share < 1) share = 1;
  const int per_block = (q.t.count + share - 1) / share;
  q.nb = (q.t.count + per_block - 1) / per_block;
  kern<<<dim3(q.nb, groups), threads, q.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), g, q);
  return 0;
}

template <int MW, int MF, int WN, int NF>
int launch_fwd_mma(const void* x, const void* w, void* y, const Geom& g,
                   int K, const FwdPlan& q, int sms, cudaStream_t stream) {
  return launch_fwd_on_card(fwd_mma_kernel<MW, MF, WN, NF>, 32 * MW * WN, x,
                            w, y, g, K, q, sms, stream);
}

int launch_fwd_mma_bn(const void* x, const void* w, void* y, const Geom& g,
                      int K, const FwdPlan& q, int sms, cudaStream_t stream) {
  switch (q.bn) {
    case 8: return launch_fwd_mma<4, 2, 1, 1>(x, w, y, g, K, q, sms, stream);
    case 16: return launch_fwd_mma<4, 2, 1, 2>(x, w, y, g, K, q, sms, stream);
    case 32: return launch_fwd_mma<4, 2, 1, 4>(x, w, y, g, K, q, sms, stream);
    default: return launch_fwd_mma<4, 2, 2, 4>(x, w, y, g, K, q, sms, stream);
  }
}

// ---------------------------------- the weight gradient on the float32 units
// A block's shape, set by the host (plan_wgrad).
struct WgradPlan {
  int ti, to;           // Ci and Co tile, powers of two in [4, 32]
  int kwc;              // taps of a kernel row a thread owns: min(kw, 3)
  int nxc;              // ceil(kw / kwc): such runs in a kernel row
  int group;            // threads of a group: kh * nxc * (ti / 4) * (to / 4)
  int groups;           // groups of a block; blockDim = group * groups
  int seg;              // output columns a group walks, ceil(OW / groups)
  int R;                // output rows of a unit: a band of one image
  int bands;            // units of an image, ceil(OH / R)
  int rh, rw;           // rows and columns of a unit's input region
  int units_per_split;  // consecutive units a block sums
  int splits;           // S, the blocks that share one output tile
  int tiles;            // Ci tiles * Co tiles
  size_t smem;          // dynamic shared memory of a block, bytes
};

int channel_tile(int c) {
  return c <= 4 ? 4 : c <= 8 ? 8 : c <= 16 ? 16 : 32;
}

WgradPlan plan_wgrad(const Geom& g, int K, int sms) {
  WgradPlan p;
  p.kwc = g.kw < 3 ? g.kw : 3;
  p.nxc = (g.kw + p.kwc - 1) / p.kwc;
  p.ti = channel_tile(g.Ci);
  p.to = channel_tile(g.Co);
  while (g.kh * p.nxc * (p.ti / 4) * (p.to / 4) > kThreads &&
         (p.ti > 4 || p.to > 4)) {
    if (p.ti >= p.to) p.ti /= 2; else p.to /= 2;
  }
  p.group = g.kh * p.nxc * (p.ti / 4) * (p.to / 4);
  p.groups = p.group >= kThreads ? 1 : kThreads / p.group;
  if (p.groups > g.OW) p.groups = g.OW;
  p.seg = (g.OW + p.groups - 1) / p.groups;
  p.tiles = ((g.Ci + p.ti - 1) / p.ti) * ((g.Co + p.to - 1) / p.to);
  p.smem = 0;
  // about 128 output pixels a unit, fewer where the region does not fit
  int r0 = 128 / g.OW;
  if (r0 < 1) r0 = 1;
  if (r0 > g.OH) r0 = g.OH;
  const size_t reduce =
      sizeof(float) * 16 * p.kwc * static_cast<size_t>(p.group) * p.groups;
  for (int r = r0; r >= 1; --r) {
    p.R = r;
    p.rh = (p.R - 1) * g.sh + g.kh;
    p.rw = (g.OW - 1) * g.sw + g.kw;
    const size_t stage = sizeof(float) *
        (static_cast<size_t>(p.rh) * p.rw * p.ti + static_cast<size_t>(p.R) * g.OW * p.to);
    const size_t need = stage > reduce ? stage : reduce;
    if (need <= kMaxSmem) {
      p.smem = need;
      break;
    }
  }
  p.bands = (g.OH + p.R - 1) / p.R;
  const long long units = static_cast<long long>(g.B) * p.bands;
  const long long target = 2LL * sms * kThreads / (p.group * p.groups) + 1;
  long long s = (target + 1LL * K * p.tiles - 1) / (1LL * K * p.tiles);
  if (s > units) s = units;
  if (s < 1) s = 1;
  p.units_per_split = static_cast<int>((units + s - 1) / s);
  p.splits = static_cast<int>((units + p.units_per_split - 1) / p.units_per_split);
  return p;
}

// Stage n_rows rows of a tile of `width` (a power of two) channels, from
// channel ch0 of rows of `stride` channels, into dst as float32: row r
// comes from src + row_of(r) * stride, or is zero where row_of(r) < 0;
// channels at or past `chans` are zero.  16-byte loads where the channels
// allow them, kLoads of them in flight a thread before their stores.
template <typename T, typename RowOf>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const T* __restrict__ src,
                                           int n_rows, int width, int ch0,
                                           int chans, int stride,
                                           RowOf row_of) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (stride % V == 0 && ch0 % V == 0 && width >= V) {
    const int per_row = width / V;
    const int total = n_rows * per_row;
    for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * blockDim.x) {
      uint4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * blockDim.x;
        const int r = e / per_row, c = ch0 + (e - r * per_row) * V;
        const int at = e < total && c < chans ? row_of(r) : -1;
        v[u] = at >= 0 ? *reinterpret_cast<const uint4*>(
                             src + static_cast<long long>(at) * stride + c)
                       : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e >= total) break;
        const T* h = reinterpret_cast<const T*>(&v[u]);
        float4* d = reinterpret_cast<float4*>(dst + e * V);
#pragma unroll
        for (int i = 0; i < V / 4; ++i) {
          d[i] = make_float4(to_f32(h[4 * i]), to_f32(h[4 * i + 1]),
                             to_f32(h[4 * i + 2]), to_f32(h[4 * i + 3]));
        }
      }
    }
  } else {
    const int total = n_rows * width;
    for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * blockDim.x) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * blockDim.x;
        const int r = e / width, c = ch0 + (e - r * width);
        const int at = e < total && c < chans ? row_of(r) : -1;
        v[u] = at >= 0 ? to_f32(src[static_cast<long long>(at) * stride + c]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < total) dst[e] = v[u];
      }
    }
  }
}

// One block: client k, units [u0, u0 + units_per_split) (a unit is a band
// of R output rows of one image), a ti x to tile of (Ci, Co).  Per unit it
// stages the band's input region (halo included, zero outside the image,
// [rh][rw][ti] float32) and the band's g ([R * OW][to] float32) once.
// Each thread of a group owns one kernel row dy, a run of KWC taps along
// it and a 4 x 4 (ci, co) tile: KWC * 16 sums in registers.  A group walks
// a segment of each output row; per pixel it reads one float4 of g and
// shares it across its KWC taps, whose float4s of x slide along the row
// (one new float4 a pixel at stride 1), so a pixel costs two shared loads
// for 48 fmaf at KWC = 3.  The groups' tiles are added in group order and
// written as this split's partial.
template <typename T, int KWC>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ gr,
             float* __restrict__ part, Geom g, int K, WgradPlan p) {
  extern __shared__ __align__(16) float smem[];
  float* Rg = smem;                                  // [rh][rw][ti]
  float* Gs = Rg + p.rh * p.rw * p.ti;               // [R * OW][to]

  const int taps = g.kh * g.kw;
  const int co_tiles = (g.Co + p.to - 1) / p.to;
  const int k = blockIdx.y;
  const int ci0 = (blockIdx.z / co_tiles) * p.ti;
  const int co0 = (blockIdx.z % co_tiles) * p.to;
  const int units = g.B * p.bands;
  const int u_begin = blockIdx.x * p.units_per_split;
  const int u_end = min(units, u_begin + p.units_per_split);
  const int to_shift = __ffs(p.to) - 1;
  const int ti4 = p.ti >> 2, to4 = p.to >> 2;

  const int grp = threadIdx.x / p.group, q = threadIdx.x % p.group;
  const int row = q / (ti4 * to4), rem = q % (ti4 * to4);
  const int dy = row / p.nxc, dx0 = (row - dy * p.nxc) * KWC;
  const int i4 = rem / to4, o4 = rem % to4;
  const int px_begin = grp * p.seg;
  const int px_end = min(g.OW, px_begin + p.seg);
  const int col_step = g.sw * p.ti;                  // next output column
  const T* xk = x + static_cast<long long>(k) * g.B * g.H * g.W * g.Ci;
  const T* gk = gr + static_cast<long long>(k) * g.B * g.OH * g.OW * g.Co;
  float acc[KWC][4][4] = {};

  for (int u = u_begin; u < u_end; ++u) {
    const int b = u / p.bands, oy0 = (u - b * p.bands) * p.R;
    const int rows = min(p.R, g.OH - oy0);
    const int rh = (rows - 1) * g.sh + g.kh;
    const int iy0 = oy0 * g.sh - g.pt;
    const int bh = b * g.H;
    stage_rows(Rg, xk, rh * p.rw, p.ti, ci0, g.Ci, g.Ci, [&](int pix) {
      const int ry = pix / p.rw, rx = pix - ry * p.rw;
      const int iy = iy0 + ry, ix = rx - g.pl;
      return static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                     static_cast<unsigned>(ix) < static_cast<unsigned>(g.W)
                 ? (bh + iy) * g.W + ix
                 : -1;
    });
    const int np = rows * g.OW;
    const int g0 = (b * g.OH + oy0) * g.OW;
    stage_rows(Gs, gk, np, p.to, co0, g.Co, g.Co,
               [&](int pp) { return g0 + pp; });
    __syncthreads();
    for (int py = 0; py < rows && px_begin < px_end; ++py) {
      // this thread's taps at output column px: region columns
      // px * sw + dx0 + j of region row py * sh + dy
      const float* ar = Rg + ((py * g.sh + dy) * p.rw + dx0) * p.ti + i4 * 4 +
                        px_begin * col_step;
      const float* gp = Gs + ((py * g.OW + px_begin) << to_shift) + o4 * 4;
      float4 a[KWC];
#pragma unroll
      for (int j = 0; j < KWC; ++j) {
        a[j] = *reinterpret_cast<const float4*>(ar + j * p.ti);
      }
      for (int px = px_begin; px < px_end; ++px) {
        const float4 gv = *reinterpret_cast<const float4*>(gp);
#pragma unroll
        for (int j = 0; j < KWC; ++j) {
          if (dx0 + j < g.kw) outer4(acc[j], a[j], gv);
        }
        gp += p.to;
        ar += col_step;
        if (px + 1 < px_end) {
          if (g.sw == 1) {
#pragma unroll
            for (int j = 0; j + 1 < KWC; ++j) a[j] = a[j + 1];
            a[KWC - 1] = *reinterpret_cast<const float4*>(ar + (KWC - 1) * p.ti);
          } else {
#pragma unroll
            for (int j = 0; j < KWC; ++j) {
              a[j] = *reinterpret_cast<const float4*>(ar + j * p.ti);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // the groups' tiles, added in group order: red[groups][taps][ti][to]
  const int tile = taps * p.ti * p.to;
  float* red = smem;
#pragma unroll
  for (int j = 0; j < KWC; ++j) {
    if (dx0 + j >= g.kw) continue;
    const int t = dy * g.kw + dx0 + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        red[grp * tile + ((t * p.ti + i4 * 4 + i) << to_shift) + o4 * 4 + c] =
            acc[j][i][c];
      }
    }
  }
  __syncthreads();
  float* out = part + (static_cast<long long>(blockIdx.x) * K + k) * taps * g.Ci * g.Co;
  for (int o = threadIdx.x; o < tile; o += blockDim.x) {
    float s = red[o];
    for (int gi = 1; gi < p.groups; ++gi) s += red[gi * tile + o];
    const int t = o / (p.ti * p.to), r = o - t * p.ti * p.to;
    const int ci = ci0 + (r >> to_shift), co = co0 + (r & (p.to - 1));
    if (ci < g.Ci && co < g.Co) out[(t * g.Ci + ci) * g.Co + co] = s;
  }
}

template <typename T, int KWC>
int launch_wgrad(const void* x, const void* gr, float* target, const Geom& g,
                 int K, const WgradPlan& p, cudaStream_t stream) {
  auto kern = wgrad_kernel<T, KWC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.splits, K, p.tiles);
  kern<<<grid, p.group * p.groups, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gr), target, g, K, p);
  return 0;
}

template <typename T>
int launch_wgrad_t(const void* x, const void* gr, float* target, const Geom& g,
                   int K, const WgradPlan& p, cudaStream_t stream) {
  switch (p.kwc) {
    case 1: return launch_wgrad<T, 1>(x, gr, target, g, K, p, stream);
    case 2: return launch_wgrad<T, 2>(x, gr, target, g, K, p, stream);
    default: return launch_wgrad<T, 3>(x, gr, target, g, K, p, stream);
  }
}


// ------------------------------- the bfloat16 weight gradient, tensor cores
constexpr int kWgWarps = 8;
constexpr int kWgThreads = 32 * kWgWarps;
constexpr int kClusterMax = 16;       // blocks of a cluster (past 8: non-portable)
constexpr int kWgTile = 256;          // output pixels of a staged tile, at most

// A block's shape on this path, set by the host (plan_wgrad_mma).  A block
// owns a tile of (ci, co): cib blocks of 16 input channels and cob output
// channels, every tap.  Its 8 warps are `parts` warp tiles (16 ci x 8 * nfw
// co, every tap: taps * nfw * 4 float32 sums a thread) times `pg` pixel
// groups that take the 16-pixel steps of each staged tile in turn.
struct WgPlan {
  Tiles t;
  int nfw;        // n-fragments of 8 output channels a warp
  int cib, cob;   // block tile: cib * 16 input channels, cob output channels
  int cop;        // warp tiles along co: cob / (8 * nfw)
  int parts, pg;  // parts = cib * cop warp tiles, pg = 8 / parts
  int ci_tiles, co_tiles;
  int ldx, ldg;   // bf16 per staged pixel of x and of g
  int cs;         // blocks of a cluster: they split a client's tiles
  int T;          // clusters per (client, block tile); T > 1 writes T
                  // float32 partials that sum_splits_kernel adds
  int tps;        // tiles of a block
  int stages;     // staged tiles in flight: 2 or 3
  bool raw;       // x's rows staged whole, then expanded (raw_rows)
  int x_slot;     // bf16 of x in a ring slot: its region, or its raw rows
  int region;     // bf16 of the one region raw rows expand into, else 0
  int stage_bytes;   // a ring slot: x, then g ([Pp][ldg])
  int ldred;      // floats per (tap, ci) row of the block's sums, cob + 8
  bool wg;        // the wgmma kernel (3x3 stride 1, 64 x 64 block tiles)
  FastDiv cx8, cg8;   // 16-byte chunks of a staged x pixel, of a g pixel
  size_t smem;    // 0: no tensor-core path
};

// The end of both tensor-core weight gradients.  red holds a block's
// sums, [pg][taps][ci_n][ldred] float32 (rows padded 8 floats: conflict-
// free float2 stores); the pixel groups' sums are added in group order,
// then the blocks of the cluster, which split one client's pixels, add
// theirs through distributed shared memory: block r sums its 1/cs slice
// of the tile over the blocks in rank order 0 .. cs - 1, every block's
// loads in flight before the sum, and writes it to dw or, for T > 1, to
// partial blockIdx.x / cs.  No atomics: the result is the same from run
// to run.
template <int NT>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster,
                                            float* red, float* __restrict__ out,
                                            const WgPlan& p,
                                            const Geom& g, int K, int taps,
                                            int ci0, int co0, int ci_n) {
  const int rank = static_cast<int>(cluster.block_rank());
  const int k = blockIdx.y;
  const int tile = taps * ci_n * p.ldred;   // floats of one group's sums
  __syncthreads();
  const int n4 = tile / 4;
  float4* red4 = reinterpret_cast<float4*>(red);
  if (p.pg > 1) {
    for (int e = threadIdx.x; e < n4; e += NT) {
      float4 s = red4[e];
      for (int q = 1; q < p.pg; ++q) {
        const float4 v = red4[q * n4 + e];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      red4[e] = s;
    }
  }
  cluster.sync();
  const int m4 = taps * ci_n * p.cob / 4;   // the sums a block tile has
  const int per = (m4 + p.cs - 1) / p.cs;
  const int e_end = min(m4, (rank + 1) * per);
  const int plane = ci_n * p.cob;
  float* dst = out + (static_cast<long long>(blockIdx.x / p.cs) * K + k) *
                         taps * g.Ci * g.Co;
  for (int e = rank * per + threadIdx.x; e < e_end; e += NT) {
    const int t = (4 * e) / plane, rem = 4 * e - t * plane;
    const int ci = rem / p.cob, co = rem - ci * p.cob;
    const int at = ((t * ci_n + ci) * p.ldred + co) / 4;
    float4 v[kClusterMax];
#pragma unroll
    for (int r = 0; r < kClusterMax; ++r) {
      if (r < p.cs) v[r] = *(reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r)) + at);
    }
    float4 s = v[0];
#pragma unroll
    for (int r = 1; r < kClusterMax; ++r) {
      if (r < p.cs) {
        s.x += v[r].x;
        s.y += v[r].y;
        s.z += v[r].z;
        s.w += v[r].w;
      }
    }
    *reinterpret_cast<float4*>(dst + (t * g.Ci + ci0 + ci) * g.Co + co0 + co) = s;
  }
  cluster.sync();   // no block leaves while another reads its sums
}

// One block: client k, block tile (ci0.., co0..), the tiles [tps * split,
// tps * (split + 1)) of that client's pixels, split = blockIdx.x.  Each
// tile's input region (channels ci0.., [imgs][rh][RW][ldx]) and g
// ([Pp][ldg], zero past the tile's pixels) are staged once, through a
// ring of `stages` buffers with cp.async, the next in flight during the
// products; every warp tile is taken from that one copy.  Per 16-pixel
// step a warp loads its B fragments (pixels x channels of g) once with a
// transposing ldmatrix and, per tap, the A fragment (channels x pixels of
// x at the tap's offset: one row address a lane, so the 16 pixels may
// come from two image rows, or be strided), then runs its mma.sync.  A
// warp takes its steps two at a time: the second step's mma adds to the
// first's (a chain of 32 products in the tensor cores, whose own
// accumulation is not IEEE rounded) and that sum is added to float32
// registers with an IEEE add, so a float32 sum over up to 32,768 pixels
// rounds about as one; the card tests hold it to the float32 bound of
// such a sum at every shape.  At the end the warps' sums go to shared
// memory, over the staging buffers, and cluster_sum adds the pixel
// groups' and the cluster's blocks'.
template <int KH, int KW, int NFW>
__global__ void __launch_bounds__(kWgThreads, 2)
wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ gr,
                 float* __restrict__ out, Geom g, int K, WgPlan p) {
  constexpr int kTaps = KH * KW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;
  const int k = blockIdx.y;
  const int ci_t = blockIdx.z / p.co_tiles;
  const int ci0 = ci_t * p.cib * 16;
  const int co0 = (blockIdx.z - ci_t * p.co_tiles) * p.cob;
  const int ci_n = min(p.cib * 16, g.Ci - ci0);
  __nv_bfloat16* region = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + p.stages * p.stage_bytes);
  int* offs = reinterpret_cast<int*>(region + p.region);
  const __nv_bfloat16* xk = x + static_cast<long long>(k) * g.B * g.H * g.W * g.Ci;
  const __nv_bfloat16* gk = gr + static_cast<long long>(k) * g.B * g.OH * g.OW * g.Co;

  // the region byte offset of each tile pixel's x at tap (0, 0)
  for (int q = threadIdx.x; q < p.t.Pp; q += kWgThreads) {
    offs[q] = 2 * p.ldx * (q < p.t.P ? region_pixel(g, p.t, q) : 0);
  }
  const int t_begin = split * p.tps;
  const int n_tiles = t_begin < p.t.count ? min(p.tps, p.t.count - t_begin) : 0;
  auto stage = [&](int i) {
    if (i < n_tiles) {
      const TileAt a = tile_at(g, p.t, t_begin + i);
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
          smem_raw + (i % p.stages) * p.stage_bytes);
      if (p.raw) {
        stage_raw<kWgThreads>(xs, xk, g, p.t, a);
      } else {
        stage_region<kWgThreads>(xs, xk, g, p.t, a, ci0, p.cx8, p.ldx);
      }
      __nv_bfloat16* gs = xs + p.x_slot;
      const int total = p.t.Pp * static_cast<int>(p.cg8.d);
      for (int e = threadIdx.x; e < total; e += kWgThreads) {
        const int q = fdiv(e, p.cg8), cc = e - q * static_cast<int>(p.cg8.d);
        const int co = co0 + cc * 8;
        const bool ok = q < a.valid && co < g.Co;
        cp_async16(gs + q * p.ldg + cc * 8,
                   ok ? gk + (a.base + q) * g.Co + co : gk, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s + 1 < p.stages; ++s) stage(s);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = warp % p.parts, pgi = warp / p.parts;
  const int cb = part / p.cop, cpart = part - cb * p.cop;
  const int gq = lane >> 2, tq = lane & 3;
  // the pixel and channel of the matrix row this lane hands ldmatrix:
  // matrices (px 0-7, ch 0-7), (px 0-7, ch 8-15), (px 8-15, ch 0-7),
  // (px 8-15, ch 8-15) give the A fragment's a0 .. a3
  const int a_px = (lane & 7) + 8 * (lane >> 4);
  const uint32_t a_ch = 2u * (cb * 16 + 8 * ((lane >> 3) & 1));
  const uint32_t b_col = 2u * cpart * NFW * 8;
  const int row_x = 2 * p.t.RW * p.ldx;
  const int ksteps = p.t.Pp / 16;
  const uint32_t s0 = smem_addr(smem_raw);
  const uint32_t offs0 = smem_addr(offs);
  float acc[kTaps][NFW][4] = {};

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait(p.stages - 2);
    __syncthreads();
    const uint32_t slot = s0 + (i % p.stages) * p.stage_bytes;
    if (p.raw) {
      expand_raw<kWgThreads>(region,
                             reinterpret_cast<const __nv_bfloat16*>(
                                 smem_raw + (i % p.stages) * p.stage_bytes),
                             g, p.t, ci0, 16 * p.cib, p.ldx);
      __syncthreads();
    }
    stage(i + p.stages - 1);
    const uint32_t xb = p.raw ? smem_addr(region) : slot;
    const uint32_t gb = slot + 2u * p.x_slot + b_col;
    // this warp's 16-pixel steps, two at a time: per tap and n-fragment
    // the two steps' products chain in the tensor cores (32 products) and
    // their sum is added to the float32 registers with an IEEE add
    for (int st = pgi; st < ksteps; st += 2 * p.pg) {
      const bool two = st + p.pg < ksteps;
      uint32_t b1[NFW][2], b2[NFW][2];
      int off1, off2 = 0;
      load_b<NFW>(b1, gb + st * 16 * 2 * p.ldg, 2 * p.ldg, lane);
      asm volatile("ld.shared.b32 %0, [%1];\n"
                   : "=r"(off1) : "r"(offs0 + 4u * (st * 16 + a_px)));
      if (two) {
        load_b<NFW>(b2, gb + (st + p.pg) * 16 * 2 * p.ldg, 2 * p.ldg, lane);
        asm volatile("ld.shared.b32 %0, [%1];\n"
                     : "=r"(off2) : "r"(offs0 + 4u * ((st + p.pg) * 16 + a_px)));
      }
      const uint32_t xa1 = xb + off1 + a_ch, xa2 = xb + off2 + a_ch;
#pragma unroll
      for (int dy = 0; dy < KH; ++dy) {
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) {
          const uint32_t tap = dy * row_x + dx * 2 * p.ldx;
          uint32_t a1[4], a2[4];
          ldsm_x4_trans(a1, xa1 + tap);
          if (two) ldsm_x4_trans(a2, xa2 + tap);
#pragma unroll
          for (int n = 0; n < NFW; ++n) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(c, a1, b1[n][0], b1[n][1]);
            if (two) mma_bf16(c, a2, b2[n][0], b2[n][1]);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[dy * KW + dx][n][r] += c[r];
          }
        }
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();

  // this block's sums, [pg][taps][ci_n][ldred] float32 (rows padded 8
  // floats: conflict-free float2 stores), over the staging buffers
  float* red = reinterpret_cast<float*>(smem_raw);
  const int tile = kTaps * ci_n * p.ldred;   // floats of one group's sums
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
#pragma unroll
    for (int n = 0; n < NFW; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = cb * 16 + gq + 8 * h;
        const int co = (cpart * NFW + n) * 8 + 2 * tq;
        if (ci < ci_n) {
          *reinterpret_cast<float2*>(red + pgi * tile + (t * ci_n + ci) * p.ldred + co) =
              make_float2(acc[t][n][2 * h], acc[t][n][2 * h + 1]);
        }
      }
    }
  }
  cluster_sum<kWgThreads>(cluster, red, out, p, g, K, kTaps, ci0, co0, ci_n);
}

// ------------------- the bfloat16 weight gradient on wgmma: 3x3, stride 1
// wgmma (Hopper's warpgroup product): a warpgroup of 4 warps multiplies a
// 64 x 16 A by a 16 x N B, both read by the tensor cores from shared
// memory through matrix descriptors, into registers, asynchronously.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A shared-memory matrix descriptor, no swizzle: the start address, the
// byte offset between core matrices (8 rows of 16 bytes, 128 contiguous
// bytes) along K (the leading byte offset) and along M or N (the stride
// byte offset).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x 64, float32) += A (64 x 16) * B (16 x 64), both read by the
// tensor cores from shared memory, both MN-major (the transpose flags set)
__device__ __forceinline__ void wgmma_mn_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

constexpr int kWgmmaThreads = 384;   // 3 warpgroups: one per kernel row

// One block: client k, a 64 x 64 (ci, co) block tile, the tiles [tps *
// split, tps * (split + 1)) of the client's pixels.  dw of a tap is, per
// 16-pixel step, x_shift^T (ci x pixels) times g (pixels x co): A and B of
// one m64n64k16 wgmma, both from shared memory.  Each tile's x region and
// g are staged channel-chunk-major ([8 channels][pixel][8], 16 bytes a
// pixel), so 8 consecutive pixels' 8 channels are one core matrix:
// consecutive output pixels are consecutive region pixels at stride 1, and
// a tap shifts the descriptor's start by its region offset.  The 16
// pixels of a step are 8 and 8 either in one output row (OW a multiple of
// 16: core matrices 128 bytes apart along K) or in two (OW = 8: a region
// row apart).  Warpgroup dy owns kernel row dy: 3 accumulators of 64 x 64
// (96 float32 a thread), and issues its 3 taps' products per step, all of
// a tile's steps back to back, one wait a tile.  The tensor cores
// accumulate each tap over all of the block's pixels (256 at 8x8 64 -> 64,
// K 10) with their own float32 rounding, a longer chain than
// wgrad_mma_kernel's 32 products; the card tests hold the result to the
// same float32 bound at every shape (measured max |err| 2.6e-4 at 8x8 64
// -> 64 against 2.3e-4 for mma.sync, profile_mc_conv.py).  The blocks of
// a cluster then add their sums (cluster_sum).
__global__ void __launch_bounds__(kWgmmaThreads, 1)
wgrad_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ gr,
                   float* __restrict__ out, Geom g, int K, WgPlan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;
  const int k = blockIdx.y;
  const int ci_t = blockIdx.z / p.co_tiles;
  const int ci0 = ci_t * 64;
  const int co0 = (blockIdx.z - ci_t * p.co_tiles) * 64;
  const int rpix = p.t.imgs * p.t.rh * p.t.RW;
  const int ksteps = p.t.Pp / 16;
  int* offs = reinterpret_cast<int*>(smem_raw + p.stages * p.stage_bytes);
  const __nv_bfloat16* xk = x + static_cast<long long>(k) * g.B * g.H * g.W * g.Ci;
  const __nv_bfloat16* gk = gr + static_cast<long long>(k) * g.B * g.OH * g.OW * g.Co;

  // the region pixel, at tap (0, 0), of each step's first pixel
  for (int q = threadIdx.x; q < ksteps; q += kWgmmaThreads) {
    offs[q] = 16 * q < p.t.P ? region_pixel(g, p.t, 16 * q) : 0;
  }
  const int t_begin = split * p.tps;
  const int n_tiles = t_begin < p.t.count ? min(p.tps, p.t.count - t_begin) : 0;
  auto stage = [&](int i) {
    if (i < n_tiles) {
      const TileAt a = tile_at(g, p.t, t_begin + i);
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
          smem_raw + (i % p.stages) * p.stage_bytes);
      for (int e = threadIdx.x; e < rpix * 8; e += kWgmmaThreads) {
        const int pix = e >> 3, cc = e & 7;
        const int im = fdiv(pix, p.t.rpix), rr = pix - im * p.t.rpix.d;
        const int r = fdiv(rr, p.t.rw), c = rr - r * p.t.rw.d;
        const int iy = a.iy0 + r, ix = c - g.pl, ch = ci0 + cc * 8;
        const bool ok = im < a.n_img &&
                        static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                        static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
        cp_async16(xs + (cc * rpix + pix) * 8,
                   ok ? xk + (((a.b0 + im) * g.H + iy) * g.W + ix) * g.Ci + ch : xk,
                   ok);
      }
      __nv_bfloat16* gs = xs + 64 * rpix;
      for (int e = threadIdx.x; e < p.t.Pp * 8; e += kWgmmaThreads) {
        const int q = e >> 3, cc = e & 7;
        const bool ok = q < a.valid;
        cp_async16(gs + (cc * p.t.Pp + q) * 8,
                   ok ? gk + (a.base + q) * g.Co + co0 + cc * 8 : gk, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s + 1 < p.stages; ++s) stage(s);

  const int dy = threadIdx.x >> 7;
  const uint32_t lbo_a = g.OW == 8 ? 16u * p.t.RW : 128u;
  const uint32_t sbo_a = 16u * rpix;
  const uint32_t sbo_b = 16u * p.t.Pp;
  const uint32_t s0 = smem_addr(smem_raw);
  float acc[3][32];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[t][r] = 0.0f;
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait(p.stages - 2);
    // the tile's bytes, written by cp.async (the generic proxy), are read
    // by the tensor cores through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    stage(i + p.stages - 1);
    const uint32_t xb = s0 + (i % p.stages) * p.stage_bytes;
    const uint32_t gb = xb + 128u * rpix;
    wgmma_fence();
    for (int st = 0; st < ksteps; ++st) {
      const uint64_t db = smem_desc(gb + 256u * st, 128u, sbo_b);
      const uint32_t xa = xb + 16u * (offs[st] + dy * p.t.RW);
      wgmma_mn_n64(acc[0], smem_desc(xa, lbo_a, sbo_a), db);
      wgmma_mn_n64(acc[1], smem_desc(xa + 16u, lbo_a, sbo_a), db);
      wgmma_mn_n64(acc[2], smem_desc(xa + 32u, lbo_a, sbo_a), db);
    }
    wgmma_commit();
    wgmma_wait_all();
  }
  cp_async_wait(0);
  __syncthreads();

  // this block's sums, [taps][64][ldred]: warp w of a warpgroup holds
  // ci rows 16w .. 16w + 15 (the mma.sync C layout), co across its
  // registers
  float* red = reinterpret_cast<float*>(smem_raw);
  const int w4 = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = 16 * w4 + gq + 8 * h, co = 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(red + ((dy * 3 + dx) * 64 + ci) * p.ldred + co) =
            make_float2(acc[dx][4 * j + 2 * h], acc[dx][4 * j + 2 * h + 1]);
      }
    }
  }
  cluster_sum<kWgmmaThreads>(cluster, red, out, p, g, K, 9, ci0, co0, 64);
}

// d (64 x 64, float32) = A (64 x 16, K-major) * B (16 x 64, MN-major), plus
// d unless `accumulate` is 0; both from shared memory
__device__ __forceinline__ void wgmma_kn_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

constexpr int kFwdWgThreads = 256;   // 2 warpgroups: 64 output pixels each

// The forward where an output row is 8 pixels (ResNet-56's 8x8 images),
// stride 1, on wgmma: one block per (client, 64 output channels) keeps its
// weights in shared memory (MN-major core matrices, 16 bytes a row: 8
// channels of one (tap, ci) row of w, so cp.async copies them as they
// lie) and streams 128-pixel tiles through the cp.async ring, each tile's
// region channel-chunk-major ([Cs / 8][pixel][8]).  Then a 64-pixel
// M-tile (8 output rows of 8) at one tap and 16 input channels is a
// K-major A of 8 core matrices: 8 consecutive region pixels (one output
// row, shifted by the tap) of 8 channels each, an output row apart in the
// region (the stride byte offset) and a channel plane apart along K.  Each
// warpgroup issues its M-tile's kh * kw * Cs / 16 products back to back,
// one wait a tile; the depth accumulates in the tensor cores, as in
// fwd_mma_kernel.
__global__ void __launch_bounds__(kFwdWgThreads, 1)
fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ y, Geom g, FwdPlan q) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int taps = g.kh * g.kw;
  const int kps = taps * q.Cs;
  const int rpix = q.t.imgs * q.t.rh * q.t.RW;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // kps * 64
  __nv_bfloat16* ring = Ws + kps * 64;                 // [stages][Cs / 8][rpix][8]
  const int k = blockIdx.y / q.co_tiles;
  const int co0 = (blockIdx.y - k * q.co_tiles) * 64;
  const __nv_bfloat16* xk = x + static_cast<long long>(k) * g.B * g.H * g.W * g.Ci;
  const __nv_bfloat16* wk = w + static_cast<long long>(k) * taps * g.Ci * g.Co;
  __nv_bfloat16* yk = y + static_cast<long long>(k) * g.B * g.OH * g.OW * g.Co;
  const int first = blockIdx.x;
  const int n_tiles = first < q.t.count ? (q.t.count - first + q.nb - 1) / q.nb : 0;

  // the weights: depth row kp = tap * Cs + c, channels co0 + 8j .. + 7 go
  // to step kp / 16, group j (256 bytes apart), K half (kp % 16) / 8 (128
  // bytes apart), row kp % 8
  for (int e = threadIdx.x; e < kps * 8; e += kFwdWgThreads) {
    const int kp = e >> 3, j = e & 7;
    const int tap = kp / q.Cs, c = kp - tap * q.Cs;
    const bool ok = c < g.Ci;
    cp_async16(Ws + (kp >> 4) * 1024 + j * 128 + (kp & 15) * 8,
               ok ? wk + (tap * g.Ci + c) * g.Co + co0 + j * 8 : wk, ok);
  }
  auto stage = [&](int i) {
    if (i < n_tiles) {
      const TileAt a = tile_at(g, q.t, first + i * q.nb);
      __nv_bfloat16* dst = ring + (i % q.stages) * q.slot;
      const int nch = static_cast<int>(q.c8.d);
      for (int e = threadIdx.x; e < rpix * nch; e += kFwdWgThreads) {
        const int pix = fdiv(e, q.c8), cc = e - pix * nch;
        const int im = fdiv(pix, q.t.rpix), rr = pix - im * q.t.rpix.d;
        const int r = fdiv(rr, q.t.rw), c = rr - r * q.t.rw.d;
        const int iy = a.iy0 + r, ix = c - g.pl, ch = cc * 8;
        const bool ok = im < a.n_img && ch < g.Ci &&
                        static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                        static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
        cp_async16(dst + (cc * rpix + pix) * 8,
                   ok ? xk + (((a.b0 + im) * g.H + iy) * g.W + ix) * g.Ci + ch : xk,
                   ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s + 1 < q.stages; ++s) stage(s);   // the weights go with 0

  const int wgi = threadIdx.x >> 7;
  const int w4 = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 64 * wgi;   // this warpgroup's first pixel of the tile
  const uint32_t m_pix = 16u * (m0 < q.t.P ? region_pixel(g, q.t, m0) : 0);
  const uint32_t plane = 16u * rpix;        // K: the next 8 channels
  const uint32_t row = 16u * q.t.RW;        // M: the next output row
  const uint32_t ws0 = smem_addr(Ws), r0 = smem_addr(ring);
  const int kc = q.Cs / 16;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait(q.stages - 2);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    stage(i + q.stages - 1);
    const uint32_t rb = r0 + 2u * (i % q.stages) * q.slot + m_pix;
    float d[32];
    wgmma_fence();
    int st = 0;
    for (int dy = 0; dy < g.kh; ++dy) {
      for (int dx = 0; dx < g.kw; ++dx) {
        const uint32_t tap = rb + row * dy + 16u * dx;
        for (int c = 0; c < kc; ++c, ++st) {
          wgmma_kn_n64(d, smem_desc(tap + 2 * c * plane, plane, row),
                       smem_desc(ws0 + 2048u * st, 128u, 256u), st);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();

    const TileAt at = tile_at(g, q.t, first + i * q.nb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + 16 * w4 + gq + 8 * h;
      if (p >= at.valid) continue;
      __nv_bfloat16* yp = yk + (at.base + p) * g.Co + co0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(yp + 8 * j) =
            __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
}

int launch_fwd_wgmma(const void* x, const void* w, void* y, const Geom& g,
                     int K, const FwdPlan& q, int sms, cudaStream_t stream) {
  return launch_fwd_on_card(fwd_wgmma_kernel, kFwdWgThreads, x, w, y, g, K, q,
                            sms, stream);
}

using WgradKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                             float*, Geom, int, WgPlan);

// The mma.sync instantiation for a kernel size and warp tile; null for the
// sizes that have none (they take the float32-unit kernel).
WgradKernel wgrad_mma_kernel_for(int kh, int kw, int nfw) {
#define FEDML_WG(KH, KW)                                                  \
  if (kh == KH && kw == KW) {                                            \
    return nfw == 1 ? wgrad_mma_kernel<KH, KW, 1>                        \
                    : wgrad_mma_kernel<KH, KW, 2>;                       \
  }
  FEDML_WG(1, 1)
  FEDML_WG(2, 2)
  FEDML_WG(3, 3)
#undef FEDML_WG
  return nullptr;
}

// How many clusters of `cs` blocks of `kern` (`threads` each) the card
// holds at once; 0 where it holds none or the size is refused.
int active_clusters(WgradKernel kern, int threads, size_t smem, int cs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
    cudaGetLastError();   // a refused size is no error of the launch
    return 0;
  }
  return n;
}

WgradKernel wgrad_kernel_of(const Geom& g, const WgPlan& p) {
  return p.wg ? wgrad_wgmma_kernel : wgrad_mma_kernel_for(g.kh, g.kw, p.nfw);
}

// The tensor-core weight gradient's plan; smem 0 where it has none: not
// bfloat16, Co not a multiple of 8 (g is staged 8 channels at a time), a
// kernel size without an instantiation, a block tile that does not split
// into 8 warps, or shared memory past a block's.  3x3 stride-1 convs with
// Ci and Co multiples of 64 and rows of 8 or a multiple of 16 pixels (at
// ResNet-56: 8x8 64 -> 64) take the wgmma kernel, a block tile of 64 x 64;
// the others the mma.sync kernel, whose block tile is all of (Ci, Co)
// where 8 warp tiles cover it (every other ResNet-56 shape).  Tiles are
// 64 to 256 output pixels; a client's tiles are split over about one or
// two blocks an SM: up to kClusterMax blocks in one cluster, more as T
// clusters whose partials go through the scratch.
int plan_wgrad_mma(const Geom& g, int K, int sms, int dtype, WgPlan& p) {
  p = WgPlan{};
  if (dtype != kBF16 || (g.Co & 7) != 0) return 0;
  p.wg = g.kh == 3 && g.kw == 3 && g.sh == 1 && g.sw == 1 && g.Ci % 64 == 0 &&
         g.Co % 64 == 0 && (g.OW == 8 || g.OW % 16 == 0) &&
         (g.OH * g.OW) % 16 == 0;
  const int cs16 = (g.Ci + 15) / 16;
  if (p.wg) {
    p.cib = 4;
    p.cob = 64;
    p.pg = 1;
  } else {
    p.nfw = g.Co % 16 == 0 ? 2 : 1;
    if (wgrad_mma_kernel_for(g.kh, g.kw, p.nfw) == nullptr) return 0;
    p.cib = cs16;
    p.cob = g.Co;
    while (p.cib * (p.cob / (8 * p.nfw)) > kWgWarps) {
      if ((p.cob / (8 * p.nfw)) % 2 == 0) {
        p.cob /= 2;
      } else if (p.cib % 2 == 0) {
        p.cib /= 2;
      } else {
        return 0;
      }
    }
    p.cop = p.cob / (8 * p.nfw);
    p.parts = p.cib * p.cop;
    if (kWgWarps % p.parts != 0) return 0;
    p.pg = kWgWarps / p.parts;
    p.raw = raw_rows(g);
  }
  p.ci_tiles = (cs16 + p.cib - 1) / p.cib;
  p.co_tiles = g.Co / p.cob;
  p.ldx = p.cib * 16 + 8;
  p.ldg = p.cob + ((p.cob / 8) % 2 == 0 ? 8 : 16);
  p.ldred = p.cob + 8;
  p.cx8 = fast_div(p.cib * 2);
  p.cg8 = fast_div(p.cob / 8);
  const int ci_n = p.cib * 16 < g.Ci ? p.cib * 16 : g.Ci;
  const size_t red = 4ull * p.pg * g.kh * g.kw * ci_n * p.ldred;
  const int groups = K * p.ci_tiles * p.co_tiles;
  const int threads = p.wg ? kWgmmaThreads : kWgThreads;
  const int max_per_sm = p.wg ? 1 : 2;   // the kernels' registers
  // A tile's ring slot: x's region ([pixel][ldx]; for the wgmma kernel
  // channel-chunk-major, 16 bytes a pixel and chunk) or raw rows, then g
  // ([Pp][ldg], or chunk-major); behind the ring the one region raw rows
  // expand into, then the offset table.
  auto layout = [&](const Tiles& t, int& x_slot, int& region, int& stage_bytes,
                    int& extra) {
    const int rpix = t.imgs * t.rh * t.RW;
    if (p.wg) {
      x_slot = 8 * rpix * 8;
      region = 0;
      stage_bytes = 2 * (x_slot + 64 * t.Pp);
      extra = 4 * (t.Pp / 16);
    } else {
      x_slot = p.raw ? t.imgs * t.rh * g.W * g.Ci : rpix * p.ldx;
      region = p.raw ? rpix * p.ldx : 0;
      stage_bytes = 2 * (x_slot + t.Pp * p.ldg);
      extra = 2 * region + 4 * t.Pp;
    }
  };
  // the tile size and ring depth that leave a block the fewest pixels,
  // with every group's blocks on the card at once (228 KB of shared
  // memory an SM, 1 KB of it a block's own); fewer pixels a block first,
  // then more stages, then larger tiles.  A group's blocks are as many as
  // share the card's slots evenly, at most a cluster's where one cluster
  // a group still fills half the slots.
  long long best = -1;
  int slots = 0;
  for (int target = kWgTile; target >= 64; target /= 2) {
    const Tiles t = make_tiles(g, target);
    if (t.count == 0) continue;
    int x_slot, region, stage_bytes, extra;
    layout(t, x_slot, region, stage_bytes, extra);
    for (int stages = 3; stages >= 2; --stages) {
      size_t need = static_cast<size_t>(stages) * stage_bytes + extra;
      if (need < red) need = red;
      if (need > kMaxSmem) continue;
      int per_sm = static_cast<int>(233472ull / (need + 1024));
      if (per_sm > max_per_sm) per_sm = max_per_sm;
      int s_max = sms * per_sm / groups;
      if (s_max > kClusterMax && 2 * groups * kClusterMax >= sms * per_sm) {
        s_max = kClusterMax;
      }
      if (s_max > t.count) s_max = t.count;
      if (s_max < 1) s_max = 1;
      const int tps = (t.count + s_max - 1) / s_max;
      const long long work = 1LL * tps * t.P;
      if (best < 0 || work < best) {
        best = work;
        p.t = t;
        p.stages = stages;
        p.x_slot = x_slot;
        p.region = region;
        p.stage_bytes = stage_bytes;
        p.smem = need;
        p.tps = tps;
        slots = sms * per_sm;
      }
    }
  }
  if (best < 0) return 0;
  const int s = (p.t.count + p.tps - 1) / p.tps;
  // one cluster of s blocks a group where the card holds them all at once,
  // else the largest cluster it does hold: T = 1 where that still gives
  // the card half its slots, else T clusters and their partials
  const WgradKernel kern = wgrad_kernel_of(g, p);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sizes[] = {s, 16, 12, 8, 4, 2, 1};
  p.cs = 1;
  for (const int c : sizes) {
    if (c > s || c > kClusterMax || c < 1) continue;
    if (c == 1 || active_clusters(kern, threads, p.smem, c) >= groups) {
      p.cs = c;
      break;
    }
  }
  if (p.cs == s || 2 * groups * p.cs >= slots) {
    p.T = 1;
  } else {
    p.T = (s + p.cs - 1) / p.cs;
  }
  p.tps = (p.t.count + p.cs * p.T - 1) / (p.cs * p.T);
  return 0;
}

int launch_wgrad_mma(const void* x, const void* gr, float* target,
                     const Geom& g, int K, const WgPlan& p,
                     cudaStream_t stream) {
  // plan_wgrad_mma set the kernel's shared memory and cluster attributes
  const WgradKernel kern = wgrad_kernel_of(g, p);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cs * p.T, K, p.ci_tiles * p.co_tiles);
  cfg.blockDim = dim3(p.wg ? kWgmmaThreads : kWgThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gr), target, g, K, p);
  return static_cast<int>(err);
}
// dw[i] = part[0][i] + part[1][i] + ... + part[S-1][i], in that order
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ dw,
                  int splits, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    float s = part[i];
    for (int sp = 1; sp < splits; ++sp) s += part[sp * n + i];
    dw[i] = s;
  }
}

// The launch's checks: positive sizes, one client's tensors indexable with
// 32-bit offsets, a grid that fits, and the device set.
int prepare(const Geom& g, int K, int dtype, int device) {
  if (K < 1 || g.B < 1 || g.H < 1 || g.W < 1 || g.Ci < 1 || g.Co < 1 ||
      g.kh < 1 || g.kw < 1 || g.sh < 1 || g.sw < 1 || g.OH < 1 || g.OW < 1 ||
      g.pt < 0 || g.pl < 0 || K > 65535 || (dtype != kF32 && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long lim = 0x7fffffffLL;
  const long long xs = 1LL * g.B * g.H * g.W * g.Ci;
  const long long ys = 1LL * g.B * g.OH * g.OW * g.Co;
  const long long ws = 1LL * g.kh * g.kw * g.Ci * g.Co;
  if (xs > lim || ys > lim || ws > lim || 1LL * K * g.kh * g.kw > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaSetDevice(device));
}

template <typename T, int BN>
void launch_fwd(const void* x, const void* w, void* y, const Geom& g, int K,
                cudaStream_t stream) {
  constexpr int kBM = 4 * (kThreads / (BN / 4));
  const int M = g.B * g.OH * g.OW;
  const dim3 grid((M + kBM - 1) / kBM, (g.Co + BN - 1) / BN, K);
  fwd_kernel<T, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), g);
}

template <typename T>
void launch_fwd_t(const void* x, const void* w, void* y, const Geom& g, int K,
                  cudaStream_t stream) {
  if (g.Co <= 16) {
    launch_fwd<T, 16>(x, w, y, g, K, stream);
  } else if (g.Co <= 32) {
    launch_fwd<T, 32>(x, w, y, g, K, stream);
  } else {
    launch_fwd<T, 64>(x, w, y, g, K, stream);
  }
}

int sm_count(int device, int* sms) {
  return static_cast<int>(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device));
}

}  // namespace

extern "C" {

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [K, B, H, W, Ci], w [K, kh, kw, Ci, Co], y [K, B, OH, OW, Co], all
// contiguous, of one dtype (0 float32, 1 bfloat16); (pt, pl) the low pads.
int fedml_mc_conv_fwd(const void* x, const void* w, void* y, int K, int B,
                      int H, int W, int Ci, int OH, int OW, int Co, int kh,
                      int kw, int sh, int sw, int pt, int pl, int dtype,
                      int device, void* stream) {
  const Geom g{B, H, W, Ci, OH, OW, Co, kh, kw, sh, sw, pt, pl};
  int err = prepare(g, K, dtype, device);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const FwdPlan q = plan_fwd(g);
    if (q.smem != 0 && 1LL * K * q.co_tiles <= 65535) {
      int sms = 0;
      err = sm_count(device, &sms);
      if (err != 0) return err;
      err = q.wg ? launch_fwd_wgmma(x, w, y, g, K, q, sms, s)
                 : launch_fwd_mma_bn(x, w, y, g, K, q, sms, s);
      if (err != 0) return err;
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (dtype == kF32) {
    launch_fwd_t<float>(x, w, y, g, K, s);
  } else {
    launch_fwd_t<__nv_bfloat16>(x, w, y, g, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The number of float32 [K, kh, kw, Ci, Co] partials the weight gradient of
// this shape writes and sums (the wrapper allocates them when it is more
// than 1); negative on an error (or a shape whose image row does not fit a
// block).
int fedml_mc_conv_wgrad_splits(int K, int B, int H, int W, int Ci, int OH,
                               int OW, int Co, int kh, int kw, int sh, int sw,
                               int pt, int pl, int dtype, int device) {
  const Geom g{B, H, W, Ci, OH, OW, Co, kh, kw, sh, sw, pt, pl};
  int sms = 0;
  const int err = sm_count(device, &sms);
  if (err != 0) return -err;
  WgPlan q;
  const int perr = plan_wgrad_mma(g, K, sms, dtype, q);
  if (perr != 0) return -perr;
  if (q.smem != 0) return q.T;
  const WgradPlan p = plan_wgrad(g, K, sms);
  return p.smem == 0 ? -static_cast<int>(cudaErrorInvalidValue) : p.splits;
}

// x [K, B, H, W, Ci] and g [K, B, OH, OW, Co] of one dtype; dw float32
// [K, kh, kw, Ci, Co]; part float32 [splits, K, kh, kw, Ci, Co], or null
// when splits is 1 (the kernel then writes dw).
int fedml_mc_conv_wgrad(const void* x, const void* gr, float* part, int splits,
                        float* dw, int K, int B, int H, int W, int Ci, int OH,
                        int OW, int Co, int kh, int kw, int sh, int sw, int pt,
                        int pl, int dtype, int device, void* stream) {
  const Geom g{B, H, W, Ci, OH, OW, Co, kh, kw, sh, sw, pt, pl};
  int err = prepare(g, K, dtype, device);
  if (err != 0) return err;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != 0) return err;
  WgPlan q;
  err = plan_wgrad_mma(g, K, sms, dtype, q);
  if (err != 0) return err;
  const bool on_mma = q.smem != 0;
  const WgradPlan p = plan_wgrad(g, K, sms);
  const int want = on_mma ? q.T : p.smem == 0 ? 0 : p.splits;
  if (want != splits || splits < 1 || (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* target = splits > 1 ? part : dw;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (on_mma) {
    err = launch_wgrad_mma(x, gr, target, g, K, q, s);
  } else {
    err = dtype == kF32
              ? launch_wgrad_t<float>(x, gr, target, g, K, p, s)
              : launch_wgrad_t<__nv_bfloat16>(x, gr, target, g, K, p, s);
  }
  if (err != 0) return err;
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  const long long n = 1LL * K * kh * kw * Ci * Co;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 32LL * sms) blocks = 32LL * sms;
  sum_splits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      part, dw, splits, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
