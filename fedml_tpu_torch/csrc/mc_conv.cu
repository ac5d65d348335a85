// Multi-client SAME convolution, forward and weight gradient, written for
// Hopper (sm_90a).
//
// Replaces the two Pallas kernels of fedml_tpu/ops/pallas_mc_conv.py:
//
//   fwd_mma_kernel (bfloat16) and fwd_kernel (float32)
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
//   wgrad_mma_kernel (bfloat16, stride 1) and wgrad_kernel, each followed
//   by sum_splits_kernel
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
// What bounds them on an H100: at ResNet-56's shapes in bfloat16 (K = 10
// clients, batch 32) the card's limit is the bytes.  A 3x3 16 -> 16 conv
// on 32x32 reads 10.5 MB of x and writes 10.5 MB of y, 6.3 us at 3.35
// TB/s, while its 1.51 GFLOP take 1.5 us on the bf16 tensor cores and 23 us
// on the float32 units.  So bfloat16 runs on the tensor cores (mma.sync
// m16n8k16, float32 sums), and what bounds these kernels is getting each
// block's operands into shared memory: a block's copies wait on device
// memory before its products start.  float32 inputs, which the tensor
// cores would round to TF32, run on the float32 units with fmaf.  wgmma,
// TMA and a pipeline that overlaps one tile's copies with another's
// products are later work.
//
// What the design does about that:
//  * Forward, bfloat16 (fwd_mma_kernel): one block of 4 warps per (client,
//    image, run of 64 or 128 output pixels, tile of up to 32 output
//    channels).  It copies the input rows the run reads (halo included,
//    zero outside the image) and its weights into shared memory in the
//    tensors' own layouts with 16-byte cp.async copies, so each x value is
//    read from device memory once per block, not once per tap.  ldmatrix
//    reads the A fragment at the tap's offset in the region and the
//    transposed B fragments from the weights.  Channels are padded to 16 in
//    shared memory (the stem has Ci = 3).
//  * Weight gradient, bfloat16, stride 1 (wgrad_mma_kernel): one warp per
//    kernel row; per unit (a band of about 128 output pixels of one image)
//    the block copies the band's input region and g, and transposing
//    ldmatrix reads x as the [channels, pixels] A fragment and g as the
//    [pixels, channels] B fragment, 16 pixels a step, the B fragment
//    shared by the row's taps.  Each step's mma starts from zero and its
//    sum is added to float32 registers with an IEEE add: the tensor cores'
//    own accumulation is not IEEE rounded, and a float32 sum over 32,768
//    pixels must round as one.
//  * float32, and bfloat16 shapes the tensor-core kernels do not take
//    (strided weight gradients, Co not a multiple of 8 for the gradient, a
//    region too large for a block): fwd_kernel gathers the patch rows 16
//    depth values at a time into float32 shared memory (the next chunk's
//    loads in flight during the products); wgrad_kernel stages each band's
//    region and g as float32, and a thread shares each g value across a
//    row of 3 taps whose x values slide along the row; both multiply 4 x 4
//    register tiles with fmaf.
//  * The reduction over M: on the TPU the batch-tile axis of the grid runs
//    in order and accumulates into one output block; blocks on Hopper run
//    in no order.  So M is split into S runs of units: one block per (run,
//    client, channel tile) sums its run into registers and writes its
//    partial to a [S, K, kh, kw, Ci, Co] float32 scratch that the wrapper
//    allocates; sum_splits_kernel adds the S partials of each output in
//    order 0..S-1.  No atomics: the result is the same from run to run.
//    S fills the card: ResNet-56's first stage has K = 10 clients of one
//    16 x 16 channel tile, so the tensor-core kernel splits the 256 units
//    of a client into 64 runs of 4 (640 blocks of 3 warps for 132 SMs).
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
#include <stdint.h>

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

// ------------------------------------ the bfloat16 forward on the tensor cores
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kLoads = 8;             // loads in flight a thread
constexpr size_t kMaxSmem = 232448;   // what one block may take on sm_90

// A block's shape on the tensor-core path, set by the host (plan_mma).
struct MmaPlan {
  int P;        // output pixels of a block: a run of one image's pixels
  int Cp;       // Ci rounded up to 16, the depth of a tap in shared memory
  int ldr;      // Cp + 8: bf16 per pixel of the staged input region
  int RW;       // columns of the region: (OW - 1) * sw + kw
  int bn;       // output channels of a block, 8 per n-fragment
  int ldw;      // bn + 8 (24 at bn 8): bf16 per row of the staged weights
  size_t smem;  // bytes of dynamic shared memory
};

// c += a (16 x 16, row) * b (16 x 8, col): bf16 products, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Four 8 x 8 bf16 matrices from shared memory, one row address a lane
// (lanes 8i .. 8i + 7 give matrix i's rows); .trans hands each thread the
// transposed element pairs.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// The B fragments (16 x 8, col) of NF n-fragments from a k-major tile
// (row k holds the n values, `ld` bf16 apart): b[j] for n-fragment j,
// columns n0 + 8j.
template <int NF>
__device__ __forceinline__ void load_b(uint32_t (&b)[NF][2],
                                       const __nv_bfloat16* k0_row, int ld,
                                       int lane) {
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
                           8 * (j + (lane >> 4)));
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
  }
}

// One block: client k, image b, output pixels [p0, p0 + P) of that image,
// output channels [co0, co0 + bn).  It copies the input rows those pixels
// read into shared memory, halo included and zero outside the image, as
// [row][col][Cp] bf16 (x's own layout: 16-byte cp.async copies, no
// registers on the way), and the block's weights as [tap * Cp + c][n]
// (w's own layout).  Each warp then multiplies MF m-fragments of 16 pixels
// by NF n-fragments of 8 channels with mma.sync, walking the taps and 16
// channels at a time: ldmatrix reads the A fragment straight from the
// region at the tap's offset (the im2col matrix is never formed) and,
// transposed, the B fragments from the weights.
template <int NF, int MF>
__global__ void __launch_bounds__(kMmaThreads)
fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ y, Geom g, MmaPlan q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int taps = g.kh * g.kw;
  const int kps = taps * q.Cp;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kps][ldw]
  __nv_bfloat16* Rs = Ws + kps * q.ldw;                             // [rh][RW][ldr]

  const int co_tiles = (g.Co + q.bn - 1) / q.bn;
  const int k = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z - k * co_tiles) * q.bn;
  const int b = blockIdx.y;
  const int npix = g.OH * g.OW;
  const int p0 = blockIdx.x * q.P;
  const int p_end = min(npix, p0 + q.P);
  const int oy_first = p0 / g.OW;
  const int rh = ((p_end - 1) / g.OW - oy_first) * g.sh + g.kh;
  const int iy0 = oy_first * g.sh - g.pt;
  const __nv_bfloat16* xb =
      x + (static_cast<long long>(k) * g.B + b) * g.H * g.W * g.Ci;
  const __nv_bfloat16* wk = w + static_cast<long long>(k) * taps * g.Ci * g.Co;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // the weights, [tap * Cp + c][n] = w[k, tap, c, co0 + n]: 8 channels a
  // 16-byte copy where Co allows it
  if ((g.Co & 7) == 0) {
    const int n8 = q.bn >> 3;
    for (int e = threadIdx.x; e < kps * n8; e += kMmaThreads) {
      const int kp = e / n8, nc = e - kp * n8;
      const int tap = kp / q.Cp, c = kp - tap * q.Cp, co = co0 + nc * 8;
      const bool ok = c < g.Ci && co < g.Co;
      cp_async16(Ws + kp * q.ldw + nc * 8,
                 ok ? wk + (tap * g.Ci + c) * g.Co + co : wk, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kps * q.bn; e += kMmaThreads) {
      const int kp = e / q.bn, n = e - kp * q.bn;
      const int tap = kp / q.Cp, c = kp - tap * q.Cp, co = co0 + n;
      Ws[kp * q.ldw + n] =
          (c < g.Ci && co < g.Co) ? wk[(tap * g.Ci + c) * g.Co + co] : zero;
    }
  }
  // the input region, [rh][RW][Cp]: 8 channels a 16-byte copy where Ci
  // allows it
  const int rpix = rh * q.RW;
  if ((g.Ci & 7) == 0) {
    const int c8 = q.Cp >> 3;
    for (int e = threadIdx.x; e < rpix * c8; e += kMmaThreads) {
      const int pix = e / c8, cc = e - pix * c8;
      const int ry = pix / q.RW, rx = pix - ry * q.RW;
      const int iy = iy0 + ry, ix = rx - g.pl;
      const bool ok = cc * 8 < g.Ci &&
                      static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
      cp_async16(Rs + pix * q.ldr + cc * 8,
                 ok ? xb + (iy * g.W + ix) * g.Ci + cc * 8 : xb, ok);
    }
  } else {
    const int total = rpix * q.Cp;
    for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * kMmaThreads) {
      __nv_bfloat16 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kMmaThreads;
        const int c = e % q.Cp, pix = e / q.Cp;
        const int ry = pix / q.RW, rx = pix - ry * q.RW;
        const int iy = iy0 + ry, ix = rx - g.pl;
        const bool ok = e < total && c < g.Ci &&
                        static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                        static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
        v[u] = ok ? xb[(iy * g.W + ix) * g.Ci + c] : zero;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kMmaThreads;
        if (e < total) Rs[(e / q.Cp) * q.ldr + e % q.Cp] = v[u];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // the region offset, at tap (0, 0), of the fragment row this lane hands
  // ldmatrix (pixel (lane & 7) + 8 * ((lane >> 3) & 1) of the m-fragment,
  // channels from 8 * (lane >> 4)); rows past the block's pixels read
  // pixel 0 and are never stored
  int a_off[MF];
#pragma unroll
  for (int j = 0; j < MF; ++j) {
    const int p = p0 + (warp * MF + j) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    int off = 0;
    if (p < p_end) {
      const int oy = p / g.OW, ox = p - oy * g.OW;
      off = ((oy - oy_first) * g.sh * q.RW + ox * g.sw) * q.ldr;
    }
    a_off[j] = off + 8 * (lane >> 4);
  }
  float acc[MF][NF][4] = {};
  for (int tap = 0; tap < taps; ++tap) {
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const __nv_bfloat16* rt = Rs + (dy * q.RW + dx) * q.ldr;
    for (int c0 = 0; c0 < q.Cp; c0 += 16) {
      uint32_t bf[NF][2];
      load_b<NF>(bf, Ws + (tap * q.Cp + c0) * q.ldw, q.ldw, lane);
#pragma unroll
      for (int j = 0; j < MF; ++j) {
        uint32_t a[4];
        ldsm_x4(a, rt + a_off[j] + c0);
#pragma unroll
        for (int i = 0; i < NF; ++i) mma_bf16(acc[j][i], a, bf[i][0], bf[i][1]);
      }
    }
  }

  __nv_bfloat16* yb = y + (static_cast<long long>(k) * g.B + b) * npix * g.Co;
#pragma unroll
  for (int j = 0; j < MF; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + (warp * MF + j) * 16 + gq + 8 * h;
      if (p >= p_end) continue;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + i * 8 + 2 * tq + e;
          if (co < g.Co) yb[p * g.Co + co] = __float2bfloat16_rn(acc[j][i][2 * h + e]);
        }
      }
    }
  }
}

// The tensor-core path's plan for this shape; smem 0 when it does not fit
// one block (an image row too wide for the channels), and the shape then
// takes the float32-unit kernel.
MmaPlan plan_mma(const Geom& g) {
  MmaPlan q;
  const int npix = g.OH * g.OW;
  const int mf = npix >= 128 ? 2 : 1;
  q.P = 16 * kMmaWarps * mf;
  q.Cp = (g.Ci + 15) / 16 * 16;
  q.ldr = q.Cp + 8;
  q.RW = (g.OW - 1) * g.sw + g.kw;
  q.bn = g.Co <= 8 ? 8 : g.Co <= 16 ? 16 : 32;
  q.ldw = q.bn == 8 ? 24 : q.bn + 8;
  int rows = (q.P + g.OW - 2) / g.OW + 1;          // most output rows a run spans
  if (rows > g.OH) rows = g.OH;
  const size_t rh = static_cast<size_t>(rows - 1) * g.sh + g.kh;
  q.smem = sizeof(__nv_bfloat16) *
           (static_cast<size_t>(g.kh) * g.kw * q.Cp * q.ldw + rh * q.RW * q.ldr);
  if (q.smem > kMaxSmem) q.smem = 0;
  return q;
}

template <int NF, int MF>
int launch_mma(const void* x, const void* w, void* y, const Geom& g, int K,
               const MmaPlan& q, cudaStream_t stream) {
  auto kern = fwd_mma_kernel<NF, MF>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(q.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int npix = g.OH * g.OW;
  const dim3 grid((npix + q.P - 1) / q.P, g.B, K * ((g.Co + q.bn - 1) / q.bn));
  kern<<<grid, kMmaThreads, q.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), g, q);
  return 0;
}

template <int MF>
int launch_mma_nf(const void* x, const void* w, void* y, const Geom& g, int K,
                  const MmaPlan& q, cudaStream_t stream) {
  switch (q.bn) {
    case 8: return launch_mma<1, MF>(x, w, y, g, K, q, stream);
    case 16: return launch_mma<2, MF>(x, w, y, g, K, q, stream);
    default: return launch_mma<4, MF>(x, w, y, g, K, q, stream);
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

// ------------------------- the bfloat16 stride-1 weight gradient, mma.sync
// A block's shape on this path, set by the host (plan_wgrad_mma).
struct MmaWgradPlan {
  int nf;               // output-channel fragments of 8 in a block tile
  int R;                // output rows of a unit: a band of one image
  int bands;            // units of an image, ceil(OH / R)
  int rh;               // region rows of a unit, R - 1 + kh
  int owp;              // OW rounded up to 16: pixels of a row, padded
  int rwp;              // region columns: owp + kw - 1
  int ldg;              // bf16 per pixel of the staged g: 8 * nf + 8, >= 24
  int tiles;            // Ci tiles (16) * Co tiles (8 * nf)
  int units_per_split;  // consecutive units a block sums
  int splits;           // S, the blocks that share one output tile
  size_t smem;          // dynamic shared memory of a block, bytes
};

constexpr int kLdx = 24;   // bf16 per pixel of the staged x: 16 channels + 8

MmaWgradPlan plan_wgrad_mma(const Geom& g, int K, int sms) {
  MmaWgradPlan p;
  p.nf = g.Co <= 8 ? 1 : g.Co <= 16 ? 2 : 4;
  p.owp = (g.OW + 15) / 16 * 16;
  p.rwp = p.owp + g.kw - 1;
  p.ldg = p.nf == 1 ? 24 : 8 * p.nf + 8;
  p.tiles = ((g.Ci + 15) / 16) * ((g.Co + 8 * p.nf - 1) / (8 * p.nf));
  p.smem = 0;
  int r0 = 128 / g.OW;
  if (r0 < 1) r0 = 1;
  if (r0 > g.OH) r0 = g.OH;
  for (int r = r0; r >= 1; --r) {
    p.R = r;
    p.rh = r - 1 + g.kh;
    const size_t need = sizeof(__nv_bfloat16) *
        (static_cast<size_t>(p.rh) * p.rwp * kLdx + static_cast<size_t>(r) * p.owp * p.ldg);
    if (need <= kMaxSmem) {
      p.smem = need;
      break;
    }
  }
  p.bands = (g.OH + p.R - 1) / p.R;
  const long long units = static_cast<long long>(g.B) * p.bands;
  const long long target = 6LL * sms;
  long long s = (target + 1LL * K * p.tiles - 1) / (1LL * K * p.tiles);
  if (s > units) s = units;
  if (s < 1) s = 1;
  p.units_per_split = static_cast<int>((units + s - 1) / s);
  p.splits = static_cast<int>((units + p.units_per_split - 1) / p.units_per_split);
  return p;
}

// One block: client k, units [u0, u0 + units_per_split), a tile of 16
// input and 8 * NF output channels; one warp per kernel row dy.  Per unit
// it copies the band's input region ([rh][rwp][16] bf16, zero outside the
// image and past the row) and the band's g ([R][owp][8 * NF], zero past
// OW) into shared memory in the tensors' own channels-last layout (16-byte
// cp.async copies).  Then dw[dy, dx][ci][co] += x_shift[ci][pixels] *
// g[pixels][co] runs on the tensor cores, 16 pixels a step: transposing
// ldmatrix reads the A fragment (channels x pixels) from the region at
// the tap's offset and the B fragments (pixels x channels) from g, shared
// by the KW taps of the row.  Each step's mma starts from zero and its
// 16-product sum is added to float32 registers with an IEEE add, so the
// long sum over the pixels rounds as a float32 sum does (the tensor
// cores' own accumulation is not IEEE rounded).
template <int KW, int NF>
__global__ void __launch_bounds__(256)
wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ gr,
                 float* __restrict__ part, Geom g, int K, MmaWgradPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [rh][rwp][kLdx]
  __nv_bfloat16* Gs = Xs + p.rh * p.rwp * kLdx;                     // [R][owp][ldg]

  const int taps = g.kh * g.kw;
  const int co_tiles = (g.Co + 8 * NF - 1) / (8 * NF);
  const int k = blockIdx.y;
  const int ci0 = (blockIdx.z / co_tiles) * 16;
  const int co0 = (blockIdx.z % co_tiles) * 8 * NF;
  const int units = g.B * p.bands;
  const int u_begin = blockIdx.x * p.units_per_split;
  const int u_end = min(units, u_begin + p.units_per_split);
  const int dy = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* xk = x + static_cast<long long>(k) * g.B * g.H * g.W * g.Ci;
  const __nv_bfloat16* gk = gr + static_cast<long long>(k) * g.B * g.OH * g.OW * g.Co;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  // the pixel and channel offset of the matrix row this lane hands
  // ldmatrix: matrices (px 0-7, ch 0-7), (px 0-7, ch 8-15), (px 8-15,
  // ch 0-7), (px 8-15, ch 8-15) give the A fragment's a0 .. a3
  const int a_px = (lane & 7) + 8 * (lane >> 4), a_ch = 8 * ((lane >> 3) & 1);
  float acc[KW][NF][4] = {};

  for (int u = u_begin; u < u_end; ++u) {
    const int b = u / p.bands, oy0 = (u - b * p.bands) * p.R;
    const int rows = min(p.R, g.OH - oy0);
    const int iy0 = oy0 - g.pt;
    // the region: pixel (ry, rx) is x[b, iy0 + ry, rx - pl, ci0 .. ci0 + 15]
    const int rpix = p.rh * p.rwp;
    if ((g.Ci & 7) == 0) {
      for (int e = threadIdx.x; e < rpix * 2; e += blockDim.x) {
        const int pix = e >> 1, c = ci0 + (e & 1) * 8;
        const int ry = pix / p.rwp, rx = pix - ry * p.rwp;
        const int iy = iy0 + ry, ix = rx - g.pl;
        const bool ok = c < g.Ci &&
                        static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                        static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
        cp_async16(Xs + pix * kLdx + (e & 1) * 8,
                   ok ? xk + ((b * g.H + iy) * g.W + ix) * g.Ci + c : xk, ok);
      }
    } else {
      const int total = rpix * 16;
      for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * blockDim.x) {
        __nv_bfloat16 v[kLoads];
#pragma unroll
        for (int uu = 0; uu < kLoads; ++uu) {
          const int e = e0 + uu * blockDim.x;
          const int pix = e >> 4, c = ci0 + (e & 15);
          const int ry = pix / p.rwp, rx = pix - ry * p.rwp;
          const int iy = iy0 + ry, ix = rx - g.pl;
          const bool ok = e < total && c < g.Ci &&
                          static_cast<unsigned>(iy) < static_cast<unsigned>(g.H) &&
                          static_cast<unsigned>(ix) < static_cast<unsigned>(g.W);
          v[uu] = ok ? xk[((b * g.H + iy) * g.W + ix) * g.Ci + c] : zero;
        }
#pragma unroll
        for (int uu = 0; uu < kLoads; ++uu) {
          const int e = e0 + uu * blockDim.x;
          if (e < total) Xs[(e >> 4) * kLdx + (e & 15)] = v[uu];
        }
      }
    }
    // g: pixel (py, px) is g[b, oy0 + py, px, co0 .. co0 + 8 NF - 1]
    const int gtotal = rows * p.owp * NF;
    for (int e = threadIdx.x; e < gtotal; e += blockDim.x) {
      const int pix = e / NF, c8 = e - pix * NF;
      const int py = pix / p.owp, px = pix - py * p.owp;
      const int c = co0 + c8 * 8;
      const bool ok = px < g.OW && c < g.Co;
      cp_async16(Gs + pix * p.ldg + c8 * 8,
                 ok ? gk + ((b * g.OH + oy0 + py) * g.OW + px) * g.Co + c : gk, ok);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int py = 0; py < rows; ++py) {
      for (int p0 = 0; p0 < p.owp; p0 += 16) {
        uint32_t bf[NF][2];
        load_b<NF>(bf, Gs + (py * p.owp + p0) * p.ldg, p.ldg, lane);
        const __nv_bfloat16* xr = Xs + ((py + dy) * p.rwp + p0 + a_px) * kLdx + a_ch;
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) {
          uint32_t a[4];
          ldsm_x4_trans(a, xr + dx * kLdx);
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(c, a, bf[j][0], bf[j][1]);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[dx][j][r] += c[r];
          }
        }
      }
    }
    __syncthreads();
  }

  float* out = part + (static_cast<long long>(blockIdx.x) * K + k) * taps * g.Ci * g.Co;
#pragma unroll
  for (int dx = 0; dx < KW; ++dx) {
    float* o = out + (dy * g.kw + dx) * g.Ci * g.Co;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ci = ci0 + gq + 8 * (r >> 1), co = co0 + j * 8 + 2 * tq + (r & 1);
        if (ci < g.Ci && co < g.Co) o[ci * g.Co + co] = acc[dx][j][r];
      }
    }
  }
}

template <int KW, int NF>
int launch_wgrad_mma(const void* x, const void* gr, float* target, const Geom& g,
                     int K, const MmaWgradPlan& p, cudaStream_t stream) {
  auto kern = wgrad_mma_kernel<KW, NF>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.splits, K, p.tiles);
  kern<<<grid, 32 * g.kh, p.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gr),
      target, g, K, p);
  return 0;
}

template <int KW>
int launch_wgrad_mma_nf(const void* x, const void* gr, float* target,
                        const Geom& g, int K, const MmaWgradPlan& p,
                        cudaStream_t stream) {
  switch (p.nf) {
    case 1: return launch_wgrad_mma<KW, 1>(x, gr, target, g, K, p, stream);
    case 2: return launch_wgrad_mma<KW, 2>(x, gr, target, g, K, p, stream);
    default: return launch_wgrad_mma<KW, 4>(x, gr, target, g, K, p, stream);
  }
}

// Whether a weight gradient takes the tensor-core path: bfloat16, stride 1,
// kernels of at most 3 columns and 8 rows, Co a multiple of 8 (g is read
// 8 channels at a time), a region that fits a block.
bool wgrad_on_mma(const Geom& g, int dtype, const MmaWgradPlan& p) {
  return dtype == kBF16 && g.sh == 1 && g.sw == 1 && g.kw <= 3 && g.kh <= 8 &&
         g.Co % 8 == 0 && p.smem != 0;
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
  const int err = prepare(g, K, dtype, device);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MmaPlan q = plan_mma(g);
  if (dtype == kF32 || q.smem == 0 || K * ((Co + q.bn - 1) / q.bn) > 65535 ||
      B > 65535) {
    if (dtype == kF32) {
      launch_fwd_t<float>(x, w, y, g, K, s);
    } else {
      launch_fwd_t<__nv_bfloat16>(x, w, y, g, K, s);
    }
  } else {
    const int launched = OH * OW >= 128 ? launch_mma_nf<2>(x, w, y, g, K, q, s)
                                        : launch_mma_nf<1>(x, w, y, g, K, q, s);
    if (launched != 0) return launched;
  }
  return static_cast<int>(cudaGetLastError());
}

// S, the number of float32 [K, kh, kw, Ci, Co] partials the weight
// gradient of this shape sums (the wrapper allocates them when S > 1);
// negative on an error (or a shape whose image row does not fit a block).
int fedml_mc_conv_wgrad_splits(int K, int B, int H, int W, int Ci, int OH,
                               int OW, int Co, int kh, int kw, int sh, int sw,
                               int pt, int pl, int dtype, int device) {
  const Geom g{B, H, W, Ci, OH, OW, Co, kh, kw, sh, sw, pt, pl};
  int sms = 0;
  const int err = sm_count(device, &sms);
  if (err != 0) return -err;
  const MmaWgradPlan q = plan_wgrad_mma(g, K, sms);
  if (wgrad_on_mma(g, dtype, q)) return q.splits;
  const WgradPlan p = plan_wgrad(g, K, sms);
  return p.smem == 0 ? -static_cast<int>(cudaErrorInvalidValue) : p.splits;
}

// x [K, B, H, W, Ci] and g [K, B, OH, OW, Co] of one dtype; dw float32
// [K, kh, kw, Ci, Co]; part float32 [splits, K, kh, kw, Ci, Co], or null
// when splits is 1 (the one partial is dw).
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
  const MmaWgradPlan q = plan_wgrad_mma(g, K, sms);
  const bool on_mma = wgrad_on_mma(g, dtype, q);
  const WgradPlan p = plan_wgrad(g, K, sms);
  const int want = on_mma ? q.splits : p.smem == 0 ? 0 : p.splits;
  if (want != splits || splits < 1 || (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* target = splits > 1 ? part : dw;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (on_mma) {
    switch (kw) {
      case 1: err = launch_wgrad_mma_nf<1>(x, gr, target, g, K, q, s); break;
      case 2: err = launch_wgrad_mma_nf<2>(x, gr, target, g, K, q, s); break;
      default: err = launch_wgrad_mma_nf<3>(x, gr, target, g, K, q, s); break;
    }
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
