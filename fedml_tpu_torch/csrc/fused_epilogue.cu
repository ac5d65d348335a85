// The fused round epilogue, written for Hopper (sm_90a): weighted reduce over
// the client axis, then one server-optimizer channel, in one pass.
//
// Replaces four Pallas kernels of fedml_tpu/ops/epilogue.py, which
// fused_epilogue launches once per leaf through _leaf_pallas_call:
//
//     _mix_kernel       (opt "none")   out = g + s*(acc - g)
//     _sgd_kernel       (opt "sgd")    out = g - lr*s*(g - acc)
//     _momentum_kernel  (opt "momentum")
//         m' = mu*m + s*(g - acc);                            out = g - lr*m'
//     _adam_kernel      (opt "adam")
//         grad = s*(g - acc); m' = b1*m + (1-b1)*grad;
//         v' = b2*v + (1-b2)*grad*grad;
//         out = g - lr*(m'/bc1) / (sqrt(v'/bc2) + eps)
//
// For column j of a row-major [C, P] stacked buffer with row stride ld >= P
// (the parameter columns of the round's [C, D] client buffer),
//
//     acc = f32(T_x(sum_c (w[c] / max(sum(w), 1e-12)) * x[c, j]))
//
// is the reduce head of reduce_head.cuh, the same as weighted_reduce.cu's,
// followed by the cast to the stacked type and back that _acc_tile makes
// (a double rounding for bfloat16).  Every channel then works in float32 and
// casts the result to the global's type; m and v are float32.  s is the
// mixing rate (1 on the Parrot path, server_lr in fold_buffer); lr, mu, b1,
// b2, eps, 1-b1, 1-b2 and the bias corrections bc = 1 - b^t are float32,
// rounded on the host exactly as the JAX package rounds them.
//
// The step's scalars are read from device memory, as the Pallas kernel reads
// its p_ref: row r of a [n_rows, kNumParams] float32 table, r = min(t,
// n_rows) - 1 for the step t (0 without a step count: adam's t, already
// advanced to this step), which comes by value or from device memory.  From
// device memory (the int64 count the caller keeps there), a launch captured
// into a CUDA graph takes each replay's own step: nothing of the step is
// frozen into the launch's parameters.  The last warp of each block reads
// the row into shared memory while warp 0 reads the weights, so the two
// reads overlap.
// This source is built with -fmad=false (see ops/cuda_build.py): no product
// is contracted into an fma, so each operation rounds where the plain
// version's does; the reduce head's fmaf is written out and stays.
//
// g, m and v may be updated in place: out may be g itself, and each element
// of g, m, v and out is read and written by one thread only.
//
// What bounds it: bytes.  Per column it reads C stacked values and g (and
// m, v) and writes out (and m, v): (C + 2)*4 bytes for mix and sgd, +8 for
// momentum, +16 for adam, in float32.  At the FedOpt round's shape (C = 10,
// P = 855,776) adam moves 54.8 MB, about 16.4 us at the 3.35 TB/s of an H100
// SXM; its ~30 float32 operations per column are far below the card's rate.
//
// What the design does about it: kernel 1's answer.  One coalesced pass;
// each thread owns 4 neighbouring columns (16-byte loads of float32 rows
// when P, ld and every pointer allow, else one column per thread), keeps the
// accumulators and the state in registers, and writes each output once.
// The weights are normalised per block in shared memory, so a round's whole
// server step is one launch.
//
// Plain C interface for ctypes.  The launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include "reduce_head.cuh"

namespace {

using namespace fedml;

enum Opt { kNone = 0, kSgd = 1, kMomentum = 2, kAdam = 3 };

struct Params {
  float s, lr, mu, b1, omb1, b2, omb2, eps, bc1, bc2;
};
constexpr int kNumParams = 10;

// the step's row of the table: the first kNumParams floats of shared memory;
// the step is *t where t is given, else `step`
struct StepRows {
  const float* rows;
  int64_t n_rows;
  int64_t step;
  const long long* t;
};

struct Args {
  const void* x;
  int64_t ld;
  const float* w;
  int C;
  const void* g;
  void* out;
  float* m;
  float* v;
  int64_t P;
  StepRows step;
};

// lanes 0..kNumParams-1 of the block's last warp copy the step's row into
// sp; the barriers of normalise_weights publish it
__device__ __forceinline__ void load_step(const StepRows& step, float* sp) {
  const int lane = static_cast<int>(threadIdx.x) - (kThreads - 32);
  if (lane < 0 || lane >= kNumParams) return;
  const int64_t t = step.t != nullptr ? *step.t : step.step;
  const int64_t r = t < 1 ? 0 : (t > step.n_rows ? step.n_rows : t) - 1;
  sp[lane] = step.rows[r * kNumParams + lane];
}

template <typename Tx, typename Tg, int VEC, int OPT>
__global__ void __launch_bounds__(kThreads)
fused_epilogue_kernel(const Tx* __restrict__ x, int64_t ld_packs,
                      const float* __restrict__ w, int C, const Tg* g,
                      Tg* out, float* m, float* v, StepRows step,
                      int64_t groups) {
  extern __shared__ float smem[];
  load_step(step, smem);
  normalise_weights(w, C, smem + kNumParams);
  const Params p{smem[0], smem[1], smem[2], smem[3], smem[4],
                 smem[5], smem[6], smem[7], smem[8], smem[9]};
  const float* wn = smem + kNumParams;

  const Pack<Tx, VEC>* src = reinterpret_cast<const Pack<Tx, VEC>*>(x);
  const Pack<Tg, VEC>* gsrc = reinterpret_cast<const Pack<Tg, VEC>*>(g);
  Pack<Tg, VEC>* dst = reinterpret_cast<Pack<Tg, VEC>*>(out);
  Pack<float, VEC>* mp = reinterpret_cast<Pack<float, VEC>*>(m);
  Pack<float, VEC>* vp = reinterpret_cast<Pack<float, VEC>*>(v);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < groups; i += stride) {
    float acc[VEC];
    accumulate<Tx, VEC>(src, ld_packs, i, wn, C, acc);
    const Pack<Tg, VEC> gp = gsrc[i];
    Pack<float, VEC> mm, vv;
    if constexpr (OPT == kMomentum || OPT == kAdam) mm = mp[i];
    if constexpr (OPT == kAdam) vv = vp[i];
    Pack<Tg, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float a = round_to(acc[j], static_cast<const Tx*>(nullptr));
      const float gf = to_f32(gp.v[j]);
      float r;
      if constexpr (OPT == kNone) {
        r = gf + p.s * (a - gf);
      } else {
        const float grad = p.s * (gf - a);
        if constexpr (OPT == kSgd) {
          r = gf - p.lr * grad;
        } else if constexpr (OPT == kMomentum) {
          const float mn = p.mu * mm.v[j] + grad;
          mm.v[j] = mn;
          r = gf - p.lr * mn;
        } else {
          const float mn = p.b1 * mm.v[j] + p.omb1 * grad;
          const float vn = p.b2 * vv.v[j] + p.omb2 * grad * grad;
          mm.v[j] = mn;
          vv.v[j] = vn;
          const float mhat = mn / p.bc1;
          const float vhat = vn / p.bc2;
          r = gf - p.lr * mhat / (sqrtf(vhat) + p.eps);
        }
      }
      store_f32(r, &o.v[j]);
    }
    dst[i] = o;
    if constexpr (OPT == kMomentum || OPT == kAdam) mp[i] = mm;
    if constexpr (OPT == kAdam) vp[i] = vv;
  }
}

template <typename Tx, typename Tg, int OPT>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kVec = 4;
  const bool state_aligned =
      ((OPT != kMomentum && OPT != kAdam) || aligned16(a.m)) &&
      (OPT != kAdam || aligned16(a.v));
  const bool vec = a.P % kVec == 0 && a.ld % kVec == 0 && aligned16(a.x) &&
                   aligned16(a.g) && aligned16(a.out) && state_aligned;
  const int64_t groups = vec ? a.P / kVec : a.P;
  const int blocks = grid_for(groups);
  const size_t smem = smem_bytes(a.C) + kNumParams * sizeof(float);
  const Tx* x = static_cast<const Tx*>(a.x);
  const Tg* g = static_cast<const Tg*>(a.g);
  Tg* out = static_cast<Tg*>(a.out);
  if (vec) {
    fused_epilogue_kernel<Tx, Tg, kVec, OPT><<<blocks, kThreads, smem, stream>>>(
        x, a.ld / kVec, a.w, a.C, g, out, a.m, a.v, a.step, groups);
  } else {
    fused_epilogue_kernel<Tx, Tg, 1, OPT><<<blocks, kThreads, smem, stream>>>(
        x, a.ld, a.w, a.C, g, out, a.m, a.v, a.step, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Tx, typename Tg>
int launch_opt(int opt, const Args& a, cudaStream_t s) {
  switch (opt) {
    case kNone:
      return launch<Tx, Tg, kNone>(a, s);
    case kSgd:
      return launch<Tx, Tg, kSgd>(a, s);
    case kMomentum:
      return launch<Tx, Tg, kMomentum>(a, s);
    case kAdam:
      return launch<Tx, Tg, kAdam>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Tx>
int launch_g(int g_dtype, int opt, const Args& a, cudaStream_t s) {
  switch (g_dtype) {
    case kF32:
      return launch_opt<Tx, float>(opt, a, s);
    case kBF16:
      return launch_opt<Tx, __nv_bfloat16>(opt, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int fedml_fused_epilogue_max_clients() { return fedml::kMaxClients; }

int fedml_fused_epilogue_num_params() { return kNumParams; }

// x: [C, P] in the type named by x_dtype, row stride ld >= P elements;
// w: [C] float32; g and out: [P] contiguous in the type named by g_dtype
// (out may be g); m: [P] float32 for momentum and adam, v: [P] float32 for
// adam, both updated in place (null otherwise).  rows: [n_rows, kNumParams]
// float32 in the order of struct Params; the kernel takes row min(s, n_rows)
// - 1 (row 0 for s < 1) of the step s = *t where t, an int64 in device
// memory, is given, else s = step.  All on `device`.
int fedml_fused_epilogue(const void* x, long long ld, const float* w, int C,
                         const void* g, void* out, float* m, float* v,
                         long long P, int opt, int x_dtype, int g_dtype,
                         const float* rows, long long n_rows, long long step,
                         const long long* t, int device, void* stream) {
  if (C < 1 || C > fedml::kMaxClients || P < 1 || ld < P ||
      rows == nullptr || n_rows < 1 ||
      ((opt == kMomentum || opt == kAdam) && !m) || (opt == kAdam && !v)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{x, ld, w, C, g, out, m, v, P, StepRows{rows, n_rows, step, t}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case fedml::kF32:
      return launch_g<float>(g_dtype, opt, a, s);
    case fedml::kBF16:
      return launch_g<__nv_bfloat16>(g_dtype, opt, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
