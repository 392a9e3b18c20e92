// Fused modulated-SIREN TRAINING forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mri_inr_tpu/ops/siren_train_kernel.py:_fwd_kernel. Per patch b and
// coordinate row s (drop_i is the counter-hash dropout of layer i, see
// siren_common.cuh; the identity when the rate is 0):
//
//   x_0   = bf16(drop_0(base[s]) * mod_0[b])
//   pre_i = x_{i-1} @ W_i + b_i                  (bf16 x bf16 -> f32 accumulate)
//   x_i   = bf16(drop_i(act(pre_i)) * mod_i[b])  i = 1 .. L-1
//   out   = sin_poly(w0 * (sum_h x_{L-1}[h] * last_w[h] + last_b))
//
// act is sin_poly(w0 * p), times exp(-p^2 / 2) for Morlet; sin_poly is the
// degree-5 or the degree-9 polynomial (the DEG template argument) in the
// hidden layers and at the output alike. Unlike the eval kernel the last
// modulation is applied (and rounded to bf16) before the projection, as the
// TPU kernel does. The dropout bit of element (b, s, col) is hashed from its
// global index (b * S + s) * H + col, so the backward kernel regenerates it.
//
// What bounds it on an H100, at the training shape (B=400, S=576, H=256,
// L=5, dropout 0.1, degree 5): the products, 2 * B * S * H^2 * (L-1) =
// 1.2e11 bf16 tensor-core operations (0.12 ms at 989 TFLOP/s), against a
// few MB of input and output; the weight stream from L2 (512 KB of hidden
// weights for every block's rows); and the epilogue's scalar work, 2.4e8
// activations of about 17 instructions each with the dropout hash, ~0.11 ms
// on the FMA pipe: as in the eval kernel, products and epilogue must
// overlap.
//
// Design: the eval kernel's (siren_fwd.cuh): a persistent block per SM, a
// producer warpgroup streaming W^T slabs by TMA into a 6-stage ring, two
// consumer warpgroups on 64-row tiles taking turns at the tensor cores
// (wgmma m64nHk16, activations as register A fragments), so a slab serves
// 128 rows (0.94 GB from L2 a call at B=400, from 1.9 GB) and one tile's
// epilogue runs under the other's products. This file holds the training
// epilogue: the dropout hash, modulation and bf16 rounding after every
// activation, and the projection with last_w in the last layer's epilogue;
// the sine degree and the activation (sine or Morlet) are template
// arguments.
//
// What it reads (PERF.md, one H100 at 700 W; chip_smoke.py and
// scripts/torch_fwd_cut_probe.py): 0.45-0.53 ms a call at B=400, 23-27% of
// the bound. A hidden layer's epilogue, with the hash, takes about 6,600 SM
// cycles against the 2,048 of its products at peak: the epilogues set the
// pace.
//
// The earlier design: the eval kernel's first one, one block of 8
// warps per (patch, 64-row tile), mma.sync fed by ldmatrix, a 3-stage
// cp.async ring per block: 1.01 ms a call at B=400, 12% of the bound (one
// H100 at 700 W, PERF.md).

#include "siren_fwd.cuh"

namespace {

using namespace siren;

struct TrainArgs {
  siren_fwd::Common common;  // mods: (B, L*H) f32
  const float* seed;         // (1,) f32 holding an integer
  const float* last_w;       // (H,) f32
  const float* last_b;       // (1,) f32
  float w0;
  int32_t thresh;   // keep where (int32)hash < thresh
  float inv_keep;   // 1 / keep
  int dropout;      // 0: rate 0, no mask
};

template <int DEG, bool MORLET>
struct TrainEpilogue {
  using Args = TrainArgs;
  static constexpr int EXTRA = 1;  // last_w
  static __device__ void load_extra(const Args& a, float* extra, int H, int tid, int threads) {
    for (int i = tid; i < H; i += threads) extra[i] = a.last_w[i];
  }

  Dropout dp;
  const float* lw;
  float w0, last_b;
  __device__ TrainEpilogue(const Args& a, const float* extra)
      : dp{(uint32_t)(int)a.seed[0], a.thresh, a.inv_keep, a.dropout},
        lw(extra),
        w0(a.w0),
        last_b(a.last_b[0]) {}

  __device__ __forceinline__ float act(float pre) const {
    float a = poly_sin<DEG>(w0 * pre);
    if (MORLET) a *= expf(-0.5f * (pre * pre));
    return a;
  }
  __device__ __forceinline__ float stage_mod(float m, int) const { return m; }
  __device__ __forceinline__ uint32_t layer_off(int layer) const {
    return layer_offset(dp, layer);
  }
  __device__ __forceinline__ float x0(float v, float mod, uint32_t e, uint32_t off) const {
    return __fmul_rn(drop(dp, v, e, off), mod);
  }
  __device__ __forceinline__ float hidden(float pre, float mod, uint32_t e,
                                          uint32_t off) const {
    return __fmul_rn(drop(dp, act(pre), e, off), mod);
  }
  // x_{L-1}, rounded to bf16 as the layers before, times last_w
  __device__ __forceinline__ float last(float pre, float mod, int col, uint32_t e,
                                        uint32_t off) const {
    return bf16_round(hidden(pre, mod, e, off)) * lw[col];
  }
  __device__ __forceinline__ float out(float r) const { return poly_sin<DEG>(w0 * (r + last_b)); }
};

template <int H, int DEG>
cudaError_t launch_act(const TrainArgs& args, int morlet, const void* swt,
                       cudaStream_t stream) {
  return morlet ? siren_fwd::launch<H, TrainEpilogue<DEG, true>>(args, swt, stream)
                : siren_fwd::launch<H, TrainEpilogue<DEG, false>>(args, swt, stream);
}

template <int H>
cudaError_t launch_deg(const TrainArgs& args, int deg, int morlet, const void* swt,
                       cudaStream_t stream) {
  switch (deg) {
    case 5: return launch_act<H, 5>(args, morlet, swt, stream);
    case 9: return launch_act<H, 9>(args, morlet, swt, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). Pointers are device pointers to
// contiguous tensors; swt is the hidden weights transposed, (L-1, H, H) bf16
// (out, in) per layer, 16-byte aligned; deg is 5 or 9 (sine degree, hidden
// and output); dropout is 0 (no mask) or 1 (keep where hash < thresh, scale
// by inv_keep).
extern "C" int siren_train_fwd_launch(const void* seed, const void* mods, const void* base,
                                      const void* swt, const void* sb, const void* last_w,
                                      const void* last_b, void* out, int B, int S, int H,
                                      int L, float w0, int morlet, int deg, int dropout,
                                      int thresh, float inv_keep, void* stream) {
  if (B <= 0 || S <= 0 || L < 2) return (int)cudaErrorInvalidValue;
  TrainArgs args{{static_cast<const float*>(mods), static_cast<const float*>(base),
                  static_cast<const float*>(sb), static_cast<float*>(out), B, S, L, 0},
                 static_cast<const float*>(seed),
                 static_cast<const float*>(last_w),
                 static_cast<const float*>(last_b),
                 w0,
                 (int32_t)thresh,
                 inv_keep,
                 dropout};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return (int)launch_deg<64>(args, deg, morlet, swt, st);
    case 128: return (int)launch_deg<128>(args, deg, morlet, swt, st);
    case 192: return (int)launch_deg<192>(args, deg, morlet, swt, st);
    case 256: return (int)launch_deg<256>(args, deg, morlet, swt, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* siren_train_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
