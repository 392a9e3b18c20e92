// Fused modulated-SIREN forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mri_inr_tpu/ops/siren_kernel.py:_kernel
// (launched by fused_siren_forward). Per patch b and coordinate row s:
//
//   x_0   = bf16(base[s] * mod_0[b])
//   pre_i = x_{i-1} @ W_i + b_i                 (bf16 x bf16 -> f32 accumulate)
//   a_i   = sin_poly(w0 * pre_i) [* exp(-pre_i^2 / 2) for Morlet]
//   x_i   = bf16(a_i * mod_i[b])                i = 1 .. L-2
//   out   = sin_out(w0 * (sum_h a_{L-1}[h] * modproj[b, h] + last_b))
//
// where modproj is the last layer's modulation already multiplied by the
// projection weights (done by the caller, as in the JAX package).
//
// What bounds it on an H100, at the eval shape (B=1024, S=576, H=256, L=5):
// - the products: 2 * B * S * H^2 * (L-1) = 3.1e11 bf16 tensor-core
//   operations, 0.31 ms at 989 TFLOP/s; its own input and output are ~9 MB;
// - the weight stream from L2: every block that computes some rows needs all
//   (L-1) * H^2 * 2 = 512 KB of hidden weights in shared memory;
// - the epilogue's scalar work: B * S * H * (L-1) = 6.0e8 activations of
//   about 13 FP32 instructions each (range reduction with a floor, the
//   polynomial, bias, w0, modulation, bf16 pack): ~0.23 ms on the FMA pipe,
//   close to the products' bound, so products and epilogue must overlap.
//
// Design (siren_fwd.cuh, the TPU kernel's `streams=2` in Hopper's idiom): a
// persistent block per SM with a producer warpgroup streaming W^T slabs by
// TMA into a 6-stage ring (at H=256, L=5) and two consumer warpgroups, each
// owning a 64-row tile; wgmma m64nHk16 with the activations as register A
// fragments, so a slab loaded once serves 128 rows (2.4 GB from L2 a call at
// B=1024, half of the earlier design's 4.8 GB); the consumers take turns at
// the tensor cores, so one's epilogue runs under the other's products. This
// file holds the eval epilogue: the hidden sine mode (degree 5, 7, 9, or
// degree 7 in bf16) and the activation (sine or Morlet) are template
// arguments; the projection with modproj is folded into the last layer's
// epilogue, a row's sum over H lying in one quad of lanes.
//
// What it reads (PERF.md, one H100 at 700 W; chip_smoke.py and
// scripts/torch_fwd_cut_probe.py): 0.80-0.86 ms a call at B=1024, 36-39% of
// the bound. A consumer's epilogue of a hidden layer takes about 3,400 SM
// cycles against the 2,048 its products need at the tensor cores' peak, and
// each tile starts with about 7,700 cycles of modulations and x_0: the
// epilogues, not the weight stream (cutting the TMA loads saves 2%), set the
// pace.
//
// The earlier design: one block of 8 warps per (patch, 64-row tile),
// mma.sync m16n8k16 fed by ldmatrix, the weights through a 3-stage cp.async
// ring of 32-row slabs per block (4.8 GB from L2 a call), a __syncthreads
// per slab and no overlap of products and epilogue inside a block: 1.82 ms
// a call at B=1024, 17% of the bound (one H100 at 700 W, PERF.md).
//
// Built with nvcc into a shared library with a plain C interface; the
// Python wrapper (ops/siren_kernel.py) checks every tensor and calls
// siren_forward_launch through ctypes on PyTorch's current stream.

#include "siren_fwd.cuh"

namespace {

using namespace siren;

// Hidden-layer sine variants (the MODE template argument).
constexpr int SIN_BF16 = 0;  // degree 7, polynomial evaluated in bf16

struct EvalArgs {
  siren_fwd::Common common;  // mods: (B, L*H) f32, block L-1 is modproj
  const float* last_b;       // (1,) f32
  float w0;
  int round_mods;  // hidden modulations rounded to bf16 (sin_bf16 mode)
  int out_deg;     // 7 or 9
};

// Degree 7 with every polynomial operation rounded to bf16. Products and
// sums of two bf16 values are exact in f32, so one rounding per operation
// reproduces bf16 arithmetic. Coefficients are the degree-7 ones rounded
// to bf16.
__device__ __forceinline__ float sin7_bf16(float x) {
  float v = bf16_round(reduce_range(x));
  float v2 = bf16_round(v * v);
  float p = bf16_round(0.0079345703125f + bf16_round(v2 * -0.00014495849609375f));
  p = bf16_round(-0.166015625f + bf16_round(v2 * p));
  p = bf16_round(1.0f + bf16_round(v2 * p));
  return bf16_round(v * p);
}

template <int MODE>
__device__ __forceinline__ float hidden_sin(float x) {
  if (MODE == 5) return sin5(x);
  if (MODE == 7) return sin7(x);
  if (MODE == 9) return sin9(x);
  return sin7_bf16(x);
}

template <int MODE, bool MORLET>
struct EvalEpilogue {
  using Args = EvalArgs;
  static constexpr int EXTRA = 0;  // no H-wide vectors beyond the biases
  static __device__ void load_extra(const Args&, float*, int, int, int) {}

  float w0, last_b;
  int L, round_mods, out_deg;
  __device__ EvalEpilogue(const Args& a, const float*)
      : w0(a.w0), last_b(a.last_b[0]), L(a.common.L), round_mods(a.round_mods),
        out_deg(a.out_deg) {}

  __device__ __forceinline__ float act(float pre) const {
    float a = hidden_sin<MODE>(w0 * pre);
    if (MORLET) a *= expf(-0.5f * (pre * pre));
    return a;
  }
  __device__ __forceinline__ float stage_mod(float m, int layer) const {
    return round_mods && layer >= 1 && layer < L - 1 ? bf16_round(m) : m;
  }
  __device__ __forceinline__ uint32_t layer_off(int) const { return 0; }
  __device__ __forceinline__ float x0(float v, float mod, uint32_t, uint32_t) const {
    return v * mod;
  }
  __device__ __forceinline__ float hidden(float pre, float mod, uint32_t, uint32_t) const {
    return act(pre) * mod;
  }
  __device__ __forceinline__ float last(float pre, float modproj, int, uint32_t,
                                        uint32_t) const {
    return act(pre) * modproj;
  }
  __device__ __forceinline__ float out(float r) const {
    const float z = w0 * (r + last_b);
    return out_deg == 9 ? sin9(z) : sin7(z);
  }
};

template <int H, int MODE>
cudaError_t launch_act(const EvalArgs& args, int morlet, const void* swt, cudaStream_t stream) {
  return morlet ? siren_fwd::launch<H, EvalEpilogue<MODE, true>>(args, swt, stream)
                : siren_fwd::launch<H, EvalEpilogue<MODE, false>>(args, swt, stream);
}

template <int H>
cudaError_t launch_mode(const EvalArgs& args, int mode, int morlet, const void* swt,
                        cudaStream_t stream) {
  switch (mode) {
    case 5: return launch_act<H, 5>(args, morlet, swt, stream);
    case 7: return launch_act<H, 7>(args, morlet, swt, stream);
    case 9: return launch_act<H, 9>(args, morlet, swt, stream);
    case SIN_BF16: return launch_act<H, SIN_BF16>(args, morlet, swt, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). Pointers are device pointers to
// contiguous tensors; swt is the hidden weights transposed, (L-1, H, H) bf16
// (out, in) per layer, 16-byte aligned; mode is 5, 7 or 9 (hidden sine
// degree) or 0 (degree 7 in bf16); out_deg is 7 or 9.
extern "C" int siren_forward_launch(const void* mods, const void* base, const void* swt,
                                    const void* sb, const void* last_b, void* out, int B,
                                    int S, int H, int L, float w0, int morlet, int mode,
                                    int round_mods, int out_deg, void* stream) {
  if (B <= 0 || S <= 0 || L < 2 || (out_deg != 7 && out_deg != 9))
    return (int)cudaErrorInvalidValue;
  EvalArgs args{{static_cast<const float*>(mods), static_cast<const float*>(base),
             static_cast<const float*>(sb), static_cast<float*>(out), B, S, L, 0},
            static_cast<const float*>(last_b),
            w0,
            round_mods,
            out_deg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return (int)launch_mode<64>(args, mode, morlet, swt, st);
    case 128: return (int)launch_mode<128>(args, mode, morlet, swt, st);
    case 192: return (int)launch_mode<192>(args, mode, morlet, swt, st);
    case 256: return (int)launch_mode<256>(args, mode, morlet, swt, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* siren_forward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
