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
// What bounds it: 2 * B * S * H^2 * (L-1) bf16 tensor-core operations
// (3.1e11 at B=1024, S=576, H=256, L=5) against ~8 MB of input and output,
// so the products, not memory, set the floor. The sine epilogue is about
// 15 scalar instructions per activation element and is the second cost.
//
// Design (simple and correct first; wgmma, TMA and warp specialisation are
// later work):
// - one block per (patch, 64-row tile of S); rows are independent given
//   their patch's modulation row, so no block talks to another;
// - the 64 x H activation tile stays in shared memory as bf16 for the whole
//   chain, written in place by each layer's epilogue (the accumulators are
//   in registers by then);
// - the hidden weights (H x H bf16 each, 512 KB for four at H=256, more than
//   a block's shared memory) stream through a 3-stage cp.async ring of
//   32-row K-slabs; the slab sequence runs across layer boundaries, so the
//   next layer's first slabs load under the current layer's last products;
// - products are mma.sync m16n8k16 bf16 -> f32, operands fed by ldmatrix
//   from rows padded by 16 bytes (conflict-free);
// - 8 warps as 2 (rows) x 4 (columns): a warp owns 32 rows x H/4 columns,
//   so the epilogue (bias, polynomial sine with the floor(v + 0.5) range
//   reduction, Morlet envelope, modulation, bf16 rounding) runs on the
//   accumulator registers where their layout is known;
// - the last layer reduces over H in registers, across the 4 lanes of a
//   quad with shuffles, then across the 4 column warps in shared memory.
//
// Built with nvcc into a shared library with a plain C interface; the
// Python wrapper (ops/siren_kernel.py) checks every tensor and calls
// siren_forward_launch through ctypes on PyTorch's current stream.

#include "siren_common.cuh"

namespace {

using namespace siren;

constexpr int TM = 64;        // rows of S per block
constexpr int KS = 32;        // weight rows per pipeline stage
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int PAD = 8;        // bf16 padding per shared row (16 bytes)

// Hidden-layer sine variants (the MODE template argument).
constexpr int SIN_BF16 = 0;  // degree 7, polynomial evaluated in bf16

struct Args {
  const float* mods;           // (B, L*H) f32; block L-1 is modproj
  const float* base;           // (S, H) f32
  const __nv_bfloat16* sw;     // (L-1, H, H) bf16, (in, out) per layer
  const float* sb;             // (L-1, H) f32
  const float* last_b;         // (1,) f32
  float* out;                  // (B, S) f32
  int S;
  int L;
  float w0;
  int morlet;
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

template <int MODE>
__device__ __forceinline__ float activation(float pre, float w0, int morlet) {
  float a = hidden_sin<MODE>(w0 * pre);
  if (morlet) a *= expf(-0.5f * (pre * pre));
  return a;
}

template <int H>
__host__ __device__ constexpr int row_stride() {
  return H + PAD;
}

// Bytes of dynamic shared memory for width H and depth L.
template <int H>
size_t smem_bytes(int L) {
  return sizeof(__nv_bfloat16) * (size_t)(TM + STAGES * KS) * row_stride<H>() +
         sizeof(float) * ((size_t)L * H + (size_t)(L - 1) * H + 4 * TM);
}

template <int H>
__device__ __forceinline__ void load_slab(__nv_bfloat16* stage, const __nv_bfloat16* sw,
                                          int slab, int tid) {
  constexpr int SLABS_PER_LAYER = H / KS;
  constexpr int CHUNKS_PER_ROW = H / 8;  // 16-byte chunks
  const int layer = slab / SLABS_PER_LAYER;
  const int k0 = (slab % SLABS_PER_LAYER) * KS;
  const __nv_bfloat16* src = sw + (size_t)layer * H * H + (size_t)k0 * H;
  for (int c = tid; c < KS * CHUNKS_PER_ROW; c += THREADS) {
    const int r = c / CHUNKS_PER_ROW, col = (c % CHUNKS_PER_ROW) * 8;
    cp_async16(stage + r * row_stride<H>() + col, src + (size_t)r * H + col);
  }
}

template <int H, int MODE>
__global__ void __launch_bounds__(THREADS, 2) siren_forward_kernel(Args args) {
  static_assert(H % 64 == 0 && H <= 256, "H must be a multiple of 64, at most 256");
  constexpr int LDS = row_stride<H>();
  constexpr int WN = H / 4;      // columns per warp
  constexpr int NT = WN / 8;     // n-tiles of 8 per warp
  constexpr int SLABS_PER_LAYER = H / KS;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // TM x LDS
  __nv_bfloat16* ws = xs + TM * LDS;                           // STAGES x KS x LDS
  float* mod_s = reinterpret_cast<float*>(ws + STAGES * KS * LDS);  // L x H
  float* bias_s = mod_s + args.L * H;                               // (L-1) x H
  float* red_s = bias_s + (args.L - 1) * H;                         // 4 x TM

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  const int tiles = (args.S + TM - 1) / TM;
  const int b = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * TM;
  const int L = args.L;
  const int nslab = (L - 1) * SLABS_PER_LAYER;

  // start the weight stream first: it is the longest wait
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) load_slab<H>(ws + s * KS * LDS, args.sw, s, tid);
    cp_async_commit();
  }

  const float* mrow = args.mods + (size_t)b * L * H;
  for (int i = tid; i < L * H; i += THREADS) {
    const int layer = i / H;
    float m = mrow[i];
    if (args.round_mods && layer >= 1 && layer < L - 1) m = bf16_round(m);
    mod_s[i] = m;
  }
  for (int i = tid; i < (L - 1) * H; i += THREADS) bias_s[i] = args.sb[i];
  __syncthreads();

  // x_0 = bf16(base * mod_0); rows past S are zero and never stored
  for (int i = tid; i < TM * (H / 4); i += THREADS) {
    const int r = i / (H / 4), c = (i % (H / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < args.S)
      v = *reinterpret_cast<const float4*>(args.base + (size_t)(row0 + r) * H + c);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(xs + r * LDS + c);
    dst[0] = __floats2bfloat162_rn(v.x * mod_s[c], v.y * mod_s[c + 1]);
    dst[1] = __floats2bfloat162_rn(v.z * mod_s[c + 2], v.w * mod_s[c + 3]);
  }

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int slab = 0; slab < nslab; ++slab) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab arrived for all threads; previous stage is free
    {
      const int next = slab + STAGES - 1;
      if (next < nslab) load_slab<H>(ws + (next % STAGES) * KS * LDS, args.sw, next, tid);
      cp_async_commit();
    }

    const __nv_bfloat16* wst = ws + (slab % STAGES) * KS * LDS;
    const int kbase = (slab % SLABS_PER_LAYER) * KS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp_m * 32 + mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], xs + r * LDS + kbase + kk + 8 * (lane >> 4));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        const int n0 = warp_n * WN + np * 16;
        ldmatrix_x4_trans(bfr, wst + (kk + (lane & 15)) * LDS + n0 + 8 * (lane >> 4));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], bfr[2], bfr[3]);
        }
      }
    }

    if ((slab + 1) % SLABS_PER_LAYER != 0) continue;

    // ---- epilogue of hidden layer `layer` ----
    const int layer = slab / SLABS_PER_LAYER;
    const float* bias = bias_s + layer * H;
    __syncthreads();  // every warp has finished reading xs for this layer

    if (layer < L - 2) {
      const float* mod = mod_s + (layer + 1) * H;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = warp_n * WN + nt * 8 + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp_m * 32 + mt * 16 + g + 8 * half;
            float& v0 = acc[mt][nt][2 * half];
            float& v1 = acc[mt][nt][2 * half + 1];
            const float x0 = activation<MODE>(v0 + bias[c], args.w0, args.morlet) * mod[c];
            const float x1 = activation<MODE>(v1 + bias[c + 1], args.w0, args.morlet) * mod[c + 1];
            *reinterpret_cast<__nv_bfloat162*>(xs + r * LDS + c) =
                __floats2bfloat162_rn(x0, x1);
            v0 = 0.f;
            v1 = 0.f;
          }
        }
      }
      continue;  // the next iteration's barrier publishes xs
    }

    // ---- last hidden layer: projection reduction + output sine ----
    const float* modproj = mod_s + (L - 1) * H;
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = warp_n * WN + nt * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
          part[mt][half] +=
              activation<MODE>(v0 + bias[c], args.w0, args.morlet) * modproj[c] +
              activation<MODE>(v1 + bias[c + 1], args.w0, args.morlet) * modproj[c + 1];
        }
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float p = part[mt][half];
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        if (t == 0) red_s[warp_n * TM + warp_m * 32 + mt * 16 + g + 8 * half] = p;
      }
    __syncthreads();
    if (tid < TM && row0 + tid < args.S) {
      const float r = red_s[tid] + red_s[TM + tid] + red_s[2 * TM + tid] +
                      red_s[3 * TM + tid] + args.last_b[0];
      const float z = args.w0 * r;
      args.out[(size_t)b * args.S + row0 + tid] = args.out_deg == 9 ? sin9(z) : sin7(z);
    }
  }
}

template <int H, int MODE>
cudaError_t launch(const Args& args, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<H>(args.L);
  cudaError_t err = cudaFuncSetAttribute(siren_forward_kernel<H, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((args.S + TM - 1) / TM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  siren_forward_kernel<H, MODE><<<(unsigned)blocks, THREADS, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_mode(const Args& args, int B, int mode, cudaStream_t stream) {
  switch (mode) {
    case 5: return launch<H, 5>(args, B, stream);
    case 7: return launch<H, 7>(args, B, stream);
    case 9: return launch<H, 9>(args, B, stream);
    case SIN_BF16: return launch<H, SIN_BF16>(args, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). Pointers are device pointers to
// contiguous tensors; mode is 5, 7 or 9 (hidden sine degree) or 0 (degree
// 7 in bf16); out_deg is 7 or 9.
extern "C" int siren_forward_launch(const void* mods, const void* base, const void* sw,
                                    const void* sb, const void* last_b, void* out, int B,
                                    int S, int H, int L, float w0, int morlet, int mode,
                                    int round_mods, int out_deg, void* stream) {
  if (B <= 0 || S <= 0 || L < 2 || (out_deg != 7 && out_deg != 9))
    return (int)cudaErrorInvalidValue;
  Args args{static_cast<const float*>(mods),
            static_cast<const float*>(base),
            static_cast<const __nv_bfloat16*>(sw),
            static_cast<const float*>(sb),
            static_cast<const float*>(last_b),
            static_cast<float*>(out),
            S,
            L,
            w0,
            morlet,
            round_mods,
            out_deg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return (int)launch_mode<64>(args, B, mode, st);
    case 128: return (int)launch_mode<128>(args, B, mode, st);
    case 192: return (int)launch_mode<192>(args, B, mode, st);
    case 256: return (int)launch_mode<256>(args, B, mode, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* siren_forward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
