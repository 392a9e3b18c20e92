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
// TPU kernel does.
//
// What bounds it: 2 * B * S * H^2 * (L-1) bf16 tensor-core operations
// (1.2e11 at B=400, S=576, H=256, L=5) against a few MB of input and output.
//
// Design: the eval kernel's (siren_forward.cu). One block per (patch, 64-row
// tile of S); the activation tile lives in shared memory as bf16 and is
// overwritten in place by each layer's epilogue; the hidden weights stream
// through a 3-stage cp.async ring of 32-row K-slabs that runs across layer
// boundaries; mma.sync m16n8k16 with ldmatrix operands; 8 warps as 2 (rows)
// x 4 (columns) so the epilogue knows each accumulator's (row, column) and
// can hash its dropout bit from the global element index
// (b * S + s) * H + column.

#include "siren_common.cuh"

namespace {

using namespace siren;

constexpr int TM = 64;        // rows of S per block
constexpr int KS = 32;        // weight rows per pipeline stage
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int PAD = 8;        // bf16 padding per shared row (16 bytes)

struct Args {
  const float* seed;           // (1,) f32 holding an integer
  const float* mods;           // (B, L*H) f32
  const float* base;           // (S, H) f32
  const __nv_bfloat16* sw;     // (L-1, H, H) bf16, (in, out) per layer
  const float* sb;             // (L-1, H) f32
  const float* last_w;         // (H,) f32
  const float* last_b;         // (1,) f32
  float* out;                  // (B, S) f32
  int S;
  int L;
  float w0;
  int morlet;
  int32_t thresh;   // keep where (int32)hash < thresh
  float inv_keep;   // 1 / keep
  int dropout;      // 0: rate 0, no mask
};

template <int DEG>
__device__ __forceinline__ float activation(float pre, float w0, int morlet) {
  float a = poly_sin<DEG>(w0 * pre);
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
         sizeof(float) * ((size_t)L * H + (size_t)(L - 1) * H + H + 4 * TM);
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

template <int H, int DEG>
__global__ void __launch_bounds__(THREADS, 2) siren_train_fwd_kernel(Args args) {
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
  float* lw_s = bias_s + (args.L - 1) * H;                          // H
  float* red_s = lw_s + H;                                          // 4 x TM

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

  const Dropout dp{(uint32_t)(int)args.seed[0], args.thresh, args.inv_keep, args.dropout};
  // global element index of (row r of this tile, column 0), 32-bit wraparound
  const uint32_t idx0 = ((uint32_t)b * (uint32_t)args.S + (uint32_t)row0) * (uint32_t)H;

  const float* mrow = args.mods + (size_t)b * L * H;
  for (int i = tid; i < L * H; i += THREADS) mod_s[i] = mrow[i];
  for (int i = tid; i < (L - 1) * H; i += THREADS) bias_s[i] = args.sb[i];
  for (int i = tid; i < H; i += THREADS) lw_s[i] = args.last_w[i];
  __syncthreads();

  // x_0 = bf16(drop_0(base) * mod_0); rows past S are zero and never stored
  {
    const uint32_t off = layer_offset(dp, 0);
    for (int i = tid; i < TM * (H / 4); i += THREADS) {
      const int r = i / (H / 4), c = (i % (H / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < args.S)
        v = *reinterpret_cast<const float4*>(args.base + (size_t)(row0 + r) * H + c);
      const uint32_t e = idx0 + (uint32_t)(r * H + c);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(xs + r * LDS + c);
      dst[0] = __floats2bfloat162_rn(__fmul_rn(drop(dp, v.x, e, off), mod_s[c]),
                                     __fmul_rn(drop(dp, v.y, e + 1, off), mod_s[c + 1]));
      dst[1] = __floats2bfloat162_rn(__fmul_rn(drop(dp, v.z, e + 2, off), mod_s[c + 2]),
                                     __fmul_rn(drop(dp, v.w, e + 3, off), mod_s[c + 3]));
    }
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

    // ---- epilogue of hidden product `layer`: x_{layer+1} ----
    const int layer = slab / SLABS_PER_LAYER;
    const float* bias = bias_s + layer * H;
    const float* mod = mod_s + (layer + 1) * H;
    const uint32_t off = layer_offset(dp, layer + 1);
    const bool last = layer == L - 2;
    __syncthreads();  // every warp has finished reading xs for this layer

    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = warp_n * WN + nt * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp_m * 32 + mt * 16 + g + 8 * half;
          const uint32_t e = idx0 + (uint32_t)(r * H + c);
          float& v0 = acc[mt][nt][2 * half];
          float& v1 = acc[mt][nt][2 * half + 1];
          const float a0 = activation<DEG>(v0 + bias[c], args.w0, args.morlet);
          const float a1 = activation<DEG>(v1 + bias[c + 1], args.w0, args.morlet);
          const __nv_bfloat162 x = __floats2bfloat162_rn(
              __fmul_rn(drop(dp, a0, e, off), mod[c]),
              __fmul_rn(drop(dp, a1, e + 1, off), mod[c + 1]));
          if (last) {
            part[mt][half] += __low2float(x) * lw_s[c] + __high2float(x) * lw_s[c + 1];
          } else {
            *reinterpret_cast<__nv_bfloat162*>(xs + r * LDS + c) = x;
          }
          v0 = 0.f;
          v1 = 0.f;
        }
      }
    }
    if (!last) continue;  // the next iteration's barrier publishes xs

    // ---- projection: reduce over H, then the output sine ----
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
      args.out[(size_t)b * args.S + row0 + tid] = poly_sin<DEG>(args.w0 * r);
    }
  }
}

template <int H, int DEG>
cudaError_t launch(const Args& args, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<H>(args.L);
  cudaError_t err = cudaFuncSetAttribute(siren_train_fwd_kernel<H, DEG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((args.S + TM - 1) / TM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  siren_train_fwd_kernel<H, DEG><<<(unsigned)blocks, THREADS, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_deg(const Args& args, int B, int deg, cudaStream_t stream) {
  switch (deg) {
    case 5: return launch<H, 5>(args, B, stream);
    case 9: return launch<H, 9>(args, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). Pointers are device pointers to
// contiguous tensors; deg is 5 or 9 (sine degree, hidden and output);
// dropout is 0 (no mask) or 1 (keep where hash < thresh, scale by inv_keep).
extern "C" int siren_train_fwd_launch(const void* seed, const void* mods, const void* base,
                                      const void* sw, const void* sb, const void* last_w,
                                      const void* last_b, void* out, int B, int S, int H,
                                      int L, float w0, int morlet, int deg, int dropout,
                                      int thresh, float inv_keep, void* stream) {
  if (B <= 0 || S <= 0 || L < 2) return (int)cudaErrorInvalidValue;
  Args args{static_cast<const float*>(seed),
            static_cast<const float*>(mods),
            static_cast<const float*>(base),
            static_cast<const __nv_bfloat16*>(sw),
            static_cast<const float*>(sb),
            static_cast<const float*>(last_w),
            static_cast<const float*>(last_b),
            static_cast<float*>(out),
            S,
            L,
            w0,
            morlet,
            (int32_t)thresh,
            inv_keep,
            dropout};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return (int)launch_deg<64>(args, B, deg, st);
    case 128: return (int)launch_deg<128>(args, B, deg, st);
    case 192: return (int)launch_deg<192>(args, B, deg, st);
    case 256: return (int)launch_deg<256>(args, B, deg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* siren_train_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
