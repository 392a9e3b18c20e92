// Fused modulated-SIREN forward with int8 products, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mri_inr_tpu/ops/siren_kernel.py:_kernel_int8
// (launched by fused_siren_forward_int8). Per patch b and coordinate row s:
//
//   xq_0  = int8(floor(base[s] * fq_0[b] + 0.5))
//   acc_i = xq_i @ Wq_i                           (int8 x int8 -> int32, exact)
//   pre_i = float(acc_i) * gd_i[b] + b_i          (a product, then a sum)
//   s_i   = sin9(w0 * pre_i) [* exp(-pre_i^2 / 2) for Morlet]
//   xq_i+1 = int8(floor(s_i * fq_{i+1}[b] + 0.5)) i = 0 .. L-3
//   r     = sum_h s_{L-2}[h] * fq_{L-1}[b, h] * last_w[h]
//   out   = sin9(w0 * (r * ls[b] + last_b))
//
// fq, gd and ls carry the per-patch dynamic activation scales and the
// per-output-channel weight scales (compute_quant_factors in the wrapper's
// module), so quantisation and dequantisation are one multiply each. The
// sines are always the degree-9 polynomial.
//
// What bounds it: 2 * B * S * H^2 * (L-1) int8 tensor-core operations
// (3.1e11 at B=1024, S=576, H=256, L=5) against ~13 MB of input and output:
// the products. The epilogue (dequantise, sine, quantise: about 25 scalar
// instructions per activation element) is the larger cost in practice.
//
// Design: siren_forward.cu's tiling with the operand types changed.
// - one block per (patch, 64-row tile of S); the 64 x H activation tile
//   lives in shared memory as int8 for the whole chain;
// - the weights arrive as (layer, out, in), K-contiguous (the wrapper
//   transposes the (in, out) int8 array once): ldmatrix.trans moves 16-bit
//   elements only, so an (in, out) int8 tile cannot be transposed on its way
//   into registers, while an (out, in) tile is already the col-major B
//   operand and loads with plain ldmatrix;
// - they stream through a 3-stage cp.async ring of slabs of 64 K-bytes for
//   all H outputs (16 KB a stage at H=256), running across layer boundaries;
// - products are mma.sync m16n8k32 s8 x s8 -> s32; rows are padded by 16
//   bytes so every ldmatrix is free of bank conflicts;
// - 8 warps as 2 (rows) x 4 (columns), epilogue on the accumulator
//   registers; floor(s * fq + 0.5) and acc * gd + b are written with
//   __fmul_rn / __fadd_rn so that no fused multiply-add rounds a tie the
//   other way than the plain version;
// - the last layer reduces over H in registers, quads, then shared memory.

#include "siren_common.cuh"

namespace {

using namespace siren;

constexpr int TM = 64;        // rows of S per block
constexpr int KS = 64;        // K bytes of every weight row per pipeline stage
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int PAD = 16;       // byte padding per shared row

struct Args {
  const float* fq;         // (B, L*H) f32 quantisation factors
  const float* gd;         // (B, (L-1)*H) f32 dequantisation factors
  const float* ls;         // (B, ls_stride) f32, column 0 read
  const float* base;       // (S, H) f32
  const int8_t* swq;       // (L-1, H, H) int8, (out, in) per layer
  const float* sb;         // (L-1, H) f32
  const float* last_w;     // (H,) f32
  const float* last_b;     // (1,) f32
  float* out;              // (B, S) f32
  int S;
  int L;
  int ls_stride;
  float w0;
  int morlet;
};

__device__ __forceinline__ float activation(float pre, float w0, int morlet) {
  float a = sin9(w0 * pre);
  if (morlet) a *= expf(-0.5f * (pre * pre));
  return a;
}

__device__ __forceinline__ float dequant(int acc, float gd, float bias) {
  return __fadd_rn(__fmul_rn((float)acc, gd), bias);
}

__device__ __forceinline__ signed char quant(float s, float fq) {
  return (signed char)(int)floorf(__fadd_rn(__fmul_rn(s, fq), 0.5f));
}

template <int H>
size_t smem_bytes(int L) {
  return (size_t)TM * (H + PAD) + (size_t)STAGES * H * (KS + PAD) +
         sizeof(float) * ((size_t)L * H + 2 * (size_t)(L - 1) * H + H + 4 * TM);
}

// Slab `slab` = K bytes [k0, k0 + KS) of all H output rows of one layer.
template <int H>
__device__ __forceinline__ void load_slab(int8_t* stage, const int8_t* swq, int slab, int tid) {
  constexpr int SLABS_PER_LAYER = H / KS;
  constexpr int CHUNKS_PER_ROW = KS / 16;
  const int layer = slab / SLABS_PER_LAYER;
  const int k0 = (slab % SLABS_PER_LAYER) * KS;
  const int8_t* src = swq + (size_t)layer * H * H + k0;
  for (int c = tid; c < H * CHUNKS_PER_ROW; c += THREADS) {
    const int n = c / CHUNKS_PER_ROW, kb = (c % CHUNKS_PER_ROW) * 16;
    cp_async16(stage + n * (KS + PAD) + kb, src + (size_t)n * H + kb);
  }
}

template <int H>
__global__ void __launch_bounds__(THREADS, 2) siren_forward_int8_kernel(Args args) {
  static_assert(H % 64 == 0 && H <= 256, "H must be a multiple of 64, at most 256");
  constexpr int LDX = H + PAD;   // bytes per activation row
  constexpr int LDW = KS + PAD;  // bytes per weight row in a stage
  constexpr int WN = H / 4;      // columns per warp
  constexpr int NT = WN / 8;     // n-tiles of 8 per warp
  constexpr int SLABS_PER_LAYER = H / KS;

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);                      // TM x LDX
  int8_t* ws = xs + TM * LDX;                                        // STAGES x H x LDW
  float* fq_s = reinterpret_cast<float*>(ws + STAGES * H * LDW);     // L x H
  float* gd_s = fq_s + args.L * H;                                   // (L-1) x H
  float* bias_s = gd_s + (args.L - 1) * H;                           // (L-1) x H
  float* lw_s = bias_s + (args.L - 1) * H;                           // H
  float* red_s = lw_s + H;                                           // 4 x TM

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
    if (s < nslab) load_slab<H>(ws + s * H * LDW, args.swq, s, tid);
    cp_async_commit();
  }

  const float* fq_row = args.fq + (size_t)b * L * H;
  const float* gd_row = args.gd + (size_t)b * (L - 1) * H;
  for (int i = tid; i < L * H; i += THREADS) fq_s[i] = fq_row[i];
  for (int i = tid; i < (L - 1) * H; i += THREADS) {
    gd_s[i] = gd_row[i];
    bias_s[i] = args.sb[i];
  }
  for (int i = tid; i < H; i += THREADS) lw_s[i] = args.last_w[i];
  __syncthreads();

  // xq_0 = int8(floor(base * fq_0 + 0.5)); rows past S are zero and never stored
  for (int i = tid; i < TM * (H / 4); i += THREADS) {
    const int r = i / (H / 4), c = (i % (H / 4)) * 4;
    char4 q = make_char4(0, 0, 0, 0);
    if (row0 + r < args.S) {
      const float4 v = *reinterpret_cast<const float4*>(args.base + (size_t)(row0 + r) * H + c);
      q = make_char4(quant(v.x, fq_s[c]), quant(v.y, fq_s[c + 1]), quant(v.z, fq_s[c + 2]),
                     quant(v.w, fq_s[c + 3]));
    }
    *reinterpret_cast<char4*>(xs + r * LDX + c) = q;
  }

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  for (int slab = 0; slab < nslab; ++slab) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab arrived for all threads; previous stage is free
    {
      const int next = slab + STAGES - 1;
      if (next < nslab) load_slab<H>(ws + (next % STAGES) * H * LDW, args.swq, next, tid);
      cp_async_commit();
    }

    const int8_t* wst = ws + (slab % STAGES) * H * LDW;
    const int kbase = (slab % SLABS_PER_LAYER) * KS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 32) {
      // A: 16 rows x 32 K bytes = four 8 x 16-byte matrices
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp_m * 32 + mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], xs + r * LDX + kbase + kk + 16 * (lane >> 4));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // B: two n-tiles of 8 outputs x 32 K bytes, (out, in) rows as stored
        uint32_t bfr[4];
        const int n = warp_n * WN + np * 16 + (lane & 7) + 8 * (lane >> 4);
        ldmatrix_x4(bfr, wst + n * LDW + kk + 16 * ((lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(acc[mt][2 * np], a[mt], bfr[0], bfr[1]);
          mma_s8(acc[mt][2 * np + 1], a[mt], bfr[2], bfr[3]);
        }
      }
    }

    if ((slab + 1) % SLABS_PER_LAYER != 0) continue;

    // ---- epilogue of hidden layer `layer` ----
    const int layer = slab / SLABS_PER_LAYER;
    const float* bias = bias_s + layer * H;
    const float* gd = gd_s + layer * H;
    const float* fq = fq_s + (layer + 1) * H;
    __syncthreads();  // every warp has finished reading xs for this layer

    if (layer < L - 2) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = warp_n * WN + nt * 8 + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp_m * 32 + mt * 16 + g + 8 * half;
            int& v0 = acc[mt][nt][2 * half];
            int& v1 = acc[mt][nt][2 * half + 1];
            const float s0 = activation(dequant(v0, gd[c], bias[c]), args.w0, args.morlet);
            const float s1 =
                activation(dequant(v1, gd[c + 1], bias[c + 1]), args.w0, args.morlet);
            *reinterpret_cast<char2*>(xs + r * LDX + c) =
                make_char2(quant(s0, fq[c]), quant(s1, fq[c + 1]));
            v0 = 0;
            v1 = 0;
          }
        }
      }
      continue;  // the next iteration's barrier publishes xs
    }

    // ---- last hidden layer: projection reduction + output sine ----
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = warp_n * WN + nt * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float s0 = activation(dequant(acc[mt][nt][2 * half], gd[c], bias[c]), args.w0,
                                      args.morlet);
          const float s1 = activation(dequant(acc[mt][nt][2 * half + 1], gd[c + 1], bias[c + 1]),
                                      args.w0, args.morlet);
          part[mt][half] += __fmul_rn(s0, fq[c]) * lw_s[c] + __fmul_rn(s1, fq[c + 1]) * lw_s[c + 1];
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
      const float r = red_s[tid] + red_s[TM + tid] + red_s[2 * TM + tid] + red_s[3 * TM + tid];
      const float pre = __fadd_rn(__fmul_rn(r, args.ls[(size_t)b * args.ls_stride]),
                                  args.last_b[0]);
      args.out[(size_t)b * args.S + row0 + tid] = sin9(args.w0 * pre);
    }
  }
}

template <int H>
cudaError_t launch(const Args& args, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<H>(args.L);
  cudaError_t err = cudaFuncSetAttribute(siren_forward_int8_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((args.S + TM - 1) / TM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  siren_forward_int8_kernel<H><<<(unsigned)blocks, THREADS, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched). Pointers are device pointers to
// contiguous tensors; swq is (L-1, out, in) int8; ls is (B, ls_stride) and
// its first column is read.
extern "C" int siren_forward_int8_launch(const void* fq, const void* gd, const void* ls,
                                         const void* base, const void* swq, const void* sb,
                                         const void* last_w, const void* last_b, void* out,
                                         int B, int S, int H, int L, int ls_stride, float w0,
                                         int morlet, void* stream) {
  if (B <= 0 || S <= 0 || L < 2 || ls_stride < 1) return (int)cudaErrorInvalidValue;
  Args args{static_cast<const float*>(fq),
            static_cast<const float*>(gd),
            static_cast<const float*>(ls),
            static_cast<const float*>(base),
            static_cast<const int8_t*>(swq),
            static_cast<const float*>(sb),
            static_cast<const float*>(last_w),
            static_cast<const float*>(last_b),
            static_cast<float*>(out),
            S,
            L,
            ls_stride,
            w0,
            morlet};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return (int)launch<64>(args, B, st);
    case 128: return (int)launch<128>(args, B, st);
    case 192: return (int)launch<192>(args, B, st);
    case 256: return (int)launch<256>(args, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* siren_forward_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
