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
// What bounds it on an H100, at the quantised eval shape (B=1024, S=576,
// H=256, L=5):
// - the products: 2 * B * S * H^2 * (L-1) = 3.1e11 int8 tensor-core
//   operations, 0.16 ms at 1,979 TOP/s; its own input and output are ~13 MB;
// - the epilogue's scalar work: B * S * H * (L-1) = 6.0e8 activations of
//   about 20 f32 instructions each (dequantise, w0, the degree-9 sine with
//   its range reduction, quantise): ~0.36 ms on the FMA pipe, above the
//   products' bound, so the epilogue sets the pace and must run under the
//   products.
//
// Design (siren_fwd.cuh's persistent warp-specialised block, with int8
// operands; this file keeps its own copy of the block because the operand
// type changes the slabs, the fragments and every epilogue):
// - one persistent block per SM, 384 threads: a producer warpgroup
//   (setmaxnreg 40) whose first thread streams the hidden weights through a
//   ring of slabs paced by full / empty mbarriers, across layers and tiles.
//   A slab is one TMA box of 128 contraction bytes of all H output rows
//   (H x 128 bytes, the 128-byte swizzle: 32 KB at H=256), ceil(H / 128)
//   a layer; at H = 64 and 192 the box's columns past H load as zeros and
//   no product reads them;
// - two consumer warpgroups (setmaxnreg 232), each owning a 64-row tile of
//   one patch (an odd last tile leaves consumer 1 a tile of zeros, computed
//   and never stored); they take turns at the tensor cores through named
//   barriers, so one's epilogue runs under the other's products;
// - products: wgmma m64nHk32 .s32.s8.s8, H / 32 a layer, issued back to
//   back once the layer's slabs have all arrived (a slab wait between them
//   made ptxas serialise the bf16 kernels' wgmma);
// - the activations stay in registers as the next product's A fragments
//   (RS form). A thread's accumulators hold columns {8j + 2t, 8j + 2t + 1}
//   of its rows, while the int8 A fragment of a k32 step wants contraction
//   bytes {4t..4t+3, 16+4t..16+4t+3}. So the wrapper permutes the
//   contraction index of the hidden weights W_1..W_{L-2} once
//   (siren_kernel.int8_kernel_weights: byte 16u + 4t + q of each 32-block
//   holds column 16u + 2t + (q & 1) + 8 (q >> 1)), and a thread packs its own
//   four quantised values of columns c, c+1, c+8, c+9 into one register:
//   no shuffle, no shared memory. Layer 0's input x_0 is built from `base`
//   in the natural order, so W_0 keeps it;
// - the epilogue rounds as the plain version does: __fmul_rn / __fadd_rn
//   for the dequantise and quantise steps, sin9 with its exact range
//   reduction, expf for Morlet. Its two conversions run on the FMA pipe
//   (128 results a cycle an SM), not the conversion unit (16), and give
//   the same bits:
//   float(acc) = (bits(1.5 * 2^23) + acc as a float) - 1.5 * 2^23 for
//   |acc| < 2^22 (|acc| <= H * 127^2), and floor(v) as an int8 is the low
//   byte of (1.5 * 2^23 + v) rounded down, for |v| < 2^22;
// - the last layer sums s * fq * last_w over H in registers and across the
//   quad of lanes that share a row: no shared memory, no block barrier.
//
// What it reads (PERF.md, one H100 at 700 W; chip_smoke.py and
// scripts/torch_fwd_cut_probe.py): about 0.8 ms a call at B=1024, 25% of
// the bound. A consumer's hidden-layer epilogue takes about 5,700 SM cycles
// against about 2,100 for issuing and completing its products, and a tile
// starts with about 4,700 cycles of factors and x_0: the epilogues, with
// both consumers' warps issuing on the same sub-partitions, set the pace.
//
// Built with nvcc into a shared library with a plain C interface; the
// Python wrapper (ops/siren_kernel.py) checks every tensor and calls
// siren_forward_int8_launch through ctypes on PyTorch's current stream.

#include "siren_fwd.cuh"

namespace {

using namespace siren;
using namespace hopper;
using siren_fwd::CONSUMER_BAR;
using siren_fwd::CONSUMER_REGS;
using siren_fwd::ORDER_BAR;
using siren_fwd::PRODUCER_REGS;
using siren_fwd::THREADS;
using siren_fwd::TM;
#ifdef SIREN_FWD_TRACE
using siren_fwd::g_trace;
using siren_fwd::TRACE_BLOCKS;
using siren_fwd::TRACE_MARKS;
#endif

constexpr int SLAB_K = 128;            // contraction bytes of a slab (a swizzled row)
constexpr int MAGIC_I = 0x4B400000;    // the bits of 1.5 * 2^23
constexpr float MAGIC_F = 12582912.f;  // 1.5 * 2^23

struct Args {
  const float* fq;      // (B, L*H) f32 quantisation factors
  const float* gd;      // (B, (L-1)*H) f32 dequantisation factors
  const float* ls;      // (B, ls_stride) f32, column 0 read
  const float* base;    // (S, H) f32
  const float* sb;      // (L-1, H) f32
  const float* last_w;  // (H,) f32
  const float* last_b;  // (1,) f32
  float* out;           // (B, S) f32
  int B, S, L, ls_stride;
  float w0;
  int stages;           // weight ring depth, set by launch()
};

template <int H>
struct Geometry {
  static_assert(H % 64 == 0 && H <= 256, "H must be a multiple of 64, at most 256");
  static_assert(H * 127 * 127 < (1 << 22), "|acc| < 2^22 for the exact conversion");
  static constexpr int KB = (H + SLAB_K - 1) / SLAB_K;  // slabs a layer
  static constexpr int STAGE = H * SLAB_K;              // one slab: H rows x 128 bytes
  static constexpr int KK = H / 32;                     // k32 products a layer
  static constexpr int NA = H / 2;                      // s32 accumulators a thread
  static constexpr int NX = H / 8;                      // A registers (4 int8 each) a thread
  // the ring, each consumer's fq (L x H) and gd ((L-1) x H), the biases,
  // last_w and the mbarriers
  static size_t smem_bytes(int L, int stages) {
    return 1024 + (size_t)stages * STAGE +
           sizeof(float) * ((size_t)2 * (2 * L - 1) * H + (size_t)L * H) +
           sizeof(uint64_t) * 2 * stages;
  }
};

template <bool MORLET>
__device__ __forceinline__ float activation(float pre, float w0) {
  float a = sin9(w0 * pre);
  if (MORLET) a *= expf(-0.5f * (pre * pre));
  return a;
}

__device__ __forceinline__ float dequant(int acc, float gd, float bias) {
  const float a = __fsub_rn(__int_as_float(acc + MAGIC_I), MAGIC_F);  // float(acc), exact
  return __fadd_rn(__fmul_rn(a, gd), bias);
}

// int8(floor(s * fq + 0.5)) in the low byte of the result
__device__ __forceinline__ uint32_t quant(float s, float fq) {
  return __float_as_uint(__fadd_rd(__fadd_rn(__fmul_rn(s, fq), 0.5f), MAGIC_F));
}

// four quantised values' low bytes -> one A-fragment register, q0 lowest
__device__ __forceinline__ uint32_t pack4(uint32_t q0, uint32_t q1, uint32_t q2, uint32_t q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040), 0x5410);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <int H, bool MORLET>
__global__ void __launch_bounds__(THREADS, 1)
    siren_forward_int8_kernel(const __grid_constant__ CUtensorMap wq_map, const Args args) {
  using G = Geometry<H>;
  constexpr int KB = G::KB, KK = G::KK, NA = G::NA, NX = G::NX;
  const int L = args.L, S = args.S, nst = args.stages;
  const int tpp = (S + TM - 1) / TM;
  const int ntiles = args.B * tpp, npairs = (ntiles + 1) / 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = siren_fwd::align1024(smem_raw);
  float* fq_s = reinterpret_cast<float*>(ring + nst * G::STAGE);  // 2 x L x H
  float* gd_s = fq_s + 2 * L * H;                                  // 2 x (L-1) x H
  float* bias_s = gd_s + 2 * (L - 1) * H;                          // (L-1) x H
  float* lw_s = bias_s + (L - 1) * H;                              // H
  uint64_t* full = reinterpret_cast<uint64_t*>(lw_s + H);
  uint64_t* empty = full + nst;

  const int tid = threadIdx.x;
  for (int i = tid; i < (L - 1) * H; i += THREADS) bias_s[i] = args.sb[i];
  for (int i = tid; i < H; i += THREADS) lw_s[i] = args.last_w[i];
  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != 0) return;
    int n = 0;
    for (int p = blockIdx.x; p < npairs; p += gridDim.x)
      for (int layer = 0; layer < L - 1; ++layer)
        for (int kq = 0; kq < KB; ++kq, ++n) {
          const int st = n % nst, use = n / nst;
          if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
          mbar_expect_tx(&full[st], G::STAGE);
          tma_load_2d(ring + st * G::STAGE, &wq_map, SLAB_K * kq, layer * H, &full[st]);
        }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  const int ci = (tid >> 7) - 1;  // consumer 0 or 1
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rbase = warp * 16 + g;  // this thread's rows: rbase, rbase + 8
  float* my_fq = fq_s + ci * L * H;
  float* my_gd = gd_s + ci * (L - 1) * H;
  const float w0 = args.w0, last_b = args.last_b[0];
#ifdef SIREN_FWD_TRACE
  int mark = 0;
#endif

  int acc[NA];       // acc[4j + 2h + e]: row rbase + 8h, column 8j + 2t4 + e
  uint32_t xa[NX];   // xa[4kk + h + 2u]: row rbase + 8h, bytes 32kk + 16u + 4t4 ..+3
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0;
  if (ci == 1) bar_arrive(ORDER_BAR, 256);  // consumer 0 goes first
  int n = 0;                                // slabs consumed

  for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
    FWD_MARK(mark);
    const int tile = 2 * p + ci;
    const bool valid = tile < ntiles;
    const int b = valid ? tile / tpp : 0;
    const int row0 = valid ? (tile % tpp) * TM : 0;
    const int rows = valid ? min(TM, S - row0) : 0;  // rows of the tile below S

    // the patch's factors, all copies in flight at once (cp.async)
    bar_sync(CONSUMER_BAR + ci, 128);  // the last tile's epilogue has read my factors
    if (valid) {
      const float* fr = args.fq + (size_t)b * L * H;
      const float* gr = args.gd + (size_t)b * (L - 1) * H;
      for (int i = 4 * wtid; i < L * H; i += 4 * 128) cp_async16(my_fq + i, fr + i);
      for (int i = 4 * wtid; i < (L - 1) * H; i += 4 * 128) cp_async16(my_gd + i, gr + i);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = 4 * wtid; i < L * H; i += 4 * 128) *reinterpret_cast<float4*>(my_fq + i) = zero;
      for (int i = 4 * wtid; i < (L - 1) * H; i += 4 * 128)
        *reinterpret_cast<float4*>(my_gd + i) = zero;
    }
    bar_sync(CONSUMER_BAR + ci, 128);

    // xq_0 in the natural contraction order; rows past S are zero
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = 32 * kk + 16 * u + 4 * t4;
        const float4 f = *reinterpret_cast<const float4*>(my_fq + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + 8 * h;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < rows)
            v = *reinterpret_cast<const float4*>(args.base + (size_t)(row0 + r) * H + col);
          xa[4 * kk + h + 2 * u] =
              pack4(quant(v.x, f.x), quant(v.y, f.y), quant(v.z, f.z), quant(v.w, f.w));
        }
      }
    FWD_MARK(mark);

    for (int layer = 0; layer < L - 1; ++layer) {
      // ---- the products, on this consumer's turn, once the layer's slabs
      // have all arrived
      FWD_MARK(mark);
      bar_sync(ORDER_BAR + ci, 256);
      FWD_MARK(mark);
#pragma unroll
      for (int s = 0; s < KB; ++s) mbar_wait(&full[(n + s) % nst], ((n + s) / nst) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const uint32_t b0 = smem_u32(ring + ((n + kk / 4) % nst) * G::STAGE);
        wgmma_rs_s8<H>(acc, xa[4 * kk], xa[4 * kk + 1], xa[4 * kk + 2], xa[4 * kk + 3],
                       desc(b0 + (kk % 4) * 32, 16, 1024), kk > 0);
      }
      wgmma_commit();
      // hand the turn over; consumer 1's last product of the block has no
      // successor, so the arrivals match the waits
      if (!(ci == 1 && layer == L - 2 && p + (int)gridDim.x >= npairs))
        bar_arrive(ORDER_BAR + (1 - ci), 256);
      FWD_MARK(mark);
      wgmma_wait<0>();
      if (wtid == 0)
        for (int s = 0; s < KB; ++s) mbar_arrive(&empty[(n + s) % nst]);
      n += KB;
      FWD_MARK(mark);

      // ---- the epilogue, while the other consumer's products run
      const float* bias = bias_s + layer * H;
      const float* gd = my_gd + layer * H;
      if (layer < L - 2) {
        const float* fq = my_fq + (layer + 1) * H;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            // n-blocks j and j + 1: columns c, c + 1, c + 8, c + 9 -> bytes
            // 4t4 .. 4t4 + 3 of the permuted 16-byte half u of block kk
            const int j = 4 * kk + 2 * u, c = 8 * j + 2 * t4;
            const float2 g0 = ld2(gd + c), g1 = ld2(gd + c + 8);
            const float2 b0 = ld2(bias + c), b1 = ld2(bias + c + 8);
            const float2 f0 = ld2(fq + c), f1 = ld2(fq + c + 8);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h;
              xa[4 * kk + h + 2 * u] = pack4(
                  quant(activation<MORLET>(dequant(acc[i], g0.x, b0.x), w0), f0.x),
                  quant(activation<MORLET>(dequant(acc[i + 1], g0.y, b0.y), w0), f0.y),
                  quant(activation<MORLET>(dequant(acc[i + 4], g1.x, b1.x), w0), f1.x),
                  quant(activation<MORLET>(dequant(acc[i + 5], g1.y, b1.y), w0), f1.y));
            }
          }
      } else {
        // last layer: each row's sum over H lies in one quad of lanes
        const float* fq = my_fq + (L - 1) * H;
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          const int c = 8 * j + 2 * t4;
          const float2 gg = ld2(gd + c), bb = ld2(bias + c), ff = ld2(fq + c), ww = ld2(lw_s + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float s0 = activation<MORLET>(dequant(acc[4 * j + 2 * h], gg.x, bb.x), w0);
            const float s1 = activation<MORLET>(dequant(acc[4 * j + 2 * h + 1], gg.y, bb.y), w0);
            part[h] += __fmul_rn(s0, ff.x) * ww.x + __fmul_rn(s1, ff.y) * ww.y;
          }
        }
        const float ls = args.ls[(size_t)b * args.ls_stride];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = part[h];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          const int r = rbase + 8 * h;
          if (t4 == 0 && r < rows)
            args.out[(size_t)b * S + row0 + r] = sin9(w0 * __fadd_rn(__fmul_rn(v, ls), last_b));
        }
      }
      FWD_MARK(mark);
    }
  }
}

// Launch on `stream` over the kernel's weight pack (`swq_k`, (L-1, H, H)
// int8, (out, in) per layer, contraction permuted for layers 1..L-2): the
// deepest ring (at most MAX_STAGES, at least one layer's slabs) that fits
// the block's shared memory, one block per SM.
template <int H, bool MORLET>
cudaError_t launch(Args args, const void* swq_k, cudaStream_t stream) {
  using G = Geometry<H>;
  CUtensorMap map;
  if (!s8_map(&map, swq_k, H, (uint64_t)(args.L - 1) * H, H)) return cudaErrorNotSupported;
  int limit = 0, sms = 0;
  cudaError_t err = siren_fwd::device_limits(limit, sms);
  if (err != cudaSuccess) return err;
  args.stages = siren_fwd::MAX_STAGES;
  while (args.stages > G::KB && G::smem_bytes(args.L, args.stages) > (size_t)limit)
    --args.stages;
  const size_t smem = G::smem_bytes(args.L, args.stages);
  if (smem > (size_t)limit) return cudaErrorInvalidConfiguration;
  // the shared-memory ceiling every launch stays under, raised once per
  // instantiation at its first use
  static const cudaError_t raised =
      cudaFuncSetAttribute(siren_forward_int8_kernel<H, MORLET>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (raised != cudaSuccess) return raised;
  const long long tiles = (long long)args.B * ((args.S + TM - 1) / TM);
  if (tiles > 0x7ffffffeLL) return cudaErrorInvalidConfiguration;
  const long long pairs = (tiles + 1) / 2;
  const int blocks = (int)(pairs < sms ? pairs : sms);
  siren_forward_int8_kernel<H, MORLET><<<blocks, THREADS, smem, stream>>>(map, args);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_act(const Args& args, int morlet, const void* swq_k, cudaStream_t stream) {
  return morlet ? launch<H, true>(args, swq_k, stream) : launch<H, false>(args, swq_k, stream);
}

}  // namespace

// Returns a cudaError_t (0 = launched). Pointers are device pointers to
// contiguous tensors; swq_k is the kernel's weight pack (L-1, H, H) int8
// (out, in) per layer with the contraction index of layers 1..L-2 permuted
// (siren_kernel.int8_kernel_weights), 16-byte aligned; ls is
// (B, ls_stride) and its first column is read.
extern "C" int siren_forward_int8_launch(const void* fq, const void* gd, const void* ls,
                                         const void* base, const void* swq_k, const void* sb,
                                         const void* last_w, const void* last_b, void* out,
                                         int B, int S, int H, int L, int ls_stride, float w0,
                                         int morlet, void* stream) {
  if (B <= 0 || S <= 0 || L < 2 || ls_stride < 1) return (int)cudaErrorInvalidValue;
  Args args{static_cast<const float*>(fq),
            static_cast<const float*>(gd),
            static_cast<const float*>(ls),
            static_cast<const float*>(base),
            static_cast<const float*>(sb),
            static_cast<const float*>(last_w),
            static_cast<const float*>(last_b),
            static_cast<float*>(out),
            B,
            S,
            L,
            ls_stride,
            w0,
            0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return (int)launch_act<64>(args, morlet, swq_k, st);
    case 128: return (int)launch_act<128>(args, morlet, swq_k, st);
    case 192: return (int)launch_act<192>(args, morlet, swq_k, st);
    case 256: return (int)launch_act<256>(args, morlet, swq_k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* siren_forward_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
