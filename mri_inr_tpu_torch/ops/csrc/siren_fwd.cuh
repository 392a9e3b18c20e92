// The warp-specialised persistent chain shared by the two SIREN forward
// kernels (siren_forward.cu: eval; siren_train_fwd.cu: training, with
// dropout). Each supplies an epilogue policy (the arithmetic between the
// products); this header holds the block, the weight ring and the products.
//
// Per 64-row tile of one patch (rows of S, a tile never straddles two
// patches), with x_0 built from `base` and the patch's first modulation:
//
//   pre_i = x_{i-1} @ W_i + b_i      (bf16 x bf16 -> f32, wgmma)
//   x_i   = bf16(epilogue(pre_i))    i = 1 .. L-2
//   out   = out_sine(sum_h last(pre_{L-1})[h] + last_b)
//
// The block (384 threads, one per SM, persistent):
// - warpgroup 0, the producer: gives its registers away (setmaxnreg 40);
//   one thread streams the hidden weights W^T (the wrapper passes them
//   transposed, (out, in) per layer) through a ring of `stages` slabs, each
//   slab 64 contraction rows of all H outputs (H/64 TMA boxes of 64 x 64
//   bf16, 128-byte swizzle: hopper.cuh's K-major layout), paced by full /
//   empty mbarriers. The slab sequence runs across layers and tiles.
// - warpgroups 1 and 2, the consumers (setmaxnreg 232): the block walks tile
//   pairs p = blockIdx.x, + gridDim.x, ...; consumer c takes tile 2p + c
//   (an odd last tile leaves consumer 1 a tile of zeros, computed and never
//   stored), so every consumer reads every slab and a slab serves 128 rows.
//   A consumer owns its tile's 64 x H accumulator (H/2 f32 a thread) and
//   keeps its activations in registers as the next product's A fragments:
//   the wgmma accumulator layout packed pairwise to bf16 is the RS form's
//   A-fragment layout (as FlashAttention-3 feeds P to P.V), so no
//   activation tile passes through shared memory.
// - ping-pong: the consumers take turns at the tensor cores, ordered by two
//   named barriers. Consumer c waits for its turn and for the layer's slabs,
//   issues the layer's H/16 wgmma m64nHk16 back to back, hands the turn over
//   and runs its epilogue while the other's products run. An empty barrier
//   counts both consumers' releases.
//
// Shared memory: 1 KB of alignment, the ring (stages x H/64 x 8 KB), the two
// consumers' modulations (2 x L x H f32), the biases ((L-1) x H f32), the
// policy's extra vectors and 2 x stages mbarriers: it grows with L only by
// H-wide vectors.

#pragma once

#include "hopper.cuh"
#include "siren_common.cuh"

namespace siren_fwd {

using namespace siren;
using namespace hopper;

constexpr int TM = 64;                 // rows of S per tile
constexpr int BOX = 64 * 64 * 2;       // bytes of one 64 x 64 bf16 TMA box
constexpr int THREADS = 384;           // producer + two consumer warpgroups
constexpr int MAX_STAGES = 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;     // 128 x (40 + 2 x 232) <= 65,536
constexpr int ORDER_BAR = 1;           // + c: consumer c's turn at the tensor cores
constexpr int CONSUMER_BAR = 3;        // + c: consumer c's own 128 threads
static_assert(128 * (PRODUCER_REGS + 2 * CONSUMER_REGS) <= 65536, "register file");

#ifdef SIREN_FWD_TRACE
// Timeline of the first TRACE_MARKS marks of each consumer of each block
// (clock64, by the consumer's first thread); built only by
// scripts/torch_fwd_cut_probe.py.
constexpr int TRACE_BLOCKS = 256, TRACE_MARKS = 256;
__device__ long long g_trace[TRACE_BLOCKS * 2 * TRACE_MARKS];
#define FWD_MARK(k)                                                                   \
  do {                                                                                \
    if (wtid == 0 && blockIdx.x < TRACE_BLOCKS && (k) < TRACE_MARKS)                  \
      g_trace[(blockIdx.x * 2 + ci) * TRACE_MARKS + (k)] = clock64();                 \
    ++(k);                                                                            \
  } while (0)
}  // namespace siren_fwd
extern "C" int siren_fwd_trace_copy(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, siren_fwd::g_trace, sizeof(siren_fwd::g_trace));
}
namespace siren_fwd {
#else
#define FWD_MARK(k) ((void)0)
#endif

// What both kernels take besides their policy's own arguments.
struct Common {
  const float* mods;  // (B, L*H) f32
  const float* base;  // (S, H) f32
  const float* sb;    // (L-1, H) f32
  float* out;         // (B, S) f32
  int B, S, L;
  int stages;         // weight ring depth, set by launch()
};

template <int H>
struct Geometry {
  static constexpr int KB = H / 64;      // slabs per layer
  static constexpr int STAGE = KB * BOX;  // one slab: H rows x 64 contraction values
  static constexpr int NA = H / 2;       // accumulator floats per thread
  static constexpr int NX = H / 4;       // packed bf16 pairs (A fragments) per thread
  static size_t smem_bytes(int L, int stages, int extra_floats) {
    return 1024 + (size_t)stages * STAGE +
           sizeof(float) * ((size_t)2 * L * H + (size_t)(L - 1) * H + extra_floats) +
           sizeof(uint64_t) * 2 * stages;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Epi: the policy. Epi::Args has a Common `common`; Epi(args, extra) is built
// per consumer thread over the Epi::EXTRA H-wide vectors of shared memory
// that Epi::load_extra fills. Per element of column col (e its dropout index
// (b*S + s)*H + col, off the layer's hash offset, layer_off(i)):
//   x0(v, mod0, e, off)          x_0 before bf16 rounding (v from base)
//   hidden(pre, mod, e, off)     x_i before bf16 rounding (pre with bias)
//   last(pre, mod, col, e, off)  the element's term of the output row sum
//   out(r)                       the output from the row sum (without last_b)
//   stage_mod(m, layer)          a modulation as the epilogue reads it
template <int H, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    forward_kernel(const __grid_constant__ CUtensorMap wt_map, const typename Epi::Args args) {
  static_assert(H % 64 == 0 && H <= 256, "H must be a multiple of 64, at most 256");
  using G = Geometry<H>;
  constexpr int KB = G::KB, NA = G::NA, NX = G::NX;
  const Common& cm = args.common;
  const int L = cm.L, S = cm.S, nst = cm.stages;
  const int tpp = (S + TM - 1) / TM;
  const int ntiles = cm.B * tpp, npairs = (ntiles + 1) / 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* mod_s = reinterpret_cast<float*>(ring + nst * G::STAGE);  // 2 x L x H
  float* bias_s = mod_s + 2 * L * H;                               // (L-1) x H
  float* extra_s = bias_s + (L - 1) * H;                           // Epi::EXTRA x H
  uint64_t* full = reinterpret_cast<uint64_t*>(extra_s + Epi::EXTRA * H);
  uint64_t* empty = full + nst;

  const int tid = threadIdx.x;
  for (int i = tid; i < (L - 1) * H; i += THREADS) bias_s[i] = cm.sb[i];
  Epi::load_extra(args, extra_s, H, tid, THREADS);
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
    const int per_pair = (L - 1) * KB;
    int n = 0;
    for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
      for (int s = 0; s < per_pair; ++s, ++n) {
        const int st = n % nst, use = n / nst;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        mbar_expect_tx(&full[st], G::STAGE);
        const int layer = s / KB, kq = s % KB;
        for (int q = 0; q < KB; ++q)
          tma_load_2d(ring + st * G::STAGE + q * BOX, &wt_map, 64 * kq, layer * H + 64 * q,
                      &full[st]);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  const int ci = (tid >> 7) - 1;  // consumer 0 or 1
  const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rbase = warp * 16 + g;  // this thread's rows: rbase, rbase + 8
  float* my_mod = mod_s + ci * L * H;
  const Epi epi(args, extra_s);
#ifdef SIREN_FWD_TRACE
  int mark = 0;
#endif

  float acc[NA];
  uint32_t xa[NX];  // the layer input as A fragments: pair m at (row(m), col(m))
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  if (ci == 1) bar_arrive(ORDER_BAR, 256);  // consumer 0 goes first
  int n = 0;                                // slabs consumed

  for (int p = blockIdx.x; p < npairs; p += gridDim.x) {
    FWD_MARK(mark);
    const int tile = 2 * p + ci;
    const bool valid = tile < ntiles;
    const int b = valid ? tile / tpp : 0;
    const int row0 = valid ? (tile % tpp) * TM : 0;
    const int rows = valid ? min(TM, S - row0) : 0;  // rows of the tile below S
    const uint32_t idx0 = ((uint32_t)b * (uint32_t)S + (uint32_t)row0) * (uint32_t)H;

    bar_sync(CONSUMER_BAR + ci, 128);  // the last tile's epilogue has read my_mod
    const float* mrow = cm.mods + (size_t)b * L * H;
    for (int i = wtid; i < L * H; i += 128)
      my_mod[i] = valid ? epi.stage_mod(mrow[i], i / H) : 0.f;
    bar_sync(CONSUMER_BAR + ci, 128);

    // x_0; rows past S are zero
    {
      const uint32_t off = epi.layer_off(0);
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        const int r = rbase + 8 * (m & 1), col = 8 * (m >> 1) + 2 * t4;
        float2 v = make_float2(0.f, 0.f);
        if (r < rows) v = *reinterpret_cast<const float2*>(cm.base + (size_t)(row0 + r) * H + col);
        const float2 md = *reinterpret_cast<const float2*>(my_mod + col);
        const uint32_t e = idx0 + (uint32_t)(r * H + col);
        xa[m] = pack_bf16(epi.x0(v.x, md.x, e, off), epi.x0(v.y, md.y, e + 1, off));
      }
    }
    FWD_MARK(mark);

    for (int layer = 0; layer < L - 1; ++layer) {
      // ---- the products: acc = x . W_layer, on this consumer's turn. The
      // layer's slabs are waited for first: with a wait loop between them,
      // ptxas serialised the wgmma instructions (C7520, a
      // warpgroup.arrive and a wait around each).
      FWD_MARK(mark);
      bar_sync(ORDER_BAR + ci, 256);
      FWD_MARK(mark);
#pragma unroll
      for (int s = 0; s < KB; ++s) mbar_wait(&full[(n + s) % nst], ((n + s) / nst) & 1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KB; ++s) {
        const uint32_t b0 = smem_u32(ring + ((n + s) % nst) * G::STAGE);
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const int kk = 4 * s + k4;
          wgmma_rs<H>(acc, xa[4 * kk], xa[4 * kk + 1], xa[4 * kk + 2], xa[4 * kk + 3],
                      desc(b0 + k4 * 32, 16, 1024), kk > 0);
        }
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
      const float* mod = my_mod + (layer + 1) * H;
      const uint32_t off = epi.layer_off(layer + 1);
      if (layer < L - 2) {
#pragma unroll
        for (int m = 0; m < NX; ++m) {
          const int r = rbase + 8 * (m & 1), col = 8 * (m >> 1) + 2 * t4;
          const float2 bb = *reinterpret_cast<const float2*>(bias + col);
          const float2 md = *reinterpret_cast<const float2*>(mod + col);
          const uint32_t e = idx0 + (uint32_t)(r * H + col);
          xa[m] = pack_bf16(epi.hidden(acc[2 * m] + bb.x, md.x, e, off),
                            epi.hidden(acc[2 * m + 1] + bb.y, md.y, e + 1, off));
        }
      } else {
        // last layer: each row's sum over H lies in one quad of lanes
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int m = 0; m < NX; ++m) {
          const int r = rbase + 8 * (m & 1), col = 8 * (m >> 1) + 2 * t4;
          const float2 bb = *reinterpret_cast<const float2*>(bias + col);
          const float2 md = *reinterpret_cast<const float2*>(mod + col);
          const uint32_t e = idx0 + (uint32_t)(r * H + col);
          part[m & 1] += epi.last(acc[2 * m] + bb.x, md.x, col, e, off) +
                         epi.last(acc[2 * m + 1] + bb.y, md.y, col + 1, e + 1, off);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = part[h];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          const int r = rbase + 8 * h;
          if (t4 == 0 && r < rows) cm.out[(size_t)b * S + row0 + r] = epi.out(v);
        }
      }
      FWD_MARK(mark);
    }
  }
}

inline cudaError_t device_limits(int& smem_limit, int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

// Launch forward_kernel<H, Epi> on `stream` over W^T (`swt`, (L-1, H, H)
// bf16, (out, in) per layer): the deepest ring (at most MAX_STAGES, at least
// one layer's slabs) that fits the block's shared memory, one block per SM.
template <int H, class Epi>
cudaError_t launch(typename Epi::Args args, const void* swt, cudaStream_t stream) {
  using G = Geometry<H>;
  Common& cm = args.common;
  CUtensorMap wt_map;
  const uint64_t dims[2] = {(uint64_t)H, (uint64_t)(cm.L - 1) * H};
  if (!bf16_map(&wt_map, swt, 2, dims)) return cudaErrorNotSupported;
  int limit = 0, sms = 0;
  cudaError_t err = device_limits(limit, sms);
  if (err != cudaSuccess) return err;
  const int extra = Epi::EXTRA * H;
  cm.stages = MAX_STAGES;
  while (cm.stages > G::KB && G::smem_bytes(cm.L, cm.stages, extra) > (size_t)limit)
    --cm.stages;
  const size_t smem = G::smem_bytes(cm.L, cm.stages, extra);
  if (smem > (size_t)limit) return cudaErrorInvalidConfiguration;
  // the shared-memory ceiling every launch stays under, raised once per
  // instantiation at its first use: a launch inside a CUDA graph's capture
  // then puts nothing but the kernel on the stream
  static const cudaError_t raised = cudaFuncSetAttribute(
      forward_kernel<H, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (raised != cudaSuccess) return raised;
  const long long tiles = (long long)cm.B * ((cm.S + TM - 1) / TM);
  if (tiles > 0x7ffffffeLL) return cudaErrorInvalidConfiguration;
  const long long pairs = (tiles + 1) / 2;
  const int blocks = (int)(pairs < sms ? pairs : sms);
  forward_kernel<H, Epi><<<blocks, THREADS, smem, stream>>>(wt_map, args);
  return cudaGetLastError();
}

}  // namespace siren_fwd
