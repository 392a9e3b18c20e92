// Fused modulated-SIREN TRAINING backward for Hopper (sm_90a): a chain
// kernel and a weight-gradient kernel, launched together by one call.
//
// Replaces the Pallas TPU kernel
// mri_inr_tpu/ops/siren_train_kernel.py:_bwd_kernel. Given the forward's
// inputs and the cotangent g (B, S) of its output, it recomputes the forward
// chain (siren_train_fwd.cu) and walks it in reverse. With drop_i the
// layer-i dropout mask regenerated from the seed, act / dact the activation
// and its derivative (dact = w0 * cos_poly(w0 * p), or env * (w0 * cos -
// p * sin) for Morlet):
//
//   last layer : r = sum_h x_{L-1} * last_w + last_b
//                dpl = g * w0 * cos_poly(w0 * r)
//                dlw += sum_rows dpl * x_{L-1};  dlb += sum_rows dpl
//                dx  = dpl (x) last_w
//   i = L-2..0 : pre = x_i @ W_i + b_i                       (product 1)
//                dmods[i+1] = sum_rows dx * drop_{i+1}(act(pre))
//                dpre = drop_{i+1}(dx * mod_{i+1}) * dact(pre)
//                dsb_i += sum_rows dpre
//                dW_i  += x_i^T @ bf16(dpre)                  (product 2)
//                dx     = bf16(dpre) @ W_i^T                  (product 3)
//   layer 0    : dmods[0] = sum_rows dx * drop_0(base)
//                dbase    = sum_patches drop_0(dx * mod_0)
//
// What bounds it: the gradient needs three H x H products per hidden layer
// and row (the forward's, dW and dx), 6 * B * S * H^2 * (L-1) bf16
// tensor-core operations (3.6e11 at B=400, S=576, H=256, L=5): 0.37 ms at
// 989 TFLOP/s; its own inputs and outputs are a few MB. No activation is
// kept between forward and backward, so the chain recomputes: it runs
// 3L - 4 products (11 at L=5), the forward's L-1, `pre` again for L-3 layers
// (the last hidden product is shared) and dx for L-1.
//
// Design:
// - chain kernel, one block per (group of patches, 64-row tile of S), the
//   patches taken in turn: four warpgroups split the H output columns
//   (64 x H/4 accumulators each for `pre` and for `dx`, so both meet
//   element by element in registers; 512 threads of up to 128 registers,
//   so 16 warps hide the epilogues' latencies). The weights come through a
//   ring of 3-4 slabs (at least one product's) filled with TMA loads by
//   thread 0 at the end of each product, so the next product's weights
//   arrive while its epilogue runs; loads issued
//   between a warpgroup's wgmma instructions made ptxas serialise them, and
//   a separate producer warp (17 warps) cut the registers to 96 and spilled.
//   Full / empty mbarriers pace the ring; the warpgroups meet at a named
//   barrier only around their shared-memory tiles. Products are wgmma
//   m64n(H/4)k16 with both operands K-major in shared memory (128-byte
//   swizzle): the A tile (x_i or bf16(dpre)) and a slab of 64 contraction
//   values of all H output rows, taken from W^T for x . W and from W for
//   dpre . W^T (the wrapper passes both), so one box shape and one
//   descriptor form serve both products;
// - the chain keeps two A tiles (x_i and bf16(dpre)) instead of all L
//   layer inputs: the recomputed forward writes each bf16 x_i (i <= L-2)
//   to a workspace, the reverse sweep loads x_i back with cp.async while
//   the layer before finishes (a tile written moments before, in L2) and
//   writes each bf16(dpre_i); 16-byte stores and loads by all threads,
//   rows past S skipped on the way out and zero on the way back. Shared
//   memory grows with L only by a few H-wide vectors a layer;
// - it computes everything but dW: dmods, dsb, dlw and dlb as one partial
//   record per (patch, tile), summed over the tile's rows in a fixed order
//   (written straight to device memory; the wrapper sums the records, so
//   they repeat bit for bit). A block takes its tile for up to 4
//   consecutive patches in turn (chain_group: while the grid keeps 4 waves)
//   and adds their dbase terms, in patch order, into one f32 partial with
//   plain loads and stores; a small kernel sums the partials in order, so
//   dbase repeats bit for bit too (one partial per patch would write and
//   read 236 MB at B=400);
// - the activation (sine or Morlet) is a template argument: the epilogues
//   are unrolled over a thread's elements, and the kernel is larger than
//   the instruction cache, so a run-time switch would cost in every block;
// - weight-gradient kernel: dW_i = X_i^T . dP_i over all B*S rows from the
//   workspace, a split-K wgmma product: blocks over (layer, 128 rows of dW,
//   split of the rows), two consumer warpgroups of 64 x H each, a producer
//   warp feeding a 4-stage TMA ring; both operands are read MN-major (the
//   contraction runs down the rows), rows past S load as zeros. Each block
//   writes its f32 partial; a reduction kernel sums the partials in a
//   fixed order, so dW repeats bit for bit.
//
// Rows past S in the last tile carry g = 0 and zero x_0, so they add exact
// zeros everywhere.
//
// Built with nvcc into a shared library with a plain C interface; the
// Python wrapper (ops/siren_train_kernel.py) checks every tensor, allocates
// the workspace and the partials, and calls siren_train_bwd_launch through
// ctypes on PyTorch's current stream.

#include "hopper.cuh"
#include "siren_common.cuh"

namespace {

using namespace siren;
using namespace hopper;

constexpr int TM = 64;                           // rows of S per chain block
constexpr int CHAIN_WGS = 4;                     // chain warpgroups: H / 4 columns each
constexpr int CHAIN_THREADS = 128 * CHAIN_WGS;
constexpr int CHAIN_BLOCK = CHAIN_THREADS;       // thread 0 also feeds the ring
constexpr int DW_CONSUMERS = 256;                // two dW warpgroups
constexpr int DW_THREADS = DW_CONSUMERS + 32;    // and a producer warp
constexpr int BOX = 64 * 64 * 2;                 // bytes of one 64 x 64 bf16 TMA box
constexpr int CONSUMER_BAR = 1;                  // named barrier of the consumers

struct Args {
  const float* seed;       // (1,) f32 holding an integer
  const float* mods;       // (B, L*H) f32
  const float* base;       // (S, H) f32
  const float* sb;         // (L-1, H) f32
  const float* last_w;     // (H,) f32
  const float* last_b;     // (1,) f32
  const float* g;          // (B, S) f32
  float* part;             // (B * tiles, record) f32, every element written
  float* dbase_part;       // (ceil(B / group), S, H) f32: dbase partials
  __nv_bfloat16* work;     // (2, L-1, B, S, H) bf16: x_i, then bf16(dpre_i)
  int B;
  int S;
  int L;
  float w0;
  int morlet;
  int32_t thresh;
  float inv_keep;
  int dropout;
  int stages;  // weight ring depth
  int group;   // patches a chain block takes in turn (chain_group)
};

// act(p) and dact(p) together: they share the range-reduced argument's
// polynomial pair and, for Morlet, the envelope.
template <int DEG, bool MORLET>
__device__ __forceinline__ void act_pair(float p, float w0, float& a, float& da) {
  const float z = w0 * p;
  const float s = poly_sin<DEG>(z), c = poly_cos<DEG>(z);
  if (MORLET) {
    const float env = expf(-0.5f * (p * p));
    a = s * env;
    da = env * (w0 * c - p * s);
  } else {
    a = s;
    da = w0 * c;
  }
}

template <int DEG, bool MORLET>
__device__ __forceinline__ float act_only(float p, float w0) {
  float a = poly_sin<DEG>(w0 * p);
  if (MORLET) a *= expf(-0.5f * (p * p));
  return a;
}

// sum over the 8 lanes that share a column pair (same t, all g)
__device__ __forceinline__ float reduce_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// bf16 pair (a, b) to columns c, c+1 of row r of a K-major swizzled tile
// (64 rows; 64-column blocks of 8 KB).
__device__ __forceinline__ void st_pair(unsigned char* tile, int r, int c, float a, float b) {
  const int kc = c & 63;
  const int off = (c >> 6) * BOX + r * 128 + ((((kc >> 3) ^ (r & 7))) << 4) + (kc & 7) * 2;
  *reinterpret_cast<__nv_bfloat162*>(tile + off) = __floats2bfloat162_rn(a, b);
}

// Rows of a swizzled 64 x H tile <-> rows row0.. (those below S) of slab z
// of the (., S, H) workspace, in 16-byte chunks by all chain threads.
template <int H>
__device__ __forceinline__ void tile_to_global(const unsigned char* tile, __nv_bfloat16* ws,
                                               size_t z, int row0, int S, int tid) {
  for (int i = tid; i < TM * (H / 8); i += CHAIN_THREADS) {
    const int r = i / (H / 8), ch = i % (H / 8);
    if (row0 + r >= S) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(tile + (ch >> 3) * BOX + r * 128 +
                                                    (((ch & 7) ^ (r & 7)) << 4));
    *reinterpret_cast<uint4*>(ws + (z * S + row0 + r) * H + ch * 8) = v;
  }
}

template <int H>
__device__ __forceinline__ void global_to_tile(unsigned char* tile, const __nv_bfloat16* ws,
                                               size_t z, int row0, int S, int tid) {
  for (int i = tid; i < TM * (H / 8); i += CHAIN_THREADS) {
    const int r = i / (H / 8), ch = i % (H / 8);
    unsigned char* dst = tile + (ch >> 3) * BOX + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
    if (row0 + r < S)
      cp_async16(dst, ws + (z * S + row0 + r) * H + ch * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Product p of a chain block's sequence -> (layer, reads W^T). The
// recomputed forward's L-1 products read W^T (x . W); then dx of layer
// L-2 reads W (dpre . W^T); then for i = L-3..0, `pre` again (W^T) and dx
// (W).
__device__ __forceinline__ void product_of(int p, int L, int& layer, bool& wt) {
  if (p < L - 1) {
    layer = p;
    wt = true;
  } else if (p == L - 1) {
    layer = L - 2;
    wt = false;
  } else {
    layer = L - 3 - (p - L) / 2;
    wt = ((p - L) & 1) == 0;
  }
}

template <int H>
struct Chain {
  static constexpr int NW = H / CHAIN_WGS;  // output columns per warpgroup
  static constexpr int NA = NW / 2;         // accumulator floats per thread
  static constexpr int KB = H / 64;         // 64-wide contraction slabs per product
  static constexpr int TILE = KB * BOX;     // one 64 x H A tile
  static constexpr int STAGE = KB * BOX;    // one slab: H rows x 64
  // a tile's partial sums: dmods (L*H), dsb ((L-1)*H), dlw (H), dlb (1),
  // padded to a multiple of 4
  __host__ __device__ static constexpr int record(int L) { return 2 * L * H + 4; }

  static size_t smem_bytes(int L, int stages) {
    return 1024 + 2 * (size_t)TILE + (size_t)stages * STAGE +
           sizeof(float) * ((size_t)L * H + (size_t)(L - 1) * H + 9 * H +
                            (CHAIN_WGS + 1) * TM) +
           sizeof(uint64_t) * 2 * stages;
  }
};

// The weight ring of a chain block. Slab n of the block's sequence
// (product n / KB, 64 contraction values n % KB of all H output rows) goes
// to stage n % stages. Thread 0 issues the TMA loads; every thread waits on
// `full`, and each warpgroup releases a stage on `empty` once its products
// have read it.
template <int H>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  const CUtensorMap* w_map;   // W: rows (layer, out), columns in
  const CUtensorMap* wt_map;  // W^T: rows (layer, in), columns out
  int stages, L;
  int products;  // of the block's sequence: 3L - 4 for each of its patches
  int t = 0;     // slabs consumed
  int next = 0;  // thread 0: the next slab to load

  // thread 0, outside any product: load slabs up to `last` as their stages
  // are released
  __device__ void load_upto(int last) {
    constexpr int KB = Chain<H>::KB;
    for (; next <= last && next < KB * products; ++next) {
      const int st = next % stages, use = next / stages;
      if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
      int layer;
      bool wt;
      product_of(next / KB % (3 * L - 4), L, layer, wt);
      mbar_expect_tx(&full[st], Chain<H>::STAGE);
      for (int q = 0; q < KB; ++q)
        tma_load_2d(base + st * Chain<H>::STAGE + q * BOX, wt ? wt_map : w_map,
                    64 * (next % KB), layer * H + 64 * q, &full[st]);
    }
  }
};

// acc = a_tile (64 x H) . B, B the ring's next KB slabs.
template <int H>
__device__ __forceinline__ void chain_product(float (&acc)[Chain<H>::NA],
                                              const unsigned char* a_tile, Ring<H>& ring,
                                              int tid) {
  using C = Chain<H>;
  const int wg = tid >> 7, wtid = tid & 127, nst = ring.stages;
#pragma unroll
  for (int i = 0; i < C::NA; ++i) acc[i] = 0.f;
  wgmma_fence();
  const uint32_t a0 = smem_u32(a_tile);
#pragma unroll
  for (int s = 0; s < C::KB; ++s, ++ring.t) {
    const int t = ring.t, st = t % nst;
    mbar_wait(&ring.full[st], (t / nst) & 1);
    const uint32_t b0 = smem_u32(ring.base + st * C::STAGE + wg * C::NW * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<C::NW, 0, 0>(acc, desc(a0 + s * BOX + kk * 32, 16, 1024),
                         desc(b0 + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the previous slab's products are done
    if (s > 0 && wtid == 0) mbar_arrive(&ring.empty[(t - 1) % nst]);
  }
  wgmma_wait<0>();
  if (wtid == 0) mbar_arrive(&ring.empty[(ring.t - 1) % nst]);
  // the next product's slabs load while this one's epilogue runs
  if (tid == 0) ring.load_upto(ring.t + nst - 1);
  __syncwarp();
}

template <int H, int DEG, bool MORLET>
__global__ void __launch_bounds__(CHAIN_BLOCK, 1)
    chain_kernel(const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap wt_map, Args args) {
  static_assert(H % 64 == 0 && H <= 256, "H must be a multiple of 64, at most 256");
  using C = Chain<H>;
  constexpr int NW = C::NW, NA = C::NA;
  const int L = args.L, S = args.S, nst = args.stages;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ax = align1024(smem_raw);  // x_i tile
  unsigned char* ap = ax + C::TILE;         // bf16(dpre) tile
  unsigned char* ring_s = ap + C::TILE;     // nst weight slabs
  float* mod_s = reinterpret_cast<float*>(ring_s + nst * C::STAGE);  // L x H
  float* bias_s = mod_s + L * H;                                   // (L-1) x H
  float* lw_s = bias_s + (L - 1) * H;                              // H
  float* red_a = lw_s + H;                                         // 4 x H
  float* red_b = red_a + 4 * H;                                    // 4 x H
  float* red_r = red_b + 4 * H;                                    // CHAIN_WGS x TM
  float* dpl_s = red_r + CHAIN_WGS * TM;                           // TM
  uint64_t* full = reinterpret_cast<uint64_t*>(dpl_s + TM);        // nst
  uint64_t* empty = full + nst;                                    // nst

  const int tid = threadIdx.x;
  const int tiles = (S + TM - 1) / TM;
  const int b0 = blockIdx.x / tiles * args.group;  // the block's first patch
  const int np = min(args.group, args.B - b0);     // its patches, taken in turn
  const int tile = blockIdx.x % tiles;
  const int row0 = tile * TM;

  for (int i = tid; i < (L - 1) * H; i += CHAIN_BLOCK) bias_s[i] = args.sb[i];
  for (int i = tid; i < H; i += CHAIN_BLOCK) lw_s[i] = args.last_w[i];
  Ring<H> ring{ring_s, full, empty, &w_map, &wt_map, nst, L, np * (3 * L - 4)};
  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CHAIN_WGS);
    }
    mbar_init_fence();
    ring.load_upto(nst - 1);  // every stage starts empty
  }
  __syncthreads();

  const int wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rbase = warp * 16 + g;  // rows rbase and rbase + 8 of the tile
  const int cbase = wg * NW + 2 * t4;  // + 8j: this thread's column pairs
  const Dropout dp{(uint32_t)(int)args.seed[0], args.thresh, args.inv_keep, args.dropout};
  // the block's dbase partial: its patches' terms for this tile, in patch order
  float* db_part = args.dbase_part + ((size_t)(b0 / args.group) * S + row0) * H;

  float acc[NA];  // pre of the current layer (without its bias)
  float dxr[NA];  // dx, same (row, column) layout

  for (int b = b0; b < b0 + np; ++b) {
    // the patch's modulations; the last patch's epilogues have read mod_s
    // (they end before the barrier ahead of its record)
    const float* mrow = args.mods + (size_t)b * L * H;
    for (int i = tid; i < L * H; i += CHAIN_BLOCK) mod_s[i] = mrow[i];
    bar_sync(CONSUMER_BAR, CHAIN_THREADS);
    const uint32_t idx0 = ((uint32_t)b * (uint32_t)S + (uint32_t)row0) * (uint32_t)H;
    const size_t xz = b, pz = (size_t)(L - 1) * args.B + b;  // workspace slabs of x_0, dpre_0
    float* dm_g = args.part + ((size_t)b * tiles + tile) * C::record(L);  // this tile's record
    float* db_g = dm_g + L * H;
    float* dlw_g = db_g + (L - 1) * H;

    // x_0 = bf16(drop_0(base) * mod_0); rows past S are zero
    {
      const uint32_t off = layer_offset(dp, 0);
      for (int i = tid; i < TM * (H / 2); i += CHAIN_THREADS) {
        const int r = i / (H / 2), c = (i % (H / 2)) * 2;
        float2 v = make_float2(0.f, 0.f);
        if (row0 + r < S)
          v = *reinterpret_cast<const float2*>(args.base + (size_t)(row0 + r) * H + c);
        const uint32_t e = idx0 + (uint32_t)(r * H + c);
        st_pair(ax, r, c, __fmul_rn(drop(dp, v.x, e, off), mod_s[c]),
                __fmul_rn(drop(dp, v.y, e + 1, off), mod_s[c + 1]));
      }
    }
    fence_async_shared();
    bar_sync(CONSUMER_BAR, CHAIN_THREADS);
    tile_to_global<H>(ax, args.work, xz, row0, S, tid);

    // ---- recomputed forward: x_1 .. x_{L-2}, each to ax and the workspace
    for (int layer = 0; layer < L - 2; ++layer) {
      chain_product<H>(acc, ax, ring, tid);
      bar_sync(CONSUMER_BAR, CHAIN_THREADS);  // ax read by every product and store
      const float* bias = bias_s + layer * H;
      const float* mod = mod_s + (layer + 1) * H;
      const uint32_t off = layer_offset(dp, layer + 1);
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int c = cbase + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + 8 * h;
          const uint32_t e = idx0 + (uint32_t)(r * H + c);
          const float a0 = act_only<DEG, MORLET>(acc[4 * j + 2 * h] + bias[c], args.w0);
          const float a1 = act_only<DEG, MORLET>(acc[4 * j + 2 * h + 1] + bias[c + 1], args.w0);
          st_pair(ax, r, c, __fmul_rn(drop(dp, a0, e, off), mod[c]),
                  __fmul_rn(drop(dp, a1, e + 1, off), mod[c + 1]));
        }
      }
      fence_async_shared();
      bar_sync(CONSUMER_BAR, CHAIN_THREADS);
      tile_to_global<H>(ax, args.work, (size_t)(layer + 1) * args.B + b, row0, S, tid);
    }

    // ---- last hidden product: pre_{L-1} stays in acc for the reverse sweep
    chain_product<H>(acc, ax, ring, tid);
    {
      const float* bias = bias_s + (L - 2) * H;
      const float* mod = mod_s + (L - 1) * H;
      const uint32_t off = layer_offset(dp, L - 1);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int c = cbase + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + 8 * h;
          const uint32_t e = idx0 + (uint32_t)(r * H + c);
          const float a0 = act_only<DEG, MORLET>(acc[4 * j + 2 * h] + bias[c], args.w0);
          const float a1 = act_only<DEG, MORLET>(acc[4 * j + 2 * h + 1] + bias[c + 1], args.w0);
          // x_{L-1}, rounded to bf16 as the forward does, kept as f32
          const float x0 = bf16_round(__fmul_rn(drop(dp, a0, e, off), mod[c]));
          const float x1 = bf16_round(__fmul_rn(drop(dp, a1, e + 1, off), mod[c + 1]));
          dxr[4 * j + 2 * h] = x0;
          dxr[4 * j + 2 * h + 1] = x1;
          part[h] += x0 * lw_s[c] + x1 * lw_s[c + 1];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p = part[h];
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        if (t4 == 0) red_r[wg * TM + rbase + 8 * h] = p;
      }
      bar_sync(CONSUMER_BAR, CHAIN_THREADS);
      if (tid < TM) {
        float dpl = 0.f;
        if (row0 + tid < S) {
          float r = red_r[tid];
          for (int w = 1; w < CHAIN_WGS; ++w) r += red_r[w * TM + tid];
          r += args.last_b[0];
          dpl = args.g[(size_t)b * S + row0 + tid] * (args.w0 * poly_cos<DEG>(args.w0 * r));
        }
        dpl_s[tid] = dpl;
      }
      bar_sync(CONSUMER_BAR, CHAIN_THREADS);
      // dlw += sum_rows dpl * x_{L-1};  dx = dpl (x) last_w
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int c = cbase + 8 * j;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float dpl = dpl_s[rbase + 8 * h];
          s0 += dpl * dxr[4 * j + 2 * h];
          s1 += dpl * dxr[4 * j + 2 * h + 1];
          dxr[4 * j + 2 * h] = dpl * lw_s[c];
          dxr[4 * j + 2 * h + 1] = dpl * lw_s[c + 1];
        }
        s0 = reduce_rows(s0);
        s1 = reduce_rows(s1);
        if (g == 0) {
          red_a[warp * H + c] = s0;
          red_a[warp * H + c + 1] = s1;
        }
      }
      bar_sync(CONSUMER_BAR, CHAIN_THREADS);
      for (int c = tid; c < H; c += CHAIN_THREADS)  // the tile's sums, in a fixed order
        dlw_g[c] = ((red_a[c] + red_a[H + c]) + red_a[2 * H + c]) + red_a[3 * H + c];
      if (tid == 0) {
        float s = 0.f;
        for (int r = 0; r < TM; ++r) s += dpl_s[r];
        dlw_g[H] = s;  // dlb
      }
    }

    // ---- reverse sweep over the hidden layers
    for (int i = L - 2; i >= 0; --i) {
      if (i < L - 2) {  // pre_{i+1} again, from x_i brought back
        cp_async_wait<0>();
        fence_async_shared();
        bar_sync(CONSUMER_BAR, CHAIN_THREADS);
        chain_product<H>(acc, ax, ring, tid);
      }
      bar_sync(CONSUMER_BAR, CHAIN_THREADS);  // ap stored, ax read by both warpgroups
      if (i > 0)  // x_{i-1} back into ax while this layer finishes
        global_to_tile<H>(ax, args.work, (size_t)(i - 1) * args.B + b, row0, S, tid);

      const float* bias = bias_s + i * H;
      const float* mod = mod_s + (i + 1) * H;
      const uint32_t off = layer_offset(dp, i + 1);
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int c = cbase + 8 * j;
        float dm0 = 0.f, dm1 = 0.f, db0 = 0.f, db1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + 8 * h;
          const uint32_t e = idx0 + (uint32_t)(r * H + c);
          float a0, a1, da0, da1;
          act_pair<DEG, MORLET>(acc[4 * j + 2 * h] + bias[c], args.w0, a0, da0);
          act_pair<DEG, MORLET>(acc[4 * j + 2 * h + 1] + bias[c + 1], args.w0, a1, da1);
          const float dx0 = dxr[4 * j + 2 * h], dx1 = dxr[4 * j + 2 * h + 1];
          dm0 += dx0 * drop(dp, a0, e, off);
          dm1 += dx1 * drop(dp, a1, e + 1, off);
          const float dp0 = drop(dp, dx0 * mod[c], e, off) * da0;
          const float dp1 = drop(dp, dx1 * mod[c + 1], e + 1, off) * da1;
          db0 += dp0;
          db1 += dp1;
          st_pair(ap, r, c, dp0, dp1);
        }
        dm0 = reduce_rows(dm0);
        dm1 = reduce_rows(dm1);
        db0 = reduce_rows(db0);
        db1 = reduce_rows(db1);
        if (g == 0) {
          red_a[warp * H + c] = dm0;
          red_a[warp * H + c + 1] = dm1;
          red_b[warp * H + c] = db0;
          red_b[warp * H + c + 1] = db1;
        }
      }
      fence_async_shared();
      bar_sync(CONSUMER_BAR, CHAIN_THREADS);
      tile_to_global<H>(ap, args.work, (size_t)pz + i * args.B, row0, S, tid);
      for (int c = tid; c < H; c += CHAIN_THREADS) {  // the tile's sums, in a fixed order
        dm_g[(i + 1) * H + c] = ((red_a[c] + red_a[H + c]) + red_a[2 * H + c]) + red_a[3 * H + c];
        db_g[i * H + c] = ((red_b[c] + red_b[H + c]) + red_b[2 * H + c]) + red_b[3 * H + c];
      }
      chain_product<H>(dxr, ap, ring, tid);  // dx = dpre . W_i^T
    }

    // ---- layer 0: dmods[0] and this patch's dbase terms
    bar_sync(CONSUMER_BAR, CHAIN_THREADS);  // red_a read by every thread above
    {
      const uint32_t off = layer_offset(dp, 0);
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int c = cbase + 8 * j;
        float dm0 = 0.f, dm1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + 8 * h;
          if (row0 + r >= S) continue;  // dx is zero there
          const uint32_t e = idx0 + (uint32_t)(r * H + c);
          const float2 bv =
              *reinterpret_cast<const float2*>(args.base + (size_t)(row0 + r) * H + c);
          const float dx0 = dxr[4 * j + 2 * h], dx1 = dxr[4 * j + 2 * h + 1];
          dm0 += dx0 * drop(dp, bv.x, e, off);
          dm1 += dx1 * drop(dp, bv.y, e + 1, off);
          float2* db = reinterpret_cast<float2*>(db_part + (size_t)r * H + c);
          float2 d = make_float2(drop(dp, dx0 * mod_s[c], e, off),
                                 drop(dp, dx1 * mod_s[c + 1], e + 1, off));
          if (b > b0) {  // the earlier patches' sum, stored by this thread
            const float2 sum = *db;
            d = make_float2(sum.x + d.x, sum.y + d.y);
          }
          *db = d;
        }
        dm0 = reduce_rows(dm0);
        dm1 = reduce_rows(dm1);
        if (g == 0) {
          red_a[warp * H + c] = dm0;
          red_a[warp * H + c + 1] = dm1;
        }
      }
    }
    bar_sync(CONSUMER_BAR, CHAIN_THREADS);
    for (int c = tid; c < H; c += CHAIN_THREADS)
      dm_g[c] = ((red_a[c] + red_a[H + c]) + red_a[2 * H + c]) + red_a[3 * H + c];
  }
}

// ------------------------------------------------------------ dW kernel
constexpr int DW_STAGES = 4;

template <int H>
struct Dw {
  static constexpr int NB = H / 64;            // 64-wide blocks of dP per stage
  static constexpr int STAGE = (2 + NB) * BOX;  // 128 columns of X, all H of dP
  static constexpr size_t SMEM = 1024 + (size_t)DW_STAGES * STAGE + 2 * DW_STAGES * 8;
};

// partial[layer][split] (H x H f32) = sum over the split's row tiles of
// X_layer^T . dP_layer, for 128 rows of dW (64 per consumer warpgroup).
template <int H>
__global__ void __launch_bounds__(DW_THREADS, 1)
    dw_kernel(const __grid_constant__ CUtensorMap ws_map, float* __restrict__ partial, int B,
              int S, int L, int splits) {
  using D = Dw<H>;
  constexpr int NA = H / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DW_STAGES * D::STAGE);
  uint64_t* empty = full + DW_STAGES;

  constexpr int MTILES = (H + 127) / 128;
  int bid = blockIdx.x;
  const int mt = bid % MTILES;
  bid /= MTILES;
  const int layer = bid % (L - 1);
  const int split = bid / (L - 1);
  const int m0 = mt * 128;
  const int xblocks = m0 + 64 < H ? 2 : 1;
  const int tpp = (S + TM - 1) / TM;
  const long long ktiles = (long long)B * tpp;
  const int k0 = (int)(ktiles * split / splits), k1 = (int)(ktiles * (split + 1) / splits);
  const int tid = threadIdx.x;

  if (tid == DW_CONSUMERS) {
    for (int i = 0; i < DW_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= DW_CONSUMERS) {
    if (tid != DW_CONSUMERS) return;
    for (int k = k0, t = 0; k < k1; ++k, ++t) {
      const int st = t % DW_STAGES, use = t / DW_STAGES;
      if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
      mbar_expect_tx(&full[st], (xblocks + D::NB) * BOX);
      const int pb = k / tpp, s0 = (k % tpp) * TM;
      unsigned char* stage = ring + st * D::STAGE;
      for (int a = 0; a < xblocks; ++a)
        tma_load_3d(stage + a * BOX, &ws_map, m0 + 64 * a, s0, layer * B + pb, &full[st]);
      for (int n = 0; n < D::NB; ++n)
        tma_load_3d(stage + (2 + n) * BOX, &ws_map, 64 * n, s0, (L - 1 + layer) * B + pb,
                    &full[st]);
    }
    return;
  }

  const int wg = tid >> 7, wtid = tid & 127;
  const bool active = wg < xblocks;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  wgmma_fence();
  int t = 0;
  for (int k = k0; k < k1; ++k, ++t) {
    const int st = t % DW_STAGES;
    mbar_wait(&full[st], (t / DW_STAGES) & 1);
    if (!active) {
      if (wtid == 0) mbar_arrive(&empty[st]);
      continue;
    }
    const uint32_t a0 = smem_u32(ring + st * D::STAGE + wg * BOX);
    const uint32_t b0 = smem_u32(ring + st * D::STAGE + 2 * BOX);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<H, 1, 1>(acc, desc(a0 + kk * 2048, BOX, 1024), desc(b0 + kk * 2048, BOX, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    if (t > 0 && wtid == 0) mbar_arrive(&empty[(t - 1) % DW_STAGES]);
  }
  if (!active) return;
  wgmma_wait<0>();

  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  float* out = partial + ((size_t)(layer * splits + split) * H + m0 + 64 * wg) * H;
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      *reinterpret_cast<float2*>(out + (size_t)r * H + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

// out[g][e] = sum over k of part[g][k][e], in k order (float4 elements, n4
// per part): dsw from the dW kernel's splits, dbase from the chain blocks'
// partials.
__global__ void ordered_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                   int groups, int parts, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= groups * n4) return;
  const int grp = i / n4, e = i - grp * n4;
  const float4* p = part + (size_t)grp * parts * n4 + e;
  float4 s = p[0];
#pragma unroll 8
  for (int k = 1; k < parts; ++k) {
    const float4 v = p[(size_t)k * n4];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[i] = s;
}

cudaError_t smem_limit(int& limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Patches a chain block takes in turn, adding their dbase terms into one
// partial: up to 4 while the grid keeps at least 4 waves of blocks over the
// SMs (fewer partials to write and sum; fewer waves would leave SMs idle at
// the end).
int chain_group(int B, int S) {
  const long long k = (long long)B * ((S + TM - 1) / TM) / (4LL * sm_count());
  return (int)(k < 1 ? 1 : k > 4 ? 4 : k);
}

// splits of the rows of dW's product: about one block per SM in all
int dw_splits(int B, int S, int H, int L) {
  const int per_split = (L - 1) * ((H + 127) / 128);
  const long long ktiles = (long long)B * ((S + TM - 1) / TM);
  long long s = sm_count() / per_split;
  if (s < 1) s = 1;
  if (s > ktiles) s = ktiles;
  return (int)s;
}

template <int H, int DEG, bool MORLET>
cudaError_t launch(Args args, const void* sw, const void* swt, void* work, float* partial,
                   float* dsw, float* dbase, cudaStream_t stream) {
  const int L = args.L, B = args.B, S = args.S;
  CUtensorMap w_map, wt_map, ws_map;
  const uint64_t wdims[2] = {(uint64_t)H, (uint64_t)(L - 1) * H};
  const uint64_t sdims[3] = {(uint64_t)H, (uint64_t)S, (uint64_t)2 * (L - 1) * B};
  if (!bf16_map(&w_map, sw, 2, wdims) || !bf16_map(&wt_map, swt, 2, wdims) ||
      !bf16_map(&ws_map, work, 3, sdims))
    return cudaErrorNotSupported;

  int limit = 0;
  cudaError_t err = smem_limit(limit);
  if (err != cudaSuccess) return err;
  args.stages = 4;
  // thread 0 loads a product's slabs at the end of the one before, so the
  // ring holds at least one product
  while (args.stages > Chain<H>::KB && Chain<H>::smem_bytes(L, args.stages) > (size_t)limit)
    --args.stages;
  const size_t smem = Chain<H>::smem_bytes(L, args.stages);
  if (smem > (size_t)limit || Dw<H>::SMEM > (size_t)limit) return cudaErrorInvalidConfiguration;
  // the shared-memory ceilings, raised once per instantiation at its first
  // use: a launch inside a CUDA graph's capture then puts nothing but the
  // kernels on the stream
  static const cudaError_t raised_chain = cudaFuncSetAttribute(
      chain_kernel<H, DEG, MORLET>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (raised_chain != cudaSuccess) return raised_chain;
  static const cudaError_t raised_dw = cudaFuncSetAttribute(
      dw_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Dw<H>::SMEM);
  if (raised_dw != cudaSuccess) return raised_dw;
  args.group = chain_group(B, S);
  const int parts = (B + args.group - 1) / args.group;
  const long long blocks = (long long)parts * ((S + TM - 1) / TM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  chain_kernel<H, DEG, MORLET><<<(unsigned)blocks, CHAIN_BLOCK, smem, stream>>>(w_map, wt_map,
                                                                               args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int sh4 = S * H / 4;
  ordered_sum_kernel<<<(sh4 + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(args.dbase_part), reinterpret_cast<float4*>(dbase), 1,
      parts, sh4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int splits = dw_splits(B, S, H, L);
  dw_kernel<H><<<(L - 1) * ((H + 127) / 128) * splits, DW_THREADS, Dw<H>::SMEM, stream>>>(
      ws_map, partial, B, S, L, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n4 = (L - 1) * H * H / 4;
  ordered_sum_kernel<<<(n4 + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(dsw), L - 1, splits,
      H * H / 4);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_deg(const Args& args, int deg, const void* sw, const void* swt, void* work,
                       float* partial, float* dsw, float* dbase, cudaStream_t stream) {
  switch (deg) {
    case 5:
      return args.morlet ? launch<H, 5, true>(args, sw, swt, work, partial, dsw, dbase, stream)
                         : launch<H, 5, false>(args, sw, swt, work, partial, dsw, dbase, stream);
    case 9:
      return args.morlet ? launch<H, 9, true>(args, sw, swt, work, partial, dsw, dbase, stream)
                         : launch<H, 9, false>(args, sw, swt, work, partial, dsw, dbase, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). Pointers are device pointers to
// contiguous tensors: sw (L-1, H, H) bf16 (in, out) and swt its per-layer
// transpose; work (2, L-1, B, S, H) bf16 and partial (L-1, splits, H, H)
// f32 (splits from siren_train_bwd_dw_splits) and dbase_part (parts, S, H)
// f32 (parts from siren_train_bwd_dbase_parts) scratch, overwritten; dsw (L-1, H, H) f32, dbase (S, H)
// f32 and part (B * tiles, 2*L*H + 4) f32, tiles = ceil(S / 64), written in
// full: per (patch, tile) its dmods (L*H), dsb ((L-1)*H), dlw (H) and dlb (1)
// partial sums. deg is 5 or 9.
extern "C" int siren_train_bwd_launch(const void* seed, const void* mods, const void* base,
                                      const void* sw, const void* swt, const void* sb,
                                      const void* last_w, const void* last_b, const void* g,
                                      void* part, void* dbase, void* dbase_part, void* dsw,
                                      void* work, void* partial, int B, int S, int H, int L,
                                      float w0, int morlet, int deg, int dropout, int thresh,
                                      float inv_keep, void* stream) {
  if (B <= 0 || S <= 0 || L < 2) return (int)cudaErrorInvalidValue;
  Args args{static_cast<const float*>(seed),
            static_cast<const float*>(mods),
            static_cast<const float*>(base),
            static_cast<const float*>(sb),
            static_cast<const float*>(last_w),
            static_cast<const float*>(last_b),
            static_cast<const float*>(g),
            static_cast<float*>(part),
            static_cast<float*>(dbase_part),
            static_cast<__nv_bfloat16*>(work),
            B,
            S,
            L,
            w0,
            morlet,
            (int32_t)thresh,
            inv_keep,
            dropout,
            4,
            1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* dw_part = static_cast<float*>(partial);
  auto* dw = static_cast<float*>(dsw);
  auto* db = static_cast<float*>(dbase);
  switch (H) {
    case 64: return (int)launch_deg<64>(args, deg, sw, swt, work, dw_part, dw, db, st);
    case 128: return (int)launch_deg<128>(args, deg, sw, swt, work, dw_part, dw, db, st);
    case 192: return (int)launch_deg<192>(args, deg, sw, swt, work, dw_part, dw, db, st);
    case 256: return (int)launch_deg<256>(args, deg, sw, swt, work, dw_part, dw, db, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int siren_train_bwd_dw_splits(int B, int S, int H, int L) {
  return dw_splits(B, S, H, L);
}

extern "C" int siren_train_bwd_dbase_parts(int B, int S) {
  const int group = chain_group(B, S);
  return (B + group - 1) / group;
}

extern "C" const char* siren_train_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int siren_train_bwd_tile_rows() { return TM; }
