// Fused modulated-SIREN TRAINING backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mri_inr_tpu/ops/siren_train_kernel.py:_bwd_kernel. Given the forward's
// inputs and the cotangent g (B, S) of its output, it recomputes the forward
// chain (siren_train_fwd.cu) keeping the bf16 layer inputs x_0 .. x_{L-2} of
// its row tile in shared memory, then walks the chain in reverse. With
// drop_i the layer-i dropout mask regenerated from the seed, act / dact the
// activation and its derivative (dact = w0 * cos_poly(w0 * p), or
// env * (w0 * cos - p * sin) for Morlet):
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
//                dbase   += drop_0(dx * mod_0)
//
// Every product of the TPU kernel's body is computed here with mma.sync
// m16n8k16 (bf16 inputs, f32 accumulation).
//
// What bounds it: the gradient needs three H x H products per hidden layer
// and row (the forward's, dW and dx), 6 * B * S * H^2 * (L-1) bf16
// tensor-core operations (3.6e11 at B=400, S=576, H=256, L=5); the bytes are
// far below that. Because no activation is kept between forward and
// backward, this kernel executes 4(L-1) - 1 products (15 at L=5): L-1 in the
// recomputed forward, L-2 for `pre` again (the last hidden product is
// shared), L-1 for dW and L-1 for dx.
//
// Design (simple and correct first):
// - one block per (patch, 64-row tile of S), 8 warps, one block per SM: the
//   tile's L-1 stored layer inputs and the bf16(dpre) tile take
//   L * 64 * (H + 8) * 2 bytes (168,960 at H=256, L=5), the weight ring
//   2 * 20,480, the per-patch rows ~15 KB: 226 KB of the 227 KB a block may
//   use. The last layer input x_{L-1} never leaves registers: the last
//   hidden product of the recomputed forward is also the first `pre` of the
//   reverse sweep, so it is not computed twice;
// - products 1 and 3 stream W_i through a 2-stage cp.async ring: product 1
//   as 32-row slabs (ldmatrix.trans, as in the forward), product 3 as
//   32-column slabs of all H rows, because dx contracts with W_i^T and the
//   B operand is then read untransposed. Their accumulators share one
//   (row, column) layout (a warp owns 32 rows x H/4 columns), so `pre` and
//   `dx` meet element by element in registers: 128 accumulators a thread;
// - product 2 contracts over the tile's rows: x_i is read transposed from
//   shared memory (ldmatrix.trans on the A operand); a warp owns 32 rows of
//   dW_i and walks it in 64-column chunks. dW_i (H x H f32) fits neither
//   registers nor shared memory across tiles and blocks run in no order,
//   so each chunk is added to the zeroed global buffer with 8-byte
//   atomicAdd(float2) (red.global.add.v2.f32 on sm_90);
// - dsb, dlw, dlb and dbase are likewise reduced with atomics after a warp
//   shuffle reduction; the per-patch dmods sum over the tile's rows is
//   reduced in shared memory and written to a (B, tiles, L*H) buffer that
//   the wrapper sums over tiles, so dmods repeats bit for bit while the
//   weight-space gradients depend on the order of the atomics. Finishing
//   dmods in the kernel measured slower than that 9-term sum: a counter per
//   patch whose last block adds the partials needs a __threadfence() behind
//   the dW atomics, and atomics into dmods lose the repeatability.
//
// Rows past S in the last tile carry g = 0 and zero x_0, so they add exact
// zeros everywhere and are never stored.

#include "siren_common.cuh"

namespace {

using namespace siren;

constexpr int TM = 64;        // rows of S per block
constexpr int KS = 32;        // weight rows (or columns) per pipeline stage
constexpr int STAGES = 2;     // cp.async ring depth
constexpr int THREADS = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int PAD = 8;        // bf16 padding per shared row (16 bytes)
constexpr int CLDS = KS + PAD;  // row stride of a column slab

struct Args {
  const float* seed;           // (1,) f32 holding an integer
  const float* mods;           // (B, L*H) f32
  const float* base;           // (S, H) f32
  const __nv_bfloat16* sw;     // (L-1, H, H) bf16, (in, out) per layer
  const float* sb;             // (L-1, H) f32
  const float* last_w;         // (H,) f32
  const float* last_b;         // (1,) f32
  const float* g;              // (B, S) f32
  float* dmods_part;           // (B, tiles, L*H) f32, every element written
  float* dbase;                // (S, H) f32, zeroed by the caller
  float* dsw;                  // (L-1, H, H) f32, zeroed
  float* dsb;                  // (L-1, H) f32, zeroed
  float* dlw;                  // (H,) f32, zeroed
  float* dlb;                  // (1,) f32, zeroed
  int S;
  int L;
  float w0;
  int morlet;
  int32_t thresh;
  float inv_keep;
  int dropout;
};

template <int H>
__host__ __device__ constexpr int row_stride() {
  return H + PAD;
}

template <int H>
__host__ __device__ constexpr int stage_elems() {
  return KS * row_stride<H>() > H * CLDS ? KS * row_stride<H>() : H * CLDS;
}

// Bytes of dynamic shared memory for width H and depth L.
template <int H>
size_t smem_bytes(int L) {
  return sizeof(__nv_bfloat16) *
             ((size_t)L * TM * row_stride<H>() + (size_t)STAGES * stage_elems<H>()) +
         sizeof(float) * ((size_t)2 * L * H + (size_t)(L - 1) * H + H + 5 * TM);
}

// act(p) and dact(p) together: they share the range-reduced argument's
// polynomial pair and, for Morlet, the envelope.
template <int DEG>
__device__ __forceinline__ void act_pair(float p, float w0, int morlet, float& a, float& da) {
  const float z = w0 * p;
  const float s = poly_sin<DEG>(z), c = poly_cos<DEG>(z);
  if (morlet) {
    const float env = expf(-0.5f * (p * p));
    a = s * env;
    da = env * (w0 * c - p * s);
  } else {
    a = s;
    da = w0 * c;
  }
}

template <int DEG>
__device__ __forceinline__ float act_only(float p, float w0, int morlet) {
  float a = poly_sin<DEG>(w0 * p);
  if (morlet) a *= expf(-0.5f * (p * p));
  return a;
}

// rows k0 .. k0+KS of W (H x H, row-major) -> stage[KS][H + PAD]
template <int H>
__device__ __forceinline__ void load_row_slab(__nv_bfloat16* stage, const __nv_bfloat16* w,
                                              int slab, int tid) {
  constexpr int CHUNKS_PER_ROW = H / 8;  // 16-byte chunks
  const __nv_bfloat16* src = w + (size_t)slab * KS * H;
  for (int c = tid; c < KS * CHUNKS_PER_ROW; c += THREADS) {
    const int r = c / CHUNKS_PER_ROW, col = (c % CHUNKS_PER_ROW) * 8;
    cp_async16(stage + r * row_stride<H>() + col, src + (size_t)r * H + col);
  }
}

// columns n0 .. n0+KS of every row of W -> stage[H][KS + PAD]
template <int H>
__device__ __forceinline__ void load_col_slab(__nv_bfloat16* stage, const __nv_bfloat16* w,
                                              int slab, int tid) {
  constexpr int CHUNKS_PER_ROW = KS / 8;
  const __nv_bfloat16* src = w + (size_t)slab * KS;
  for (int c = tid; c < H * CHUNKS_PER_ROW; c += THREADS) {
    const int r = c / CHUNKS_PER_ROW, col = (c % CHUNKS_PER_ROW) * 8;
    cp_async16(stage + r * CLDS + col, src + (size_t)r * H + col);
  }
}

template <int H>
struct Tile {
  static constexpr int LDS = row_stride<H>();
  static constexpr int WN = H / 4;   // columns per warp
  static constexpr int NT = WN / 8;  // n-tiles of 8 per warp
  static constexpr int NSLAB = H / KS;
  static constexpr int STAGE = stage_elems<H>();
};

// acc = a_s (TM x H, bf16 in shared memory) @ W, or @ W^T when TRANS.
// Starts and ends with the ring idle; the leading barrier also publishes
// whatever the caller wrote to a_s.
template <int H, bool TRANS>
__device__ __forceinline__ void product(float (&acc)[2][Tile<H>::NT][4],
                                        const __nv_bfloat16* a_s, const __nv_bfloat16* w,
                                        __nv_bfloat16* ws, int tid) {
  using T = Tile<H>;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  __syncthreads();  // a_s written, ring free
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (TRANS) load_col_slab<H>(ws + s * T::STAGE, w, s, tid);
    else load_row_slab<H>(ws + s * T::STAGE, w, s, tid);
    cp_async_commit();
  }
  for (int slab = 0; slab < T::NSLAB; ++slab) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab arrived for all threads; the other stage is free
    {
      const int next = slab + STAGES - 1;
      if (next < T::NSLAB) {
        if (TRANS) load_col_slab<H>(ws + (next % STAGES) * T::STAGE, w, next, tid);
        else load_row_slab<H>(ws + (next % STAGES) * T::STAGE, w, next, tid);
      }
      cp_async_commit();
    }
    const __nv_bfloat16* wst = ws + (slab % STAGES) * T::STAGE;
    const int kbase = slab * KS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp_m * 32 + mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], a_s + r * T::LDS + kbase + kk + 8 * (lane >> 4));
      }
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t bfr[4];
        const int n0 = warp_n * T::WN + np * 16;
        if (TRANS) {
          // stage[out column][contraction]: untransposed 8x8 blocks
          ldmatrix_x4(bfr, wst + (n0 + (lane & 7) + 8 * (lane >> 4)) * CLDS + kk +
                               8 * ((lane >> 3) & 1));
        } else {
          ldmatrix_x4_trans(bfr, wst + (kk + (lane & 15)) * T::LDS + n0 + 8 * (lane >> 4));
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// p[0] += a, p[1] += b in global memory; p is 8-byte aligned. One vector
// reduction on sm_90 (atomicAdd on float2 compiles to red.global.add.v2.f32
// when the result is unused).
__device__ __forceinline__ void add2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// dW (H x H f32, global) += x_s^T @ p_s, both TM x H bf16 in shared memory.
template <int H>
__device__ __forceinline__ void weight_grad(float* dw, const __nv_bfloat16* x_s,
                                            const __nv_bfloat16* p_s, int tid) {
  using T = Tile<H>;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m_base = warp * 32;  // this warp's rows of dW
  if (m_base >= H) return;
  for (int chunk = 0; chunk < H / 64; ++chunk) {
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TM; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A = x^T: 8x8 blocks stored [tile row][hidden], read transposed
        const int m0 = m_base + mt * 16;
        ldmatrix_x4_trans(a[mt], x_s + (kk + (lane & 7) + 8 * (lane >> 4)) * T::LDS + m0 +
                                     8 * ((lane >> 3) & 1));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        const int n0 = chunk * 64 + np * 16;
        ldmatrix_x4_trans(bfr, p_s + (kk + (lane & 15)) * T::LDS + n0 + 8 * (lane >> 4));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], bfr[2], bfr[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m_base + mt * 16 + g + 8 * half;
          const int n = chunk * 64 + nt * 8 + 2 * t;
          add2(dw + (size_t)m * H + n, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
  }
}

// sum over the 8 lanes that share a column pair (same t, all g)
__device__ __forceinline__ float reduce_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

template <int H, int DEG>
__global__ void __launch_bounds__(THREADS, 1) siren_train_bwd_kernel(Args args) {
  static_assert(H % 64 == 0 && H <= 256, "H must be a multiple of 64, at most 256");
  using T = Tile<H>;
  constexpr int LDS = T::LDS;
  constexpr int WN = T::WN;
  constexpr int NT = T::NT;
  const int L = args.L;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // (L-1) x TM x LDS
  __nv_bfloat16* ps = xs + (size_t)(L - 1) * TM * LDS;         // TM x LDS: bf16(dpre)
  __nv_bfloat16* ws = ps + TM * LDS;                           // STAGES x STAGE
  float* mod_s = reinterpret_cast<float*>(ws + STAGES * T::STAGE);  // L x H
  float* dm_s = mod_s + L * H;                                      // L x H
  float* bias_s = dm_s + L * H;                                     // (L-1) x H
  float* lw_s = bias_s + (L - 1) * H;                               // H
  float* red_s = lw_s + H;                                          // 4 x TM
  float* dpl_s = red_s + 4 * TM;                                    // TM

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  const int tiles = (args.S + TM - 1) / TM;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int row0 = tile * TM;

  const Dropout dp{(uint32_t)(int)args.seed[0], args.thresh, args.inv_keep, args.dropout};
  const uint32_t idx0 = ((uint32_t)b * (uint32_t)args.S + (uint32_t)row0) * (uint32_t)H;

  const float* mrow = args.mods + (size_t)b * L * H;
  for (int i = tid; i < L * H; i += THREADS) {
    mod_s[i] = mrow[i];
    dm_s[i] = 0.f;
  }
  for (int i = tid; i < (L - 1) * H; i += THREADS) bias_s[i] = args.sb[i];
  for (int i = tid; i < H; i += THREADS) lw_s[i] = args.last_w[i];
  __syncthreads();

  // x_0 = bf16(drop_0(base) * mod_0); rows past S are zero
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

  float acc[2][NT][4];  // pre of the current layer (without its bias)
  float dxr[2][NT][4];  // dx, same (row, column) layout

  // ---- recomputed forward: x_1 .. x_{L-2} to shared memory ----
  for (int layer = 0; layer < L - 2; ++layer) {
    product<H, false>(acc, xs + (size_t)layer * TM * LDS, args.sw + (size_t)layer * H * H, ws,
                      tid);
    const float* bias = bias_s + layer * H;
    const float* mod = mod_s + (layer + 1) * H;
    const uint32_t off = layer_offset(dp, layer + 1);
    __nv_bfloat16* xn = xs + (size_t)(layer + 1) * TM * LDS;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = warp_n * WN + nt * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp_m * 32 + mt * 16 + g + 8 * half;
          const uint32_t e = idx0 + (uint32_t)(r * H + c);
          const float a0 = act_only<DEG>(acc[mt][nt][2 * half] + bias[c], args.w0, args.morlet);
          const float a1 =
              act_only<DEG>(acc[mt][nt][2 * half + 1] + bias[c + 1], args.w0, args.morlet);
          *reinterpret_cast<__nv_bfloat162*>(xn + r * LDS + c) = __floats2bfloat162_rn(
              __fmul_rn(drop(dp, a0, e, off), mod[c]),
              __fmul_rn(drop(dp, a1, e + 1, off), mod[c + 1]));
        }
      }
  }

  // ---- last hidden product: pre_{L-1} stays in acc for the reverse sweep ----
  product<H, false>(acc, xs + (size_t)(L - 2) * TM * LDS, args.sw + (size_t)(L - 2) * H * H, ws,
                    tid);
  {
    const float* bias = bias_s + (L - 2) * H;
    const float* mod = mod_s + (L - 1) * H;
    const uint32_t off = layer_offset(dp, L - 1);
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = warp_n * WN + nt * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp_m * 32 + mt * 16 + g + 8 * half;
          const uint32_t e = idx0 + (uint32_t)(r * H + c);
          const float a0 = act_only<DEG>(acc[mt][nt][2 * half] + bias[c], args.w0, args.morlet);
          const float a1 =
              act_only<DEG>(acc[mt][nt][2 * half + 1] + bias[c + 1], args.w0, args.morlet);
          // x_{L-1}, rounded to bf16 as the forward does, kept as f32
          const float x0 = bf16_round(__fmul_rn(drop(dp, a0, e, off), mod[c]));
          const float x1 = bf16_round(__fmul_rn(drop(dp, a1, e + 1, off), mod[c + 1]));
          dxr[mt][nt][2 * half] = x0;
          dxr[mt][nt][2 * half + 1] = x1;
          part[mt][half] += x0 * lw_s[c] + x1 * lw_s[c + 1];
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
    if (tid < TM) {
      float dpl = 0.f;
      if (row0 + tid < args.S) {
        const float r = red_s[tid] + red_s[TM + tid] + red_s[2 * TM + tid] +
                        red_s[3 * TM + tid] + args.last_b[0];
        dpl = args.g[(size_t)b * args.S + row0 + tid] *
              (args.w0 * poly_cos<DEG>(args.w0 * r));
      }
      dpl_s[tid] = dpl;
      // dlb: TM threads are warps 0 and 1, whole warps
      float s = dpl;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) atomicAdd(args.dlb, s);
    }
    __syncthreads();
    // dlw += sum_rows dpl * x_{L-1};  dx = dpl (x) last_w
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = warp_n * WN + nt * 8 + 2 * t;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float dpl = dpl_s[warp_m * 32 + mt * 16 + g + 8 * half];
          s0 += dpl * dxr[mt][nt][2 * half];
          s1 += dpl * dxr[mt][nt][2 * half + 1];
          dxr[mt][nt][2 * half] = dpl * lw_s[c];
          dxr[mt][nt][2 * half + 1] = dpl * lw_s[c + 1];
        }
      s0 = reduce_rows(s0);
      s1 = reduce_rows(s1);
      if (g == 0) {
        atomicAdd(args.dlw + c, s0);
        atomicAdd(args.dlw + c + 1, s1);
      }
    }
  }

  // ---- reverse sweep over the hidden layers ----
  for (int i = L - 2; i >= 0; --i) {
    const __nv_bfloat16* xi = xs + (size_t)i * TM * LDS;
    const __nv_bfloat16* wi = args.sw + (size_t)i * H * H;
    if (i < L - 2) product<H, false>(acc, xi, wi, ws, tid);  // pre_{i+1} again

    const float* bias = bias_s + i * H;
    const float* mod = mod_s + (i + 1) * H;
    const uint32_t off = layer_offset(dp, i + 1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = warp_n * WN + nt * 8 + 2 * t;
      float dm0 = 0.f, dm1 = 0.f, db0 = 0.f, db1 = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp_m * 32 + mt * 16 + g + 8 * half;
          const uint32_t e = idx0 + (uint32_t)(r * H + c);
          float a0, a1, da0, da1;
          act_pair<DEG>(acc[mt][nt][2 * half] + bias[c], args.w0, args.morlet, a0, da0);
          act_pair<DEG>(acc[mt][nt][2 * half + 1] + bias[c + 1], args.w0, args.morlet, a1, da1);
          const float dx0 = dxr[mt][nt][2 * half], dx1 = dxr[mt][nt][2 * half + 1];
          dm0 += dx0 * drop(dp, a0, e, off);
          dm1 += dx1 * drop(dp, a1, e + 1, off);
          const float dp0 = drop(dp, dx0 * mod[c], e, off) * da0;
          const float dp1 = drop(dp, dx1 * mod[c + 1], e + 1, off) * da1;
          db0 += dp0;
          db1 += dp1;
          *reinterpret_cast<__nv_bfloat162*>(ps + r * LDS + c) = __floats2bfloat162_rn(dp0, dp1);
        }
      dm0 = reduce_rows(dm0);
      dm1 = reduce_rows(dm1);
      db0 = reduce_rows(db0);
      db1 = reduce_rows(db1);
      if (g == 0) {
        atomicAdd(dm_s + (i + 1) * H + c, dm0);
        atomicAdd(dm_s + (i + 1) * H + c + 1, dm1);
        atomicAdd(args.dsb + i * H + c, db0);
        atomicAdd(args.dsb + i * H + c + 1, db1);
      }
    }
    // product() starts with a barrier, which publishes ps for both uses
    product<H, true>(dxr, ps, wi, ws, tid);
    weight_grad<H>(args.dsw + (size_t)i * H * H, xi, ps, tid);
    // the next step's product() barrier keeps ps until every warp is here
  }

  // ---- layer 0: dmods[0] and dbase ----
  {
    const uint32_t off = layer_offset(dp, 0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = warp_n * WN + nt * 8 + 2 * t;
      float dm0 = 0.f, dm1 = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp_m * 32 + mt * 16 + g + 8 * half;
          if (row0 + r >= args.S) continue;  // dx is zero there
          const uint32_t e = idx0 + (uint32_t)(r * H + c);
          const float2 bv =
              *reinterpret_cast<const float2*>(args.base + (size_t)(row0 + r) * H + c);
          const float dx0 = dxr[mt][nt][2 * half], dx1 = dxr[mt][nt][2 * half + 1];
          dm0 += dx0 * drop(dp, bv.x, e, off);
          dm1 += dx1 * drop(dp, bv.y, e + 1, off);
          add2(args.dbase + (size_t)(row0 + r) * H + c, drop(dp, dx0 * mod_s[c], e, off),
               drop(dp, dx1 * mod_s[c + 1], e + 1, off));
        }
      dm0 = reduce_rows(dm0);
      dm1 = reduce_rows(dm1);
      if (g == 0) {
        atomicAdd(dm_s + c, dm0);
        atomicAdd(dm_s + c + 1, dm1);
      }
    }
  }
  __syncthreads();
  float* dst = args.dmods_part + ((size_t)b * tiles + tile) * L * H;
  for (int i = tid; i < L * H; i += THREADS) dst[i] = dm_s[i];
}

template <int H, int DEG>
cudaError_t launch(const Args& args, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<H>(args.L);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)limit) return cudaErrorInvalidConfiguration;  // too many layers
  err = cudaFuncSetAttribute(siren_train_bwd_kernel<H, DEG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((args.S + TM - 1) / TM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  siren_train_bwd_kernel<H, DEG><<<(unsigned)blocks, THREADS, smem, stream>>>(args);
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

// Returns a cudaError_t (0 = launched; cudaErrorInvalidConfiguration when
// L layer tiles of width H do not fit a block's shared memory). Pointers are
// device pointers to contiguous tensors; dbase, dsw, dsb, dlw and dlb must
// be zero on entry (the kernel adds to them); dmods_part is (B, tiles, L*H)
// with tiles = ceil(S / 64) and is written in full. deg is 5 or 9.
extern "C" int siren_train_bwd_launch(const void* seed, const void* mods, const void* base,
                                      const void* sw, const void* sb, const void* last_w,
                                      const void* last_b, const void* g, void* dmods_part,
                                      void* dbase, void* dsw, void* dsb, void* dlw, void* dlb,
                                      int B, int S, int H, int L, float w0, int morlet,
                                      int deg, int dropout, int thresh, float inv_keep,
                                      void* stream) {
  if (B <= 0 || S <= 0 || L < 2) return (int)cudaErrorInvalidValue;
  Args args{static_cast<const float*>(seed),
            static_cast<const float*>(mods),
            static_cast<const float*>(base),
            static_cast<const __nv_bfloat16*>(sw),
            static_cast<const float*>(sb),
            static_cast<const float*>(last_w),
            static_cast<const float*>(last_b),
            static_cast<const float*>(g),
            static_cast<float*>(dmods_part),
            static_cast<float*>(dbase),
            static_cast<float*>(dsw),
            static_cast<float*>(dsb),
            static_cast<float*>(dlw),
            static_cast<float*>(dlb),
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

extern "C" const char* siren_train_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int siren_train_bwd_tile_rows() { return TM; }
