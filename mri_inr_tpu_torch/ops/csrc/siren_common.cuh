// Device code shared by the fused modulated-SIREN kernels (siren_forward.cu,
// siren_forward_int8.cu, siren_train_fwd.cu, siren_train_bwd.cu): the
// polynomial sines and cosines of ops/fast_math.py, the counter-hash dropout
// of ops/siren_train_kernel.py, and thin wrappers over the PTX the kernels
// are built from (cp.async, ldmatrix, mma.sync m16n8k16 bf16 -> f32 and
// m16n8k32 int8 -> int32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace siren {

constexpr float TWO_PI = 6.283185307179586f;
constexpr float INV_TWO_PI = 0.15915494309189535f;
constexpr float HALF_PI = 1.5707963267948966f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// v - 2pi * floor(v / 2pi + 0.5), rounded step by step as the reference
// does (no fused multiply-add), so both pick the same period.
__device__ __forceinline__ float reduce_range(float x) {
  float k = floorf(__fadd_rn(__fmul_rn(x, INV_TWO_PI), 0.5f));
  return __fsub_rn(x, __fmul_rn(TWO_PI, k));
}

__device__ __forceinline__ float sin9(float x) {
  float v = reduce_range(x), v2 = v * v;
  float p = -1.926507745066e-04f + v2 * 2.147913009143e-06f;
  p = 8.308990402314e-03f + v2 * p;
  p = -1.666243985636e-01f + v2 * p;
  p = 9.999793973572e-01f + v2 * p;
  return v * p;
}

__device__ __forceinline__ float sin7(float x) {
  float v = reduce_range(x), v2 = v * v;
  float p = 7.958186419379e-03f + v2 * -1.450852979995e-04f;
  p = -1.656675056348e-01f + v2 * p;
  p = 9.992763920561e-01f + v2 * p;
  return v * p;
}

__device__ __forceinline__ float sin5(float x) {
  float v = reduce_range(x), v2 = v * v;
  float p = -1.5347773e-01f + v2 * 5.4669000e-03f;
  p = 9.8444443e-01f + v2 * p;
  return v * p;
}

// The train kernels' sine / cosine pair: degree 5 or degree 9; the cosine
// is the same polynomial at x + pi/2 (fast_cos, fast_cos5).
template <int DEG>
__device__ __forceinline__ float poly_sin(float x) {
  return DEG == 5 ? sin5(x) : sin9(x);
}

template <int DEG>
__device__ __forceinline__ float poly_cos(float x) {
  return poly_sin<DEG>(__fadd_rn(x, HALF_PI));
}

// Counter-hash dropout: element idx of layer `layer` is kept when
// (int32)hash < thresh, where hash = m ^ (m >> 16), m = (idx + seed +
// layer * 1315423911) * 0x9E3779B1, all in 32-bit wraparound arithmetic.
// Kept values are scaled by 1/keep. The forward and the backward kernel
// regenerate the same mask from (seed, layer, idx); nothing is stored.
struct Dropout {
  uint32_t seed;
  int32_t thresh;
  float inv_keep;
  int on;
};

__device__ __forceinline__ uint32_t layer_offset(const Dropout& d, int layer) {
  return d.seed + (uint32_t)layer * 1315423911u;
}

__device__ __forceinline__ float drop(const Dropout& d, float v, uint32_t idx, uint32_t off) {
  if (!d.on) return v;
  uint32_t h = (idx + off) * 0x9E3779B1u;
  h ^= h >> 16;
  return (int32_t)h < d.thresh ? __fmul_rn(v, d.inv_keep) : 0.f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace siren
