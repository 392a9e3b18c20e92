// Flax's dropout keep mask on the card: jax.random.bernoulli(key, keep, shape)
// per element, as mri_inr_tpu_torch/ops/dropout.py describes it and
// threefry_keep_mask_reference computes it.
//
// Replaces no Pallas kernel: the JAX package's module path draws these bits
// through XLA (flax/linen/stochastic.py Dropout -> jax/_src/random.py
// bernoulli -> uniform -> jax/_src/prng.py threefry_2x32 under
// jax_threefry_partitionable). The port's module path draws one mask per
// hidden layer and step, inside the graphed epoch, so the key is read from a
// device buffer that the host restages between replays, not passed by value.
//
// Element n (n + offset) is hashed as the counter (hi, lo) of its 64-bit
// index: 20 rounds of Threefry-2x32 with five key injections, in registers,
// rotations by __funnelshift_l; bits = x0 ^ x1; the float
// ((bits >> 9) | 0x3f800000) - 1 is compared < keep (float32). One byte a
// element is written, four elements a thread at a time as one 32-bit store.
//
// Bound: integer operations. Per element about 85 32-bit operations (20
// rounds of add, rotate and xor; 10 key-injection adds; the counter split,
// the float and the compare) against one byte written, so the H100's integer
// rate, not its memory, sets the pace; the design keeps everything in
// registers, loads nothing but the 8-byte key, and stores coalesced words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr uint32_t PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t k2,
                                                  uint64_t n) {
  uint32_t x0 = static_cast<uint32_t>(n >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(n) + k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef TF_ROUND

__device__ __forceinline__ uint32_t keep_byte(uint32_t k0, uint32_t k1, uint32_t k2,
                                              uint64_t n, float keep) {
  const uint32_t bits = threefry_bits(k0, k1, k2, n);
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return u < keep ? 1u : 0u;
}

__global__ void __launch_bounds__(THREADS)
threefry_keep_mask_kernel(const uint32_t* __restrict__ key, uint8_t* __restrict__ out,
                          long long numel, unsigned long long offset, float keep) {
  const uint32_t k0 = key[0], k1 = key[1];
  const uint32_t k2 = k0 ^ k1 ^ PARITY;
  const long long words = numel / PER_THREAD;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  uint32_t* out_words = reinterpret_cast<uint32_t*>(out);
  for (long long w = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; w < words;
       w += stride) {
    const uint64_t n = offset + static_cast<uint64_t>(w) * PER_THREAD;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) word |= keep_byte(k0, k1, k2, n + j, keep) << (8 * j);
    out_words[w] = word;
  }
  // the ragged tail, fewer than PER_THREAD elements, by the first threads
  const long long tail = words * PER_THREAD + static_cast<long long>(blockIdx.x) * THREADS +
                         threadIdx.x;
  if (tail < numel) out[tail] = static_cast<uint8_t>(keep_byte(k0, k1, k2, offset + tail, keep));
}

}  // namespace

extern "C" int threefry_keep_mask_launch(const void* key, void* out, long long numel,
                                         unsigned long long offset, float keep, void* stream) {
  if (numel <= 0 || key == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 4 != 0) return (int)cudaErrorMisalignedAddress;
  const long long words = numel / PER_THREAD;
  long long blocks = (words + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks an SM, grid-stride beyond
  threefry_keep_mask_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<uint8_t*>(out), numel, offset, keep);
  return (int)cudaGetLastError();
}

extern "C" const char* threefry_dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
