// Centred orthonormal 2-D (i)DFT as two dense complex products, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel mri_inr_tpu/ops/fft_kernel.py:_kernel
// (launched by dft2c_ri). Per slice:
//
//   Y = A_H . X . A_W^T        (complex; A_n is the centred (i)DFT matrix)
//   out = Y  or  |Y| = sqrt(yr^2 + yi^2)
//
// X and Y interleave real and imaginary parts in their last axis and are
// read and written as float2, so the wrapper makes no split copies. Both
// matrices arrive interleaved too (the wrapper builds and caches them);
// A_W arrives transposed, so both products read their right-hand operand
// row by row. A is not assumed symmetric (it is not for odd n).
//
// What bounds it: 8 * N * H * W * (H + W) f32 operations (2.5e10 for one
// fastMRI brain volume, 16 x 640 x 320) against 44 MB of input, output and
// matrices: the operations, by a factor of about 30 at the f32 FMA rate.
// The products run as f32 fmaf on the CUDA cores: the contract is 2e-5
// against the FFT, and TF32 or bf16 tensor-core products keep three
// decimal digits. A split-TF32 scheme is later work.
//
// Design (one launch, no workspace in device memory; the TPU kernel keeps a
// whole slice and T = A_H . X in VMEM, which no block's shared memory can):
// - one block per (slice, strip of 16 output rows);
// - the block's 16 rows of A_H are loaded into shared memory;
// - phase 1: T[16, W] = A_H[rows, :] . X, each thread owning one column and
//   all 16 rows (32 accumulators), X streamed from device memory (the
//   slice's other strips read the same X, so it stays in L2), the A values
//   read as shared-memory broadcasts, two k at a time as one float4; T is
//   written to shared memory;
// - phase 2: Y[16, W] = T . A_W^T by the same routine, with T as the
//   broadcast operand and A_W^T streamed; the epilogue writes Y or |Y|;
// - odd and unequal sizes: rows past H are zero in the A strip and never
//   stored, columns are guarded by the column loop, an odd K gets a scalar
//   tail step.
//
// Built with nvcc into a shared library with a plain C interface; the
// Python wrapper (ops/fft_kernel.py) checks every tensor and calls
// dft2c_launch through ctypes on PyTorch's current stream.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 16;        // output rows per block
constexpr int THREADS = 256;
constexpr int MAX_DIM = 640;  // largest H or W (DFT_MAX_DIM in the wrapper)

__host__ __device__ constexpr int even(int n) { return n + (n & 1); }

__device__ __forceinline__ void cmadd(float2& acc, float sr, float si, float2 g) {
  acc.x = fmaf(sr, g.x, acc.x);
  acc.x = fmaf(-si, g.y, acc.x);
  acc.y = fmaf(sr, g.y, acc.y);
  acc.y = fmaf(si, g.x, acc.y);
}

// acc[r] = sum_k S[r, k] * G[k, c] for r < TM: S (TM x K, row stride lds,
// lds even) in shared memory, G (K x cols, row stride cols) in device memory.
__device__ __forceinline__ void strip_column(float2 (&acc)[TM], const float2* S, int lds,
                                             const float2* G, int K, int cols, int c) {
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = make_float2(0.f, 0.f);
  int k = 0;
#pragma unroll 4
  for (; k + 1 < K; k += 2) {
    const float2 g0 = __ldg(G + (size_t)k * cols + c);
    const float2 g1 = __ldg(G + (size_t)(k + 1) * cols + c);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float4 s = *reinterpret_cast<const float4*>(S + r * lds + k);
      cmadd(acc[r], s.x, s.y, g0);
      cmadd(acc[r], s.z, s.w, g1);
    }
  }
  if (k < K) {
    const float2 g0 = __ldg(G + (size_t)k * cols + c);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float2 s = S[r * lds + k];
      cmadd(acc[r], s.x, s.y, g0);
    }
  }
}

__global__ void __launch_bounds__(THREADS) dft2c_kernel(
    const float2* __restrict__ x,   // (N, H, W) complex
    const float2* __restrict__ a,   // (H, H) complex: A_H
    const float2* __restrict__ bt,  // (W, W) complex: A_W transposed
    float* __restrict__ out,        // (N, H, W, 2) or (N, H, W)
    int H, int W, int magnitude) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = even(H), ldt = even(W);
  float2* as = reinterpret_cast<float2*>(smem);  // TM x lda
  float2* ts = as + TM * lda;                    // TM x ldt

  const int tiles = (H + TM - 1) / TM;
  const int n = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * TM;
  const int tid = threadIdx.x;

  for (int i = tid; i < TM * lda; i += THREADS) {
    const int r = i / lda, k = i % lda;
    as[i] = (row0 + r < H && k < H) ? a[(size_t)(row0 + r) * H + k] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  float2 acc[TM];
  const float2* xs = x + (size_t)n * H * W;
  for (int c = tid; c < W; c += THREADS) {
    strip_column(acc, as, lda, xs, H, W, c);
#pragma unroll
    for (int r = 0; r < TM; ++r) ts[r * ldt + c] = acc[r];
  }
  if (tid < TM && (W & 1)) ts[tid * ldt + W] = make_float2(0.f, 0.f);
  __syncthreads();

  for (int c = tid; c < W; c += THREADS) {
    strip_column(acc, ts, ldt, bt, W, W, c);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      if (row0 + r >= H) break;
      const size_t o = ((size_t)n * H + row0 + r) * W + c;
      if (magnitude)
        out[o] = sqrtf(__fadd_rn(__fmul_rn(acc[r].x, acc[r].x), __fmul_rn(acc[r].y, acc[r].y)));
      else
        reinterpret_cast<float2*>(out)[o] = acc[r];
    }
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). Pointers are device pointers to
// contiguous f32 tensors: x (N, H, W, 2), a (H, H, 2), bt (W, W, 2), out
// (N, H, W, 2) or, with magnitude, (N, H, W).
extern "C" int dft2c_launch(const void* x, const void* a, const void* bt, void* out, int N,
                            int H, int W, int magnitude, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || H > MAX_DIM || W > MAX_DIM)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float2) * (size_t)TM * (even(H) + even(W));
  cudaError_t err = cudaFuncSetAttribute(dft2c_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(sizeof(float2) * TM * 2 * MAX_DIM));
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)N * ((H + TM - 1) / TM);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dft2c_kernel<<<(unsigned)blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(a),
      static_cast<const float2*>(bt), static_cast<float*>(out), H, W, magnitude);
  return (int)cudaGetLastError();
}

extern "C" const char* dft2c_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
