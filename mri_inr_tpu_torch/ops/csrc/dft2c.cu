// Centred orthonormal 2-D (i)DFT as a two-pass mixed-radix FFT, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel mri_inr_tpu/ops/fft_kernel.py:_kernel
// (launched by dft2c_ri). Per slice:
//
//   Y = fftshift((i)fft2(ifftshift(X), norm="ortho"))
//   out = Y  or  |Y| = sqrt(yr^2 + yi^2)
//
// The TPU kernel computes Y as dense products A_H . X . A_W^T because the
// MXU cannot run butterflies. An SM can, in shared memory, so this kernel
// runs an FFT: O(log n) work per element where the products did O(H + W).
//
// What bounds it: the function reads its input once (N*H*W*8 bytes) and
// writes its output once (N*H*W*4 with the magnitude): 39.3 MB at one
// fastMRI brain volume (16 x 640 x 320), 0.0117 ms at 3.35 TB/s; its
// operations, 5*N*HW*log2(HW) = 2.9e8 f32 FLOP, take 0.0043 ms at the f32
// rate. So bytes bound it. The design moves the slice through device memory
// twice (pass 1 writes a workspace that pass 2 reads: about 92 MB in all at
// that shape, less where the 26 MB workspace stays in the 50 MB L2). The
// arithmetic is f32 fmaf on the CUDA cores: the contract is 2e-5 against the
// FFT, which TF32 products could not hold.
//
// Design (two launches on one stream, one wrapper call):
// - pass 1, along W: a block takes ROWS consecutive rows of the input (one
//   contiguous chunk, read with 16-byte loads when W is even); each element
//   lands in shared memory at its ifftshift position within the row. The
//   rows are transformed there and each is written to the workspace row
//   that the H axis's ifftshift sends it to, with the W axis's fftshift
//   folded into the store and the scale 1/sqrt(W);
// - pass 2, along H: a block takes a strip of COLS complex columns of one
//   slice (64-byte row segments), transforms the H-long columns in shared
//   memory and writes Y or |Y| (__fmul_rn / __fadd_rn / sqrtf, as the plain
//   version rounds) with the H axis's fftshift folded into the store and the
//   scale 1/sqrt(H);
// - each 1-D transform is a Stockham autosort FFT between two shared-memory
//   buffers, one stage per radix of the plan: radix 2, 3, 4, 5 and 8
//   butterflies are written out, any other prime p is a generic stage in
//   which a thread computes one output of a length-p DFT (so a prime length
//   costs what the dense products did on that axis, and nothing falls back);
// - the plan (radix list) and the f32 twiddle / root tables come from the
//   wrapper (ops/fft_kernel.py), built in float64 and cached per size and
//   direction; this file recomputes each stage's ns and table offset from
//   the radix list by the same rule. Twiddles are read through the read-only
//   cache.
//
// Built with nvcc into a shared library with a plain C interface; the
// Python wrapper checks every tensor and calls dft2c_launch through ctypes
// on PyTorch's current stream.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIM = 640;    // largest H or W (DFT_MAX_DIM in the wrapper)
constexpr int MAX_STAGES = 12;  // 2^9 < 640 needs at most 9 radix-2 stages
constexpr int THREADS = 256;
constexpr int ROWS = 8;  // pass 1: rows per block
constexpr int COLS = 8;  // pass 2: complex columns per block

// pass 1's row stride in shared memory: W elements and one pad every 8
__host__ __device__ constexpr int row_stride(int w) { return w + w / 8 + 1; }

struct Plan {
  int n;
  int stages;
  int radix[MAX_STAGES];
  int ns[MAX_STAGES];   // product of the earlier stages' radices
  int off[MAX_STAGES];  // offset of the stage's twiddles in the table
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cscale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * (sign * i): the quarter turn of the direction's root
template <bool INV>
__device__ __forceinline__ float2 rot(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// In-register length-R DFT with w = exp(sign * 2 pi i / R), sign = +1 for
// the inverse.
template <int R, bool INV>
struct Dft;

template <bool INV>
struct Dft<2, INV> {
  __device__ __forceinline__ static void run(float2 (&v)[2]) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  }
};

template <bool INV>
struct Dft<4, INV> {
  __device__ __forceinline__ static void run(float2 (&v)[4]) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = rot<INV>(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[1] = cadd(t1, t3);
    v[2] = csub(t0, t2);
    v[3] = csub(t1, t3);
  }
};

template <bool INV>
struct Dft<8, INV> {
  __device__ __forceinline__ static void run(float2 (&v)[8]) {
    constexpr float C = 0.70710678118654752f;  // cos(pi/4)
    float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
    Dft<4, INV>::run(e);
    Dft<4, INV>::run(o);
    // o[q] *= w8^q, w8 = exp(sign * i pi / 4)
    const float s = INV ? 1.f : -1.f;
    o[1] = cscale(make_float2(o[1].x - s * o[1].y, o[1].y + s * o[1].x), C);
    o[2] = rot<INV>(o[2]);
    o[3] = cscale(make_float2(-o[3].x - s * o[3].y, -o[3].y + s * o[3].x), C);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = cadd(e[q], o[q]);
      v[q + 4] = csub(e[q], o[q]);
    }
  }
};

template <bool INV>
struct Dft<3, INV> {
  __device__ __forceinline__ static void run(float2 (&v)[3]) {
    constexpr float S3 = 0.86602540378443865f;  // sin(2 pi / 3)
    const float2 t = cadd(v[1], v[2]);
    const float2 u = rot<INV>(cscale(csub(v[1], v[2]), S3));
    const float2 m = make_float2(v[0].x - 0.5f * t.x, v[0].y - 0.5f * t.y);
    v[0] = cadd(v[0], t);
    v[1] = cadd(m, u);
    v[2] = csub(m, u);
  }
};

template <bool INV>
struct Dft<5, INV> {
  __device__ __forceinline__ static void run(float2 (&v)[5]) {
    constexpr float C1 = 0.30901699437494742f;   // cos(2 pi / 5)
    constexpr float C2 = -0.80901699437494742f;  // cos(4 pi / 5)
    constexpr float S1 = 0.95105651629515357f;   // sin(2 pi / 5)
    constexpr float S2 = 0.58778525229247313f;   // sin(4 pi / 5)
    const float2 a1 = cadd(v[1], v[4]), a2 = cadd(v[2], v[3]);
    const float2 b1 = csub(v[1], v[4]), b2 = csub(v[2], v[3]);
    const float2 m1 = make_float2(v[0].x + C1 * a1.x + C2 * a2.x, v[0].y + C1 * a1.y + C2 * a2.y);
    const float2 m2 = make_float2(v[0].x + C2 * a1.x + C1 * a2.x, v[0].y + C2 * a1.y + C1 * a2.y);
    const float2 n1 = rot<INV>(make_float2(S1 * b1.x + S2 * b2.x, S1 * b1.y + S2 * b2.y));
    const float2 n2 = rot<INV>(make_float2(S2 * b1.x - S1 * b2.x, S2 * b1.y - S1 * b2.y));
    v[0] = cadd(v[0], cadd(a1, a2));
    v[1] = cadd(m1, n1);
    v[4] = csub(m1, n1);
    v[2] = cadd(m2, n2);
    v[3] = csub(m2, n2);
  }
};

// A shared-memory batch of `lines` vectors of length n: element e of line l
// at buf[l * ls + e * es + (e / 8) * pad]. The padding keeps a stage's
// strided writes (stride R elements when ns = 1) off a few banks: pass 1
// pads a row by one element every 8, pass 2 strides its 8 columns by 9.
// LINE_FAST: consecutive threads take consecutive lines (pass 2, columns
// side by side), else consecutive elements.
struct Lines {
  int n, lines, ls, es, pad;
  __device__ __forceinline__ int at(int l, int e) const { return l * ls + e * es + (e >> 3) * pad; }
};

template <bool LINE_FAST>
__device__ __forceinline__ void split_item(int t, int per_line, int lines, int& l, int& j) {
  if (LINE_FAST) {
    l = t % lines;
    j = t / lines;
  } else {
    l = t / per_line;
    j = t - l * per_line;
  }
}

// One Stockham stage with a written-out radix-R butterfly.
template <int R, bool INV, bool LINE_FAST>
__device__ __forceinline__ void stage(const float2* in, float2* out, const Lines& g, int ns,
                                     const float2* __restrict__ tw, int tid) {
  const int m = g.n / R;
  for (int t = tid; t < g.lines * m; t += THREADS) {
    int l, j;
    split_item<LINE_FAST>(t, m, g.lines, l, j);
    const int k = j % ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = in[g.at(l, j + r * m)];
      if (r > 0) v[r] = cmul(v[r], __ldg(tw + r * ns + k));  // row r = 0 is 1
    }
    Dft<R, INV>::run(v);
    const int d = (j - k) * R + k;  // (j / ns) * ns * R + j % ns
#pragma unroll
    for (int r = 0; r < R; ++r) out[g.at(l, d + r * ns)] = v[r];
  }
}

// One Stockham stage of any radix R: a thread computes one output q of one
// length-R DFT, sum_r (in[j + r*m] * tw[r, k]) * root[(r * q) mod R].
template <bool LINE_FAST>
__device__ __forceinline__ void stage_generic(const float2* in, float2* out, const Lines& g,
                                              int R, int ns, const float2* __restrict__ tw,
                                              int tid) {
  const int m = g.n / R;
  const float2* root = tw + R * ns;
  for (int t = tid; t < g.lines * g.n; t += THREADS) {
    int l, o;
    split_item<LINE_FAST>(t, g.n, g.lines, l, o);
    const int q = o / m, j = o - q * m, k = j % ns;
    float2 acc = make_float2(0.f, 0.f);
    int rq = 0;
    for (int r = 0; r < R; ++r) {
      const float2 a = cmul(in[g.at(l, j + r * m)], __ldg(tw + r * ns + k));
      acc = cadd(acc, cmul(a, __ldg(root + rq)));
      rq += q;
      if (rq >= R) rq -= R;
    }
    out[g.at(l, (j - k) * R + k + q * ns)] = acc;
  }
}

// Runs every stage of the plan between buf0 (holding the input) and buf1;
// returns the buffer that holds the result. Ends with a barrier.
template <bool INV, bool LINE_FAST>
__device__ float2* run_fft(float2* buf0, float2* buf1, const Plan& p,
                           const float2* __restrict__ tab, const Lines& g, int tid) {
  float2 *in = buf0, *out = buf1;
  for (int s = 0; s < p.stages; ++s) {
    const int ns = p.ns[s];
    const float2* tw = tab + p.off[s];
    switch (p.radix[s]) {
      case 2: stage<2, INV, LINE_FAST>(in, out, g, ns, tw, tid); break;
      case 3: stage<3, INV, LINE_FAST>(in, out, g, ns, tw, tid); break;
      case 4: stage<4, INV, LINE_FAST>(in, out, g, ns, tw, tid); break;
      case 5: stage<5, INV, LINE_FAST>(in, out, g, ns, tw, tid); break;
      case 8: stage<8, INV, LINE_FAST>(in, out, g, ns, tw, tid); break;
      default: stage_generic<LINE_FAST>(in, out, g, p.radix[s], ns, tw, tid); break;
    }
    __syncthreads();
    float2* t = in;
    in = out;
    out = t;
  }
  return in;
}

// Pass 1: rows_total = N*H rows of W complex, ROWS per block.
template <bool INV>
__global__ void __launch_bounds__(THREADS) dft_rows_kernel(const float2* __restrict__ x,
                                                           float2* __restrict__ work, Plan pw,
                                                           const float2* __restrict__ tab,
                                                           int rows_total, int H, int W,
                                                           float scale) {
  extern __shared__ __align__(16) float2 sm[];
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, rows_total - g0);
  const int sw = W / 2, sh = H / 2;
  const Lines g{W, rows, row_stride(W), 1, 1};
  float2* b0 = sm;
  float2* b1 = sm + ROWS * g.ls;

  // load: input element (g0 + lr, c) -> b0[lr][(c - W/2) mod W]
  const float2* src = x + (size_t)g0 * W;
  if ((W & 1) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int half = W / 2;
    for (int i = tid; i < rows * half; i += THREADS) {
      const float4 v = __ldg(s4 + i);
      const int lr = i / half;
      int p = 2 * (i - lr * half) - sw;
      if (p < 0) p += W;
      b0[g.at(lr, p)] = make_float2(v.x, v.y);
      if (++p == W) p = 0;
      b0[g.at(lr, p)] = make_float2(v.z, v.w);
    }
  } else {
    for (int i = tid; i < rows * W; i += THREADS) {
      const int lr = i / W;
      int p = i - lr * W - sw;
      if (p < 0) p += W;
      b0[g.at(lr, p)] = __ldg(src + i);
    }
  }
  __syncthreads();
  const float2* z = run_fft<INV, false>(b0, b1, pw, tab, g, tid);

  // store: row h of slice n goes to workspace row (h - H/2) mod H; position
  // p of the row takes Z[(p - W/2) mod W]
  for (int i = tid; i < rows * W; i += THREADS) {
    const int lr = i / W, p = i - lr * W;
    const int row = g0 + lr, n = row / H;
    int h = row - n * H - sh;
    if (h < 0) h += H;
    int m = p - sw;
    if (m < 0) m += W;
    work[((size_t)n * H + h) * W + p] = cscale(z[g.at(lr, m)], scale);
  }
}

// Pass 2: strips of COLS columns of each slice of the workspace.
template <bool INV>
__global__ void __launch_bounds__(THREADS) dft_cols_kernel(const float2* __restrict__ work,
                                                           float* __restrict__ out, Plan ph,
                                                           const float2* __restrict__ tab,
                                                           int H, int W, float scale,
                                                           int magnitude) {
  extern __shared__ __align__(16) float2 sm[];
  const Lines g{H, COLS, 1, COLS + 1, 0};
  float2* b0 = sm;
  float2* b1 = sm + H * g.es;
  const int tid = threadIdx.x;
  const int strips = (W + COLS - 1) / COLS;
  const int n = blockIdx.x / strips;
  const int c0 = (blockIdx.x - n * strips) * COLS;
  const int cols = min(COLS, W - c0);
  const float2* src = work + (size_t)n * H * W + c0;

  if ((W & 1) == 0 && cols == COLS) {
    constexpr int PAIRS = COLS / 2;
    for (int i = tid; i < H * PAIRS; i += THREADS) {
      const int h = i / PAIRS, c = 2 * (i - h * PAIRS);
      const float4 v = *reinterpret_cast<const float4*>(src + (size_t)h * W + c);
      b0[g.at(c, h)] = make_float2(v.x, v.y);
      b0[g.at(c + 1, h)] = make_float2(v.z, v.w);
    }
  } else {
    for (int i = tid; i < H * COLS; i += THREADS) {
      const int h = i / COLS, c = i - h * COLS;
      b0[g.at(c, h)] = c < cols ? src[(size_t)h * W + c] : make_float2(0.f, 0.f);
    }
  }
  __syncthreads();
  const float2* z = run_fft<INV, true>(b0, b1, ph, tab, g, tid);

  // store: output row p takes Z[(p - H/2) mod H]
  const int sh = H / 2;
  for (int i = tid; i < H * COLS; i += THREADS) {
    const int p = i / COLS, c = i - p * COLS;
    if (c >= cols) continue;
    int m = p - sh;
    if (m < 0) m += H;
    const float2 v = cscale(z[g.at(c, m)], scale);
    const size_t o = ((size_t)n * H + p) * W + c0 + c;
    if (magnitude)
      out[o] = sqrtf(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
    else
      reinterpret_cast<float2*>(out)[o] = v;
  }
}

// The plan of length n from its radix list; false if the radices do not
// multiply to n or are too many.
bool make_plan(Plan& p, int n, const int* radix, int stages) {
  if (stages < 0 || stages > MAX_STAGES) return false;
  p.n = n;
  p.stages = stages;
  int ns = 1, off = 0;
  for (int s = 0; s < stages; ++s) {
    if (radix[s] < 2) return false;
    p.radix[s] = radix[s];
    p.ns[s] = ns;
    p.off[s] = off;
    off += radix[s] * ns + radix[s];
    ns *= radix[s];
  }
  return ns == n;
}

template <bool INV>
cudaError_t launch(const float2* x, const float2* tab_h, const float2* tab_w, float2* work,
                   float* out, int N, int H, int W, const Plan& ph, const Plan& pw,
                   int magnitude, cudaStream_t stream) {
  const int smem_max = (int)(sizeof(float2) * 2 * ROWS * row_stride(MAX_DIM));
  static_assert(ROWS * row_stride(MAX_DIM) >= (COLS + 1) * MAX_DIM, "pass 2 fits pass 1's bound");
  cudaError_t err = cudaFuncSetAttribute(dft_rows_kernel<INV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dft_cols_kernel<INV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_max);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)N * H;
  const long long blocks1 = (rows + ROWS - 1) / ROWS;
  const long long blocks2 = (long long)N * ((W + COLS - 1) / COLS);
  if (blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dft_rows_kernel<INV><<<(unsigned)blocks1, THREADS, sizeof(float2) * 2 * ROWS * row_stride(W), stream>>>(
      x, work, pw, tab_w, (int)rows, H, W, (float)(1.0 / sqrt((double)W)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dft_cols_kernel<INV><<<(unsigned)blocks2, THREADS, sizeof(float2) * 2 * (COLS + 1) * H, stream>>>(
      work, out, ph, tab_h, H, W, (float)(1.0 / sqrt((double)H)), magnitude);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched). Device pointers to contiguous f32
// tensors: x (N, H, W, 2), 16-byte aligned; tab_h / tab_w the twiddle and
// root tables of the plans of H and W (ops/fft_kernel.py:tables); work
// (N, H, W, 2), overwritten; out (N, H, W, 2) or, with magnitude, (N, H, W).
// radix_h / radix_w are host arrays of the plans' radices.
extern "C" int dft2c_launch(const void* x, const void* tab_h, const void* tab_w, void* work,
                            void* out, int N, int H, int W, const int* radix_h, int stages_h,
                            const int* radix_w, int stages_w, int inverse, int magnitude,
                            void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || H > MAX_DIM || W > MAX_DIM)
    return (int)cudaErrorInvalidValue;
  Plan ph, pw;
  if (!make_plan(ph, H, radix_h, stages_h) || !make_plan(pw, W, radix_w, stages_w))
    return (int)cudaErrorInvalidValue;
  const auto* xs = static_cast<const float2*>(x);
  const auto* th = static_cast<const float2*>(tab_h);
  const auto* tw = static_cast<const float2*>(tab_w);
  auto* ws = static_cast<float2*>(work);
  auto* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = inverse ? launch<true>(xs, th, tw, ws, o, N, H, W, ph, pw, magnitude, st)
                                  : launch<false>(xs, th, tw, ws, o, N, H, W, ph, pw, magnitude, st);
  return (int)err;
}

extern "C" const char* dft2c_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
