// Native host-side data-pipeline loops for mri_inr_tpu_torch (own copy of
// mri_inr_tpu/native/tileops.cpp; host code, not a device kernel).
//
// The data path's two memory-bound host loops: the start-up tiling of every
// slice into overlapping patches and the per-step random gather of ~400
// patch pairs per batch.
//
//   tile_f32:         reflect-pad + overlapping-window extraction
//                     (the numpy twin is native/__init__.py:_tile_np)
//   gather_pairs_f32: batched random gather of (fully, under) patch pairs
//                     into contiguous batch buffers
//   patch_means_f32:  per-patch means (black-patch classification)
//
// Threading: OpenMP over rows of the output. Exposed through a C ABI for
// ctypes. The tests hold each function exact-equal to its numpy version.

#include <algorithm>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Reflect index into [0, n) without repeating the edge sample
// (numpy pad mode="reflect" semantics).
inline int reflect(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = ((i % period) + period) % period;
  return i < n ? i : period - i;
}

}  // namespace

extern "C" {

// img:   (H, W) row-major float32
// out:   (nv * nh, outer, outer) preallocated
// Geometry: pad = (outer - inner) / 2 on top/left; windows start at
// row r*inner - pad; rows beyond H-1+pad(+alignment pad) are reflected.
// nv = ceil(H / inner), nh = ceil(W / inner).
void tile_f32(const float* img, int64_t H, int64_t W, int64_t outer,
              int64_t inner, float* out) {
  const int64_t pad = (outer - inner) / 2;
  const int64_t nv = (H + inner - 1) / inner;
  const int64_t nh = (W + inner - 1) / inner;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t r = 0; r < nv; ++r) {
    for (int64_t c = 0; c < nh; ++c) {
      float* dst = out + (r * nh + c) * outer * outer;
      for (int64_t i = 0; i < outer; ++i) {
        const int src_row = reflect(static_cast<int>(r * inner - pad + i),
                                    static_cast<int>(H));
        const float* row = img + static_cast<int64_t>(src_row) * W;
        const int64_t col0 = c * inner - pad;
        // fast path: fully interior row span
        if (col0 >= 0 && col0 + outer <= W) {
          std::memcpy(dst + i * outer, row + col0, outer * sizeof(float));
        } else {
          for (int64_t j = 0; j < outer; ++j) {
            dst[i * outer + j] =
                row[reflect(static_cast<int>(col0 + j), static_cast<int>(W))];
          }
        }
      }
    }
  }
}

// Gather n patches of patch_elems floats each from two parallel pools.
void gather_pairs_f32(const float* fully, const float* under,
                      const int64_t* idx, int64_t n, int64_t patch_elems,
                      float* out_fully, float* out_under) {
#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < n; ++k) {
    const int64_t src = idx[k] * patch_elems;
    std::memcpy(out_fully + k * patch_elems, fully + src,
                patch_elems * sizeof(float));
    std::memcpy(out_under + k * patch_elems, under + src,
                patch_elems * sizeof(float));
  }
}

// Per-patch means over a (n, patch_elems) pool: black-patch classification
// (mean < 1e-10) without a second pass over the data in Python.
void patch_means_f32(const float* patches, int64_t n, int64_t patch_elems,
                     float* out_means) {
#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < n; ++k) {
    const float* p = patches + k * patch_elems;
    double acc = 0.0;
    for (int64_t j = 0; j < patch_elems; ++j) acc += p[j];
    out_means[k] = static_cast<float>(acc / static_cast<double>(patch_elems));
  }
}

int omp_max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
