// Host-side augment library of the PyTorch port: the batched fused recrop
// + clamp + normalize of the `native` augment backend.
//
// A copy of the JAX package's native/lsps_native.cpp, kept in the port so
// that the port builds its own library and loads nothing of the JAX
// package; the arithmetic is the same line for line, so the two libraries,
// built with the same flags, give the same bits.  The per-sample augment
// path (recropHand, handdetector.py:786-807, and the clamp/renormalize
// tail of augmentCrop, dataset_hand2.py:103-116) makes ~6 passes over each
// 128x128 crop; this fuses the chain into one pass per pixel, batched with
// OpenMP across samples.
//
// Coordinates are double and rounded with lround (half away from zero),
// where cv2's nearest warp rounds float32 coordinates half to even: the
// two backends may pick another source pixel at exact ties.
//
// Build: g++ -O3 -fPIC -shared -fopenmp (lsps_tpu_torch/native/__init__.py,
// into build/ at first use).  Binding: ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Nearest-neighbor perspective warp of one float32 image.
// M maps DESTINATION (x, y, 1) -> SOURCE homogeneous coords (cv2
// WARP_INVERSE_MAP convention; callers pass the inverted matrix).
void warp_perspective_nn(const float* src, int sh, int sw,
                         const double* m, float* dst, int dh, int dw,
                         float border) {
    for (int y = 0; y < dh; ++y) {
        for (int x = 0; x < dw; ++x) {
            double w = m[6] * x + m[7] * y + m[8];
            double sx = (m[0] * x + m[1] * y + m[2]) / w;
            double sy = (m[3] * x + m[4] * y + m[5]) / w;
            int ix = (int)std::lround(sx);
            int iy = (int)std::lround(sy);
            dst[y * dw + x] =
                (ix >= 0 && ix < sw && iy >= 0 && iy < sh)
                    ? src[iy * sw + ix]
                    : border;
        }
    }
}

// Fused recrop + sentinel/clamp + normalize for a batch of crops.
//
// For each sample b:
//   v   = NN-warp of src[b] through minv[b] (dst->src), border pad_value
//   v   = (|v - nv_val| < eps_nv) ? pad_value : v       (recropHand nv)
//   v   = (v < zstart && v != 0) ? zstart : v           (z clamp near)
//   v   = (v > zend   && v != 0) ? 0      : v           (z clamp far)
//   v   = (v == premax || v == 0) ? far : min(max(v, near), far)
//   out = (v - com_z) / (cube_z / 2)                    (normalize)
// which is recropHand + augmentCrop's tail in one pass.
void fused_recrop_normalize_batch(
    const float* src, int n, int h, int w,
    const double* minv,            // n * 9, dst->src
    const float* com_z,            // n
    const float* cube_z,           // n
    const float* premax,           // n
    const float* zstart,           // n
    const float* zend,             // n
    float pad_value, float nv_val, float* out) {
#pragma omp parallel for schedule(static)
    for (int b = 0; b < n; ++b) {
        const float* s = src + (size_t)b * h * w;
        float* d = out + (size_t)b * h * w;
        const double* m = minv + b * 9;
        const float far = com_z[b] + cube_z[b] * 0.5f;
        const float near_ = com_z[b] - cube_z[b] * 0.5f;
        const float half = cube_z[b] * 0.5f;
        const float pm = premax[b];
        const float zs = zstart[b];
        const float ze = zend[b];
        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                double ww = m[6] * x + m[7] * y + m[8];
                double sx = (m[0] * x + m[1] * y + m[2]) / ww;
                double sy = (m[3] * x + m[4] * y + m[5]) / ww;
                int ix = (int)std::lround(sx);
                int iy = (int)std::lround(sy);
                float v = (ix >= 0 && ix < w && iy >= 0 && iy < h)
                              ? s[iy * w + ix]
                              : pad_value;
                // recropHand nv replacement (isclose to nv_val)
                if (std::fabs(v - nv_val) <= 1e-5f * std::fabs(nv_val))
                    v = pad_value;
                // z-threshold (getCrop/recropHand semantics)
                if (v != 0.0f && v < zs) v = zs;
                if (v != 0.0f && v > ze) v = 0.0f;
                // augmentCrop tail (dataset_hand2.py:111-116)
                if (v == pm || v == 0.0f) v = far;
                if (v >= far) v = far;
                if (v <= near_) v = near_;
                d[y * w + x] = (v - com_z[b]) / half;
            }
        }
    }
}

// Batched depth normalization (dataset_hand2.py:27-31) — one pass.
void normalize_batch(const float* src, int n, int hw, const float* com_z,
                     const float* cube_z, float* out) {
#pragma omp parallel for schedule(static)
    for (int b = 0; b < n; ++b) {
        const float* s = src + (size_t)b * hw;
        float* d = out + (size_t)b * hw;
        const float far = com_z[b] + cube_z[b] * 0.5f;
        const float half = cube_z[b] * 0.5f;
        for (int i = 0; i < hw; ++i) {
            float v = s[i];
            if (v == 0.0f) v = far;
            d[i] = (v - com_z[b]) / half;
        }
    }
}

}  // extern "C"
