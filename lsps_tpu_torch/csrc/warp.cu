// Serving crop warp + clamp/normalize tail for Hopper (sm_90a), with the
// crop-index math computed inside the kernel.
//
// Replaces the TPU kernel lsps_tpu/ops/pallas/warp.py:_warp_kernel and the
// per-sample index math of crop_normalize_batch_pallas that feeds it.  Per
// frame b and output pixel (r, c) of a (dh, dw) crop:
//
//   v = frame[b, iy[b, r], ix[b, c]]   (0 where either index is -1,
//                                       0 where the sample is not finite)
//   v = (v < zstart && v != 0) ? zstart : v      near plane clamp
//   v = (v > zend   && v != 0) ? 0      : v      far cut
//   v = (v == 0) ? zend : v                      background -> far plane
//   out[b, r, c] = (v - com_z) / half
//
// with (zstart, zend, com_z, half) the frame's tail parameters.  Two
// entries share one templated kernel:
//
// * lsps_crop_normalize computes iy, ix, the tail parameters and the crop
//   affine M from the frame's CoM and cube, so a batch is one launch.  The
//   math is that of lsps_tpu_torch/ops/kernels/warp.py:crop_indices, op for
//   op in float32, every operation an explicitly rounded intrinsic
//   (__fmul_rn, __fdiv_rn, __fadd_rn, __fsub_rn, __fmaf_rn): nvcc contracts
//   a plain `a * b + c` into one FMA by default, and one stray rounding
//   moves a crop bound by a pixel for a few CoMs in 1e5.  A failed
//   detection (CoM 0) gives infinite bounds and NaN in M; no NaN or inf is
//   ever converted to an index (the mask is taken in float first).
// * lsps_warp_normalize reads iy, ix and the tail parameters from memory.
//
// Bound on this card: bytes.  A 128x128 crop writes 64 KiB of float32 and
// reads at most one source pixel per output pixel; the index math is a
// few dozen flops per row and column.  The TPU kernel selected rows and
// columns with two one-hot MXU contractions; here each thread gathers
// directly.  A block covers one tile of rows of one frame (frames on
// grid.x, tiles on grid.y).  Its first row of threads computes (or loads)
// the frame's source columns and the tile's source rows once, into shared
// memory, with the tail's two constant outputs (near plane, far plane);
// then each thread covers VEC = 4 adjacent columns (one 16-byte store) and
// RPT rows and issues all of its RPT * VEC gathers before the tails and
// the stores.  An invalid row or column issues no load, and only a sample
// inside the z-range pays for a division.  The rows per thread and the
// threads per block are compile-time constants from the sweep recorded in
// PERF.md (warp_sweep.py at the repository root rebuilds this file with
// others through the LSPS_WARP_* macros below).
// The frames' 32-byte sectors that the gathers touch, with the crop, are
// about 1.4 times the bytes the bound counts: a crop samples every 1.5-2
// source pixels of a row, and DRAM serves whole sectors.
//
// Arithmetic is IEEE throughout, so the results are bit-equal to the plain
// PyTorch version whatever flags the file is built with.  Do not build with
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

// The sweep's parameters: 1 row per thread and 256 threads per block are
// the best, or within 0.5 % of it, at batch 1, 32 and 256 with the frames
// cold in L2.
#ifndef LSPS_WARP_ROWS_PER_THREAD
#define LSPS_WARP_ROWS_PER_THREAD 1
#endif
#ifndef LSPS_WARP_THREADS
#define LSPS_WARP_THREADS 256
#endif

namespace {

constexpr int RPT = LSPS_WARP_ROWS_PER_THREAD;  // rows per thread
constexpr int kThreads = LSPS_WARP_THREADS;      // threads per block
static_assert(RPT >= 1, "rows per thread");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "threads per block");

__device__ __forceinline__ float sanitize(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u ? 0.0f : v;
}
__device__ __forceinline__ float sanitize(uint16_t v) {
  return static_cast<float>(v);
}

struct Args {
  const void* frames;
  const int32_t* iy;      // loaded indices: (b, dh), (b, dw), (b, 4)
  const int32_t* ix;
  const float* params;
  const float* coms;      // computed indices: (b, 3), (b, 3)
  const float* cubes;
  float fx, fy, rfx, rfy;
  float* Ms;              // (b, 3, 3), computed indices only
  float* out;             // (b, dh, dw)
  int h, w, dh, dw;
};

// The crop of one frame, as crop_indices computes it.
struct Crop {
  float zstart, zend, com_z, half;   // the tail
  float scale;
  float xstart, xoff, xlim;          // xlim = xoff + ceil(wb * scale)
  float ystart, yoff, ylim;
};

// floor(fma(fma(c * z, r, half) / z, f, 0.5)): one edge of the 2D box.
__device__ __forceinline__ float edge(float c, float z, float r, float f,
                                      float half) {
  return floorf(__fmaf_rn(
      __fdiv_rn(__fmaf_rn(__fmul_rn(c, z), r, half), z), f, 0.5f));
}

__device__ Crop compute_crop(const Args& a, int b, float* M) {
  const float u = a.coms[b * 3], v = a.coms[b * 3 + 1],
              z = a.coms[b * 3 + 2];
  // x / 2 and x * 0.5 round the same real number: the same bits
  const float half_x = __fmul_rn(a.cubes[b * 3], 0.5f);
  const float half_y = __fmul_rn(a.cubes[b * 3 + 1], 0.5f);
  const float half_z = __fmul_rn(a.cubes[b * 3 + 2], 0.5f);
  Crop k;
  k.zstart = __fsub_rn(z, half_z);
  k.zend = __fadd_rn(z, half_z);
  k.com_z = z;
  k.half = half_z;
  k.xstart = edge(u, z, a.rfx, a.fx, -half_x);
  const float xend = edge(u, z, a.rfx, a.fx, half_x);
  k.ystart = edge(v, z, a.rfy, a.fy, -half_y);
  const float yend = edge(v, z, a.rfy, a.fy, half_y);
  const float wb = __fsub_rn(xend, k.xstart);
  const float hb = __fsub_rn(yend, k.ystart);
  const float dsw = static_cast<float>(a.dw), dsh = static_cast<float>(a.dh);
  const bool wide = wb > hb;
  k.scale = wide ? __fdiv_rn(dsw, wb) : __fdiv_rn(dsh, hb);
  const float sz_w = floorf(wide ? dsw : __fmul_rn(wb, k.scale));
  const float sz_h = floorf(wide ? __fmul_rn(hb, k.scale) : dsh);
  k.xoff = floorf(__fsub_rn(__fmul_rn(dsw, 0.5f), __fmul_rn(sz_w, 0.5f)));
  k.yoff = floorf(__fsub_rn(__fmul_rn(dsh, 0.5f), __fmul_rn(sz_h, 0.5f)));
  k.xlim = __fadd_rn(k.xoff, ceilf(__fmul_rn(wb, k.scale)));
  k.ylim = __fadd_rn(k.yoff, ceilf(__fmul_rn(hb, k.scale)));
  if (M != nullptr) {
    M[0] = k.scale;
    M[1] = 0.0f;
    M[2] = __fmaf_rn(-k.xstart, k.scale, k.xoff);
    M[3] = 0.0f;
    M[4] = k.scale;
    M[5] = __fmaf_rn(-k.ystart, k.scale, k.yoff);
    M[6] = 0.0f;
    M[7] = 0.0f;
    M[8] = 1.0f;
  }
  return k;
}

// Source row or column of output position pos, -1 where it lies outside
// the destination box or the source frame.  src is converted only where
// the mask holds, and there it is finite and in [0, n_src).
__device__ __forceinline__ int axis_index(float pos, float off, float start,
                                          float lim, float scale,
                                          int n_src) {
  const float src =
      floorf(__fadd_rn(__fdiv_rn(__fsub_rn(pos, off), scale), start));
  const bool ok = pos >= off && pos < lim && src >= 0.0f &&
                  src < static_cast<float>(n_src);
  return ok ? static_cast<int>(src) : -1;
}

// What the tail makes of x once the near clamp is done.
__device__ __forceinline__ float after_near(float x, float zend,
                                            float com_z, float half) {
  if (x > zend && x != 0.0f) x = 0.0f;
  if (x == 0.0f) x = zend;
  return __fdiv_rn(__fsub_rn(x, com_z), half);
}

// The tail of one frame.  A sample below zstart becomes zstart, and one
// that is 0 or beyond zend becomes zend: both outputs are computed once
// per block, so only a sample inside the z-range is divided.
struct Tail {
  float zstart, zend, com_z, half, near, far;

  __device__ __forceinline__ float operator()(float v) const {
    if (v < zstart && v != 0.0f) return near;
    if (v == 0.0f || v > zend) return far;
    return __fdiv_rn(__fsub_rn(v, com_z), half);
  }
};

__device__ __forceinline__ Tail make_tail(float zstart, float zend,
                                          float com_z, float half) {
  return {zstart, zend, com_z, half, after_near(zstart, zend, com_z, half),
          after_near(0.0f, zend, com_z, half)};
}

// Block (tx, ty): tx threads across the columns, VEC columns each; ty
// threads down the block's tile of ty * RPT rows, RPT rows each, ty
// apart.  grid = (b, row tiles).  The threads of the first block row put
// the frame's dw source columns and the tile's source rows into shared
// memory (computed from the CoM and cube, or loaded), and the tail's
// constants; then every thread gathers.
template <typename T, int VEC, bool kComputed>
__global__ void __launch_bounds__(kThreads)
crop_warp_kernel(const Args a) {
  extern __shared__ __align__(16) int s_idx[];  // ix[0:dw], tile's iy
  __shared__ Tail s_tail;
  const int b = blockIdx.x;
  const int tile = blockDim.y * RPT;
  const int row0 = blockIdx.y * tile;
  const int n_rows = min(tile, a.dh - row0);
  if (threadIdx.y == 0) {
    if constexpr (kComputed) {
      const bool first = blockIdx.y == 0 && threadIdx.x == 0;
      const Crop k = compute_crop(
          a, b, first ? a.Ms + static_cast<int64_t>(b) * 9 : nullptr);
      for (int i = threadIdx.x; i < a.dw + n_rows; i += blockDim.x) {
        s_idx[i] = i < a.dw
                       ? axis_index(static_cast<float>(i), k.xoff, k.xstart,
                                    k.xlim, k.scale, a.w)
                       : axis_index(static_cast<float>(row0 + i - a.dw),
                                    k.yoff, k.ystart, k.ylim, k.scale, a.h);
      }
      if (threadIdx.x == 0) s_tail = make_tail(k.zstart, k.zend, k.com_z,
                                               k.half);
    } else {
      for (int i = threadIdx.x; i < a.dw + n_rows; i += blockDim.x) {
        s_idx[i] = i < a.dw
                       ? a.ix[static_cast<int64_t>(b) * a.dw + i]
                       : a.iy[static_cast<int64_t>(b) * a.dh + row0 + i -
                              a.dw];
      }
      if (threadIdx.x == 0) {
        const float* p = a.params + static_cast<int64_t>(b) * 4;
        s_tail = make_tail(p[0], p[1], p[2], p[3]);
      }
    }
  }
  __syncthreads();
  const Tail tail = s_tail;
  const T* frame = static_cast<const T*>(a.frames) +
                   static_cast<int64_t>(b) * a.h * a.w;

  int rows[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = threadIdx.y + i * blockDim.y;
    rows[i] = r < n_rows ? s_idx[a.dw + r] : -1;
  }
  for (int c0 = threadIdx.x * VEC; c0 < a.dw; c0 += blockDim.x * VEC) {
    int cols[VEC];
    if constexpr (VEC == 4) {
      const int4 c4 = *reinterpret_cast<const int4*>(s_idx + c0);
      cols[0] = c4.x;
      cols[1] = c4.y;
      cols[2] = c4.z;
      cols[3] = c4.w;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        cols[j] = c0 + j < a.dw ? s_idx[c0 + j] : -1;
      }
    }
    // every gather of this thread first, then the tails and stores
    float v[RPT][VEC];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const T* src = frame + static_cast<int64_t>(rows[i]) * a.w;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[i][j] = (rows[i] >= 0 && cols[j] >= 0)
                      ? sanitize(__ldg(src + cols[j]))
                      : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = threadIdx.y + i * blockDim.y;
      if (r >= n_rows) continue;
      float* dst =
          a.out + (static_cast<int64_t>(b) * a.dh + row0 + r) * a.dw + c0;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(tail(v[i][0]), tail(v[i][1]), tail(v[i][2]),
                        tail(v[i][3]));
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          if (c0 + j < a.dw) dst[j] = tail(v[i][j]);
        }
      }
    }
  }
}

template <typename T, int VEC, bool kComputed>
int launch_vec(const Args& a, int b, cudaStream_t s) {
  const int cols = (a.dw + VEC - 1) / VEC;
  const int tx = cols < kThreads ? cols : kThreads;
  const int ty = kThreads / tx;
  const int tile = ty * RPT;
  const dim3 grid(b, (a.dh + tile - 1) / tile);
  const size_t smem = static_cast<size_t>(a.dw + tile) * sizeof(int);
  crop_warp_kernel<T, VEC, kComputed><<<grid, dim3(tx, ty), smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte store needs dw % 4 == 0 and a 16-byte aligned output.
template <typename T, bool kComputed>
int launch_type(const Args& a, int b, cudaStream_t s) {
  const bool vec4 =
      a.dw % 4 == 0 && (reinterpret_cast<uintptr_t>(a.out) & 15u) == 0;
  return vec4 ? launch_vec<T, 4, kComputed>(a, b, s)
              : launch_vec<T, 1, kComputed>(a, b, s);
}

template <bool kComputed>
int launch(int frame_dtype, const Args& a, int b, void* stream) {
  if (b <= 0 || a.dh <= 0 || a.dw <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (frame_dtype) {
    case 0: return launch_type<float, kComputed>(a, b, s);
    case 1: return launch_type<uint16_t, kComputed>(a, b, s);
    default: return -1;
  }
}

}  // namespace

// frame_dtype: 0 = float32, 1 = uint16.  Each entry returns
// cudaGetLastError() after the launch (0 on success); -1 for an unknown
// frame_dtype or an empty batch or crop.

// Indices and tail parameters read from memory: iy (b, dh), ix (b, dw)
// int32, -1 where invalid; params (b, 4) float32.
extern "C" int lsps_warp_normalize(const void* frames, int frame_dtype,
                                   const void* iy, const void* ix,
                                   const void* params, void* out, int b,
                                   int h, int w, int dh, int dw,
                                   void* stream) {
  Args a = {};
  a.frames = frames;
  a.iy = static_cast<const int32_t*>(iy);
  a.ix = static_cast<const int32_t*>(ix);
  a.params = static_cast<const float*>(params);
  a.out = static_cast<float*>(out);
  a.h = h;
  a.w = w;
  a.dh = dh;
  a.dw = dw;
  return launch<false>(frame_dtype, a, b, stream);
}

// Indices, tail parameters and the crop affine computed from coms (b, 3)
// and cubes (b, 3) float32.  fx, fy are the focal lengths and rfx, rfy
// their reciprocals, each rounded to float32 on the host; Ms (b, 3, 3).
extern "C" int lsps_crop_normalize(const void* frames, int frame_dtype,
                                   const void* coms, const void* cubes,
                                   float fx, float fy, float rfx, float rfy,
                                   void* out, void* Ms, int b, int h, int w,
                                   int dh, int dw, void* stream) {
  Args a = {};
  a.frames = frames;
  a.coms = static_cast<const float*>(coms);
  a.cubes = static_cast<const float*>(cubes);
  a.fx = fx;
  a.fy = fy;
  a.rfx = rfx;
  a.rfy = rfy;
  a.Ms = static_cast<float*>(Ms);
  a.out = static_cast<float*>(out);
  a.h = h;
  a.w = w;
  a.dh = dh;
  a.dw = dw;
  return launch<true>(frame_dtype, a, b, stream);
}
