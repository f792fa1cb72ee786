// Fused InstanceNorm kernels for Hopper (sm_90a): forward and backward of
// IN + LeakyReLU, and of IN + residual add.
//
// Replace the TPU kernels of lsps_tpu/ops/pallas/norm_act.py:
//   lsps_in_act_fwd  <- _pallas_fwd         (norm_act.py:92)
//   lsps_in_act_bwd  <- _pallas_bwd         (norm_act.py:124)
//   lsps_in_res_fwd  <- _pallas_in_res_fwd  (norm_act.py:275)
//   lsps_in_res_bwd  <- _pallas_in_res_bwd  (norm_act.py:307)
//
// Layout: NCHW, so each (b, c) plane is hw contiguous values; one block
// normalises one plane (grid.x = B * C).  Per plane:
//
//   mean = sum(x) / hw;  var = sum((x - mean)^2) / hw     (two passes)
//   rstd = 1 / sqrt(var + 1e-5);  xhat = (x - mean) * rstd
//   in_act_fwd:  y = act(xhat), writes y (x's type), xhat (f32), rstd
//   in_act_bwd:  gp = act'(xhat) * g
//                dx = rstd * (gp - mean(gp) - xhat * mean(gp * xhat))
//   in_res_fwd:  y = xhat + res, writes y, mean, rstd
//   in_res_bwd:  xhat recomputed from x, mean, rstd;
//                dx = rstd * (g - mean(g) - xhat * mean(g * xhat))
//
// act(v) = v >= 0 ? v : slope * v, or v when has_slope is 0.  Inputs are
// float32 or bfloat16 (dtype 0 / 1); moments, xhat and every sum are
// float32, as in the TPU kernels.
//
// Bound on this card: bytes.  A call moves three plane-sized tensors
// (x, y, xhat; g, xhat, dx; x, res, y; g, x, dx) plus B*C moments and
// does some ten flops per value, far below the 67 TFLOP/s float32 rate.
// At (64, 256, 32, 32) float32 that is 3 * 67.1 MB = 201 MB, 0.060 ms at
// 3.35 TB/s.  The design reads device memory once: the first pass keeps
// the plane (or, in the backward, the two values each sum needs) in shared
// memory, and the later passes read it from there.  A plane too large for
// 48 KB of shared memory is read again from device memory (through L2).
// Loads and stores are 4 values wide where hw is a multiple of 4 and the
// pointers are 16-byte aligned.  The sums are reduced in a fixed order
// (per thread, then warp shuffles, then warps in order), so a result does
// not change from run to run.  No fast-math: 1/sqrt is __frsqrt_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kCacheBytes = 48 * 1024 - kMaxWarps * 2 * sizeof(float);
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive values at p (p aligned to VEC values when VEC == 4).
template <int VEC>
__device__ __forceinline__ void load(const float* p, float* v) {
  if (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if (VEC == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}
template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if (VEC == 4) {
    uint2 t;
    *reinterpret_cast<__nv_bfloat162*>(&t.x) =
        __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&t.y) =
        __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums of a and b over the block, returned to every thread.  red holds
// 2 * kMaxWarps floats; the leading barrier keeps a previous call's
// readers ahead of this call's writers.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[warp] = a;
    red[kMaxWarps + warp] = b;
  }
  __syncthreads();
  float2 s = make_float2(0.0f, 0.0f);
  for (int i = 0; i < nwarps; ++i) {
    s.x += red[i];
    s.y += red[kMaxWarps + i];
  }
  return s;
}

__device__ __forceinline__ float block_sum(float a, float* red) {
  return block_sum2(a, 0.0f, red).x;
}

// mean and rstd of the plane src[0:hw]; with CACHE the values are kept in
// cache[0:hw] for the caller's next pass (each thread reads back only the
// entries it wrote).
template <typename T, int VEC, bool CACHE>
__device__ __forceinline__ float2 plane_moments(const T* src, float* cache,
                                                int hw, float* red) {
  const int step = blockDim.x * VEC;
  float s = 0.0f;
  for (int i = threadIdx.x * VEC; i < hw; i += step) {
    float v[VEC];
    load<VEC>(src + i, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) s += v[k];
    if (CACHE) store<VEC>(cache + i, v);
  }
  const float mean = block_sum(s, red) / static_cast<float>(hw);
  float q = 0.0f;
  for (int i = threadIdx.x * VEC; i < hw; i += step) {
    float v[VEC];
    if (CACHE) load<VEC>(cache + i, v); else load<VEC>(src + i, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float d = v[k] - mean;
      q += d * d;
    }
  }
  const float var = block_sum(q, red) / static_cast<float>(hw);
  return make_float2(mean, __frsqrt_rn(var + kEps));
}

template <typename T, int VEC, bool CACHE>
__global__ void __launch_bounds__(kMaxThreads)
in_act_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                  float* __restrict__ xhat, float* __restrict__ rstd_out,
                  int hw, float slope, bool has_slope) {
  extern __shared__ float smem[];
  float* red = smem;
  float* cache = smem + 2 * kMaxWarps;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const float2 mr = plane_moments<T, VEC, CACHE>(x + base, cache, hw, red);
  for (int i = threadIdx.x * VEC; i < hw; i += blockDim.x * VEC) {
    float v[VEC], out[VEC];
    if (CACHE) load<VEC>(cache + i, v); else load<VEC>(x + base + i, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      v[k] = (v[k] - mr.x) * mr.y;
      out[k] = (has_slope && !(v[k] >= 0.0f)) ? slope * v[k] : v[k];
    }
    store<VEC>(xhat + base + i, v);
    store<VEC>(y + base + i, out);
  }
  if (threadIdx.x == 0) rstd_out[blockIdx.x] = mr.y;
}

template <typename T, int VEC, bool CACHE>
__global__ void __launch_bounds__(kMaxThreads)
in_res_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  T* __restrict__ y, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, int hw) {
  extern __shared__ float smem[];
  float* red = smem;
  float* cache = smem + 2 * kMaxWarps;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const float2 mr = plane_moments<T, VEC, CACHE>(x + base, cache, hw, red);
  for (int i = threadIdx.x * VEC; i < hw; i += blockDim.x * VEC) {
    float v[VEC], r[VEC];
    if (CACHE) load<VEC>(cache + i, v); else load<VEC>(x + base + i, v);
    load<VEC>(res + base + i, r);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = (v[k] - mr.x) * mr.y + r[k];
    store<VEC>(y + base + i, v);
  }
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mr.x;
    rstd_out[blockIdx.x] = mr.y;
  }
}

// dx = rstd * (a - mean(a) - xh * mean(a * xh)) for the plane, where the
// loader gives (a, xh) for index i.  With CACHE both are kept in cache
// (a in cache[0:hw], xh in cache[hw:2hw]) between the two passes.
template <typename T, int VEC, bool CACHE, typename Loader>
__device__ __forceinline__ void norm_backward(const Loader& ld, T* dx,
                                              float* cache, int hw,
                                              float rstd, float* red) {
  const int step = blockDim.x * VEC;
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = threadIdx.x * VEC; i < hw; i += step) {
    float a[VEC], xh[VEC];
    ld(i, a, xh);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s1 += a[k];
      s2 += a[k] * xh[k];
    }
    if (CACHE) {
      store<VEC>(cache + i, a);
      store<VEC>(cache + hw + i, xh);
    }
  }
  const float2 s = block_sum2(s1, s2, red);
  const float m1 = s.x / static_cast<float>(hw);
  const float m2 = s.y / static_cast<float>(hw);
  for (int i = threadIdx.x * VEC; i < hw; i += step) {
    float a[VEC], xh[VEC];
    if (CACHE) {
      load<VEC>(cache + i, a);
      load<VEC>(cache + hw + i, xh);
    } else {
      ld(i, a, xh);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = rstd * (a[k] - m1 - xh[k] * m2);
    store<VEC>(dx + i, a);
  }
}

template <typename T, int VEC, bool CACHE>
__global__ void __launch_bounds__(kMaxThreads)
in_act_bwd_kernel(const T* __restrict__ g, const float* __restrict__ xhat,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  int hw, float slope, bool has_slope) {
  extern __shared__ float smem[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const T* gp = g + base;
  const float* xp = xhat + base;
  auto ld = [=](int i, float* a, float* xh) {
    load<VEC>(gp + i, a);
    load<VEC>(xp + i, xh);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (has_slope && !(xh[k] >= 0.0f)) a[k] = slope * a[k];
    }
  };
  norm_backward<T, VEC, CACHE>(ld, dx + base, smem + 2 * kMaxWarps, hw,
                               rstd[blockIdx.x], smem);
}

template <typename T, int VEC, bool CACHE>
__global__ void __launch_bounds__(kMaxThreads)
in_res_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  int hw) {
  extern __shared__ float smem[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const T* gp = g + base;
  const T* xp = x + base;
  const float mu = mean[blockIdx.x];
  const float r = rstd[blockIdx.x];
  auto ld = [=](int i, float* a, float* xh) {
    load<VEC>(gp + i, a);
    load<VEC>(xp + i, xh);
#pragma unroll
    for (int k = 0; k < VEC; ++k) xh[k] = (xh[k] - mu) * r;
  };
  norm_backward<T, VEC, CACHE>(ld, dx + base, smem + 2 * kMaxWarps, hw, r,
                               smem);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launch shape for planes of hw values: one block per plane, up to 256
// threads, each taking VEC values a step; `cached` values of each plane
// element are kept in shared memory when they fit.
struct Shape {
  dim3 grid, block;
  size_t smem;
  bool vec, cache;
};

Shape shape_for(int planes, int hw, int cached, bool vec) {
  Shape s;
  s.vec = vec;
  const int per_thread = vec ? 4 : 1;
  int threads = (hw + per_thread - 1) / per_thread;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  s.grid = dim3(planes);
  s.block = dim3(threads);
  const size_t cache_bytes =
      static_cast<size_t>(hw) * cached * sizeof(float);
  s.cache = cache_bytes <= static_cast<size_t>(kCacheBytes);
  s.smem = 2 * kMaxWarps * sizeof(float) + (s.cache ? cache_bytes : 0);
  return s;
}

// Picks the <VEC, CACHE> instance of a kernel and launches it.
#define LSPS_DISPATCH(KERNEL, T, SHAPE, STREAM, ...)                        \
  do {                                                                      \
    if ((SHAPE).vec && (SHAPE).cache)                                       \
      KERNEL<T, 4, true><<<(SHAPE).grid, (SHAPE).block, (SHAPE).smem,       \
                           STREAM>>>(__VA_ARGS__);                          \
    else if ((SHAPE).vec)                                                   \
      KERNEL<T, 4, false><<<(SHAPE).grid, (SHAPE).block, (SHAPE).smem,      \
                            STREAM>>>(__VA_ARGS__);                         \
    else if ((SHAPE).cache)                                                 \
      KERNEL<T, 1, true><<<(SHAPE).grid, (SHAPE).block, (SHAPE).smem,       \
                           STREAM>>>(__VA_ARGS__);                          \
    else                                                                    \
      KERNEL<T, 1, false><<<(SHAPE).grid, (SHAPE).block, (SHAPE).smem,      \
                            STREAM>>>(__VA_ARGS__);                         \
  } while (0)

template <typename T>
int in_act_fwd(const void* x, void* y, void* xhat, void* rstd, int planes,
               int hw, float slope, bool has_slope, cudaStream_t stream) {
  const Shape s = shape_for(planes, hw, 1, hw % 4 == 0 && aligned16(x) &&
                            aligned16(y) && aligned16(xhat));
  LSPS_DISPATCH(in_act_fwd_kernel, T, s, stream, static_cast<const T*>(x),
                static_cast<T*>(y), static_cast<float*>(xhat),
                static_cast<float*>(rstd), hw, slope, has_slope);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int in_act_bwd(const void* g, const void* xhat, const void* rstd, void* dx,
               int planes, int hw, float slope, bool has_slope,
               cudaStream_t stream) {
  const Shape s = shape_for(planes, hw, 2, hw % 4 == 0 && aligned16(g) &&
                            aligned16(xhat) && aligned16(dx));
  LSPS_DISPATCH(in_act_bwd_kernel, T, s, stream, static_cast<const T*>(g),
                static_cast<const float*>(xhat),
                static_cast<const float*>(rstd), static_cast<T*>(dx), hw,
                slope, has_slope);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int in_res_fwd(const void* x, const void* res, void* y, void* mean,
               void* rstd, int planes, int hw, cudaStream_t stream) {
  const Shape s = shape_for(planes, hw, 1, hw % 4 == 0 && aligned16(x) &&
                            aligned16(res) && aligned16(y));
  LSPS_DISPATCH(in_res_fwd_kernel, T, s, stream, static_cast<const T*>(x),
                static_cast<const T*>(res), static_cast<T*>(y),
                static_cast<float*>(mean), static_cast<float*>(rstd), hw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int in_res_bwd(const void* g, const void* x, const void* mean,
               const void* rstd, void* dx, int planes, int hw,
               cudaStream_t stream) {
  const Shape s = shape_for(planes, hw, 2, hw % 4 == 0 && aligned16(g) &&
                            aligned16(x) && aligned16(dx));
  LSPS_DISPATCH(in_res_bwd_kernel, T, s, stream, static_cast<const T*>(g),
                static_cast<const T*>(x), static_cast<const float*>(mean),
                static_cast<const float*>(rstd), static_cast<T*>(dx), hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after
// the launch (0 on success), or -1 for an unknown dtype or a bad size.
// xhat, mean and rstd are float32; planes = B * C, hw = H * W.

extern "C" int lsps_in_act_fwd(const void* x, void* y, void* xhat,
                               void* rstd, int dtype, int planes, int hw,
                               float slope, int has_slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || hw <= 0) return -1;
  if (dtype == 0)
    return in_act_fwd<float>(x, y, xhat, rstd, planes, hw, slope,
                             has_slope != 0, s);
  if (dtype == 1)
    return in_act_fwd<__nv_bfloat16>(x, y, xhat, rstd, planes, hw, slope,
                                     has_slope != 0, s);
  return -1;
}

extern "C" int lsps_in_act_bwd(const void* g, const void* xhat,
                               const void* rstd, void* dx, int dtype,
                               int planes, int hw, float slope,
                               int has_slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || hw <= 0) return -1;
  if (dtype == 0)
    return in_act_bwd<float>(g, xhat, rstd, dx, planes, hw, slope,
                             has_slope != 0, s);
  if (dtype == 1)
    return in_act_bwd<__nv_bfloat16>(g, xhat, rstd, dx, planes, hw, slope,
                                     has_slope != 0, s);
  return -1;
}

extern "C" int lsps_in_res_fwd(const void* x, const void* res, void* y,
                               void* mean, void* rstd, int dtype,
                               int planes, int hw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || hw <= 0) return -1;
  if (dtype == 0)
    return in_res_fwd<float>(x, res, y, mean, rstd, planes, hw, s);
  if (dtype == 1)
    return in_res_fwd<__nv_bfloat16>(x, res, y, mean, rstd, planes, hw, s);
  return -1;
}

extern "C" int lsps_in_res_bwd(const void* g, const void* x,
                               const void* mean, const void* rstd, void* dx,
                               int dtype, int planes, int hw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || hw <= 0) return -1;
  if (dtype == 0)
    return in_res_bwd<float>(g, x, mean, rstd, dx, planes, hw, s);
  if (dtype == 1)
    return in_res_bwd<__nv_bfloat16>(g, x, mean, rstd, dx, planes, hw, s);
  return -1;
}
