// Serving crop warp + clamp/normalize tail for Hopper (sm_90a).
//
// Replaces the TPU kernel lsps_tpu/ops/pallas/warp.py:_warp_kernel.
// Per frame b and output pixel (r, c) of a (dh, dw) crop:
//
//   v = frame[b, iy[b, r], ix[b, c]]   (0 where either index is -1,
//                                       0 where the sample is not finite)
//   v = (v < zstart && v != 0) ? zstart : v      near plane clamp
//   v = (v > zend   && v != 0) ? 0      : v      far cut
//   v = (v == 0) ? zend : v                      background -> far plane
//   out[b, r, c] = (v - com_z) / half
//
// with params[b] = (zstart, zend, com_z, half).  The TPU kernel selected
// rows and columns with two one-hot MXU contractions, a workaround for
// XLA's gather lowering on that chip; here it is a direct gather, one
// thread per output pixel.  Only the sampled pixels are read, so a frame
// needs no sanitising pass over all of it: a non-finite sample is set to
// 0 where it is read, which gives what sanitising the whole frame gives.
// The frame is read in its stored type (float32, or uint16 millimetres as
// the sensor delivers them).
//
// Bound on this card: bytes.  A frame writes 64 KiB of float32 output and
// reads at most one source pixel per output pixel plus 1 KiB of indices;
// there are 9 flops a pixel.  At batch 1 the 64 blocks are far too few to
// fill 132 SMs and the launch itself dominates.  The design keeps the
// store coalesced (neighbouring threads write neighbouring columns) and
// loads the indices once per block into shared memory; wider stores and
// several rows per thread are left for later work.
//
// Arithmetic is IEEE: explicit round-to-nearest subtract and divide, so
// the result is bit-equal to the plain PyTorch version whatever flags the
// file is built with.  Do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool is_finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t v) {
  return static_cast<float>(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_normalize_kernel(const T* __restrict__ frames,
                      const int32_t* __restrict__ iy,
                      const int32_t* __restrict__ ix,
                      const float* __restrict__ params,
                      float* __restrict__ out,
                      int h, int w, int dh, int dw) {
  extern __shared__ int32_t s_idx[];  // iy[0:dh] then ix[0:dw]
  __shared__ float s_par[4];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < dh; i += blockDim.x) {
    s_idx[i] = iy[static_cast<int64_t>(b) * dh + i];
  }
  for (int i = threadIdx.x; i < dw; i += blockDim.x) {
    s_idx[dh + i] = ix[static_cast<int64_t>(b) * dw + i];
  }
  if (threadIdx.x < 4) s_par[threadIdx.x] = params[b * 4 + threadIdx.x];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= dh * dw) return;
  const int r = p / dw;
  const int c = p - r * dw;
  const int sy = s_idx[r];
  const int sx = s_idx[dh + c];
  float v = 0.0f;
  if (sy >= 0 && sx >= 0) {
    v = to_float(frames[(static_cast<int64_t>(b) * h + sy) * w + sx]);
    if (!is_finite(v)) v = 0.0f;
  }
  const float zstart = s_par[0];
  const float zend = s_par[1];
  if (v < zstart && v != 0.0f) v = zstart;
  if (v > zend && v != 0.0f) v = 0.0f;
  if (v == 0.0f) v = zend;
  out[static_cast<int64_t>(b) * dh * dw + p] =
      __fdiv_rn(__fsub_rn(v, s_par[2]), s_par[3]);
}

template <typename T>
int launch(const void* frames, const void* iy, const void* ix,
           const void* params, void* out, int b, int h, int w, int dh,
           int dw, cudaStream_t stream) {
  const dim3 grid((dh * dw + kThreads - 1) / kThreads, b);
  const size_t smem = static_cast<size_t>(dh + dw) * sizeof(int32_t);
  warp_normalize_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(frames), static_cast<const int32_t*>(iy),
      static_cast<const int32_t*>(ix), static_cast<const float*>(params),
      static_cast<float*>(out), h, w, dh, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// frame_dtype: 0 = float32, 1 = uint16.  Returns cudaGetLastError() after
// the launch (0 on success); -1 for an unknown frame_dtype.
extern "C" int lsps_warp_normalize(const void* frames, int frame_dtype,
                                   const void* iy, const void* ix,
                                   const void* params, void* out, int b,
                                   int h, int w, int dh, int dw,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (frame_dtype) {
    case 0:
      return launch<float>(frames, iy, ix, params, out, b, h, w, dh, dw, s);
    case 1:
      return launch<uint16_t>(frames, iy, ix, params, out, b, h, w, dh, dw,
                              s);
    default:
      return -1;
  }
}
