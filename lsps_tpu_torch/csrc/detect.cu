// On-device hand detection for Hopper (sm_90a): raw depth frames and cubes
// -> CoMs, the arithmetic of lsps_tpu_torch/serve/detect.py's plain version
// (device_detect_batch_reference) in a fixed number of launches.
//
// Replaces no TPU kernel: the JAX package computes detection outside Pallas
// (lsps_tpu/serve/detect_jax.py), as XLA ops.  On the card the plain
// PyTorch form is ~600 launches a call, and at batch 256 a scatter-add
// histogram whose atomics mostly hit one bin a frame.  Per frame b:
//
//   1. detect_minmax_kernel: the raw max and min, as an order-free atomic
//      max on an order-preserving integer key of each float, and a NaN
//      flag (torch's amax and amin propagate NaN).  Every later pass clamps
//      them to [10, 6500] as the plain version does.
//   2. detect_slice_kernel: a kTileH x kTileW tile of the slice-index plane
//      with a one-pixel halo in shared memory (-2 outside the frame, so a
//      border pixel never passes the 3x3 interior test, as the plain
//      version's `inb` rule has it).  Per slice k >= first_slice: the
//      interior count, the pixel count and the sums of x and y of the
//      pixels in slice k, aggregated per warp (__match_any_sync: the lanes
//      of a row segment mostly share a slice) into shared memory, then one
//      64-bit global atomic per bin and block.  The histogram and the blob
//      centroid of the selected slice come out of this one pass.
//   3. detect_box_kernel, 1 + refine_iters launches.  Round 0 selects the
//      first slice from first_slice on with >= interior_min interior
//      pixels, its rounded centroid, the +-100 px box and the z window, and
//      sums the masked CoM over that box.  Round r >= 1 computes round
//      r - 1's CoM from its sums (and stores it), the box and z range from
//      it (com_to_bounds, as warp.cu computes it), and sums over that box.
//      About kBoxBlocks blocks a round share the frames' boxes, a warp a
//      row at a time; a block whose rows miss the box leaves at once.
//   4. detect_finalize_kernel: the last round's CoM, zero where no slice
//      qualifies.
//
// A call is one memset of the workspace and 4 + refine_iters launches,
// whatever the batch and frame size; no host sync.
//
// Sums are exact integers in any order: counts, sums of x and y, and depths
// as fixed point (d * 2^20 is a whole number for every float32 d in
// [8, 8192), and a counted depth lies in [10, 6500]).  In a refine round
// the pixels clamped to the near plane add n_near * zstart in float64.  A
// CoM is the float64 quotient of its sums, rounded to float32 once.  So it
// is the same from run to run; it equals the plain version's where that
// version's float32 sums are exact (whole numbers below 2^24: u and v of a
// hand) and lies closer to the exact mean where they are not (z).  Every
// predicate is the plain version's, in float32 with explicitly rounded
// intrinsics (nvcc contracts a * b + c into one FMA by default): the
// clamps, d > 0, v != 0, the NaN-to-slice-0 rule, the zero CoM where no
// slice qualifies and the keep-the-old-CoM rule of a round with no pixel.
//
// Bound on this card: bytes.  Passes 1 and 2 read every frame once each
// (two reads of the batch: 2 * 157 MB for 256 uint16 640 x 480 frames,
// 0.094 ms at 3.35 TB/s); the box rounds read only their boxes, a fraction
// of a frame each; the arithmetic is a few dozen operations a pixel.
//
// Arithmetic is IEEE throughout.  Do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 128, kTileH = 16;        // pass 2's tile of a frame
constexpr int kHaloW = kTileW + 2, kHaloH = kTileH + 2;
constexpr int kHaloPerThread = (kHaloW * kHaloH + kThreads - 1) / kThreads;
constexpr int kSegments = kTileH * (kTileW / 32);  // 32-pixel row segments
constexpr int kBoxBlocks = 2048;                // box rounds: blocks a call
constexpr int kMinMaxLoads = 4;                 // loads a thread in pass 1
constexpr int kMaxSteps = 127;                  // slice indices fit in int8
constexpr float kFixed = 1048576.0f;            // 2^20
constexpr double kUnfix = 1.0 / 1048576.0;
static_assert(kTileW % 32 == 0, "row segments of a warp");

// Per frame and slice: interior count, pixel count, sum of x, sum of y.
enum { kInterior, kCount, kSumX, kSumY, kBin };
// Per frame and round: pixels, pixels clamped to the near plane, sums of
// x, y and the fixed-point depths of the pixels not clamped.
enum { kN, kNear, kSx, kSy, kSd, kRound };
// Per frame: max key, inverted min key, NaN flag, any slice qualified.
enum { kMaxKey, kMinKey, kNan, kAnyOk, kStats };

struct Work {
  u64* hist;        // (b, steps, kBin)
  u64* sums;        // (b, rounds, kRound)
  unsigned* stats;  // (b, kStats)
  float* coms;      // (b, rounds, 3): round r's CoM, stored by round r + 1
};

struct Layout {
  size_t hist, sums, stats, coms, zeroed, total;
};

inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// The workspace's parts; [0, zeroed) is cleared at the start of a call.
inline Layout layout(int b, int steps, int rounds) {
  Layout l;
  l.hist = 0;
  l.sums = align16(l.hist + sizeof(u64) * b * steps * kBin);
  l.stats = align16(l.sums + sizeof(u64) * b * rounds * kRound);
  l.coms = align16(l.stats + sizeof(unsigned) * b * kStats);
  l.zeroed = l.coms;
  l.total = align16(l.coms + sizeof(float) * b * rounds * 3);
  return l;
}

struct Args {
  const void* frames;
  const float* cubes;  // (b, 3)
  float fx, fy, rfx, rfy, rsteps;
  int steps, interior_min, rounds, first_slice;
  int b, h, w;
  Work ws;
  float* out;          // (b, 3)
};

// ---------------------------------------------------------------------------
// per-pixel arithmetic
// ---------------------------------------------------------------------------

__device__ __forceinline__ float raw_at(const float* p, int64_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float raw_at(const uint16_t* p, int64_t i) {
  return static_cast<float>(__ldg(p + i));
}

// An unsigned key in the order of the floats (NaN aside).
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float float_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The frame's clamped depth range and slice width.
struct Frame {
  float mx, mn, dz;
};

__device__ __forceinline__ Frame frame_of(const Args& a, int b) {
  const unsigned* st = a.ws.stats + kStats * b;
  Frame f;
  if (st[kNan] != 0u) {
    f.mx = f.mn = __uint_as_float(0x7fc00000u);
  } else {
    f.mx = fminf(float_of(st[kMaxKey]), 6500.0f);
    f.mn = fmaxf(float_of(~st[kMinKey]), 10.0f);
  }
  f.dz = __fmul_rn(__fsub_rn(f.mx, f.mn), a.rsteps);
  return f;
}

// Out-of-range depths zeroed.
__device__ __forceinline__ float depth_of(float raw, const Frame& f) {
  return (raw > f.mx || raw < f.mn) ? 0.0f : raw;
}

// The slice of depth d: floor((d - min) / dz), NaN (a flat frame, 0 / 0)
// -> 0, clamped to [0, steps - 1]; -1 where d is 0.  Clamped in float
// before the conversion.
__device__ __forceinline__ int slice_of(float d, const Frame& f, int steps) {
  float q = floorf(__fdiv_rn(__fsub_rn(d, f.mn), f.dz));
  if (isnan(q)) q = 0.0f;
  q = fminf(fmaxf(q, 0.0f), static_cast<float>(steps - 1));
  return d > 0.0f ? static_cast<int>(q) : -1;
}

__device__ __forceinline__ u64 fixed_of(float d) {
  return __float2ull_rn(__fmul_rn(d, kFixed));
}

// The sum of the lane indices in a warp mask.
__device__ __forceinline__ unsigned lane_sum(unsigned m) {
  return __popc(m & 0xaaaaaaaau) + 2u * __popc(m & 0xccccccccu) +
         4u * __popc(m & 0xf0f0f0f0u) + 8u * __popc(m & 0xff00ff00u) +
         16u * __popc(m & 0xffff0000u);
}

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// {i in [0, n): i >= lo && i < hi} as [*a, *b); empty where either is NaN.
__device__ __forceinline__ void axis_range(float lo, float hi, int n, int* a,
                                           int* b) {
  if (!(lo < hi)) {
    *a = *b = 0;
    return;
  }
  const float cl = ceilf(lo), ch = ceilf(hi), fn = static_cast<float>(n);
  *a = cl <= 0.0f ? 0 : (cl >= fn ? n : static_cast<int>(cl));
  *b = ch <= 0.0f ? 0 : (ch >= fn ? n : static_cast<int>(ch));
}

// floor(fma(fma(c * z, r, half) / z, f, 0.5)): one edge of the 2D box, as
// warp.cu's edge and ops/kernels/warp.py's com_to_bounds compute it.
__device__ __forceinline__ float edge(float c, float z, float r, float f,
                                      float half) {
  return floorf(__fmaf_rn(
      __fdiv_rn(__fmaf_rn(__fmul_rn(c, z), r, half), z), f, 0.5f));
}

// ---------------------------------------------------------------------------
// pass 1: max and min
// ---------------------------------------------------------------------------

// Elements of one load: a 16-byte vector, or one element.
template <typename T, bool kVec>
__device__ __forceinline__ void load_unit(const T* frame, int64_t u,
                                          float* v) {
  if constexpr (!kVec) {
    v[0] = raw_at(frame, u);
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(frame) + u);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(frame) + u);
    const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = static_cast<float>(words[k] & 0xffffu);
      v[2 * k + 1] = static_cast<float>(words[k] >> 16);
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
detect_minmax_kernel(const Args a, int chunks) {
  constexpr int kPer = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kLoads = kVec ? kMinMaxLoads : 4 * kMinMaxLoads;
  __shared__ unsigned s_max[kWarps], s_min[kWarps], s_nan;
  const int b = blockIdx.x / chunks, chunk = blockIdx.x - b * chunks;
  const int64_t hw = static_cast<int64_t>(a.h) * a.w, units = hw / kPer;
  const T* frame = static_cast<const T*>(a.frames) + b * hw;
  if (threadIdx.x == 0) s_nan = 0u;
  float mx = -INFINITY, mn = INFINITY;
  bool nan = false;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int64_t u =
        (static_cast<int64_t>(chunk) * kLoads + j) * kThreads + threadIdx.x;
    if (u < units) {
      float v[kPer];
      load_unit<T, kVec>(frame, u, v);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (isnan(v[k])) {
          nan = true;
        } else {
          mx = fmaxf(mx, v[k]);
          mn = fminf(mn, v[k]);
        }
      }
    }
  }
  const unsigned kmax = __reduce_max_sync(0xffffffffu, key_of(mx));
  const unsigned kmin = __reduce_max_sync(0xffffffffu, ~key_of(mn));
  const bool any_nan = __any_sync(0xffffffffu, nan);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    s_max[warp] = kmax;
    s_min[warp] = kmin;
    if (any_nan) s_nan = 1u;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned bmax = s_max[0], bmin = s_min[0];
    for (int i = 1; i < kWarps; ++i) {
      bmax = max(bmax, s_max[i]);
      bmin = max(bmin, s_min[i]);
    }
    unsigned* st = a.ws.stats + kStats * b;
    atomicMax(st + kMaxKey, bmax);
    atomicMax(st + kMinKey, bmin);
    if (s_nan) atomicOr(st + kNan, 1u);
  }
}

// ---------------------------------------------------------------------------
// pass 2: slices, interior test, histogram and slice centroids
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
detect_slice_kernel(const Args a, int tiles_x, int tiles) {
  __shared__ int8_t s_tile[kHaloH * kHaloW];
  __shared__ unsigned s_bins[kBin][kMaxSteps + 1];
  const int b = blockIdx.x / tiles, t = blockIdx.x - b * tiles;
  const int x0 = (t % tiles_x) * kTileW, y0 = (t / tiles_x) * kTileH;
  const Frame f = frame_of(a, b);
  const T* frame = static_cast<const T*>(a.frames) +
                   static_cast<int64_t>(b) * a.h * a.w;
  for (int i = threadIdx.x; i < kBin * (kMaxSteps + 1); i += kThreads) {
    (&s_bins[0][0])[i] = 0u;
  }
  // every load of this thread first, then the slices
  float raw[kHaloPerThread];
  unsigned inside = 0u;
#pragma unroll
  for (int j = 0; j < kHaloPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int y = y0 + i / kHaloW - 1, x = x0 + i % kHaloW - 1;
    raw[j] = 0.0f;
    if (i < kHaloH * kHaloW && y >= 0 && y < a.h && x >= 0 && x < a.w) {
      raw[j] = raw_at(frame, static_cast<int64_t>(y) * a.w + x);
      inside |= 1u << j;
    }
  }
#pragma unroll
  for (int j = 0; j < kHaloPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < kHaloH * kHaloW) {
      s_tile[i] = static_cast<int8_t>(
          (inside >> j) & 1u ? slice_of(depth_of(raw[j], f), f, a.steps)
                             : -2);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int seg = threadIdx.x >> 5; seg < kSegments; seg += kWarps) {
    const int r = seg / (kTileW / 32), c0 = (seg % (kTileW / 32)) * 32;
    const int c = c0 + lane;
    const int s = s_tile[(r + 1) * kHaloW + c + 1];
    bool interior = s >= 0;
    if (interior) {
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          interior &= s_tile[(r + dr) * kHaloW + c + dc] == s;
        }
      }
    }
    const int key = s >= a.first_slice ? s : -1;
    // most segments lie in one slice (or none): one vote for them
    const unsigned peers =
        __all_sync(0xffffffffu, key == __shfl_sync(0xffffffffu, key, 0))
            ? 0xffffffffu
            : __match_any_sync(0xffffffffu, key);
    const unsigned inner = __ballot_sync(0xffffffffu, interior);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      const unsigned n = __popc(peers), ni = __popc(peers & inner);
      atomicAdd(&s_bins[kCount][key], n);
      if (ni != 0u) atomicAdd(&s_bins[kInterior][key], ni);
      atomicAdd(&s_bins[kSumX][key],
                n * static_cast<unsigned>(x0 + c0) + lane_sum(peers));
      atomicAdd(&s_bins[kSumY][key], n * static_cast<unsigned>(y0 + r));
    }
  }
  __syncthreads();
  u64* hist = a.ws.hist + static_cast<int64_t>(b) * a.steps * kBin;
  for (int k = a.first_slice + threadIdx.x; k < a.steps; k += kThreads) {
    if (s_bins[kCount][k] == 0u) continue;
#pragma unroll
    for (int q = 0; q < kBin; ++q) {
      if (s_bins[q][k] != 0u) atomicAdd(hist + k * kBin + q, s_bins[q][k]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 3: the box rounds
// ---------------------------------------------------------------------------

struct Box {
  int x0, x1, y0, y1;  // the pixels [x0, x1) x [y0, y1)
  float lo, hi;        // round 0: the selected slice's depth window
  float zs, ze;        // refine rounds: near clamp and far cut
};

__device__ __forceinline__ float half_cube(const Args& a, int b, int axis) {
  return __fmul_rn(a.cubes[3 * b + axis], 0.5f);  // x / 2, exactly
}

// Round r's CoM from its sums: the masked mean, or round r - 1's CoM
// where a refine round counted no pixel.
__device__ float3 com_of(const Args& a, int b, int r) {
  const u64* s = a.ws.sums + (static_cast<int64_t>(b) * a.rounds + r) * kRound;
  float3 prev = make_float3(0.0f, 0.0f, 0.0f);
  if (r > 0) {
    const float* p =
        a.ws.coms + (static_cast<int64_t>(b) * a.rounds + r - 1) * 3;
    prev = make_float3(p[0], p[1], p[2]);
    if (s[kN] == 0) return prev;
  }
  const double n = static_cast<double>(s[kN] > 0 ? s[kN] : 1ull);
  double sd = static_cast<double>(s[kSd]) * kUnfix;
  if (s[kNear] != 0) {
    const float zs = __fsub_rn(prev.z, half_cube(a, b, 2));
    sd += static_cast<double>(s[kNear]) * static_cast<double>(zs);
  }
  return make_float3(static_cast<float>(static_cast<double>(s[kSx]) / n),
                     static_cast<float>(static_cast<double>(s[kSy]) / n),
                     static_cast<float>(sd / n));
}

// Round 0 (warp 0 of the block): the first qualifying slice, its
// centroid, the +-100 px box and the z window.
__device__ void select_box(const Args& a, int b, const Frame& f, bool lead,
                           Box* box) {
  const int lane = threadIdx.x & 31;
  const u64* hist = a.ws.hist + static_cast<int64_t>(b) * a.steps * kBin;
  int first = -1;
  for (int base = a.first_slice; base < a.steps; base += 32) {
    const int k = base + lane;
    const bool ok = k < a.steps &&
                    hist[k * kBin + kInterior] >=
                        static_cast<u64>(a.interior_min);
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (m != 0u) {
      first = base + __ffs(m) - 1;
      break;
    }
  }
  if (lane != 0) return;
  if (lead) a.ws.stats[kStats * b + kAnyOk] = first >= 0;
  const int k = first >= 0 ? first : a.first_slice;
  const u64* bin = hist + k * kBin;
  const double n = static_cast<double>(bin[kCount] > 0 ? bin[kCount] : 1ull);
  const float cx =
      rintf(static_cast<float>(static_cast<double>(bin[kSumX]) / n));
  const float cy =
      rintf(static_cast<float>(static_cast<double>(bin[kSumY]) / n));
  axis_range(fmaxf(__fsub_rn(cx, 100.0f), 0.0f),
             fminf(__fadd_rn(cx, 100.0f), static_cast<float>(a.w - 1)), a.w,
             &box->x0, &box->x1);
  axis_range(fmaxf(__fsub_rn(cy, 100.0f), 0.0f),
             fminf(__fadd_rn(cy, 100.0f), static_cast<float>(a.h - 1)), a.h,
             &box->y0, &box->y1);
  const float kf = static_cast<float>(k);
  box->lo = __fmaf_rn(kf, f.dz, f.mn);
  box->hi = __fmaf_rn(__fadd_rn(kf, 1.0f), f.dz, f.mn);
}

// Refine round r (thread 0 of the block): the box and z range of round
// r - 1's CoM, which the frame's first block stores for round r + 1.
__device__ void refine_box(const Args& a, int b, int r, bool lead, Box* box) {
  const float3 c = com_of(a, b, r - 1);
  if (lead) {
    float* p = a.ws.coms + (static_cast<int64_t>(b) * a.rounds + r - 1) * 3;
    p[0] = c.x;
    p[1] = c.y;
    p[2] = c.z;
  }
  const float hx = half_cube(a, b, 0), hy = half_cube(a, b, 1),
              hz = half_cube(a, b, 2);
  box->zs = __fsub_rn(c.z, hz);
  box->ze = __fadd_rn(c.z, hz);
  axis_range(edge(c.x, c.z, a.rfx, a.fx, -hx), edge(c.x, c.z, a.rfx, a.fx, hx),
             a.w, &box->x0, &box->x1);
  axis_range(edge(c.y, c.z, a.rfy, a.fy, -hy), edge(c.y, c.z, a.rfy, a.fy, hy),
             a.h, &box->y0, &box->y1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
detect_box_kernel(const Args a, int per_frame, int round) {
  __shared__ Box s_box;
  __shared__ u64 s_red[kRound][kWarps];
  const int b = blockIdx.x / per_frame, j = blockIdx.x - b * per_frame;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Frame f = frame_of(a, b);
  if (round == 0) {
    if (warp == 0) select_box(a, b, f, j == 0, &s_box);
  } else if (threadIdx.x == 0) {
    refine_box(a, b, round, j == 0, &s_box);
  }
  __syncthreads();
  const Box box = s_box;
  if (box.y0 + j * kWarps >= box.y1 || box.x0 >= box.x1) return;
  // warp w of block j takes rows y0 + j * kWarps + w, then every
  // per_frame * kWarps rows
  unsigned n = 0, near = 0;
  u64 sx = 0, sy = 0, sd = 0;
  for (int y = box.y0 + j * kWarps + warp; y < box.y1;
       y += per_frame * kWarps) {
    const T* row = static_cast<const T*>(a.frames) +
                   (static_cast<int64_t>(b) * a.h + y) * a.w;
    for (int x = box.x0 + lane; x < box.x1; x += 32) {
      const float d = depth_of(raw_at(row, x), f);
      if (round == 0) {
        if (d >= box.lo && d <= box.hi && d > 0.0f) {
          ++n;
          sx += x;
          sy += y;
          sd += fixed_of(d);
        }
      } else {
        // near clamp, far cut, then the range test, as the plain version
        float v = d;
        const bool clamped = v < box.zs && v != 0.0f;
        if (clamped) v = box.zs;
        if (v > box.ze) v = 0.0f;
        if (v >= f.mn && v <= f.mx && v != 0.0f) {
          ++n;
          sx += x;
          sy += y;
          if (clamped) {
            ++near;
          } else {
            sd += fixed_of(v);
          }
        }
      }
    }
  }
  n = __reduce_add_sync(0xffffffffu, n);
  near = __reduce_add_sync(0xffffffffu, near);
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  sd = warp_sum(sd);
  if (lane == 0) {
    s_red[kN][warp] = n;
    s_red[kNear][warp] = near;
    s_red[kSx][warp] = sx;
    s_red[kSy][warp] = sy;
    s_red[kSd][warp] = sd;
  }
  __syncthreads();
  if (threadIdx.x < kRound) {
    u64 v = 0;
    for (int i = 0; i < kWarps; ++i) v += s_red[threadIdx.x][i];
    u64* sums =
        a.ws.sums + (static_cast<int64_t>(b) * a.rounds + round) * kRound;
    if (v != 0) atomicAdd(sums + threadIdx.x, v);
  }
}

// ---------------------------------------------------------------------------
// pass 4: the CoMs
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
detect_finalize_kernel(const Args a) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= a.b) return;
  const float3 c = com_of(a, b, a.rounds - 1);
  const bool ok = a.ws.stats[kStats * b + kAnyOk] != 0u;
  a.out[3 * b] = ok ? c.x : 0.0f;
  a.out[3 * b + 1] = ok ? c.y : 0.0f;
  a.out[3 * b + 2] = ok ? c.z : 0.0f;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

inline bool grid_fits(int64_t blocks) {
  return blocks > 0 && blocks <= INT_MAX;
}

template <typename T, bool kVec>
int launch_minmax(const Args& a, cudaStream_t s) {
  constexpr int kPer = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kLoads = kVec ? kMinMaxLoads : 4 * kMinMaxLoads;
  const int64_t units = static_cast<int64_t>(a.h) * a.w / kPer;
  const int64_t chunks = (units + kLoads * kThreads - 1) / (kLoads * kThreads);
  if (!grid_fits(chunks * a.b)) return -1;
  detect_minmax_kernel<T, kVec><<<static_cast<int>(chunks * a.b), kThreads, 0,
                                  s>>>(a, static_cast<int>(chunks));
  return 0;
}

template <typename T>
int launch_type(const Args& a, cudaStream_t s) {
  // pass 1 reads 16 bytes a load where every frame starts 16-byte aligned
  const int per = 16 / static_cast<int>(sizeof(T));
  const bool vec = (static_cast<int64_t>(a.h) * a.w) % per == 0 &&
                   (reinterpret_cast<uintptr_t>(a.frames) & 15u) == 0;
  const int rc =
      vec ? launch_minmax<T, true>(a, s) : launch_minmax<T, false>(a, s);
  if (rc != 0) return -1;
  const int tiles_x = (a.w + kTileW - 1) / kTileW;
  const int64_t tiles =
      static_cast<int64_t>(tiles_x) * ((a.h + kTileH - 1) / kTileH);
  // about kBoxBlocks blocks a box round (a few waves of the card), and
  // no more a frame than there are kWarps-row bands in it
  const int bands = (a.h + kWarps - 1) / kWarps;
  const int per_frame =
      max(1, min(bands, (kBoxBlocks + a.b - 1) / a.b));
  if (!grid_fits(tiles * a.b) ||
      !grid_fits(static_cast<int64_t>(per_frame) * a.b)) {
    return -1;
  }
  detect_slice_kernel<T><<<static_cast<int>(tiles * a.b), kThreads, 0, s>>>(
      a, tiles_x, static_cast<int>(tiles));
  for (int r = 0; r < a.rounds; ++r) {
    detect_box_kernel<T><<<per_frame * a.b, kThreads, 0, s>>>(a, per_frame,
                                                            r);
  }
  detect_finalize_kernel<<<(a.b + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      a);
  return 0;
}

}  // namespace

// Bytes of the workspace a call needs (a uint8 tensor of at least this
// size, 16-byte aligned), or -1 where it would not fit in an int.
extern "C" int lsps_detect_workspace(int b, int steps, int refine_iters) {
  if (b < 0 || steps < 1 || steps > kMaxSteps || refine_iters < 0) return -1;
  const size_t total = layout(b, steps, 1 + refine_iters).total;
  return total > static_cast<size_t>(INT_MAX) ? -1 : static_cast<int>(total);
}

// frames (b, h, w), frame_dtype 0 = float32, 1 = uint16; cubes (b, 3)
// float32; out (b, 3) float32; work as lsps_detect_workspace sizes it.  fx,
// fy are the focal lengths and rfx, rfy, rsteps the float32 reciprocals of
// fx, fy and steps, each rounded on the host.  interior_min in
// [0, INT_MAX], 0 <= first_slice < steps <= 127, h * w < 2^31, h and w at
// most 65535.  Returns cudaGetLastError() after the launches (0 on
// success), or -1 for arguments the kernels do not take.
extern "C" int lsps_detect_coms(const void* frames, int frame_dtype,
                                const void* cubes, float fx, float fy,
                                float rfx, float rfy, float rsteps, int steps,
                                int interior_min, int refine_iters,
                                int first_slice, void* work, void* out, int b,
                                int h, int w, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || h > 65535 || w > 65535 ||
      static_cast<int64_t>(h) * w > INT_MAX || steps < 1 ||
      steps > kMaxSteps || first_slice < 0 || first_slice >= steps ||
      interior_min < 0 || refine_iters < 0) {
    return -1;
  }
  const int rounds = 1 + refine_iters;
  const Layout l = layout(b, steps, rounds);
  char* base = static_cast<char*>(work);
  Args a = {};
  a.frames = frames;
  a.cubes = static_cast<const float*>(cubes);
  a.fx = fx;
  a.fy = fy;
  a.rfx = rfx;
  a.rfy = rfy;
  a.rsteps = rsteps;
  a.steps = steps;
  a.interior_min = interior_min;
  a.rounds = rounds;
  a.first_slice = first_slice;
  a.b = b;
  a.h = h;
  a.w = w;
  a.ws.hist = reinterpret_cast<u64*>(base + l.hist);
  a.ws.sums = reinterpret_cast<u64*>(base + l.sums);
  a.ws.stats = reinterpret_cast<unsigned*>(base + l.stats);
  a.ws.coms = reinterpret_cast<float*>(base + l.coms);
  a.out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(work, 0, l.zeroed, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc;
  switch (frame_dtype) {
    case 0: rc = launch_type<float>(a, s); break;
    case 1: rc = launch_type<uint16_t>(a, s); break;
    default: return -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
