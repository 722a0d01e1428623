// K5: the viewer's per-frame frustum cull + LOD screen size, one thread per
// (frame, node).  For node i of frame f:
//   * the corners of its cube: min + unit * edge (unit in {0, 1}^3, x
//     fastest), two values a coordinate;
//   * SAT separation against the frame's axes: the node is separated when,
//     on some axis, the corners' projection interval lies wholly above qmax
//     or below qmin;
//   * its screen size: each corner through rows 0, 1 and 3 of the 4x4
//     clip matrix, x/w and y/w clamped to [-1, 1], the area of their box;
//   * visible = !separated && num_points > 0, priority = visible ? size :
//     -inf.
//
// Replaces the Pallas kernel point_cloud_viewer_tpu/ops/culling_pallas.py
// _cull_pallas (the pl.pallas_call at culling_pallas.py:81, body _kernel
// :31), which tiles 512 nodes into VMEM with a fixed A_PAD = 32 axes, and
// the lax step it stands for (point_cloud_viewer_tpu/ops/culling.py:63-90),
// including the vmapped F-frame form (culling.py:95-97): blockIdx.y is the
// frame.
//
// Bound: instructions, then bytes.  A node reads 20 B (mins, edge, count)
// and writes 9 B (size, visible, priority) a frame; what it computes is
// what costs.  The design does only the work the function needs:
//   a. Inert axes dropped.  An axis whose query range is (-inf, +inf)
//      separates nothing (nothing is > +inf or < -inf, NaN included): the
//      session's padding (ops/culling.py pad_cull_axes).  The block's
//      prologue compacts the frame's other axes, in order, into shared
//      memory, and every thread loops over those alone.
//   b. Two corners an axis.  fl(c * u) is monotone in c for a fixed u and
//      fl(a + b) is monotone in each argument, so over the corner set
//      {x0, x1} x {y0, y1} x {z0, z1} the least ((x*ux + y*uy) + z*uz),
//      rounded as written, is its value at the corner that takes the
//      smaller term on each coordinate, the greatest at the other extreme,
//      as long as both are finite (an infinite term, or a NaN anywhere,
//      makes one of them infinite or NaN: the pair of terms is ordered so
//      that a NaN lands in at least one extreme).  An axis whose extreme is
//      not finite goes through all 8 corners with NaN-propagating min and
//      max, as the plain version does.  About 15 operations an axis
//      instead of about 120; the loop still stops at the first separating
//      axis.
//   c. Screen size from the 18 distinct products (each row times the two
//      values of each coordinate) and the 12 distinct (x, y) partial sums,
//      then each corner's ((x*r0 + y*r1) + z*r2) + r3, the 16 divisions,
//      the clamp and the min/max: the same operations on the same operands
//      as one product per corner and row.
// The frame's matrix rows and live axes sit in shared memory (every thread
// of a block reads the same ones: broadcasts), the six corner coordinates
// in registers.  a_cap is a runtime argument: the cull session grows it
// past 32 when a frustum needs more axes (culling.py:220-224).  What is
// left is mostly the screen size, about 400 instructions a node by count
// (16 IEEE divisions, the NaN-propagating clamp and min/max), which every
// node needs whether or not it is visible: the kernel stays
// instruction-bound (PERF.md).
//
// Rounding: every product, sum and quotient is a separately rounded IEEE
// op (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: nvcc contracts
// nothing into an FMA, and no division becomes a reciprocal), in the plain
// PyTorch version's order: corners min + unit * edge (so the low corner is
// min + 0 * edge: not min when min is -0 or edge is not finite), SAT
// (x*ax + y*ay) + z*az, clip ((x*m0 + y*m1) + z*m2) + m3.  min, max and
// the clamp propagate NaN as torch.minimum / maximum / clamp do (a cube
// that straddles w = 0 gives 0/0).  So the kernel is bit-equal to
// cull_lod_plain (point_cloud_viewer_tpu_torch/ops/cull_cuda.py); its
// rules are modelled on the CPU in tests/test_torch_cull.py.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace pcv {
namespace {

// One node a thread, 128 threads a block (other block shapes and several
// nodes a thread were no faster on one frame: PERF.md).
constexpr int kCullThreads = 128;
// (12 + 5 * a_cap) floats of shared memory must fit the default 48 KB.
constexpr int kCullMaxAxes = 2048;

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float clamp_unit(float v) {
  return v != v ? v : fminf(fmaxf(v, -1.0f), 1.0f);
}

// (lo, hi) of two terms: where either is NaN, lo or hi is NaN.
__device__ __forceinline__ void order2(float a, float b, float& lo,
                                       float& hi) {
  const bool lt = a < b;
  lo = lt ? a : b;
  hi = lt ? b : a;
}

// (x*ux + y*uy) + z*uz
__device__ __forceinline__ float project(float x, float y, float z,
                                         float4 u) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, u.x), __fmul_rn(y, u.y)),
                   __fmul_rn(z, u.z));
}

// The 8-corner test of one axis (u.w = qmin), for projections that are not
// finite: NaN-propagating min and max over the corners in order.
__device__ __noinline__ bool separated_8(float x0, float x1, float y0,
                                         float y1, float z0, float z1,
                                         float4 u, float qmax) {
  float b_min = 0.f, b_max = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float p = project(c & 1 ? x1 : x0, c & 2 ? y1 : y0,
                            c & 4 ? z1 : z0, u);
    b_min = c ? nan_min(b_min, p) : p;
    b_max = c ? nan_max(b_max, p) : p;
  }
  return b_min > qmax || b_max < u.w;
}

// One row of the clip matrix over the corners: the four (x, y) partial
// sums x*r0 + y*r1 (x fastest) and the two z*r2.
struct RowTerms {
  float xy[4];
  float z[2];
};

__device__ __forceinline__ RowTerms row_terms(float x0, float x1, float y0,
                                              float y1, float z0, float z1,
                                              float4 r) {
  const float px0 = __fmul_rn(x0, r.x), px1 = __fmul_rn(x1, r.x);
  const float py0 = __fmul_rn(y0, r.y), py1 = __fmul_rn(y1, r.y);
  RowTerms t;
  t.xy[0] = __fadd_rn(px0, py0);
  t.xy[1] = __fadd_rn(px1, py0);
  t.xy[2] = __fadd_rn(px0, py1);
  t.xy[3] = __fadd_rn(px1, py1);
  t.z[0] = __fmul_rn(z0, r.z);
  t.z[1] = __fmul_rn(z1, r.z);
  return t;
}

// Corner c's ((x*r0 + y*r1) + z*r2) + r3.
__device__ __forceinline__ float clip_at(const RowTerms& t, int c, float r3) {
  return __fadd_rn(__fadd_rn(t.xy[c & 3], t.z[c >> 2]), r3);
}

// A node's corner coordinates, two values each, as the plain version forms
// them: min + 0 * edge and min + 1 * edge.
struct Corners {
  float x0, x1, y0, y1, z0, z1;
};

__device__ __forceinline__ Corners corners(float mx, float my, float mz,
                                           float e) {
  return {__fadd_rn(mx, __fmul_rn(0.f, e)), __fadd_rn(mx, __fmul_rn(1.f, e)),
          __fadd_rn(my, __fmul_rn(0.f, e)), __fadd_rn(my, __fmul_rn(1.f, e)),
          __fadd_rn(mz, __fmul_rn(0.f, e)), __fadd_rn(mz, __fmul_rn(1.f, e))};
}

// SAT over the live axes, stopping at the first that separates.
__device__ __forceinline__ bool separated(const Corners& c,
                                         const float4* live_axes,
                                         const float* live_qmax, int live) {
  for (int a = 0; a < live; ++a) {
    const float4 u = live_axes[a];
    const float hi = live_qmax[a];
    float xl, xh, yl, yh, zl, zh;
    order2(__fmul_rn(c.x0, u.x), __fmul_rn(c.x1, u.x), xl, xh);
    order2(__fmul_rn(c.y0, u.y), __fmul_rn(c.y1, u.y), yl, yh);
    order2(__fmul_rn(c.z0, u.z), __fmul_rn(c.z1, u.z), zl, zh);
    const float p_min = __fadd_rn(__fadd_rn(xl, yl), zl);
    const float p_max = __fadd_rn(__fadd_rn(xh, yh), zh);
    const bool sep =
        fabsf(p_min) < CUDART_INF_F && fabsf(p_max) < CUDART_INF_F
            ? p_min > hi || p_max < u.w
            : separated_8(c.x0, c.x1, c.y0, c.y1, c.z0, c.z1, u, hi);
    if (sep) return true;
  }
  return false;
}

// The screen size: every corner through rows 0, 1 and 3 (rows[0..2]).
__device__ __forceinline__ float screen_size(const Corners& c,
                                             const float4* rows) {
  const RowTerms t0 = row_terms(c.x0, c.x1, c.y0, c.y1, c.z0, c.z1, rows[0]);
  const RowTerms t1 = row_terms(c.x0, c.x1, c.y0, c.y1, c.z0, c.z1, rows[1]);
  const RowTerms t3 = row_terms(c.x0, c.x1, c.y0, c.y1, c.z0, c.z1, rows[2]);
  float x_min = 0.f, x_max = 0.f, y_min = 0.f, y_max = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = clip_at(t3, k, rows[2].w);
    const float px = clamp_unit(__fdiv_rn(clip_at(t0, k, rows[0].w), w));
    const float py = clamp_unit(__fdiv_rn(clip_at(t1, k, rows[1].w), w));
    if (k == 0) {
      x_min = x_max = px;
      y_min = y_max = py;
    } else {
      x_min = nan_min(x_min, px);
      x_max = nan_max(x_max, px);
      y_min = nan_min(y_min, py);
      y_max = nan_max(y_max, py);
    }
  }
  return __fmul_rn(__fsub_rn(x_max, x_min), __fsub_rn(y_max, y_min));
}

// One thread per node of frame blockIdx.y, kCullThreads a block.
__global__ void __launch_bounds__(kCullThreads)
cull_kernel(const float* __restrict__ matrix,   // (F, 4, 4)
            const float* __restrict__ axes,     // (F, a_cap, 3)
            const float* __restrict__ qmin,     // (F, a_cap)
            const float* __restrict__ qmax,     // (F, a_cap)
            int a_cap,
            const float* __restrict__ mins,     // (K, 3)
            const float* __restrict__ edges,    // (K,)
            const int* __restrict__ num_points, // (K,)
            int k,
            float* __restrict__ sizes,          // (F, K)
            uint8_t* __restrict__ visible,      // (F, K)
            float* __restrict__ priority) {     // (F, K)
  constexpr int kWarps = kCullThreads / 32;
  extern __shared__ float4 smem[];
  float4* rows = smem;                 // matrix rows 0, 1 and 3
  float4* live_axes = smem + 3;        // (ux, uy, uz, qmin), a_cap at most
  float* live_qmax = reinterpret_cast<float*>(live_axes + a_cap);
  __shared__ int s_count[kWarps];
  const int f = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // The node's loads go out before the prologue's barriers.
  const long long i =
      static_cast<long long>(blockIdx.x) * kCullThreads + threadIdx.x;
  float mx = 0.f, my = 0.f, mz = 0.f, e = 0.f;
  int count = 0;
  if (i < k) {
    mx = mins[3 * i];
    my = mins[3 * i + 1];
    mz = mins[3 * i + 2];
    e = edges[i];
    count = num_points[i];
  }

  if (threadIdx.x < 12) {
    const int j = threadIdx.x;
    const int row = j < 8 ? j >> 2 : 3;
    reinterpret_cast<float*>(rows)[j] = matrix[f * 16 + row * 4 + (j & 3)];
  }
  // Compact the live axes in order: a ballot a warp, the warps' counts
  // through shared memory.
  const long long fa = static_cast<long long>(f) * a_cap;
  int live = 0;  // the same in every thread
  for (int base = 0; base < a_cap; base += kCullThreads) {
    const int a = base + threadIdx.x;
    bool keep = false;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    float hi = 0.f;
    if (a < a_cap) {
      u.w = qmin[fa + a];
      hi = qmax[fa + a];
      keep = !(u.w == -CUDART_INF_F && hi == CUDART_INF_F);
      u.x = axes[3 * (fa + a)];
      u.y = axes[3 * (fa + a) + 1];
      u.z = axes[3 * (fa + a) + 2];
    }
    const unsigned held = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(held);
    __syncthreads();
    int at = live;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      at += w < warp ? c : 0;
      live += c;
    }
    if (keep) {
      at += __popc(held & ((1u << lane) - 1u));
      live_axes[at] = u;
      live_qmax[at] = hi;
    }
    __syncthreads();  // s_count is rewritten by the next round
  }
  __syncthreads();  // rows (and the axes) for every thread
  if (i >= k) return;

  const Corners c = corners(mx, my, mz, e);
  const float size = screen_size(c, rows);
  const bool vis = count > 0 && !separated(c, live_axes, live_qmax, live);
  const long long o = static_cast<long long>(f) * k + i;
  sizes[o] = size;
  visible[o] = vis ? 1 : 0;
  priority[o] = vis ? size : -CUDART_INF_F;
}

}  // namespace
}  // namespace pcv

extern "C" {

int pcv_cull_max_axes() { return pcv::kCullMaxAxes; }

// One launch for F frames over K nodes; outputs are (F, K).  F and K must
// be > 0 (a grid of 0 is a launch error), F <= 65535, 0 <= a_cap <=
// pcv_cull_max_axes().
int pcv_cull(const float* matrix, const float* axes, const float* qmin,
             const float* qmax, int a_cap, int frames, const float* mins,
             const float* edges, const int* num_points, long long k,
             float* sizes, uint8_t* visible, float* priority, void* stream) {
  if (frames <= 0 || frames > 65535 || k <= 0 || k > INT32_MAX ||
      a_cap < 0 || a_cap > pcv::kCullMaxAxes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(
      static_cast<unsigned>((k + pcv::kCullThreads - 1) / pcv::kCullThreads),
      static_cast<unsigned>(frames));
  const size_t smem = (12 + 5 * static_cast<size_t>(a_cap)) * sizeof(float);
  pcv::cull_kernel<<<grid, pcv::kCullThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      matrix, axes, qmin, qmax, a_cap, mins, edges, num_points,
      static_cast<int>(k), sizes, visible, priority);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
