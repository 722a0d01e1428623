// K5: the viewer's per-frame frustum cull + LOD screen size, one thread per
// (frame, node).  For node i of frame f:
//   * the 8 corners of its cube: min + unit * edge (unit in {0, 1}^3, x
//     fastest);
//   * SAT separation against the frame's a_cap axes: the node is
//     separated when, on some axis, the corners' projection interval lies
//     wholly above qmax or below qmin;
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
// Bound: f32 arithmetic, not bytes.  A node reads 20 B (mins, edge,
// count) and writes 9 B (size, visible, priority) per frame, but costs
// 8 x a_cap x 5 operations for SAT and ~8 x 20 for the screen size.  The
// frame's matrix rows and axes sit in shared memory (every thread of a
// block reads the same ones: broadcasts), the 24 corner coordinates in
// registers; the axis loop stops at the first separating axis.  a_cap is a
// runtime argument: the cull session grows it past 32 when a frustum needs
// more axes (culling.py:220-224).
//
// Rounding: every product, sum and quotient is a separately rounded IEEE
// op (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so nvcc contracts
// nothing into an FMA), in the plain PyTorch version's order: SAT
// (x*ax + y*ay) + z*az, clip ((x*m0 + y*m1) + z*m2) + m3.  min, max and
// the clamp propagate NaN as torch.minimum / maximum / clamp do (a cube
// that straddles w = 0 gives 0/0).  So the kernel is bit-equal to
// cull_lod_plain (point_cloud_viewer_tpu_torch/ops/cull_cuda.py).

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace pcv {
namespace {

constexpr int kCullThreads = 256;
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

// ((x*r0 + y*r1) + z*r2) + r3
__device__ __forceinline__ float clip_row(float x, float y, float z,
                                          const float* r) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(x, r[0]), __fmul_rn(y, r[1])),
                __fmul_rn(z, r[2])),
      r[3]);
}

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
  extern __shared__ float smem[];
  float* rows = smem;               // 12: matrix rows 0, 1 and 3
  float* ax = smem + 12;            // a_cap x 3
  float* lo = ax + 3 * a_cap;       // a_cap
  float* hi = lo + a_cap;           // a_cap
  const int f = blockIdx.y;
  for (int j = threadIdx.x; j < 12; j += blockDim.x) {
    const int row = j < 8 ? j >> 2 : 3;
    rows[j] = matrix[f * 16 + row * 4 + (j & 3)];
  }
  const long long fa = static_cast<long long>(f) * a_cap;
  for (int j = threadIdx.x; j < 3 * a_cap; j += blockDim.x) {
    ax[j] = axes[3 * fa + j];
  }
  for (int j = threadIdx.x; j < a_cap; j += blockDim.x) {
    lo[j] = qmin[fa + j];
    hi[j] = qmax[fa + j];
  }
  __syncthreads();

  const long long i =
      static_cast<long long>(blockIdx.x) * kCullThreads + threadIdx.x;
  if (i >= k) return;
  const float mx = mins[3 * i], my = mins[3 * i + 1], mz = mins[3 * i + 2];
  const float e = edges[i];

  float cx[8], cy[8], cz[8];
  float x_min = 0.f, x_max = 0.f, y_min = 0.f, y_max = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    cx[c] = __fadd_rn(mx, __fmul_rn(static_cast<float>(c & 1), e));
    cy[c] = __fadd_rn(my, __fmul_rn(static_cast<float>((c >> 1) & 1), e));
    cz[c] = __fadd_rn(mz, __fmul_rn(static_cast<float>((c >> 2) & 1), e));
    const float w = clip_row(cx[c], cy[c], cz[c], rows + 8);
    const float px =
        clamp_unit(__fdiv_rn(clip_row(cx[c], cy[c], cz[c], rows), w));
    const float py =
        clamp_unit(__fdiv_rn(clip_row(cx[c], cy[c], cz[c], rows + 4), w));
    if (c == 0) {
      x_min = x_max = px;
      y_min = y_max = py;
    } else {
      x_min = nan_min(x_min, px);
      x_max = nan_max(x_max, px);
      y_min = nan_min(y_min, py);
      y_max = nan_max(y_max, py);
    }
  }
  const float size =
      __fmul_rn(__fsub_rn(x_max, x_min), __fsub_rn(y_max, y_min));

  bool separated = false;
  for (int a = 0; a < a_cap && !separated; ++a) {
    const float ux = ax[3 * a], uy = ax[3 * a + 1], uz = ax[3 * a + 2];
    float b_min = 0.f, b_max = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float p = __fadd_rn(
          __fadd_rn(__fmul_rn(cx[c], ux), __fmul_rn(cy[c], uy)),
          __fmul_rn(cz[c], uz));
      if (c == 0) {
        b_min = b_max = p;
      } else {
        b_min = nan_min(b_min, p);
        b_max = nan_max(b_max, p);
      }
    }
    separated = b_min > hi[a] || b_max < lo[a];
  }

  const bool vis = !separated && num_points[i] > 0;
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
  const dim3 grid(static_cast<unsigned>((k + pcv::kCullThreads - 1) /
                                        pcv::kCullThreads),
                  static_cast<unsigned>(frames));
  const size_t smem = (12 + 5 * static_cast<size_t>(a_cap)) * sizeof(float);
  pcv::cull_kernel<<<grid, pcv::kCullThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      matrix, axes, qmin, qmax, a_cap, mins, edges, num_points,
      static_cast<int>(k), sizes, visible, priority);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
