// The associative operators of the port's carried sweeps, and the warp
// shuffle they scan with.  Every sweep is one launch now: K1 (scan.cu), K2
// and K3 (level.cu) run the decoupled look-back of lookback_scan.cuh, K4
// (promote.cu) its own kernel on that header's tile states, and K6's carry
// scan (leaf_levels.cu `carry_scan`) one block a level.
//
// The Pallas kernels they replace (point_cloud_viewer_tpu/ops/scan_pallas.py,
// ops/level_pallas.py) keep a running carry in SMEM across a grid that the
// TPU runs in order.  An operator here is `T`, `identity()` and
// `combine(a, b)`, where a is the earlier part of the sweep; it need not
// commute.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace pcv {
namespace {

struct MaxOp {
  using T = int;
  __device__ static T identity() { return INT_MIN; }
  __device__ static T combine(T a, T b) { return a > b ? a : b; }
};

struct MinOp {
  using T = int;
  __device__ static T identity() { return INT_MAX; }
  __device__ static T combine(T a, T b) { return a < b ? a : b; }
};

struct SumOp {
  using T = int;
  __device__ static T identity() { return 0; }
  // Two's-complement wrap, as the i32 cumsum it mirrors.
  __device__ static T combine(T a, T b) {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  }
};

__device__ __forceinline__ int shfl_up(int v, int d) {
  return __shfl_up_sync(0xffffffffu, v, d);
}

}  // namespace
}  // namespace pcv
