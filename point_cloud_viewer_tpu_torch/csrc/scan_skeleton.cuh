// Reduce-then-scan skeleton of K3 leaf_update (level.cu), the port's last
// three-launch sweep.  K1 (scan.cu), K2 (level.cu seg_start) and K4
// (promote.cu) run the one-launch decoupled look-back of lookback_scan.cuh,
// which shares the operators below, as does K6's carry scan
// (leaf_levels.cu).
//
// The Pallas kernels these replace (point_cloud_viewer_tpu/ops/scan_pallas.py,
// ops/level_pallas.py) keep a running carry in SMEM across a grid that the
// TPU runs in order.  CUDA blocks run in no set order, so a sweep here is
// three launches on one stream:
//
//   1. tile_reduce        one aggregate per tile of kTile elements;
//   2. agg_exclusive_scan one block turns the aggregates into each tile's
//                         carry-in (exclusive scan in sweep order);
//   3. tile_scan          each tile rescans its elements from its carry-in
//                         and hands (exclusive, inclusive) prefixes to a
//                         fused epilogue.
//
// A sweep is parameterised by
//   Op   the associative operator: `T`, `identity()`, `combine(a, b)`
//        (a is the earlier part of the sweep; Op need not commute);
//   Src  the fused prologue: `T load(i)` reads element i (physical index);
//   Epi  the fused epilogue: `store(i, excl, incl)`;
//   REV  sweep direction: a reverse sweep visits physical n-1 .. 0.
//
// Bound: device-memory bytes.  Pass 1 and pass 3 each read the operands
// once, pass 3 writes the outputs; pass 2 touches n / kTile aggregates.
// Layout: thread t of a tile owns kItems consecutive elements (a blocked
// arrangement read with scalar loads).  lookback_scan.cuh reads once, with
// 16-B coalesced loads; K3 is off the build path and stays here.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace pcv {
namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096 elements per block
constexpr int kAggThreads = 1024;

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

// Block-wide exclusive scan of one value per thread, in thread order.
// Every thread of the block must call it.  Returns the thread's exclusive
// prefix and writes the block aggregate to *total.
template <class Op>
__device__ typename Op::T block_exclusive_scan(typename Op::T v,
                                               typename Op::T* total) {
  using T = typename Op::T;
  __shared__ T warp_incl[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  T incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T up = shfl_up(incl, d);
    if (lane >= d) incl = Op::combine(up, incl);
  }
  T excl = shfl_up(incl, 1);
  if (lane == 0) excl = Op::identity();
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? warp_incl[lane] : Op::identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T up = shfl_up(w, d);
      if (lane >= d) w = Op::combine(up, w);
    }
    warp_incl[lane] = w;
  }
  __syncthreads();
  if (warp > 0) excl = Op::combine(warp_incl[warp - 1], excl);
  *total = warp_incl[nwarps - 1];
  __syncthreads();  // warp_incl is reused by the next call
  return excl;
}

template <class Op, bool REV, class Src>
__global__ void __launch_bounds__(kThreads)
tile_reduce(Src src, long long n, typename Op::T* agg) {
  using T = typename Op::T;
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  T acc = Op::identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long l = base + k;
    if (l < n) acc = Op::combine(acc, src.load(REV ? n - 1 - l : l));
  }
  T total;
  block_exclusive_scan<Op>(acc, &total);
  if (threadIdx.x == 0) agg[blockIdx.x] = total;
}

// One whole block, in place: agg[t] <- combine of the elements before t in
// sweep order (REV: the elements after t), i.e. the carry-in of tile t.
template <class Op, bool REV = false>
__device__ void block_exclusive_scan_in_place(typename Op::T* agg,
                                              long long num_tiles) {
  using T = typename Op::T;
  T carry = Op::identity();
  const long long per_round = static_cast<long long>(blockDim.x) * kItems;
  for (long long start = 0; start < num_tiles; start += per_round) {
    const long long base = start + static_cast<long long>(threadIdx.x) * kItems;
    T v[kItems];
    T acc = Op::identity();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long l = base + k;
      v[k] = l < num_tiles ? agg[REV ? num_tiles - 1 - l : l] : Op::identity();
      acc = Op::combine(acc, v[k]);
    }
    T total;
    T run = Op::combine(carry, block_exclusive_scan<Op>(acc, &total));
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long l = base + k;
      if (l < num_tiles) agg[REV ? num_tiles - 1 - l : l] = run;
      run = Op::combine(run, v[k]);
    }
    carry = Op::combine(carry, total);
  }
}

template <class Op>
__global__ void __launch_bounds__(kAggThreads)
agg_exclusive_scan(typename Op::T* agg, long long num_tiles) {
  block_exclusive_scan_in_place<Op>(agg, num_tiles);
}

template <class Op, bool REV, class Src, class Epi>
__global__ void __launch_bounds__(kThreads)
tile_scan(Src src, Epi epi, long long n, const typename Op::T* carry_in) {
  using T = typename Op::T;
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  T v[kItems];
  T acc = Op::identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long l = base + k;
    v[k] = l < n ? src.load(REV ? n - 1 - l : l) : Op::identity();
    acc = Op::combine(acc, v[k]);
  }
  T total;
  T run = Op::combine(carry_in[blockIdx.x],
                      block_exclusive_scan<Op>(acc, &total));
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long l = base + k;
    const T incl = Op::combine(run, v[k]);
    if (l < n) epi.store(REV ? n - 1 - l : l, run, incl);
    run = incl;
  }
}

inline long long num_tiles(long long n) { return (n + kTile - 1) / kTile; }

// The three launches of one sweep; `agg` holds num_tiles(n) values of
// Op::T, allocated by the caller.  Returns the first launch error.
template <class Op, bool REV, class Src, class Epi>
cudaError_t run_sweep(Src src, Epi epi, long long n, typename Op::T* agg,
                      cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const long long tiles = num_tiles(n);
  tile_reduce<Op, REV, Src><<<static_cast<unsigned>(tiles), kThreads, 0,
                              stream>>>(src, n, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  agg_exclusive_scan<Op><<<1, kAggThreads, 0, stream>>>(agg, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scan<Op, REV, Src, Epi><<<static_cast<unsigned>(tiles), kThreads, 0,
                                 stream>>>(src, epi, n, agg);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pcv
