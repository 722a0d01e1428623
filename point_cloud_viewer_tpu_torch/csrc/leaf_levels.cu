// K6: the leaf level of every point over all levels at once.
//
// Replaces the Pallas kernels of point_cloud_viewer_tpu/ops/tree_build_pallas.py
// (leaf_levels_pallas :150, calls :209 and :246; bodies _fwd_kernel :87 and
// _bwd_kernel :107).  For each point of SORTED codes: the first level l in
// 1..levels whose segment (the run of codes sharing the level-l prefix)
// holds <= max_points points, else `levels`.
//
// The Pallas design materialises an (n, 32) i32 segment-start tensor
// (128 B/pt: 2 GB at 16M points) between a forward and a backward sweep.
// Here nothing per level touches device memory.  The u8 boundary level b
// (ops/tree_build.py `_bound_levels`) holds every level's starts: row i
// starts a level-l segment iff b[i] <= l, for l <= depth; row 0 at every
// level; past `depth` no other row does (the Pallas kernel's invalid
// lanes).  Both carried sweeps, the running max of starts (forward) and
// the suffix min of starts (backward), follow the reduce-then-scan skeleton
// of scan_skeleton.cuh with one lane per level, in three launches:
//
//   1. leaf_tile_bounds  per tile and level, the first and the last start;
//   2. leaf_carry_scan   one block per (level, direction): each tile's
//                        carry-in, an exclusive max of the last starts
//                        before it / min of the first starts after it;
//   3. leaf_tile_assign  per tile, level by level: block scans give each
//                        row its segment start and end, and the first
//                        small level is kept in registers; the tile stops
//                        early once every row has its level.
//
// Bound: device-memory bytes are ~6 B/pt (b read twice, i32 leaf written),
// plus 2 x levels x 4 B per 4096-row tile of carries; the work is one block
// scan per level and direction, so the kernel is bound by instruction
// throughput and block barriers rather than by bytes.  Exact integers
// throughout: bit-equal to the plain PyTorch version
// (ops/leaf_levels_cuda.py).

#include "scan_skeleton.cuh"

namespace pcv {
namespace {

constexpr int kMaxLevels = 21;  // 63-bit codes: levels 1..21

__device__ __forceinline__ bool is_start(int bv, long long row, int level,
                                         int depth) {
  return row == 0 || (level <= depth && bv <= level);
}

// Loads a thread's kItems boundary levels; rows past n read 255 (no start).
__device__ __forceinline__ void load_bounds(const uint8_t* b, long long n,
                                            long long base, int* bv) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    bv[k] = base + k < n ? static_cast<int>(b[base + k]) : 255;
  }
}

// first[l * tiles + t] / last[l * tiles + t]: the first / last start of
// level l + 1 in tile t (INT_MAX / INT_MIN when it holds none).
__global__ void __launch_bounds__(kThreads)
leaf_tile_bounds(const uint8_t* b, long long n, int depth, int levels,
                 long long tiles, int* first, int* last) {
  __shared__ int s_first[kMaxLevels];
  __shared__ int s_last[kMaxLevels];
  if (threadIdx.x < kMaxLevels) {
    s_first[threadIdx.x] = INT_MAX;
    s_last[threadIdx.x] = INT_MIN;
  }
  __syncthreads();
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int bv[kItems];
  load_bounds(b, n, base, bv);
  for (int level = 1; level <= levels; ++level) {
    int lo = INT_MAX;
    int hi = INT_MIN;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k < n && is_start(bv[k], base + k, level, depth)) {
        const int row = static_cast<int>(base + k);
        lo = min(lo, row);
        hi = max(hi, row);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(&s_first[level - 1], lo);
      atomicMax(&s_last[level - 1], hi);
    }
  }
  __syncthreads();
  if (threadIdx.x < levels) {
    first[threadIdx.x * tiles + blockIdx.x] = s_first[threadIdx.x];
    last[threadIdx.x * tiles + blockIdx.x] = s_last[threadIdx.x];
  }
}

// grid (levels, 2): y = 0 turns last[level] into the exclusive running max
// over earlier tiles, y = 1 turns first[level] into the exclusive min over
// later tiles.
__global__ void __launch_bounds__(kAggThreads)
leaf_carry_scan(int* first, int* last, long long tiles) {
  const long long off = static_cast<long long>(blockIdx.x) * tiles;
  if (blockIdx.y == 0) {
    block_exclusive_scan_in_place<MaxOp, false>(last + off, tiles);
  } else {
    block_exclusive_scan_in_place<MinOp, true>(first + off, tiles);
  }
}

// Exclusive MinOp scan over the threads AFTER this one: the thread order is
// reversed through shared memory around the skeleton's block scan.
__device__ __forceinline__ int block_exclusive_min_after(int v, int* s_rev) {
  const int t = threadIdx.x;
  s_rev[kThreads - 1 - t] = v;
  __syncthreads();
  const int mine = s_rev[t];
  __syncthreads();
  int total;
  const int excl = block_exclusive_scan<MinOp>(mine, &total);
  s_rev[t] = excl;
  __syncthreads();
  const int after = s_rev[kThreads - 1 - t];
  __syncthreads();
  return after;
}

__global__ void __launch_bounds__(kThreads)
leaf_tile_assign(const uint8_t* b, long long n, int depth, int levels,
                 int max_points, long long tiles, const int* first_after,
                 const int* last_before, int* leaf) {
  __shared__ int s_rev[kThreads];
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  const int n32 = static_cast<int>(n);
  int bv[kItems];
  load_bounds(b, n, base, bv);
  int out[kItems];
  unsigned pending = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    out[k] = levels;
    if (base + k < n) pending |= 1u << k;
  }
  for (int level = 1; level <= levels; ++level) {
    // Uniform across the block, so every thread reaches the same scans.
    if (!__syncthreads_or(pending != 0)) break;
    const long long lane = static_cast<long long>(level - 1) * tiles;

    // Forward: the latest start at or before each row.
    int mine = INT_MIN;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k < n && is_start(bv[k], base + k, level, depth)) {
        mine = static_cast<int>(base + k);
      }
    }
    int total;
    int run = MaxOp::combine(last_before[lane + blockIdx.x],
                             block_exclusive_scan<MaxOp>(mine, &total));
    int seg_start[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k < n && is_start(bv[k], base + k, level, depth)) {
        run = static_cast<int>(base + k);
      }
      seg_start[k] = run;
    }

    // Backward: the first start strictly after each row, else n.
    int first = INT_MAX;
#pragma unroll
    for (int k = kItems - 1; k >= 0; --k) {
      if (base + k < n && is_start(bv[k], base + k, level, depth)) {
        first = static_cast<int>(base + k);
      }
    }
    int next = MinOp::combine(first_after[lane + blockIdx.x],
                              block_exclusive_min_after(first, s_rev));
#pragma unroll
    for (int k = kItems - 1; k >= 0; --k) {
      const int seg_end = next < n32 ? next : n32;
      if ((pending >> k & 1u) && seg_end - seg_start[k] <= max_points) {
        out[k] = level;
        pending &= ~(1u << k);
      }
      if (base + k < n && is_start(bv[k], base + k, level, depth)) {
        next = static_cast<int>(base + k);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k < n) leaf[base + k] = out[k];
  }
}

}  // namespace
}  // namespace pcv

extern "C" {

// b: (n,) u8 boundary levels of sorted codes; leaf: (n,) int32 out.
// `scratch`: 2 * levels * ceil(n / tile) int32.  1 <= levels <= 21.
int pcv_leaf_levels(const uint8_t* b, int* leaf, long long n, int depth,
                    int levels, int max_points, int* scratch, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (levels < 1 || levels > pcv::kMaxLevels) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = pcv::num_tiles(n);
  int* first = scratch;
  int* last = scratch + static_cast<long long>(levels) * tiles;
  pcv::leaf_tile_bounds<<<static_cast<unsigned>(tiles), pcv::kThreads, 0, s>>>(
      b, n, depth, levels, tiles, first, last);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pcv::leaf_carry_scan<<<dim3(levels, 2), pcv::kAggThreads, 0, s>>>(
      first, last, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pcv::leaf_tile_assign<<<static_cast<unsigned>(tiles), pcv::kThreads, 0, s>>>(
      b, n, depth, levels, max_points, tiles, first, last, leaf);
  return cudaGetLastError();
}

}  // extern "C"
