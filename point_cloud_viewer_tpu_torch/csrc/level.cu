// K2-K3: the per-level sweeps of the leaf loop of the tree derivation,
// over the u8 boundary-level array `b` (b[i] <= level  <=>  a segment
// starts at i).  K4, the promotion, is csrc/promote.cu.
//
// Replace the Pallas kernels of point_cloud_viewer_tpu/ops/level_pallas.py:
//   K2 seg_start_pass   (:140, call :145, body _seg_start_kernel :52)
//   K3 leaf_update_pass (:160, call :166, body _leaf_update_kernel :68)
// which sweep (1024, 128) blocks in grid order with SMEM carries.  On the
// card the K6 leaf stage (leaf_levels.cu) replaced their loop on the build
// path; they run as its yardstick and on request.
//
// Bound: device-memory bytes.  Per level the Pallas design moves about
// 5 / 7 B per element (level_pallas.py:18-19).
//   K2 is the one-launch decoupled look-back scan of lookback_scan.cuh: it
//   reads b once with one 16-B load of 16 bytes a lane and writes seg_start
//   once, staged through shared memory so that it goes out as 16 B a lane:
//   5 B an element, its bound.  A tile holding a segment start knows its
//   inclusive prefix (its last start) without its predecessors, so look-
//   backs stop at the nearest tile with a start.
//   K3 is the reduce-then-scan skeleton of scan_skeleton.cuh, which reads
//   its inputs twice: about 7-10 B (b twice, seg_start, leaf/found read and
//   written only where they change).
// The prologue (b <= level) and the epilogue are fused into the sweep, so
// no i32 temporary other than seg_start is materialised.
//
// Every quantity is an exact integer, so each kernel is bit-equal to its
// plain PyTorch version (point_cloud_viewer_tpu_torch/ops/level_cuda.py).

#include "lookback_scan.cuh"

namespace pcv {
namespace {

// ---- K2: seg_start[i] = latest j <= i with b[j] <= level (running max).
struct LoadSegStart {
  using In = uint8_t;
  const uint8_t* p;
  int level;
  __device__ int lift(long long i, uint8_t b) const {
    return b <= level ? static_cast<int>(i) : 0;
  }
  // Positions grow along the sweep, so a tile past the first whose
  // aggregate is a start (> 0) holds the running max of everything so far.
  __device__ bool closes(int agg) const { return agg > 0; }
};

struct StoreSegStart {
  int* out;
  __device__ int value(int, int incl) const { return incl; }
};

// ---- K3: seg_end[i] = first j > i with b[j] <= level, else n: the
// EXCLUSIVE suffix-min of (b[j] <= level ? j : n).  Where the segment holds
// <= threshold points and no shallower level was small, leaf = level.
struct LoadNextStart {
  const uint8_t* b;
  int level;
  int n;
  __device__ int load(long long i) const {
    return b[i] <= level ? static_cast<int>(i) : n;
  }
};

struct LeafUpdate {
  const int* seg_start;
  uint8_t* leaf;
  uint8_t* found;
  int level;
  int threshold;
  int n;
  __device__ void store(long long i, int excl, int) const {
    const int seg_end = excl < n ? excl : n;  // identity (INT_MAX) -> n
    if (seg_end - seg_start[i] <= threshold && !found[i]) {
      leaf[i] = static_cast<uint8_t>(level);
      found[i] = 1;
    }
  }
};

}  // namespace
}  // namespace pcv

extern "C" {

// `scratch`: ceil(n / 8192) + 1 u64 words, cleared here on `stream`.
int pcv_seg_start(const uint8_t* b, int* seg_start, long long n, int level,
                  unsigned long long* scratch, void* stream) {
  return pcv::run_lookback<pcv::MaxOp, false>(
      pcv::LoadSegStart{b, level}, pcv::StoreSegStart{seg_start}, n, scratch,
      static_cast<cudaStream_t>(stream));
}

// Updates leaf and found in place.  `agg`: ceil(n / tile) int32 scratch.
int pcv_leaf_update(const uint8_t* b, const int* seg_start, uint8_t* leaf,
                    uint8_t* found, long long n, int level, int threshold,
                    int* agg, void* stream) {
  const int n32 = static_cast<int>(n);
  return pcv::run_sweep<pcv::MinOp, true>(
      pcv::LoadNextStart{b, level, n32},
      pcv::LeafUpdate{seg_start, leaf, found, level, threshold, n32}, n, agg,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
