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
// Bound: device-memory bytes.  Both are one launch after one memset of the
// scratch: the decoupled look-back scan of lookback_scan.cuh, which reads b
// once with one 16-B load of 16 bytes a lane.
//   K2 (forward running max) writes seg_start once, staged through shared
//   memory so that it goes out as 16 B a lane: 5 B an element, its bound.
//   A tile holding a segment start knows its inclusive prefix (its last
//   start) without its predecessors, so look-backs stop at the nearest tile
//   with a start.
//   K3 (reverse running min of the next start) is the look-back's in-place
//   epilogue: a lane reads seg_start (4 x 16 B) and found (16 B) for its
//   16 elements, and only where one of them changes reads leaf (16 B) and
//   stores leaf and found (16 B each): 6 B an element plus the chunks that
//   change.  The function's least bytes are 6 an element plus 2 a row that
//   changes (leaf and found written).  A reverse sweep reaches a tile after
//   every tile to its right, and the least start of a tile that holds one
//   lies below all their indices: so its aggregate is its inclusive prefix,
//   and look-backs stop at the nearest tile (to the right) with a start.
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
  using In = uint8_t;
  const uint8_t* p;
  int level;
  int n;
  __device__ int lift(long long i, uint8_t b) const {
    return b <= level ? static_cast<int>(i) : n;
  }
  // A tile holding a start (agg < n): its least start is below every index
  // after the tile, so the aggregate alone is its inclusive prefix.
  __device__ bool closes(int agg) const { return agg < n; }
};

struct LeafUpdate {
  using InPlace = void;
  const int* seg_start;
  uint8_t* leaf;
  uint8_t* found;
  int level;
  int threshold;
  int n;

  // seg_end: the exclusive suffix-min, identity (INT_MAX) -> n.
  __device__ int value(int excl, int) const { return excl < n ? excl : n; }

  uintptr_t bases() const {
    return reinterpret_cast<uintptr_t>(seg_start) |
           reinterpret_cast<uintptr_t>(leaf) |
           reinterpret_cast<uintptr_t>(found);
  }

  __device__ bool small(int seg_end, int start) const {
    return seg_end - start <= threshold;
  }

  // The 16 elements of a lane's chunk at physical index `at`.
  template <bool VEC, int W>
  __device__ void apply(long long at, long long count,
                        const int (&seg_end)[W]) const {
    static_assert(W == 16, "a 16-B chunk of u8 b");
    if (VEC && at + W <= count) {
      union {
        uint4 v;
        uint8_t e[16];
      } lf, fd;
      union {
        int4 v[4];
        int e[16];
      } ss;
      fd.v = *reinterpret_cast<const uint4*>(found + at);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ss.v[q] = __ldg(reinterpret_cast<const int4*>(seg_start + at) + q);
      }
      unsigned set = 0;  // bit k: row at + k is set at this level
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (!fd.e[k] && small(seg_end[k], ss.e[k])) set |= 1u << k;
      }
      // leaf is read, and both arrays written, only where a row changes.
      if (set) {
        lf.v = *reinterpret_cast<const uint4*>(leaf + at);
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if (set >> k & 1u) {
            lf.e[k] = static_cast<uint8_t>(level);
            fd.e[k] = 1;
          }
        }
        *reinterpret_cast<uint4*>(leaf + at) = lf.v;
        *reinterpret_cast<uint4*>(found + at) = fd.v;
      }
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const long long i = at + k;
        if (i < count && !found[i] && small(seg_end[k], seg_start[i])) {
          leaf[i] = static_cast<uint8_t>(level);
          found[i] = 1;
        }
      }
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

// Updates leaf and found in place.  `scratch`: ceil(n / 8192) + 1 u64
// words, cleared here on `stream`.
int pcv_leaf_update(const uint8_t* b, const int* seg_start, uint8_t* leaf,
                    uint8_t* found, long long n, int level, int threshold,
                    unsigned long long* scratch, void* stream) {
  const int n32 = static_cast<int>(n);
  return pcv::run_lookback<pcv::MinOp, true>(
      pcv::LoadNextStart{b, level, n32},
      pcv::LeafUpdate{seg_start, leaf, found, level, threshold, n32}, n,
      scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
