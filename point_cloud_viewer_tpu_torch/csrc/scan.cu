// K1: inclusive prefix or suffix scan of a 1-D int32 array under max, min
// or sum; bit-equal to torch.cummax / cummin / cumsum (and their flips).
//
// Replaces the Pallas kernel point_cloud_viewer_tpu/ops/scan_pallas.py
// scan_1d -> _scan_padded (the pl.pallas_call at scan_pallas.py:148, body
// _make_kernel :115 with _scan_block_fwd/_rev :67-112), which sweeps
// (2048, 128) blocks in grid order with an SMEM carry.
//
// Bound: device-memory bytes, 8 B per element (the input read once, the
// output written once).  Design: the one-launch decoupled look-back scan of
// lookback_scan.cuh, which reads each element once with 16-B loads,
// neighbouring lanes on neighbouring addresses, and writes it once the same
// way; the only other traffic is one 8-B tile state per 8192 elements and
// the memset that clears them.  A reverse scan walks the same physical
// tiles in reverse, so nothing is flipped in memory.  Integer max and min
// are exact and the sum wraps in two's complement, so any grouping gives
// the same bits.
//
// C interface (loaded with ctypes): every entry returns the first CUDA
// error of its launches; pointers are device pointers, `stream` a
// cudaStream_t.

#include "lookback_scan.cuh"

namespace pcv {
namespace {

struct LoadI32 {
  using In = int;
  const int* p;
  __device__ int lift(long long, int v) const { return v; }
  __device__ bool closes(int) const { return false; }
};

struct StoreInclusive {
  int* out;
  __device__ int value(int, int incl) const { return incl; }
};

template <class Op>
cudaError_t scan_dir(const int* x, int* out, long long n, bool reverse,
                     unsigned long long* scratch, cudaStream_t stream) {
  LoadI32 src{x};
  StoreInclusive epi{out};
  return reverse ? run_lookback<Op, true>(src, epi, n, scratch, stream)
                 : run_lookback<Op, false>(src, epi, n, scratch, stream);
}

}  // namespace
}  // namespace pcv

extern "C" {

// Elements per tile of the three-launch skeleton (K3): the caller
// allocates ceil(n / tile) aggregates.
int pcv_tile_elems() { return pcv::kTile; }

// Elements per tile of the look-back scan (K1, K2): the caller allocates
// ceil(n / tile) + 1 u64 words of scratch.
int pcv_lookback_tile_elems() { return pcv::kLbTile; }

const char* pcv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kind: 0 max, 1 min, 2 sum.  `scratch`: ceil(n / 8192) + 1 u64 words,
// cleared here on `stream`.
int pcv_scan_i32(const int* x, int* out, long long n, int kind, int reverse,
                 unsigned long long* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return pcv::scan_dir<pcv::MaxOp>(x, out, n, reverse, scratch, s);
    case 1: return pcv::scan_dir<pcv::MinOp>(x, out, n, reverse, scratch, s);
    case 2: return pcv::scan_dir<pcv::SumOp>(x, out, n, reverse, scratch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
