// K6: the leaf stage of the tree derivation in one pass from the sorted
// codes -- each point's u8 boundary level b and its leaf level.
//
// Replaces, on the build path, the lax `_bound_levels` of
// point_cloud_viewer_tpu/ops/tree_build.py (:163-178) and the leaf half of
// point_cloud_viewer_tpu/ops/level_pallas.py (K2 `seg_start_pass` :140 and
// K3 `leaf_update_pass` :160, once per level); and, as the public K6, the
// Pallas kernels of point_cloud_viewer_tpu/ops/tree_build_pallas.py
// (`leaf_levels_pallas` :150, calls :209 and :246; bodies `_fwd_kernel` :87
// and `_bwd_kernel` :107).
//
// What it computes.  Over SORTED int64 codes c, row i's boundary level is
//   x = c[i] ^ c[i - 1]  (row 0: c[0] ^ ~c[0], all ones),
//   b = x == 0 ? depth + 1 : max(depth - (63 - clz(x)) / 3, 0),
// and rows >= n_real are pad rows: the first gets 0, the rest depth + 1.
// Row i starts a level-l segment iff b[i] <= l.  A point's leaf level is
// the first level l in lo..hi whose segment holds <= max_points points,
// else hi.  Two start rules, one kernel:
//   * the build's (k6_rule = 0): b[i] <= l at every level, so past `depth`
//     every row starts a segment (the loop of ops/tree_build.py);
//   * the public K6's (k6_rule = 1): past `depth` only row 0 does, so the
//     one segment holds all n points (the Pallas kernel's invalid lanes).
//
// Bound: device-memory bytes.  The least traffic is the codes read once
// and b and the leaf written once: 8 + 1 + 1 = 10 B a point for the build
// (u8 leaf), 13 B for the public K6 (i32 leaf); this design moves 11 (14):
// b is read again by pass 3.  At n = 16,000,017 on an H100 (3.35 TB/s)
// 10 B a point is 0.048 ms.
//
// Design.  Starts nest: b[i] <= l implies b[i] <= l' for every l' >= l.  So
// one lane's starts at level l are one 32-bit mask over its 32 rows, made
// from its eight words of b by a byte-wise add (four rows an add), and a
// segment's count is the distance between two starts.  A warp owns a tile
// of 1024 rows and never waits on another warp: the passes that touch the
// points have no block barrier.
//   1. leaf_bounds   reads the codes with 16-B loads (two a lane, plus the
//                    code before the tile), computes b with __clzll, stages
//                    it in shared memory and writes it with 16-B stores;
//                    every level's first and last start in the tile: one
//                    ballot a level over the lanes' least b, then lane i
//                    masks the first and the last lane holding a start at
//                    level lo + i;
//   2. leaf_carry_scan  one block per (level, direction): each tile's
//                    carry, the last start before it and the first start
//                    after it, a shuffle scan over n / 1024 values a level
//                    with coalesced loads and stores;
//   3. leaf_assign   per level, lowest first, a lane's start mask, two warp
//                    shuffle scans (the last start before the lane and the
//                    first after it), and the counts of the few segment
//                    pieces inside its 32 rows; a warp stops once all its
//                    rows have their level.  b in and the leaf out go
//                    through shared memory, 16 B a lane on neighbouring
//                    addresses.
// No host sync and no allocation: the caller passes the scratch of
// 2 x levels x tiles int32 carries.
// Exact integers throughout: bit-equal to the plain PyTorch versions
// (ops/leaf_levels_cuda.py: `leaf_stage_plain`, `leaf_levels_plain`) and
// to the K2 + K3 loop it replaced (`leaf_stage_loop`).

#include "scan_skeleton.cuh"

namespace pcv {
namespace {

constexpr int kLeafMaxLevel = 21;  // 63-bit codes
constexpr int kLeafThreads = 256;
constexpr int kLeafWarps = kLeafThreads / 32;
constexpr int kLaneRows = 32;                 // rows a lane owns
constexpr int kWarpRows = 32 * kLaneRows;     // 1024 rows: a warp's tile
constexpr unsigned kFull = 0xffffffffu;

// Boundary level of a row whose XOR with the row before it is x; 0x7F for
// rows past n (never a start).
__device__ __forceinline__ unsigned bound_level(long long x, long long row,
                                                long long n, long long n_real,
                                                int depth) {
  if (row >= n) return 0x7Fu;
  if (row >= n_real) return row == n_real ? 0u : depth + 1u;
  if (x == 0) return depth + 1u;
  const int hsb = 63 - __clzll(x);  // x < 0: clz 0, so 63
  return static_cast<unsigned>(max(depth - hsb / 3, 0));
}

// Bit k set iff row k of the lane starts a segment at `level`: b <= level.
// Bytes hold b <= 22, or 0x7F for rows past n (never a start), so adding
// 0x7F - level to each byte carries into no other byte, and a byte's top
// bit stays clear exactly where b <= level.
__device__ __forceinline__ unsigned start_mask(const unsigned (&bw)[8],
                                               int level) {
  const unsigned add = static_cast<unsigned>(0x7F - level) * 0x01010101u;
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    // 0x01 in each byte that starts, then the four bytes' bits 0, 8, 16,
    // 24 gathered into bits 24-27 by one multiply.
    const unsigned le = (~(bw[q] + add) & 0x80808080u) >> 7;
    m |= ((le * 0x01020408u) >> 24) << (4 * q);
  }
  return m;
}

// start_mask of the 32 bytes of b at p (shared memory, 16-B aligned).
__device__ __forceinline__ unsigned lane_mask(const uint8_t* p, int level) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 c = *reinterpret_cast<const uint4*>(p + 16);
  const unsigned bw[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  return start_mask(bw, level);
}

// Bits [j, k) of a 32-bit mask, 0 <= j < k <= 32.
__device__ __forceinline__ unsigned bit_range(int j, int k) {
  const unsigned below_k = k == 32 ? kFull : (1u << k) - 1u;
  return below_k & ~((1u << j) - 1u);
}

// The lane's rows whose segment holds <= max_points rows, given its start
// mask m (row0 = the lane's first row), the last start before the lane
// and the first start after it (n when none).
__device__ __forceinline__ unsigned small_rows(unsigned m, int row0,
                                               int before, int after,
                                               int max_points) {
  if (m == 0) return after - before <= max_points ? kFull : 0u;
  int j = __ffs(m) - 1;
  unsigned small = 0;
  if (j > 0 && row0 + j - before <= max_points) small = (1u << j) - 1u;
  unsigned rest = m & (m - 1u);
  for (;;) {
    const int k = rest ? __ffs(rest) - 1 : 32;
    const int end = rest ? row0 + k : after;
    if (end - (row0 + j) <= max_points) small |= bit_range(j, k);
    if (!rest) return small;
    j = k;
    rest &= rest - 1u;
  }
}

// Pass 1: b, and per level the first and last start of each warp tile
// (first / last[(level - lo) * tiles + t]; INT_MAX / INT_MIN when none).
template <bool VEC>
__global__ void __launch_bounds__(kLeafThreads)
leaf_bounds(const long long* codes, uint8_t* b, long long n, long long n_real,
            int depth, int lo, int levels, long long tiles, int* first,
            int* last) {
  __shared__ __align__(16) uint8_t s_b[kLeafWarps][kWarpRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * kLeafWarps + warp;
  if (t >= tiles) return;  // whole warps only; no block barrier follows
  const long long base = t * kWarpRows;
  uint8_t* sb = s_b[warp];

  // Codes in 16 rounds of 64 rows, two consecutive codes a lane, so a
  // round is one coalesced 512-B load; the row before each pair comes from
  // the lane before (lane 0: the last code of the previous round).
  long long carry = base == 0 ? ~codes[0] : codes[base - 1];
#pragma unroll 4
  for (int r = 0; r < kWarpRows / 64; ++r) {
    const int off = r * 64 + 2 * lane;
    const long long at = base + off;
    long long c0, c1;
    if (VEC && at + 2 <= n) {
      const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(codes + at));
      c0 = v.x;
      c1 = v.y;
    } else {
      c0 = at < n ? codes[at] : 0;
      c1 = at + 1 < n ? codes[at + 1] : 0;
    }
    long long prev = __shfl_up_sync(kFull, c1, 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(kFull, c1, 31);
    const unsigned b0 = bound_level(c0 ^ prev, at, n, n_real, depth);
    const unsigned b1 = bound_level(c1 ^ c0, at + 1, n, n_real, depth);
    *reinterpret_cast<uint16_t*>(sb + off) =
        static_cast<uint16_t>(b0 | (b1 << 8));
  }
  __syncwarp();

  // b out: 512 B a warp-wide store.
#pragma unroll
  for (int q = 0; q < kWarpRows / 512; ++q) {
    const int off = q * 512 + lane * 16;
    const long long at = base + off;
    if (VEC && at + 16 <= n) {
      *reinterpret_cast<uint4*>(b + at) =
          *reinterpret_cast<const uint4*>(sb + off);
    } else {
      for (int k = 0; k < 16; ++k) {
        if (at + k < n) b[at + k] = sb[off + k];
      }
    }
  }

  // Every level's first and last start in the tile.  A ballot a level
  // finds the lanes holding a start (their least b is <= the level); then
  // lane i, for level lo + i, takes the first and the last of those lanes
  // and finds the start inside each from its 32 bytes in shared memory.
  const uint4 a = *reinterpret_cast<const uint4*>(sb + lane * kLaneRows);
  const uint4 c = *reinterpret_cast<const uint4*>(sb + lane * kLaneRows + 16);
  const unsigned bw[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  int least_of[8];  // a tree, not a chain of 32 dependent mins
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    least_of[q] = min(min(bw[q] & 0xFFu, (bw[q] >> 8) & 0xFFu),
                      min((bw[q] >> 16) & 0xFFu, bw[q] >> 24));
  }
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1) {
#pragma unroll
    for (int q = 0; q < w; ++q) least_of[q] = min(least_of[q], least_of[q + w]);
  }
  const int least = least_of[0];
  unsigned lanes = 0;  // lane i: the lanes holding a start at level lo + i
  for (int i = 0; i < levels; ++i) {
    const unsigned held = __ballot_sync(kFull, least <= lo + i);
    if (lane == i) lanes = held;
  }
  if (lane < levels) {
    int f = INT_MAX;
    int l = INT_MIN;
    if (lanes) {
      const int fl = __ffs(lanes) - 1;
      const int ll = 31 - __clz(lanes);
      f = static_cast<int>(base + fl * kLaneRows) +
          __ffs(lane_mask(sb + fl * kLaneRows, lo + lane)) - 1;
      l = static_cast<int>(base + ll * kLaneRows) + 31 -
          __clz(lane_mask(sb + ll * kLaneRows, lo + lane));
    }
    first[lane * tiles + t] = f;
    last[lane * tiles + t] = l;
  }
}

constexpr int kCarryThreads = 1024;
constexpr int kCarryItems = 16;  // values a lane holds in a round

// One block, in place: a[i] <- Op over the values before i in sweep order
// (REV: after i).  A warp takes 512 consecutive values a round, each of
// its 16 loads (and stores) 32 neighbouring values, and scans them with
// shuffles; one barrier pair a round joins the 32 warps.
template <class Op, bool REV>
__device__ void carry_scan(int* a, long long count) {
  __shared__ int s_warp[32];
  __shared__ int s_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr long long kRound = kCarryThreads * kCarryItems;
  int carry = Op::identity();
  for (long long start = 0; start < count; start += kRound) {
    const long long wbase = start + warp * (32 * kCarryItems);
    int v[kCarryItems];
#pragma unroll
    for (int k = 0; k < kCarryItems; ++k) {
      const long long i = wbase + k * 32 + lane;
      v[k] = i < count ? a[REV ? count - 1 - i : i] : Op::identity();
    }
    int run = Op::identity();
#pragma unroll
    for (int k = 0; k < kCarryItems; ++k) {
      int incl = v[k];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = Op::combine(up, incl);
      }
      int ex = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) ex = Op::identity();
      v[k] = Op::combine(run, ex);  // now exclusive within the warp's span
      run = Op::combine(run, __shfl_sync(kFull, incl, 31));
    }
    if (lane == 0) s_warp[warp] = run;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w = Op::combine(up, w);
      }
      int ex = __shfl_up_sync(kFull, w, 1);
      if (lane == 0) ex = Op::identity();
      s_warp[lane] = Op::combine(carry, ex);
      if (lane == 31) s_total = w;
    }
    __syncthreads();
    const int pre = s_warp[warp];
#pragma unroll
    for (int k = 0; k < kCarryItems; ++k) {
      const long long i = wbase + k * 32 + lane;
      if (i < count) a[REV ? count - 1 - i : i] = Op::combine(pre, v[k]);
    }
    carry = Op::combine(carry, s_total);
    __syncthreads();  // s_warp and s_total are rewritten next round
  }
}

// grid (levels, 2): y = 0 turns last[level] into the exclusive running max
// over earlier tiles, y = 1 turns first[level] into the exclusive min over
// later tiles.
__global__ void __launch_bounds__(kCarryThreads)
leaf_carry_scan(int* first, int* last, long long tiles) {
  const long long off = static_cast<long long>(blockIdx.x) * tiles;
  if (blockIdx.y == 0) {
    carry_scan<MaxOp, false>(last + off, tiles);
  } else {
    carry_scan<MinOp, true>(first + off, tiles);
  }
}

// Pass 3: each row's leaf level, lowest level first.  b comes in and the
// leaf goes out through the warp's kilobyte of shared memory, so every
// device-memory access is 16 B a lane on neighbouring addresses.
template <bool VEC, class OutT>
__global__ void __launch_bounds__(kLeafThreads)
leaf_assign(const uint8_t* b, OutT* leaf, long long n, int depth, int lo,
            int levels, int k6_rule, int max_points, long long tiles,
            const int* first_after, const int* last_before) {
  __shared__ __align__(16) uint8_t s_io[kLeafWarps][kWarpRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * kLeafWarps + warp;
  if (t >= tiles) return;  // whole warps only; no block barrier follows
  const long long base = t * kWarpRows;
  const long long row0 = base + lane * kLaneRows;
  uint8_t* io = s_io[warp];
#pragma unroll
  for (int q = 0; q < kWarpRows / 512; ++q) {
    const int off = q * 512 + lane * 16;
    const long long at = base + off;
    if (VEC && at + 16 <= n) {
      *reinterpret_cast<uint4*>(io + off) =
          __ldg(reinterpret_cast<const uint4*>(b + at));
    } else {
      for (int e = 0; e < 16; ++e) io[off + e] = at + e < n ? b[at + e] : 0x7F;
    }
  }
  __syncwarp();
  const uint4 ba = *reinterpret_cast<const uint4*>(io + lane * kLaneRows);
  const uint4 bc = *reinterpret_cast<const uint4*>(io + lane * kLaneRows + 16);
  const unsigned bw[8] = {ba.x, ba.y, ba.z, ba.w, bc.x, bc.y, bc.z, bc.w};
  const long long rem = n - row0;
  unsigned pending = rem >= kLaneRows ? kFull
                     : rem <= 0       ? 0u
                                      : (1u << rem) - 1u;
  const int hi = lo + levels - 1;
  unsigned out[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) out[q] = static_cast<unsigned>(hi) * 0x01010101u;
  const int n32 = static_cast<int>(n);
  const int r0 = static_cast<int>(min(row0, n));
  // The tile's carries, level lo + i in lane i, loaded up front so the
  // level loop does not wait on device memory.
  int carry_before = INT_MIN;
  int carry_after = INT_MAX;
  if (lane < levels) {
    carry_before = last_before[lane * tiles + t];
    carry_after = first_after[lane * tiles + t];
  }

  for (int i = 0; i < levels; ++i) {
    if (!__any_sync(kFull, pending)) break;  // warp-uniform
    const int level = lo + i;
    unsigned small;
    if (k6_rule && level > depth) {
      small = n <= max_points ? kFull : 0u;  // one segment: rows 0..n-1
    } else {
      const unsigned m = start_mask(bw, level);
      int incl = m ? r0 + 31 - __clz(m) : INT_MIN;
      int incl_b = m ? r0 + __ffs(m) - 1 : INT_MAX;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        const int dn = __shfl_down_sync(kFull, incl_b, d);
        if (lane >= d) incl = max(incl, up);
        if (lane + d < 32) incl_b = min(incl_b, dn);
      }
      int before = __shfl_up_sync(kFull, incl, 1);
      int after = __shfl_down_sync(kFull, incl_b, 1);
      if (lane == 0) before = INT_MIN;
      if (lane == 31) after = INT_MAX;
      before = max(before, __shfl_sync(kFull, carry_before, i));
      after = min(min(after, __shfl_sync(kFull, carry_after, i)), n32);
      small = small_rows(m, r0, before, after, max_points);
    }
    const unsigned now = small & pending;
    if (now) {
      const unsigned lv = static_cast<unsigned>(level) * 0x01010101u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        // Rows 4q..4q+3 of `now` spread to one 0xFF byte each.
        const unsigned nib = (now >> (4 * q)) & 0xFu;
        const unsigned bm = ((nib * 0x00204081u) & 0x01010101u) * 0xFFu;
        out[q] = (out[q] & ~bm) | (lv & bm);
      }
    }
    pending &= ~small;
  }

  // The leaf out through shared memory: the lane's 32 u8 levels, then 16 B
  // a lane on neighbouring addresses (u8) or 4 levels widened to an int4.
  __syncwarp();  // every lane has read its b
  *reinterpret_cast<uint4*>(io + lane * kLaneRows) =
      make_uint4(out[0], out[1], out[2], out[3]);
  *reinterpret_cast<uint4*>(io + lane * kLaneRows + 16) =
      make_uint4(out[4], out[5], out[6], out[7]);
  __syncwarp();
  if constexpr (sizeof(OutT) == 1) {
#pragma unroll
    for (int q = 0; q < kWarpRows / 512; ++q) {
      const int off = q * 512 + lane * 16;
      const long long at = base + off;
      if (VEC && at + 16 <= n) {
        *reinterpret_cast<uint4*>(leaf + at) =
            *reinterpret_cast<const uint4*>(io + off);
      } else {
        for (int e = 0; e < 16; ++e) {
          if (at + e < n) leaf[at + e] = io[off + e];
        }
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kWarpRows / 128; ++q) {
      const int off = q * 128 + lane * 4;
      const long long at = base + off;
      const unsigned w = *reinterpret_cast<const unsigned*>(io + off);
      const int4 v = make_int4(w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF,
                               w >> 24);
      if (VEC && at + 4 <= n) {
        *reinterpret_cast<int4*>(leaf + at) = v;
      } else {
        const int e[4] = {v.x, v.y, v.z, v.w};
        for (int k = 0; k < 4; ++k) {
          if (at + k < n) leaf[at + k] = e[k];
        }
      }
    }
  }
}

template <bool VEC, class OutT>
cudaError_t run_leaf_stage(const long long* codes, uint8_t* b, OutT* leaf,
                           long long n, long long n_real, int depth, int lo,
                           int levels, int k6_rule, int max_points,
                           int* scratch, cudaStream_t s) {
  const long long tiles = (n + kWarpRows - 1) / kWarpRows;
  const unsigned grid =
      static_cast<unsigned>((tiles + kLeafWarps - 1) / kLeafWarps);
  int* first = scratch;
  int* last = scratch + static_cast<long long>(levels) * tiles;
  leaf_bounds<VEC><<<grid, kLeafThreads, 0, s>>>(codes, b, n, n_real, depth,
                                                  lo, levels, tiles, first,
                                                  last);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  leaf_carry_scan<<<dim3(levels, 2), kCarryThreads, 0, s>>>(first, last,
                                                              tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  leaf_assign<VEC, OutT><<<grid, kLeafThreads, 0, s>>>(
      b, leaf, n, depth, lo, levels, k6_rule, max_points, tiles, first, last);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pcv

extern "C" {

// Rows of one carry tile: the scratch holds 2 * levels * ceil(n / this).
int pcv_leaf_tile_rows() { return pcv::kWarpRows; }

// codes: (n,) sorted int64; b: (n,) u8 out; leaf: (n,) u8 (leaf_i32 = 0)
// or int32 (leaf_i32 = 1) out.  Levels lo .. lo + levels - 1, within
// 1..21; rows >= n_real are pad rows (n_real = n: none).
int pcv_leaf_stage(const long long* codes, uint8_t* b, void* leaf,
                   int leaf_i32, long long n, long long n_real, int depth,
                   int lo, int levels, int k6_rule, int max_points,
                   int* scratch, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (levels < 1 || lo < 1 || lo + levels - 1 > pcv::kLeafMaxLevel ||
      depth < 0 || depth > pcv::kLeafMaxLevel || n_real < 0 || n_real > n) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(codes) |
                     reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(leaf)) & 15) == 0;
  if (leaf_i32) {
    int* out = static_cast<int*>(leaf);
    return vec ? pcv::run_leaf_stage<true>(codes, b, out, n, n_real, depth,
                                           lo, levels, k6_rule, max_points,
                                           scratch, s)
               : pcv::run_leaf_stage<false>(codes, b, out, n, n_real, depth,
                                            lo, levels, k6_rule, max_points,
                                            scratch, s);
  }
  uint8_t* out = static_cast<uint8_t*>(leaf);
  return vec ? pcv::run_leaf_stage<true>(codes, b, out, n, n_real, depth, lo,
                                         levels, k6_rule, max_points, scratch,
                                         s)
             : pcv::run_leaf_stage<false>(codes, b, out, n, n_real, depth, lo,
                                          levels, k6_rule, max_points,
                                          scratch, s);
}

}  // extern "C"
