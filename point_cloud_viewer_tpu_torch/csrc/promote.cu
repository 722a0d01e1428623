// K4: the LOD promotion of the tree derivation, every level in one launch
// (the build's promotion stage) or one level in place (the public K4).
//
// Replaces the Pallas kernel of point_cloud_viewer_tpu/ops/level_pallas.py
// promote_pass (:198, call :203, body _promote_kernel :110-132), which the
// JAX package runs once a level, deepest first, and on the build path the
// loop of those sweeps (ops/tree_build.py `_assign_and_promote`).
//
// What it computes.  At level l row i starts a segment iff b[i] <= l and is
// active iff cur[i] == l.  Its rank is the number of active rows before it
// in its segment (from row 0 when no start precedes it), and an active row
// of rank 0 mod 8 moves to l - 1; levels hi, hi - 1, ..., hi - levels + 1
// in turn.  Only the rank mod 8 matters, so the carry of a range of rows is
// (f, r): f says whether the range holds a start, r counts its active rows
// since its last start (all of them when f = 0), mod 8:
//   (f1, r1) . (f2, r2) = (f1 | f2, f2 ? r2 : (r1 + r2) & 7),
// associative, with identity (0, 0); packed as f << 3 | r, 4 bits of the
// look-back state word (lookback_scan.cuh).
//
// Bound: device-memory bytes.  b and the input levels read once and the
// output written once: 3 B a row whatever the number of levels (0.0143 ms
// for 16M rows at 3.35 TB/s).  The design moves those 3 B and one 8-B
// state a tile a level.
//
// Design.  One cudaMemsetAsync of the scratch, then one launch; tile ids
// come from an atomic counter, so a tile only waits on tiles that running
// blocks took, and those wait only on smaller ids: every wait ends.  A tile
// of kPromoteThreads x 32 rows loads b and the levels once (16 B a lane on
// neighbouring addresses, through the warp's kilobyte of shared memory) and
// keeps them in registers, each lane its 32 consecutive rows as eight
// words of each.  Per level, deepest first:
//   * the lane's active rows (row_masks.cuh) -- none where the lane holds
//     no row at the level, which a 64-bit set of its levels tells without
//     touching the rows.  A tile with no active row (one barrier,
//     __syncthreads_or) publishes (f, 0), f from its least b, and goes on:
//     at most levels most tiles hold no row;
//   * else the lane's start mask and its (f, r) by popcount, a warp shuffle
//     scan (skipped where no lane of the warp is active) and a scan of the
//     warps' totals;
//   * the tile publishes its state at that level: its prefix at once when
//     it holds a start (or is tile 0), else its aggregate;
//   * it looks back over its predecessors' states at that level
//     (lookback_scan.cuh look_back) only when an active row lies before its
//     first start: otherwise no rank in the tile depends on the rows before
//     it, and the tile goes on at once;
//   * each lane walks its active rows in order, the count reset at each
//     start, and moves those of rank 0 mod 8 to level - 1 in its registers.
// Level l - 1's active rows depend on level l's promotions, so a tile that
// must look back waits once a level.  The output goes out once, through
// shared memory, 16 B a lane.  Exact integers throughout: bit-equal to the
// plain PyTorch versions (ops/level_cuda.py `promote_pass_plain`,
// `promote_stage_plain`).
//
// Scratch: 1 + levels x tiles u64 words: word 0 the tile counter, then the
// states of level hi, of level hi - 1, ..., tiles words each.

#include "lookback_scan.cuh"
#include "row_masks.cuh"

namespace pcv {
namespace {

constexpr int kPromoteThreads = 256;   // the shape of tune/promote_tiles.cu
constexpr int kPromoteLaneRows = 32;   // rows a lane owns
constexpr int kPromoteMaxLevel = 63;  // the lane's 64-bit set of levels

// The (f, r mod 8) carry, f << 3 | r; `a` is the earlier range.
struct RankMod8Op {
  using T = int;
  __device__ static T identity() { return 0; }
  __device__ static T combine(T a, T c) {
    return (c & 8) ? c : ((a & 8) | ((a + c) & 7));
  }
};

__device__ __forceinline__ unsigned rows_below(int k) {
  return k >= 32 ? kFull : (1u << k) - 1u;
}

// The active rows `a` of rank 0 mod 8, given the starts `m` and the count
// r carried into the lane's first row.
__device__ __forceinline__ unsigned promoted_rows(unsigned m, unsigned a,
                                                  int r) {
  unsigned p = 0;
  unsigned seen = 0;  // rows up to the previous active row
  for (unsigned x = a; x; x &= x - 1u) {
    const int i = __ffs(x) - 1;
    const unsigned upto = (2u << i) - 1u;  // rows 0..i (i = 31: all)
    if (m & upto & ~seen) r = 0;           // a start since the last one
    if ((r & 7) == 0) p |= 1u << i;
    ++r;
    seen = upto;
  }
  return p;
}

// A warp's 1024 rows of `src` from base, 16 B a lane, through `io`; the
// lane's 32 rows come back as eight words.  Rows past n read as `fill`.
template <bool VEC>
__device__ __forceinline__ void load_rows(const uint8_t* src, long long base,
                                          long long n, uint8_t fill,
                                          uint8_t* io, int lane,
                                          unsigned (&w)[8]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int off = q * 512 + lane * 16;
    const long long at = base + off;
    if (VEC && at + 16 <= n) {
      *reinterpret_cast<uint4*>(io + off) =
          *reinterpret_cast<const uint4*>(src + at);
    } else {
      for (int e = 0; e < 16; ++e) io[off + e] = at + e < n ? src[at + e] : fill;
    }
  }
  __syncwarp();
  const uint4 a = *reinterpret_cast<const uint4*>(io + lane * 32);
  const uint4 c = *reinterpret_cast<const uint4*>(io + lane * 32 + 16);
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  w[4] = c.x, w[5] = c.y, w[6] = c.z, w[7] = c.w;
  __syncwarp();  // io is reused
}

// Bit v of the lane's set of levels (v > 63 is never a level).
__device__ __forceinline__ unsigned long long level_bit(unsigned v) {
  return v < 64 ? 1ull << v : 0ull;
}

template <bool VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
promote_levels(const uint8_t* b, const uint8_t* cur_in, uint8_t* cur_out,
               long long n, int hi, int levels, unsigned long long* scratch) {
  using Op = RankMod8Op;
  constexpr int kWarps = THREADS / 32;
  constexpr int kWarpRows = 32 * kPromoteLaneRows;
  constexpr long long kTileRows =
      static_cast<long long>(THREADS) * kPromoteLaneRows;
  static_assert(kWarps <= 32, "warp 0 scans one total a warp");
  __shared__ __align__(16) uint8_t s_io[kWarps][kWarpRows];
  __shared__ int s_x[kWarps];  // the warps' totals, then their prefixes
  __shared__ long long s_tile;
  __shared__ int s_least;  // the tile's least b

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
    s_least = 0x7F;
  }
  __syncthreads();
  const long long t = s_tile;
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  const long long base = t * kTileRows + static_cast<long long>(warp) * kWarpRows;
  uint8_t* io = s_io[warp];

  // b past n reads 0x7F (never a start) and the levels 0xFF (never active).
  unsigned bw[8];
  unsigned cw[8];
  load_rows<VEC>(b, base, n, 0x7F, io, lane, bw);
  load_rows<VEC>(cur_in, base, n, 0xFF, io, lane, cw);
  // b above 0x7F starts no segment at any level <= 63: clamp it to 0x7F
  // for start_mask.  `least`: the lane's least b, so f without the mask.
  int least = 0x7F;
  unsigned long long held = 0;  // the levels the lane's rows hold
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const unsigned top = (bw[q] >> 7) & 0x01010101u;
    bw[q] = (bw[q] & ~(top * 0xFFu)) | (top * 0x7Fu);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      least = min(least, static_cast<int>((bw[q] >> (8 * k)) & 0xFFu));
      held |= level_bit((cw[q] >> (8 * k)) & 0xFFu);
    }
  }
  const int warp_least = __reduce_min_sync(kFull, least);
  if (lane == 0) atomicMin(&s_least, warp_least);
  __syncthreads();
  const int tile_least = s_least;

  for (int k = 0; k < levels; ++k) {
    const int level = hi - k;
    unsigned long long* states = scratch + 1 + static_cast<long long>(k) * tiles;
    const unsigned a = (held >> level) & 1ull ? equal_mask(cw, level) : 0u;
    if (!__syncthreads_or(a != 0)) {
      // No row of the tile rests at this level: its state is (f, 0), and
      // no rank in it needs a carry.
      if (threadIdx.x == 0) {
        const int agg = tile_least <= level ? 8 : 0;
        publish(states, t, t == 0 || agg ? kPrefix : kAggregate, agg);
      }
      continue;
    }
    unsigned m = 0;
    int agg = least <= level ? 8 : 0;  // (f, 0) when no row is active
    bool pre = false;  // an active row before the lane's first start
    if (a) {
      m = start_mask(bw, level);
      if (m) {
        agg = 8 | (__popc(a >> (31 - __clz(m))) & 7);
        pre = (a & rows_below(__ffs(m) - 1)) != 0;
      } else {
        agg = __popc(a) & 7;
        pre = true;
      }
    }

    // The lane's prefix within the warp, the warp's total, and whether an
    // active row of the warp precedes every start of the warp.
    int excl = 0;
    int total;
    bool warp_pre = false;
    if (__any_sync(kFull, a != 0)) {
      int incl = agg;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = Op::combine(up, incl);
      }
      excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0;
      total = __shfl_sync(kFull, incl, 31);
      warp_pre = __any_sync(kFull, pre && !(excl & 8));
    } else {
      total = __any_sync(kFull, agg != 0) ? 8 : 0;
    }
    if (lane == 0) s_x[warp] = total | (warp_pre ? 16 : 0);
    __syncthreads();

    // Warp 0: the warps' prefixes, the tile's state, the look-back.
    if (warp == 0) {
      const int x = lane < kWarps ? s_x[lane] : 0;
      int w = x & 15;
      const unsigned starts = __ballot_sync(kFull, w & 8);
      // Some warp's active row lies before every start of the tile.
      const bool need =
          __any_sync(kFull, (x & 16) && !(starts & ((1u << lane) - 1u)));
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w = Op::combine(up, w);
      }
      const int tile_agg = __shfl_sync(kFull, w, kWarps - 1);
      int wex = __shfl_up_sync(kFull, w, 1);
      if (lane == 0) wex = 0;
      const bool closed = t == 0 || (tile_agg & 8);
      if (lane == 0) {
        publish(states, t, closed ? kPrefix : kAggregate, tile_agg);
      }
      int carry = Op::identity();
      if (need && t > 0) {
        carry = look_back<Op>(states, t, lane);
        if (!closed && lane == 0) {
          publish(states, t, kPrefix, Op::combine(carry, tile_agg));
        }
      }
      if (lane < kWarps) s_x[lane] = Op::combine(carry, wex);
    }
    __syncthreads();

    if (a) {
      const int in = Op::combine(s_x[warp], excl);
      const unsigned p = promoted_rows(m, a, in & 7);
      if (p) {
        set_bytes(cw, p, level - 1);
        held |= level_bit(level - 1);
      }
    }
  }

  // The levels out through shared memory, 16 B a lane.
  *reinterpret_cast<uint4*>(io + lane * 32) =
      make_uint4(cw[0], cw[1], cw[2], cw[3]);
  *reinterpret_cast<uint4*>(io + lane * 32 + 16) =
      make_uint4(cw[4], cw[5], cw[6], cw[7]);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int off = q * 512 + lane * 16;
    const long long at = base + off;
    if (VEC && at + 16 <= n) {
      *reinterpret_cast<uint4*>(cur_out + at) =
          *reinterpret_cast<const uint4*>(io + off);
    } else {
      for (int e = 0; e < 16; ++e) {
        if (at + e < n) cur_out[at + e] = io[off + e];
      }
    }
  }
}

template <int THREADS>
long long promote_tiles(long long n) {
  constexpr long long rows = static_cast<long long>(THREADS) * kPromoteLaneRows;
  return (n + rows - 1) / rows;
}

// Clear the scratch, then one launch; returns the first error.
template <int THREADS>
cudaError_t run_promote(const uint8_t* b, const uint8_t* cur_in,
                        uint8_t* cur_out, long long n, int hi, int levels,
                        unsigned long long* scratch, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  const long long tiles = promote_tiles<THREADS>(n);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (1 + levels * tiles) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  const bool vec = ((reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(cur_in) |
                     reinterpret_cast<uintptr_t>(cur_out)) & 15) == 0;
  const unsigned grid = static_cast<unsigned>(tiles);
  if (vec) {
    promote_levels<true, THREADS><<<grid, THREADS, 0, s>>>(
        b, cur_in, cur_out, n, hi, levels, scratch);
  } else {
    promote_levels<false, THREADS><<<grid, THREADS, 0, s>>>(
        b, cur_in, cur_out, n, hi, levels, scratch);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace pcv

extern "C" {

// Rows of one tile: the scratch holds 1 + levels * ceil(n / this) u64.
int pcv_promote_tile_rows() {
  return pcv::kPromoteThreads * pcv::kPromoteLaneRows;
}

// b, cur_in: (n,) u8; cur_out: (n,) u8, cur_in itself for the in-place
// public K4.  Promotes levels hi, hi - 1, ..., hi - levels + 1 (all within
// 1..63); levels = 0 copies cur_in.  `scratch` is cleared here on
// `stream`.
int pcv_promote(const uint8_t* b, const uint8_t* cur_in, uint8_t* cur_out,
                long long n, int hi, int levels,
                unsigned long long* scratch, void* stream) {
  if (n < 0 || levels < 0 ||
      (levels > 0 && (hi > pcv::kPromoteMaxLevel || hi - levels + 1 < 1))) {
    return cudaErrorInvalidValue;
  }
  return pcv::run_promote<pcv::kPromoteThreads>(
      b, cur_in, cur_out, n, hi, levels, scratch,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
