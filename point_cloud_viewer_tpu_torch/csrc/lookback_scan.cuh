// Single-pass chained scan with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016):
// the sweep of K1 (scan.cu) and K2 (level.cu, seg_start).  K4 (promote.cu)
// runs its own kernel on the tile states and `look_back` below, one set of
// states a level.  K3 still runs the three-launch skeleton of
// scan_skeleton.cuh, whose operators (MaxOp, MinOp, SumOp) this header
// shares.
//
// A sweep is one launch after one cudaMemsetAsync of its scratch:
//
//   * tile ids come from an atomic counter, not from blockIdx, so a tile
//     only ever waits on tiles that blocks already running have taken;
//   * each tile reads its input once, reduces it, and publishes one 64-bit
//     state word (status invalid / aggregate / inclusive prefix, and the
//     i32 value);
//   * one warp looks back over the states of 32 predecessors at a time;
//     __ballot_sync finds the nearest inclusive prefix and the warp
//     combines the aggregates after it in sweep order;
//   * the tile rescans its elements from registers and writes them once.
//
// Parameters (those of scan_skeleton.cuh):
//   Op   the associative operator: `T`, `identity()`, `combine(a, b)`
//        (a is the earlier part of the sweep; Op need not commute); T is
//        int (the state word holds 32 bits of value);
//   Src  the fused prologue: `In` the element type in memory, `p` the base
//        pointer, `T lift(i, raw)` the value of element i (physical index),
//        and `bool closes(T agg)`: true when a tile's aggregate alone is its
//        inclusive prefix (K2: a tile holding a segment start), so it
//        publishes a prefix at once and look-backs stop there;
//   Epi  the fused epilogue: `int* out` and `int value(excl, incl)`, the
//        i32 written to out[i];
//   REV  sweep direction: a reverse sweep visits physical n-1 .. 0.
//
// Layout: tiles of kLbTile elements are cut from element 0 whatever the
// direction, so every full 16-B chunk of a 16-B aligned array is aligned
// (cutting from the end breaks that whenever n % 4 != 0).  The t-th tile
// id of a reverse sweep takes physical tile num_tiles - 1 - t and reverses
// the order inside the tile in registers.  Within a tile, warp w owns
// 32 x ITEMS consecutive elements; a lane owns 16-B chunks (4 i32 or 16 u8),
// and neighbouring lanes load neighbouring chunks with one 16-B load each
// (R = ITEMS / 4 loads a lane for i32, ITEMS / 16 for u8).  Outputs are i32:
// for i32 input a lane's chunk of output is 16 B and is stored directly;
// for u8 input it is 64 B, so a warp stages each 2 KB of output in shared
// memory and stores it as 16 B a lane, neighbouring lanes on neighbouring
// addresses.  The ragged tail is masked; a base pointer that is not 16-B
// aligned (a view such as x[1:]) takes the same kernel with scalar loads
// and stores (VEC = false), chosen by run_lookback from the pointers.
//
// Tile size: 8192 elements (256 threads x 32).  Look-back traffic is one
// 8-B state a tile against 64 KB (K1) or 40 KB (K2) of data; each block
// holds at most 16 KB of shared memory and its registers allow at least
// two blocks on each of the 132 SMs (registers and smem: nvcc -Xptxas -v,
// printed by chip_smoke.py).  The shape comes from tune/lookback_tiles.cu,
// which times K1 and K2 at other block shapes (numbers in PERF.md).
//
// Scratch: (num_tiles + 1) u64 words, cleared by run_lookback on the
// launch's stream: word 0 holds the tile counter, word 1 + t tile t's state.
#pragma once

#include <cstdint>

#include <cuda/atomic>
#include <cuda_runtime.h>

#include "scan_skeleton.cuh"

namespace pcv {
namespace {

constexpr int kLbThreads = 256;
constexpr int kLbItems = 32;  // elements a thread owns
constexpr int kLbTile = 8192;  // elements a tile (ops/_ext.py LOOKBACK_TILE)
static_assert(kLbTile == kLbThreads * kLbItems, "tile = threads x items");

// Tile state: status in bits 32-33, the i32 value in bits 0-31.
constexpr unsigned long long kInvalid = 0ull;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr unsigned long long kStatusMask = 3ull << 32;

using StateRef = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

// A state word carries its own value, so a reader needs nothing else
// published before it: states are stored and loaded relaxed (a release
// store costs a GPU-scope fence, which K4 would pay once a level).
__device__ __forceinline__ void publish(unsigned long long* states,
                                        long long t,
                                        unsigned long long status, int v) {
  StateRef(states[t]).store(status | static_cast<unsigned>(v),
                            cuda::memory_order_relaxed);
}

__device__ __forceinline__ int state_value(unsigned long long s) {
  return static_cast<int>(static_cast<unsigned>(s));
}

__host__ __device__ inline long long lookback_tiles(long long n) {
  return (n + kLbTile - 1) / kLbTile;
}

// Called by one whole warp for tile t > 0: the combine, in sweep order, of
// every element before tile t (its exclusive prefix), the same in every
// lane.  Lane j reads the state of tile t - 1 - j (plus 32 a round), waits
// while it is invalid, and the window stops at the nearest inclusive
// prefix.  Tile 0 always publishes a prefix, so the walk ends there.
template <class Op>
__device__ int look_back(unsigned long long* states, long long t, int lane) {
  using T = typename Op::T;
  T excl = Op::identity();
  for (long long end = t - 1;; end -= 32) {
    const long long j = end - lane;  // lane 0: the nearest predecessor
    unsigned long long s = kPrefix | static_cast<unsigned>(Op::identity());
    if (j >= 0) {
      StateRef ref(states[j]);
      s = ref.load(cuda::memory_order_relaxed);
      while ((s & kStatusMask) == kInvalid) {
        __nanosleep(32);
        s = ref.load(cuda::memory_order_relaxed);
      }
    }
    const unsigned prefixes =
        __ballot_sync(0xffffffffu, (s & kStatusMask) == kPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 32;
    T v = lane <= stop ? state_value(s) : Op::identity();
    // Higher lanes are earlier in the sweep: lane i takes lanes [i, i + 2d).
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T up = __shfl_down_sync(0xffffffffu, v, d);
      if (lane + d < 32) v = Op::combine(up, v);
    }
    excl = Op::combine(__shfl_sync(0xffffffffu, v, 0), excl);
    if (stop < 32) return excl;
  }
}

// W elements of a 16-B chunk starting at physical index `at`.
template <bool VEC, int W, class In>
__device__ __forceinline__ void load_chunk(const In* p, long long at,
                                           long long n, In (&raw)[W]) {
  if (VEC && at + W <= n) {
    union {
      uint4 v;
      In e[W];
    } u;
    u.v = __ldg(reinterpret_cast<const uint4*>(p + at));
#pragma unroll
    for (int k = 0; k < W; ++k) raw[k] = u.e[k];
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) raw[k] = at + k < n ? p[at + k] : In();
  }
}

// Four i32 at physical index `at` (e0..e3 in physical order).
template <bool VEC>
__device__ __forceinline__ void store4(int* out, long long at, long long n,
                                       int4 v) {
  if (VEC && at + 4 <= n) {
    *reinterpret_cast<int4*>(out + at) = v;
  } else {
    const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (at + k < n) out[at + k] = e[k];
    }
  }
}

// int4 slot g of a warp's staging buffer, XOR-swizzled so that eight lanes
// storing their own 64 B, or loading neighbouring 16 B, hit eight distinct
// 16-B bank groups.
__device__ __forceinline__ int swizzle(int g) { return g ^ ((g >> 3) & 3); }

template <class Op, bool REV, bool VEC, int THREADS, int ITEMS, class Src,
          class Epi>
__global__ void __launch_bounds__(THREADS)
lookback_scan(Src src, Epi epi, long long n, unsigned long long* scratch) {
  using T = typename Op::T;
  using In = typename Src::In;
  constexpr int kWarps = THREADS / 32;
  constexpr int kTileElems = THREADS * ITEMS;
  constexpr int kWarpElems = 32 * ITEMS;
  constexpr int W = 16 / static_cast<int>(sizeof(In));  // elements a chunk
  constexpr int R = ITEMS / W;                           // chunks a thread
  constexpr int kSub = 32 * W;  // elements one warp-wide load covers
  static_assert(ITEMS % W == 0, "a thread owns whole chunks");
  static_assert(W == 4 || W == 16, "i32 or u8 input");

  __shared__ long long s_tile;
  __shared__ T s_warp[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* states = scratch + 1;
  if (threadIdx.x == 0) {
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  }
  __syncthreads();
  const long long t = s_tile;
  const long long tiles = (n + kTileElems - 1) / kTileElems;
  const long long base = (REV ? tiles - 1 - t : t) * kTileElems;
  // Physical warp and lane of this thread's logical place in the sweep.
  const int pw = REV ? kWarps - 1 - warp : warp;
  const int pl = REV ? 31 - lane : lane;
  const long long warp_at = base + static_cast<long long>(pw) * kWarpElems;

  // Load: logical chunk r, logical element k (REV reverses both).
  T v[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int pr = REV ? R - 1 - r : r;
    const long long at = warp_at + pr * kSub + pl * W;
    In raw[W];
    load_chunk<VEC, W>(src.p, at, n, raw);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int e = REV ? W - 1 - k : k;
      v[r][k] = at + e < n ? src.lift(at + e, raw[e]) : Op::identity();
    }
  }

  // Scan: in each chunk, then across the warp's lanes, chunk by chunk.
  T chunk_pre[R];
  T warp_run = Op::identity();
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 1; k < W; ++k) v[r][k] = Op::combine(v[r][k - 1], v[r][k]);
    T incl = v[r][W - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T up = shfl_up(incl, d);
      if (lane >= d) incl = Op::combine(up, incl);
    }
    T ex = shfl_up(incl, 1);
    if (lane == 0) ex = Op::identity();
    chunk_pre[r] = Op::combine(warp_run, ex);
    warp_run = Op::combine(warp_run, __shfl_sync(0xffffffffu, incl, 31));
  }
  if (lane == 0) s_warp[warp] = warp_run;
  __syncthreads();

  // Warp 0: the warps' prefixes, the tile's state, the look-back.
  if (warp == 0) {
    T w = lane < kWarps ? s_warp[lane] : Op::identity();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T up = shfl_up(w, d);
      if (lane >= d) w = Op::combine(up, w);
    }
    const T tile_agg = __shfl_sync(0xffffffffu, w, kWarps - 1);
    T wex = shfl_up(w, 1);
    if (lane == 0) wex = Op::identity();
    T excl = Op::identity();
    if (t == 0) {
      if (lane == 0) publish(states, t, kPrefix, tile_agg);
    } else {
      const bool closed = src.closes(tile_agg);
      if (lane == 0) {
        publish(states, t, closed ? kPrefix : kAggregate, tile_agg);
      }
      excl = look_back<Op>(states, t, lane);
      if (!closed && lane == 0) {
        publish(states, t, kPrefix, Op::combine(excl, tile_agg));
      }
    }
    if (lane < kWarps) s_warp[lane] = Op::combine(excl, wex);
  }
  __syncthreads();
  const T warp_pre = s_warp[warp];

  // Rescan from registers; o[r][e] holds the output of physical slot e.
  int o[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const T pre = Op::combine(warp_pre, chunk_pre[r]);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const T ex = k ? Op::combine(pre, v[r][k - 1]) : pre;
      o[r][REV ? W - 1 - k : k] = epi.value(ex, Op::combine(pre, v[r][k]));
    }
  }

  if constexpr (W == 4) {
    // i32 in, i32 out: a lane's chunk of output is 16 B.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pr = REV ? R - 1 - r : r;
      store4<VEC>(epi.out, warp_at + pr * kSub + pl * W, n,
                  make_int4(o[r][0], o[r][1], o[r][2], o[r][3]));
    }
  } else {
    // u8 in, i32 out: a lane's chunk of output is 64 B; stage each warp-
    // wide chunk of 512 outputs and store it 16 B a lane.
    __shared__ int4 s_out[kWarps][kSub / 4];
    int4* buf = s_out[warp];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pr = REV ? R - 1 - r : r;
      if (r) __syncwarp();  // the previous chunk's stores have read buf
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        buf[swizzle(pl * (W / 4) + q)] = make_int4(
            o[r][4 * q], o[r][4 * q + 1], o[r][4 * q + 2], o[r][4 * q + 3]);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const int g = q * 32 + lane;
        store4<VEC>(epi.out, warp_at + pr * kSub + 4 * g, n,
                    buf[swizzle(g)]);
      }
    }
  }
}

// One sweep: clear the scratch, then one launch.  Returns the first error.
template <class Op, bool REV, class Src, class Epi>
cudaError_t run_lookback(Src src, Epi epi, long long n,
                         unsigned long long* scratch, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const long long tiles = lookback_tiles(n);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (tiles + 1) * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return err;
  const bool vec = ((reinterpret_cast<uintptr_t>(src.p) |
                     reinterpret_cast<uintptr_t>(epi.out)) & 15) == 0;
  const unsigned grid = static_cast<unsigned>(tiles);
  if (vec) {
    lookback_scan<Op, REV, true, kLbThreads, kLbItems>
        <<<grid, kLbThreads, 0, stream>>>(src, epi, n, scratch);
  } else {
    lookback_scan<Op, REV, false, kLbThreads, kLbItems>
        <<<grid, kLbThreads, 0, stream>>>(src, epi, n, scratch);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace pcv
