// K8: the query filter's per-point mask of one node, one thread a row.  For
// row i of an (n, 3) f64 position array and up to kMaskMaxIntervals f64
// attribute columns, one u8 code:
//   bit 0  definitely inside the region and inside every interval;
//   bit 1  uncertain (the host decides) and inside every interval.
// The four regions are the ones query/device_filter.py classifies on the
// device, with the same rules and margins (its module docstring):
//   Aabb             mins <= p < maxs on every axis (exact, never uncertain);
//   Obb              l = p @ rot_t + t against the half extent h, with the
//                    error bound E = 2^-49 S + 2^-1000 of each entry and the
//                    margin 2 (E + 2^-52 (h + |l|));
//   Frustum          [q | w] = p @ m[:, :3].T + m[:, 3], clip = q / w, with
//                    the margin 2 D + 2^-51 of the docstring;
//   WebMercatorRect  the point projected by wmc_project, against the rect
//                    grown and shrunk by the calibrated delta.
// An interval keeps lo <= v <= hi (NaN fails it), as math/intervals.py.
//
// The dot products are summed in any order and contracted into FMAs at
// will: the bound of the docstring holds for any order, with or without
// FMA (Higham, gamma_4).  S is formed from |p|, |m| and |b| as the docstring
// says.  Comparisons are written as query/device_filter.py writes them, so
// a NaN or an overflowed margin falls into the band as it does there.
//
// The region's constants and the intervals' bounds ride in a struct passed
// by value (kernel parameter space): nothing is uploaded for them.  The C
// entry pcv_query_mask does a node's whole round trip on one stream: the
// H2D copy of positions and columns from pinned memory, the launch, the
// D2H copy of the codes into pinned memory, then it waits for the stream.
// Called through ctypes, it holds no GIL while it waits.
//
// wmc_project is the only Web Mercator projection on this route: the
// classify kind and the projection-only entry pcv_web_mercator_project (the
// margin's calibration, web_mercator_device._calibrated_delta) call the
// same non-inlined function, so the margin is measured on the code that
// classifies.
//
// A second C entry, pcv_query_decode_mask, takes a node as stored: its
// positions in the node's encoding (u8, u16, f32 or f64, each scaled to the
// node's cube) and each interval column in its own scalar type.  One kernel
// decodes each row bit-equal to ops/codec.decode_positions as the host runs
// it for that node, classifies it as above, and compacts the rows whose code
// is not 0 in row order (their row index, decoded position and code), with
// the decoupled look-back of lookback_scan.cuh over tiles of kCompactTile
// rows.  The host copies back the count, then the kept rows alone.  The two
// entries share the classification: the row loader (F64Rows, EncodedRows)
// is a template parameter of the code of a row.  pcv_read_node_files reads
// a node's files into the caller's buffers beforehand, so that the worker
// that calls it holds no GIL for that either.
//
// Bound: bytes over PCIe, then HBM.  A row reads 24 B of positions and 8 B
// an interval and writes 1 B; the work is a few dozen flops a row (the
// projection's transcendentals for a tile).  Encoded, a row reads 3, 6, 12
// or 24 B of positions and its columns' own widths, and a kept row writes
// 29 B.

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cuda_runtime.h>

#include "lookback_scan.cuh"

namespace pcv {
namespace {

constexpr int kMaskThreads = 256;
constexpr int kMaskMaxIntervals = 8;
constexpr int kMaskRegion = 16;
constexpr int kMaskBlocksPerSm = 16;

enum MaskKind { kAabb = 0, kObb = 1, kFrustum = 2, kWebMercator = 3 };

// The host packs this as kMaskParams doubles (device_filter._k8_params):
//   Aabb          region[0:3] mins, [3:6] maxs
//   Obb           region[0:9] rot_t row-major ((x, y, z) by axis), [9:12]
//                 translation, [12:15] half extent
//   Frustum       region[0:16] clip_from_query row-major
//   WebMercator   region[0:2] nw + delta, [2:4] se - delta, [4:6] nw - delta,
//                 [6:8] se + delta, [8:16] the projection's constants
//                 (WmcConsts)
//   lo, hi        the intervals' bounds, n_intervals of each
struct MaskParams {
  double region[kMaskRegion];
  double lo[kMaskMaxIntervals];
  double hi[kMaskMaxIntervals];
};
constexpr int kMaskParams = sizeof(MaskParams) / sizeof(double);

// region[8:16] of a WebMercator mask, in the order of
// math/web_mercator_device.wmc_consts().
struct WmcConsts {
  double a;            // SEMI_MAJOR_M
  double b;            // SEMI_MINOR_M
  double k_sin;        // ECC2_SQ * SEMI_MINOR_M
  double k_cos;        // ECC_SQ * SEMI_MAJOR_M
  double lat_bound;    // LAT_BOUND_RAD
  double two_pi;       // 2 pi
  double quarter_pi;   // 0.25 / pi
  double unused;
};

constexpr double kERel = 0x1p-49;    // device_filter._E_REL
constexpr double kEAbs = 0x1p-1000;  // device_filter._E_ABS
constexpr double kRound = 0x1p-52;   // device_filter._ROUND

// math/web_mercator_device._wmc_project: ECEF -> geodetic (Bowring, three
// iterations) -> normalized Web Mercator, in the same operation order.
// The clamp keeps NaN, as torch.clamp does.
__device__ __noinline__ double2 wmc_project(double x, double y, double z,
                                            const WmcConsts& c) {
  const double lon = atan2(y, x);
  const double pr = hypot(x, y);
  double theta = atan2(z * c.a, pr * c.b);
  double lat = 0.0;
  for (int it = 0; it < 3; ++it) {
    double st, ct;
    sincos(theta, &st, &ct);
    lat = atan2(z + c.k_sin * (st * st * st), pr - c.k_cos * (ct * ct * ct));
    double sl, cl;
    sincos(lat, &sl, &cl);
    theta = atan2(c.b * sl, c.a * cl);
  }
  lat = lat < -c.lat_bound ? -c.lat_bound
                           : (lat > c.lat_bound ? c.lat_bound : lat);
  const double sin_y = sin(lat);
  return make_double2(0.5 + lon / c.two_pi,
                      0.5 - log((1.0 + sin_y) / (1.0 - sin_y)) * c.quarter_pi);
}

__device__ __forceinline__ const WmcConsts& wmc_consts(const MaskParams& p) {
  return *reinterpret_cast<const WmcConsts*>(p.region + 8);
}

// (definitely in, uncertain) of one point.
template <int KIND>
__device__ __forceinline__ void classify(const MaskParams& c, double x,
                                         double y, double z, bool& in,
                                         bool& uncertain) {
  const double* r = c.region;
  if (KIND == kAabb) {
    in = r[0] <= x && x < r[3] && r[1] <= y && y < r[4] && r[2] <= z &&
         z < r[5];
    uncertain = false;
  } else if (KIND == kObb) {
    const double ax = fabs(x), ay = fabs(y), az = fabs(z);
    bool all_in = true, any_out = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double l = x * r[k] + y * r[3 + k] + z * r[6 + k] + r[9 + k];
      const double s = ax * fabs(r[k]) + ay * fabs(r[3 + k]) +
                       az * fabs(r[6 + k]) + fabs(r[9 + k]);
      const double e = s * kERel + kEAbs;
      const double h = r[12 + k];
      const double a = fabs(l);
      const double margin = (e + (h + a) * kRound) * 2.0;
      all_in = all_in && (a <= h - margin);
      any_out = any_out || (a > h + margin);
    }
    in = all_in;
    uncertain = !(all_in || any_out);
  } else if (KIND == kFrustum) {
    const double ax = fabs(x), ay = fabs(y), az = fabs(z);
    double qw[4], e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double* m = r + 4 * k;
      qw[k] = x * m[0] + y * m[1] + z * m[2] + m[3];
      const double s = ax * fabs(m[0]) + ay * fabs(m[1]) + az * fabs(m[2]) +
                       fabs(m[3]);
      e[k] = s * kERel + kEAbs;
    }
    const double w = qw[3], ew = e[3], aw = fabs(w);
    const bool ok = isfinite(qw[0]) && isfinite(qw[1]) && isfinite(qw[2]) &&
                    isfinite(w) && aw > ew * 2.0;
    bool all_in = true, any_out = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double q = qw[k], eq = e[k];
      const double clip = q / w;
      const double rr = (fabs(q) + eq) / (aw - ew);
      const double d = (eq + rr * ew) / aw + (rr + fabs(clip)) * kRound;
      const double margin = d * 2.0 + 0x1p-51;
      all_in = all_in && (clip > margin - 1.0) && (clip < 1.0 - margin);
      any_out = any_out || (clip <= -1.0 - margin) || (clip >= 1.0 + margin);
    }
    in = ok && all_in;
    uncertain = !(in || (ok && any_out));
  } else {
    const double2 m = wmc_project(x, y, z, wmc_consts(c));
    const bool all_in = m.x >= r[0] && m.x < r[2] && m.y >= r[1] && m.y < r[3];
    const bool any_out = m.x < r[4] || m.x >= r[6] || m.y < r[5] || m.y >= r[7];
    in = all_in;
    uncertain = !(all_in || any_out);
  }
}

// Row loaders: `position(i, x, y, z)` and `column(j, i)`, the value of
// interval column j at row i as f64.
//
// F64Rows: pos is (n, 3) f64, cols (n_intervals, n) f64, one buffer.
struct F64Rows {
  const double* pos;
  const double* cols;
  long long n;

  __device__ __forceinline__ void position(long long i, double& x, double& y,
                                           double& z) const {
    x = pos[3 * i];
    y = pos[3 * i + 1];
    z = pos[3 * i + 2];
  }
  __device__ __forceinline__ double column(int j, long long i) const {
    return cols[j * n + i];
  }
};

// The stored types of an interval column (device_filter._K8_COLUMN).
enum ColumnType {
  kColF64 = 0, kColF32 = 1, kColU8 = 2, kColU16 = 3, kColU32 = 4,
  kColI8 = 5, kColI16 = 6, kColI32 = 7
};

// The node's positions as stored and its columns.  The decode is
// ops/codec.decode_positions as the host runs it for this node:
//   u8, u16 (fixpoint)  t = enc / div (255 or 65535), one rounded division;
//   f32, f64            t = enc, widened exactly;
//   fma                 fma(t, edge, cube_min), one rounding: the native
//                       routine (native/pcv_native.cpp, g++ contracts the
//                       multiply-add) that the host takes for u8 and u16
//                       nodes of 10,000 rows or more;
//   else                (t * edge) + cube_min, each rounded: numpy's
//                       expression.
// The intrinsics keep nvcc from contracting where the host does not.  The
// encoding and the rounding are the node's, the same for every row, so
// their branches never diverge; one kernel a region serves them all.
struct EncodedRows {
  const void* enc;
  int encoding;  // ops/codec.PositionEncoding: 1 u8, 2 u16, 3 f32, 4 f64
  bool fma;
  double div;
  double edge;
  double cube_min[3];
  const void* col[kMaskMaxIntervals];
  int type[kMaskMaxIntervals];

  __device__ __forceinline__ double axis(long long i, int k) const {
    const long long at = 3 * i + k;
    double t;
    switch (encoding) {
      case 1:
        t = __ddiv_rn(static_cast<const uint8_t*>(enc)[at], div);
        break;
      case 2:
        t = __ddiv_rn(static_cast<const uint16_t*>(enc)[at], div);
        break;
      case 3: t = static_cast<const float*>(enc)[at]; break;
      default: t = static_cast<const double*>(enc)[at]; break;
    }
    return fma ? __fma_rn(t, edge, cube_min[k])
               : __dadd_rn(__dmul_rn(t, edge), cube_min[k]);
  }
  __device__ __forceinline__ void position(long long i, double& x, double& y,
                                           double& z) const {
    x = axis(i, 0);
    y = axis(i, 1);
    z = axis(i, 2);
  }
  __device__ __forceinline__ double column(int j, long long i) const {
    const void* p = col[j];
    switch (type[j]) {
      case kColF64: return static_cast<const double*>(p)[i];
      case kColF32: return static_cast<const float*>(p)[i];
      case kColU8: return static_cast<const uint8_t*>(p)[i];
      case kColU16: return static_cast<const uint16_t*>(p)[i];
      case kColU32: return static_cast<const uint32_t*>(p)[i];
      case kColI8: return static_cast<const int8_t*>(p)[i];
      case kColI16: return static_cast<const int16_t*>(p)[i];
      default: return static_cast<const int32_t*>(p)[i];
    }
  }
};

// Row i's code (bit 0 definitely in, bit 1 uncertain, each within every
// interval; 0 out) and its position, as `rows` loads it.
template <int KIND, class Rows>
__device__ __forceinline__ uint8_t row_code(const MaskParams& c,
                                            int n_intervals, const Rows& rows,
                                            long long i, double& x, double& y,
                                            double& z) {
  bool keep = true;
  for (int j = 0; j < n_intervals; ++j) {
    const double v = rows.column(j, i);
    keep = keep && v >= c.lo[j] && v <= c.hi[j];
  }
  rows.position(i, x, y, z);
  bool in, uncertain;
  classify<KIND>(c, x, y, z, in, uncertain);
  return static_cast<uint8_t>(keep ? (in ? 1 : 0) | (uncertain ? 2 : 0) : 0);
}

// Grid-stride over the rows of an f64 batch: one code a row.
template <int KIND>
__global__ void __launch_bounds__(kMaskThreads)
query_mask_kernel(const MaskParams c, int n_intervals, const F64Rows rows,
                  uint8_t* __restrict__ codes) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < rows.n; i += stride) {
    double x, y, z;
    codes[i] = row_code<KIND>(c, n_intervals, rows, i, x, y, z);
  }
}

// --- the encoded node: decode, classify, compact -------------------------

constexpr int kCompactThreads = 256;
constexpr int kCompactItems = 4;  // rows a thread
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kCompactTile = kCompactThreads * kCompactItems;
static_assert(kCompactItems * kCompactWarps == 32,
              "one warp scans the tile's (item, warp) counts");

// The kept rows, in row order: kept[0] their count, pos (cap, 3) f64, row
// (cap,) i32, code (cap,) u8.
struct CompactOut {
  long long* kept;
  double* pos;
  int* row;
  uint8_t* code;
};

// One tile of kCompactTile rows a block, tile ids from an atomic counter
// (so a tile waits only on tiles that running blocks hold).  Row
// base + r * kCompactThreads + threadIdx.x is thread threadIdx.x's item r,
// so (r, warp, lane) is row order: the tile's 32 (r, warp) counts are
// scanned by warp 0, which then looks back (SumOp) for the rows kept before
// the tile.  The last tile writes the total.
//
// scratch: word 0 the tile counter, word 1 the blocks done, 2 + t tile t's
// state.  It is zero before the launch (the host clears it once, when it
// allocates it), and the last block to finish clears it again, so a node
// costs one launch and no memset.
template <int KIND>
__global__ void __launch_bounds__(kCompactThreads)
query_decode_compact_kernel(const MaskParams c, int n_intervals,
                            const EncodedRows rows, long long n,
                            CompactOut out, unsigned long long* scratch) {
  __shared__ long long s_tile;
  __shared__ int s_pre[32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* states = scratch + 2;
  if (threadIdx.x == 0) {
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  }
  __syncthreads();
  const long long t = s_tile;
  const long long tiles = (n + kCompactTile - 1) / kCompactTile;
  const long long base = t * kCompactTile + threadIdx.x;

  double px[kCompactItems], py[kCompactItems], pz[kCompactItems];
  uint8_t code[kCompactItems];
  unsigned kept[kCompactItems];
#pragma unroll
  for (int r = 0; r < kCompactItems; ++r) {
    const long long i = base + r * kCompactThreads;
    code[r] = 0;
    if (i < n) {
      code[r] = row_code<KIND>(c, n_intervals, rows, i, px[r], py[r], pz[r]);
    }
    kept[r] = __ballot_sync(0xffffffffu, code[r] != 0);
    if (lane == 0) s_pre[r * kCompactWarps + warp] = __popc(kept[r]);
  }
  __syncthreads();

  if (warp == 0) {
    const int v = s_pre[lane];
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = shfl_up(incl, d);
      if (lane >= d) incl += up;
    }
    const int agg = __shfl_sync(0xffffffffu, incl, 31);
    int excl = 0;
    if (t == 0) {
      if (lane == 0) publish(states, t, kPrefix, agg);
    } else {
      if (lane == 0) publish(states, t, kAggregate, agg);
      excl = look_back<SumOp>(states, t, lane);
      if (lane == 0) publish(states, t, kPrefix, excl + agg);
    }
    s_pre[lane] = excl + incl - v;
    if (t == tiles - 1 && lane == 0) *out.kept = excl + agg;
  }
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kCompactItems; ++r) {
    if (code[r]) {
      const long long at =
          s_pre[r * kCompactWarps + warp] + __popc(kept[r] & below);
      out.pos[3 * at] = px[r];
      out.pos[3 * at + 1] = py[r];
      out.pos[3 * at + 2] = pz[r];
      out.row[at] = static_cast<int>(base + r * kCompactThreads);
      out.code[at] = code[r];
    }
  }

  // Every block has finished its look-back before it counts itself done,
  // so the last one may clear the scratch for the next node.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned done =
        atomicAdd(reinterpret_cast<unsigned*>(scratch + 1), 1u);
    s_last = done == static_cast<unsigned>(tiles - 1);
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (s_last) {
    for (long long k = threadIdx.x; k < tiles; k += kCompactThreads) {
      states[k] = 0;
    }
    if (threadIdx.x == 0) {
      scratch[0] = 0;
      scratch[1] = 0;
    }
  }
}

__global__ void __launch_bounds__(kMaskThreads)
wmc_project_kernel(const WmcConsts c, const double* __restrict__ pos,
                   long long n, double* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const double2 m = wmc_project(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2],
                                  c);
    out[2 * i] = m.x;
    out[2 * i + 1] = m.y;
  }
}

// Blocks for n rows: one a row up to kMaskBlocksPerSm a multiprocessor of
// the first card asked (the port's cards are alike).
unsigned grid_for(long long n) {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  const long long blocks = (n + kMaskThreads - 1) / kMaskThreads;
  const long long cap = static_cast<long long>(sms) * kMaskBlocksPerSm;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

int launch(int kind, const MaskParams& c, int n_intervals, const double* pos,
           long long n, uint8_t* codes, cudaStream_t s) {
  const unsigned grid = grid_for(n);
  const F64Rows rows{pos, pos + 3 * n, n};
  switch (kind) {
    case kAabb:
      query_mask_kernel<kAabb><<<grid, kMaskThreads, 0, s>>>(c, n_intervals,
                                                              rows, codes);
      break;
    case kObb:
      query_mask_kernel<kObb><<<grid, kMaskThreads, 0, s>>>(c, n_intervals,
                                                             rows, codes);
      break;
    case kFrustum:
      query_mask_kernel<kFrustum><<<grid, kMaskThreads, 0, s>>>(
          c, n_intervals, rows, codes);
      break;
    case kWebMercator:
      query_mask_kernel<kWebMercator><<<grid, kMaskThreads, 0, s>>>(
          c, n_intervals, rows, codes);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_compact(int kind, const MaskParams& c, int n_intervals,
                   const EncodedRows& rows, long long n, const CompactOut& out,
                   unsigned long long* scratch, cudaStream_t s) {
  const unsigned grid =
      static_cast<unsigned>((n + kCompactTile - 1) / kCompactTile);
  switch (kind) {
    case kAabb:
      query_decode_compact_kernel<kAabb><<<grid, kCompactThreads, 0, s>>>(
          c, n_intervals, rows, n, out, scratch);
      break;
    case kObb:
      query_decode_compact_kernel<kObb><<<grid, kCompactThreads, 0, s>>>(
          c, n_intervals, rows, n, out, scratch);
      break;
    case kFrustum:
      query_decode_compact_kernel<kFrustum><<<grid, kCompactThreads, 0, s>>>(
          c, n_intervals, rows, n, out, scratch);
      break;
    case kWebMercator:
      query_decode_compact_kernel<kWebMercator>
          <<<grid, kCompactThreads, 0, s>>>(c, n_intervals, rows, n, out,
                                            scratch);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int kind, int n_intervals, long long n) {
  return kind < kAabb || kind > kWebMercator || n_intervals < 0 ||
         n_intervals > kMaskMaxIntervals || n < 0 || n > INT32_MAX;
}

}  // namespace
}  // namespace pcv

extern "C" {

int pcv_query_mask_params() { return pcv::kMaskParams; }
int pcv_query_mask_max_intervals() { return pcv::kMaskMaxIntervals; }

// The kernel alone, on `stream`: dev_in holds (n, 3) positions, then
// n_intervals columns of n; params is host memory, pcv_query_mask_params()
// doubles.  n = 0 launches nothing.
int pcv_query_mask_launch(int kind, const double* params, int n_intervals,
                          long long n, const double* dev_in,
                          uint8_t* dev_codes, void* stream) {
  if (pcv::bad_args(kind, n_intervals, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  pcv::MaskParams c;
  std::memcpy(&c, params, sizeof(c));
  return pcv::launch(kind, c, n_intervals, dev_in, n, dev_codes,
                     static_cast<cudaStream_t>(stream));
}

// A node's round trip on `stream`: host_in (pinned, (3 + n_intervals) * n
// doubles) -> dev_in, the launch, dev_codes -> host_codes (pinned, n
// bytes), then the stream is synchronised.  The codes are in host_codes
// when it returns 0.
int pcv_query_mask(int kind, const double* params, int n_intervals,
                   long long n, const double* host_in, double* dev_in,
                   uint8_t* dev_codes, uint8_t* host_codes, void* stream) {
  if (pcv::bad_args(kind, n_intervals, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(3 + n_intervals) * n * sizeof(double);
  cudaError_t err =
      cudaMemcpyAsync(dev_in, host_in, bytes, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int launched = pcv_query_mask_launch(kind, params, n_intervals, n,
                                             dev_in, dev_codes, stream);
  if (launched != 0) return launched;
  err = cudaMemcpyAsync(host_codes, dev_codes, static_cast<size_t>(n),
                        cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Rows a tile of the compacting kernel: its scratch holds 2 + one state a
// tile u64 words (device_filter._Staging.reserve_node).
int pcv_query_decode_tile_rows() { return pcv::kCompactTile; }

// The compacting kernel alone, on `stream`, over a node as stored in
// dev_in: its n positions in `encoding` (ops/codec.PositionEncoding: 1 u8,
// 2 u16, 3 f32, 4 f64) from byte 0, and interval column j, of type
// cols[2 j] (device_filter._K8_COLUMN), from byte cols[2 j + 1]; node is
// cube_min (3 doubles) and the edge; fma 1 decodes u8 and u16 with the
// contracted multiply-add.  scratch must be zero, as the kernel leaves it.
// n = 0 launches nothing.  The kept rows go to dev_out, laid out for a node
// of n rows in 16 + 29 n bytes (device_filter._decode_layout): the count
// (8 B, then 8 B of padding), then room for n positions (24 B a row), n row
// indices (4 B a row) and n codes (1 B a row).
int pcv_query_decode_launch(int kind, const double* params, int n_intervals,
                            int encoding, int fma, const double* node,
                            const long long* cols, long long n,
                            const void* dev_in, void* dev_out, void* scratch,
                            void* stream) {
  if (pcv::bad_args(kind, n_intervals, n) || encoding < 1 || encoding > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  pcv::MaskParams c;
  std::memcpy(&c, params, sizeof(c));
  const void* col[pcv::kMaskMaxIntervals];
  int type[pcv::kMaskMaxIntervals];
  for (int j = 0; j < n_intervals; ++j) {
    if (cols[2 * j] < pcv::kColF64 || cols[2 * j] > pcv::kColI32) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    type[j] = static_cast<int>(cols[2 * j]);
    col[j] = static_cast<const char*>(dev_in) + cols[2 * j + 1];
  }
  char* out = static_cast<char*>(dev_out);
  const pcv::CompactOut o{reinterpret_cast<long long*>(out),
                          reinterpret_cast<double*>(out + 16),
                          reinterpret_cast<int*>(out + 16 + 24 * n),
                          reinterpret_cast<uint8_t*>(out + 16 + 28 * n)};
  auto* states = static_cast<unsigned long long*>(scratch);
  pcv::EncodedRows rows;
  rows.enc = dev_in;
  rows.encoding = encoding;
  rows.fma = fma != 0 && encoding <= 2;
  rows.div = encoding == 1 ? 255.0 : 65535.0;
  rows.edge = node[3];
  for (int k = 0; k < 3; ++k) rows.cube_min[k] = node[k];
  for (int j = 0; j < pcv::kMaskMaxIntervals; ++j) {
    rows.col[j] = j < n_intervals ? col[j] : nullptr;
    rows.type[j] = j < n_intervals ? type[j] : pcv::kColF64;
  }
  return pcv::launch_compact(kind, c, n_intervals, rows, n, o, states,
                             static_cast<cudaStream_t>(stream));
}

// A node's round trip on `stream`: host_in (pinned, in_bytes, laid out as
// pcv_query_decode_launch's dev_in) -> dev_in, the launch, the count ->
// host_out (pinned), a sync, then the kept rows alone -> host_out, a sync.
// When it returns 0, host_out holds the count and the kept rows in
// dev_out's layout; n = 0 writes a count of 0.
int pcv_query_decode_mask(int kind, const double* params, int n_intervals,
                          int encoding, int fma, const double* node,
                          const long long* cols, long long n,
                          long long in_bytes, const void* host_in,
                          void* dev_in, void* dev_out, void* host_out,
                          void* scratch, void* stream) {
  if (pcv::bad_args(kind, n_intervals, n) || encoding < 1 || encoding > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  char* h = static_cast<char*>(host_out);
  auto* host_kept = reinterpret_cast<long long*>(h);
  *host_kept = 0;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(dev_in, host_in,
                                    static_cast<size_t>(in_bytes),
                                    cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int launched = pcv_query_decode_launch(
      kind, params, n_intervals, encoding, fma, node, cols, n, dev_in,
      dev_out, scratch, stream);
  if (launched != 0) return launched;
  const char* d = static_cast<const char*>(dev_out);
  err = cudaMemcpyAsync(h, d, sizeof(long long), cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long k = *host_kept;
  if (k < 0 || k > n) return static_cast<int>(cudaErrorUnknown);
  if (k > 0) {
    const size_t ku = static_cast<size_t>(k);
    const size_t rows_at = 16 + 24 * static_cast<size_t>(n);
    const size_t codes_at = 16 + 28 * static_cast<size_t>(n);
    err = cudaMemcpyAsync(h + 16, d + 16, 24 * ku, cudaMemcpyDeviceToHost, s);
    if (err == cudaSuccess) {
      err = cudaMemcpyAsync(h + rows_at, d + rows_at, 4 * ku,
                            cudaMemcpyDeviceToHost, s);
    }
    if (err == cudaSuccess) {
      err = cudaMemcpyAsync(h + codes_at, d + codes_at, ku,
                            cudaMemcpyDeviceToHost, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaStreamSynchronize(s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// A node's files read whole, for NodeDecode to call once a node with the
// GIL released: `paths` holds `count` NUL-terminated paths one after
// another, and expect[i] the size the node's meta gives file i.  Each file
// gets a slot of expect[i] + 1 bytes rounded up to 16, the first `staged`
// one after another in buf0 (cap0 bytes), the rest in buf1 (cap1 bytes),
// and is read with one read() into it: a file of the expected size comes
// back short of its slot, so it costs open, read and close alone; another
// size is confirmed with fstat().  out (2 count + 2 long longs) receives
// each file's size, each slot's offset, and the bytes each buffer needs.
// Returns 0 when every file was read; 1 when a buffer is too small or a
// file larger than its slot (call again with expect = the sizes in out);
// -errno when a file cannot be opened or read (its size reads -1).
int pcv_read_node_files(int count, int staged, const char* paths,
                        const long long* expect, void* buf0, long long cap0,
                        void* buf1, long long cap1, long long* out) {
  long long* sizes = out;
  long long* offsets = out + count;
  long long need[2] = {0, 0};
  if (count < 1 || staged < 1 || staged > count) return -EINVAL;
  for (int i = 0; i < count; ++i) {
    const int g = i < staged ? 0 : 1;
    offsets[i] = need[g];
    need[g] += (expect[i] + 1 + 15) / 16 * 16;
  }
  out[2 * count] = need[0];
  out[2 * count + 1] = need[1];
  if (need[0] > cap0 || need[1] > cap1) return 1;
  int status = 0;
  const char* path = paths;
  for (int i = 0; i < count; ++i, path += std::strlen(path) + 1) {
    const long long slot = (expect[i] + 1 + 15) / 16 * 16;
    char* dst = static_cast<char*>(i < staged ? buf0 : buf1) + offsets[i];
    const int fd = open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) {
      sizes[i] = -1;
      return -errno;
    }
    long long done = 0;
    for (;;) {
      const ssize_t got =
          read(fd, dst + done, static_cast<size_t>(slot - done));
      if (got < 0 && errno == EINTR) continue;
      if (got < 0) {
        const int err = errno;
        close(fd);
        sizes[i] = -1;
        return -err;
      }
      done += got;
      if (got == 0 || done == slot || done == expect[i]) break;
    }
    sizes[i] = done;
    if (done != expect[i]) {
      struct stat st;
      if (fstat(fd, &st) != 0) {
        const int err = errno;
        close(fd);
        sizes[i] = -1;
        return -err;
      }
      sizes[i] = static_cast<long long>(st.st_size);
      if (sizes[i] != done) status = 1;
    }
    close(fd);
  }
  return status;
}

// wmc_project over (n, 3) device positions into (n, 2) on `stream`
// (consts: 8 host doubles, WmcConsts); no sync.
int pcv_web_mercator_project(const double* consts, const double* dev_pos,
                             long long n, double* dev_out, void* stream) {
  if (n < 0 || n > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  pcv::WmcConsts c;
  std::memcpy(&c, consts, sizeof(c));
  pcv::wmc_project_kernel<<<pcv::grid_for(n), pcv::kMaskThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      c, dev_pos, n, dev_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
