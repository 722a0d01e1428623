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
// Bound: bytes over PCIe, then HBM.  A row reads 24 B of positions and 8 B
// an interval and writes 1 B; the work is a few dozen flops a row (the
// projection's transcendentals for a tile).

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

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

// Grid-stride over the rows; pos is (n, 3), cols (n_intervals, n).
template <int KIND>
__global__ void __launch_bounds__(kMaskThreads)
query_mask_kernel(const MaskParams c, int n_intervals,
                  const double* __restrict__ pos,
                  const double* __restrict__ cols, long long n,
                  uint8_t* __restrict__ codes) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    bool keep = true;
    for (int j = 0; j < n_intervals; ++j) {
      const double v = cols[j * n + i];
      keep = keep && v >= c.lo[j] && v <= c.hi[j];
    }
    bool in, uncertain;
    classify<KIND>(c, pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], in,
                   uncertain);
    codes[i] = static_cast<uint8_t>(keep ? (in ? 1 : 0) | (uncertain ? 2 : 0)
                                         : 0);
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
  const double* cols = pos + 3 * n;
  switch (kind) {
    case kAabb:
      query_mask_kernel<kAabb><<<grid, kMaskThreads, 0, s>>>(
          c, n_intervals, pos, cols, n, codes);
      break;
    case kObb:
      query_mask_kernel<kObb><<<grid, kMaskThreads, 0, s>>>(
          c, n_intervals, pos, cols, n, codes);
      break;
    case kFrustum:
      query_mask_kernel<kFrustum><<<grid, kMaskThreads, 0, s>>>(
          c, n_intervals, pos, cols, n, codes);
      break;
    case kWebMercator:
      query_mask_kernel<kWebMercator><<<grid, kMaskThreads, 0, s>>>(
          c, n_intervals, pos, cols, n, codes);
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
