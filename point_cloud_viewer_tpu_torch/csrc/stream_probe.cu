// K7: the streaming-bandwidth probe.  One pass over 1, 2 or 3 f32 input
// streams and one output stream, with a device scalar s:
//   copy   o = x + s
//   triad  o = x + s * y
//   add3   o = (x + y) + s * z
//
// Replaces the Pallas kernel of the repository's bench.py, _hbm_probes
// `pallas_copy` (the pl.pallas_call at bench.py:199, body copy_kernel
// :196-197), which copies (2048, 128) f32 blocks through VMEM
// along a sequential grid and adds an SMEM scalar to each; triad and add3
// are the shapes bench.py:236-256 runs through XLA.  Its measured rate is
// the denominator of every kernel's bound (ops/hbm_probe.py).
//
// Bound: bytes.  Each element is read once from every input stream and
// written once (8, 12 or 16 B), one or two flops per element.  The design
// is the plainest one that keeps enough loads in flight: a grid-stride loop
// over float4 (16 B a thread, neighbouring threads on neighbouring
// addresses), a few blocks per SM, and a scalar loop for the last n % 4
// elements.  If any pointer is not 16-byte aligned the same kernel runs
// its scalar loop over everything.  s is read from device memory by every
// thread (one broadcast load), so a caller can feed each launch the output
// of the one before with nothing copied up.
//
// Rounding: every product and sum is a separately rounded IEEE op
// (__fmul_rn / __fadd_rn, so nvcc contracts nothing into an FMA), in the
// order above.  So the kernel is bit-equal to stream_probe_plain
// (point_cloud_viewer_tpu_torch/ops/hbm_probe.py) and to the jnp
// expressions of bench.py:152, 239, 249.

#include <cstdint>

#include <cuda_runtime.h>

namespace pcv {
namespace {

constexpr int kProbeThreads = 256;
constexpr int kProbeBlocksPerSm = 8;

enum ProbeMode { kCopy = 0, kTriad = 1, kAdd3 = 2 };

template <int MODE>
__device__ __forceinline__ float probe_op(float x, float y, float z,
                                          float s) {
  if (MODE == kCopy) return __fadd_rn(x, s);
  if (MODE == kTriad) return __fadd_rn(x, __fmul_rn(s, y));
  return __fadd_rn(__fadd_rn(x, y), __fmul_rn(s, z));
}

template <int MODE>
__device__ __forceinline__ float4 probe_op4(float4 x, float4 y, float4 z,
                                            float s) {
  return make_float4(probe_op<MODE>(x.x, y.x, z.x, s),
                     probe_op<MODE>(x.y, y.y, z.y, s),
                     probe_op<MODE>(x.z, y.z, z.z, s),
                     probe_op<MODE>(x.w, y.w, z.w, s));
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(kProbeThreads)
stream_probe_kernel(const float* __restrict__ x,
                    const float* __restrict__ y,   // triad, add3
                    const float* __restrict__ z,   // add3
                    const float* __restrict__ s,   // (1,)
                    float* __restrict__ o, long long n) {
  const float sv = __ldg(s);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (VEC) {
    const long long n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    const float4* z4 = reinterpret_cast<const float4*>(z);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (long long i = tid; i < n4; i += stride) {
      const float4 a = x4[i];
      const float4 b = MODE != kCopy ? y4[i] : a;
      const float4 c = MODE == kAdd3 ? z4[i] : a;
      o4[i] = probe_op4<MODE>(a, b, c, sv);
    }
    done = n4 << 2;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float b = MODE != kCopy ? y[i] : 0.f;
    const float c = MODE == kAdd3 ? z[i] : 0.f;
    o[i] = probe_op<MODE>(x[i], b, c, sv);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int MODE>
void launch(const float* x, const float* y, const float* z, const float* s,
            float* o, long long n, bool vec, cudaStream_t stream) {
  const long long work = vec ? (n >> 2) : n;
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (work + kProbeThreads - 1) / kProbeThreads;
  const long long cap = static_cast<long long>(sms) * kProbeBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec) {
    stream_probe_kernel<MODE, true>
        <<<grid, kProbeThreads, 0, stream>>>(x, y, z, s, o, n);
  } else {
    stream_probe_kernel<MODE, false>
        <<<grid, kProbeThreads, 0, stream>>>(x, y, z, s, o, n);
  }
}

}  // namespace
}  // namespace pcv

extern "C" {

// mode: 0 copy, 1 triad, 2 add3.  x, s and o always; y for triad and add3;
// z for add3.  n must be > 0 (a grid of 0 is a launch error).
int pcv_stream_probe(int mode, const float* x, const float* y, const float* z,
                     const float* s, float* o, long long n, void* stream) {
  if (n <= 0 || mode < pcv::kCopy || mode > pcv::kAdd3 || !x || !s || !o ||
      (mode != pcv::kCopy && !y) || (mode == pcv::kAdd3 && !z)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = pcv::aligned16(x) && pcv::aligned16(o) &&
                   (mode == pcv::kCopy || pcv::aligned16(y)) &&
                   (mode != pcv::kAdd3 || pcv::aligned16(z));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case pcv::kCopy:
      pcv::launch<pcv::kCopy>(x, y, z, s, o, n, vec, st);
      break;
    case pcv::kTriad:
      pcv::launch<pcv::kTriad>(x, y, z, s, o, n, vec, st);
      break;
    default:
      pcv::launch<pcv::kAdd3>(x, y, z, s, o, n, vec, st);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
