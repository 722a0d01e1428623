// Tile-shape sweep of the look-back scan (../lookback_scan.cuh): K1's sum
// (i32) and K2's segment start at level 8 (u8 in, i32 out), forward, at
// 16,000,017 and 64,000,017 elements, for block shapes threads x items.
// Each shape is checked against a host reference and timed over 30
// back-to-back sweeps (memset + launch) with CUDA events; a device-to-
// device copy of the i32 array is the yardstick.  The product kernels use
// kLbThreads x kLbItems; this program is how that shape was chosen.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o lookback_tiles point_cloud_viewer_tpu_torch/csrc/tune/lookback_tiles.cu
//   ./lookback_tiles

#include <cstdio>
#include <vector>

#include "../lookback_scan.cuh"

namespace pcv {
namespace {

struct LoadI32 {
  using In = int;
  const int* p;
  __device__ int lift(long long, int v) const { return v; }
  __device__ bool closes(int) const { return false; }
};

struct LoadSegStart {
  using In = uint8_t;
  const uint8_t* p;
  int level;
  __device__ int lift(long long i, uint8_t b) const {
    return b <= level ? static_cast<int>(i) : 0;
  }
  __device__ bool closes(int agg) const { return agg > 0; }
};

struct StoreInclusive {
  int* out;
  __device__ int value(int, int incl) const { return incl; }
};

constexpr int kReps = 30;

template <class Op, int THREADS, int ITEMS, class Src>
void sweep(const char* name, Src src, int* out, const std::vector<int>& want,
           long long n, unsigned long long* scratch) {
  const long long tiles = (n + THREADS * ITEMS - 1) / (THREADS * ITEMS);
  auto once = [&] {
    cudaMemsetAsync(scratch, 0, (tiles + 1) * sizeof(unsigned long long));
    lookback_scan<Op, false, true, THREADS, ITEMS>
        <<<static_cast<unsigned>(tiles), THREADS>>>(src, StoreInclusive{out},
                                                    n, scratch);
  };
  once();
  cudaDeviceSynchronize();
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  cudaEventRecord(start);
  for (int r = 0; r < kReps; ++r) once();
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, start, end);
  std::vector<int> got(n);
  cudaMemcpy(got.data(), out, n * sizeof(int), cudaMemcpyDeviceToHost);
  long long bad = 0;
  for (long long i = 0; i < n; ++i) bad += got[i] != want[i];
  printf("%s n=%lld threads %d items %d: %.4f ms, mismatches %lld, %s\n",
         name, n, THREADS, ITEMS, ms / kReps, bad,
         cudaGetErrorString(cudaGetLastError()));
}

}  // namespace
}  // namespace pcv

int main() {
  using namespace pcv;
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s\n", prop.name);
  for (long long n : {16000017LL, 64000017LL}) {
    // x: small values (the sum never wraps); b: a start (b <= 8) at about
    // one element in 64, and at element 0.
    std::vector<int> x(n), sums(n), starts(n);
    std::vector<uint8_t> b(n);
    unsigned h = 1;
    int sum = 0, last = 0;
    for (long long i = 0; i < n; ++i) {
      h = h * 1664525u + 1013904223u;
      x[i] = static_cast<int>(h >> 28) - 8;
      b[i] = i == 0 || (h >> 20) % 64 == 0 ? 3 : 20;
      sum += x[i];
      sums[i] = sum;
      if (b[i] <= 8) last = static_cast<int>(i);
      starts[i] = last;
    }
    int *dx, *dout;
    uint8_t* db;
    unsigned long long* scratch;
    cudaMalloc(&dx, n * sizeof(int));
    cudaMalloc(&dout, n * sizeof(int));
    cudaMalloc(&db, n);
    cudaMalloc(&scratch, (n / 1024 + 2) * sizeof(unsigned long long));
    cudaMemcpy(dx, x.data(), n * sizeof(int), cudaMemcpyHostToDevice);
    cudaMemcpy(db, b.data(), n, cudaMemcpyHostToDevice);
    const LoadI32 k1{dx};
    const LoadSegStart k2{db, 8};
    sweep<SumOp, 128, 16>("K1", k1, dout, sums, n, scratch);
    sweep<SumOp, 128, 32>("K1", k1, dout, sums, n, scratch);
    sweep<SumOp, 128, 48>("K1", k1, dout, sums, n, scratch);
    sweep<SumOp, 128, 64>("K1", k1, dout, sums, n, scratch);
    sweep<SumOp, 256, 8>("K1", k1, dout, sums, n, scratch);
    sweep<SumOp, 256, 16>("K1", k1, dout, sums, n, scratch);
    sweep<SumOp, 256, 32>("K1", k1, dout, sums, n, scratch);
    sweep<SumOp, 256, 48>("K1", k1, dout, sums, n, scratch);
    sweep<SumOp, 256, 64>("K1", k1, dout, sums, n, scratch);
    sweep<SumOp, 384, 32>("K1", k1, dout, sums, n, scratch);
    sweep<SumOp, 512, 16>("K1", k1, dout, sums, n, scratch);
    sweep<SumOp, 512, 32>("K1", k1, dout, sums, n, scratch);
    sweep<MaxOp, 128, 16>("K2", k2, dout, starts, n, scratch);
    sweep<MaxOp, 128, 32>("K2", k2, dout, starts, n, scratch);
    sweep<MaxOp, 128, 64>("K2", k2, dout, starts, n, scratch);
    sweep<MaxOp, 128, 128>("K2", k2, dout, starts, n, scratch);
    sweep<MaxOp, 256, 16>("K2", k2, dout, starts, n, scratch);
    sweep<MaxOp, 256, 32>("K2", k2, dout, starts, n, scratch);
    sweep<MaxOp, 256, 48>("K2", k2, dout, starts, n, scratch);
    sweep<MaxOp, 256, 64>("K2", k2, dout, starts, n, scratch);
    sweep<MaxOp, 512, 16>("K2", k2, dout, starts, n, scratch);
    sweep<MaxOp, 512, 32>("K2", k2, dout, starts, n, scratch);
    cudaEvent_t start, end;
    cudaEventCreate(&start);
    cudaEventCreate(&end);
    cudaEventRecord(start);
    for (int r = 0; r < kReps; ++r) {
      cudaMemcpyAsync(dout, dx, n * sizeof(int), cudaMemcpyDeviceToDevice);
    }
    cudaEventRecord(end);
    cudaEventSynchronize(end);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, start, end);
    printf("copy n=%lld: cudaMemcpy device to device %.4f ms\n", n,
           ms / kReps);
    cudaFree(dx);
    cudaFree(dout);
    cudaFree(db);
    cudaFree(scratch);
  }
  return 0;
}
