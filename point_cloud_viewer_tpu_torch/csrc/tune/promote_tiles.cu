// Tile-shape sweep of K4's promotion stage (../promote.cu): 21 levels
// (max_split_level 21 down to 1) at 16,000,017 and 64,000,017 rows, for
// tiles of THREADS x 32 rows, on two inputs:
//   * codes       -- b and leaf levels of sorted synthetic 63-bit codes
//                    (uniform, plus dense cells holding 10 / 5 / 3 / 2 % of
//                    the rows; leaf threshold 100,000);
//   * start only  -- row 0 the only start and every row at level 21, the
//                    longest look-back at every level.
// Each shape is checked against a host reference and timed over 20 back-to-
// back stages (memset + launch) with CUDA events; a device-to-device copy
// of b and leaf (the stage's least traffic) is the yardstick.  The product
// kernel uses kPromoteThreads; this program is how that shape was chosen.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o promote_tiles point_cloud_viewer_tpu_torch/csrc/tune/promote_tiles.cu
//   ./promote_tiles

#include <algorithm>
#include <cstdio>
#include <vector>

#include "../promote.cu"

namespace {

constexpr int kReps = 20;
constexpr int kLevels = 21;
constexpr long long kMaxPoints = 100000;

unsigned long long next(unsigned long long& h) {
  h ^= h << 13;
  h ^= h >> 7;
  h ^= h << 17;
  return h;
}

// b of sorted codes made by random gaps: dense cells are runs of narrow
// gaps.  b = the shallowest level whose prefix changes from the row before
// (depth 21; 22 for an equal code), row 0 level 0.
void codes_input(long long n, std::vector<uint8_t>& b,
                 std::vector<uint8_t>& leaf) {
  unsigned long long h = 88172645463325252ull, code = 0;
  // Uniform gaps of mean 2^63 / n; four dense cells, rows [start, start +
  // count) inside one cell of 2^low_bits codes.
  const unsigned long long range = (1ull << 63) / n * 2;
  const double frac[4] = {0.10, 0.05, 0.03, 0.02};
  const int low_bits[4] = {16, 24, 30, 40};
  long long start[4], count[4], at = 0;
  for (int c = 0; c < 4; ++c) {
    at += n / 9;
    start[c] = at;
    count[c] = static_cast<long long>(n * frac[c]);
    at += count[c];
  }
  b.assign(n, 0);
  for (long long i = 1; i < n; ++i) {
    unsigned long long gap = next(h) % range;
    for (int c = 0; c < 4; ++c) {
      if (i >= start[c] && i < start[c] + count[c]) {
        const unsigned long long span = (1ull << low_bits[c]) / count[c];
        gap = span ? next(h) % (2 * span) : (next(h) & 1);
      }
    }
    const unsigned long long x = code ^ (code + gap);
    code += gap;
    b[i] = x == 0 ? 22 : static_cast<uint8_t>(
        21 - std::min(21, (63 - __builtin_clzll(x)) / 3));
  }
  // Leaf: the first level whose segment holds <= kMaxPoints rows, else 21.
  leaf.assign(n, 0);
  for (int l = 1; l <= kLevels; ++l) {
    long long s = 0;
    for (long long i = 1; i <= n; ++i) {
      if (i == n || b[i] <= l) {
        if (i - s <= kMaxPoints) {
          for (long long j = s; j < i; ++j) {
            if (!leaf[j]) leaf[j] = static_cast<uint8_t>(l);
          }
        }
        s = i;
      }
    }
  }
  for (auto& v : leaf) {
    if (!v) v = kLevels;
  }
}

std::vector<uint8_t> host_promote(const std::vector<uint8_t>& b,
                                  std::vector<uint8_t> cur) {
  for (int l = kLevels; l >= 1; --l) {
    int cnt = 0;
    for (size_t i = 0; i < b.size(); ++i) {
      if (b[i] <= l) cnt = 0;
      if (cur[i] == l) {
        if ((cnt & 7) == 0) cur[i] = static_cast<uint8_t>(l - 1);
        ++cnt;
      }
    }
  }
  return cur;
}

template <int THREADS>
void sweep(const char* input, long long n, const uint8_t* b,
           const uint8_t* leaf, uint8_t* out, unsigned long long* scratch,
           const std::vector<uint8_t>& want) {
  auto once = [&] {
    return pcv::run_promote<THREADS>(b, leaf, out, n, kLevels, kLevels,
                                     scratch, 0);
  };
  cudaError_t err = once();
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
  std::vector<uint8_t> got(n);
  cudaMemcpy(got.data(), out, n, cudaMemcpyDeviceToHost);
  long long bad = 0;
  for (long long i = 0; i < n; ++i) bad += got[i] != want[i];
  printf("stage %s n=%lld threads %d (tile %d rows): %.4f ms, mismatches "
         "%lld, %s / %s\n", input, n, THREADS, THREADS * 32, ms / kReps, bad,
         cudaGetErrorString(err), cudaGetErrorString(cudaGetLastError()));
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s\n", prop.name);
  for (long long n : {16000017LL, 64000017LL}) {
    uint8_t *db, *dleaf, *dout;
    unsigned long long* scratch;
    cudaMalloc(&db, n);
    cudaMalloc(&dleaf, n);
    cudaMalloc(&dout, n);
    cudaMalloc(&scratch, (1 + kLevels * (n / 4096 + 1)) * 8);
    for (const char* input : {"codes", "start only"}) {
      std::vector<uint8_t> b, leaf;
      if (input[0] == 'c') {
        codes_input(n, b, leaf);
      } else {
        b.assign(n, 22);
        b[0] = 0;
        leaf.assign(n, kLevels);
      }
      const std::vector<uint8_t> want = host_promote(b, leaf);
      cudaMemcpy(db, b.data(), n, cudaMemcpyHostToDevice);
      cudaMemcpy(dleaf, leaf.data(), n, cudaMemcpyHostToDevice);
      sweep<128>(input, n, db, dleaf, dout, scratch, want);
      sweep<256>(input, n, db, dleaf, dout, scratch, want);
      sweep<512>(input, n, db, dleaf, dout, scratch, want);
    }
    cudaEvent_t start, end;
    cudaEventCreate(&start);
    cudaEventCreate(&end);
    cudaEventRecord(start);
    for (int r = 0; r < kReps; ++r) {
      cudaMemcpyAsync(dout, db, n, cudaMemcpyDeviceToDevice);
      cudaMemcpyAsync(dout, dleaf, n, cudaMemcpyDeviceToDevice);
    }
    cudaEventRecord(end);
    cudaEventSynchronize(end);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, start, end);
    printf("copy n=%lld: two device-to-device copies of n bytes %.4f ms\n",
           n, ms / kReps);
    cudaFree(db);
    cudaFree(dleaf);
    cudaFree(dout);
    cudaFree(scratch);
  }
  return 0;
}
