// Host-side native kernels of point_cloud_viewer_tpu_torch: the port's copy
// of point_cloud_viewer_tpu/native/pcv_native.cpp, unchanged in behaviour,
// holding only the extern "C" functions the port calls (the position
// decode, Morton encoding and the radix argsort, the host tree derivation
// tree_levels (pcv_native.cpp:392-466: the host build route and the deep
// build's smaller fat-cell sub-builds), the builder's grouping and
// gathers, the host cull, the meta.pb fast parser) and the position
// encode behind native.encode_positions (pcv_native.cpp:47-67).  Left
// out: decode_to_f32_relative (pcv_native.cpp:267-276), which no Python
// wrapper of the JAX package calls.
//
// Built as a plain shared library with g++ (native/__init__.py); Python
// binds via ctypes (no pybind11).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <cmath>
#include <limits>
#include <queue>
#include <thread>
#include <vector>

// Worker-thread count: hardware_concurrency capped at `cap`, overridable
// via PCV_NATIVE_THREADS (tests use it to exercise the multithreaded
// paths on single-core hosts; deployments can pin it).
static int pcv_num_threads(int cap) {
    const char* s = std::getenv("PCV_NATIVE_THREADS");
    if (s) {
        const int v = std::atoi(s);
        if (v > 0) return std::min(v, cap);
    }
    return std::max(
        1, (int)std::min<int64_t>(std::thread::hardware_concurrency(), cap));
}

extern "C" {

// ---------------------------------------------------------------------------
// Position codec: fixpoint/normalized encode+decode, interleaved xyz.
// t = clamp((p - min) / edge, 0, 1); integers truncate (Rust `as` semantics).

static inline double clamp01(double v) {
    if (!(v > 0.0)) return 0.0;  // also catches NaN
    if (v > 1.0) return 1.0;
    return v;
}

void encode_positions_u8(const double* pos, const double* cube_min,
                         const double* edge, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const double e = edge[i];
        for (int d = 0; d < 3; ++d) {
            double t = e > 0.0 ? (pos[3 * i + d] - cube_min[3 * i + d]) / e : 0.0;
            out[3 * i + d] = (uint8_t)(clamp01(t) * 255.0);
        }
    }
}

void encode_positions_u16(const double* pos, const double* cube_min,
                          const double* edge, int64_t n, uint16_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const double e = edge[i];
        for (int d = 0; d < 3; ++d) {
            double t = e > 0.0 ? (pos[3 * i + d] - cube_min[3 * i + d]) / e : 0.0;
            out[3 * i + d] = (uint16_t)(clamp01(t) * 65535.0);
        }
    }
}

void decode_positions_u8(const uint8_t* enc, const double* cube_min,
                         const double* edge, int64_t n, double* out) {
    for (int64_t i = 0; i < n; ++i)
        for (int d = 0; d < 3; ++d)
            out[3 * i + d] =
                (double)enc[3 * i + d] / 255.0 * edge[i] + cube_min[3 * i + d];
}

void decode_positions_u16(const uint16_t* enc, const double* cube_min,
                          const double* edge, int64_t n, double* out) {
    for (int64_t i = 0; i < n; ++i)
        for (int d = 0; d < 3; ++d)
            out[3 * i + d] =
                (double)enc[3 * i + d] / 65535.0 * edge[i] + cube_min[3 * i + d];
}

// ---------------------------------------------------------------------------
// Morton encoding: (N, 3) u32 cells (21 bits/axis) -> u64 codes, x msb.

static inline uint64_t spread3(uint64_t x) {
    x &= 0x1fffff;
    x = (x | (x << 32)) & 0x1f00000000ffffULL;
    x = (x | (x << 16)) & 0x1f0000ff0000ffULL;
    x = (x | (x << 8)) & 0x100f00f00f00f00fULL;
    x = (x | (x << 4)) & 0x10c30c30c30c30c3ULL;
    x = (x | (x << 2)) & 0x1249249249249249ULL;
    return x;
}

void morton_encode(const uint32_t* cells, int64_t n, uint64_t* out) {
    const int num_threads = pcv_num_threads(16);
    if (n < 100000 || num_threads <= 1) {
        for (int64_t i = 0; i < n; ++i)
            out[i] = (spread3(cells[3 * i]) << 2) |
                     (spread3(cells[3 * i + 1]) << 1) | spread3(cells[3 * i + 2]);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n + num_threads - 1) / num_threads;
    for (int t = 0; t < num_threads; ++t) {
        int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
        threads.emplace_back([=]() {
            for (int64_t i = lo; i < hi; ++i)
                out[i] = (spread3(cells[3 * i]) << 2) |
                         (spread3(cells[3 * i + 1]) << 1) |
                         spread3(cells[3 * i + 2]);
        });
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Stable LSD radix argsort of u64 keys.  Two classic optimizations over the
// fixed 4x16-bit version (both leave the stable result bit-identical —
// digit widths never change an LSD argsort's output):
//  * adaptive digit width from the keys' actual bit-length: 51-bit Morton
//    codes (the depth-17 bench resolution) sort in 3x17-bit passes instead
//    of 4x16; small keys (the spill's 6-bit bucket ids) in ONE pass;
//  * single-threaded only: all pass histograms in a single read pass
//    (a GLOBAL histogram is permutation-invariant, so pass p's counts
//    computed on the original array are valid after p scatters; the
//    per-thread split used when multithreaded is NOT, so that path
//    recounts each pass on the current array).
// Constant digits (e.g. a shared bucket prefix) skip their scatter pass.

void radix_argsort_u64(const uint64_t* keys, int64_t n, int64_t* perm_out,
                       uint64_t* keys_out) {
    const int num_threads = pcv_num_threads(16);
    const int64_t chunk = (n + num_threads - 1) / num_threads;

    // Bit-length of the largest key (OR-fold: only the top set bit matters).
    uint64_t mx = 0;
    if (num_threads <= 1 || n < 1000000) {
        for (int64_t i = 0; i < n; ++i) mx |= keys[i];
    } else {
        std::vector<uint64_t> part(num_threads, 0);
        std::vector<std::thread> threads;
        for (int t = 0; t < num_threads; ++t) {
            threads.emplace_back([&, t]() {
                uint64_t m = 0;
                const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
                for (int64_t i = lo; i < hi; ++i) m |= keys[i];
                part[t] = m;
            });
        }
        for (auto& th : threads) th.join();
        for (uint64_t m : part) mx |= m;
    }
    int bits = 64;
    while (bits > 1 && !((mx >> (bits - 1)) & 1)) --bits;
    // Digits sized evenly across the passes.  Single-threaded cap is 11
    // bits: measured on 16M random 51-bit keys, 5x11 beats 3x17 by ~23%
    // (1.39 s vs 1.79 s) — 2048 scatter streams stay cache-resident where
    // 131072 thrash, and locality beats the extra passes' traffic (13-17
    // bit caps all measured slower; <=10 adds passes for no further
    // locality win).  Multithreaded keeps 16 (bounds per-thread histogram
    // memory).
    const int digit_cap = num_threads > 1 ? 16 : 11;
    const int passes = (bits + digit_cap - 1) / digit_cap;
    const int digit_bits = (bits + passes - 1) / passes;
    const int64_t buckets = (int64_t)1 << digit_bits;

    std::vector<uint64_t> k0(keys, keys + n), k1(n);
    // u32 permutation during the passes (n < 2^32 always holds for
    // in-memory clouds): 25% less scatter traffic than i64.
    std::vector<uint32_t> p0(n), p1(n);
    for (int64_t i = 0; i < n; ++i) p0[i] = (uint32_t)i;

    uint64_t* kin = k0.data();
    uint64_t* kout = k1.data();
    uint32_t* pin = p0.data();
    uint32_t* pout = p1.data();

    // Histograms.  Single-threaded: ONE read pass builds every pass's
    // histogram up front — valid because a GLOBAL histogram is
    // permutation-invariant, so pass p's counts taken on the original
    // array still hold after p scatters.  Multithreaded: that shortcut is
    // UNSOUND per-thread (after a scatter, thread t's chunk [t*chunk, ..)
    // holds different elements than it counted), so each pass counts its
    // own digits on the CURRENT array before scattering.
    const bool fused_hist = num_threads <= 1;
    std::vector<int64_t> hist(
        (size_t)(fused_hist ? passes : num_threads) * buckets, 0);
    if (fused_hist) {
        for (int64_t i = 0; i < n; ++i) {
            const uint64_t k = kin[i];
            for (int p = 0; p < passes; ++p)
                hist[(size_t)p * buckets +
                     ((k >> (p * digit_bits)) & (buckets - 1))]++;
        }
    }

    for (int pass = 0; pass < passes; ++pass) {
        const int shift = pass * digit_bits;
        int64_t* ph;
        if (fused_hist) {
            ph = hist.data() + (size_t)pass * buckets;
        } else {
            std::fill(hist.begin(), hist.end(), 0);
            std::vector<std::thread> threads;
            for (int t = 0; t < num_threads; ++t) {
                threads.emplace_back([&, t]() {
                    int64_t* h = hist.data() + (size_t)t * buckets;
                    const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
                    for (int64_t i = lo; i < hi; ++i)
                        h[(kin[i] >> shift) & (buckets - 1)]++;
                });
            }
            for (auto& th : threads) th.join();
            ph = hist.data();
        }
        // Skip constant digits (e.g. the shared prefix of one spill
        // bucket's codes).
        int nonzero = 0;
        for (int64_t b = 0; b < buckets && nonzero < 2; ++b) {
            int64_t s = 0;
            for (int t = 0; t < num_threads; ++t) s += ph[(size_t)t * buckets + b];
            if (s) nonzero++;
        }
        if (nonzero < 2) continue;
        // Exclusive prefix over (bucket, thread) so each thread scatters to
        // disjoint ranges (stable).
        int64_t acc = 0;
        for (int64_t b = 0; b < buckets; ++b) {
            for (int t = 0; t < num_threads; ++t) {
                int64_t& h = ph[(size_t)t * buckets + b];
                int64_t c = h;
                h = acc;
                acc += c;
            }
        }
        // Parallel scatter.
        {
            std::vector<std::thread> threads;
            for (int t = 0; t < num_threads; ++t) {
                threads.emplace_back([&, t]() {
                    int64_t* h = ph + (size_t)t * buckets;
                    const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
                    for (int64_t i = lo; i < hi; ++i) {
                        const int64_t o = h[(kin[i] >> shift) & (buckets - 1)]++;
                        kout[o] = kin[i];
                        pout[o] = pin[i];
                    }
                });
            }
            for (auto& th : threads) th.join();
        }
        std::swap(kin, kout);
        std::swap(pin, pout);
    }
    std::memcpy(keys_out, kin, sizeof(uint64_t) * n);
    for (int64_t i = 0; i < n; ++i) perm_out[i] = pin[i];
}

// ---------------------------------------------------------------------------
// Fused quantize + Morton encode: (N, 3) f64 world positions -> u64 codes
// (and optionally the u32 grid cells) in ONE pass over the input.
// Bit-identical to ops/morton.quantize + morton_encode:
//   t = (p - min) / edge;  c = floor(t * 2^depth);  clip to [0, 2^depth - 1].

void quantize_morton(const double* pos, const double* root_min, double edge,
                     int depth, int64_t n, uint64_t* codes_out,
                     uint32_t* cells_out /* nullable */) {
    const double scale = (double)(1ULL << depth);
    const double cmax = scale - 1.0;
    const double m0 = root_min[0], m1 = root_min[1], m2 = root_min[2];
    for (int64_t i = 0; i < n; ++i) {
        uint32_t c[3];
        const double p0 = pos[3 * i], p1 = pos[3 * i + 1], p2 = pos[3 * i + 2];
        double t0 = std::floor((p0 - m0) / edge * scale);
        double t1 = std::floor((p1 - m1) / edge * scale);
        double t2 = std::floor((p2 - m2) / edge * scale);
        // clip handles NaN like np.clip (NaN -> propagates; cast of NaN is 0
        // in numpy's astype on x86 via cvttsd2si -> here force 0 explicitly).
        t0 = t0 < 0.0 ? 0.0 : (t0 > cmax ? cmax : t0);
        t1 = t1 < 0.0 ? 0.0 : (t1 > cmax ? cmax : t1);
        t2 = t2 < 0.0 ? 0.0 : (t2 > cmax ? cmax : t2);
        c[0] = (t0 == t0) ? (uint32_t)t0 : 0u;
        c[1] = (t1 == t1) ? (uint32_t)t1 : 0u;
        c[2] = (t2 == t2) ? (uint32_t)t2 : 0u;
        codes_out[i] =
            (spread3(c[0]) << 2) | (spread3(c[1]) << 1) | spread3(c[2]);
        if (cells_out) {
            cells_out[3 * i] = c[0];
            cells_out[3 * i + 1] = c[1];
            cells_out[3 * i + 2] = c[2];
        }
    }
}

// ---------------------------------------------------------------------------
// Fused gather + per-node fixpoint encode: for each node k, the points
// idx[offsets[k] .. offsets[k+1]) of `pos` are encoded against the node's
// (min, edge).  Removes both the big position gather and the np.repeat'd
// per-point min/edge arrays from the builder's hot path.

}  // extern "C" — template helper needs C++ linkage

template <typename OutT>
static inline void gather_encode_impl(const double* pos, const int64_t* idx,
                                      const double* node_min,
                                      const double* node_edge,
                                      const int64_t* offsets, int64_t k,
                                      double tmax, OutT* out) {
    for (int64_t nd = 0; nd < k; ++nd) {
        const double e = node_edge[nd];
        const double m0 = node_min[3 * nd], m1 = node_min[3 * nd + 1],
                     m2 = node_min[3 * nd + 2];
        for (int64_t i = offsets[nd]; i < offsets[nd + 1]; ++i) {
            const int64_t j = idx[i];
            const double* p = pos + 3 * j;
            double t0 = e > 0.0 ? (p[0] - m0) / e : 0.0;
            double t1 = e > 0.0 ? (p[1] - m1) / e : 0.0;
            double t2 = e > 0.0 ? (p[2] - m2) / e : 0.0;
            out[3 * i] = (OutT)(clamp01(t0) * tmax);
            out[3 * i + 1] = (OutT)(clamp01(t1) * tmax);
            out[3 * i + 2] = (OutT)(clamp01(t2) * tmax);
        }
    }
}

extern "C" {

void gather_encode_u8(const double* pos, const int64_t* idx,
                      const double* node_min, const double* node_edge,
                      const int64_t* offsets, int64_t k, uint8_t* out) {
    gather_encode_impl(pos, idx, node_min, node_edge, offsets, k, 255.0, out);
}

void gather_encode_u16(const double* pos, const int64_t* idx,
                       const double* node_min, const double* node_edge,
                       const int64_t* offsets, int64_t k, uint16_t* out) {
    gather_encode_impl(pos, idx, node_min, node_edge, offsets, k, 65535.0, out);
}

// Same fused gather, normalized float output (f32/f64 encodings).
void gather_encode_f32(const double* pos, const int64_t* idx,
                       const double* node_min, const double* node_edge,
                       const int64_t* offsets, int64_t k, float* out) {
    for (int64_t nd = 0; nd < k; ++nd) {
        const double e = node_edge[nd];
        const double m0 = node_min[3 * nd], m1 = node_min[3 * nd + 1],
                     m2 = node_min[3 * nd + 2];
        for (int64_t i = offsets[nd]; i < offsets[nd + 1]; ++i) {
            const double* p = pos + 3 * idx[i];
            out[3 * i] = (float)clamp01(e > 0.0 ? (p[0] - m0) / e : 0.0);
            out[3 * i + 1] = (float)clamp01(e > 0.0 ? (p[1] - m1) / e : 0.0);
            out[3 * i + 2] = (float)clamp01(e > 0.0 ? (p[2] - m2) / e : 0.0);
        }
    }
}

void gather_encode_f64(const double* pos, const int64_t* idx,
                       const double* node_min, const double* node_edge,
                       const int64_t* offsets, int64_t k, double* out) {
    for (int64_t nd = 0; nd < k; ++nd) {
        const double e = node_edge[nd];
        const double m0 = node_min[3 * nd], m1 = node_min[3 * nd + 1],
                     m2 = node_min[3 * nd + 2];
        for (int64_t i = offsets[nd]; i < offsets[nd + 1]; ++i) {
            const double* p = pos + 3 * idx[i];
            out[3 * i] = clamp01(e > 0.0 ? (p[0] - m0) / e : 0.0);
            out[3 * i + 1] = clamp01(e > 0.0 ? (p[1] - m1) / e : 0.0);
            out[3 * i + 2] = clamp01(e > 0.0 ? (p[2] - m2) / e : 0.0);
        }
    }
}

// ---------------------------------------------------------------------------
// Per-point tree level assignment over SORTED Morton codes — the host
// mirror of ops/tree_build.build_tree_device (same leaf rule + LOD
// promotion, so grouping/encoding downstream is shared):
//   leaf[i]  = first level whose code-prefix segment holds <= max_points
//              points (root never a leaf; capped at max_split_level)
//   final[i] = leaf[i] after bottom-up promotion: per level, every 8th
//              point (rank % 8 == 0) resident in a node moves to its parent
//              (reference rule, src/octree/generation.rs:224-229).

// root_level/stop_level generalize to SUBTREE builds (the out-of-core
// bucket path): the DFS roots at the level-`root_level` node containing all
// codes (treated as split unconditionally), and promotion stops at
// `stop_level` — points accumulated there are the bucket residual the
// caller's top pass continues from.  The whole-tree build is
// root_level = stop_level = 0.
void tree_levels(const uint64_t* codes, int64_t n, int depth, int root_level,
                 int stop_level, int max_split_level, int64_t max_points,
                 uint8_t* leaf_out, uint8_t* final_out) {
    if (n == 0) return;
    // blevel[i]: shallowest level whose prefix differs between codes[i-1]
    // and codes[i]; segment of point i at level l starts at the nearest
    // j <= i with blevel[j] <= l.  blevel[0] = 0.
    std::vector<uint8_t> blevel(n);
    blevel[0] = 0;
    for (int64_t i = 1; i < n; ++i) {
        const uint64_t x = codes[i - 1] ^ codes[i];
        if (x == 0) {
            blevel[i] = (uint8_t)(max_split_level + 1);
        } else {
            const int hb = 63 - __builtin_clzll(x);
            const int l = depth - hb / 3;
            blevel[i] = (uint8_t)(l < 0 ? 0 : l);
        }
    }

    // Leaf assignment: DFS over splitting segments (root always splits).
    struct Seg { int64_t s, e; int l; };
    std::vector<Seg> stack;
    stack.push_back({0, n, root_level});
    std::vector<int64_t> level_count(max_split_level + 2, 0);
    while (!stack.empty()) {
        const Seg seg = stack.back();
        stack.pop_back();
        const int child_level = seg.l + 1;
        int64_t a = seg.s;
        for (int64_t i = seg.s + 1; i <= seg.e; ++i) {
            if (i < seg.e && blevel[i] > child_level) continue;
            const int64_t b = i;  // child segment [a, b)
            const int64_t cnt = b - a;
            if (cnt > max_points && child_level < max_split_level) {
                stack.push_back({a, b, child_level});
            } else {
                std::memset(leaf_out + a, child_level, (size_t)cnt);
                level_count[child_level] += cnt;
            }
            a = b;
        }
    }

    // LOD promotion, deepest level first, stopping at stop_level.
    std::memcpy(final_out, leaf_out, (size_t)n);
    for (int l = max_split_level; l >= stop_level + 1; --l) {
        if (level_count[l] == 0) continue;
        int64_t rank = 0;
        int64_t promoted = 0;
        for (int64_t i = 0; i < n; ++i) {
            if (blevel[i] <= l) rank = 0;
            if (final_out[i] == (uint8_t)l) {
                if (rank % 8 == 0) {
                    final_out[i] = (uint8_t)(l - 1);
                    ++promoted;
                }
                ++rank;
            }
        }
        level_count[l] -= promoted;
        level_count[l - 1] += promoted;
    }
}

// Full level grouping for the builder: counting-sort point indices by
// final level AND emit, per level, the distinct code-prefix runs (node
// paths + per-node counts) plus the distinct leaf prefixes (for the
// ancestor/node-set union done in numpy).  Replaces per-level
// codes[sel] >> shift gathers in Python (the dominant cost of grouping on
// slow-memory hosts).
//
// Two-call protocol: with idx_by_level == nullptr only the per-level node
// and leaf-path counts are produced (node_level_offsets / leaf_level_offsets
// hold COUNTS, not offsets, in that mode); the second call fills all
// arrays, with the offsets precomputed by the caller.

void group_levels_full(const uint64_t* codes, const uint8_t* final_lv,
                       const uint8_t* leaf_lv, int64_t n, int depth,
                       int num_levels,
                       int64_t* idx_by_level /*n, nullable*/,
                       int64_t* level_starts /*num_levels+1*/,
                       uint64_t* node_paths_flat,
                       int64_t* node_counts_flat,
                       int64_t* node_level_offsets /*num_levels+1*/,
                       uint64_t* leaf_paths_flat,
                       int64_t* leaf_level_offsets /*num_levels+1*/) {
    const bool fill = idx_by_level != nullptr;
    // Counting sort by final level (stable: ascending index order within
    // a level = code order).
    std::vector<int64_t> count(num_levels, 0);
    for (int64_t i = 0; i < n; ++i) count[final_lv[i]]++;
    std::vector<int64_t> starts(num_levels + 1);
    int64_t acc = 0;
    for (int l = 0; l < num_levels; ++l) {
        starts[l] = acc;
        acc += count[l];
    }
    starts[num_levels] = acc;
    std::vector<int64_t> cursor(starts.begin(), starts.end() - 1);
    std::vector<int64_t> own_idx;
    int64_t* idx = idx_by_level;
    if (!fill) {
        own_idx.resize(n);
        idx = own_idx.data();
    }
    for (int64_t i = 0; i < n; ++i) idx[cursor[final_lv[i]]++] = i;
    if (fill)
        std::memcpy(level_starts, starts.data(),
                    sizeof(int64_t) * (num_levels + 1));

    // Per level: distinct prefix runs over the level's points (code order).
    for (int l = 0; l < num_levels; ++l) {
        const int shift = 3 * (depth - l);
        int64_t n_nodes = 0;
        uint64_t last = 0;
        int64_t run = 0;
        int64_t out = fill ? node_level_offsets[l] : 0;
        for (int64_t i = starts[l]; i < starts[l + 1]; ++i) {
            const uint64_t pref =
                shift >= 64 ? 0 : codes[idx[i]] >> shift;
            if (run == 0 || pref != last) {
                if (fill && run > 0) {
                    node_paths_flat[out] = last;
                    node_counts_flat[out] = run;
                    ++out;
                }
                if (!fill && run > 0) ++n_nodes;
                last = pref;
                run = 1;
            } else {
                ++run;
            }
        }
        if (run > 0) {
            if (fill) {
                node_paths_flat[out] = last;
                node_counts_flat[out] = run;
                ++out;
            } else {
                ++n_nodes;
            }
        }
        if (!fill) node_level_offsets[l] = n_nodes;
    }

    // Leaf prefixes per level (distinct paths only).  Leaf levels are also
    // code-ordered within a level after a counting sort.
    std::fill(count.begin(), count.end(), 0);
    for (int64_t i = 0; i < n; ++i) count[leaf_lv[i]]++;
    std::vector<int64_t> lstarts(num_levels + 1);
    acc = 0;
    for (int l = 0; l < num_levels; ++l) {
        lstarts[l] = acc;
        acc += count[l];
    }
    lstarts[num_levels] = acc;
    std::vector<int64_t> lidx(n);
    std::vector<int64_t> lcursor(lstarts.begin(), lstarts.end() - 1);
    for (int64_t i = 0; i < n; ++i) lidx[lcursor[leaf_lv[i]]++] = i;
    for (int l = 0; l < num_levels; ++l) {
        const int shift = 3 * (depth - l);
        int64_t n_paths = 0;
        uint64_t last = 0;
        bool have = false;
        int64_t out = fill ? leaf_level_offsets[l] : 0;
        for (int64_t i = lstarts[l]; i < lstarts[l + 1]; ++i) {
            const uint64_t pref =
                shift >= 64 ? 0 : codes[lidx[i]] >> shift;
            if (!have || pref != last) {
                if (fill) leaf_paths_flat[out + n_paths] = pref;
                ++n_paths;
                last = pref;
                have = true;
            }
        }
        if (!fill) leaf_level_offsets[l] = n_paths;
    }
}

// Generic row gather: out[i] = src[idx[i]] for fixed-size rows.  numpy's
// fancy indexing pays significant per-row overhead at small row sizes
// (3-byte colors); this is a tight memcpy loop with common sizes inlined.

void gather_rows(const uint8_t* src, const int64_t* idx, int64_t n,
                 int64_t row_size, uint8_t* out) {
    switch (row_size) {
        case 1:
            for (int64_t i = 0; i < n; ++i) out[i] = src[idx[i]];
            return;
        case 3:
            for (int64_t i = 0; i < n; ++i)
                std::memcpy(out + 3 * i, src + 3 * idx[i], 3);
            return;
        case 4:
            for (int64_t i = 0; i < n; ++i)
                std::memcpy(out + 4 * i, src + 4 * idx[i], 4);
            return;
        case 8:
            for (int64_t i = 0; i < n; ++i)
                std::memcpy(out + 8 * i, src + 8 * idx[i], 8);
            return;
        case 24:
            for (int64_t i = 0; i < n; ++i)
                std::memcpy(out + 24 * i, src + 24 * idx[i], 24);
            return;
        default:
            for (int64_t i = 0; i < n; ++i)
                std::memcpy(out + row_size * i, src + row_size * idx[i],
                            (size_t)row_size);
    }
}

// ---------------------------------------------------------------------------
// Host-side frustum cull + LOD select — the interactive-latency twin of
// ops/culling._cull_core (same SAT relations, same hemicube screen-size
// heuristic, same stable descending-priority order).  On relay-attached
// accelerators a single device dispatch costs ~30 ms; node tables up to
// ~100k are faster to cull on host, so the viewer picks per table size.

}  // extern "C" — template with C++ linkage

// Per-node SAT out-test + projected-screen-size heuristic (reference:
// src/octree/mod.rs:119-139).  Returns geometric visibility (not-Out);
// `size_out` is the clamped projected xy-extent area.
template <typename F>
static inline bool eval_node_vis_size(const F* matrix, const F* axes,
                                      const F* qmin, const F* qmax, int64_t a,
                                      const F* mn, F e, F* size_out) {
    // 8 cube corners, x fastest (matches _CORNER_UNIT).
    F c[8][3];
    for (int ci = 0; ci < 8; ++ci) {
        c[ci][0] = mn[0] + ((ci & 1) ? e : F(0));
        c[ci][1] = mn[1] + ((ci & 2) ? e : F(0));
        c[ci][2] = mn[2] + ((ci & 4) ? e : F(0));
    }
    // SAT out-test against the cached frustum axes (visibility only
    // needs Out vs not-Out; early exit on the first separating axis).
    bool out = false;
    for (int64_t ax = 0; ax < a && !out; ++ax) {
        const F* av = axes + 3 * ax;
        F bmin = std::numeric_limits<F>::max();
        F bmax = std::numeric_limits<F>::lowest();
        for (int ci = 0; ci < 8; ++ci) {
            const F p =
                c[ci][0] * av[0] + c[ci][1] * av[1] + c[ci][2] * av[2];
            bmin = std::min(bmin, p);
            bmax = std::max(bmax, p);
        }
        if (bmin > qmax[ax] || bmax < qmin[ax]) out = true;
    }
    // Screen-size heuristic: clamped xy extent of the projected cube.
    F xmin = F(1), xmax = F(-1), ymin = F(1), ymax = F(-1);
    for (int ci = 0; ci < 8; ++ci) {
        const F w = matrix[12] * c[ci][0] + matrix[13] * c[ci][1] +
                    matrix[14] * c[ci][2] + matrix[15];
        const F px = (matrix[0] * c[ci][0] + matrix[1] * c[ci][1] +
                      matrix[2] * c[ci][2] + matrix[3]) / w;
        const F py = (matrix[4] * c[ci][0] + matrix[5] * c[ci][1] +
                      matrix[6] * c[ci][2] + matrix[7]) / w;
        const F cx = px < F(-1) ? F(-1) : (px > F(1) ? F(1) : px);
        const F cy = py < F(-1) ? F(-1) : (py > F(1) ? F(1) : py);
        xmin = std::min(xmin, cx); xmax = std::max(xmax, cx);
        ymin = std::min(ymin, cy); ymax = std::max(ymax, cy);
    }
    *size_out = (xmax - xmin) * (ymax - ymin);
    return !out;
}

template <typename F>
static void cull_lod_select_impl(const F* matrix, const F* axes, const F* qmin,
                                 const F* qmax, int64_t a, const F* node_min,
                                 const F* edge, const int32_t* num_points,
                                 int64_t k, int64_t max_out,
                                 int32_t* order_out, F* sizes_out,
                                 uint8_t* visible_out) {
    std::vector<F> priority(k);
    for (int64_t i = 0; i < k; ++i) {
        F size;
        const bool not_out = eval_node_vis_size<F>(
            matrix, axes, qmin, qmax, a, node_min + 3 * i, edge[i], &size);
        const bool vis = not_out && num_points[i] > 0;
        sizes_out[i] = size;
        visible_out[i] = vis ? 1 : 0;
        priority[i] = vis ? size : std::numeric_limits<F>::lowest();
    }
    for (int64_t i = 0; i < k; ++i) order_out[i] = (int32_t)i;
    // Index tie-break makes the order TOTAL, so partial_sort emits the
    // same stable order as stable_sort (ties are common: fully-covering
    // nodes all clamp to area 4, culled nodes all share lowest()) — the
    // top-K set/order must match the flat and device paths exactly.
    const auto cmp = [&](int32_t x, int32_t y) {
        if (priority[x] != priority[y]) return priority[x] > priority[y];
        return x < y;
    };
    if (max_out > 0 && max_out < k) {
        // Viewers draw at most a node budget per frame: a top-K partial
        // sort is O(N log K) instead of a full O(N log N) ordering.
        std::partial_sort(order_out, order_out + max_out, order_out + k, cmp);
    } else {
        std::sort(order_out, order_out + k, cmp);
    }
}

extern "C" {

void cull_lod_select(const float* matrix, const float* axes, const float* qmin,
                     const float* qmax, int64_t a, const float* node_min,
                     const float* edge, const int32_t* num_points, int64_t k,
                     int64_t max_out, int32_t* order_out, float* sizes_out,
                     uint8_t* visible_out) {
    cull_lod_select_impl<float>(matrix, axes, qmin, qmax, a, node_min, edge,
                                num_points, k, max_out, order_out, sizes_out,
                                visible_out);
}

void cull_lod_select_f64(const double* matrix, const double* axes,
                         const double* qmin, const double* qmax, int64_t a,
                         const double* node_min, const double* edge,
                         const int32_t* num_points, int64_t k,
                         int64_t max_out, int32_t* order_out,
                         double* sizes_out, uint8_t* visible_out) {
    cull_lod_select_impl<double>(matrix, axes, qmin, qmax, a, node_min, edge,
                                 num_points, k, max_out, order_out, sizes_out,
                                 visible_out);
}

}  // extern "C"

// Best-first heap traversal of the node tree — the reference's visible-node
// semantics (src/octree/mod.rs:228-283: pop the largest-screen-size node,
// emit, push its children) with early exit at the node budget.  Cost is
// O(emitted * 8 * log heap) and INDEPENDENT of the table size, so the
// all-visible worst case at 1M nodes meets the frame budget (the flat
// kernel scans every node).  Pop order is globally largest-first because a
// child's clamped projected extent never exceeds its parent's for cubes
// fully in front of the camera (point-wise containment under the
// projective map), so everything still unpushed is covered by an ancestor
// already in the heap.  KNOWN DIVERGENCE: a cube straddling the w=0 plane
// can give a child a LARGER clamped extent than its parent (the hemicube
// clamp is not monotone across w=0), so for such views the emitted set /
// order can differ from the flat top-max_out kernel.  This matches the
// reference, whose BinaryHeap has the same non-monotone sizes
// (src/octree/mod.rs:119-139 clip_point_to_hemicube + :228-283); it has
// no budget, so there the divergence only reorders output.
template <typename F>
static int64_t cull_lod_heap_impl(const F* matrix, const F* axes,
                                  const F* qmin, const F* qmax, int64_t a,
                                  const F* node_min, const F* edge,
                                  const int32_t* num_points,
                                  const int32_t* child_start,
                                  const int32_t* child_end, int32_t root,
                                  int64_t max_out, int32_t* order_out,
                                  F* sizes_out) {
    struct Item {
        F size;
        int32_t idx;
    };
    const auto less = [](const Item& x, const Item& y) {
        // max-heap by (size, then smaller index first) — deterministic ties.
        return x.size < y.size || (x.size == y.size && x.idx > y.idx);
    };
    std::priority_queue<Item, std::vector<Item>, decltype(less)> heap(less);
    F size;
    if (root >= 0 &&
        eval_node_vis_size<F>(matrix, axes, qmin, qmax, a,
                              node_min + 3 * root, edge[root], &size)) {
        heap.push({size, root});
    }
    int64_t emitted = 0;
    while (!heap.empty() && emitted < max_out) {
        const Item it = heap.top();
        heap.pop();
        if (num_points[it.idx] > 0) {
            order_out[emitted] = it.idx;
            sizes_out[emitted] = it.size;
            ++emitted;
        }
        for (int32_t c = child_start[it.idx]; c < child_end[it.idx]; ++c) {
            F csize;
            if (eval_node_vis_size<F>(matrix, axes, qmin, qmax, a,
                                      node_min + 3 * c, edge[c], &csize)) {
                heap.push({csize, c});
            }
        }
    }
    return emitted;
}

extern "C" {

int64_t cull_lod_heap_f64(const double* matrix, const double* axes,
                          const double* qmin, const double* qmax, int64_t a,
                          const double* node_min, const double* edge,
                          const int32_t* num_points,
                          const int32_t* child_start,
                          const int32_t* child_end, int32_t root,
                          int64_t max_out, int32_t* order_out,
                          double* sizes_out) {
    return cull_lod_heap_impl<double>(matrix, axes, qmin, qmax, a, node_min,
                                      edge, num_points, child_start,
                                      child_end, root, max_out, order_out,
                                      sizes_out);
}

// ---------------------------------------------------------------------------
// Fast meta.pb parser for the CURRENT octree layout (proto3 wire walk of
// Meta{1:version,4:bbox{3:min,4:max Vector3d},6:OctreeMeta{2:resolution,
// 3:repeated OctreeNode{2:encoding,3:num_points,4:NodeId{3:hi,4:lo}}}}).
// Per-node Python decoding costs ~17 us/node; this walks ~1M nodes in tens
// of milliseconds.  ANY unexpected field (legacy versions, s2 metas,
// deprecated ids) returns -1 and the caller falls back to the Python
// decoder, so migrations keep working.

namespace {

struct Cursor {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;
    uint64_t varint() {
        uint64_t v = 0;
        int shift = 0;
        while (p < end) {
            const uint8_t b = *p++;
            v |= (uint64_t)(b & 0x7f) << shift;
            if (!(b & 0x80)) return v;
            shift += 7;
            if (shift >= 64) break;
        }
        ok = false;
        return 0;
    }
    double fixed64() {
        if (end - p < 8) { ok = false; return 0.0; }
        double d;
        std::memcpy(&d, p, 8);
        p += 8;
        return d;
    }
};

// Parse Vector3d {1,2,3: double}; unknown fields bail.
static bool parse_vec3(Cursor c, double* out) {
    out[0] = out[1] = out[2] = 0.0;
    while (c.p < c.end && c.ok) {
        const uint64_t tag = c.varint();
        const int f = (int)(tag >> 3), wt = (int)(tag & 7);
        if (wt != 1 || f < 1 || f > 3) return false;
        out[f - 1] = c.fixed64();
    }
    return c.ok;
}

}  // namespace

int64_t parse_octree_meta(const uint8_t* buf, int64_t len, int32_t* version,
                          double* bbox /*6: min xyz, max xyz*/,
                          double* resolution, int64_t n_cap,
                          uint64_t* id_hi, uint64_t* id_lo,
                          int64_t* num_points, uint8_t* encoding) {
    Cursor c{buf, buf + len};
    int64_t n = 0;
    bool saw_octree = false;
    while (c.p < c.end && c.ok) {
        const uint64_t tag = c.varint();
        const int f = (int)(tag >> 3), wt = (int)(tag & 7);
        if (f == 1 && wt == 0) {
            *version = (int32_t)c.varint();
        } else if (f == 4 && wt == 2) {  // bounding_box
            const uint64_t sz = c.varint();
            if (!c.ok || c.end - c.p < (int64_t)sz) return -1;
            Cursor b{c.p, c.p + sz};
            c.p += sz;
            while (b.p < b.end && b.ok) {
                const uint64_t t2 = b.varint();
                const int f2 = (int)(t2 >> 3), w2 = (int)(t2 & 7);
                if ((f2 == 3 || f2 == 4) && w2 == 2) {
                    const uint64_t s2 = b.varint();
                    if (!b.ok || b.end - b.p < (int64_t)s2) return -1;
                    if (!parse_vec3(Cursor{b.p, b.p + s2},
                                    bbox + (f2 == 3 ? 0 : 3)))
                        return -1;
                    b.p += s2;
                } else {
                    return -1;  // deprecated Vector3f forms -> Python path
                }
            }
            if (!b.ok) return -1;
        } else if (f == 6 && wt == 2) {  // octree
            saw_octree = true;
            const uint64_t sz = c.varint();
            if (!c.ok || c.end - c.p < (int64_t)sz) return -1;
            Cursor o{c.p, c.p + sz};
            c.p += sz;
            while (o.p < o.end && o.ok) {
                const uint64_t t2 = o.varint();
                const int f2 = (int)(t2 >> 3), w2 = (int)(t2 & 7);
                if (f2 == 2 && w2 == 1) {
                    *resolution = o.fixed64();
                } else if (f2 == 3 && w2 == 2) {  // one OctreeNode
                    const uint64_t s2 = o.varint();
                    if (!o.ok || o.end - o.p < (int64_t)s2) return -1;
                    Cursor nd{o.p, o.p + s2};
                    o.p += s2;
                    uint64_t hi = 0, lo = 0, np_ = 0, enc = 0;
                    while (nd.p < nd.end && nd.ok) {
                        const uint64_t t3 = nd.varint();
                        const int f3 = (int)(t3 >> 3), w3 = (int)(t3 & 7);
                        if (f3 == 2 && w3 == 0) enc = nd.varint();
                        else if (f3 == 3 && w3 == 0) np_ = nd.varint();
                        else if (f3 == 4 && w3 == 2) {
                            const uint64_t s3 = nd.varint();
                            if (!nd.ok || nd.end - nd.p < (int64_t)s3)
                                return -1;
                            Cursor idc{nd.p, nd.p + s3};
                            nd.p += s3;
                            while (idc.p < idc.end && idc.ok) {
                                const uint64_t t4 = idc.varint();
                                const int f4 = (int)(t4 >> 3),
                                          w4 = (int)(t4 & 7);
                                if (f4 == 3 && w4 == 0) hi = idc.varint();
                                else if (f4 == 4 && w4 == 0) lo = idc.varint();
                                else return -1;  // deprecated id forms
                            }
                            if (!idc.ok) return -1;
                        } else {
                            return -1;
                        }
                    }
                    if (!nd.ok) return -1;
                    // Reject out-of-range values instead of truncating:
                    // PositionEncoding is 1..4 and levels cap at 40
                    // (120-bit paths) — a corrupt meta must not wrap into
                    // a "valid" value (e.g. varint 257 -> u8 1).
                    if (enc < 1 || enc > 4) return -1;
                    if ((hi >> 56) > 40) return -1;
                    if (id_hi != nullptr) {
                        if (n >= n_cap) return -1;
                        id_hi[n] = hi;
                        id_lo[n] = lo;
                        num_points[n] = (int64_t)np_;
                        encoding[n] = (uint8_t)enc;
                    }
                    ++n;
                } else {
                    return -1;  // deprecated bbox inside OctreeMeta, etc.
                }
            }
            if (!o.ok) return -1;
        } else {
            return -1;  // s2 metas, deprecated fields -> Python path
        }
    }
    if (!c.ok || !saw_octree) return -1;
    return n;
}

// Stable counting argsort of small-range keys (spill bucket ids: 8^B
// values).  `counts` is the per-key histogram (np.bincount on the Python
// side, which also yields the per-bucket run boundaries for free); the
// scatter visits indices in original order, so the result is IDENTICAL
// to a stable sort by key — the radix argsort this replaces paid ~5x
// more here (u64 key copies + sorted-key materialization the spill then
// threw away).
void counting_argsort_i64(const int64_t* ids, int64_t n,
                          const int64_t* counts, int64_t num_keys,
                          int64_t* order_out) {
    std::vector<int64_t> pos(num_keys);
    int64_t acc = 0;
    for (int64_t b = 0; b < num_keys; ++b) {
        pos[b] = acc;
        acc += counts[b];
    }
    for (int64_t i = 0; i < n; ++i) order_out[pos[ids[i]]++] = i;
}

int pcv_native_abi_version() { return 5; }

}  // extern "C"
