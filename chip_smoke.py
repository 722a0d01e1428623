#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (point_cloud_viewer_tpu_torch) on
one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

(`python3 chip_smoke.py --tools` runs phases 2, 5 and 14 alone, and
`python3 chip_smoke.py --api` phases 2, 5 and 15, with their checks and
log lines; neither prints a result line.)

Phases (any failure raises and the exit code is non-zero):
  1. device  -- require CUDA; print the card's name and power limit; a
                meta-path finder refuses every import of jax and of the JAX
                package (point_cloud_viewer_tpu), so the run proves the port
                stands alone; whether scipy and PIL import;
  2. build   -- compile the port's CUDA kernels (csrc/*.cu) with nvcc and,
                beside them, its host library (native/pcv_native.cpp) with
                g++, so no later wall time holds a build;
  3. kernels -- K1-K4 against their plain PyTorch versions on the card, at
                16M and 64M elements (ragged n), bit for bit (K4, the
                public one-level entry, at every level), and at 16M K1 (six
                modes), K2 and K3 (every level) on views at element offsets
                1-3 (unaligned bases), K2 and K3 on an input whose only
                start is element 0 and K3 on starts at both ends only;
                CUDA-event median times of kernel and plain version, one
                call and 20 back to back (queued behind a sleep of the
                card, so the card alone is timed; K3 each call from the
                state before its level), K1 over torch.cumsum;
  4. core    -- the device derivation (build_tree_device_codes_grouped) at
                16M and 64M synthetic codes on the card; at 16M against
                the same call on CPU tensors (the kernels' plain
                versions), every output bit for bit, at 64M its level
                counts against a bincount of its levels (the CPU route
                there is cut for the time limit); where its time goes,
                step by step
                (code sort, leaf stage, promotion stage, key sort, extras);
  5. e2e     -- a 16M-point PLY through the port's CLI
                (cli.build_octree, whose defaults derive the tree on the
                card) byte-compared with the same CLI run with --device
                cpu; per-phase times and
                the main path's kernel launch counts (K1 launched, the K6
                leaf stage and the K4 promotion stage once a derivation;
                K2, K3 and the one-level K4, whose loops they replaced,
                not);
  6. cull    -- the viewer's device cull: a. K5 against its plain version
                on a 1,048,576-node table (partial view, all visible, > 32
                axes, axes all inert, K = 0, a 64-frame batch) and on a
                table of IEEE corner cases in each setup, bit for bit, with
                CUDA-event medians and each timed setup's least work;
                b. DeviceCullSession.step / step_frames on the card
                against device="cpu" over that table and phase 5's octree,
                60 orbit frames, bit for bit; c. the port's viewer CLI
                (cli.view --frames 60, which culls on the card by default)
                on phase 5's octree:
                K5 launches, visible nodes, a decodable final PNG;
  7. stages + streaming -- a. K6 at 16M and 64M sorted synthetic codes:
                the leaf stage (b and leaf from the codes) against its plain
                version and against _bound_levels + the K2 + K3 loop it
                replaced, in core, as a streamed bucket (root level 2) and
                with pad rows; the public K6 against its plain version and
                the device core's leaf; bit for bit, with CUDA-event
                medians of the stage alone, the public K6, the 21-level
                K2 + K3 loop and _bound_levels;
                b. K4's promotion stage (every level in one launch) at 16M
                and 64M against its plain version and the per-level K4 loop
                it replaced, bit for bit: in core, as a root-level-2 bucket
                promoted down to stop level 2, with 1001 pad rows, and on an
                input whose only start is row 0 with every row at the
                deepest level; CUDA-event medians one call at a time and 20
                back to back, device time by kernel (torch.profiler, after
                K6's: profiles taken after phases 4-6 see the card, one
                taken before them left K6's without device time);
                d. (run after b, before c) device time by torch.profiler
                of K5 in each timed setup of 6a and of K3, held to their
                queued back-to-back times (off by more than 20%: "not
                measured"), and the kernels and memsets one K3 call and
                one K5 call put on the card (read in a child process,
                `chip_smoke.py --device-ops`, whose profiler keeps them;
                five profiles of a K3 call in this process are logged
                beside it);
                c. phase 5's PLY through cli.build_octree --use_device
                --streaming, byte-compared with phase 5's in-core output, then
                a 64M-point PLY built in core and streamed on the card and
                byte-compared; per-bucket phase times, bytes up and down, the
                bucket count, the streaming path's K1-K4 launches and the
                share of the card's bucket time the host waited for;
  9. deep + host (run after 7d, before 7c)
             -- a 16,000,000-point cloud in a 6.4e6 m root box at 1 mm
                (total cap 33, sub-builds at depth 12): a Gaussian in one
                level-21 cell (10M points: a fat cell derived on the card),
                four fat cells of ~750,000 (native tree_levels) and a 1 km
                site (no fat cell), in three level-2 buckets; built in core
                on the card (build_octree's default), byte-compared with
                the host route (use_device=False) and with its streamed
                build on the card (B = 2); K1, K4's stage and K6's stage
                launched once a device sub-build, K2, K3 and the one-level
                K4 never; the 10M cell's grouped derivation at depth 12 on
                the card against the same call on CPU tensors, output by
                output, with its CUDA-event time; then phase 5's PLY
                through cli.build_octree --no-use_device, byte-compared
                with phase 5's card build; phase times and walls of every
                build (the in-core card build is kept for 12e);
  10. query (run after 7c) -- a 16M-point cloud on and above the WGS84
                surface (a 20 km x 20 km site, altitudes -100 to 500 m,
                half uniform, half in 64 Gaussian clusters) through
                cli.build_octree on the card at 1 cm (launches as phase
                5's); an AABB, a cell union of level 12-14 cells, a
                WebMercator rect (zoom 12) whose edges cross the site and
                the AABB with an intensity interval through cli.query_points
                on the card (its default) and with --no-device_filter,
                equal counts; those and an OBB, a frustum and the OBB with
                the interval through PointCloudClient.stream on the card
                and on the host, sorted positions byte-equal; walls, rows
                filtered on the card, band rows and rows the host
                recomputed, the WebMercator margin; no kernel of K1-K7
                launched by the queries; then 1,048,576 points on the OBB's
                faces and on the frustum's planes, and S2 points on face
                boundaries (argmax ties, bit 63 set), masks and leaf ids on
                the card against device="cpu" and the host, bit for bit;
  11. xray (run after 10) -- phase 5's octree through
                cli.build_xray_quadtree at 256 px tiles of 0.05 m (256
                leaf tiles at level 4; the reference's 0.01 m, 16,384
                leaves, is cut for the time limit) in four strategies on
                the card (splat and filter) and by the host route: xray,
                colored and colored_with_intensity byte-equal, the height
                stddev (full-f64 heights) within 1 per channel with the
                pixels that differ counted; colored binned byte-equal;
                heights on a 1/64 m step byte-equal to the numpy route; the
                four splat reductions on the card against their CPU route
                at 8M points (256 and 1448 px, and empty) bit for bit; four
                level-1 partial builds merged by cli.merge_xray_quadtrees
                into the full build's node set; cli.upgrade_xray_quadtree
                (v3 kept, v2 rewritten) and cli.inpaint_xray_quadtree (the
                full build, and a level-3 subtree with a transparent
                background whose holes it fills), every tile decoding;
                walls, tiles and points splatted; no launch of K1-K7;
  12. mesh (run after 11) -- the multi-device build on a mesh of 4
                shards sharing the card (the card machine has one):
                a. build_tree_device (the full device core from cells,
                with t_norm) on the cells of phase 4's 16M and 64M codes,
                CUDA-event medians of 3 and the Morton encode's share; at
                16M order, final and leaf equal build_tree_device_codes on
                the card and t_norm a numpy recomputation, at 1M the whole
                result its CPU route, bit for bit; b. the exact sharded
                sort: the dry run's skewed 64,000 points at capacity
                factor 1.0 retry at least once, the 16M cells equal the
                host's stable sort; c. phase 5's 16M batch built with the
                mesh, byte-equal to phase 5's octree (1529 nodes), points
                a shard summing to 16M, K6's and K4's stages launched once
                a shard and nothing else, then cli.build_octree --mesh 1 on
                phase 5's PLY, byte-equal too; d. entry.dryrun_multichip(4)
                (stats step, skewed retry, 2,000,003 ECEF points mesh vs
                one device byte for byte, geodesic queries); e. phase 9's
                deep cloud on a 2-shard mesh, byte-equal to phase 9's
                in-core card build, its one fat cell of at least
                _DEEP_DEVICE_MIN_N dispatched once (one cell on shards
                sharing one card cannot show the placement;
                tests/test_torch_mesh_build.py checks it on cpu shards);
  13. viewers (run after 12) -- a. whether libEGL.so.1 loads (found
                without creating a context); where it does, the GL
                context's vendor, renderer and version, cli.view --gl on
                the card over phase 5's octree (K5 launched, a final frame
                that is not all background), then 8 orbit views whose
                visible lists on the card equal the CPU route's, drawn
                through PointsRendererGL (draw and readback ms) and held to
                the software rasterizer by occupancy (IoU > 0.75 on 8x8
                blocks); where it does not, a line saying so with
                NVIDIA_DRIVER_CAPABILITIES; b. run_windowed over the port's
                libSDL2 stub (g++), GL frames where a. found EGL, else
                software, culling on the card, keys w, left, CTRL+SHIFT+1
                and CTRL+1: every frame presented, a last frame that is not
                all background, K5 launched, the pose saved; c. the points
                web server on port 0: /init_tree, /, /visible_nodes of 8
                orbit views byte-equal to Octree.visible_node_names_json,
                every visible list POSTed to /nodes_data in the client's
                batches of 50, each blob byte-equal to
                build_nodes_data_blob and the first of each view decoded
                (counts, positions within the resolution), ms a request;
                d. the x-ray server over phase 11's quadtree: /meta as its
                meta.pb, 16 tiles byte-equal to their files, 404 for an
                unknown node and path;
  14. tools (run after 13) -- a. phase 10's cloud regenerated and written
                as a PLY, then cli.build_s2 at level 14 (the default 20
                would give ~15M files over the 20 km site): the meta's cell
                counts sum to 16,000,000 and 16 cells read back their PLY
                rows bit for bit (f64 positions, unquantised); b. phase
                10's seven queries over the S2 cloud through
                PointCloudClient on the card and with device_filter=False,
                sorted positions byte-equal, the AABB's count equal to
                numpy's Aabb.contains; cli.query_points with the AABB and
                the cell union on the card and with --no-device_filter,
                equal counts; c. cli.export_ply of the AABB on the card and
                with --no-device_filter, sorted rows byte-equal, as many as
                b.'s, and --append doubling the vertex count; no kernel
                launched in a-c; d. on phase 5's octree: cli.upgrade_octree
                turns its meta.pb re-encoded at version 12 back into the
                version-13 bytes, node_ids_bfs yields all 1529 nodes,
                default_factory's HttpDataProvider over a local HTTP server
                (port 0) serves meta.pb and an Octree over it answers a
                5 m AABB through the card's filter with the on-disk
                octree's points; e. the three campaign twins
                (tools/fuzz_differential, fuzz_crash_resume, fuzz_xray) in
                process on the card with fixed seeds and iteration counts,
                each ending with "no failures", K4 and K6 launched over
                each differential run and over the crash-resume run's
                device bucket route, the crash hooks restored;
  15. api (run after 11, before 12, which deletes phase 5's PLY) -- a.
                the package root's twelve names (`__all__`) resolve; b. a
                child (`chip_smoke.py --trace-build`) builds phase 5's PLY
                in core on the card through the root's build_octree under
                utils.progress.torch_trace, byte-equal to phase 5's build;
                from its Chrome trace: the traced window, the card's busy
                time (union of kernel, memcpy and memset intervals), the
                idle share, K6's, K4's and K1's launches (each > 0) and the
                five device operations that took most time; c. the padded
                entries (tree_codes_grouped_on_device_padded,
                tree_codes_on_device_padded) at 16,000,017 synthetic codes
                (padded to 16,777,216) and at 65,537 against the unpadded
                tree_codes_grouped_on_device, rows [0, n), level counts and
                extras bit for bit, K6 = K4 = 1 a call; sort_codes_device
                against argsort_codes_on_device; d. the culling building
                blocks (node_corners, sat_relation_device,
                relative_sizes_on_screen_device) on phase 6's 1,048,576-node
                table, card against device="cpu" bit for bit; e. in a child
                with PCV_DISABLE_NATIVE=1, native.available() is False;
  8. probe + bounds -- K7 (copy, triad, add3) against its plain version
                at 128,000,000 and ragged n, bit for bit; the streaming-
                bandwidth probes (hbm_probes: add_1d, add_2d, copy, triad,
                add3) and torch.add's time; then, for K1-K7, the least bytes
                a launch moves, its launches per main-path call (16M
                in-core build, streamed bucket, deep 16M build, 16M mesh
                build on 4 shards, padded grouped entry, viewer frame,
                --gl frame, windowed frame), its bound
                (bytes over the card's memory rate -- the larger of its
                published peak and the measured probe rate -- or K5's f32
                operations over the card's published f32 peak where
                larger; K5 also for each timed setup), the bytes over the
                probe rate alone, and kernel, plain and library times
                beside them.

The CPU route itself is held to the JAX package by tests/test_torch_*.py.
Every line but the last three starts with the card's name and power limit
as nvidia-smi prints them; the third line from the end is that label
alone, the one before the last a JSON object {"kernels": [...]}, the last
{"ok": true, "device": {...}}.  Imports nothing of JAX and nothing of the
JAX package.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import re
import shutil
import statistics
import sys
import tempfile
import threading
import time

import numpy as np

SIZES = (16_000_017, 64_000_017)     # phase 3: ragged element counts
UNALIGNED = (1, 2, 3)                # phase 3: element offsets of views
CORE_SIZES = (16_000_000, 64_000_000)  # phase 4: synthetic codes
CORE_CPU_MAX = 16_000_000            # phase 4: the CPU route's largest n
E2E_POINTS = 16_000_000              # phase 5: the README's in-core cloud
BIG_POINTS = 64_000_000              # phase 7c: a ~2 GB PLY, streamed
LEAF_MAX_POINTS = 100_000            # MAX_POINTS_PER_NODE
DEEP_POINTS = (10_000_000, 3_000_000, 3_000_000)  # phase 9: see deep_cloud
PLANET = 6.4e6                       # phase 9: root edge (tests/test_deep_build)
DEEP_RESOLUTION = 0.001              # phase 9: 1 mm, total cap 33
CULL_NODES = 1_048_576               # phase 6: bench.py's 1M-node tree
CULL_BATCH = 64                      # phase 6a: bench.py's batched orbit
VIEW_FRAMES = 60                     # phase 6b/c: cli.view's default orbit
DEPTH = 21                           # the 63-bit code budget
REPS = 5                             # timed repetitions (median reported)
PROBE_N = 128_000_000                # phase 8: bench.py:145's probe size
PROBE_RAGGED = (1, 3, 5, 4097, 1_000_003)
PROBE_ITERS = 20                     # bench.py:144
QUERY_POINTS = 16_000_000            # phase 10: the README's in-core cloud
QUERY_SITE = (48.8566, 2.3522)       # phase 10: site centre, degrees
QUERY_EDGE = 20_000.0                # phase 10: site edge (m), east / north
QUERY_ALT = (-100.0, 500.0)          # phase 10: altitudes (m)
QUERY_RESOLUTION = 0.01              # phase 10: 1 cm (depth cap 21)
QUERY_ZOOM = 12                      # phase 10: --web_mercator_rect zoom
QUERY_FACE_POINTS = 1 << 20          # phase 10b: adversarial points
QUERY_MASK_ROWS = 100_000            # phase 10c: a full node (K8)
XRAY_TILE = 256                      # phase 11: tile size (px)
XRAY_RESOLUTION = 0.05               # phase 11: m a pixel (reference: 0.01)
XRAY_STRATEGIES = (                  # phase 11a: strategy, its flags
    ("xray", []),
    ("colored", []),
    ("colored_with_intensity", ["--min_intensity=-1", "--max_intensity=1"]),
    ("colored_with_height_stddev", ["--max_stddev", "0.5"]),
)
XRAY_BINNING = "intensity=0.125"     # phase 11b: colored, binned
XRAY_HEIGHT_POINTS = 4_000_000       # phase 11c: points on a 1/64 m step
XRAY_SPLAT_POINTS = 8_000_000        # phase 11d: the reductions' input
XRAY_INPAINT_ROOT = "r000"           # phase 11f: a level-3 subtree
MESH_SHARDS = 4                      # phase 12: shards sharing the card
MESH_CORE_CHECK = 1_000_000          # phase 12a: whole result vs CPU route
MESH_SKEW = 64_000                   # phase 12b: the dry run's skewed cloud
DEEP_MESH_SHARDS = 2                 # phase 12e
VIEW_SIZE = (320, 240)               # phase 13a/b: frame width, height
VIEW_MATRICES = 8                    # phase 13a/c: orbit views
GL_DRAW_POINTS = 2_000_000           # phase 13a: points drawn a view, at most
WINDOW_FRAMES = 12                   # phase 13b: frames of the stub shell
WINDOW_HZ = 60                       # phase 13b: the stub's vsync
WEB_BATCH = 50                       # phase 13c: the web client's batch
XRAY_SERVED_TILES = 16               # phase 13d
S2_SPLIT_LEVEL = 14                  # phase 14a: cells (default 20; files)
S2_SAMPLE_CELLS = 16                 # phase 14a: cells read back
HTTP_BOX = 5.0                       # phase 14d: AABB edge (m) over HTTP
CAMPAIGNS = (                        # phase 14e: twin, FUZZ_SEED, iterations
    ("fuzz_differential", 1, 8),
    ("fuzz_differential", 5, 6),     # three 60,000-point clouds
    ("fuzz_crash_resume", 10, 3),    # the third on the device bucket route
    ("fuzz_xray", 4, 8),
)
CAMPAIGN_SECONDS = 600               # phase 14e: each twin's deadline
API_ROWS = (16_000_017, 65_537)      # phase 15c: padded to 2^24 and 98,304
API_TOP_OPS = 5                      # phase 15b: device operations listed
# f32 rate outside the tensor cores, NVIDIA H100 SXM data sheet (an FMA
# counts two operations), at the 700 W power limit.
FP32_PEAK_OPS = 67e12
# Clock cycles of the sleep that train_ms queues its calls behind: ~5 ms at
# the H100's 1.98 GHz boost clock, more than the host takes to enqueue 20
# calls of any wrapper here.
QUEUE_CYCLES = 10_000_000
DEVICE = "cuda"
# The build's kernels (K6: the leaf stage from the codes; K4: the promotion
# stage, every level in one launch), and those whose per-level loops the
# stages replaced, which must not run on it ("K4 pass": the public
# one-level K4).
BUILD_PATH = ("K1", "K4", "K6")
OFF_PATH = ("K2", "K3", "K4 pass")
CARD = ""  # nvidia-smi's name and power limit; main() sets it


def log(*args) -> None:
    """Print a line that starts with the card's label once it is known."""
    print(*((f"[{CARD}]",) if CARD else ()), *args, flush=True)


class RefuseJaxPackage:
    """Meta-path finder that refuses jax and the JAX package
    (point_cloud_viewer_tpu and its submodules)."""

    @staticmethod
    def refused(name: str) -> bool:
        return (name.split(".")[0] in ("jax", "jaxlib")
                or name == "point_cloud_viewer_tpu"
                or name.startswith("point_cloud_viewer_tpu."))

    def find_spec(self, name, path=None, target=None):
        if self.refused(name):
            raise ImportError(f"chip_smoke refuses to import {name}")
        return None


def cuda_ms(fn, setup=None, reps=REPS) -> float:
    """Median CUDA-event time in ms of fn(*setup()) after one warm-up;
    setup runs outside the timed region (fresh state for in-place
    kernels)."""
    import torch

    setup = setup or (lambda: ())
    fn(*setup())
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        args = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def train_ms(fn, count: int = 20, setup=None) -> float:
    """Median over REPS of the mean CUDA-event time in ms of `count` calls
    of fn back to back, queued behind a sleep of the card (QUEUE_CYCLES):
    the host enqueues them all while the card sleeps, so the events time
    the card alone, launch gaps and memsets included (cuda_ms adds the
    host's time to the first launch).  setup, if given, returns the
    `count` argument tuples of one repetition (fresh state for an in-place
    kernel) and runs untimed."""
    import torch

    setup = setup or (lambda: [()] * count)
    fn(*setup()[0])
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        args = setup()
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for a in args:
            fn(*a)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return statistics.median(times)


def synthetic_codes(n: int, seed: int) -> np.ndarray:
    """(n,) uint64 Morton codes < 2^63: uniform, plus dense cells of
    several sizes (deep splits) and a run of the maximal code 2^63 - 1."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**63, n, dtype=np.uint64)
    start = 0
    for frac, low_bits in ((0.10, 16), (0.05, 24), (0.03, 30), (0.02, 40)):
        k = int(n * frac)
        base = codes[start] & ~np.uint64((1 << low_bits) - 1)
        codes[start:start + k] = base | rng.integers(
            0, 1 << low_bits, k, dtype=np.uint64)
        start += k
    codes[start:start + 1000] = np.uint64(2**63 - 1)
    return codes


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def unaligned(t, offset: int):
    """A copy of t as a view at `offset` elements into a fresh buffer: its
    base is not 16-B aligned for offsets 1-3 of i32 or 1-15 of u8."""
    import torch

    buf = torch.empty(t.shape[0] + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:]
    view.copy_(t)
    return view


def phase_kernels(record: dict) -> None:
    """K1-K4 against their plain versions at SIZES, K1 and K2 also on
    unaligned views and K2 on a start-only input at SIZES[0]; tolerance
    0."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
    from point_cloud_viewer_tpu_torch.ops import scan_cuda as SC
    from point_cloud_viewer_tpu_torch.ops.tree_build import _bound_levels

    dev = torch.device(DEVICE)
    for n in SIZES:
        tag = f"n={n}"
        rng = np.random.default_rng(n)
        # K1: all three ops x both directions.  Sum inputs stay small so
        # the int32 running sum cannot wrap.
        wide = torch.from_numpy(
            rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
            .astype(np.int32)).to(dev)
        small = torch.from_numpy(
            rng.integers(-16, 17, n).astype(np.int32)).to(dev)
        for kind in ("max", "min", "sum"):
            x = small if kind == "sum" else wide
            for rev in (False, True):
                err = max_abs_err(SC.scan_1d(x, kind, rev),
                                  SC.scan_1d_plain(x, kind, rev))
                log(f"K1 scan_1d {kind} reverse={rev} {tag}: "
                    f"max_abs_err={err}")
                record["K1"]["err"] = max(record["K1"]["err"], err)
                if err:
                    raise AssertionError(f"K1 {kind} rev={rev} {tag}: {err}")
        if n == SIZES[0]:
            for offset in UNALIGNED:
                for kind in ("max", "min", "sum"):
                    x = unaligned(small if kind == "sum" else wide, offset)
                    for rev in (False, True):
                        err = max_abs_err(SC.scan_1d(x, kind, rev),
                                          SC.scan_1d_plain(x, kind, rev))
                        record["K1"]["err"] = max(record["K1"]["err"], err)
                        if err:
                            raise AssertionError(
                                f"K1 {kind} rev={rev} offset {offset} "
                                f"{tag}: {err}")
            log(f"K1 scan_1d {tag} at element offsets {UNALIGNED} "
                "(unaligned bases): six modes bit-equal")
        ms = cuda_ms(lambda: SC.scan_1d(small, "sum"))
        pms = cuda_ms(lambda: SC.scan_1d_plain(small, "sum"))
        lms = cuda_ms(lambda: torch.cumsum(small, 0, dtype=torch.int32))
        log(f"K1 scan_1d sum {tag}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"torch.cumsum {lms:.4f} ms; kernel / torch.cumsum "
            f"{ms / lms:.4f}")
        tms = train_ms(lambda: SC.scan_1d(small, "sum"))
        tlms = train_ms(lambda: torch.cumsum(small, 0, dtype=torch.int32))
        log(f"K1 scan_1d sum {tag}, 20 calls back to back: kernel "
            f"{tms:.4f} ms a call, torch.cumsum {tlms:.4f} ms; kernel / "
            f"torch.cumsum {tms / tlms:.4f}")
        if n == SIZES[0]:
            off1 = unaligned(small, 1)
            log(f"K1 scan_1d sum {tag} at offset 1 (scalar loads): kernel "
                f"{cuda_ms(lambda: SC.scan_1d(off1, 'sum')):.4f} ms")
            del off1
        record["K1"]["times"][n] = (ms, pms)
        record["K1"]["lib"][n] = lms
        del wide, small, x

        # K2-K4 over the boundary array of sorted codes with dense cells,
        # every level, kernel and plain version from the same state.
        codes = torch.from_numpy(
            synthetic_codes(n, seed=n).view(np.int64)).to(dev)
        b = _bound_levels(torch.sort(codes).values, DEPTH)
        del codes
        leaf = torch.full((n,), DEPTH, dtype=torch.uint8, device=dev)
        found = torch.zeros(n, dtype=torch.uint8, device=dev)
        snap = {}
        for level in range(1, DEPTH + 1):
            ss = LC.seg_start_pass(b, level)
            ss_p = LC.seg_start_pass_plain(b, level)
            err2 = max_abs_err(ss, ss_p)
            lk, fk = LC.leaf_update_pass(b, ss, leaf.clone(), found.clone(),
                                         level, 100_000)
            LC.leaf_update_pass_plain(b, ss_p, leaf, found, level, 100_000)
            err3 = max(max_abs_err(lk, leaf), max_abs_err(fk, found))
            record["K2"]["err"] = max(record["K2"]["err"], err2)
            record["K3"]["err"] = max(record["K3"]["err"], err3)
            if err2 or err3:
                raise AssertionError(
                    f"level {level} {tag}: K2 err {err2}, K3 err {err3}")
        cur = leaf.clone()
        promoted_levels = 0
        busiest = (0, 0)  # (active points, level): K4 is timed there
        for level in range(DEPTH, 0, -1):
            active = int((cur == level).sum())
            promoted_levels += active > 0
            if active > busiest[0]:
                busiest = (active, level)
                snap["cur"] = cur.clone()
            ck = LC.promote_pass(b, cur.clone(), level)
            LC.promote_pass_plain(b, cur, level)
            err4 = max_abs_err(ck, cur)
            record["K4"]["err"] = max(record["K4"]["err"], err4)
            if err4:
                raise AssertionError(f"level {level} {tag}: K4 err {err4}")
        if n == SIZES[0]:
            # K2 on unaligned views, and on an input whose only start is
            # element 0: every tile's look-back crosses the tiles before it.
            start_only = torch.full((n,), DEPTH + 1, dtype=torch.uint8,
                                    device=dev)
            start_only[:1].fill_(0)
            cases = {f"offset {o}": unaligned(b, o) for o in UNALIGNED}
            cases["start only"] = start_only
            for name, bb in cases.items():
                for level in range(1, DEPTH + 1):
                    err2 = max_abs_err(LC.seg_start_pass(bb, level),
                                       LC.seg_start_pass_plain(bb, level))
                    record["K2"]["err"] = max(record["K2"]["err"], err2)
                    if err2:
                        raise AssertionError(f"K2 {name} level {level} "
                                             f"{tag}: {err2}")
            log(f"K2 seg_start_pass {tag}: {DEPTH} levels bit-equal on "
                f"{list(cases)}; start only, level 8: kernel "
                f"{cuda_ms(lambda: LC.seg_start_pass(start_only, 8)):.4f} "
                f"ms; offset 1, level 8: kernel "
                f"{cuda_ms(lambda: LC.seg_start_pass(cases['offset 1'], 8)):.4f} ms")
            k3_cases(record, b, start_only, tag)
            del cases, start_only
        log(f"K2/K3 {tag}: {DEPTH} levels bit-equal; K4 promote_pass {tag}: "
            f"{DEPTH} levels ({promoted_levels} non-empty) bit-equal; leaf "
            "levels "
            f"{torch.bincount(leaf, minlength=DEPTH + 1).tolist()}")

        # K3 is timed at level 8 from the state the levels before leave.
        ss_p, lf, fd = k3_level_state(b, 8)
        fresh = lambda: (lf.clone(), fd.clone())  # noqa: E731
        k3 = lambda l, f: LC.leaf_update_pass(b, ss_p, l, f, 8, 100_000)  # noqa: E731
        times = {
            "K2": (cuda_ms(lambda: LC.seg_start_pass(b, 8)),
                   cuda_ms(lambda: LC.seg_start_pass_plain(b, 8))),
            "K3": (cuda_ms(k3, fresh),
                   cuda_ms(lambda l, f: LC.leaf_update_pass_plain(
                       b, ss_p, l, f, 8, 100_000), fresh)),
            "K4": (cuda_ms(lambda c: LC.promote_pass(b, c, busiest[1]),
                           lambda: (snap["cur"].clone(),)),
                   cuda_ms(lambda c: LC.promote_pass_plain(b, c, busiest[1]),
                           lambda: (snap["cur"].clone(),))),
        }
        log(f"K2 seg_start_pass {tag}, level 8, 20 calls back to back: "
            f"kernel {train_ms(lambda: LC.seg_start_pass(b, 8)):.4f} ms a "
            "call")
        changed = k3_changed(k3, lf, fd)
        k3_train = train_ms(k3, setup=lambda: [fresh() for _ in range(20)])
        record["K3"]["train"][n] = k3_train
        log(f"K3 leaf_update_pass {tag}, level 8, 20 calls back to back, "
            f"each from the state before level 8 ({changed} rows set): "
            f"kernel {k3_train:.4f} ms a call; least bytes "
            f"{k3_bytes(n, changed)} (6 a row, 2 a row set)")
        if n == SIZES[0]:
            record["K3"]["bytes"] = k3_bytes(n, changed)
            record["K3"]["inputs"] = (b, ss_p, lf, fd)  # phase 7d
        again = snap["cur"].clone()
        log(f"K4 promote_pass {tag}, level {busiest[1]}, 20 calls back to "
            f"back in place on one array: kernel "
            f"{train_ms(lambda: LC.promote_pass(b, again, busiest[1])):.4f} "
            "ms a call")
        for k, (ms, pms) in times.items():
            at = (f"level {busiest[1]}, {busiest[0]} active" if k == "K4"
                  else "level 8")
            name = "K4 promote_pass" if k == "K4" else k
            log(f"{name} {tag}: kernel {ms:.4f} ms, plain {pms:.4f} ms ({at})")
            # K4's row is the promotion stage (phase 7b); the one-level
            # entry's times are printed only.
            if k != "K4":
                record[k]["times"][n] = (ms, pms)
        del b, leaf, found, cur, snap, lf, fd, ss_p, again
        torch.cuda.empty_cache()


def k3_level_state(b, level: int) -> tuple:
    """(seg_start, leaf, found) at `level`: the plain versions' state after
    levels 1 .. level - 1 from leaf = DEPTH and found = 0."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC

    n = b.shape[0]
    leaf = torch.full((n,), DEPTH, dtype=torch.uint8, device=b.device)
    found = torch.zeros(n, dtype=torch.uint8, device=b.device)
    for lv in range(1, level):
        LC.leaf_update_pass_plain(b, LC.seg_start_pass_plain(b, lv), leaf,
                                  found, lv, LEAF_MAX_POINTS)
    return LC.seg_start_pass_plain(b, level), leaf, found


def k3_changed(call, leaf, found) -> int:
    """Rows that call(leaf, found) sets, run on copies."""
    lt, ft = leaf.clone(), found.clone()
    call(lt, ft)
    return int((ft != found).sum())


def k3_bytes(n: int, changed: int) -> int:
    """K3's least bytes: b, seg_start and found read once (6 B a row), leaf
    and found written where a row is set (2 B)."""
    return 6 * n + 2 * changed


def k3_cases(record: dict, b, start_only, tag: str) -> None:
    """K3 at every level, bit for bit, with all four arrays as views at
    element offsets UNALIGNED (the scalar epilogue), on the start-only
    input (every tile's look-back runs to the sweep's first tile; threshold
    n) and on starts at the first and the last element only (every row
    below the last carries it as its segment end; threshold n - 1); each
    call from the plain version's state of the level before.  Times one
    call at level 8 on the start-only input and at offset 1."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC

    n = b.shape[0]
    both_ends = start_only.clone()
    both_ends[n - 1:].fill_(0)
    cases = {f"offset {o}": (b, 100_000, o) for o in UNALIGNED}
    cases["start only"] = (start_only, n, 0)
    cases["first and last"] = (both_ends, n - 1, 0)
    for name, (bb, threshold, offset) in cases.items():
        leaf = torch.full((n,), DEPTH, dtype=torch.uint8, device=b.device)
        found = torch.zeros(n, dtype=torch.uint8, device=b.device)
        views = [unaligned(t, offset) for t in (bb, leaf, found)]
        for level in range(1, DEPTH + 1):
            ss = LC.seg_start_pass_plain(bb, level)
            views[1].copy_(leaf)
            views[2].copy_(found)
            LC.leaf_update_pass(views[0], unaligned(ss, offset), views[1],
                                views[2], level, threshold)
            LC.leaf_update_pass_plain(bb, ss, leaf, found, level, threshold)
            err = max(max_abs_err(views[1], leaf), max_abs_err(views[2], found))
            record["K3"]["err"] = max(record["K3"]["err"], err)
            if err:
                raise AssertionError(f"K3 {name} level {level} {tag}: {err}")
        if name != "offset 1" and name.startswith("offset"):
            continue
        if name != "offset 1" and not bool(found.all()):
            raise AssertionError(f"K3 {name} {tag}: a row was not set")
        ss = unaligned(LC.seg_start_pass_plain(bb, 8), offset)
        fresh = (leaf.fill_(DEPTH), found.zero_())
        ms = cuda_ms(lambda lv, fv: LC.leaf_update_pass(
            views[0], ss, lv, fv, 8, threshold),
            lambda: tuple(unaligned(t, offset) for t in fresh))
        log(f"K3 leaf_update_pass {tag} {name}, level 8: kernel {ms:.4f} ms")
    log(f"K3 leaf_update_pass {tag}: {DEPTH} levels bit-equal on "
        f"{list(cases)}")


def phase_promote(record: dict) -> None:
    """7b: K4's promotion stage at SIZES (levels DEPTH down to stop + 1)
    against its plain version and the per-level K4 loop it replaced
    (promote_stage_loop), bit for bit, from b and leaf levels of the K6
    leaf stage: in core; the codes moved into one level-2 cell, promoted
    down to stop level 2 (a streamed bucket); 1001 pad rows; and an input
    whose only start is row 0 with every row at DEPTH.  CUDA-event medians
    of the stage one call at a time and 20 back to back, its device time by
    kernel (torch.profiler), the loop, and the plain stage at SIZES[0]."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import leaf_levels_cuda as K6
    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
    from point_cloud_viewer_tpu_torch.testing import kernel_split

    dev = torch.device(DEVICE)
    for n in SIZES:
        tag = f"n={n}"
        codes = torch.sort(torch.from_numpy(
            synthetic_codes(n, seed=n).view(np.int64)).to(dev)).values
        padded = codes.clone()
        padded[n - 1001:].copy_(codes[:1001].flip(0))  # 1001 pad rows
        start_only = torch.full((n,), DEPTH + 1, dtype=torch.uint8,
                                device=dev)
        start_only[:1].fill_(0)
        setups = {
            "in core": (*K6.leaf_stage(codes, DEPTH, DEPTH,
                                       LEAF_MAX_POINTS), 0),
            "bucket, root 2, stop 2": (*K6.leaf_stage(
                bucket_codes(codes, 2), DEPTH, DEPTH, LEAF_MAX_POINTS, 2), 2),
            "pad rows": (*K6.leaf_stage(padded, DEPTH, DEPTH, LEAF_MAX_POINTS,
                                        0, n - 1001), 0),
            "start only, all active": (start_only, torch.full(
                (n,), DEPTH, dtype=torch.uint8, device=dev), 0),
        }
        del codes, padded
        for name, (b, leaf, stop) in setups.items():
            before = LC.promote_stage.launches
            got = LC.promote_stage(b, leaf, DEPTH, stop)
            launched = LC.promote_stage.launches - before
            loop = LC.promote_stage_loop(b, leaf, DEPTH, stop)
            plain = LC.promote_stage_plain(b, leaf, DEPTH, stop)
            errs = [max_abs_err(got, loop), max_abs_err(got, plain)]
            log(f"K4 promote_stage {tag} {name} (levels {DEPTH}..{stop + 1}):"
                f" max_abs_err vs the K4 loop and plain {errs}; launches "
                f"{launched}; rows promoted {int((got != leaf).sum())}; final "
                f"levels {torch.bincount(got, minlength=DEPTH + 1).tolist()}")
            record["K4"]["err"] = max(record["K4"]["err"], *errs)
            if any(errs) or launched != 1:
                raise AssertionError(f"K4 promote_stage {tag} {name}: errors "
                                     f"{errs}, launches {launched}")
            del got, loop, plain

        b, leaf, _ = setups["in core"]
        b1, leaf1, _ = setups["start only, all active"]
        stage = lambda: LC.promote_stage(b, leaf, DEPTH, 0)  # noqa: E731
        chain = lambda: LC.promote_stage(b1, leaf1, DEPTH, 0)  # noqa: E731
        times = {
            "stage": cuda_ms(stage),
            "stage, 20 back to back": train_ms(stage),
            f"{DEPTH} x K4 (the loop)": cuda_ms(
                lambda: LC.promote_stage_loop(b, leaf, DEPTH, 0)),
            "start only: stage": cuda_ms(chain),
            "start only: stage, 20 back to back": train_ms(chain),
            f"start only: {DEPTH} x K4": cuda_ms(
                lambda: LC.promote_stage_loop(b1, leaf1, DEPTH, 0)),
        }
        if n == SIZES[0]:
            times["stage plain"] = cuda_ms(
                lambda: LC.promote_stage_plain(b, leaf, DEPTH, 0), reps=3)
            record["K4"]["times"][n] = (times["stage"], times["stage plain"])
        for label, fn in (("in core", stage), ("start only", chain)):
            split = kernel_split(fn)
            log(f"K4 {tag} promotion stage, {label}, by kernel "
                "(torch.profiler, device ms a call): "
                + (", ".join(f"{k} {v:.4f}" for k, v in split.items())
                   or "not measured (no device time)"))
        log(f"K4 {tag} promotion stage (CUDA-event medians, ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
            + "; loop / stage "
            f"{times[f'{DEPTH} x K4 (the loop)'] / times['stage']:.2f}")
        del setups, b, leaf, b1, leaf1, start_only
        torch.cuda.empty_cache()


def core_split(codes, n: int) -> dict:
    """Where the device core's time goes: build_tree_device_codes_grouped's
    steps run one after another as it runs them, with a CUDA event between
    steps (no host sync inside); median ms of each step over 3 runs."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import leaf_levels_cuda as K6
    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
    from point_cloud_viewer_tpu_torch.ops import scan_cuda as SC

    def steps():
        vals, perm = torch.sort(codes, stable=True)
        idx = perm.to(torch.int32)
        yield "code sort"
        b, leaf = K6.leaf_stage(vals, DEPTH, DEPTH, LEAF_MAX_POINTS)
        yield "leaf stage (K6)"
        cur = LC.promote_stage(b, leaf, DEPTH, 0)
        yield "promotion stage (K4)"
        sorted_key, by_key = torch.sort(cur, stable=True)
        idx[by_key]
        torch.diff(torch.searchsorted(
            sorted_key.to(torch.int32),
            torch.arange(DEPTH + 3, dtype=torch.int32, device=codes.device)))
        yield "key sort + counts"
        shift = 3 * (DEPTH - leaf[1:].to(torch.int64))
        same = (leaf[1:] == leaf[:-1]) & (
            (vals[1:] >> shift) == (vals[:-1] >> shift))
        run_start = torch.cat([same.new_ones(1), ~same])
        sole = run_start & torch.cat([run_start[1:], run_start.new_ones(1)])
        rank = SC.scan_1d(sole.to(torch.int32), "sum") - 1
        cap = max(512, n >> 6)
        slot = torch.where(sole & (rank < cap), rank, cap).long()
        torch.zeros(cap + 1, dtype=torch.int32,
                    device=codes.device).scatter_(0, slot, idx)
        yield "extras (K1 + scatter)"

    runs = []
    for _ in range(4):  # a warm-up, then 3
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()
        names = []
        for name in steps():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            names.append(name)
        torch.cuda.synchronize()
        runs.append([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    return {name: statistics.median(r[i] for r in runs[1:])
            for i, name in enumerate(names)}


def phase_core() -> None:
    """The device derivation on the card against the same call on CPU
    tensors, every output bit for bit, up to CORE_CPU_MAX codes; past it,
    the card's level counts against a bincount of its final levels."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import morton
    from point_cloud_viewer_tpu_torch.ops.tree_build import (
        GroupedExchange,
        build_tree_device_codes_grouped,
    )

    for n in CORE_SIZES:
        codes = synthetic_codes(n, seed=n + 1)
        on = {dev: morton.codes_to_tensor(codes, dev)
              for dev in (DEVICE, "cpu")}

        def run(device):
            return build_tree_device_codes_grouped(
                on[device], n, DEPTH, DEPTH, extras_cap=max(512, n >> 6))

        run(DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run(DEVICE)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        s = statistics.median(secs)
        log(f"core n={n}: median {s * 1e3:.3f} ms over 3 = "
            f"{n / s / 1e6:.3f} Mpts/s (codes resident); runs "
            f"{[round(x, 6) for x in secs]} s; peak device memory "
            f"{peak / 2**30:.3f} GiB")
        split = core_split(on[DEVICE], n)
        log(f"core n={n} split (CUDA events between steps, median of 3, "
            "ms): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f"; sum {sum(split.values()):.4f}")

        if n > CORE_CPU_MAX:
            counts = out.level_counts.to(torch.int64)
            ok = torch.equal(counts, torch.bincount(
                out.final.to(torch.int64), minlength=DEPTH + 2))
            log(f"core n={n}: no CPU route past {CORE_CPU_MAX} (the time "
                f"limit); card level_counts == bincount(final): {ok}; "
                f"extras_total={int(out.extras_total)}")
            if not ok:
                raise AssertionError(f"core n={n}: level_counts differ from "
                                     "bincount(final)")
            del out, on
            torch.cuda.empty_cache()
            continue
        t0 = time.perf_counter()
        ref = run("cpu")
        log(f"core n={n}: CPU route {time.perf_counter() - t0:.3f} s")
        checks = {name: torch.equal(got.cpu(), want) for name, got, want
                  in zip(GroupedExchange._fields, out, ref)}
        counts = ref.level_counts.to(torch.int64)
        checks["level_counts==bincount(final)"] = torch.equal(
            counts, torch.bincount(ref.final, minlength=DEPTH + 2))
        log(f"core n={n} card vs CPU route: {checks}; extras_total="
            f"{int(out.extras_total)}; level_counts="
            f"{out.level_counts.tolist()}")
        if not all(checks.values()):
            raise AssertionError(f"core n={n}: card differs from CPU: "
                                 f"{checks}")
        del out, ref, on
        torch.cuda.empty_cache()


def write_ply(path: str, n: int, seed: int) -> None:
    """Binary PLY: xyz f64, rgb u8, intensity f32; half uniform over a
    200 x 200 x 40 m box, half in 64 dense clusters."""
    rng = np.random.default_rng(seed)
    half = n // 2
    extent = np.array([200.0, 200.0, 40.0])
    pos = np.empty((n, 3))
    pos[:half] = rng.random((half, 3)) * extent
    centers = rng.random((64, 3)) * extent
    which = rng.integers(0, 64, n - half)
    pos[half:] = centers[which] + rng.normal(0.0, 0.5, (n - half, 3))
    write_ply_points(path, pos, rng)


def write_ply_points(path: str, pos: np.ndarray, rng) -> None:
    """Binary PLY of the (n, 3) f64 positions, with rgb u8 and intensity
    f32 drawn from rng."""
    n = len(pos)
    rows = np.empty(n, dtype=[("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
                              ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                              ("intensity", "<f4")])
    rows["x"], rows["y"], rows["z"] = pos[:, 0], pos[:, 1], pos[:, 2]
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    rows["red"], rows["green"], rows["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    rows["intensity"] = rng.random(n, dtype=np.float32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property double x\nproperty double y\nproperty double z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "property float intensity\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rows.tofile(f)


def dirs_byte_equal(a: str, b: str) -> int:
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    if fa != fb:
        raise AssertionError(f"file sets differ: {len(fa)} vs {len(fb)}")
    for name in fa:
        with open(os.path.join(a, name), "rb") as f:
            da = f.read()
        with open(os.path.join(b, name), "rb") as f:
            db = f.read()
        if da != db:
            raise AssertionError(f"{name}: bytes differ")
    return len(fa)


def run_cli(args: list, phase_times: dict) -> str:
    """The port's CLI main on args; returns what it printed."""
    from point_cloud_viewer_tpu_torch.cli.build_octree import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(args, phase_times=phase_times)
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"cli {args} returned {rc}: {out}")
    return out


def check_build_launches(where: str, launches: dict,
                         derivations: int) -> None:
    """The build path launched each of BUILD_PATH and none of OFF_PATH, and
    each stage (K4, K6) once a derivation."""
    missing = [k for k in BUILD_PATH if launches[k] <= 0]
    stray = [k for k in OFF_PATH if launches[k] != 0]
    stages = {k: launches[k] for k in ("K4", "K6")
              if launches[k] != derivations}
    if missing or stray or stages:
        raise AssertionError(f"{where}: kernels not launched on the build "
                             f"path {missing}; launched off it {stray}; "
                             f"stages launched other than {derivations} "
                             f"times {stages}")


def phase_e2e(wrappers: dict, tmp: str) -> tuple:
    """16M points through the CLI on the card, held byte for byte against
    the CLI with --device cpu; returns the main path's launch counts, the
    card's octree directory (kept for phases 6, 7c and 12), the PLY (kept
    for 7c and 12), the card build's wall seconds and its phases."""
    ply = os.path.join(tmp, "cloud.ply")
    a_dir = os.path.join(tmp, "card")
    b_dir = os.path.join(tmp, "cpu")
    t0 = time.perf_counter()
    write_ply(ply, E2E_POINTS, seed=5)
    log(f"e2e: wrote {E2E_POINTS} points ({os.path.getsize(ply)} B) in "
        f"{time.perf_counter() - t0:.3f} s")

    for w in wrappers.values():
        w.launches = 0
    phases = {}
    t0 = time.perf_counter()
    out = run_cli([ply, "--output_directory", a_dir], phases)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"e2e: port CLI build on the card {wall:.3f} s; phases (s) "
        f"{json.dumps(phases)}; launches {json.dumps(launches)}")
    log("e2e: cli said: " + out.strip().splitlines()[0])
    said = re.search(r"Built octree with (\d+) points in (\d+) nodes",
                     out)
    if not said or int(said.group(1)) != E2E_POINTS:
        raise AssertionError(f"cli output does not report {E2E_POINTS} "
                             f"points: {out}")

    t0 = time.perf_counter()
    run_cli([ply, "--output_directory", b_dir, "--use_device",
             "--device", "cpu"], {})
    log(f"e2e: port CLI build with --device cpu "
        f"{time.perf_counter() - t0:.3f} s")
    files = dirs_byte_equal(a_dir, b_dir)
    log(f"e2e: card == CPU route, {files} files byte-equal; "
        f"{said.group(2)} nodes hold all {E2E_POINTS} points")
    check_build_launches("e2e", launches, 1)
    shutil.rmtree(b_dir)
    return launches, a_dir, ply, wall, phases

# --- phase 6: the viewer's device cull ------------------------------------


def synthetic_node_table(k: int, seed: int):
    """A valid k-node octree table by the recipe of the JAX package's 1M-node
    tree (bench.py:664-697): every node down to level 6, then k - 299,593
    distinct random level-7 nodes; root cube [0, 1024]^3, 10 points a node.
    A cube follows its path's octal digits root first, x/y/z from bits
    2/1/0 of each digit.  -> mins (k, 3) f64, edges (k,) f64, num_points
    (k,) int64, as an octree holds them."""
    rng = np.random.default_rng(seed)
    per_level = [np.arange(8**level, dtype=np.int64) for level in range(7)]
    n7 = k - sum(len(p) for p in per_level)
    per_level.append(np.sort(rng.choice(8**7, size=n7, replace=False)))
    mins, edges = [], []
    for level, paths in enumerate(per_level):
        lo = np.zeros((len(paths), 3))
        for d in range(1, level + 1):
            digit = (paths >> (3 * (level - d))) & 7
            bits = np.stack([(digit >> 2) & 1, (digit >> 1) & 1, digit & 1],
                            axis=1)
            lo += bits * (1024.0 / 2**d)
        mins.append(lo)
        edges.append(np.full(len(paths), 1024.0 / 2**level))
    return (np.concatenate(mins), np.concatenate(edges),
            np.full(k, 10, dtype=np.int64))


def cull_frusta(C) -> dict:
    """The frusta of phase 6a, built through the port's culling module."""
    partial = C.Frustum.new(  # bench.py:711-713
        C.Isometry.from_axis_angle([0, 1, 0], 0.3,
                                   translation=[200.0, 200.0, 400.0]),
        C.Perspective.from_fov(1.0, 0.7, 1.0, 500.0))
    everything = C.Frustum.new(  # bench.py:715-719
        C.Isometry.from_axis_angle([0, 1, 0], 0.0,
                                   translation=[512.0, 512.0, 4000.0]),
        C.Perspective.from_fov(1.2, 1.0, 1.0, 10000.0))
    # An off-axis projection: 26 separating axes instead of 16.
    eye = C.Isometry.from_axis_angle([1, 1, 0], 0.7,
                                     translation=[300.0, 200.0, 900.0])
    proj = C.Perspective.from_fov(1.0, 0.7, 1.0, 2000.0).matrix.copy()
    proj[0, 2], proj[1, 2] = 0.3, -0.2
    off_axis = C.Frustum.from_matrix4(proj @ eye.inverse().to_matrix4())
    orbit = [  # bench.py:628-636
        C.Frustum.new(
            C.Isometry.from_axis_angle([0, 1, 0], 0.4 + ang,
                                       translation=[60.0, 45.0, 260.0]),
            C.Perspective.from_fov(1.5, 1.2, 0.5, 1000.0))
        for ang in np.linspace(0, 0.2, CULL_BATCH)
    ]
    return {"partial": partial, "all": everything, "off_axis": off_axis,
            "orbit": orbit}


def f32_err(a, b) -> float:
    """max |a - b| where a and b differ; 0.0 when they are equal bit for
    bit (NaN matching NaN, -0 matching +0)."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    a, b = a.float(), b.float()
    differ = ~((a == b) | (a.isnan() & b.isnan()))
    if not bool(differ.any()):
        return 0.0
    return float((a[differ] - b[differ]).abs().nan_to_num(
        nan=float("inf")).max())


def cull_inputs(dev) -> tuple:
    """Phase 6a's inputs on dev: the CULL_NODES-node table (as an octree
    holds it: f64 mins and edges, i64 counts), the same as f32/i32 tensors,
    a 65,536-node table of IEEE corner cases, and each setup's per-frame
    tensors by name (a partial view, all visible, the off-axis frame padded
    to the axis capacity the session's growth rule gives it, a frame whose
    axes are all inert, a CULL_BATCH-frame batch)."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import culling as C
    from point_cloud_viewer_tpu_torch.testing import adversarial_node_table

    mins, edges, num_points = synthetic_node_table(CULL_NODES, seed=5)
    table = [torch.from_numpy(a).to(dev) for a in
             (mins.astype(np.float32), edges.astype(np.float32),
              num_points.astype(np.int32))]
    odd = [torch.from_numpy(a).to(dev)
           for a in adversarial_node_table(CULL_NODES // 16, seed=6)]
    frusta = cull_frusta(C)

    def frame(frustum, a_cap):
        axes, qmin, qmax = C.frustum_axes_and_projections(frustum)
        padded = C.pad_cull_axes(axes, qmin, qmax, a_cap)
        arrays = (frustum.clip_from_query.astype(np.float32), *padded)
        return [torch.from_numpy(a).to(dev) for a in arrays]

    # The session's growth rule (culling.py:220-224) past K5's 32 axes.
    grown = C.DeviceCullSession(mins, edges, num_points, axis_capacity=8,
                                device=dev)
    grown.step(frusta["off_axis"])
    if not grown.a_cap > 32:
        raise AssertionError(f"a_cap {grown.a_cap} <= 32")
    mats, axs, qns, qxs = C.prep_frustum_frames(frusta["orbit"], 32)
    inert = frame(frusta["partial"], 32)
    inert[2].fill_(-np.inf)
    inert[3].fill_(np.inf)
    setups = {
        "partial": frame(frusta["partial"], 32),
        "all visible": frame(frusta["all"], 32),
        f"off-axis, {grown.a_cap} axes": frame(frusta["off_axis"],
                                               grown.a_cap),
        "inert axes only": inert,
        f"{CULL_BATCH} frames": [torch.from_numpy(a).to(dev)
                                 for a in (mats, axs, qns, qxs)],
    }
    return (mins, edges, num_points), table, odd, setups


def phase_cull_kernel(record: dict) -> tuple:
    """6a: K5 against its plain version on the card, bit for bit, at
    CULL_NODES nodes and on an adversarial table, in every setup of
    cull_inputs and with K = 0; CUDA-event medians and the least work of
    the timed setups (all but the inert frame).  Returns the node table
    (mins, edges, num_points) and the timed setups (per-frame tensors,
    node tensors) for the device times of phase 7d."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC

    dev = torch.device(DEVICE)
    octree_table, table, odd, setups = cull_inputs(dev)
    cases = {name: (per_frame, table) for name, per_frame in setups.items()}
    cases["K = 0"] = (setups["partial"], [t[:0] for t in table])
    cases.update({f"adversarial table, {name}": (per_frame, odd)
                  for name, per_frame in setups.items()})
    for name, (per_frame, nodes) in cases.items():
        before = CC.cull_lod.launches
        got = CC.cull_lod(*per_frame, *nodes)
        torch.cuda.synchronize()
        launched = CC.cull_lod.launches - before
        want = CC.cull_lod_plain(*per_frame, *nodes)
        errs = [f32_err(g, w) for g, w in zip(got, want)]
        visible = int(got[1].sum())
        log(f"K5 cull_lod {name}: K={nodes[0].shape[0]}, shape "
            f"{tuple(got[0].shape)}, axes {per_frame[1].shape[-2]}, "
            f"visible {visible}, NaN sizes {int(got[0].isnan().sum())}, "
            f"launches {launched}, max_abs_err (sizes, visible, priority) "
            f"{errs}")
        record["K5"]["err"] = max(record["K5"]["err"], *errs)
        if any(errs) or launched != (1 if nodes[0].shape[0] else 0):
            raise AssertionError(f"K5 {name}: errors {errs}, launches "
                                 f"{launched}")
        if name in ("all visible", "inert axes only") and visible != CULL_NODES:
            raise AssertionError(f"K5 {name}: {visible} visible")
        if name == "partial" and not 0 < visible < CULL_NODES:
            raise AssertionError(f"K5 partial view: {visible} visible")

    timed = {name: cases[name] for name in setups
             if name != "inert axes only"}
    times, work = {}, {}
    for name, (per_frame, nodes) in timed.items():
        ms = cuda_ms(lambda: CC.cull_lod(*per_frame, *nodes))
        pms = (cuda_ms(lambda: CC.cull_lod_plain(*per_frame, *nodes))
               if name in ("partial", f"{CULL_BATCH} frames") else None)
        times[name] = (ms, pms)
        work[name] = cull_work(per_frame, nodes)
        log(f"K5 {name} at K={CULL_NODES}: kernel {ms:.4f} ms (CUDA events, "
            "one call)" + ("" if pms is None else f", plain {pms:.4f} ms")
            + f"; least work {work[name][0]} B, {work[name][1]} f32 "
            "operations")
    record["K5"]["times"] = times
    record["K5"]["work"] = work
    record["K5"]["bytes"], record["K5"]["ops"] = work["partial"]
    return octree_table, timed


# Least f32 operations of K5 for one node and frame (csrc/cull.cu): the
# corners' six coordinates (0 * edge, then six sums: 7); the screen size
# from its distinct terms (18 products, 12 + 24 + 24 sums, 16 quotients,
# 32 clamp comparisons, 28 min/max, 2 differences and their product: 157);
# visibility and priority (2).  And for each live axis tested, the
# two-corner form: 6 products, 3 comparisons ordering the term pairs, 4
# sums, 2 comparisons with the query range.
CULL_NODE_OPS = 7 + 157 + 2
CULL_AXIS_OPS = 6 + 3 + 4 + 2


def cull_work(per_frame, nodes) -> tuple:
    """(bytes, f32 operations) that one K5 launch needs on these inputs,
    one frame or F: the node table read once, each frame's matrix and axes
    read once, every output (size, visible, priority) written once; per node
    and frame CULL_NODE_OPS, plus CULL_AXIS_OPS for each live axis (query
    range other than (-inf, inf)) tested up to the first that separates."""
    import torch

    matrix, axes, qmin, qmax = per_frame
    if matrix.dim() == 2:
        matrix, axes, qmin, qmax = (t[None] for t in per_frame)
    mins, edges, _ = nodes
    frames, k = matrix.shape[0], edges.shape[0]
    nbytes = (sum(t.numel() * t.element_size() for t in (*per_frame, *nodes))
              + frames * k * (4 + 1 + 4))
    unit = torch.tensor([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                         for c in range(8)], dtype=torch.float32,
                        device=mins.device)
    corners = mins[:, None, :] + unit[None] * edges[:, None, None]
    tested = 0
    for f in range(frames):
        live = ~((qmin[f] == -np.inf) & (qmax[f] == np.inf))
        alive = torch.ones(k, dtype=torch.bool, device=mins.device)
        for j in torch.nonzero(live).flatten().tolist():
            u = axes[f, j]
            p = (corners[..., 0] * u[0] + corners[..., 1] * u[1]
                 + corners[..., 2] * u[2])
            tested += int(alive.sum())
            alive &= ~((p.amin(1) > qmax[f, j]) | (p.amax(1) < qmin[f, j]))
    return nbytes, CULL_NODE_OPS * k * frames + CULL_AXIS_OPS * tested


def orbit_matrices(center, diag, frames, width, height) -> list:
    """The camera matrices of run_headless's orbit (render_loop.py:428-438),
    through the port's viewer module."""
    from point_cloud_viewer_tpu_torch.viewer.render_loop import Camera

    camera = Camera(width, height)
    out = []
    for frame in range(frames):
        angle = 2 * np.pi * frame / frames
        camera.position = center + diag * np.array(
            [np.cos(angle), np.sin(angle), 0.5])
        camera.theta = angle + np.pi / 2
        camera.phi = np.pi / 3
        camera.moved = True
        camera.update(1 / 60)
        out.append(camera.world_to_gl())
    return out


def session_card_vs_cpu(name, mins, edges, num_points, center, diag):
    """DeviceCullSession on the card against device="cpu" over the orbit
    of run_headless: every frame of step and the one step_frames call
    against the CPU route's step_frames (which the CPU tests hold
    bit-equal to its step), bit for bit.  Per-frame host clock of step as
    the renderer calls it (each result dropped before the next frame; kept
    results would add first-touch page faults of fresh host memory);
    returns the frusta and the card's session."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import culling as C

    frusta = [C.Frustum.from_matrix4(m) for m in
              orbit_matrices(center, diag, VIEW_FRAMES, 1280, 720)]
    card = C.DeviceCullSession(mins, edges, num_points, device=DEVICE)
    card.step(frusta[0])
    torch.cuda.synchronize()
    secs = []
    for f in frusta:
        t0 = time.perf_counter()
        card.step(f)
        secs.append(time.perf_counter() - t0)
    steps = [card.step(f) for f in frusta]
    t0 = time.perf_counter()
    batch = card.step_frames(frusta)
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = C.DeviceCullSession(mins, edges, num_points,
                              device="cpu").step_frames(frusta)
    cpu_s = time.perf_counter() - t0
    bad = []
    for i, one in enumerate(steps):
        for field, got, b, want in zip(("order", "sizes", "visible"), one,
                                       batch, ref):
            for label, a in (("step", got), ("step_frames", b[i])):
                if f32_err(torch.from_numpy(np.asarray(a)),
                           torch.from_numpy(np.asarray(want[i]))):
                    bad.append(f"frame {i} {label} {field}")
    counts = [int(v.sum()) for v in ref[2]]
    log(f"session {name}: K={len(edges)}, {VIEW_FRAMES} orbit frames; card "
        f"step median {statistics.median(secs) * 1e3:.3f} ms/frame (min "
        f"{min(secs) * 1e3:.3f}, max {max(secs) * 1e3:.3f}); step_frames "
        f"{batch_s * 1e3 / VIEW_FRAMES:.3f} ms/frame (results kept); CPU "
        f"route step_frames {cpu_s:.3f} s; visible per frame min "
        f"{min(counts)} median {int(statistics.median(counts))} max "
        f"{max(counts)}; a_cap {card.a_cap}; card == CPU route: {not bad}")
    if bad:
        raise AssertionError(f"session {name}: card differs from the CPU "
                             f"route at {bad[:10]} ({len(bad)} in all)")
    if max(counts) == 0:
        raise AssertionError(f"session {name}: no frame sees a node")
    return frusta, card


def session_split(frusta, card) -> None:
    """Where one step's time goes: the orbit through DeviceCullSession.step
    under torch.profiler, read from the session's own spans (select.prep,
    .upload, .launch, .fetch; host clock, mean a frame), plus CUDA-event
    times of the kernel and the sort on the last frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC
    from point_cloud_viewer_tpu_torch.ops import culling as C
    from point_cloud_viewer_tpu_torch.utils import progress

    progress.reset_span_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        for f in frusta:
            card.step(f)
    totals = progress.span_totals()
    parts = ("select.prep", "select.upload", "select.launch", "select.fetch")
    if any(totals.get(k, [0])[0] != len(frusta) for k in parts):
        raise AssertionError(f"session spans: {totals}, {len(frusta)} frames")
    f = frusta[-1]
    args = [card._put(a) for a in
            (f.clip_from_query.astype(np.float32),
             *card._pad(*C.frustum_axes_and_projections(f)))]
    table = (card._mins, card._edges, card._num_points)
    _, _, priority = CC.cull_lod(*args, *table)
    kernel_ms = cuda_ms(lambda: CC.cull_lod(*args, *table))
    sort_ms = cuda_ms(lambda: torch.sort(-priority, stable=True))
    log("session split, 1M table, orbit means of the session's spans (host "
        "clock, ms): " + ", ".join(
            f"{k.split('.')[1]} {totals[k][1] / totals[k][0] * 1e3:.4f}"
            for k in parts)
        + f"; last frame by CUDA events: kernel {kernel_ms:.4f} ms, sort "
        f"{sort_ms:.4f} ms")


def phase_cull_session(octree_dir: str, table) -> None:
    """6b: the session on the card against the CPU route, over the 1M-node
    table and phase 5's octree; the split of one step on the card."""
    from point_cloud_viewer_tpu_torch.viewer.render_loop import Octree

    mins, edges, num_points = table
    frusta, card = session_card_vs_cpu(
        "1M table", mins, edges, num_points, np.full(3, 512.0),
        1024.0 * np.sqrt(3.0))
    session_split(frusta, card)
    octree = Octree.from_directory(octree_dir)
    box = octree.bounding_box
    session_card_vs_cpu("phase 5 octree", octree.cube_mins,
                        octree.cube_edges, octree.num_points, box.center(),
                        float(np.linalg.norm(box.diag())))


def decode_png(path: str) -> np.ndarray:
    """An 8-bit RGBA PNG whose rows use filter 0 (what the port's viewer
    writes) -> (H, W, 4) u8, checking every chunk's CRC."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    width, height, depth, color = header[:4]
    if (depth, color) != (8, 6):
        raise AssertionError(f"{path}: not 8-bit RGBA ({depth}, {color})")
    rows = np.frombuffer(zlib.decompress(idat), dtype=np.uint8).reshape(
        height, 1 + 4 * width)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row uses a filter other than 0")
    return rows[:, 1:].reshape(height, width, 4)


def phase_view(octree_dir: str, tmp: str) -> int:
    """6c: the port's viewer CLI, culling on the card by default, over phase
    5's octree; returns K5's launches in that run."""
    from point_cloud_viewer_tpu_torch.cli.view import main as view_main
    from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC

    shot = os.path.join(tmp, "view.png")
    buf = io.StringIO()
    CC.cull_lod.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = view_main([octree_dir, "--device", DEVICE, "--frames",
                        str(VIEW_FRAMES), "--screenshot", shot])
    wall = time.perf_counter() - t0
    launches = CC.cull_lod.launches
    out = buf.getvalue().strip()
    log(f"view: cli.view --frames {VIEW_FRAMES} on the card: "
        f"rc {rc}, {wall:.3f} s, K5 launches {launches}; cli said: {out}")
    said = re.search(r"Final frame: (\d+)/(\d+) nodes, (\d+) points", out)
    if rc != 0 or not said or int(said.group(2)) <= 0:
        raise AssertionError(f"view: rc {rc}, output {out!r}")
    if launches <= 0:
        raise AssertionError("view: K5 was not launched")
    image = decode_png(shot)
    painted = int((image != np.array([17, 17, 20, 255], np.uint8))
                  .any(axis=2).sum())
    log(f"view: final frame {image.shape[1]}x{image.shape[0]} RGBA, "
        f"{painted} non-background pixels")
    if painted <= 0:
        raise AssertionError("view: the final frame is all background")
    return launches


# --- phase 7: K6, K4's promotion stage and the streaming build -----------


def device_readings(fn, setup=None) -> dict:
    """fn's CUDA-event median of one call (cuda_ms), of 20 calls queued
    back to back (train_ms) and the device time of the port's kernels in a
    call (torch.profiler: testing.kernel_split); setup, if given, returns
    fresh arguments for one call (an in-place kernel) and runs untimed.
    The device time reads None (not measured) where no profile kept a
    record of the kernel, or where it and the back-to-back time differ by
    more than 20%: a profile that dropped or mistimed records."""
    from point_cloud_viewer_tpu_torch.testing import kernel_split

    setup = setup or (lambda: ())
    out = {"ms": cuda_ms(fn, setup),
           "train_ms": train_ms(fn, setup=lambda: [setup()
                                                   for _ in range(20)])}
    split = kernel_split(lambda: fn(*setup()))
    dms = sum(split.values()) if split else None
    out["profiled_ms"] = dms
    if dms is not None and abs(dms - out["train_ms"]) > 0.2 * out["train_ms"]:
        dms = None
    out["device_ms"] = dms
    return out


def readings_text(r: dict) -> str:
    """One line of device_readings' numbers."""
    dms, pms = r["device_ms"], r["profiled_ms"]
    device = (f"{dms:.4f} ms a call (torch.profiler)" if dms is not None
              else "not measured (the profiler kept no record)" if pms is None
              else f"not measured (the profiler read {pms:.4f} ms a call, "
                   "more than 20% off the queued back-to-back time)")
    return (f"device {device}; 20 queued back to back {r['train_ms']:.4f} "
            f"ms a call; one call {r['ms']:.4f} ms (CUDA events)")


def device_ops_main() -> int:
    """`chip_smoke.py --device-ops` (fresh_device_ops' child): prints as
    JSON the kernels and memsets one K3 call and one K5 call put on the
    card (testing.device_ops), on phase 3's K3 input (SIZES[0] codes,
    level 8, the state the levels before leave) and phase 6a's partial
    frame over its node table."""
    sys.meta_path.insert(0, RefuseJaxPackage())
    import torch

    from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC
    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
    from point_cloud_viewer_tpu_torch.ops.leaf_levels_cuda import (
        _bound_levels,
    )
    from point_cloud_viewer_tpu_torch.testing import device_ops

    dev = torch.device(DEVICE)
    n = SIZES[0]
    codes = torch.from_numpy(synthetic_codes(n, seed=n).view(np.int64))
    b = _bound_levels(torch.sort(codes.to(dev)).values, DEPTH)
    ss, leaf, found = k3_level_state(b, 8)
    ops = {"K3": device_ops(
        lambda: LC.leaf_update_pass(b, ss, leaf, found, 8, 100_000))}
    _, table, _, setups = cull_inputs(dev)
    ops["K5"] = device_ops(lambda: CC.cull_lod(*setups["partial"], *table))
    print(json.dumps(ops), flush=True)
    return 0


def fresh_device_ops() -> dict:
    """device_ops_main's readings, taken in a child process.  Late in this
    process torch.profiler once dropped the memset record of all ten
    profiles of a K3 call on an H100, while a fresh process kept it in 50
    of 50 profiles, with 60 profiles of K6 between them: what one call puts
    on the card is read where the profiler keeps its records."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--device-ops"],
        cwd=here, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"chip_smoke.py --device-ops exited "
                             f"{proc.returncode}: {proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def inprocess_profiles(k3_call, tries: int = 5) -> list:
    """What this process's profiler keeps of one K3 call, late in the
    smoke, beside fresh_device_ops' reading: for each of `tries` sessions
    of one call (testing._session), the device records kept of its kernel
    and its memset, and the activity buffers kineto requested during it.
    Logged only; the child's reading is the check (PERF.md §7)."""
    import torch
    from torch.autograd import DeviceType

    from point_cloud_viewer_tpu_torch import testing as T

    k3_call()
    torch.cuda.synchronize()
    rows = []
    for _ in range(tries):
        events = [(ev.name, ev.device_type)
                  for ev in T._session(k3_call, 1).events()]
        cuda = [name.lower() for name, kind in events
                if kind == DeviceType.CUDA]
        rows.append({
            "kernel": sum("lookback_scan" in name for name in cuda),
            "memset": sum("memset" in name for name in cuda),
            "buffer_requests": sum(name == "Activity Buffer Request"
                                   for name, _ in events)})
    log(f"K3 in this process (logged, not the check): {tries} profiles of "
        f"one call kept {json.dumps(rows)}")
    return rows


def phase_device_times(record: dict, cull_setups: dict) -> None:
    """7d, after 7a-b (profiles taken there see the card): device_readings
    of K5 in each timed setup of 6a and of K3 at SIZES[0], level 8, from
    phase 3's timed state; and the kernels and memsets one call of each
    puts on the card (testing.device_ops, in a child process:
    fresh_device_ops), which must be one memset and one lookback_scan for
    K3, one cull_kernel for K5."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC
    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC

    device = {}
    for name, (per_frame, nodes) in cull_setups.items():
        r = device_readings(lambda: CC.cull_lod(*per_frame, *nodes))
        device[name] = r["device_ms"]
        log(f"K5 {name}: {readings_text(r)}")
    record["K5"]["device"] = device
    record["K5"]["device_ms"] = device["partial"]

    b, ss, leaf, found = record["K3"].pop("inputs")
    k3 = lambda l, f: LC.leaf_update_pass(b, ss, l, f, 8, 100_000)  # noqa: E731
    r = device_readings(k3, lambda: (leaf.clone(), found.clone()))
    record["K3"]["device_ms"] = r["device_ms"]
    log(f"K3 leaf_update_pass n={b.shape[0]}, level 8, each call from the "
        f"state before level 8: {readings_text(r)}")
    inprocess_profiles(lambda: k3(leaf, found))
    del b, ss, leaf, found
    torch.cuda.empty_cache()
    for k, ops in fresh_device_ops().items():
        record[k]["device_ops"] = ops
    want = {"K3": {"kernels": ["lookback_scan"], "memsets": 1},
            "K5": {"kernels": ["cull_kernel"], "memsets": 0}}
    for k, ops in want.items():
        got = record[k]["device_ops"]
        log(f"{k}: one call puts {len(got['kernels'])} kernel(s) "
            f"{got['kernels']} and {got['memsets']} memset(s) on the card")
        if got != ops:
            raise AssertionError(f"{k} is not {ops} a call: {got}")


def ab_turn() -> list:
    """One turn of kernel_ab.py, in whichever port this process imports:
    K5 in the timed setups of 6a and K3 at SIZES[0], level 8, on the codes
    (from the state before level 8) and on the start-only input (every row
    set), each held bit-equal to its plain version, then device_readings
    and the least work of each call; K3 on the start-only input from leaf =
    DEPTH, found = 0.  -> rows of dicts."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC
    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
    from point_cloud_viewer_tpu_torch.ops.tree_build import _bound_levels

    dev = torch.device(DEVICE)
    _, table, _, setups = cull_inputs(dev)
    rows = []
    for name, per_frame in setups.items():
        if name == "inert axes only":
            continue
        want = CC.cull_lod_plain(*per_frame, *table)
        got = CC.cull_lod(*per_frame, *table)
        errs = [f32_err(g, w) for g, w in zip(got, want)]
        if any(errs):
            raise AssertionError(f"K5 {name}: {errs}")
        nbytes, ops = cull_work(per_frame, table)
        rows.append({"kernel": "K5", "setup": name, "bytes": nbytes,
                     "ops": ops, **device_readings(
                         lambda: CC.cull_lod(*per_frame, *table))})
    n = SIZES[0]
    b = _bound_levels(torch.sort(torch.from_numpy(
        synthetic_codes(n, seed=n).view(np.int64)).to(dev)).values, DEPTH)
    start_only = torch.full((n,), DEPTH + 1, dtype=torch.uint8, device=dev)
    start_only[:1].fill_(0)
    fresh = (LC.seg_start_pass_plain(start_only, 8),
             torch.full((n,), DEPTH, dtype=torch.uint8, device=dev),
             torch.zeros(n, dtype=torch.uint8, device=dev))
    for name, bb, threshold, state in (
            ("codes, level 8", b, LEAF_MAX_POINTS, k3_level_state(b, 8)),
            ("start only, level 8", start_only, n, fresh)):
        ss, leaf, found = state
        k3 = lambda l, f: LC.leaf_update_pass(bb, ss, l, f, 8, threshold)  # noqa: E731
        want = LC.leaf_update_pass_plain(bb, ss, leaf.clone(), found.clone(),
                                         8, threshold)
        got = k3(leaf.clone(), found.clone())
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K3 {name}: differs from plain")
        rows.append({"kernel": "K3", "setup": name,
                     "bytes": k3_bytes(n, k3_changed(k3, leaf, found)),
                     "ops": 0, **device_readings(
                         k3, lambda: (leaf.clone(), found.clone()))})
    return rows


def bucket_codes(codes, root_level: int):
    """The codes moved into one level-`root_level` cell (their top 3 x
    root_level bits replaced by those of the first code), as a streamed
    bucket's derivation sees them; still sorted."""
    import torch

    low = 3 * (DEPTH - root_level)
    return torch.sort((codes & ((1 << low) - 1))
                      | (codes[:1] >> low << low)).values


def phase_leaf_levels(record: dict) -> None:
    """7a: K6 at SIZES sorted synthetic codes.  The leaf stage (b and the u8
    leaf from the codes, the build's entry) against its plain version and
    against `_bound_levels` + the K2 + K3 loop it replaced: in core, as a
    streamed bucket (root_level 2, codes inside one level-2 cell) and with
    pad rows (n_real < n); the public K6 (i32 leaf) against its plain
    version and the device core's leaf.  Tolerance 0.  CUDA-event medians
    of the stage alone, the public K6, the replaced loop from b and
    `_bound_levels`."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import leaf_levels_cuda as K6
    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
    from point_cloud_viewer_tpu_torch.ops.tree_build import (
        _bound_levels,
        build_tree_device_codes_grouped,
    )
    from point_cloud_viewer_tpu_torch.testing import kernel_split

    dev = torch.device(DEVICE)
    for n in SIZES:
        tag = f"n={n}"
        codes = torch.sort(torch.from_numpy(
            synthetic_codes(n, seed=n).view(np.int64)).to(dev)).values
        padded = codes.clone()
        padded[n - 1001:].copy_(codes[:1001].flip(0))  # 1001 pad rows
        cases = {"in core": (codes, 0, n),
                 "bucket, root 2": (bucket_codes(codes, 2), 2, n),
                 "pad rows": (padded, 0, n - 1001)}
        for name, (c, root, n_real) in cases.items():
            got = K6.leaf_stage(c, DEPTH, DEPTH, LEAF_MAX_POINTS, root, n_real)
            loop = K6.leaf_stage_loop(c, DEPTH, DEPTH, LEAF_MAX_POINTS, root,
                                      n_real)
            errs = [max_abs_err(g, w) for g, w in zip(got, loop)]
            if name == "in core":
                plain = K6.leaf_stage_plain(c, DEPTH, DEPTH, LEAF_MAX_POINTS)
                errs += [max_abs_err(g, w) for g, w in zip(got, plain)]
                del plain
            log(f"K6 leaf_stage {tag} {name}: max_abs_err (b, leaf) vs the "
                f"K2 + K3 loop{' and plain' if name == 'in core' else ''} "
                f"{errs}; leaf levels "
                f"{torch.bincount(got[1], minlength=DEPTH + 1).tolist()}")
            record["K6"]["err"] = max(record["K6"]["err"], *errs)
            if any(errs):
                raise AssertionError(f"K6 leaf_stage {tag} {name}: {errs}")
            del got, loop
        del cases, padded

        got = K6.leaf_levels(codes, DEPTH, DEPTH, LEAF_MAX_POINTS)
        plain = K6.leaf_levels_plain(codes, DEPTH, DEPTH, LEAF_MAX_POINTS)
        core = build_tree_device_codes_grouped(
            codes, n, DEPTH, DEPTH, LEAF_MAX_POINTS,
            extras_cap=max(512, n >> 6)).leaf
        err_plain, err_core = max_abs_err(got, plain), max_abs_err(got, core)
        log(f"K6 leaf_levels {tag} (public, i32): max_abs_err vs plain "
            f"{err_plain}, vs core leaf {err_core}")
        record["K6"]["err"] = max(record["K6"]["err"], err_plain, err_core)
        if err_plain or err_core:
            raise AssertionError(f"K6 {tag}: err vs plain {err_plain}, vs "
                                 f"core {err_core}")
        del got, plain, core

        b = _bound_levels(codes, DEPTH)
        fresh = (torch.full((n,), DEPTH, dtype=torch.uint8, device=dev),
                 torch.zeros(n, dtype=torch.uint8, device=dev))

        def leaf_loop(leaf, found):
            for level in range(1, DEPTH + 1):
                LC.leaf_update_pass(b, LC.seg_start_pass(b, level), leaf,
                                    found, level, LEAF_MAX_POINTS)

        stage = lambda: K6.leaf_stage(codes, DEPTH, DEPTH, LEAF_MAX_POINTS)
        times = {
            "stage": cuda_ms(stage),
            "stage, 20 back to back": train_ms(stage),
            "public K6 (i32)": cuda_ms(lambda: K6.leaf_levels(
                codes, DEPTH, DEPTH, LEAF_MAX_POINTS)),
            "21 x (K2 + K3) from b": cuda_ms(
                leaf_loop, lambda: tuple(t.clone() for t in fresh)),
            "_bound_levels": cuda_ms(lambda: _bound_levels(codes, DEPTH)),
        }
        if n == SIZES[0]:
            times["stage plain"] = cuda_ms(lambda: K6.leaf_stage_plain(
                codes, DEPTH, DEPTH, LEAF_MAX_POINTS), reps=3)
            record["K6"]["times"][n] = (times["stage"], times["stage plain"])
        split = kernel_split(stage)
        log(f"K6 {tag} leaf stage by kernel (torch.profiler, device ms a "
            "call): " + (", ".join(f"{k} {v:.4f}" for k, v in split.items())
                         or "not measured (no device time)"))
        log(f"K6 {tag} (CUDA-event medians, ms; the stage and the public K6 "
            "start from the codes, the loop from b): "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
            + f"; replaced (_bound_levels + loop) / stage "
            f"{(times['_bound_levels'] + times['21 x (K2 + K3) from b']) / times['stage']:.2f}")
        del codes, b, fresh
        torch.cuda.empty_cache()


def streaming_cli(ply: str, out_dir: str, spill: str, wrappers: dict):
    """The port's CLI with --streaming on the card, launch counts set to 0
    just before and read just after; -> (wall s, phases, launches)."""
    for w in wrappers.values():
        w.launches = 0
    phases = {}
    t0 = time.perf_counter()
    said = run_cli([ply, "--output_directory", out_dir, "--use_device",
                    "--device", DEVICE, "--streaming", "--spill_directory",
                    spill], phases)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    log("streaming: cli said: " + said.strip().splitlines()[0])
    buckets = int(phases.get("buckets_derived", 0))
    host = {k: phases.get(k, 0.0) for k in (
        "bucket_load", "bucket_quantize", "bucket_device_dispatch",
        "bucket_group", "bucket_encode_write")}
    wait = phases.get("bucket_device_wait", 0.0)
    busy = phases.get("bucket_device_busy", 0.0)
    log(f"streaming: wall {wall:.3f} s; phases (s, bytes) "
        f"{json.dumps(phases)}; launches {json.dumps(launches)}")
    log(f"streaming: {buckets} buckets derived on the card; per bucket (ms): "
        + ", ".join(f"{k} {v * 1e3 / max(buckets, 1):.3f}"
                    for k, v in {**host, "bucket_device_derive":
                                 phases.get("bucket_device_derive", 0.0),
                                 "bucket_device_wait": wait,
                                 "bucket_device_busy": busy}.items())
        + f"; up {phases.get('bucket_upload_bytes', 0) / max(buckets, 1):.0f}"
        f" B, down {phases.get('bucket_fetch_bytes', 0) / max(buckets, 1):.0f}"
        " B")
    log(f"streaming overlap: host waited {wait:.4f} s for {busy:.4f} s of "
        f"card time (upload + derivation) = "
        f"{wait / busy if busy else 0.0:.4f} of it not hidden, against "
        f"{sum(host.values()):.3f} s of host bucket phases")
    if buckets <= 0:
        raise AssertionError("streaming path: no bucket derived on the card")
    check_build_launches("streaming", launches, buckets)
    return wall, phases, launches


def phase_streaming(wrappers: dict, tmp: str, ply16: str, incore16: str,
                    incore16_wall: float) -> dict:
    """7c: phase 5's PLY streamed on the card against phase 5's in-core
    output, then BIG_POINTS built in core and streamed, byte for byte;
    every intermediate is deleted once compared (phase 5's PLY is kept for
    phase 12).  Returns the 16M
    streaming path's launch counts and its number of buckets derived on
    the card."""
    spill = os.path.join(tmp, "spill")
    out = os.path.join(tmp, "streamed16")
    wall, phases16, launches16 = streaming_cli(ply16, out, spill, wrappers)
    files = dirs_byte_equal(incore16, out)
    log(f"streaming 16M: == phase 5's in-core card build, {files} files "
        f"byte-equal; wall streamed {wall:.3f} s vs in core "
        f"{incore16_wall:.3f} s")
    shutil.rmtree(out)

    ply = os.path.join(tmp, "big.ply")
    t0 = time.perf_counter()
    write_ply(ply, BIG_POINTS, seed=6)
    log(f"streaming 64M: wrote {BIG_POINTS} points "
        f"({os.path.getsize(ply)} B) in {time.perf_counter() - t0:.3f} s")
    incore = os.path.join(tmp, "incore64")
    phases = {}
    t0 = time.perf_counter()
    said = run_cli([ply, "--output_directory", incore, "--use_device",
                    "--device", DEVICE], phases)
    incore_wall = time.perf_counter() - t0
    log(f"streaming 64M: in-core card build {incore_wall:.3f} s; phases (s) "
        f"{json.dumps(phases)}; cli said: {said.strip().splitlines()[0]}")
    out = os.path.join(tmp, "streamed64")
    wall, _, _ = streaming_cli(ply, out, spill, wrappers)
    os.remove(ply)
    files = dirs_byte_equal(incore, out)
    log(f"streaming 64M: == in-core card build, {files} files byte-equal; "
        f"wall streamed {wall:.3f} s vs in core {incore_wall:.3f} s")
    shutil.rmtree(incore)
    shutil.rmtree(out)
    return launches16, int(phases16["buckets_derived"])


# --- phase 9: the deep build and the host route ---------------------------


def deep_cloud(seed: int):
    """DEEP_POINTS in the planet box, xyz f64, rgb u8, intensity f32, three
    parts in three level-2 cells (buckets at B = 2): a Gaussian (sigma
    0.25 m) centred in one level-21 cell and clipped into it (one fat cell,
    derived on the card); a uniform 2 x 2 x 1 block of level-21 cells
    (four fat cells of ~750,000, native tree_levels); a uniform 1 km x 1 km
    x 20 m site (no fat cell).  -> (batch, the fat Gaussian cell's level-21
    path)."""
    from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch

    rng = np.random.default_rng(seed)
    e21 = PLANET / (1 << 21)
    n_one, n_four, n_site = DEEP_POINTS
    cell = np.array([100_000, 100_000, 100_000])
    lo = cell * e21
    one = np.clip(lo + e21 / 2 + rng.normal(0.0, 0.25, (n_one, 3)),
                  lo + 1e-6, lo + e21 - 1e-6)
    four = (np.array([700_000, 100_000, 100_000]) * e21
            + rng.random((n_four, 3)) * (e21 * np.array([2.0, 2.0, 1.0])))
    site = (np.array([100_000, 720_000, 100_000]) * e21
            + rng.random((n_site, 3)) * np.array([1000.0, 1000.0, 20.0]))
    n = sum(DEEP_POINTS)
    batch = PointsBatch(position=np.concatenate([one, four, site]),
                        attributes={
                            "color": rng.integers(0, 256, (n, 3),
                                                  dtype=np.uint8),
                            "intensity": rng.random(n, dtype=np.float32)})
    x, y, z = (int(c) for c in cell)
    path = 0
    for bit in range(20, -1, -1):  # Morton, x most significant
        path = (path << 3) | (((x >> bit) & 1) << 2 | ((y >> bit) & 1) << 1
                              | ((z >> bit) & 1))
    return batch, path


def check_deep_launches(where: str, launches: dict, subbuilds: int) -> None:
    """A deep build launched K1, K4's stage and K6's stage once a device
    sub-build, and none of OFF_PATH."""
    want = {k: subbuilds for k in BUILD_PATH}
    want.update({k: 0 for k in OFF_PATH})
    if launches != want:
        raise AssertionError(f"{where}: launches {launches}, want {want}")


def phase_deep(wrappers: dict, tmp: str, ply16: str, incore16: str) -> dict:
    """9: the deep cloud built in core on the card against the host route
    (use_device=False) and against its streamed build on the card (B = 2),
    byte for byte; the fat cell's sub-build (the grouped derivation at
    depth 12) on the card against the same call on CPU tensors, output by
    output; launches per build; then phase 5's PLY through cli.build_octree
    --no-use_device against phase 5's card build.  Returns the in-core
    deep build's launch counts and its octree (kept for phase 12e)."""
    import torch

    from point_cloud_viewer_tpu_torch.math.geometry import Aabb, Cube
    from point_cloud_viewer_tpu_torch.octree import builder as B
    from point_cloud_viewer_tpu_torch.octree.node_id import MAX_FORMAT_LEVEL
    from point_cloud_viewer_tpu_torch.octree.streaming import (
        build_octree_streaming,
    )
    from point_cloud_viewer_tpu_torch.ops import morton
    from point_cloud_viewer_tpu_torch.ops import tree_build as tb

    t0 = time.perf_counter()
    batch, cell_path = deep_cloud(seed=9)
    box = Aabb(np.zeros(3), np.full(3, PLANET))
    root = Cube.bounding(box)
    total_cap = B.compute_depth_cap(PLANET, DEEP_RESOLUTION,
                                    max_level=MAX_FORMAT_LEVEL)
    codes21, _ = morton.quantize_and_encode(batch.position, root.min,
                                            root.edge_length, DEPTH)
    cells, counts = np.unique(codes21, return_counts=True)
    fat = counts[counts > LEAF_MAX_POINTS]
    run = np.flatnonzero(codes21 == np.uint64(cell_path))
    log(f"deep: {len(batch)} points in {time.perf_counter() - t0:.3f} s; "
        f"total cap {total_cap}, sub-build depth {total_cap - DEPTH}; fat "
        f"level-21 cells {sorted(fat.tolist(), reverse=True)}; the Gaussian "
        f"cell holds {len(run)}")
    if (total_cap != 33 or len(run) != DEEP_POINTS[0] or len(fat) != 5
            or int((fat >= B._DEEP_DEVICE_MIN_N).sum()) != 1):
        raise AssertionError("deep: the cloud is not one fat cell on the "
                             "card's route and four on the native route")
    del codes21

    def build(label, fn, out, **kwargs):
        for w in wrappers.values():
            w.launches = 0
        phases = {}
        t0 = time.perf_counter()
        result = fn(out, DEEP_RESOLUTION, batch, bounding_box=box,
                    phase_times=phases, **kwargs)
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        log(f"deep {label}: wall {wall:.3f} s; {len(result.nodes)} nodes, "
            f"depth cap {result.depth_cap}, deepest level "
            f"{max(n.level for n, _ in result.nodes)}; phases (s) "
            f"{json.dumps(phases)}; launches {json.dumps(launches)}")
        if result.num_points != len(batch) or result.depth_cap != total_cap:
            raise AssertionError(f"deep {label}: {result.num_points} points, "
                                 f"depth cap {result.depth_cap}")
        return phases, launches

    card, host, streamed = (os.path.join(tmp, d) for d in
                            ("deep_card", "deep_host", "deep_streamed"))
    phases, launches = build("in core on the card", B.build_octree, card,
                             device=DEVICE)
    check_deep_launches("deep in core", launches,
                        int(phases["deep_device_subbuilds"]))
    if phases["deep_device_subbuilds"] != 1:
        raise AssertionError("deep: expected one sub-build on the card")
    build("host route", B.build_octree, host, use_device=False)
    files = dirs_byte_equal(card, host)
    log(f"deep: card in core == host route, {files} files byte-equal")
    shutil.rmtree(host)
    s_phases, s_launches = build(
        "streamed on the card (B = 2)", build_octree_streaming, streamed,
        bucket_levels=2, spill_directory=os.path.join(tmp, "deep_spill"),
        device=DEVICE)
    check_deep_launches("deep streamed", s_launches,
                        int(s_phases["deep_device_subbuilds"]))
    files = dirs_byte_equal(card, streamed)
    log(f"deep: streamed on the card == in core, {files} files byte-equal")
    shutil.rmtree(streamed)

    # The fat cell's sub-build, card against CPU tensors; these launches
    # are outside the builds' counts.
    d2 = total_cap - DEPTH
    sub_codes, out = B._dispatch_deep_device(
        batch, run, cell_path, root, DEPTH, total_cap, torch.device(DEVICE))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ref = B._dispatch_deep_device(batch, run, cell_path, root, DEPTH,
                                     total_cap, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    checks = {name: torch.equal(got.cpu(), want) for name, got, want
              in zip(tb.GroupedExchange._fields, out, ref)}
    on_card = morton.codes_to_tensor(sub_codes, DEVICE)
    derive_ms = cuda_ms(lambda: tb.build_tree_device_codes_grouped(
        on_card, len(run), d2, d2, extras_cap=max(512, len(run) >> 6)))
    upload_ms = cuda_ms(lambda: tb.tree_codes_grouped_on_device(
        sub_codes, d2, d2, device=DEVICE))
    log(f"deep sub-build ({len(run)} points, depth {d2}): card vs CPU route "
        f"{checks}; extras_total {int(out.extras_total)}; level_counts "
        f"{out.level_counts.tolist()}; derivation {derive_ms:.4f} ms on the "
        f"card (codes resident; {upload_ms:.4f} ms with the pinned upload), "
        f"CPU route {cpu_s:.3f} s (CUDA events, median of {REPS})")
    if not all(checks.values()):
        raise AssertionError(f"deep sub-build: card differs from CPU: "
                             f"{checks}")
    del out, ref, on_card, batch
    torch.cuda.empty_cache()

    host16 = os.path.join(tmp, "host16")
    phases = {}
    t0 = time.perf_counter()
    said = run_cli([ply16, "--output_directory", host16, "--no-use_device"],
                   phases)
    wall = time.perf_counter() - t0
    files = dirs_byte_equal(incore16, host16)
    log(f"host route: cli --no-use_device on phase 5's PLY {wall:.3f} s; "
        f"phases (s) {json.dumps(phases)}; == phase 5's card build, {files} "
        f"files byte-equal; cli said: {said.strip().splitlines()[0]}")
    shutil.rmtree(host16)
    return launches, card


# --- phase 10: the query path ------------------------------------------------


def query_cloud(n: int, seed: int) -> np.ndarray:
    """(n, 3) f64 ECEF points on and above the WGS84 surface over a
    QUERY_EDGE x QUERY_EDGE m site centred on QUERY_SITE, altitudes in
    QUERY_ALT: half uniform, half in 64 Gaussian clusters (sigma 40 m
    across, 10 m up), converted with the port's wgs84.geodetic_to_ecef."""
    from point_cloud_viewer_tpu_torch.math import wgs84

    rng = np.random.default_rng(seed)
    half = n // 2
    east_north = (rng.random((n, 2)) - 0.5) * QUERY_EDGE
    alt = rng.uniform(*QUERY_ALT, n)
    centers = (rng.random((64, 3)) - 0.5) * [QUERY_EDGE, QUERY_EDGE, 0.0]
    centers[:, 2] = rng.uniform(*QUERY_ALT, 64)
    which = rng.integers(0, 64, n - half)
    east_north[half:] = np.clip(
        centers[which, :2] + rng.normal(0.0, 40.0, (n - half, 2)),
        -QUERY_EDGE / 2, QUERY_EDGE / 2)
    alt[half:] = np.clip(centers[which, 2] + rng.normal(0.0, 10.0, n - half),
                         *QUERY_ALT)
    lat0, lon0 = QUERY_SITE
    m_per_deg = 111_320.0
    lat = lat0 + east_north[:, 1] / m_per_deg
    lon = lon0 + east_north[:, 0] / (m_per_deg * np.cos(np.deg2rad(lat0)))
    return wgs84.geodetic_to_ecef(np.deg2rad(lat), np.deg2rad(lon), alt)


def query_set(ecef: np.ndarray) -> list:
    """phase 10's queries over part of the site: [(name, CLI flags or None,
    location, filter intervals)].  The CLI has no OBB or frustum flag (nor
    has the JAX package's), so those two run through the library only."""
    from point_cloud_viewer_tpu_torch.math import s2, wgs84
    from point_cloud_viewer_tpu_torch.math.geometry import (
        Aabb, Frustum, Isometry, Obb, Perspective)
    from point_cloud_viewer_tpu_torch.math.intervals import ClosedInterval
    from point_cloud_viewer_tpu_torch.math.web_mercator import (
        WebMercatorRect, lat_lng_to_web_mercator)
    from point_cloud_viewer_tpu_torch.s2_cells.cell_union import CellUnion

    lat0, lon0 = QUERY_SITE
    frame = wgs84.local_frame_from_lat_lng(lat0, lon0)
    to_ecef = frame.inverse()
    center = to_ecef.translation
    aabb = Aabb(center - [3000.0, 3500.0, 2500.0],
                center + [2500.0, 2000.0, 3000.0])
    obb = Obb(to_ecef.compose(Isometry.from_axis_angle(
        [0, 0, 1], 0.3, translation=[1500.0, -2000.0, 100.0])),
        np.array([3500.0, 2000.0, 300.0]))
    frustum = Frustum.new(to_ecef.compose(Isometry.from_axis_angle(
        [1, 0, 0], 0.25, translation=[-1000.0, 500.0, 3000.0])),
        Perspective.from_fov(1.3, 0.8, 10.0, 6000.0))
    # Cells around points within 700 m of the site's north-south axis: a
    # cell's world box spans the Earth's radius band (31.6 km), so cells
    # spread east-west would reach almost every node of the site.
    sample = ecef[:len(ecef) // 2:1000]
    sample = sample[np.abs(frame.transform_points(sample)[:, 0]) < 700.0]
    leaves = s2.leaf_cell_ids_from_points(
        sample[::max(1, len(sample) // 16)][:16])
    cells = {int(c) for level, k in ((12, 4), (13, 8), (14, 16))
             for c in s2.parent(leaves[:k], level)}
    union = CellUnion(sorted(cells))
    tokens = ",".join(s2.token(int(c)) for c in union.ids)
    zoom = float(256 << QUERY_ZOOM)
    c = lat_lng_to_web_mercator(np.deg2rad(lat0), np.deg2rad(lon0)) * zoom
    lo, hi = c + [-160.0, -120.0], c + [90.0, 140.0]
    rect = WebMercatorRect.from_zoomed_coordinates(lo, hi, QUERY_ZOOM)
    intensity = {"intensity": ClosedInterval(0.2, 0.6)}
    box_flag = ",".join(repr(float(v)) for v in (*aabb.mins, *aabb.maxs))
    return [
        ("aabb", ["--aabb", box_flag], aabb, {}),
        ("obb", None, obb, {}),
        ("frustum", None, frustum, {}),
        ("cell_union", ["--cell_union", tokens], union, {}),
        ("web_mercator", ["--web_mercator_rect", ",".join(
            repr(float(v)) for v in (*lo, *hi)) + f",{QUERY_ZOOM}"],
         rect, {}),
        ("aabb+intensity", ["--aabb", box_flag, "--filter_interval",
                            "intensity=0.2,0.6"], aabb, intensity),
        ("obb+intensity", None, obb, intensity),
    ]


def run_query_cli(args: list) -> tuple:
    """cli.query_points main on args -> (points it streamed, wall s)."""
    from point_cloud_viewer_tpu_torch.cli.query_points import main as query

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = query(args)
    wall = time.perf_counter() - t0
    said = re.search(r"Streamed (\d+) points", buf.getvalue())
    if rc != 0 or not said:
        raise AssertionError(f"query cli {args} returned {rc}: "
                             f"{buf.getvalue()}")
    return int(said.group(1)), wall


def stream_sorted(client, query) -> tuple:
    """The client's streamed positions, rows sorted -> (positions, wall s
    of the stream alone)."""
    t0 = time.perf_counter()
    parts = [b.position for b in client.stream(query)]
    wall = time.perf_counter() - t0
    pos = np.concatenate(parts) if parts else np.empty((0, 3))
    return pos[np.lexsort(pos.T)], wall


def phase_query(wrappers: dict, tmp: str) -> None:
    """10: the query path.  a. A QUERY_POINTS cloud on and above the WGS84
    surface (query_cloud) through cli.build_octree on the card at 1 cm;
    each query of query_set through cli.query_points on the card (the
    default) and with --no-device_filter, the counts equal, and through
    PointCloudClient.stream on the card and on the host, the sorted
    positions byte-equal; walls, rows filtered on the card, band rows and
    rows the host recomputed, the WebMercator margin.  b. QUERY_FACE_POINTS
    points on the OBB's faces and the frustum's planes, and S2 points on
    face boundaries (argmax ties, bit 63 set): point_filter_mask and
    leaf_ids on the card against device="cpu" and the host, bit for bit.
    The build's launches are held as phase 5's; the queries launch none of
    K1-K7.  Removes its files."""
    import torch

    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.math import s2, s2_device
    from point_cloud_viewer_tpu_torch.math.web_mercator_device import (
        _calibrated_delta)
    from point_cloud_viewer_tpu_torch.query import device_filter as DF
    from point_cloud_viewer_tpu_torch.query.client import PointCloudClient
    from point_cloud_viewer_tpu_torch.query.location import location_for
    from point_cloud_viewer_tpu_torch.query.point_query import PointQuery
    from point_cloud_viewer_tpu_torch.s2_cells.cell_union import CellUnion

    dev = torch.device(DEVICE)
    t_phase = t0 = time.perf_counter()
    ecef = query_cloud(QUERY_POINTS, seed=10)
    ply = os.path.join(tmp, "site.ply")
    write_ply_points(ply, ecef, np.random.default_rng(11))
    octree = os.path.join(tmp, "site")
    gen_s = time.perf_counter() - t0
    for w in wrappers.values():
        w.launches = 0
    phases = {}
    t0 = time.perf_counter()
    out = run_cli([ply, "--output_directory", octree, "--resolution",
                   str(QUERY_RESOLUTION)], phases)
    build_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    check_build_launches("query cloud build", launches, 1)
    os.remove(ply)
    level12 = len(np.unique(s2.parent(
        s2.leaf_cell_ids_from_points(ecef[::1000]), 12)))
    queries = query_set(ecef)
    log(f"query: {QUERY_POINTS} points over a {QUERY_EDGE:.0f} m site at "
        f"{QUERY_SITE} (made and written in {gen_s:.3f} s; {level12} "
        f"level-12 S2 cells); cli.build_octree on the card at "
        f"{QUERY_RESOLUTION} m {build_s:.3f} s, launches "
        f"{json.dumps(launches)}; cli said: {out.strip().splitlines()[0]}")
    del ecef

    for w in wrappers.values():
        w.launches = 0
    attrs = ["--attributes", "color", "intensity"]
    for name, flags, location, intervals in queries:
        line = [f"query {name}:"]
        if flags is not None:
            card_n, card_s = run_query_cli([octree, *flags, *attrs])
            host_n, host_s = run_query_cli([octree, *flags, *attrs,
                                            "--no-device_filter"])
            if card_n != host_n:
                raise AssertionError(f"query {name}: the CLI streamed "
                                     f"{card_n} points on the card, "
                                     f"{host_n} on the host")
            line.append(f"cli {card_n} points, card {card_s:.3f} s, host "
                        f"{host_s:.3f} s;")
        query = PointQuery(attributes=["color", "intensity"],
                           location=location, filter_intervals=intervals)
        card = PointCloudClient.from_locations([octree])
        got, card_s = stream_sorted(card, query)
        want, host_s = stream_sorted(PointCloudClient.from_locations(
            [octree], device_filter=False), query)
        if got.shape != want.shape or got.tobytes() != want.tobytes():
            raise AssertionError(f"query {name}: the card's stream differs "
                                 f"from the host's ({len(got)} vs "
                                 f"{len(want)} points)")
        if not 0 < len(got) < QUERY_POINTS:
            raise AssertionError(f"query {name}: {len(got)} points")
        stats = card.filter_stats
        line.append(
            f"stream {len(got)} points == host, byte-equal; card "
            f"{card_s:.3f} s, host {host_s:.3f} s; filtered on the card "
            f"{stats.rows} rows, band {stats.uncertain}, host recomputed "
            f"{stats.refined}")
        if name == "web_mercator":
            on_card = torch.empty(0, device=dev).device  # with its index
            line[-1] += (f"; delta {_calibrated_delta(on_card, fused=True)!r}"
                         f" (K8's projection)")
        log(" ".join(line))
    launches = {k: w.launches for k, w in wrappers.items()}
    if any(launches.values()):
        raise AssertionError(f"query: kernels launched on the query path "
                             f"{launches}")
    shutil.rmtree(octree)

    by_name = {name: location for name, _, location, _ in queries}
    for name, make in (("obb", testing.obb_face_points),
                       ("frustum", testing.frustum_plane_points)):
        loc = location_for(by_name[name])
        pts = make(loc.geometry, QUERY_FACE_POINTS, seed=12)
        host = loc.contains(pts)
        stats = DF.FilterStats()
        t0 = time.perf_counter()
        card = DF.point_filter_mask(loc, pts, device=dev, stats=stats)
        card_s = time.perf_counter() - t0
        cpu = DF.point_filter_mask(loc, pts, device="cpu")
        if not (np.array_equal(card, host) and np.array_equal(cpu, host)):
            raise AssertionError(f"query {name} faces: card or CPU route "
                                 f"differs from the host")
        log(f"query {name} faces: {len(pts)} points, {int(host.sum())} in; "
            f"card == CPU route == host; band {stats.uncertain} rows; card "
            f"{card_s:.3f} s")
    pts = testing.s2_face_points(QUERY_FACE_POINTS, seed=13)
    host = s2.leaf_cell_ids_from_points(pts)
    ids = {d: s2_device.leaf_ids(torch.from_numpy(pts).to(d)).cpu().numpy()
           .view(np.uint64) for d in (dev, torch.device("cpu"))}
    union = CellUnion([int(c) for c in s2.parent(host[::4096], 9)])
    want = union.contains(pts)
    masks = {d: DF.point_filter_mask(union, pts, device=d)
             for d in (dev, torch.device("cpu"))}
    bad = [f"{what} on {d.type}: {int(np.count_nonzero(got != ref))} rows"
           for what, by_device, ref in (("leaf ids", ids, host),
                                        ("union mask", masks, want))
           for d, got in by_device.items() if not np.array_equal(got, ref)]
    if bad:
        raise AssertionError("query S2: differs from the host: "
                             + "; ".join(bad))
    log(f"query S2: {len(pts)} points on all six faces ({int((host >> np.uint64(63)).sum())} "
        f"ids with bit 63 set, {int(want.sum())} in a {len(union)}-cell "
        f"union); leaf ids and union masks card == CPU route == host")
    log(f"query: phase 10 took {time.perf_counter() - t_phase:.3f} s")


def phase_query_mask() -> dict:
    """10c: K8 (csrc/query_mask.cu) on one QUERY_MASK_ROWS node of each
    region, without and with two intervals (testing.query_mask_case), then
    on a node as stored (node_decode_readings):
    point_filter_mask bit-equal to the host; CUDA-event medians of the
    entry's round trip (pinned H2D, the kernel, D2H, on its own stream) and
    of the kernel alone (pcv_query_mask_launch on the uploaded node); host
    ms of point_filter_mask (K8 and the host refinement) and of the eager
    route's classes on the card, which K8 replaced; bytes a launch and the
    kernel over its bound at 3.35 TB/s.  -> {case: readings}."""
    import torch

    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.math.web_mercator_device import (
        _calibrated_delta)
    from point_cloud_viewer_tpu_torch.ops import _ext
    from point_cloud_viewer_tpu_torch.query import device_filter as DF

    dev = torch.empty(0, device=DEVICE).device  # with its index
    n = QUERY_MASK_ROWS
    out = {}
    for kind in testing.QUERY_MASK_KINDS:
        for with_intervals in (False, True):
            loc, pts, intervals, attrs = testing.query_mask_case(
                kind, n, seed=23, with_intervals=with_intervals)
            want = testing.query_mask_host(loc, pts, intervals, attrs)
            got = DF.point_filter_mask(loc, pts, intervals, attrs, device=dev)
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"K8 {kind}: {int(np.count_nonzero(got != want))} rows "
                    f"differ from the host")
            names = sorted(intervals)
            k = len(names)
            g = loc.geometry
            delta = (_calibrated_delta(dev, fused=True)
                     if kind == "web_mercator" else 0.0)
            params = DF._k8_params(
                type(g), g, [intervals[m].lower_bound for m in names],
                [intervals[m].upper_bound for m in names], delta)
            st = DF._take_staging(dev)
            st.reserve((3 + k) * n, n)
            host = st.host_in.numpy()
            host[:3 * n] = pts.ravel()
            for i, m in enumerate(names):
                host[(3 + i) * n:(4 + i) * n] = attrs[m]
            code = DF._K8_KIND[type(g)]
            lib = _ext.lib()

            def entry():
                _ext.check(lib.pcv_query_mask(
                    code, params.ctypes.data, k, n, st.host_in.data_ptr(),
                    st.dev_in.data_ptr(), st.dev_codes.data_ptr(),
                    st.host_codes.data_ptr(), st.stream_ptr()),
                    "pcv_query_mask")

            def kernel():
                _ext.check(lib.pcv_query_mask_launch(
                    code, params.ctypes.data, k, n, st.dev_in.data_ptr(),
                    st.dev_codes.data_ptr(), st.stream_ptr()),
                    "pcv_query_mask_launch")

            with torch.cuda.device(dev), torch.cuda.stream(st.stream):
                entry_ms = cuda_ms(entry)
                kernel_ms = cuda_ms(kernel)
            DF._give_staging(st)
            times = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                DF.point_filter_mask(loc, pts, intervals, attrs, device=dev)
                times.append((time.perf_counter() - t0) * 1e3)
            eager = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                DF._eager_classes(type(g), loc, g, pts, names, intervals,
                                  attrs, dev)
                eager.append((time.perf_counter() - t0) * 1e3)
            nbytes = (24 + 8 * k + 1) * n
            bound_ms = nbytes / 3.35e12 * 1e3
            name = f"{kind}{'+2 intervals' if k else ''}"
            out[name] = {"bytes": nbytes, "bound_ms": bound_ms,
                         "kernel_ms": kernel_ms, "entry_ms": entry_ms,
                         "mask_ms": statistics.median(times),
                         "eager_ms": statistics.median(eager)}
            log(f"K8 {name}: {n} rows == host; {nbytes} B a launch, bound "
                f"{bound_ms:.6f} ms at 3.35 TB/s; kernel {kernel_ms:.4f} ms "
                f"({kernel_ms / bound_ms:.2f}x the bound); entry round trip "
                f"{entry_ms:.4f} ms; point_filter_mask {out[name]['mask_ms']:.3f}"
                f" ms; the eager route's classes on the card "
                f"{out[name]['eager_ms']:.3f} ms")
    for encoding in ("u16", "f32"):
        for kept in (0.01, 0.5):  # the interval keeps 0.8 of the box's rows
            name = f"as stored {encoding}, {kept:.0%} kept"
            out[name] = node_decode_readings(dev, encoding, kept / 0.8, n)
    return out


def node_decode_readings(dev, encoding: str, share: float, n: int) -> dict:
    """10c, K8 on a node as stored (pcv_query_decode_mask): n random rows
    in `encoding` (u16 or f32) and an f32 intensity, written as node files
    (testing.query_decode_node), a box over `share` of the node's x and an
    intensity interval.  NodeDecode's batch equal to the host's
    read_node_batch, masks and retain; CUDA-event medians of the round
    trip (pinned H2D of the stored bytes, the kernel, the count, the kept
    rows) and of the kernel alone; host ms of a node by NodeDecode (its
    read, the round trip, the gather) and by the host's decode and K8's
    f64 entry, which it replaces; bytes over the card's memory and the
    kernel over its bound at 3.35 TB/s."""
    import tempfile

    import torch

    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.ops import _ext
    from point_cloud_viewer_tpu_torch.query import device_filter as DF

    tmp = tempfile.TemporaryDirectory()
    cloud, query = testing.query_decode_node(tmp.name, encoding, n, seed=31,
                                             share=share)
    meta = cloud.node_meta("r")
    enc = meta.position_encoding
    route = DF.NodeDecode(query, [], dev)

    def host_route():
        return testing.query_decode_node_host(cloud, query, dev)

    got, want = route.node_points(cloud, "r"), host_route()
    if not (got.position.tobytes() == want.position.tobytes()
            and all(got.attributes[a].tobytes() == want.attributes[a].tobytes()
                    for a in want.attributes)):
        raise AssertionError(f"K8 as stored ({encoding}): the kept rows "
                             f"differ from the host's")
    kept = len(got)
    plan = DF._CloudPlan(cloud, route.names, route.rest)
    st = DF._take_staging(dev)
    node = route._read(cloud, "r", plan, st)
    route._round_trip(node, plan, st)  # fills st.node_args
    in_bytes = DF._aligned(node.offsets[1] + node.sizes[1])
    fma = int(DF._host_decode_fused(enc, n))
    args = st.node_args.ctypes.data
    lib = _ext.lib()

    def kernel():
        _ext.check(lib.pcv_query_decode_launch(
            0, route.params_ptr, 1, int(enc), fma, args, args + 32, n,
            st.dev_node.data_ptr(), st.dev_kept.data_ptr(),
            st.scratch.data_ptr(), st.stream_ptr()),
            "pcv_query_decode_launch")

    with torch.cuda.device(dev), torch.cuda.stream(st.stream):
        entry_ms = cuda_ms(lambda: route._round_trip(node, plan, st))
        kernel_ms = cuda_ms(kernel)
    DF._give_staging(st)
    times = {"node_ms": [], "host_route_ms": []}
    for _ in range(REPS):
        for key, fn in (("node_ms", lambda: route.node_points(cloud, "r")),
                        ("host_route_ms", host_route)):
            t0 = time.perf_counter()
            fn()
            times[key].append((time.perf_counter() - t0) * 1e3)
    nbytes = in_bytes + 8 + 29 * kept
    bound_ms = nbytes / 3.35e12 * 1e3
    r = {"rows": n, "kept": kept, "bytes": nbytes, "bound_ms": bound_ms,
         "kernel_ms": kernel_ms, "entry_ms": entry_ms,
         "node_ms": statistics.median(times["node_ms"]),
         "host_route_ms": statistics.median(times["host_route_ms"])}
    tmp.cleanup()
    log(f"K8 as stored {encoding}, {kept} of {n} rows kept == host; {nbytes} "
        f"B over the card's memory ({in_bytes} up), bound "
        f"{bound_ms:.6f} ms at 3.35 TB/s; kernel {kernel_ms:.4f} ms "
        f"({kernel_ms / bound_ms:.2f}x the bound); round trip "
        f"{entry_ms:.4f} ms; a node by NodeDecode {r['node_ms']:.3f} ms, "
        f"by the host's decode and K8's f64 entry {r['host_route_ms']:.3f} ms")
    return r


# --- phase 11: the x-ray quadtree path -----------------------------------


def run_xray_cli(name: str, args: list, wrappers: dict, what: str) -> tuple:
    """The port's cli.<name> main on args, the launch counters set to 0
    just before -> (what it printed, wall s, the build's stats).  Raises
    when it fails or when a kernel of K1-K7 was launched."""
    cli = importlib.import_module(f"point_cloud_viewer_tpu_torch.cli.{name}")
    for w in wrappers.values():
        w.launches = 0
    stats = {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = (cli.main(args, stats=stats) if name == "build_xray_quadtree"
              else cli.main(args))
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"xray {what}: cli.{name} {args} returned {rc}: "
                             f"{buf.getvalue()}")
    launched = {k: w.launches for k, w in wrappers.items() if w.launches}
    if launched:
        raise AssertionError(f"xray {what}: cli.{name} launched kernels of "
                             f"K1-K7 {launched}")
    return buf.getvalue(), wall, stats


def xray_build(octree_dir: str, out: str, kind: str, flags: list,
               wrappers: dict, what: str, host: bool = False) -> dict:
    """cli.build_xray_quadtree of `kind` over octree_dir on DEVICE (the
    CLI's defaults: splat and filter there), or by the host route
    (--no-use_device --no-device_filter) -> its stats and wall ("wall")."""
    route = (["--no-use_device", "--no-device_filter"] if host else
             ["--device", DEVICE])
    said, wall, stats = run_xray_cli("build_xray_quadtree", [
        octree_dir, "--output_directory", out, "--coloring_strategy", kind,
        "--tile_size", str(XRAY_TILE), "--resolution", str(XRAY_RESOLUTION),
        *flags, *route], wrappers, what)
    if f"with {stats['tiles']} tiles" not in said:
        raise AssertionError(f"xray {what}: cli said {said!r}, stats "
                             f"{stats}")
    return dict(stats, wall=wall)


def decode_tiles(directory: str) -> dict:
    """{file name: (size, size, 4) u8 array} of every PNG in directory,
    decoded with PIL; raises naming the tile that does not decode."""
    from PIL import Image

    tiles = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".png"):
            try:
                tiles[name] = np.asarray(Image.open(
                    os.path.join(directory, name)).convert("RGBA"))
            except Exception as e:  # noqa: BLE001 - re-raised with the tile
                raise AssertionError(f"{directory}/{name} does not decode: "
                                     f"{e}") from e
    return tiles


def xray_within_one(a: str, b: str, what: str) -> tuple:
    """Two builds of one quadtree: equal file sets and meta.pb, every tile's
    decoded pixels within 1 per channel -> (tiles, pixels that differ, the
    largest difference)."""
    from point_cloud_viewer_tpu_torch import testing

    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    if fa != fb:
        raise AssertionError(f"xray {what}: file sets differ: {len(fa)} vs "
                             f"{len(fb)} ({sorted(set(fa) ^ set(fb))[:5]})")
    with open(os.path.join(a, "meta.pb"), "rb") as f:
        meta = f.read()
    with open(os.path.join(b, "meta.pb"), "rb") as f:
        if f.read() != meta:
            raise AssertionError(f"xray {what}: meta.pb differs")
    ta, tb = decode_tiles(a), decode_tiles(b)
    pixels = most = 0
    for name, img in ta.items():
        n, m = testing.image_difference(img, tb[name])
        if m > 1:
            raise AssertionError(f"xray {what}: tile {name} differs by {m} "
                                 f"in a channel ({n} pixels)")
        pixels += n
        most = max(most, m)
    return len(ta), pixels, most


def xray_line(s: dict) -> str:
    return (f"{s['wall']:.3f} s ({s['leaf_tiles']} leaf tiles, {s['tiles']} "
            f"tiles, {s['points']} points splatted; leaves "
            f"{s['leaves_s']:.3f} s, pyramid {s['pyramid_s']:.3f} s)")


def phase_xray(wrappers: dict, tmp: str, octree_dir: str) -> str:
    """11: the x-ray quadtree path on phase 5's in-core octree (16M points;
    a 200 x 200 x 40 m box and its clusters) at XRAY_TILE px tiles of
    XRAY_RESOLUTION m a pixel: the cloud fits 16 x 16 tiles of 12.8 m, so
    256 leaf tiles at level 4, every one holding points, 341 tiles with the
    pyramid.  The reference's default pixel, 0.01 m, gives 16,384 leaf
    tiles at level 7; the depth is cut for the smoke's time limit only.
    a. Each of XRAY_STRATEGIES through cli.build_xray_quadtree on the card
       (its defaults: splat and filter on the card) and by its host route
       (--no-use_device --no-device_filter): xray, colored and
       colored_with_intensity byte-equal; colored_with_height_stddev (full
       f64 heights, summed in no fixed order on the card) with equal file
       sets and meta.pb and every pixel within 1 per channel, the pixels
       that differ counted.
    b. colored binned by XRAY_BINNING, card against host, byte-equal.
    c. HeightStddevStrategy on XRAY_HEIGHT_POINTS synthetic points whose z
       lies on a 1/64 m step (the exactness condition), card against the
       numpy route at XRAY_TILE px, byte-equal; with z off any step,
       within 1.
    d. The four reductions on the card against their CPU route at
       XRAY_SPLAT_POINTS points at XRAY_TILE and 1448 px and on the empty
       input, bit for bit under the condition; 1449 px refused on both.
    e. Partial builds of the four level-1 quadrants (--root_node_id) on
       the card, merged by cli.merge_xray_quadtrees: the full build's node
       set.
    f. cli.upgrade_xray_quadtree on the full build (at version 3: left as
       is) and on a copy whose meta.pb is at version 2 (rewritten to the
       full build's bytes); cli.inpaint_xray_quadtree on the full build
       (its white background leaves no holes, so this runs the stitching,
       seams and pyramid over every leaf) and on a partial build of the
       level-3 subtree XRAY_INPAINT_ROOT (4 leaf tiles) built and
       inpainted with a transparent background, whose holes it fills: the
       fewer transparent leaf pixels after.  The numpy inpaint takes
       seconds a 512 px stitched tile with holes, too long for the full
       build's 256 leaves within the smoke's time limit.  Every tile
       written decodes.
    Every x-ray CLI runs with the launch counters set to 0 and launches
    none of K1-K7.  Walls, tiles written and points splatted of every
    build.  Removes its files."""
    import torch

    from point_cloud_viewer_tpu_torch import testing
    from point_cloud_viewer_tpu_torch.protos.xray_meta import XrayMetaProto
    from point_cloud_viewer_tpu_torch.xray import device_splat as DS
    from point_cloud_viewer_tpu_torch.xray.meta import XrayMeta

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "xray")
    full = os.path.join(root, "card_xray")
    for kind, flags in XRAY_STRATEGIES + (
            ("colored", ["--binning", XRAY_BINNING]),):
        label = kind + (" binned" if "--binning" in flags else "")
        tag = label.replace(" ", "_")
        card_dir = os.path.join(root, f"card_{tag}")
        host_dir = os.path.join(root, f"host_{tag}")
        card = xray_build(octree_dir, card_dir, kind, flags, wrappers,
                          f"{label} on the card")
        host = xray_build(octree_dir, host_dir, kind, flags, wrappers,
                          f"{label} by the host route", host=True)
        if card["points"] != host["points"]:
            raise AssertionError(f"xray {label}: {card['points']} points "
                                 f"splatted on the card, {host['points']} "
                                 f"by the host route")
        if kind == "colored_with_height_stddev":
            tiles, pixels, most = xray_within_one(card_dir, host_dir, label)
            same = (f"{tiles} tiles decoded, meta.pb equal, {pixels} pixels "
                    f"differ, by at most {most} (full-f64 heights)")
        else:
            try:
                same = f"{dirs_byte_equal(card_dir, host_dir)} files " \
                       "byte-equal"
            except AssertionError as e:
                raise AssertionError(f"xray {label}: card vs host route: "
                                     f"{e}") from e
        log(f"xray {label}: card {xray_line(card)}; host route "
            f"{xray_line(host)}; card/host {card['wall'] / host['wall']:.3f}"
            f"; {same}")
        shutil.rmtree(host_dir)
        if card_dir != full:
            shutil.rmtree(card_dir)
    if len(decode_tiles(full)) != len(XrayMeta.from_directory(full).nodes):
        raise AssertionError("xray: the full build's tiles and meta differ")

    # c. The exactness condition for heights: z on a 1/64 m step.
    kwargs = {"max_stddev": 0.5}
    for step in (1.0 / 64.0, None):
        batches = [testing.xray_points(XRAY_HEIGHT_POINTS // 2, seed, step)
                   for seed in (31, 32)]
        t0 = time.perf_counter()
        card = testing.xray_render("colored_with_height_stddev", kwargs,
                                   batches, XRAY_TILE, dev)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = testing.xray_render("colored_with_height_stddev", kwargs,
                                   batches, XRAY_TILE, None)
        host_s = time.perf_counter() - t0
        pixels, most = testing.image_difference(card, want)
        if step is not None and card.tobytes() != want.tobytes():
            raise AssertionError(f"xray heights on a 1/64 m step: the card's "
                                 f"tile differs from the numpy route's in "
                                 f"{pixels} pixels, by up to {most}")
        if most > 1:
            raise AssertionError(f"xray full-f64 heights: {pixels} pixels "
                                 f"differ, by up to {most}")
        log(f"xray heights {'on a 1/64 m step' if step else 'in full f64'}: "
            f"{XRAY_HEIGHT_POINTS} points at {XRAY_TILE} px, card "
            f"{card_s:.3f} s, numpy route {host_s:.3f} s; "
            + ("byte-equal" if step else
               f"{pixels} pixels differ, by at most {most}"))

    # d. The four reductions, card against CPU route.
    for n, size in ((XRAY_SPLAT_POINTS, XRAY_TILE), (XRAY_SPLAT_POINTS, 1448),
                    (0, XRAY_TILE), (0, 1448)):
        inputs = testing.xray_splat_inputs(n, size, seed=33)
        testing.xray_splat_outputs(inputs, size, dev)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = testing.xray_splat_outputs(inputs, size, dev)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = testing.xray_splat_outputs(inputs, size, "cpu")
        cpu_s = time.perf_counter() - t0
        differ = testing.xray_splat_differences(got, want)
        if differ:
            raise AssertionError(f"xray reductions at n={n}, {size} px: the "
                                 f"card differs from the CPU route in "
                                 f"{differ}")
        log(f"xray reductions: n={n} at {size} px, card == CPU route bit "
            f"for bit (the four, the moments of heights and of intensities; "
            f"wall of all five calls, host clock with upload and fetch: "
            f"card {card_s:.3f} s, CPU {cpu_s:.3f} s)")
        del inputs, got, want
    for d in (dev, "cpu"):
        try:
            DS.xray_occupancy_device(np.array([7]), 1449, d)
        except ValueError:
            continue
        raise AssertionError(f"xray: occupancy at 1449 px not refused on {d}")

    # e. Partial builds of the four level-1 quadrants, merged.
    parts = []
    t0 = time.perf_counter()
    points = 0
    for q in range(4):
        parts.append(os.path.join(root, f"part{q}"))
        s = xray_build(octree_dir, parts[-1], "xray",
                       ["--root_node_id", f"r{q}"], wrappers,
                       f"partial build r{q}")
        points += s["points"]
    parts_s = time.perf_counter() - t0
    merged = os.path.join(root, "merged")
    said, merge_s, _ = run_xray_cli("merge_xray_quadtrees",
                                    [*parts, "--output_directory", merged],
                                    wrappers, "merge")
    want = XrayMeta.from_directory(full).nodes
    got = XrayMeta.from_directory(merged).nodes
    if got != want:
        raise AssertionError(f"xray merge: {len(got)} nodes, the full build "
                             f"{len(want)} ({len(got ^ want)} differ)")
    tiles = decode_tiles(merged)
    equal = sum(1 for name, img in decode_tiles(full).items()
                if name in tiles and img.tobytes() == tiles[name].tobytes())
    log(f"xray merge: four level-1 partial builds on the card "
        f"{parts_s:.3f} s ({points} points splatted), "
        f"cli.merge_xray_quadtrees {merge_s:.3f} s: {len(got)} nodes == the "
        f"full build's; {len(tiles)} tiles decode, {equal} of them "
        f"pixel-equal to the full build's; said "
        f"{said.strip().splitlines()[-1]!r}")
    for d in parts + [merged]:
        shutil.rmtree(d)

    # f. Upgrade and inpaint.
    with open(os.path.join(full, "meta.pb"), "rb") as f:
        meta_v3 = f.read()
    said, up_s, _ = run_xray_cli("upgrade_xray_quadtree", [full], wrappers,
                                 "upgrade at version 3")
    with open(os.path.join(full, "meta.pb"), "rb") as f:
        if f.read() != meta_v3 or "already at version 3" not in said:
            raise AssertionError(f"xray upgrade: a version 3 meta.pb was "
                                 f"changed: {said}")
    old = os.path.join(root, "v2")
    os.makedirs(old)
    proto = XrayMetaProto.decode(meta_v3)
    proto.version = 2
    with open(os.path.join(old, "meta.pb"), "wb") as f:
        f.write(proto.encode())
    said2, up2_s, _ = run_xray_cli("upgrade_xray_quadtree", [old], wrappers,
                                   "upgrade from version 2")
    with open(os.path.join(old, "meta.pb"), "rb") as f:
        if f.read() != meta_v3:
            raise AssertionError(f"xray upgrade: version 2 -> 3 did not give "
                                 f"the full build's meta.pb: {said2}")
    painted = os.path.join(root, "inpainted")
    said3, paint_s, _ = run_xray_cli(
        "inpaint_xray_quadtree", [full, "--output_directory", painted],
        wrappers, "inpaint of the full build")
    tiles = decode_tiles(painted)
    if len(tiles) != len(XrayMeta.from_directory(full).nodes):
        raise AssertionError(f"xray inpaint: {len(tiles)} tiles decode, the "
                             f"full build has "
                             f"{len(XrayMeta.from_directory(full).nodes)}")
    shutil.rmtree(painted)
    # A subtree built and inpainted with a transparent background keeps its
    # holes until the inpaint fills them (a white one leaves none).
    clear = ["--tile_background_color", "0,0,0,0"]
    sub = os.path.join(root, "sub")
    s = xray_build(octree_dir, sub, "colored",
                   ["--root_node_id", XRAY_INPAINT_ROOT, *clear], wrappers,
                   f"partial build {XRAY_INPAINT_ROOT}")
    said4, sub_s, _ = run_xray_cli(
        "inpaint_xray_quadtree",
        [sub, "--output_directory", painted, "--root_node_id",
         XRAY_INPAINT_ROOT, *clear], wrappers, "inpaint of a subtree")
    before, after = decode_tiles(sub), decode_tiles(painted)
    deepest = XrayMeta.from_directory(
        sub, f"meta{XRAY_INPAINT_ROOT[1:]}.pb").deepest_level
    holes = [sum(int((t[:, :, 3] < 128).sum()) for name, t in d.items()
                 if len(name) == len("r.png") + deepest)
             for d in (before, after)]
    if sorted(before) != sorted(after) or not holes[1] < holes[0]:
        raise AssertionError(f"xray inpaint of {XRAY_INPAINT_ROOT}: "
                             f"{len(after)} tiles written of {len(before)}; "
                             f"leaf pixels transparent before and after "
                             f"{holes}")
    log(f"xray upgrade: version 3 left as is ({up_s:.3f} s), version 2 "
        f"rewritten to the full build's meta.pb ({up2_s:.3f} s); inpaint of "
        f"the full build {paint_s:.3f} s, {len(tiles)} tiles decode "
        f"(white background: no holes left); partial build "
        f"{XRAY_INPAINT_ROOT} with a transparent background on the card "
        f"{xray_line(s)}, inpainted in {sub_s:.3f} s: {len(after)} tiles "
        f"decode, transparent leaf pixels {holes[0]} -> {holes[1]}; said "
        f"{said4.strip().splitlines()[-1]!r}")
    served = os.path.join(tmp, "xray_served")
    os.replace(full, served)
    shutil.rmtree(root)
    log(f"xray: phase 11 took {time.perf_counter() - t_phase:.3f} s")
    return served


# --- phase 12: the multi-device build ----------------------------------------


def morton_decode_device(codes):
    """int64 Morton codes -> (N, 3) int32 cells (x msb) on their device:
    the inverse of ops/morton._spread3_device, to make cells from phase
    4's synthetic codes."""
    import torch

    def compact(v):
        v = v & 0x1249249249249249
        for shift, mask in ((2, 0x10C30C30C30C30C3), (4, 0x100F00F00F00F00F),
                            (8, 0x1F0000FF0000FF), (16, 0x1F00000000FFFF),
                            (32, 0x1FFFFF)):
            v = (v | (v >> shift)) & mask
        return v

    return torch.stack([compact(codes >> 2), compact(codes >> 1),
                        compact(codes)], dim=1).to(torch.int32)


def t_norm_numpy(cells: np.ndarray, order: np.ndarray,
                 final: np.ndarray) -> np.ndarray:
    """build_tree_device's t_norm recomputed with numpy from the cells and
    the final levels: (low s bits + 0.5) / 2^s in f32, s = depth - level."""
    c = cells[order].astype(np.int64)
    s = (DEPTH - final.astype(np.int64))[:, None]
    return ((c & ((1 << s) - 1)).astype(np.float32) + np.float32(0.5)) / (
        (1 << s).astype(np.float32))


def phase_mesh_core() -> np.ndarray:
    """12a: build_tree_device (the full device core from cells) on the
    cells of phase 4's codes: at CORE_SIZES[0] order, final and leaf equal
    build_tree_device_codes on the card and t_norm a numpy recomputation,
    bit for bit; at MESH_CORE_CHECK points the whole result equals its CPU
    route; CUDA-event medians of 3 and the Morton encode's share.  Returns
    the CORE_SIZES[0] cells (host u32) for 12b."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import morton
    from point_cloud_viewer_tpu_torch.ops import tree_build as tb

    kept = None
    for n in CORE_SIZES:
        on_card = morton.codes_to_tensor(synthetic_codes(n, seed=n + 1),
                                         DEVICE)
        cells = morton_decode_device(on_card)
        if not torch.equal(morton.morton_encode_device(cells, DEPTH),
                           on_card):
            raise AssertionError(f"mesh core n={n}: decoded cells do not "
                                 "encode back to the codes")
        core_ms = cuda_ms(lambda: tb.build_tree_device(cells, DEPTH, DEPTH),
                          reps=3)
        encode_ms = cuda_ms(lambda: morton.morton_encode_device(cells, DEPTH),
                            reps=3)
        log(f"mesh core n={n}: build_tree_device {core_ms:.4f} ms = "
            f"{n / core_ms / 1e3:.3f} Mpts/s (cells resident; CUDA events, "
            f"median of 3); Morton encode {encode_ms:.4f} ms = "
            f"{encode_ms / core_ms:.4f} of it")
        if n == CORE_SIZES[0]:
            out = tb.build_tree_device(cells, DEPTH, DEPTH)
            order, final, leaf = tb.build_tree_device_codes(on_card, DEPTH,
                                                            DEPTH)
            host_cells = cells.cpu().numpy()
            checks = {
                "codes": torch.equal(out.codes, torch.sort(on_card).values),
                "order": torch.equal(out.order, order.long()),
                "final": torch.equal(out.final_level, final),
                "leaf": torch.equal(out.leaf_level, leaf),
                "t_norm": np.array_equal(
                    out.t_norm.cpu().numpy().view(np.uint32),
                    t_norm_numpy(host_cells, out.order.cpu().numpy(),
                                 out.final_level.cpu().numpy()).view(
                                     np.uint32)),
            }
            log(f"mesh core n={n}: against build_tree_device_codes on the "
                f"card and numpy's t_norm {checks}")
            if not all(checks.values()):
                raise AssertionError(f"mesh core n={n}: {checks}")
            kept = host_cells.view(np.uint32)
            small = cells[:MESH_CORE_CHECK]
            got = tb.build_tree_device(small, DEPTH, DEPTH)
            t0 = time.perf_counter()
            want = tb.build_tree_device(small.cpu(), DEPTH, DEPTH)
            cpu_s = time.perf_counter() - t0
            checks = {name: torch.equal(g.cpu(), w) for name, g, w in
                      zip(tb.DeviceTreeResult._fields, got, want)}
            log(f"mesh core n={MESH_CORE_CHECK}: card vs CPU route {checks} "
                f"(CPU route {cpu_s:.3f} s)")
            if not all(checks.values()):
                raise AssertionError(f"mesh core: card differs from CPU: "
                                     f"{checks}")
            del out, order, final, leaf, got, want, small
        del on_card, cells
        torch.cuda.empty_cache()
    return kept


def phase_mesh_sort(mesh, cells16: np.ndarray) -> None:
    """12b: the exact sharded sort on the mesh: the dry run's skewed cloud
    at capacity factor 1.0 retries at least once; phase 4's 16M cells equal
    the host's stable sort in codes and order."""
    from point_cloud_viewer_tpu_torch.ops import morton
    from point_cloud_viewer_tpu_torch.parallel.sharded_build import (
        sharded_morton_sort,
    )

    rng = np.random.default_rng(11)
    pos = rng.random((MESH_SKEW, 3)) * 100.0
    pos[: int(MESH_SKEW * 0.4)] *= 0.01
    pos = pos[rng.permutation(MESH_SKEW)]
    cells = morton.quantize(pos, np.zeros(3), 100.0, DEPTH)
    stats = {}
    codes, order = sharded_morton_sort(cells, mesh, DEPTH,
                                       capacity_factor=1.0, stats=stats)
    host_codes = morton.morton_encode(cells)
    host_order = np.argsort(host_codes, kind="stable")
    if not (np.array_equal(codes, host_codes[host_order])
            and np.array_equal(order, host_order)) or stats["attempts"] < 2:
        raise AssertionError(f"mesh sort: skewed cloud {stats}")
    t0 = time.perf_counter()
    codes, order = sharded_morton_sort(cells16, mesh, DEPTH)
    wall = time.perf_counter() - t0
    host_codes, host_order = morton.argsort_codes(
        morton.morton_encode(cells16))
    equal = (np.array_equal(codes, host_codes)
             and np.array_equal(order, host_order))
    log(f"mesh sort: skewed {MESH_SKEW} points at capacity factor 1.0 "
        f"{stats}; {len(cells16)} cells on "
        f"{len(mesh)} shards {wall:.3f} s with upload and fetch, == the "
        f"host's stable sort: {equal}")
    if not equal:
        raise AssertionError("mesh sort: 16M cells differ from the host sort")


def check_mesh_launches(where: str, launches: dict, shards: int) -> None:
    """The mesh build launched K6's and K4's stages once a shard and
    nothing else (no extras scan: the shards' levels come back whole)."""
    want = {k: 0 for k in launches}
    want.update({"K4": shards, "K6": shards})
    if launches != want:
        raise AssertionError(f"{where}: launches {launches}, want {want}")


def phase_mesh(wrappers: dict, tmp: str, ply16: str, incore16: str,
               incore_phases: dict, deep_dir: str) -> dict:
    """12: the multi-device build on MESH_SHARDS shards sharing the card
    (12a the device core, 12b the sharded sort, 12c phase 5's 16M cloud
    with a mesh and through cli.build_octree --mesh 1, 12d
    entry.dryrun_multichip, 12e phase 9's deep cloud on DEEP_MESH_SHARDS
    shards), each byte- or bit-equal to its single-device counterpart.
    Returns the 12c mesh build's launch counts."""
    import torch

    from point_cloud_viewer_tpu_torch import entry
    from point_cloud_viewer_tpu_torch.io.ply import PlyReader
    from point_cloud_viewer_tpu_torch.math.geometry import Aabb
    from point_cloud_viewer_tpu_torch.octree import builder as B
    from point_cloud_viewer_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    card = torch.device(DEVICE)
    mesh = make_mesh(devices=[card] * MESH_SHARDS)
    cells16 = phase_mesh_core()
    phase_mesh_sort(mesh, cells16)
    del cells16

    batch = PlyReader(ply16).read_all()
    for w in wrappers.values():
        w.launches = 0
    phases = {}
    out = os.path.join(tmp, "mesh16")
    t0 = time.perf_counter()
    result = B.build_octree(out, 0.001, batch, mesh=mesh, phase_times=phases)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    files = dirs_byte_equal(incore16, out)
    log(f"mesh build ({MESH_SHARDS} shards on {card}): wall {wall:.3f} s; "
        f"phases (s) {json.dumps(phases)} beside phase 5's "
        f"{json.dumps(incore_phases)}; points a shard {result.shard_points};"
        f" {len(result.nodes)} nodes; == phase 5's in-core build, {files} "
        f"files byte-equal; launches {json.dumps(launches)}")
    if sum(result.shard_points) != len(batch):
        raise AssertionError(f"mesh build: points a shard "
                             f"{result.shard_points}")
    check_mesh_launches("mesh build", launches, MESH_SHARDS)
    shutil.rmtree(out)
    del batch
    for w in wrappers.values():
        w.launches = 0
    cli_phases = {}
    t0 = time.perf_counter()
    said = run_cli([ply16, "--output_directory", out, "--mesh", "1",
                    "--device", DEVICE], cli_phases)
    cli_launches = {k: w.launches for k, w in wrappers.items()}
    files = dirs_byte_equal(incore16, out)
    log(f"mesh cli --mesh 1: wall {time.perf_counter() - t0:.3f} s; phases "
        f"(s) {json.dumps(cli_phases)}; == phase 5's build, {files} files "
        f"byte-equal; launches {json.dumps(cli_launches)}; cli said: "
        f"{said.strip().splitlines()[0]}")
    check_mesh_launches("mesh cli", cli_launches, 1)
    shutil.rmtree(out)
    os.remove(ply16)

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = entry.dryrun_multichip(MESH_SHARDS, device=DEVICE)
    log(f"mesh dry run: {time.perf_counter() - t0:.3f} s; "
        + buf.getvalue().strip())
    log(f"mesh dry run numbers: {json.dumps(summary)}")

    batch, _ = deep_cloud(seed=9)
    box = Aabb(np.zeros(3), np.full(3, PLANET))
    real = B._dispatch_deep_device
    placed = []

    def recording(batch_, run_order, *args, device=None, **kwargs):
        placed.append((len(run_order), device))
        return real(batch_, run_order, *args, device=device, **kwargs)

    deep_mesh = make_mesh(devices=[card] * DEEP_MESH_SHARDS)
    for w in wrappers.values():
        w.launches = 0
    deep_phases = {}
    out = os.path.join(tmp, "deep_mesh")
    B._dispatch_deep_device = recording
    try:
        t0 = time.perf_counter()
        B.build_octree(out, DEEP_RESOLUTION, batch, bounding_box=box,
                       mesh=deep_mesh, phase_times=deep_phases)
        wall = time.perf_counter() - t0
    finally:
        B._dispatch_deep_device = real
    deep_launches = {k: w.launches for k, w in wrappers.items()}
    files = dirs_byte_equal(deep_dir, out)
    fat = sorted((n for n, _ in placed), reverse=True)
    log(f"mesh deep ({DEEP_MESH_SHARDS} shards): wall {wall:.3f} s; phases "
        f"(s) {json.dumps(deep_phases)}; sub-builds placed "
        f"{[(n, str(d)) for n, d in placed]} (one dispatch checked, not "
        f"the placement); == phase 9's in-core card build, {files} files "
        f"byte-equal; launches "
        f"{json.dumps(deep_launches)}")
    if (fat != [DEEP_POINTS[0]] or [d for _, d in placed] != [card]
            or deep_phases["deep_device_subbuilds"] != 1):
        raise AssertionError(f"mesh deep: placed {placed}")
    check_deep_launches("mesh deep", deep_launches, 1)
    shutil.rmtree(out)
    shutil.rmtree(deep_dir)
    log(f"mesh: phase 12 took {time.perf_counter() - t_phase:.3f} s")
    return launches


# --- phase 13: the viewers beyond the headless loop and the web servers -----


def egl_library() -> tuple:
    """(whether libEGL.so.1 loads, what was found): the library the GL
    bootstrap (viewer/gl/api.py) loads, found without creating a context."""
    import ctypes
    import ctypes.util

    found = ctypes.util.find_library("EGL")
    try:
        ctypes.CDLL("libEGL.so.1")
    except OSError as e:
        return False, f"find_library('EGL') -> {found}; libEGL.so.1: {e}"
    return True, f"find_library('EGL') -> {found}; libEGL.so.1 loads"


def visible_list(session, matrix) -> list:
    """The node rows of one frame's visible set, in the order the viewer
    draws them (PointCloudRenderer._device_visible, uncapped)."""
    from point_cloud_viewer_tpu_torch.math.geometry import Frustum

    order, _, visible = session.step(Frustum.from_matrix4(matrix))
    return [int(i) for i in order[:int(visible.sum())]]


def occupancy_iou(a, b) -> float:
    """IoU of the 8x8 blocks that hold a pixel other than each frame's
    corner pixel (tests/test_gl_renderer.py:263-311)."""
    h, w = (a.shape[0] // 8) * 8, (a.shape[1] // 8) * 8

    def blocks(img):
        mask = np.any(img[:h, :w, :3] != img[0, 0, :3], axis=-1)
        return mask.reshape(h // 8, 8, w // 8, 8).any(axis=(1, 3))

    oa, ob = blocks(a), blocks(b)
    return float((oa & ob).sum() / max(1, (oa | ob).sum()))


def phase_gl(octree_dir: str, tmp: str) -> dict:
    """13a: where libEGL.so.1 loads, the GL context's strings, cli.view --gl
    on the card (K5 launches, a final frame that is not all background),
    then VIEW_MATRICES orbit views: the visible set from K5 on the card
    equals the CPU route's, and its first GL_DRAW_POINTS points drawn
    through PointsRendererGL match the software rasterizer by occupancy
    (IoU > 0.75).  Where the library is absent, says so with nvidia-smi's
    name and NVIDIA_DRIVER_CAPABILITIES.  Returns {"present", "launches"}."""
    from point_cloud_viewer_tpu_torch.cli.view import main as view_main
    from point_cloud_viewer_tpu_torch.octree.octree import Octree
    from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC
    from point_cloud_viewer_tpu_torch.ops.culling import DeviceCullSession
    from point_cloud_viewer_tpu_torch.viewer.software_raster import (
        rasterize_points)

    present, found = egl_library()
    if not present:
        log(f"viewers: no EGL library: {found}; nvidia-smi: {CARD}; "
            f"NVIDIA_DRIVER_CAPABILITIES="
            f"{os.environ.get('NVIDIA_DRIVER_CAPABILITIES')}; the GL draw "
            "(13a) is not run on this machine")
        return {"present": False, "launches": None}
    from point_cloud_viewer_tpu_torch.viewer.gl import renderer as GR

    width, height = VIEW_SIZE
    ctx = GR.GlContext(width=width, height=height)
    strings = [ctx.gl.glGetString(k).decode() for k in (0x1F00, 0x1F01,
                                                          0x1F02)]
    log(f"viewers: {found}; GL vendor {strings[0]!r}, renderer "
        f"{strings[1]!r}, version {strings[2]!r}")

    shot = os.path.join(tmp, "view_gl.png")
    buf = io.StringIO()
    CC.cull_lod.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = view_main([octree_dir, "--gl", "--device", DEVICE, "--frames",
                        str(VIEW_FRAMES), "--width", str(width), "--height",
                        str(height), "--screenshot", shot])
    wall = time.perf_counter() - t0
    launches = CC.cull_lod.launches
    image = decode_png(shot)
    painted = int((image != image[0, 0]).any(axis=2).sum())
    log(f"viewers: cli.view --gl --frames {VIEW_FRAMES} on the card: rc "
        f"{rc}, {wall:.3f} s, K5 launches {launches}, {painted} "
        f"non-background pixels; cli said: {buf.getvalue().strip()}")
    if rc != 0 or launches <= 0 or painted <= 0:
        raise AssertionError(f"viewers: cli.view --gl: rc {rc}, K5 "
                             f"launches {launches}, painted {painted}")

    octree = Octree.from_directory(octree_dir)
    center = octree.bounding_box.center()
    diag = float(np.linalg.norm(octree.bounding_box.diag()))
    sessions = [DeviceCullSession(octree.cube_mins, octree.cube_edges,
                                  octree.num_points, device=d)
                for d in (DEVICE, "cpu")]
    ctx.make_current()  # cli.view left its own context current
    r = GR.PointsRendererGL(ctx)
    r.point_size = 1.0
    draw_ms, read_ms, ious = [], [], []
    for k, m in enumerate(orbit_matrices(center, diag, VIEW_MATRICES, width,
                                         height)):
        card, cpu = (visible_list(sess, m) for sess in sessions)
        if card != cpu:
            raise AssertionError(f"viewers: view {k}: the card's visible "
                                 f"list differs from the CPU route's")
        nodes, points, pos_parts, col_parts = [], 0, [], []
        for i in card:
            if points >= GL_DRAW_POINTS:
                break
            node_id = octree.node_ids[i]
            meta, pos, col = octree.get_node_data(node_id)
            enc = meta.position_encoding
            nodes.append(r.make_node_buffer(
                np.frombuffer(pos, enc.numpy_dtype).reshape(-1, 3),
                np.frombuffer(col, np.uint8).reshape(-1, 3), enc,
                meta.cube_min, meta.edge_length))
            batch = octree.points_in_node(node_id, attributes=["color"])
            pos_parts.append(batch.position)
            col_parts.append(batch.attributes["color"])
            points += meta.num_points
        t0 = time.perf_counter()
        r.begin_frame()
        for node in nodes:
            r.draw_node(node, m, camera_origin=center)
        ctx.gl.glFinish()
        t1 = time.perf_counter()
        frame = r.read_frame()
        t2 = time.perf_counter()
        for node in nodes:
            node.destroy()
        draw_ms.append((t1 - t0) * 1e3)
        read_ms.append((t2 - t1) * 1e3)
        soft = rasterize_points(np.concatenate(pos_parts),
                                np.concatenate(col_parts), m, width, height)
        ious.append(occupancy_iou(frame, soft))
        if ious[-1] <= 0.75:
            raise AssertionError(f"viewers: view {k}: GL vs software "
                                 f"occupancy IoU {ious[-1]:.3f} <= 0.75")
        log(f"viewers: GL view {k}: {len(card)} visible nodes (card == "
            f"cpu), {len(nodes)} drawn, {points} points, draw "
            f"{draw_ms[-1]:.3f} ms, readback {read_ms[-1]:.3f} ms, IoU "
            f"{ious[-1]:.3f}")
    log(f"viewers: GL frame {width}x{height} median draw "
        f"{statistics.median(draw_ms):.3f} ms, readback "
        f"{statistics.median(read_ms):.3f} ms over {VIEW_MATRICES} views; "
        f"IoU min {min(ious):.3f}")
    return {"present": True, "launches": launches}


def phase_window(octree_dir: str, use_gl: bool) -> int:
    """13b: run_windowed through SdlBackend over the port's libSDL2 stub
    (built with g++), culling on the card, keys w, left, CTRL+SHIFT+1 (save
    pose slot 0) and CTRL+1 (load it) scripted as C events; requires
    WINDOW_FRAMES presents, a last frame that drew nodes and is not all
    background, K5 launched and the pose saved.  The stub presents at
    once, where a window's present waits for the display: each present
    is held to WINDOW_HZ, as vsync would, so the visible-node thread and
    the loaders run beside the frames as they do under a real window.
    Returns K5's launches in the run."""
    import ctypes

    from point_cloud_viewer_tpu_torch import native
    from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC
    from point_cloud_viewer_tpu_torch.viewer.sdl_shell import (
        SdlBackend, run_windowed)

    t0 = time.perf_counter()
    path = native.sdl2_stub_path()
    build_s = time.perf_counter() - t0
    stub = ctypes.CDLL(path)
    stub.pcv_stub_get.restype = ctypes.c_int
    stub.pcv_stub_get.argtypes = [ctypes.c_char_p]
    stub.pcv_stub_pixel_sum.restype = ctypes.c_uint64
    stub.pcv_stub_reset()
    ctrl, shift = 0x0040, 0x0001
    for down, up, mod in ((26, 26, 0), (80, 80, 0), (30, None, ctrl | shift),
                          (30, None, ctrl)):
        stub.pcv_stub_push_keydown(down, mod)
        stub.pcv_stub_push_frame_end()
        if up is not None:
            stub.pcv_stub_push_keyup(up)
    pose = os.path.join(octree_dir, "poses.json")
    if os.path.exists(pose):
        os.remove(pose)
    class VsyncBackend(SdlBackend):
        last = 0.0

        def present(self, image):
            super().present(image)
            wait = self.last + 1.0 / WINDOW_HZ - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.last = time.perf_counter()

    width, height = VIEW_SIZE
    CC.cull_lod.launches = 0
    t0 = time.perf_counter()
    stats = run_windowed(octree_dir,
                         backend=VsyncBackend(width, height, lib_path=path),
                         width=width, height=height, use_gl=use_gl,
                         max_frames=WINDOW_FRAMES, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = CC.cull_lod.launches
    presents = stub.pcv_stub_get(b"render_present")
    pixel_sum = stub.pcv_stub_pixel_sum()
    background = width * height * (17 + 17 + 20 + 255)
    saved = os.path.exists(pose)
    if saved:
        with open(pose) as f:
            saved = "0" in json.load(f)
        os.remove(pose)
    log(f"viewers: run_windowed over the SDL stub (g++ {build_s:.3f} s), "
        f"{'GL' if use_gl else 'software'} frames {width}x{height} held to "
        f"{WINDOW_HZ} Hz, cull on the card: {presents} presents in "
        f"{wall:.3f} s "
        f"({wall / WINDOW_FRAMES * 1e3:.3f} ms a frame), K5 launches "
        f"{launches}, last frame {stats.nodes_drawn}/{stats.visible_nodes} "
        f"nodes, {stats.points_drawn} points, pixel sum {pixel_sum} "
        f"(background alone {background}), pose saved {saved}")
    if (presents != WINDOW_FRAMES or not 0 < pixel_sum != background
            or stats.nodes_drawn <= 0 or launches <= 0 or not saved):
        raise AssertionError(
            f"viewers: windowed shell: presents {presents}, pixel sum "
            f"{pixel_sum}, K5 launches {launches}, pose saved {saved}")
    return launches


def http(url: str, body=None) -> tuple:
    """(status, body, ms) of one request, error answers included."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body), timeout=120) as r:
            status, data = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, data = e.code, e.read()
    return status, data, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def serving(server):
    """Run an http.server on a thread; yields its base URL."""
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def ms_line(ms: list) -> str:
    return (f"{len(ms)} requests, median {statistics.median(ms):.3f} ms, "
            f"max {max(ms):.3f} ms")


def phase_web(octree_dir: str) -> None:
    """13c: the points web server over phase 5's octree on port 0:
    /init_tree and / as the files, /visible_nodes for VIEW_MATRICES orbit
    views byte-equal to Octree.visible_node_names_json, and every visible
    list POSTed to /nodes_data in the client's batches of WEB_BATCH, each
    blob byte-equal to build_nodes_data_blob; the first batch of each view
    decoded per the module docstring's layout (counts as the metas,
    positions within the octree's resolution of points_in_node's)."""
    import struct

    from point_cloud_viewer_tpu_torch.octree.node_id import NodeId
    from point_cloud_viewer_tpu_torch.octree.octree import Octree
    from point_cloud_viewer_tpu_torch.viewer import web_backend as WB

    t_phase = time.perf_counter()
    tree_id = os.path.basename(octree_dir)
    octree = Octree.from_directory(octree_dir)
    center = octree.bounding_box.center()
    diag = float(np.linalg.norm(octree.bounding_box.diag()))
    with open(WB._CLIENT_HTML, "rb") as f:
        page = f.read()
    vis_ms, data_ms, served = [], [], 0
    state = WB.AppState(prefix=os.path.dirname(octree_dir),
                        init_octree_id=tree_id)
    with serving(WB.make_server(state, port=0)) as base:
        if http(base + "/init_tree")[:2] != (200, tree_id.encode()):
            raise AssertionError("web: /init_tree")
        if http(base + "/")[:2] != (200, page):
            raise AssertionError("web: / is not viewer/client.html")
        for k, m in enumerate(orbit_matrices(center, diag, VIEW_MATRICES,
                                             *VIEW_SIZE)):
            param = ",".join(repr(float(v)) for v in m.T.reshape(-1))
            status, body, ms = http(
                f"{base}/visible_nodes/{tree_id}/?matrix={param}")
            vis_ms.append(ms)
            if status != 200 or body != octree.visible_node_names_json(m):
                raise AssertionError(f"web: view {k}: /visible_nodes "
                                     f"{status} differs")
            names = json.loads(body)
            for b in range(0, len(names), WEB_BATCH):
                batch = names[b:b + WEB_BATCH]
                status, blob, ms = http(f"{base}/nodes_data/{tree_id}/",
                                        json.dumps(batch).encode())
                data_ms.append(ms)
                served += len(blob)
                if status != 200 or blob != WB.build_nodes_data_blob(
                        octree, batch):
                    raise AssertionError(f"web: view {k}: /nodes_data "
                                         f"{status} differs")
                if b:
                    continue
                off = 0
                for name in batch:
                    node_id = NodeId.from_str(name)
                    meta = octree.node_meta(node_id)
                    mins = struct.unpack_from("<ddd", blob, off)
                    edge, = struct.unpack_from("<d", blob, off + 24)
                    count, bpc = struct.unpack_from("<IB", blob, off + 32)
                    off = (off + 37 + 7) & ~7
                    t = np.frombuffer(blob, {1: "<u1", 2: "<u2", 4: "<f4",
                                             8: "<f8"}[bpc],
                                      count=3 * count, offset=off)
                    scale = {1: 255.0, 2: 65535.0}.get(bpc, 1.0)
                    pos = (t.reshape(-1, 3) / scale) * edge + mins
                    truth = octree.points_in_node(node_id, ["color"]).position
                    off = (off + 3 * count * bpc + 7) & ~7
                    off = (off + 3 * count + 7) & ~7
                    err = float(np.abs(pos - truth).max()) if count else 0.0
                    if (count != meta.num_points
                            or bpc != meta.position_encoding
                            .bytes_per_coordinate
                            or err > octree.resolution):
                        raise AssertionError(f"web: view {k}: node {name}: "
                                             f"decode off by {err}")
            log(f"web: view {k}: {len(names)} visible nodes, "
                f"{-(-len(names) // WEB_BATCH)} /nodes_data batches")
    log(f"web: /visible_nodes {ms_line(vis_ms)}; /nodes_data (batches of "
        f"{WEB_BATCH}) {ms_line(data_ms)}, {served} bytes served; phase "
        f"13c {time.perf_counter() - t_phase:.3f} s")


def phase_xray_server(xray_dir: str) -> None:
    """13d: the x-ray server over phase 11's quadtree on port 0: /meta as
    the meta.pb says, XRAY_SERVED_TILES tiles byte-equal to their files,
    an unknown node and an unknown path answered 404."""
    from point_cloud_viewer_tpu_torch.xray import backend as XB
    from point_cloud_viewer_tpu_torch.xray.meta import XrayMeta

    meta = XrayMeta.from_directory(xray_dir)
    want = json.dumps({
        "bounding_rect": {"min_x": meta.bounding_rect.min_x,
                          "min_y": meta.bounding_rect.min_y,
                          "edge_length": meta.bounding_rect.edge_length},
        "tile_size": meta.tile_size, "deepest_level": meta.deepest_level,
    }).encode()
    tiles = sorted(f[:-4] for f in os.listdir(xray_dir) if f.endswith(".png"))
    rng = np.random.default_rng(13)
    picked = sorted(rng.choice(tiles, XRAY_SERVED_TILES, replace=False))
    tile_ms = []
    with serving(XB.make_server(xray_dir, port=0)) as base:
        if http(base + "/meta")[:2] != (200, want):
            raise AssertionError("xray server: /meta")
        for tile in picked:
            status, body, ms = http(f"{base}/node_image/{tile}")
            tile_ms.append(ms)
            with open(os.path.join(xray_dir, tile + ".png"), "rb") as f:
                if (status, body) != (200, f.read()):
                    raise AssertionError(f"xray server: tile {tile}")
        for path in ("/node_image/r9", "/nosuch"):
            if http(base + path)[0] != 404:
                raise AssertionError(f"xray server: {path} is not 404")
    log(f"xray server: /meta as meta.pb, {len(picked)} of {len(tiles)} "
        f"tiles byte-equal to their files ({ms_line(tile_ms)}), unknown "
        "node and path 404")


def phase_viewers(octree_dir: str, xray_dir: str, tmp: str) -> dict:
    """13: the GL viewer (a), the windowed shell (b), the points web server
    (c) and the x-ray server (d); returns K5's launches on a and b."""
    t_phase = time.perf_counter()
    gl = phase_gl(octree_dir, tmp)
    window = phase_window(octree_dir, gl["present"])
    phase_web(octree_dir)
    phase_xray_server(xray_dir)
    shutil.rmtree(xray_dir)
    log(f"viewers: phase 13 took {time.perf_counter() - t_phase:.3f} s")
    return {"gl": gl["launches"], "window": window}


# --- phase 14: the tools -------------------------------------------------


def ply_rows(path: str) -> np.ndarray:
    """The body of a PLY that write_ply_points wrote, as its structured
    rows (a read-only memory map)."""
    from point_cloud_viewer_tpu_torch.io.ply import parse_header

    with open(path, "rb") as f:
        header = parse_header(f)
    return np.memmap(path, mode="r", offset=header.header_len, dtype=[
        ("x", "<f8"), ("y", "<f8"), ("z", "<f8"), ("red", "u1"),
        ("green", "u1"), ("blue", "u1"), ("intensity", "<f4")],
        shape=(header.num_vertices,))


def run_main(main, args: list) -> str:
    """A CLI's main(args), its standard output captured; raises unless it
    returns 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    if rc != 0:
        raise AssertionError(f"{main.__module__} {args} returned {rc}: "
                             f"{buf.getvalue()}")
    return buf.getvalue()


def sorted_ply(path: str) -> tuple:
    """(rows, bytes of the rows sorted by position) of an exported PLY."""
    from point_cloud_viewer_tpu_torch.io.ply import PlyReader

    batch = PlyReader(path).read_all()
    order = np.lexsort(batch.position.T)
    parts = [batch.position[order].tobytes()] + [
        batch.attributes[k][order].tobytes() for k in sorted(batch.attributes)]
    return len(batch), b"".join(parts)


def phase_s2(wrappers: dict, tmp: str) -> dict:
    """14a-c: phase 10's cloud as an S2 cloud.  a. query_cloud regenerated
    and written as a PLY, then cli.build_s2 at level S2_SPLIT_LEVEL; the
    meta's cell counts sum to QUERY_POINTS and S2_SAMPLE_CELLS cells read
    back their PLY rows bit for bit (positions f64, unquantised).  b.
    query_set through PointCloudClient on the card and with
    device_filter=False, sorted positions byte-equal, the AABB's count equal
    to numpy's Aabb.contains; cli.query_points with the AABB and the cell
    union on the card and with --no-device_filter, equal counts.  c.
    cli.export_ply of the AABB on the card and with --no-device_filter,
    sorted rows byte-equal and as many as b.'s AABB; --append doubles the
    vertex count.  No kernel of K1-K7 launches.  Returns the AABB's box
    flag and count; removes its files."""
    from point_cloud_viewer_tpu_torch.cli.build_s2 import main as build_s2
    from point_cloud_viewer_tpu_torch.cli.export_ply import main as export
    from point_cloud_viewer_tpu_torch.io.ply import PlyReader
    from point_cloud_viewer_tpu_torch.math import s2
    from point_cloud_viewer_tpu_torch.protos.meta import MetaProto
    from point_cloud_viewer_tpu_torch.query.client import PointCloudClient
    from point_cloud_viewer_tpu_torch.query.point_query import PointQuery

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    ecef = query_cloud(QUERY_POINTS, seed=10)
    ply = os.path.join(tmp, "site_s2.ply")
    write_ply_points(ply, ecef, np.random.default_rng(11))
    gen_s = time.perf_counter() - t0
    s2dir = os.path.join(tmp, "site_s2")
    t0 = time.perf_counter()
    said = run_main(build_s2, [ply, "--output_directory", s2dir,
                               "--split_level", str(S2_SPLIT_LEVEL)])
    build_s = time.perf_counter() - t0
    with open(os.path.join(s2dir, "meta.pb"), "rb") as f:
        meta = MetaProto.decode(f.read())
    counts = {c.id: c.num_points for c in meta.s2.cells}
    if sum(counts.values()) != QUERY_POINTS:
        raise AssertionError(f"s2: the meta's cells hold "
                             f"{sum(counts.values())} points, not "
                             f"{QUERY_POINTS}")
    files = len(os.listdir(s2dir))
    t0 = time.perf_counter()
    cells = s2.parent(s2.leaf_cell_ids_from_points(ecef), S2_SPLIT_LEVEL)
    rows = ply_rows(ply)
    ids = sorted(counts)
    sample = [ids[i] for i in np.linspace(0, len(ids) - 1, S2_SAMPLE_CELLS,
                                          dtype=int)]
    for cid in sample:
        want = rows[cells == np.uint64(cid)]
        stem = os.path.join(s2dir, s2.token(cid))
        for ext, data in (("xyz", np.stack([want["x"], want["y"], want["z"]],
                                           axis=1)),
                          ("rgb", np.stack([want["red"], want["green"],
                                            want["blue"]], axis=1)),
                          ("intensity", want["intensity"])):
            with open(f"{stem}.{ext}", "rb") as f:
                got = f.read()
            if got != np.ascontiguousarray(data).tobytes():
                raise AssertionError(f"s2: cell {s2.token(cid)}.{ext} does "
                                     f"not hold its {len(want)} PLY rows")
    check_s = time.perf_counter() - t0
    del rows, cells
    os.remove(ply)
    log(f"s2: {QUERY_POINTS} points (phase 10's cloud, made and written in "
        f"{gen_s:.3f} s); cli.build_s2 at level {S2_SPLIT_LEVEL} "
        f"{build_s:.3f} s, {len(counts)} cells, {files} files, cell counts "
        f"sum to {QUERY_POINTS}; {len(sample)} cells read back their PLY "
        f"rows bit for bit ({check_s:.3f} s); cli said: {said.strip()}")

    queries = query_set(ecef)
    aabb = queries[0][2]
    aabb_count = int(aabb.contains(ecef).sum())
    del ecef
    attrs = ["--attributes", "color", "intensity"]
    out = {}
    for name, flags, location, intervals in queries:
        line = [f"s2 query {name}:"]
        if name in ("aabb", "cell_union"):
            card_n, card_s = run_query_cli([s2dir, *flags, *attrs])
            host_n, host_s = run_query_cli([s2dir, *flags, *attrs,
                                            "--no-device_filter"])
            if card_n != host_n:
                raise AssertionError(f"s2 query {name}: the CLI streamed "
                                     f"{card_n} points on the card, "
                                     f"{host_n} on the host")
            line.append(f"cli {card_n} points, card {card_s:.3f} s, host "
                        f"{host_s:.3f} s;")
        query = PointQuery(attributes=["color", "intensity"],
                           location=location, filter_intervals=intervals)
        card = PointCloudClient.from_locations([s2dir])
        got, card_s = stream_sorted(card, query)
        want, host_s = stream_sorted(PointCloudClient.from_locations(
            [s2dir], device_filter=False), query)
        if got.shape != want.shape or got.tobytes() != want.tobytes():
            raise AssertionError(f"s2 query {name}: the card's stream "
                                 f"differs from the host's ({len(got)} vs "
                                 f"{len(want)} points)")
        if not 0 < len(got) < QUERY_POINTS:
            raise AssertionError(f"s2 query {name}: {len(got)} points")
        if name == "aabb" and len(got) != aabb_count:
            raise AssertionError(f"s2 query aabb: {len(got)} points, numpy's "
                                 f"Aabb.contains {aabb_count}")
        if name == "aabb" and card_n != aabb_count:
            raise AssertionError(f"s2 query aabb: the CLI streamed {card_n} "
                                 f"points, numpy's Aabb.contains {aabb_count}")
        stats = card.filter_stats
        line.append(f"stream {len(got)} points == host, byte-equal; card "
                    f"{card_s:.3f} s, host {host_s:.3f} s; filtered on the "
                    f"card {stats.rows} rows, band {stats.uncertain}, host "
                    f"recomputed {stats.refined}")
        log(" ".join(line))
        out[name] = len(got)

    box = queries[0][1][1]
    paths = {}
    for route, extra in (("card", []), ("host", ["--no-device_filter"])):
        paths[route] = os.path.join(tmp, f"export_{route}.ply")
        t0 = time.perf_counter()
        run_main(export, [s2dir, "--output", paths[route], "--aabb", box,
                          *attrs, *extra])
        out[f"export {route} s"] = time.perf_counter() - t0
    (n_card, card_rows), (n_host, host_rows) = (sorted_ply(paths[r])
                                                for r in ("card", "host"))
    if card_rows != host_rows or n_card != aabb_count:
        raise AssertionError(f"s2 export: {n_card} rows on the card, "
                             f"{n_host} on the host, {aabb_count} in the "
                             f"AABB; sorted rows equal: "
                             f"{card_rows == host_rows}")
    run_main(export, [s2dir, "--output", paths["card"], "--aabb", box,
                      *attrs, "--append"])
    appended = PlyReader(paths["card"]).num_points
    if appended != 2 * n_card:
        raise AssertionError(f"s2 export --append: {appended} vertices, not "
                             f"{2 * n_card}")
    log(f"s2 export: cli.export_ply of the AABB on the card "
        f"{out['export card s']:.3f} s, --no-device_filter "
        f"{out['export host s']:.3f} s; {n_card} rows each, sorted rows "
        f"byte-equal; --append -> {appended} vertices")
    launches = {k: w.launches for k, w in wrappers.items()}
    if any(launches.values()):
        raise AssertionError(f"s2: kernels launched on the S2 path "
                             f"{launches}")
    shutil.rmtree(s2dir)
    for p in paths.values():
        os.remove(p)
    return out


def meta_v12(raw: bytes) -> bytes:
    """A version-13 octree meta.pb re-encoded at version 12: the bounding
    box inside OctreeMeta (field 1), as protos/meta.py decodes it."""
    from point_cloud_viewer_tpu_torch.protos import pbwire as pb
    from point_cloud_viewer_tpu_torch.protos.meta import MetaProto

    meta = MetaProto.decode(raw)
    octree = pb.FieldWriter()
    octree.message(1, meta.bounding_box.encode())
    octree.double(2, meta.octree.resolution)
    for node in meta.octree.nodes:
        octree.message(3, node.encode())
    w = pb.FieldWriter()
    w.varint(1, 12, signed=True)
    w.message(6, octree.finish())
    return w.finish()


def phase_host_tools(octree_dir: str, tmp: str) -> None:
    """14d: on phase 5's octree, cli.upgrade_octree on a copy of its meta.pb
    re-encoded at version 12 gives back the version-13 bytes; node_ids_bfs
    yields every node; default_factory's HTTP provider over a
    ThreadingHTTPServer of the directory (port 0) serves meta.pb, and an
    Octree over it answers a small AABB query through the card's filter
    with the on-disk octree's points."""
    import functools
    from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

    from point_cloud_viewer_tpu_torch.cli.upgrade_octree import main as upgrade
    from point_cloud_viewer_tpu_torch.io.factory import (
        HttpDataProvider, default_factory)
    from point_cloud_viewer_tpu_torch.math.geometry import Aabb
    from point_cloud_viewer_tpu_torch.octree.octree import Octree
    from point_cloud_viewer_tpu_torch.octree.traversal import node_ids_bfs
    from point_cloud_viewer_tpu_torch.query.client import PointCloudClient
    from point_cloud_viewer_tpu_torch.query.point_query import PointQuery

    with open(os.path.join(octree_dir, "meta.pb"), "rb") as f:
        raw = f.read()
    old = os.path.join(tmp, "upgrade")
    os.makedirs(old)
    with open(os.path.join(old, "meta.pb"), "wb") as f:
        f.write(meta_v12(raw))
    said = run_main(upgrade, [old])
    with open(os.path.join(old, "meta.pb"), "rb") as f:
        if f.read() != raw:
            raise AssertionError("upgrade: the v12 meta did not come back "
                                 "as the v13 bytes")
    shutil.rmtree(old)
    octree = Octree.from_directory(octree_dir)
    t0 = time.perf_counter()
    bfs = list(node_ids_bfs(octree))
    bfs_s = time.perf_counter() - t0
    if len(bfs) != len(octree) or len(set(bfs)) != len(octree):
        raise AssertionError(f"node_ids_bfs: {len(bfs)} nodes of "
                             f"{len(octree)}")
    log(f"tools: cli.upgrade_octree v12 -> v13 byte-equal ({said.strip()}); "
        f"node_ids_bfs {len(bfs)} nodes of {len(octree)} in {bfs_s:.3f} s")

    class Quiet(SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(
        Quiet, directory=octree_dir))
    box = octree.bounding_box
    mid = (box.mins + box.maxs) / 2.0
    query = PointQuery(attributes=["color", "intensity"],
                       location=Aabb(mid - HTTP_BOX / 2, mid + HTTP_BOX / 2))
    with serving(server) as url:
        provider = default_factory().generate_data_provider(url + "/")
        if not isinstance(provider, HttpDataProvider):
            raise AssertionError(f"factory gave {type(provider).__name__}")
        if provider.meta_bytes() != raw:
            raise AssertionError("http provider: meta.pb differs")
        t0 = time.perf_counter()
        got, _ = stream_sorted(PointCloudClient([Octree(provider)]), query)
        http_s = time.perf_counter() - t0
    want, disk_s = stream_sorted(PointCloudClient.from_locations(
        [octree_dir]), query)
    if got.tobytes() != want.tobytes() or not len(got):
        raise AssertionError(f"http provider: {len(got)} points, on disk "
                             f"{len(want)}")
    log(f"tools: default_factory's HttpDataProvider on port "
        f"{server.server_address[1]} served meta.pb; a {HTTP_BOX:.0f} m AABB "
        f"through the card's filter gave {len(got)} points over HTTP "
        f"({http_s:.3f} s) == on disk ({disk_s:.3f} s), byte-equal")


def run_campaign(name: str, seed: int, iters: int) -> tuple:
    """One campaign twin's main in process on DEVICE with FUZZ_SEED and
    FUZZ_MAX_ITERS set -> (iterations, seconds, its last line)."""
    module = importlib.import_module(
        f"point_cloud_viewer_tpu_torch.tools.{name}")
    saved = {k: os.environ.get(k) for k in ("FUZZ_SEED", "FUZZ_MAX_ITERS")}
    os.environ.update(FUZZ_SEED=str(seed), FUZZ_MAX_ITERS=str(iters))
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = module.main([str(CAMPAIGN_SECONDS), "--device", DEVICE])
    except BaseException:
        log(f"campaign {name}: " + " | ".join(buf.getvalue().splitlines()[-3:]))
        raise
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    said = re.search(r"finished: (\d+) iterations, no failures$", lines[-1])
    if rc != 0 or not said or int(said.group(1)) != iters:
        raise AssertionError(f"campaign {name}: rc {rc}, last line "
                             f"{lines[-1]!r}")
    return iters, seconds, lines


def phase_campaigns(wrappers: dict) -> dict:
    """14e: the three campaign twins in process on the card (CAMPAIGNS:
    seed and iterations), each run ending with its "no failures" line; K1,
    K4 and K6 counted over each run: each differential run, and the
    crash-resume run through the device bucket route, must launch K4 and
    K6.  Returns the counts summed over the differential runs."""
    from point_cloud_viewer_tpu_torch.tools import fuzz_crash_resume

    counts = {k: 0 for k in BUILD_PATH}
    for name, seed, iters in CAMPAIGNS:
        for w in wrappers.values():
            w.launches = 0
        iters, seconds, lines = run_campaign(name, seed, iters)
        launches = {k: wrappers[k].launches for k in BUILD_PATH}
        extra = ""
        if name == "fuzz_differential":
            if not (launches["K4"] and launches["K6"]):
                raise AssertionError(f"campaign {name}: K4 or K6 never "
                                     f"launched {launches}")
            counts = {k: counts[k] + launches[k] for k in BUILD_PATH}
            extra = f"; launches {json.dumps(launches)}"
        if name == "fuzz_crash_resume":
            real = {k: getattr(mod, attr) for k, (mod, attr)
                    in fuzz_crash_resume.HOOKS.items()}
            if real != fuzz_crash_resume.REAL:
                raise AssertionError("campaign fuzz_crash_resume left a hook "
                                     "patched")
            device_its = sum("dev=True" in line for line in lines)
            if not (device_its and launches["K4"] and launches["K6"]):
                raise AssertionError(f"campaign {name}: the device bucket "
                                     f"route never ran on the card "
                                     f"({device_its} iterations, launches "
                                     f"{launches})")
            extra = (f"; {device_its} iterations on the device bucket route, "
                     f"launches {json.dumps(launches)}; hooks restored")
        log(f"campaign {name}: seed {seed}, {iters} iterations on the card "
            f"in {seconds:.3f} s, no failures{extra}; last: {lines[-2]}")
    return counts


def phase_tools(wrappers: dict, tmp: str, octree_dir: str) -> dict:
    """14: the tools -- the S2 cloud (a-c), the host tools (d) and the
    campaigns on the card (e); returns 14e's launch counts."""
    t_phase = time.perf_counter()
    phase_s2(wrappers, tmp)
    t0 = time.perf_counter()
    phase_host_tools(octree_dir, tmp)
    tools_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = phase_campaigns(wrappers)
    log(f"tools: 14d {tools_s:.3f} s, 14e {time.perf_counter() - t0:.3f} s; "
        f"phase 14 took {time.perf_counter() - t_phase:.3f} s")
    return counts


# --- phase 15: the public surface ----------------------------------------

# The kernels of a traced build, by the names of their CUDA functions: K6's
# leaf stage is three, K4's promotion stage one; K1 runs on the look-back
# scan that K2 and K3 share, whose launches on the build path are K1's
# (the child's counters hold K2 = K3 = 0).
TRACE_KERNELS = {"K6": ("leaf_bounds", "leaf_carry_scan", "leaf_assign"),
                 "K4": ("promote_levels",), "K1": ("lookback_scan",)}


def trace_build_main(args: list) -> int:
    """`chip_smoke.py --trace-build PLY OUT LOG_DIR` (phase 15b's child):
    the PLY built in core on the card by the package root's build_octree,
    as cli.build_octree builds it, under utils.progress.torch_trace (the
    PLY read and the card's start-up outside the trace); prints one JSON
    line: the build's wall, its phases and the wrappers' launches."""
    sys.meta_path.insert(0, RefuseJaxPackage())
    import torch

    import point_cloud_viewer_tpu_torch as pcv
    from point_cloud_viewer_tpu_torch.io.ply import PlyReader
    from point_cloud_viewer_tpu_torch.ops import _ext
    from point_cloud_viewer_tpu_torch.ops import leaf_levels_cuda as K6
    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
    from point_cloud_viewer_tpu_torch.ops import scan_cuda as SC
    from point_cloud_viewer_tpu_torch.utils.progress import torch_trace

    ply, out, log_dir = args
    batch = PlyReader(ply).read_all()
    torch.zeros(1, device=DEVICE)
    _ext.lib()
    torch.cuda.synchronize()
    phases = {}
    t0 = time.perf_counter()
    with torch_trace(log_dir):
        pcv.build_octree(out, 0.001, batch, phase_times=phases,
                         device=DEVICE)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": SC.scan_1d.launches, "K2": LC.seg_start_pass.launches,
                "K3": LC.leaf_update_pass.launches,
                "K4": LC.promote_stage.launches, "K6": K6.leaf_stage.launches,
                "K4 pass": LC.promote_pass.launches}
    print(json.dumps({"wall": wall, "phases": phases, "launches": launches}),
          flush=True)
    return 0


def trace_readings(path: str) -> dict:
    """A Chrome trace of torch_trace -> the traced window (first to last
    event, s), the device's busy time (the union of its kernel, memcpy and
    memset intervals, s), the idle share, launches of TRACE_KERNELS' names
    and the API_TOP_OPS device operations that took most time."""
    from point_cloud_viewer_tpu_torch.testing import kernel_name

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if isinstance(e, dict) and e.get("ph") == "X"
                  and "dur" in e]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not spans or not device:
        raise AssertionError(f"{path}: {len(spans)} events, {len(device)} "
                             "on the device")
    window = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e6
    busy, end = 0.0, -np.inf
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in device):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e6
    ops, kernels = {}, {k: 0 for k in TRACE_KERNELS}
    for e in device:
        name = (kernel_name(e["name"]) if e.get("cat") == "kernel"
                else e["name"])[:60]
        total, count = ops.get(name, (0.0, 0))
        ops[name] = (total + float(e["dur"]) / 1e3, count + 1)
        for k, names in TRACE_KERNELS.items():
            kernels[k] += kernel_name(e["name"]) in names
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:API_TOP_OPS]
    return {"window_s": window, "busy_s": busy, "idle": 1.0 - busy / window,
            "kernels": kernels, "device_events": len(device), "top": top}


def api_trace_build(tmp: str, ply16: str, incore16: str) -> dict:
    """15b: phase 5's PLY through the package root's build_octree under
    torch_trace, in a child (profiles late in this process drop records,
    7d), byte-compared with phase 5's build; the trace's readings."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, "traced16")
    log_dir = os.path.join(tmp, "trace16")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--trace-build",
         ply16, out, log_dir], cwd=here, capture_output=True, text=True,
        timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"chip_smoke.py --trace-build exited "
                             f"{proc.returncode}: {proc.stderr[-4000:]}")
    said = json.loads(proc.stdout.strip().splitlines()[-1])
    files = dirs_byte_equal(incore16, out)
    shutil.rmtree(out)
    (name,) = os.listdir(log_dir)
    size = os.path.getsize(os.path.join(log_dir, name))
    r = trace_readings(os.path.join(log_dir, name))
    shutil.rmtree(log_dir)
    log(f"api trace: the root's build_octree under torch_trace (child "
        f"{child_s:.3f} s): wall {said['wall']:.3f} s, phases (s) "
        f"{json.dumps(said['phases'])}; == phase 5's build, {files} files "
        f"byte-equal; launches {json.dumps(said['launches'])}; trace "
        f"{size} B, {r['device_events']} device events")
    log(f"api trace: traced window {r['window_s']:.6f} s, device busy "
        f"{r['busy_s']:.6f} s (kernels, memcpys, memsets), idle share "
        f"{r['idle']:.6f}; kernels in the trace {json.dumps(r['kernels'])}")
    log("api trace: top device operations (ms, count): " + "; ".join(
        f"{n} {ms:.4f} x{c}" for n, (ms, c) in r["top"]))
    missing = [k for k, c in r["kernels"].items() if c <= 0]
    stray = {k: said["launches"][k] for k in OFF_PATH
             if said["launches"][k] != 0}
    if missing or stray:
        raise AssertionError(f"api trace: no launch of {missing} in the "
                             f"trace; off-path launches {stray}")
    return r


def api_padded(wrappers: dict) -> dict:
    """15c: the padded entries at API_ROWS (phase 4's generator) against
    the unpadded tree_codes_grouped_on_device on the card, rows [0, n),
    level counts and extras bit for bit, K6 = K4 = 1 a call; and
    sort_codes_device against argsort_codes_on_device.  Returns the
    launches of one padded grouped call at API_ROWS[0]."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import morton
    from point_cloud_viewer_tpu_torch.ops import tree_build as TB

    per_call = None
    for n in API_ROWS:
        codes = synthetic_codes(n, seed=n + 1)
        hi, lo = morton.split_u64(codes)
        want = TB.tree_codes_grouped_on_device(codes, DEPTH, DEPTH,
                                               device=DEVICE)
        counts = {}
        t0 = time.perf_counter()
        for w in wrappers.values():
            w.launches = 0
        got, n_got = TB.tree_codes_grouped_on_device_padded(
            hi, lo, DEPTH, DEPTH, device=DEVICE)
        torch.cuda.synchronize()
        grouped_s = time.perf_counter() - t0
        counts["grouped"] = {k: w.launches for k, w in wrappers.items()}
        for w in wrappers.values():
            w.launches = 0
        idx, final, leaf, n_classic = TB.tree_codes_on_device_padded(
            hi, lo, DEPTH, DEPTH, device=DEVICE)
        torch.cuda.synchronize()
        counts["classic"] = {k: w.launches for k, w in wrappers.items()}
        padded = got.order2.shape[0]
        total = int(want.extras_total)
        cap = min(got.extras_idx.shape[0], want.extras_idx.shape[0])
        checks = {
            "n": n_got == n_classic == n,
            "order2": torch.equal(got.order2[:n], want.order2),
            "level_counts": torch.equal(got.level_counts[:-1],
                                        want.level_counts[:-1]),
            "pad bin": int(got.level_counts[-1]) == padded - n,
            "extras_total": int(got.extras_total) == total,
            "extras": (torch.equal(got.extras_idx[:min(total, cap)],
                                   want.extras_idx[:min(total, cap)])
                       and torch.equal(got.extras_level[:min(total, cap)],
                                       want.extras_level[:min(total, cap)])),
        }
        for name, a, b in (("idx", got.idx, want.idx),
                           ("final", got.final, want.final),
                           ("leaf", got.leaf, want.leaf),
                           ("classic idx", idx, want.idx),
                           ("classic final", final, want.final),
                           ("classic leaf", leaf, want.leaf)):
            checks[name] = torch.equal(a[:n], b)
        for call, c in counts.items():
            checks[f"{call} K6 = K4 = 1"] = c["K6"] == c["K4"] == 1
        sort = TB.sort_codes_device(torch.from_numpy(hi.astype(np.int64)).to(
            DEVICE), torch.from_numpy(lo.astype(np.int64)).to(DEVICE))
        _, order = TB.argsort_codes_on_device(codes, DEVICE)
        checks["sort_codes_device"] = bool(np.array_equal(
            sort.cpu().numpy().astype(np.int64), order))
        log(f"api padded n={n} -> {padded} rows: grouped {grouped_s:.3f} s "
            f"(upload included); launches a call {json.dumps(counts)}; "
            f"extras_total {total}; {checks}")
        if not all(checks.values()):
            raise AssertionError(f"api padded n={n}: {checks}")
        if per_call is None:
            per_call = counts["grouped"]
        del want, got, idx, final, leaf, sort
        torch.cuda.empty_cache()
    return per_call


def api_culling() -> None:
    """15d: node_corners, sat_relation_device and
    relative_sizes_on_screen_device on phase 6's node table on the card
    against device="cpu", bit for bit, for the partial and the off-axis
    frustum of phase 6a."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import culling as C

    mins, edges, _ = synthetic_node_table(CULL_NODES, seed=5)
    frusta = cull_frusta(C)
    for name in ("partial", "off_axis"):
        axes, qmin, qmax = C.frustum_axes_and_projections(frusta[name])
        arrays = (mins.astype(np.float32), edges.astype(np.float32), axes,
                  qmin, qmax, frusta[name].clip_from_query.astype(np.float32))
        out, secs = {}, {}
        for dev in (DEVICE, "cpu"):
            m, e, a, lo, hi, mat = (torch.from_numpy(x).to(dev)
                                    for x in arrays)
            t0 = time.perf_counter()
            corners = C.node_corners(m, e)
            rel = C.sat_relation_device(a, lo, hi, corners)
            sizes = C.relative_sizes_on_screen_device(mat, corners)
            if dev == DEVICE:
                torch.cuda.synchronize()
            secs[dev] = time.perf_counter() - t0
            out[dev] = [t.cpu() for t in (corners, rel, sizes)]
        same = [torch.equal(a.view(torch.uint8) if a.is_floating_point()
                            else a, b.view(torch.uint8)
                            if b.is_floating_point() else b)
                for a, b in zip(out[DEVICE], out["cpu"])]
        rel = out["cpu"][1]
        log(f"api culling {name} ({len(axes)} axes, {CULL_NODES} nodes): "
            f"card == CPU bit for bit (corners, relations, sizes) {same}; "
            f"in / cross / out {[int((rel == r).sum()) for r in range(3)]}; "
            f"card {secs[DEVICE]:.3f} s, CPU {secs['cpu']:.3f} s")
        if not all(same):
            raise AssertionError(f"api culling {name}: card != CPU {same}")


def phase_api(wrappers: dict, tmp: str, ply16: str, incore16: str) -> tuple:
    """15: the package root's names (a), the traced 16M build (b), the
    padded entries and the device sort (c), the culling building blocks
    (d) and PCV_DISABLE_NATIVE (e).  Returns (15b's readings, 15c's
    launches of one padded grouped call)."""
    import subprocess

    import point_cloud_viewer_tpu_torch as pcv

    t_phase = time.perf_counter()
    resolved = {name: getattr(pcv, name) for name in pcv.__all__}
    log(f"api root: {len(resolved)} names resolve: " + ", ".join(
        f"{k}={v!r}" if isinstance(v, (int, str)) else
        f"{k}={v.__module__}" for k, v in resolved.items()))
    if len(resolved) != 12:
        raise AssertionError(f"api root: __all__ has {len(resolved)} names")
    trace = api_trace_build(tmp, ply16, incore16)
    per_call = api_padded(wrappers)
    api_culling()
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", "from point_cloud_viewer_tpu_torch import "
         "native; print(native.available())"], cwd=here,
        env={**os.environ, "PCV_DISABLE_NATIVE": "1"}, capture_output=True,
        text=True, timeout=120)
    said = proc.stdout.strip()
    from point_cloud_viewer_tpu_torch import native

    log(f"api native: native.available() is {said} in a child with "
        f"PCV_DISABLE_NATIVE=1, {native.available()} here")
    if proc.returncode != 0 or said != "False":
        raise AssertionError(f"api native: {proc.returncode} {said} "
                             f"{proc.stderr[-2000:]}")
    log(f"api: phase 15 took {time.perf_counter() - t_phase:.3f} s")
    return trace, per_call


# --- phase 8: K7, the probes, and every kernel's bound -------------------


def phase_probe(record: dict) -> tuple:
    """8a: K7 (every mode) against its plain version at PROBE_RAGGED and
    PROBE_N, bit for bit, and CUDA-event medians of the copy, its plain
    version and torch.add at the Pallas probe's whole-block length; 8b:
    hbm_probes on the card, K7's launch count set to 0 just before and
    read just after.  Returns (K7 launches in 8b, the probe results)."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import hbm_probe as K7

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(8)
    for n in (*PROBE_RAGGED, PROBE_N):
        x, y, z = (torch.rand(n, generator=gen, device=dev) * 2 - 1
                   for _ in range(3))
        s = torch.rand(1, generator=gen, device=dev) - 0.5
        for mode, extra in (("copy", ()), ("triad", (y,)), ("add3", (y, z))):
            got = K7.stream_probe(mode, x, s, *extra)
            want = K7.stream_probe_plain(mode, x, s, *extra)
            err = f32_err(got, want)
            record["K7"]["err"] = max(record["K7"]["err"], err)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"K7 {mode} n={n}: max_abs_err {err}")
        log(f"K7 stream_probe n={n}: copy, triad, add3 bit-equal to plain")

    n_eff = PROBE_N // (128 * 2048) * (128 * 2048)
    xe = x[:n_eff]
    ms = cuda_ms(lambda: K7.stream_probe("copy", xe, s))
    pms = cuda_ms(lambda: K7.stream_probe_plain("copy", xe, s))
    lms = cuda_ms(lambda: torch.add(xe, s))
    alpha = float(s)
    tri = (cuda_ms(lambda: K7.stream_probe("triad", x, s, y)),
           cuda_ms(lambda: torch.add(x, y, alpha=alpha)))
    log(f"K7 copy at n_eff={n_eff}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
        f"torch.add {lms:.4f} ms; triad at n={PROBE_N}: kernel "
        f"{tri[0]:.4f} ms, torch.add(x, y, alpha=s) {tri[1]:.4f} ms")
    record["K7"]["times"][PROBE_N] = (ms, pms)
    record["K7"]["lib"][PROBE_N] = lms
    record["K7"]["bytes"] = 2 * 4 * n_eff
    del x, y, z, s, got, want, xe
    torch.cuda.empty_cache()

    K7.stream_probe.launches = 0
    probes = K7.hbm_probes(dev, n=PROBE_N, iters=PROBE_ITERS,
                           generator=torch.Generator(dev).manual_seed(9))
    launches = K7.stream_probe.launches
    for shape in ("add_1d", "add_2d", "copy", "triad", "add3"):
        log(f"probe {shape}: {probes[f'hbm_probe_{shape}_gbps']:.3f} GB/s, "
            f"{probes[f'hbm_probe_{shape}_ms']:.4f} ms a pass")
    share = probes["hbm_probe_share_of_published_peak"]
    log(f"probe: hbm_probe_gbps {probes['hbm_probe_gbps']:.3f} GB/s on "
        f"{probes['card']}; share of the card's published peak "
        f"({probes['published_peak_gbps']} GB/s): "
        f"{'n/a' if share is None else f'{share:.4f}'}; K7 launches {launches}")
    if launches <= 0:
        raise AssertionError("probe: K7 was not launched")
    return launches, probes


def bounds(record: dict, probes: dict, per_call: dict) -> dict:
    """Per kernel: the least time the card could take for one launch's
    work -- its bytes over the card's memory rate, or its f32 operations
    over FP32_PEAK_OPS where larger -- beside its kernel, plain and library
    times; printed as a table, returned by kernel.  The memory rate is the
    larger of the card's published peak and the probe's measured
    hbm_probe_gbps, so a slow probe cannot loosen a bound; `bound_probe_ms`
    is the bytes over the measured rate alone."""
    probe = probes["hbm_probe_gbps"]
    rate = max(probe, probes["published_peak_gbps"] or 0.0)
    log(f"bound: memory rate {rate:.3f} GB/s (published peak "
        f"{probes['published_peak_gbps']} GB/s, probe {probe:.3f} GB/s); "
        f"f32 peak {FP32_PEAK_OPS:.4g} operations/s")
    out = {}
    for k, rec in record.items():
        ms, pms = rec["main"]
        t_bytes = rec["bytes"] / (rate * 1e9) * 1e3
        t_ops = rec.get("ops", 0) / FP32_PEAK_OPS * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        lib = rec["lib_ms"]
        out[k] = {"bytes": rec["bytes"], "bound_ms": bound, "bound_by": by,
                  "bound_probe_ms": rec["bytes"] / (probe * 1e9) * 1e3}
        for name, (nbytes, ops) in rec.get("work", {}).items():
            t_b, t_o = nbytes / (rate * 1e9) * 1e3, ops / FP32_PEAK_OPS * 1e3
            dms = rec["device"].get(name)
            setup = {"ms": rec["times"][name][0], "device_ms": dms,
                     "bound_ms": max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations",
                     "bytes": nbytes, "ops": ops}
            out[k].setdefault("setups", {})[name] = setup
            log(f"bound {k} {name}: {nbytes} B, {ops} f32 ops; bound "
                f"{setup['bound_ms']:.4f} ms ({setup['bound_by']}); kernel "
                f"{setup['ms']:.4f} ms one call = "
                f"{setup['ms'] / setup['bound_ms']:.2f}x, device "
                + ("not measured" if dms is None else
                   f"{dms:.4f} ms = {dms / setup['bound_ms']:.2f}x"))
        calls = ", ".join(f"{where} {'not run' if n is None else f'{n:.3f}'}"
                          for where, n in per_call[k].items())
        log(f"bound {k}: {rec['bytes']} B"
            + (f", {rec['ops']} f32 ops" if "ops" in rec else "")
            + f"; launches per call: {calls}; bound {bound:.4f} ms ({by}); "
            f"kernel {ms:.4f} ms = {ms / bound:.2f}x bound; bytes over the "
            f"probe rate {out[k]['bound_probe_ms']:.4f} ms; plain "
            f"{pms:.4f} ms; library "
            + ("none (no single call)" if lib is None else f"{lib:.4f} ms"))
    return out


def build_all() -> None:
    """Phase 2: nvcc over the port's CUDA sources and, beside it, g++ over
    its host library; raises if either fails."""
    from point_cloud_viewer_tpu_torch import native
    from point_cloud_viewer_tpu_torch.ops import _ext

    host = {}

    def build_host():
        try:
            host["seconds"] = native.build()
        except Exception as e:  # noqa: BLE001 - re-raised below
            host["error"] = e

    thread = threading.Thread(target=build_host)
    thread.start()
    info = _ext.build(force=True)
    thread.join()
    if "error" in host:
        raise host["error"]
    if not native.available():
        raise AssertionError("the port's host library does not load")
    log(f"build: nvcc {info.seconds:.3f} s -> {_ext.LIB_PATH}; g++ "
        f"{host['seconds']:.3f} s (beside nvcc) -> {native._SO}")
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  " + line.strip())


def run_alone(flag: str, body) -> int:
    """`chip_smoke.py FLAG`: phase 2, phase 5 and body(wrappers, tmp,
    phase 5's PLY, phase 5's octree) alone, with their log lines and
    checks; prints no result line."""
    sys.meta_path.insert(0, RefuseJaxPackage())
    import torch

    from point_cloud_viewer_tpu_torch.ops import hbm_probe as K7
    from point_cloud_viewer_tpu_torch.ops import leaf_levels_cuda as K6
    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
    from point_cloud_viewer_tpu_torch.ops import scan_cuda as SC

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    global CARD
    t_start = time.perf_counter()
    CARD = K7.card_label(torch.device(DEVICE))
    build_all()
    build = {"K1": SC.scan_1d, "K2": LC.seg_start_pass,
             "K3": LC.leaf_update_pass, "K4": LC.promote_stage,
             "K6": K6.leaf_stage, "K4 pass": LC.promote_pass}
    tmp = tempfile.mkdtemp(prefix="pcv_chip_smoke_")
    try:
        _, octree_dir, ply, _, _ = phase_e2e(build, tmp)
        body(build, tmp, ply, octree_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"{flag} total {time.perf_counter() - t_start:.3f} s")
    return 0


def query_mask_main() -> int:
    """`chip_smoke.py --query-mask`: phase 2 and phase 10c alone; prints
    10c's readings as the last line."""
    sys.meta_path.insert(0, RefuseJaxPackage())
    import torch

    from point_cloud_viewer_tpu_torch.ops import hbm_probe as K7

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    global CARD
    CARD = K7.card_label(torch.device(DEVICE))
    build_all()
    print(json.dumps({"card": CARD, "k8": phase_query_mask()}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--device-ops"]:
        return device_ops_main()
    if sys.argv[1:] == ["--tools"]:  # PERF.md's phase-14 numbers
        return run_alone("--tools", lambda build, tmp, ply, octree_dir:
                         phase_tools(build, tmp, octree_dir))
    if sys.argv[1:] == ["--api"]:
        return run_alone("--api", phase_api)
    if sys.argv[1:] == ["--query-mask"]:
        return query_mask_main()
    if sys.argv[1:2] == ["--trace-build"]:
        return trace_build_main(sys.argv[2:])
    finder = RefuseJaxPackage()
    sys.meta_path.insert(0, finder)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC
    from point_cloud_viewer_tpu_torch.ops import hbm_probe as K7
    from point_cloud_viewer_tpu_torch.ops import leaf_levels_cuda as K6
    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
    from point_cloud_viewer_tpu_torch.ops import scan_cuda as SC

    global CARD
    t_start = time.perf_counter()
    smi = K7.card_label(torch.device(DEVICE))
    CARD = smi
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; imports of "
        "jax and point_cloud_viewer_tpu refused")
    found = {}
    for name in ("scipy", "PIL"):
        try:
            found[name] = importlib.import_module(name).__version__
        except ImportError:
            found[name] = "does not import"
    log(f"device: scipy {found['scipy']}; PIL {found['PIL']}")

    build_all()

    kernels = {
        "K1": ("scan_1d", SC.scan_1d, "point_cloud_viewer_tpu_torch/csrc/scan.cu",
               "point_cloud_viewer_tpu/ops/scan_pallas.py:148"),
        "K2": ("seg_start_pass", LC.seg_start_pass,
               "point_cloud_viewer_tpu_torch/csrc/level.cu",
               "point_cloud_viewer_tpu/ops/level_pallas.py:145"),
        "K3": ("leaf_update_pass", LC.leaf_update_pass,
               "point_cloud_viewer_tpu_torch/csrc/level.cu",
               "point_cloud_viewer_tpu/ops/level_pallas.py:166"),
        "K4": ("promote_stage", LC.promote_stage,
               "point_cloud_viewer_tpu_torch/csrc/promote.cu",
               "point_cloud_viewer_tpu/ops/level_pallas.py:203"),
        "K5": ("cull_lod", CC.cull_lod,
               "point_cloud_viewer_tpu_torch/csrc/cull.cu",
               "point_cloud_viewer_tpu/ops/culling_pallas.py:81"),
        "K6": ("leaf_stage", K6.leaf_stage,
               "point_cloud_viewer_tpu_torch/csrc/leaf_levels.cu",
               "point_cloud_viewer_tpu/ops/tree_build_pallas.py:150"),
        "K7": ("stream_probe", K7.stream_probe,
               "point_cloud_viewer_tpu_torch/csrc/stream_probe.cu",
               "bench.py:199"),
    }
    record = {k: {"err": 0, "times": {}, "lib": {}, "train": {}}
              for k in kernels}
    phase_kernels(record)
    phase_core()
    build = {k: v[1] for k, v in kernels.items()
             if k in BUILD_PATH + OFF_PATH}
    build["K4 pass"] = LC.promote_pass
    tmp = tempfile.mkdtemp(prefix="pcv_chip_smoke_")
    try:
        launches, octree_dir, ply, incore_wall, incore_phases = phase_e2e(
            build, tmp)
        incore = dict(launches)
        table, cull_setups = phase_cull_kernel(record)
        phase_cull_session(octree_dir, table)
        launches["K5"] = phase_view(octree_dir, tmp)
        phase_leaf_levels(record)
        phase_promote(record)
        phase_device_times(record, cull_setups)
        del cull_setups
        deep, deep_dir = phase_deep(build, tmp, ply, octree_dir)
        streamed, buckets = phase_streaming(build, tmp, ply, octree_dir,
                                            incore_wall)
        phase_query(build, tmp)
        phase_query_mask()
        xray_dir = phase_xray({**build, "K5": CC.cull_lod,
                               "K7": K7.stream_probe}, tmp, octree_dir)
        _, api_calls = phase_api(build, tmp, ply, octree_dir)
        mesh = phase_mesh(build, tmp, ply, octree_dir, incore_phases,
                          deep_dir)
        viewers = phase_viewers(octree_dir, xray_dir, tmp)
        campaign = phase_tools(build, tmp, octree_dir)
        log(f"launches on the in-core path (phase 5) {json.dumps(incore)}; "
            f"on the streaming path (phase 7c, 16M, {buckets} buckets) "
            f"{json.dumps(streamed)}; on the deep 16M build (phase 9) "
            f"{json.dumps(deep)}; on the 16M mesh build (phase 12c, "
            f"{MESH_SHARDS} shards) {json.dumps(mesh)}; K5 in the viewer "
            f"(phase 6c, {VIEW_FRAMES} frames) {launches['K5']}, in "
            f"cli.view --gl (phase 13a, {VIEW_FRAMES} frames) "
            f"{viewers['gl']}, in the windowed shell (phase 13b, "
            f"{WINDOW_FRAMES} frames) {viewers['window']}; over the "
            f"differential campaign (phase 14e) {json.dumps(campaign)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches["K7"], probes = phase_probe(record)

    # Bytes a launch moves at the timed shape (n = SIZES[0] for K1-K4 and
    # K6): K1 i32 in + out; K2 u8 b in, i32 seg_start out; K4 (the
    # promotion stage, every level) b and leaf in, the final levels out; K6
    # (the leaf stage) i64 codes in, u8 b and u8 leaf out.  K3 (from the
    # rows its timed call sets), K5 and K7 were counted in their phases.
    per_elem = {"K1": 8, "K2": 5, "K4": 3, "K6": 10}
    for k, rec in record.items():
        if k in per_elem:
            rec["bytes"] = per_elem[k] * SIZES[0]
        rec["main"] = (rec["times"]["partial"] if k == "K5" else
                       rec["times"][PROBE_N if k == "K7" else SIZES[0]])
        rec["lib_ms"] = {"K1": rec["lib"].get(SIZES[0]),
                         "K7": rec["lib"].get(PROBE_N)}.get(k)
    per_call = {k: {"in-core 16M build": incore.get(k, 0),
                    "streamed bucket": streamed.get(k, 0) / buckets,
                    "deep 16M build": deep.get(k, 0),
                    f"mesh 16M build ({MESH_SHARDS} shards)": mesh.get(k, 0),
                    "padded grouped entry": api_calls.get(k, 0),
                    "viewer frame": (launches["K5"] / VIEW_FRAMES
                                     if k == "K5" else 0),
                    "--gl frame": (None if viewers["gl"] is None else
                                   viewers["gl"] / VIEW_FRAMES
                                   if k == "K5" else 0),
                    "windowed frame": (viewers["window"] / WINDOW_FRAMES
                                       if k == "K5" else 0)}
                for k in kernels}
    bound = bounds(record, probes, per_call)

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": record[k]["err"],
         "ms": record[k]["main"][0], "plain_ms": record[k]["main"][1],
         "bound_ms": bound[k]["bound_ms"], "bound_by": bound[k]["bound_by"],
         "library_ms": record[k]["lib_ms"], "lib_ms": record[k]["lib_ms"],
         "bytes": record[k]["bytes"],
         "bound_probe_ms": bound[k]["bound_probe_ms"],
         "launches_per_call": per_call[k],
         "device_ms": record[k].get("device_ms"),
         "device_ops_per_call": record[k].get("device_ops"),
         "back_to_back_ms": record[k]["train"].get(SIZES[0]),
         "setups": bound[k].get("setups")}
        for k, (name, _, src, rep) in kernels.items()
    ]}
    leaked = sorted(m for m in sys.modules if finder.refused(m))
    if leaked:
        raise AssertionError(f"modules of jax or the JAX package loaded: "
                             f"{leaked}")
    log(f"total {time.perf_counter() - t_start:.3f} s; card: {smi}")
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
