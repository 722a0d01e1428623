#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (point_cloud_viewer_tpu_torch) on
one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
  1. device  -- require CUDA; print the card's name and power limit; a
                meta-path finder refuses every import of jax and of the JAX
                package (point_cloud_viewer_tpu), so the run proves the port
                stands alone;
  2. build   -- compile the port's CUDA kernels (csrc/*.cu) with nvcc and,
                beside them, its host library (native/pcv_native.cpp) with
                g++, so no later wall time holds a build;
  3. kernels -- K1-K4 against their plain PyTorch versions on the card, at
                16M and 64M elements (ragged n), bit for bit (K4, the
                public one-level entry, at every level), and at 16M K1 (six
                modes) and K2 (every level) on views at element offsets 1-3
                (unaligned bases) and K2 on an input whose only start is
                element 0; CUDA-event median times of kernel and plain
                version, K1 over torch.cumsum;
  4. core    -- the device derivation (build_tree_device_codes_grouped) at
                16M and 64M synthetic codes on the card against the same
                call on CPU tensors (the kernels' plain versions), every
                output bit for bit; where its time goes, step by step
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
                axes, K = 0, a 64-frame batch), bit for bit, with CUDA-event
                medians; b. DeviceCullSession.step / step_frames on the card
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
                c. phase 5's PLY through cli.build_octree --use_device
                --streaming, byte-compared with phase 5's in-core output, then
                a 64M-point PLY built in core and streamed on the card and
                byte-compared; per-bucket phase times, bytes up and down, the
                bucket count, the streaming path's K1-K4 launches and the
                share of the card's bucket time the host waited for;
  8. probe + bounds -- K7 (copy, triad, add3) against its plain version
                at 128,000,000 and ragged n, bit for bit; the streaming-
                bandwidth probes (hbm_probes: add_1d, add_2d, copy, triad,
                add3) and torch.add's time; then, for K1-K7, the least bytes
                a launch moves, its launches per main-path call (16M
                in-core build, streamed bucket, viewer frame), its bound
                (bytes over the card's memory rate -- the larger of its
                published peak and the measured probe rate -- or K5's f32
                operations over the card's published f32 peak where
                larger), the bytes over the probe rate alone, and kernel,
                plain and library times beside them.

The CPU route itself is held to the JAX package by tests/test_torch_*.py.
Every line but the last three starts with the card's name and power limit
as nvidia-smi prints them; the third line from the end is that label
alone, the one before the last a JSON object {"kernels": [...]}, the last
{"ok": true, "device": {...}}.  Imports nothing of JAX and nothing of the
JAX package.
"""

from __future__ import annotations

import contextlib
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
E2E_POINTS = 16_000_000              # phase 5: the README's in-core cloud
BIG_POINTS = 64_000_000              # phase 7c: a ~2 GB PLY, streamed
LEAF_MAX_POINTS = 100_000            # MAX_POINTS_PER_NODE
CULL_NODES = 1_048_576               # phase 6: bench.py's 1M-node tree
CULL_BATCH = 64                      # phase 6a: bench.py's batched orbit
VIEW_FRAMES = 60                     # phase 6b/c: cli.view's default orbit
DEPTH = 21                           # the 63-bit code budget
REPS = 5                             # timed repetitions (median reported)
PROBE_N = 128_000_000                # phase 8: bench.py:145's probe size
PROBE_RAGGED = (1, 3, 5, 4097, 1_000_003)
PROBE_ITERS = 20                     # bench.py:144
# f32 rate outside the tensor cores, NVIDIA H100 SXM data sheet (an FMA
# counts two operations), at the 700 W power limit.
FP32_PEAK_OPS = 67e12
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


def train_ms(fn, count: int = 20) -> float:
    """Median over REPS of the mean CUDA-event time in ms of `count`
    back-to-back calls of fn: once the card is busy, the host's time to
    enqueue each call hides behind the one before, so this is the device
    time of a call (cuda_ms adds the host's time to the first launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            fn()
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
            if level == 8:
                snap["leaf"] = (leaf.clone(), found.clone(), ss_p)
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
            del cases, start_only
        log(f"K2/K3 {tag}: {DEPTH} levels bit-equal; K4 promote_pass {tag}: "
            f"{DEPTH} levels ({promoted_levels} non-empty) bit-equal; leaf "
            "levels "
            f"{torch.bincount(leaf, minlength=DEPTH + 1).tolist()}")

        lf, fd, ss_p = snap["leaf"]
        times = {
            "K2": (cuda_ms(lambda: LC.seg_start_pass(b, 8)),
                   cuda_ms(lambda: LC.seg_start_pass_plain(b, 8))),
            "K3": (cuda_ms(lambda l, f: LC.leaf_update_pass(b, ss_p, l, f, 8,
                                                            100_000),
                           lambda: (lf.clone(), fd.clone())),
                   cuda_ms(lambda l, f: LC.leaf_update_pass_plain(
                       b, ss_p, l, f, 8, 100_000),
                           lambda: (lf.clone(), fd.clone()))),
            "K4": (cuda_ms(lambda c: LC.promote_pass(b, c, busiest[1]),
                           lambda: (snap["cur"].clone(),)),
                   cuda_ms(lambda c: LC.promote_pass_plain(b, c, busiest[1]),
                           lambda: (snap["cur"].clone(),))),
        }
        log(f"K2 seg_start_pass {tag}, level 8, 20 calls back to back: "
            f"kernel {train_ms(lambda: LC.seg_start_pass(b, 8)):.4f} ms a "
            "call")
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
    tensors, every output bit for bit."""
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
    rows = np.empty(n, dtype=[("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
                              ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                              ("intensity", "<f4")])
    half = n // 2
    extent = np.array([200.0, 200.0, 40.0])
    pos = np.empty((n, 3))
    pos[:half] = rng.random((half, 3)) * extent
    centers = rng.random((64, 3)) * extent
    which = rng.integers(0, 64, n - half)
    pos[half:] = centers[which] + rng.normal(0.0, 0.5, (n - half, 3))
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
    card's octree directory (kept for phases 6 and 7c), the PLY (kept for
    7c) and the card build's wall seconds."""
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
    return launches, a_dir, ply, wall

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


def phase_cull_kernel(record: dict) -> tuple:
    """6a: K5 against its plain version on the card at CULL_NODES nodes,
    bit for bit; returns the node table (mins, edges, num_points)."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC
    from point_cloud_viewer_tpu_torch.ops import culling as C

    dev = torch.device(DEVICE)
    mins, edges, num_points = synthetic_node_table(CULL_NODES, seed=5)
    table = [torch.from_numpy(a).to(dev) for a in
             (mins.astype(np.float32), edges.astype(np.float32),
              num_points.astype(np.int32))]
    frusta = cull_frusta(C)

    def frame(frustum, a_cap):
        axes, qmin, qmax = C.frustum_axes_and_projections(frustum)
        padded = C.pad_cull_axes(axes, qmin, qmax, a_cap)
        arrays = (frustum.clip_from_query.astype(np.float32), *padded)
        return [torch.from_numpy(a).to(dev) for a in arrays], len(axes)

    # The session's growth rule (culling.py:220-224) past K5's 32 axes.
    grown = C.DeviceCullSession(mins, edges, num_points, axis_capacity=8,
                                device=dev)
    grown.step(frusta["off_axis"])
    off_axis, n_axes = frame(frusta["off_axis"], grown.a_cap)
    if not grown.a_cap > 32:
        raise AssertionError(f"a_cap {grown.a_cap} <= 32 ({n_axes} axes)")
    mats, axs, qns, qxs = C.prep_frustum_frames(frusta["orbit"], 32)
    batch = [torch.from_numpy(a).to(dev) for a in (mats, axs, qns, qxs)]
    cases = {
        "partial": (frame(frusta["partial"], 32)[0], table),
        "all visible": (frame(frusta["all"], 32)[0], table),
        f"off-axis, {grown.a_cap} axes": (off_axis, table),
        "K = 0": (frame(frusta["partial"], 32)[0],
                  [t[:0] for t in table]),
        f"{CULL_BATCH} frames": (batch, table),
    }
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
            f"visible {visible}, launches {launched}, max_abs_err "
            f"(sizes, visible, priority) {errs}")
        record["K5"]["err"] = max(record["K5"]["err"], *errs)
        if any(errs) or launched != (1 if nodes[0].shape[0] else 0):
            raise AssertionError(f"K5 {name}: errors {errs}, launches "
                                 f"{launched}")
        if name == "all visible" and visible != CULL_NODES:
            raise AssertionError(f"K5 all visible: {visible} visible")
        if name == "partial" and not 0 < visible < CULL_NODES:
            raise AssertionError(f"K5 partial view: {visible} visible")

    times = {}
    for name in ("partial", f"{CULL_BATCH} frames"):
        per_frame, nodes = cases[name]
        times[name] = (cuda_ms(lambda: CC.cull_lod(*per_frame, *nodes)),
                       cuda_ms(lambda: CC.cull_lod_plain(*per_frame, *nodes)))
        log(f"K5 {name} at K={CULL_NODES}: kernel {times[name][0]:.4f} ms, "
            f"plain {times[name][1]:.4f} ms")
    record["K5"]["times"] = times
    record["K5"]["bytes"], record["K5"]["ops"] = cull_work(
        *cases["partial"])
    return mins, edges, num_points


def cull_work(per_frame, nodes) -> tuple:
    """(bytes, f32 operations) that one single-frame K5 launch needs on
    these inputs: every input read once and every output (size, visible,
    priority) written once; per node 271 operations for the corners and
    the screen size, plus 56 for each SAT axis tested up to the first that
    separates (csrc/cull.cu stops there)."""
    import torch

    matrix, axes, qmin, qmax = per_frame
    mins, edges, _ = nodes
    k, a_cap = edges.shape[0], axes.shape[0]
    nbytes = (sum(t.numel() * t.element_size() for t in (*per_frame, *nodes))
              + k * (4 + 1 + 4))
    unit = torch.tensor([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                         for c in range(8)], dtype=torch.float32,
                        device=mins.device)
    corners = mins[:, None, :] + unit[None] * edges[:, None, None]
    tested = torch.full((k,), a_cap, dtype=torch.int64, device=mins.device)
    alive = torch.ones(k, dtype=torch.bool, device=mins.device)
    for j in range(a_cap):
        u = axes[j]
        p = corners[..., 0] * u[0] + corners[..., 1] * u[1] + corners[..., 2] * u[2]
        separated = (p.amin(1) > qmax[j]) | (p.amax(1) < qmin[j])
        tested[alive & separated] = j + 1
        alive &= ~separated
    return nbytes, 271 * k + 56 * int(tested.sum())


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
    """Where one step's time goes (culling.py DeviceCullSession.step,
    piece by piece, host clock with a sync after each), median over the
    orbit, plus CUDA-event times of the kernel and the sort."""
    import torch

    from point_cloud_viewer_tpu_torch.ops import cull_cuda as CC
    from point_cloud_viewer_tpu_torch.ops import culling as C

    table = (card._mins, card._edges, card._num_points)
    parts = {"host prep": [], "upload": [], "kernel": [], "sort": [],
             "fetch": []}
    for f in frusta:
        t0 = time.perf_counter()
        padded = card._pad(*C.frustum_axes_and_projections(f))
        t1 = time.perf_counter()
        args = [card._put(a) for a in
                (f.clip_from_query.astype(np.float32), *padded)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        sizes, visible, priority = CC.cull_lod(*args, *table)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        order = torch.sort(-priority, stable=True).indices.to(torch.int32)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for t in (order, sizes, visible):
            t.cpu().numpy()
        t5 = time.perf_counter()
        for key, a, b in zip(parts, (t0, t1, t2, t3, t4), (t1, t2, t3, t4,
                                                           t5)):
            parts[key].append(b - a)
    kernel_ms = cuda_ms(lambda: CC.cull_lod(*args, *table))
    sort_ms = cuda_ms(lambda: torch.sort(-priority, stable=True))
    log("session split, 1M table, orbit medians (host clock, ms): "
        + ", ".join(f"{k} {statistics.median(v) * 1e3:.4f}"
                    for k, v in parts.items())
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


def kernel_split(fn, reps: int = 5) -> dict:
    """Device ms of each CUDA kernel that fn launches, by name, averaged
    over `reps` calls after a warm-up (torch.profiler); {} when the
    profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and "pcv::" in ev.key:
            name = re.sub(r"^(void )?pcv::\(anonymous namespace\)::", "",
                          ev.key).split("(")[0]
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


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
    every intermediate is deleted once compared.  Returns the 16M
    streaming path's launch counts and its number of buckets derived on
    the card."""
    spill = os.path.join(tmp, "spill")
    out = os.path.join(tmp, "streamed16")
    wall, phases16, launches16 = streaming_cli(ply16, out, spill, wrappers)
    files = dirs_byte_equal(incore16, out)
    log(f"streaming 16M: == phase 5's in-core card build, {files} files "
        f"byte-equal; wall streamed {wall:.3f} s vs in core "
        f"{incore16_wall:.3f} s")
    os.remove(ply16)
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
        calls = ", ".join(f"{where} {n:.3f}" for where, n in per_call[k].items())
        log(f"bound {k}: {rec['bytes']} B"
            + (f", {rec['ops']} f32 ops" if "ops" in rec else "")
            + f"; launches per call: {calls}; bound {bound:.4f} ms ({by}); "
            f"kernel {ms:.4f} ms = {ms / bound:.2f}x bound; bytes over the "
            f"probe rate {out[k]['bound_probe_ms']:.4f} ms; plain "
            f"{pms:.4f} ms; library "
            + ("none (no single call)" if lib is None else f"{lib:.4f} ms"))
    return out


def main() -> int:
    finder = RefuseJaxPackage()
    sys.meta_path.insert(0, finder)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from point_cloud_viewer_tpu_torch import native
    from point_cloud_viewer_tpu_torch.ops import _ext
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
    record = {k: {"err": 0, "times": {}, "lib": {}}
              for k in kernels}
    phase_kernels(record)
    phase_core()
    build = {k: v[1] for k, v in kernels.items()
             if k in BUILD_PATH + OFF_PATH}
    build["K4 pass"] = LC.promote_pass
    tmp = tempfile.mkdtemp(prefix="pcv_chip_smoke_")
    try:
        launches, octree_dir, ply, incore_wall = phase_e2e(build, tmp)
        incore = dict(launches)
        table = phase_cull_kernel(record)
        phase_cull_session(octree_dir, table)
        launches["K5"] = phase_view(octree_dir, tmp)
        phase_leaf_levels(record)
        phase_promote(record)
        streamed, buckets = phase_streaming(build, tmp, ply, octree_dir,
                                            incore_wall)
        log(f"launches on the in-core path (phase 5) {json.dumps(incore)}; "
            f"on the streaming path (phase 7c, 16M, {buckets} buckets) "
            f"{json.dumps(streamed)}; K5 in the viewer (phase 6c, "
            f"{VIEW_FRAMES} frames) {launches['K5']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches["K7"], probes = phase_probe(record)

    # Bytes a launch moves at the timed shape (n = SIZES[0] for K1-K4 and
    # K6): K1 i32 in + out; K2 u8 b in, i32 seg_start out; K3 b, seg_start,
    # leaf and found in, leaf and found out; K4 (the promotion stage, every
    # level) b and leaf in, the final levels out; K6 (the leaf stage) i64
    # codes in, u8 b and u8 leaf out.  K5 and K7 were counted in their
    # phases.
    per_elem = {"K1": 8, "K2": 5, "K3": 9, "K4": 3, "K6": 10}
    for k, rec in record.items():
        if k in per_elem:
            rec["bytes"] = per_elem[k] * SIZES[0]
        rec["main"] = (rec["times"]["partial"] if k == "K5" else
                       rec["times"][PROBE_N if k == "K7" else SIZES[0]])
        rec["lib_ms"] = {"K1": rec["lib"].get(SIZES[0]),
                         "K7": rec["lib"].get(PROBE_N)}.get(k)
    per_call = {k: {"in-core 16M build": incore.get(k, 0),
                    "streamed bucket": streamed.get(k, 0) / buckets,
                    "viewer frame": (launches["K5"] / VIEW_FRAMES
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
         "launches_per_call": per_call[k]}
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
