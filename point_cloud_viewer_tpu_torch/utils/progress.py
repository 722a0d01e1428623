"""The stderr progress bar `ProgressBar`, timing breadcrumbs `timed` and
`timed_phase`, and the CLIs' parsers `parse_key_val` and `parse_aabb` (copy
of point_cloud_viewer_tpu/utils/progress.py:13-50, 51-81 and 96-115;
`build_octree(progress=True)` passes `echo`, the x-ray build draws a
`ProgressBar`), and `torch_trace`, the twin of its `jax_trace` (:84-93).

The port's spans: `span(name)` and `count(name, n)` record only while a
torch.profiler session runs in the process.  A span then puts a
`record_function` range on the profiler's timeline (a `user_annotation`
event in its Chrome trace) and adds [calls, seconds] into a process-wide
table; a counter adds n to its entry's first number.  `span_totals()`
reads the table, from any thread's spans.  With no profiler running, a
span is one flag check.  `timed_phase` opens `span("build." + key)`."""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional


class ProgressBar:
    """Minimal stderr progress bar, thread-safe, refreshing at most every
    `refresh_s` seconds (the reference uses pbr with 2s refresh)."""

    def __init__(self, total: int, message: str = "", refresh_s: float = 2.0,
                 stream=None) -> None:
        self.total = max(total, 1)
        self.message = message
        self.refresh_s = refresh_s
        self.count = 0
        self._lock = threading.Lock()
        self._last = 0.0
        self._start = time.time()
        self._stream = stream or sys.stderr
        self._render(force=True)

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.count += n
            self._render()

    def _render(self, force: bool = False) -> None:
        now = time.time()
        if not force and now - self._last < self.refresh_s:
            return
        self._last = now
        pct = 100.0 * self.count / self.total
        self._stream.write(f"\r{self.message}: {self.count}/{self.total} ({pct:.0f}%)")
        self._stream.flush()

    def finish(self) -> None:
        with self._lock:
            self._render(force=True)
            elapsed = time.time() - self._start
            self._stream.write(f" done in {elapsed:.1f}s\n")
            self._stream.flush()



@contextlib.contextmanager
def timed(label: str, stream=None) -> Iterator[None]:
    """Timing breadcrumb: prints '<label>: X.XXXs' on exit."""
    stream = stream or sys.stderr
    start = time.perf_counter()
    try:
        yield
    finally:
        stream.write(f"{label}: {time.perf_counter() - start:.3f}s\n")
        stream.flush()


# The span table and the lock that guards it and every phase_times addition
# made through timed_phase (the build's write pool adds from its threads).
_lock = threading.Lock()
_totals: Dict[str, List[float]] = {}


def _profiling() -> bool:
    """Whether a torch.profiler session runs: torch's own module-level flag,
    which worker threads see too.  Without torch loaded none can run."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _add_total(name: str, calls: int, seconds: float) -> None:
    with _lock:
        entry = _totals.setdefault(name, [0, 0.0])
        entry[0] += calls
        entry[1] += seconds


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A named range of host time: while a torch.profiler session runs, a
    `record_function(name)` range on the trace's clock and [1, seconds]
    added into the span table under `name`; otherwise nothing."""
    if not _profiling():
        yield
        return
    import torch

    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _add_total(name, 1, time.perf_counter() - t0)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` in the span table while a profiler
    session runs (its entry reads [total, 0.0])."""
    if _profiling():
        _add_total(name, n, 0.0)


def span_totals() -> Dict[str, List[float]]:
    """A copy of the span table: name -> [calls, seconds] of a span, or
    [total, 0.0] of a counter, summed over threads since the last reset."""
    with _lock:
        return {name: list(entry) for name, entry in _totals.items()}


def reset_span_totals() -> None:
    with _lock:
        _totals.clear()


@contextlib.contextmanager
def timed_phase(phase_times: Optional[dict], key: str,
                echo: Optional[str] = None) -> Iterator[None]:
    """Accumulate wall time into phase_times[key] (no-op dict when None);
    with `echo`, also print a `timed`-style breadcrumb.  Records on
    exceptions too (try/finally), so a failed phase still shows where the
    time went.  The phase is also `span("build." + key)`, and additions
    from several threads into one dict are safe."""
    t0 = time.perf_counter()
    try:
        with span("build." + key):
            if echo is not None:
                with timed(echo):
                    yield
            else:
                yield
    finally:
        if phase_times is not None:
            with _lock:
                phase_times[key] = (
                    phase_times.get(key, 0.0) + time.perf_counter() - t0
                )


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Wrap a region in a torch.profiler trace when log_dir is given: the
    twin of the JAX package's `jax_trace` (progress.py:84-93), which wraps
    it in a jax.profiler trace.  Without log_dir it does nothing.

    The profile records CPU activity of every thread (the query client's
    workers and the build's write pool too, with their spans) and, where
    torch sees a card, CUDA activity (kernels, memcpys, memsets).  On exit, also when the region
    raises, one Chrome trace is written into log_dir (created if absent)
    as `trace.<pid>.<ns>.json`; a failure to write it raises."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace.{os.getpid()}.{time.time_ns()}.json")
    prof = profile(activities=activities,
                   experimental_config=torch._C._profiler._ExperimentalConfig(
                       profile_all_threads=True))
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        if not os.path.isfile(path):
            raise OSError(f"torch_trace: no trace written to {path}")


def parse_key_val(s: str):
    """'KEY=value' -> (key, value) (reference: src/utils.rs:10-21)."""
    if "=" not in s:
        raise ValueError(f"invalid KEY=value: no '=' found in {s!r}")
    key, value = s.split("=", 1)
    return key, value


def parse_aabb(s: str):
    """'minx,miny,minz,maxx,maxy,maxz' -> Aabb, validating the length (a
    typo'd count would otherwise broadcast into a silently wrong box)."""
    from ..math.geometry import Aabb

    v = [float(x) for x in s.split(",")]
    if len(v) != 6:
        raise ValueError(
            f"--aabb needs 6 comma-separated values "
            f"(minx,miny,minz,maxx,maxy,maxz), got {len(v)}"
        )
    return Aabb(v[:3], v[3:])
