"""Timing breadcrumbs, `timed` and `timed_phase`, and the CLI's box parser
`parse_aabb` (copy of point_cloud_viewer_tpu/utils/progress.py:51-81 and
104-115; `build_octree(progress=True)` passes `echo`)."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Iterator, Optional


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


@contextlib.contextmanager
def timed_phase(phase_times: Optional[dict], key: str,
                echo: Optional[str] = None) -> Iterator[None]:
    """Accumulate wall time into phase_times[key] (no-op dict when None);
    with `echo`, also print a `timed`-style breadcrumb.  Records on
    exceptions too (try/finally), so a failed phase still shows where the
    time went."""
    t0 = time.perf_counter()
    try:
        if echo is not None:
            with timed(echo):
                yield
        else:
            yield
    finally:
        if phase_times is not None:
            phase_times[key] = (
                phase_times.get(key, 0.0) + time.perf_counter() - t0
            )


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
