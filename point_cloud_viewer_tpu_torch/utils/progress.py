"""Timing breadcrumbs: `timed_phase` (copy of
point_cloud_viewer_tpu/utils/progress.py:63-81, without its `echo`
option, which no caller of the port passes)."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def timed_phase(phase_times: Optional[dict], key: str) -> Iterator[None]:
    """Accumulate wall time into phase_times[key] (no-op dict when None).
    Records on exceptions too (try/finally), so a failed phase still shows
    where the time went."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if phase_times is not None:
            phase_times[key] = (
                phase_times.get(key, 0.0) + time.perf_counter() - t0
            )
