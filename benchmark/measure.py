"""The benchmark's arithmetic: end-to-end statistics over a window's units,
the published peaks of the card, and roofline shares."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates: HBM3 bandwidth and f32 outside
# the tensor cores.  Shares are stated against these, with the card's
# power limit printed beside them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile over all values (linear between ranks)."""
    if len(values) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def rate(work: Iterable[float], t_open: float, ends: Iterable[float]) -> float:
    """All work over all time: the work of every unit started in the window
    over the time from the window's opening until the last of them ends."""
    work = list(work)
    ends = list(ends)
    if not work:
        raise ValueError("no units")
    return float(sum(work)) / (max(ends) - t_open)


def roofline_share(nbytes: float, flops: float, seconds: float) -> Optional[float]:
    """Percent of the card's peak: the least time the work needs (the
    larger of bytes over peak bandwidth and operations over peak f32 rate)
    over the time it took.  None where nothing was timed."""
    if not seconds or seconds <= 0:
        return None
    least = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S)
    return 100.0 * least / seconds


def idle_share(busy_s: float, window_s: float) -> Optional[float]:
    if not window_s or window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / window_s)


def kernel_seconds_per_launch(kernels: dict, names: Sequence[str],
                              launches_of: str) -> Optional[float]:
    """Device seconds of the named kernels over the launches of
    `launches_of` (one launch of a multi-kernel stage); None without one."""
    launches = kernels.get(launches_of, [0, 0.0])[0]
    if launches == 0:
        return None
    return sum(kernels.get(n, [0, 0.0])[1] for n in names) / launches
