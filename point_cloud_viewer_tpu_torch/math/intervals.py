"""Closed intervals for attribute filtering (reference: src/math/mod.rs:67-111).

Copy of point_cloud_viewer_tpu/math/intervals.py:1-30, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ClosedInterval:
    lower_bound: float
    upper_bound: float

    def __post_init__(self) -> None:
        if self.lower_bound > self.upper_bound:
            raise ValueError("Lower bound needs to be smaller or equal to upper bound.")

    def contains(self, values) -> np.ndarray:
        """Vectorized: (N,) values -> (N,) bool."""
        values = np.asarray(values, dtype=np.float64)
        return (self.lower_bound <= values) & (values <= self.upper_bound)

    @classmethod
    def from_str(cls, s: str) -> "ClosedInterval":
        """Parse 'lo,hi' (CLI filter syntax, reference src/utils.rs:10-21)."""
        bounds = s.split(",")
        if len(bounds) != 2:
            raise ValueError("An interval needs to be defined by exactly 2 bounds.")
        return cls(float(bounds[0]), float(bounds[1]))
