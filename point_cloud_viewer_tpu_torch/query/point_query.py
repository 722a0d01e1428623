"""PointQuery: what to fetch (attributes), where (location), and attribute
interval filters (reference: src/iterator.rs:66-72).

Port of point_cloud_viewer_tpu/query/point_query.py:1-79: `filter_batch`
takes the PyTorch `device` of the per-point mask and a FilterStats to
tally its work."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ..core.points_batch import PointsBatch
from ..math.intervals import ClosedInterval
from .location import AllPoints, PointLocation, location_for


@dataclass
class PointQuery:
    attributes: List[str] = field(default_factory=list)
    location: PointLocation = field(default_factory=AllPoints)
    filter_intervals: Dict[str, ClosedInterval] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.location = location_for(self.location)

    def _apply_intervals(self, batch: PointsBatch, keep: np.ndarray) -> np.ndarray:
        for attrib, interval in self.filter_intervals.items():
            data = batch.attributes.get(attrib)
            if data is None:
                raise KeyError(
                    "Filter attribute needs to be specified as query attribute."
                )
            if data.ndim != 1:
                raise ValueError(
                    f"interval filter on non-scalar attribute {attrib}"
                )
            keep = keep & interval.contains(data)
        return keep

    def filter_batch(
        self,
        batch: PointsBatch,
        use_device: bool = False,
        skip_geometry: bool = False,
        device="cuda",
        stats=None,
    ) -> PointsBatch:
        """Apply geometric culling + interval filters to a decoded node batch
        (the reference's FilteredIterator, src/iterator.rs:93-119).

        `use_device`: the per-point mask runs in f64 on the PyTorch `device`
        (query/device_filter.py), bit-equal to the host mask for all six
        geometries with or without intervals; `stats` (a
        device_filter.FilterStats) tallies its rows.  Only a custom
        location type, or a filter attribute that is missing or not
        numeric, takes the host path (which then raises as it would
        without `use_device`); a failure on the device raises.

        `skip_geometry`: the caller certifies every point passes the
        geometric test (node fully inside the query — see
        nodes_in_location_ex), so only interval filters run.  AllPoints
        queries take the same shortcut unconditionally."""
        if skip_geometry or isinstance(self.location, AllPoints):
            if not self.filter_intervals:
                return batch
            keep = self._apply_intervals(batch, np.ones(len(batch), dtype=bool))
        else:
            keep = None
            if use_device:
                from .device_filter import point_filter_mask

                # Returns None for host-only queries — including missing
                # or non-scalar filter attributes, so the host path below
                # keeps raising the same errors.
                keep = point_filter_mask(
                    self.location, batch.position,
                    intervals=self.filter_intervals, attributes=batch.attributes,
                    device=device, stats=stats,
                )
            if keep is None:
                keep = self._apply_intervals(
                    batch, self.location.contains(batch.position)
                )
        if keep.all():
            return batch
        return batch.retain(keep)
