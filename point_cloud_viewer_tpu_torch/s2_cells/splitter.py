"""S2Splitter: build an S2 point cloud by routing batches into per-cell
files (reference: src/read_write/s2.rs:14-174).

Vectorized: one pass computes every point's level-`split_level` cell
(leaf-id parent arithmetic), then points are grouped with a single argsort
and appended to per-cell files.  ECEF validity (Earth radius band) and
attribute-schema consistency are enforced as in the reference.

Copy of point_cloud_viewer_tpu/s2_cells/splitter.py:1-179, unchanged.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Union

import numpy as np

from ..core.attributes import AttributeDataType
from ..core.constants import CURRENT_VERSION, META_FILENAME
from ..core.points_batch import PointsBatch
from ..math import s2
from ..math.geometry import Aabb
from ..math.wgs84 import EARTH_RADIUS_MAX_M, EARTH_RADIUS_MIN_M
from ..protos.meta import (
    AttributeProto,
    BoundingBoxProto,
    MetaProto,
    S2CellProto,
    S2MetaProto,
)
from ..core.attributes import attribute_extension

DEFAULT_S2_SPLIT_LEVEL = 20  # cells of roughly 10m x 10m


class S2Splitter:
    def __init__(
        self,
        directory: str,
        split_level: int = DEFAULT_S2_SPLIT_LEVEL,
        max_open_writers: int = 4096,
    ) -> None:
        """max_open_writers bounds the LRU of open per-cell file handles.

        The reference keeps 25 open writers (src/read_write/s2.rs:14-135);
        measured here (ROUND_NOTES r5) a cap of 25 thrashes — each batch
        appends its cells in sorted order, so with more cells per batch
        than the cap, LRU hits nothing and the bookkeeping makes it SLOWER
        than plain open-per-append.  A cap comfortably above the per-batch
        working set (4096, clamped to half the soft fd limit after the
        rlimit bump) wins ~1.5-2x on the append path.  0 disables caching
        (one open/close pair per cell file per batch)."""
        from collections import OrderedDict

        from ..io.node_io import attempt_increasing_rlimit_to_max

        self.directory = directory
        self.split_level = split_level
        self.cell_stats: Dict[int, int] = {}
        self.bounding_box: Optional[Aabb] = None
        self.attributes_seen: Dict[str, AttributeDataType] = {}
        self._truncated: set = set()
        attempt_increasing_rlimit_to_max()
        try:
            import resource

            soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
            if soft != resource.RLIM_INFINITY:
                max_open_writers = min(max_open_writers, max(soft // 2, 0))
        except Exception:  # noqa: BLE001 - non-posix: keep the default
            pass
        self._max_open_writers = max_open_writers
        self._writers: "OrderedDict[str, object]" = OrderedDict()
        os.makedirs(directory, exist_ok=True)

    def write(self, batch: PointsBatch) -> None:
        self._check_attributes(batch)
        pos = batch.position
        radius = np.linalg.norm(pos, axis=1)
        bad = (radius > EARTH_RADIUS_MAX_M) | (radius < EARTH_RADIUS_MIN_M)
        if bad.any():
            i = int(np.nonzero(bad)[0][0])
            raise ValueError(
                f"Point ({pos[i,0]}, {pos[i,1]}, {pos[i,2]}) is not a valid ECEF point"
            )
        if self.bounding_box is None:
            self.bounding_box = Aabb.bounding_points(pos)
        else:
            self.bounding_box.grow(pos.min(axis=0))
            self.bounding_box.grow(pos.max(axis=0))

        cells = s2.parent(s2.leaf_cell_ids_from_points(pos), self.split_level)
        order = np.argsort(cells, kind="stable")
        sorted_cells = cells[order]
        unique, starts = np.unique(sorted_cells, return_index=True)
        ends = np.append(starts[1:], len(sorted_cells))
        sorted_batch = batch.take(order)
        for cid, s0, s1 in zip(unique, starts, ends):
            self._append_cell(int(cid), sorted_batch.slice(int(s0), int(s1)))

    def _writer(self, path: str, mode: str):
        """An open file handle for `path` from the bounded LRU (or a fresh
        open when caching is disabled / the handle was evicted)."""
        if self._max_open_writers <= 0:
            return open(path, mode), True  # (handle, close_after_use)
        f = self._writers.pop(path, None)
        if f is None:
            f = open(path, mode)
        self._writers[path] = f
        if len(self._writers) > self._max_open_writers:
            _, old = self._writers.popitem(last=False)
            old.close()
        return f, False

    def _close_writers(self) -> None:
        for f in self._writers.values():
            f.close()
        self._writers.clear()

    def _append_cell(self, cell_id: int, batch: PointsBatch) -> None:
        token = s2.token(cell_id)
        stem = os.path.join(self.directory, token)
        mode = "ab" if cell_id in self._truncated else "wb"
        self._truncated.add(cell_id)
        f, close = self._writer(stem + ".xyz", mode)
        f.write(np.ascontiguousarray(batch.position, dtype="<f8").tobytes())
        if close:
            f.close()
        for name, arr in batch.attributes.items():
            f, close = self._writer(
                stem + "." + attribute_extension(name), mode
            )
            f.write(np.ascontiguousarray(arr).tobytes())
            if close:
                f.close()
        self.cell_stats[cell_id] = self.cell_stats.get(cell_id, 0) + len(batch)

    def _check_attributes(self, batch: PointsBatch) -> None:
        dtypes = batch.data_types()
        if not self.attributes_seen:
            self.attributes_seen = dtypes
        elif self.attributes_seen != dtypes:
            raise ValueError(
                f"attribute schema mismatch: {dtypes} vs {self.attributes_seen}"
            )

    def finish(self) -> MetaProto:
        """Write meta.pb and return the proto."""
        self._close_writers()  # flush before anything reads the cell files
        bbox = self.bounding_box or Aabb.zero()
        meta = MetaProto(
            version=CURRENT_VERSION,
            bounding_box=BoundingBoxProto(min=tuple(bbox.mins), max=tuple(bbox.maxs)),
            s2=S2MetaProto(
                cells=[
                    S2CellProto(id=cid, num_points=n)
                    for cid, n in sorted(self.cell_stats.items())
                ],
                attributes=[
                    AttributeProto(name, dt)
                    for name, dt in self.attributes_seen.items()
                ],
            ),
        )
        with open(os.path.join(self.directory, META_FILENAME), "wb") as f:
            f.write(meta.encode())
        return meta


def build_s2_cloud(
    directory: str,
    data: Union[PointsBatch, Iterable[PointsBatch]],
    split_level: int = DEFAULT_S2_SPLIT_LEVEL,
) -> MetaProto:
    splitter = S2Splitter(directory, split_level)
    if isinstance(data, PointsBatch):
        data = [data]
    for batch in data:
        splitter.write(batch)
    return splitter.finish()
