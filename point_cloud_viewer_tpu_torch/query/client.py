"""PointCloudClient: unified streaming queries over many point clouds.

The reference runs a crossbeam work-stealing pool with a bounded channel
back to the consumer (src/iterator.rs:226-334, point_cloud_client/src/lib.rs).
Here: a thread pool decodes + filters nodes (numpy releases the GIL for the
heavy ops), a bounded queue provides back-pressure, per-worker re-batchers
emit batches of exactly `batch_size`, and a consumer-side error cancels all
workers cooperatively — preserving the reference's early-stop semantics
(exercised by its tests, src/octree/tests.rs:83-136).

Port of point_cloud_viewer_tpu/query/client.py:1-235: the per-point
filter runs on the card by default (`device_filter=True`, `device="cuda"`),
as the port's build derives on the card by default.  Each worker masks
one node at a time through query/device_filter.py (for a box, OBB, frustum
or Web Mercator tile, one K8 round trip on a stream of its own with the
GIL released); `filter_stats` tallies the rows.  An octree node that K8
would mask, and that is not fully inside the region, is decoded on the card
too (device_filter.NodeDecode): the worker reads its files as stored and
gets back only the rows the query keeps.  While a torch.profiler session
runs, `stream` records the spans `query.select_nodes` (the node list, on the
caller's thread), `query.decode` and `query.mask` (each node, in the
workers) and the counters `query.nodes` (jobs a query), `query.decode.card`
and `query.decode.host` (nodes whose positions the card alone or the host
decoded; utils/progress.span).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

from ..core.constants import NUM_POINTS_PER_BATCH
from ..core.points_batch import PointsBatch
from ..math.geometry import Aabb
from ..utils.progress import count, span
from .point_query import PointQuery


class _Cancelled(Exception):
    pass


class _Rebatcher:
    """Accumulate filtered batches and emit exactly batch_size points
    (reference PointStream, src/iterator.rs:123-166)."""

    def __init__(self, batch_size: int, emit: Callable[[PointsBatch], None]) -> None:
        self.batch_size = batch_size
        self.emit = emit
        self.parts: List[PointsBatch] = []
        self.buffered = 0

    def push(self, batch: PointsBatch) -> None:
        if len(batch) == 0:
            return
        self.parts.append(batch)
        self.buffered += len(batch)
        while self.buffered >= self.batch_size:
            # Consume whole parts up to the boundary and split only the
            # straddling one: the tail is never re-copied, so one large
            # input batch costs O(T) row copies total, not O(T^2/batch).
            take: List[PointsBatch] = []
            need = self.batch_size
            while need > 0:
                part = self.parts[0]
                if len(part) <= need:
                    take.append(self.parts.pop(0))
                    need -= len(part)
                else:
                    tail = part.split_off(need)
                    take.append(self.parts[0])
                    self.parts[0] = tail
                    need = 0
            self.buffered -= self.batch_size
            self.emit(
                take[0] if len(take) == 1 else PointsBatch.concatenate(take)
            )

    def flush(self) -> None:
        if self.buffered:
            self.emit(PointsBatch.concatenate(self.parts))
            self.parts = []
            self.buffered = 0


class PointCloudClient:
    """Queries across a list of point clouds (octrees and/or S2 clouds).

    Defaults follow the reference builder (point_cloud_client/src/lib.rs:61-91):
    batch 500k points, cpus-1 threads, buffer of 4 in-flight batches.
    """

    def __init__(
        self,
        clouds: Sequence,
        batch_size: int = NUM_POINTS_PER_BATCH,
        num_threads: Optional[int] = None,
        buffer_size: int = 4,
        device_filter: bool = True,
        device="cuda",
    ) -> None:
        import os

        from ..device import resolve_device
        from .device_filter import FilterStats

        self.clouds = list(clouds)
        self.batch_size = batch_size
        self.num_threads = num_threads or max(1, (os.cpu_count() or 2) - 1)
        self.buffer_size = buffer_size
        # Per-point filtering in f64 on `device` (query/device_filter.py),
        # bit-equal to the host masks; device_filter=False filters on the
        # host.  Asking for CUDA without a card raises here.
        self.device_filter = device_filter
        self.device = resolve_device(device) if device_filter else None
        self.filter_stats = FilterStats()

    @classmethod
    def from_locations(cls, locations: Sequence[str], **kwargs) -> "PointCloudClient":
        """Open octree or S2 directories, dispatching on the meta contents
        (reference: point_cloud_client/src/lib.rs:108-132)."""
        from ..io.node_io import OnDiskDataProvider
        from ..octree.octree import Octree

        clouds = []
        for loc in locations:
            provider = OnDiskDataProvider(loc)
            meta = provider.meta_proto()
            if meta.octree is not None:
                clouds.append(Octree(provider))
            else:
                from ..s2_cells.container import S2Cells

                clouds.append(S2Cells(provider))
        return cls(clouds, **kwargs)

    def bounding_box(self) -> Aabb:
        box = None
        for cloud in self.clouds:
            b = cloud.bounding_box
            if box is None:
                box = Aabb(b.mins, b.maxs)
            else:
                box.grow(b.mins)
                box.grow(b.maxs)
        return box if box is not None else Aabb.zero()

    # ------------------------------------------------------------------

    def for_each_point_data(
        self, query: PointQuery, callback: Callable[[PointsBatch], None]
    ) -> None:
        """Stream every matching batch to `callback` (serially).  An
        exception raised by the callback cancels outstanding work and
        propagates."""
        for batch in self.stream(query):
            callback(batch)

    def stream(self, query: PointQuery) -> Iterator[PointsBatch]:
        """Lazily yield matching batches as worker threads produce them.

        Truly streaming: batches are yielded straight off the bounded
        worker queue (back-pressure holds workers when the consumer is
        slow), and abandoning the generator (break / .close()) cancels all
        outstanding work cooperatively — the reference's early-stop
        semantics (src/iterator.rs:226-334, src/octree/tests.rs:83-136)."""
        jobs: List[Tuple[object, object, bool]] = []
        with span("query.select_nodes"):
            for cloud in self.clouds:
                ex = getattr(cloud, "nodes_in_location_ex", None)
                if ex is not None:
                    # fully_inside nodes skip the per-point geometry mask
                    # (bit-exact by construction — see nodes_in_location_ex).
                    for node_id, fully in ex(query.location):
                        jobs.append((cloud, node_id, fully))
                else:
                    for node_id in cloud.nodes_in_location(query.location):
                        jobs.append((cloud, node_id, False))
        count("query.nodes", len(jobs))
        card = None
        if self.device_filter:
            from .device_filter import node_decode

            card = node_decode(query, self.clouds, self.device)

        out: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        cancel = threading.Event()
        job_iter = iter(jobs)
        job_lock = threading.Lock()
        _SENTINEL = object()

        def worker() -> None:
            def emit(batch: PointsBatch) -> None:
                while True:
                    if cancel.is_set():
                        raise _Cancelled()
                    try:
                        out.put(batch, timeout=0.1)
                        return
                    except queue.Full:
                        continue

            rebatcher = _Rebatcher(self.batch_size, emit)
            try:
                while not cancel.is_set():
                    with job_lock:
                        job = next(job_iter, None)
                    if job is None:
                        break
                    cloud, node_id, fully = job
                    if card is not None and card.takes(cloud, fully):
                        rebatcher.push(card.node_points(
                            cloud, node_id, stats=self.filter_stats))
                        continue
                    count("query.decode.host", 1)
                    with span("query.decode"):
                        batch = cloud.points_in_node(
                            node_id, attributes=query.attributes)
                    with span("query.mask"):
                        batch = query.filter_batch(
                            batch,
                            use_device=self.device_filter,
                            skip_geometry=fully,
                            device=self.device,
                            stats=self.filter_stats,
                        )
                    rebatcher.push(batch)
                rebatcher.flush()
            except _Cancelled:
                pass
            except BaseException as e:  # surfaced via the error slot
                errors.append(e)
                cancel.set()
            finally:
                emit_done()

        errors: List[BaseException] = []

        def emit_done() -> None:
            out.put(_SENTINEL)

        threads = [
            threading.Thread(
                target=worker, daemon=True, name="pcv-stream-worker"
            )
            for _ in range(self.num_threads)
        ]
        for t in threads:
            t.start()

        done_workers = 0
        try:
            while done_workers < len(threads):
                item = out.get()
                if item is _SENTINEL:
                    done_workers += 1
                    continue
                if cancel.is_set():
                    continue  # drain
                yield item
        finally:
            # Normal exhaustion, consumer exception, or an abandoned
            # generator all land here: cancel outstanding work, drain the
            # queue so blocked producers can emit their sentinel, join.
            cancel.set()
            while done_workers < len(threads):
                if out.get() is _SENTINEL:
                    done_workers += 1
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
