"""Headless viewer runtime of the port — the sdl_viewer's engine without the
window (copy of point_cloud_viewer_tpu/viewer/render_loop.py:35-461, with
the per-frame cull on a PyTorch device).

Reproduces the reference's interactive machinery
(sdl_viewer/src/lib.rs:350-611, node_drawer.rs):

* visible-node selection on a BACKGROUND thread; queued camera matrices are
  drained so only the latest wins (lib.rs:95-111),
* an LRU node cache sized max_nodes_in_memory = cache_size_mb * 5, filled by
  an async loader with at most 10 requests in flight (node_drawer.rs:263-336),
* point order within a node is SHUFFLED once at load, so drawing a prefix
  of 1/lod of the points is a uniform subsample (node_drawer.rs:185-201),
* an adaptive node budget while moving: shrink 10% when FPS < 20, grow 10%
  when FPS > 25 (lib.rs:220-227).

The visible set comes from the DeviceCullSession (ops/culling.py: K5 on
`device`, the default) or, with `device_cull=False`, from the octree's host
cull (the port's native library).  For the device cull:

* the session (`cull_session`) culls in the frame of the octree's root
  cube's centre, so a table in ECEF keeps its resolution in f32, and cuts
  each frame's list to the node cache's capacity on the device
  (`step_capped`); `node_id_list` turns the list into NodeIds with the
  cyclic collector paused (`collector_paused`);
* the session and, on a card, the kernel library are made when the
  renderer is constructed, on the calling thread, so nvcc never runs inside
  the daemon worker;
* a device error is never hidden: there is no host fallback and no "keep
  the previous visible set".  The worker keeps the first error and stops;
  `draw` and `shutdown` raise it.  A camera matrix that `Frustum` rejects
  (singular, non-finite) still skips the frame, as in the JAX package.

The draw target is the numpy software rasterizer or, with `use_gl`, the GL
pipeline (viewer/gl/viewer.py, on this engine and its cull); `run_headless`
writes the final frame as PNG with the standard library (`write_png`).
"""

from __future__ import annotations

import gc
import queue
import struct
import sys
import threading
import time
import zlib
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..math.geometry import Frustum
from ..octree.node_id import NodeId
from ..octree.octree import Octree
from ..ops.culling import DeviceCullSession
from ..utils.progress import span
from .camera import Camera
from .software_raster import draw_wireframe_boxes, rasterize_points

__all__ = ["Camera", "FrameStats", "Octree", "PointCloudRenderer",
           "cull_session", "node_id_list", "run_headless", "write_png"]

MAX_NODES_IN_FLIGHT = 10
FPS_LOWER, FPS_UPPER = 20.0, 25.0


def cull_session(octree: Octree, device="cuda") -> DeviceCullSession:
    """The viewer's cull session over `octree`'s node table, on `device`,
    in the frame whose zero is the root cube's centre."""
    return DeviceCullSession(octree.cube_mins, octree.cube_edges,
                             octree.num_points, device=device,
                             origin=octree.root_cube.center())


_collector_lock = threading.Lock()
_collector_pausers = 0
_collector_was_enabled = False


@contextmanager
def collector_paused():
    """Pauses CPython's cyclic collector while held, on any thread.

    A frame's list of up to `max_nodes` NodeIds is a run of that many
    tracked objects that all live to its end: with the collector running,
    its young collections promote them, and every few frames the promoted
    count sets off a full collection of the whole heap (the interpreter's
    and the libraries' objects, ~0.2 s on a host that also drives a card).
    The list makes no cycles, so pausing the collector while it is built
    loses nothing.

    Pauses nest and overlap across threads: the first holder disables the
    collector if it was enabled, the last restores that state.  The port
    changes the collector's state nowhere else; code that disables it
    while a pause is held gets it back enabled when the pause ends."""
    global _collector_pausers, _collector_was_enabled
    with _collector_lock:
        if _collector_pausers == 0:
            _collector_was_enabled = gc.isenabled()
            gc.disable()
        _collector_pausers += 1
    try:
        yield
    finally:
        with _collector_lock:
            _collector_pausers -= 1
            if _collector_pausers == 0 and _collector_was_enabled:
                gc.enable()


def node_id_list(octree: Octree, indices) -> List[NodeId]:
    """The NodeIds of table rows `indices`, in their order, built with the
    cyclic collector paused (the span `select.ids` while a profiler
    runs), in one pass over the table's id columns (`Octree.node_ids_at`)."""
    with span("select.ids"), collector_paused():
        return octree.node_ids_at(indices)


@dataclass
class NodeView:
    """A node's decoded, shuffled point data ready to draw."""

    positions: np.ndarray  # (N, 3) f64 world coords (planet-scale safe)
    colors: np.ndarray  # (N, 3) u8

    def prefix(self, level_of_detail: int) -> Tuple[np.ndarray, np.ndarray]:
        n = int(np.ceil(len(self.positions) / level_of_detail))
        return self.positions[:n], self.colors[:n]


class _DaemonPool:
    """Fixed-size pool of DAEMON worker threads.  Unlike the stdlib
    ThreadPoolExecutor (whose non-daemon workers are JOINED at interpreter
    exit), a node load wedged on a hung data provider cannot block process
    exit."""

    def __init__(self, max_workers: int, name: str) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._threads = [
            threading.Thread(target=self._run, daemon=True, name=f"{name}-{i}")
            for i in range(max_workers)
        ]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 - loaders report via queues
                pass

    def submit(self, fn, *args) -> None:
        self._q.put((fn, args))

    def shutdown(self) -> None:
        for _ in self._threads:
            self._q.put(None)


class NodeViewContainer:
    """LRU cache + async loader (reference node_drawer.rs:263-336)."""

    def __init__(self, octree: Octree, max_nodes_in_memory: int) -> None:
        self.octree = octree
        self.max_nodes = max_nodes_in_memory
        self._cache: "OrderedDict[int, NodeView]" = OrderedDict()
        self._in_flight: Dict[int, bool] = {}
        self._arrived: "queue.Queue" = queue.Queue()
        self._pool = _DaemonPool(max_workers=4, name="pcv-node-loader")
        self._lock = threading.Lock()

    def _load(self, node_id: NodeId) -> None:
        try:
            batch = self.octree.points_in_node(node_id, attributes=["color"])
            # Seed per NODE ID: deterministic LOD subsamples regardless of
            # which loader thread runs which node.
            perm = np.random.default_rng(node_id.value ^ 2).permutation(len(batch))
            view = NodeView(
                positions=batch.position[perm],
                colors=batch.attributes["color"][perm],
            )
            self._arrived.put((node_id.value, view))
        except Exception:
            self._arrived.put((node_id.value, None))

    def consume_arrived(self) -> int:
        """Move completed loads into the cache; returns how many arrived."""
        n = 0
        while True:
            try:
                key, view = self._arrived.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                self._in_flight.pop(key, None)
                if view is not None:
                    self._cache[key] = view
                    self._cache.move_to_end(key)
                    while len(self._cache) > self.max_nodes:
                        self._cache.popitem(last=False)
            n += 1
        return n

    def get_or_request(self, node_id: NodeId) -> Optional[NodeView]:
        key = node_id.value
        with self._lock:
            view = self._cache.get(key)
            if view is not None:
                self._cache.move_to_end(key)
                return view
            if key not in self._in_flight and len(self._in_flight) < MAX_NODES_IN_FLIGHT:
                self._in_flight[key] = True
                self._pool.submit(self._load, node_id)
        return None

    def shutdown(self) -> None:
        self._pool.shutdown()


@dataclass
class FrameStats:
    nodes_drawn: int = 0
    points_drawn: int = 0
    visible_nodes: int = 0
    moving: bool = False


class PointCloudRenderer:
    """The per-frame engine: visible-node thread + cache + draw, with the
    cull on `device` ("cuda" by default, "cpu" for K5's plain version) or,
    with `device_cull=False`, on the host."""

    def __init__(
        self,
        octree: Octree,
        cache_size_mb: int = 2000,
        width: int = 800,
        height: int = 600,
        device_cull: bool = True,
        device="cuda",
    ) -> None:
        self._cull_session = None
        if device_cull:
            self._cull_session = cull_session(octree, device)
        self._cull_error: Optional[Exception] = None
        # Cache size clamped to [1000, 16000] MB, ~200 KB per node =>
        # max nodes = MB * 5 (reference lib.rs:374-385).
        cache_size_mb = max(1000, min(16_000, cache_size_mb))
        self.octree = octree
        self.node_views = NodeViewContainer(octree, max_nodes_in_memory=cache_size_mb * 5)
        self.width = width
        self.height = height
        self.max_nodes_moving = cache_size_mb * 5
        self._budget_frames = 0
        self._budget_window_start = time.perf_counter()
        self.point_size_lod = 2  # draw 1/2 of points while moving
        self.show_octree_nodes = False
        # Interactive display knobs (reference lib.rs:505-508 binds keys
        # 7/8/9/0 to +-0.1 steps); the GL pipeline consumes them as shader
        # uniforms, the software rasterizer applies them directly.
        self.gamma = 1.0
        self.point_size = 2.0
        self.device_cull = device_cull
        self._visible: List[NodeId] = []
        self._matrix_queue: "queue.Queue" = queue.Queue()
        self._visible_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._visible_worker, daemon=True)
        self._thread.start()

    # -- background visible-node computation -------------------------------

    def _device_visible(self, frustum: Frustum) -> List[NodeId]:
        """Visible nodes of one frame's frustum through the session, in
        descending screen size, capped at the node cache's capacity on the
        device."""
        order, _, _ = self._cull_session.step_capped(
            frustum, self.node_views.max_nodes)
        return node_id_list(self.octree, order)

    def _next_matrix(self) -> Optional[np.ndarray]:
        """The newest queued camera matrix (older ones are dropped,
        lib.rs:102-111), or None after 50 ms without one."""
        try:
            matrix = self._matrix_queue.get(timeout=0.05)
        except queue.Empty:
            return None
        while True:
            try:
                matrix = self._matrix_queue.get_nowait()
            except queue.Empty:
                return matrix

    def _visible_worker(self) -> None:
        while not self._stop.is_set():
            matrix = self._next_matrix()
            if matrix is None:
                continue
            # A non-finite matrix (NaN pose) does NOT raise: NaN SAT
            # comparisons cull nothing, so every node would go "visible"
            # and storm the loader.  Keep the previous set.
            if not np.isfinite(matrix).all():
                print("viewer: non-finite camera matrix; keeping previous "
                      "visible set", file=sys.stderr)
                continue
            if not self.device_cull:
                # Cap at the node-cache capacity: nothing beyond it can be
                # drawn, and the top-K cull is much cheaper at ~1M nodes.
                try:
                    visible = self.octree.get_visible_nodes(
                        matrix, max_nodes=self.node_views.max_nodes)
                except Exception as e:  # noqa: BLE001 - a bad frame must
                    # not kill this thread (a singular matrix raises in
                    # Frustum); keep the previous visible set.
                    print(f"viewer: cull failed ({type(e).__name__}: {e}); "
                          "keeping previous visible set", file=sys.stderr)
                    continue
            else:
                try:
                    frustum = Frustum.from_matrix4(matrix)
                except Exception as e:  # noqa: BLE001 - a bad camera frame
                    print(f"viewer: bad camera matrix ({type(e).__name__}: "
                          f"{e}); keeping previous visible set",
                          file=sys.stderr)
                    continue
                try:
                    visible = self._device_visible(frustum)
                except Exception as e:  # noqa: BLE001 - raised by draw
                    self._cull_error = e
                    return
            with self._visible_lock:
                self._visible = visible

    def _raise_cull_error(self) -> None:
        if self._cull_error is not None:
            raise self._cull_error

    def camera_changed(self, world_to_gl: np.ndarray) -> None:
        self._matrix_queue.put(world_to_gl)

    # -- display knobs --------------------------------------------------------

    def adjust_gamma(self, delta: float) -> None:
        """Key 7/8 binding (reference lib.rs:505-506)."""
        self.gamma = max(0.1, self.gamma + delta)
        gl = getattr(self, "gl_renderer", None)
        if gl is not None:
            gl.gamma = self.gamma

    def adjust_point_size(self, delta: float) -> None:
        """Key 9/0 binding (reference lib.rs:507-508)."""
        self.point_size = max(0.1, self.point_size + delta)
        gl = getattr(self, "gl_renderer", None)
        if gl is not None:
            gl.point_size = self.point_size

    # -- adaptive budget -----------------------------------------------------

    def adapt_budget(self, moving: bool, now: Optional[float] = None) -> None:
        """FPS feedback on the moving node budget: +-10% from the AVERAGED
        frame rate, at most once per second, and only while the camera
        moves (reference lib.rs:213-227)."""
        if now is None:
            now = time.perf_counter()
        self._budget_frames += 1
        duration = now - self._budget_window_start
        if duration <= 1.0:
            return
        fps = self._budget_frames / duration
        if moving:
            if fps < FPS_LOWER:
                self.max_nodes_moving = max(1, int(self.max_nodes_moving * 0.9))
            elif fps > FPS_UPPER:
                self.max_nodes_moving = min(
                    self.node_views.max_nodes,
                    int(self.max_nodes_moving * 1.1) + 1,
                )
        self._budget_frames = 0
        self._budget_window_start = now

    def resize(self, width: int, height: int) -> None:
        """Window size changed (reference lib.rs:581-586 -> set_size)."""
        self.width = width
        self.height = height

    # -- drawing ------------------------------------------------------------

    def draw(
        self, world_to_gl: np.ndarray, moving: bool = False, render: bool = False
    ):
        """One frame: returns (FrameStats, image or None); raises the
        device cull's error once it has failed."""
        self._raise_cull_error()
        self.node_views.consume_arrived()
        with self._visible_lock:
            visible = list(self._visible)
        limit = self.max_nodes_moving if moving else len(visible)
        lod = self.point_size_lod if moving else 1
        stats = FrameStats(visible_nodes=len(visible), moving=moving)
        pos_parts, col_parts = [], []
        drawn_ids = []
        for node_id in visible[:limit]:
            view = self.node_views.get_or_request(node_id)
            if view is None:
                continue
            p, c = view.prefix(lod)
            stats.nodes_drawn += 1
            stats.points_drawn += len(p)
            drawn_ids.append(node_id)
            if render:
                pos_parts.append(p)
                col_parts.append(c)
        image = None
        if render:
            positions = (
                np.concatenate(pos_parts) if pos_parts else np.empty((0, 3))
            )
            colors = (
                np.concatenate(col_parts)
                if col_parts
                else np.empty((0, 3), dtype=np.uint8)
            )
            if self.gamma != 1.0 and len(colors):
                # pow(color, 1/gamma), as the JAX package's GL fragment
                # stage.
                colors = (
                    ((colors / 255.0) ** (1.0 / self.gamma)) * 255.0
                ).astype(np.uint8)
            image = rasterize_points(
                positions, colors, world_to_gl, self.width, self.height,
                point_size=max(1, int(round(self.point_size / 2.0))),
            )
            if self.show_octree_nodes and drawn_ids:
                metas = [self.octree.node_meta(n) for n in drawn_ids]
                draw_wireframe_boxes(
                    image,
                    np.stack([m.cube_min for m in metas]),
                    np.array([m.edge_length for m in metas]),
                    world_to_gl,
                )
        return stats, image

    def shutdown(self) -> None:
        self._stop.set()
        # Bounded, so a wedged device call cannot hang exit forever.
        self._thread.join(timeout=20 if self.device_cull else 2)
        self.node_views.shutdown()
        self._raise_cull_error()


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """(H, W, 4) u8 RGBA -> 8-bit RGBA PNG, every row with filter 0."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    height, width, channels = image.shape
    if channels != 4:
        raise ValueError(f"write_png: expected RGBA, got {channels} channels")
    rows = np.zeros((height, 1 + 4 * width), dtype=np.uint8)
    rows[:, 1:] = image.reshape(height, 4 * width)
    header = struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", header))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def run_headless(
    octree_directory: str,
    num_frames: int = 100,
    width: int = 800,
    height: int = 600,
    screenshot_path: Optional[str] = None,
    frame_pacing_s: float = 0.01,
    use_gl: bool = False,
    show_octree_nodes: bool = False,
    device_cull: bool = True,
    cache_size_mb: int = 2000,
    device="cuda",
) -> FrameStats:
    """Drive the full viewer loop headlessly (render_loop.py:392-461):
    orbit the camera around the cloud, stream nodes, adapt the budget, and
    optionally save the final frame.  Returns the last frame's stats.

    `device`: where the device cull runs (with `device_cull`, the default).
    use_gl=True renders through the real OpenGL pipeline (surfaceless EGL,
    shader-side decode -- viewer/gl/) instead of the software rasterizer;
    without a GL driver it raises."""
    octree = Octree.from_directory(octree_directory)
    camera = Camera(width, height)
    center = octree.bounding_box.center()
    diag = float(np.linalg.norm(octree.bounding_box.diag()))
    if use_gl:
        from .gl.viewer import GlPointCloudRenderer

        renderer = GlPointCloudRenderer(
            octree, width=width, height=height, device_cull=device_cull,
            cache_size_mb=cache_size_mb, device=device,
        )
    else:
        renderer = PointCloudRenderer(
            octree, width=width, height=height, device_cull=device_cull,
            cache_size_mb=cache_size_mb, device=device,
        )
    renderer.show_octree_nodes = show_octree_nodes
    try:
        stats = FrameStats()
        for frame in range(num_frames):
            angle = 2 * np.pi * frame / num_frames
            camera.position = center + diag * np.array(
                [np.cos(angle), np.sin(angle), 0.5]
            )
            camera.theta = angle + np.pi / 2
            camera.phi = np.pi / 3
            camera.moved = True
            moved = camera.update(1 / 60)
            matrix = camera.world_to_gl()
            renderer.camera_changed(matrix)
            want_shot = screenshot_path is not None and frame == num_frames - 1
            stats, image = renderer.draw(matrix, moving=moved, render=want_shot)
            if want_shot:
                # Let the async loads settle so the final frame is complete.
                deadline = time.perf_counter() + 5.0
                while (
                    stats.nodes_drawn < stats.visible_nodes
                    and time.perf_counter() < deadline
                ):
                    time.sleep(0.02)
                    stats, image = renderer.draw(
                        matrix, moving=False, render=True
                    )
            renderer.adapt_budget(moved)
            if want_shot and image is not None:
                write_png(screenshot_path, image)
            time.sleep(frame_pacing_s)
        return stats
    finally:
        renderer.shutdown()
