"""Headless viewer runtime of the port: the JAX package's render loop
(point_cloud_viewer_tpu/viewer/render_loop.py, jax-free) with its
per-frame device cull on a PyTorch device.

`PointCloudRenderer(..., device_cull=True, device=...)` keeps the node
cache, loader, adaptive budget and software rasterizer of the JAX package
and replaces the visible-node calculation (render_loop.py:199-271):

* the DeviceCullSession (ops/culling.py) and, on a card, the K5 kernel
  library are made when the renderer is constructed, on the calling
  thread, so nvcc never runs inside the daemon worker (whose join waits at
  most 20 s, render_loop.py:388);
* a device error is never hidden: there is no host fallback and no "keep
  the previous visible set".  The worker keeps the first error and stops;
  `draw` and `shutdown` raise it.  A camera matrix that `Frustum` rejects
  (singular, non-finite) still skips the frame, as in the JAX package.

`run_headless` is render_loop.py:392-461 with this renderer, writing the
final frame as PNG with the standard library (`write_png`).
"""

from __future__ import annotations

import queue
import struct
import sys
import time
import zlib
from typing import List, Optional

import numpy as np

from point_cloud_viewer_tpu.math.geometry import Frustum
from point_cloud_viewer_tpu.octree.node_id import NodeId
from point_cloud_viewer_tpu.octree.octree import Octree
from point_cloud_viewer_tpu.viewer import render_loop as _ref
from point_cloud_viewer_tpu.viewer.camera import Camera
from point_cloud_viewer_tpu.viewer.render_loop import FrameStats

from ..ops.culling import DeviceCullSession

__all__ = ["Camera", "FrameStats", "Octree", "PointCloudRenderer",
           "run_headless", "write_png"]


class PointCloudRenderer(_ref.PointCloudRenderer):
    """The JAX package's renderer with the device cull on `device`."""

    def __init__(
        self,
        octree: Octree,
        cache_size_mb: int = 2000,
        width: int = 800,
        height: int = 600,
        device_cull: bool = False,
        device="cuda",
    ) -> None:
        session = None
        if device_cull:
            session = DeviceCullSession(
                octree.cube_mins, octree.cube_edges, octree.num_points,
                device=device,
            )
        self._cull_error: Optional[Exception] = None
        super().__init__(octree, cache_size_mb=cache_size_mb, width=width,
                         height=height, device_cull=device_cull)
        # No matrix is queued before __init__ returns, so the worker cannot
        # have looked at the session yet.
        self._cull_session = session

    def _device_visible(self, frustum: Frustum) -> List[NodeId]:
        """Visible nodes of one frame's frustum through the session, in
        descending screen size, capped at the node cache's capacity."""
        order, _, visible = self._cull_session.step(frustum)
        count = min(int(visible.sum()), self.node_views.max_nodes)
        return [self.octree.node_ids[i] for i in order[:count]]

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
            if not np.isfinite(matrix).all():
                print("viewer: non-finite camera matrix; keeping previous "
                      "visible set", file=sys.stderr)
                continue
            if not self.device_cull:
                try:
                    visible = self.octree.get_visible_nodes(
                        matrix, max_nodes=self.node_views.max_nodes)
                except Exception as e:  # noqa: BLE001 - as render_loop.py:263
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

    def draw(self, world_to_gl: np.ndarray, moving: bool = False,
             render: bool = False):
        """One frame: returns (FrameStats, image or None); raises the
        device cull's error once it has failed."""
        self._raise_cull_error()
        return super().draw(world_to_gl, moving=moving, render=render)

    def shutdown(self) -> None:
        super().shutdown()
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
    device_cull: bool = False,
    cache_size_mb: int = 2000,
    device="cuda",
) -> FrameStats:
    """Drive the full viewer loop headlessly (render_loop.py:392-461):
    orbit the camera around the cloud, stream nodes, adapt the budget, and
    optionally save the final frame.  Returns the last frame's stats.

    `device`: where the device cull runs (with `device_cull`).  use_gl is
    not yet ported and raises."""
    if use_gl:
        raise NotImplementedError("use_gl: the GL renderer is not yet ported")
    octree = Octree.from_directory(octree_directory)
    camera = Camera(width, height)
    center = octree.bounding_box.center()
    diag = float(np.linalg.norm(octree.bounding_box.diag()))
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
