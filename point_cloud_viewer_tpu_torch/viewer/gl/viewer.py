"""GPU viewer loop: the PointCloudRenderer engine drawing through the real
GL pipeline instead of the software rasterizer.

Node payloads stay in their on-disk encoding all the way into GPU vertex
buffers (the shader decodes — reference node_drawer.rs); the LRU cache,
background visible-node thread, adaptive budget and shuffled-prefix LOD
come from the shared engine.  GL objects are only ever touched on the
thread that owns the context: loader threads fetch raw bytes, buffer
upload happens in consume_arrived() on the render thread.

Copy of point_cloud_viewer_tpu/viewer/gl/viewer.py:1-145 on the port's
engine, with its cull contract: the visible set comes from K5 on `device`
("cuda" by default; `device_cull=False` culls on the host), the renderer is
built with the JAX signature plus `device`, and `draw` raises the device
cull's error (render_loop.PointCloudRenderer._raise_cull_error) instead of
drawing a stale set.  The visible-node thread launches K5 while the render
thread owns the GL context; vertex data goes from host numpy to
glBufferData, with no CUDA-GL interop.
"""

from __future__ import annotations

import queue
from typing import Optional, Tuple

import numpy as np

from ...octree.node_id import NodeId
from ...octree.octree import Octree
from ..render_loop import FrameStats, NodeViewContainer, PointCloudRenderer
from .renderer import GlContext, NodeBufferGL, PointsRendererGL


class GlNodeViewContainer(NodeViewContainer):
    """LRU + async loader whose cached views are GPU vertex buffers."""

    def __init__(self, octree: Octree, max_nodes_in_memory: int,
                 renderer: PointsRendererGL) -> None:
        super().__init__(octree, max_nodes_in_memory)
        self.renderer = renderer

    def _load(self, node_id: NodeId) -> None:
        # Loader thread: raw bytes only — no GL here.
        try:
            meta, pos_bytes, color_bytes = self.octree.get_node_data(node_id)
            dt = meta.position_encoding.numpy_dtype
            positions = np.frombuffer(pos_bytes, dtype=dt).reshape(-1, 3)
            colors = np.frombuffer(color_bytes, dtype=np.uint8).reshape(-1, 3)
            # Per-node seed: see render_loop.NodeViewContainer._load.
            perm = np.random.default_rng(node_id.value ^ 2).permutation(len(positions))
            payload = (
                positions[perm], colors[perm], meta.position_encoding,
                meta.cube_min, meta.edge_length,
            )
            self._arrived.put((node_id.value, payload))
        except Exception:
            self._arrived.put((node_id.value, None))

    def consume_arrived(self) -> int:
        # Render thread: turn raw payloads into GPU buffers.
        n = 0
        while True:
            try:
                key, payload = self._arrived.get_nowait()
            except queue.Empty:
                break
            view = None
            if payload is not None:
                positions, colors, encoding, cube_min, edge = payload
                view = self.renderer.make_node_buffer(
                    positions, colors, encoding, cube_min, edge
                )
            with self._lock:
                self._in_flight.pop(key, None)
                if view is not None:
                    old = self._cache.pop(key, None)
                    if old is not None:
                        old.destroy()
                    self._cache[key] = view
                    self._cache.move_to_end(key)
                    while len(self._cache) > self.max_nodes:
                        _, evicted = self._cache.popitem(last=False)
                        evicted.destroy()
            n += 1
        return n


class GlPointCloudRenderer(PointCloudRenderer):
    """PointCloudRenderer whose draw path is the real GL pipeline."""

    def __init__(self, octree: Octree, cache_size_mb: int = 2000,
                 width: int = 800, height: int = 600,
                 device_cull: bool = True, device="cuda") -> None:
        self.ctx = GlContext(width=width, height=height)
        self.gl_renderer = PointsRendererGL(self.ctx)
        super().__init__(octree, cache_size_mb=cache_size_mb,
                         width=width, height=height,
                         device_cull=device_cull, device=device)
        # Replace the software container with the GPU one (same size: the
        # base init already clamped cache_size_mb to the reference range).
        max_nodes = self.node_views.max_nodes
        self.node_views.shutdown()
        self.node_views = GlNodeViewContainer(
            octree, max_nodes_in_memory=max_nodes,
            renderer=self.gl_renderer,
        )

    def resize(self, width: int, height: int) -> None:
        """Resize the camera target AND the GL framebuffer (kept in sync:
        drawing into a stale-sized FBO while the camera projects with the
        new aspect would distort the output)."""
        super().resize(width, height)
        self.ctx.resize(width, height)

    def draw(self, world_to_gl: np.ndarray, moving: bool = False,
             render: bool = False) -> Tuple[FrameStats, Optional[np.ndarray]]:
        self._raise_cull_error()
        self.node_views.consume_arrived()
        with self._visible_lock:
            visible = list(self._visible)
        limit = self.max_nodes_moving if moving else len(visible)
        lod = self.point_size_lod if moving else 1
        stats = FrameStats(visible_nodes=len(visible), moving=moving)

        # Camera origin for relative-to-eye precision: invert the view ray
        # cheaply by using the octree center (sufficient: what matters is
        # that the origin is NEAR the drawn geometry).
        origin = self.octree.bounding_box.center()

        if render:
            self.gl_renderer.begin_frame()
        drawn_ids = []
        for node_id in visible[:limit]:
            view = self.node_views.get_or_request(node_id)
            if view is None:
                continue
            count = int(np.ceil(view.count / lod))
            stats.nodes_drawn += 1
            stats.points_drawn += count
            drawn_ids.append(node_id)
            if render:
                self.gl_renderer.draw_node(
                    view, world_to_gl, camera_origin=origin, count=count
                )
        image = None
        if render:
            if self.show_octree_nodes and drawn_ids:
                metas = [self.octree.node_meta(n) for n in drawn_ids]
                self.gl_renderer.draw_boxes(
                    np.stack([m.cube_min for m in metas]),
                    np.array([m.edge_length for m in metas]),
                    world_to_gl, camera_origin=origin,
                )
            image = self.gl_renderer.read_frame()
        return stats, image
