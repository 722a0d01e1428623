"""GL clipmap terrain drawer — the reference's terrain_drawer rendering
half (sdl_viewer/src/terrain_drawer/mod.rs:22,72-141): a single reusable
(GRID_SIZE+1)^2 grid mesh drawn once per clipmap level at doubling spacing,
displaced in the vertex shader by the camera-following height window
(viewer/terrain.TerrainLayer) uploaded as textures.

Copy of point_cloud_viewer_tpu/viewer/gl/terrain.py:1-208, unchanged.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..terrain import TerrainLayer
from .api import (
    GL_CLAMP_TO_EDGE,
    GL_ELEMENT_ARRAY_BUFFER,
    GL_FLOAT,
    GL_LINEAR,
    GL_NEAREST,
    GL_R32F,
    GL_RED,
    GL_RGBA,
    GL_RGBA8,
    GL_STATIC_DRAW,
    GL_TEXTURE0,
    GL_TEXTURE_2D,
    GL_TEXTURE_MAG_FILTER,
    GL_TEXTURE_MIN_FILTER,
    GL_TEXTURE_WRAP_S,
    GL_TEXTURE_WRAP_T,
    GL_TRIANGLES,
    GL_UNPACK_ALIGNMENT,
    GL_UNSIGNED_BYTE,
    GL_UNSIGNED_INT,
)
from .core import GlBuffer, GlProgram, GlVertexArray
from .shaders import load_shader

GRID_SIZE = 1023  # quads per side per clipmap level (reference: 1023,
# sdl_viewer/src/terrain_drawer/mod.rs:22); tests pass smaller grids.


def clipmap_mesh(grid_size: int = GRID_SIZE, ring_only: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The clipmap grid: returns (vertices (V, 2) f32 grid coordinates,
    indices (T*3,) u32).  ring_only=True omits the central half-size block
    (covered by the next-finer level) — the classic clipmap ring."""
    g = grid_size
    xs, ys = np.meshgrid(np.arange(g + 1), np.arange(g + 1), indexing="xy")
    vertices = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float32)

    ix, iy = np.meshgrid(np.arange(g), np.arange(g), indexing="xy")
    ix, iy = ix.ravel(), iy.ravel()
    if ring_only:
        lo, hi = g // 4, g - g // 4
        keep = ~((ix >= lo) & (ix < hi) & (iy >= lo) & (iy < hi))
        ix, iy = ix[keep], iy[keep]

    def flat(x, y):
        return y * (g + 1) + x

    tris = np.empty((len(ix), 6), dtype=np.uint32)
    tris[:, 0] = flat(ix, iy)
    tris[:, 1] = flat(ix + 1, iy)
    tris[:, 2] = flat(ix, iy + 1)
    tris[:, 3] = flat(ix + 1, iy)
    tris[:, 4] = flat(ix, iy + 1)
    tris[:, 5] = flat(ix + 1, iy + 1)
    return vertices, tris.ravel()


class _Texture:
    def __init__(self, gl, data: np.ndarray, internal_fmt: int, fmt: int,
                 gl_type: int, filter_: int) -> None:
        self.gl = gl
        tid = ctypes.c_uint()
        gl.glGenTextures(1, ctypes.byref(tid))
        self.id = tid.value
        gl.glBindTexture(GL_TEXTURE_2D, self.id)
        gl.glPixelStorei(GL_UNPACK_ALIGNMENT, 1)
        data = np.ascontiguousarray(data)
        h, w = data.shape[:2]
        gl.glTexImage2D(GL_TEXTURE_2D, 0, internal_fmt, w, h, 0, fmt,
                        gl_type, data.ctypes.data_as(ctypes.c_void_p))
        for pname in (GL_TEXTURE_MIN_FILTER, GL_TEXTURE_MAG_FILTER):
            gl.glTexParameteri(GL_TEXTURE_2D, pname, filter_)
        for pname in (GL_TEXTURE_WRAP_S, GL_TEXTURE_WRAP_T):
            gl.glTexParameteri(GL_TEXTURE_2D, pname, GL_CLAMP_TO_EDGE)

    def bind(self, unit: int) -> None:
        self.gl.glActiveTexture(GL_TEXTURE0 + unit)
        self.gl.glBindTexture(GL_TEXTURE_2D, self.id)

    def destroy(self) -> None:
        if self.id:
            tid = ctypes.c_uint(self.id)
            self.gl.glDeleteTextures(1, ctypes.byref(tid))
            self.id = 0

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.destroy()
        except Exception:
            pass


class TerrainDrawerGL:
    """Draws a TerrainLayer through the clipmap pipeline."""

    def __init__(self, ctx, layer: TerrainLayer, num_levels: int = 4,
                 grid_size: int = GRID_SIZE) -> None:
        self.ctx = ctx
        self.layer = layer
        self.num_levels = num_levels
        self.grid_size = grid_size
        ctx.make_current()
        gl = ctx.gl
        self.program = GlProgram(
            gl, load_shader("terrain.vs"), load_shader("terrain.fs"),
            geometry_source=load_shader("terrain.gs"),
        )
        self._meshes = []
        for level in range(num_levels):
            verts, idx = clipmap_mesh(grid_size, ring_only=level > 0)
            vao = GlVertexArray(gl)
            vao.attach(self.program.attrib("grid_pos"), GlBuffer(gl, verts),
                       2, GL_FLOAT, normalized=False)
            # Element buffer binds into the VAO state.
            vao.bind()
            ibo = ctypes.c_uint()
            gl.glGenBuffers(1, ctypes.byref(ibo))
            gl.glBindBuffer(GL_ELEMENT_ARRAY_BUFFER, ibo.value)
            idx = np.ascontiguousarray(idx)
            gl.glBufferData(GL_ELEMENT_ARRAY_BUFFER, idx.nbytes,
                            idx.ctypes.data_as(ctypes.c_void_p), GL_STATIC_DRAW)
            self._meshes.append((vao, len(idx)))
        self._height_tex = None
        self._color_tex = None
        self._window_key = None

    def _refresh_textures(self) -> None:
        """Re-upload the camera-following windows when they moved."""
        hw = self.layer.height_window
        key = hw.pos
        if key == self._window_key and self._height_tex is not None:
            return
        self._window_key = key
        gl = self.ctx.gl
        if self._height_tex is not None:
            self._height_tex.destroy()
            self._color_tex.destroy()
        heights = self.layer.height_window.snapshot().astype(np.float32)
        colors = self.layer.color_window.snapshot()
        if colors.ndim == 2:
            colors = np.stack([colors] * 3, axis=-1)
        if colors.shape[-1] == 3:
            colors = np.concatenate(
                [colors, np.full(colors.shape[:2] + (1,), 255, colors.dtype)],
                axis=-1,
            )
        self._height_tex = _Texture(gl, heights, GL_R32F, GL_RED, GL_FLOAT,
                                    GL_LINEAR)
        self._color_tex = _Texture(gl, colors.astype(np.uint8), GL_RGBA8,
                                   GL_RGBA, GL_UNSIGNED_BYTE, GL_LINEAR)

    def draw(self, clip_from_world: np.ndarray, camera_xy) -> None:
        """Draw all clipmap levels centered on the camera (world xy)."""
        self.layer.follow_camera(camera_xy)
        self._refresh_textures()
        gl = self.ctx.gl
        meta = self.layer.meta
        res = meta.resolution_m
        hw = self.layer.height_window
        window_min_x = meta.world_origin_x + hw.pos[0] * res
        window_min_y = meta.world_origin_y + hw.pos[1] * res
        extent = self.layer.window_size * res

        origin_w = np.array([camera_xy[0], camera_xy[1], 0.0])
        m = np.asarray(clip_from_world, dtype=np.float64).copy()
        m[:, 3] = m @ np.array([origin_w[0], origin_w[1], 0.0, 1.0])

        self.program.use()
        self.program.set_mat4("rel_to_clip", m)
        self.program.set_f("window_extent", extent)
        gl.glUniform1i(self.program.uniform("height_tex"), 0)
        gl.glUniform1i(self.program.uniform("color_tex"), 1)
        self._height_tex.bind(0)
        self._color_tex.bind(1)
        loc_org = self.program.uniform("origin")
        loc_wmin = self.program.uniform("window_min")
        gl.glUniform2f(
            loc_wmin, window_min_x - origin_w[0], window_min_y - origin_w[1]
        )
        for level in range(self.num_levels):
            spacing = res * (1 << level)
            half = spacing * self.grid_size / 2
            # Snap the level origin to its own spacing so vertices do not
            # swim as the camera moves (standard clipmap rule).
            ox = np.floor((camera_xy[0] - half) / spacing) * spacing
            oy = np.floor((camera_xy[1] - half) / spacing) * spacing
            gl.glUniform1f(self.program.uniform("spacing"), spacing)
            # origin is camera-relative (subtract origin_w).
            gl.glUniform2f(loc_org, ox - origin_w[0], oy - origin_w[1])
            vao, count = self._meshes[level]
            vao.bind()
            gl.glDrawElements(GL_TRIANGLES, count, GL_UNSIGNED_INT, None)
