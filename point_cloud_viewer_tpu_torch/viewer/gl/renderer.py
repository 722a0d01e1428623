"""The GL point renderer: per-node GPU buffers (raw on-disk encodings,
decoded in the vertex shader), an f32/f64 program pair, LOD prefix draws,
and box outlines — the reference's node_drawer + box_drawer over the RAII
core (sdl_viewer/src/node_drawer.rs, box_drawer.rs).

Everything is camera-relative: node cube minima (f64) are subtracted from
the camera origin on the host per frame, so f32 GPU math holds up at
planet scale; FLOAT64-encoded nodes use the split-double program.

Copy of point_cloud_viewer_tpu/viewer/gl/renderer.py:1-215, unchanged.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from ...ops.codec import PositionEncoding
from . import api
from .api import (
    GL_BLEND,
    GL_COLOR_BUFFER_BIT,
    GL_DEPTH_BUFFER_BIT,
    GL_DEPTH_TEST,
    GL_FLOAT,
    GL_LINES,
    GL_ONE_MINUS_SRC_ALPHA,
    GL_POINTS,
    GL_PROGRAM_POINT_SIZE,
    GL_SRC_ALPHA,
    GL_UNSIGNED_BYTE,
    GL_UNSIGNED_SHORT,
)
from .core import GlBuffer, GlFramebuffer, GlProgram, GlVertexArray
from .shaders import load_shader


class GlContext:
    """A surfaceless GL context + offscreen framebuffer."""

    def __init__(self, width: int = 800, height: int = 600) -> None:
        self.egl, self.gl, self.display, self.context = api.create_context()
        self.fbo = GlFramebuffer(self.gl, width, height)
        self.fbo.bind()
        self.gl.glEnable(GL_PROGRAM_POINT_SIZE)

    def make_current(self) -> None:
        """Re-bind this context on the calling thread (multiple contexts
        may coexist in one process; GL currency is per thread)."""
        self.egl.eglMakeCurrent(self.display, None, None, self.context)

    def resize(self, width: int, height: int) -> None:
        self.make_current()
        if (width, height) != (self.fbo.width, self.fbo.height):
            self.fbo.destroy()
            self.fbo = GlFramebuffer(self.gl, width, height)
        self.fbo.bind()


def split_double(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """f64 array -> (hi, lo) f32 arrays with hi + lo == value to f64
    precision (hi = round-to-f32, lo = residual)."""
    hi = values.astype(np.float32)
    lo = (values - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


class NodeBufferGL:
    """One node's GPU-resident points: the raw on-disk position encoding is
    uploaded verbatim (u8/u16 normalized, f32), decoded by the shader;
    FLOAT64 uploads split-double world coordinates."""

    def __init__(self, ctx: GlContext, programs: "ProgramPair",
                 encoded_positions: np.ndarray, colors: np.ndarray,
                 encoding: PositionEncoding, cube_min: np.ndarray,
                 edge_length: float) -> None:
        ctx.make_current()
        gl = ctx.gl
        self.count = len(encoded_positions)
        self.encoding = encoding
        self.cube_min = np.asarray(cube_min, dtype=np.float64)
        self.edge_length = float(edge_length)
        self.vao = GlVertexArray(gl)
        color_f = np.ascontiguousarray(colors, dtype=np.uint8)

        if encoding == PositionEncoding.FLOAT64:
            prog = programs.f64
            world = (
                np.asarray(encoded_positions, dtype=np.float64)
                * self.edge_length + self.cube_min
            )
            hi, lo = split_double(world)
            self.vao.attach(prog.attrib("position_hi"), GlBuffer(gl, hi), 3,
                            GL_FLOAT, normalized=False)
            self.vao.attach(prog.attrib("position_lo"), GlBuffer(gl, lo), 3,
                            GL_FLOAT, normalized=False)
        else:
            prog = programs.f32
            gl_type = {
                PositionEncoding.UINT8: GL_UNSIGNED_BYTE,
                PositionEncoding.UINT16: GL_UNSIGNED_SHORT,
                PositionEncoding.FLOAT32: GL_FLOAT,
            }[encoding]
            normalized = encoding != PositionEncoding.FLOAT32
            self.vao.attach(
                prog.attrib("position"),
                GlBuffer(gl, np.ascontiguousarray(encoded_positions)), 3,
                gl_type, normalized=normalized,
            )
        self.vao.attach(prog.attrib("color"), GlBuffer(gl, color_f), 3,
                        GL_UNSIGNED_BYTE, normalized=True)

    def destroy(self) -> None:
        self.vao.destroy()


class ProgramPair:
    """The f32 + f64 point programs sharing one fragment stage."""

    def __init__(self, gl) -> None:
        fs = load_shader("points.fs")
        self.f32 = GlProgram(gl, load_shader("points.vs"), fs)
        self.f64 = GlProgram(gl, load_shader("points_f64.vs"), fs)


class PointsRendererGL:
    """Draws node buffers for one frame with gamma/alpha/point-size state."""

    def __init__(self, ctx: GlContext) -> None:
        self.ctx = ctx
        self.programs = ProgramPair(ctx.gl)
        self.solid = GlProgram(
            ctx.gl, load_shader("solid.vs"), load_shader("solid.fs")
        )
        self.point_size = 2.0
        self.gamma = 1.0
        self.alpha = 1.0
        self.background = (0.066, 0.066, 0.078, 1.0)

    def make_node_buffer(self, encoded_positions, colors, encoding,
                         cube_min, edge_length) -> NodeBufferGL:
        return NodeBufferGL(self.ctx, self.programs, encoded_positions,
                            colors, encoding, cube_min, edge_length)

    def begin_frame(self) -> None:
        gl = self.ctx.gl
        self.ctx.make_current()
        self.ctx.fbo.bind()
        gl.glClearColor(*self.background)
        gl.glClear(GL_COLOR_BUFFER_BIT | GL_DEPTH_BUFFER_BIT)
        gl.glEnable(GL_DEPTH_TEST)
        if self.alpha < 1.0:
            gl.glEnable(GL_BLEND)
            gl.glBlendFunc(GL_SRC_ALPHA, GL_ONE_MINUS_SRC_ALPHA)
        else:
            gl.glDisable(GL_BLEND)

    def draw_node(self, node: NodeBufferGL, clip_from_world: np.ndarray,
                  camera_origin: np.ndarray, count: Optional[int] = None) -> None:
        """Draw the first `count` points of a node (shuffled-prefix LOD)."""
        gl = self.ctx.gl
        origin = np.asarray(camera_origin, dtype=np.float64)
        # clip_from_rel = clip_from_world @ translate(origin): columns 0..2
        # unchanged, translation column re-expressed relative to the origin.
        m = np.asarray(clip_from_world, dtype=np.float64).copy()
        m[:, 3] = m @ np.array([origin[0], origin[1], origin[2], 1.0])
        n = self.count_for(node, count)
        if node.encoding == PositionEncoding.FLOAT64:
            prog = self.programs.f64
            prog.use()
            hi, lo = split_double(origin)
            prog.set_vec3("origin_hi", hi)
            prog.set_vec3("origin_lo", lo)
        else:
            prog = self.programs.f32
            prog.use()
            prog.set_vec3("cube_min", (node.cube_min - origin).astype(np.float32))
            prog.set_f("edge_length", node.edge_length)
        prog.set_mat4("rel_to_clip", m)
        prog.set_f("point_size", self.point_size)
        prog.set_f("gamma", self.gamma)
        prog.set_f("alpha", self.alpha)
        node.vao.bind()
        gl.glDrawArrays(GL_POINTS, 0, n)

    @staticmethod
    def count_for(node: NodeBufferGL, count: Optional[int]) -> int:
        return node.count if count is None else min(count, node.count)

    def draw_boxes(self, mins: np.ndarray, edges: np.ndarray,
                   clip_from_world: np.ndarray, camera_origin: np.ndarray,
                   color=(1.0, 1.0, 0.0, 1.0)) -> None:
        """Wireframe node cubes (reference box_drawer.rs)."""
        gl = self.ctx.gl
        origin = np.asarray(camera_origin, dtype=np.float64)
        mins = np.asarray(mins, dtype=np.float64) - origin
        edges = np.asarray(edges, dtype=np.float64)
        from ..software_raster import _BOX_EDGES, _CORNER_UNIT

        corners = mins[:, None, :] + _CORNER_UNIT[None] * edges[:, None, None]
        segs = corners[:, _BOX_EDGES.ravel(), :].reshape(-1, 3).astype(np.float32)
        m = np.asarray(clip_from_world, dtype=np.float64).copy()
        m[:, 3] = m @ np.array([origin[0], origin[1], origin[2], 1.0])
        self.solid.use()
        self.solid.set_mat4("rel_to_clip", m)
        self.solid.set_vec4("color_u", color)
        vao = GlVertexArray(gl)
        vao.attach(self.solid.attrib("position"), GlBuffer(gl, segs), 3,
                   GL_FLOAT, normalized=False)
        vao.bind()
        gl.glDrawArrays(GL_LINES, 0, len(segs))
        vao.destroy()

    def read_frame(self) -> np.ndarray:
        return self.ctx.fbo.read_rgba()
