"""RAII OpenGL abstractions — the counterpart of the reference's graphic
core (sdl_viewer/src/graphic/mod.rs:31-104): programs, buffers, vertex
arrays and framebuffers that create their GL object on construction and
delete it on .destroy()/garbage collection, plus uniform caching.

Copy of point_cloud_viewer_tpu/viewer/gl/core.py:1-259, unchanged.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from . import api
from .api import (
    GL_ARRAY_BUFFER,
    GL_COLOR_ATTACHMENT0,
    GL_COMPILE_STATUS,
    GL_DEPTH_ATTACHMENT,
    GL_DEPTH_COMPONENT24,
    GL_FRAGMENT_SHADER,
    GL_FRAMEBUFFER,
    GL_FRAMEBUFFER_COMPLETE,
    GL_LINK_STATUS,
    GL_RENDERBUFFER,
    GL_RGBA,
    GL_RGBA8,
    GL_STATIC_DRAW,
    GL_UNSIGNED_BYTE,
    GL_VERTEX_SHADER,
)


class GlError(RuntimeError):
    pass


def _compile_shader(gl, kind: int, source: str) -> int:
    sid = gl.glCreateShader(kind)
    src = ctypes.c_char_p(source.encode())
    gl.glShaderSource(sid, 1, ctypes.byref(src), None)
    gl.glCompileShader(sid)
    status = ctypes.c_int()
    gl.glGetShaderiv(sid, GL_COMPILE_STATUS, ctypes.byref(status))
    if not status.value:
        buf = ctypes.create_string_buffer(4096)
        gl.glGetShaderInfoLog(sid, 4096, None, buf)
        gl.glDeleteShader(sid)
        raise GlError(f"shader compile failed:\n{buf.value.decode()}")
    return sid


class GlProgram:
    """Compiled+linked GLSL program with a uniform-location cache."""

    def __init__(self, gl, vertex_source: str, fragment_source: str,
                 geometry_source: str = None) -> None:
        from .api import GL_GEOMETRY_SHADER

        self.gl = gl
        vs = _compile_shader(gl, GL_VERTEX_SHADER, vertex_source)
        fs = _compile_shader(gl, GL_FRAGMENT_SHADER, fragment_source)
        gs = (
            _compile_shader(gl, GL_GEOMETRY_SHADER, geometry_source)
            if geometry_source is not None else None
        )
        self.id = gl.glCreateProgram()
        gl.glAttachShader(self.id, vs)
        gl.glAttachShader(self.id, fs)
        if gs is not None:
            gl.glAttachShader(self.id, gs)
        gl.glLinkProgram(self.id)
        gl.glDeleteShader(vs)
        gl.glDeleteShader(fs)
        if gs is not None:
            gl.glDeleteShader(gs)
        status = ctypes.c_int()
        gl.glGetProgramiv(self.id, GL_LINK_STATUS, ctypes.byref(status))
        if not status.value:
            buf = ctypes.create_string_buffer(4096)
            gl.glGetProgramInfoLog(self.id, 4096, None, buf)
            raise GlError(f"program link failed:\n{buf.value.decode()}")
        self._uniforms: Dict[str, int] = {}

    def use(self) -> None:
        self.gl.glUseProgram(self.id)

    def uniform(self, name: str) -> int:
        loc = self._uniforms.get(name)
        if loc is None:
            loc = self.gl.glGetUniformLocation(self.id, name.encode())
            self._uniforms[name] = loc
        return loc

    def attrib(self, name: str) -> int:
        return self.gl.glGetAttribLocation(self.id, name.encode())

    def set_f(self, name: str, value: float) -> None:
        self.gl.glUniform1f(self.uniform(name), value)

    def set_vec3(self, name: str, v) -> None:
        self.gl.glUniform3f(self.uniform(name), float(v[0]), float(v[1]), float(v[2]))

    def set_vec4(self, name: str, v) -> None:
        self.gl.glUniform4f(
            self.uniform(name), float(v[0]), float(v[1]), float(v[2]), float(v[3])
        )

    def set_mat4(self, name: str, m: np.ndarray) -> None:
        # numpy row-major -> transpose flag GL_TRUE is unavailable in some
        # ES profiles; pass column-major explicitly.
        col = np.ascontiguousarray(np.asarray(m, dtype=np.float32).T)
        self.gl.glUniformMatrix4fv(
            self.uniform(name), 1, 0, col.ctypes.data_as(ctypes.c_void_p)
        )

    def destroy(self) -> None:
        if self.id:
            self.gl.glDeleteProgram(self.id)
            self.id = 0

    def __del__(self) -> None:  # pragma: no cover - GC timing
        try:
            self.destroy()
        except Exception:
            pass


class GlBuffer:
    """Immutable vertex buffer uploaded from a numpy array."""

    def __init__(self, gl, data: np.ndarray) -> None:
        self.gl = gl
        data = np.ascontiguousarray(data)
        self.nbytes = data.nbytes
        bid = ctypes.c_uint()
        gl.glGenBuffers(1, ctypes.byref(bid))
        self.id = bid.value
        gl.glBindBuffer(GL_ARRAY_BUFFER, self.id)
        gl.glBufferData(
            GL_ARRAY_BUFFER, data.nbytes,
            data.ctypes.data_as(ctypes.c_void_p), GL_STATIC_DRAW,
        )

    def bind(self) -> None:
        self.gl.glBindBuffer(GL_ARRAY_BUFFER, self.id)

    def destroy(self) -> None:
        if self.id:
            bid = ctypes.c_uint(self.id)
            self.gl.glDeleteBuffers(1, ctypes.byref(bid))
            self.id = 0

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.destroy()
        except Exception:
            pass


class GlVertexArray:
    """VAO wrapper: attach_* calls record attribute layout."""

    def __init__(self, gl) -> None:
        self.gl = gl
        vid = ctypes.c_uint()
        gl.glGenVertexArrays(1, ctypes.byref(vid))
        self.id = vid.value
        self._buffers = []  # keep uploads alive with the VAO

    def bind(self) -> None:
        self.gl.glBindVertexArray(self.id)

    def attach(self, location: int, buffer: GlBuffer, components: int,
               gl_type: int, normalized: bool) -> None:
        if location < 0:
            return  # attribute optimized out
        self.bind()
        buffer.bind()
        self.gl.glEnableVertexAttribArray(location)
        self.gl.glVertexAttribPointer(
            location, components, gl_type, 1 if normalized else 0, 0, None
        )
        self._buffers.append(buffer)

    def destroy(self) -> None:
        if self.id:
            vid = ctypes.c_uint(self.id)
            self.gl.glDeleteVertexArrays(1, ctypes.byref(vid))
            self.id = 0
        for b in self._buffers:
            b.destroy()
        self._buffers = []

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.destroy()
        except Exception:
            pass


class GlFramebuffer:
    """Offscreen RGBA8 + depth24 render target with readback."""

    def __init__(self, gl, width: int, height: int) -> None:
        self.gl = gl
        self.width = width
        self.height = height
        fid = ctypes.c_uint()
        gl.glGenFramebuffers(1, ctypes.byref(fid))
        self.id = fid.value
        gl.glBindFramebuffer(GL_FRAMEBUFFER, self.id)
        self._rbs = []
        for attachment, fmt in (
            (GL_COLOR_ATTACHMENT0, GL_RGBA8),
            (GL_DEPTH_ATTACHMENT, GL_DEPTH_COMPONENT24),
        ):
            rid = ctypes.c_uint()
            gl.glGenRenderbuffers(1, ctypes.byref(rid))
            gl.glBindRenderbuffer(GL_RENDERBUFFER, rid.value)
            gl.glRenderbufferStorage(GL_RENDERBUFFER, fmt, width, height)
            gl.glFramebufferRenderbuffer(
                GL_FRAMEBUFFER, attachment, GL_RENDERBUFFER, rid.value
            )
            self._rbs.append(rid.value)
        status = gl.glCheckFramebufferStatus(GL_FRAMEBUFFER)
        if status != GL_FRAMEBUFFER_COMPLETE:
            raise GlError(f"framebuffer incomplete: 0x{status:x}")

    def bind(self) -> None:
        self.gl.glBindFramebuffer(GL_FRAMEBUFFER, self.id)
        self.gl.glViewport(0, 0, self.width, self.height)

    def read_rgba(self) -> np.ndarray:
        """-> (height, width, 4) u8, top row first (flipped from GL)."""
        self.bind()
        self.gl.glFinish()
        out = np.empty((self.height, self.width, 4), dtype=np.uint8)
        self.gl.glReadPixels(
            0, 0, self.width, self.height, GL_RGBA, GL_UNSIGNED_BYTE,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out[::-1].copy()

    def destroy(self) -> None:
        if self.id:
            fid = ctypes.c_uint(self.id)
            self.gl.glDeleteFramebuffers(1, ctypes.byref(fid))
            self.id = 0
        for r in self._rbs:
            rid = ctypes.c_uint(r)
            self.gl.glDeleteRenderbuffers(1, ctypes.byref(rid))
        self._rbs = []

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.destroy()
        except Exception:
            pass
