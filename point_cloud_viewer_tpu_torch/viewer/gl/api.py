"""ctypes bindings for EGL + the OpenGL entry points this renderer uses.

No PyOpenGL in this environment; the EGL/GL C ABIs are stable, so a thin
hand-declared binding is all that is needed.  GL functions are resolved
through eglGetProcAddress after a context is current (required for
anything newer than GL 1.1 on most drivers).

Copy of point_cloud_viewer_tpu/viewer/gl/api.py:1-262, unchanged.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

# ---------------------------------------------------------------------------
# constants (from EGL/egl.h and GL/glcorearb.h — stable ABI values)

EGL_PLATFORM_SURFACELESS_MESA = 0x31DD
EGL_RENDERABLE_TYPE = 0x3040
EGL_OPENGL_BIT = 0x0008
EGL_NONE = 0x3038
EGL_OPENGL_API = 0x30A2

GL_COLOR_BUFFER_BIT = 0x00004000
GL_DEPTH_BUFFER_BIT = 0x00000100
GL_DEPTH_TEST = 0x0B71
GL_BLEND = 0x0BE2
GL_SRC_ALPHA = 0x0302
GL_ONE_MINUS_SRC_ALPHA = 0x0303
GL_PROGRAM_POINT_SIZE = 0x8642
GL_ARRAY_BUFFER = 0x8892
GL_STATIC_DRAW = 0x88E4
GL_FLOAT = 0x1406
GL_DOUBLE = 0x140A
GL_UNSIGNED_BYTE = 0x1401
GL_UNSIGNED_SHORT = 0x1403
GL_VERTEX_SHADER = 0x8B31
GL_GEOMETRY_SHADER = 0x8DD9
GL_FRAGMENT_SHADER = 0x8B30
GL_COMPILE_STATUS = 0x8B81
GL_LINK_STATUS = 0x8B82
GL_INFO_LOG_LENGTH = 0x8B84
GL_POINTS = 0x0000
GL_LINES = 0x0001
GL_TRIANGLES = 0x0004
GL_TRIANGLE_STRIP = 0x0005
GL_FRAMEBUFFER = 0x8D40
GL_RENDERBUFFER = 0x8D41
GL_COLOR_ATTACHMENT0 = 0x8CE0
GL_DEPTH_ATTACHMENT = 0x8D00
GL_RGBA8 = 0x8058
GL_DEPTH_COMPONENT24 = 0x81A6
GL_FRAMEBUFFER_COMPLETE = 0x8CD5
GL_RGBA = 0x1908
GL_VERSION = 0x1F02
GL_RENDERER = 0x1F01
GL_LEQUAL = 0x0203
GL_UNSIGNED_INT = 0x1405
GL_ELEMENT_ARRAY_BUFFER = 0x8893
GL_TEXTURE_2D = 0x0DE1
GL_TEXTURE0 = 0x84C0
GL_TEXTURE_MIN_FILTER = 0x2801
GL_TEXTURE_MAG_FILTER = 0x2800
GL_TEXTURE_WRAP_S = 0x2802
GL_TEXTURE_WRAP_T = 0x2803
GL_CLAMP_TO_EDGE = 0x812F
GL_NEAREST = 0x2600
GL_LINEAR = 0x2601
GL_R32F = 0x822E
GL_RED = 0x1903
GL_UNPACK_ALIGNMENT = 0x0CF5

_lock = threading.Lock()
_egl: Optional[ctypes.CDLL] = None
_gl = None  # populated _GlFns
_probe_result: Optional[bool] = None


class _GlFns:
    """GL function table resolved via eglGetProcAddress."""

    _SIGS = {
        "glGetString": (ctypes.c_char_p, [ctypes.c_uint]),
        "glGetError": (ctypes.c_uint, []),
        "glViewport": (None, [ctypes.c_int] * 4),
        "glClearColor": (None, [ctypes.c_float] * 4),
        "glClear": (None, [ctypes.c_uint]),
        "glEnable": (None, [ctypes.c_uint]),
        "glDisable": (None, [ctypes.c_uint]),
        "glBlendFunc": (None, [ctypes.c_uint, ctypes.c_uint]),
        "glDepthFunc": (None, [ctypes.c_uint]),
        "glFinish": (None, []),
        "glCreateShader": (ctypes.c_uint, [ctypes.c_uint]),
        "glShaderSource": (
            None,
            [ctypes.c_uint, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
             ctypes.c_void_p],
        ),
        "glCompileShader": (None, [ctypes.c_uint]),
        "glGetShaderiv": (
            None, [ctypes.c_uint, ctypes.c_uint, ctypes.POINTER(ctypes.c_int)]
        ),
        "glGetShaderInfoLog": (
            None,
            [ctypes.c_uint, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
             ctypes.c_char_p],
        ),
        "glDeleteShader": (None, [ctypes.c_uint]),
        "glCreateProgram": (ctypes.c_uint, []),
        "glAttachShader": (None, [ctypes.c_uint, ctypes.c_uint]),
        "glLinkProgram": (None, [ctypes.c_uint]),
        "glGetProgramiv": (
            None, [ctypes.c_uint, ctypes.c_uint, ctypes.POINTER(ctypes.c_int)]
        ),
        "glGetProgramInfoLog": (
            None,
            [ctypes.c_uint, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
             ctypes.c_char_p],
        ),
        "glUseProgram": (None, [ctypes.c_uint]),
        "glDeleteProgram": (None, [ctypes.c_uint]),
        "glGetUniformLocation": (ctypes.c_int, [ctypes.c_uint, ctypes.c_char_p]),
        "glGetAttribLocation": (ctypes.c_int, [ctypes.c_uint, ctypes.c_char_p]),
        "glUniform1f": (None, [ctypes.c_int, ctypes.c_float]),
        "glUniform1i": (None, [ctypes.c_int, ctypes.c_int]),
        "glUniform2f": (None, [ctypes.c_int] + [ctypes.c_float] * 2),
        "glUniform3f": (None, [ctypes.c_int] + [ctypes.c_float] * 3),
        "glUniform4f": (None, [ctypes.c_int] + [ctypes.c_float] * 4),
        "glUniformMatrix4fv": (
            None,
            [ctypes.c_int, ctypes.c_int, ctypes.c_ubyte, ctypes.c_void_p],
        ),
        "glGenBuffers": (None, [ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]),
        "glBindBuffer": (None, [ctypes.c_uint, ctypes.c_uint]),
        "glBufferData": (
            None,
            [ctypes.c_uint, ctypes.c_ssize_t, ctypes.c_void_p, ctypes.c_uint],
        ),
        "glDeleteBuffers": (None, [ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]),
        "glGenVertexArrays": (None, [ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]),
        "glBindVertexArray": (None, [ctypes.c_uint]),
        "glDeleteVertexArrays": (
            None, [ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]
        ),
        "glEnableVertexAttribArray": (None, [ctypes.c_uint]),
        "glVertexAttribPointer": (
            None,
            [ctypes.c_uint, ctypes.c_int, ctypes.c_uint, ctypes.c_ubyte,
             ctypes.c_int, ctypes.c_void_p],
        ),
        "glDrawArrays": (None, [ctypes.c_uint, ctypes.c_int, ctypes.c_int]),
        "glDrawElements": (
            None, [ctypes.c_uint, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
        ),
        "glGenFramebuffers": (None, [ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]),
        "glBindFramebuffer": (None, [ctypes.c_uint, ctypes.c_uint]),
        "glDeleteFramebuffers": (
            None, [ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]
        ),
        "glGenRenderbuffers": (None, [ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]),
        "glBindRenderbuffer": (None, [ctypes.c_uint, ctypes.c_uint]),
        "glRenderbufferStorage": (
            None, [ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int]
        ),
        "glFramebufferRenderbuffer": (
            None, [ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint]
        ),
        "glDeleteRenderbuffers": (
            None, [ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]
        ),
        "glCheckFramebufferStatus": (ctypes.c_uint, [ctypes.c_uint]),
        "glGenTextures": (None, [ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]),
        "glBindTexture": (None, [ctypes.c_uint, ctypes.c_uint]),
        "glActiveTexture": (None, [ctypes.c_uint]),
        "glTexImage2D": (
            None,
            [ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
             ctypes.c_void_p],
        ),
        "glTexParameteri": (None, [ctypes.c_uint, ctypes.c_uint, ctypes.c_int]),
        "glDeleteTextures": (None, [ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]),
        "glPixelStorei": (None, [ctypes.c_uint, ctypes.c_int]),
        "glReadPixels": (
            None,
            [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p],
        ),
    }

    def __init__(self, egl: ctypes.CDLL) -> None:
        egl.eglGetProcAddress.restype = ctypes.c_void_p
        egl.eglGetProcAddress.argtypes = [ctypes.c_char_p]
        for name, (restype, argtypes) in self._SIGS.items():
            addr = egl.eglGetProcAddress(name.encode())
            if not addr:
                raise OSError(f"GL entry point {name} not found")
            fn = ctypes.CFUNCTYPE(restype, *argtypes)(addr)
            setattr(self, name, fn)


def _load_egl() -> ctypes.CDLL:
    egl = ctypes.CDLL("libEGL.so.1")
    egl.eglGetPlatformDisplay.restype = ctypes.c_void_p
    egl.eglGetPlatformDisplay.argtypes = [
        ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p
    ]
    egl.eglInitialize.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)
    ]
    egl.eglChooseConfig.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    egl.eglBindAPI.argtypes = [ctypes.c_uint]
    egl.eglCreateContext.restype = ctypes.c_void_p
    egl.eglCreateContext.argtypes = [ctypes.c_void_p] * 4
    egl.eglMakeCurrent.argtypes = [ctypes.c_void_p] * 4
    egl.eglDestroyContext.argtypes = [ctypes.c_void_p] * 2
    return egl


def create_context():
    """Create + make current a surfaceless GL context; returns (egl, gl,
    display, context).  Raises OSError when no driver is available."""
    global _egl, _gl
    with _lock:
        if _egl is None:
            _egl = _load_egl()
        egl = _egl
        dpy = egl.eglGetPlatformDisplay(
            EGL_PLATFORM_SURFACELESS_MESA, None, None
        )
        if not dpy:
            raise OSError("no EGL surfaceless display")
        maj, min_ = ctypes.c_int(), ctypes.c_int()
        if not egl.eglInitialize(dpy, ctypes.byref(maj), ctypes.byref(min_)):
            raise OSError("eglInitialize failed")
        attrs = (ctypes.c_int * 3)(EGL_RENDERABLE_TYPE, EGL_OPENGL_BIT, EGL_NONE)
        cfg = ctypes.c_void_p()
        n = ctypes.c_int()
        egl.eglChooseConfig(dpy, attrs, ctypes.byref(cfg), 1, ctypes.byref(n))
        egl.eglBindAPI(EGL_OPENGL_API)
        ctx = egl.eglCreateContext(dpy, cfg if n.value else None, None, None)
        if not ctx:
            raise OSError("eglCreateContext failed")
        if not egl.eglMakeCurrent(dpy, None, None, ctx):
            raise OSError("eglMakeCurrent failed")
        if _gl is None:
            _gl = _GlFns(egl)
        return egl, _gl, dpy, ctx


def probe() -> bool:
    global _probe_result
    if _probe_result is None:
        try:
            create_context()
            _probe_result = True
        except Exception:
            _probe_result = False
    return _probe_result
