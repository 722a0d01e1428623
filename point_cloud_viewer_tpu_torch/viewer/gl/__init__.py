"""Real OpenGL render path of the port (copy of point_cloud_viewer_tpu/
viewer/gl/, the reference's sdl_viewer GPU pipeline).

The reference draws points through GLSL programs compiled by a live GL
driver (sdl_viewer/src/graphic/mod.rs, node_drawer.rs, shaders/*.vs).
This package is its counterpart, designed for headless operation: a
surfaceless EGL context renders into an offscreen framebuffer, with
glReadPixels screenshots.  Vertex data goes from host numpy arrays to GL
buffers; no CUDA-GL interop is used.  The modules are copies of the JAX
package's, the context bootstrap (api.py) included.

`available()` says whether a context can be created here.  Where no GL
driver exists, constructing a context raises: the viewers never turn a GL
request into software rendering.
"""

from __future__ import annotations


def available() -> bool:
    """True when a headless GL context can be created on this machine
    (point_cloud_viewer_tpu/viewer/gl/__init__.py:18-25)."""
    try:
        from . import api

        return api.probe()
    except Exception:
        return False
