"""GLSL shader sources (the reference keeps these in
sdl_viewer/shaders/*.vs/.fs; same idea here, loaded at program build).

Copy of point_cloud_viewer_tpu/viewer/gl/shaders/__init__.py:1-13, unchanged.
"""

from __future__ import annotations

import os

_DIR = os.path.dirname(os.path.abspath(__file__))


def load_shader(name: str) -> str:
    with open(os.path.join(_DIR, name), "r") as f:
        return f.read()
