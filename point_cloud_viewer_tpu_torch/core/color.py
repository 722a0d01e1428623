"""Color utilities (reference: src/color.rs).

Colors are numpy arrays; helpers convert between u8 and normalized f32
with the reference's truncating semantics and provide its named constants.

Copy of point_cloud_viewer_tpu/core/color.py:1-25, unchanged.
"""

from __future__ import annotations

import numpy as np

WHITE = np.array([1.0, 1.0, 1.0, 1.0], dtype=np.float32)
BLACK = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)
RED = np.array([1.0, 0.0, 0.0, 1.0], dtype=np.float32)
GREEN = np.array([0.0, 1.0, 0.0, 1.0], dtype=np.float32)
BLUE = np.array([0.0, 0.0, 1.0, 1.0], dtype=np.float32)
TRANSPARENT = np.array([0.0, 0.0, 0.0, 0.0], dtype=np.float32)


def to_u8(color_f32: np.ndarray) -> np.ndarray:
    """f32 [0,1] -> u8, truncating like Rust `as` (color.rs:28-37)."""
    return np.clip(np.asarray(color_f32) * 255.0, 0, 255).astype(np.uint8)


def to_f32(color_u8: np.ndarray) -> np.ndarray:
    return np.asarray(color_u8).astype(np.float32) / 255.0
