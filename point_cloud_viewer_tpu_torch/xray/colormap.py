"""Colormaps for X-ray tiles (reference: xray/src/colormap.rs), vectorized:
value arrays in [0,1] -> (N, 4) u8 RGBA.

Copy of point_cloud_viewer_tpu/xray/colormap.py:1-42, unchanged.
"""

from __future__ import annotations

import numpy as np

PURPLISH = (0.8, 0.8, 1.0, 1.0)


def _jet_base(val: np.ndarray) -> np.ndarray:
    """Matlab jet base ramp."""
    out = np.zeros_like(val)
    out = np.where(val <= -0.75, 0.0, out)
    m = (val > -0.75) & (val <= -0.25)
    out = np.where(m, (val + 0.75) * 2.0, out)
    out = np.where((val > -0.25) & (val <= 0.25), 1.0, out)
    m = (val > 0.25) & (val <= 0.75)
    out = np.where(m, 1.0 - (val - 0.25) * 2.0, out)
    return out


def jet(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values, dtype=np.float32)
    rgba = np.stack(
        [
            _jet_base(v - 0.5),
            _jet_base(v),
            _jet_base(v + 0.5),
            np.ones_like(v),
        ],
        axis=-1,
    )
    return (rgba * 255.0).astype(np.uint8)


def monochrome(values: np.ndarray, base=PURPLISH) -> np.ndarray:
    """Interpolate from `base` at 0 to black at 1 (alpha stays opaque)."""
    v = np.asarray(values, dtype=np.float32)[..., None]
    rgb = (1.0 - v) * np.asarray(base[:3], dtype=np.float32)
    alpha = np.ones_like(v)
    return (np.concatenate([rgb, alpha], axis=-1) * 255.0).astype(np.uint8)
