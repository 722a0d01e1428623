"""Headless software point rasterizer (copy of point_cloud_viewer_tpu/
viewer/software_raster.py:17-100, unchanged).

Stands in for the reference's OpenGL draw path (sdl_viewer): projects world
points through a clip_from_world matrix and paints them with a z-buffer
(painter's order by depth), entirely in numpy.  Used by the headless viewer
loop for screenshots.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rasterize_points(
    positions: np.ndarray,
    colors: np.ndarray,
    clip_from_world: np.ndarray,
    width: int,
    height: int,
    point_size: int = 1,
    background: Tuple[int, int, int, int] = (17, 17, 20, 255),
) -> np.ndarray:
    """-> (height, width, 4) u8 RGBA image."""
    img = np.empty((height, width, 4), dtype=np.uint8)
    img[:] = background
    if len(positions) == 0:
        return img
    q = positions @ clip_from_world[:3, :3].T + clip_from_world[:3, 3]
    w = positions @ clip_from_world[3, :3].T + clip_from_world[3, 3]
    keep = w > 1e-9
    ndc = q[keep] / w[keep, None]
    colors = colors[keep]
    inside = np.all(np.abs(ndc[:, :2]) <= 1.0, axis=1) & (np.abs(ndc[:, 2]) <= 1.0)
    ndc = ndc[inside]
    colors = colors[inside]
    if len(ndc) == 0:
        return img
    px = ((ndc[:, 0] * 0.5 + 0.5) * (width - 1)).astype(np.int64)
    py = ((0.5 - ndc[:, 1] * 0.5) * (height - 1)).astype(np.int64)
    # Far-to-near painter order: nearest assignments land last.
    order = np.argsort(-ndc[:, 2], kind="stable")
    px, py, colors = px[order], py[order], colors[order]
    rgba = np.concatenate(
        [colors, np.full((len(colors), 1), 255, dtype=np.uint8)], axis=1
    )
    if point_size <= 1:
        img[py, px] = rgba
    else:
        r = point_size // 2
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                yy = np.clip(py + dy, 0, height - 1)
                xx = np.clip(px + dx, 0, width - 1)
                img[yy, xx] = rgba
    return img


# Cube edges as corner-index pairs (corner c: x=c&1, y=(c>>1)&1, z=(c>>2)&1).
_BOX_EDGES = np.array(
    [(0, 1), (2, 3), (4, 5), (6, 7),  # x-aligned
     (0, 2), (1, 3), (4, 6), (5, 7),  # y-aligned
     (0, 4), (1, 5), (2, 6), (3, 7)]  # z-aligned
)
_CORNER_UNIT = np.array(
    [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.float64
)


def draw_wireframe_boxes(
    img: np.ndarray,
    mins: np.ndarray,
    edges: np.ndarray,
    clip_from_world: np.ndarray,
    color=(255, 255, 0, 255),
    samples_per_edge: int = 32,
) -> np.ndarray:
    """Overlay node-cube outlines (the reference's box_drawer,
    sdl_viewer/src/box_drawer.rs): each of the 12 edges is rendered as a
    sampled polyline through the projection."""
    height, width = img.shape[:2]
    corners = mins[:, None, :] + _CORNER_UNIT[None, :, :] * np.asarray(edges)[:, None, None]
    t = np.linspace(0.0, 1.0, samples_per_edge)
    a = corners[:, _BOX_EDGES[:, 0], :]  # (K, 12, 3)
    b = corners[:, _BOX_EDGES[:, 1], :]
    pts = a[:, :, None, :] + (b - a)[:, :, None, :] * t[None, None, :, None]
    pts = pts.reshape(-1, 3)
    q = pts @ clip_from_world[:3, :3].T + clip_from_world[:3, 3]
    w = pts @ clip_from_world[3, :3].T + clip_from_world[3, 3]
    keep = w > 1e-9
    ndc = q[keep] / w[keep, None]
    inside = np.all(np.abs(ndc[:, :2]) <= 1.0, axis=1) & (np.abs(ndc[:, 2]) <= 1.0)
    ndc = ndc[inside]
    if len(ndc):
        px = ((ndc[:, 0] * 0.5 + 0.5) * (width - 1)).astype(np.int64)
        py = ((0.5 - ndc[:, 1] * 0.5) * (height - 1)).astype(np.int64)
        img[py, px] = color
    return img
