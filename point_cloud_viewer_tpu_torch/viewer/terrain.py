"""Terrain streaming: tiled textures + camera-following moving windows
(reference: sdl_viewer/src/graphic/moving_window_texture.rs,
sdl_viewer/src/graphic/tiled_texture_loader.rs, sdl_viewer/src/terrain_drawer/).

The GL parts of the reference (clipmap mesh, shaders) need a display; the
machinery that makes terrain streaming work — sparse tile loading, the
toroidally-addressed window that updates only the newly-exposed L-shaped
strip (split into <= 4 wraparound regions), and the camera-following layer —
is implemented here over numpy textures and is fully testable headless.

On-disk terrain format (reference terrain_drawer/read_write.rs:8-50):
meta.json + per-tile files named x%08d_y%08d.height (f32 heights) and
x%08d_y%08d.color (RGBA u8).

Copy of point_cloud_viewer_tpu/viewer/terrain.py:1-263, unchanged.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


class TiledTextureLoader:
    """Sparse tile map: {(x, y) -> tile array}; load() stitches any aligned
    region, filling missing tiles with a fill value."""

    def __init__(self, tile_size: int, tiles: Dict[Tuple[int, int], np.ndarray],
                 fill_value=0) -> None:
        self.tile_size = tile_size
        self.tiles = tiles
        self.fill_value = fill_value
        sample = next(iter(tiles.values())) if tiles else None
        self._dtype = sample.dtype if sample is not None else np.float32
        self._channels = (
            sample.shape[2] if sample is not None and sample.ndim == 3 else 0
        )

    def load(self, min_x: int, min_y: int, width: int, height: int) -> np.ndarray:
        """Stitch the region [min_x, min_x+width) x [min_y, min_y+height)
        (in texel coordinates, tiles aligned at multiples of tile_size)."""
        shape = (height, width) if not self._channels else (height, width, self._channels)
        out = np.full(shape, self.fill_value, dtype=self._dtype)
        ts = self.tile_size
        tx0 = (min_x - (min_x % ts)) // ts  # floor(min_x / ts)
        ty0 = (min_y - (min_y % ts)) // ts
        for ty in range(ty0, (min_y + height + ts - 1) // ts + 1):
            for tx in range(tx0, (min_x + width + ts - 1) // ts + 1):
                tile = self.tiles.get((tx, ty))
                if tile is None:
                    continue
                # Tile texel range.
                x0, y0 = tx * ts, ty * ts
                sx0 = max(min_x, x0)
                sy0 = max(min_y, y0)
                sx1 = min(min_x + width, x0 + ts)
                sy1 = min(min_y + height, y0 + ts)
                if sx0 >= sx1 or sy0 >= sy1:
                    continue
                out[sy0 - min_y : sy1 - min_y, sx0 - min_x : sx1 - min_x] = tile[
                    sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0
                ]
        return out


@dataclass
class Region:
    """A rectangle of texels to refresh: window-space offset + data slice
    bounds in world texel coordinates."""

    x: int
    y: int
    width: int
    height: int


def wraparound_regions(x: int, y: int, width: int, height: int, size: int) -> List[Region]:
    """Split an update rectangle into <= 4 regions that are each contiguous
    after toroidal (mod size) addressing (reference:
    moving_window_texture.rs:24-341)."""
    regions = []
    x0 = x % size
    y0 = y % size
    x_splits = [(x0, min(width, size - x0))]
    if x0 + width > size:
        x_splits.append((0, x0 + width - size))
    y_splits = [(y0, min(height, size - y0))]
    if y0 + height > size:
        y_splits.append((0, y0 + height - size))
    for sy, hh in y_splits:
        for sx, ww in x_splits:
            if ww > 0 and hh > 0:
                regions.append(Region(sx, sy, ww, hh))
    return regions


class MovingWindowTexture:
    """A size x size texture window over an unbounded texel grid with
    toroidal addressing: moving the window re-uploads only the newly
    exposed strips."""

    def __init__(self, size: int, loader: TiledTextureLoader,
                 origin: Tuple[int, int] = (0, 0)) -> None:
        self.size = size
        self.loader = loader
        self.pos = (int(origin[0]), int(origin[1]))  # window min corner
        full = loader.load(self.pos[0], self.pos[1], size, size)
        self.texture = np.zeros_like(full)
        self._store(self.pos[0], self.pos[1], full)

    def _store(self, world_x: int, world_y: int, data: np.ndarray) -> None:
        """Write `data` (whose world min corner is (world_x, world_y)) into
        the toroidal texture, split into <= 4 contiguous regions."""
        h, w = data.shape[:2]
        sx = world_x % self.size
        sy = world_y % self.size
        x_parts = [(0, sx, min(w, self.size - sx))]
        if sx + w > self.size:
            x_parts.append((self.size - sx, 0, sx + w - self.size))
        y_parts = [(0, sy, min(h, self.size - sy))]
        if sy + h > self.size:
            y_parts.append((self.size - sy, 0, sy + h - self.size))
        for dy, ty, hh in y_parts:
            for dx, tx, ww in x_parts:
                self.texture[ty : ty + hh, tx : tx + ww] = data[
                    dy : dy + hh, dx : dx + ww
                ]

    def move_to(self, new_x: int, new_y: int) -> int:
        """Move the window; returns the number of texels re-uploaded."""
        old_x, old_y = self.pos
        dx, dy = new_x - old_x, new_y - old_y
        if dx == 0 and dy == 0:
            return 0
        if abs(dx) >= self.size or abs(dy) >= self.size:
            data = self.loader.load(new_x, new_y, self.size, self.size)
            self._store(new_x, new_y, data)
            self.pos = (new_x, new_y)
            return self.size * self.size
        uploaded = 0
        # Vertical strip: the new window's columns not covered by the old
        # window, over the new window's full height.
        if dx != 0:
            strip_x = old_x + self.size if dx > 0 else new_x
            w = abs(dx)
            data = self.loader.load(strip_x, new_y, w, self.size)
            self._store(strip_x, new_y, data)
            uploaded += w * self.size
        # Horizontal strip: the new window's uncovered rows, excluding the
        # columns already handled by the vertical strip (L-shape corner).
        if dy != 0:
            strip_y = old_y + self.size if dy > 0 else new_y
            h = abs(dy)
            strip_x0 = new_x if dx <= 0 else old_x + dx
            if dx < 0:
                strip_x0 = new_x + abs(dx)
            w = self.size - abs(dx)
            data = self.loader.load(strip_x0, strip_y, w, h)
            self._store(strip_x0, strip_y, data)
            uploaded += w * h
        self.pos = (new_x, new_y)
        return uploaded

    def sample(self, world_x: int, world_y: int):
        """Read the texel at world coordinates (must be inside the window)."""
        wx, wy = self.pos
        if not (wx <= world_x < wx + self.size and wy <= world_y < wy + self.size):
            raise IndexError("texel outside window")
        return self.texture[world_y % self.size, world_x % self.size]

    def snapshot(self) -> np.ndarray:
        """The window contents in world orientation (de-toroidalized)."""
        x0, y0 = self.pos
        rows = (np.arange(self.size) + y0) % self.size
        cols = (np.arange(self.size) + x0) % self.size
        return self.texture[np.ix_(rows, cols)]


# ---------------------------------------------------------------------------
# On-disk terrain


@dataclass
class TerrainMetadata:
    tile_size: int
    world_origin_x: float
    world_origin_y: float
    resolution_m: float

    @classmethod
    def from_directory(cls, directory: str) -> "TerrainMetadata":
        with open(os.path.join(directory, "meta.json")) as f:
            d = json.load(f)
        return cls(
            tile_size=d["tile_size"],
            world_origin_x=d["world_origin_x"],
            world_origin_y=d["world_origin_y"],
            resolution_m=d["resolution_m"],
        )

    def save(self, directory: str) -> None:
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(self.__dict__, f, indent=2)


def tile_path(directory: str, x: int, y: int, kind: str) -> str:
    return os.path.join(directory, f"x{x:08d}_y{y:08d}.{kind}")


def load_terrain_tiles(directory: str) -> Tuple[TerrainMetadata, Dict, Dict]:
    """-> (meta, height tiles {(x,y): (S,S) f32}, color tiles
    {(x,y): (S,S,4) u8})."""
    meta = TerrainMetadata.from_directory(directory)
    heights: Dict[Tuple[int, int], np.ndarray] = {}
    colors: Dict[Tuple[int, int], np.ndarray] = {}
    s = meta.tile_size
    for name in os.listdir(directory):
        if not name.startswith("x"):
            continue
        stem, _, kind = name.partition(".")
        x = int(stem[1:9])
        y = int(stem[11:19])
        path = os.path.join(directory, name)
        if kind == "height":
            heights[(x, y)] = np.fromfile(path, dtype="<f4").reshape(s, s)
        elif kind == "color":
            colors[(x, y)] = np.fromfile(path, dtype=np.uint8).reshape(s, s, 4)
    return meta, heights, colors


class TerrainLayer:
    """Camera-following height+color windows (reference terrain_drawer/
    layer.rs:19-242): the window min corner tracks the camera in integer
    grid coordinates."""

    def __init__(self, directory: str, window_size: int = 256) -> None:
        self.meta, heights, colors = load_terrain_tiles(directory)
        self.window_size = window_size
        self.height_window = MovingWindowTexture(
            window_size,
            TiledTextureLoader(self.meta.tile_size, heights, fill_value=np.nan),
        )
        self.color_window = MovingWindowTexture(
            window_size, TiledTextureLoader(self.meta.tile_size, colors, fill_value=0)
        )

    def grid_pos(self, world_xy) -> Tuple[int, int]:
        gx = int(np.floor((world_xy[0] - self.meta.world_origin_x) / self.meta.resolution_m))
        gy = int(np.floor((world_xy[1] - self.meta.world_origin_y) / self.meta.resolution_m))
        return gx, gy

    def follow_camera(self, camera_world_xy) -> int:
        gx, gy = self.grid_pos(camera_world_xy)
        target = (gx - self.window_size // 2, gy - self.window_size // 2)
        a = self.height_window.move_to(*target)
        b = self.color_window.move_to(*target)
        return a + b

    def height_at(self, world_xy) -> float:
        gx, gy = self.grid_pos(world_xy)
        return float(self.height_window.sample(gx, gy))
