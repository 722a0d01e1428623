"""Web Mercator projection and rectangles, vectorized.

Formulas match the reference (src/math/web_mercator.rs:27-98 and
src/geometry/web_mercator_rect.rs) including latitude clamping before sin(),
the normalized-[0,1) internal representation, and the extruded-ECEF convex
polyhedron for 3D queries.

Copy of point_cloud_viewer_tpu/math/web_mercator.py:1-150, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import wgs84
from .sat import Intersector, normalize

LAT_BOUND_RAD = 1.4844222297453324
LAT_BOUND_SIN = 0.99627207622075
TILE_SIZE = 256
MAX_ZOOM = 23

MIN_ELEVATION_M = -500.0
MAX_ELEVATION_M = 10000.0


def lat_lng_to_web_mercator(lat_rad, lon_rad) -> np.ndarray:
    """(...,) lat/lon radians -> normalized [0,1) Web Mercator (..., 2)."""
    lat = np.clip(np.asarray(lat_rad, dtype=np.float64), -LAT_BOUND_RAD, LAT_BOUND_RAD)
    sin_y = np.sin(lat)
    x = 0.5 + np.asarray(lon_rad) / (2.0 * np.pi)
    y = 0.5 - np.log((1.0 + sin_y) / (1.0 - sin_y)) * (0.25 / np.pi)
    return np.stack([x, y], axis=-1)


def web_mercator_to_lat_lng(normalized: np.ndarray):
    """Normalized (..., 2) -> (lat_rad, lon_rad); altitude is 0."""
    normalized = np.asarray(normalized, dtype=np.float64)
    cx = normalized[..., 0] - 0.5
    cy = normalized[..., 1] - 0.5
    sin_term = np.exp(-cy * 4.0 * np.pi)
    one_over_sin_y = (sin_term + 1.0) * -0.5
    sin_y = np.clip(1.0 / one_over_sin_y + 1.0, -LAT_BOUND_SIN, LAT_BOUND_SIN)
    lon = np.clip(cx * 2.0 * np.pi, -np.pi, np.pi)
    return np.arcsin(sin_y), lon


def ecef_to_web_mercator(points: np.ndarray) -> np.ndarray:
    """(N, 3) ECEF -> (N, 2) normalized Web Mercator."""
    lat, lon, _ = wgs84.ecef_to_geodetic(points)
    return lat_lng_to_web_mercator(lat, lon)


@dataclass(frozen=True)
class WebMercatorCoord:
    """A single normalized-[0,1) Web Mercator coordinate."""

    normalized: np.ndarray

    @classmethod
    def from_lat_lng(cls, lat_rad: float, lon_rad: float) -> "WebMercatorCoord":
        return cls(lat_lng_to_web_mercator(lat_rad, lon_rad))

    def to_lat_lng(self):
        lat, lon = web_mercator_to_lat_lng(self.normalized)
        return float(lat), float(lon)

    def to_zoomed_coordinate(self, z: int) -> Optional[np.ndarray]:
        if z > MAX_ZOOM:
            return None
        return self.normalized * float(TILE_SIZE << z)

    @classmethod
    def from_zoomed_coordinate(cls, coord, z: int) -> Optional["WebMercatorCoord"]:
        coord = np.asarray(coord, dtype=np.float64)
        if z > MAX_ZOOM or coord.min() < 0.0:
            return None
        zoom = float(TILE_SIZE << z)
        if coord.max() >= zoom:
            return None
        return cls(coord / zoom)


class WebMercatorRect:
    """An unrotated rectangle on the Web Mercator map, usable as a 3D query
    volume by extruding its corners along altitude (reference:
    src/geometry/web_mercator_rect.rs:58-116)."""

    def __init__(self, north_west: WebMercatorCoord, south_east: WebMercatorCoord) -> None:
        self.north_west = north_west
        self.south_east = south_east

    @classmethod
    def from_zoomed_coordinates(cls, min_xy, max_xy, z: int) -> Optional["WebMercatorRect"]:
        nw = WebMercatorCoord.from_zoomed_coordinate(min_xy, z)
        se = WebMercatorCoord.from_zoomed_coordinate(max_xy, z)
        if nw is None or se is None:
            return None
        diff = (np.asarray(max_xy, dtype=np.float64) - np.asarray(min_xy)) / float(1 << z)
        # x may wrap around the antimeridian; y may not.
        if np.remainder(diff[0], 256.0) > 1.0 or diff[1] > 1.0 or diff[1] < 0.0:
            return None
        return cls(nw, se)

    def contains(self, points: np.ndarray) -> np.ndarray:
        """(N, 3) ECEF points -> (N,) bool; NW-closed, SE-open interval."""
        wmc = ecef_to_web_mercator(np.atleast_2d(points))
        nw = self.north_west.normalized
        se = self.south_east.normalized
        return np.all((nw <= wmc) & (wmc < se), axis=-1)

    def corners(self) -> np.ndarray:
        """8 ECEF corners: the 4 rect corners at MIN then MAX elevation,
        ordered NW, NE, SE, SW (reference order)."""
        nw_lat, nw_lon = self.north_west.to_lat_lng()
        se_lat, se_lon = self.south_east.to_lat_lng()
        lats = [nw_lat, nw_lat, se_lat, se_lat]
        lons = [nw_lon, se_lon, se_lon, nw_lon]
        out = []
        for elevation in (MIN_ELEVATION_M, MAX_ELEVATION_M):
            out.append(
                wgs84.geodetic_to_ecef(np.array(lats), np.array(lons), elevation)
            )
        return np.concatenate(out)

    def intersector(self) -> Intersector:
        c = self.corners()
        edges = normalize(
            np.stack(
                [
                    c[1] - c[0], c[2] - c[1], c[3] - c[2], c[0] - c[3],  # down ring
                    c[5] - c[4], c[6] - c[5], c[7] - c[6], c[4] - c[7],  # up ring
                    c[4] - c[0], c[5] - c[1], c[6] - c[2], c[7] - c[3],  # verticals
                ]
            )
        )
        face_normals = normalize(
            np.stack(
                [
                    np.cross(edges[0], edges[8]),   # N
                    np.cross(edges[1], edges[9]),   # E
                    np.cross(edges[2], edges[10]),  # S
                    np.cross(edges[3], edges[11]),  # W
                    np.cross(edges[1], edges[0]),   # down
                    np.cross(edges[5], edges[4]),   # up
                ]
            )
        )
        return Intersector(corners=c, edges=edges, face_normals=face_normals)
