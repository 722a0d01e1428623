"""WGS84 ellipsoid conversions: geodetic <-> ECEF, and local ENU frames.

Replaces the reference's nav-types dependency with vectorized numpy.  The
geodetic -> ECEF direction is closed-form; the inverse uses Bowring's
iteration to sub-millimeter accuracy (matching nav-types' practical
precision, which the reference relies on for WebMercatorRect containment —
src/geometry/web_mercator_rect.rs:119-125).

Copy of point_cloud_viewer_tpu/math/wgs84.py:1-86, unchanged.
"""

from __future__ import annotations

import numpy as np

from .geometry import Isometry

# WGS84 defining parameters.
SEMI_MAJOR_M = 6378137.0
FLATTENING = 1.0 / 298.257223563
SEMI_MINOR_M = SEMI_MAJOR_M * (1.0 - FLATTENING)
ECC_SQ = FLATTENING * (2.0 - FLATTENING)  # first eccentricity squared
ECC2_SQ = ECC_SQ / (1.0 - ECC_SQ)  # second eccentricity squared

# Earth-radius extremes (reference: src/math/mod.rs:32-35).
EARTH_RADIUS_MIN_M = 6_352_800.0
EARTH_RADIUS_MAX_M = 6_384_400.0


def geodetic_to_ecef(lat_rad, lon_rad, alt_m):
    """Vectorized geodetic -> ECEF. Inputs broadcast; returns (..., 3)."""
    lat = np.asarray(lat_rad, dtype=np.float64)
    lon = np.asarray(lon_rad, dtype=np.float64)
    alt = np.asarray(alt_m, dtype=np.float64)
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = SEMI_MAJOR_M / np.sqrt(1.0 - ECC_SQ * sin_lat**2)
    x = (n + alt) * cos_lat * np.cos(lon)
    y = (n + alt) * cos_lat * np.sin(lon)
    z = (n * (1.0 - ECC_SQ) + alt) * sin_lat
    return np.stack([x, y, z], axis=-1)


def ecef_to_geodetic(ecef):
    """Vectorized ECEF (..., 3) -> (lat_rad, lon_rad, alt_m).

    Bowring's method with two refinement iterations (≈ nanometer-level for
    terrestrial points)."""
    ecef = np.asarray(ecef, dtype=np.float64)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    # Initial parametric latitude.
    theta = np.arctan2(z * SEMI_MAJOR_M, p * SEMI_MINOR_M)
    for _ in range(3):
        sin_t, cos_t = np.sin(theta), np.cos(theta)
        lat = np.arctan2(
            z + ECC2_SQ * SEMI_MINOR_M * sin_t**3,
            p - ECC_SQ * SEMI_MAJOR_M * cos_t**3,
        )
        theta = np.arctan2(SEMI_MINOR_M * np.sin(lat), SEMI_MAJOR_M * np.cos(lat))
    sin_lat = np.sin(lat)
    n = SEMI_MAJOR_M / np.sqrt(1.0 - ECC_SQ * sin_lat**2)
    # Altitude from whichever direction is better conditioned.
    cos_lat = np.cos(lat)
    alt = np.where(
        np.abs(cos_lat) > 1e-10,
        p / np.where(np.abs(cos_lat) > 1e-10, cos_lat, 1.0) - n,
        np.abs(z) - SEMI_MINOR_M,
    )
    return lat, lon, alt


def local_frame_from_lat_lng(lat_deg: float, lon_deg: float) -> Isometry:
    """ECEF -> local ENU frame at the given origin (altitude 0).

    Matches the reference's rotation composition
    (src/math/mod.rs:167-183): Rz(-pi/2) * Ry(lat - pi/2) * Rz(-lon),
    translated so the origin maps to zero.
    """
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    origin = geodetic_to_ecef(lat, lon, 0.0)

    rot_1 = Isometry.from_axis_angle([0, 0, 1], -np.pi / 2).rotation
    rot_2 = Isometry.from_axis_angle([0, 1, 0], lat - np.pi / 2).rotation
    rot_3 = Isometry.from_axis_angle([0, 0, 1], -lon).rotation
    rotation = rot_1 @ rot_2 @ rot_3
    return Isometry(rotation, rotation @ (-origin))
