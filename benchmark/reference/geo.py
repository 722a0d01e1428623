"""WGS84 and Web Mercator conversions, frozen copies of the program's
math/wgs84.py (geodetic_to_ecef, ecef_to_geodetic) and math/web_mercator.py
(lat_lng_to_web_mercator, ecef_to_web_mercator), and a local east-north-up
basis."""

from __future__ import annotations

import numpy as np

SEMI_MAJOR_M = 6378137.0
FLATTENING = 1.0 / 298.257223563
SEMI_MINOR_M = SEMI_MAJOR_M * (1.0 - FLATTENING)
ECC_SQ = FLATTENING * (2.0 - FLATTENING)
ECC2_SQ = ECC_SQ / (1.0 - ECC_SQ)
M_PER_DEG = 111_320.0
LAT_BOUND_RAD = 1.4844222297453324


def geodetic_to_ecef(lat_rad, lon_rad, alt_m) -> np.ndarray:
    lat = np.asarray(lat_rad, dtype=np.float64)
    lon = np.asarray(lon_rad, dtype=np.float64)
    alt = np.asarray(alt_m, dtype=np.float64)
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = SEMI_MAJOR_M / np.sqrt(1.0 - ECC_SQ * sin_lat**2)
    x = (n + alt) * cos_lat * np.cos(lon)
    y = (n + alt) * cos_lat * np.sin(lon)
    z = (n * (1.0 - ECC_SQ) + alt) * sin_lat
    return np.stack([x, y, z], axis=-1)


def ecef_to_geodetic(ecef) -> tuple:
    """(..., 3) -> (lat_rad, lon_rad, alt_m), Bowring's method."""
    ecef = np.asarray(ecef, dtype=np.float64)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    theta = np.arctan2(z * SEMI_MAJOR_M, p * SEMI_MINOR_M)
    for _ in range(3):
        sin_t, cos_t = np.sin(theta), np.cos(theta)
        lat = np.arctan2(z + ECC2_SQ * SEMI_MINOR_M * sin_t**3,
                         p - ECC_SQ * SEMI_MAJOR_M * cos_t**3)
        theta = np.arctan2(SEMI_MINOR_M * np.sin(lat),
                           SEMI_MAJOR_M * np.cos(lat))
    sin_lat = np.sin(lat)
    n = SEMI_MAJOR_M / np.sqrt(1.0 - ECC_SQ * sin_lat**2)
    cos_lat = np.cos(lat)
    alt = np.where(np.abs(cos_lat) > 1e-10,
                   p / np.where(np.abs(cos_lat) > 1e-10, cos_lat, 1.0) - n,
                   np.abs(z) - SEMI_MINOR_M)
    return lat, lon, alt


def lat_lng_to_web_mercator(lat_rad, lon_rad) -> np.ndarray:
    """-> normalized [0, 1) Web Mercator (..., 2)."""
    lat = np.clip(np.asarray(lat_rad, dtype=np.float64), -LAT_BOUND_RAD,
                  LAT_BOUND_RAD)
    sin_y = np.sin(lat)
    x = 0.5 + np.asarray(lon_rad) / (2.0 * np.pi)
    y = 0.5 - np.log((1.0 + sin_y) / (1.0 - sin_y)) * (0.25 / np.pi)
    return np.stack([x, y], axis=-1)


def ecef_to_web_mercator(points: np.ndarray) -> np.ndarray:
    lat, lon, _ = ecef_to_geodetic(points)
    return lat_lng_to_web_mercator(lat, lon)


def enu_basis(lat_rad: float, lon_rad: float) -> np.ndarray:
    """(3, 3) rows east, north, up in ECEF at (lat, lon)."""
    sl, cl = np.sin(lat_rad), np.cos(lat_rad)
    so, co = np.sin(lon_rad), np.cos(lon_rad)
    return np.array([[-so, co, 0.0],
                     [-sl * co, -sl * so, cl],
                     [cl * co, cl * so, sl]])
