"""A city survey in ECEF: a square site on and above the WGS84 surface,
half of the points uniform over it, half in Gaussian clusters (chip_smoke.py
`query_cloud`'s recipe).

The clusters' centres come from the configuration's `scene_seed`, so every
run surveys the same site; `--seed` draws the points, colours and
intensities."""

from __future__ import annotations

import numpy as np

from reference.geo import M_PER_DEG, geodetic_to_ecef


def _scene(g: dict) -> np.ndarray:
    """The clusters' centres: east, north and altitude in m."""
    edge = float(g["edge_m"])
    scene = np.random.default_rng(g["scene_seed"])
    centers = (scene.random((g["clusters"], 3)) - 0.5) * [edge, edge, 0.0]
    centers[:, 2] = scene.uniform(*g["altitude_m"], g["clusters"])
    return centers


def _points(g: dict, rng, n: int) -> np.ndarray:
    """n ECEF points of the site's distribution: the first half uniform,
    the rest in the clusters."""
    edge = float(g["edge_m"])
    alt_lo, alt_hi = g["altitude_m"]
    centers = _scene(g)
    half = n // 2
    east_north = (rng.random((n, 2)) - 0.5) * edge
    alt = rng.uniform(alt_lo, alt_hi, n)
    which = rng.integers(0, g["clusters"], n - half)
    east_north[half:] = np.clip(
        centers[which, :2]
        + rng.normal(0.0, g["sigma_across_m"], (n - half, 2)),
        -edge / 2, edge / 2)
    alt[half:] = np.clip(
        centers[which, 2] + rng.normal(0.0, g["sigma_up_m"], n - half),
        alt_lo, alt_hi)
    lat0, lon0 = g["site_lat_lon_deg"]
    lat = lat0 + east_north[:, 1] / M_PER_DEG
    lon = lon0 + east_north[:, 0] / (M_PER_DEG * np.cos(np.deg2rad(lat0)))
    return geodetic_to_ecef(np.deg2rad(lat), np.deg2rad(lon), alt)


def generate(cfg: dict, seed: int) -> dict:
    n = int(cfg["num_points"])
    rng = np.random.default_rng(seed)
    position = _points(cfg["generator_params"], rng, n)
    return {"position": position,
            "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
            "intensity": rng.random(n, dtype=np.float32)}


def sample_points(cfg: dict, rng, k: int) -> np.ndarray:
    """k points drawn from the site's distribution (not from a cloud):
    query centres that stay the same from seed to seed."""
    return _points(cfg["generator_params"], rng, k)[rng.permutation(k)]
