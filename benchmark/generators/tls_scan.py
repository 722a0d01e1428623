"""A terrestrial laser scan: half of the points uniform over the scene's
box, half in Gaussian clusters (chip_smoke.py `write_ply`'s recipe).

The clusters' centres come from the configuration's `scene_seed`, so every
run scans the same scene and the octree keeps its shape from seed to seed;
`--seed` draws the points, colours and intensities."""

from __future__ import annotations

import numpy as np


def generate(cfg: dict, seed: int) -> dict:
    g = cfg["generator_params"]
    n = int(cfg["num_points"])
    extent = np.asarray(g["extent_m"], dtype=np.float64)
    centers = np.random.default_rng(g["scene_seed"]).random(
        (g["clusters"], 3)) * extent
    rng = np.random.default_rng(seed)
    half = n // 2
    pos = np.empty((n, 3))
    pos[:half] = rng.random((half, 3)) * extent
    which = rng.integers(0, g["clusters"], n - half)
    pos[half:] = centers[which] + rng.normal(0.0, g["sigma_m"], (n - half, 3))
    return {"position": pos,
            "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
            "intensity": rng.random(n, dtype=np.float32)}
