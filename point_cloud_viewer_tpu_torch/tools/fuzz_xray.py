"""X-ray strategy fuzz of the port: random configurations (strategy kind,
binning, intensity ranges, tile sizes, point distributions incl.
edge-sitters and empty/degenerate batches) -- the splat reductions on
--device must render the same images as the host's numpy unique/bincount
reductions.  Twin of the JAX package's tools/fuzz_xray.py, with the same
generators, checks and final line.

Exactness conditions (see xray/device_splat.py): intensities are quantized
to 1/64 steps so all f64 sums are association-independent; colors are u8
so sums are exact integers.  Images must be equal when z is quantized, and
within 1 LSB for full-f64 height stddev.

Usage: python -m point_cloud_viewer_tpu_torch.tools.fuzz_xray [seconds] \
           [--device cuda|cpu]
(FUZZ_SEED=n varies the run, FUZZ_MAX_ITERS=n bounds it.)

The host strategy is make_strategy(kind, device=None, ...), the numpy
route; the device strategy is make_strategy(kind, device=<--device>, ...).

Campaign results of the port are recorded in PERF.md.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

KINDS = ["xray", "colored", "colored_with_intensity",
         "colored_with_height_stddev"]


def main(argv=None) -> int:
    from ..core.points_batch import PointsBatch
    from ..math.geometry import Aabb
    from ..xray.generation import make_strategy
    from .fuzz_differential import parse_args

    deadline, dev = parse_args(argv, __doc__)
    max_iters = int(os.environ.get("FUZZ_MAX_ITERS", 10**9))
    rng_master = np.random.default_rng(int(os.environ.get("FUZZ_SEED", 4)))
    it = 0
    while time.time() < deadline and it < max_iters:
        it += 1
        seed = int(rng_master.integers(0, 2**31))
        rng = np.random.default_rng(seed)
        kind = KINDS[int(rng.integers(0, len(KINDS)))]
        size = int(rng.choice([16, 64, 256]))
        extent = rng.uniform(1.0, 200.0, 3)
        bbox = Aabb(np.zeros(3), extent)
        kwargs = {}
        if kind == "colored_with_intensity":
            kwargs = {"min_intensity": float(rng.uniform(0.01, 2.0)),
                      "max_intensity": float(rng.uniform(10.0, 1e5))}
        elif kind == "colored_with_height_stddev":
            kwargs = {"max_stddev": float(rng.uniform(0.1, 10.0)),
                      "colormap": str(rng.choice(["jet", "purplish"]))}
        if kind in ("colored", "colored_with_intensity") and rng.random() < 0.5:
            kwargs["binning"] = ("ts", float(rng.uniform(0.5, 50.0)))
        # Height-stddev exactness precondition (device_splat.py docstring):
        # quantized z -> bit-equality is a theorem; full-f64 z -> device
        # sums may differ in the last ulp, image by <= 1 LSB at colormap
        # boundaries.
        quantize_z = kind != "colored_with_height_stddev" or rng.random() < 0.5
        nb = int(rng.integers(1, 4))
        batches = []
        for _ in range(nb):
            n = int(rng.choice([0, 3, 1000, 50_000]))
            pos = rng.random((n, 3)) * extent
            if quantize_z and n:
                pos[:, 2] = np.round(pos[:, 2] * 64.0) / 64.0
            if n and rng.random() < 0.3:
                pos[: n // 4, 1] = 0.0           # min-y edge: discretize drops
                pos[n // 4 : n // 2, 0] = extent[0] * 0.999999
            attrs = {
                "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
                "intensity": (rng.integers(-640, 64_000, n) / 64.0).astype(
                    np.float32),
                "ts": rng.random(n) * 100.0 - 20.0,
            }
            batches.append(PointsBatch(position=pos, attributes=attrs))
        tag = (f"it{it} seed={seed} {kind} size={size} kwargs={kwargs} "
               f"nb={nb} device={dev}")
        try:
            host = make_strategy(kind, device=None, **kwargs)
            on_dev = make_strategy(kind, device=dev, **kwargs)
            for b in batches:
                host.process(b, bbox, size)
                on_dev.process(b, bbox, size)
            ih, idv = host.render(size), on_dev.render(size)
            if quantize_z:
                assert np.array_equal(ih, idv), (
                    f"{tag}: host/device images differ")
            else:
                d = np.abs(ih.astype(np.int16) - idv.astype(np.int16)).max()
                assert d <= 1, f"{tag}: full-f64 stddev drift {d} LSB (> 1)"
            print(f"OK {tag} (exact={quantize_z})", flush=True)
        except Exception:
            print(f"FAIL {tag}", flush=True)
            raise
    print(f"xray fuzz finished: {it} iterations, no failures", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
