"""Crash-injection fuzz of the port's streaming build: kill it at random
points (in the spill pass, bucket builds, node writes, or the device
bucket route's dispatch and completion stages), resume -- possibly crashing
again -- and require output byte-identical to an uninterrupted build.  Twin
of the JAX package's tools/fuzz_crash_resume.py, with the same generators,
checks and final line.

Usage: python -m point_cloud_viewer_tpu_torch.tools.fuzz_crash_resume \
           [seconds] [--device cuda|cpu]
(FUZZ_SEED=n varies the run, FUZZ_MAX_ITERS=n bounds it.)

The uninterrupted build is the host route, as in the original; a crashing
build takes the device bucket route on --device (cuda by default) in 30%
of the iterations.  With the original's generators a crash is seldom
drawn at the two device-bucket hooks before the build ends, so they are
rarely reached; tests/test_torch_streaming.py crashes and resumes the
device route at _finish_device_bucket directly.  The five hooks patch the
port's modules and are restored in a `finally`, so an in-process call
leaves the port unpatched.

Campaign results of the port are recorded in PERF.md.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ..octree import builder as B
from ..octree import streaming as S


class Boom(Exception):
    pass


HOOKS = {
    "bucket": (S, "_build_bucket_subtree"),
    "spill_append": (S._BucketSpill, "append"),
    # builder.py binds write_node_files at import: patch ITS binding.
    "write_node": (B, "write_node_files"),
    # Device (pipelined) bucket route: dispatch and completion stages.
    "dev_dispatch": (S, "_dispatch_device_bucket"),
    "dev_finish": (S, "_finish_device_bucket"),
}
REAL = {k: getattr(mod, name) for k, (mod, name) in HOOKS.items()}


def with_crash(hook, crash_at):
    mod, name = HOOKS[hook]
    real = REAL[hook]
    state = {"n": 0}

    def wrapper(*a, **kw):
        state["n"] += 1
        if state["n"] == crash_at:
            raise Boom(f"{hook}@{crash_at}")
        return real(*a, **kw)

    setattr(mod, name, wrapper)


def restore():
    for k, (mod, name) in HOOKS.items():
        setattr(mod, name, REAL[k])


def main(argv=None) -> int:
    from ..core.points_batch import PointsBatch
    from ..math.geometry import Aabb
    from .fuzz_differential import parse_args

    deadline, dev = parse_args(argv, __doc__)
    max_iters = int(os.environ.get("FUZZ_MAX_ITERS", 10**9))
    rng_master = np.random.default_rng(int(os.environ.get("FUZZ_SEED", 5)))
    it = 0
    try:
        while time.time() < deadline and it < max_iters:
            it += 1
            seed = int(rng_master.integers(0, 2**31))
            rng = np.random.default_rng(seed)
            n = int(rng.choice([40_000, 300_000]))
            style = rng.random()
            pos = rng.random((n, 3)) * 64.0
            if style < 0.4:  # clustered: uneven buckets, some split deep
                k = 6
                centers = rng.random((k, 3)) * 60
                pos = centers[rng.integers(0, k, n)] + rng.normal(0, 0.3, (n, 3))
            batch = PointsBatch(position=pos, attributes={
                "color": rng.integers(0, 256, (n, 3), dtype=np.uint8)})
            bl = int(rng.choice([1, 2]))
            res = float(rng.choice([0.01, 0.05]))
            use_device = bool(rng.random() < 0.3)  # pipelined device buckets
            base = tempfile.mkdtemp(prefix="rfuzz_")
            tag = (f"it{it} seed={seed} n={n} bl={bl} res={res} "
                   f"dev={use_device} device={dev}")
            try:
                ref = os.path.join(base, "ref")
                S.build_octree_streaming(ref, res, batch, bucket_levels=bl,
                                         use_device=False)
                crash_dir = os.path.join(base, "crash")
                spill = os.path.join(base, "spill")
                bbox = Aabb.bounding_points(pos)
                attempts = 0
                crashes = []
                while True:
                    attempts += 1
                    assert attempts < 30, f"{tag}: did not converge"
                    if rng.random() < 0.75:   # 25%: let this attempt run clean
                        pool = (["bucket", "spill_append", "write_node"]
                                if not use_device else
                                ["spill_append", "write_node", "dev_dispatch",
                                 "dev_finish"])
                        hook = pool[int(rng.integers(0, len(pool)))]
                        hi = {"bucket": 9, "spill_append": 2, "write_node": 60,
                              "dev_dispatch": 9, "dev_finish": 9}[hook]
                        with_crash(hook, int(rng.integers(1, hi)))
                    try:
                        S.build_octree_streaming(
                            crash_dir, res, batch, bounding_box=bbox,
                            bucket_levels=bl, spill_directory=spill,
                            use_device=use_device, device=dev,
                        )
                        break  # completed
                    except Boom as e:
                        crashes.append(str(e))  # resume on next loop
                    finally:
                        restore()
                fa, fb = sorted(os.listdir(ref)), sorted(os.listdir(crash_dir))
                assert fa == fb, (f"{tag}: file sets differ after {attempts} "
                                  f"attempts")
                for name in fa:
                    with open(os.path.join(ref, name), "rb") as f:
                        a = f.read()
                    with open(os.path.join(crash_dir, name), "rb") as f:
                        b = f.read()
                    assert a == b, (f"{tag}: {name} differs after {attempts} "
                                    f"attempts")
                print(f"OK {tag} ({attempts} attempts; crashed at "
                      f"{', '.join(crashes) or 'none'})", flush=True)
            except Exception:
                print(f"FAIL {tag}", flush=True)
                raise
            finally:
                shutil.rmtree(base, ignore_errors=True)
    finally:
        restore()
    print(f"resume fuzz finished: {it} iterations, no failures", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
