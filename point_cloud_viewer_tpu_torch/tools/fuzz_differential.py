"""Differential fuzz of the port: random clouds -> in-core vs streamed vs
mesh builds byte for byte; random AABB and OBB queries against brute force
within the quantization envelope, and frustum queries exactly on the
decoded points (index-in-color).  Twin of the JAX package's
tools/fuzz_differential.py, with the same generators, checks and final
line.

Usage: python -m point_cloud_viewer_tpu_torch.tools.fuzz_differential \
           [seconds] [--device cuda|cpu]
(FUZZ_SEED=n varies the run, FUZZ_MAX_ITERS=n bounds it, FUZZ_NO_MESH=1
skips the mesh builds.)

Builds, streams and queries run on --device (cuda by default; without a
card that raises).  The mesh is make_mesh(devices=[dev] * nd) on a card
(nd shards sharing it) or make_mesh(nd, device="cpu").  One addition to the
original: each iteration also builds the host route (use_device=False) and
holds it byte-equal to the in-core build.

Campaign results of the port are recorded in PERF.md.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

STYLES = ["uniform", "clustered", "collinear", "same_point", "plane"]


def synth(rng, n, style):
    if n == 0:
        return np.zeros((0, 3))
    if style == "uniform":
        return rng.random((n, 3)) * rng.uniform(0.5, 500)
    if style == "clustered":
        k = max(1, min(10, n // 10))
        centers = rng.random((k, 3)) * 100
        idx = rng.integers(0, k, n)
        return centers[idx] + rng.normal(0, rng.uniform(0.001, 2.0), (n, 3))
    if style == "collinear":
        t = rng.random(n)
        return np.outer(t, rng.random(3) * 50) + rng.random(3)
    if style == "same_point":
        return np.tile(rng.random(3) * 10, (n, 1))
    if style == "plane":
        p = rng.random((n, 3)) * 40
        p[:, rng.integers(0, 3)] = rng.random() * 40
        return p
    raise AssertionError(style)


def attrs(rng, n, which):
    a = {}
    if "color" in which:
        a["color"] = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    if "intensity" in which:
        a["intensity"] = rng.random(n).astype(np.float32)
    if "ts" in which:
        a["ts"] = rng.random(n) * 1e6
    return a


def same_dir(a, b, tag):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb, f"{tag}: file sets differ {len(fa)} vs {len(fb)}"
    for name in fa:
        with open(os.path.join(a, name), "rb") as f:
            da = f.read()
        with open(os.path.join(b, name), "rb") as f:
            db = f.read()
        if da != db:
            raise AssertionError(f"{tag}: {name} bytes differ")


def _indices(batch):
    c = batch.attributes["color"].astype(np.uint32)
    return (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]


def _streamed(client, query):
    got = [_indices(bt) for bt in client.stream(query)]
    return np.sort(np.concatenate(got)) if got else np.empty(0, np.uint32)


def parse_args(argv, description):
    """[seconds] [--device cuda|cpu] -> (deadline, torch device)."""
    from ..device import resolve_device

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("seconds", nargs="?", type=float, default=600.0)
    parser.add_argument("--device", default="cuda",
                        help="PyTorch device of the builds and queries: "
                             "cuda (default) or cpu.")
    args = parser.parse_args(argv)
    return time.time() + args.seconds, resolve_device(args.device)


def main(argv=None) -> int:
    from ..core.points_batch import PointsBatch
    from ..math.geometry import Aabb, Frustum, Isometry, Obb, Perspective
    from ..octree.builder import build_octree
    from ..octree.streaming import build_octree_streaming
    from ..parallel.mesh import make_mesh
    from ..query.client import PointCloudClient
    from ..query.location import GeometryLocation
    from ..query.point_query import PointQuery

    deadline, dev = parse_args(argv, __doc__)
    max_iters = int(os.environ.get("FUZZ_MAX_ITERS", 10**9))
    no_mesh = os.environ.get("FUZZ_NO_MESH", "") == "1"
    rng_master = np.random.default_rng(int(os.environ.get("FUZZ_SEED", 0)))

    def client(qdir):
        return PointCloudClient.from_locations([qdir], batch_size=7919,
                                               device=dev)

    it = 0
    while time.time() < deadline and it < max_iters:
        it += 1
        seed = int(rng_master.integers(0, 2**31))
        rng = np.random.default_rng(seed)
        n = int(rng.choice([0, 1, 2, 7, 103, 5_001, 60_000]))
        style = STYLES[int(rng.integers(0, len(STYLES)))]
        opts = [["color"], ["color", "intensity"], ["intensity", "ts"], []]
        which = ["color"] if n == 0 else opts[int(rng.integers(0, len(opts)))]
        pos = synth(rng, n, style)
        res = float(rng.choice([0.001, 0.01, 0.3, 5.0]))
        if n and rng.random() < 0.15 and style in ("clustered", "same_point"):
            res = float(np.max(pos.max(axis=0) - pos.min(axis=0)) + 1e-6) / 2**26
        bl = int(rng.choice([1, 2, 3]))
        batch = PointsBatch(position=pos, attributes=attrs(rng, n, which))
        base = tempfile.mkdtemp(prefix="fuzz_")
        tag = (f"it{it} seed={seed} n={n} {style} res={res} bl={bl} "
               f"attrs={which} device={dev}")
        mem = os.path.join(base, "mem")
        try:
            build_octree(mem, res, batch, device=dev)
            build_octree(os.path.join(base, "host"), res, batch,
                         use_device=False)
            same_dir(mem, os.path.join(base, "host"), tag + " [host route]")
            nb = max(1, int(rng.integers(1, 6)))
            cuts = np.sort(rng.integers(0, n + 1, nb - 1)) if n else []
            parts = np.split(np.arange(n), cuts) if n else [np.arange(0)]
            batches = [batch.slice(int(p[0]), int(p[-1]) + 1) if len(p) else
                       PointsBatch(position=np.zeros((0, 3)),
                                   attributes=attrs(rng, 0, which))
                       for p in parts]
            build_octree_streaming(
                os.path.join(base, "stream"), res, batches,
                bounding_box=Aabb.bounding_points(pos) if n else None,
                bucket_levels=bl, spill_directory=os.path.join(base, "spill"),
                device=dev,
            )
            same_dir(mem, os.path.join(base, "stream"), tag + " [stream]")
            if n > 0 and not no_mesh and rng.random() < 0.5:
                nd = int(rng.choice([2, 3, 5, 8]))
                mesh = (make_mesh(devices=[dev] * nd) if dev.type == "cuda"
                        else make_mesh(nd, device="cpu"))
                build_octree(os.path.join(base, "mesh"), res, batch, mesh=mesh)
                same_dir(mem, os.path.join(base, "mesh"), tag + f" [mesh{nd}]")

            # query differential (only when color carries the index)
            if n > 0 and "color" in which and n <= 60_000:
                idxc = np.arange(n, dtype=np.uint32)
                icolor = np.stack([(idxc >> 16) & 0xFF, (idxc >> 8) & 0xFF,
                                   idxc & 0xFF], axis=1).astype(np.uint8)
                qb = PointsBatch(position=pos, attributes={"color": icolor})
                qdir = os.path.join(base, "q")
                build_octree(qdir, res, qb, device=dev)
                lo = pos.min(axis=0)
                hi = pos.max(axis=0)
                span = np.maximum(hi - lo, 1e-9)
                a = lo + rng.random(3) * span * 0.8
                b = a + rng.random(3) * span * 0.5 + 1e-9
                box = Aabb(a, b)
                expected = np.nonzero(box.contains(pos))[0]
                got = _streamed(client(qdir), PointQuery(
                    attributes=["color"], location=GeometryLocation(box)))
                # quantization envelope: points within sqrt(3)*res of the
                # boundary may flip (box)
                sym = (np.setdiff1d(got, expected).size
                       + np.setdiff1d(expected, got).size)
                if sym:
                    flip = np.union1d(np.setdiff1d(got, expected),
                                      np.setdiff1d(expected, got)).astype(int)
                    d = np.maximum(np.maximum(a - pos[flip], pos[flip] - b)
                                   .max(axis=1), 0)
                    # decoded position error bound
                    assert (np.abs(d) <= np.sqrt(3) * res + 1e-12).all(), (
                        f"{tag}: query flips beyond quantization envelope: "
                        f"{d.max()}")
            if n > 0 and "color" in which and n <= 60_000 and rng.random() < 0.5:
                # OBB differential on the same index cloud
                center = lo + rng.random(3) * span
                half = rng.random(3) * span * 0.4 + 1e-6
                axis = rng.normal(size=3)
                axis /= np.linalg.norm(axis)
                iso = Isometry.from_axis_angle(axis, rng.random() * 3.0,
                                               translation=center)
                obb = Obb(iso, half)
                expected = np.nonzero(obb.contains(pos))[0]
                got = _streamed(client(qdir), PointQuery(
                    attributes=["color"], location=GeometryLocation(obb)))
                flips = np.union1d(np.setdiff1d(got, expected),
                                   np.setdiff1d(expected, got)).astype(int)
                if len(flips):
                    local = np.abs(obb.obb_from_query.transform_points(
                        pos[flips]))
                    d = np.max(local - half, axis=1)
                    assert ((d <= np.sqrt(3) * res + 1e-9).all()
                            and (d >= -np.sqrt(3) * res - 1e-9).all()), (
                        f"{tag}: OBB flips beyond envelope: {d.min()} "
                        f"{d.max()}")
            if n > 0 and "color" in which and n <= 60_000 and rng.random() < 0.5:
                # Frustum differential: eye outside the cloud looking at a
                # random interior target.
                eye_pos = lo + (rng.random(3) - 0.5) * span * 4.0
                look = lo + rng.random(3) * span
                fwd = look - eye_pos
                if np.linalg.norm(fwd) > 1e-9:
                    fwd /= np.linalg.norm(fwd)
                    zax = np.array([0.0, 0.0, 1.0])
                    axis = np.cross(zax, -fwd)  # camera looks down -z
                    s_ = np.linalg.norm(axis)
                    ang = float(np.arctan2(s_, np.dot(zax, -fwd)))
                    iso = Isometry.from_axis_angle(
                        axis / s_ if s_ > 1e-12 else zax, ang,
                        translation=eye_pos)
                    far = max(float(np.linalg.norm(span) * 6), 1.0)
                    fr = Frustum.new(iso, Perspective.from_fov(
                        float(rng.uniform(0.4, 1.6)),
                        float(rng.uniform(0.6, 1.5)), 0.1, far))
                    # Ground truth on the DECODED positions -- exactly what
                    # the engine filters -- so the comparison is EXACT, no
                    # envelope.
                    qc = client(qdir)
                    decoded = np.empty((n, 3))
                    for bt in qc.stream(PointQuery(attributes=["color"])):
                        decoded[_indices(bt)] = bt.position
                    expected = np.nonzero(fr.contains(decoded))[0]
                    got = _streamed(qc, PointQuery(
                        attributes=["color"], location=GeometryLocation(fr)))
                    assert np.array_equal(got, expected), (
                        f"{tag}: frustum query != frustum test on decoded "
                        f"points")
            print(f"OK {tag}", flush=True)
        except Exception:
            print(f"FAIL {tag}", flush=True)
            raise
        finally:
            shutil.rmtree(base, ignore_errors=True)
    print(f"fuzz finished: {it} iterations, no failures", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
