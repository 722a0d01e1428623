"""The reference build on edge cases, against the program's CPU route."""

import contextlib
import io

import numpy as np

import harness
from reference import octree as ref_octree


def test_a_node_emptied_by_promotion_stays_in_the_tree(tmp_path):
    # Octant 0 holds 100,001 points and splits; octant 7 holds one point,
    # a leaf whose only point moves to the root: the leaf keeps no point,
    # has no files, and meta.pb still lists it.
    rng = np.random.default_rng(3)
    pos = np.concatenate([rng.random((100_001, 3)) * 0.4,
                          [[1.0, 1.0, 1.0]]])
    n = len(pos)
    cloud = {"position": pos,
             "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
             "intensity": rng.random(n, dtype=np.float32)}
    ref = ref_octree.build(pos, cloud["color"], cloud["intensity"], 0.001,
                           100_000)
    empty = [(int(lv), int(pa)) for lv, pa, c in
             zip(ref.levels, ref.paths, ref.counts) if c == 0]
    assert (1, 7) in empty
    assert "r7.xyz" not in ref.files and "r7.rgb" not in ref.files

    build = harness.load_module("traffic", "build")
    ply = str(tmp_path / "cloud.ply")
    build.write_ply(ply, cloud)
    from point_cloud_viewer_tpu_torch.cli import build_octree

    out = str(tmp_path / "octree")
    with contextlib.redirect_stdout(io.StringIO()):
        assert build_octree.main([ply, "--output_directory", out,
                                  "--resolution", "0.001",
                                  "--device", "cpu"]) == 0
    got = ref_octree.compare_files(ref.files, ref_octree.read_directory(out))
    assert got == {"files_differ": 0, "files_missing": 0, "files_extra": 0,
                   "bytes_differ": 0}


def test_float32_reference_differs_from_float64():
    cfg = dict(harness.config("tls_scan_16m"), num_points=50_000)
    c = harness.load_module("generators", "tls_scan").generate(cfg, 9)
    import torch

    hi = ref_octree.build(c["position"], c["color"], c["intensity"], 0.001,
                          100_000)
    lo = ref_octree.build(c["position"], c["color"], c["intensity"], 0.001,
                          100_000, dtype=torch.float32)
    assert ref_octree.compare_files(hi.files, lo.files)["files_differ"] > 0
