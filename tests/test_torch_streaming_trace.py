"""The PyTorch port's out-of-core build (`cli/build_octree.py --streaming`)
traced: the phases its `phase_times` records (`bounds`, PASS 1, and the
write pool's `encode+write/encode`, `/wait` and `/write` of every bucket
and of the top), its spans, and the counters `build.buckets`,
`build.bucket_points` and `build.spill_bytes` against what the spill held.
The traced build stays byte-equal to the port's in-core build and to the
JAX package's streaming build, on the CPU."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from point_cloud_viewer_tpu.cli.build_octree import main as jax_cli
from point_cloud_viewer_tpu_torch.cli.build_octree import main as cli_main
from point_cloud_viewer_tpu_torch.octree import streaming as PS
from point_cloud_viewer_tpu_torch.utils import progress
from tests.conftest import assert_dirs_byte_equal

RESOLUTION = 0.001
N_CLUSTER, N_UNIFORM = 140_000, 20_000
# The PLY's record as spilled: x y z f64, red green blue u8, intensity f32.
RECORD_BYTES = 3 * 8 + 3 + 4
WRITE_KEYS = ("encode+write/encode", "encode+write/wait",
              "encode+write/write")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """A PLY of a dense cluster past MAX_POINTS_PER_NODE in one level-2
    cell (a bucket subtree at bucket_levels 1 and 2) among uniform points
    (buckets handed whole to the top), and its in-core build."""
    root = tmp_path_factory.mktemp("scan")
    rng = np.random.default_rng(25)
    position = np.concatenate([
        rng.random((N_UNIFORM, 3)) * [40.0, 40.0, 8.0],
        [6.0, 6.0, 2.0] + rng.normal(0.0, 0.2, (N_CLUSTER, 3)),
    ])
    n = len(position)
    rows = np.empty(n, dtype=[("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
                              ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                              ("intensity", "<f4")])
    rows["x"], rows["y"], rows["z"] = position.T
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    rows["red"], rows["green"], rows["blue"] = rgb.T
    rows["intensity"] = rng.random(n, dtype=np.float32)
    ply = str(root / "scan.ply")
    with open(ply, "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {n}\n"
                 "property double x\nproperty double y\nproperty double z\n"
                 "property uchar red\nproperty uchar green\n"
                 "property uchar blue\nproperty float intensity\n"
                 "end_header\n").encode("ascii"))
        rows.tofile(f)
    incore = str(root / "incore")
    assert cli_main([ply, "--output_directory", incore, "--device", "cpu",
                     "--resolution", repr(RESOLUTION)]) == 0
    return {"ply": ply, "n": n, "incore": incore}


@pytest.fixture
def spills(monkeypatch):
    """Every _BucketSpill a build makes, kept for its counts."""
    made = []
    real = PS._BucketSpill

    class Kept(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(PS, "_BucketSpill", Kept)
    return made


def _streamed(scan, out, bucket_levels, spill, phases):
    argv = [scan["ply"], "--output_directory", out, "--device", "cpu",
            "--resolution", repr(RESOLUTION), "--streaming",
            "--bucket_levels", str(bucket_levels)]
    if spill is not None:
        argv += ["--spill_directory", spill]
    assert cli_main(argv, phase_times=phases) == 0


@pytest.mark.parametrize("bucket_levels", [1, 2])
@pytest.mark.parametrize("with_spill_directory", [False, True])
def test_traced_streamed_build_records_phases_and_counts_its_spill(
        tmp_path, scan, spills, bucket_levels, with_spill_directory):
    out = str(tmp_path / "port")
    spill = str(tmp_path / "spill") if with_spill_directory else None
    phases: dict = {}
    progress.reset_span_totals()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _streamed(scan, out, bucket_levels, spill, phases)
        totals = progress.span_totals()
        traced = {e.key for e in prof.key_averages()}
    finally:
        progress.reset_span_totals()

    assert {"bounds", "spill", "bucket_load", "bucket_encode_write", "top",
            *WRITE_KEYS} <= set(phases)
    assert all(phases[k] > 0 for k in ("bounds", *WRITE_KEYS))
    for name in ("build.bounds", *("build." + k for k in WRITE_KEYS)):
        assert totals[name][0] >= 1 and totals[name][1] > 0, name
    # The pool's writes run on its threads; the caller's spans are traced.
    assert {"build.bounds", "build.encode+write/encode",
            "build.encode+write/wait"} <= traced

    (spill_of_build,) = spills
    nonempty = int(np.count_nonzero(spill_of_build.counts))
    assert nonempty > 1 and phases["buckets_derived"] >= 1
    assert totals["build.buckets"] == [nonempty, 0.0]
    assert totals["build.bucket_points"] == [scan["n"], 0.0]
    assert totals["build.spill_bytes"] == [scan["n"] * RECORD_BYTES, 0.0]

    ref = str(tmp_path / "jax")
    assert jax_cli([scan["ply"], "--output_directory", ref, "--resolution",
                    repr(RESOLUTION), "--streaming", "--bucket_levels",
                    str(bucket_levels)]) == 0
    assert_dirs_byte_equal(scan["incore"], out,
                           context="traced streamed vs in-core")
    assert_dirs_byte_equal(ref, out, context="traced streamed vs JAX")


def test_untraced_streamed_build_counts_nothing(tmp_path, scan):
    progress.reset_span_totals()
    phases: dict = {}
    _streamed(scan, str(tmp_path / "port"), 2, None, phases)
    assert "bounds" in phases and "encode+write/write" in phases
    assert not any(name.startswith("build.")
                   for name in progress.span_totals())
