"""The streamed-build cell (`tls_scan_16m.streamed`, traffic kind
`build_streamed`) end to end at a small size on the program's CPU route,
judged against the plain reference; its control and three faults planted
under the timed path come out as not correct; its per-layer readers read
known contexts, and nothing where the program has no such phase or
counter.  The same cell on the card at full size, untraced and traced,
is the `cuda` tests."""

import argparse
import os
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import harness
import run

CELL = "tls_scan_16m.streamed"
SEED = 2**31 + 2525
SMALL = 250_000


def _small(layout):
    """The cell at 250,000 points.  At that size the scan's 64 clusters
    leave every level-2 bucket under the node cap, so the top takes every
    bucket whole; "one cluster" puts the clustered half in one, so one
    bucket is derived and written as a subtree, as the full-size cell's
    ~16 buckets are."""
    cell = harness.cell(CELL)
    cfg = dict(harness.config(cell["config"]), num_points=SMALL)
    if layout == "one cluster":
        cfg["generator_params"] = dict(cfg["generator_params"], clusters=1)
    return cell, cfg


def _run(layout="one cluster", seconds=1.0, control=0):
    torch.set_num_threads(4)
    cell, cfg = _small(layout)
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=seconds,
                              trace=0, control=control)
    return run.run(args, device="cpu", t_start=time.perf_counter(),
                   cell_override=cell, config_override=cfg)


@pytest.mark.parametrize("layout", ["the scan's", "one cluster"])
def test_cell_is_correct_on_the_cpu_route(layout):
    r = _run(layout, seconds=1.5)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"setup_s", "build_mpts_s"}


def test_control_is_not_correct():
    r = _run(seconds=0.5, control=1)
    assert not r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


def test_the_deployment_builds_the_tls_scan_out_of_core():
    """The cell's configuration is a deployment of its own (source, route
    settings) over `tls_scan_16m`'s data: the same numbers and cut, and
    the same points from the same seed."""
    own = harness.config(harness.cell(CELL)["config"])
    scan = harness.config("tls_scan_16m")
    for key in ("generator", "num_points", "resolution",
                "max_points_per_node", "record", "generator_params",
                "reduced"):
        assert own[key] == scan[key], key
    assert own["source"] != scan["source"] and own["bucket_levels"] == 2
    gen = harness.load_module("generators", own["generator"]).generate
    a = gen(dict(own, num_points=20_000), SEED)
    b = gen(dict(scan, num_points=20_000), SEED)
    assert set(a) == set(b)
    for key in a:
        assert np.array_equal(a[key], b[key]), key


def _fault_bucket_dropped(monkeypatch):
    """The first non-empty bucket of each build loads back empty."""
    from point_cloud_viewer_tpu_torch.octree import streaming

    load = streaming._BucketSpill.load

    def dropped(self, bucket):
        batch = load(self, bucket)
        if batch is not None and bucket == np.flatnonzero(self.counts)[0]:
            batch = batch.take(np.arange(0))
        return batch

    monkeypatch.setattr(streaming._BucketSpill, "load", dropped)


def _fault_subtree_byte(monkeypatch):
    """A byte altered in each node file below the bucket level (level 2)."""
    from point_cloud_viewer_tpu_torch.octree import builder

    write = builder.write_node_files

    def altered(stem, encoded, attributes):
        if len(os.path.basename(stem)) > 3:
            encoded = encoded.copy()
            encoded.reshape(-1).view(np.uint8)[0] ^= 1
        return write(stem, encoded, attributes)

    monkeypatch.setattr(builder, "write_node_files", altered)


def _fault_residual_dropped(monkeypatch):
    """The residual of each build's first derived bucket never reaches the
    top."""
    from point_cloud_viewer_tpu_torch.octree import streaming

    finish = streaming._finish_device_bucket
    seen = set()

    def dropped(output_directory, *args, **kwargs):
        residual, nodes = finish(output_directory, *args, **kwargs)
        if output_directory not in seen:
            seen.add(output_directory)
            residual = residual.take(np.arange(0))
        return residual, nodes

    monkeypatch.setattr(streaming, "_finish_device_bucket", dropped)


FAULTS = {"one bucket's points dropped at the spill's load":
              _fault_bucket_dropped,
          "a byte altered in a bucket subtree's node file":
              _fault_subtree_byte,
          "the top's residuals of one bucket dropped":
              _fault_residual_dropped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = _run()
    assert r["failed"] == 0
    assert not r["correct"], r["checks"]


PHASES = {"build.bounds_s": "bounds", "build.spill_s": "spill",
          "build.bucket_load_s": "bucket_load",
          "build.bucket_write_s": "bucket_encode_write",
          "build.top_s": "top",
          "build.bucket_device_busy_s": "bucket_device_busy"}


@pytest.mark.parametrize("metric", sorted(PHASES))
def test_phase_reader_gives_the_mean_a_build(metric):
    read = harness.layer_reader(metric)
    key = PHASES[metric]
    assert read({"phases": [{key: 1.0, "total": 9.0}, {key: 2.5},
                            {"read ply": 1.0}]}) == 1.75
    assert read({"phases": [{"total": 3.0}]}) is None
    assert read({}) is None


def test_unhidden_share_is_the_wait_over_the_busy_time():
    read = harness.layer_reader("build.bucket_unhidden_share")
    assert read({"phases": [
        {"bucket_device_wait": 0.1, "bucket_device_busy": 1.0},
        {"bucket_device_wait": 0.0, "bucket_device_busy": 1.0},
        {"total": 3.0}]}) == pytest.approx(5.0)
    assert read({"phases": [{"bucket_device_wait": 0.0,
                             "bucket_device_busy": 0.0}]}) is None
    assert read({"phases": [{"total": 3.0}]}) is None
    assert read({}) is None


BUCKET_ROOFLINES = {"build.bucket_k6_roofline": (
                        ("leaf_bounds", "leaf_carry_scan", "leaf_assign"), 10),
                    "build.bucket_k4_roofline": (("promote_levels",), 3)}


@pytest.mark.parametrize("metric", sorted(BUCKET_ROOFLINES))
def test_bucket_roofline_takes_a_launch_as_one_bucket(metric):
    from measure import PEAK_BYTES_PER_S

    read = harness.layer_reader(metric)
    kernels, per_point = BUCKET_ROOFLINES[metric]
    trace = {"kernels": {k: [32, 32 * 10e-6] for k in kernels}}
    # Two traced builds of 16 buckets of 1M points; the third was not
    # traced and its buckets are not counted.
    phases = [{"buckets_derived": 16, "bucket_upload_bytes": 128e6}] * 2 + [
        {"buckets_derived": 1, "bucket_upload_bytes": 8.0}]
    got = read({"trace": trace, "phases": phases, "traced_units": 2})
    least = per_point * 1e6 / PEAK_BYTES_PER_S
    assert got == pytest.approx(100 * least / (len(kernels) * 10e-6))
    assert read({"trace": trace, "phases": [{"total": 1.0}],
                 "traced_units": 1}) is None
    assert read({"trace": {"kernels": {}}, "phases": phases,
                 "traced_units": 2}) is None


@pytest.fixture
def program_table():
    from point_cloud_viewer_tpu_torch.utils import progress

    progress.reset_span_totals()
    yield progress
    progress.reset_span_totals()


def test_points_per_bucket_reads_the_program_counters(program_table):
    read = harness.layer_reader("build.points_per_bucket")
    assert read({"traced_units": 2}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        for n in (1_000_000, 3_000_000):
            program_table.count("build.buckets", 2)
            program_table.count("build.bucket_points", n)
    assert read({"traced_units": 2}) == 1_000_000.0
    program_table.reset_span_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        program_table.count("build.bucket_points", 5)
    assert read({"traced_units": 1}) is None


def test_spill_rate_reads_the_spill_counter(program_table):
    read = harness.layer_reader("build.spill_mb_s")
    phases = [{"spill": 1.5}, {"spill": 2.5}, {"spill": 9.0}]
    assert read({"phases": phases, "traced_units": 2}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        program_table.count("build.spill_bytes", 496_000_000)
        program_table.count("build.spill_bytes", 496_000_000)
    assert read({"phases": phases, "traced_units": 2}) == pytest.approx(248.0)
    assert read({"phases": [{"total": 1.0}], "traced_units": 1}) is None


@pytest.mark.parametrize("metric", ["build.points_per_bucket",
                                    "build.spill_mb_s"])
def test_counter_reader_reads_nothing_from_a_program_without_the_table(
        metric, monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "point_cloud_viewer_tpu_torch.utils.progress",
                        types.ModuleType("progress"))
    assert harness.layer_reader(metric)(
        {"traced_units": 3, "phases": [{"spill": 1.0}] * 3}) is None


@pytest.mark.cuda
def test_cell_is_correct_on_the_card(card):
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=20,
                              trace=0, control=0)
    r = run.run(args, t_start=time.perf_counter())
    print(r["metrics"], r["checks"])
    assert r["correct"], r["checks"]


@pytest.mark.cuda
def test_traced_run_reports_the_streamed_metrics_on_the_card(
        card, program_table):
    cell = harness.cell(CELL)
    args = argparse.Namespace(workload=CELL, seed=SEED + 1, seconds=20,
                              trace=1, control=0)
    r = run.run(args, t_start=time.perf_counter())
    assert r["correct"], r["checks"]
    names = {m["name"] for m in cell["per_layer"]}
    assert {*PHASES, *BUCKET_ROOFLINES, "build.points_per_bucket",
            "build.bucket_unhidden_share", "build.spill_mb_s",
            "build.encode_s", "build.write_wait_s", "build.write_thread_s",
            "idle_share.build"} == names
    assert names <= set(r["metrics"])
    totals = program_table.span_totals()
    points = harness.config(cell["config"])["num_points"]
    assert totals["build.bucket_points"][0] == points * r["samples"]
    per_bucket = r["metrics"]["build.points_per_bucket"]["value"]
    assert per_bucket * totals["build.buckets"][0] == pytest.approx(
        points * r["samples"])
