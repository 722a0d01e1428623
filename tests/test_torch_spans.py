"""The port's spans and counters (utils/progress.span, count, span_totals,
timed_phase) on the CPU: nothing is recorded without a profiler; under one,
a build, a query and a cull session leave their names in the span table and
as `user_annotation` events in the Chrome trace; totals from many threads
add up exactly; the build's phase_times hold `total` and the split of
encode+write; torch_trace keeps the spans of worker threads."""

import contextlib
import json
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from point_cloud_viewer_tpu_torch.cli.build_octree import main as build_cli
from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
from point_cloud_viewer_tpu_torch.io.ply import write_ply
from point_cloud_viewer_tpu_torch.math.geometry import (
    Aabb, Frustum, Isometry, Perspective)
from point_cloud_viewer_tpu_torch.octree.builder import build_octree
from point_cloud_viewer_tpu_torch.octree.octree import Octree
from point_cloud_viewer_tpu_torch.ops.culling import DeviceCullSession
from point_cloud_viewer_tpu_torch.query.client import PointCloudClient
from point_cloud_viewer_tpu_torch.query.point_query import PointQuery
from point_cloud_viewer_tpu_torch.utils import progress

TOP_PHASES = ("read ply", "quantize+morton", "device core", "group levels",
              "encode+write")
SPLIT = ("encode+write/encode", "encode+write/wait", "encode+write/write")


@pytest.fixture
def table():
    progress.reset_span_totals()
    yield
    progress.reset_span_totals()


def _cloud(n: int, seed: int) -> PointsBatch:
    rng = np.random.default_rng(seed)
    return PointsBatch(
        position=rng.random((n, 3)) * 10.0,
        attributes={"color": rng.integers(0, 255, (n, 3), dtype=np.uint8),
                    "intensity": rng.random(n).astype(np.float32)})


@pytest.fixture(scope="module")
def octree_dir(tmp_path_factory):
    """A few nodes: 250,000 points over at most 100,000 a node."""
    out = str(tmp_path_factory.mktemp("spans") / "octree")
    build_octree(out, 0.001, _cloud(250_000, 3), device="cpu")
    return out


@contextlib.contextmanager
def _profiled(path):
    """A CPU profile of every thread, exported as a Chrome trace."""
    prof = profile(
        activities=[ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(path))


def _annotations(path) -> set:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events
            if isinstance(e, dict) and e.get("cat") == "user_annotation"}


def test_span_records_nothing_without_a_profiler(table, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    phases = {}
    with progress.span("a"):
        progress.count("b", 3)
    with progress.timed_phase(phases, "c"):
        pass
    assert progress.span_totals() == {}
    assert list(phases) == ["c"]


def _build(tmp_path, octree_dir):
    ply = str(tmp_path / "cloud.ply")
    write_ply(ply, _cloud(20_000, 1))
    assert build_cli([ply, "--output_directory", str(tmp_path / "out"),
                      "--device", "cpu"]) == 0
    names = {"build." + k for k in ("total", *TOP_PHASES, *SPLIT)}
    return names, names


def _query(tmp_path, octree_dir):
    client = PointCloudClient([Octree.from_directory(octree_dir)],
                              num_threads=3, device_filter=True, device="cpu")
    query = PointQuery(attributes=["color"],
                       location=Aabb([1.0, 1.0, 1.0], [7.0, 6.0, 9.0]))
    assert sum(len(b) for b in client.stream(query)) > 0
    names = {"query.select_nodes", "query.decode", "query.mask"}
    return names, names | {"query.nodes"}


def _select(tmp_path, octree_dir):
    octree = Octree.from_directory(octree_dir)
    session = DeviceCullSession(octree.cube_mins, octree.cube_edges,
                                octree.num_points, device="cpu")
    frusta = [Frustum.new(
        Isometry.from_axis_angle([0, 0, 1], 0.5 * i, translation=[5, 5, 30]),
        Perspective.from_fov(1.1, 0.9, 1.0, 60.0)) for i in range(4)]
    for f in frusta:
        session.step(f)
    session.step_frames(frusta)
    names = {"select.prep", "select.upload", "select.launch", "select.fetch"}
    assert all(progress.span_totals()[k][0] == 5 for k in names)
    return names, names


@pytest.mark.parametrize("path", [_build, _query, _select],
                         ids=["build", "query", "select"])
def test_paths_leave_their_spans_under_a_profiler(path, table, tmp_path,
                                                  octree_dir):
    trace = tmp_path / "trace.json"
    with _profiled(trace):
        in_trace, in_table = path(tmp_path, octree_dir)
    totals = progress.span_totals()
    assert in_table <= set(totals)
    assert all(totals[k][0] >= 1 for k in in_table)
    assert in_trace <= _annotations(trace)


def test_totals_from_eight_threads_add_up_exactly(table, monkeypatch):
    """Each thread's clock ticks by 1 a reading, so a span reads 1 s and a
    phase 3 s (its own two readings around the span's two): any lost
    update breaks the exact sums.  A reading yields the interpreter to
    another thread, as a real clock call may."""
    clock = threading.local()

    def perf_counter():
        time.sleep(0)
        clock.t = getattr(clock, "t", 0.0) + 1.0
        return clock.t

    monkeypatch.setattr(progress, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))
    phases, rounds = {}, 500

    def work():
        for _ in range(rounds):
            with progress.timed_phase(phases, "k"):
                progress.count("n", 2)
            with progress.span("s"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    n = 8 * rounds
    assert phases == {"k": 3.0 * n}
    assert progress.span_totals() == {"build.k": [n, 1.0 * n], "s": [n, 1.0 * n],
                                      "n": [2 * n, 0.0]}


def test_cli_build_phase_times_hold_total_and_the_split_of_encode_write(
        tmp_path):
    ply = str(tmp_path / "cloud.ply")
    write_ply(ply, _cloud(150_000, 2))
    phases = {}
    assert build_cli([ply, "--output_directory", str(tmp_path / "out"),
                      "--device", "cpu"], phase_times=phases) == 0
    assert set(phases) == {"total", *TOP_PHASES, *SPLIT}
    assert phases["total"] >= sum(phases[k] for k in TOP_PHASES)
    encode_write = phases["encode+write"]
    assert phases["encode+write/encode"] + phases["encode+write/wait"] \
        <= encode_write
    assert phases["encode+write/write"] > 0


def test_torch_trace_records_spans_of_worker_threads(tmp_path, table):
    def work():
        with progress.span("worker.span"):
            torch.ones(4).sum()

    with progress.torch_trace(str(tmp_path)):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        with progress.span("main.span"):
            pass
    assert not t.is_alive()
    (trace,) = list(tmp_path.glob("trace.*.json"))
    assert {"worker.span", "main.span"} <= _annotations(trace)
    assert progress.span_totals()["worker.span"][0] == 1
