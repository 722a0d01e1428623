"""The readers of the program's own timings on the CPU: the build's
phase_times keys (`build.encode_s`, `build.write_wait_s`,
`build.write_thread_s`, `build.unphased_s`) from hand-made contexts, and the
span table (`query.*`, `select.*`) as the program fills it under a
profiler; a program without the keys or the table reads as nothing."""

import sys
import threading
import types

import pytest
from torch.profiler import ProfilerActivity, profile

import harness

TOP = ("read ply", "quantize+morton", "device core", "group levels",
       "encode+write")
SPANS = {"query.select_nodes_ms": "query.select_nodes",
         "query.decode_ms": "query.decode", "query.mask_ms": "query.mask",
         "select.prep_ms": "select.prep", "select.upload_ms": "select.upload",
         "select.launch_ms": "select.launch", "select.fetch_ms": "select.fetch"}


@pytest.mark.parametrize("metric,key", [
    ("build.encode_s", "encode+write/encode"),
    ("build.write_wait_s", "encode+write/wait"),
    ("build.write_thread_s", "encode+write/write")])
def test_phase_readers_give_the_mean_a_build(metric, key):
    read = harness.layer_reader(metric)
    assert read({"phases": [{key: 1.0, "encode+write": 9.0}, {key: 2.5},
                            {"read ply": 1.0}]}) == 1.75
    assert read({"phases": [{"encode+write": 3.0}]}) is None
    assert read({}) is None


def test_unphased_is_total_less_the_five_top_level_phases():
    read = harness.layer_reader("build.unphased_s")
    first = dict({k: 0.5 for k in TOP}, total=10.0)
    first.update({"encode+write/encode": 2.0, "encode+write/write": 8.0})
    second = {"total": 6.0, "read ply": 1.0, "encode+write": 2.0}
    assert read({"phases": [first, second]}) == (7.5 + 3.0) / 2
    assert read({"phases": [{k: 1.0 for k in TOP}]}) is None


@pytest.fixture
def program_table(monkeypatch):
    """The program's span table with a clock that ticks 1 s a reading in
    each thread, so a span reads exactly 1 s."""
    from point_cloud_viewer_tpu_torch.utils import progress

    clock = threading.local()

    def perf_counter():
        clock.t = getattr(clock, "t", 0.0) + 1.0
        return clock.t

    monkeypatch.setattr(progress, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))
    progress.reset_span_totals()
    yield progress
    progress.reset_span_totals()


def test_span_readers_divide_the_program_table_by_the_traced_units(
        program_table):
    with profile(activities=[ProfilerActivity.CPU]):
        for name in SPANS.values():
            for _ in range(3):
                with program_table.span(name):
                    pass
        program_table.count("query.nodes", 7)
        program_table.count("query.nodes", 5)
    for metric in SPANS:
        assert harness.layer_reader(metric)({"traced_units": 2}) == 1500.0
    nodes = harness.layer_reader("query.nodes_per_query")
    assert nodes({"traced_units": 4}) == 3.0
    assert nodes({"traced_units": 0}) is None
    program_table.reset_span_totals()
    assert all(harness.layer_reader(m)({"traced_units": 2}) is None
               for m in (*SPANS, "query.nodes_per_query"))


def test_span_readers_read_nothing_from_a_program_without_the_table(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "point_cloud_viewer_tpu_torch.utils.progress",
                        types.ModuleType("progress"))
    for metric in (*SPANS, "query.nodes_per_query"):
        assert harness.layer_reader(metric)({"traced_units": 5}) is None
