"""The reader of `query.fused_share`: the program's counters
"query.mask.fused" and "query.mask.eager" as the program fills them under a
profiler; a program without the table or the counters reads as nothing."""

import sys
import types

import pytest
from torch.profiler import ProfilerActivity, profile

import harness


@pytest.fixture
def program_table():
    """The program's span table, emptied before and after the test."""
    from point_cloud_viewer_tpu_torch.utils import progress

    progress.reset_span_totals()
    yield progress
    progress.reset_span_totals()


def test_fused_share_is_the_fused_nodes_over_all_masked(program_table):
    read = harness.layer_reader("query.fused_share")
    with profile(activities=[ProfilerActivity.CPU]):
        assert read({}) is None
        for _ in range(3):
            program_table.count("query.mask.fused", 1)
        assert read({}) == 1.0
        program_table.count("query.mask.eager", 1)
    assert read({}) == 0.75
    program_table.reset_span_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        program_table.count("query.mask.eager", 2)
    assert read({}) == 0.0


def test_fused_share_reads_nothing_without_the_counters(program_table):
    with profile(activities=[ProfilerActivity.CPU]):
        program_table.count("query.nodes", 4)
    assert harness.layer_reader("query.fused_share")({}) is None


def test_fused_share_reads_nothing_from_a_program_without_the_table(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "point_cloud_viewer_tpu_torch.utils.progress",
                        types.ModuleType("progress"))
    assert harness.layer_reader("query.fused_share")({}) is None
