"""The reader of `query.card_decode_share`: the program's counters
"query.decode.card" and "query.decode.host" as the program fills them under
a profiler; a program without the table or the counters reads as
nothing."""

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


def test_card_decode_share_is_the_card_nodes_over_all(program_table):
    read = harness.layer_reader("query.card_decode_share")
    with profile(activities=[ProfilerActivity.CPU]):
        assert read({}) is None
        program_table.count("query.decode.card", 3)
        assert read({}) == 1.0
        program_table.count("query.decode.host", 1)
    assert read({}) == 0.75
    program_table.reset_span_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        program_table.count("query.decode.host", 2)
    assert read({}) == 0.0


def test_card_decode_share_reads_nothing_without_the_counters(program_table):
    with profile(activities=[ProfilerActivity.CPU]):
        program_table.count("query.nodes", 4)
        program_table.count("query.mask.fused", 4)
    assert harness.layer_reader("query.card_decode_share")({}) is None


def test_card_decode_share_reads_nothing_from_a_program_without_the_table(
        monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "point_cloud_viewer_tpu_torch.utils.progress",
                        types.ModuleType("progress"))
    assert harness.layer_reader("query.card_decode_share")({}) is None
