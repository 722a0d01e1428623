"""The `flyover` traffic kind and its readers on the CPU route, at a small
size of `city_1m_nodes`: the cell comes out correct, its control (the
reference in f32 in the ECEF frame) and faults planted under the timed
path (nodes dropped at the cap, nodes at the cap swapped at the same
length for nodes just past the tie at the cap, the table shifted by
0.5 m) do not; the tie at the cap excuses a swap across it within its
width and nothing else;
the readers of the capped path's span and counters read nothing where the
program has none.  The same runs on the card, at full size, are the `cuda`
tests."""

import argparse
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import harness
import run

WORKLOAD = "city_1m_nodes.select"
SAMPLE = 300_000  # about 15k nodes
SEED = 2**31 + 2027
READERS = {"select.ids_ms": "select.ids",
           "select.visible_per_frame": "select.visible",
           "select.fetch_kb_per_frame": "select.fetch_bytes"}


def _small():
    """The cell at SAMPLE sample points, standing for as many fewer points
    (the same leaf threshold), with a cap of 800 over 12 frames."""
    cell = harness.cell(WORKLOAD)
    cell["params"] = dict(cell["params"], node_cap=800, frames=12,
                          compare_frames=4)
    cfg = harness.config(cell["config"])
    g = cfg["generator_params"]
    cfg = dict(cfg, num_points=cfg["num_points"] * SAMPLE // g["sample_points"],
               generator_params=dict(g, sample_points=SAMPLE))
    return cell, cfg


def _run(seconds=1.0, control=0):
    torch.set_num_threads(4)
    cell, cfg = _small()
    args = argparse.Namespace(workload=WORKLOAD, seed=SEED, seconds=seconds,
                              trace=0, control=control)
    return run.run(args, device="cpu", t_start=time.perf_counter(),
                   cell_override=cell, config_override=cfg)


def test_cell_is_correct_on_the_cpu_route():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "select_ms_p95"}


def test_control_is_not_correct():
    r = _run(seconds=0.5, control=1)
    assert not r["correct"], r["checks"]


def _fault_dropped_at_the_cap(monkeypatch):
    """The capped step leaves out the last 2% of its list."""
    from point_cloud_viewer_tpu_torch.ops import culling

    step = culling.DeviceCullSession.step_capped

    def drop(self, frustum, cap):
        order, sizes, seen = step(self, frustum, cap)
        keep = len(order) - max(1, len(order) // 50)
        return order[:keep], sizes[:keep], seen

    monkeypatch.setattr(culling.DeviceCullSession, "step_capped", drop)


def _fault_shifted(monkeypatch):
    """The viewer's session culls a table moved by 0.5 m along x."""
    from point_cloud_viewer_tpu_torch.ops.culling import DeviceCullSession
    from point_cloud_viewer_tpu_torch.viewer import render_loop

    def shifted(octree, device="cuda"):
        return DeviceCullSession(octree.cube_mins + [0.5, 0.0, 0.0],
                                 octree.cube_edges, octree.num_points,
                                 device=device,
                                 origin=octree.root_cube.center())

    monkeypatch.setattr(render_loop, "cull_session", shifted)


def _fault_swapped_past_the_tie(monkeypatch):
    """The capped step swaps its last 3 nodes, which lie within the tie at
    the cap, for the 3 visible nodes just past the tie, at the same length
    and in falling order."""
    from point_cloud_viewer_tpu_torch.ops import culling

    width = harness.cell(WORKLOAD)["limits"]["cap_gap"]

    def swap(self, frustum, cap):
        order, sizes, visible = self.step(frustum)
        seen = int(visible.sum())
        head = order[:min(seen, cap)]
        last = sizes[head[-1]]
        past = [i for i in order[len(head):seen]
                if sizes[i] < last * (1 - 2 * width)][:3]
        rows = np.concatenate([head[:len(head) - len(past)], past])
        return rows, sizes[rows], seen

    monkeypatch.setattr(culling.DeviceCullSession, "step_capped", swap)


FAULTS = {"nodes dropped at the cap": _fault_dropped_at_the_cap,
          "nodes swapped past the tie at the cap": _fault_swapped_past_the_tie,
          "the table shifted by 0.5 m": _fault_shifted}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    torch.set_num_threads(4)
    cell, cfg = _small()
    flyover = harness.load_module("traffic", "flyover")
    return flyover.setup({
        "cell": cell, "config": cfg, "seed": SEED, "device": "cpu",
        "tmp": str(tmp_path_factory.mktemp("city")),
        "generator": harness.load_module("generators", cfg["generator"])})


def test_tie_at_the_cap_excuses_a_swap_within_its_width_and_nothing_else(
        state):
    flyover = harness.load_module("traffic", "flyover")
    tree, cap = state["tree"], state["cell"]["params"]["node_cap"]
    res = float(state["config"]["resolution"])
    f = sorted(state["sample"])[0]
    order, sizes, visible, margin = flyover.reference(
        tree, state["matrices"][f], "float64", 4096)
    assert visible.sum() > cap + 1
    key = lambda k: (int(tree.levels[k]), int(tree.paths[k]))  # noqa: E731
    listed, last = order[:cap], sizes[order[cap - 1]]
    # The first visible node past the cap that is smaller than the cap-th
    # and no boundary tie: its distance from the cap-th, relative.
    nxt = next(k for k in order[cap:int(visible.sum())]
               if sizes[k] < last and abs(margin[k]) > res)
    depth = (last - sizes[nxt]) / last

    def judged(rows, width):
        limits = dict(state["cell"]["limits"], cap_gap=width)
        st = dict(state, cell=dict(state["cell"], limits=limits))
        return flyover.judge(st, {f: ([key(k) for k in rows], sizes[rows])})

    width = state["cell"]["limits"]["cap_gap"]
    r = judged(listed, width)
    assert (r["node_set_gap"], r["cap_gap"]) == (0, 0.0)
    swapped = np.concatenate([listed[:-1], [nxt]])
    r = judged(swapped, depth * 1.01)  # within the tie: excused
    assert r["node_set_gap"] == 0 and r["cap_excused"] == 2
    assert r["cap_gap"] == pytest.approx(depth)
    r = judged(swapped, depth * 0.99)  # past it: counted
    assert r["node_set_gap"] == 1 and r["cap_gap"] > depth * 0.99
    assert judged(listed[:-1], width)["node_set_gap"] == 1  # dropped
    head = np.concatenate([listed[1:], order[cap:cap + 1]])
    assert judged(head, width)["node_set_gap"] >= 1  # the largest left out


def test_blocked_reference_is_the_whole_table_at_once(state):
    flyover = harness.load_module("traffic", "flyover")
    matrix = state["matrices"][0]
    whole = flyover.reference(state["tree"], matrix, "float64",
                              len(state["tree"].counts))
    for got, want in zip(flyover.reference(state["tree"], matrix, "float64",
                                           1000), whole):
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def table():
    from point_cloud_viewer_tpu_torch.utils import progress

    progress.reset_span_totals()
    yield progress
    progress.reset_span_totals()


def test_readers_read_the_capped_path(table):
    with profile(activities=[ProfilerActivity.CPU]):
        with table.span("select.ids"):
            pass
        table.count("select.visible", 30_000)
        table.count("select.visible", 50_000)
        table.count("select.fetch_bytes", 80_004)
    read = {m: harness.layer_reader(m) for m in READERS}
    assert read["select.visible_per_frame"]({"traced_units": 2}) == 40_000
    assert read["select.fetch_kb_per_frame"]({"traced_units": 2}) == 40.002
    assert read["select.ids_ms"]({"traced_units": 2}) > 0
    assert all(r({"traced_units": 0}) is None for r in read.values())
    table.reset_span_totals()
    assert all(r({"traced_units": 2}) is None for r in read.values())


def test_readers_read_nothing_from_a_program_without_the_table(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "point_cloud_viewer_tpu_torch.utils.progress",
                        types.ModuleType("progress"))
    for metric in READERS:
        assert harness.layer_reader(metric)({"traced_units": 5}) is None


def test_setup_fails_at_once_on_a_program_without_the_capped_session(
        monkeypatch, tmp_path):
    """A program without the viewer's capped session (the parent's) fails
    before the table is made."""
    from point_cloud_viewer_tpu_torch.viewer import render_loop

    monkeypatch.delattr(render_loop, "cull_session")
    made = []
    cell, cfg = _small()
    flyover = harness.load_module("traffic", "flyover")
    with pytest.raises(ImportError, match="cull_session"):
        flyover.setup({"cell": cell, "config": cfg, "seed": SEED,
                       "device": "cpu", "tmp": str(tmp_path),
                       "generator": types.SimpleNamespace(
                           generate=lambda *a, **k: made.append(a))})
    assert made == []


@pytest.mark.cuda
def test_cell_is_correct_on_the_card(card):
    args = argparse.Namespace(workload=WORKLOAD, seed=SEED, seconds=5,
                              trace=0, control=0)
    r = run.run(args, t_start=time.perf_counter())
    assert r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct_on_the_card(card, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    args = argparse.Namespace(workload=WORKLOAD, seed=SEED + 1, seconds=2,
                              trace=0, control=0)
    r = run.run(args, t_start=time.perf_counter())
    print(fault, r["checks"])
    assert not r["correct"], r["checks"]
