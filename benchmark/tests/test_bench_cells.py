"""Each traffic kind end to end at a small size on the program's CPU route,
judged against the plain reference; the controls (the reference in a lower
precision put in the program's place) and the faults planted under the
timed path must come out as not correct.  The same runs on the card at
full size are the `cuda` tests."""

import argparse
import sys
import time
import types

import numpy as np
import pytest
import torch

import harness
import run

SMALL = {"tls_scan_16m.build": 250_000, "ecef_site_16m.build": 250_000,
         "ecef_site_16m.query": 250_000, "tls_scan_16m.select": 250_000}
SEED = 2**31 + 2026


def _small(workload):
    cell = harness.cell(workload)
    cfg = dict(harness.config(cell["config"]), num_points=SMALL[workload])
    if cell["kind"] == "query":
        cell["params"] = dict(cell["params"], distinct_queries=12,
                              compare_queries=7)
    return cell, cfg


def _run(workload, seconds=1.5, control=0):
    torch.set_num_threads(4)
    cell, cfg = _small(workload)
    args = argparse.Namespace(workload=workload, seed=SEED, seconds=seconds,
                              trace=0, control=control)
    return run.run(args, device="cpu", t_start=time.perf_counter(),
                   cell_override=cell, config_override=cfg)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_is_correct_on_the_cpu_route(workload):
    r = _run(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    names = {m["name"] for m in harness.cell(workload)["end_to_end"]}
    assert set(r["metrics"]) == names


@pytest.mark.parametrize("workload", ["tls_scan_16m.build",
                                      "ecef_site_16m.query",
                                      "tls_scan_16m.select"])
def test_control_is_not_correct(workload):
    # --control 1: the reference in a lower precision is judged in the
    # program's place, through the harness's own comparison.
    r = _run(workload, seconds=0.5, control=1)
    assert not r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


def test_no_result_when_a_refused_module_loads_after_the_window(
        monkeypatch, capsys):
    select = harness.load_module("traffic", "select")
    check = select.check

    def check_and_load(state, units):
        monkeypatch.setitem(sys.modules, "point_cloud_viewer_tpu",
                            types.ModuleType("point_cloud_viewer_tpu"))
        return check(state, units)

    monkeypatch.setattr(select, "check", check_and_load)
    monkeypatch.setattr(harness, "set_environment", lambda: None)
    cell, cfg = _small("tls_scan_16m.select")
    real = run.run
    monkeypatch.setattr(run, "run", lambda args: real(
        args, device="cpu", t_start=time.perf_counter(), cell_override=cell,
        config_override=cfg))
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "tls_scan_16m.select", "--seed", str(SEED),
                  "--seconds", "0.5"])
    assert e.value.code == 3
    out = capsys.readouterr()
    assert out.out == ""
    assert "refused" in out.err and "point_cloud_viewer_tpu" in out.err


def _fault_build_half(monkeypatch):
    from point_cloud_viewer_tpu_torch.io import ply

    read_all = ply.PlyReader.read_all
    monkeypatch.setattr(ply.PlyReader, "read_all",
                        lambda self: (lambda b: b.take(np.arange(len(b) // 2)))(
                            read_all(self)))


def _fault_build_altered(monkeypatch):
    from point_cloud_viewer_tpu_torch.octree import builder

    write = builder.write_node_files

    def altered(stem, encoded, attributes):
        if stem.endswith("r"):
            encoded = encoded.copy()
            encoded.reshape(-1).view(np.uint8)[0] ^= 1
        return write(stem, encoded, attributes)

    monkeypatch.setattr(builder, "write_node_files", altered)


def _fault_query_half(monkeypatch):
    from point_cloud_viewer_tpu_torch.query import point_query

    filt = point_query.PointQuery.filter_batch

    def half(self, batch, **kw):
        out = filt(self, batch, **kw)
        return out.take(np.arange(len(out) // 2))

    monkeypatch.setattr(point_query.PointQuery, "filter_batch", half)


def _fault_query_altered(monkeypatch):
    from point_cloud_viewer_tpu_torch.query import point_query

    filt = point_query.PointQuery.filter_batch

    def altered(self, batch, **kw):
        out = filt(self, batch, **kw)
        if len(out):
            out.attributes["intensity"] = out.attributes["intensity"].copy()
            out.attributes["intensity"][0] += 1.0
        return out

    monkeypatch.setattr(point_query.PointQuery, "filter_batch", altered)


def _fault_select_drop(monkeypatch, which):
    """The session's step leaves out the visible nodes that
    which(order, visible, levels) marks, its outputs kept consistent."""
    from point_cloud_viewer_tpu_torch.ops import culling

    step = culling.DeviceCullSession.step

    def drop(self, frustum):
        order, sizes, visible = step(self, frustum)
        edges = self._edges.double().cpu().numpy()
        levels = np.rint(np.log2(edges.max() / edges)).astype(int)
        visible = visible & ~which(order, visible, levels)
        first = visible[order]
        return np.concatenate([order[first], order[~first]]), sizes, visible

    monkeypatch.setattr(culling.DeviceCullSession, "step", drop)


def _listed(order, visible):
    return order[:int(visible.sum())]


def _rows(visible, rows):
    m = np.zeros(len(visible), dtype=bool)
    m[rows] = True
    return m


def _fault_select_head_half(monkeypatch):
    def larger_half(order, visible, levels):
        listed = _listed(order, visible)
        return _rows(visible, listed[:len(listed) // 2])

    _fault_select_drop(monkeypatch, larger_half)


def _fault_select_tail_half(monkeypatch):
    def smaller_half(order, visible, levels):
        listed = _listed(order, visible)
        return _rows(visible, listed[len(listed) - len(listed) // 2:])

    _fault_select_drop(monkeypatch, smaller_half)


def _fault_select_deep(monkeypatch):
    # Nodes deeper than level 5; a tree that shallow loses its deepest level.
    def deep(order, visible, levels):
        return levels > min(5, levels.max() - 1)

    _fault_select_drop(monkeypatch, deep)


def _fault_select_altered(monkeypatch):
    from point_cloud_viewer_tpu_torch.ops import culling

    step = culling.DeviceCullSession.step

    def altered(self, frustum):
        order, sizes, visible = step(self, frustum)
        order = order.copy()
        order[[0, 1]] = order[[1, 0]]
        sizes = sizes.copy()
        sizes[order[2]] *= 1.01
        return order, sizes, visible

    monkeypatch.setattr(culling.DeviceCullSession, "step", altered)


FAULTS = {
    ("tls_scan_16m.build", "half of the points left out"): _fault_build_half,
    ("tls_scan_16m.build", "a byte altered where written"): _fault_build_altered,
    ("ecef_site_16m.query", "half of each answer left out"): _fault_query_half,
    ("ecef_site_16m.query", "a point altered where yielded"): _fault_query_altered,
    ("tls_scan_16m.select", "the larger half of the list left out"):
        _fault_select_head_half,
    ("tls_scan_16m.select", "the smaller half of the list left out"):
        _fault_select_tail_half,
    ("tls_scan_16m.select", "the deep nodes left out"): _fault_select_deep,
    ("tls_scan_16m.select", "the order altered where produced"): _fault_select_altered,
}


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_fault_under_the_timed_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[workload, fault](monkeypatch)
    r = _run(workload, seconds=1.0)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_is_correct_on_the_card(card, workload):
    args = argparse.Namespace(workload=workload, seed=SEED, seconds=5,
                              trace=0, control=0)
    r = run.run(args, t_start=time.perf_counter())
    assert r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(f for w, f in FAULTS
                                         if w == "tls_scan_16m.select"))
def test_select_fault_is_not_correct_on_the_card(card, fault, monkeypatch):
    # At the cell's own size, where the deep nodes are small on screen.
    FAULTS["tls_scan_16m.select", fault](monkeypatch)
    args = argparse.Namespace(workload="tls_scan_16m.select", seed=SEED + 1,
                              seconds=2, trace=0, control=0)
    r = run.run(args, t_start=time.perf_counter())
    print(fault, r["checks"])
    assert not r["correct"], r["checks"]
