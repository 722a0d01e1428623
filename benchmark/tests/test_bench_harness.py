"""The harness's own parts on the CPU: finding things by name, the
generators, the statistics, the trace arithmetic and the refusals."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import devtrace
import harness
import measure


def test_every_cell_config_and_metric_is_found_by_name():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell = harness.cell(w["name"], bench)
        assert cell["config"] == w["config"]
        cfg = harness.config(cell["config"])
        assert cfg["name"] == cell["config"]
        harness.load_module("traffic", cell["kind"])
        harness.load_module("generators", cfg["generator"])
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(harness.layer_reader(m["name"]))
        assert set(cell["limits"]) and all(
            v >= 0 for v in cell["limits"].values())
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))


def test_names_outside_the_folder_are_refused():
    for bad in ("../run", "a/b", "", ".hidden"):
        with pytest.raises(ValueError):
            harness.config(bad)
    with pytest.raises(KeyError):
        harness.cell("no_such.cell")


@pytest.mark.parametrize("config", ["tls_scan_16m", "ecef_site_16m"])
def test_generators_are_seed_deterministic(config):
    cfg = dict(harness.config(config), num_points=20_000)
    gen = harness.load_module("generators", cfg["generator"]).generate
    a, b, c = gen(cfg, 2**31 + 7), gen(cfg, 2**31 + 7), gen(cfg, 2**31 + 8)
    for key in ("position", "color", "intensity"):
        assert np.array_equal(a[key], b[key])
        assert not np.array_equal(a[key], c[key])
    assert a["position"].dtype == np.float64 and a["position"].shape == (20_000, 3)
    assert a["color"].dtype == np.uint8 and a["intensity"].dtype == np.float32


def test_query_mix_is_the_same_for_every_seed_in_equal_shares():
    query = harness.load_module("traffic", "query")
    cell = harness.cell("ecef_site_16m.query")
    cfg = harness.config("ecef_site_16m")
    gen = harness.load_module("generators", "ecef_site")
    a = query.plan(cfg, gen, cell["params"])
    b = query.plan(cfg, gen, cell["params"])
    assert [q["label"] for q in a] == [q["label"] for q in b]
    assert all(np.array_equal(x["center"], y["center"]) for x, y in zip(a, b))
    labels = [q["label"] for q in a]
    kinds = cell["params"]["kinds"]
    assert set(labels) == set(kinds) <= set(query.KINDS)
    assert {labels.count(k) for k in kinds} == {len(a) // len(kinds)}
    other = query.plan(cfg, gen, dict(cell["params"], mix_seed=1))
    assert not np.array_equal(a[0]["center"], other[0]["center"])


def test_rate_is_all_work_over_all_time():
    # Three builds of 16M points, started at 0, 5 and 9 s after the window
    # opened at 100 s; the last ends at 114 s.
    assert measure.rate([16e6] * 3, 100.0, [105.0, 109.0, 114.0]) == 48e6 / 14
    with pytest.raises(ValueError):
        measure.rate([], 0.0, [])


def test_p95_is_over_all_samples():
    values = list(range(1, 101))  # 1 .. 100 ms
    assert measure.percentile(values, 95) == pytest.approx(95.05)
    assert measure.percentile(values, 50) == pytest.approx(50.5)
    assert measure.percentile([7.0], 95) == 7.0


def test_query_rows_at_one_position_are_matched_by_attributes():
    query = harness.load_module("traffic", "query")
    pos = np.array([[4.2e6, 1.7e5, 4.8e6]] * 2 + [[4.2e6, 1.7e5, 4.8e6 + 0.01]])
    want = {"position": pos, "color": np.array([[1, 2, 3], [9, 8, 7], [5, 5, 5]],
                                              np.uint8),
            "intensity": np.array([0.25, 0.5, 0.3], np.float32)}
    swapped = [1, 0, 2]
    got = {k: v[swapped] for k, v in want.items()}
    r = query._judge({0: got}, {0: want}, 0.01)
    assert r == {"count_gap": 0, "position_gap_res": 0.0, "attribute_gap": 0}
    got["color"] = got["color"].copy()
    got["color"][0, 1] += 1
    assert query._judge({0: got}, {0: want}, 0.01)["attribute_gap"] > 0


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_share_and_rooflines_from_hand_made_events():
    events = [
        _event("user_annotation", "bench.build", 0, 1_000_000),
        _event("cpu_op", "aten::copy_", 100_000, 50_000),
        _event("kernel", "void pcv::(anonymous namespace)::leaf_bounds<int>(long)",
               120_000, 30_000),
        _event("kernel", "void pcv::(anonymous namespace)::leaf_assign<int>(long)",
               140_000, 20_000),  # overlaps the one before
        _event("gpu_memset", "Memset (Device)", 500_000, 10_000),
        _event("kernel", "promote_levels", 600_000, 40_000),
    ]
    r = devtrace.reduce(events)
    assert r["window_s"] == pytest.approx(1.0)
    assert r["busy_s"] == pytest.approx(0.04 + 0.01 + 0.04)
    assert measure.idle_share(r["busy_s"], r["window_s"]) == pytest.approx(91.0)
    assert r["kernels"]["leaf_bounds"] == [1, pytest.approx(0.03)]
    assert r["memsets"] == 1
    assert [g[1] for g in r["idle_gaps"]] == pytest.approx(
        [0.36, 0.34, 0.12, 0.09])  # 640 ms .. 1 s first
    assert r["idle_gaps"][0][0] == "bench.build"
    assert r["idle_gaps"][2][0] == "bench.build"  # the op ended at 150 ms
    assert r["device_ops"][0][1] == pytest.approx(0.04)
    # K6 at 16M points: 160 MB at 3.35 TB/s over the 50 ms of its kernels.
    k6 = harness.layer_reader("build.k6_roofline")(
        {"trace": r, "points_per_build": 16_000_000})
    assert k6 == pytest.approx(100 * 160e6 / 3.35e12 / 0.05)
    assert harness.layer_reader("build.k4_roofline")(
        {"trace": r, "points_per_build": 16_000_000}) == pytest.approx(
        100 * 48e6 / 3.35e12 / 0.04)
    assert harness.layer_reader("select.k5_roofline")(
        {"trace": r, "nodes": 1000}) is None
    assert measure.roofline_share(1e9, 67e12, 1.0) == pytest.approx(100.0)


def test_refusal_compares_whole_top_level_names():
    assert harness.refused_modules({"point_cloud_viewer_tpu_torch": 1,
                                    "point_cloud_viewer_tpu_torch.ops": 1,
                                    "jaxtyping": 1}) == []
    assert harness.refused_modules({"point_cloud_viewer_tpu.core": 1}) == [
        "point_cloud_viewer_tpu.core"]
    assert harness.refused_modules({"jax.numpy": 1, "flax": 1}) == [
        "flax", "jax.numpy"]


def _run_cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "tls_scan_16m.build",
         "--seed", "3", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run_cli(harness.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "needs 1 CUDA" in proc.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    proc = _run_cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_json_keeps_to_its_shape():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.cell(w)["end_to_end"]}
