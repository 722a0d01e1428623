"""What every cell of the benchmark shares: finding cells, configurations,
traffic kinds and per-layer readers by name, the guard against JAX, the
closed-loop window, and the result line.

Everything that belongs to one configuration, one cell or one per-layer
metric lives in a file of its own that is found by its name:

    BENCHMARK.json                    the cells, metrics and bounds
    benchmark/configs/<config>.json   a deployment: source, cuts, generator
    benchmark/cells/<cell>.json       a cell: config, traffic kind, params
    benchmark/generators/<gen>.py     a point-cloud generator
    benchmark/traffic/<kind>.py       a traffic kind (setup, unit, check)
    benchmark/layers/<metric>.py      a per-layer metric's reader

A later change adds a cell, a configuration or a metric by adding such
files and entries; it edits none of these modules.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import sys
import time
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# Top-level module names that may not be loaded in a run: the JAX package,
# JAX itself and Flax.  Compared whole: the program's own name begins with
# the JAX package's.
REFUSED_TOP_LEVEL = ("jax", "jaxlib", "flax", "point_cloud_viewer_tpu")

# Build and kernel caches at fixed paths inside the checkout, so that only
# the first run of a checkout compiles.  The program builds its kernels
# into its own package directory (point_cloud_viewer_tpu_torch/_build/).
CACHE_DIR = os.path.join(BENCH_DIR, "_cache")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _named(kind: str, name: str, ext: str) -> str:
    """Path of benchmark/<kind>/<name><ext>, refusing names that could
    leave the folder."""
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}", name):
        raise ValueError(f"invalid {kind} name {name!r}")
    path = os.path.join(BENCH_DIR, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return path


def config(name: str) -> dict:
    return load_json(_named("configs", name, ".json"))


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """The cell's file, checked against its BENCHMARK.json entry, with the
    entry's `chips` and the metrics it reports ("end_to_end" and
    "per_layer" lists of metric entries)."""
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    spec = load_json(_named("cells", name, ".json"))
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} {spec[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    spec = dict(spec, name=name, chips=int(entry["chips"]))
    spec["end_to_end"] = [m for m in bench["end_to_end"]
                          if name in m.get("workloads", [name])]
    moved = {m["name"] for m in spec["end_to_end"]}
    spec["per_layer"] = [
        m for m in bench["per_layer"]
        if (name in m["workloads"] if "workloads" in m
            else m["moves"] in moved)]
    return spec


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = _named(kind, name, ".py")
    mod_name = f"bench_{kind}_" + re.sub(r"\W", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def layer_reader(metric: str) -> Callable[[dict], Optional[float]]:
    return load_module("layers", metric).read


def refused_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is refused, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names
                   if n.split(".")[0] in REFUSED_TOP_LEVEL})


def set_environment() -> None:
    """Cache directories inside the checkout; no library may pull in JAX
    or Flax on its own."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


# --- the window -----------------------------------------------------------


class Unit:
    """One unit of a closed loop: a build, a query or a frame."""

    __slots__ = ("index", "start", "end", "ok", "work", "info")

    def __init__(self, index: int, start: float) -> None:
        self.index = index
        self.start = start
        self.end = start
        self.ok = False
        self.work = 0
        self.info = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


def closed_loop(run_unit: Callable[[int], tuple], seconds: float,
                span: str, profiler=None, trace_seconds: float = math.inf,
                errors: Optional[list] = None) -> tuple:
    """Run units back to back from now until `seconds` have passed; every
    unit started in the window runs to its end.  run_unit(i) -> (work,
    info).  With a profiler, each unit is wrapped in the record_function
    span `span`, and the profiler is stopped once `trace_seconds` have
    passed (the traced window).  Returns (units, window open time, traced
    window's end or None)."""
    import torch

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    units: List[Unit] = []
    t_open = time.perf_counter()
    close = t_open + seconds
    trace_end = None
    i = 0
    while True:
        now = time.perf_counter()
        if now >= close:
            break
        if profiler is not None and trace_end is None \
                and now - t_open >= trace_seconds:
            sync()
            profiler.stop()
            trace_end = time.perf_counter()
        unit = Unit(i, now)
        try:
            if profiler is not None and trace_end is None:
                with torch.profiler.record_function(span):
                    unit.work, unit.info = run_unit(i)
            else:
                unit.work, unit.info = run_unit(i)
            unit.ok = True
        except Exception as e:  # noqa: BLE001 - a failed unit is counted
            if errors is not None:
                errors.append(f"{span} {i}: {type(e).__name__}: {e}")
        unit.end = time.perf_counter()
        units.append(unit)
        i += 1
    if profiler is not None and trace_end is None:
        sync()
        profiler.stop()
        trace_end = time.perf_counter()
    return units, t_open, trace_end


def io_text() -> str:
    """This process's bytes read and written on the host's storage."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
        return (f"io: read_bytes {int(io['read_bytes'])}, "
                f"write_bytes {int(io['write_bytes'])}")
    except (OSError, KeyError, ValueError):
        return "io: not readable"


def checks_text(checks: Dict[str, dict]) -> List[str]:
    return [f"check {name}: {c['value']!r} <= limit {c['limit']!r} "
            f"({'ok' if c['value'] <= c['limit'] else 'FAILED'})"
            for name, c in checks.items()]


def all_within(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(
        c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values())
