"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

Set-up (imports, kernel load, the cell's data from the seed, its warm-up)
runs from the process's start until the window opens; the window runs the
cell's traffic in a closed loop for --seconds; then the window's outputs
are judged against the plain reference.  The last line on standard output
is one JSON object: correct, attempted, failed, metrics, device, (with
--trace 1) breakdown, the sample count, and last the numbers compared with
their limits, which also end standard error.

--trace 1 runs the window under torch.profiler (at most the cell's
`trace_seconds` of it) with a span around each unit, and reports the
cell's per-layer metrics in place of its end-to-end ones.  --control 1 puts
the control, the reference computed in a lower precision, in the
program's place: its outputs are judged against the reference instead of
the window's, so `correct` comes out false.

It exits with another code than 0 and prints no result without a CUDA
device (or with fewer than the cell's chips), when a module of JAX, Flax or
the JAX package is loaded before the window, after it or when the result
is due, or when the program cannot be imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import harness  # noqa: E402


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def refuse_jax(where: str) -> None:
    found = harness.refused_modules()
    if found:
        log(f"refused: modules of JAX or the JAX package loaded {where}: "
            f"{found}")
        sys.exit(3)


def card_label() -> dict:
    """nvidia-smi's name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        name, limit = [s.strip() for s in out[0].split(",")]
        return {"name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {"name": "unknown", "power_limit": "unknown"}


def run(args, device: str = "cuda", t_start: float = T_START,
        cell_override=None, config_override=None) -> dict:
    """One run of a cell; returns the result object.  `device` other than
    cuda, and the overrides, are for the CPU tests."""
    bench = harness.benchmark()
    cell = cell_override or harness.cell(args.workload, bench)
    cfg = config_override or harness.config(cell["config"])
    kind = harness.load_module("traffic", cell["kind"])
    generator = harness.load_module("generators", cfg["generator"])

    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            log(f"refused: {cell['name']} needs {cell['chips']} CUDA "
                f"device(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            sys.exit(2)
        label = card_label()
        log(f"card: {label['name']}, power limit {label['power_limit']}")
    tmp = tempfile.mkdtemp(prefix="pcv-bench-",
                           dir=os.environ.get("TMPDIR") or None)
    errors: list = []
    try:
        state = kind.setup({"cell": cell, "config": cfg, "seed": args.seed,
                            "tmp": tmp, "device": device,
                            "generator": generator})
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        refuse_jax("before the window")
        prof = None
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        setup_s = time.perf_counter() - t_start
        units, t_open, trace_end = harness.closed_loop(
            lambda i: kind.unit(state, i), args.seconds, kind.SPAN,
            profiler=prof,
            trace_seconds=cell.get("trace_seconds", math.inf), errors=errors)
        if device == "cuda":
            torch.cuda.synchronize()
        refuse_jax("after the window")
        done = [u for u in units if u.ok]
        failed = len(units) - len(done)
        metrics = {}
        if done:
            values = kind.end_to_end(state, done, t_open)
            values["setup_s"] = setup_s
            units_of = {m["name"]: m["unit"] for m in bench["end_to_end"]}
            metrics = {name: {"value": values[name], "unit": units_of[name]}
                       for name in (m["name"] for m in cell["end_to_end"])}
        for line in getattr(kind, "summary", lambda s, u: [])(state, done):
            log(line)
        dev_info = {"platform": "gpu" if device == "cuda" else device,
                    "kind": (torch.cuda.get_device_name(0)
                             if device == "cuda" else device),
                    "count": cell["chips"],
                    "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                          if device == "cuda" else 0)}
        breakdown = None
        if prof is not None:
            import devtrace

            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            reduced = devtrace.reduce(devtrace.load(path))
            os.remove(path)
            traced = [u for u in done if u.start < trace_end]
            ctx = dict(kind.layer_context(state, done), trace=reduced,
                       traced_units=len(traced), cell=cell, config=cfg)
            metrics = {}
            for m in cell["per_layer"]:
                value = harness.layer_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev_info["busy_s"] = reduced["busy_s"]
            dev_info["window_s"] = reduced["window_s"]
            breakdown = {"device_ops": reduced["device_ops"],
                         "idle_gaps": reduced["idle_gaps"]}
        if args.control:
            log("control: the reference in a lower precision is judged in "
                "the program's place")
            readings = kind.control(state)
        else:
            readings = kind.check(state, units) if done else {}
        limits = cell["limits"]
        checks = {name: {"value": readings.get(name, math.nan),
                         "limit": limits[name]} for name in limits}
        kind.close(state)
        result = {"correct": harness.all_within(checks) and failed == 0,
                  "attempted": len(units), "failed": failed,
                  "metrics": metrics, "device": dev_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result.update(samples=len(done), checks=checks)
        for line in errors[:5]:
            log(line)
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    harness.set_environment()
    try:
        import point_cloud_viewer_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"refused: the program does not import: {e}")
        return 4
    try:
        result = run(args)
    except SystemExit:
        raise
    except Exception:  # noqa: BLE001 - the run's boundary: report, no result
        log(traceback.format_exc())
        return 1
    log(harness.io_text())
    for line in harness.checks_text(result["checks"]):
        log(line)
    refuse_jax("when the result is due")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
