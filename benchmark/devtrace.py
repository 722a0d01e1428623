"""Reduction of a torch.profiler Chrome trace to the benchmark's device
readings: the traced window, the device's busy time (the union of its
kernel, memcpy and memset intervals), the device operations that took most
time, the longest idle gaps named by what the host was doing, and each
kernel's launches and device time.

The busy-time arithmetic is copied from chip_smoke.py's `trace_readings`,
and `kernel_name` extends point_cloud_viewer_tpu_torch/testing.py's rule,
so that the yardstick does not move with the program.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


def kernel_name(key: str) -> str:
    """A kernel's name without the program's namespace, anonymous
    namespaces, template arguments or parameters (testing.kernel_name's
    rule, extended to keep library kernels' names)."""
    key = re.sub(r"^void ", "", key.replace("(anonymous namespace)::", ""))
    return re.sub(r"^pcv::", "", key).split("<")[0].split("(")[0]


def load(path: str) -> List[dict]:
    """Complete events ("ph": "X" with a duration) of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X"
            and "dur" in e and "ts" in e]


def _merged(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_label(mid: float, starts, ends, names, spans) -> str:
    """What the host was doing at time `mid`: the innermost benchmark
    span and the innermost CPU op open then."""
    inside = np.flatnonzero((starts <= mid) & (mid <= ends))
    if len(inside) == 0:
        return "host (no span)"
    span = [i for i in inside if spans[i]]
    ops = [i for i in inside if not spans[i]]
    label = []
    if span:
        label.append(names[max(span, key=lambda i: starts[i])])
    if ops:
        label.append(names[max(ops, key=lambda i: starts[i])])
    return " > ".join(label)


def reduce(events: List[dict]) -> dict:
    """-> {window_s, busy_s, device_ops, idle_gaps, kernels, memsets,
    device_events}.  `kernels` maps a kernel's short name to
    [launches, device seconds]."""
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not events or not device:
        raise ValueError(f"trace has {len(events)} events, {len(device)} on "
                         "the device")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy_iv = _merged([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in device])
    busy = sum(b - a for a, b in busy_iv)

    ops: Dict[str, float] = {}
    kernels: Dict[str, list] = {}
    memsets = 0
    for e in device:
        if e.get("cat") == "kernel":
            name = kernel_name(e["name"])
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += float(e["dur"]) / 1e6
        else:
            name = e["name"]
            memsets += e.get("cat") == "gpu_memset"
        name = name[:60]
        ops[name] = ops.get(name, 0.0) + float(e["dur"]) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]

    gaps = []
    edges = [t0] + [x for iv in busy_iv for x in iv] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    host = [e for e in events if e.get("cat") in HOST_CATS]
    starts = np.array([float(e["ts"]) for e in host])
    ends = starts + np.array([float(e["dur"]) for e in host])
    names = [e["name"] for e in host]
    spans = [e.get("cat") == "user_annotation" for e in host]
    idle = [[_host_label((a + b) / 2, starts, ends, names, spans)[:120],
             length / 1e6] for length, a, b in gaps[:TOP]]
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "device_ops": [[n, s] for n, s in top], "idle_gaps": idle,
            "kernels": kernels, "memsets": memsets,
            "device_events": len(device)}
