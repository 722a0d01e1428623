"""Traffic kind `build`: a PLY file through the program's `build_octree`
command, in process, in a closed loop.

Set-up writes the seed's cloud as a binary PLY (xyz f64, rgb u8, intensity
f32) and builds it once (loading the kernels and warming the card's
allocator).  Each unit of the window is one whole build into a fresh
directory; the previous build's output is removed before the next starts,
except one build drawn from the seed among the first `keep_among`.  That
build and the window's last are judged against the reference build, file
by file and byte by byte, once the window has closed.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import sys

import numpy as np

from reference import octree as ref_octree

SPAN = "bench.build"


def write_ply(path: str, cloud: dict) -> None:
    """Binary little-endian PLY of the cloud (copy of chip_smoke.py's
    `write_ply_points`, with the attributes given)."""
    pos = cloud["position"]
    n = len(pos)
    rows = np.empty(n, dtype=[("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
                              ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                              ("intensity", "<f4")])
    rows["x"], rows["y"], rows["z"] = pos[:, 0], pos[:, 1], pos[:, 2]
    rgb = cloud["color"]
    rows["red"], rows["green"], rows["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    rows["intensity"] = cloud["intensity"]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              "property double x\nproperty double y\nproperty double z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "property float intensity\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rows.tofile(f)


def _build(state: dict, out: str, phases: dict) -> None:
    from point_cloud_viewer_tpu_torch.cli import build_octree

    args = [state["ply"], "--output_directory", out, "--resolution",
            repr(state["config"]["resolution"]), "--device", state["device"]]
    with contextlib.redirect_stdout(io.StringIO()):
        rc = build_octree.main(args, phase_times=phases)
    if rc != 0:
        raise RuntimeError(f"build_octree returned {rc}")


def setup(ctx: dict) -> dict:
    state = dict(ctx, cloud=ctx["generator"].generate(ctx["config"], ctx["seed"]))
    state["ply"] = os.path.join(ctx["tmp"], "cloud.ply")
    write_ply(state["ply"], state["cloud"])
    warm = os.path.join(ctx["tmp"], "warm")
    _build(state, warm, {})
    shutil.rmtree(warm)
    state["n"] = len(state["cloud"]["position"])
    state["keep"] = int(np.random.default_rng([ctx["seed"], 1]).integers(
        ctx["cell"]["params"]["keep_among"]))
    return state


def _out(state: dict, i: int) -> str:
    return os.path.join(state["tmp"], f"build{i}")


def unit(state: dict, i: int) -> tuple:
    if i > 0 and i - 1 != state["keep"]:
        shutil.rmtree(_out(state, i - 1), ignore_errors=True)
    phases: dict = {}
    _build(state, _out(state, i), phases)
    return state["n"], {"phases": phases}


def end_to_end(state: dict, units: list, t_open: float) -> dict:
    from measure import rate

    done = [u for u in units if u.ok]
    return {"build_mpts_s": rate([u.work for u in done], t_open,
                                 [u.end for u in done]) / 1e6}


def summary(state: dict, units: list) -> list:
    return [f"build {u.index}: {u.seconds:.3f} s, phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in u.info["phases"].items())
            for u in units]


def layer_context(state: dict, units: list) -> dict:
    return {"phases": [u.info["phases"] for u in units if u.ok],
            "points_per_build": state["n"]}


def _reference(state: dict, dtype):
    import torch

    c = state["cloud"]
    return ref_octree.build(
        c["position"], c["color"], c["intensity"],
        state["config"]["resolution"], state["config"]["max_points_per_node"],
        device=state["device"], dtype=getattr(torch, dtype))


def check(state: dict, units: list) -> dict:
    """The kept builds against the reference build, summed."""
    ref = _reference(state, "float64")
    total: dict = {}
    judged = {state["keep"], len(units) - 1} & {u.index for u in units}
    for u in units:
        if u.index in judged and u.ok:
            notes: list = []
            got = ref_octree.compare_files(
                ref.files, ref_octree.read_directory(_out(state, u.index)),
                notes)
            for line in notes:
                print(f"build {u.index}: {line}", file=sys.stderr)
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
    return total


def control(state: dict) -> dict:
    """The reference built in float32, judged as a build of the window."""
    return ref_octree.compare_files(_reference(state, "float64").files,
                                    _reference(state, "float32").files)


def close(state: dict) -> None:
    state.pop("cloud", None)
