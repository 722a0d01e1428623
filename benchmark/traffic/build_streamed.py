"""Traffic kind `build_streamed`: a PLY file through the program's
`build_octree --streaming` command, out of core and resumable, in process,
in a closed loop.

Set-up writes the seed's cloud as the `build` kind's binary PLY and builds
it once streamed (loading the kernels and warming the card's allocator).
Each unit of the window is one whole streamed build with the
configuration's `bucket_levels` into a fresh output directory, with a
fresh spill directory (`--spill_directory`, which makes the build
resumable; the program removes it when the build succeeds, and whatever
is left is removed before the next unit).  The outputs are kept and judged as the
`build` kind keeps and judges its own: one build drawn from the seed among
the first `keep_among` and the window's last, against the reference build,
file by file and byte by byte, since the streamed route writes the in-core
route's bytes.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil

import numpy as np

import harness

_build_kind = harness.load_module("traffic", "build")

SPAN = "bench.build"
write_ply = _build_kind.write_ply
end_to_end = _build_kind.end_to_end
summary = _build_kind.summary
layer_context = _build_kind.layer_context
check = _build_kind.check
control = _build_kind.control
close = _build_kind.close


def _spill(state: dict, i) -> str:
    return os.path.join(state["tmp"], f"spill{i}")


def _build(state: dict, out: str, spill: str, phases: dict) -> None:
    from point_cloud_viewer_tpu_torch.cli import build_octree

    args = [state["ply"], "--output_directory", out, "--resolution",
            repr(state["config"]["resolution"]), "--device", state["device"],
            "--streaming", "--bucket_levels",
            str(state["config"]["bucket_levels"]),
            "--spill_directory", spill]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = build_octree.main(args, phase_times=phases)
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    if rc != 0:
        raise RuntimeError(f"build_octree returned {rc}")


def setup(ctx: dict) -> dict:
    state = dict(ctx, cloud=ctx["generator"].generate(ctx["config"], ctx["seed"]))
    state["ply"] = os.path.join(ctx["tmp"], "cloud.ply")
    write_ply(state["ply"], state["cloud"])
    warm = os.path.join(ctx["tmp"], "warm")
    _build(state, warm, _spill(state, "_warm"), {})
    shutil.rmtree(warm)
    state["n"] = len(state["cloud"]["position"])
    state["keep"] = int(np.random.default_rng([ctx["seed"], 1]).integers(
        ctx["cell"]["params"]["keep_among"]))
    return state


def unit(state: dict, i: int) -> tuple:
    if i > 0 and i - 1 != state["keep"]:
        shutil.rmtree(_build_kind._out(state, i - 1), ignore_errors=True)
    phases: dict = {}
    _build(state, _build_kind._out(state, i), _spill(state, i), phases)
    return state["n"], {"phases": phases}
