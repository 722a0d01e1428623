"""Bounded runs of the port's campaign twins (point_cloud_viewer_tpu_torch/
tools/), the counterparts of tests/test_fuzz_smoke.py: each runs as
`python -m point_cloud_viewer_tpu_torch.tools.<twin> SECONDS --device cpu`
in a fresh interpreter with jax and the JAX package refused, and must end
with its "no failures" line.  The x-ray twin runs too: the port has no jit,
so the compile time that keeps the JAX x-ray campaign out of Tier-1
(tests/test_fuzz_smoke.py:34) does not arise.  The long campaigns run on
the card; their results are in PERF.md."""

import os
import subprocess
import sys
import textwrap

import pytest

from tests.test_torch_imports import _REFUSE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("twin,seed,iters", [
    ("fuzz_differential", 1, 6),
    ("fuzz_differential", 5, 6),   # three 60,000-point clouds
    ("fuzz_crash_resume", 2, 4),
    ("fuzz_crash_resume", 10, 3),  # its third takes the device bucket route
    ("fuzz_xray", 4, 6),
])
def test_campaign_twin_smoke(twin, seed, iters):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    env["FUZZ_SEED"] = str(seed)
    env["FUZZ_MAX_ITERS"] = str(iters)  # bounded: the long runs are on the card
    env.pop("FUZZ_NO_MESH", None)        # mesh builds on: no compile to wait for
    body = textwrap.dedent(f"""
        import runpy
        sys.argv = ["{twin}", "120", "--device", "cpu"]
        try:
            runpy.run_module("point_cloud_viewer_tpu_torch.tools.{twin}",
                             run_name="__main__")
        except SystemExit as e:
            assert_nothing_refused_loaded()
            raise
    """)
    proc = subprocess.run(
        [sys.executable, "-c", _REFUSE + body], capture_output=True,
        text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].endswith(f"finished: {iters} iterations, no failures"), \
        lines[-1]
    assert sum(line.startswith("OK it") for line in lines) == iters
