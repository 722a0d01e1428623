"""The PyTorch port imports without jax (the GPU machine has none), asks
for CUDA only explicitly, and never counts a kernel launch on the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PORT_MODULES = [
    "point_cloud_viewer_tpu_torch",
    "point_cloud_viewer_tpu_torch.device",
    "point_cloud_viewer_tpu_torch.ops.morton",
    "point_cloud_viewer_tpu_torch.ops.tree_build",
    "point_cloud_viewer_tpu_torch.ops.scan_cuda",
    "point_cloud_viewer_tpu_torch.ops.level_cuda",
    "point_cloud_viewer_tpu_torch.octree.builder",
    "point_cloud_viewer_tpu_torch.cli.build_octree",
    "point_cloud_viewer_tpu_torch.ops.cull_cuda",
    "point_cloud_viewer_tpu_torch.ops.culling",
    "point_cloud_viewer_tpu_torch.viewer.render_loop",
    "point_cloud_viewer_tpu_torch.cli.view",
    "point_cloud_viewer_tpu_torch.octree.streaming",
    "point_cloud_viewer_tpu_torch.ops.leaf_levels_cuda",
]


def test_port_imports_with_jax_blocked():
    script = textwrap.dedent(f"""
        import importlib, sys

        class BlockJax:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib"):
                    raise ImportError("jax is blocked: " + name)
                return None

        sys.meta_path.insert(0, BlockJax())
        for name in {_PORT_MODULES!r}:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib"))
        assert not leaked, leaked
        print("imported", len({_PORT_MODULES!r}))
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", script], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(_PORT_MODULES)}" in proc.stdout


def test_cuda_request_without_card_raises(monkeypatch):
    from point_cloud_viewer_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cpu_calls_leave_every_launch_counter_at_zero():
    import numpy as np

    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
    from point_cloud_viewer_tpu_torch.ops import scan_cuda as SC
    from point_cloud_viewer_tpu_torch.ops.tree_build import (
        build_tree_device_codes_grouped,
    )

    from point_cloud_viewer_tpu_torch.ops import leaf_levels_cuda as K6

    wrappers = (SC.scan_1d, LC.seg_start_pass, LC.leaf_update_pass,
                LC.promote_pass, K6.leaf_levels)
    before = [w.launches for w in wrappers]
    codes = np.random.default_rng(0).integers(0, 2**63, 3_000,
                                              dtype=np.uint64)
    out = build_tree_device_codes_grouped(
        torch.from_numpy(codes.view(np.int64)), len(codes), 21, 21, 50)
    assert out.order2.device.type == "cpu"
    K6.leaf_levels(torch.sort(torch.from_numpy(codes.view(np.int64))).values,
                   21, 21, 50)
    assert [w.launches for w in wrappers] == before
