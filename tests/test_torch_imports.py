"""The PyTorch port imports without jax (the GPU machine has none) and
without the JAX package, builds and views with both refused, asks for CUDA
only explicitly, and never counts a kernel launch on the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A meta-path finder that refuses jax, jaxlib and the JAX package
# (point_cloud_viewer_tpu and its submodules), as chip_smoke.py installs.
_REFUSE = textwrap.dedent("""
    import importlib, pkgutil, sys

    def refused(name):
        return (name.split(".")[0] in ("jax", "jaxlib")
                or name == "point_cloud_viewer_tpu"
                or name.startswith("point_cloud_viewer_tpu."))

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if refused(name):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())

    def assert_nothing_refused_loaded():
        leaked = sorted(m for m in sys.modules if refused(m))
        assert not leaked, leaked
""")


def _run_refused(body: str, timeout: int = 600) -> str:
    """Run `body` in a fresh interpreter with the finder installed; returns
    its standard output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"  # one core, beside the other test workers
    proc = subprocess.run(
        [sys.executable, "-c", _REFUSE + textwrap.dedent(body)], cwd=_REPO,
        env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout

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
                LC.promote_pass, LC.promote_stage, K6.leaf_stage,
                K6.leaf_levels)
    before = [w.launches for w in wrappers]
    codes = np.random.default_rng(0).integers(0, 2**63, 3_000,
                                              dtype=np.uint64)
    out = build_tree_device_codes_grouped(
        torch.from_numpy(codes.view(np.int64)), len(codes), 21, 21, 50)
    assert out.order2.device.type == "cpu"
    K6.leaf_levels(torch.sort(torch.from_numpy(codes.view(np.int64))).values,
                   21, 21, 50)
    assert [w.launches for w in wrappers] == before


def test_port_stands_alone_builds_and_views(tmp_path):
    """Every module of the port and chip_smoke import with jax and the JAX
    package refused; then a tiny CPU build through cli.build_octree (in
    core and --streaming) and 3 frames of cli.view on the result."""
    out = _run_refused(f"""
        import os

        import chip_smoke
        import point_cloud_viewer_tpu_torch as P
        from point_cloud_viewer_tpu_torch.cli.build_octree import main as build
        from point_cloud_viewer_tpu_torch.cli.view import main as view
        from point_cloud_viewer_tpu_torch.io.ply import PlyReader

        names = [m.name for m in pkgutil.walk_packages(
            P.__path__, "point_cloud_viewer_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        tmp = {str(tmp_path)!r}
        ply = os.path.join(tmp, "cloud.ply")
        chip_smoke.write_ply(ply, 150_000, seed=3)
        assert len(PlyReader(ply).read_all()) == 150_000
        dirs = {{"incore": [], "streamed": ["--streaming"]}}
        for name, extra in dirs.items():
            assert build([ply, "--output_directory", os.path.join(tmp, name),
                          "--use_device", "--device", "cpu", *extra]) == 0
        files = sorted(os.listdir(os.path.join(tmp, "incore")))
        assert files == sorted(os.listdir(os.path.join(tmp, "streamed")))
        for f in files:
            a, b = (open(os.path.join(tmp, d, f), "rb").read() for d in dirs)
            assert a == b, f
        shot = os.path.join(tmp, "view.png")
        assert view([os.path.join(tmp, "incore"), "--device", "cpu",
                     "--frames", "3", "--width", "64", "--height", "48",
                     "--screenshot", shot]) == 0
        assert os.path.getsize(shot) > 0
        assert_nothing_refused_loaded()
        print("modules", len(names), "files", len(files))
    """)
    assert "modules" in out


def test_host_cull_of_a_large_octree_stands_alone(tmp_path):
    """get_visible_nodes on an octree past _HIER_THRESHOLD (100,000 nodes)
    whose heap index is absent (the meta leaves the level-5 ancestors out):
    the coarse-index branch (octree.py:429) runs with jax and the JAX
    package refused, and its visible set equals the JAX package's."""
    from point_cloud_viewer_tpu.octree.octree import Octree as JaxOctree
    from point_cloud_viewer_tpu.viewer.camera import Camera

    directory = str(tmp_path / "big")
    cam = Camera(640, 480)
    cam.position = np.array([100.0, 100.0, 300.0])
    cam.phi = 0.3
    matrix = cam.world_to_gl()
    np.save(str(tmp_path / "matrix.npy"), matrix)
    out = _run_refused(f"""
        import os
        import numpy as np
        from point_cloud_viewer_tpu_torch.core.constants import META_FILENAME
        from point_cloud_viewer_tpu_torch.octree import octree as O
        from point_cloud_viewer_tpu_torch.octree.node_id import NodeId
        from point_cloud_viewer_tpu_torch.protos.meta import (
            BoundingBoxProto, MetaProto, OctreeMetaProto, OctreeNodeProto,
            PositionEncodingProto)

        rng = np.random.default_rng(4)
        ids = [NodeId.from_level_index(level, int(p))
               for level in range(5) for p in range(8 ** level)]
        deep = np.sort(rng.choice(8 ** 7, 100_000, replace=False))
        ids += [NodeId.from_level_index(7, int(p)) for p in deep]
        nodes = [OctreeNodeProto(id=n.value, num_points=1 + i % 7,
                                 position_encoding=PositionEncodingProto.UINT8)
                 for i, n in enumerate(ids)]
        meta = MetaProto(
            bounding_box=BoundingBoxProto(min=(0.0, 0.0, 0.0),
                                          max=(1024.0, 1024.0, 1024.0)),
            octree=OctreeMetaProto(resolution=0.01, nodes=nodes))
        os.makedirs({directory!r})
        with open(os.path.join({directory!r}, META_FILENAME), "wb") as f:
            f.write(meta.encode())
        octree = O.Octree.from_directory({directory!r})
        assert len(octree) >= O._HIER_THRESHOLD
        assert octree._coarse is not None and octree._heap is None
        matrix = np.load({str(tmp_path / "matrix.npy")!r})
        visible = octree.get_visible_nodes(matrix, max_nodes=10_000)
        assert "point_cloud_viewer_tpu_torch.octree.builder" in sys.modules
        assert_nothing_refused_loaded()
        print("visible", " ".join(str(n.value) for n in visible))
    """)
    got = [int(v) for v in out.split("visible", 1)[1].split()]
    want = JaxOctree.from_directory(directory).get_visible_nodes(
        matrix, max_nodes=10_000)
    assert 0 < len(got) < 100_000
    assert got == [n.value for n in want]
