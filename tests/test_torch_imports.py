"""The PyTorch port imports without jax (the GPU machine has none) and
without the JAX package, builds, views (headless, through GL and through
the windowed shell), queries, serves and runs the x-ray CLIs with both
refused, asks for CUDA only explicitly, and never counts a kernel launch on
the CPU."""

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
    "point_cloud_viewer_tpu_torch.math.s2_device",
    "point_cloud_viewer_tpu_torch.math.web_mercator_device",
    "point_cloud_viewer_tpu_torch.query.device_filter",
    "point_cloud_viewer_tpu_torch.query.client",
    "point_cloud_viewer_tpu_torch.s2_cells.container",
    "point_cloud_viewer_tpu_torch.cli.query_points",
    "point_cloud_viewer_tpu_torch.xray.device_splat",
    "point_cloud_viewer_tpu_torch.xray.generation",
    "point_cloud_viewer_tpu_torch.xray.build",
    "point_cloud_viewer_tpu_torch.xray.merge",
    "point_cloud_viewer_tpu_torch.xray.inpaint",
    "point_cloud_viewer_tpu_torch.cli.build_xray_quadtree",
    "point_cloud_viewer_tpu_torch.cli.merge_xray_quadtrees",
    "point_cloud_viewer_tpu_torch.cli.inpaint_xray_quadtree",
    "point_cloud_viewer_tpu_torch.cli.upgrade_xray_quadtree",
    "point_cloud_viewer_tpu_torch.ops.sort",
    "point_cloud_viewer_tpu_torch.parallel.mesh",
    "point_cloud_viewer_tpu_torch.parallel.sharded_build",
    "point_cloud_viewer_tpu_torch.entry",
    "point_cloud_viewer_tpu_torch.viewer.camera",
    "point_cloud_viewer_tpu_torch.viewer.input",
    "point_cloud_viewer_tpu_torch.viewer.terrain",
    "point_cloud_viewer_tpu_torch.viewer.sdl_shell",
    "point_cloud_viewer_tpu_torch.viewer.web_backend",
    "point_cloud_viewer_tpu_torch.viewer.gl",
    "point_cloud_viewer_tpu_torch.viewer.gl.api",
    "point_cloud_viewer_tpu_torch.viewer.gl.core",
    "point_cloud_viewer_tpu_torch.viewer.gl.renderer",
    "point_cloud_viewer_tpu_torch.viewer.gl.viewer",
    "point_cloud_viewer_tpu_torch.viewer.gl.terrain",
    "point_cloud_viewer_tpu_torch.viewer.gl.shaders",
    "point_cloud_viewer_tpu_torch.xray.backend",
    "point_cloud_viewer_tpu_torch.cli.points_web_viewer",
    "point_cloud_viewer_tpu_torch.cli.xray_web_viewer",
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


def test_deep_and_host_builds_stand_alone(tmp_path):
    """With jax and the JAX package refused: a deep build (planet box, one
    fat level-21 cell) on CPU tensors with the device threshold lowered,
    the same cloud on the host route, in core and streamed, all four
    byte-equal; then a host build through cli.build_octree
    --no-use_device."""
    out = _run_refused(f"""
        import os

        import numpy as np
        from point_cloud_viewer_tpu_torch.cli.build_octree import main as cli
        from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
        from point_cloud_viewer_tpu_torch.math.geometry import Aabb
        from point_cloud_viewer_tpu_torch.octree import builder as B
        from point_cloud_viewer_tpu_torch.octree.streaming import (
            build_octree_streaming)
        import chip_smoke

        B._DEEP_DEVICE_MIN_N = 1_000
        rng = np.random.default_rng(8)
        pos = np.concatenate([rng.random((104_000, 3)) * 2.5 + 7e5,
                              rng.random((3_000, 3)) * 4e6])
        batch = PointsBatch(position=pos, attributes={{
            "color": rng.integers(0, 256, (len(pos), 3), dtype=np.uint8)}})
        box = Aabb(np.zeros(3), np.full(3, 6.4e6))
        tmp = {str(tmp_path)!r}
        dirs = [os.path.join(tmp, d) for d in ("dev", "host", "sdev", "shost")]
        phases = {{}}
        B.build_octree(dirs[0], 0.01, batch, bounding_box=box, device="cpu",
                       phase_times=phases)
        assert phases["deep_device_subbuilds"] == 1, phases
        B.build_octree(dirs[1], 0.01, batch, bounding_box=box,
                       use_device=False)
        for d, use_device in ((dirs[2], True), (dirs[3], False)):
            build_octree_streaming(d, 0.01, batch, bounding_box=box,
                                   use_device=use_device, device="cpu")
        files = sorted(os.listdir(dirs[0]))
        assert any(len(f) > len("r") + 21 + len(".xyz") for f in files)
        for d in dirs[1:]:
            assert sorted(os.listdir(d)) == files
            for f in files:
                a, b = (open(os.path.join(x, f), "rb").read()
                        for x in (dirs[0], d))
                assert a == b, (d, f)
        ply = os.path.join(tmp, "cloud.ply")
        chip_smoke.write_ply(ply, 20_000, seed=4)
        assert cli([ply, "--output_directory", os.path.join(tmp, "cli"),
                    "--no-use_device"]) == 0
        assert_nothing_refused_loaded()
        print("deep files", len(files))
    """)
    assert "deep files" in out


def test_mesh_build_and_dryrun_stand_alone(tmp_path):
    """With jax and the JAX package refused: a 4-shard CPU mesh build
    byte-equal to the single-device build, a deep build with its fat cell
    placed on the mesh, and entry.dryrun_multichip(4) with its build cut
    to 60,001 points."""
    out = _run_refused(f"""
        import os

        import numpy as np
        from point_cloud_viewer_tpu_torch import entry
        from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
        from point_cloud_viewer_tpu_torch.math.geometry import Aabb
        from point_cloud_viewer_tpu_torch.octree import builder as B
        from point_cloud_viewer_tpu_torch.parallel.mesh import make_mesh

        def same(a, b):
            files = sorted(os.listdir(a))
            assert files == sorted(os.listdir(b))
            for f in files:
                x, y = (open(os.path.join(d, f), "rb").read() for d in (a, b))
                assert x == y, f
            return len(files)

        rng = np.random.default_rng(2)
        pos = np.concatenate([rng.random((40_000, 3)) * 30.0,
                              10.0 + rng.normal(0.0, 0.05, (40_000, 3))])
        batch = PointsBatch(position=pos, attributes={{
            "color": rng.integers(0, 256, (len(pos), 3), dtype=np.uint8)}})
        tmp = {str(tmp_path)!r}
        mesh = make_mesh(4, device="cpu")
        result = B.build_octree(os.path.join(tmp, "mesh"), 0.01, batch,
                                mesh=mesh)
        assert sum(result.shard_points) == len(pos)
        B.build_octree(os.path.join(tmp, "one"), 0.01, batch, device="cpu")
        files = same(os.path.join(tmp, "mesh"), os.path.join(tmp, "one"))

        B._DEEP_DEVICE_MIN_N = 1_000
        deep = PointsBatch(position=np.concatenate([
            rng.random((104_000, 3)) * 2.5 + 7e5,
            rng.random((3_000, 3)) * 4e6]), attributes={{}})
        box = Aabb(np.zeros(3), np.full(3, 6.4e6))
        phases = {{}}
        B.build_octree(os.path.join(tmp, "dmesh"), 0.01, deep,
                       bounding_box=box, mesh=mesh, phase_times=phases)
        assert phases["deep_device_subbuilds"] == 1, phases
        B.build_octree(os.path.join(tmp, "dhost"), 0.01, deep,
                       bounding_box=box, use_device=False)
        same(os.path.join(tmp, "dmesh"), os.path.join(tmp, "dhost"))

        entry.BUILD_POINTS = 60_001
        summary = entry.dryrun_multichip(4, device="cpu")
        assert summary["skew_attempts"] >= 2
        assert_nothing_refused_loaded()
        print("mesh files", files, "dry run files", summary["files"])
    """)
    assert "mesh files" in out


def test_query_stands_alone(tmp_path):
    """With jax and the JAX package refused: a tiny cloud on and above the
    WGS84 surface through cli.build_octree (CPU), then cli.query_points
    with each query flag, the filter on CPU tensors and on the host, the
    same counts; the client streams the same points both ways."""
    out = _run_refused(f"""
        import contextlib, io, os, re

        import numpy as np
        from point_cloud_viewer_tpu_torch.cli.build_octree import main as build
        from point_cloud_viewer_tpu_torch.cli.query_points import main as query
        from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
        from point_cloud_viewer_tpu_torch.math import s2, wgs84
        from point_cloud_viewer_tpu_torch.math.geometry import Isometry, Obb
        from point_cloud_viewer_tpu_torch.math.web_mercator import (
            lat_lng_to_web_mercator)
        from point_cloud_viewer_tpu_torch.octree.builder import build_octree
        from point_cloud_viewer_tpu_torch.query.client import PointCloudClient
        from point_cloud_viewer_tpu_torch.query.point_query import PointQuery

        rng = np.random.default_rng(9)
        n = 40_000
        lat = np.deg2rad(47.0 + rng.random(n) * 0.01)
        lon = np.deg2rad(8.0 + rng.random(n) * 0.01)
        ecef = wgs84.geodetic_to_ecef(lat, lon, rng.random(n) * 50.0)
        directory = os.path.join({str(tmp_path)!r}, "site")
        build_octree(directory, 0.01, PointsBatch(position=ecef, attributes={{
            "color": rng.integers(0, 256, (n, 3), dtype=np.uint8)}}),
            device="cpu")
        mid = ecef.mean(axis=0)
        tokens = ",".join(s2.token(int(c)) for c in s2.parent(
            s2.leaf_cell_ids_from_points(ecef[::5000]), 16))
        z = 17
        nw = lat_lng_to_web_mercator(np.deg2rad(47.007),
                                     np.deg2rad(8.002)) * (256 << z)
        se = lat_lng_to_web_mercator(np.deg2rad(47.002),
                                     np.deg2rad(8.006)) * (256 << z)
        flags = [["--aabb", ",".join(str(float(v)) for v in
                                     [*(mid - 300.0), *(mid + 200.0)])],
                 ["--cell_union", tokens],
                 ["--web_mercator_rect",
                  ",".join(str(float(v)) for v in [*nw, *se]) + f",{{z}}"]]
        counts = []
        for extra in flags:
            said = []
            for route in (["--device", "cpu"], ["--no-device_filter"]):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    assert query([directory, *extra, *route]) == 0
                said.append(int(re.search(r"Streamed (\\d+)",
                                          buf.getvalue()).group(1)))
            assert said[0] == said[1] and 0 < said[0] < n, (extra, said)
            counts.append(said[0])
        frame = Isometry(np.eye(3), mid)
        q = PointQuery(attributes=["color"],
                       location=Obb(frame, np.array([250.0, 150.0, 40.0])))
        got = []
        for kwargs in ({{"device": "cpu"}}, {{"device_filter": False}}):
            client = PointCloudClient.from_locations([directory], **kwargs)
            pos = np.concatenate([b.position for b in client.stream(q)])
            got.append(pos[np.lexsort(pos.T)])
        assert got[0].tobytes() == got[1].tobytes() and len(got[0])
        assert_nothing_refused_loaded()
        print("query counts", counts, len(got[0]))
    """)
    assert "query counts" in out


def test_xray_clis_stand_alone(tmp_path):
    """With jax and the JAX package refused, the four x-ray CLIs on a tiny
    octree built by the port: cli.build_xray_quadtree with --device cpu in
    every strategy (and its numpy route), partial builds of the four
    level-1 quadrants merged by cli.merge_xray_quadtrees into the full
    build's node set, cli.inpaint_xray_quadtree and
    cli.upgrade_xray_quadtree on the full build; every tile decodes.  The
    lazy imports inside the x-ray modules run here, so one of the JAX
    package left behind would show."""
    out = _run_refused(f"""
        import os

        import numpy as np
        from PIL import Image
        from point_cloud_viewer_tpu_torch.cli.build_xray_quadtree import (
            main as build)
        from point_cloud_viewer_tpu_torch.cli.inpaint_xray_quadtree import (
            main as inpaint)
        from point_cloud_viewer_tpu_torch.cli.merge_xray_quadtrees import (
            main as merge)
        from point_cloud_viewer_tpu_torch.cli.upgrade_xray_quadtree import (
            main as upgrade)
        from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
        from point_cloud_viewer_tpu_torch.octree.builder import build_octree
        from point_cloud_viewer_tpu_torch.xray.meta import XrayMeta

        rng = np.random.default_rng(12)
        n = 30_000
        tmp = {str(tmp_path)!r}
        cloud = os.path.join(tmp, "cloud")
        build_octree(cloud, 0.001, PointsBatch(
            position=rng.random((n, 3)) * [4.0, 4.0, 1.0], attributes={{
                "color": rng.integers(0, 256, (n, 3), dtype=np.uint8),
                "intensity": rng.random(n, dtype=np.float32)}}),
            device="cpu")
        common = [cloud, "--tile_size", "64", "--resolution", "0.05",
                  "--num_threads", "2"]
        strategies = {{
            "xray": [], "colored": ["--binning", "intensity=0.25"],
            "colored_with_intensity": ["--min_intensity", "-1",
                                       "--max_intensity", "1"],
            "colored_with_height_stddev": ["--max_stddev", "0.5"]}}
        for kind, extra in strategies.items():
            for route in (["--device", "cpu"],
                          ["--no-use_device", "--no-device_filter"]):
                d = os.path.join(tmp, kind + route[0])
                assert build([*common, "--coloring_strategy", kind, *extra,
                              *route, "--output_directory", d]) == 0
        full = os.path.join(tmp, "xray--device")
        parts = []
        for q in range(4):
            parts.append(os.path.join(tmp, f"part{{q}}"))
            assert build([*common, "--device", "cpu", "--root_node_id",
                          f"r{{q}}", "--output_directory", parts[-1]]) == 0
        merged = os.path.join(tmp, "merged")
        assert merge([*parts, "--output_directory", merged]) == 0
        assert XrayMeta.from_directory(merged).nodes == (
            XrayMeta.from_directory(full).nodes)
        painted = os.path.join(tmp, "inpainted")
        assert inpaint([full, "--output_directory", painted,
                        "--num_threads", "2"]) == 0
        assert upgrade([full]) == 0
        tiles = 0
        for d in (full, merged, painted):
            for name in os.listdir(d):
                if name.endswith(".png"):
                    assert np.asarray(Image.open(os.path.join(d, name))
                                      ).shape == (64, 64, 4)
                    tiles += 1
        assert_nothing_refused_loaded()
        print("xray tiles", tiles)
    """)
    assert "xray tiles" in out


def test_viewers_and_servers_stand_alone(tmp_path):
    """With jax and the JAX package refused: run_headless(use_gl=True)
    where a GL driver exists, run_windowed through SdlBackend over the
    port's libSDL2 stub (its cull on device="cpu"), and both web servers
    answering on port 0 -- every lazy import inside them runs here."""
    out = _run_refused(f"""
        import json, os, threading, urllib.request

        import numpy as np
        from point_cloud_viewer_tpu_torch import native
        from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
        from point_cloud_viewer_tpu_torch.octree.builder import build_octree
        from point_cloud_viewer_tpu_torch.query.client import PointCloudClient
        from point_cloud_viewer_tpu_torch.viewer import gl, web_backend
        from point_cloud_viewer_tpu_torch.viewer.render_loop import (
            run_headless)
        from point_cloud_viewer_tpu_torch.viewer.sdl_shell import (
            SdlBackend, run_windowed)
        from point_cloud_viewer_tpu_torch.xray import backend
        from point_cloud_viewer_tpu_torch.xray.build import (
            XrayParameters, build_xray_quadtree)

        rng = np.random.default_rng(4)
        n = 20_000
        tmp = {str(tmp_path)!r}
        tree = os.path.join(tmp, "tree")
        build_octree(tree, 0.001, PointsBatch(
            position=rng.random((n, 3)) * [8.0, 8.0, 2.0], attributes={{
                "color": rng.integers(0, 256, (n, 3), dtype=np.uint8)}}),
            device="cpu")
        said = []
        if gl.available():
            shot = os.path.join(tmp, "gl.png")
            run_headless(tree, num_frames=3, width=64, height=48,
                         screenshot_path=shot, use_gl=True, device="cpu")
            said.append("gl %d" % os.path.getsize(shot))
        stats = run_windowed(tree, backend=SdlBackend(
            64, 48, lib_path=native.sdl2_stub_path()), width=64, height=48,
            cache_size_mb=10, max_frames=3, device="cpu")
        said.append("window %d" % stats.visible_nodes)
        xdir = os.path.join(tmp, "xray")
        build_xray_quadtree("xray", XrayParameters(
            xdir, PointCloudClient.from_locations([tree], device="cpu"),
            tile_size_px=64, pixel_size_m=0.05),
            strategy_kwargs={{"device": "cpu"}}, num_threads=1)
        servers = [web_backend.make_server(web_backend.AppState(
            prefix=tmp, init_octree_id="tree"), port=0),
            backend.make_server(xdir, port=0)]
        for s in servers:
            threading.Thread(target=s.serve_forever, daemon=True).start()
        web, xray = ("http://127.0.0.1:%d" % s.server_address[1]
                     for s in servers)
        ident = ",".join(str(float(v)) for v in np.eye(4).T.reshape(-1) * 0.1)
        names = json.loads(urllib.request.urlopen(
            web + "/visible_nodes/tree/?matrix=" + ident).read())
        blob = urllib.request.urlopen(urllib.request.Request(
            web + "/nodes_data/tree/", data=json.dumps(names).encode())).read()
        meta = json.loads(urllib.request.urlopen(xray + "/meta").read())
        png = urllib.request.urlopen(xray + "/node_image/r").read()
        for s in servers:
            s.shutdown()
            s.server_close()
        assert names and blob and meta["tile_size"] == 64
        assert png[:8] == b"\\x89PNG\\r\\n\\x1a\\n"
        said.append("served %d nodes" % len(names))
        assert_nothing_refused_loaded()
        print(*said)
    """)
    assert "window" in out and "served" in out
