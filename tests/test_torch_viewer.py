"""The PyTorch port's headless viewer (point_cloud_viewer_tpu_torch/
viewer/render_loop.py, cli/view.py) with its device cull on the CPU
(`device="cpu"`: K5's plain version) against the JAX package's renderer.

The visible node SET must equal the JAX host renderer's for the same
camera (display order may permute among screen-size near-ties: f32 device
vs f64 host, as tests/test_viewer.py:132-163 states).  A failing device
cull raises from draw/shutdown and never turns into host culling.
"""

import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from point_cloud_viewer_tpu.core.points_batch import PointsBatch
from point_cloud_viewer_tpu.octree.builder import build_octree
from point_cloud_viewer_tpu.octree.octree import Octree
from point_cloud_viewer_tpu.viewer.camera import Camera
from point_cloud_viewer_tpu.viewer.render_loop import (
    PointCloudRenderer as JaxRenderer,
)
from point_cloud_viewer_tpu_torch.cli.view import main as view_main
from point_cloud_viewer_tpu_torch.octree.octree import Octree as PortOctree
from point_cloud_viewer_tpu_torch.viewer.render_loop import (
    PointCloudRenderer,
    run_headless,
    write_png,
)

BACKGROUND = np.array([17, 17, 20, 255])


@pytest.fixture(scope="module")
def octree_dir(tmp_path_factory):
    """tests/test_viewer.py:85-98."""
    rng = np.random.default_rng(11)
    n = 120_000
    batch = PointsBatch(
        position=rng.random((n, 3)) * 10.0,
        attributes={
            "color": rng.integers(30, 255, (n, 3), dtype=np.uint8),
            "intensity": rng.random(n).astype(np.float32),
        },
    )
    out = str(tmp_path_factory.mktemp("viewcloud"))
    build_octree(out, 0.001, batch)
    return out


def _matrix():
    cam = Camera(640, 480)
    cam.position = np.array([5.0, 5.0, 25.0])
    return cam.world_to_gl()


def _wait_visible(renderers, deadline_s=60.0):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if all(r._visible for r in renderers):
            break
        time.sleep(0.02)
    out = []
    for r in renderers:
        with r._visible_lock:
            out.append(list(r._visible))
    return out


def test_device_cull_on_cpu_matches_jax_host_and_device(octree_dir):
    octree = Octree.from_directory(octree_dir)
    matrix = _matrix()
    host = JaxRenderer(octree, width=640, height=480)
    jax_dev = JaxRenderer(octree, width=640, height=480, device_cull=True)
    port = PointCloudRenderer(PortOctree.from_directory(octree_dir),
                              width=640, height=480, device_cull=True,
                              device="cpu")
    try:
        assert port._cull_session.device == torch.device("cpu")
        for r in (host, jax_dev, port):
            r.camera_changed(matrix)
        host_ids, jax_ids, port_ids = _wait_visible([host, jax_dev, port])
        assert host_ids, "host path saw nothing: bad fixture"
        # Each package's NodeIds over its own octree: equal by value.
        port_values = {n.value for n in port_ids}
        assert port_values == {n.value for n in host_ids}
        assert port_values == {n.value for n in jax_ids}
        assert len(port_ids) == len(set(port_ids))
    finally:
        for r in (host, jax_dev, port):
            r.shutdown()


def test_device_cull_error_raises_and_never_falls_back(octree_dir):
    octree = Octree.from_directory(octree_dir)
    port = PointCloudRenderer(octree, width=160, height=120,
                              device_cull=True, device="cpu")

    def broken(frustum, cap):
        raise RuntimeError("cull kernel failed")

    port._cull_session.step_capped = broken  # the viewer's capped step
    port.camera_changed(_matrix())
    deadline = time.time() + 60
    while port._cull_error is None and time.time() < deadline:
        time.sleep(0.02)
    with pytest.raises(RuntimeError, match="cull kernel failed"):
        port.draw(_matrix())
    assert port.device_cull  # no switch to host culling
    assert port._visible == []
    with pytest.raises(RuntimeError, match="cull kernel failed"):
        port.shutdown()


def test_bad_camera_matrix_skips_the_frame(octree_dir):
    """A singular or non-finite matrix is skipped as in the JAX package;
    the next good matrix is culled on the device."""
    octree = PortOctree.from_directory(octree_dir)
    port = PointCloudRenderer(octree, width=160, height=120,
                              device_cull=True, device="cpu")
    try:
        port.camera_changed(np.zeros((4, 4)))
        time.sleep(0.3)
        port.camera_changed(np.full((4, 4), np.nan))
        time.sleep(0.3)
        assert port._cull_error is None and port._visible == []
        port.camera_changed(_matrix())
        (ids,) = _wait_visible([port])
        assert ids
        stats, _ = port.draw(_matrix())
        assert stats.visible_nodes == len(ids)
    finally:
        port.shutdown()


def test_renderer_asks_for_cuda_explicitly(octree_dir, monkeypatch):
    octree = Octree.from_directory(octree_dir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        PointCloudRenderer(octree, device_cull=True)  # device="cuda"


def test_run_headless_device_cull_on_cpu(octree_dir, tmp_path, monkeypatch):
    shot = str(tmp_path / "frame.png")
    stats = run_headless(octree_dir, num_frames=8, width=320, height=240,
                         screenshot_path=shot, device_cull=True,
                         device="cpu")
    assert stats.visible_nodes > 0 and stats.points_drawn > 0
    img = np.asarray(Image.open(shot))
    assert img.shape == (240, 320, 4)
    assert (img != BACKGROUND).any(axis=2).sum() > 1000
    # The GL path culls on the card by default too: without a card (or
    # without a GL driver) it raises rather than culling on the host.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, OSError)):
        run_headless(octree_dir, num_frames=1, use_gl=True,
                     screenshot_path=str(tmp_path / "never.png"))
    assert not os.path.exists(tmp_path / "never.png")


def test_cli_view_device_cull_cpu(octree_dir, tmp_path, capsys):
    shot = str(tmp_path / "cli.png")
    rc = view_main([octree_dir, "--device", "cpu", "--device_cull",
                    "--frames", "5", "--width", "200", "--height", "150",
                    "--screenshot", shot])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("Final frame: ") and shot in out
    img = np.asarray(Image.open(shot))
    assert img.shape == (150, 200, 4)
    assert (img != BACKGROUND).any(axis=2).any()


@pytest.mark.parametrize("flag", ["--gl", "--window"])
def test_cli_view_unported_flags_exit_2(octree_dir, tmp_path, flag, capsys,
                                        monkeypatch):
    """--gl and --window are ported; without their library (no GL driver,
    no libSDL2) each exits 2 with a clear error and draws nothing."""
    from point_cloud_viewer_tpu_torch.viewer import gl, input as shell_input

    monkeypatch.setattr(gl, "available", lambda: False)
    monkeypatch.setattr(shell_input, "sdl_available", lambda: False)
    shot = str(tmp_path / "never.png")
    assert view_main([octree_dir, flag, "--screenshot", shot]) == 2
    said = capsys.readouterr().err
    assert ("--gl needs an EGL/OpenGL driver" if flag == "--gl"
            else "--window needs libSDL2") in said
    assert not os.path.exists(shot)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (120, 160)])
def test_write_png_decodes_to_the_image(tmp_path, shape):
    rng = np.random.default_rng(shape[0])
    image = rng.integers(0, 256, (*shape, 4), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, image)
    decoded = Image.open(path)
    assert decoded.mode == "RGBA"
    np.testing.assert_array_equal(np.asarray(decoded), image)
