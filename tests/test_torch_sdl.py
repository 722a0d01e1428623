"""The port's windowed shell (viewer/sdl_shell.py, viewer/input.py) against
the JAX package's: the event bindings of tests/test_sdl_shell.py applied
through both packages' dispatch_event give the same camera and renderer
states, frame by frame, and the same poses.json bytes (tolerance 0: both
run the same float64 numpy arithmetic); the ctypes marshalling cases of
tests/test_sdl_stub.py against the port's copy of the libSDL2 stub
(native/sdl2_stub.cpp, built by native.sdl2_stub_path) record the same
calls and decode the same events as the JAX backend against the JAX
source; the joystick mappings give the same camera motion; run_windowed
presents, polls and quits through a FakeBackend and through the stub with
its cull on device="cpu"; cli.view --window exits 2 without libSDL2."""

import ctypes
import importlib
import os
import subprocess
from dataclasses import asdict

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _packages():
    out = []
    for pkg in ("point_cloud_viewer_tpu_torch", "point_cloud_viewer_tpu"):
        mods = {n.split(".")[-1]: importlib.import_module(f"{pkg}.{n}")
                for n in ("viewer.sdl_shell", "viewer.camera", "viewer.input",
                          "viewer.render_loop", "octree.octree")}
        out.append(type("Mods", (), mods))
    return out


P, J = _packages()


@pytest.fixture(scope="module")
def octree_dir(tmp_path_factory):
    """tests/test_sdl_stub.py's cloud (20,000 points in a 10 m box),
    built by the port on the CPU."""
    from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
    from point_cloud_viewer_tpu_torch.octree.builder import build_octree

    rng = np.random.default_rng(11)
    n = 20_000
    out = str(tmp_path_factory.mktemp("shellcloud") / "oct")
    build_octree(out, 0.001, PointsBatch(
        position=rng.random((n, 3)) * 10.0,
        attributes={"color": rng.integers(30, 255, (n, 3), dtype=np.uint8)}),
        device="cpu")
    return out


# -- dispatch_event: the same states through both packages ------------------

def _keys(*keys, **mods):
    return [[("KeyDown", (k,), mods)] for k in keys]


# Each script is a list of frames; a frame is the events dispatched before
# one camera.update(1/60).
_SCRIPTS = {
    "move_and_turn": [
        frame for key in ("w", "s", "a", "d", "z", "q", "left", "right",
                          "up", "down")
        for frame in ([("KeyDown", (key,), {})], [],
                      [("KeyUp", (key,), {})])],
    "display_and_ct": _keys("o", "7", "8", "8", "9", "0", "t", "u", "i", "j",
                            "k", "t", "o"),
    "pose_slots": [
        *_keys("3", ctrl=True, shift=True), *_keys("w"), [],
        [("KeyUp", ("w",), {})], *_keys("3", ctrl=True),
        *_keys("5", ctrl=True), *_keys("0", ctrl=True, shift=True),
        *_keys("w", shift=True), [], *_keys("0", ctrl=True)],
    "mouse_wheel_resize": [
        [("MouseMotion", (15, 0), {"left": True})],
        [("MouseMotion", (0, 10), {"right": True})],
        [("MouseMotion", (3, -7), {})],
        [("MouseWheel", (2,), {}), ("MouseWheel", (-1,), {})],
        [("Resize", (640, 480), {})], *_keys("d"), []],
    "escape_and_quit": [*_keys("escape"), [("Quit", (), {})], *_keys("w")],
}


def _camera_state(cam, renderer):
    return {
        "position": np.asarray(cam.position, np.float64).tobytes(),
        "angles": (cam.theta, cam.phi, cam.movement_speed),
        "flags": (dict(cam.moving), dict(cam.turning), cam.ct_mode,
                  cam.ct_near, cam.ct_far, cam.width, cam.height),
        "world_to_gl": cam.world_to_gl().tobytes(),
        "renderer": (renderer.gamma, renderer.point_size,
                     renderer.show_octree_nodes, renderer.width,
                     renderer.height),
    }


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_dispatch_event_states_match_jax(tmp_path, octree_dir, script):
    sides = []
    for M, name in ((P, "port"), (J, "jax")):
        octree = M.octree.Octree.from_directory(octree_dir)
        kwargs = {"device": "cpu"} if M is P else {}
        renderer = M.render_loop.PointCloudRenderer(
            octree, cache_size_mb=10, width=320, height=240, **kwargs)
        camera = M.camera.Camera(320, 240)
        camera.position = np.array([5.0, -2.0, 9.0])
        camera.theta, camera.phi = 0.3, 0.7
        os.makedirs(tmp_path / name)
        poses = M.camera.PoseStore(str(tmp_path / name / "poses.json"))
        sides.append((M, camera, renderer, poses))
    try:
        for step in _SCRIPTS[script]:
            states, results = [], []
            for M, camera, renderer, poses in sides:
                for kind, args, kwargs in step:
                    event = getattr(M.sdl_shell, kind)(*args, **kwargs)
                    results.append(M.sdl_shell.dispatch_event(
                        event, camera, renderer, poses))
                camera.update(1 / 60)
                states.append(_camera_state(camera, renderer))
            half = len(results) // 2
            assert results[:half] == results[half:]
            assert states[0] == states[1], step
    finally:
        for _, _, renderer, _ in sides:
            renderer.shutdown()
    files = [tmp_path / name / "poses.json" for name in ("port", "jax")]
    assert [f.exists() for f in files] == [script == "pose_slots"] * 2
    if script == "pose_slots":
        assert files[0].read_bytes() == files[1].read_bytes()
        camera = sides[0][1]
        np.testing.assert_array_equal(camera.position, [5.0, -2.0, 9.0])
    if script == "display_and_ct":
        renderer = sides[0][2]
        assert renderer.gamma == pytest.approx(1.1)
        assert renderer.point_size == pytest.approx(2.0)
        assert renderer.show_octree_nodes is False


@pytest.mark.parametrize("name", ["Xbox Wireless Controller", "SpaceMouse"])
def test_joystick_mappings_match_jax(name):
    axes = [1200, -20000, 300, 12345, -4000, 900]
    states = []
    for M in (P, J):
        camera = M.camera.Camera(320, 240)
        mapping = M.input.joystick_for_name(name)
        for _ in range(3):
            mapping.act(camera, axes)
            camera.update(1 / 30)
        states.append((mapping.kind, camera.position.tobytes(), camera.theta,
                       camera.phi))
    assert states[0] == states[1]


# -- the ctypes layer against the stub --------------------------------------

_KMOD_LSHIFT = 0x0001
_KMOD_LCTRL = 0x0040
_SC = {"w": 26, "1": 30, "3": 32, "escape": 41, "left": 80}
_COUNTERS = ("init_flags", "window_w", "window_h", "window_flags",
             "textures_created", "textures_destroyed", "tex_w", "tex_h",
             "tex_access", "update_count", "last_pitch", "render_clear",
             "render_copy", "render_present", "renderer_destroyed",
             "window_destroyed", "quit_called", "axis_calls",
             "joystick_closed")


@pytest.fixture(scope="module")
def stubs(tmp_path_factory):
    """(port stub, JAX stub): the port's copy built by sdl2_stub_path, the
    JAX source built as tests/test_sdl_stub.py builds it."""
    from point_cloud_viewer_tpu_torch import native

    jax_so = str(tmp_path_factory.mktemp("sdlstub") / "libsdl2_stub.so")
    subprocess.run(
        ["g++", "-shared", "-fPIC", "-O1", "-o", jax_so,
         os.path.join(_REPO, "point_cloud_viewer_tpu", "native",
                      "sdl2_stub.cpp")],
        check=True, capture_output=True)
    return native.sdl2_stub_path(), jax_so


def _control(path):
    lib = ctypes.CDLL(path)
    lib.pcv_stub_get.restype = ctypes.c_int
    lib.pcv_stub_get.argtypes = [ctypes.c_char_p]
    lib.pcv_stub_pixel_sum.restype = ctypes.c_uint64
    lib.pcv_stub_tex_format.restype = ctypes.c_uint64
    lib.pcv_stub_window_title.restype = ctypes.c_char_p
    lib.pcv_stub_set_joystick.argtypes = [ctypes.c_char_p]
    lib.pcv_stub_set_axis.argtypes = [ctypes.c_int, ctypes.c_int16]
    lib.pcv_stub_reset()
    return lib


def _record(stub):
    out = {c: stub.pcv_stub_get(c.encode()) for c in _COUNTERS}
    out["pixel_sum"] = stub.pcv_stub_pixel_sum()
    out["tex_format"] = stub.pcv_stub_tex_format()
    out["title"] = stub.pcv_stub_window_title()
    return out


def _events(events):
    return [(type(e).__name__, asdict(e)) for e in events]


def _case_init_and_window(M, stub, path):
    backend = M.sdl_shell.SdlBackend(640, 400, lib_path=path)
    backend.close()
    got = _record(stub)
    assert got["init_flags"] == 0x20 | 0x200
    assert (got["window_w"], got["window_h"]) == (640, 400)
    assert got["window_flags"] == 0x4 | 0x20
    assert got["title"] == b"point_cloud_viewer_tpu"
    assert (got["window_destroyed"], got["renderer_destroyed"],
            got["quit_called"]) == (1, 1, 1)
    return got


def _case_init_failure(M, stub, path):
    stub.pcv_stub_set_init_result(1)
    with pytest.raises(RuntimeError, match="stub-injected failure") as e:
        M.sdl_shell.SdlBackend(100, 100, lib_path=path)
    return str(e.value)


def _case_event_marshalling(M, stub, path):
    backend = M.sdl_shell.SdlBackend(320, 240, lib_path=path)
    try:
        stub.pcv_stub_push_keydown(_SC["w"], 0)
        stub.pcv_stub_push_keydown(_SC["3"], _KMOD_LCTRL | _KMOD_LSHIFT)
        stub.pcv_stub_push_keydown(_SC["left"], 0)
        stub.pcv_stub_push_keydown(100, 0)  # unbound scancode: dropped
        stub.pcv_stub_push_keyup(_SC["w"])
        stub.pcv_stub_push_mousemotion(1, 50, 60, 15, -4)
        stub.pcv_stub_push_mousemotion(4, 51, 61, -2, 7)
        stub.pcv_stub_push_wheel(-3)
        stub.pcv_stub_push_windowevent(6, 800, 450)
        stub.pcv_stub_push_windowevent(1, 9, 9)
        stub.pcv_stub_push_quit()
        events = backend.poll_events()
        S = M.sdl_shell
        assert events == [
            S.KeyDown("w"), S.KeyDown("3", ctrl=True, shift=True),
            S.KeyDown("left"), S.KeyUp("w"), S.MouseMotion(15, -4, left=True),
            S.MouseMotion(-2, 7, right=True), S.MouseWheel(-3),
            S.Resize(800, 450), S.Quit()]
        assert backend.poll_events() == []
    finally:
        backend.close()
    return _events(events)


def _case_present_uploads(M, stub, path):
    backend = M.sdl_shell.SdlBackend(320, 240, lib_path=path)
    records = []
    try:
        img = np.arange(120 * 160 * 4, dtype=np.uint32).astype(np.uint8)
        backend.present(img.reshape(120, 160, 4))
        records.append(_record(stub))
        assert records[-1]["pixel_sum"] == int(img.sum())
        assert records[-1]["tex_format"] == 0x16762004
        backend.present(np.full((60, 80, 4), 7, dtype=np.uint8))
        records.append(_record(stub))
        assert (records[-1]["textures_created"],
                records[-1]["textures_destroyed"]) == (2, 1)
    finally:
        backend.close()
    records.append(_record(stub))
    assert records[-1]["textures_destroyed"] == 2
    return records


def _case_joystick_axes(M, stub, path):
    stub.pcv_stub_set_joystick(b"Xbox Wireless Controller")
    stub.pcv_stub_set_axis(1, -20000)
    stub.pcv_stub_set_axis(3, 12345)
    backend = M.sdl_shell.SdlBackend(320, 240, lib_path=path)
    try:
        (name, axes_fn), = backend.joysticks()
        axes = axes_fn()
        assert (name, axes) == ("Xbox Wireless Controller",
                                [0, -20000, 0, 12345, 0, 0])
    finally:
        backend.close()
    assert stub.pcv_stub_get(b"joystick_closed") == 1
    return name, axes, _record(stub)


_STUB_CASES = {
    "init_and_window": _case_init_and_window,
    "init_failure": _case_init_failure,
    "event_marshalling": _case_event_marshalling,
    "present_uploads": _case_present_uploads,
    "joystick_axes": _case_joystick_axes,
}


@pytest.mark.parametrize("case", sorted(_STUB_CASES))
def test_stub_marshalling_matches_jax(stubs, case):
    got = []
    for M, path in zip((P, J), stubs):
        got.append(_STUB_CASES[case](M, _control(path), path))
    assert got[0] == got[1]


def test_run_windowed_through_the_stub(stubs, octree_dir):
    """The whole loop on the real SdlBackend over the port's stub, culling
    on device="cpu": scripted C events (W, a pose save, escape), one
    present per frame, the joystick's six axes polled once a frame, the
    pose saved, clean teardown."""
    path = stubs[0]
    stub = _control(path)
    stub.pcv_stub_set_joystick(b"Xbox Wireless Controller")
    stub.pcv_stub_push_keydown(_SC["w"], 0)
    stub.pcv_stub_push_frame_end()
    stub.pcv_stub_push_keyup(_SC["w"])
    stub.pcv_stub_push_keydown(_SC["1"], _KMOD_LCTRL | _KMOD_LSHIFT)
    stub.pcv_stub_push_frame_end()
    stub.pcv_stub_push_keydown(_SC["escape"], 0)
    pose_path = os.path.join(octree_dir, "poses.json")
    try:
        stats = P.sdl_shell.run_windowed(
            octree_dir, backend=P.sdl_shell.SdlBackend(160, 120,
                                                       lib_path=path),
            width=160, height=120, cache_size_mb=10, device="cpu")
        got = _record(stub)
        assert (got["render_present"], got["update_count"]) == (3, 3)
        assert got["axis_calls"] == 3 * 6
        assert got["last_pitch"] == 160 * 4
        assert stats.visible_nodes >= 0
        assert os.path.exists(pose_path)
        assert (got["quit_called"], got["window_destroyed"]) == (1, 1)
    finally:
        if os.path.exists(pose_path):
            os.remove(pose_path)


class FakeBackend:
    """tests/test_sdl_shell.py's scripted backend."""

    def __init__(self, frames, joystick_specs=()):
        self.frames = list(frames)
        self.presented = []
        self.closed = False
        self._joysticks = list(joystick_specs)

    def poll_events(self):
        return self.frames.pop(0) if self.frames else []

    def joysticks(self):
        return list(self._joysticks)

    def present(self, image):
        self.presented.append(np.asarray(image))

    def close(self):
        self.closed = True


@pytest.mark.parametrize("case", ["quit_after_save", "max_frames",
                                  "joystick", "gl"])
def test_run_windowed_fake_backend(octree_dir, case):
    S = P.sdl_shell
    calls = {"n": 0}

    def axes():
        calls["n"] += 1
        return [0, -20000, 0, 0, 0, 0]

    frames, joy, kwargs = [], [], {}
    if case == "quit_after_save":
        frames = [[S.KeyDown("w")],
                  [S.KeyUp("w"), S.KeyDown("1", ctrl=True, shift=True)],
                  [S.KeyDown("escape")], []]
    elif case == "max_frames":
        kwargs = {"max_frames": 2}
    elif case == "joystick":
        frames = [[], [], [S.KeyDown("escape")]]
        joy = [("Xbox Wireless Controller", axes)]
    else:
        from point_cloud_viewer_tpu_torch.viewer import gl

        if not gl.available():
            pytest.skip("no EGL/GL driver available")
        frames = [[S.KeyDown("0")], [S.Quit()]]
        kwargs = {"use_gl": True}
    backend = FakeBackend(frames, joy)
    pose_path = os.path.join(octree_dir, "poses.json")
    try:
        stats = S.run_windowed(octree_dir, backend=backend, width=160,
                               height=120, cache_size_mb=10, device="cpu",
                               **kwargs)
    finally:
        saved = os.path.exists(pose_path)
        if saved:
            os.remove(pose_path)
    assert backend.closed and stats is not None
    want = {"quit_after_save": 3, "max_frames": 2, "joystick": 3, "gl": 2}
    assert len(backend.presented) == want[case]
    assert all(img.shape == (120, 160, 4) for img in backend.presented)
    assert saved == (case == "quit_after_save")
    if case == "joystick":
        assert calls["n"] == 3


def test_sdl_backend_without_library_raises():
    with pytest.raises(RuntimeError, match="SDL"):
        P.sdl_shell.SdlBackend(100, 100, lib_path="libSDL2-absent.so.0")


@pytest.mark.parametrize("flag", ["--window", "--gl"])
def test_cli_view_refuses_without_its_library(octree_dir, flag, monkeypatch,
                                              capsys):
    """--window without libSDL2 exits 2 with the JAX package's message;
    --gl without a GL driver exits 2 and renders nothing in software."""
    from point_cloud_viewer_tpu.cli import view as jax_view
    from point_cloud_viewer_tpu_torch.cli import view
    from point_cloud_viewer_tpu_torch.viewer import gl
    from point_cloud_viewer_tpu_torch.viewer import render_loop

    monkeypatch.setattr(P.input, "sdl_available", lambda: False)
    monkeypatch.setattr(gl, "available", lambda: False)
    monkeypatch.setattr(render_loop, "run_headless", None)
    assert view.main([octree_dir, "--device", "cpu", flag]) == 2
    said = capsys.readouterr().err
    if flag == "--window":
        monkeypatch.setattr(J.input, "sdl_available", lambda: False)
        assert jax_view.main([octree_dir, flag]) == 2
        assert said == capsys.readouterr().err
    else:
        assert "--gl needs an EGL/OpenGL driver" in said


@pytest.mark.parametrize("entry", ["sdl_shell.run_windowed",
                                   "gl.viewer.GlPointCloudRenderer",
                                   "render_loop.run_headless"])
def test_viewer_entry_points_cull_on_the_card_by_default(entry,
                                                         monkeypatch,
                                                         octree_dir):
    """device_cull=True and device="cuda" by default (the JAX signatures
    cull on the host by default: a documented difference of defaults);
    without a card the windowed shell raises rather than culling on the
    host."""
    import inspect

    import torch

    module, name = entry.rsplit(".", 1)
    fn = getattr(importlib.import_module(
        f"point_cloud_viewer_tpu_torch.viewer.{module}"), name)
    params = inspect.signature(fn).parameters
    assert params["device_cull"].default is True
    assert params["device"].default == "cuda"
    if entry == "sdl_shell.run_windowed":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            fn(octree_dir, backend=FakeBackend([]), max_frames=1)
