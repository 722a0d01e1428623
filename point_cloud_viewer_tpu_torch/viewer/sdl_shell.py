"""Windowed SDL2 viewer shell — the reference's interactive application.

Reproduces `run::<Extension>()` (reference sdl_viewer/src/lib.rs:350-611):
an SDL window, the live event pump with the reference's exact key/mouse
bindings (lib.rs:480-591), per-frame joystick polling (lib.rs:588-591 via
the mappings in viewer/input.py = lib.rs:304-348), CTRL(+SHIFT)+0-9 camera
pose slots (lib.rs:249-294), and the frame loop driving the shared
PointCloudRenderer engine (visible-node thread, LRU cache, adaptive
budget — render_loop.py).

Architecture: the event loop is written against a tiny backend protocol
(`poll_events` / `joysticks` / `present` / `close`), so the binding logic
is pure and fully tested headless (tests/test_sdl_shell.py drives it with
a scripted FakeBackend).  `SdlBackend` implements the protocol over
libSDL2 through ctypes — no compiled bindings needed — and presents
frames through an SDL streaming texture, which works with both the
software rasterizer and the EGL GL pipeline (whose frames are read back
as RGBA).  This image ships no libSDL2/display, so the windowed shell is
environment-gated: `sdl_available()` (viewer/input.py) reports whether it
can run, and `cli.view --window` degrades with a clear error.

Deviation from the reference, recorded: the reference can only SAVE poses
when poses.json already existed at startup (lib.rs:395-400 sets pose_path
only if the file exists); here saving always works and creates the file —
strictly more capable, load semantics identical.

Copy of point_cloud_viewer_tpu/viewer/sdl_shell.py:1-460 on the port's
engine.  One difference of defaults, as the port's other entry points:
`run_windowed` culls on the card (`device_cull=True`, `device="cuda"`;
K5 once a frame) where the JAX signature culls on the host by default, and
passes `device` to the renderer.  The ABI stub the tests name is the port's
copy, native/sdl2_stub.cpp, built by native.sdl2_stub_path().
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .camera import Camera, PoseStore
from .input import joystick_for_name
from .render_loop import FrameStats, PointCloudRenderer


# -- shell events (backend-agnostic) ----------------------------------------
#
# Keys are semantic names ('w', 'left', '7', 'escape'); the SDL backend
# translates scancodes, a test backend emits them directly.


@dataclass(frozen=True)
class Quit:
    pass


@dataclass(frozen=True)
class KeyDown:
    key: str
    ctrl: bool = False
    shift: bool = False


@dataclass(frozen=True)
class KeyUp:
    key: str


@dataclass(frozen=True)
class MouseMotion:
    xrel: int
    yrel: int
    left: bool = False
    right: bool = False


@dataclass(frozen=True)
class MouseWheel:
    y: int


@dataclass(frozen=True)
class Resize:
    width: int
    height: int


_MOVE_KEYS = {  # reference lib.rs:489-494 / 556-561
    "w": "forward", "s": "backward", "a": "left",
    "d": "right", "z": "down", "q": "up",
}
_TURN_KEYS = {  # lib.rs:500-503 / 562-565
    "left": "left", "right": "right", "down": "down", "up": "up",
}
_DIGIT_TO_SLOT = {str((i + 1) % 10): i for i in range(10)}  # '1'->0 .. '0'->9


def dispatch_event(
    event, camera: Camera, renderer: PointCloudRenderer, poses: PoseStore
) -> bool:
    """Apply one shell event; returns False when the loop must exit.

    Bindings mirror the reference event match (sdl_viewer/src/lib.rs:
    481-587): unmodified keys move/turn/toggle, CTRL+digit loads a pose
    slot, CTRL+SHIFT+digit saves one, mouse-left drag rotates, mouse-right
    drag pans, the wheel scales movement speed, window resize reshapes the
    camera."""
    if isinstance(event, Quit):
        return False
    if isinstance(event, KeyDown):
        if event.ctrl and event.shift:
            slot = _DIGIT_TO_SLOT.get(event.key)
            if slot is not None:  # lib.rs:522-535
                poses.save(slot, camera.state())
            return True
        if event.ctrl:
            slot = _DIGIT_TO_SLOT.get(event.key)
            if slot is not None:  # lib.rs:537-551
                state = poses.load(slot)
                if state is not None:
                    camera.set_state(state)
            return True
        if event.shift:
            # Reference gates the unmodified bindings on keymod.is_empty()
            # (lib.rs:489): SHIFT+W / SHIFT+7 etc. must do nothing.
            return True
        key = event.key
        if key == "escape":
            return False
        if key in _MOVE_KEYS:
            camera.moving[_MOVE_KEYS[key]] = True
        elif key in _TURN_KEYS:
            camera.turning[_TURN_KEYS[key]] = True
        elif key == "t":  # lib.rs:495
            camera.toggle_ct_mode()
        elif key == "u":  # lib.rs:496-499
            camera.move_ct(-0.5)
        elif key == "i":
            camera.move_ct(0.5)
        elif key == "j":
            camera.move_far_plane_ct(-0.5)
        elif key == "k":
            camera.move_far_plane_ct(0.5)
        elif key == "o":  # lib.rs:504
            renderer.show_octree_nodes = not renderer.show_octree_nodes
        elif key == "7":  # lib.rs:505-508
            renderer.adjust_gamma(-0.1)
        elif key == "8":
            renderer.adjust_gamma(0.1)
        elif key == "9":
            renderer.adjust_point_size(-0.1)
        elif key == "0":
            renderer.adjust_point_size(0.1)
        return True
    if isinstance(event, KeyUp):
        if event.key in _MOVE_KEYS:
            camera.moving[_MOVE_KEYS[event.key]] = False
        elif event.key in _TURN_KEYS:
            camera.turning[_TURN_KEYS[event.key]] = False
        return True
    if isinstance(event, MouseMotion):  # lib.rs:566-577
        if event.left:
            camera.mouse_drag_rotate(event.xrel, event.yrel)
        elif event.right:
            camera.mouse_drag_pan(event.xrel, event.yrel)
        return True
    if isinstance(event, MouseWheel):  # lib.rs:578-580
        camera.mouse_wheel(event.y)
        return True
    if isinstance(event, Resize):  # lib.rs:581-586
        camera.set_size(event.width, event.height)
        renderer.resize(event.width, event.height)
        return True
    return True


# -- the loop ----------------------------------------------------------------


def run_windowed(
    octree_directory: str,
    backend=None,
    width: int = 800,
    height: int = 600,
    cache_size_mb: int = 2000,
    use_gl: bool = False,
    device_cull: bool = True,
    max_frames: Optional[int] = None,
    device="cuda",
) -> FrameStats:
    """The windowed viewer application loop (reference lib.rs:350-611).

    `backend=None` opens a real SDL window (requires libSDL2 + a display);
    tests inject a scripted backend.  `max_frames` bounds the loop for
    tests/automation; the interactive default runs until Quit/Escape.
    `device`: where the per-frame cull runs (with `device_cull`)."""
    from ..octree.octree import Octree

    if backend is None:
        backend = SdlBackend(width, height)
    octree = Octree.from_directory(octree_directory)
    camera = Camera(width, height)
    # Start looking at the cloud (the reference starts at the world origin,
    # which for ECEF data is inside the planet; framing the bbox is the
    # usable equivalent and matches run_headless' convention).
    center = octree.bounding_box.center()
    diag = float(np.linalg.norm(octree.bounding_box.diag()))
    camera.position = center + np.array([0.0, -diag, diag * 0.5])
    camera.phi = np.pi / 3

    if use_gl:
        from .gl.viewer import GlPointCloudRenderer

        renderer = GlPointCloudRenderer(
            octree, cache_size_mb=cache_size_mb, width=width, height=height,
            device_cull=device_cull, device=device,
        )
    else:
        renderer = PointCloudRenderer(
            octree, cache_size_mb=cache_size_mb, width=width, height=height,
            device_cull=device_cull, device=device,
        )
    poses = PoseStore(os.path.join(octree_directory, "poses.json"))
    joysticks: List[Tuple[object, Callable[[], Sequence[int]]]] = [
        (joystick_for_name(name), axes_fn) for name, axes_fn in backend.joysticks()
    ]

    stats = FrameStats()
    try:
        camera.moved = True  # draw the initial view without input
        last = time.perf_counter()
        frames = 0
        running = True
        while running and (max_frames is None or frames < max_frames):
            for event in backend.poll_events():
                if not dispatch_event(event, camera, renderer, poses):
                    running = False
            for mapping, axes_fn in joysticks:  # lib.rs:588-591
                mapping.act(camera, axes_fn())
            now = time.perf_counter()
            elapsed, last = now - last, now
            moved = camera.update(elapsed)  # lib.rs:592-599
            if moved:
                renderer.camera_changed(camera.world_to_gl())
            # moving=moved engages the reduced-LOD budget while navigating
            # (max_nodes_moving cap + point_size_lod prefix), the state the
            # adapt_budget FPS feedback below adjusts — same contract as
            # run_headless (render_loop.py) and the reference's draw().
            stats, image = renderer.draw(
                camera.world_to_gl(), moving=moved, render=True
            )
            if image is not None:
                backend.present(image)
            renderer.adapt_budget(moved)
            frames += 1
        return stats
    finally:
        renderer.shutdown()
        backend.close()


# -- SDL2 backend over ctypes -------------------------------------------------

# SDL_scancode.h values for the keys the reference binds.
_SCANCODES = {
    4: "a", 7: "d", 12: "i", 13: "j", 14: "k", 18: "o", 20: "q", 22: "s",
    23: "t", 24: "u", 26: "w", 29: "z",
    30: "1", 31: "2", 32: "3", 33: "4", 34: "5", 35: "6", 36: "7",
    37: "8", 38: "9", 39: "0",
    41: "escape", 79: "right", 80: "left", 81: "down", 82: "up",
}
_SDL_QUIT = 0x100
_SDL_WINDOWEVENT = 0x200
_SDL_KEYDOWN = 0x300
_SDL_KEYUP = 0x301
_SDL_MOUSEMOTION = 0x400
_SDL_MOUSEWHEEL = 0x403
_SDL_WINDOWEVENT_SIZE_CHANGED = 6
_KMOD_SHIFT = 0x0001 | 0x0002
_KMOD_CTRL = 0x0040 | 0x0080
_SDL_INIT_VIDEO = 0x20
_SDL_INIT_JOYSTICK = 0x200
_SDL_WINDOW_SHOWN = 0x4
_SDL_WINDOW_RESIZABLE = 0x20
_SDL_PIXELFORMAT_ABGR8888 = 0x16762004  # RGBA byte order in memory (LE)
_SDL_TEXTUREACCESS_STREAMING = 1


def _sdl_structs():
    """ctypes layouts for the SDL_Event variants we consume (SDL2 ABI)."""
    import ctypes

    class Keysym(ctypes.Structure):
        _fields_ = [("scancode", ctypes.c_int), ("sym", ctypes.c_int),
                    ("mod", ctypes.c_uint16), ("unused", ctypes.c_uint32)]

    class KeyboardEvent(ctypes.Structure):
        _fields_ = [("type", ctypes.c_uint32), ("timestamp", ctypes.c_uint32),
                    ("windowID", ctypes.c_uint32), ("state", ctypes.c_uint8),
                    ("repeat", ctypes.c_uint8), ("padding2", ctypes.c_uint8),
                    ("padding3", ctypes.c_uint8), ("keysym", Keysym)]

    class MouseMotionEvent(ctypes.Structure):
        _fields_ = [("type", ctypes.c_uint32), ("timestamp", ctypes.c_uint32),
                    ("windowID", ctypes.c_uint32), ("which", ctypes.c_uint32),
                    ("state", ctypes.c_uint32), ("x", ctypes.c_int32),
                    ("y", ctypes.c_int32), ("xrel", ctypes.c_int32),
                    ("yrel", ctypes.c_int32)]

    class MouseWheelEvent(ctypes.Structure):
        _fields_ = [("type", ctypes.c_uint32), ("timestamp", ctypes.c_uint32),
                    ("windowID", ctypes.c_uint32), ("which", ctypes.c_uint32),
                    ("x", ctypes.c_int32), ("y", ctypes.c_int32),
                    ("direction", ctypes.c_uint32)]

    class WindowEvent(ctypes.Structure):
        _fields_ = [("type", ctypes.c_uint32), ("timestamp", ctypes.c_uint32),
                    ("windowID", ctypes.c_uint32), ("event", ctypes.c_uint8),
                    ("padding1", ctypes.c_uint8), ("padding2", ctypes.c_uint8),
                    ("padding3", ctypes.c_uint8), ("data1", ctypes.c_int32),
                    ("data2", ctypes.c_int32)]

    return KeyboardEvent, MouseMotionEvent, MouseWheelEvent, WindowEvent


class SdlBackend:
    """Real SDL2 window + event pump + joystick poll via ctypes.

    Presents frames by streaming RGBA images into an SDL texture — one
    upload per frame, renderer-agnostic (software raster or EGL readback).
    Requires libSDL2 and a display; raises RuntimeError otherwise."""

    def __init__(self, width: int, height: int,
                 title: bytes = b"point_cloud_viewer_tpu",
                 lib_path: str = "libSDL2-2.0.so.0") -> None:
        """`lib_path` overrides the SDL library to load — production uses
        the system soname; tests point it at the scriptable ABI stub
        (native/sdl2_stub.cpp) so the real ctypes marshalling executes."""
        import ctypes

        try:
            lib = ctypes.CDLL(lib_path)
        except OSError as e:
            raise RuntimeError(
                "libSDL2 is not available in this environment; the windowed "
                "shell needs it (plus a display). Use cli.view's headless "
                "mode instead."
            ) from e
        self._ct = ctypes
        self.lib = lib
        lib.SDL_CreateWindow.restype = ctypes.c_void_p
        lib.SDL_CreateRenderer.restype = ctypes.c_void_p
        lib.SDL_CreateTexture.restype = ctypes.c_void_p
        lib.SDL_JoystickOpen.restype = ctypes.c_void_p
        lib.SDL_JoystickName.restype = ctypes.c_char_p
        lib.SDL_GetError.restype = ctypes.c_char_p
        lib.SDL_JoystickGetAxis.restype = ctypes.c_int16
        if lib.SDL_Init(_SDL_INIT_VIDEO | _SDL_INIT_JOYSTICK) != 0:
            raise RuntimeError(
                f"SDL_Init failed: {lib.SDL_GetError().decode()} "
                "(no display available?)"
            )
        self.window = lib.SDL_CreateWindow(
            title, ctypes.c_int(0x2FFF0000), ctypes.c_int(0x2FFF0000),  # CENTERED
            width, height, _SDL_WINDOW_SHOWN | _SDL_WINDOW_RESIZABLE,
        )
        if not self.window:
            raise RuntimeError(f"SDL window: {lib.SDL_GetError().decode()}")
        self.renderer = lib.SDL_CreateRenderer(
            ctypes.c_void_p(self.window), -1, 0
        )
        self._texture = None
        self._tex_size = (0, 0)
        self._structs = _sdl_structs()
        self._joysticks = []
        for idx in range(lib.SDL_NumJoysticks()):
            handle = lib.SDL_JoystickOpen(idx)
            if handle:
                name = (lib.SDL_JoystickName(ctypes.c_void_p(handle)) or b"").decode()
                self._joysticks.append((name, handle))

    # -- protocol ----------------------------------------------------------

    def poll_events(self):
        ct = self._ct
        Keyboard, Motion, Wheel, Window = self._structs
        buf = ct.create_string_buffer(64)  # SDL_Event is 56 bytes; headroom
        out = []
        while self.lib.SDL_PollEvent(ct.byref(buf)):
            etype = ct.cast(buf, ct.POINTER(ct.c_uint32)).contents.value
            if etype == _SDL_QUIT:
                out.append(Quit())
            elif etype in (_SDL_KEYDOWN, _SDL_KEYUP):
                ev = ct.cast(buf, ct.POINTER(Keyboard)).contents
                key = _SCANCODES.get(ev.keysym.scancode)
                if key is None:
                    continue
                if etype == _SDL_KEYDOWN:
                    out.append(KeyDown(
                        key,
                        ctrl=bool(ev.keysym.mod & _KMOD_CTRL),
                        shift=bool(ev.keysym.mod & _KMOD_SHIFT),
                    ))
                else:
                    out.append(KeyUp(key))
            elif etype == _SDL_MOUSEMOTION:
                ev = ct.cast(buf, ct.POINTER(Motion)).contents
                out.append(MouseMotion(
                    ev.xrel, ev.yrel,
                    left=bool(ev.state & 1), right=bool(ev.state & 4),
                ))
            elif etype == _SDL_MOUSEWHEEL:
                ev = ct.cast(buf, ct.POINTER(Wheel)).contents
                out.append(MouseWheel(ev.y))
            elif etype == _SDL_WINDOWEVENT:
                ev = ct.cast(buf, ct.POINTER(Window)).contents
                if ev.event == _SDL_WINDOWEVENT_SIZE_CHANGED:
                    out.append(Resize(ev.data1, ev.data2))
        return out

    def joysticks(self):
        ct = self._ct

        def axes_fn_for(handle):
            def axes():
                return [
                    self.lib.SDL_JoystickGetAxis(ct.c_void_p(handle), i)
                    for i in range(6)
                ]
            return axes

        return [(name, axes_fn_for(handle)) for name, handle in self._joysticks]

    def present(self, image: np.ndarray) -> None:
        ct = self._ct
        h, w = image.shape[:2]
        if self._texture is None or self._tex_size != (w, h):
            if self._texture:
                self.lib.SDL_DestroyTexture(ct.c_void_p(self._texture))
            self._texture = self.lib.SDL_CreateTexture(
                ct.c_void_p(self.renderer), _SDL_PIXELFORMAT_ABGR8888,
                _SDL_TEXTUREACCESS_STREAMING, w, h,
            )
            self._tex_size = (w, h)
        data = np.ascontiguousarray(image)
        self.lib.SDL_UpdateTexture(
            ct.c_void_p(self._texture), None,
            data.ctypes.data_as(ct.c_void_p), w * 4,
        )
        self.lib.SDL_RenderClear(ct.c_void_p(self.renderer))
        self.lib.SDL_RenderCopy(
            ct.c_void_p(self.renderer), ct.c_void_p(self._texture), None, None
        )
        self.lib.SDL_RenderPresent(ct.c_void_p(self.renderer))

    def close(self) -> None:
        ct = self._ct
        for _, handle in self._joysticks:
            self.lib.SDL_JoystickClose(ct.c_void_p(handle))
        if self._texture:
            self.lib.SDL_DestroyTexture(ct.c_void_p(self._texture))
        if self.renderer:
            self.lib.SDL_DestroyRenderer(ct.c_void_p(self.renderer))
        if self.window:
            self.lib.SDL_DestroyWindow(ct.c_void_p(self.window))
        self.lib.SDL_Quit()
