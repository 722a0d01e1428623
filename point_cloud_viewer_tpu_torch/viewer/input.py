"""Joystick input mapping + optional SDL2 windowed shell.

The mapping math mirrors the reference exactly
(sdl_viewer/src/lib.rs:304-348): per-frame, raw signed-16-bit axis values
map to camera pan/rotate deltas.  Devices are classified by name
(lib.rs:413-421: names containing "Xbox" get the gamepad mapping,
everything else the SpaceMouse mapping).

The mapping layer is pure math and runs anywhere (tested headless); the
SDL2 shell at the bottom loads libSDL2 via ctypes at runtime and degrades
gracefully when no library/display exists (this environment has neither —
the GL pipeline itself is exercised via surfaceless EGL instead).

Copy of point_cloud_viewer_tpu/viewer/input.py:1-70, unchanged.
"""

from __future__ import annotations

from typing import Sequence

from .camera import Camera


class XBoxJoystick:
    """Gamepad mapping (reference lib.rs:310-326): left stick pans in the
    camera plane, right stick turns."""

    kind = "xbox"

    def act(self, camera: Camera, axes: Sequence[int]) -> None:
        right = float(axes[0]) / 1000.0
        forward = float(axes[1]) / 1000.0
        turning_right = -float(axes[3]) / 32000.0
        turning_up = -float(axes[4]) / 32000.0
        camera.pan(right, 0.0, forward)
        camera.rotate(turning_up, turning_right)


class SpaceMouseJoystick:
    """6-DOF puck mapping (reference lib.rs:328-345): axes 0..2 translate,
    axis 3 tilts, axes 4-5 combine into turning."""

    kind = "spacemouse"

    def act(self, camera: Camera, axes: Sequence[int]) -> None:
        x = float(axes[0]) / 500.0
        y = -float(axes[1]) / 500.0
        z = -float(axes[2]) / 500.0
        up = float(axes[3]) / 500.0
        around = float(axes[4]) / 500.0 - float(axes[5]) / 500.0
        camera.pan(x, y, z)
        camera.rotate(up, around)


def joystick_for_name(name: str):
    """Device-name classification (reference lib.rs:413-421)."""
    if "Xbox" in name:
        return XBoxJoystick()
    return SpaceMouseJoystick()


def sdl_available() -> bool:
    """True when libSDL2 exists (a windowed shell needs it + a display;
    this environment has neither, so the GPU pipeline runs headless via
    surfaceless EGL — cli.view --gl)."""
    try:
        import ctypes

        ctypes.CDLL("libSDL2-2.0.so.0")
        return True
    except OSError:
        return False
