"""First-person viewer camera (reference: sdl_viewer/src/camera.rs).

Semantics preserved: yaw theta around world z composed with pitch phi
around camera x; WASD-style panning in the camera frame scaled by a
mouse-wheel-adjustable movement speed; mouse-drag rotation and pan; pose
save/load slots persisted to poses.json (sdl_viewer/src/lib.rs:249-294);
optional CT mode with a movable near/far slab.

Copy of point_cloud_viewer_tpu/viewer/camera.py:1-223, unchanged.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..math.geometry import Isometry, Perspective

NEAR_PLANE = 0.1
FAR_PLANE = 10000.0
TURNING_SPEED = 0.5


@dataclass
class CameraState:
    """Serializable pose (reference State, camera.rs:82-86)."""

    position: list
    theta: float
    phi: float

    def to_dict(self) -> dict:
        return {"position": list(self.position), "theta": self.theta, "phi": self.phi}

    @classmethod
    def from_dict(cls, d: dict) -> "CameraState":
        return cls(position=list(d["position"]), theta=d["theta"], phi=d["phi"])


class Camera:
    def __init__(self, width: int = 1920, height: int = 1080) -> None:
        self.width = width
        self.height = height
        self.movement_speed = 10.0
        self.theta = 0.0
        self.phi = 0.0
        self.position = np.zeros(3)
        self._pan = np.zeros(3)
        self._delta_rotation = np.zeros(2)  # (theta, phi) from mouse
        self._rotation_speed = np.zeros(2)
        self.moving = {k: False for k in
                       ("right", "left", "backward", "forward", "up", "down")}
        self.turning = {k: False for k in ("left", "right", "up", "down")}
        self.moved = True
        # CT (slice) mode: render only a [near, far] slab.
        self.ct_mode = False
        self.ct_near = 2.0
        self.ct_far = 5.0
        self._update_projection()

    # -- input ---------------------------------------------------------------

    def mouse_drag_rotate(self, delta_x: float, delta_y: float) -> None:
        self._delta_rotation[0] -= 2.0 * np.pi * delta_x / self.width
        self._delta_rotation[1] -= 2.0 * np.pi * delta_y / self.height

    def mouse_drag_pan(self, delta_x: float, delta_y: float) -> None:
        self._pan[0] -= 100.0 * delta_x / self.width
        self._pan[1] += 100.0 * delta_y / self.height

    def mouse_wheel(self, delta: float) -> None:
        """+-10% movement speed per wheel EVENT (sign only, not magnitude)
        with the reference's 0.01 floor (camera.rs:296-301)."""
        sign = (delta > 0) - (delta < 0)
        self.movement_speed += sign * 0.1 * self.movement_speed
        self.movement_speed = max(self.movement_speed, 0.01)

    def pan(self, x: float, y: float, z: float) -> None:
        """Accumulate a camera-frame translation for this frame
        (reference camera.rs:304-308; joystick input arrives here)."""
        self._pan[0] += x
        self._pan[1] += y
        self._pan[2] += z

    def rotate(self, up: float, around: float) -> None:
        """Accumulate rotation speed (reference camera.rs:310-313)."""
        self._rotation_speed[0] += around
        self._rotation_speed[1] += up

    def set_size(self, width: int, height: int) -> None:
        self.width = width
        self.height = height
        self._update_projection()
        self.moved = True

    def move_ct(self, delta: float) -> None:
        self.ct_near += delta
        self.moved = True

    def move_far_plane_ct(self, delta: float) -> None:
        self.ct_far += delta
        self.moved = True

    # -- state ---------------------------------------------------------------

    def state(self) -> CameraState:
        return CameraState(
            position=self.position.tolist(), theta=self.theta, phi=self.phi
        )

    def set_state(self, state: CameraState) -> None:
        self.position = np.asarray(state.position, dtype=np.float64)
        self.theta = state.theta
        self.phi = state.phi
        self.moved = True

    # -- frame update ----------------------------------------------------------

    def update(self, elapsed_seconds: float) -> bool:
        """Advance one frame; returns True if the camera moved
        (reference: camera.rs:206-284)."""
        moved = self.moved
        self.moved = False

        pan = np.zeros(3)
        if self.moving["right"]:
            pan[0] += 1.0
        if self.moving["left"]:
            pan[0] -= 1.0
        if self.moving["backward"]:
            pan[2] += 1.0
        if self.moving["forward"]:
            pan[2] -= 1.0
        if self.moving["up"]:
            pan[1] += 1.0
        if self.moving["down"]:
            pan[1] -= 1.0
        if pan @ pan > 0:
            self._pan += pan / np.linalg.norm(pan)

        if self.turning["left"]:
            self._rotation_speed[0] += TURNING_SPEED
        if self.turning["right"]:
            self._rotation_speed[0] -= TURNING_SPEED
        if self.turning["up"]:
            self._rotation_speed[1] += TURNING_SPEED
        if self.turning["down"]:
            self._rotation_speed[1] -= TURNING_SPEED

        rotation = self._rotation_matrix()
        if self._pan @ self._pan > 0:
            moved = True
            self.position = self.position + rotation @ (
                self._pan * self.movement_speed * elapsed_seconds
            )

        if np.any(self._rotation_speed != 0) or np.any(self._delta_rotation != 0):
            moved = True
            if np.any(self._delta_rotation != 0):
                self.theta += self._delta_rotation[0]
                self.phi += self._delta_rotation[1]
            else:
                self.theta += self._rotation_speed[0] * elapsed_seconds
                self.phi += self._rotation_speed[1] * elapsed_seconds

        self._pan[:] = 0
        self._rotation_speed[:] = 0
        self._delta_rotation[:] = 0
        return moved

    # -- matrices ----------------------------------------------------------------

    def _rotation_matrix(self) -> np.ndarray:
        rot_z = Isometry.from_axis_angle([0, 0, 1], self.theta).rotation
        rot_x = Isometry.from_axis_angle([1, 0, 0], self.phi).rotation
        return rot_z @ rot_x

    def _update_projection(self) -> None:
        aspect = self.width / self.height
        near, far = (self.ct_near, self.ct_far) if self.ct_mode else (NEAR_PLANE, FAR_PLANE)
        self.projection = Perspective.from_fov(aspect, np.pi / 4, near, far)

    def toggle_ct_mode(self) -> None:
        self.ct_mode = not self.ct_mode
        self._update_projection()
        self.moved = True

    def camera_to_world(self) -> Isometry:
        return Isometry(self._rotation_matrix(), self.position.copy())

    def world_to_gl(self) -> np.ndarray:
        """The clip_from_world matrix fed to culling and rendering."""
        if self.ct_mode:
            self._update_projection()
        cam_from_world = self.camera_to_world().inverse()
        return self.projection.matrix @ cam_from_world.to_matrix4()


class PoseStore:
    """Save/load camera poses in slots 0-9 -> poses.json
    (reference: sdl_viewer/src/lib.rs:249-294)."""

    def __init__(self, path: str = "poses.json") -> None:
        self.path = path

    def _load_all(self) -> Dict[str, dict]:
        if os.path.exists(self.path):
            with open(self.path) as f:
                return json.load(f)
        return {}

    def save(self, slot: int, state: CameraState) -> None:
        poses = self._load_all()
        poses[str(slot)] = state.to_dict()
        with open(self.path, "w") as f:
            json.dump(poses, f, indent=2)

    def load(self, slot: int) -> Optional[CameraState]:
        poses = self._load_all()
        d = poses.get(str(slot))
        return CameraState.from_dict(d) if d else None
