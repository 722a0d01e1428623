"""First-person viewer camera (copy of point_cloud_viewer_tpu/viewer/
camera.py:21-198, trimmed to what the headless viewer drives: the input
bindings, pose slots and CT-mode toggles of the windowed shell stay in the
JAX package; reference: sdl_viewer/src/camera.rs).

Semantics preserved: yaw theta around world z composed with pitch phi
around camera x; panning in the camera frame scaled by the movement speed.
"""

from __future__ import annotations

import numpy as np

from ..math.geometry import Isometry, Perspective

NEAR_PLANE = 0.1
FAR_PLANE = 10000.0
TURNING_SPEED = 0.5


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

    def camera_to_world(self) -> Isometry:
        return Isometry(self._rotation_matrix(), self.position.copy())

    def world_to_gl(self) -> np.ndarray:
        """The clip_from_world matrix fed to culling and rendering."""
        if self.ct_mode:
            self._update_projection()
        cam_from_world = self.camera_to_world().inverse()
        return self.projection.matrix @ cam_from_world.to_matrix4()
