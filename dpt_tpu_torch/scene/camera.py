"""Orbit camera (Camera.cpp semantics) and the Camera the renderer consumes.

Counterpart of `dpt_tpu/scene/camera.py`.  `OrbitCamera` is the same host
state machine (float64 numpy quaternion math); `camera()` rounds its result
once to float32 tensors, so no float64 tensor reaches the renderer.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dpt_tpu_torch.scene.scene import (
    check_dtypes,
    f32,
    resolve_device,
    to_device,
)


@dataclasses.dataclass
class Camera:
    """What the renderer consumes (camera UBO, raytrace_comp.comp:67-73)."""

    position: torch.Tensor  # [3]
    direction: torch.Tensor  # [3] normalised
    up: torch.Tensor  # [3]
    fov_deg: torch.Tensor  # 0-d

    def __post_init__(self):
        check_dtypes(self)

    @property
    def device(self) -> torch.device:
        return self.position.device

    def to(self, device) -> "Camera":
        return to_device(self, device)


def _quat_from_axis_angle(axis, angle_deg):
    half = math.radians(angle_deg) * 0.5
    s = math.sin(half)
    return np.array(
        [math.cos(half), axis[0] * s, axis[1] * s, axis[2] * s], np.float64
    )


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        np.float64,
    )


def _quat_rotate(q, v):
    w, x, y, z = q
    u = np.array([x, y, z], np.float64)
    v = np.asarray(v, np.float64)
    return 2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v + 2.0 * w * np.cross(u, v)


@dataclasses.dataclass
class OrbitCamera:
    """Interactive orbit-around-origin camera (Camera.cpp)."""

    yaw: float = 0.0
    pitch: float = 0.0
    radius: float = 5.0  # Camera.h:36
    fov_deg: float = 60.0  # Camera.h:34
    sensitivity: float = 0.25  # Camera.h:35
    # Yaw-direction correction flips when the up vector crosses the pole
    # (Camera.cpp:39,56-63).
    _correction: int = -1

    def view_update(self, dx: float, dy: float) -> "OrbitCamera":
        """Mouse-drag orbit (Camera.cpp:37-64)."""
        yaw = self.yaw + dx * self._correction * self.sensitivity
        pitch = self.pitch - dy * self.sensitivity
        cam = dataclasses.replace(self, yaw=yaw, pitch=pitch)
        correction = 1 if cam._up_np()[1] < 0 else -1
        return dataclasses.replace(cam, _correction=correction)

    def zoom_update(self, factor: float) -> "OrbitCamera":
        """Wheel zoom scales the orbit radius (Camera.cpp:66-77)."""
        return dataclasses.replace(self, radius=self.radius * factor)

    def _rotation(self):
        yaw_q = _quat_from_axis_angle((0.0, 1.0, 0.0), self.yaw)
        pitch_q = _quat_from_axis_angle((1.0, 0.0, 0.0), self.pitch)
        return _quat_mul(yaw_q, pitch_q)

    def _position_np(self):
        return _quat_rotate(self._rotation(), (0.0, 0.0, self.radius))

    def _up_np(self):
        return _quat_rotate(self._rotation(), (0.0, 1.0, 0.0))

    def camera(self, device="cuda") -> Camera:
        """Lower to the float32 Camera consumed by the renderer.

        Direction points at the origin (Camera.cpp:90-95); up is the rotated
        +Y (Camera.cpp:97-101).
        """
        device = resolve_device(device)
        pos = self._position_np()
        direction = -pos / max(np.linalg.norm(pos), 1e-20)
        return Camera(
            position=f32(pos, device),
            direction=f32(direction, device),
            up=f32(self._up_np(), device),
            fov_deg=f32(self.fov_deg, device),
        )

    def state_tuple(self):
        """Hashable signature for camera-change detection
        (VulkanRayTracer.cpp:739-754)."""
        return (self.yaw, self.pitch, self.radius, self.fov_deg)
