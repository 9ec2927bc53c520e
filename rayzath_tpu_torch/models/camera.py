"""Host camera model.

Mirrors the reference ``Engine::Camera`` (RayZath/camera.hpp:28-136): position,
Euler rotation (look-at convention), resolution, fov, near/far, focal distance,
aperture, exposure time, temporal blend, enabled flag. Defaults follow
camera.hpp:127-136 (1280x720, fov pi/2, focal 10, aperture 0.02, exposure 1/60).
"""
from __future__ import annotations

import numpy as np

from ..utils.hostmath import rotation_look_at, look_at_rotation


class Camera:
    def __init__(
        self,
        name: str = "camera",
        position=(0.0, 0.0, 0.0),
        rotation=(0.0, 0.0, 0.0),
        resolution=(1280, 720),
        fov: float = float(np.pi / 2),
        near_far=(0.01, 1000.0),
        focal_distance: float = 10.0,
        aperture: float = 0.02,
        exposure_time: float = 1.0 / 60.0,
        temporal_blend: float = 0.75,
        enabled: bool = True,
    ):
        self.name = name
        self.position = np.asarray(position, np.float32)
        self.rotation = np.asarray(rotation, np.float32)
        self.resolution = (int(resolution[0]), int(resolution[1]))
        self.fov = float(fov)
        self.near_far = np.asarray(near_far, np.float32)
        self.focal_distance = float(focal_distance)
        self.aperture = float(aperture)
        self.exposure_time = float(exposure_time)
        self.temporal_blend = float(temporal_blend)
        self.enabled = bool(enabled)
        self.focal_point = (self.width // 2, self.height // 2)  # reference m_focal_point
        self.version = 0

    @property
    def width(self) -> int:
        return self.resolution[0]

    @property
    def height(self) -> int:
        return self.resolution[1]

    @property
    def aspect_ratio(self) -> float:
        return self.width / float(self.height)

    def coord_system(self) -> np.ndarray:
        """3x3 matrix, columns = camera axes (look-at rotation order Z,X,Y)."""
        return rotation_look_at(self.rotation)

    def look_at(self, point, roll: float = 0.0) -> None:
        """Point the camera at ``point`` (reference Transformation::lookAtPoint)."""
        self.rotation = look_at_rotation(self.position, point, roll)
        self.touch()

    def touch(self) -> None:
        self.version += 1
