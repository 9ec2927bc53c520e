"""Host light models.

SpotLight mirrors reference RayZath/spot_light.hpp:14-46 (position, direction,
color, disk size, emission, beam angle); DirectLight mirrors
RayZath/direct_light.hpp (direction, color, emission, angular size).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.hostmath import normalize
from .versioned import Versioned


@dataclass
class SpotLight(Versioned):
    name: str = "spot light"
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = field(default_factory=lambda: np.array([0, -1, 0], np.float32))
    color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    size: float = 0.5          # emitting disk radius
    emission: float = 100.0
    beam_angle: float = 1.0    # radians, half-angle of the beam cone

    def __post_init__(self):
        self.position = np.asarray(self.position, np.float32)
        self.direction = normalize(np.asarray(self.direction, np.float32))
        self.color = np.asarray(self.color, np.float32)[:3]

    @property
    def cos_beam_angle(self) -> float:
        return float(np.cos(self.beam_angle))


@dataclass
class DirectLight(Versioned):
    name: str = "direct light"
    direction: np.ndarray = field(default_factory=lambda: np.array([0, -1, 0], np.float32))
    color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    emission: float = 10.0
    angular_size: float = 0.1  # radians (sun ~ 0.009)

    def __post_init__(self):
        self.direction = normalize(np.asarray(self.direction, np.float32))
        self.color = np.asarray(self.color, np.float32)[:3]

    @property
    def cos_angular_size(self) -> float:
        return float(np.cos(self.angular_size))
