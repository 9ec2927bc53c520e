"""Host texture-map model.

Mirrors the reference ``TextureBuffer<T>`` family (RayZath/render_parts.hpp:95-227):
five map kinds (Texture RGBA, NormalMap RGB, Metalness/Roughness scalar,
Emission float) with point/linear filtering, wrap/clamp/mirror/border addressing,
and a UV transform (scale, rotation, translation) applied at fetch time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar

import numpy as np

from .versioned import Versioned

FILTER_POINT = 0
FILTER_LINEAR = 1
ADDRESS_WRAP = 0
ADDRESS_CLAMP = 1
ADDRESS_MIRROR = 2
ADDRESS_BORDER = 3

_FILTER_NAMES = {"point": FILTER_POINT, "linear": FILTER_LINEAR}
_ADDRESS_NAMES = {
    "wrap": ADDRESS_WRAP, "clamp": ADDRESS_CLAMP,
    "mirror": ADDRESS_MIRROR, "border": ADDRESS_BORDER,
}


def filter_mode_id(name) -> int:
    return _FILTER_NAMES[name] if isinstance(name, str) else int(name)


def address_mode_id(name) -> int:
    return _ADDRESS_NAMES[name] if isinstance(name, str) else int(name)


@dataclass
class TextureMap(Versioned):
    """Base host map: ``data`` is float32 [H, W, C] in [0, 1] (or any float for emission)."""

    channels: ClassVar[int] = 4

    name: str = "map"
    data: np.ndarray = field(default_factory=lambda: np.ones((1, 1, 4), np.float32))
    filter_mode: int = FILTER_POINT
    address_mode: int = ADDRESS_WRAP
    scale: np.ndarray = field(default_factory=lambda: np.ones(2, np.float32))
    rotation: float = 0.0
    translation: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))

    def __post_init__(self):
        self.filter_mode = filter_mode_id(self.filter_mode)
        self.address_mode = address_mode_id(self.address_mode)
        self.scale = np.asarray(self.scale, np.float32)
        self.translation = np.asarray(self.translation, np.float32)
        data = np.asarray(self.data, np.float32)
        if data.ndim == 2:
            data = data[:, :, None]
        cls_ch = type(self).channels
        if data.shape[2] < cls_ch:
            pad = np.ones(data.shape[:2] + (cls_ch - data.shape[2],), np.float32)
            data = np.concatenate([data, pad], axis=2)
        self.data = data[:, :, :cls_ch]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]


class Texture(TextureMap):
    """RGBA color texture; alpha modulates opacity (reference render_parts.hpp:95-130)."""
    channels = 4


class NormalMap(TextureMap):
    """Tangent-space normal map, RGB in [0,1] mapped to [-1,1] at shading time."""
    channels = 4


class MetalnessMap(TextureMap):
    """Scalar metalness map (reference stores uint8; we keep float32 in [0,1])."""
    channels = 1


class RoughnessMap(TextureMap):
    channels = 1


class EmissionMap(TextureMap):
    """Scalar emission multiplier map (float, unbounded)."""
    channels = 1


MAP_KINDS = ("texture", "normal_map", "metalness_map", "roughness_map", "emission_map")
MAP_CLASSES = {
    "texture": Texture,
    "normal_map": NormalMap,
    "metalness_map": MetalnessMap,
    "roughness_map": RoughnessMap,
    "emission_map": EmissionMap,
}
