"""Host material model.

Mirrors the reference ``Engine::Material`` (RayZath/material.hpp:13-117):
``color`` is RGBA in [0,1] where **alpha encodes opacity** (1 = opaque,
0 = fully transmissive — reference Graphics::Color alpha, used inverted as
"opacity color" on device, cuda_material.cuh:80-95), plus metalness, roughness,
emission, ior, scattering, and five optional maps.

The 13 common presets reproduce ``Material::generateMaterial`` specializations
(reference material.cpp:93-199).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .texture import Texture, NormalMap, MetalnessMap, RoughnessMap, EmissionMap
from .versioned import Versioned


def _rgba(r, g, b, a=1.0):
    return np.array([r, g, b, a], dtype=np.float32)


@dataclass
class Material(Versioned):
    name: str = "material"
    color: np.ndarray = field(default_factory=lambda: _rgba(1, 1, 1, 1))
    metalness: float = 0.0
    roughness: float = 0.0
    emission: float = 0.0
    ior: float = 1.0
    scattering: float = 0.0

    texture: Optional[Texture] = None
    normal_map: Optional[NormalMap] = None
    metalness_map: Optional[MetalnessMap] = None
    roughness_map: Optional[RoughnessMap] = None
    emission_map: Optional[EmissionMap] = None

    def __post_init__(self):
        self.color = np.asarray(self.color, dtype=np.float32)
        if self.color.shape == (3,):
            self.color = np.concatenate([self.color, [1.0]]).astype(np.float32)
        assert self.color.shape == (4,), f"material color must be RGBA, got {self.color.shape}"

    # -- common presets (reference material.cpp:93-199; colors are 0xRRGGBBAA) --
    @staticmethod
    def preset(kind: str) -> "Material":
        kind = kind.lower()
        table = {
            "gold": dict(color=_rgba(0xFF / 255, 0xD7 / 255, 0x00 / 255, 1.0),
                         metalness=1.0, roughness=0.001, emission=0.0, ior=1.0, scattering=0.0),
            "silver": dict(color=_rgba(0xC0 / 255, 0xC0 / 255, 0xC0 / 255, 1.0),
                           metalness=1.0, roughness=0.001, ior=1.0),
            "copper": dict(color=_rgba(0xB8 / 255, 0x73 / 255, 0x33 / 255, 1.0),
                           metalness=1.0, roughness=0.001, ior=1.0),
            "glass": dict(color=_rgba(1.0, 1.0, 1.0, 0.0), metalness=0.0, roughness=0.0, ior=1.45),
            "water": dict(color=_rgba(1.0, 1.0, 1.0, 0.0), metalness=0.0, roughness=0.0, ior=1.33),
            "mirror": dict(color=_rgba(0xF0 / 255, 0xF0 / 255, 0xF0 / 255, 1.0),
                           metalness=0.9, roughness=0.0, ior=1.0),
            "rough_wood": dict(color=_rgba(0x96 / 255, 0x6F / 255, 0x33 / 255, 1.0),
                               roughness=0.1, ior=1.5),
            "polished_wood": dict(color=_rgba(0x96 / 255, 0x6F / 255, 0x33 / 255, 1.0),
                                  roughness=0.002, ior=1.5),
            "paper": dict(color=_rgba(1.0, 1.0, 1.0, 1.0), roughness=0.0, ior=1.0),
            "rubber": dict(color=_rgba(0.0, 0.0, 0.0, 1.0), roughness=0.018, ior=1.3),
            "rough_plastic": dict(color=_rgba(1.0, 1.0, 1.0, 1.0), roughness=0.45, ior=1.5),
            "polished_plastic": dict(color=_rgba(1.0, 1.0, 1.0, 1.0), roughness=0.0015, ior=1.5),
            "porcelain": dict(color=_rgba(1.0, 1.0, 1.0, 1.0), roughness=0.0, ior=1.5),
        }
        if kind not in table:
            raise KeyError(f"unknown material preset: {kind!r} (have {sorted(table)})")
        return Material(name=f"generated_{kind}", **table[kind])


MATERIAL_PRESETS = (
    "gold", "silver", "copper", "glass", "water", "mirror", "rough_wood",
    "polished_wood", "paper", "rubber", "rough_plastic", "polished_plastic", "porcelain",
)


def world_default_material() -> Material:
    """The world 'sky' material (reference world.cpp:33-38): white, alpha 0 (transparent)."""
    return Material(name="world_material", color=_rgba(1.0, 1.0, 1.0, 0.0))


def default_surface_material() -> Material:
    """Default surface material (reference world.cpp:39-43): light grey, opaque."""
    g = 0xD3 / 255  # Graphics::Color::Palette::LightGrey
    return Material(name="world_default_material", color=_rgba(g, g, g, 1.0))
