"""Render configuration.

Counterpart of ``rayzath_tpu/engine/config.py``, which mirrors the
reference ``RenderConfig`` (RayZath/engine_parts.hpp:76-128):
``Tracing{max_depth=16, rpp=8}`` and ``LightSampling{spot=1, direct=1}``.
The same frozen dataclasses with the same fields and defaults, so a config
reads the same in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class Tracing:
    max_depth: int = 16
    rpp: int = 8  # bounce-steps (cumulative passes) per render cycle


@dataclass(frozen=True)
class LightSampling:
    spot_light: int = 1
    direct_light: int = 1


@dataclass(frozen=True)
class RenderConfig:
    tracing: Tracing = Tracing()
    light_sampling: LightSampling = LightSampling()
    # Soup scenes with <= this many triangles (and every empty world) take
    # the dense projection test (ops/intersect.py) instead of a walk.
    brute_force_threshold: int = 0
    # the soup BVH's leaf size (the Renderer compiles with it), and so the
    # skip-link walk's lanes
    bvh_leaf_size: int = 8
    chunk: int = 512                   # dense-path triangle tile
    # Soup scenes: True = the cluster traversal kernels (B1/B2), False =
    # the skip-link BVH walk of ops/traverse.py (torch ops, slow). Two-level
    # scenes always take B3/B4, as in the JAX package.
    packet_traversal: bool = True
    # Acceleration structure: None = auto (two-level when instancing would
    # duplicate geometry substantially; world-space soup otherwise).
    two_level: Optional[bool] = None
    # Sort rays by the coherence key (ops/sort_rays.py) before traversal.
    # None = auto: on when the scene has at least 16 real clusters, as in
    # the JAX package (integrator._sort_traversal); otherwise rays go in
    # 32x32 image tiles.
    ray_sort: Optional[bool] = None

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)
