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
    # Scenes with <= this many triangles take the dense projection test in
    # the JAX package. That path is not ported (ROADMAP A4); the port always
    # runs the cluster traversal, and a positive value raises.
    brute_force_threshold: int = 0
    bvh_leaf_size: int = 8
    chunk: int = 512                   # dense-path triangle tile (JAX only)
    # Use the cluster traversal kernels. Must be True in the port: the
    # JAX package's alternative, the XLA skip-link walk (ops/traverse.py),
    # is not ported (ROADMAP A17).
    packet_traversal: bool = True
    # Acceleration structure: None = auto (two-level when instancing would
    # duplicate geometry substantially; world-space soup otherwise). The
    # port renders the soup only; a two-level scene raises (ROADMAP A11).
    two_level: Optional[bool] = None
    # Sort rays by the coherence key (ops/sort_rays.py) before traversal.
    # None = auto: on when the scene has at least 16 real clusters, as in
    # the JAX package (integrator._sort_traversal); otherwise rays go in
    # 32x32 image tiles.
    ray_sort: Optional[bool] = None

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)
