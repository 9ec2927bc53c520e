"""Host instance + group hierarchy.

Instance mirrors reference RayZath/instance.hpp:14-68: a mesh reference, up to 64
material slots, a TRS transform, and an optional group chain whose transforms are
flattened into the instance's effective (in-group) transform. Group mirrors
RayZath/group.hpp:12-54.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils.hostmath import Transform
from .material import Material
from .mesh import Mesh

MATERIAL_CAPACITY = 64  # reference instance.hpp:17


class Group:
    def __init__(self, name: str = "group", transform: Optional[Transform] = None):
        self.name = name
        self.transform = transform or Transform()
        self.parent: Optional["Group"] = None
        self.groups: List["Group"] = []
        self.instances: List["Instance"] = []
        self.version = 0

    def add_group(self, group: "Group") -> None:
        group.parent = self
        self.groups.append(group)
        self.touch()

    def add_instance(self, instance: "Instance") -> None:
        instance.group = self
        self.instances.append(instance)
        self.touch()

    def chain_transform(self) -> Transform:
        """Flatten the group chain into one transform (innermost first)."""
        t = self.transform
        g = self.parent
        while g is not None:
            t = t.compose_with(g.transform)
            g = g.parent
        return t

    def touch(self) -> None:
        self.version += 1
        for g in self.groups:
            g.touch()
        for i in self.instances:
            i.touch()


class Instance:
    def __init__(
        self,
        name: str = "instance",
        mesh: Optional[Mesh] = None,
        materials: Optional[List[Material]] = None,
        transform: Optional[Transform] = None,
    ):
        self.name = name
        self.mesh = mesh
        self.materials: List[Optional[Material]] = list(materials or [])
        if len(self.materials) > MATERIAL_CAPACITY:
            raise ValueError(f"instance supports at most {MATERIAL_CAPACITY} material slots")
        self.transform = transform or Transform()
        self.group: Optional[Group] = None
        self.version = 0

    def set_material(self, slot: int, material: Material) -> None:
        if not (0 <= slot < MATERIAL_CAPACITY):
            raise ValueError(f"material slot out of range: {slot}")
        while len(self.materials) <= slot:
            self.materials.append(None)
        self.materials[slot] = material
        self.touch()

    def effective_transform(self) -> Transform:
        """Instance transform composed through its group chain (reference
        ``transformationInGroup``, instance.hpp / groupable.hpp)."""
        if self.group is None:
            return self.transform
        return self.transform.compose_with(self.group.chain_transform())

    def world_vertices(self) -> np.ndarray:
        if self.mesh is None or len(self.mesh.vertices) == 0:
            return np.zeros((0, 3), np.float32)
        return self.effective_transform().points_l2g(self.mesh.vertices).astype(np.float32)

    def bounding_box(self) -> tuple[np.ndarray, np.ndarray]:
        """World-space AABB from transformed vertices (reference instance.cpp:117-156)."""
        wv = self.world_vertices()
        if len(wv) == 0:
            p = self.effective_transform().position
            return p.copy(), p.copy()
        return wv.min(0), wv.max(0)

    def touch(self) -> None:
        self.version += 1
