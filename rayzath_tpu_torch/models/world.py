"""Host world: typed object containers + world/default materials.

TPU-native equivalent of the reference ``Engine::World`` (RayZath/world.hpp:64-196):
a container per object type (5 map kinds, Material, Mesh, Camera, SpotLight,
DirectLight, Instance, Group) with create/destroy and name lookup, a global sky
("world") material, a default surface material, and procedural generate shortcuts.

Instead of per-object GPU mirroring, the world carries a monotonically increasing
``version``; the device compiler (models/device_scene.py) re-flattens the scene
into SoA JAX arrays whenever the version changed.
"""
from __future__ import annotations

from typing import Generic, List, Optional, TypeVar

import numpy as np

from .camera import Camera
from .instance import Group, Instance
from .lights import DirectLight, SpotLight
from .material import Material, world_default_material, default_surface_material
from .mesh import Mesh, GENERATORS
from .texture import (Texture, NormalMap, MetalnessMap, RoughnessMap, EmissionMap)

T = TypeVar("T")


class ObjectContainer(Generic[T]):
    """Growable container with swap-compaction destroy + name lookup
    (reference object_container.hpp:90-132)."""

    def __init__(self, world: "World"):
        self._world = world
        self._objects: List[T] = []

    def create(self, obj: T) -> T:
        self._objects.append(obj)
        self._world.touch()
        return obj

    def destroy(self, obj: T) -> bool:
        try:
            idx = self._objects.index(obj)
        except ValueError:
            return False
        self._objects[idx] = self._objects[-1]
        self._objects.pop()
        # Observer semantics (reference roho.hpp:18-502): every holder of a
        # destroyed object is notified and drops its reference, so nothing
        # renders from a silently-stale Python object
        self._world._detach(obj)
        self._world.touch()
        return True

    def find(self, name: str) -> Optional[T]:
        for o in self._objects:
            if getattr(o, "name", None) == name:
                return o
        return None

    def clear(self) -> None:
        self._objects.clear()
        self._world.touch()

    def __len__(self) -> int:
        return len(self._objects)

    def __iter__(self):
        return iter(self._objects)

    def __getitem__(self, idx: int) -> T:
        return self._objects[idx]

    def index_of(self, obj: T) -> int:
        return self._objects.index(obj)


class World:
    def __init__(self):
        self.version = 0
        self.textures: ObjectContainer[Texture] = ObjectContainer(self)
        self.normal_maps: ObjectContainer[NormalMap] = ObjectContainer(self)
        self.metalness_maps: ObjectContainer[MetalnessMap] = ObjectContainer(self)
        self.roughness_maps: ObjectContainer[RoughnessMap] = ObjectContainer(self)
        self.emission_maps: ObjectContainer[EmissionMap] = ObjectContainer(self)
        self.materials: ObjectContainer[Material] = ObjectContainer(self)
        self.meshes: ObjectContainer[Mesh] = ObjectContainer(self)
        self.cameras: ObjectContainer[Camera] = ObjectContainer(self)
        self.spot_lights: ObjectContainer[SpotLight] = ObjectContainer(self)
        self.direct_lights: ObjectContainer[DirectLight] = ObjectContainer(self)
        self.instances: ObjectContainer[Instance] = ObjectContainer(self)
        self.groups: ObjectContainer[Group] = ObjectContainer(self)

        self.material = world_default_material()        # sky/world material
        self.default_material = default_surface_material()

    # -- destroy notification (reference Observer callbacks, roho.hpp:18-502) --
    def _detach(self, obj) -> None:
        """Null out every live reference to a just-destroyed object: material
        slots and mesh refs on instances, map refs on materials, group links.
        The next compile then substitutes defaults (materials) or skips
        (instances without a mesh) instead of rendering a stale object."""
        if isinstance(obj, Material):
            for inst in self.instances:
                inst.materials = [None if m is obj else m
                                  for m in inst.materials]
        elif isinstance(obj, Mesh):
            for inst in self.instances:
                if inst.mesh is obj:
                    inst.mesh = None
        elif isinstance(obj, (Texture, NormalMap, MetalnessMap,
                              RoughnessMap, EmissionMap)):
            attrs = ("texture", "normal_map", "metalness_map",
                     "roughness_map", "emission_map")
            for mat in list(self.materials) + [self.material,
                                               self.default_material]:
                for a in attrs:
                    if getattr(mat, a, None) is obj:
                        setattr(mat, a, None)
        elif isinstance(obj, Instance):
            for grp in self.groups:
                if obj in getattr(grp, "instances", ()):
                    grp.instances.remove(obj)
        elif isinstance(obj, Group):
            for grp in self.groups:
                if obj in grp.groups:
                    grp.groups.remove(obj)
            for inst in self.instances:
                if inst.group is obj:
                    inst.group = None
            for child in obj.groups:
                child.parent = None

    # -- dirty tracking (analog of reference StateRegister, updatable.hpp:10-32) --
    def touch(self) -> None:
        self.version += 1

    def content_version(self) -> int:
        """Scene fingerprint reflecting in-place edits of every render-visible
        object (the reference's StateRegister dirty cascade, updatable.hpp:10-54).
        Cameras are excluded: they mirror separately per view."""
        v = self.version
        for container in (self.meshes, self.instances, self.materials,
                          self.spot_lights, self.direct_lights, self.textures,
                          self.normal_maps, self.metalness_maps,
                          self.roughness_maps, self.emission_maps, self.groups):
            for o in container:
                v += getattr(o, "version", 0)
        v += getattr(self.material, "version", 0)
        v += getattr(self.default_material, "version", 0)
        return v

    # -- convenience creators --------------------------------------------------
    def create_material(self, name: str = "material", **kwargs) -> Material:
        return self.materials.create(Material(name=name, **kwargs))

    def generate_material(self, preset: str) -> Material:
        return self.materials.create(Material.preset(preset))

    def create_mesh(self, name: str = "mesh", **kwargs) -> Mesh:
        return self.meshes.create(Mesh(name=name, **kwargs))

    def generate_mesh(self, kind: str, **kwargs) -> Mesh:
        """Procedural mesh (reference World::generateMesh, world.cpp:129-560);
        kinds: cube, plane, sphere/uvsphere, icosphere, cone, cylinder, torus."""
        gen = GENERATORS.get(kind.lower())
        if gen is None:
            raise KeyError(f"unknown mesh kind {kind!r}; have {sorted(GENERATORS)}")
        return self.meshes.create(gen(**kwargs))

    def create_camera(self, name: str = "camera", **kwargs) -> Camera:
        return self.cameras.create(Camera(name=name, **kwargs))

    def create_spot_light(self, name: str = "spot light", **kwargs) -> SpotLight:
        return self.spot_lights.create(SpotLight(name=name, **kwargs))

    def create_direct_light(self, name: str = "direct light", **kwargs) -> DirectLight:
        return self.direct_lights.create(DirectLight(name=name, **kwargs))

    def create_instance(self, name: str = "instance", **kwargs) -> Instance:
        return self.instances.create(Instance(name=name, **kwargs))

    def create_group(self, name: str = "group", **kwargs) -> Group:
        return self.groups.create(Group(name=name, **kwargs))

    def destroy_all(self) -> None:
        """Reference World::destroyAll (world.cpp:81-99). The sky and default
        materials are reset to fresh defaults: container.clear() bypasses
        per-object _detach, and a stale map reference on the surviving
        world.material would silently keep rendering the previous scene's
        sky texture after a load (round-4 advisor finding)."""
        for c in (self.textures, self.normal_maps, self.metalness_maps,
                  self.roughness_maps, self.emission_maps, self.materials,
                  self.meshes, self.cameras, self.spot_lights, self.direct_lights,
                  self.instances, self.groups):
            c.clear()
        self.material = world_default_material()
        self.default_material = default_surface_material()
        self.touch()

    # -- scene IO (reference World::loader()/saver(), world.hpp) ----------------
    def load_scene(self, path: str):
        from ..io.loader import load_scene
        return load_scene(self, path)

    def save_scene(self, path: str) -> None:
        from ..io.loader import save_scene
        save_scene(self, path)

    # -- stats ------------------------------------------------------------------
    def triangle_count(self) -> int:
        total = 0
        for inst in self.instances:
            if inst.mesh is not None:
                total += inst.mesh.triangle_count
        return total
