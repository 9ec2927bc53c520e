from .material import Material, MATERIAL_PRESETS, world_default_material, default_surface_material
from .texture import (Texture, NormalMap, MetalnessMap, RoughnessMap, EmissionMap,
                      TextureMap, MAP_KINDS, MAP_CLASSES)
from .mesh import Mesh, GENERATORS
from .camera import Camera
from .lights import SpotLight, DirectLight
from .instance import Instance, Group, MATERIAL_CAPACITY
from .world import World, ObjectContainer

__all__ = [
    "Material", "MATERIAL_PRESETS", "world_default_material", "default_surface_material",
    "Texture", "NormalMap", "MetalnessMap", "RoughnessMap", "EmissionMap", "TextureMap",
    "MAP_KINDS", "MAP_CLASSES",
    "Mesh", "GENERATORS", "Camera", "SpotLight", "DirectLight",
    "Instance", "Group", "MATERIAL_CAPACITY", "World", "ObjectContainer",
]
