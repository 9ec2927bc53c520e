"""JSON scene loader + saver for the reference scene schema.

Schema behavioral port of RayZath/json_loader.cpp (cited per construct below):
top-level ``Objects`` with per-type arrays/objects (Texture, NormalMap,
MetalnessMap, RoughnessMap, EmissionMap, Material, Mesh, Camera, SpotLight,
DirectLight, Instance, Group) plus world ``Material`` / ``DefaultMaterial``
overrides. Values reference earlier objects by name. Colors are arrays of >= 3
numbers; floats clamp to [0,1], integers to [0,255] (json_loader.cpp:56-73).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..models.camera import Camera
from ..models.instance import Group, Instance, MATERIAL_CAPACITY
from ..models.lights import DirectLight, SpotLight
from ..models.material import Material, MATERIAL_PRESETS
from ..models.mesh import Mesh, GENERATORS
from ..models.texture import (Texture, NormalMap, MetalnessMap, RoughnessMap,
                              EmissionMap, MAP_CLASSES)
from .bitmap import load_image, save_image
from .load_result import LoadResult
from .obj import load_mtl, load_meshes, load_instances, save_obj, save_mtl

_MAP_KEYS = {
    "Texture": ("texture", Texture, "textures"),
    "NormalMap": ("normal_map", NormalMap, "normal_maps"),
    "MetalnessMap": ("metalness_map", MetalnessMap, "metalness_maps"),
    "RoughnessMap": ("roughness_map", RoughnessMap, "roughness_maps"),
    "EmissionMap": ("emission_map", EmissionMap, "emission_maps"),
}
_MAT_MAP_JSON_KEYS = {
    # json key -> (map kind, Material attribute)
    "texture": ("Texture", "texture"),
    "normal map": ("NormalMap", "normal_map"),
    "metalness map": ("MetalnessMap", "metalness_map"),
    "roughness map": ("RoughnessMap", "roughness_map"),
    "emission map": ("EmissionMap", "emission_map"),
}


def _json_color(value) -> np.ndarray:
    """Color array -> float32 RGBA in [0,1] (json_loader.cpp:56-73)."""
    if not isinstance(value, (list, tuple)) or len(value) < 3:
        raise ValueError("Color has at least three channels.")
    out = np.array([0xF0 / 255, 0xF0 / 255, 0xF0 / 255, 1.0], np.float32)
    for i, v in enumerate(value[:4]):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError("Color values should be numbers.")
        if isinstance(v, float):
            out[i] = min(max(v, 0.0), 1.0)
        else:
            out[i] = min(max(int(v), 0), 255) / 255.0
    return out


def _vec(value, n: int):
    if not isinstance(value, (list, tuple)) or len(value) != n:
        raise ValueError(f"Array has to have {n} coordinates.")
    return [float(v) for v in value]


class JsonLoader:
    """Loads a scene .json into a World (reference JsonLoader)."""

    def __init__(self, world, path: str):
        self.world = world
        self.path = os.path.abspath(path)
        self.base = os.path.dirname(self.path)
        self.result = LoadResult()
        # name lookup per type (the reference LoadedSet)
        self.named: dict[str, dict] = {k: {} for k in (
            "Texture", "NormalMap", "MetalnessMap", "RoughnessMap",
            "EmissionMap", "Material", "Mesh", "Camera", "SpotLight",
            "DirectLight", "Instance", "Group")}

    def make_path(self, rel: str) -> str:
        if os.path.isabs(rel):
            return rel
        return os.path.normpath(os.path.join(self.base, rel))

    def _register(self, kind: str, name: str, obj) -> None:
        if name in self.named[kind]:
            self.result.log_warning(
                f"Loading {kind.lower()} with ambigous name \"{name}\".")
        self.named[kind][name] = obj
        self.result.log_message(f"Loaded {kind.lower()} \"{name}\".")

    # -- maps (json_loader.cpp:75-163) --------------------------------------
    def load_map(self, kind: str, value):
        attr, cls, container = _MAP_KEYS[kind]
        if isinstance(value, str):
            m = self.named[kind].get(value)
            if m is None:
                self.result.log_error(f"\"{value}\" is not yet a loaded map.")
            return m
        if not isinstance(value, dict):
            self.result.log_error(
                "Value of map definition has to be either a string or an object.")
            return None
        if "name" not in value or "file" not in value:
            self.result.log_error(
                "Map definition has to contain \"name\" and \"file\" properties")
            return None
        file = str(value["file"])
        # cross-load dedup: a map already loaded from this path (in ANY
        # previous load into this world) is reused (reference LoadedSet,
        # loader.hpp:16-134)
        from .loader import loaded_set
        lset = loaded_set(self.world)
        cached = lset.get(kind, self.make_path(file))
        if cached is not None and any(
                cached is m for m in getattr(self.world, container)):
            self._register(kind, str(value.get("name", cached.name)), cached)
            if kind == "Texture":
                # an HDR texture carries a paired emission map: register it
                # in THIS load's name table too, or materials referencing
                # "<name> emission" fail to resolve on repeat loads
                emi_cached = lset.get("EmissionMap", self.make_path(file))
                if emi_cached is not None and any(
                        emi_cached is m for m in self.world.emission_maps):
                    self._register("EmissionMap", emi_cached.name, emi_cached)
            return cached
        hdr_emission = None
        try:
            if (kind == "Texture"
                    and os.path.splitext(file)[1].lower() in (".hdr", ".npy")):
                # HDR -> chroma texture + emission map pair (reference
                # BitmapLoader::loadHDR, loader.cpp:103-138)
                from .bitmap import load_hdr, hdr_to_texture_emission
                data, hdr_emission = hdr_to_texture_emission(
                    load_hdr(self.make_path(file)))
            else:
                data = load_image(self.make_path(file))
        except (OSError, RuntimeError) as e:
            self.result.log_error(f"Failed to load map file: {e}")
            return None
        if cls.channels == 1:
            data = data[:, :, :1]
        kwargs = {}
        if isinstance(value.get("filter mode"), str):
            kwargs["filter_mode"] = value["filter mode"]
        if isinstance(value.get("address mode"), str):
            kwargs["address_mode"] = value["address mode"]
        if isinstance(value.get("scale"), (list, tuple)):
            kwargs["scale"] = _vec(value["scale"], 2)
        if isinstance(value.get("rotation"), (int, float)):
            kwargs["rotation"] = float(value["rotation"])
        if isinstance(value.get("translation"), (list, tuple)):
            kwargs["translation"] = _vec(value["translation"], 2)
        m = cls(name=str(value["name"]), data=data, **kwargs)
        getattr(self.world, container).create(m)
        self._register(kind, m.name, m)
        lset.add(kind, self.make_path(file), m)
        if hdr_emission is not None:
            emi = EmissionMap(name=f"{m.name} emission", data=hdr_emission,
                              **kwargs)
            self.world.emission_maps.create(emi)
            self._register("EmissionMap", emi.name, emi)
            lset.add("EmissionMap", self.make_path(file), emi)
        return m

    # -- material (json_loader.cpp:190-392) ----------------------------------
    def load_material(self, value):
        if isinstance(value, str):
            m = self.named["Material"].get(value)
            if m is None:
                self.result.log_error(f"\"{value}\" is not yet a loaded material.")
            return m
        if not isinstance(value, dict):
            self.result.log_error(
                "Value of material definition has to be either a string or an object.")
            return None
        mat: Optional[Material] = None
        if "file" in value:
            mats = load_mtl(self.make_path(str(value["file"])), self.world,
                            self.result)
            if len(mats) != 1:
                self.result.log_warning(
                    f"Expected exactly one material loaded from file "
                    f"\"{value['file']}\".")
            mat = mats[0] if mats else None
        if mat is None:
            mat = Material()
            self.world.materials.create(mat)
        self.apply_material(value, mat, create=False)
        self._register("Material", mat.name, mat)
        return mat

    def apply_material(self, value, mat: Material, create: bool = True) -> None:
        """generateMaterial + file + direct properties onto an existing
        material (reference loadMaterial, json_loader.cpp:253-281)."""
        if not isinstance(value, dict):
            self.result.log_error(
                "Value of material definition has to be either a string or an object.")
            return
        # "generate <preset>" statements (json_loader.cpp:327-392)
        for preset in MATERIAL_PRESETS:
            key = "generate " + preset.replace("_", " ")
            if key in value:
                gen = Material.preset(preset)
                mat.color = gen.color
                mat.metalness = gen.metalness
                mat.roughness = gen.roughness
                mat.emission = gen.emission
                mat.ior = gen.ior
                mat.scattering = gen.scattering
                break
        if create and "file" in value:
            load_mtl(self.make_path(str(value["file"])), self.world, self.result)
        if isinstance(value.get("name"), str):
            mat.name = value["name"]
        for key, v in value.items():
            try:
                if key == "color":
                    mat.color = _json_color(v)
                elif key == "metalness" and isinstance(v, (int, float)):
                    mat.metalness = min(max(float(v), 0.0), 1.0)
                elif key == "roughness" and isinstance(v, (int, float)):
                    mat.roughness = min(max(float(v), 0.0), 1.0)
                elif key == "emission" and isinstance(v, (int, float)):
                    mat.emission = max(float(v), 0.0)
                elif key == "ior" and isinstance(v, (int, float)):
                    mat.ior = max(float(v), 1.0)
                elif key == "scattering" and isinstance(v, (int, float)):
                    mat.scattering = max(float(v), 0.0)
                elif key in _MAT_MAP_JSON_KEYS:
                    kind, attr = _MAT_MAP_JSON_KEYS[key]
                    setattr(mat, attr, self.load_map(kind, v))
            except ValueError as e:
                self.result.log_error(
                    f"Failed to load {key} property of \"{mat.name}\" material. {e}")

    # -- mesh (json_loader.cpp:394-662) ---------------------------------------
    def load_mesh(self, value):
        if isinstance(value, str):
            m = self.named["Mesh"].get(value)
            if m is None:
                self.result.log_error(f"\"{value}\" is not yet a loaded mesh.")
            return m
        if not isinstance(value, dict):
            self.result.log_error(
                "Value of mesh definition has to be either a string or an object.")
            return None
        if "name" not in value and "file" not in value:
            self.result.log_error(
                "mesh definition has to contain \"name\" property, "
                "when not loaded from file.")
            return None
        name = str(value.get("name", "default"))

        mesh = self._generate_mesh(value)
        if mesh is not None:
            mesh.name = name
            self.world.meshes.create(mesh)
            self._register("Mesh", name, mesh)
            return mesh

        if "file" in value:
            meshes = load_meshes(self.make_path(str(value["file"])), self.world,
                                 self.result)
            if len(meshes) != 1:
                self.result.log_warning(
                    f"{len(meshes)} meshes loaded from {value['file']}. "
                    "Exactly one is expected in scene mesh definition.")
            if not meshes:
                self.result.log_error(f"no mesh loaded from {value['file']}")
                return None
            self._register("Mesh", meshes[0].name, meshes[0])
            return meshes[0]

        # inline arrays (json_loader.cpp:594-656)
        mesh = Mesh(name=name)
        if isinstance(value.get("vertices"), list):
            mesh.vertices = np.asarray(
                [_vec(v, 3) for v in value["vertices"]], np.float32).reshape(-1, 3)
        if isinstance(value.get("texcrds"), list):
            mesh.texcrds = np.asarray(
                [_vec(t, 2) for t in value["texcrds"]], np.float32).reshape(-1, 2)
        if isinstance(value.get("normals"), list):
            mesh.normals = np.asarray(
                [_vec(n, 3) for n in value["normals"]], np.float32).reshape(-1, 3)
        if isinstance(value.get("triangles"), list):
            for tri in value["triangles"]:
                if not isinstance(tri, dict):
                    continue
                v = tri.get("v")
                t = tri.get("t")
                n = tri.get("n")
                m = tri.get("m", 0)
                mesh.create_triangle(v, t, n, int(m))
        self.world.meshes.create(mesh)
        self._register("Mesh", mesh.name, mesh)
        return mesh

    def _generate_mesh(self, value) -> Optional[Mesh]:
        """\"generate <kind>\" statements (json_loader.cpp:394-537)."""
        for key, params in value.items():
            if not key.startswith("generate "):
                continue
            kind = key[len("generate "):]
            if kind not in ("cube", "plane", "sphere", "cone", "cylinder", "torus"):
                continue
            p = params if isinstance(params, dict) else {}
            if kind == "cube":
                return GENERATORS["cube"]()
            if kind == "plane":
                return GENERATORS["plane"](
                    sides=max(3, int(p.get("resolution", 4))),
                    width=float(p.get("width", 1.0)),
                    height=float(p.get("height", 1.0)))
            if kind == "sphere":
                typ = str(p.get("type", "uvsphere"))
                if typ == "icosphere":
                    res = int(p.get("resolution", 16))
                    return GENERATORS["icosphere"](
                        subdivisions=max(0, min(5, int(np.log2(max(res, 4) / 4)) + 1)),
                        normals=bool(p.get("normals", True)),
                        texcrds=bool(p.get("texcrds", True)))
                return GENERATORS["sphere"](
                    resolution=max(4, int(p.get("resolution", 16))),
                    normals=bool(p.get("normals", True)),
                    texcrds=bool(p.get("texcrds", True)))
            if kind == "cone":
                return GENERATORS["cone"](
                    side_faces=max(3, int(p.get("resolution", 16))),
                    normals=bool(p.get("normals", True)),
                    texcrds=bool(p.get("texcrds", True)))
            if kind == "cylinder":
                return GENERATORS["cylinder"](
                    faces=max(3, int(p.get("resolution", 16))),
                    normals=bool(p.get("normals", True)))
            if kind == "torus":
                return GENERATORS["torus"](
                    major_resolution=max(3, int(p.get("major resolution", 32))),
                    minor_resolution=max(3, int(p.get("minor resolution", 16))),
                    major_radius=max(0.0, float(p.get("major radious", 1.0))),
                    minor_radius=max(0.0, float(p.get("minor radious", 0.25))),
                    normals=bool(p.get("normals", True)),
                    texcrds=bool(p.get("texcrds", True)))
        return None

    # -- camera / lights (json_loader.cpp:664-780) -----------------------------
    def load_camera(self, value):
        if not isinstance(value, dict):
            self.result.log_error("Value of camera definition has to be an object.")
            return None
        kw = {}
        if isinstance(value.get("name"), str):
            kw["name"] = value["name"]
        if "position" in value:
            kw["position"] = _vec(value["position"], 3)
        if "rotation" in value:
            kw["rotation"] = _vec(value["rotation"], 3)
        if "resolution" in value:
            kw["resolution"] = [int(v) for v in _vec(value["resolution"], 2)]
        for jk, ak in (("fov", "fov"), ("focal distance", "focal_distance"),
                       ("aperture", "aperture"), ("exposure time", "exposure_time"),
                       ("temporal blend", "temporal_blend")):
            if isinstance(value.get(jk), (int, float)):
                kw[ak] = float(value[jk])
        near_far = [0.01, 1000.0]
        if isinstance(value.get("near plane"), (int, float)):
            near_far[0] = float(value["near plane"])
        if isinstance(value.get("far plane"), (int, float)):
            near_far[1] = float(value["far plane"])
        if "near far" in value:
            near_far = _vec(value["near far"], 2)
        kw["near_far"] = near_far
        if isinstance(value.get("enabled"), bool):
            kw["enabled"] = value["enabled"]
        cam = Camera(**kw)
        self.world.cameras.create(cam)
        self._register("Camera", cam.name, cam)
        return cam

    def load_spot_light(self, value):
        if not isinstance(value, dict):
            self.result.log_error("Value of spot light definition has to be an object.")
            return None
        kw = {}
        if isinstance(value.get("name"), str):
            kw["name"] = value["name"]
        if "position" in value:
            kw["position"] = _vec(value["position"], 3)
        if "direction" in value:
            kw["direction"] = _vec(value["direction"], 3)
        if "color" in value:
            kw["color"] = _json_color(value["color"])[:3]
        for jk, ak in (("size", "size"), ("emission", "emission"),
                       ("angle", "beam_angle")):
            if isinstance(value.get(jk), (int, float)):
                kw[ak] = float(value[jk])
        light = SpotLight(**kw)
        self.world.spot_lights.create(light)
        self._register("SpotLight", light.name, light)
        return light

    def load_direct_light(self, value):
        if not isinstance(value, dict):
            self.result.log_error("Value of direct light definition has to be an object.")
            return None
        kw = {}
        if isinstance(value.get("name"), str):
            kw["name"] = value["name"]
        if "direction" in value:
            kw["direction"] = _vec(value["direction"], 3)
        if "color" in value:
            kw["color"] = _json_color(value["color"])[:3]
        if isinstance(value.get("emission"), (int, float)):
            kw["emission"] = float(value["emission"])
        if isinstance(value.get("size"), (int, float)):
            kw["angular_size"] = float(value["size"])
        light = DirectLight(**kw)
        self.world.direct_lights.create(light)
        self._register("DirectLight", light.name, light)
        return light

    # -- instance (json_loader.cpp:782-885) -------------------------------------
    def load_instance(self, value):
        if not isinstance(value, dict):
            self.result.log_error("Value of instance definition has to be an object.")
            return None
        inst: Optional[Instance] = None
        if "file" in value:
            instances = load_instances(self.make_path(str(value["file"])),
                                       self.world, self.result)
            if len(instances) != 1:
                self.result.log_warning(
                    f"{len(instances)} instances loaded from {value['file']}. "
                    "Exactly one is expected in scene instance definition.")
            inst = instances[0] if instances else None
        if inst is None:
            inst = Instance()
            self.world.instances.create(inst)

        material_count = 0

        def add_material(v):
            nonlocal material_count
            if material_count >= MATERIAL_CAPACITY:
                return
            if isinstance(v, str):
                mat = self.named["Material"].get(v)
                if mat is None:
                    self.result.log_error(
                        f"Reference to material \"{v}\" in the definition of "
                        f"instance {inst.name} is invalid.")
                    return
            else:
                mat = self.load_material(v)
            if mat is not None:
                inst.set_material(material_count, mat)
                material_count += 1

        from ..utils.hostmath import Transform
        pos, rot, scale = (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
        for key, v in value.items():
            if key == "name" and isinstance(v, str):
                inst.name = v
            elif key == "position":
                pos = _vec(v, 3)
            elif key == "rotation":
                rot = _vec(v, 3)
            elif key == "scale":
                scale = _vec(v, 3)
            elif key == "Material":
                if isinstance(v, list):
                    for m in v:
                        add_material(m)
                else:
                    add_material(v)
            elif key == "Mesh":
                if inst.mesh is not None:
                    self.result.log_warning(
                        f"Mesh reference for \"{inst.name}\" instance already "
                        "specified. Ignored.")
                else:
                    inst.mesh = self.load_mesh(v)
        inst.transform = Transform(position=pos, rotation=rot, scale=scale)
        if material_count >= MATERIAL_CAPACITY:
            self.result.log_error(
                f"Reached the limit of {MATERIAL_CAPACITY} materials per "
                f"instance in definition of \"{inst.name}\".")
        self._register("Instance", inst.name, inst)
        return inst

    # -- groups (json_loader.cpp:886-1033) --------------------------------------
    def load_groups(self, objects_json):
        if "Group" not in objects_json:
            return
        from ..utils.hostmath import Transform
        groups_json = objects_json["Group"]
        entries = groups_json if isinstance(groups_json, list) else [groups_json]
        loaded: dict[str, tuple[Group, dict]] = {}
        for gj in entries:
            if not isinstance(gj, dict):
                self.result.log_error("Group definition should be an object.")
                continue
            name = str(gj.get("name", "group"))
            if name in loaded:
                self.result.log_error(
                    f"Group with name: {name} has already been loaded.")
                continue
            tr = Transform(
                position=_vec(gj["position"], 3) if "position" in gj else (0, 0, 0),
                rotation=_vec(gj["rotation"], 3) if "rotation" in gj else (0, 0, 0),
                scale=_vec(gj["scale"], 3) if "scale" in gj else (1, 1, 1))
            group = Group(name=name, transform=tr)
            self.world.groups.create(group)
            loaded[name] = (group, gj)
            self._register("Group", name, group)
            for obj_name in gj.get("objects", []):
                if not isinstance(obj_name, str):
                    self.result.log_error(
                        "Object entry in group has to be a string, as a name "
                        "of previously defined object.")
                    continue
                inst = self.named["Instance"].get(obj_name)
                if inst is None:
                    self.result.log_error(
                        f"Object \"{obj_name}\" referenced in group "
                        f"\"{name}\" couldn't be found")
                    continue
                group.add_instance(inst)
        # link subgroups with circular-reference detection
        for name, (group, gj) in loaded.items():
            for sub_name in gj.get("groups", []):
                if not isinstance(sub_name, str):
                    self.result.log_error("Sub-group reference in group has to be a string.")
                    continue
                entry = loaded.get(sub_name)
                if entry is None:
                    self.result.log_error(
                        f"Subgroup \"{sub_name}\" referenced in group"
                        f"\"{name}\" couldn't be found.")
                    continue
                sub = entry[0]
                parent = group
                circular = False
                while parent is not None:
                    if parent is sub:
                        self.result.log_error(
                            "Circular reference detected in groupping. Group "
                            f"\"{name}\" referencing sub-group \"{sub_name}\" "
                            "has it as a direct or an indirect parent.")
                        circular = True
                        break
                    parent = parent.parent
                if not circular:
                    group.add_group(sub)

    # -- world (json_loader.cpp:1036-1097) ---------------------------------------
    def load(self) -> LoadResult:
        with open(self.path, "r", encoding="utf-8") as f:
            try:
                world_json = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"Failed to parse file {os.path.basename(self.path)}: {e}")
        self.world.destroy_all()

        def each(objects_json, key, fn):
            if key not in objects_json:
                return
            v = objects_json[key]
            items = v if isinstance(v, list) else [v]
            for item in items:
                try:
                    fn(item)
                except (ValueError, KeyError) as e:
                    self.result.log_error(f"Failed to load {key}. {e}")

        if "Objects" in world_json:
            objs = world_json["Objects"]
            for kind in ("Texture", "NormalMap", "MetalnessMap",
                         "RoughnessMap", "EmissionMap"):
                each(objs, kind, lambda v, k=kind: self.load_map(k, v))
            each(objs, "Material", self.load_material)
            each(objs, "Mesh", self.load_mesh)
            each(objs, "Camera", self.load_camera)
            each(objs, "SpotLight", self.load_spot_light)
            each(objs, "DirectLight", self.load_direct_light)
            each(objs, "Instance", self.load_instance)
            self.load_groups(objs)
        if "Material" in world_json:
            self.apply_material(world_json["Material"], self.world.material)
        if "DefaultMaterial" in world_json:
            self.apply_material(world_json["DefaultMaterial"],
                                self.world.default_material)
        return self.result


# ---------------------------------------------------------------------------
# saver (reference json_saver.cpp — same schema, written back)
# ---------------------------------------------------------------------------

def _color_json(rgba: np.ndarray) -> list:
    return [float(v) for v in np.asarray(rgba, np.float32)]


def _material_json(mat: Material, map_names: dict) -> dict:
    out = {
        "name": mat.name,
        "color": _color_json(mat.color),
        "metalness": float(mat.metalness),
        "roughness": float(mat.roughness),
        "emission": float(mat.emission),
        "ior": float(mat.ior),
        "scattering": float(mat.scattering),
    }
    for jk, attr in (("texture", "texture"), ("normal map", "normal_map"),
                     ("metalness map", "metalness_map"),
                     ("roughness map", "roughness_map"),
                     ("emission map", "emission_map")):
        m = getattr(mat, attr)
        if m is not None and id(m) in map_names:
            out[jk] = map_names[id(m)]
    return out


class JsonSaver:
    """Writes a World back to the reference .json schema (+ PNG map files)."""

    FILTER_NAMES = {0: "point", 1: "linear"}
    ADDRESS_NAMES = {0: "wrap", 1: "clamp", 2: "mirror", 3: "border"}

    def __init__(self, world, path: str):
        self.world = world
        self.path = os.path.abspath(path)
        self.base = os.path.dirname(self.path)
        self._written: list = []     # files created by this save (rollback)

    def save(self, options=None) -> None:
        """Write the scene; ``options`` is a loader.SaveOptions (None = all
        defaults). On failure with allow_partial_write=False, every file
        this save created is removed again."""
        from .loader import SaveOptions
        options = options or SaveOptions()
        self._written = []
        try:
            self._save(options)
        except BaseException:
            if not options.allow_partial_write:
                for f in self._written:
                    try:
                        os.remove(f)
                    except OSError:
                        pass
            raise

    def _want(self, options, group: str) -> bool:
        return options.only is None or group in options.only

    def _write_map_file(self, kind, i, m, options) -> str:
        data = m.data if m.data.shape[2] > 1 else np.repeat(m.data, 3, 2)
        if options.duplicate_textures:
            fname = os.path.join("maps", f"{kind}_{i}_{m.name}.png")
        else:
            # content-hash name: identical maps share one file and an
            # unchanged map is never rewritten (map dedup on save —
            # reference SaveOptions::duplicate_textures=false semantics)
            import hashlib
            h = hashlib.sha1(np.ascontiguousarray(m.data).tobytes())
            fname = os.path.join("maps", f"{kind}_{h.hexdigest()[:10]}.png")
            if os.path.exists(os.path.join(self.base, fname)):
                return fname
        target = os.path.join(self.base, fname)
        existed = os.path.exists(target)
        save_image(target, data)
        if not existed:
            # rollback removes only files this save CREATED — deleting an
            # overwritten pre-existing map would not restore it (advisor
            # finding)
            self._written.append(target)
        return fname

    def _save(self, options) -> None:
        os.makedirs(self.base, exist_ok=True)
        objects: dict = {}
        map_names: dict = {}

        for kind, (attr, cls, container) in _MAP_KEYS.items():
            if not self._want(options, "maps"):
                # names must still resolve for material references
                for m in getattr(self.world, container):
                    map_names[id(m)] = m.name
                continue
            entries = []
            for i, m in enumerate(getattr(self.world, container)):
                fname = self._write_map_file(kind, i, m, options)
                entries.append({
                    "name": m.name, "file": fname,
                    "filter mode": self.FILTER_NAMES[m.filter_mode],
                    "address mode": self.ADDRESS_NAMES[m.address_mode],
                    "scale": [float(m.scale[0]), float(m.scale[1])],
                    "rotation": float(m.rotation),
                    "translation": [float(m.translation[0]), float(m.translation[1])],
                })
                map_names[id(m)] = m.name
            if entries:
                objects[kind] = entries

        materials = [_material_json(m, map_names) for m in self.world.materials]
        if materials and self._want(options, "materials"):
            objects["Material"] = materials
        mat_names = {id(m): m.name for m in self.world.materials}

        meshes = []
        for mesh in self.world.meshes:
            meshes.append({
                "name": mesh.name,
                "vertices": [[float(x) for x in v] for v in mesh.vertices],
                "texcrds": [[float(x) for x in t] for t in mesh.texcrds],
                "normals": [[float(x) for x in n] for n in mesh.normals],
                "triangles": [
                    {"v": [int(x) for x in mesh.tri_v[k]],
                     **({"t": [int(x) for x in mesh.tri_t[k]]}
                        if (mesh.tri_t[k] >= 0).all() else {}),
                     **({"n": [int(x) for x in mesh.tri_n[k]]}
                        if (mesh.tri_n[k] >= 0).all() else {}),
                     "m": int(mesh.tri_mat[k])}
                    for k in range(len(mesh.tri_v))],
            })
        if meshes and self._want(options, "meshes"):
            objects["Mesh"] = meshes
        mesh_names = {id(m): m.name for m in self.world.meshes}

        cameras = []
        for c in self.world.cameras:
            cameras.append({
                "name": c.name,
                "position": [float(v) for v in c.position],
                "rotation": [float(v) for v in c.rotation],
                "resolution": [int(c.width), int(c.height)],
                "fov": float(c.fov),
                "near far": [float(c.near_far[0]), float(c.near_far[1])],
                "focal distance": float(c.focal_distance),
                "aperture": float(c.aperture),
                "exposure time": float(c.exposure_time),
                "temporal blend": float(c.temporal_blend),
                "enabled": bool(c.enabled),
            })
        if cameras and self._want(options, "cameras"):
            objects["Camera"] = cameras

        spots = [{
            "name": li.name,
            "position": [float(v) for v in li.position],
            "direction": [float(v) for v in li.direction],
            "color": _color_json(np.append(li.color, 1.0)),
            "size": float(li.size), "emission": float(li.emission),
            "angle": float(li.beam_angle),
        } for li in self.world.spot_lights]
        if spots and self._want(options, "lights"):
            objects["SpotLight"] = spots

        directs = [{
            "name": li.name,
            "direction": [float(v) for v in li.direction],
            "color": _color_json(np.append(li.color, 1.0)),
            "emission": float(li.emission), "size": float(li.angular_size),
        } for li in self.world.direct_lights]
        if directs and self._want(options, "lights"):
            objects["DirectLight"] = directs

        instances = []
        for inst in self.world.instances:
            entry: dict = {"name": inst.name}
            tr = inst.transform
            entry["position"] = [float(v) for v in tr.position]
            entry["rotation"] = [float(v) for v in tr.rotation]
            entry["scale"] = [float(v) for v in tr.scale]
            if inst.mesh is not None and id(inst.mesh) in mesh_names:
                entry["Mesh"] = mesh_names[id(inst.mesh)]
            mats = [mat_names[id(m)] for m in inst.materials
                    if m is not None and id(m) in mat_names]
            if mats:
                entry["Material"] = mats
            instances.append(entry)
        if instances and self._want(options, "instances"):
            objects["Instance"] = instances

        groups = []
        for g in self.world.groups:
            entry = {
                "name": g.name,
                "position": [float(v) for v in g.transform.position],
                "rotation": [float(v) for v in g.transform.rotation],
                "scale": [float(v) for v in g.transform.scale],
            }
            if g.instances:
                entry["objects"] = [i.name for i in g.instances]
            if g.groups:
                entry["groups"] = [sg.name for sg in g.groups]
            groups.append(entry)
        if groups and self._want(options, "groups"):
            objects["Group"] = groups

        doc = {
            "Objects": objects,
            "Material": _material_json(self.world.material, map_names),
            "DefaultMaterial": _material_json(self.world.default_material, map_names),
        }
        existed = os.path.exists(self.path)
        with open(self.path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        if not existed:
            self._written.append(self.path)
