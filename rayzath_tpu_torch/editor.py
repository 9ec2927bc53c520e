"""Scene editing surface: explorer tree + property get/set + save.

The headless-product counterpart of the reference editor's Scene Explorer
and Properties panels (Application/explorer.cpp:1-815 lists every container
with per-type trees; Application/properties.cpp:1-908 edits the selected
object's fields live; Application/save_modals.cpp saves). The logic lives
here, UI-free, so it is unit-testable and reusable; ``viewer.py`` exposes
it over HTTP with a browser panel. A copy of ``rayzath_tpu/editor.py`` on
the port's ``models/`` and ``io/loader``: it touches no device.

Edits go through normal attribute assignment on the host model objects, so
the ``Versioned`` dirty tracking bumps ``World.content_version()`` and the
renderer re-flattens + restarts accumulation on the next cycle — the same
update path the reference drives through ``StateRegister::MakeModified``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .models.world import World

# Per-type editable fields, mirroring the reference property panels
# (properties.cpp: material 300-420, spot light 120-170, direct light
# 171-210, camera 211-299, instance/group transform 40-119).
#   kind: float | vec3 | rgb | rgba | bool
EDITABLE: Dict[str, List[tuple]] = {
    "material": [("color", "rgba"), ("metalness", "float"),
                 ("roughness", "float"), ("emission", "float"),
                 ("ior", "float"), ("scattering", "float")],
    "spot_light": [("position", "vec3"), ("direction", "vec3"),
                   ("color", "rgb"), ("size", "float"),
                   ("emission", "float"), ("beam_angle", "float")],
    "direct_light": [("direction", "vec3"), ("color", "rgb"),
                     ("emission", "float"), ("angular_size", "float")],
    "camera": [("position", "vec3"), ("fov", "float"),
               ("focal_distance", "float"), ("aperture", "float"),
               ("exposure_time", "float"), ("temporal_blend", "float"),
               ("enabled", "bool")],
    "instance": [("transform.position", "vec3"),
                 ("transform.rotation", "vec3"),
                 ("transform.scale", "vec3")],
    "group": [("transform.position", "vec3"),
              ("transform.rotation", "vec3"),
              ("transform.scale", "vec3")],
    "world_material": [("color", "rgba"), ("emission", "float")],
    "default_material": [("color", "rgba"), ("metalness", "float"),
                         ("roughness", "float"), ("emission", "float"),
                         ("ior", "float"), ("scattering", "float")],
}

_CONTAINERS = {
    "camera": "cameras", "mesh": "meshes", "material": "materials",
    "instance": "instances", "group": "groups", "spot_light": "spot_lights",
    "direct_light": "direct_lights", "texture": "textures",
    "normal_map": "normal_maps", "metalness_map": "metalness_maps",
    "roughness_map": "roughness_maps", "emission_map": "emission_maps",
}


def resolve(world: World, type_: str, idx: int):
    """The live object addressed by (type, index)."""
    if type_ == "world_material":
        return world.material
    if type_ == "default_material":
        return world.default_material
    cont = getattr(world, _CONTAINERS[type_])
    return cont[idx]


def scene_tree(world: World) -> dict:
    """Explorer tree: every container's objects with name + a one-line
    summary (reference explorer trees, explorer.cpp:1-815)."""
    def describe(type_, i, obj):
        extra = ""
        if type_ == "mesh":
            extra = f"{obj.triangle_count} tris"
        elif type_ == "instance":
            extra = obj.mesh.name if obj.mesh is not None else "(no mesh)"
        elif type_ == "material":
            extra = f"rough {obj.roughness:.2f}"
        elif type_ in ("texture", "normal_map", "metalness_map",
                       "roughness_map", "emission_map"):
            extra = f"{obj.width}x{obj.height}"
        elif type_ == "camera":
            extra = f"{obj.width}x{obj.height}"
        return {"idx": i, "name": obj.name, "info": extra,
                "editable": type_ in EDITABLE}

    tree = {type_: [describe(type_, i, o)
                    for i, o in enumerate(getattr(world, attr))]
            for type_, attr in _CONTAINERS.items()}
    tree["world_material"] = [{"idx": 0, "name": "world (sky)",
                               "info": "", "editable": True}]
    tree["default_material"] = [{"idx": 0, "name": "default material",
                                 "info": "", "editable": True}]
    return tree


def _get_attr(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def get_props(world: World, type_: str, idx: int) -> dict:
    """All editable properties of one object as JSON-safe values."""
    obj = resolve(world, type_, idx)
    fields = []
    for attr, kind in EDITABLE.get(type_, []):
        v = _get_attr(obj, attr)
        if kind in ("vec3", "rgb", "rgba"):
            v = [float(x) for x in np.asarray(v).ravel()]
        elif kind == "bool":
            v = bool(v)
        else:
            v = float(v)
        fields.append({"attr": attr, "kind": kind, "value": v})
    return {"type": type_, "idx": idx,
            "name": getattr(obj, "name", type_), "fields": fields}


def set_prop(world: World, type_: str, idx: int, attr: str, value) -> dict:
    """Assign one editable property (validated against EDITABLE); returns
    the refreshed property dict. Assignment goes through the object's
    ``Versioned.__setattr__``, so the renderer sees the content-version bump
    and restarts progressive accumulation."""
    spec = dict(EDITABLE.get(type_, []))
    if attr not in spec:
        raise KeyError(f"{type_}.{attr} is not editable")
    obj = resolve(world, type_, idx)
    kind = spec[attr]
    if kind in ("vec3", "rgb", "rgba"):
        n = 4 if kind == "rgba" else 3
        value = np.asarray([float(x) for x in value], np.float32)
        if kind == "rgba" and value.shape == (3,):
            value = np.concatenate([value, [1.0]]).astype(np.float32)
        assert value.shape == (n,), f"{attr} expects {n} components"
    elif kind == "bool":
        value = bool(value)
    else:
        value = float(value)

    if "." in attr:  # instance/group transform fields
        head, leaf = attr.rsplit(".", 1)
        target = _get_attr(obj, head)
        setattr(target, leaf, value)
        if leaf == "rotation":  # Transform caches its rotation matrix
            from .utils.hostmath import rotation_xyz
            target.rot = rotation_xyz(target.rotation)
        obj.touch()  # Transform is plain (not Versioned): bump the owner
    else:
        setattr(obj, attr, value)
        if type_ in ("spot_light", "direct_light") and attr == "direction":
            from .utils.hostmath import normalize
            object.__setattr__(obj, "direction",
                               normalize(np.asarray(obj.direction)))
    return get_props(world, type_, idx)


def save_scene(world: World, path: str) -> dict:
    """Save the world to a scene JSON (+ maps) — the save-modal action."""
    world.save_scene(path)
    return {"saved": path}


def load_scene(world: World, path: str) -> dict:
    """Replace the world's content with a scene JSON — the load-modal action
    (reference Application/load_modals.cpp:1-597 + file_browser.cpp). The
    world object itself survives (the renderer keeps watching it); its
    containers are cleared and refilled, and the content-version bump
    restarts accumulation."""
    from .io.loader import load_scene as _load
    # load into a scratch world first: a bad path or parse error must not
    # destroy the current (possibly unsaved) scene (round-4 advisor finding).
    # Only after the load succeeds are the containers transplanted.
    tmp = World()
    result = _load(tmp, path)
    world.destroy_all()
    for cattr in _CONTAINERS.values():
        cont, src = getattr(world, cattr), getattr(tmp, cattr)
        cont._objects = src._objects
        src._objects = []
    world.material = tmp.material
    world.default_material = tmp.default_material
    world.touch()
    return {"loaded": path,
            "errors": [str(m) for m in getattr(result, "errors", [])],
            "objects": {t: len(getattr(world, c))
                        for t, c in _CONTAINERS.items()}}


#: Constructible object types for the new-object modal (reference
#: Application/new_modals.cpp): type -> (world factory, default kwargs).
NEWABLE = {
    "material": lambda w, p: w.create_material(p.get("name", "material")),
    "mesh": lambda w, p: w.generate_mesh(p.get("kind", "cube"),
                                         **{k: v for k, v in p.items()
                                            if k not in ("kind", "name")}),
    "spot_light": lambda w, p: w.create_spot_light(p.get("name", "spot light")),
    "direct_light": lambda w, p: w.create_direct_light(
        p.get("name", "direct light")),
    "camera": lambda w, p: w.create_camera(p.get("name", "camera")),
    "group": lambda w, p: w.create_group(p.get("name", "group")),
}


def new_object(world: World, type_: str, params: dict | None = None) -> dict:
    """Create an object — the new-object modal action. ``instance`` takes
    ``mesh``/``material`` container indices; ``mesh`` takes a generator
    ``kind`` (+ its parameters)."""
    params = params or {}
    if type_ == "instance":
        mesh = world.meshes[int(params.get("mesh", 0))] if len(world.meshes) \
            else None
        mats = []
        if "material" in params:
            mats = [world.materials[int(params["material"])]]
        obj = world.create_instance(name=params.get("name", "instance"),
                                    mesh=mesh, materials=mats)
    elif type_ in NEWABLE:
        obj = NEWABLE[type_](world, params)
        if "name" in params:
            obj.name = params["name"]
    else:
        raise KeyError(f"cannot create type {type_!r}; have "
                       f"{sorted(NEWABLE) + ['instance']}")
    container = getattr(world, _CONTAINERS[type_])
    return {"created": type_, "idx": container.index_of(obj),
            "name": getattr(obj, "name", "")}


def destroy_object(world: World, type_: str, idx: int) -> dict:
    """Destroy by container index — detaches every reference (Observer
    semantics, models/world.py World._detach)."""
    container = getattr(world, _CONTAINERS[type_])
    obj = container[idx]
    container.destroy(obj)
    return {"destroyed": type_, "name": getattr(obj, "name", ""),
            "remaining": len(container)}
