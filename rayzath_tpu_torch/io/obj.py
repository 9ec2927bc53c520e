"""OBJ/MTL loader + saver.

Behavioral port of the reference loader stack (RayZath/loader.cpp):

* OBJ (parseOBJ, loader.cpp:738-1040): ``o``/``g`` starts a new mesh; vertices
  and normals negate z (right-handed .obj to the engine's left-handed space);
  faces triangulate as a fan with winding (0, i+2, i+1); indices may be
  negative (relative) or 0 (unused); each mesh's components are re-based to the
  min..max range it references; ``usemtl`` allocates per-mesh material slots
  (max 64); ``mtllib`` paths are collected.
* MTL (loadMTL, loader.cpp:430-640): Kd color (1 or 3 floats), Ns exponent ->
  roughness = 1 - log10(clamp(Ns,1,1000))/log10(1000), d/Tr -> alpha,
  Ni -> ior (>= 1), Pm/Pr metalness/roughness, Ke emission, maps via
  map_Kd/norm/map_Pm/map_Pr/map_Ke.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from ..models.material import Material
from ..models.mesh import Mesh, NO_INDEX
from ..models.instance import Instance, Group, MATERIAL_CAPACITY
from ..models.texture import (Texture, NormalMap, MetalnessMap, RoughnessMap,
                              EmissionMap)
from .bitmap import load_image, save_image
from .load_result import LoadResult

MAX_NGON = 8


# ---------------------------------------------------------------------------
# MTL
# ---------------------------------------------------------------------------

_MAP_STATEMENTS = {
    "map_Kd": ("texture", Texture),
    "norm": ("normal_map", NormalMap),
    "map_Pm": ("metalness_map", MetalnessMap),
    "map_Pr": ("roughness_map", RoughnessMap),
    "map_Ke": ("emission_map", EmissionMap),
}


def load_mtl(path: str, world=None, result: Optional[LoadResult] = None
             ) -> List[Material]:
    """Parse a .mtl file into Materials (maps loaded relative to the file).

    If ``world`` is given, created materials and maps are added to its
    containers.
    """
    result = result if result is not None else LoadResult()
    base = os.path.dirname(os.path.abspath(path))
    materials: List[Material] = []
    pending_maps: List[Tuple[Material, str, type, str]] = []
    unrecognized: set = set()

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line_no, raw in enumerate(f):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(None, 1)
            stmt = parts[0]
            rest = parts[1].strip() if len(parts) > 1 else ""

            if stmt == "newmtl":
                materials.append(Material(name=rest))
                continue
            if not materials:
                result.log_warning(
                    "First statement in file wasn't the \"newmtl\". Ignored.")
                continue
            mat = materials[-1]
            vals = rest.split()

            try:
                if stmt == "Kd":
                    nums = [float(v) for v in vals[:3]]
                    if len(nums) == 1:
                        nums = nums * 3
                    if len(nums) < 3:
                        result.log_error(f"{path}:{line_no}: invalid color")
                        continue
                    c = np.clip(nums, 0.0, 1.0)
                    mat.color = np.array([c[0], c[1], c[2], mat.color[3]], np.float32)
                elif stmt == "Ns":
                    ns = float(vals[0])
                    ns = min(max(ns, 1.0), 1000.0)
                    mat.roughness = 1.0 - (np.log10(ns) / np.log10(1000.0))
                elif stmt == "d":
                    a = min(max(float(vals[0]), 0.0), 1.0)
                    mat.color = np.array([*mat.color[:3], a], np.float32)
                elif stmt == "Tr":
                    tr = min(max(float(vals[0]), 0.0), 1.0)
                    mat.color = np.array([*mat.color[:3], 1.0 - tr], np.float32)
                elif stmt == "Ni":
                    mat.ior = max(float(vals[0]), 1.0)
                elif stmt == "Pm":
                    mat.metalness = min(max(float(vals[0]), 0.0), 1.0)
                elif stmt == "Pr":
                    mat.roughness = min(max(float(vals[0]), 0.0), 1.0)
                elif stmt == "Ke":
                    mat.emission = max(float(vals[0]), 0.0)
                elif stmt in _MAP_STATEMENTS:
                    attr, cls = _MAP_STATEMENTS[stmt]
                    pending_maps.append((mat, attr, cls, rest))
                else:
                    if stmt not in unrecognized:
                        result.log_warning(f"Unrecognized statement \"{stmt}\".")
                        unrecognized.add(stmt)
            except (ValueError, IndexError):
                result.log_error(f"{path}:{line_no}: invalid value for \"{stmt}\"")

    for mat, attr, cls, file_rel in pending_maps:
        # map statements may carry -options before the filename; take the tail
        tokens = file_rel.split()
        file_name = tokens[-1] if tokens else ""
        map_path = os.path.normpath(os.path.join(base, file_name))
        try:
            data = load_image(map_path)
        except (OSError, RuntimeError) as e:
            result.log_error(f"Failed to load map {map_path}: {e}")
            continue
        if cls.channels == 1:
            data = data[:, :, :1]
        m = cls(name=os.path.splitext(os.path.basename(file_name))[0], data=data)
        setattr(mat, attr, m)
        if world is not None:
            container = {
                Texture: world.textures, NormalMap: world.normal_maps,
                MetalnessMap: world.metalness_maps,
                RoughnessMap: world.roughness_maps,
                EmissionMap: world.emission_maps,
            }[cls]
            container.create(m)

    if world is not None:
        for m in materials:
            world.materials.create(m)
    for m in materials:
        result.log_message(f"Loaded material \"{m.name}\".")
    return materials


def save_mtl(path: str, materials: List[Material],
             save_maps: bool = True) -> None:
    """Write materials to a .mtl file (maps saved as PNGs next to it)."""
    base = os.path.dirname(os.path.abspath(path))
    os.makedirs(base, exist_ok=True)
    lines = []
    for mat in materials:
        lines.append(f"newmtl {mat.name}")
        c = np.asarray(mat.color, np.float32)
        lines.append(f"Kd {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}")
        lines.append(f"d {c[3]:.6f}")
        lines.append(f"Ni {mat.ior:.6f}")
        lines.append(f"Pm {mat.metalness:.6f}")
        lines.append(f"Pr {mat.roughness:.6f}")
        lines.append(f"Ke {mat.emission:.6f}")
        for stmt, attr in (("map_Kd", "texture"), ("norm", "normal_map"),
                           ("map_Pm", "metalness_map"), ("map_Pr", "roughness_map"),
                           ("map_Ke", "emission_map")):
            m = getattr(mat, attr)
            if m is None:
                continue
            fname = f"{mat.name}_{attr}.png"
            if save_maps:
                data = m.data if m.data.shape[2] > 1 else np.repeat(m.data, 3, 2)
                save_image(os.path.join(base, fname), data)
            lines.append(f"{stmt} {fname}")
        lines.append("")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

class ParsedMesh:
    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.material_slots: Dict[str, int] = {}  # material name -> slot idx


def parse_obj(path: str, result: Optional[LoadResult] = None
              ) -> Tuple[List[ParsedMesh], List[str]]:
    """Parse an .obj into meshes + the set of mtllib paths (reference
    OBJLoader::parseOBJ semantics, see module docstring).

    Dispatches to the native C++ parser (native/src/obj.cpp) when
    available; this Python implementation is the fallback and behavioral spec.
    """
    result = result if result is not None else LoadResult()
    parsed_native = native.obj_parse(path) if os.path.exists(path) else None
    if parsed_native is not None:
        nmeshes, mtllibs, log = parsed_native
        for level, text in log:
            (result.log_message, result.log_warning,
             result.log_error)[level](text)
        out: List[ParsedMesh] = []
        for nm in nmeshes:
            mesh = Mesh(name=nm.name, vertices=nm.vertices, texcrds=nm.texcrds,
                        normals=nm.normals, tri_v=nm.tri_v, tri_t=nm.tri_t,
                        tri_n=nm.tri_n, tri_mat=nm.tri_m)
            pm = ParsedMesh(mesh)
            pm.material_slots = {name: i for i, name in enumerate(nm.slot_names)}
            out.append(pm)
        return out, mtllibs
    return _parse_obj_py(path, result)


def _parse_obj_py(path: str, result: LoadResult
                  ) -> Tuple[List[ParsedMesh], List[str]]:
    vertices: List[List[float]] = []
    texcrds: List[List[float]] = []
    normals: List[List[float]] = []
    meshes: List[ParsedMesh] = []
    mtllibs: List[str] = []
    unrecognized: set = set()

    # per-mesh accumulated triangles (global indices); re-based at flush
    tri_v: List[List[int]] = []
    tri_t: List[List[int]] = []
    tri_n: List[List[int]] = []
    tri_m: List[int] = []
    material_count = 0
    material_idx = 0

    def flush():
        nonlocal tri_v, tri_t, tri_n, tri_m
        if not meshes:
            return
        pm = meshes[-1]
        if tri_v:
            tv = np.asarray(tri_v, np.int32)
            tt = np.asarray(tri_t, np.int32)
            tn = np.asarray(tri_n, np.int32)

            def rebase(tri, pool_len):
                used = tri[tri >= 0]
                lo = int(used.min()) if used.size else 0
                hi = int(used.max()) + 1 if used.size else 0
                out = np.where(tri >= 0, tri - lo, NO_INDEX).astype(np.int32)
                return out, lo, hi

            tv2, vlo, vhi = rebase(tv, len(vertices))
            tt2, tlo, thi = rebase(tt, len(texcrds))
            tn2, nlo, nhi = rebase(tn, len(normals))
            pm.mesh.vertices = np.asarray(vertices[vlo:vhi], np.float32).reshape(-1, 3)
            pm.mesh.texcrds = np.asarray(texcrds[tlo:thi], np.float32).reshape(-1, 2)
            pm.mesh.normals = np.asarray(normals[nlo:nhi], np.float32).reshape(-1, 3)
            pm.mesh.tri_v = tv2
            pm.mesh.tri_t = tt2
            pm.mesh.tri_n = tn2
            pm.mesh.tri_mat = np.asarray(tri_m, np.int32)
            pm.mesh.touch()
        tri_v, tri_t, tri_n, tri_m = [], [], [], []

    def resolve(idx: int, pool_len: int, what: str, line_no: int) -> int:
        if idx > 0 and idx <= pool_len:
            return idx - 1
        if idx < 0 and -idx <= pool_len:
            return pool_len + idx
        if idx != 0:
            result.log_error(f"On line {line_no}: {what} index outside of range.")
        return NO_INDEX

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line_no, raw in enumerate(f):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(None, 1)
            stmt = parts[0]
            rest = parts[1].strip() if len(parts) > 1 else ""

            if stmt == "mtllib":
                mtllibs.append(rest)
            elif stmt == "v":
                try:
                    x, y, z = (float(v) for v in rest.split()[:3])
                except ValueError:
                    result.log_error(f"Vertex definition on line {line_no} is invalid.")
                    continue
                vertices.append([x, y, -z])  # RH .obj -> LH engine space
            elif stmt == "vt":
                try:
                    u, v = (float(t) for t in rest.split()[:2])
                except ValueError:
                    result.log_error(f"Texcrd definition on line {line_no} is invalid.")
                    continue
                texcrds.append([u, v])
            elif stmt == "vn":
                try:
                    x, y, z = (float(v) for v in rest.split()[:3])
                except ValueError:
                    result.log_error(f"Normal definition on line {line_no} is invalid.")
                    continue
                n = np.array([x, y, -z], np.float32)
                if np.linalg.norm(n) < 1e-12:
                    result.log_warning(f"Line {line_no}: normal is invalid.")
                    n = np.array([0, 1, 0], np.float32)
                normals.append(n.tolist())
            elif stmt in ("o", "g"):
                flush()
                meshes.append(ParsedMesh(Mesh(name=rest)))
                material_count = 0
                material_idx = 0
            elif not meshes:
                result.log_warning(
                    f"Statement in line {line_no} has to be preceded by object "
                    "or group declaration. Ignored.")
            elif stmt == "usemtl":
                slots = meshes[-1].material_slots
                if rest in slots:
                    material_idx = slots[rest]
                elif material_count >= MATERIAL_CAPACITY:
                    result.log_warning(
                        f"usemtl \"{rest}\" on line {line_no} exceeds "
                        f"{MATERIAL_CAPACITY} materials per object. Ignored.")
                else:
                    material_idx = material_count
                    slots[rest] = material_count
                    material_count += 1
            elif stmt == "f":
                triplets = []
                for buff in rest.split()[:MAX_NGON]:
                    ids = (buff.split("/") + ["", "", ""])[:3]
                    def to_int(s):
                        try:
                            return int(s) if s else 0
                        except ValueError:
                            result.log_error(f"Face on line {line_no}: invalid index.")
                            return 0
                    vi, ti, ni = (to_int(s) for s in ids)
                    triplets.append((
                        resolve(vi, len(vertices), "vertex", line_no),
                        resolve(ti, len(texcrds), "texture coordinate", line_no),
                        resolve(ni, len(normals), "normal", line_no)))
                if len(triplets) < 3:
                    result.log_error(
                        f"On line {line_no}: at least three vertex indices required.")
                    continue
                # fan triangulation with reference winding (0, i+2, i+1)
                for i in range(len(triplets) - 2):
                    a, b, c = triplets[0], triplets[i + 2], triplets[i + 1]
                    tri_v.append([a[0], b[0], c[0]])
                    tri_t.append([a[1], b[1], c[1]])
                    tri_n.append([a[2], b[2], c[2]])
                    tri_m.append(material_idx)
            else:
                if stmt not in unrecognized:
                    result.log_warning(f"Unrecognized statement \"{stmt}\".")
                    unrecognized.add(stmt)

    flush()
    return meshes, mtllibs


def load_meshes(path: str, world=None, result: Optional[LoadResult] = None
                ) -> List[Mesh]:
    """Load only the meshes from an .obj (reference OBJLoader::loadMeshes)."""
    result = result if result is not None else LoadResult()
    parsed, _ = parse_obj(path, result)
    meshes = [p.mesh for p in parsed]
    if world is not None:
        for m in meshes:
            world.meshes.create(m)
    for m in meshes:
        result.log_message(f"Loaded mesh \"{m.name}\".")
    return meshes


def load_instances(path: str, world, result: Optional[LoadResult] = None
                   ) -> List[Instance]:
    """Load meshes + mtllib materials and create one instance per mesh with
    its material slots resolved (reference OBJLoader::loadInstances)."""
    result = result if result is not None else LoadResult()
    base = os.path.dirname(os.path.abspath(path))
    parsed, mtllibs = parse_obj(path, result)

    materials: Dict[str, Material] = {}
    for lib in mtllibs:
        lib_path = os.path.normpath(os.path.join(base, lib))
        try:
            for m in load_mtl(lib_path, world, result):
                materials[m.name] = m
        except OSError as e:
            result.log_error(f"Failed to open mtllib {lib_path}: {e}")

    instances: List[Instance] = []
    for pm in parsed:
        world.meshes.create(pm.mesh)
        inst = Instance(name=pm.mesh.name, mesh=pm.mesh)
        for mat_name, slot in pm.material_slots.items():
            mat = materials.get(mat_name)
            if mat is None:
                result.log_error(f"Failed to obtain \"{mat_name}\" material.")
            else:
                inst.set_material(slot, mat)
        world.instances.create(inst)
        instances.append(inst)
    return instances


def load_model(path: str, world, result: Optional[LoadResult] = None) -> Group:
    """Load an .obj as instances enclosed in one group (reference
    OBJLoader::loadModel)."""
    instances = load_instances(path, world, result)
    group = Group(name=os.path.basename(path))
    for inst in instances:
        group.add_instance(inst)
    world.groups.create(group)
    return group


def save_obj(path: str, meshes: List[Mesh], mtl_name: Optional[str] = None) -> None:
    """Write meshes to an .obj (z re-negated back to right-handed)."""
    lines = []
    if mtl_name:
        lines.append(f"mtllib {mtl_name}")
    v_base = t_base = n_base = 1
    for mesh in meshes:
        lines.append(f"o {mesh.name}")
        for v in mesh.vertices:
            lines.append(f"v {v[0]:.6f} {v[1]:.6f} {-v[2]:.6f}")
        for t in mesh.texcrds:
            lines.append(f"vt {t[0]:.6f} {t[1]:.6f}")
        for n in mesh.normals:
            lines.append(f"vn {n[0]:.6f} {n[1]:.6f} {-n[2]:.6f}")

        def ref(vi, ti, ni):
            s = str(vi + v_base)
            if ti >= 0 or ni >= 0:
                s += "/" + (str(ti + t_base) if ti >= 0 else "")
            if ni >= 0:
                s += "/" + str(ni + n_base)
            return s

        for k in range(len(mesh.tri_v)):
            # inverse of load winding (0, i+2, i+1): emit (v0, v2, v1)
            v = mesh.tri_v[k]; t = mesh.tri_t[k]; n = mesh.tri_n[k]
            lines.append("f " + " ".join(
                ref(v[i], t[i], n[i]) for i in (0, 2, 1)))
        v_base += len(mesh.vertices)
        t_base += len(mesh.texcrds)
        n_base += len(mesh.normals)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
