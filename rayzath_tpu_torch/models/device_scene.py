"""World -> device scene compilation (SoA torch tensors), soup path only.

Counterpart of the world-space soup branch of
``rayzath_tpu/models/device_scene.py`` (``compile_world``,
``_soup_geometry``, ``_pack_tri_rows``, ``_light_fields``,
``compile_camera``). The whole scene is flattened on the host (NumPy) into
SoA arrays: every instance's mesh is transformed into world space and
concatenated into one triangle list carrying a global material id and an
instance id, reordered by a leaf-8 BVH exactly as the JAX package does (so
triangle ids agree between the packages), then split into the flat cluster
tables of ``ops/traverse_cluster.py``. The arrays become tensors on one
explicit device.

Not built here, because the soup render path does not read them: the XLA
skip-link tables (``aabb_links``, ``node_*``), the dense projection frames
(``tri_pw``/``tri_pc``), the per-vertex normal/texcoord columns outside
``tri_pack`` and the texture atlases. Not ported yet, and refused with
``NotImplementedError``: the two-level instanced structure (ROADMAP A11),
texture maps (A9) and texture-alpha cutout shadows (A10).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops.bvh import build_bvh, triangle_aabbs, FlatBVH
from ..ops.traverse_cluster import build_cluster_tables
from ..utils.hostmath import normalize as nrm
from .material import Material
from .texture import TextureMap
from .world import World

WORLD_MATERIAL_ID = 0
DEFAULT_MATERIAL_ID = 1
NO_MAP = -1


@dataclasses.dataclass
class TorchScene:
    # geometry (world space, BVH leaf order), padded to a bucketed n_tri_pad
    tri_v0: torch.Tensor         # [F,3]
    tri_e1: torch.Tensor         # [F,3]
    tri_e2: torch.Tensor         # [F,3]
    tri_mat: torch.Tensor        # [F] i32 global material id
    tri_inst: torch.Tensor       # [F] i32 instance id (picking)
    # per-hit shading row: v0 0:3 | e1 3:6 | e2 6:9 | n0 9:12 | n1 12:15 |
    # n2 15:18 | t0 18:20 | t1 20:22 | t2 22:24 | mat 24 | inst 25 | pad
    tri_pack: torch.Tensor       # [F,32] f32

    # materials SoA (0 = world/sky, 1 = default surface)
    mat_color: torch.Tensor      # [M,4] rgba (alpha: 1 = opaque)
    mat_metalness: torch.Tensor  # [M]
    mat_roughness: torch.Tensor  # [M]
    mat_emission: torch.Tensor   # [M]
    mat_ior: torch.Tensor        # [M]
    mat_scattering: torch.Tensor  # [M]
    mat_maps: torch.Tensor       # [M,5] i32 (-1 = none; always -1 here)

    # lights (padded to >= 1 row; the counts gate their use)
    spot_pos: torch.Tensor       # [S,3]
    spot_dir: torch.Tensor       # [S,3]
    spot_color: torch.Tensor     # [S,3]
    spot_size: torch.Tensor      # [S]
    spot_emission: torch.Tensor  # [S]
    spot_cos_angle: torch.Tensor  # [S]
    dir_dir: torch.Tensor        # [D,3]
    dir_color: torch.Tensor      # [D,3]
    dir_emission: torch.Tensor   # [D]
    dir_cos: torch.Tensor        # [D]

    # flat cluster tables (ops/traverse_cluster.py)
    cl_box: torch.Tensor         # [8,Cp] cluster AABB / base / count table
    cl_lw: torch.Tensor          # [Cp,4,384] cluster-local projection frames
    cl_order: torch.Tensor       # [F] i32 cluster order -> soup index
    cl_base: torch.Tensor        # [Cp] i32 first triangle (cluster order)
    cl_count: torch.Tensor       # [Cp] i32 triangle count

    n_triangles: int = 0
    n_materials: int = 2
    n_spot_lights: int = 0
    n_direct_lights: int = 0
    n_instances: int = 0
    n_clusters: int = 0          # REAL clusters (tables are 128-padded)


@dataclasses.dataclass
class TorchCamera:
    position: torch.Tensor       # [3]
    rot: torch.Tensor            # [3,3] columns = axes
    fov: torch.Tensor            # scalar
    near_far: torch.Tensor       # [2]
    focal_distance: torch.Tensor
    aperture: torch.Tensor
    exposure_time: torch.Tensor
    width: int = 1280
    height: int = 720


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def compile_camera(cam, device="cpu") -> TorchCamera:
    return TorchCamera(
        position=_f32(cam.position, device),
        rot=_f32(cam.coord_system(), device),
        fov=_f32(cam.fov, device),
        near_far=_f32(cam.near_far, device),
        focal_distance=_f32(cam.focal_distance, device),
        aperture=_f32(cam.aperture, device),
        exposure_time=_f32(cam.exposure_time, device),
        width=cam.width,
        height=cam.height,
    )


# ---------------------------------------------------------------------------
# world compilation (host side copied from the JAX package's soup branch)
# ---------------------------------------------------------------------------

def _pack_tri_rows(v0, e1, e2, n0, n1, n2, t0, t1, t2, mat_or_slot, inst):
    """[F,32] packed per-triangle shading row (TorchScene.tri_pack)."""
    f = len(v0)
    return np.concatenate([
        v0, e1, e2, n0, n1, n2, t0, t1, t2,
        np.asarray(mat_or_slot, np.float32).reshape(f, 1),
        np.asarray(inst, np.float32).reshape(f, 1),
        np.zeros((f, 6), np.float32)], axis=1).astype(np.float32)


def _pad_rows(a: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    if len(a) >= n:
        return a[:n]
    pad = np.full((n - len(a),) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _bucket(n: int, lo: int = 8) -> int:
    """Smallest 2^k or 1.5 * 2^k >= n (>= lo): 8, 16, 24, 32, 48, 64, 96...
    Padded sizes quantize to these buckets so small edits keep shapes."""
    import math
    if n <= lo:
        return lo
    k = 2 ** int(math.floor(math.log2(n)))
    for c in (k, k * 3 // 2, k * 2):
        if c >= n:
            return c
    return k * 2


def _chain_key(inst):
    ks = []
    g = inst.group
    while g is not None:
        ks.append((id(g), getattr(g, "version", 0)))
        g = g.parent
    return tuple(ks)


def _geometry_key(world: World, leaf_size: int):
    """Cache key covering everything the flattened world-space geometry
    depends on: instance identity/version (includes transform + material
    slot edits), mesh identity/version, and the group chain versions."""
    parts = []
    for inst in world.instances:
        m = inst.mesh
        parts.append((id(inst), getattr(inst, "version", 0), id(m),
                      getattr(m, "version", 0) if m is not None else -1,
                      m.triangle_count if m is not None else 0,
                      _chain_key(inst)))
    return ("soup_geo", leaf_size, tuple(parts))


def _resolve_mat(mat_index: dict, mat, inst_name: str) -> int:
    """Material slot -> global id, warning on dangling references (a material
    not in the world renders with the default material)."""
    mid = mat_index.get(id(mat))
    if mid is None:
        warnings.warn(
            f"instance {inst_name!r} references material "
            f"{getattr(mat, 'name', '?')!r} that is not in the world; "
            "substituting the default material", RuntimeWarning)
        return DEFAULT_MATERIAL_ID
    return mid


def _two_level_auto(world: World) -> bool:
    """The JAX package's automatic structure choice (device_scene.py:654-665):
    two-level when instancing duplicates 2x+ a scene past 8192 triangles."""
    live = [i for i in world.instances
            if i.mesh is not None and i.mesh.triangle_count > 0]
    expanded = sum(i.mesh.triangle_count for i in live)
    unique = sum(m.triangle_count
                 for m in {id(i.mesh): i.mesh for i in live}.values())
    return expanded > 8192 and expanded >= 2 * unique


def compile_world(world: World, leaf_size: int = 8,
                  two_level: Optional[bool] = None,
                  cache: Optional[dict] = None,
                  device="cpu") -> TorchScene:
    """Flatten the host world into a TorchScene on ``device`` (see module
    docstring). ``cache`` memoizes the geometry block by version, as in the
    JAX package, so a materials-or-lights-only edit rebuilds only the cheap
    binding tables."""
    if two_level is None:
        two_level = _two_level_auto(world)
    if two_level:
        raise NotImplementedError(
            "two-level instanced scenes are not ported yet (ROADMAP A11, "
            "kernels B3/B4)")

    materials: list[Material] = ([world.material, world.default_material]
                                 + list(world.materials))
    mat_index = {id(m): i for i, m in enumerate(materials)}
    all_maps: list[TextureMap] = (
        list(world.textures) + list(world.normal_maps)
        + list(world.metalness_maps) + list(world.roughness_maps)
        + list(world.emission_maps))
    map_id = {id(m): i for i, m in enumerate(all_maps)}

    def map_ref(m: Optional[TextureMap]) -> int:
        return NO_MAP if m is None else map_id[id(m)]

    mat_color = np.stack([m.color for m in materials]).astype(np.float32)
    mat_maps = np.array(
        [[map_ref(m.texture), map_ref(m.normal_map), map_ref(m.metalness_map),
          map_ref(m.roughness_map), map_ref(m.emission_map)] for m in materials],
        np.int32)

    geo = _soup_geometry(world, leaf_size, cache)
    n_tri = geo["n_tri"]

    # material binding: instance slot tables -> per-triangle global ids
    slot_tables = np.full((max(len(world.instances), 1), 64),
                          DEFAULT_MATERIAL_ID, np.int32)
    for inst_id, inst in enumerate(world.instances):
        for s, mat in enumerate(inst.materials[:64]):
            if mat is not None:
                slot_tables[inst_id, s] = _resolve_mat(mat_index, mat,
                                                       inst.name)
    inst_rows = geo["inst_rows"]
    tri_mat = np.where(
        inst_rows >= 0,
        slot_tables[np.clip(inst_rows, 0, None), geo["slot_rows"]],
        DEFAULT_MATERIAL_ID).astype(np.int32)

    # texture-alpha cutouts: a triangle whose material has a color texture
    # AND alpha < 1 (JAX _cutout_from_soup)
    tm = tri_mat[:n_tri]
    if ((mat_maps[tm, 0] >= 0) & (mat_color[tm, 3] < 1.0 - 1e-6)).any():
        raise NotImplementedError(
            "texture-alpha cutout shadows are not ported yet (ROADMAP A10)")
    if all_maps:
        raise NotImplementedError(
            "texture maps are not ported yet (ROADMAP A9)")

    tri_pack = _pack_tri_rows(geo["tri_v0"], geo["tri_e1"], geo["tri_e2"],
                              geo["tri_n0"], geo["tri_n1"], geo["tri_n2"],
                              geo["tri_t0"], geo["tri_t1"], geo["tri_t2"],
                              tri_mat, inst_rows)
    arrays = dict(
        tri_v0=geo["tri_v0"], tri_e1=geo["tri_e1"], tri_e2=geo["tri_e2"],
        tri_mat=tri_mat, tri_inst=inst_rows, tri_pack=tri_pack,
        mat_color=mat_color,
        mat_metalness=np.array([m.metalness for m in materials], np.float32),
        mat_roughness=np.array([m.roughness for m in materials], np.float32),
        mat_emission=np.array([m.emission for m in materials], np.float32),
        mat_ior=np.array([m.ior for m in materials], np.float32),
        mat_scattering=np.array([m.scattering for m in materials], np.float32),
        mat_maps=mat_maps,
        **_light_fields(world), **geo["cl_fields"])
    statics = dict(n_triangles=n_tri, n_materials=len(materials),
                   n_spot_lights=len(world.spot_lights),
                   n_direct_lights=len(world.direct_lights),
                   n_instances=len(world.instances),
                   n_clusters=geo["n_clusters"])
    return scene_from_arrays(arrays, statics, device)


def _soup_geometry(world: World, leaf_size: int, cache: Optional[dict]):
    """Flatten instances into the world-space soup, build the BVH + cluster
    tables, pad to bucketed shapes. Material-independent (slots stay
    mesh-local), so a materials-only edit reuses this block via ``cache``."""
    key = _geometry_key(world, leaf_size)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit

    v0s, e1s, e2s = [], [], []
    n0s, n1s, n2s = [], [], []
    t0s, t1s, t2s = [], [], []
    slots, insts = [], []
    refs = []
    for inst_id, inst in enumerate(world.instances):
        mesh = inst.mesh
        if mesh is None or mesh.triangle_count == 0:
            continue
        refs.append((inst, mesh))
        tr = inst.effective_transform()
        wv = tr.points_l2g(mesh.vertices).astype(np.float32)
        v0 = wv[mesh.tri_v[:, 0]]
        v1 = wv[mesh.tri_v[:, 1]]
        v2 = wv[mesh.tri_v[:, 2]]
        flat = nrm(np.cross(v1 - v0, v2 - v0)).astype(np.float32)
        if len(mesh.normals):
            wn = tr.normals_l2g(mesh.normals).astype(np.float32)

            def vtx_normal(col):
                idx = mesh.tri_n[:, col]
                ok = idx >= 0
                out = flat.copy()
                out[ok] = wn[idx[ok]]
                return out
            n0, n1, n2 = vtx_normal(0), vtx_normal(1), vtx_normal(2)
        else:
            n0 = n1 = n2 = flat
        if len(mesh.texcrds):
            def vtx_uv(col):
                idx = mesh.tri_t[:, col]
                ok = idx >= 0
                out = np.zeros((len(idx), 2), np.float32)
                out[ok] = mesh.texcrds[idx[ok]]
                return out
            t0, t1, t2 = vtx_uv(0), vtx_uv(1), vtx_uv(2)
        else:
            t0 = t1 = t2 = np.zeros((len(v0), 2), np.float32)
        v0s.append(v0); e1s.append(v1 - v0); e2s.append(v2 - v0)
        n0s.append(n0); n1s.append(n1); n2s.append(n2)
        t0s.append(t0); t1s.append(t1); t2s.append(t2)
        slots.append(np.clip(mesh.tri_mat, 0, 63).astype(np.int32))
        insts.append(np.full(len(v0), inst_id, np.int32))

    if v0s:
        tri_v0 = np.concatenate(v0s); tri_e1 = np.concatenate(e1s); tri_e2 = np.concatenate(e2s)
        tri_n0 = np.concatenate(n0s); tri_n1 = np.concatenate(n1s); tri_n2 = np.concatenate(n2s)
        tri_t0 = np.concatenate(t0s); tri_t1 = np.concatenate(t1s); tri_t2 = np.concatenate(t2s)
        slot_rows = np.concatenate(slots); inst_rows = np.concatenate(insts)
    else:
        tri_v0 = tri_e1 = tri_e2 = np.zeros((0, 3), np.float32)
        tri_n0 = tri_n1 = tri_n2 = np.zeros((0, 3), np.float32)
        tri_t0 = tri_t1 = tri_t2 = np.zeros((0, 2), np.float32)
        slot_rows = np.zeros(0, np.int32); inst_rows = np.zeros(0, np.int32)

    n_tri = len(tri_v0)

    # ---- BVH over world-space triangles + reorder into leaf order ----
    if n_tri:
        pmin, pmax = triangle_aabbs(tri_v0, tri_v0 + tri_e1, tri_v0 + tri_e2)
        bvh: FlatBVH = build_bvh(pmin, pmax, leaf_size=leaf_size)
        o = bvh.order
        tri_v0, tri_e1, tri_e2 = tri_v0[o], tri_e1[o], tri_e2[o]
        tri_n0, tri_n1, tri_n2 = tri_n0[o], tri_n1[o], tri_n2[o]
        tri_t0, tri_t1, tri_t2 = tri_t0[o], tri_t1[o], tri_t2[o]
        slot_rows, inst_rows = slot_rows[o], inst_rows[o]

    # pad to a bucketed size; the padded tail never hits (v0 far, zero edges)
    n_tri_pad = _bucket(n_tri)
    tri_v0 = _pad_rows(tri_v0, n_tri_pad, 1e30)
    tri_e1 = _pad_rows(tri_e1, n_tri_pad, 0.0)
    tri_e2 = _pad_rows(tri_e2, n_tri_pad, 0.0)
    tri_n0 = _pad_rows(tri_n0, n_tri_pad, 0.0)
    tri_n1 = _pad_rows(tri_n1, n_tri_pad, 0.0)
    tri_n2 = _pad_rows(tri_n2, n_tri_pad, 0.0)
    tri_t0 = _pad_rows(tri_t0, n_tri_pad, 0.0)
    tri_t1 = _pad_rows(tri_t1, n_tri_pad, 0.0)
    tri_t2 = _pad_rows(tri_t2, n_tri_pad, 0.0)
    slot_rows = _pad_rows(slot_rows, n_tri_pad, 0)
    inst_rows = _pad_rows(inst_rows, n_tri_pad, -1)

    # cluster tables; an empty world gets an all-padding table (the JAX
    # package has none and takes its dense path there)
    cl_box, cl_lw, cl_order, cl_base, cl_count = build_cluster_tables(
        tri_v0[:n_tri], tri_e1[:n_tri], tri_e2[:n_tri])
    value = dict(
        n_tri=n_tri, n_tri_pad=n_tri_pad,
        tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
        tri_n0=tri_n0, tri_n1=tri_n1, tri_n2=tri_n2,
        tri_t0=tri_t0, tri_t1=tri_t1, tri_t2=tri_t2,
        slot_rows=slot_rows, inst_rows=inst_rows,
        cl_fields=dict(cl_box=cl_box, cl_lw=cl_lw,
                       # order padded to the triangle bucket, as in JAX
                       cl_order=_pad_rows(cl_order, n_tri_pad, 0),
                       cl_base=cl_base, cl_count=cl_count),
        n_clusters=int((cl_count > 0).sum()),
        refs=refs,  # pin object identity: id() reuse cannot false-hit
    )
    if cache is not None:
        for stale in [k2 for k2 in cache
                      if isinstance(k2, tuple) and k2[0] == "soup_geo"]:
            del cache[stale]
        cache[key] = value
    return value


def _light_fields(world: World) -> dict:
    """Light SoA tables (padded to >= 1 row so shapes stay static; counts
    gate usage)."""
    sl = list(world.spot_lights)
    dl = list(world.direct_lights)
    spot_pos = np.stack([l.position for l in sl]) if sl else np.zeros((1, 3), np.float32)
    spot_dir = np.stack([l.direction for l in sl]) if sl else np.tile([[0, -1, 0]], (1, 1)).astype(np.float32)
    spot_color = np.stack([l.color for l in sl]) if sl else np.ones((1, 3), np.float32)
    spot_size = np.array([l.size for l in sl], np.float32) if sl else np.zeros(1, np.float32)
    spot_emission = np.array([l.emission for l in sl], np.float32) if sl else np.zeros(1, np.float32)
    spot_cos = np.array([l.cos_beam_angle for l in sl], np.float32) if sl else np.ones(1, np.float32)
    dir_dir = np.stack([l.direction for l in dl]) if dl else np.tile([[0, -1, 0]], (1, 1)).astype(np.float32)
    dir_color = np.stack([l.color for l in dl]) if dl else np.ones((1, 3), np.float32)
    dir_emission = np.array([l.emission for l in dl], np.float32) if dl else np.zeros(1, np.float32)
    dir_cos = np.array([l.cos_angular_size for l in dl], np.float32) if dl else np.ones(1, np.float32)
    return dict(
        spot_pos=spot_pos, spot_dir=spot_dir, spot_color=spot_color,
        spot_size=spot_size, spot_emission=spot_emission,
        spot_cos_angle=spot_cos, dir_dir=dir_dir, dir_color=dir_color,
        dir_emission=dir_emission, dir_cos=dir_cos)


_STATICS = ("n_triangles", "n_materials", "n_spot_lights", "n_direct_lights",
            "n_instances", "n_clusters")


def scene_from_arrays(leaves: dict, statics: dict, device="cpu") -> TorchScene:
    """Build a TorchScene from named NumPy arrays (for example the leaves of
    a JAX ``DeviceScene``, each converted with ``np.asarray``) and its static
    counts. Extra leaves are ignored. Scenes with the unported features
    (``two_level``, ``has_maps``, ``n_cutout``) raise NotImplementedError."""
    if statics.get("two_level"):
        raise NotImplementedError(
            "two-level instanced scenes are not ported yet (ROADMAP A11)")
    if statics.get("has_maps"):
        raise NotImplementedError("texture maps are not ported yet (ROADMAP A9)")
    if statics.get("n_cutout"):
        raise NotImplementedError(
            "texture-alpha cutout shadows are not ported yet (ROADMAP A10)")
    tensors = {}
    for f in dataclasses.fields(TorchScene):
        if f.name in _STATICS:
            continue
        a = leaves.get(f.name)
        if a is None:
            raise ValueError(f"scene leaf {f.name!r} is missing")
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        elif a.dtype.kind in "iu":
            a = a.astype(np.int32)
        tensors[f.name] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return TorchScene(**tensors, **{k: int(statics[k]) for k in _STATICS})
