"""World -> device scene compilation (SoA torch tensors).

Counterpart of ``rayzath_tpu/models/device_scene.py`` (``compile_world``
with its soup and two-level branches, ``_soup_geometry``,
``_two_level_arrays``, ``_pack_tri_rows``, ``_light_fields``,
``compile_camera``). The whole scene is flattened on the host (NumPy) into
SoA arrays, which become tensors on one explicit device:

* **Soup:** every instance's mesh is transformed into world space and
  concatenated into one triangle list carrying a global material id and an
  instance id, reordered by a leaf-8 BVH exactly as the JAX package does
  (so triangle ids agree between the packages), then split into the flat
  cluster tables of ``ops/traverse_cluster.py``.
* **Two-level:** each mesh keeps one object-space cluster table, shared by
  all of its instances, and each instance gets a row with its world AABB,
  world->object transform and cluster range (``build_instance_tables``).
  ``tri_*`` and ``tri_pack`` then hold object-space per-mesh geometry in
  device (cluster) order, with the mesh-local material slot in column 24;
  the integrator moves a hit to world space through ``inst_fwd`` /
  ``inst_nrm`` and resolves its material through ``inst_slot_map``.

``compile_world`` picks the structure as the JAX package does; the fields
of the structure not chosen hold small placeholders (:func:`placeholders`).

Both structures also get the texture atlases and per-map tables (all maps
shelf-packed into one RGBA and one scalar atlas, with the 2x2 block tables
of ``ops/texture.py``) and the texture-alpha "cutout" set: the world-space
triangles whose material has a color texture and alpha < 1, whose texture
term the integrator's dense cutout pass multiplies into the shadow
kernels' constant opacity. A soup scene with such a set also gets it per
slot of its cluster table (``cl_cut_map``, ``cl_cut_uv``;
:func:`cutout_slots`), which B2's cutout variant reads at its own hits on a
card (``engine/integrator.py`` ``shadow_route``). With ``differentiable=True`` a two-level scene
also gets the expanded (instance, triangle) lists ``exp_tri``/``exp_inst``
that only the B4 backward reads (317,954 rows on ``instanced_field``, so
the serve path never builds them).

A soup scene also gets the dense projection frames ``tri_pw``/``tri_pc``
of every (padded) triangle, which the dense path reads
(``brute_force_threshold``); an empty world gets no cluster table
(``cl_box`` and the other ``cl_*`` fields None), as in the JAX package, and
always takes that path.

A soup scene also gets the tables of the skip-link BVH walk
(``ops/traverse.py``, ``packet_traversal=False``): ``aabb_links``, the
per-octant [8, 8N] node table of ``build_aabb_links`` over the links of
``ops/bvh.py`` ``compute_skip_links``, and the leaf ranges ``node_begin`` /
``node_count`` of the same BVH, always, as in the JAX package; and, the
port's own, ``leaf_tri``, the walk's leaf blocks of ``leaf_size`` lanes
(``ops/traverse.py`` ``leaf_table``), which the JAX walk rebuilds inside
every call. A two-level scene and the empty world hold the JAX two-level
scene's placeholders there (:func:`_no_skip_links`; no path reads them).

Not built, because no path of the port reads them: the per-vertex
normal/texcoord columns outside ``tri_pack`` and the cutouts' raw geometry
(``cut_v0``/``cut_e1``/``cut_e2``, read only by the JAX package's NumPy
oracle).

``compile_world``'s parts are spans (``utils/timing.span``): ``rz::geometry``
(the soup or two-level geometry, BVH builds included), ``rz::atlas`` (the
atlases and map tables), ``rz::cutouts`` (a soup's per-slot cutout tables)
and ``rz::upload`` (``scene_from_arrays``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops.bvh import build_bvh, compute_skip_links, triangle_aabbs, FlatBVH
from ..ops.intersect import triangle_frames
from ..ops.texture import block_indices
from ..ops.traverse import build_aabb_links, leaf_table
from ..ops.traverse_cluster import (build_cluster_tables,
                                    build_instance_tables, cluster_slot_rows,
                                    group_table, B_MIN, B_MAX, B_BASE, B_CNT,
                                    CLUSTER_T, SLOTS)
from ..utils.device import DEFAULT, resolve
from ..utils.hostmath import normalize as nrm, transform_matrices
from ..utils.timing import span
from .material import Material
from .texture import TextureMap
from .world import World

WORLD_MATERIAL_ID = 0
DEFAULT_MATERIAL_ID = 1
NO_MAP = -1
DEFAULT_LEAF_SIZE = 8        # BVH leaf size, RenderConfig.bvh_leaf_size's default


@dataclasses.dataclass
class TorchScene:
    # geometry (soup: world space, BVH leaf order; two-level: object space,
    # device order), padded to a bucketed n_tri_pad
    tri_v0: torch.Tensor         # [F,3]
    tri_e1: torch.Tensor         # [F,3]
    tri_e2: torch.Tensor         # [F,3]
    tri_mat: torch.Tensor        # [F] i32 global material id (soup)
    tri_inst: torch.Tensor       # [F] i32 instance id (soup picking)
    # per-hit shading row: v0 0:3 | e1 3:6 | e2 6:9 | n0 9:12 | n1 12:15 |
    # n2 15:18 | t0 18:20 | t1 20:22 | t2 22:24 | mat (soup) or mesh-local
    # slot (two-level) 24 | inst (soup; -1 two-level) 25 | pad
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

    # two-level instance tables (placeholders on the soup path)
    ti_rows: torch.Tensor        # [Ip,24] instance rows (AABB, inv, range, id)
    cl_obox: torch.Tensor        # [Cm,8] object-space cluster rows
    cl_slot: torch.Tensor        # [Cm,128] f32 per-cluster triangle slots
    tri_slot: torch.Tensor       # [F] i32 mesh-local material slot
    inst_fwd: torch.Tensor       # [I,12] object->world 3x4 (row-major)
    inst_nrm: torch.Tensor       # [I,9] normal matrix 3x3 (row-major)
    inst_slot_map: torch.Tensor  # [I,64] i32 material slot -> global id

    # texture atlases + per-map tables (an 8x8 zero atlas when no map)
    color_atlas: torch.Tensor    # [Hc,Wc,4]
    scalar_atlas: torch.Tensor   # [Hs,Ws]
    map_rect: torch.Tensor       # [K,4] i32: y0, x0, h, w
    map_flags: torch.Tensor      # [K,3] i32: filter, address, atlas (0 color)
    map_uv: torch.Tensor         # [K,5]: scale_x, scale_y, rotation, tx, ty
    col_blk_idx: torch.Tensor    # [Hc*Wc,4] i32 2x2 block texel indices
    sc_blk_idx: torch.Tensor     # [Hs*Ws,4] i32

    # cluster tables (ops/traverse_cluster.py; None on an empty soup
    # world); two-level: cl_lw, cl_base and cl_count hold the shared
    # per-mesh tables, cl_box and cl_order are placeholders
    cl_box: Optional[torch.Tensor] = None    # [8,Cp] AABB / base / count table
    cl_lw: Optional[torch.Tensor] = None     # [Cp,4,384] cluster-local frames
    cl_order: Optional[torch.Tensor] = None  # [F] i32 cluster order -> soup index
    cl_base: Optional[torch.Tensor] = None   # [Cp] i32 first triangle (cluster order)
    cl_count: Optional[torch.Tensor] = None  # [Cp] i32 triangle count
    cl_group: Optional[torch.Tensor] = None  # [8,Gp] group table of cl_box
    # dense projection frames of the soup's triangles (ops/intersect.py;
    # two-level: placeholders)
    tri_pw: Optional[torch.Tensor] = None    # [3,3F]
    tri_pc: Optional[torch.Tensor] = None    # [3F]
    # skip-link walk tables (ops/traverse.py; two-level and the empty
    # world: placeholders)
    aabb_links: Optional[torch.Tensor] = None  # [8,8N] per-octant node table
    node_begin: Optional[torch.Tensor] = None  # [N] i32 first triangle / child
    node_count: Optional[torch.Tensor] = None  # [N] i32 (0 = inner node)
    leaf_tri: Optional[torch.Tensor] = None    # [NB,L] i32 leaf blocks' ids
    # texture-alpha cutout set, world space (None when n_cutout == 0)
    cut_pw: Optional[torch.Tensor] = None    # [3,3C] projection frames
    cut_pc: Optional[torch.Tensor] = None    # [3C]
    cut_t0: Optional[torch.Tensor] = None    # [C,2] texcrds
    cut_t1: Optional[torch.Tensor] = None
    cut_t2: Optional[torch.Tensor] = None
    cut_map: Optional[torch.Tensor] = None   # [C] i32 texture map id
    # the same set per slot of the soup's cluster table (cutout_slots; None
    # when n_cutout == 0, on a two-level scene and without a cluster table)
    cl_cut_map: Optional[torch.Tensor] = None  # [Cp,128] i32 map id, -1 none
    cl_cut_uv: Optional[torch.Tensor] = None   # [Cp,128,6] t0, t1-t0, t2-t0
    # expanded (instance, triangle) lists of a two-level scene, for the B4
    # backward (None unless compiled with differentiable=True)
    exp_tri: Optional[torch.Tensor] = None   # [K] i32 device-order triangle
    exp_inst: Optional[torch.Tensor] = None  # [K] i32 global instance

    n_triangles: int = 0
    n_materials: int = 2
    n_spot_lights: int = 0
    n_direct_lights: int = 0
    n_instances: int = 0
    n_clusters: int = 0          # REAL clusters (soup; tables are 128-padded)
    max_ncl: int = 0             # two-level: most real clusters of one mesh
    n_cutout: int = 0
    two_level: bool = False
    has_maps: bool = False       # any map in the world (even an unused one)
    # which of (texture, normal, metalness, roughness, emission) a material
    # references: the integrator skips the fetches of absent kinds
    map_kinds_used: tuple = (False,) * 5


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


def compile_camera(cam, device=DEFAULT) -> TorchCamera:
    device = resolve(device)
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
# world compilation (host side copied from the JAX package)
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


def compile_world(world: World, leaf_size: int = DEFAULT_LEAF_SIZE,
                  two_level: Optional[bool] = None,
                  cache: Optional[dict] = None,
                  device=DEFAULT, differentiable: bool = False) -> TorchScene:
    """Flatten the host world into a TorchScene on ``device`` (see module
    docstring). ``two_level``: False = world-space soup, True = shared
    per-mesh object-space tables + instance rows, None = the JAX package's
    automatic choice (:func:`_two_level_auto`). ``cache`` memoizes the
    geometry blocks and the atlases by version, as in the JAX package, so a
    materials-or-lights-only edit rebuilds only the cheap binding tables.
    ``differentiable`` builds what only the gradient path reads (a
    two-level scene's ``exp_tri``/``exp_inst``)."""
    device = resolve(device)
    if two_level is None:
        two_level = _two_level_auto(world)

    materials: list[Material] = ([world.material, world.default_material]
                                 + list(world.materials))
    mat_index = {id(m): i for i, m in enumerate(materials)}
    # map ids: color maps (textures, normal maps) then scalar maps
    color_maps: list[TextureMap] = list(world.textures) + list(world.normal_maps)
    all_maps: list[TextureMap] = color_maps + (
        list(world.metalness_maps) + list(world.roughness_maps)
        + list(world.emission_maps))
    map_id = {id(m): i for i, m in enumerate(all_maps)}

    def map_ref(m: Optional[TextureMap]) -> int:
        return NO_MAP if m is None else map_id[id(m)]

    mat_color = np.stack([m.color for m in materials]).astype(np.float32)
    mat_maps = np.array(
        [[map_ref(m.texture), map_ref(m.normal_map), map_ref(m.metalness_map),
          map_ref(m.roughness_map), map_ref(m.emission_map)] for m in materials],
        np.int32)
    common = dict(
        mat_color=mat_color,
        mat_metalness=np.array([m.metalness for m in materials], np.float32),
        mat_roughness=np.array([m.roughness for m in materials], np.float32),
        mat_emission=np.array([m.emission for m in materials], np.float32),
        mat_ior=np.array([m.ior for m in materials], np.float32),
        mat_scattering=np.array([m.scattering for m in materials], np.float32),
        mat_maps=mat_maps, **_light_fields(world))
    with span("atlas"):
        common.update(_atlas_fields(all_maps, len(color_maps), cache))
    statics = dict(n_materials=len(materials),
                   n_spot_lights=len(world.spot_lights),
                   n_direct_lights=len(world.direct_lights),
                   n_instances=len(world.instances),
                   has_maps=len(all_maps) > 0,
                   map_kinds_used=tuple(bool((mat_maps[:, k] >= 0).any())
                                        for k in range(5)))

    if two_level:
        cut = _cutout_fields(world, mat_index, mat_color, mat_maps)
        with span("geometry"):
            geo = _two_level_arrays(world, mat_index, cache, differentiable)
        max_ncl = geo.pop("max_ncl")
        n_tri = geo.pop("n_tri")
        with span("upload"):
            return scene_from_arrays(
                dict(**geo, **common, **cut),
                dict(statics, n_triangles=n_tri, n_clusters=0,
                     max_ncl=max_ncl, n_cutout=len(cut.get("cut_map", ())),
                     two_level=True), device)

    with span("geometry"):
        geo = _soup_geometry(world, leaf_size, cache)
    n_tri = geo["n_tri"]

    # material binding: instance slot tables -> per-triangle global ids
    slot_tables = np.full((max(len(world.instances), 1), SLOTS),
                          DEFAULT_MATERIAL_ID, np.int32)
    for inst_id, inst in enumerate(world.instances):
        slot_tables[inst_id] = _slot_table(mat_index, inst)
    inst_rows = geo["inst_rows"]
    tri_mat = np.where(
        inst_rows >= 0,
        slot_tables[np.clip(inst_rows, 0, None), geo["slot_rows"]],
        DEFAULT_MATERIAL_ID).astype(np.int32)

    tri_pack = _pack_tri_rows(geo["tri_v0"], geo["tri_e1"], geo["tri_e2"],
                              geo["tri_n0"], geo["tri_n1"], geo["tri_n2"],
                              geo["tri_t0"], geo["tri_t1"], geo["tri_t2"],
                              tri_mat, inst_rows)
    cut = _cutout_from_soup(geo, tri_mat, mat_color, mat_maps)
    if cut and geo["cl_fields"]:
        with span("cutouts"):
            cut.update(cutout_slots(geo, tri_mat, mat_color, mat_maps))
    arrays = dict(
        tri_v0=geo["tri_v0"], tri_e1=geo["tri_e1"], tri_e2=geo["tri_e2"],
        tri_mat=tri_mat, tri_inst=inst_rows, tri_pack=tri_pack,
        tri_pw=geo["tri_pw"], tri_pc=geo["tri_pc"],
        **common, **geo["cl_fields"], **geo["skip_fields"], **cut)
    with span("upload"):
        return scene_from_arrays(
            arrays, dict(statics, n_triangles=n_tri,
                         n_clusters=geo["n_clusters"], max_ncl=0,
                         n_cutout=len(cut.get("cut_map", ())),
                         two_level=False), device)


# ---------------------------------------------------------------------------
# texture atlases and cutouts (JAX _pack_shelf, _atlas_fields,
# _cutout_from_soup, _cutout_fields)
# ---------------------------------------------------------------------------

def _pack_shelf(maps: list, channels: int):
    """Shelf-pack maps into one atlas, tallest first. Returns (atlas
    [H, W, channels], rects [K, 4] i32 y0, x0, h, w in the maps' order)."""
    if not maps:
        return np.zeros((8, 8, channels), np.float32), np.zeros((0, 4), np.int32)
    atlas_w = 1 << int(np.ceil(np.log2(max(max(m.width for m in maps), 8))))
    rows: list[dict] = []
    rects = []
    y_cursor = 0
    for m in sorted(range(len(maps)), key=lambda i: -maps[i].height):
        tex = maps[m]
        for row in rows:
            if row["x"] + tex.width <= atlas_w and tex.height <= row["h"]:
                rects.append((m, row["y"], row["x"], tex.height, tex.width))
                row["x"] += tex.width
                break
        else:
            rows.append({"y": y_cursor, "x": tex.width, "h": tex.height})
            rects.append((m, y_cursor, 0, tex.height, tex.width))
            y_cursor += tex.height
    atlas = np.zeros((max(y_cursor, 8), atlas_w, channels), np.float32)
    out = np.zeros((len(maps), 4), np.int32)
    for m, y0, x0, h, w in rects:
        atlas[y0:y0 + h, x0:x0 + w, :] = maps[m].data[:, :, :channels]
        out[m] = (y0, x0, h, w)
    return atlas, out


def _atlas_fields(all_maps: list, n_color: int, cache: Optional[dict]) -> dict:
    """Atlases (cached by map identity and version), per-map tables and the
    2x2 block tables of both atlases."""
    key = ("atlas", tuple((id(m), getattr(m, "version", 0)) for m in all_maps))
    if cache is not None and key in cache:
        color_atlas, color_rects, scalar_atlas, scalar_rects = cache[key]["v"]
    else:
        color_atlas, color_rects = _pack_shelf(all_maps[:n_color], 4)
        scalar3, scalar_rects = _pack_shelf(all_maps[n_color:], 1)
        scalar_atlas = scalar3[:, :, 0]
        if cache is not None:
            for stale in [k for k in cache
                          if isinstance(k, tuple) and k[0] == "atlas"]:
                del cache[stale]
            cache[key] = {"v": (color_atlas, color_rects, scalar_atlas,
                                scalar_rects), "refs": list(all_maps)}
    k = max(len(all_maps), 1)
    map_rect = np.zeros((k, 4), np.int32)
    map_flags = np.zeros((k, 3), np.int32)
    map_uv = np.zeros((k, 5), np.float32)
    map_uv[:, 0:2] = 1.0
    for i, m in enumerate(all_maps):
        in_color = i < n_color
        map_rect[i] = color_rects[i] if in_color else scalar_rects[i - n_color]
        map_flags[i] = (m.filter_mode, m.address_mode, 0 if in_color else 1)
        map_uv[i] = (m.scale[0], m.scale[1], m.rotation, m.translation[0],
                     m.translation[1])
    return dict(
        color_atlas=color_atlas, scalar_atlas=scalar_atlas, map_rect=map_rect,
        map_flags=map_flags, map_uv=map_uv,
        col_blk_idx=block_indices(color_rects, *color_atlas.shape[:2]),
        sc_blk_idx=block_indices(scalar_rects, *scalar_atlas.shape))


def _cutout(gmat, mat_color, mat_maps):
    """Texture-alpha cutout triangles: the resolved material has a color
    texture AND alpha < 1 (when alpha = 1 the constant part already blocks
    the ray; reference cuda_material.cuh:86-95)."""
    return (mat_maps[gmat, 0] >= 0) & (mat_color[gmat, 3] < 1.0 - 1e-6)


def _cut_arrays(v0, e1, e2, t0, t1, t2, maps) -> dict:
    pw, pc = triangle_frames(v0, e1, e2)
    return dict(cut_pw=pw, cut_pc=pc, cut_t0=t0, cut_t1=t1, cut_t2=t2,
                cut_map=np.asarray(maps).astype(np.int32))


def _cutout_from_soup(geo: dict, tri_mat, mat_color, mat_maps) -> dict:
    """The cutout set of a soup scene, taken from the (cached) world-space
    soup in its BVH order; {} when there is none."""
    n = geo["n_tri"]
    tm = tri_mat[:n]
    sel = _cutout(tm, mat_color, mat_maps)
    if not sel.any():
        return {}
    return _cut_arrays(*(geo[k][:n][sel] for k in ("tri_v0", "tri_e1", "tri_e2",
                                                   "tri_t0", "tri_t1", "tri_t2")),
                       mat_maps[tm[sel], 0])


def cutout_slots(geo: dict, tri_mat, mat_color, mat_maps) -> dict:
    """The soup's cutout set per slot of its cluster table, in the order of
    ``cl_order`` / ``cl_base``: ``cl_cut_map`` [Cp, 128] i32, the colour map
    id of slot j of row c's triangle (soup index ``cl_order[cl_base[c] +
    j]``) where it is in the set (:func:`_cutout`), else -1 (padding slots
    too), and ``cl_cut_uv`` [Cp, 128, 6] f32, its texture coordinates t0,
    t1 - t0, t2 - t0 (zero off the set), so that B2's cutout variant
    interpolates t0 + b1 (t1 - t0) + b2 (t2 - t0) as the dense pass does.
    Static: a material edit that changes the set needs a recompile, as for
    the dense pass's set."""
    cl = geo["cl_fields"]
    order, base, count = cl["cl_order"], cl["cl_base"], cl["cl_count"]
    lanes = np.arange(CLUSTER_T)[None, :]
    valid = lanes < count[:, None]
    tri = order[np.clip(base[:, None] + lanes, 0, len(order) - 1)]
    gmat = tri_mat[tri]
    sel = valid & _cutout(gmat, mat_color, mat_maps)
    t0 = geo["tri_t0"][tri]
    uv = np.concatenate([t0, geo["tri_t1"][tri] - t0, geo["tri_t2"][tri] - t0],
                        axis=-1)
    return dict(cl_cut_map=np.where(sel, mat_maps[gmat, 0], -1).astype(np.int32),
                cl_cut_uv=np.where(sel[..., None], uv, 0.0).astype(np.float32))


def _slots_from_leaves(leaves: dict) -> dict:
    """:func:`cutout_slots` of a soup given as named arrays: the cluster
    order and the texture coordinates t0, t1, t2 of ``tri_pack``'s columns
    18-23 (:func:`_pack_tri_rows`)."""
    tp = np.asarray(leaves["tri_pack"])
    geo = {"cl_fields": {k: np.asarray(leaves[k])
                         for k in ("cl_order", "cl_base", "cl_count")},
           "tri_t0": tp[:, 18:20], "tri_t1": tp[:, 20:22],
           "tri_t2": tp[:, 22:24]}
    return cutout_slots(geo, np.asarray(leaves["tri_mat"]),
                        np.asarray(leaves["mat_color"]),
                        np.asarray(leaves["mat_maps"]))


def _cutout_fields(world: World, mat_index, mat_color, mat_maps) -> dict:
    """The world-space cutout set of a two-level scene, instance by
    instance in world order; {} when there is none."""
    parts = [[] for _ in range(7)]
    for inst in world.instances:
        mesh = inst.mesh
        if mesh is None or mesh.triangle_count == 0:
            continue
        gmat = _slot_table(mat_index, inst)[np.clip(mesh.tri_mat, 0, 63)]
        sel = _cutout(gmat, mat_color, mat_maps)
        if not sel.any():
            continue
        wv = inst.effective_transform().points_l2g(mesh.vertices).astype(np.float32)
        tv = mesh.tri_v[sel]
        tt = mesh.tri_t[sel]
        if len(mesh.texcrds):   # a missing texcoord (-1) reads (0, 0)
            uv = np.concatenate([mesh.texcrds.astype(np.float32),
                                 np.zeros((1, 2), np.float32)])
        else:
            uv = np.zeros((1, 2), np.float32)
            tt = np.full_like(tt, -1)
        v0 = wv[tv[:, 0]]
        for lst, a in zip(parts, (v0, wv[tv[:, 1]] - v0, wv[tv[:, 2]] - v0,
                                  uv[tt[:, 0]], uv[tt[:, 1]], uv[tt[:, 2]],
                                  mat_maps[gmat[sel], 0])):
            lst.append(a)
    if not parts[0]:
        return {}
    return _cut_arrays(*(np.concatenate(p) for p in parts))


def _slot_table(mat_index: dict, inst) -> np.ndarray:
    """[SLOTS] i32 global material id of each of an instance's slots."""
    table = np.full(SLOTS, DEFAULT_MATERIAL_ID, np.int32)
    for s, mat in enumerate(inst.materials[:SLOTS]):
        if mat is not None:
            table[s] = _resolve_mat(mat_index, mat, inst.name)
    return table


# ---------------------------------------------------------------------------
# two-level structure (JAX _mesh_object_arrays .. _two_level_arrays)
# ---------------------------------------------------------------------------

def _mesh_object_arrays(mesh):
    """Object-space SoA shading arrays for one mesh (original triangle
    order): (v0, e1, e2, n0, n1, n2, t0, t1, t2, slot)."""
    v = np.asarray(mesh.vertices, np.float32)
    v0 = v[mesh.tri_v[:, 0]]
    v1 = v[mesh.tri_v[:, 1]]
    v2 = v[mesh.tri_v[:, 2]]
    flat = nrm(np.cross(v1 - v0, v2 - v0)).astype(np.float32)
    if len(mesh.normals):
        on = nrm(np.asarray(mesh.normals, np.float32))

        def vtx_normal(col):
            idx = mesh.tri_n[:, col]
            ok = idx >= 0
            out = flat.copy()
            out[ok] = on[idx[ok]]
            return out
        n0, n1, n2 = vtx_normal(0), vtx_normal(1), vtx_normal(2)
    else:
        n0 = n1 = n2 = flat
    if len(mesh.texcrds):
        def vtx_uv(col):
            idx = mesh.tri_t[:, col]
            ok = idx >= 0
            out = np.zeros((len(idx), 2), np.float32)
            out[ok] = np.asarray(mesh.texcrds, np.float32)[idx[ok]]
            return out
        t0, t1, t2 = vtx_uv(0), vtx_uv(1), vtx_uv(2)
    else:
        t0 = t1 = t2 = np.zeros((len(v0), 2), np.float32)
    slot = np.clip(np.asarray(mesh.tri_mat, np.int64), 0, 63).astype(np.int32)
    return v0, v1 - v0, v2 - v0, n0, n1, n2, t0, t1, t2, slot


def _aabb_l2g(fwd, cmin, cmax):
    """World AABBs of object-space boxes ([C,3] each) under a 3x4 transform:
    per output axis, the sum of the per-input-axis min/max of
    L_ij * {cmin_j, cmax_j} (exact for affine transforms, rounded in f32)."""
    lin = fwd[:, :3]
    m1 = cmin[:, None, :] * lin[None, :, :]
    m2 = cmax[:, None, :] * lin[None, :, :]
    lo = np.minimum(m1, m2).sum(-1) + fwd[:, 3]
    hi = np.maximum(m1, m2).sum(-1) + fwd[:, 3]
    return lo.astype(np.float32), hi.astype(np.float32)


def _mesh_cluster_block(m, cache: Optional[dict]):
    """Object-space cluster tables + cluster-ordered shading arrays of one
    mesh, memoized in ``cache`` by (id, version), so a transform or material
    edit reuses every untouched mesh's build. :func:`_two_level_arrays`
    evicts the entries of meshes that are gone or changed."""
    key = ("mesh_cl", id(m), getattr(m, "version", 0))
    if cache is not None and key in cache:
        return cache[key]
    v0, e1, e2, n0, n1, n2, t0, t1, t2, slot = _mesh_object_arrays(m)
    box_m, frames_m, o, base_m, count_m = build_cluster_tables(v0, e1, e2)
    c = int((count_m > 0).sum())   # REAL clusters (tables are 128-padded)
    value = dict(
        arrays=tuple(a[o] for a in (v0, e1, e2, n0, n1, n2, t0, t1, t2)),
        slot=slot[o], frames=frames_m, base=base_m, count=count_m,
        cmin=box_m[B_MIN:B_MIN + 3, :c].T.copy(),
        cmax=box_m[B_MAX:B_MAX + 3, :c].T.copy(),
        obox6=box_m.T[:, :6].copy(),   # padded rows (inverted pad boxes)
        ref=m)                         # pin identity: id() reuse cannot hit
    if cache is not None:
        cache[key] = value
    return value


def _two_level_arrays(world: World, mat_index: dict,
                      cache: Optional[dict] = None,
                      expanded: bool = False) -> dict:
    """Two-level geometry: the shared per-mesh object-space cluster tables
    (concatenated, each mesh padded to a multiple of 128 rows), the
    instance rows and the per-instance transforms and slot tables; with
    ``expanded``, also the (instance, triangle) lists of every live
    instance in world order (``exp_tri`` device-order triangle, ``exp_inst``
    global instance)."""
    meshes: list = []
    mesh_pos: dict[int, int] = {}
    valid: list = []
    for gi, inst in enumerate(world.instances):
        m = inst.mesh
        if m is None or m.triangle_count == 0:
            continue
        if id(m) not in mesh_pos:
            mesh_pos[id(m)] = len(meshes)
            meshes.append(m)
        valid.append((gi, inst))

    arrays = [[] for _ in range(9)]
    slots, frames_parts, base_parts, count_parts, obox_parts = [], [], [], [], []
    mesh_box, mesh_cl0, mesh_tri_base = [], [], []
    tri_base = cl_base_row = 0
    for m in meshes:
        blk = _mesh_cluster_block(m, cache)
        for lst, arr in zip(arrays, blk["arrays"]):
            lst.append(arr)
        slots.append(blk["slot"])
        frames_parts.append(blk["frames"])
        base_parts.append(blk["base"] + tri_base)
        count_parts.append(blk["count"])
        obox_parts.append(blk["obox6"])
        mesh_box.append((blk["cmin"], blk["cmax"]))
        mesh_cl0.append(cl_base_row)
        mesh_tri_base.append(tri_base)
        cl_base_row += len(blk["base"])  # padded length: concat offsets
        tri_base += len(blk["arrays"][0])
    if cache is not None:
        # evict the blocks of meshes that were removed or edited
        live = {("mesh_cl", id(m), getattr(m, "version", 0)) for m in meshes}
        for stale in [k for k in cache if isinstance(k, tuple)
                      and k[0] == "mesh_cl" and k not in live]:
            del cache[stale]

    n_inst = max(len(world.instances), 1)
    inst_fwd = np.tile(np.eye(3, 4, dtype=np.float32).reshape(1, 12), (n_inst, 1))
    inst_nrm = np.tile(np.eye(3, dtype=np.float32).reshape(1, 9), (n_inst, 1))
    inst_slot_map = np.full((n_inst, SLOTS), DEFAULT_MATERIAL_ID, np.int32)
    i_min, i_max, i_inv, i_cl0, i_ncl, i_gid = ([] for _ in range(6))
    exp_tri, exp_inst = [], []
    for gi, inst in valid:
        mi = mesh_pos[id(inst.mesh)]
        if expanded:
            ntri = inst.mesh.triangle_count
            exp_tri.append(np.arange(ntri, dtype=np.int32) + mesh_tri_base[mi])
            exp_inst.append(np.full(ntri, gi, np.int32))
        fwd, inv, nmat = transform_matrices(inst.effective_transform())
        inst_fwd[gi] = fwd.reshape(12)
        inst_nrm[gi] = nmat.reshape(9)
        inst_slot_map[gi] = _slot_table(mat_index, inst)
        # world AABB of the instance = union of its transformed cluster boxes
        wmin, wmax = _aabb_l2g(fwd, *mesh_box[mi])
        i_min.append(wmin.min(0))
        i_max.append(wmax.max(0))
        i_inv.append(inv)
        i_cl0.append(mesh_cl0[mi])
        i_ncl.append(len(mesh_box[mi][0]))
        i_gid.append(gi)

    ti_rows = build_instance_tables(
        np.asarray(i_min, np.float32).reshape(-1, 3),
        np.asarray(i_max, np.float32).reshape(-1, 3),
        np.asarray(i_inv, np.float32).reshape(-1, 3, 4),
        np.asarray(i_cl0, np.int32), np.asarray(i_ncl, np.int32),
        np.asarray(i_gid, np.int32))
    if meshes:
        cl_lw = np.concatenate(frames_parts)
        cl_base = np.concatenate(base_parts)
        cl_count = np.concatenate(count_parts)
        cl_obox = np.zeros((len(cl_base), 8), np.float32)
        cl_obox[:, :6] = np.concatenate(obox_parts)
        cl_obox[:, B_BASE] = cl_base.astype(np.float32)
        cl_obox[:, B_CNT] = cl_count.astype(np.float32)
        cols = [np.concatenate(a) for a in arrays]
        tri_slot = np.concatenate(slots)
    else:
        cl_lw = np.zeros((1, 4, 384), np.float32)
        cl_base = np.zeros(1, np.int32)
        cl_count = np.zeros(1, np.int32)
        cl_obox = _empty_obox()
        cols = [np.zeros((0, 3), np.float32)] * 6 + [np.zeros((0, 2), np.float32)] * 3
        tri_slot = np.zeros(0, np.int32)

    n_tri_pad = _bucket(tri_base)
    fills = (1e30,) + (0.0,) * 8
    cols = [_pad_rows(a, n_tri_pad, f) for a, f in zip(cols, fills)]
    tri_slot = _pad_rows(tri_slot, n_tri_pad, 0)
    return dict(
        tri_v0=cols[0], tri_e1=cols[1], tri_e2=cols[2], tri_slot=tri_slot,
        tri_pack=_pack_tri_rows(*cols, tri_slot,
                                np.full(n_tri_pad, -1, np.int32)),
        # soup fields the two-level path never reads (as in the JAX scene)
        tri_mat=np.zeros(n_tri_pad, np.int32),
        tri_inst=np.full(n_tri_pad, -1, np.int32),
        cl_lw=cl_lw, cl_base=cl_base, cl_count=cl_count, ti_rows=ti_rows,
        cl_obox=cl_obox, cl_slot=cluster_slot_rows(tri_slot, cl_base, cl_count),
        inst_fwd=inst_fwd, inst_nrm=inst_nrm, inst_slot_map=inst_slot_map,
        max_ncl=int(max(i_ncl)) if i_ncl else 0, n_tri=tri_base,
        **(dict(exp_tri=np.concatenate(exp_tri) if exp_tri else np.zeros(1, np.int32),
                exp_inst=np.concatenate(exp_inst) if exp_inst else np.zeros(1, np.int32))
           if expanded else {}))


def _empty_obox() -> np.ndarray:
    obox = np.zeros((1, 8), np.float32)
    obox[:, B_MIN:B_MIN + 3] = 3e38
    obox[:, B_MAX:B_MAX + 3] = -3e38
    return obox


def _no_skip_links() -> dict:
    """The skip-link tables of a scene without a soup BVH to walk (the JAX
    two-level scene's inert fields, device_scene.py:554-556)."""
    return dict(aabb_links=np.zeros((8, 8), np.float32),
                node_begin=np.zeros(1, np.int32),
                node_count=np.zeros(1, np.int32),
                leaf_tri=np.full((1, DEFAULT_LEAF_SIZE), -1, np.int32))


def placeholders(two_level: bool) -> dict:
    """Small stand-ins for the fields that only the other structure reads:
    on a two-level scene the soup's ``cl_box`` (all padding), ``cl_order``,
    dense frames and skip-link tables (the JAX scene's inert ``tri_pw``,
    ``tri_pc``, ``aabb_links`` and ``node_*``); on a soup scene the
    instance tables (no real row)."""
    if two_level:
        box = np.zeros((8, 128), np.float32)
        box[B_MIN:B_MIN + 3] = 3e38
        box[B_MAX:B_MAX + 3] = -3e38
        return dict(cl_box=box, cl_order=np.zeros(1, np.int32),
                    tri_pw=np.zeros((3, 3), np.float32),
                    tri_pc=np.zeros(3, np.float32), **_no_skip_links())
    return dict(
        ti_rows=build_instance_tables(np.zeros((0, 3)), np.zeros((0, 3)),
                                      np.zeros((0, 3, 4)), np.zeros(0),
                                      np.zeros(0), np.zeros(0)),
        cl_obox=_empty_obox(), cl_slot=np.zeros((1, 128), np.float32),
        tri_slot=np.zeros(1, np.int32),
        inst_fwd=np.eye(3, 4, dtype=np.float32).reshape(1, 12),
        inst_nrm=np.eye(3, dtype=np.float32).reshape(1, 9),
        inst_slot_map=np.full((1, SLOTS), DEFAULT_MATERIAL_ID, np.int32))


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

    # ---- BVH over world-space triangles + reorder into leaf order, and
    # the skip-link walk's tables of that BVH ----
    skip_fields = _no_skip_links()
    if n_tri:
        pmin, pmax = triangle_aabbs(tri_v0, tri_v0 + tri_e1, tri_v0 + tri_e2)
        bvh: FlatBVH = build_bvh(pmin, pmax, leaf_size=leaf_size)
        o = bvh.order
        tri_v0, tri_e1, tri_e2 = tri_v0[o], tri_e1[o], tri_e2[o]
        tri_n0, tri_n1, tri_n2 = tri_n0[o], tri_n1[o], tri_n2[o]
        tri_t0, tri_t1, tri_t2 = tri_t0[o], tri_t1[o], tri_t2[o]
        slot_rows, inst_rows = slot_rows[o], inst_rows[o]
        first8, skip8 = compute_skip_links(bvh.node_begin, bvh.node_count,
                                           bvh.node_axis)
        skip_fields = dict(
            aabb_links=build_aabb_links(bvh.node_min, bvh.node_max,
                                        bvh.node_count, first8, skip8),
            node_begin=bvh.node_begin, node_count=bvh.node_count,
            leaf_tri=leaf_table(bvh.node_begin, bvh.node_count, leaf_size))

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

    tri_pw, tri_pc = triangle_frames(tri_v0, tri_e1, tri_e2)

    # cluster tables for every non-empty world; an empty one has none and
    # takes the dense path, as in the JAX package
    cl_fields, n_clusters = {}, 0
    if n_tri:
        cl_box, cl_lw, cl_order, cl_base, cl_count = build_cluster_tables(
            tri_v0[:n_tri], tri_e1[:n_tri], tri_e2[:n_tri])
        cl_fields = dict(cl_box=cl_box, cl_lw=cl_lw,
                         # order padded to the triangle bucket, as in JAX
                         cl_order=_pad_rows(cl_order, n_tri_pad, 0),
                         cl_base=cl_base, cl_count=cl_count)
        n_clusters = int((cl_count > 0).sum())
    value = dict(
        n_tri=n_tri, n_tri_pad=n_tri_pad,
        tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
        tri_n0=tri_n0, tri_n1=tri_n1, tri_n2=tri_n2,
        tri_t0=tri_t0, tri_t1=tri_t1, tri_t2=tri_t2,
        slot_rows=slot_rows, inst_rows=inst_rows,
        tri_pw=tri_pw, tri_pc=tri_pc, skip_fields=skip_fields,
        cl_fields=cl_fields, n_clusters=n_clusters,
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
            "n_instances", "n_clusters", "max_ncl", "n_cutout")
_FLAGS = ("two_level", "has_maps")


def scene_from_arrays(leaves: dict, statics: dict,
                      device=DEFAULT) -> TorchScene:
    """Build a TorchScene from named NumPy arrays (for example the leaves of
    a JAX ``DeviceScene``, each converted with ``np.asarray``) and its static
    counts and flags. Extra leaves are ignored; the fields that only the
    other structure reads may be missing and take :func:`placeholders`, and
    the optional fields (the cutout set, the expanded lists) stay None when
    missing. A soup's ``leaf_tri``, which the JAX scene does not hold, is
    built from its ``node_begin`` / ``node_count`` at the default leaf
    size. The group table ``cl_group`` of a ``cl_box`` is built here
    (``group_table``) when the leaves lack it, and so is a soup's cutout
    set per cluster slot (:func:`cutout_slots`, from the cluster order,
    ``tri_mat``, the material tables and ``tri_pack``'s texture
    coordinates) when the scene has cutouts and a cluster table."""
    device = resolve(device)
    two_level = bool(statics.get("two_level", False))
    stand_in = placeholders(two_level)
    if not two_level and "leaf_tri" not in leaves and "node_count" in leaves:
        leaves = dict(leaves, leaf_tri=leaf_table(
            leaves["node_begin"], leaves["node_count"], DEFAULT_LEAF_SIZE))
    box = leaves.get("cl_box", stand_in.get("cl_box"))
    if "cl_group" not in leaves and box is not None:
        leaves = dict(leaves, cl_group=group_table(box))
    if (not two_level and int(statics.get("n_cutout", 0))
            and "cl_box" in leaves and "cl_cut_map" not in leaves):
        leaves = dict(leaves, **_slots_from_leaves(leaves))
    tensors = {}
    for f in dataclasses.fields(TorchScene):
        if f.name in _STATICS or f.name in _FLAGS or f.name == "map_kinds_used":
            continue
        a = leaves.get(f.name)
        if a is None:
            a = stand_in.get(f.name)
        if a is None:
            if f.default is None:
                continue
            raise ValueError(f"scene leaf {f.name!r} is missing")
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        elif a.dtype.kind in "iu":
            a = a.astype(np.int32)
        tensors[f.name] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return TorchScene(
        **tensors, **{k: int(statics.get(k, 0)) for k in _STATICS},
        two_level=two_level, has_maps=bool(statics.get("has_maps", False)),
        map_kinds_used=tuple(bool(x) for x in
                             statics.get("map_kinds_used", (False,) * 5)))
