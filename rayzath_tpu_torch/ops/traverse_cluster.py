"""Cluster traversal: closest hit and transmission shadow, flat (B1, B2)
and instanced (B3, B4).

Counterpart of ``rayzath_tpu/ops/traverse_cluster.py``.
The acceleration structure is the same flat table of triangle clusters (the
leaves of an ordinary BVH build, at most 128 triangles each), built on the
host by :func:`build_cluster_tables`:

* ``box_tab [8, Cp]``: per cluster the AABB min (rows 0-2) and max (rows
  3-5), the first triangle in cluster order (row 6) and the triangle count
  (row 7, 0 = padding lane).
* ``frames [Cp, 4, 384]``: cluster-local projection frames. For cluster c
  with centre ``ctr = (bmin + bmax) / 2``, triangle j and part a (x, y, z):
  ``o'_a = sum_k frames[c, k, a*128 + j] * (o - ctr, 1)_k`` and
  ``d'_a = sum_k frames[c, k, a*128 + j] * (d, 0)_k``. Then
  ``t = o'_z / -d'_z`` (d'_z nudged by DET_EPS when tiny),
  ``b1 = o'_x + t d'_x`` and ``b2 = o'_y + t d'_y``.

A table of more than ``GROUPED_ROWS`` rows is also cut into groups of
``GROUP`` (32) consecutive rows, neighbouring BVH leaves, by
:func:`group_table`:

* ``cl_group [8, Gp]``: per group the union AABB of its real rows (rows
  0-5), its first row (row 6) and its count of real rows (row 7, 0 =
  padding group), the ``box_tab`` layout.

B1 and B2 given it (``groups=``) rank, vote on and enter groups first and
walk the rows of the groups they enter; the hits are the flat walk's.

The instanced (two-level) variant keeps one such table per mesh, in object
space, concatenated into one shared table (each mesh padded to a multiple
of 128 rows), plus one row per instance, built by
:func:`build_instance_tables`:

* ``ti_rows [Ip, 24]``: world AABB min/max (``TI_MIN``/``TI_MAX``), the
  world->object 3x4 matrix row-major (``TI_INV``), the mesh's first cluster
  row and its real cluster count (``TI_CL0``/``TI_NCL``, 0 = padding row)
  and the global instance index (``TI_ID``).
* ``cl_obox [Cm, 8]``: per shared cluster the object-space AABB min/max,
  first triangle (device order) and count, the ``box_tab`` rows as columns.
* ``cl_slot [Cm, 128]``: the mesh-local material slot of each triangle.

A ray visits an instance by moving into its object space,
``o' = A o + a`` and ``d' = A d`` with d' left unnormalized, so that t stays
the world t, and then walks that mesh's clusters.

B3 and B4 rank the instances per block of 128 rays and walk them, and
each visited mesh's clusters, per warp of 32 rays.

Each public entry point (``cluster_closest``, ``cluster_shadow``,
``cluster_closest_inst``, ``cluster_shadow_inst``) takes the plain PyTorch
version for a tensor on the CPU and launches the hand-written CUDA kernel
(``csrc/cluster_closest.cu``, ``csrc/cluster_shadow.cu``,
``csrc/cluster_closest_inst.cu``, ``csrc/cluster_shadow_inst.cu``) for a
tensor on a CUDA device; any other device raises. Each counts its kernel
launches in a ``launches`` attribute (``ops/_kernels.py`` ``launch``), B1
and B2 those on the grouped walk also in ``grouped``. Each also counts the
work of its walk: ``rays`` (host: the rays handed to the walk) and
``work`` (a :class:`WorkCounter`, per device, added to by the kernels
themselves, so that a captured graph counts on every replay): B1 and B2
their cluster tests, triangle tests and slab tests, B3 and B4 their
instance visits and (instance, cluster) tests, and B2 and B4 besides their
live rays, those handed in with dist > 0 (a ray of dist 0, which the
bounce writes for a light sample that weighs exactly zero, is inactive:
visibility 1, no vote, no test). The plain versions visit every
real cluster (of every real instance) with no culling; the kernels cull
conservatively, so both return the same hits.

B2 also takes a soup scene's texture-alpha cutouts (``cutouts=``, a
:class:`Cutouts`): at each hit of a slot in the cutout set it fetches the
colour map's texel at the hit's texture coordinates and multiplies (rgb,
1 - alpha) into the hit's factor, so that the walk's product is the whole
transmission of the reference's any-hit walk (cuda_instance.cuh:92-164);
it counts its fetches in ``fetches`` (a :class:`WorkCounter` of one key,
``cutout_fetches``, beside ``work``).

The closest-hit entries return discrete hits and carry no gradient. The
shadow entries are ``torch.autograd.Function``s when an input requires
grad: the forward is the kernel (or the plain version on the CPU), the
backward the hand-written B2-grad or B4-grad kernel
(``csrc/cluster_shadow_grad.cu``, ``csrc/cluster_shadow_inst_grad.cu``;
:func:`cluster_shadow_grad`, :func:`cluster_shadow_inst_grad`, which take
:func:`cluster_shadow_grad_plain` / :func:`cluster_shadow_inst_grad_plain`
on the CPU and count their launches too). They give the result of the JAX
package's custom_vjp rules, a dense replay of the shadow test through
``ops/intersect.py`` ``project_shadow`` (kept as the tests' oracle in
``utils/check_tables.py``), by walking the cluster tables twice: only the
opacity table gets a gradient, and each hit's share is the product of the
ray's other factors times its cotangent, over every hit (no alpha stop).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _kernels
from ._kernels import counted, launch as _launch, ptr as _ptr
from .gather import gather_rows
from .texture import fetch as _fetch_texel
from .bvh import build_bvh, triangle_aabbs
from .intersect import BIG, DET_EPS, triangle_frames

CLUSTER_T = 128         # triangles per cluster
KERNEL_BLOCK = 128      # rays per block of the CUDA kernels

# box_tab row layout ([8, Cp] f32, clusters on columns)
B_MIN = 0               # rows 0..2: cluster AABB min xyz
B_MAX = 3               # rows 3..5: cluster AABB max xyz
B_BASE = 6              # row 6: first triangle (reordered index)
B_CNT = 7               # row 7: triangle count (0 = padding lane)

# ti_rows layout ([Ip, TI_W] f32, one row per instance)
TI_MIN = 0              # 0..2: world AABB min
TI_MAX = 3              # 3..5: world AABB max
TI_INV = 6              # 6..17: world->object 3x4 (row-major)
TI_CL0 = 18             # first shared cluster row of the instance's mesh
TI_NCL = 19             # real cluster count (0 = padding row)
TI_ID = 20              # global instance index
TI_W = 24
SLOTS = 64              # material slots per instance

# group table layout ([8, Gp] f32, one column per GROUP consecutive cluster
# rows; group_table): rows 0-5 the union AABB of the group's real rows, row
# 6 its first cluster row, row 7 its count of real rows (0 = padding group)
GROUP = _kernels.header_constant("GROUP")
#: B1 and B2 walk a flat table of more than GROUPED_ROWS cluster rows
#: through its group table (ranking, voting on and entering groups of
#: GROUP rows, then sweeping a group's rows), and a smaller one row by
#: row. Both walks return the same hits. The line lies between the
#: tables measured on an H100 (PERF.md, Findings, 512^2 camera and bounce
#: rays): on mesh_massive's 5,632 rows the grouped walk ran B1 and B2
#: 2.1-2.7x faster than the flat one, whose per-block rank and vote over
#: every row took 65-71% of their time; on mesh_heavy's 768 rows it ran
#: B1 4-7% slower and B2 10-11% faster.
GROUPED_ROWS = 1024
#: the keys of B1's work counter (:class:`WorkCounter`)
SOUP_WORK = ("cluster_tests", "triangle_tests", "slab_tests")
#: B2's: B1's keys, then its live rays (dist > 0: the rays that walk)
SHADOW_WORK = SOUP_WORK + ("live",)
#: B3's
INST_WORK = ("instance_visits", "cluster_tests")
#: B4's: B3's keys, then its live rays
INST_SHADOW_WORK = INST_WORK + ("live",)
#: the key of B2's counter of the texels its cutout variant fetched
CUTOUT_WORK = ("cutout_fetches",)


class Cutouts(NamedTuple):
    """A soup scene's texture-alpha cutouts for B2, per slot of its cluster
    table (``models/device_scene.py`` ``cutout_slots``) with the colour
    atlas and map tables they name (``TorchScene`` fields of the same
    meaning)."""
    slot_map: torch.Tensor       # [Cp, 128] i32 colour map id, -1 off the set
    slot_uv: torch.Tensor        # [Cp, 128, 6] f32 t0, t1 - t0, t2 - t0
    color_atlas: torch.Tensor    # [Hc, Wc, 4]
    col_blk_idx: torch.Tensor    # [Hc * Wc, 4] i32
    map_rect: torch.Tensor       # [K, 4] i32
    map_flags: torch.Tensor      # [K, 3] i32
    map_uv: torch.Tensor         # [K, 5]

    @classmethod
    def of(cls, scene) -> "Cutouts":
        """The cutouts of a compiled soup scene with per-slot tables."""
        return cls(scene.cl_cut_map, scene.cl_cut_uv, scene.color_atlas,
                   scene.col_blk_idx, scene.map_rect, scene.map_flags,
                   scene.map_uv)


# ---------------------------------------------------------------------------
# host build (copied from the JAX package; NumPy only)
# ---------------------------------------------------------------------------

def build_cluster_tables(tri_v0, tri_e1, tri_e2, cluster_t: int = CLUSTER_T):
    """Host build of the flat cluster tables.

    Returns (box_tab [8, Cp] f32, frames [Cp, 4, 3*cluster_t] f32,
    order [T] i32 reordered -> original, base [Cp] i32, count [Cp] i32).
    """
    tri_v0 = np.asarray(tri_v0, np.float32)
    tri_e1 = np.asarray(tri_e1, np.float32)
    tri_e2 = np.asarray(tri_e2, np.float32)
    t_count = len(tri_v0)
    # triangle ids are carried as f32 in box_tab row 6: exact below 2^24
    assert t_count < 2 ** 24, "f32 triangle ids overflow at 2^24 triangles"
    pmin, pmax = triangle_aabbs(tri_v0, tri_v0 + tri_e1, tri_v0 + tri_e2)
    bvh = build_bvh(pmin, pmax, leaf_size=cluster_t)
    order = bvh.order if t_count else np.zeros(0, np.int32)
    v0, e1, e2 = tri_v0[order], tri_e1[order], tri_e2[order]

    # leaves -> clusters, SPLITTING any leaf larger than cluster_t (the
    # BVH's too-large-object partition can emit oversized leaves when
    # centroids coincide); chunk bounds recomputed from the chunk's own
    # triangle AABBs so culling stays tight
    pmin_r = pmin[order] if t_count else pmin
    pmax_r = pmax[order] if t_count else pmax
    leaves = []          # (begin, count, bmin, bmax) per CLUSTER
    if t_count:
        for node in np.nonzero(bvh.node_count > 0)[0]:
            b = int(bvh.node_begin[node])
            n = int(bvh.node_count[node])
            if n <= cluster_t:
                leaves.append((b, n, bvh.node_min[node], bvh.node_max[node]))
            else:
                for b0 in range(b, b + n, cluster_t):
                    m = min(cluster_t, b + n - b0)
                    leaves.append((b0, m, pmin_r[b0:b0 + m].min(0),
                                   pmax_r[b0:b0 + m].max(0)))
    c = len(leaves)
    cp = max(128, -(-max(c, 1) // 128) * 128)
    box = np.zeros((8, cp), np.float32)
    # padding lanes: inverted boxes that no slab test can reach
    box[B_MIN:B_MIN + 3, :] = 3e38
    box[B_MAX:B_MAX + 3, :] = -3e38
    base = np.zeros(cp, np.int32)
    count = np.zeros(cp, np.int32)
    frames = np.zeros((cp, 4, 3 * cluster_t), np.float32)
    # never-hit padding frames: w = 0, c = (-1, -1, 1) => b1 = -1 everywhere
    frames[:, 3, 0 * cluster_t:1 * cluster_t] = -1.0
    frames[:, 3, 1 * cluster_t:2 * cluster_t] = -1.0
    frames[:, 3, 2 * cluster_t:3 * cluster_t] = 1.0
    if t_count:
        w_all, c_all = triangle_frames(v0, e1, e2)      # [3, 3T], [3T]
        for s, (b, n, bmin, bmax) in enumerate(leaves):
            base[s] = b
            count[s] = n
            box[B_MIN:B_MIN + 3, s] = bmin
            box[B_MAX:B_MAX + 3, s] = bmax
            box[B_BASE, s] = float(b)
            box[B_CNT, s] = float(n)
            # frames are evaluated against CLUSTER-LOCAL ray origins
            # (o - box center): absorb the center into the constant term in
            # f64 so the traversal sees small, well-conditioned magnitudes
            ctr = (bmin.astype(np.float64) + bmax.astype(np.float64)) * 0.5
            for a in range(3):                          # local coord part
                cols = slice(a * t_count + b, a * t_count + b + n)
                w_c = w_all[:, cols].astype(np.float64)
                frames[s, 0:3, a * cluster_t:a * cluster_t + n] = w_all[:, cols]
                frames[s, 3, a * cluster_t:a * cluster_t + n] = (
                    c_all[cols].astype(np.float64) + ctr @ w_c
                ).astype(np.float32)
    return box, frames, order.astype(np.int32), base, count


def group_table(box_tab):
    """Host build of the group table [8, Gp] f32 of a flat cluster table
    ``box_tab`` [8, Cp] (NumPy, or a CPU tensor): column g covers cluster
    rows g * GROUP .. g * GROUP + GROUP - 1, consecutive BVH leaves. Rows
    0-5 hold the union AABB of the group's real rows, row 6 its first row,
    row 7 its count of real rows, which the walk sweeps from the first
    (so real rows have to come first in every group, as
    :func:`build_cluster_tables` pads at the end; raises otherwise); a
    group of padding rows only keeps their inverted box, and the rank
    leaves it out."""
    box = np.asarray(box_tab, np.float32)
    cp = box.shape[1]
    gp = -(-cp // GROUP)
    rows = np.zeros((8, gp * GROUP), np.float32)
    rows[B_MIN:B_MIN + 3] = 3e38
    rows[B_MAX:B_MAX + 3] = -3e38
    rows[:, :cp] = box
    rows = rows.reshape(8, gp, GROUP)
    real = rows[B_CNT] > 0
    if (np.diff(real.astype(np.int8), axis=1) > 0).any():
        raise ValueError("group_table: a padding row precedes a real row "
                         "in a group")
    out = np.zeros((8, gp), np.float32)
    out[B_MIN:B_MIN + 3] = np.where(real, rows[B_MIN:B_MIN + 3],
                                    np.float32(3e38)).min(2)
    out[B_MAX:B_MAX + 3] = np.where(real, rows[B_MAX:B_MAX + 3],
                                    np.float32(-3e38)).max(2)
    out[B_BASE] = np.arange(gp) * GROUP
    out[B_CNT] = real.sum(1)
    return out


def cluster_opacity(op_rgb, op_a, order, base, count,
                    cluster_t: int = CLUSTER_T):
    """[Cp, 4, cluster_t] per-cluster rgba opacity from the live material
    opacity tables (original triangle order), rebuilt on every call so that
    material edits are never stale. Padding slots get 1."""
    ops = gather_rows(torch.cat([op_rgb, op_a[:, None]], dim=1), order)  # [T,4]
    lanes = torch.arange(cluster_t, device=op_rgb.device)
    idx = base[:, None].long() + lanes[None, :]                      # [C,ct]
    valid = lanes[None, :] < count[:, None]
    idx = torch.clamp(idx, 0, max(ops.shape[0] - 1, 0))
    vals = torch.where(valid[:, :, None], gather_rows(ops, idx),
                       torch.ones((), dtype=ops.dtype, device=ops.device))
    return vals.permute(0, 2, 1).contiguous()                        # [C,4,ct]


def build_instance_tables(wmin, wmax, inv, cl0, ncl, inst_id):
    """Host build of the instance rows: wmin/wmax [I,3] world AABBs,
    inv [I,3,4] world->object, cl0/ncl [I] shared-cluster ranges,
    inst_id [I] global instance indices. Returns ti_rows [Ip, TI_W] with
    Ip = I rounded up to a multiple of 128 (at least 128); padding rows are
    all zeros (ncl = 0). The JAX package also builds a lane-major box twin
    for its ranking pass; the port's walk reads the rows only."""
    i = len(cl0)
    ip = max(128, -(-max(i, 1) // 128) * 128)
    rows = np.zeros((ip, TI_W), np.float32)
    if i:
        rows[:i, TI_MIN:TI_MIN + 3] = wmin
        rows[:i, TI_MAX:TI_MAX + 3] = wmax
        rows[:i, TI_INV:TI_INV + 12] = np.asarray(inv).reshape(i, 12)
        rows[:i, TI_CL0] = np.asarray(cl0).astype(np.float32)
        rows[:i, TI_NCL] = np.asarray(ncl).astype(np.float32)
        rows[:i, TI_ID] = np.asarray(inst_id).astype(np.float32)
    return rows


def cluster_slot_rows(tri_slot, cl_base, cl_count):
    """[Cm, CLUSTER_T] f32 material slot of each triangle of each shared
    cluster (device order). Padding slots keep slot 0 (they never hit)."""
    lanes = np.arange(CLUSTER_T)[None, :]
    idx = np.clip(cl_base[:, None] + lanes, 0, max(len(tri_slot) - 1, 0))
    valid = lanes < cl_count[:, None]
    return np.where(valid, tri_slot[idx], 0).astype(np.float32)


def instance_opacity(mat_color, inst_slot_map):
    """[I, 4, SLOTS] per-instance slot opacity (rgb, 1 - alpha), resolved
    from the live material table on every call, so edits are never
    stale."""
    mc = gather_rows(mat_color, inst_slot_map)                       # [I,64,4]
    ops = torch.cat([mc[..., :3], 1.0 - mc[..., 3:4]], dim=-1)
    return ops.permute(0, 2, 1).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions (no culling)
# ---------------------------------------------------------------------------

def _real_clusters(box_tab):
    """[(cluster, first triangle)] of every non-padding row, read once."""
    rows = box_tab[[B_BASE, B_CNT]].cpu()
    return [(c, int(rows[0, c])) for c in
            torch.nonzero(rows[1] > 0).flatten().tolist()]


def _project(origin, direction, box_tab, frames, c):
    """(t, b1, b2) [R, 128] of every ray against cluster ``c``'s triangles,
    with the kernels' exact operation order."""
    ct = CLUSTER_T
    ctr = (box_tab[B_MIN:B_MIN + 3, c] + box_tab[B_MAX:B_MAX + 3, c]) * 0.5
    p = origin - ctr
    f = frames[c]                                                   # [4, 384]
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    ol = f[0] * px + f[1] * py + f[2] * pz + f[3]                   # [R, 384]
    dl = f[0] * dx + f[1] * dy + f[2] * dz
    olx, oly, olz = ol[:, 0:ct], ol[:, ct:2 * ct], ol[:, 2 * ct:]
    dlx, dly, dlz = dl[:, 0:ct], dl[:, ct:2 * ct], dl[:, 2 * ct:]
    dlz = dlz + (dlz.abs() < DET_EPS).to(dlz.dtype) * DET_EPS
    t = olz / -dlz
    b1 = olx + t * dlx
    b2 = oly + t * dly
    return t, b1, b2


def _inside(b1, b2):
    return (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)


def cluster_closest_plain(origin, direction, near, far, box_tab, frames):
    """Closest hit over every real cluster, in table order. Returns
    (t [R], id [R] i32 in CLUSTER order, -1 = miss). A ray with far <= 0 is
    invalid: it returns t = -1 and id -1. Ties inside a cluster keep the
    lowest id; across clusters a later cluster must be strictly nearer."""
    r = origin.shape[0]
    dev = origin.device
    ok = far > 0.0
    best_t = torch.where(ok, torch.clamp(far, max=BIG),
                         torch.full_like(far, -1.0))
    best_id = torch.full((r,), -1, dtype=torch.int32, device=dev)
    lanes = torch.arange(CLUSTER_T, dtype=torch.int32, device=dev)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    for c, base in _real_clusters(box_tab):
        t, b1, b2 = _project(origin, direction, box_tab, frames, c)
        valid = (_inside(b1, b2) & (t > near[:, None]) & (t < best_t[:, None])
                 & ok[:, None])
        tm = torch.where(valid, t, big)
        t_new = tm.amin(dim=1)
        j = torch.where(tm == t_new[:, None], lanes,
                        torch.full_like(lanes, CLUSTER_T)).amin(dim=1)
        got = t_new < best_t
        best_id = torch.where(got, base + j, best_id)
        best_t = torch.where(got, t_new, best_t)
    return best_t, best_id


def cutout_factors(c: int, hit, b1, b2, cutouts: Cutouts):
    """The texel factors of cluster ``c``'s hits ``hit`` [R, 128] at the
    barycentrics (b1, b2) [R, 128] in its cutout slots: ([R, 4, 128], 1
    elsewhere; the number of fetches per ray [R]), or None where no hit
    lies in a cutout slot. A factor is (tex_rgb, 1 - tex_alpha) of the
    slot's colour map at uv = t0 + b1 (t1 - t0) + b2 (t2 - t0), as the
    dense pass (``engine/integrator.py`` ``texture_shadow_factor``) and
    B2's cutout variant take it."""
    mid = cutouts.slot_map[c]                                       # [128]
    take = hit & (mid >= 0)[None, :]
    if not bool(take.any()):
        return None
    ray, slot = torch.nonzero(take, as_tuple=True)
    uv = cutouts.slot_uv[c][slot]                                   # [K, 6]
    u = uv[:, 0:2] + b1[ray, slot][:, None] * uv[:, 2:4] \
        + b2[ray, slot][:, None] * uv[:, 4:6]
    tex = _fetch_texel(cutouts.color_atlas, cutouts.col_blk_idx,
                       cutouts.map_rect, cutouts.map_flags, cutouts.map_uv,
                       mid[slot], u)
    fac = torch.ones((hit.shape[0], CLUSTER_T, 4), dtype=torch.float32,
                     device=hit.device)
    fac[ray, slot] = torch.cat([tex[:, :3], 1.0 - tex[:, 3:4]], dim=1)
    return fac.permute(0, 2, 1), take.sum(dim=1)


def _shadow_plain(origin, direction, dist, box_tab, frames, op_tab,
                  cutouts=None):
    """:func:`cluster_shadow_plain` and its texel fetches per ray [R]."""
    r = origin.shape[0]
    m = torch.ones((r, 4), dtype=torch.float32, device=origin.device)
    fetches = torch.zeros(r, dtype=torch.int64, device=origin.device)
    for c, _ in _real_clusters(box_tab):
        t, b1, b2 = _project(origin, direction, box_tab, frames, c)
        valid = _inside(b1, b2) & (t > 0.0) & (t < dist[:, None])   # [R,ct]
        fac = torch.where(valid[:, None, :], op_tab[c][None], 1.0)  # [R,4,ct]
        tex = None if cutouts is None else cutout_factors(c, valid, b1, b2,
                                                          cutouts)
        if tex is not None:
            fac = fac * tex[0]
            fetches += tex[1]
        m = m * fac.prod(dim=2)
    return m[:, 0:3].contiguous(), m[:, 3].contiguous(), fetches


def cluster_shadow_plain(origin, direction, dist, box_tab, frames, op_tab,
                         cutouts=None):
    """Product of the rgba opacity of every hit with t in (0, dist), over
    every real cluster, times each hit's texel factor in the cutout slots
    of ``cutouts`` (:func:`cutout_factors`; no alpha stop). Returns (rgb
    [R,3], a [R])."""
    return _shadow_plain(origin, direction, dist, box_tab, frames, op_tab,
                         cutouts)[:2]


def _real_instances(ti_rows, cl_obox):
    """[(row, gid, [(cluster, first triangle), ...])] of every non-padding
    instance row, in table order, read once."""
    rows = ti_rows[:, [TI_CL0, TI_NCL, TI_ID]].cpu()
    base = cl_obox[:, B_BASE].cpu()
    out = []
    for k in torch.nonzero(rows[:, 1] > 0).flatten().tolist():
        cl0, ncl = int(rows[k, 0]), int(rows[k, 1])
        out.append((k, int(rows[k, 2]),
                    [(s, int(base[s])) for s in range(cl0, cl0 + ncl)]))
    return out


def _object_rays(origin, direction, ti_rows, k):
    """Rays in instance row ``k``'s object space: o' = A o + a, d' = A d
    (d' unnormalized, so t stays the world t), in the kernels' order."""
    a = ti_rows[k, TI_INV:TI_INV + 12]
    ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    o = torch.stack([a[4 * i] * ox + a[4 * i + 1] * oy + a[4 * i + 2] * oz
                     + a[4 * i + 3] for i in range(3)], dim=1)
    d = torch.stack([a[4 * i] * dx + a[4 * i + 1] * dy + a[4 * i + 2] * dz
                     for i in range(3)], dim=1)
    return o, d


def cluster_closest_inst_plain(origin, direction, near, far, ti_rows, cl_obox,
                               frames):
    """Two-level closest hit over every real instance and every cluster of
    its mesh, in table order. Returns (t [R], tri_id [R] i32 in DEVICE
    order, inst_id [R] i32 global instance index; -1 = miss). A ray with
    far <= 0 returns t = -1. Ties follow :func:`cluster_closest_plain`: a
    later cluster or instance must be strictly nearer."""
    r = origin.shape[0]
    dev = origin.device
    ok = far > 0.0
    best_t = torch.where(ok, torch.clamp(far, max=BIG),
                         torch.full_like(far, -1.0))
    best_id = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((r,), -1, dtype=torch.int32, device=dev)
    lanes = torch.arange(CLUSTER_T, dtype=torch.int32, device=dev)
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    box = cl_obox.t()                                              # [8, Cm]
    for k, gid, clusters in _real_instances(ti_rows, cl_obox):
        o, d = _object_rays(origin, direction, ti_rows, k)
        for s, base in clusters:
            t, b1, b2 = _project(o, d, box, frames, s)
            valid = (_inside(b1, b2) & (t > near[:, None])
                     & (t < best_t[:, None]) & ok[:, None])
            tm = torch.where(valid, t, big)
            t_new = tm.amin(dim=1)
            j = torch.where(tm == t_new[:, None], lanes,
                            torch.full_like(lanes, CLUSTER_T)).amin(dim=1)
            got = t_new < best_t
            best_id = torch.where(got, base + j, best_id)
            best_inst = torch.where(got, torch.full_like(best_inst, gid),
                                    best_inst)
            best_t = torch.where(got, t_new, best_t)
    return best_t, best_id, best_inst


def cluster_shadow_inst_plain(origin, direction, dist, ti_rows, cl_obox,
                              frames, cl_slot, op_tab):
    """Two-level transmission product: per ray, the product of the rgba
    opacity ``op_tab[gid, :, cl_slot[s, j]]`` of every hit with t in
    (0, dist), over every real instance and cluster. Returns (rgb [R,3],
    a [R])."""
    r = origin.shape[0]
    m = torch.ones((r, 4), dtype=torch.float32, device=origin.device)
    box = cl_obox.t()
    slots = cl_slot.long()
    for k, gid, clusters in _real_instances(ti_rows, cl_obox):
        o, d = _object_rays(origin, direction, ti_rows, k)
        opi = op_tab[gid]                                          # [4, 64]
        for s, _ in clusters:
            t, b1, b2 = _project(o, d, box, frames, s)
            valid = _inside(b1, b2) & (t > 0.0) & (t < dist[:, None])
            ops = opi[:, slots[s]]                                 # [4, ct]
            fac = torch.where(valid[:, None, :], ops[None], 1.0)
            m = m * fac.prod(dim=2)
    return m[:, 0:3].contiguous(), m[:, 3].contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_rays(dev, origin, direction, **per_ray) -> int:
    """The rays' arguments on ``dev``: origin and direction [R, 3], each
    of ``per_ray`` [R], all float32 and contiguous. Returns R."""
    r = origin.shape[0]
    for name, x in (("origin", origin), ("direction", direction)):
        _kernels.check(dev, name, x, torch.float32, (r, 3))
    for name, x in per_ray.items():
        _kernels.check(dev, name, x, torch.float32, (r,))
    return r


def _check_tables(dev, box_tab, frames):
    """B1's and B2's cluster tables on ``dev``; returns their rows Cp."""
    cp = box_tab.shape[1]
    if box_tab.shape != (8, cp) or frames.shape != (cp, 4, 3 * CLUSTER_T):
        raise ValueError(f"cluster tables disagree: box_tab {tuple(box_tab.shape)}"
                         f", frames {tuple(frames.shape)}")
    _kernels.check(dev, "box_tab", box_tab, torch.float32)
    _kernels.check(dev, "frames", frames, torch.float32)
    return cp


def _aligned(**tensors):
    """Raise unless every tensor starts on a 16-byte boundary (the kernels
    stage frames, opacity blocks and slot rows with 16-byte cp.async
    copies)."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


@functools.cache
def _smem_optin(index: int) -> int:
    """Bytes of shared memory one block may opt in to on CUDA device
    ``index``."""
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def _ranked_smem(lib, dev, rows: int, kernel: int, grouped: bool = False) -> int:
    """Dynamic shared memory of a launch of kernel B``kernel`` (1-4) over
    ``rows`` table rows (B1's and B2's clusters, or their group rows when
    ``grouped``; B3's and B4's instances), as the kernel asks for it;
    raises when the device cannot give it."""
    need = (lib.rz_grouped_smem if grouped else lib.rz_ranked_smem)(rows,
                                                                    kernel)
    have = _smem_optin(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    if need > have:
        raise ValueError(f"the ranked walk needs {need} bytes of shared memory "
                         f"per block; {dev} gives at most {have}")
    return need


def _visit_buffer(visits, dev, r):
    """Pointer to the optional visit counter: None, or an int32 CUDA tensor
    of R + ceil(R / 128) entries that receives each ray's cluster tests and
    each block's staged clusters."""
    if visits is None:
        return ctypes.c_void_p(None)
    _kernels.check(dev, "visits", visits, torch.int32,
                   (r + -(-r // KERNEL_BLOCK),))
    return _ptr(visits)


def _soup_visits(visits, dev, r):
    """B1's and B2's visit counters: ``visits`` None, of R + B entries, B =
    ceil(R / 128) (as :func:`_visit_buffer`), or of R + 2 B, whose last
    part receives per block the group rows it entered (0 on the flat
    walk). Returns the two pointers, null where absent."""
    blocks = -(-r // KERNEL_BLOCK)
    if visits is not None and visits.shape == (r + 2 * blocks,):
        return (_visit_buffer(visits[:r + blocks], dev, r),
                _ptr(visits[r + blocks:]))
    return _visit_buffer(visits, dev, r), ctypes.c_void_p(None)


def walk_resources(kernel: str, rows: int, grouped: bool = False,
                   cutout: bool = False) -> dict:
    """Registers per thread, dynamic shared bytes, resident blocks per SM
    and spilled (local) bytes per thread of B1 (``kernel="closest"``) or B2
    (``"shadow"``; its cutout variant with ``cutout``) launched over
    ``rows`` cluster rows on the flat or the grouped walk, or of B3
    (``"closest_inst"``) or B4 (``"shadow_inst"``) over ``rows`` instance
    rows, on the current CUDA device (for reports)."""
    lib = _kernels.load()
    out = (ctypes.c_int * 4)()
    gp = -(-rows // GROUP) if grouped else 0
    if kernel == "closest":
        err = lib.rz_closest_resources(rows, gp, out)
    elif kernel == "shadow":
        err = lib.rz_shadow_resources(rows, gp, int(cutout), out)
    else:
        fn = {"closest_inst": lib.rz_closest_inst_resources,
              "shadow_inst": lib.rz_shadow_inst_resources}[kernel]
        err = fn(rows, out)
    if err:
        raise RuntimeError(f"walk_resources: {_kernels.error_string(err)}")
    return dict(registers=out[0], smem_bytes=out[1], blocks_per_sm=out[2],
                spill_bytes=out[3])


def _group_args(dev, cp: int, groups):
    """The group table's launch arguments (pointer, group rows) when B1 or
    B2 takes the grouped walk (a group table given for more than
    GROUPED_ROWS cluster rows), else (null, 0): the flat walk."""
    if groups is None or cp <= GROUPED_ROWS:
        return ctypes.c_void_p(None), 0
    gp = -(-cp // GROUP)
    _kernels.check(dev, "groups", groups, torch.float32, (8, gp))
    return _ptr(groups), gp


class WorkCounter:
    """What a walk made since the process started: per device one int64
    count for each of ``keys``. B3 and B4 count [instance visits,
    (instance, cluster) tests]: an instance visit is one ray moved into one
    instance's object space (``to_object``, 33 operations); a test is one
    ray against one cluster of 128 triangle slots. B1 and B2 count
    [cluster tests, triangle tests, slab tests]: a triangle test is one
    ray against one real triangle of a cluster it tests (the slots past
    the cluster's count are not tested), a slab test one ray's gate
    against one box of the cluster or group table (``slab``). B2 and B4
    add a last key, ``live``: the rays handed in with dist > 0. The kernels
    add their launch's totals, one atomicAdd per counter per block of 128
    rays, with no host sync and no allocation, so a captured graph counts
    on every replay; on the CPU the wrapper adds what the plain version
    tests (every real cluster or pair, for each ray that walks, and no
    slab test)."""

    def __init__(self, keys=INST_WORK):
        self.keys = tuple(keys)
        self._counts: dict = {}

    def pair(self, dev) -> torch.Tensor:
        """The device's counts (a pair for B3 and B4, whose name it keeps),
        made on their first use, which has to come before any graph capture
        (the render cycle and the training step run every launch once
        before they capture)."""
        counts = self._counts.get(dev)
        if counts is None:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a walk's work counter has to be made "
                                   "before a graph is captured")
            counts = self._counts[dev] = torch.zeros(
                len(self.keys), dtype=torch.int64, device=dev)
        return counts

    def read(self) -> dict:
        """The counts under :attr:`keys`, summed over the devices (a host
        read: it waits for each device's work so far)."""
        total = [0] * len(self.keys)
        for counts in list(self._counts.values()):
            total = [a + b for a, b in zip(total, counts.tolist())]
        return dict(zip(self.keys, total))


def _count_plain(wrapper, active, work, tests, visits) -> None:
    """Count a plain walk on the CPU as the kernels count theirs:
    ``wrapper.rays`` gains the rays, ``wrapper.work`` for each ray that
    walks (``active``) the count ``work`` gives under each of its keys (a
    ``live`` key counts one); ``visits`` (optional, R + B entries as for
    the kernels) receives each walking ray's ``tests``, then the tests each
    block of 128 rays stages (all of them when one of its rays walks)."""
    r = active.shape[0]
    blocks = -(-r // KERNEL_BLOCK)
    if visits is not None:
        _kernels.check(active.device, "visits", visits, torch.int32,
                       (r + blocks,))
    n = int(active.sum())
    wrapper.rays += r
    per_ray = dict(work, live=1)
    wrapper.work.pair(active.device).add_(torch.tensor(
        [n * per_ray[k] for k in wrapper.work.keys], dtype=torch.int64))
    if visits is not None:
        walks = torch.zeros(blocks * KERNEL_BLOCK, dtype=torch.bool)
        walks[:r] = active
        visits[:r] = active.to(torch.int32) * tests
        visits[r:] = walks.reshape(blocks, -1).any(1).to(torch.int32) * tests


def _count_plain_inst(wrapper, active, ti_rows, visits) -> None:
    """:func:`_count_plain` of B3 or B4: every real instance and every
    (instance, cluster) pair for each ray that walks."""
    ncl = ti_rows[:, TI_NCL]
    n_pairs = int(ncl.sum())
    _count_plain(wrapper, active, dict(instance_visits=int((ncl > 0).sum()),
                                       cluster_tests=n_pairs),
                 n_pairs, visits)


def _count_plain_soup(wrapper, active, box_tab, visits) -> None:
    """:func:`_count_plain` of B1 or B2: every real cluster and its real
    triangles for each ray that walks, and no slab test."""
    cnt = box_tab[B_CNT]
    n_real = int((cnt > 0).sum())
    _count_plain(wrapper, active, dict(cluster_tests=n_real,
                                       triangle_tests=int(cnt.sum()),
                                       slab_tests=0), n_real, visits)


def _map_ids(rid, order):
    """Cluster-order ids -> original soup ids (-1 stays -1)."""
    safe = torch.clamp(rid, 0, order.shape[0] - 1).long()
    return torch.where(rid >= 0, order[safe].to(torch.int32),
                       torch.full_like(rid, -1))


@counted("grouped", "rays")
def cluster_closest(origin, direction, near, far, box_tab, frames, order, *,
                    groups=None, visits=None):
    """Closest hit. Returns (t [R], tri_id [R] i32 in ORIGINAL order,
    -1 = miss). CPU tensors take :func:`cluster_closest_plain`; CUDA
    tensors launch the B1 kernel (``csrc/cluster_closest.cu``), a ranked
    front-to-back walk per block of 128 rays (a block with a ray of
    near < 0 walks in table order instead). ``groups``: the table's
    :func:`group_table`; above GROUPED_ROWS cluster rows the walk ranks and
    enters groups of rows first (``grouped`` counts those launches).
    ``visits`` (off the render path): an int32 tensor of R + B entries, B =
    ceil(R / 128), that receives each ray's cluster tests, then each
    block's staged clusters (on the CPU, as :func:`_count_plain_soup`
    counts); on a card optionally followed by B entries, each block's
    groups entered. Adds to ``rays`` and ``work`` (:class:`WorkCounter`:
    :data:`SOUP_WORK`) on every call."""
    if origin.device.type == "cpu":
        t, rid = cluster_closest_plain(origin, direction, near, far, box_tab,
                                       frames)
        _count_plain_soup(cluster_closest, far > 0.0, box_tab, visits)
        return t, _map_ids(rid, order)
    lib = _kernels.load()
    dev = _kernels.card(origin.device)
    r = _check_rays(dev, origin, direction, near=near, far=far)
    cp = _check_tables(dev, box_tab, frames)
    _aligned(frames=frames)
    grp, gp = _group_args(dev, cp, groups)
    _ranked_smem(lib, dev, gp or cp, kernel=1, grouped=gp > 0)
    counts, stats = _soup_visits(visits, dev, r)
    work = cluster_closest.work.pair(dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    rid = torch.empty(r, dtype=torch.int32, device=dev)
    if r:
        _launch(cluster_closest, lib.rz_cluster_closest, dev,
                _ptr(origin), _ptr(direction), _ptr(near), _ptr(far),
                _ptr(box_tab), _ptr(frames), grp, r, cp, gp, _ptr(t),
                _ptr(rid), counts, stats, _ptr(work))
        cluster_closest.rays += r
        if gp:
            cluster_closest.grouped += 1
    return t, _map_ids(rid, order.to(dev))


cluster_closest.work = WorkCounter(SOUP_WORK)


# ---------------------------------------------------------------------------
# backward: the plain versions of B2-grad and B4-grad
# ---------------------------------------------------------------------------

def _fold_hits(hit, op, prod, zeros):
    """Walk 1 of the backward over one cluster: the hits ``hit`` [R, ct]
    with factors ``op`` [4, ct] multiply the non-zero ones into ``prod``
    [R, 4] and count the zero ones into ``zeros`` [R, 4]."""
    zero = op == 0.0
    f = torch.where(hit[:, None, :] & ~zero[None], op[None], 1.0)    # [R,4,ct]
    return (prod * f.prod(dim=2),
            zeros + (hit[:, None, :] & zero[None]).sum(dim=2))


def _coefficients(g_rgb, g_a, prod, zeros):
    """Each ray's (A, B) [R, 4] from its cotangent and walk 1: A = g P where
    the ray has no zero factor, B = g P where it has exactly one, else 0."""
    gp = torch.cat([g_rgb, g_a[:, None]], dim=1) * prod
    zero = torch.zeros((), dtype=gp.dtype, device=gp.device)
    return torch.where(zeros == 0, gp, zero), torch.where(zeros == 1, gp, zero)


def _slot_grad(hit, coef, op):
    """Walk 2 over one cluster: [4, ct] gradient of its factors ``op``
    [4, ct] from the rays that hit each slot (``hit`` [R, ct]): the summed
    A over op where op != 0 (the product of the other factors), the summed
    B where op == 0."""
    a, b = coef
    v = hit.to(a.dtype)
    nz = op != 0.0
    return torch.where(nz, (a.t() @ v) / torch.where(nz, op, 1.0), b.t() @ v)


def cluster_shadow_grad_plain(origin, direction, dist, box_tab, frames, op_tab,
                              g_rgb, g_a):
    """The vector-Jacobian product of :func:`cluster_shadow_plain` with
    respect to ``op_tab`` for the cotangents (g_rgb [R,3], g_a [R]):
    d_op_tab [Cp, 4, 128]. Every hit with t in (0, dist) counts (no alpha
    stop, as in the JAX package's dense replay). Per ray and channel, P is
    the product of its non-zero factors and z the number of zero ones; a hit
    of factor f gets g P / f when f != 0 and z = 0, g P when f = 0 and
    z = 1, else 0: the product of the ray's other factors times g, with no
    division by zero. Two walks over every real cluster."""
    clusters = _real_clusters(box_tab)

    def hits(c):
        t, b1, b2 = _project(origin, direction, box_tab, frames, c)
        return _inside(b1, b2) & (t > 0.0) & (t < dist[:, None])

    prod = torch.ones((origin.shape[0], 4), dtype=torch.float32,
                      device=origin.device)
    zeros = torch.zeros(prod.shape, dtype=torch.int64, device=origin.device)
    for c, _ in clusters:
        prod, zeros = _fold_hits(hits(c), op_tab[c], prod, zeros)
    coef = _coefficients(g_rgb, g_a, prod, zeros)
    out = torch.zeros_like(op_tab)
    for c, _ in clusters:
        out[c] = _slot_grad(hits(c), coef, op_tab[c])
    return out


def cluster_shadow_inst_grad_plain(origin, direction, dist, ti_rows, cl_obox,
                                   frames, cl_slot, op_tab, g_rgb, g_a):
    """The vector-Jacobian product of :func:`cluster_shadow_inst_plain` with
    respect to the instance slot table ``op_tab`` [I, 4, 64] for the
    cotangents (g_rgb [R,3], g_a [R]): d_op_tab [I, 4, 64], each hit's share
    as in :func:`cluster_shadow_grad_plain` added to its instance's entry of
    its triangle's slot. Two walks over every real instance and cluster."""
    box = cl_obox.t()
    slots = cl_slot.long()

    def visits():
        for k, gid, clusters in _real_instances(ti_rows, cl_obox):
            o, d = _object_rays(origin, direction, ti_rows, k)
            for s, _ in clusters:
                t, b1, b2 = _project(o, d, box, frames, s)
                yield (gid, s, _inside(b1, b2) & (t > 0.0) & (t < dist[:, None]),
                       op_tab[gid][:, slots[s]])

    prod = torch.ones((origin.shape[0], 4), dtype=torch.float32,
                      device=origin.device)
    zeros = torch.zeros(prod.shape, dtype=torch.int64, device=origin.device)
    for _, _, hit, op in visits():
        prod, zeros = _fold_hits(hit, op, prod, zeros)
    coef = _coefficients(g_rgb, g_a, prod, zeros)
    out = torch.zeros_like(op_tab)
    for gid, s, hit, op in visits():
        out[gid].index_add_(1, slots[s], _slot_grad(hit, coef, op))
    return out


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _check_soup_shadow(origin, direction, dist, box_tab, frames, op_tab):
    """The argument checks of B2 and B2-grad on a CUDA device. Returns
    (device, rays, table rows)."""
    dev = _kernels.card(origin.device)
    r = _check_rays(dev, origin, direction, dist=dist)
    cp = _check_tables(dev, box_tab, frames)
    _kernels.check(dev, "op_tab", op_tab, torch.float32, (cp, 4, CLUSTER_T))
    _aligned(frames=frames, op_tab=op_tab)
    return dev, r, cp


def _check_inst_shadow(origin, direction, dist, ti_rows, cl_obox, frames,
                       cl_slot, op_tab):
    """The argument checks of B4 and B4-grad on a CUDA device. Returns
    (device, rays, instance rows)."""
    dev = _kernels.card(origin.device)
    r = _check_rays(dev, origin, direction, dist=dist)
    ip = _check_inst_tables(dev, ti_rows, cl_obox, frames)
    _kernels.check(dev, "cl_slot", cl_slot, torch.float32,
                   (cl_obox.shape[0], CLUSTER_T))
    _kernels.check(dev, "op_tab", op_tab, torch.float32,
                   (op_tab.shape[0], 4, SLOTS))
    _aligned(frames=frames, cl_slot=cl_slot, op_tab=op_tab)
    return dev, r, ip


def _check_cotangents(dev, r, g_rgb, g_a):
    _kernels.check(dev, "g_rgb", g_rgb, torch.float32, (r, 3))
    _kernels.check(dev, "g_a", g_a, torch.float32, (r,))


@counted()
def cluster_shadow_grad(origin, direction, dist, box_tab, frames, op_tab,
                        g_rgb, g_a, *, visits=None):
    """B2-grad: d_op_tab [Cp, 4, 128], the gradient of B2's product with
    respect to its opacity table for the cotangents (g_rgb [R,3], g_a [R])
    (:func:`cluster_shadow_grad_plain`). CPU tensors take the plain
    version; CUDA tensors launch the B2-grad kernel
    (``csrc/cluster_shadow_grad.cu``): B2's ranked walk twice per block of
    128 rays with no alpha stop, the block's contributions summed in shared
    memory and added with one atomicAdd per entry per visit (so the last
    bits vary from call to call). ``visits`` as for :func:`cluster_closest`,
    counting both walks' cluster tests (CUDA only, off the training
    path)."""
    if origin.device.type == "cpu":
        return cluster_shadow_grad_plain(origin, direction, dist, box_tab,
                                         frames, op_tab, g_rgb, g_a)
    lib = _kernels.load()
    dev, r, cp = _check_soup_shadow(origin, direction, dist, box_tab, frames,
                                    op_tab)
    _check_cotangents(dev, r, g_rgb, g_a)
    _ranked_smem(lib, dev, cp, kernel=5)
    counts = _visit_buffer(visits, dev, r)
    d_op = torch.zeros_like(op_tab)
    if r:
        _launch(cluster_shadow_grad, lib.rz_cluster_shadow_grad, dev,
                _ptr(origin), _ptr(direction), _ptr(dist), _ptr(g_rgb),
                _ptr(g_a), _ptr(box_tab), _ptr(frames), _ptr(op_tab), r, cp,
                _ptr(d_op), counts)
    return d_op


@counted()
def cluster_shadow_inst_grad(origin, direction, dist, ti_rows, cl_obox, frames,
                             cl_slot, op_tab, g_rgb, g_a, *, visits=None):
    """B4-grad: d_op_tab [I, 4, 64], the gradient of B4's product with
    respect to the instance slot table of :func:`instance_opacity` for the
    cotangents (g_rgb [R,3], g_a [R])
    (:func:`cluster_shadow_inst_grad_plain`). CPU tensors take the plain
    version; CUDA tensors launch the B4-grad kernel
    (``csrc/cluster_shadow_inst_grad.cu``): B4's ranked walk at both levels
    twice per block of 128 rays with no alpha stop, a visited instance's
    contributions summed in shared memory and added with one atomicAdd per
    entry. ``visits`` as for :func:`cluster_closest_inst`, counting both
    walks (CUDA only, off the training path)."""
    if origin.device.type == "cpu":
        return cluster_shadow_inst_grad_plain(origin, direction, dist, ti_rows,
                                              cl_obox, frames, cl_slot, op_tab,
                                              g_rgb, g_a)
    lib = _kernels.load()
    dev, r, ip = _check_inst_shadow(origin, direction, dist, ti_rows, cl_obox,
                                    frames, cl_slot, op_tab)
    _check_cotangents(dev, r, g_rgb, g_a)
    _ranked_smem(lib, dev, ip, kernel=6)
    counts = _visit_buffer(visits, dev, r)
    d_op = torch.zeros_like(op_tab)
    if r:
        _launch(cluster_shadow_inst_grad, lib.rz_cluster_shadow_inst_grad,
                dev, _ptr(origin), _ptr(direction), _ptr(dist), _ptr(g_rgb),
                _ptr(g_a), _ptr(ti_rows), _ptr(cl_obox), _ptr(frames),
                _ptr(cl_slot), _ptr(op_tab), r, ip, _ptr(d_op), counts)
    return d_op


# ---------------------------------------------------------------------------
# the shadow entry points and their autograd Functions
# ---------------------------------------------------------------------------

class _Shadow(torch.autograd.Function):
    """B2 and its backward: forward :func:`_shadow` on the opacity table
    ``op_tab``; backward :func:`cluster_shadow_grad`, the gradient of
    ``op_tab`` (the product is piecewise constant in the rays and dist:
    they get none)."""

    @staticmethod
    def forward(ctx, origin, direction, dist, op_tab, box_tab, frames, groups,
                visits):
        ctx.save_for_backward(origin, direction, dist, op_tab)
        ctx.tables = (box_tab, frames)
        return _shadow(origin, direction, dist, box_tab, frames, op_tab,
                       groups, visits)

    @staticmethod
    def backward(ctx, g_rgb, g_a):
        d_op = None
        if ctx.needs_input_grad[3]:
            o, d, dist, op_tab = ctx.saved_tensors
            d_op = cluster_shadow_grad(o, d, dist, *ctx.tables, op_tab,
                                       g_rgb.contiguous(), g_a.contiguous())
        return None, None, None, d_op, None, None, None, None


class _ShadowInst(torch.autograd.Function):
    """B4 and its backward: forward :func:`_shadow_inst` on the instance
    slot table ``op_tab``; backward :func:`cluster_shadow_inst_grad`, the
    gradient of ``op_tab`` only."""

    @staticmethod
    def forward(ctx, origin, direction, dist, op_tab, ti_rows, cl_obox, frames,
                cl_slot, visits):
        ctx.save_for_backward(origin, direction, dist, op_tab)
        ctx.tables = (ti_rows, cl_obox, frames, cl_slot)
        return _shadow_inst(origin, direction, dist, ti_rows, cl_obox, frames,
                            cl_slot, op_tab, visits)

    @staticmethod
    def backward(ctx, g_rgb, g_a):
        d_op = None
        if ctx.needs_input_grad[3]:
            o, d, dist, op_tab = ctx.saved_tensors
            d_op = cluster_shadow_inst_grad(o, d, dist, *ctx.tables, op_tab,
                                            g_rgb.contiguous(),
                                            g_a.contiguous())
        return None, None, None, d_op, None, None, None, None, None


def _cutout_args(dev, cp: int, cutouts):
    """B2's cutout launch arguments: null pointers and zeros without
    ``cutouts``, else its tables, checked, the device's fetch counter
    (``cluster_shadow.fetches``) and the colour atlas's sizes."""
    if cutouts is None:
        return (ctypes.c_void_p(None),) * 8 + (0, 0, 0)
    c = cutouts
    k = c.map_rect.shape[0]
    _kernels.check(dev, "slot_map", c.slot_map, torch.int32, (cp, CLUSTER_T))
    _kernels.check(dev, "slot_uv", c.slot_uv, torch.float32,
                   (cp, CLUSTER_T, 6))
    _kernels.check(dev, "color_atlas", c.color_atlas, torch.float32)
    hc, wc = c.color_atlas.shape[:2]
    _kernels.check(dev, "col_blk_idx", c.col_blk_idx, torch.int32,
                   (hc * wc, 4))
    _kernels.check(dev, "map_rect", c.map_rect, torch.int32, (k, 4))
    _kernels.check(dev, "map_flags", c.map_flags, torch.int32, (k, 3))
    _kernels.check(dev, "map_uv", c.map_uv, torch.float32, (k, 5))
    _aligned(color_atlas=c.color_atlas, col_blk_idx=c.col_blk_idx)
    return (_ptr(c.slot_map), _ptr(c.slot_uv),
            _ptr(cluster_shadow.fetches.pair(dev)), _ptr(c.color_atlas),
            _ptr(c.col_blk_idx), _ptr(c.map_rect), _ptr(c.map_flags),
            _ptr(c.map_uv), k, wc, hc * wc)


def _shadow(origin, direction, dist, box_tab, frames, op_tab, groups=None,
            visits=None, cutouts=None):
    """B2 on an opacity table, with the texel factors of ``cutouts`` where
    given: the plain version on the CPU, the kernel on a card (grouped as
    :func:`cluster_closest`); either adds to ``cluster_shadow``'s ``rays``
    and ``work``."""
    if origin.device.type == "cpu":
        *out, fetches = _shadow_plain(origin, direction, dist, box_tab,
                                      frames, op_tab, cutouts)
        _count_plain_soup(cluster_shadow, dist > 0.0, box_tab, visits)
        if cutouts is not None:
            cluster_shadow.fetches.pair(origin.device).add_(
                fetches.sum().reshape(1))
        return tuple(out)
    lib = _kernels.load()
    dev, r, cp = _check_soup_shadow(origin, direction, dist, box_tab, frames,
                                    op_tab)
    grp, gp = _group_args(dev, cp, groups)
    cut = _cutout_args(dev, cp, cutouts)
    _ranked_smem(lib, dev, gp or cp, kernel=2, grouped=gp > 0)
    counts, stats = _soup_visits(visits, dev, r)
    work = cluster_shadow.work.pair(dev)
    rgb = torch.empty((r, 3), dtype=torch.float32, device=dev)
    a = torch.empty(r, dtype=torch.float32, device=dev)
    if r:
        _launch(cluster_shadow, lib.rz_cluster_shadow, dev,
                _ptr(origin), _ptr(direction), _ptr(dist), _ptr(box_tab),
                _ptr(frames), _ptr(op_tab), grp, r, cp, gp, _ptr(rgb), _ptr(a),
                counts, stats, _ptr(work), *cut)
        cluster_shadow.rays += r
        if gp:
            cluster_shadow.grouped += 1
    return rgb, a


@counted("grouped", "rays")
def cluster_shadow(origin, direction, dist, box_tab, frames, order, base,
                   count, op_rgb, op_a, *, tris=None, groups=None,
                   visits=None, cutouts=None):
    """Transmission-filtered visibility: (mask_rgb [R,3], mask_a [R]), the
    product of the live material opacity over every hit in (0, dist).
    CPU tensors take :func:`cluster_shadow_plain`; CUDA tensors launch the
    B2 kernel (``csrc/cluster_shadow.cu``), a ranked front-to-back walk per
    block of 128 rays that stops a ray once its alpha is below 1e-4.
    ``groups``, ``visits``, ``rays`` and ``work`` as for
    :func:`cluster_closest`; ``work`` (:data:`SHADOW_WORK`) also counts the
    live rays, those of dist > 0 (a ray of dist <= 0 walks nothing and
    gets visibility 1).

    ``cutouts`` (a :class:`Cutouts`): each hit in a cutout slot also takes
    its texel factor (rgb, 1 - alpha) (:func:`cutout_factors`; on a card
    the kernel's cutout variant), and ``fetches`` (:class:`WorkCounter`:
    :data:`CUTOUT_WORK`) counts the texels fetched, so that the product is
    the whole transmission through texture-alpha cutouts. Against the
    dense pass (``engine/integrator.py`` ``texture_shadow_factor`` times
    this product without ``cutouts``) the kernel departs in alpha by less
    than 1e-4 where its stop fires (a ray is blocked once the combined
    alpha is below 1e-4; the dense pass multiplies every texel), and both
    it and the plain version (no stop) by the rounding of a hit's
    barycentrics, which they take in the cluster's local frame and the
    dense pass in a world-space frame: at a silhouette's edge a bilinear
    alpha map of 256 texels moves by up to 256 per unit of texture
    coordinate (some 4e-3 there on the leaf canopy). A ray that starts on
    a cutout, as a bounce off a leaf does where the integrator's nudge
    (1e-4 of the path's last segment) is below the frames' rounding,
    meets that card within rounding of t = 0, and the two frames may put
    the hit on either side of 0: there each route's result is the result
    with that card's factor or the one without it (the dense route's with
    the origin moved 3e-5 m back or on along the ray), to the rounding
    above, which grows as 1 / |cos| of the angle between the ray and the
    card's normal, and the routes may take different ones. With
    ``cutouts`` it is not differentiable: the dense pass carries the
    atlas's gradient.

    Differentiable when grad mode is on and an input requires grad; as in
    the JAX package the caller passes ``tris`` = (tri_v0, tri_e1, tri_e2),
    the soup triangles in the order of ``op_rgb`` / ``op_a``, which its
    dense replay reads. Here the backward is B2-grad
    (:func:`cluster_shadow_grad`: that replay's result, computed by the
    walk). Only the opacities get a gradient: the product is piecewise
    constant in the rays and the triangles, which only decide which
    factors enter."""
    grad = tris is not None and _needs_grad(origin, direction, *tris, op_rgb,
                                            op_a)
    if not grad and _needs_grad(origin, direction, op_rgb, op_a):
        raise ValueError("cluster_shadow needs tris=(tri_v0, tri_e1, tri_e2) "
                         "to differentiate")
    if grad and cutouts is not None:
        raise ValueError("cluster_shadow differentiates no texel factor: "
                         "take the dense cutout pass under autograd")
    op_tab = cluster_opacity(op_rgb, op_a, order, base, count)
    if grad:
        return _Shadow.apply(origin, direction, dist, op_tab, box_tab, frames,
                             groups, visits)
    return _shadow(origin, direction, dist, box_tab, frames, op_tab, groups,
                   visits, cutouts)


cluster_shadow.work = WorkCounter(SHADOW_WORK)
cluster_shadow.fetches = WorkCounter(CUTOUT_WORK)


def _check_inst_tables(dev, ti_rows, cl_obox, frames):
    """B3's and B4's instance and cluster tables on ``dev``; returns their
    instance rows Ip."""
    ip, cm = ti_rows.shape[0], cl_obox.shape[0]
    if (ti_rows.shape != (ip, TI_W) or ip % 128 or cl_obox.shape != (cm, 8)
            or frames.shape != (cm, 4, 3 * CLUSTER_T)):
        raise ValueError(f"instance tables disagree: ti_rows "
                         f"{tuple(ti_rows.shape)}, cl_obox {tuple(cl_obox.shape)}"
                         f", frames {tuple(frames.shape)}")
    for name, x in (("ti_rows", ti_rows), ("cl_obox", cl_obox),
                    ("frames", frames)):
        _kernels.check(dev, name, x, torch.float32)
    return ip


@counted("rays")
def cluster_closest_inst(origin, direction, near, far, ti_rows, cl_obox,
                         frames, *, visits=None):
    """Two-level closest hit. Returns (t [R], tri_id [R] i32 in DEVICE
    order, i.e. the order of ``tri_pack``, and inst_id [R] i32; -1 = miss).
    CPU tensors take :func:`cluster_closest_inst_plain`; CUDA tensors launch
    the B3 kernel (``csrc/cluster_closest_inst.cu``), a ranked front-to-back
    walk of the instances, ranked per block of 128 rays, and of each
    visited mesh's clusters, per warp of 32 rays (near < 0 as for
    :func:`cluster_closest`). ``visits`` as for
    :func:`cluster_closest`, counting (instance, cluster) tests (on the CPU
    too, as :func:`_count_plain` counts). Adds to ``rays`` and ``work``
    (:class:`WorkCounter`) on every call."""
    if origin.device.type == "cpu":
        out = cluster_closest_inst_plain(origin, direction, near, far,
                                         ti_rows, cl_obox, frames)
        _count_plain_inst(cluster_closest_inst, far > 0.0, ti_rows,
                          visits)
        return out
    lib = _kernels.load()
    dev = _kernels.card(origin.device)
    r = _check_rays(dev, origin, direction, near=near, far=far)
    ip = _check_inst_tables(dev, ti_rows, cl_obox, frames)
    _aligned(frames=frames)
    _ranked_smem(lib, dev, ip, kernel=3)
    counts = _visit_buffer(visits, dev, r)
    work = cluster_closest_inst.work.pair(dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    tid = torch.empty(r, dtype=torch.int32, device=dev)
    inst = torch.empty(r, dtype=torch.int32, device=dev)
    if r:
        _launch(cluster_closest_inst, lib.rz_cluster_closest_inst, dev,
                _ptr(origin), _ptr(direction), _ptr(near), _ptr(far),
                _ptr(ti_rows), _ptr(cl_obox), _ptr(frames), r, ip, _ptr(t),
                _ptr(tid), _ptr(inst), counts, _ptr(work))
        cluster_closest_inst.rays += r
    return t, tid, inst


cluster_closest_inst.work = WorkCounter(INST_WORK)


def _shadow_inst(origin, direction, dist, ti_rows, cl_obox, frames, cl_slot,
                 op_tab, visits=None):
    """B4 on an instance slot table: the plain version on the CPU, the
    kernel on a card; either adds to ``cluster_shadow_inst``'s ``rays``
    and ``work``."""
    if origin.device.type == "cpu":
        out = cluster_shadow_inst_plain(origin, direction, dist, ti_rows,
                                        cl_obox, frames, cl_slot, op_tab)
        _count_plain_inst(cluster_shadow_inst, dist > 0.0, ti_rows, visits)
        return out
    lib = _kernels.load()
    dev, r, ip = _check_inst_shadow(origin, direction, dist, ti_rows, cl_obox,
                                    frames, cl_slot, op_tab)
    _ranked_smem(lib, dev, ip, kernel=4)
    counts = _visit_buffer(visits, dev, r)
    work = cluster_shadow_inst.work.pair(dev)
    rgb = torch.empty((r, 3), dtype=torch.float32, device=dev)
    a = torch.empty(r, dtype=torch.float32, device=dev)
    if r:
        _launch(cluster_shadow_inst, lib.rz_cluster_shadow_inst, dev,
                _ptr(origin), _ptr(direction), _ptr(dist), _ptr(ti_rows),
                _ptr(cl_obox), _ptr(frames), _ptr(cl_slot), _ptr(op_tab), r, ip,
                _ptr(rgb), _ptr(a), counts, _ptr(work))
        cluster_shadow_inst.rays += r
    return rgb, a


@counted("rays")
def cluster_shadow_inst(origin, direction, dist, ti_rows, cl_obox, frames,
                        cl_slot, inst_slot_map, mat_color, *, tris=None,
                        expanded=None, visits=None):
    """Two-level transmission-filtered visibility: (mask_rgb [R,3],
    mask_a [R]), the product of the live material opacity, resolved through
    each instance's slot table (:func:`instance_opacity`), over every hit in
    (0, dist). CPU tensors take :func:`cluster_shadow_inst_plain`; CUDA
    tensors launch the B4 kernel (``csrc/cluster_shadow_inst.cu``), a
    ranked front-to-back walk of the instances and of each visited mesh's
    clusters, as B3's, that stops a ray once its alpha is below 1e-4.
    ``visits``, ``rays`` and ``work`` as for :func:`cluster_closest_inst`;
    ``work`` (:data:`INST_SHADOW_WORK`) also counts the live rays, as
    :func:`cluster_shadow`'s.

    Differentiable when grad mode is on and an input requires grad; as in
    the JAX package the caller passes ``tris`` = (tri_v0, tri_e1, tri_e2)
    in object space and device order and ``expanded`` = (tri_slot, exp_tri,
    exp_inst, inst_fwd), which its dense replay over the expanded
    (instance, triangle) set reads. Here the backward is B4-grad
    (:func:`cluster_shadow_inst_grad`); as for :func:`cluster_shadow`, only
    ``mat_color`` gets a gradient, through :func:`instance_opacity`."""
    grad = tris is not None and _needs_grad(origin, direction, *tris, mat_color)
    if grad and expanded is None:
        raise ValueError("cluster_shadow_inst needs expanded=(tri_slot, "
                         "exp_tri, exp_inst, inst_fwd) to differentiate; "
                         "compile the world with differentiable=True")
    if not grad and _needs_grad(origin, direction, mat_color):
        raise ValueError("cluster_shadow_inst needs tris= and expanded= to "
                         "differentiate")
    op_tab = instance_opacity(mat_color, inst_slot_map)
    if grad:
        return _ShadowInst.apply(origin, direction, dist, op_tab, ti_rows,
                                 cl_obox, frames, cl_slot, visits)
    return _shadow_inst(origin, direction, dist, ti_rows, cl_obox, frames,
                        cl_slot, op_tab, visits)


cluster_shadow_inst.work = WorkCounter(INST_SHADOW_WORK)
