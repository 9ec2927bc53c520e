"""Cluster tables built to test the ranked walks (B1-B4) against their
plain versions, for ``chip_smoke.py`` and the port's tests.

* :func:`tie_tables`: every cluster of a random soup twice, as rows
  ``[0, m)`` and ``[m, 2m)`` with the same frames. The second copy's boxes
  are grown on every side with the float32 centre ``(lo + hi) * 0.5`` kept
  bit for bit, so each duplicated triangle gives the same t in both rows
  while the later row's box is entered first: a front-to-back walk meets
  the later row first and must still return the earlier row's hit, as the
  plain version's table order does.
* :func:`tie_instance_tables`: the same doubled table as one mesh, under
  three instances: the identity, the identity again with a grown world box
  (exact ties across instance rows, the later one entered first) and a
  translated copy.
* :func:`window_tables` / :func:`window_instance_tables`: a soup's clusters
  tiled with shifted boxes into more rows than the kernels rank at once
  (``RANK_WINDOW`` cluster rows for B1, ``MESH_WINDOW`` clusters of one mesh
  for B4-grad; B3 and B4 rank a mesh 32 clusters at a time), so their walks
  take several windows.
* :func:`many_instance_tables`: a small soup's mesh under more instance rows
  than the kernels rank at once (``RANK_WINDOW``), so B3's and B4's
  instance walk takes several windows.

Each returns NumPy arrays and the world-space triangles (``v0``, ``e1``,
``e2``, in the order of the ids the tables report) to aim rays at;
:func:`soup_opacity` / :func:`instance_materials` add (translucent)
opacities for the shadow walks (B2, B4).

:func:`needed_soup` / :func:`needed_inst` count the visits a walk needs
(the ray and (instance,) cluster pairs whose exact slab interval meets
[t0, t1]), for the bounds and the made-against-needed checks;
:func:`shadow_hits` / :func:`shadow_hits_inst` count the hits a shadow
backward scatters (the ray and triangle pairs with t in (0, dist)).

:func:`soup_replay` / :func:`inst_replay` are the JAX package's custom_vjp
rules for B2 and B4, a dense replay of the shadow test through
``ops/intersect.py`` ``project_shadow``: autograd through them is the
oracle of the shadow walks' gradients.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import _kernels
from ..ops import traverse_cluster as tc
from ..ops.intersect import project_shadow, triangle_frames_torch
from ..ops.traverse_cluster import (B_BASE, B_CNT, B_MAX, B_MIN,
                                    build_cluster_tables,
                                    build_instance_tables)

RANK_WINDOW = _kernels.header_constant("RANK_MAX")     # B1 rows per window
MESH_WINDOW = _kernels.header_constant("CL_WINDOW")    # B4-grad clusters per window
_F = np.float32


def soup(n: int, seed: int, spread: float = 4.0, size: float = 0.35):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n, 3)).astype(_F)
    e1 = rng.uniform(-size, size, (n, 3)).astype(_F)
    e2 = rng.uniform(-size, size, (n, 3)).astype(_F)
    return v0, e1, e2


def aimed_rays(v0, e1, e2, r: int, seed: int, spread: float = 6.0):
    """Random origins; every other ray aimed at a random point inside a
    random triangle, so that most of them hit."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (r, 3)).astype(_F)
    d = rng.normal(size=(r, 3)).astype(_F)
    k = rng.integers(0, len(v0), r // 2)
    b = rng.uniform(0.05, 0.45, (r // 2, 2)).astype(_F)
    d[: r // 2] = v0[k] + b[:, :1] * e1[k] + b[:, 1:] * e2[k] - o[: r // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def wall_rays(v0, e1, e2, r: int):
    """Rays that each hit one of the first triangles from 0.5 before it,
    all along (1, 1, 1): on a :func:`window_tables` grid the clusters
    behind the hits on their lines outnumber the needed ones, so a walk
    without the front-to-back stop tests several times the needed
    clusters."""
    k = np.arange(r) % len(v0)
    a = np.asarray([[1, 1, 1]], _F) / np.sqrt(_F(3))
    p = v0[k] + _F(0.25) * e1[k] + _F(0.25) * e2[k]
    return (p - _F(0.5) * a).astype(_F), np.tile(a, (r, 1)).astype(_F)


def grow_centred(lo, hi):
    """Boxes grown by a power of two on every side, per element the
    smallest of 2^-2 .. 2^10 that keeps the float32 centre
    ``(lo + hi) * 0.5`` bit for bit (an element with none keeps its
    bounds)."""
    lo, hi = lo.astype(_F), hi.astype(_F)
    ctr = (lo + hi) * _F(0.5)
    out_lo, out_hi = lo.copy(), hi.copy()
    todo = np.ones(lo.shape, bool)
    for k in range(-2, 11):
        e = _F(2.0 ** k)
        a, b = lo - e, hi + e
        ok = todo & ((a + b) * _F(0.5) == ctr)
        out_lo[ok], out_hi[ok] = a[ok], b[ok]
        todo &= ~ok
    return out_lo, out_hi


def _padded(rows: int):
    """Empty soup tables of ``rows`` rows rounded up to 128: padding boxes no
    slab reaches and never-hit frames, as ``build_cluster_tables`` pads."""
    cp = max(128, -(-rows // 128) * 128)
    box = np.zeros((8, cp), _F)
    box[B_MIN:B_MIN + 3] = 3e38
    box[B_MAX:B_MAX + 3] = -3e38
    frames = np.zeros((cp, 4, 384), _F)
    frames[:, 3, 0:128] = -1.0
    frames[:, 3, 128:256] = -1.0
    frames[:, 3, 256:384] = 1.0
    return box, frames


def _copies(box, frames, m: int, t: int, shifts, grow_from: int = -1):
    """Rows of ``len(shifts)`` copies of the first ``m`` clusters, copy i
    moved by ``shifts[i]`` and its ids offset by ``i * t``; copies from
    ``grow_from`` on get :func:`grow_centred` boxes."""
    n = len(shifts)
    out_box, out_frames = _padded(n * m)
    for i, s in enumerate(np.asarray(shifts, _F)):
        rows = slice(i * m, (i + 1) * m)
        lo = box[B_MIN:B_MIN + 3, :m] + s[:, None]
        hi = box[B_MAX:B_MAX + 3, :m] + s[:, None]
        if 0 <= grow_from <= i:
            lo, hi = grow_centred(lo, hi)
        out_box[B_MIN:B_MIN + 3, rows] = lo
        out_box[B_MAX:B_MAX + 3, rows] = hi
        out_box[B_BASE, rows] = box[B_BASE, :m] + _F(i * t)
        out_box[B_CNT, rows] = box[B_CNT, :m]
        out_frames[rows] = frames[:m]
    return out_box, out_frames


def _soup_tables(n: int, seed: int):
    v0, e1, e2 = soup(n, seed)
    box, frames, order, _, count = build_cluster_tables(v0, e1, e2)
    return v0, e1, e2, box, frames, order, int((count > 0).sum())


def _tiled(v0, e1, e2, order, shifts):
    """World-space triangles and the cluster-order -> original id map of the
    copies (copy i's triangles are originals i*T .. (i+1)*T - 1)."""
    t = len(v0)
    s = np.asarray(shifts, _F)
    return dict(v0=np.concatenate([v0 + si for si in s]),
                e1=np.tile(e1, (len(s), 1)), e2=np.tile(e2, (len(s), 1)),
                order=np.concatenate([order + i * t for i in range(len(s))])
                .astype(np.int32))


def tie_tables(n: int = 1200, seed: int = 7) -> dict:
    """Flat tables (box_tab, frames, order) of a soup's clusters twice, the
    second copy's boxes grown (see the module docstring)."""
    v0, e1, e2, box, frames, order, m = _soup_tables(n, seed)
    shifts = np.zeros((2, 3), _F)
    out = _tiled(v0, e1, e2, order, shifts)
    out["box_tab"], out["frames"] = _copies(box, frames, m, len(v0), shifts,
                                            grow_from=1)
    out["real_rows"] = 2 * m
    return out


def window_tables(rows: int = 2 * RANK_WINDOW + 1, n: int = 300,
                  seed: int = 8) -> dict:
    """Flat tables of at least ``rows`` real cluster rows: a soup's
    clusters tiled along a 3-D grid of shifts 10 apart."""
    v0, e1, e2, box, frames, order, m = _soup_tables(n, seed)
    k = -(-rows // m)
    side = int(np.ceil(k ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
    shifts = (grid.reshape(-1, 3)[:k] * 10.0 - 5.0 * side).astype(_F)
    out = _tiled(v0, e1, e2, order, shifts)
    out["box_tab"], out["frames"] = _copies(box, frames, m, len(v0), shifts)
    out["real_rows"] = k * m
    return out


def _mesh(flat: dict):
    """Shared-cluster rows (cl_obox [Cm, 8], frames) of a flat table's real
    rows: one mesh whose triangle ids are its cluster-order ids."""
    rows = flat["real_rows"]
    return (np.ascontiguousarray(flat["box_tab"][:, :rows].T),
            np.ascontiguousarray(flat["frames"][:rows]))


def _instances(cl_obox, moves, grow):
    """ti_rows of one instance per (translation, grow) of the mesh, all of
    its clusters, global ids 0, 1, ...; a grown instance's world box is
    twice the mesh box around the same centre."""
    lo = cl_obox[:, 0:3].min(0)
    hi = cl_obox[:, 3:6].max(0)
    wmin, wmax, inv = [], [], []
    for mv, g in zip(np.asarray(moves, _F), grow):
        a, b = lo + mv, hi + mv
        if g:
            c, h = (a + b) * 0.5, (b - a)
            a, b = c - h, c + h
        wmin.append(a)
        wmax.append(b)
        inv.append(np.concatenate([np.eye(3, dtype=_F), -mv[:, None]], 1))
    i = len(moves)
    return build_instance_tables(np.asarray(wmin, _F), np.asarray(wmax, _F),
                                 np.asarray(inv, _F), np.zeros(i, np.int32),
                                 np.full(i, len(cl_obox), np.int32),
                                 np.arange(i, dtype=np.int32))


def _expanded(flat: dict, moves):
    """World-space triangles of every instance in instance order, each in
    device (cluster) order: instance k's triangle id j is row k * F + j."""
    v0, e1, e2 = (flat[x][flat["order"]] for x in ("v0", "e1", "e2"))
    mv = np.asarray(moves, _F)
    return dict(v0=np.concatenate([v0 + s for s in mv]),
                e1=np.tile(e1, (len(mv), 1)), e2=np.tile(e2, (len(mv), 1)))


def tie_instance_tables(n: int = 1200, seed: int = 7) -> dict:
    """Instanced tables (ti_rows, cl_obox, frames): the doubled soup of
    :func:`tie_tables` as one mesh under three instances (see the module
    docstring)."""
    flat = tie_tables(n, seed)
    cl_obox, frames = _mesh(flat)
    moves = [(0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (3.0, -2.0, 1.0)]
    out = _expanded(flat, moves)
    out.update(ti_rows=_instances(cl_obox, moves, (False, True, False)),
               cl_obox=cl_obox, frames=frames)
    return out


def window_instance_tables(rows: int = MESH_WINDOW + 100, n: int = 300,
                           seed: int = 9) -> dict:
    """Instanced tables of one mesh of at least ``rows`` clusters (tiled as
    :func:`window_tables`) under two instances."""
    flat = window_tables(rows, n, seed)
    cl_obox, frames = _mesh(flat)
    moves = [(0.0, 0.0, 0.0), (1.5, 0.5, -1.0)]
    out = _expanded(flat, moves)
    out.update(ti_rows=_instances(cl_obox, moves, (False, False)),
               cl_obox=cl_obox, frames=frames)
    return out


def many_instance_tables(rows: int = RANK_WINDOW + 100, n: int = 200,
                         seed: int = 10) -> dict:
    """Instanced tables of one small soup's mesh (``n`` triangles) under
    ``rows`` instances on a square grid 12 apart."""
    v0, e1, e2, box, frames, _, m = _soup_tables(n, seed)
    cl_obox, frames = _mesh(dict(box_tab=box, frames=frames, real_rows=m))
    side = int(np.ceil(np.sqrt(rows)))
    grid = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                                indexing="ij"), -1).reshape(-1, 2)[:rows]
    moves = np.zeros((rows, 3), _F)
    moves[:, 0], moves[:, 2] = grid[:, 0] * 12.0, grid[:, 1] * 12.0
    moves -= moves.mean(0)
    return dict(v0=np.concatenate([v0 + mv for mv in moves]),
                e1=np.tile(e1, (rows, 1)), e2=np.tile(e2, (rows, 1)),
                ti_rows=_instances(cl_obox, moves, (False,) * rows),
                cl_obox=cl_obox, frames=frames)


def soup_opacity(tabs: dict, seed: int) -> dict:
    """Per-triangle translucent opacities of a flat table for the shadow
    kernel (B2), in the original triangle order of ``tabs["order"]``: rgb
    factors in [0.3, 1] and alpha factors (1 - alpha) in [0.5, 0.95], with
    the per-row first triangle and count that ``cluster_opacity`` reads."""
    rng = np.random.default_rng(seed)
    t = len(tabs["v0"])
    return dict(op_rgb=rng.uniform(0.3, 1.0, (t, 3)).astype(_F),
                op_a=rng.uniform(0.5, 0.95, t).astype(_F),
                base=tabs["box_tab"][B_BASE].astype(np.int32),
                count=tabs["box_tab"][B_CNT].astype(np.int32))


def instance_materials(tabs: dict, seed: int, alpha=(0.05, 0.5)) -> dict:
    """Materials of an instanced table for the shadow kernel (B4): a random
    slot in [0, 4) per triangle (``cl_slot``), each instance's slots mapped
    to six random materials (``inst_slot_map``), and ``mat_color`` rgba
    with rgb in [0.3, 1] and alpha in ``alpha`` (translucent by default;
    (1, 1): opaque)."""
    rng = np.random.default_rng(seed)
    n_inst = int((tabs["ti_rows"][:, tc.TI_NCL] > 0).sum())
    color = np.concatenate([rng.uniform(0.3, 1.0, (6, 3)),
                            rng.uniform(*alpha, (6, 1))], 1)
    return dict(
        cl_slot=rng.integers(0, 4, (len(tabs["cl_obox"]), tc.CLUSTER_T))
        .astype(_F),
        inst_slot_map=rng.integers(0, 6, (n_inst, tc.SLOTS))
        .astype(np.int32),
        mat_color=color.astype(_F))


def _safe_inv(v):
    """The kernels' safe_inv: 1 / v with |v| raised to at least 1e-12."""
    small = v.abs() < 1e-12
    return 1.0 / torch.where(small, torch.where(v < 0, -1e-12, 1e-12), v)


def _slab(lo, hi, o, inv):
    """Exact slab (tmin, tmax) [n, m] of rays (o, inv) [n, 3] against the
    boxes lo, hi [m, 3]."""
    t1 = (lo[None] - o[:, None]) * inv[:, None]
    t2 = (hi[None] - o[:, None]) * inv[:, None]
    return torch.minimum(t1, t2).amax(2), torch.maximum(t1, t2).amin(2)


def _needed(o, inv, t0, t1, lo, hi, cnt, chunk_pairs=1 << 24):
    """Pairs of rays and boxes whose exact slab interval meets [t0, t1]:
    (pairs, triangle tests = pairs x the box's triangle count, the boxes
    some ray needs)."""
    step = max(1, chunk_pairs // max(1, len(lo)))
    pairs, tests = 0, 0.0
    rows = torch.zeros(len(lo), dtype=torch.bool, device=o.device)
    for a in range(0, len(o), step):
        tmin, tmax = _slab(lo, hi, o[a:a + step], inv[a:a + step])
        need = ((tmax >= t0[a:a + step, None]) & (tmin <= tmax)
                & (tmin <= t1[a:a + step, None]))
        pairs += int(need.sum())
        tests += float(need.float().sum(0) @ cnt)
        rows |= need.any(0)
    return pairs, tests, rows


def needed_soup(o, d, t0, t1, box_tab):
    """Needed visits of a soup walk (B1, B2): (ray, cluster) pairs whose
    exact slab interval meets [t0, t1]. Returns (pairs, triangle tests,
    clusters needed by some ray, real cluster rows)."""
    real = (box_tab[B_CNT] > 0).nonzero().flatten()
    lo = box_tab[B_MIN:B_MIN + 3, real].t()
    hi = box_tab[B_MAX:B_MAX + 3, real].t()
    pairs, tests, rows = _needed(o, _safe_inv(d), t0, t1, lo, hi,
                                 box_tab[B_CNT, real])
    return pairs, tests, int(rows.sum()), len(real)


def needed_inst(o, d, t0, t1, ti_rows, cl_obox):
    """Needed visits of a two-level walk (B3, B4): (ray, instance, cluster)
    triples whose exact world-box interval and object-space cluster
    interval both meet [t0, t1]. Returns (cluster pairs, triangle tests,
    instance pairs, shared clusters needed, instances needed, real
    instance rows)."""
    inv = _safe_inv(d)
    rows = ti_rows[:, [tc.TI_CL0, tc.TI_NCL]].cpu()
    real = (rows[:, 1] > 0).nonzero().flatten().tolist()
    pairs, tests, inst_pairs, insts = 0, 0.0, 0, 0
    clusters = torch.zeros(cl_obox.shape[0], dtype=torch.bool, device=o.device)
    for k in real:
        tmin, tmax = _slab(ti_rows[k, 0:3][None], ti_rows[k, 3:6][None], o, inv)
        ok = ((tmax[:, 0] >= t0) & (tmin[:, 0] <= tmax[:, 0])
              & (tmin[:, 0] <= t1)).nonzero().flatten()
        if not len(ok):
            continue
        inst_pairs += len(ok)
        insts += 1
        oo, dd = tc._object_rays(o[ok], d[ok], ti_rows, k)
        s = slice(int(rows[k, 0]), int(rows[k, 0] + rows[k, 1]))
        p, t, need = _needed(oo, _safe_inv(dd), t0[ok], t1[ok],
                             cl_obox[s, 0:3], cl_obox[s, 3:6], cl_obox[s, 7])
        pairs += p
        tests += t
        clusters[s] |= need
    return pairs, tests, inst_pairs, int(clusters.sum()), insts, len(real)


def shadow_hits(o, d, dist, box_tab, frames) -> int:
    """Hits with t in (0, dist) of the rays (o, d) over every real cluster
    of a soup table (the plain versions' projection): each one a share that
    B2-grad adds."""
    hits = 0
    for c, _ in tc._real_clusters(box_tab):
        t, b1, b2 = tc._project(o, d, box_tab, frames, c)
        hits += int((tc._inside(b1, b2) & (t > 0.0) & (t < dist[:, None])).sum())
    return hits


def shadow_hits_inst(o, d, dist, ti_rows, cl_obox, frames) -> int:
    """:func:`shadow_hits` over every real instance and cluster of the
    two-level tables (B4-grad)."""
    box = cl_obox.t()
    hits = 0
    for k, _, clusters in tc._real_instances(ti_rows, cl_obox):
        oo, dd = tc._object_rays(o, d, ti_rows, k)
        for s, _ in clusters:
            t, b1, b2 = tc._project(oo, dd, box, frames, s)
            hits += int((tc._inside(b1, b2) & (t > 0.0)
                         & (t < dist[:, None])).sum())
    return hits


def soup_replay(origin, direction, dist, tri_v0, tri_e1, tri_e2, op_rgb, op_a):
    """B2's replay (JAX ``_make_cluster_shadow`` bwd): the dense shadow test
    over every soup triangle, frames built differentiably."""
    w, c = triangle_frames_torch(tri_v0, tri_e1, tri_e2)
    return project_shadow(origin, direction, dist, w, c, op_rgb, op_a,
                          chunk=replay_chunk(origin.shape[0], tri_v0.shape[0]))


def inst_replay(tri_slot, exp_tri, exp_inst, inst_fwd, inst_slot_map,
                origin, direction, dist, tri_v0, tri_e1, tri_e2, mat_color):
    """B4's replay (JAX ``_make_cluster_shadow_inst`` bwd): the dense shadow
    test over the expanded (instance, triangle) set, each triangle moved to
    world space by its instance's object->world rows and its opacity
    resolved through the instance's slot table."""
    tri, inst = exp_tri.long(), exp_inst.long()
    a = inst_fwd[inst].reshape(-1, 3, 4)
    lin = a[:, :, :3]

    def l2g(v):
        v = v[tri]
        return (lin[:, :, 0] * v[:, 0:1] + lin[:, :, 1] * v[:, 1:2]
                + lin[:, :, 2] * v[:, 2:3])

    w, c = triangle_frames_torch(l2g(tri_v0) + a[:, :, 3], l2g(tri_e1),
                                 l2g(tri_e2))
    mc = mat_color[inst_slot_map[inst, tri_slot[tri].long()].long()]
    return project_shadow(origin, direction, dist, w, c, mc[:, :3],
                          1.0 - mc[:, 3],
                          chunk=replay_chunk(origin.shape[0], tri.shape[0]))


def replay_chunk(r: int, f: int) -> int:
    """Triangles per checkpointed replay chunk: 512 as in the JAX package,
    fewer for wide wavefronts so that one chunk's [R, chunk] terms stay near
    2^25 elements (128 at 512^2 rays)."""
    return max(1, min(512, f, max(32, 2 ** 25 // max(r, 1))))
