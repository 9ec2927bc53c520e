"""Stackless BVH walk with skip links (``RenderConfig(packet_traversal=False)``).

Counterpart of ``rayzath_tpu/ops/traverse.py``, which runs as XLA code, not
as a Pallas kernel: here it runs as torch ops on the scene's device, the
CPU or the card, with no hand-written kernel (the walk is a public option,
never a fallback of the cluster kernels). Each ray walks the soup's leaf-8
BVH on its own, one node per step, exactly as the JAX walk does:

* the octant of its direction picks one of eight per-octant link tables
  (``build_aabb_links``, host side: per node its AABB, the near child
  ``first`` for that octant, -1 on leaves, and the subtree ``skip`` link);
* a step gathers the node's column and a leaf block (``[NB, G*L]``,
  field-major, gathered per call from the scene's :func:`leaf_table` ids,
  id -1 on padding and on inner nodes), tests
  the slab against ``min(far, best_t)`` (closest) or ``dist`` (shadow),
  runs Moller-Trumbore over the block's L triangles at once and either
  descends (``first``) or skips;
* a block's winner is the least t, then the largest id among ties; shadow
  rays multiply the translucent factors over the L lanes, then along the
  walk, and stop once alpha < 1e-4.

One difference, a repair: a leaf may hold more than L triangles (the
builder's leaves of primitives too large to split, and leaves at the depth
cap; cornell_box has one of 10, mesh_heavy one of 63). The JAX walk's leaf
block has L lanes and never tests the rest (ROADMAP C); here such a leaf
has one block per L triangles and takes one step per block, so a ray that
enters it tests every triangle. Where every leaf holds at most L triangles
the walks are the same step for step.

The compaction ladder of the JAX walk is kept: once at most a quarter of
the rays remain active (``cap = r // 4``, while ``cap >= 64``) the rest are
compacted onto quarter-size arrays. It changes the cost, never a result.

The loop's "rays still active" test is a host sync on the card, so it runs
every :data:`CHECK_EVERY` steps instead of every step. Extra steps leave a
finished ray as it is (its node stays >= N, and every update needs
``active``), so the results are those of a test at every step, bit for bit.
Each walk adds its host seconds to its ``seconds`` attribute, as the kernel
wrappers count their launches: on the card its last read of the count
waits for the device, so this is about its device time too.

Float operations are written one torch op at a time, in the JAX walk's
order, and the lane products as a fixed pairwise tree, so the card and the
CPU return the same bits (a torch kernel fuses nothing across ops; XLA on
the CPU fuses multiply-adds, so against JAX the hit ids agree except where
an f64 Moller-Trumbore calls the ray a tie, and t and rgba to float32
rounding).

No reverse mode: the JAX walk is a ``lax.while_loop``, which ``jax.grad``
refuses, so a walk whose inputs require a gradient raises here too instead
of recording a graph of every step. The integrator hands the closest-hit
walk detached rays (hit ids carry no gradient), as it does the kernels;
a shadow walk under autograd raises (ROADMAP C).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .intersect import DET_EPS, BIG

# Steps between two host reads of the active-ray count. A read drains the
# device queue (the host waits for the device, then the device for the
# host), while a step on finished rays only costs its ~50 launches; every
# 8 steps bounds the waste to 7 steps a phase (a phase runs tens to
# hundreds of steps) and cuts the syncs eightfold.
CHECK_EVERY = 8
ALPHA_STOP = 1e-4


class Hit(NamedTuple):
    t: torch.Tensor        # [R]
    tri_id: torch.Tensor   # [R] i32, -1 = miss


def build_aabb_links(node_min, node_max, node_count, first8, skip8):
    """Host-side [8, 8N] traversal table: per octant o and node n, column
    o*N + n holds (min xyz, max xyz, first, skip); first = -1 marks a leaf."""
    n = len(node_count)
    leaf = node_count > 0
    out = np.empty((8, 8 * n), np.float32)
    for o in range(8):
        s = slice(o * n, (o + 1) * n)
        out[0:3, s] = np.asarray(node_min, np.float32).T
        out[3:6, s] = np.asarray(node_max, np.float32).T
        out[6, s] = np.where(leaf, -1.0, first8[o].astype(np.float32))
        out[7, s] = skip8[o].astype(np.float32)
    return out


def _no_reverse_mode(*xs) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise ValueError(
            "the skip-link BVH walk (packet_traversal=False) has no reverse "
            "mode, as the JAX package's lax.while_loop has none: render it "
            "under torch.no_grad(), or differentiate with "
            "packet_traversal=True")


def _inv1(d):
    tiny = torch.full_like(d, 1e-12)
    return 1.0 / torch.where(d.abs() < 1e-12, torch.where(d < 0, -tiny, tiny), d)


def _octant(d):
    neg = (d < 0).to(torch.int64)
    return neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)


def leaf_table(node_begin, node_count, leaf_size: int) -> np.ndarray:
    """Host-side [NB, L] triangle ids of the leaf blocks of L =
    ``leaf_size`` lanes: ceil(count / L) blocks per leaf and one per inner
    node, in node order (a node's first block is the exclusive prefix sum of
    the block counts, :func:`_blocks`), -1 on padding and on inner nodes.
    Where no leaf holds more than L triangles, row n is the id group of the
    JAX walk's ``_leaf_table`` row n."""
    L = leaf_size
    begin = np.asarray(node_begin, np.int64)
    count = np.asarray(node_count, np.int64)
    blocks = np.maximum((count + L - 1) // L, 1)
    owner = np.repeat(np.arange(len(count)), blocks)
    part = np.arange(len(owner)) - (np.cumsum(blocks) - blocks)[owner]
    lane = part[:, None] * L + np.arange(L)
    return np.where(lane < count[owner][:, None],
                    begin[owner][:, None] + lane, -1).astype(np.int32)


class _Blocks(NamedTuple):
    table: torch.Tensor    # [NB, G*L] field-major leaf blocks
    first: torch.Tensor    # [N] i32 a node's first block row
    count: torch.Tensor    # [N] i32 its blocks (inner nodes: one of padding)


def _blocks(node_count, leaf_tri, columns) -> _Blocks:
    """The walk's leaf blocks from :func:`leaf_table`'s ids: one group of L
    lanes per column of ``columns`` ([F] per-triangle values), then the ids
    (-1 on padding), and each node's first block row and block count."""
    L = leaf_tri.shape[1]
    count = torch.clamp((node_count + (L - 1)) // L, min=1)
    first = torch.cumsum(count, 0, dtype=torch.int32) - count
    valid = leaf_tri >= 0
    idx = torch.clamp(leaf_tri, min=0).long()
    cols = [torch.where(valid, col[idx], 0.0) for col in columns]
    cols.append(leaf_tri.to(torch.float32))
    return _Blocks(torch.cat(cols, dim=1), first, count.to(torch.int32))


def _compact_slots(active, cap: int):
    """Indices of (up to ``cap``) active rays by a cumsum scatter (no sort,
    no sync). Requires ``sum(active) <= cap``; unused slots hold ray 0, a
    benign duplicate that recomputes and writes back ray 0's own result."""
    r = active.shape[0]
    pos = torch.cumsum(active.to(torch.int64), 0) - 1
    store = torch.where(active, pos, torch.full_like(pos, cap))
    slots = torch.zeros(cap + 1, dtype=torch.int64, device=active.device)
    slots[store] = torch.arange(r, dtype=torch.int64, device=active.device)
    return slots[:cap]


def _mt_lanes(g2, L, o1, d1):
    """Moller-Trumbore over the L leaf triangles of each ray's block
    (reference numerics, cuda_render_parts.cuh:1023-1083): [R, L] t and the
    barycentric test, from the field groups of ``g2`` and [R, 1] ray
    columns ``o1`` and ``d1``."""
    def grp(f):
        return g2[:, f * L:(f + 1) * L]
    ox, oy, oz = o1
    dx, dy, dz = d1
    v0x, v0y, v0z = grp(0), grp(1), grp(2)
    e1x, e1y, e1z = grp(3), grp(4), grp(5)
    e2x, e2y, e2z = grp(6), grp(7), grp(8)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det = det + torch.where(det.abs() < DET_EPS, DET_EPS, 0.0)
    inv_det = 1.0 / det
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    b1 = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    b2 = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    bary_ok = (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    return t, bary_ok


class _Rays:
    """Per-phase ray constants: the origin and direction columns, the
    inverse direction and the octant's column offset."""

    def __init__(self, origin, direction, n_nodes: int):
        self.o = origin.T                                     # [3, R]
        self.inv = _inv1(direction).T
        self.oct_off = _octant(direction) * n_nodes
        self.o1 = tuple(origin[:, i:i + 1] for i in range(3))
        self.d1 = tuple(direction[:, i:i + 1] for i in range(3))


def _slab(links, rays: _Rays, nid):
    """The node columns of each ray's octant and the slab interval:
    (tmin, tmax, first, skip)."""
    g1 = links[:, rays.oct_off + nid]                        # [8, R]
    t1 = (g1[0:3] - rays.o) * rays.inv
    t2 = (g1[3:6] - rays.o) * rays.inv
    tmin = torch.minimum(t1, t2).amax(0)
    tmax = torch.maximum(t1, t2).amin(0)
    return tmin, tmax, g1[6], g1[7]


def _walk(step, node, state, n_nodes: int, n_steps: int, stop_count: int):
    """Run ``step`` until at most ``stop_count`` rays remain active (their
    node < N), reading the count every CHECK_EVERY steps, or ``n_steps``
    + 1 steps have run (the JAX walk's guard, N + 1, with a step per leaf
    block: no ray takes more steps than there are blocks)."""
    for it in range(n_steps + 1):
        if it % CHECK_EVERY == 0 and int((node < n_nodes).sum()) <= stop_count:
            break
        node, state = step(node, state)
    return node, state


def _ladder(phase, n_nodes: int, rays: tuple, node, state: tuple):
    """The compaction ladder: a phase until <= r // 4 rays remain active,
    then the stragglers compacted onto quarter-size arrays, recursively,
    until the cap falls below 64."""
    cap = rays[0].shape[0] // 4
    if cap < 64:
        return phase(rays, node, state, 0)[1]
    node, state = phase(rays, node, state, cap)
    slots = _compact_slots(node < n_nodes, cap)
    sub = _ladder(phase, n_nodes, tuple(x[slots] for x in rays), node[slots],
                  tuple(x[slots] for x in state))
    out = []
    for x, y in zip(state, sub):
        x = x.clone()
        x[slots] = y
        out.append(x)
    return tuple(out)


def bvh_closest(origin, direction, near, far, aabb_links, node_count,
                leaf_tri, tri_v0, tri_e1, tri_e2) -> Hit:
    """Closest-hit skip-link walk of rays [R,3] over the flattened BVH
    (``aabb_links``: the [8, 8N] table of :func:`build_aabb_links`;
    ``leaf_tri``: the [NB, L] ids of :func:`leaf_table`, whose L lanes a
    step tests)."""
    _no_reverse_mode(origin, direction, near, far, tri_v0, tri_e1, tri_e2)
    t0 = time.perf_counter()
    n_nodes = node_count.shape[0]
    L = leaf_tri.shape[1]
    cols = [c[:, i] for c in (tri_v0, tri_e1, tri_e2) for i in range(3)]
    blocks = _blocks(node_count, leaf_tri, cols)
    n_steps = blocks.table.shape[0]
    ID = 9

    def phase(rays, node, state, stop_count: int):
        o, d, near, far = rays
        r = _Rays(o, d, n_nodes)
        near1 = near[:, None]

        def step(node, state):
            part, best_t, best_id = state
            active = node < n_nodes
            nid = torch.clamp(node, max=n_nodes - 1).long()
            tmin, tmax, first, skip = _slab(aabb_links, r, nid)
            hit_box = (active & (tmax >= near) & (tmin <= tmax)
                       & (tmin <= torch.minimum(far, best_t)))
            is_leaf = first < 0.0
            g2 = blocks.table[(blocks.first[nid] + part).long()]  # [R, 10L]
            ids = g2[:, ID * L:(ID + 1) * L]
            t, bary_ok = _mt_lanes(g2, L, r.o1, r.d1)
            valid = ((hit_box & is_leaf)[:, None] & bary_ok & (ids >= 0.0)
                     & (t > near1) & (t < best_t[:, None]))
            t_cand = torch.where(valid, t, BIG)
            leaf_t = t_cand.amin(1)
            win = t_cand <= leaf_t[:, None]
            leaf_id = torch.where(win & valid, ids, -1.0).amax(1)
            better = leaf_id >= 0.0
            best_t = torch.where(better, leaf_t, best_t)
            best_id = torch.where(better, leaf_id.to(torch.int32), best_id)
            more = hit_box & is_leaf & (part + 1 < blocks.count[nid])
            nxt = torch.where(hit_box & ~is_leaf, first, skip).to(torch.int32)
            node = torch.where(active & ~more, nxt, node)
            part = torch.where(more, part + 1, 0)
            return node, (part, best_t, best_id)

        return _walk(step, node, state, n_nodes, n_steps, stop_count)

    R = origin.shape[0]
    dev = origin.device
    zero = torch.zeros(R, dtype=torch.int32, device=dev)
    _, t, tid = _ladder(phase, n_nodes, (origin, direction, near, far), zero,
                        (zero, torch.clamp(far, max=BIG),
                         torch.full((R,), -1, dtype=torch.int32, device=dev)))
    bvh_closest.seconds += time.perf_counter() - t0
    return Hit(t=t, tri_id=tid)


bvh_closest.seconds = 0.0


def _lane_product(f):
    """Product over the last axis as a fixed pairwise tree (an odd last
    lane carried to the next level), the same order on every device."""
    while f.shape[-1] > 1:
        h = f.shape[-1] // 2
        g = f[..., :h] * f[..., h:2 * h]
        f = torch.cat([g, f[..., 2 * h:]], -1) if f.shape[-1] % 2 else g
    return f[..., 0]


def bvh_shadow(origin, direction, dist, aabb_links, node_count, leaf_tri,
               tri_v0, tri_e1, tri_e2, tri_opacity_rgb, tri_opacity_a):
    """Transmission-accumulating shadow walk (reference cuda_bvh.cuh:172-232).
    Returns (mask_rgb [R,3], mask_a [R]); a ray finishes once its alpha is
    below 1e-4 (the reference's early out, cuda_instance.cuh:110). The
    per-triangle opacity rides in the leaf block as four more field
    groups."""
    _no_reverse_mode(origin, direction, dist, tri_v0, tri_e1, tri_e2,
                     tri_opacity_rgb, tri_opacity_a)
    t0 = time.perf_counter()
    n_nodes = node_count.shape[0]
    L = leaf_tri.shape[1]
    cols = [c[:, i] for c in (tri_v0, tri_e1, tri_e2, tri_opacity_rgb)
            for i in range(3)] + [tri_opacity_a]
    blocks = _blocks(node_count, leaf_tri, cols)
    n_steps = blocks.table.shape[0]
    OPR, ID = 9, 13

    def phase(rays, node, state, stop_count: int):
        o, d, dist = rays
        r = _Rays(o, d, n_nodes)
        dist1 = dist[:, None]
        done = torch.full_like(node, n_nodes)

        def step(node, state):
            part, m = state                                   # m: [R, 4] rgba
            walking = node < n_nodes
            active = walking & (m[:, 3] >= ALPHA_STOP)
            nid = torch.clamp(node, max=n_nodes - 1).long()
            tmin, tmax, first, skip = _slab(aabb_links, r, nid)
            hit_box = active & (tmax >= 0.0) & (tmin <= tmax) & (tmin <= dist)
            is_leaf = first < 0.0
            g2 = blocks.table[(blocks.first[nid] + part).long()]  # [R, 14L]
            ids = g2[:, ID * L:(ID + 1) * L]
            t, bary_ok = _mt_lanes(g2, L, r.o1, r.d1)
            valid = ((hit_box & is_leaf)[:, None] & bary_ok & (ids >= 0.0)
                     & (t > 0.0) & (t < dist1))
            op = g2[:, OPR * L:(OPR + 4) * L].reshape(-1, 4, L)
            m = m * _lane_product(torch.where(valid[:, None, :], op, 1.0))
            live = m[:, 3] >= ALPHA_STOP
            more = hit_box & is_leaf & (part + 1 < blocks.count[nid]) & live
            nxt = torch.where(hit_box & ~is_leaf, first, skip).to(torch.int32)
            nxt = torch.where(live, nxt, done)                # opaque: done
            node = torch.where(walking & ~more, nxt, node)
            part = torch.where(more, part + 1, 0)
            return node, (part, m)

        return _walk(step, node, state, n_nodes, n_steps, stop_count)

    R = origin.shape[0]
    dev = origin.device
    zero = torch.zeros(R, dtype=torch.int32, device=dev)
    _, m = _ladder(phase, n_nodes, (origin, direction, dist), zero,
                   (zero, torch.ones((R, 4), dtype=torch.float32, device=dev)))
    bvh_shadow.seconds += time.perf_counter() - t0
    return m[:, :3].contiguous(), m[:, 3].contiguous()


bvh_shadow.seconds = 0.0
