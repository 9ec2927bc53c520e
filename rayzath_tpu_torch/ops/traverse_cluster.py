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

Each public entry point (``cluster_closest``, ``cluster_shadow``,
``cluster_closest_inst``, ``cluster_shadow_inst``) takes the plain PyTorch
version for a tensor on the CPU and launches the hand-written CUDA kernel
(``csrc/cluster_closest.cu``, ``csrc/cluster_shadow.cu``,
``csrc/cluster_closest_inst.cu``, ``csrc/cluster_shadow_inst.cu``) for a
tensor on a CUDA device; any other device raises. Each counts its kernel
launches in a ``launches`` attribute. The plain versions visit every real
cluster (of every real instance) with no culling; the kernels cull
conservatively, so both return the same hits.

The closest-hit entries return discrete hits and carry no gradient. The
shadow entries are ``torch.autograd.Function``s when an input requires
grad: the forward is the kernel (or the plain version on the CPU), the
backward replays the shadow test densely through ``ops/intersect.py``
``project_shadow``, as the JAX package's custom_vjp rules do.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _kernels
from .bvh import build_bvh, triangle_aabbs
from .intersect import (BIG, DET_EPS, project_shadow, triangle_frames,
                        triangle_frames_torch)

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


def cluster_opacity(op_rgb, op_a, order, base, count,
                    cluster_t: int = CLUSTER_T):
    """[Cp, 4, cluster_t] per-cluster rgba opacity from the live material
    opacity tables (original triangle order), rebuilt on every call so that
    material edits are never stale. Padding slots get 1."""
    ops = torch.cat([op_rgb, op_a[:, None]], dim=1)[order]          # [T,4]
    lanes = torch.arange(cluster_t, device=op_rgb.device)
    idx = base[:, None].long() + lanes[None, :]                      # [C,ct]
    valid = lanes[None, :] < count[:, None]
    idx = torch.clamp(idx, 0, max(ops.shape[0] - 1, 0))
    vals = torch.where(valid[:, :, None], ops[idx],
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
    mc = mat_color[inst_slot_map.long()]                             # [I,64,4]
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


def cluster_shadow_plain(origin, direction, dist, box_tab, frames, op_tab):
    """Product of the rgba opacity of every hit with t in (0, dist), over
    every real cluster. Returns (rgb [R,3], a [R])."""
    r = origin.shape[0]
    m = torch.ones((r, 4), dtype=torch.float32, device=origin.device)
    for c, _ in _real_clusters(box_tab):
        t, b1, b2 = _project(origin, direction, box_tab, frames, c)
        valid = _inside(b1, b2) & (t > 0.0) & (t < dist[:, None])   # [R,ct]
        fac = torch.where(valid[:, None, :], op_tab[c][None], 1.0)  # [R,4,ct]
        m = m * fac.prod(dim=2)
    return m[:, 0:3].contiguous(), m[:, 3].contiguous()


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

def _check(dev, **tensors):
    """Raise unless every tensor is a contiguous float32/int32 tensor on the
    CUDA device ``dev``."""
    for name, (x, dtype) in tensors.items():
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device {dev}, "
                             f"got {x.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_shapes(extra):
    for name, x, shape in extra:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")


def _check_tables(box_tab, frames, extra=()):
    cp = box_tab.shape[1]
    if box_tab.shape != (8, cp) or frames.shape != (cp, 4, 3 * CLUSTER_T):
        raise ValueError(f"cluster tables disagree: box_tab {tuple(box_tab.shape)}"
                         f", frames {tuple(frames.shape)}")
    _check_shapes(extra)
    return cp


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _launch(name, fn, dev, *args):
    """Call the library function ``fn(*args, stream)`` on CUDA device
    ``dev`` and that device's current stream, whatever device is current in
    the calling thread; raise when it reports an error."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_kernels.error_string(err)}")


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


def _ranked_smem(lib, dev, rows: int, kernel: int) -> int:
    """Dynamic shared memory of a launch of kernel B``kernel`` (1-4) over
    ``rows`` table rows (B1's and B2's clusters, B3's and B4's instances),
    as the kernel asks for it; raises when the device cannot give it."""
    need = lib.rz_ranked_smem(rows, kernel)
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
    _check(dev, visits=(visits, torch.int32))
    _check_shapes([("visits", visits, (r + -(-r // KERNEL_BLOCK),))])
    return _ptr(visits)


def _map_ids(rid, order):
    """Cluster-order ids -> original soup ids (-1 stays -1)."""
    safe = torch.clamp(rid, 0, order.shape[0] - 1).long()
    return torch.where(rid >= 0, order[safe].to(torch.int32),
                       torch.full_like(rid, -1))


def cluster_closest(origin, direction, near, far, box_tab, frames, order, *,
                    visits=None):
    """Closest hit. Returns (t [R], tri_id [R] i32 in ORIGINAL order,
    -1 = miss). CPU tensors take :func:`cluster_closest_plain`; CUDA
    tensors launch the B1 kernel (``csrc/cluster_closest.cu``), a ranked
    front-to-back walk per block of 128 rays (a block with a ray of
    near < 0 walks in table order instead). ``visits`` (CUDA only, off
    the render path): an int32 tensor of R + ceil(R / 128) entries that
    receives each ray's cluster tests, then each block's staged
    clusters."""
    if origin.device.type == "cpu":
        t, rid = cluster_closest_plain(origin, direction, near, far, box_tab,
                                       frames)
        return t, _map_ids(rid, order)
    lib = _kernels.load()
    dev = origin.device
    r = origin.shape[0]
    _check(dev, origin=(origin, torch.float32), direction=(direction, torch.float32),
           near=(near, torch.float32), far=(far, torch.float32),
           box_tab=(box_tab, torch.float32), frames=(frames, torch.float32))
    cp = _check_tables(box_tab, frames, (
        ("origin", origin, (r, 3)), ("direction", direction, (r, 3)),
        ("near", near, (r,)), ("far", far, (r,))))
    _aligned(frames=frames)
    _ranked_smem(lib, dev, cp, kernel=1)
    counts = _visit_buffer(visits, dev, r)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    rid = torch.empty(r, dtype=torch.int32, device=dev)
    if r:
        _launch("cluster_closest", lib.rz_cluster_closest, dev,
                _ptr(origin), _ptr(direction), _ptr(near), _ptr(far),
                _ptr(box_tab), _ptr(frames), r, cp, _ptr(t), _ptr(rid), counts)
        cluster_closest.launches += 1
    return t, _map_ids(rid, order.to(dev))


cluster_closest.launches = 0


# ---------------------------------------------------------------------------
# backward: dense replay (the JAX package's custom_vjp rules)
# ---------------------------------------------------------------------------

class _ShadowReplay(torch.autograd.Function):
    """Forward: ``run()``, the kernel or its plain version, on ``xs``.
    Backward: the VJP of ``replay(*xs)``, the dense differentiable shadow
    test over the same inputs (path replay: the transmission product does
    not depend on the order of its factors, so the gradient is exact
    wherever the kernel's alpha < 1e-4 stop has not cut the product, and
    beyond it the light term is ~0 either way)."""

    @staticmethod
    def forward(ctx, run, replay, *xs):
        ctx.replay = replay
        ctx.save_for_backward(*xs)
        return run()

    @staticmethod
    def backward(ctx, g_rgb, g_a):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
            outs = [(y, g) for y, g in zip(ctx.replay(*xs), (g_rgb, g_a))
                    if y.requires_grad]
            if not outs:
                # the product is piecewise constant in the rays and the
                # triangles: only the opacities carry a gradient
                return (None,) * (2 + len(need))
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad([y for y, _ in outs], wrt,
                                             [g for _, g in outs],
                                             allow_unused=True))
        return (None, None) + tuple(next(grads) if n else None for n in need)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _soup_replay(origin, direction, dist, tri_v0, tri_e1, tri_e2, op_rgb, op_a):
    """B2's replay (JAX ``_make_cluster_shadow`` bwd): the dense shadow test
    over every soup triangle, frames built differentiably."""
    w, c = triangle_frames_torch(tri_v0, tri_e1, tri_e2)
    return project_shadow(origin, direction, dist, w, c, op_rgb, op_a,
                          chunk=_replay_chunk(origin.shape[0], tri_v0.shape[0]))


def _inst_replay(tri_slot, exp_tri, exp_inst, inst_fwd, inst_slot_map,
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
                          chunk=_replay_chunk(origin.shape[0], tri.shape[0]))


def _replay_chunk(r: int, f: int) -> int:
    """Triangles per checkpointed replay chunk: 512 as in the JAX package,
    fewer for wide wavefronts so that one chunk's [R, chunk] terms stay near
    2^25 elements (128 at 512^2 rays)."""
    return max(1, min(512, f, max(32, 2 ** 25 // max(r, 1))))


def cluster_shadow(origin, direction, dist, box_tab, frames, order, base,
                   count, op_rgb, op_a, *, tris=None, visits=None):
    """Transmission-filtered visibility: (mask_rgb [R,3], mask_a [R]), the
    product of the live material opacity over every hit in (0, dist).
    CPU tensors take :func:`cluster_shadow_plain`; CUDA tensors launch the
    B2 kernel (``csrc/cluster_shadow.cu``), a ranked front-to-back walk per
    block of 128 rays that stops a ray once its alpha is below 1e-4.
    ``visits`` as for :func:`cluster_closest` (CUDA only, off the render
    path).

    Differentiable when grad mode is on and an input requires grad: the
    backward replays the test densely (:func:`_soup_replay`) over ``tris``
    = (tri_v0, tri_e1, tri_e2), the soup triangles in the order of
    ``op_rgb`` / ``op_a``. Only the opacities get a non-zero gradient: the
    product is piecewise constant in the rays and the triangles, which only
    decide which factors enter (as in the JAX package)."""
    if tris is not None and _needs_grad(origin, direction, *tris, op_rgb, op_a):
        return _ShadowReplay.apply(
            lambda: cluster_shadow(origin.detach(), direction.detach(),
                                   dist.detach(), box_tab, frames, order, base,
                                   count, op_rgb.detach(), op_a.detach(),
                                   visits=visits),
            _soup_replay, origin, direction, dist, *tris, op_rgb, op_a)
    if _needs_grad(origin, direction, op_rgb, op_a):
        raise ValueError("cluster_shadow needs tris=(tri_v0, tri_e1, tri_e2) "
                         "to differentiate")
    op_tab = cluster_opacity(op_rgb, op_a, order, base, count)
    if origin.device.type == "cpu":
        return cluster_shadow_plain(origin, direction, dist, box_tab, frames,
                                    op_tab)
    lib = _kernels.load()
    dev = origin.device
    r = origin.shape[0]
    _check(dev, origin=(origin, torch.float32), direction=(direction, torch.float32),
           dist=(dist, torch.float32), box_tab=(box_tab, torch.float32),
           frames=(frames, torch.float32), op_tab=(op_tab, torch.float32))
    cp = _check_tables(box_tab, frames, (
        ("origin", origin, (r, 3)), ("direction", direction, (r, 3)),
        ("dist", dist, (r,)), ("op_tab", op_tab, (box_tab.shape[1], 4, CLUSTER_T))))
    _aligned(frames=frames, op_tab=op_tab)
    _ranked_smem(lib, dev, cp, kernel=2)
    counts = _visit_buffer(visits, dev, r)
    rgb = torch.empty((r, 3), dtype=torch.float32, device=dev)
    a = torch.empty(r, dtype=torch.float32, device=dev)
    if r:
        _launch("cluster_shadow", lib.rz_cluster_shadow, dev,
                _ptr(origin), _ptr(direction), _ptr(dist), _ptr(box_tab),
                _ptr(frames), _ptr(op_tab), r, cp, _ptr(rgb), _ptr(a), counts)
        cluster_shadow.launches += 1
    return rgb, a


cluster_shadow.launches = 0


def _check_inst_tables(ti_rows, cl_obox, frames, extra=()):
    ip, cm = ti_rows.shape[0], cl_obox.shape[0]
    if (ti_rows.shape != (ip, TI_W) or ip % 128 or cl_obox.shape != (cm, 8)
            or frames.shape != (cm, 4, 3 * CLUSTER_T)):
        raise ValueError(f"instance tables disagree: ti_rows "
                         f"{tuple(ti_rows.shape)}, cl_obox {tuple(cl_obox.shape)}"
                         f", frames {tuple(frames.shape)}")
    _check_shapes(extra)
    return ip


def cluster_closest_inst(origin, direction, near, far, ti_rows, cl_obox,
                         frames, *, visits=None):
    """Two-level closest hit. Returns (t [R], tri_id [R] i32 in DEVICE
    order, i.e. the order of ``tri_pack``, and inst_id [R] i32; -1 = miss).
    CPU tensors take :func:`cluster_closest_inst_plain`; CUDA tensors launch
    the B3 kernel (``csrc/cluster_closest_inst.cu``), a ranked front-to-back
    walk of the instances and of each visited mesh's clusters per block of
    128 rays (near < 0 as for :func:`cluster_closest`). ``visits`` as for
    :func:`cluster_closest`, counting (instance, cluster) tests."""
    if origin.device.type == "cpu":
        return cluster_closest_inst_plain(origin, direction, near, far,
                                          ti_rows, cl_obox, frames)
    lib = _kernels.load()
    dev = origin.device
    r = origin.shape[0]
    _check(dev, origin=(origin, torch.float32), direction=(direction, torch.float32),
           near=(near, torch.float32), far=(far, torch.float32),
           ti_rows=(ti_rows, torch.float32), cl_obox=(cl_obox, torch.float32),
           frames=(frames, torch.float32))
    ip = _check_inst_tables(ti_rows, cl_obox, frames, (
        ("origin", origin, (r, 3)), ("direction", direction, (r, 3)),
        ("near", near, (r,)), ("far", far, (r,))))
    _aligned(frames=frames)
    _ranked_smem(lib, dev, ip, kernel=3)
    counts = _visit_buffer(visits, dev, r)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    tid = torch.empty(r, dtype=torch.int32, device=dev)
    inst = torch.empty(r, dtype=torch.int32, device=dev)
    if r:
        _launch("cluster_closest_inst", lib.rz_cluster_closest_inst, dev,
                _ptr(origin), _ptr(direction), _ptr(near), _ptr(far),
                _ptr(ti_rows), _ptr(cl_obox), _ptr(frames), r, ip, _ptr(t),
                _ptr(tid), _ptr(inst), counts)
        cluster_closest_inst.launches += 1
    return t, tid, inst


cluster_closest_inst.launches = 0


def cluster_shadow_inst(origin, direction, dist, ti_rows, cl_obox, frames,
                        cl_slot, inst_slot_map, mat_color, *, tris=None,
                        expanded=None, visits=None):
    """Two-level transmission-filtered visibility: (mask_rgb [R,3],
    mask_a [R]), the product of the live material opacity, resolved through
    each instance's slot table (:func:`instance_opacity`), over every hit in
    (0, dist). CPU tensors take :func:`cluster_shadow_inst_plain`; CUDA
    tensors launch the B4 kernel (``csrc/cluster_shadow_inst.cu``), a
    ranked front-to-back walk of the instances and of each visited mesh's
    clusters per block of 128 rays that stops a ray once its alpha is below
    1e-4. ``visits`` as for :func:`cluster_closest_inst` (CUDA only, off
    the render path).

    Differentiable when grad mode is on and an input requires grad: the
    backward replays the test densely over the expanded (instance,
    triangle) set (:func:`_inst_replay`), from ``tris`` = (tri_v0, tri_e1,
    tri_e2) in object space and device order and ``expanded`` = (tri_slot,
    exp_tri, exp_inst, inst_fwd); as for :func:`cluster_shadow`, only
    ``mat_color`` gets a non-zero gradient."""
    if tris is not None and _needs_grad(origin, direction, *tris, mat_color):
        if expanded is None:
            raise ValueError("cluster_shadow_inst needs expanded=(tri_slot, "
                             "exp_tri, exp_inst, inst_fwd) to differentiate; "
                             "compile the world with differentiable=True")
        replay = functools.partial(_inst_replay, *expanded, inst_slot_map)
        return _ShadowReplay.apply(
            lambda: cluster_shadow_inst(origin.detach(), direction.detach(),
                                        dist.detach(), ti_rows, cl_obox,
                                        frames, cl_slot, inst_slot_map,
                                        mat_color.detach(), visits=visits),
            replay, origin, direction, dist, *tris, mat_color)
    if _needs_grad(origin, direction, mat_color):
        raise ValueError("cluster_shadow_inst needs tris= and expanded= to "
                         "differentiate")
    op_tab = instance_opacity(mat_color, inst_slot_map)
    if origin.device.type == "cpu":
        return cluster_shadow_inst_plain(origin, direction, dist, ti_rows,
                                         cl_obox, frames, cl_slot, op_tab)
    lib = _kernels.load()
    dev = origin.device
    r = origin.shape[0]
    _check(dev, origin=(origin, torch.float32), direction=(direction, torch.float32),
           dist=(dist, torch.float32), ti_rows=(ti_rows, torch.float32),
           cl_obox=(cl_obox, torch.float32), frames=(frames, torch.float32),
           cl_slot=(cl_slot, torch.float32), op_tab=(op_tab, torch.float32))
    ip = _check_inst_tables(ti_rows, cl_obox, frames, (
        ("origin", origin, (r, 3)), ("direction", direction, (r, 3)),
        ("dist", dist, (r,)), ("cl_slot", cl_slot, (cl_obox.shape[0], CLUSTER_T)),
        ("op_tab", op_tab, (op_tab.shape[0], 4, SLOTS))))
    _aligned(frames=frames, cl_slot=cl_slot, op_tab=op_tab)
    _ranked_smem(lib, dev, ip, kernel=4)
    counts = _visit_buffer(visits, dev, r)
    rgb = torch.empty((r, 3), dtype=torch.float32, device=dev)
    a = torch.empty(r, dtype=torch.float32, device=dev)
    if r:
        _launch("cluster_shadow_inst", lib.rz_cluster_shadow_inst, dev,
                _ptr(origin), _ptr(direction), _ptr(dist), _ptr(ti_rows),
                _ptr(cl_obox), _ptr(frames), _ptr(cl_slot), _ptr(op_tab), r, ip,
                _ptr(rgb), _ptr(a), counts)
        cluster_shadow_inst.launches += 1
    return rgb, a


cluster_shadow_inst.launches = 0
