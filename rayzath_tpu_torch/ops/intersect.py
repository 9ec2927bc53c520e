"""Per-ray Moller-Trumbore refine, projection frames and the dense
closest-hit and shadow tests.

Counterpart of ``rayzath_tpu/ops/intersect.py``: its projection path,
which the JAX renderer runs (its all-pairs ``brute_force_*`` functions serve
only its tests and tools). Numerical semantics follow the
reference device intersector (RayZath/cuda_render_parts.cuh:1023-1083): the
determinant is nudged by +1e-7 when |det| < 1e-7, and ``external`` (front
face) is det > 0.

``triangle_frames`` is the host (NumPy) precompute of the unit-triangle
projection frames that the cluster tables hold: per triangle
M = inv([e1 e2 n]) (n = e1 x e2) and c = -M v0, so that a world point p maps
to M p + c, whose (x, y) are the barycentrics (b1, b2) and whose z vanishes
on the triangle plane. ``triangle_frames_torch`` builds the same frames
differentiably. ``project_closest`` and ``project_shadow`` run the dense
tests on them: the integrator's dense path (``brute_force_threshold``, and
every empty world), and the replay the B2/B4 backwards
(ops/traverse_cluster.py) and the texture cutout pass (engine/integrator.py)
project through.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint

from .vec import cross, dot, prod

DET_EPS = 1e-7
BIG = 3.402823466e38


def triangle_frames(v0: np.ndarray, e1, e2):
    """Host-side precompute of projection frames.

    Returns (w [3, 3F], c [3F]) float32, laid out as the x-rows block, then
    y-rows, then z-rows, so ``o @ w + c`` yields [R, 3F] = [ox | oy | oz].
    Degenerate (padded) triangles get w = 0, c = (-1, -1, 1): b1 = -1 keeps
    them invalid for every ray without producing NaNs.
    """
    f = len(v0)
    if f == 0:
        return np.zeros((3, 0), np.float32), np.zeros(0, np.float32)
    n = np.cross(e1, e2)
    b = np.stack([e1, e2, n], axis=-1)              # [F,3,3] columns
    det = np.linalg.det(b)
    ok = np.abs(det) > 1e-30
    b_safe = np.where(ok[:, None, None], b, np.eye(3, dtype=b.dtype))
    m = np.linalg.inv(b_safe)                       # rows: b1, b2, z
    c = -np.einsum("fij,fj->fi", m, v0)
    m = np.where(ok[:, None, None], m, 0.0)
    c = np.where(ok[:, None], c, np.array([-1.0, -1.0, 1.0]))
    w = np.concatenate([m[:, 0, :], m[:, 1, :], m[:, 2, :]], axis=0).T  # [3,3F]
    cc = np.concatenate([c[:, 0], c[:, 1], c[:, 2]], axis=0)            # [3F]
    return w.astype(np.float32), cc.astype(np.float32)


def triangle_frames_torch(v0, e1, e2):
    """Differentiable twin of :func:`triangle_frames` on [F,3] tensors (the
    JAX package's ``_frames_jnp``): the frames the shadow backwards replay
    through. The 3x3 inverse is written out by cofactors, elementwise in
    IEEE float32 (no matrix unit, no TF32). Degenerate rows get the
    never-hit frame; ``det`` only selects them and carries no gradient."""
    n = cross(e1, e2)
    # columns e1, e2, n: rows of the inverse are (c2 x c3, c3 x c1, c1 x c2) / det
    r0, r1, r2 = cross(e2, n), cross(n, e1), cross(e1, e2)
    det = dot(e1, r0)
    ok = (det.detach().abs() > 1e-30)[:, None]
    one = torch.ones((), dtype=v0.dtype, device=v0.device)
    inv_det = 1.0 / torch.where(ok[:, 0], det, one)
    zero = torch.zeros((), dtype=v0.dtype, device=v0.device)
    m = [torch.where(ok, r * inv_det[:, None], zero) for r in (r0, r1, r2)]
    fill = (-1.0, -1.0, 1.0)
    c = [torch.where(ok[:, 0], -dot(mi, v0), torch.full_like(det, f))
         for mi, f in zip(m, fill)]
    w = torch.cat([m[0], m[1], m[2]], dim=0).t()                # [3, 3F]
    return w, torch.cat(c, dim=0)                               # [3F]


def _project_terms(origin, direction, w, c):
    """Projection of rays [R,3] onto triangle frames (w [3, 3F], c [3F]),
    written out elementwise in IEEE float32 (the JAX package uses
    precision=HIGHEST matmuls). Returns (t, b1, b2, dz), each [R, F]."""
    f = w.shape[1] // 3
    ol = (origin[:, 0:1] * w[0] + origin[:, 1:2] * w[1]
          + origin[:, 2:3] * w[2] + c)
    dl = direction[:, 0:1] * w[0] + direction[:, 1:2] * w[1] + direction[:, 2:3] * w[2]
    ox, oy, oz = ol[:, :f], ol[:, f:2 * f], ol[:, 2 * f:]
    dx, dy, dz = dl[:, :f], dl[:, f:2 * f], dl[:, 2 * f:]
    dz = dz + (dz.abs() < DET_EPS).to(dz.dtype) * DET_EPS
    t = -oz / dz
    return t, ox + t * dx, oy + t * dy, dz


def project_closest(origin, direction, near, far, tri_w, tri_c,
                    chunk: int = 512):
    """Dense closest hit of rays [R,3] against every triangle frame (the JAX
    package's ``project_closest``). Per chunk of triangles: the valid hits
    with t in (near, best t so far), their smallest t and its first index
    on ties, taken only where strictly nearer than the running best; the
    last chunk is ragged where the JAX package pads it with never-hit
    frames (the same answers). Returns (t [R], tri_id [R] i32, -1 = miss);
    discrete, so it records no gradient (``refine_tri`` re-derives a hit's
    t)."""
    f = tri_w.shape[1] // 3
    w3 = tri_w.reshape(3, 3, f)
    c3 = tri_c.reshape(3, f)
    best_t = torch.clamp(far, max=BIG)
    best_id = torch.full((origin.shape[0],), -1, dtype=torch.int32,
                         device=origin.device)
    with torch.no_grad():
        for i0 in range(0, f, chunk):
            sl = slice(i0, min(i0 + chunk, f))
            t, b1, b2, _ = _project_terms(origin, direction,
                                          w3[:, :, sl].reshape(3, -1),
                                          c3[:, sl].reshape(-1))
            valid = ((b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
                     & (t > near[:, None]) & (t < best_t[:, None]))
            tk, k = torch.where(valid, t, BIG).min(dim=1)
            upd = tk < best_t
            best_id = torch.where(upd, (k + i0).to(torch.int32), best_id)
            best_t = torch.where(upd, tk, best_t)
    return best_t, best_id


def _shadow_block(origin, direction, dist, w, c, op):
    """Product over one chunk of triangles of the rgba opacity ``op``
    [chunk, 4] of every hit with t in (0, dist). Returns [R, 4]."""
    t, b1, b2, _ = _project_terms(origin, direction, w, c)
    valid = ((b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
             & (t > 0.0) & (t < dist[:, None]))                  # [R, chunk]
    return prod(torch.where(valid[:, :, None], op[None], 1.0), 1)


def project_shadow(origin, direction, dist, tri_w, tri_c, op_rgb, op_a,
                   chunk: int = 512):
    """Dense transmission-filtered shadow test through projection frames
    (reference anyIntersection, cuda_instance.cuh:92-164): the product of
    the opacity color over every intersection in (0, dist), over every
    triangle. Returns (rgb [R,3], a [R]).

    This is the replay the shadow backwards run through. Under autograd each
    chunk is one ``torch.utils.checkpoint``, so the backward recomputes one
    chunk's [R, chunk] terms at a time; the running product across chunks is
    plain multiplication, whose backward needs no division (opaque factors
    are exactly 0)."""
    f = tri_w.shape[1] // 3
    w3 = tri_w.reshape(3, 3, f)
    c3 = tri_c.reshape(3, f)
    op = torch.cat([op_rgb, op_a[:, None]], dim=1)
    m = torch.ones((origin.shape[0], 4), dtype=origin.dtype, device=origin.device)
    grad = torch.is_grad_enabled()
    for i0 in range(0, f, chunk):
        sl = slice(i0, min(i0 + chunk, f))
        args = (origin, direction, dist, w3[:, :, sl].reshape(3, -1),
                c3[:, sl].reshape(-1), op[sl])
        if grad:
            blk = torch.utils.checkpoint.checkpoint(
                _shadow_block, *args, use_reentrant=False,
                preserve_rng_state=False)         # it draws no torch numbers
        else:
            blk = _shadow_block(*args)
        m = m * blk
    return m[:, :3], m[:, 3]


def refine_tri(origin, direction, v0, e1, e2):
    """Per-ray explicit Moller-Trumbore refine: one triangle per ray, all
    [R,3]. Returns (t, b1, b2, det)."""
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    det = det + (det.abs() < DET_EPS).to(det.dtype) * DET_EPS
    inv_det = 1.0 / det
    tvec = origin - v0
    b1 = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    b2 = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    return t, b1, b2, det
