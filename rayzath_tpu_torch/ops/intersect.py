"""Per-ray Moller-Trumbore refine and the host projection-frame build.

Counterpart of the parts of ``rayzath_tpu/ops/intersect.py`` that the soup
render path runs. Numerical semantics follow the reference device
intersector (RayZath/cuda_render_parts.cuh:1023-1083): the determinant is
nudged by +1e-7 when |det| < 1e-7, and ``external`` (front face) is det > 0.

``triangle_frames`` is the host (NumPy) precompute of the unit-triangle
projection frames that the cluster tables hold: per triangle
M = inv([e1 e2 n]) (n = e1 x e2) and c = -M v0, so that a world point p maps
to M p + c, whose (x, y) are the barycentrics (b1, b2) and whose z vanishes
on the triangle plane.
"""
from __future__ import annotations

import numpy as np

from .vec import dot, cross

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
