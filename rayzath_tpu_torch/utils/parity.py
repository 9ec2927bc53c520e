"""NumPy references that hold the port's results to the JAX package's rules.

* :func:`mt_f64` / :func:`chaotic_rays`: an f64 Moller-Trumbore closest hit
  and the classification of rays whose hit id float32 may legitimately
  decide either way (the rule of ``tests/test_oracle_parity.py:207-221``:
  the winner near a barycentric edge, a near-tie with the runner-up, or a
  near-miss candidate close to the winning t).
* :func:`expand_instances`: the world-space (instance, triangle) list of a
  two-level scene in f64, the f64 reference's input for the instanced
  kernels.
* :func:`images_match`: the image comparison of
  ``tests/test_oracle_parity.py`` ``assert_images_match``: exact sample
  counts, a bulk of pixels at fp noise, and a bounded outlier fraction.

Used by the tests and by ``chip_smoke.py``; computes in numpy.
"""
from __future__ import annotations

import numpy as np

from ..ops.traverse_cluster import B_BASE, B_CNT, TI_CL0, TI_NCL, TI_ID

EPS_B = 1e-4


def mt_f64(o, d, v0, e1, e2):
    """f64 Moller-Trumbore of rays [R,3] against triangles [T,3]. Returns
    (t, b1, b2, valid), each [R, T]; valid requires t > 0."""
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    pvec = np.cross(d[:, None, :], e2[None])
    det = np.sum(e1[None] * pvec, -1)
    det = det + np.where(np.abs(det) < 1e-300, 1e-300, 0.0)
    inv = 1.0 / det
    tvec = o[:, None, :] - v0[None]
    b1 = np.sum(tvec * pvec, -1) * inv
    qvec = np.cross(tvec, e1[None])
    b2 = np.sum(d[:, None, :] * qvec, -1) * inv
    t = np.sum(e2[None] * qvec, -1) * inv
    valid = (b1 >= 0) & (b1 <= 1) & (b2 >= 0) & (b1 + b2 <= 1) & (t > 0)
    return t, b1, b2, valid


def closest_f64(o, d, v0, e1, e2, near=None, far=None, chunk=256):
    """(tid [R] i32 (-1 = miss), chaotic [R] bool) of the f64 closest hit
    with t in (near, far), in ray chunks of ``chunk`` (memory ~ chunk*T)."""
    r = len(o)
    near = np.zeros(r) if near is None else np.asarray(near, np.float64)
    far = np.full(r, np.inf) if far is None else np.asarray(far, np.float64)
    tid = np.full(r, -1, np.int32)
    chaotic = np.zeros(r, bool)
    for s in range(0, r, chunk):
        sl = slice(s, min(r, s + chunk))
        t, b1, b2, valid = mt_f64(o[sl], d[sl], v0, e1, e2)
        nr, nf = near[sl, None], far[sl, None]
        win = (t > nr) & (t < nf)
        ok = valid & win
        tt = np.where(ok, t, np.inf)
        order = np.argsort(tt, axis=1, kind="stable")
        rows = np.arange(len(tt))
        k1 = order[:, 0]
        t1 = tt[rows, k1]
        t2 = tt[rows, order[:, 1]] if tt.shape[1] > 1 else np.full(len(tt), np.inf)
        hit = np.isfinite(t1)
        tid[sl] = np.where(hit, k1, -1)
        margin = np.minimum.reduce([b1[rows, k1], 1.0 - b1[rows, k1],
                                    b2[rows, k1],
                                    1.0 - b1[rows, k1] - b2[rows, k1]])
        with np.errstate(invalid="ignore"):      # inf - inf on misses
            near_tie = (t2 - t1) < 1e-4 * np.maximum(t1, 1.0)
        near_tie = np.where(hit, near_tie, False)
        t1c = np.where(hit, t1, nf[:, 0])
        band = ((b1 > -EPS_B) & (b1 < 1 + EPS_B) & (b2 > -EPS_B)
                & (b1 + b2 < 1 + EPS_B) & ~ok & (t > 0)
                & (t < t1c[:, None] * (1 + 1e-4) + 1e-6))
        # a candidate within rounding of the (near, far) window ends
        # (an "unbounded" far of 1e30 or more has no end to round against)
        window = (valid & ((np.abs(t - nr) < 1e-4 * np.maximum(np.abs(nr), 1.0))
                           | ((np.abs(t - nf) < 1e-4 * np.maximum(np.abs(nf), 1.0))
                              & (nf < 1e30))))
        chaotic[sl] = ((hit & ((margin < EPS_B) | near_tie))
                       | band.any(1) | window.any(1))
    return tid, chaotic


def expand_instances(ti_rows, cl_obox, inst_fwd, tri_v0, tri_e1, tri_e2):
    """World-space triangles of every (real instance, triangle of its mesh)
    pair, in the instanced walk's order, transformed in f64 by the
    instance's object->world rows. Returns (v0, e1, e2 [K,3] f64, tri [K]
    device-order triangle id, inst [K] global instance index)."""
    rows, obox = np.asarray(ti_rows), np.asarray(cl_obox)
    fwd = np.asarray(inst_fwd, np.float64)
    v0s, e1s, e2s, tris, insts = [], [], [], [], []
    for k in np.nonzero(rows[:, TI_NCL] > 0)[0]:
        cl0, ncl, gid = (int(rows[k, c]) for c in (TI_CL0, TI_NCL, TI_ID))
        tri = np.concatenate([
            np.arange(int(obox[s, B_BASE]), int(obox[s, B_BASE] + obox[s, B_CNT]))
            for s in range(cl0, cl0 + ncl)])
        a = fwd[gid].reshape(3, 4)
        v0s.append(np.asarray(tri_v0, np.float64)[tri] @ a[:, :3].T + a[:, 3])
        e1s.append(np.asarray(tri_e1, np.float64)[tri] @ a[:, :3].T)
        e2s.append(np.asarray(tri_e2, np.float64)[tri] @ a[:, :3].T)
        tris.append(tri)
        insts.append(np.full(len(tri), gid))
    return (np.concatenate(v0s), np.concatenate(e1s), np.concatenate(e2s),
            np.concatenate(tris).astype(np.int32),
            np.concatenate(insts).astype(np.int32))


def images_match(a, b, tol=2e-3, frac=0.995):
    """Raise AssertionError unless accumulations ``a`` and ``b`` [H,W,4]
    match as ``assert_images_match`` requires (same defaults)."""
    assert np.array_equal(a[..., 3], b[..., 3]), "sample counts diverged"
    scale = max(np.abs(b[..., :3]).max(), 1e-6)
    rel = np.abs(a[..., :3] - b[..., :3]) / scale
    assert np.percentile(rel, 75) < 1e-6, "bulk mismatch: not an fp-noise tail"
    close = (rel < tol).mean()
    assert close >= frac, f"only {close:.4f} of pixels within {tol} (scale {scale})"
    return close
