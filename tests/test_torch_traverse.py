"""The modules that hold a kernel: cluster closest hit (B1) and cluster
shadow (B2), port against the JAX package.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as its own suite does.
Rules, following tests/test_cluster_traversal.py and the f64 pin of
tests/test_oracle_parity.py:

* hit ids are equal except on rays an f64 Moller-Trumbore classifies as
  chaotic (winner near a barycentric edge, a near-tie, a near-miss close to
  the winning t, or a candidate within rounding of the near/far window);
* t agrees to rtol 1e-5 on hits with the f64 t and the JAX t, except on
  grazing hits (incidence cos < 0.01), where float32 rounding in t grows
  as 1/cos and the bound against f64 is scaled by 0.01/cos;
* rgba agrees to rtol 1e-5 where alpha >= 1e-4 (the JAX kernel may stop a
  ray below that, the plain version takes the full product).

The CUDA kernels themselves are compared with the plain versions in
tests/test_torch_gpu.py, which needs a card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from rayzath_tpu.ops import traverse_cluster as jtc  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import _kernels  # noqa: E402
from rayzath_tpu_torch.ops import traverse_cluster as ttc  # noqa: E402
from rayzath_tpu_torch.ops.sort_rays import sort_payload, unsort_payload  # noqa: E402
from rayzath_tpu_torch.utils.parity import closest_f64, mt_f64  # noqa: E402


def make_soup(n, seed=0, spread=4.0, size=0.35):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-size, size, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-size, size, (n, 3)).astype(np.float32)
    return v0, e1, e2


def make_rays(r, seed=1, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def aimed_rays(v0, e1, e2, r, seed):
    """Random origins; every other ray aimed at a random point of a random
    triangle, so small soups still get many hits (and many edge cases)."""
    o, d = make_rays(r, seed)
    rng = np.random.default_rng(seed + 100)
    k = rng.integers(0, len(v0), r // 2)
    b = rng.uniform(0.0, 0.6, (r // 2, 2)).astype(np.float32)
    p = v0[k] + b[:, :1] * e1[k] + b[:, 1:] * e2[k]
    a = p - o[: r // 2]
    d[: r // 2] = a / np.linalg.norm(a, axis=1, keepdims=True)
    return o, d


def _t(*xs):
    return [torch.as_tensor(np.ascontiguousarray(x)) for x in xs]


def closest_both(v0, e1, e2, o, d, near, far):
    box, frames, order, base, count = ttc.build_cluster_tables(v0, e1, e2)
    t, tid = ttc.cluster_closest(*_t(o, d, near, far, box, frames, order))
    n_real = int((count > 0).sum())
    tj, tidj = jtc.cluster_closest(*map(jnp.asarray, (o, d, near, far, box,
                                                      frames, order)),
                                   n_real=n_real)
    return t.numpy(), tid.numpy(), np.asarray(tj), np.asarray(tidj)


def assert_closest_parity(v0, e1, e2, o, d, near, far):
    t, tid, tj, tidj = closest_both(v0, e1, e2, o, d, near, far)
    ref, chaotic = closest_f64(o, d, v0, e1, e2, near, far)
    safe = ~chaotic
    assert safe.mean() > 0.97, f"chaotic fraction {1 - safe.mean()}"
    assert np.array_equal(tid[safe], tidj[safe])
    assert np.array_equal(tid[safe], ref[safe])
    hit = np.nonzero(safe & (tid >= 0))[0]
    # t = o'_z / -d'_z with d'_z ~ cos of the incidence angle, so float32
    # rounding in t grows as 1/cos on grazing hits: rtol 1e-5 against both
    # the f64 t and the JAX t where cos >= 0.01, and against the f64 t with
    # the tolerance scaled by 0.01/cos below that
    t64 = mt_f64(o[hit], d[hit], v0[tid[hit]], e1[tid[hit]], e2[tid[hit]])[0]
    t64 = t64[np.arange(len(hit)), np.arange(len(hit))]
    n = np.cross(e1[tid[hit]], e2[tid[hit]])
    cos = np.abs(np.sum(n * d[hit], 1)) / np.linalg.norm(n, axis=1)
    assert (np.abs(t[hit] - t64) <= 1e-5 * t64 * np.maximum(1.0, 0.01 / cos)).all()
    steep = hit[cos >= 0.01]
    np.testing.assert_allclose(t[steep], tj[steep], rtol=1e-5)
    return tid


@pytest.mark.parametrize("n_tri", [40, 700])
def test_closest_matches_jax(n_tri):
    v0, e1, e2 = make_soup(n_tri)
    o, d = aimed_rays(v0, e1, e2, 512, seed=1)
    tid = assert_closest_parity(v0, e1, e2, o, d, np.zeros(512, np.float32),
                                np.full(512, 1e30, np.float32))
    assert (tid >= 0).sum() > 20


def test_closest_near_far_window():
    v0, e1, e2 = make_soup(300, seed=3)
    o, d = make_rays(256, seed=4)
    rng = np.random.default_rng(5)
    near = rng.uniform(0.0, 2.0, 256).astype(np.float32)
    far = rng.uniform(3.0, 9.0, 256).astype(np.float32)
    assert_closest_parity(v0, e1, e2, o, d, near, far)


def test_closest_empty_hit_set():
    """Rays that point away from every triangle (and rays with far <= 0,
    which the port treats as invalid) return -1."""
    v0, e1, e2 = make_soup(200, seed=6, spread=1.0)
    r = 128
    rng = np.random.default_rng(7)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (r, 1))
    o = np.concatenate([rng.uniform(-1, 1, (r, 2)),
                        np.full((r, 1), 5.0)], 1).astype(np.float32)
    near = np.zeros(r, np.float32)
    far = np.full(r, 1e30, np.float32)
    t, tid, tj, tidj = closest_both(v0, e1, e2, o, d, near, far)
    assert (tid == -1).all() and (tidj == -1).all()
    box, frames, order, _, _ = ttc.build_cluster_tables(v0, e1, e2)
    o2 = o.copy()
    o2[:, 2] = -5.0                    # now every ray would hit something ...
    t2, tid2 = ttc.cluster_closest(*_t(o2, d, near, np.zeros(r, np.float32),
                                       box, frames, order))
    assert (tid2.numpy() == -1).all()  # ... but far = 0 makes it invalid
    assert (t2.numpy() == -1.0).all()


def test_single_cluster_scene():
    v0 = np.array([[0.0, 0.0, 2.0]], np.float32)
    e1 = np.array([[1.0, 0.0, 0.0]], np.float32)
    e2 = np.array([[0.0, 1.0, 0.0]], np.float32)
    o = np.asarray([[0.2, 0.2, 0.0], [5.0, 5.0, 0.0]], np.float32)
    d = np.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    t, tid, tj, tidj = closest_both(v0, e1, e2, o, d, np.zeros(2, np.float32),
                                    np.full(2, 100.0, np.float32))
    assert tid.tolist() == tidj.tolist() == [0, -1]
    assert abs(t[0] - 2.0) < 1e-5
    box, frames, order, base, count = ttc.build_cluster_tables(v0, e1, e2)
    rgb, a = ttc.cluster_shadow(*_t(o, d, np.full(2, 9.0, np.float32), box,
                                    frames, order, base, count,
                                    np.full((1, 3), 0.5, np.float32),
                                    np.full(1, 0.25, np.float32)))
    assert np.allclose(a.numpy(), [0.25, 1.0]) and np.allclose(rgb.numpy()[0], 0.5)


@pytest.mark.parametrize("n_tri", [40, 700])
def test_shadow_matches_jax(n_tri):
    v0, e1, e2 = make_soup(n_tri, seed=7)
    box, frames, order, base, count = ttc.build_cluster_tables(v0, e1, e2)
    rng = np.random.default_rng(8)
    op_rgb = rng.uniform(0.3, 1.0, (n_tri, 3)).astype(np.float32)
    op_a = rng.uniform(0.4, 1.0, n_tri).astype(np.float32)
    o, d = aimed_rays(v0, e1, e2, 256, seed=9)
    dist = np.full(256, 8.0, np.float32)
    rgb, a = ttc.cluster_shadow(*_t(o, d, dist, box, frames, order, base,
                                    count, op_rgb, op_a))
    rgbj, aj = jtc.cluster_shadow(*map(jnp.asarray, (
        o, d, dist, box, frames, order, base, count, v0, e1, e2, op_rgb, op_a)),
        n_real=int((count > 0).sum()))
    a, rgb, aj, rgbj = a.numpy(), rgb.numpy(), np.asarray(aj), np.asarray(rgbj)
    # rays whose f64 hit set is ambiguous may differ by a whole factor
    _, chaotic = closest_f64(o, d, v0, e1, e2, None, dist)
    live = (a >= 1e-4) & ~chaotic
    assert live.mean() > 0.9 and (a[live] < 1.0).sum() > 10
    np.testing.assert_allclose(a[live], aj[live], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rgb[live], rgbj[live], rtol=1e-5, atol=1e-6)


def test_hit_ids_pinned_teapot():
    """The f64 hit-id pin of test_oracle_parity.py, run against the port's
    closest hit on the teapot_like camera rays at 64^2."""
    w = rt.scenes.teapot_like(64, 64)
    scene = tds.compile_world(w, device="cpu")
    cam = tds.compile_camera(w.cameras[0], device="cpu")
    from rayzath_tpu_torch.ops.camera import pixel_grid as tpix, generate_rays as tgen
    r = 64 * 64
    o, d = tgen(cam, tpix(64, 64), torch.full((r, 4), 0.5))
    t, tid = ttc.cluster_closest(o, d, torch.zeros(r), torch.full((r,), 1e30),
                                 scene.cl_box, scene.cl_lw, scene.cl_order)
    n = scene.n_triangles
    ref, chaotic = closest_f64(o.numpy(), d.numpy(), scene.tri_v0[:n].numpy(),
                               scene.tri_e1[:n].numpy(), scene.tri_e2[:n].numpy())
    safe = ~chaotic
    assert safe.mean() > 0.97, f"chaotic fraction too large: {1 - safe.mean()}"
    mism = safe & (tid.numpy() != ref)
    assert not mism.any(), f"{mism.sum()} non-boundary hit-id mismatches"
    assert (tid.numpy() >= 0).mean() > 0.5


def test_sorted_equals_unsorted():
    v0, e1, e2 = make_soup(500, seed=31)
    box, frames, order, base, count = _t(*ttc.build_cluster_tables(v0, e1, e2))
    o, d = _t(*make_rays(2048, seed=32))
    near = torch.zeros(2048)
    far = torch.full((2048,), 1e30)
    t0, tid0 = ttc.cluster_closest(o, d, near, far, box, frames, order)
    o_s, d_s, (n_s, f_s), idx = sort_payload(o, d, (near, far))
    t1, tid1 = unsort_payload(idx, ttc.cluster_closest(o_s, d_s, n_s, f_s,
                                                       box, frames, order))
    assert torch.equal(tid0, tid1) and torch.equal(t0, t1)


def test_cpu_wrappers_launch_nothing():
    before = (ttc.cluster_closest.launches, ttc.cluster_shadow.launches)
    test_single_cluster_scene()
    assert (ttc.cluster_closest.launches, ttc.cluster_shadow.launches) == before


def _meta_args():
    v0, e1, e2 = make_soup(40)
    box, frames, order, base, count = ttc.build_cluster_tables(v0, e1, e2)
    m = lambda x: torch.as_tensor(x).to("meta")  # noqa: E731
    r = 8
    rays = (m(np.zeros((r, 3), np.float32)), m(np.ones((r, 3), np.float32)))
    closest = rays + (m(np.zeros(r, np.float32)), m(np.ones(r, np.float32)),
                      m(box), m(frames), m(order))
    shadow = rays + (m(np.ones(r, np.float32)), m(box), m(frames), m(order),
                     m(base), m(count), m(np.ones((40, 3), np.float32)),
                     m(np.ones(40, np.float32)))
    return closest, shadow


@pytest.mark.parametrize("loader", ["real", "raises", "fake_library"])
def test_non_cpu_tensor_never_falls_back(monkeypatch, loader):
    """A tensor off the CPU launches the kernel or raises: the plain
    versions are never taken for it."""
    def boom(*a, **k):
        raise AssertionError("plain version taken for a non-CPU tensor")
    monkeypatch.setattr(ttc, "cluster_closest_plain", boom)
    monkeypatch.setattr(ttc, "cluster_shadow_plain", boom)
    if loader == "raises":
        def no_build():
            raise RuntimeError("nvcc not found")
        monkeypatch.setattr(_kernels, "load", no_build)
        err = RuntimeError
    elif loader == "fake_library":
        class Lib:
            def __getattr__(self, name):
                raise AssertionError("kernel launched with non-CUDA pointers")
        monkeypatch.setattr(_kernels, "load", lambda: Lib())
        err = ValueError                   # meta tensors fail the device check
    else:
        err = RuntimeError                 # no CUDA device / no nvcc here
        if torch.cuda.is_available():
            err = ValueError
    closest, shadow = _meta_args()
    with pytest.raises(err):
        ttc.cluster_closest(*closest)
    with pytest.raises(err):
        ttc.cluster_shadow(*shadow)
