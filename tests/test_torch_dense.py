"""The dense path (``ops/intersect.py`` ``project_closest``, ROADMAP A4)
against the JAX package's, and the renders that take it: a soup scene under
``brute_force_threshold`` and the empty world, which has no cluster table.

Rules, as in tests/test_torch_traverse.py: hit ids equal JAX's and an f64
Moller-Trumbore's except on rays the f64 reference calls chaotic; t to rtol
1e-5 of the f64 t (scaled by 0.01/cos on grazing hits) and of JAX's where
the incidence cos >= 0.01; exact ties go to the first triangle index in both
packages. Renders from the same seed with no injected uniforms match by
``assert_images_match`` (sample counts equal; radiance tol 2e-3, frac
0.995).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu.models import device_scene as jds  # noqa: E402
from rayzath_tpu.ops import intersect as jint  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine import integrator as tinteg  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import intersect as tint  # noqa: E402
from rayzath_tpu_torch.utils.check_worlds import empty_world  # noqa: E402
from rayzath_tpu_torch.utils.parity import closest_f64, mt_f64  # noqa: E402

from test_oracle_parity import assert_images_match  # noqa: E402
from test_torch_host import assert_scene_equal, jax_leaves  # noqa: E402
from test_torch_traverse import aimed_rays, make_rays, make_soup  # noqa: E402


def closest_both(v0, e1, e2, o, d, near, far, chunk):
    """(port t, port ids, JAX t, JAX ids) of ``project_closest``."""
    w, c = tint.triangle_frames(v0, e1, e2)
    t, tid = tint.project_closest(*(torch.as_tensor(x) for x in (o, d, near,
                                                                 far, w, c)),
                                  chunk=chunk)
    tj, tidj = jint.project_closest(*map(jnp.asarray, (o, d, near, far, w, c)),
                                    chunk=chunk)
    return t.numpy(), tid.numpy(), np.asarray(tj), np.asarray(tidj)


def assert_dense_parity(v0, e1, e2, o, d, near, far, chunk):
    t, tid, tj, tidj = closest_both(v0, e1, e2, o, d, near, far, chunk)
    assert tid.dtype == np.int32
    ref, chaotic = closest_f64(o, d, v0, e1, e2, near, far)
    safe = ~chaotic
    assert safe.mean() > 0.97, f"chaotic fraction {1 - safe.mean()}"
    assert np.array_equal(tid[safe], tidj[safe])
    assert np.array_equal(tid[safe], ref[safe])
    hit = np.nonzero(safe & (tid >= 0))[0]
    t64 = mt_f64(o[hit], d[hit], v0[tid[hit]], e1[tid[hit]], e2[tid[hit]])[0]
    t64 = t64[np.arange(len(hit)), np.arange(len(hit))]
    n = np.cross(e1[tid[hit]], e2[tid[hit]])
    cos = np.abs(np.sum(n * d[hit], 1)) / np.linalg.norm(n, axis=1)
    assert (np.abs(t[hit] - t64) <= 1e-5 * t64 * np.maximum(1.0, 0.01 / cos)).all()
    steep = hit[cos >= 0.01]
    np.testing.assert_allclose(t[steep], tj[steep], rtol=1e-5)
    return tid


@pytest.mark.parametrize("n_tri,chunk", [(40, 512), (700, 512), (700, 96)])
def test_project_closest_matches_jax(n_tri, chunk):
    """One chunk, several, and a ragged last chunk (700 = 7 x 96 + 28)."""
    v0, e1, e2 = make_soup(n_tri)
    o, d = aimed_rays(v0, e1, e2, 512, seed=1)
    tid = assert_dense_parity(v0, e1, e2, o, d, np.zeros(512, np.float32),
                              np.full(512, 1e30, np.float32), chunk)
    assert (tid >= 0).sum() > 20


def test_project_closest_near_far_window():
    v0, e1, e2 = make_soup(300, seed=3)
    o, d = make_rays(256, seed=4)
    rng = np.random.default_rng(5)
    near = rng.uniform(0.0, 2.0, 256).astype(np.float32)
    far = rng.uniform(3.0, 9.0, 256).astype(np.float32)
    assert_dense_parity(v0, e1, e2, o, d, near, far, 128)


@pytest.mark.parametrize("chunk", [4, 512])
def test_project_closest_ties_take_the_first_index(chunk):
    """Three copies of one triangle at ids 1, 5 and 9 (and other triangles
    elsewhere): every ray through it gets id 1 in both packages, within a
    chunk (argmin's first index) and across chunks (strict < against the
    running best)."""
    v0, e1, e2 = make_soup(12, seed=11, spread=20.0)
    for k in (1, 5, 9):
        v0[k], e1[k], e2[k] = (0.0, 0.0, 2.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)
    r = 64
    rng = np.random.default_rng(12)
    o = np.concatenate([rng.uniform(0.05, 0.4, (r, 2)), np.zeros((r, 1))],
                       1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (r, 1))
    t, tid, tj, tidj = closest_both(v0, e1, e2, o, d, np.zeros(r, np.float32),
                                    np.full(r, 1e30, np.float32), chunk)
    assert (tid == 1).all() and (tidj == 1).all()
    assert np.array_equal(t, tj)


def test_project_closest_no_triangles():
    """An empty frame set: every ray misses with t = min(far, BIG)."""
    o, d = make_rays(16, seed=2)
    far = np.full(16, 7.0, np.float32)
    t, tid = tint.project_closest(torch.as_tensor(o), torch.as_tensor(d),
                                  torch.zeros(16), torch.as_tensor(far),
                                  torch.zeros((3, 0)), torch.zeros(0))
    assert (tid.numpy() == -1).all() and (t.numpy() == 7.0).all()


def _render_both(make_world, cfg_kw, res, passes, seed=3):
    out = []
    for pkg in (rz, rt):
        world = make_world(pkg)
        cfg = pkg.RenderConfig(tracing=pkg.Tracing(max_depth=4), **cfg_kw)
        kw = {} if pkg is rz else dict(device="cpu")
        r = pkg.Renderer(world, cfg, seed=seed, **kw)
        r.render(rpp=passes)
        out.append((r, np.asarray(r.views[id(world.cameras[0])].state.accum)))
    return out


@pytest.mark.parametrize("name", ["cornell_box_nee", "cornell_box"])
def test_brute_force_render_matches_jax(name):
    """brute_force_threshold above the triangle count: both packages take
    their dense closest hit and dense shadow; the port's image matches
    JAX's, and its dense closest hit gives the cluster walk's ids on the
    camera rays."""
    (jr, a_jax), (tr, a_port) = _render_both(
        lambda pkg: getattr(pkg.scenes, name)(16, 16),
        dict(brute_force_threshold=64), 16, 3)
    cfg = tr.config
    assert tinteg._dense(cfg, tr.scene)
    assert a_port[..., 3].sum() > 0 and a_port[..., :3].max() > 0
    assert_images_match(a_port, a_jax)

    from rayzath_tpu_torch.ops import camera as cam_ops
    cam = tds.compile_camera(tr.world.cameras[0], device="cpu")
    o, d = cam_ops.generate_rays(cam, cam_ops.pixel_grid(16, 16),
                                 torch.full((256, 4), 0.5))
    near, far = torch.zeros(256), torch.full((256,), 1e30)
    dense = tinteg.closest_hit(tr.scene, cfg, o, d, near, far)
    walk = tinteg.closest_hit(tr.scene, rt.RenderConfig(), o, d, near, far)
    assert torch.equal(dense[1], walk[1]) and int((dense[1] >= 0).sum()) > 100
    torch.testing.assert_close(dense[0], walk[0], rtol=0, atol=0)


def test_empty_world_matches_jax():
    """No geometry: neither package builds a cluster table; every ray
    misses (id -1, t = far) and the sky and direct light render alike."""
    (jr, a_jax), (tr, a_port) = _render_both(
        lambda pkg: empty_world(16, pkg.World), {}, 16, 3)
    assert jr.scene.cl_box is None and tr.scene.cl_box is None
    assert tr.scene.tri_v0.shape == tuple(jr.scene.tri_v0.shape)
    assert tinteg._dense(tr.config, tr.scene)
    assert a_port[..., 3].sum() == 3 * 16 * 16 and a_port[..., :3].max() > 0
    assert_images_match(a_port, a_jax)
    o = torch.zeros((8, 3))
    d = torch.as_tensor(make_rays(8, seed=3)[1])
    far = torch.full((8,), 5.0)
    t, tid, *_ = tinteg.closest_hit(tr.scene, tr.config, o, d, torch.zeros(8), far)
    assert (tid == -1).all() and torch.equal(t, far)


def test_empty_world_compiles_like_jax():
    """The empty world's compiled arrays, port against JAX, array for
    array (the cluster fields None in both), but for the skip-link tables:
    the JAX scene's come from an out-of-bounds write of its native
    ``rz_bvh_skip_links`` on the empty BVH's lone node (ROADMAP C), the
    port's are the JAX two-level scene's placeholders. No path reads them:
    an empty world takes the dense path."""
    import dataclasses
    js = jds.compile_world(empty_world(8, rz.World))
    ts = tds.compile_world(empty_world(8), device="cpu")
    leaves, statics = jax_leaves(js)
    skip = ("aabb_links", "node_begin", "node_count")
    for f in skip:
        assert leaves.pop(f).shape == getattr(ts, f).shape, f
        assert np.array_equal(getattr(ts, f).numpy(), tds._no_skip_links()[f]), f
    assert np.array_equal(ts.leaf_tri.numpy(), tds._no_skip_links()["leaf_tri"])
    assert_scene_equal(dataclasses.replace(ts, **dict.fromkeys(skip + ("leaf_tri",))),
                       leaves, statics)

