"""Temporal reprojection (``ops/reproject.py``, ROADMAP A13) against the JAX
package's, mirroring tests/test_reproject.py (identity, teleport, renderer
move, scene change cancels) plus focus-then-render.

Rules: primary-hit depth and points to rtol 1e-5 of the JAX package's on
every ray an f64 Moller-Trumbore does not call chaotic (the same hit ids; t
re-derived by ``refine_tri`` in both); ``reproject_accum``
on the same inputs equal to JAX's on every pixel to rtol 1e-6 (the pixel
decision is a truncation and a 1% depth test, which one float32 ulp moves
only on an exact pixel border); renders through both ``Renderer``s with
the same seed and no injected uniforms by ``assert_images_match`` (sample
counts equal; radiance tol 2e-3, frac 0.995).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu.models import device_scene as jds  # noqa: E402
from rayzath_tpu.ops import reproject as jrep  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import reproject as trep  # noqa: E402
from rayzath_tpu_torch.utils.parity import closest_f64  # noqa: E402

from test_oracle_parity import assert_images_match  # noqa: E402

RES = 32


def hits_both(move=None):
    """(JAX (depth, space), port (depth, space)) of cornell_box at RES^2,
    the camera moved by ``move`` first."""
    out = []
    for pkg, ds in ((rz, jds), (rt, tds)):
        w = pkg.scenes.cornell_box(RES, RES)
        cam = w.cameras[0]
        if move is not None:
            cam.position = cam.position + np.asarray(move, np.float32)
            cam.touch()
        kw = {} if pkg is rz else dict(device="cpu")
        scene = ds.compile_world(w, **kw)
        dcam = ds.compile_camera(cam, **kw)
        mod = jrep if pkg is rz else trep
        depth, space = mod.primary_hits(scene, dcam, pkg.RenderConfig())
        out.append((np.asarray(depth), np.asarray(space)))
    return out


def port_camera(move=None):
    w = rt.scenes.cornell_box(RES, RES)
    cam = w.cameras[0]
    if move is not None:
        cam.position = cam.position + np.asarray(move, np.float32)
        cam.touch()
    return tds.compile_camera(cam, device="cpu"), cam


def chaotic_pixels():
    """[RES, RES] mask of the centre rays whose hit float32 may decide
    either way (the f64 rule of ``utils/parity.py``: cracks between the
    box's triangles, near-ties)."""
    from rayzath_tpu_torch.ops import camera as cam_ops
    w = rt.scenes.cornell_box(RES, RES)
    scene = tds.compile_world(w, device="cpu")
    dcam = tds.compile_camera(w.cameras[0], device="cpu")
    o, d = cam_ops.simple_ray(dcam, cam_ops.pixel_grid(RES, RES))
    n = scene.n_triangles
    _, chaotic = closest_f64(o.numpy(), d.numpy(), scene.tri_v0[:n].numpy(),
                             scene.tri_e1[:n].numpy(), scene.tri_e2[:n].numpy())
    return chaotic.reshape(RES, RES)


def test_identity_reprojection_blends_everything():
    (jd, js), (td, tsp) = hits_both()
    safe = ~chaotic_pixels()
    assert safe.mean() > 0.95          # the box diagonals cross pixel centres
    np.testing.assert_allclose(td[safe], jd[safe], rtol=1e-5)
    np.testing.assert_allclose(tsp[safe], js[safe], rtol=1e-5, atol=1e-5)
    dcam, _ = port_camera()
    prev = torch.arange(RES * RES * 4, dtype=torch.float32).reshape(RES, RES, 4)
    seeded = trep.reproject_accum(torch.as_tensor(tsp), dcam, prev,
                                  torch.as_tensor(td), 0.75)
    np.testing.assert_allclose(seeded.numpy(), prev.numpy() * 0.75, rtol=1e-5)


def test_teleport_reprojects_nothing():
    (_, _), (td, tsp) = hits_both()
    far_cam, cam = port_camera()
    cam.position = np.asarray([500.0, 500.0, 500.0], np.float32)
    cam.touch()
    far_cam = tds.compile_camera(cam, device="cpu")
    seeded = trep.reproject_accum(torch.as_tensor(tsp), far_cam,
                                  torch.ones(RES, RES, 4), torch.as_tensor(td),
                                  0.75)
    assert float(seeded.abs().max()) == 0.0


def test_reproject_accum_matches_jax():
    """The same inputs through both packages' reproject_accum: points under
    a moved camera, the first camera's depth and a numpy accumulation."""
    (jd0, _), _ = hits_both()
    jd0 = np.array(jd0)
    (_, js1), _ = hits_both(move=(0.05, 0.02, 0.0))
    prev = np.random.default_rng(3).uniform(0, 5, (RES, RES, 4)).astype(np.float32)
    js1 = np.array(js1)
    wj = rz.scenes.cornell_box(RES, RES)
    jcam = jds.compile_camera(wj.cameras[0])
    ref = np.asarray(jrep.reproject_accum(jnp.asarray(js1), jcam,
                                          jnp.asarray(prev), jnp.asarray(jd0),
                                          0.75))
    tcam, _ = port_camera()
    got = trep.reproject_accum(torch.as_tensor(js1), tcam, torch.as_tensor(prev),
                               torch.as_tensor(jd0), 0.75).numpy()
    assert (ref[..., 3] > 0).mean() > 0.5          # most pixels reproject
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def renderers(seed=3, depth=3):
    """(JAX renderer, port renderer) of cornell_box_nee at 16^2."""
    cfgs = [pkg.RenderConfig(tracing=pkg.Tracing(max_depth=depth))
            for pkg in (rz, rt)]
    jr = rz.Renderer(rz.scenes.cornell_box_nee(16, 16), cfgs[0], seed=seed)
    tr = rt.Renderer(rt.scenes.cornell_box_nee(16, 16), cfgs[1], seed=seed,
                     device="cpu")
    return jr, tr


def accum(r):
    return np.asarray(r.views[id(r.world.cameras[0])].state.accum)


def test_renderer_reprojects_on_camera_move():
    """A small lateral move seeds ~0.75x the previous samples (reference
    test), the same accumulation as the JAX renderer's; temporal_blend 0
    restarts from nothing."""
    jr, tr = renderers()
    for r in (jr, tr):
        r.render(rpp=4)
    spp_before = float(accum(tr)[..., 3].mean())
    assert spp_before > 0
    for r in (jr, tr):
        cam = r.world.cameras[0]
        cam.position = cam.position + np.asarray([0.02, 0.0, 0.0], np.float32)
        cam.touch()
        r.render(rpp=1)
    view = tr.view(tr.world.cameras[0])
    assert view.pass_count == 1 and view.pending_reprojection is None
    assert float(accum(tr)[..., 3].mean()) > 0.3 * spp_before
    assert "temporal reproject" in tr.debug_info()
    assert_images_match(accum(tr), accum(jr))

    cam = tr.world.cameras[0]
    cam.temporal_blend = 0.0
    cam.position = cam.position + np.asarray([0.02, 0.0, 0.0], np.float32)
    cam.touch()
    tr.render(rpp=1)
    assert float(accum(tr)[..., 3].mean()) <= 1.0 + 1e-6


def test_scene_change_cancels_reprojection():
    w = rt.scenes.cornell_box(32, 32)
    r = rt.Renderer(w, rt.RenderConfig(tracing=rt.Tracing(max_depth=3)),
                    device="cpu")
    r.render(rpp=4)
    cam = w.cameras[0]
    cam.position = cam.position + np.asarray([0.01, 0, 0], np.float32)
    cam.touch()
    w.materials[0].roughness = 0.5
    w.materials[0].touch()
    r.render(rpp=1)
    spp = float(accum(r)[..., 3].mean())
    assert spp <= 1.0 + 1e-6


def test_focus_then_render_reprojects_like_jax():
    """Renderer.focus touches the camera; the next render reprojects, as
    the JAX renderer does, to the same accumulation and focal distance."""
    jr, tr = renderers(seed=8)
    dists = []
    for r in (jr, tr):
        r.render(rpp=3)
        dists.append(r.focus(r.world.cameras[0], 8, 9))
        r.render(rpp=1)
    assert dists[1] == pytest.approx(dists[0], rel=1e-5) and dists[1] > 0
    assert float(accum(tr)[..., 3].sum()) > 16 * 16     # seeded + one pass
    assert_images_match(accum(tr), accum(jr))
