"""The slice as a whole: the port's bounce step and Renderer against the JAX
package.

Both packages get the same scene (the JAX ``DeviceScene`` leaves carried
into the port with ``scene_from_arrays``) and the same uniforms (the JAX
``pass_uniforms`` streams, injected through ``bounce_step(..., u=)``), so
every path takes the same branches up to float rounding. The JAX side runs
on the CPU with its Pallas kernels in interpret mode.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu.engine import integrator as jint  # noqa: E402
from rayzath_tpu.engine import state as jstate  # noqa: E402
from rayzath_tpu.models.device_scene import compile_world, compile_camera  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine import integrator as tint  # noqa: E402
from rayzath_tpu_torch.engine import state as tstate  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.utils.parity import closest_f64  # noqa: E402

from test_oracle_parity import assert_images_match  # noqa: E402

RES = 24


def port_scene(scene):
    leaves, statics = {}, {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if v is None:
            continue
        if isinstance(v, (bool, int, tuple)):
            statics[f.name] = v
        else:
            leaves[f.name] = np.asarray(v)
    return tds.scene_from_arrays(leaves, statics, device="cpu")


def run_both(name, n_passes=4, max_depth=4, res=RES, seed=3, on_pass=None):
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=max_depth))
    tcfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=max_depth))
    world = getattr(rz.scenes, name)(res, res)
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])
    tscene = port_scene(scene)
    tcam = tds.compile_camera(getattr(rt.scenes, name)(res, res).cameras[0], device="cpu")
    key = jax.random.key(seed)
    ns = jint.n_streams(cfg, scene)
    assert tint.n_streams(tcfg, tscene) == ns
    js = jstate.init_state(res, res)
    ts = tstate.init_state(res, res, device="cpu")
    for p in range(n_passes):
        k = jax.random.fold_in(key, p)
        u = jint.pass_uniforms(k, 0, res, res, ns)
        if on_pass is not None:
            on_pass(p, scene, cfg, js, tscene, tcfg)
        js = jint.bounce_step(scene, cam, cfg, js, k)
        ts = tint.bounce_step(tscene, tcam, tcfg, ts, u=torch.as_tensor(np.array(u)))
    return np.asarray(js.accum), ts.accum.numpy(), ts


@pytest.mark.parametrize("name", ["cornell_box_nee", "multi_light",
                                  "teapot_like", "mesh_heavy"])
def test_bounce_matches_jax(name):
    a_jax, a_port, ts = run_both(name)
    assert ts.pass_idx == 4
    assert_images_match(a_port, a_jax)


def test_bounce_glass_and_fog_pins_hit_ids():
    """glass_and_fog (refraction + a scattering medium, ray-sorted
    traversal): on every pass's wavefront, fed identically to both
    packages, the port's closest-hit ids equal the JAX ids on every ray
    that f64 does not classify as chaotic; sample counts stay exact.

    Image tolerance: frac 0.97 of pixels within 2e-3 (the JAX suite's own
    oracle test of this scene accepts 0.85; measured here 0.980). Why not
    0.995: XLA on the CPU fuses multiply-adds into FMAs and torch does not,
    so directions differ in the last bits, and refraction at the curved
    glass and the free-flight distances in the fog amplify that over
    bounces into different paths for about 2% of pixels at 24^2, 4
    passes."""
    checked = []

    def pin(p, scene, cfg, js, tscene, tcfg):
        o, d = np.array(js.origin), np.array(js.direction)
        depth0 = np.asarray(js.path_depth)
        cam = (0.01, 1000.0)
        near = np.where(depth0 == 0, cam[0], np.asarray(js.near)).astype(np.float32)
        far = np.where(depth0 == 0, cam[1], np.asarray(js.far)).astype(np.float32)
        hw = (RES, RES)
        _, tid_j, *_ = jint.closest_hit(scene, cfg, *map(jax.numpy.asarray,
                                                         (o, d, near, far)), hw=hw)
        _, tid_t, *_ = tint.closest_hit(tscene, tcfg, *map(torch.as_tensor,
                                                          (o, d, near, far)), hw=hw)
        n = tscene.n_triangles
        ref, chaotic = closest_f64(o, d, tscene.tri_v0[:n].numpy(),
                                   tscene.tri_e1[:n].numpy(),
                                   tscene.tri_e2[:n].numpy(), near, far)
        safe = ~chaotic
        # pass 0 traces init_state's placeholder rays (all from the origin
        # along +z, which sits inside the glass sphere on a mesh edge): one
        # ray repeated, chaotic by symmetry. Later passes mix camera rays
        # with bounce rays, which leave a surface nudged only 1e-4 t off
        # it, so the surface they leave is within rounding of near = 0
        assert p == 0 or safe.mean() > 0.8, safe.mean()
        assert np.array_equal(tid_t.numpy()[safe], np.asarray(tid_j)[safe])
        assert np.array_equal(tid_t.numpy()[safe], ref[safe])
        checked.append(p)

    a_jax, a_port, _ = run_both("glass_and_fog", on_pass=pin)
    assert checked == [0, 1, 2, 3]
    assert_images_match(a_port, a_jax, frac=0.97)


def test_pick_matches_jax():
    """ray_cast (picking) on the same state in both packages: the JAX
    state after two passes is carried into the port with state_from_arrays."""
    res = 32
    world = rz.scenes.teapot_like(res, res)
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=4))
    js = jint.render_steps(scene, cam, cfg, jstate.init_state(res, res),
                           jax.random.key(1), 2)
    arrays = {f.name: np.array(getattr(js, f.name))
              for f in dataclasses.fields(js)}
    ts = tstate.state_from_arrays(arrays, device="cpu")
    assert ts.pass_idx == 2 and torch.equal(ts.accum, torch.as_tensor(arrays["accum"]))
    tscene = port_scene(scene)
    tcam = tds.compile_camera(rt.scenes.teapot_like(res, res).cameras[0], device="cpu")
    tcfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
    picks = []
    for y in range(2, res, 5):
        for x in range(1, res, 5):
            ji, jm = jint.ray_cast(scene, cam, cfg, js, x, y)
            picks.append(((int(ji), int(jm)),
                          tint.ray_cast(tscene, tcam, tcfg, ts, x, y)))
    assert all(a == b for a, b in picks), picks
    assert sum(a[0] >= 0 for a, _ in picks) >= 10     # 14 of 42 pixels hit


def test_ray_sort_does_not_change_the_image():
    world = rt.scenes.multi_light(32, 32)
    out = []
    for sort in (True, False):
        r = rt.Renderer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=4),
                                               ray_sort=sort), seed=5, device="cpu")
        r.render(rpp=3)
        out.append(r.views[id(world.cameras[0])].state.accum)
    assert torch.equal(out[0], out[1])


def test_renderer_cpu_image():
    world = rt.scenes.cornell_box_nee(32, 32)
    r = rt.Renderer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=4)),
                    device="cpu")
    r.render(rpp=4)
    img = r.image()
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    f = r.image_f32()
    assert not np.isnan(f).any() and 5 < img.mean() < 220
    cv = r.views[id(world.cameras[0])]
    assert cv.pass_count == 4 and cv.ray_count == 4 * 32 * 32
    assert float(cv.state.accum[..., 3].sum()) > 0
    assert r.depth().shape == (32, 32)
    inst, mat = r.pick(world.cameras[0], 16, 28)
    assert (inst >= 0) == (mat >= 0)


def test_resume_reproduces_render(tmp_path):
    world = rt.scenes.multi_light(24, 24)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
    full = rt.Renderer(world, cfg, seed=9, device="cpu")
    full.render(rpp=4)
    half = rt.Renderer(world, cfg, seed=9, device="cpu")
    half.render(rpp=2)
    p = str(tmp_path / "half.npz")
    half.save_checkpoint(p)
    resumed = rt.Renderer(world, cfg, seed=9, device="cpu")
    resumed.load_checkpoint(p)
    resumed.render(rpp=2)
    cam = world.cameras[0]
    assert torch.equal(resumed.views[id(cam)].state.accum,
                       full.views[id(cam)].state.accum)


def test_checkpoint_crosses_packages(tmp_path):
    """A port checkpoint loads in the JAX package and resumes there; a JAX
    checkpoint loads in the port and resumes there."""
    res = 24
    jworld = rz.scenes.cornell_box_nee(res, res)
    scene = compile_world(jworld)
    cam = compile_camera(jworld.cameras[0])
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=4))

    tworld = rt.scenes.cornell_box_nee(res, res)
    tr = rt.Renderer(tworld, rt.RenderConfig(tracing=rt.Tracing(max_depth=4)), device="cpu")
    tr.render(rpp=2)
    p1 = str(tmp_path / "port.npz")
    tr.save_checkpoint(p1)
    js = jstate.load_state(p1)
    assert int(js.pass_idx) == 2 and (js.width, js.height) == (res, res)
    before = float(np.asarray(js.accum)[..., 3].sum())
    js = jint.render_steps(scene, cam, cfg, js, jax.random.key(0), 2)
    assert int(js.pass_idx) == 4
    assert float(np.asarray(js.accum)[..., 3].sum()) > before

    p2 = str(tmp_path / "jax.npz")
    jstate.save_state(p2, js)
    tr2 = rt.Renderer(tworld, rt.RenderConfig(tracing=rt.Tracing(max_depth=4)), device="cpu")
    tr2.load_checkpoint(p2)
    cv = tr2.views[id(tworld.cameras[0])]
    assert cv.pass_count == 4
    assert np.array_equal(cv.state.accum.numpy(), np.asarray(js.accum))
    tr2.render(rpp=2)
    assert cv.state.pass_idx == 6
    assert float(cv.state.accum[..., 3].sum()) > float(np.asarray(js.accum)[..., 3].sum())


def test_camera_move_with_temporal_blend_raises():
    """A camera move under the default temporal_blend (0.75) once raised
    NotImplementedError (ROADMAP A13). Now the port reprojects as the JAX
    renderer does: two passes, a look_at, one pass, in both packages from
    the same seed with no injected uniforms; the seeded accumulation
    matches JAX's (``assert_images_match``). With temporal_blend 0 the
    accumulation restarts."""
    out = []
    for pkg in (rz, rt):
        world = pkg.scenes.cornell_box_nee(16, 16)
        kw = {} if pkg is rz else dict(device="cpu")
        r = pkg.Renderer(world, pkg.RenderConfig(tracing=pkg.Tracing(max_depth=2)),
                         seed=2, **kw)
        r.render(rpp=2)
        cam = world.cameras[0]
        cam.look_at((0.1, 0.0, 1.0))
        r.render(rpp=1)
        out.append(np.asarray(r.views[id(cam)].state.accum))
    assert r.views[id(cam)].pass_count == 1
    assert out[1][..., 3].sum() > 16 * 16          # seeded beyond one pass
    assert_images_match(out[1], out[0])
    cam.temporal_blend = 0.0
    cam.look_at((0.0, 0.1, 1.0))
    r.render(rpp=1)
    assert r.views[id(cam)].state.accum[..., 3].sum() == 16 * 16
