"""The bounce's three stages (``engine/integrator.py`` ``_head``,
``_surface``, ``_tail``) and their kernel wrappers (``ops/bounce.py``) on
the CPU.

``bounce_step`` runs one sequence of stages around the walks; the
integrator takes the kernel stages only on a card without autograd, so on
the CPU it runs the plain stages and the wrappers, which have no CPU
route, launch nothing. These tests hold:

* the stages called one by one (``_head``, ``_closest_walk``,
  ``_surface``, the shadow walks, ``_tail``) equal to ``bounce_step`` bit
  for bit, with autograd and without, on soup, textured, scattering,
  two-level and cutout scenes, with no bounce launch counted;
* each wrapper refusing CPU tensors (the kernel library's load raises
  without a card; with one, the device check raises).

That the stages equal the one-piece bounce they were cut from is held by
the JAX parity tests (``test_torch_render.py``, ``test_torch_textures.py``,
``test_torch_two_level.py``, ``test_torch_oracle_parity.py``), which run
the port's ``bounce_step`` against the JAX package's.
"""
import numpy as np
import pytest
import torch

import rayzath_tpu_torch as rt
from rayzath_tpu_torch.engine import integrator as I
from rayzath_tpu_torch.engine.state import _ARRAYS, init_state
from rayzath_tpu_torch.models import device_scene as tds
from rayzath_tpu_torch.ops import bounce
from rayzath_tpu_torch.utils.check_worlds import cutout_world

torch.set_num_threads(2)

RES = 16
WORLDS = ("cornell_box_nee", "multi_light", "glass_and_fog", "textured_room",
          "instanced_field", "cutout world")
STAGES = (bounce.bounce_head, bounce.bounce_surface, bounce.bounce_tail)


def setup(name, two_level=None):
    if name == "cutout world":
        world = cutout_world(RES)
    elif name == "instanced_field":
        world = rt.scenes.instanced_field(RES, RES, n=3, resolution=12)
    else:
        world = rt.scenes.SCENES[name](RES, RES)
    scene = tds.compile_world(world, two_level=two_level, device="cpu")
    cam = tds.compile_camera(world.cameras[0], device="cpu")
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
    return scene, cam, cfg


def uniforms(scene, cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    ns = I.n_streams(cfg, scene)
    return [torch.as_tensor(rng.random((RES * RES, ns), dtype=np.float32))
            for _ in range(n)]


def by_hand(scene, cam, cfg, state, u):
    """One bounce from the plain stages called one by one."""
    hw = (state.height, state.width)
    hd = I._head(scene, cam, state, u)
    walk = I._closest_walk(scene, cfg, state.origin, state.direction,
                           hd.near, hd.far_eff, hw=hw)
    sf = I._surface(scene, cfg, state, u, hd, walk)
    vis = I._shadows(scene, cfg, sf, hw)
    assert len(vis) == len(sf.shadow_d) == len(sf.shadow_w)
    return I._tail(scene, cam, cfg, state, u, sf, vis, 0)


def assert_same(a, b):
    for f in _ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(x, y) or (
            x.is_floating_point() and torch.equal(torch.isnan(x), torch.isnan(y))
            and torch.equal(x[~torch.isnan(x)], y[~torch.isnan(y)])), f
    assert a.pass_idx == b.pass_idx


@pytest.mark.parametrize("grad", [True, False], ids=["autograd", "no_grad"])
@pytest.mark.parametrize("name", WORLDS)
def test_stages_compose_to_bounce_step(name, grad):
    """_head -> _closest_walk -> _surface -> shadows -> _tail, called by
    hand, give bounce_step's state bit for bit over three bounces, and the
    wrappers launch nothing on the CPU."""
    scene, cam, cfg = setup(name)
    state = init_state(RES, RES, "cpu")
    start = [f.launches for f in STAGES]
    with torch.set_grad_enabled(grad):
        for u in uniforms(scene, cfg, 3):
            got = I.bounce_step(scene, cam, cfg, state, u=u)
            assert_same(got, by_hand(scene, cam, cfg, state, u))
            state = got
    assert [f.launches for f in STAGES] == start


def stage_args(name):
    """Each wrapper's arguments on CPU tensors, from the plain stages of
    one bounce of ``name``."""
    scene, cam, cfg = setup(name)
    state = init_state(RES, RES, "cpu")
    u = uniforms(scene, cfg, 1)[0]
    lights = I.light_samples(cfg, scene)
    with torch.no_grad():
        hd = I._head(scene, cam, state, u)
        walk = I._closest_walk(scene, cfg, state.origin, state.direction,
                               hd.near, hd.far_eff, hw=(RES, RES))
        sf = I._surface(scene, cfg, state, u, hd, walk)
        vis = I._shadows(scene, cfg, sf, (RES, RES))
    return {bounce.bounce_head: (scene, cam, state, u, hd.mp),
            bounce.bounce_surface: (scene, state, u, hd, walk, lights),
            bounce.bounce_tail: (scene, cam, state, u, sf, vis, lights,
                                 cfg.tracing.max_depth)}


@pytest.mark.parametrize("stage", STAGES, ids=lambda f: f.__name__)
def test_bounce_wrappers_refuse_tensors_off_a_card(stage):
    """A wrapper called with CPU tensors raises and counts no launch: the
    kernel library's load first (no card, no nvcc here), else the device
    check. There is no CPU route."""
    args = stage_args("textured_room")[stage]
    start = stage.launches
    with torch.no_grad(), pytest.raises(
            ValueError if torch.cuda.is_available() else RuntimeError):
        stage(*args)
    assert stage.launches == start


def test_renderer_on_the_cpu_launches_no_bounce_kernel():
    """A Renderer on the CPU (its passes run without autograd, through the
    wrappers) counts no bounce launch."""
    world = rt.scenes.multi_light(RES, RES)
    r = rt.Renderer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=4)),
                    seed=1, device="cpu")
    start = [f.launches for f in STAGES]
    r.render(rpp=2)
    assert [f.launches for f in STAGES] == start
    assert float(r.views[id(world.cameras[0])].state.accum[..., 3].sum()) > 0


CULL_WORLDS = ("cutout world", "textured_room", "cornell_box_nee",
               "instanced_field")


def _same(x, y):
    """Two Surface fields the same bits (tensors, tuples of them, None)."""
    if isinstance(x, tuple):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    if x is None or y is None:
        return x is y
    return torch.equal(x, y) or (
        x.is_floating_point() and torch.equal(torch.isnan(x), torch.isnan(y))
        and torch.equal(x[~torch.isnan(x)], y[~torch.isnan(y)]))


@pytest.mark.parametrize("name", CULL_WORLDS)
def test_zero_weight_samples_enter_the_walks_inactive(name, monkeypatch):
    """Over three bounces, ``_surface`` hands a light sample's shadow ray
    in with dist 0 exactly where the sample weighs zero whatever its
    visibility (its lane hit nothing or its radiance is 0), and every
    other sample with the distance of the uncut formula (``_live_dist``
    the identity), all else the same bits. The walks give a culled ray
    visibility (1, 1, 1, 1), and ``_tail`` gives the same accumulation and
    next state bit for bit with the culled samples' visibility replaced by
    seeded values in [0, 1], and from the uncut rays' walked visibility.
    instanced_field is compiled two-level, so that B4 walks its rays."""
    scene, cam, cfg = setup(name, two_level=name == "instanced_field" or None)
    assert scene.two_level == (name == "instanced_field")
    state = init_state(RES, RES, "cpu")
    hw = (RES, RES)
    gen = torch.Generator().manual_seed(11)
    culled_rays = missed = 0
    with torch.no_grad():
        for u in uniforms(scene, cfg, 3):
            hd = I._head(scene, cam, state, u)
            walk = I._closest_walk(scene, cfg, state.origin, state.direction,
                                   hd.near, hd.far_eff, hw=hw)
            sf = I._surface(scene, cfg, state, u, hd, walk)
            with monkeypatch.context() as m:
                m.setattr(I, "_live_dist", lambda dist, any_hit, rad: dist)
                uncut = I._surface(scene, cfg, state, u, hd, walk)
            assert len(sf.shadow_dist) > 0
            for f in I.Surface._fields:
                if f != "shadow_dist":
                    assert _same(getattr(sf, f), getattr(uncut, f)), f
            for dist, full, rad in zip(sf.shadow_dist, uncut.shadow_dist,
                                       sf.shadow_rad):
                culled = ~sf.any_hit | (rad == 0.0)
                assert torch.equal(dist == 0.0, culled)
                assert torch.equal(dist[~culled], full[~culled])
                assert bool((full > 0.0).all())
                culled_rays += int(culled.sum())
            missed += int((~sf.any_hit).sum())

            vis = I._shadows(scene, cfg, sf, hw)
            noisy = []
            for (v_rgb, v_a), dist in zip(vis, sf.shadow_dist):
                off = dist == 0.0
                assert bool((v_rgb[off] == 1.0).all() and (v_a[off] == 1.0).all())
                noisy.append((
                    torch.where(off[:, None], torch.rand(v_rgb.shape,
                                                         generator=gen), v_rgb),
                    torch.where(off, torch.rand(v_a.shape, generator=gen),
                                v_a)))
            got = I._tail(scene, cam, cfg, state, u, sf, vis, 0)
            assert_same(got, I._tail(scene, cam, cfg, state, u, sf, noisy, 0))
            assert_same(got, I._tail(scene, cam, cfg, state, u, uncut,
                                     I._shadows(scene, cfg, uncut, hw), 0))
            state = got
    assert culled_rays > 0 and missed > 0
