"""Gradients of the port against ``jax.grad`` of the same loss on the same
paths.

Both packages render the same scene (the JAX scene carried across with
``scene_from_arrays``) with the same uniforms (JAX's ``pass_uniforms``
streams, injected per pass), and the MSE image loss of
``parallel/train.py`` is differentiated with respect to all ten
``DIFF_PARAMS``: here on ``tiny_world`` (12^2) and ``lit_world`` (16^2, a
translucent blocker between a spot light, a direct light and a glossy
floor). The B2/B4 backwards at 64^2 and on two-level scenes are in
tests/test_torch_shadow_grad.py; ``textured_room(16, 12)`` (the color atlas
through the bilinear fetch), the finite-difference checks and the training
step in tests/test_torch_gradients_fd.py. (Three files, so that each stays
near a minute on the CPU: the JAX side's interpret-mode compile dominates.)

Tolerance: each parameter's gradient to rtol 1e-3 of its max |g|, where
max |g| is floored at 1e-4 of the largest max |g| of any parameter (a
gradient below that is float32 rounding on both sides). The JAX side runs
with its ``gather_rows`` replaced by a plain take: its one-hot bf16-limb
matrix product returns the same forward values bit for bit, but its
transpose rounds the cotangent of every gathered table (materials, lights)
to bfloat16, 2^-9 relative (ROADMAP C; pinned by
:func:`test_reference_table_gradients_are_bf16_rounded`).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu.engine import integrator as jint  # noqa: E402
from rayzath_tpu.engine.state import init_state as jinit  # noqa: E402
from rayzath_tpu.models.device_scene import compile_world, compile_camera  # noqa: E402
from rayzath_tpu.parallel import train as jtrain  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine.state import init_state  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.parallel import train as ttrain  # noqa: E402

from test_torch_render import port_scene  # noqa: E402

DIFF_PARAMS = ttrain.DIFF_PARAMS
RTOL = 1e-3


def _transform(pkg):
    return importlib.import_module(pkg.__name__ + ".utils.hostmath").Transform


def tiny_world(pkg, emission=8.0):
    """tests/test_gradients.py ``tiny_world`` from either package: a floor
    and an emissive cube, 12x12 camera."""
    w = pkg.World()
    white = w.create_material("white", color=(0.7, 0.6, 0.5, 1.0))
    lamp = w.create_material("lamp", color=(1.0, 0.9, 0.8, 1.0), emission=emission)
    plane = w.generate_mesh("plane", sides=4, width=4.0, height=4.0)
    w.create_instance(name="floor", mesh=plane, materials=[white])
    cube = w.generate_mesh("cube")
    w.create_instance(name="glow", mesh=cube, materials=[lamp],
                      transform=_transform(pkg)(position=(0, 1.2, 0)))
    cam = w.create_camera("cam", position=(0, 1.0, -3.0), resolution=(12, 12),
                          aperture=0.01, exposure_time=1.0)
    cam.look_at((0, 0.5, 0))
    return w


def lit_world(pkg, res=16):
    """tests/test_gradients.py ``lit_world`` from either package: spot and
    direct light, a glossy floor and a blocker at alpha 0.55."""
    w = pkg.World()
    floor_m = w.create_material("floor", color=(0.6, 0.6, 0.6, 1.0),
                                roughness=0.3, metalness=0.2)
    blocker_m = w.create_material("blocker", color=(0.8, 0.3, 0.2, 0.55))
    plane = w.generate_mesh("plane", sides=4, width=6.0, height=6.0)
    w.create_instance(name="floor", mesh=plane, materials=[floor_m])
    cube = w.generate_mesh("cube")
    w.create_instance(name="blocker", mesh=cube, materials=[blocker_m],
                      transform=_transform(pkg)(position=(0, 1.0, 0),
                                                scale=(0.8, 0.2, 0.8)))
    w.create_spot_light(position=(0.0, 3.0, 0.0), direction=(0, -1, 0),
                        size=0.4, emission=30.0, beam_angle=1.2)
    w.create_direct_light(direction=(-0.4, -1.0, 0.2), emission=5.0,
                          angular_size=0.1)
    cam = w.create_camera("cam", position=(0, 2.0, -4.0), resolution=(res, res),
                          aperture=0.01, exposure_time=1.0)
    cam.look_at((0, 0.3, 0))
    return w


@pytest.fixture
def exact_gathers(monkeypatch):
    """Route the JAX integrator's gather_rows to a plain take (same forward
    values; f32 cotangents instead of bf16-rounded ones). The jit caches are
    cleared on both sides: a cached trace would keep the other gather."""
    jax.clear_caches()
    monkeypatch.setattr(jint, "gather_rows",
                        lambda table, idx, one_hot_max=128: table[idx])
    yield
    jax.clear_caches()


def both_grads(make_world, n_steps, max_depth, seed, target=0.1,
               two_level=None):
    """(JAX loss, JAX grads, port loss, port grads) of the MSE image loss
    against a constant target, with respect to every DIFF_PARAMS leaf, on
    the same scene and uniforms."""
    world = make_world(rz)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=max_depth))
    scene = compile_world(world, two_level=two_level)
    cam = compile_camera(world.cameras[0])
    w_, h_ = world.cameras[0].width, world.cameras[0].height
    key = jax.random.key(seed)
    tgt = np.full((h_, w_, 3), target, np.float32)
    params = {k: getattr(scene, k) for k in DIFF_PARAMS}

    def loss_fn(p):
        return jtrain.image_loss(scene.replace(**p), cam, cfg, jinit(w_, h_),
                                 key, jnp.asarray(tgt), n_steps)[0]

    jl, jg = jax.value_and_grad(loss_fn)(params)
    ts = port_scene(scene)
    tcam = tds.compile_camera(make_world(rt).cameras[0], device="cpu")
    ns = jint.n_streams(cfg, scene)
    us = [torch.as_tensor(np.array(jint.pass_uniforms(
        jax.random.fold_in(key, p), 0, h_, w_, ns))) for p in range(n_steps)]
    leaves = {k: getattr(ts, k).detach().requires_grad_(True) for k in DIFF_PARAMS}
    tl, _ = ttrain.image_loss(dataclasses.replace(ts, **leaves), tcam,
                              rt.RenderConfig(tracing=rt.Tracing(max_depth=max_depth)),
                              init_state(w_, h_, device="cpu"), 0, torch.as_tensor(tgt),
                              n_steps, u=us)
    tg = torch.autograd.grad(tl, list(leaves.values()), allow_unused=True)
    tg = {k: (np.zeros(v.shape, np.float32) if g is None else g.numpy())
          for (k, v), g in zip(leaves.items(), tg)}
    return (float(jl), {k: np.asarray(v) for k, v in jg.items()},
            float(tl.detach()), tg)


def assert_grads_match(jg, tg, rtol=RTOL, expect=()):
    """Each parameter's port gradient within ``rtol`` of its max |g| (floored
    at 1e-4 of the largest) of JAX's; the parameters in ``expect`` must
    receive a non-zero gradient."""
    top = max(np.abs(g).max() for g in jg.values())
    for k in DIFF_PARAMS:
        assert np.isfinite(tg[k]).all(), k
        scale = max(np.abs(jg[k]).max(), 1e-4 * top)
        err = np.abs(tg[k] - jg[k]).max() / scale
        assert err <= rtol, f"{k}: max |dg| / max |g| = {err:.3e}"
    for k in expect:
        assert np.abs(tg[k]).max() > 1e-6 * top, f"{k}: no gradient"


def test_grads_match_jax_tiny_world(exact_gathers):
    jl, jg, tl, tg = both_grads(tiny_world, n_steps=6, max_depth=3, seed=7)
    assert tl == pytest.approx(jl, rel=1e-5)
    assert_grads_match(jg, tg, expect=("mat_color", "mat_emission"))


def test_grads_match_jax_lit_world(exact_gathers):
    """Spot and direct NEE through B2's backward (the blocker's opacity),
    glossy and metallic BSDF, the ior's relaxed TIR term and the world
    medium's score function."""
    jl, jg, tl, tg = both_grads(lit_world, n_steps=4, max_depth=3, seed=3)
    assert tl == pytest.approx(jl, rel=1e-5)
    assert_grads_match(jg, tg, expect=(
        "mat_color", "mat_metalness", "mat_roughness", "mat_ior",
        "mat_scattering", "spot_emission", "dir_emission"))


def test_reference_table_gradients_are_bf16_rounded():
    """Records a reference-side fault (ROADMAP C): without the exact-gather
    patch, the JAX gradients of the gathered material table carry bfloat16
    rounding (the transpose of gather_rows' bf16-limb product), up to 2^-9
    of their size, while the forward loss is unchanged."""
    jax.clear_caches()
    jl, jg, tl, tg = both_grads(tiny_world, n_steps=6, max_depth=3, seed=7)
    assert tl == pytest.approx(jl, rel=1e-5)
    g_j, g_t = jg["mat_emission"][3], tg["mat_emission"][3]
    assert g_j != g_t and abs(g_j - g_t) <= 2.0 ** -8 * abs(g_t)
    assert_grads_match(jg, tg, rtol=2.0 ** -8)
