"""The port's random streams (``ops/rng.py``) against ``jax.random``.

``key``, ``fold_in`` and the pass uniforms are held bit for bit to jax's
default threefry2x32 (partitionable layout), for several seeds, folds, row
offsets and shapes. Then renders and gradients with no injected uniforms:
``Renderer(seed=s)`` against the JAX ``Renderer(seed=s)`` (sample counts
equal, radiance by ``assert_images_match``: tol 2e-3, frac 0.995), a band
of rows at ``row0 > 0`` against the same rows of the whole image (bit for
bit), and ``image_loss`` / ``training_step`` against ``jax.grad`` with
``jax.random.key(seed)`` (loss to rel 1e-5, each gradient to rtol 1e-3 of
its max |g|, the rule of tests/test_torch_gradients.py).
"""
import dataclasses

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
from rayzath_tpu_torch.engine import integrator as tint  # noqa: E402
from rayzath_tpu_torch.engine.state import init_state  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import rng  # noqa: E402
from rayzath_tpu_torch.parallel import train as ttrain  # noqa: E402

from test_oracle_parity import assert_images_match  # noqa: E402
from test_torch_gradients import (DIFF_PARAMS, assert_grads_match,  # noqa: E402
                                  exact_gathers, tiny_world)  # noqa: F401


def key_words(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 7, 12345, 2 ** 31 - 1, -3, 2 ** 32 - 1])
def test_key_and_fold_in_match_jax(seed):
    k = jax.random.key(seed)
    assert rng.key(seed) == key_words(k)
    for d in (0, 1, 3, 255, 2 ** 31 + 5):
        assert rng.fold_in(rng.key(seed), d) == key_words(jax.random.fold_in(k, d))


@pytest.mark.parametrize("shape", [(6,), (2, 3), (5, 14), (3, 4, 5)])
def test_uniform_bits_match_jax(shape):
    """The bits at flat index i are x0 ^ x1 of threefry2x32(k, (0, i))."""
    k = jax.random.fold_in(jax.random.key(11), 4)
    ref = np.asarray(jax.random.uniform(k, shape, jnp.float32))
    k0, k1 = key_words(k)
    x0, x1 = rng.threefry2x32(k0, k1, 0, torch.arange(int(np.prod(shape)),
                                                    dtype=torch.int64))
    got = rng.bits_to_unit(x0 ^ x1).reshape(shape).numpy()
    assert np.array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("seed,pass_idx,row0,h,w,ns", [
    (7, 3, 0, 2, 3, 8), (0, 0, 5, 4, 7, 14), (2 ** 31 - 1, 11, 100, 3, 16, 11),
    (9, 1, 37, 1, 1, 8)])
def test_pass_uniforms_match_jax(seed, pass_idx, row0, h, w, ns):
    k = jax.random.fold_in(jax.random.key(seed), pass_idx)
    ref = np.asarray(jint.pass_uniforms(k, row0, h, w, ns))
    got = tint.pass_uniforms(rng.fold_in(rng.key(seed), pass_idx), row0, h, w,
                             ns, "cpu").numpy()
    assert got.shape == (h * w, ns) and got.dtype == np.float32
    assert np.array_equal(bits(got), bits(ref))


def test_band_draws_the_global_rows():
    """A band of rows at row0 draws what the same rows of the whole image
    draw, and a band's bounce equals the same rows of the whole bounce."""
    k = rng.fold_in(rng.key(5), 2)
    whole = rng.uniform_rows_plain(k, 0, 12, 8, 14)
    band = rng.uniform_rows_plain(k, 4, 6, 8, 14)
    assert torch.equal(band, whole[4 * 8:10 * 8])

    world = rt.scenes.cornell_box_nee(16, 16)
    scene = tds.compile_world(world, device="cpu")
    cam = tds.compile_camera(world.cameras[0], device="cpu")
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3))
    st_all = init_state(16, 16, device="cpu")
    st_band = init_state(16, 8, device="cpu")
    for p in range(3):
        kp = rng.fold_in(rng.key(5), p)
        st_all = tint.bounce_step(scene, cam, cfg, st_all, kp)
        st_band = tint.bounce_step(scene, cam, cfg, st_band, kp, row0=8)
    assert torch.equal(st_band.accum, st_all.accum[8:])


@pytest.mark.parametrize("name", ["cornell_box_nee", "multi_light"])
def test_renderer_seed_matches_jax(name):
    """No injected uniforms: the port's Renderer(seed=) against the JAX
    Renderer(seed=), both compiling the same world with their defaults."""
    res, seed = 16, 21
    jr = rz.Renderer(getattr(rz.scenes, name)(res, res),
                     rz.RenderConfig(tracing=rz.Tracing(max_depth=4)), seed=seed)
    tworld = getattr(rt.scenes, name)(res, res)
    tr = rt.Renderer(tworld, rt.RenderConfig(tracing=rt.Tracing(max_depth=4)),
                     seed=seed, device="cpu")
    jr.render(rpp=3)
    tr.render(rpp=3)
    a_jax = np.asarray(jr.views[id(jr.world.cameras[0])].state.accum)
    a_port = tr.views[id(tworld.cameras[0])].state.accum.numpy()
    assert a_port[..., 3].sum() > 0
    assert_images_match(a_port, a_jax)


def test_image_loss_and_training_step_match_jax_without_u(exact_gathers):
    """image_loss's gradients and training_step with no injected uniforms
    against jax.grad and the JAX training_step, both keyed by seed 13."""
    seed, n_steps, lr = 13, 4, 0.5
    world = tiny_world(rz)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=3))
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])
    w_, h_ = world.cameras[0].width, world.cameras[0].height
    tgt = np.full((h_, w_, 3), 0.1, np.float32)
    params = {k: getattr(scene, k) for k in DIFF_PARAMS}

    def loss_fn(p):
        return jtrain.image_loss(scene.replace(**p), cam, cfg, jinit(w_, h_),
                                 jax.random.key(seed), jnp.asarray(tgt),
                                 n_steps)[0]

    jl, jg = jax.value_and_grad(loss_fn)(params)
    jg = {k: np.asarray(v) for k, v in jg.items()}
    ts = tds.compile_world(tiny_world(rt), device="cpu")
    tcam = tds.compile_camera(tiny_world(rt).cameras[0], device="cpu")
    tcfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3))
    leaves = {k: getattr(ts, k).detach().requires_grad_(True) for k in DIFF_PARAMS}
    tl, _ = ttrain.image_loss(dataclasses.replace(ts, **leaves), tcam, tcfg,
                              init_state(w_, h_, device="cpu"), seed,
                              torch.as_tensor(tgt), n_steps)
    tg = torch.autograd.grad(tl, list(leaves.values()), allow_unused=True)
    tg = {k: (np.zeros(v.shape, np.float32) if g is None else g.numpy())
          for (k, v), g in zip(leaves.items(), tg)}
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert_grads_match(jg, tg, expect=("mat_color", "mat_emission"))

    js_new, _, jloss = jtrain.training_step(scene, cam, cfg, jinit(w_, h_),
                                            jax.random.key(seed),
                                            jnp.asarray(tgt), lr, n_steps)
    ts_new, _, tloss = ttrain.training_step(ts, tcam, tcfg,
                                            init_state(w_, h_, device="cpu"),
                                            seed, torch.as_tensor(tgt), lr,
                                            n_steps)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    for k in ("mat_color", "mat_emission"):
        step_j = np.asarray(getattr(js_new, k)) - np.asarray(getattr(scene, k))
        step_t = (getattr(ts_new, k) - getattr(ts, k)).numpy()
        assert np.abs(step_t - step_j).max() <= 1e-3 * np.abs(step_j).max(), k
