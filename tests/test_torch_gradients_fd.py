"""The port's gradients against finite differences, and its training step.

The checks of tests/test_gradients.py rerun on the port alone (its own
``compile_world``, its own uniforms): central differences of the image
loss, with the scenes, parameters, steps and tolerances of the JAX suite
(rel 0.05 for material color and emission, the atlas texel and the
blocker's alpha at 64^2; rel 0.07 for the lights and surface parameters;
Monte Carlo against Monte Carlo over several seeds for the ior, rel 0.3,
and the scattering coefficient's score function, rel 0.15). Then
``training_step`` descends as in ``test_training_step_descends``, and
``jax.grad`` on ``textured_room(16, 12)`` reaches the atlas texels as the
port's gradient does (tests/test_torch_gradients.py's rule).
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine.integrator import render_steps_preserve  # noqa: E402
from rayzath_tpu_torch.engine.state import init_state  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import rng  # noqa: E402
from rayzath_tpu_torch.parallel.train import image_loss, training_step  # noqa: E402

from test_torch_gradients import (assert_grads_match, both_grads,  # noqa: E402
                                  exact_gathers, lit_world, tiny_world)  # noqa: F401


def setup(make_world, max_depth, **compile_kw):
    w = make_world(rt)
    cam = w.cameras[0]
    return (tds.compile_world(w, device="cpu", **compile_kw),
            tds.compile_camera(cam, device="cpu"),
            rt.RenderConfig(tracing=rt.Tracing(max_depth=max_depth)),
            init_state(cam.width, cam.height, device="cpu"), (cam.height, cam.width))


def grad_and_fd(scene, cam, cfg, state, seed, target, n, param, idx, eps):
    """(d loss / d param[idx] by autograd, central difference)."""
    def loss_at(value, grad=False):
        p = getattr(scene, param).detach().clone()
        if grad:
            p.requires_grad_(True)
            with torch.no_grad():
                p[idx] = value
        else:
            p[idx] = value
        loss, _ = image_loss(dataclasses.replace(scene, **{param: p}), cam, cfg,
                             state, seed, target, n)
        return loss, p

    base = float(getattr(scene, param)[idx])
    loss, p = loss_at(base, grad=True)
    g = float(torch.autograd.grad(loss, p)[0][idx])
    with torch.no_grad():
        fd = (float(loss_at(base + eps)[0]) - float(loss_at(base - eps)[0])) / (2 * eps)
    return g, fd


@pytest.mark.parametrize("param,idx,eps", [("mat_emission", 3, 1e-2),
                                           ("mat_color", (2, 0), 1e-3)])
def test_grad_matches_finite_difference(param, idx, eps):
    scene, cam, cfg, state, hw = setup(tiny_world, 3)
    g, fd = grad_and_fd(scene, cam, cfg, state, 7, torch.zeros(*hw, 3), 6,
                        param, idx, eps)
    assert np.isfinite(g) and g != 0.0
    assert g == pytest.approx(fd, rel=0.05)


@pytest.mark.parametrize("param,idx,eps", [
    ("spot_emission", 0, 1e-2), ("dir_emission", 0, 1e-2),
    ("mat_roughness", 2, 1e-3), ("mat_metalness", 2, 1e-3)])
def test_grad_fd_lights_and_surface_params(param, idx, eps):
    scene, cam, cfg, state, hw = setup(lit_world, 3)
    g, fd = grad_and_fd(scene, cam, cfg, state, 3, torch.zeros(*hw, 3), 4,
                        param, idx, eps)
    assert np.isfinite(g) and g != 0.0
    assert g == pytest.approx(fd, rel=0.07)


def test_grad_fd_atlas_texel():
    scene, cam, cfg, state, hw = setup(
        lambda pkg: pkg.scenes.textured_room(16, 12), 2)
    target = torch.zeros(*hw, 3)
    atlas = scene.color_atlas.detach().clone().requires_grad_(True)
    loss, _ = image_loss(dataclasses.replace(scene, color_atlas=atlas), cam,
                         cfg, state, 9, target, 2)
    g = torch.autograd.grad(loss, atlas)[0].numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    iy, ix, ic = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 1e-2

    def loss_of(delta):
        a = scene.color_atlas.clone()
        a[iy, ix, ic] += delta
        with torch.no_grad():
            return float(image_loss(dataclasses.replace(scene, color_atlas=a),
                                    cam, cfg, state, 9, target, 2)[0])

    fd = (loss_of(eps) - loss_of(-eps)) / (2 * eps)
    assert float(g[iy, ix, ic]) == pytest.approx(fd, rel=0.05)


def test_grad_fd_through_cluster_shadow_at_64px():
    """The blocker's alpha reaches the loss through B2's backward only."""
    scene, cam, cfg, state, hw = setup(lambda pkg: lit_world(pkg, 64), 2)
    bi = 3                                  # world, default, floor, blocker
    assert abs(float(scene.mat_color[bi, 3]) - 0.55) < 1e-6
    g, fd = grad_and_fd(scene, cam, cfg, state, 4, torch.zeros(*hw, 3), 2,
                        "mat_color", (bi, 3), 2e-3)
    assert np.isfinite(g) and g != 0.0
    assert g == pytest.approx(fd, rel=0.05)


def test_grad_fd_ior():
    """The ior through fresnel's straight-through TIR relaxation: analytic
    and finite differences both averaged over seeds (the branch lotteries
    it shifts are discrete)."""
    scene, cam, cfg, state, hw = setup(
        lambda pkg: pkg.scenes.multi_light(16, 12), 3)
    idx = int(np.argwhere(scene.mat_ior.numpy() > 1.2)[0, 0])
    target = torch.zeros(*hw, 3)
    gs, fds = [], []
    for seed in range(50, 58):
        g, fd = grad_and_fd(scene, cam, cfg, state, seed, target, 4, "mat_ior",
                            idx, 0.05)
        gs.append(g)
        fds.append(fd)
    g, fd = float(np.mean(gs)), float(np.mean(fds))
    assert np.isfinite(g) and g != 0.0
    assert g == pytest.approx(fd, rel=0.3)


def foggy_world(pkg):
    """tests/test_gradients.py ``foggy_world``: the camera inside a
    scattering world medium over an emissive floor."""
    w = pkg.World()
    w.material.scattering = 0.8
    w.material.emission = 0.4
    glow = w.create_material("glow", color=(1.0, 1.0, 1.0, 1.0), emission=5.0)
    plane = w.generate_mesh("plane", sides=4, width=6.0, height=6.0)
    w.create_instance(name="floor", mesh=plane, materials=[glow])
    cam = w.create_camera("cam", position=(0, 1.2, -2.0), resolution=(8, 8),
                          aperture=0.01, exposure_time=1.0)
    cam.look_at((0, 0.0, 0.5))
    return w


def test_grad_fd_scattering_score_function():
    """The free-flight decision's score-function ratio: the derivative of
    the expected radiance, analytic and finite differences each averaged
    over 32 seeds."""
    scene, cam, cfg, state, _ = setup(foggy_world, 4)
    assert float(scene.mat_scattering[0]) == pytest.approx(0.8)

    def radiance(v, seed, grad=False):
        s = scene.mat_scattering.detach().clone()
        s[0] = v
        s.requires_grad_(grad)
        st = render_steps_preserve(dataclasses.replace(scene, mat_scattering=s),
                                   cam, cfg, state, rng.key(seed), 4)
        return st.accum[..., :3].mean(), s

    gs, fds = [], []
    for seed in range(1000, 1032):
        r, s = radiance(0.8, seed, grad=True)
        gs.append(float(torch.autograd.grad(r, s)[0][0]))
        with torch.no_grad():
            fds.append((float(radiance(0.95, seed)[0])
                        - float(radiance(0.65, seed)[0])) / 0.3)
    g, fd = float(np.mean(gs)), float(np.mean(fds))
    assert np.isfinite(g) and g != 0.0
    assert g == pytest.approx(fd, rel=0.15)


def test_training_step_descends():
    """Target: the same scene with a dimmer lamp; eight SGD steps at lr 0.5
    cut the loss and move the lamp's emission toward the target's. The
    caller's scene and state are not mutated, and remat gives the same
    step."""
    scene, cam, cfg, state, _ = setup(tiny_world, 3)
    dim, *_ = setup(lambda pkg: tiny_world(pkg, emission=2.0), 3)
    with torch.no_grad():
        st = render_steps_preserve(dim, cam, cfg, state, rng.key(7), 6)
    target = st.accum[..., :3] / torch.clamp(st.accum[..., 3:4], min=1.0)
    before = {k: v.clone() for k, v in vars(scene).items()
              if isinstance(v, torch.Tensor)}
    state0 = state.accum.clone()
    s, losses = scene, []
    for _ in range(8):
        s, _, loss = training_step(s, cam, cfg, state, 7, target, 0.5, 6)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses
    assert float(s.mat_emission[3]) < float(scene.mat_emission[3])
    for k, v in before.items():
        assert torch.equal(getattr(scene, k), v), k
    assert torch.equal(state.accum, state0)
    s1, _, l1 = training_step(scene, cam, cfg, state, 7, target, 0.5, 6)
    s2, _, l2 = training_step(scene, cam, cfg, state, 7, target, 0.5, 6,
                              remat=True)
    assert float(l1) == float(l2)
    for k in ("mat_emission", "mat_color"):
        torch.testing.assert_close(getattr(s1, k), getattr(s2, k),
                                   rtol=1e-6, atol=1e-7)


def test_serve_path_records_no_graph():
    """Renderer.render keeps no autograd graph, even for a scene whose
    parameters require grad."""
    world = rt.scenes.textured_room(16, 16)
    r = rt.Renderer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=2)), device="cpu")
    r.update_scene()
    r.scene.mat_color.requires_grad_(True)
    r.render(rpp=2)
    st = r.views[id(world.cameras[0])].state
    assert all(not getattr(st, f.name).requires_grad
               for f in dataclasses.fields(st)
               if isinstance(getattr(st, f.name), torch.Tensor))


def test_grads_match_jax_textured_room(exact_gathers):
    """All ten parameters against jax.grad on textured_room(16, 12): the
    color atlas through the bilinear fetch, the scalar maps and the normal
    map's frame."""
    jl, jg, tl, tg = both_grads(
        lambda pkg: pkg.scenes.textured_room(16, 12), n_steps=2, max_depth=2,
        seed=9)
    assert tl == pytest.approx(jl, rel=1e-5)
    assert_grads_match(jg, tg, expect=("mat_color", "color_atlas",
                                       "spot_emission"))
