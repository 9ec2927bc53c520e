"""Differentiable (inverse-rendering) training step.

Counterpart of ``rayzath_tpu/parallel/train.py``: render with the current
scene parameters, compare the mean image with a target, and take one
projected SGD step on the material properties, texture atlases and light
emissions. Gradients flow through the wavefront integrator: discrete hit
ids carry none, hit coordinates are re-derived differentiably
(engine/integrator.py), the shadow kernels replay densely in their
backward (ops/traverse_cluster.py), the total-internal-reflection branch is
straight-through with a sigmoid-relaxed gradient (ops/vec.py) and the
free-flight scatter decision carries a score-function ratio.
"""
from __future__ import annotations

import dataclasses

import torch

from ..engine.integrator import render_steps_preserve
from ..engine.state import RenderState
from ..ops import rng

#: Scene leaves that receive gradients (the JAX package's list; each is
#: held against ``jax.grad`` and finite differences in
#: tests/test_torch_gradients.py).
DIFF_PARAMS = ("mat_color", "mat_metalness", "mat_roughness", "mat_emission",
               "mat_ior", "mat_scattering",
               "color_atlas", "scalar_atlas", "spot_emission", "dir_emission")

_UNIT_PARAMS = ("mat_color", "mat_metalness", "mat_roughness", "color_atlas")


def image_loss(scene, cam, cfg, state: RenderState, seed: int, target,
               n_steps: int, remat: bool = False, u=None):
    """MSE between the mean accumulated radiance and a target HDR image
    [H, W, 3]. Returns (loss, post-render state); ``state`` is not
    mutated. The render runs under ``rng.key(seed)``, the JAX package's
    ``jax.random.key(seed)``. ``u``: optional injected uniforms, one tensor
    per step."""
    st = render_steps_preserve(scene, cam, cfg, state, rng.key(seed), n_steps,
                               remat=remat, u=u)
    spp = torch.maximum(st.accum[..., 3:4], torch.ones_like(st.accum[..., 3:4]))
    img = st.accum[..., :3] / spp
    return torch.mean(torch.square(img - target)), st


def training_step(scene, cam, cfg, state: RenderState, seed: int, target, lr,
                  n_steps: int, remat: bool = False, u=None):
    """One SGD step on the :data:`DIFF_PARAMS` of ``scene``.

    Returns (updated scene, post-render state, loss), all detached. The
    parameters become fresh autograd leaves for the render, the gradients
    come from ``torch.autograd.grad``, and the projected update runs under
    ``no_grad``; the caller's scene and state are not mutated (the new
    scene is a ``dataclasses.replace`` with new parameter tensors). As in
    the JAX package, ``state`` should be a fresh ``init_state`` unless a
    progressive estimate is continued on purpose."""
    params = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in DIFF_PARAMS}
    with torch.enable_grad():
        loss, st = image_loss(dataclasses.replace(scene, **params), cam, cfg,
                              state, seed, target, n_steps, remat=remat, u=u)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    with torch.no_grad():
        new = {k: _project(k, p - lr * g) if g is not None else p.detach()
               for (k, p), g in zip(params.items(), grads)}
    st = st.replace(**{f.name: getattr(st, f.name).detach()
                       for f in dataclasses.fields(st)
                       if isinstance(getattr(st, f.name), torch.Tensor)})
    return dataclasses.replace(scene, **new), st, loss.detach()


def _project(name: str, value):
    """Projected SGD: keep parameters in their physical ranges (negative
    emission or roughness outside [0, 1] give non-physical radiance and can
    diverge to NaN)."""
    if name in _UNIT_PARAMS:
        return torch.clamp(value, 0.0, 1.0)
    if name == "mat_ior":
        return torch.clamp(value, min=1.0)    # indices below 1 are non-physical
    return torch.clamp(value, min=0.0)
