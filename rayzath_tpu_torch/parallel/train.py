"""Differentiable (inverse-rendering) training step.

Counterpart of ``rayzath_tpu/parallel/train.py``: render with the current
scene parameters, compare the mean image with a target, and take one
projected SGD step on the material properties, texture atlases and light
emissions. Gradients flow through the wavefront integrator: discrete hit
ids carry none, hit coordinates are re-derived differentiably
(engine/integrator.py), the shadow kernels' backwards are the B2-grad and
B4-grad kernels (ops/traverse_cluster.py), the table gathers' backward is
the per-row sum G2 (ops/gather.py), the total-internal-reflection
branch is straight-through with a sigmoid-relaxed gradient (ops/vec.py)
and the free-flight scatter decision carries a score-function ratio.

The JAX package compiles the step (``jax.jit(training_step)``). Here its
counterpart is one captured CUDA graph per step: on a CUDA device
:func:`training_step` runs a :class:`_Step`, which keeps the step's inputs
and outputs in static device buffers. The first call for a given set of
baked-in values captures one whole step into a ``torch.cuda.CUDAGraph``:
the forward passes, the checkpointed recompute and the backward of
``torch.autograd.grad`` (autograd's device thread launches into the
capturing stream), the projected update and the copies into the output
buffers. Each call copies its inputs into the static buffers, replays the
graph once and returns clones of the outputs, so the caller's tensors are
never touched, as in JAX.

* The graph bakes in the scene's non-parameter tensors (the geometry and
  the tables: held by the step and compared by identity), the camera (by
  identity), the config, ``n_steps``, ``remat``, the image size, the
  target's shape and whether ``u`` is given. A call that changes one of
  them captures anew.
* Static buffers: the :data:`DIFF_PARAMS` leaves, the target, ``lr`` (a
  device scalar), the render key's words and the input state's pass index
  (each pass's key is folded on the device, ``rng.DeviceKey``, so every
  replay draws under its own seed), the input state, ``u`` when given, and
  the outputs: the updated parameters, the post-render state and the loss.
* On the CPU the same object runs the step eagerly with the same buffer
  handling: the plain path that the CPU tests hold bit for bit to the
  eager step (:func:`_eager_step`).
* A config whose passes read device values on the host
  (``integrator.host_reads``: the skip-link walk of
  ``RenderConfig(packet_traversal=False)``) runs :func:`_eager_step` on the
  card by design, as the render cycle runs such passes eagerly; its shadow
  gradient raises as in JAX in any case.
* Capture never falls back: a failed capture or replay raises
  ``RuntimeError``.

A captured kernel launches on every replay, but its wrapper's launch
counter ran only while the step was captured; as in ``engine/cycle.py``,
the step records what each counter of :data:`COUNTED` gained over the
capture and adds it per replay.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..engine import cycle
from ..engine.cycle import _int32, capture
from ..engine.integrator import host_reads, render_steps_preserve
from ..engine.state import _ARRAYS, RenderState
from ..ops import gather, rng
from ..ops import traverse_cluster as tc
from ..utils.timing import span

#: Scene leaves that receive gradients (the JAX package's list; each is
#: held against ``jax.grad`` and finite differences in
#: tests/test_torch_gradients.py).
DIFF_PARAMS = ("mat_color", "mat_metalness", "mat_roughness", "mat_emission",
               "mat_ior", "mat_scattering",
               "color_atlas", "scalar_atlas", "spot_emission", "dir_emission")

_UNIT_PARAMS = ("mat_color", "mat_metalness", "mat_roughness", "color_atlas")

#: the kernel wrappers whose ``launches`` counters a replay advances: a
#: render pass's, the shadow backwards and the gathers' backward
COUNTED = cycle.COUNTED + (tc.cluster_shadow_grad, tc.cluster_shadow_inst_grad,
                           gather.gather_rows_grad)


def image_loss(scene, cam, cfg, state: RenderState, seed: int, target,
               n_steps: int, remat: bool = False, u=None, row0: int = 0):
    """MSE between the mean accumulated radiance and a target HDR image
    [H, W, 3]. Returns (loss, post-render state); ``state`` is not
    mutated. The render runs under ``rng.key(seed)``, the JAX package's
    ``jax.random.key(seed)``. ``u``: optional injected uniforms, one tensor
    per step. ``row0``: global image row of the state's first row (a band
    of ``parallel/mesh.py``)."""
    return _loss(scene, cam, cfg, state, rng.key(seed), target, n_steps,
                 remat=remat, u=u, row0=row0)


def _loss(scene, cam, cfg, state: RenderState, key, target, n_steps: int,
          remat: bool = False, u=None, row0: int = 0):
    """:func:`image_loss` under a render key: ``rng.key(seed)``, or an
    ``rng.DeviceKey`` whose counter holds ``state.pass_idx``."""
    st = render_steps_preserve(scene, cam, cfg, state, key, n_steps,
                               row0=row0, remat=remat, u=u)
    spp = torch.maximum(st.accum[..., 3:4], torch.ones_like(st.accum[..., 3:4]))
    img = st.accum[..., :3] / spp
    return torch.mean(torch.square(img - target)), st


def training_step(scene, cam, cfg, state: RenderState, seed: int, target, lr,
                  n_steps: int, remat: bool = False, u=None):
    """One SGD step on the :data:`DIFF_PARAMS` of ``scene``.

    Returns (updated scene, post-render state, loss): fresh tensors,
    detached; the caller's scene and state are not mutated (the new scene
    is a ``dataclasses.replace`` with new parameter tensors). On a CUDA
    device the step is one replay of a captured CUDA graph (the module
    docstring); on the CPU, and on a card for a config with host reads, it
    runs eagerly, bit for bit as :func:`_eager_step`. As in the JAX
    package, ``state`` should be a fresh ``init_state`` unless a
    progressive estimate is continued on purpose."""
    dev = state.accum.device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda" and host_reads(cfg, scene):
        return _eager_step(scene, cam, cfg, state, seed, target, lr, n_steps,
                           remat=remat, u=u)
    step = _STEPS.get(dev)
    if step is None:
        step = _STEPS[dev] = _Step(dev)
    return step.run(scene, cam, cfg, state, seed, target, lr, n_steps, remat, u)


def _eager_step(scene, cam, cfg, state: RenderState, seed: int, target, lr,
                n_steps: int, remat: bool = False, u=None):
    """The training step run eagerly, op by op: the parameters become fresh
    autograd leaves for the render, the gradients come from
    ``torch.autograd.grad``, and the projected update runs under
    ``no_grad``. Returns what :func:`training_step` returns."""
    params = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in DIFF_PARAMS}
    with torch.enable_grad():
        loss, st = image_loss(dataclasses.replace(scene, **params), cam, cfg,
                              state, seed, target, n_steps, remat=remat, u=u)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    with torch.no_grad():
        new = {k: _update(k, p, g, lr)
               for (k, p), g in zip(params.items(), grads)}
    st = st.replace(**{f.name: getattr(st, f.name).detach()
                       for f in dataclasses.fields(st)
                       if isinstance(getattr(st, f.name), torch.Tensor)})
    return dataclasses.replace(scene, **new), st, loss.detach()


def _update(name: str, p, g, lr):
    """The projected SGD update of one parameter (unchanged without a
    gradient)."""
    return _project(name, p - lr * g) if g is not None else p.detach()


def _project(name: str, value):
    """Projected SGD: keep parameters in their physical ranges (negative
    emission or roughness outside [0, 1] give non-physical radiance and can
    diverge to NaN)."""
    if name in _UNIT_PARAMS:
        return torch.clamp(value, 0.0, 1.0)
    if name == "mat_ior":
        return torch.clamp(value, min=1.0)    # indices below 1 are non-physical
    return torch.clamp(value, min=0.0)


class _Step:
    """One training step's static buffers on ``device`` and, on a card, its
    captured graph (the module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        #: whether :meth:`run` replays a captured graph (else it runs the
        #: step eagerly)
        self.graphed = self.device.type == "cuda"
        self._baked: Optional[tuple] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._per_replay: tuple = ()    # (wrapper, launches per replay)
        self.params: Dict[str, torch.Tensor] = {}
        #: captures made and the milliseconds of the last one (its warm-up
        #: step included)
        self.captures = 0
        self.capture_ms = 0.0

    def run(self, scene, cam, cfg, state: RenderState, seed: int, target, lr,
            n_steps: int, remat: bool = False, u=None):
        """The step of :func:`training_step` through the static buffers."""
        baked = self._bake(scene, cam, cfg, state, target, n_steps, remat, u)
        if not self._same(baked):
            self._build(scene, state, target, u, baked)
        self._load(scene, state, seed, target, lr, u)
        if self.graphed:
            with torch.cuda.device(self.device):
                graph = self._captured()
                try:
                    graph.replay()
                except RuntimeError as e:
                    raise RuntimeError(f"training step: the replay failed: "
                                       f"{e}") from e
            for f, k in self._per_replay:
                f.launches += k
        else:
            self._body()
        new = {k: t.clone() for k, t in self.out_params.items()}
        st = state.replace(pass_idx=state.pass_idx + n_steps,
                           **{f: t.clone() for f, t in self.out_state.items()})
        return dataclasses.replace(scene, **new), st, self.out_loss.clone()

    # -- what the graph bakes in ---------------------------------------------
    @staticmethod
    def _bake(scene, cam, cfg, state, target, n_steps, remat, u) -> tuple:
        fixed = tuple((f.name, getattr(scene, f.name))
                      for f in dataclasses.fields(scene)
                      if f.name not in DIFF_PARAMS)
        return (fixed, cam, cfg, int(n_steps), bool(remat),
                (state.width, state.height), tuple(target.shape), u is None)

    def _same(self, baked: tuple) -> bool:
        if self._baked is None:
            return False
        (fixed, cam, *rest), (fixed0, cam0, *rest0) = baked, self._baked
        return (cam is cam0 and rest == rest0 and all(
            a is b or (not isinstance(a, torch.Tensor) and a == b)
            for (_, a), (_, b) in zip(fixed, fixed0)))

    # -- static buffers -------------------------------------------------------
    def _build(self, scene, state, target, u, baked) -> None:
        """New static buffers for the baked-in values (and no graph)."""
        self._graph = None      # and its memory pool, before capturing anew
        self._baked = baked
        dev = self.device
        f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32,
                                                              device=dev)
        self.params = {k: getattr(scene, k).detach().clone().requires_grad_(True)
                       for k in DIFF_PARAMS}
        self.scene = dataclasses.replace(scene, **self.params)
        self.cam, self.cfg, self.n_steps, self.remat = baked[1:5]
        self.state = state.replace(**{f: getattr(state, f).clone()
                                      for f in _ARRAYS})
        self.target = target.detach().clone()
        self.lr = torch.zeros((), **f32)
        self.words = torch.zeros(2, **i32)
        self.pass0 = torch.zeros((), **i32)
        self.u = None if u is None else [x.detach().clone() for x in u]
        self.out_params = {k: torch.empty_like(p) for k, p in self.params.items()}
        self.out_state = {f: torch.empty_like(getattr(state, f)) for f in _ARRAYS}
        self.out_loss = torch.zeros((), **f32)

    def _load(self, scene, state, seed, target, lr, u) -> None:
        """Copy a call's inputs into the static buffers."""
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(getattr(scene, k))
            for f in _ARRAYS:
                getattr(self.state, f).copy_(getattr(state, f))
            self.state.pass_idx = state.pass_idx
            self.target.copy_(target)
            self.lr.copy_(torch.as_tensor(lr, dtype=torch.float32))
            self.words.copy_(rng.key_words(rng.key(seed), "cpu"))
            self.pass0.fill_(_int32(state.pass_idx))
            for a, b in zip(self.u or (), u or ()):
                a.copy_(b)

    # -- the step -------------------------------------------------------------
    def _body(self) -> None:
        """One step from the static inputs into the static outputs:
        the loss, ``torch.autograd.grad``, the projected update."""
        with torch.enable_grad():
            loss, st = _loss(self.scene, self.cam, self.cfg, self.state,
                             rng.DeviceKey(self.words, self.pass0), self.target,
                             self.n_steps, remat=self.remat, u=self.u)
            grads = torch.autograd.grad(loss, list(self.params.values()),
                                        allow_unused=True)
        with torch.no_grad():
            for (k, p), g in zip(self.params.items(), grads):
                self.out_params[k].copy_(_update(k, p, g, self.lr))
            for f in _ARRAYS:
                self.out_state[f].copy_(getattr(st, f))
            self.out_loss.copy_(loss)

    def _captured(self) -> torch.cuda.CUDAGraph:
        """The graph of one step for the baked-in values, captured on first
        use."""
        if self._graph is not None:
            return self._graph
        with span("capture") as timed:
            # the warm-up's step (it also starts autograd's device thread)
            # goes into the output buffers, which the replay overwrites
            self._graph, self._per_replay = capture(
                self._body, self._body, "training step: the step", COUNTED)
            self.captures += 1
            torch.cuda.synchronize()
        self.capture_ms = timed.ms
        return self._graph


#: the step object of each device (its buffers and graph are those of the
#: last baked-in values)
_STEPS: Dict[torch.device, _Step] = {}
