"""The donated, compiled render cycle: one captured CUDA graph per pass.

Counterpart of the JAX package's ``render_steps = jax.jit(
_render_steps_impl, donate_argnames=("state",))``
(``rayzath_tpu/engine/integrator.py``). There a render call's passes are
one compiled program that rewrites the donated state in its own memory,
with the pass index a device int32 folded into the key on the device, so
the call returns at once and the host blocks only to fetch results.

A :class:`RenderCycle` keeps one camera view's render state, camera, key
words and pass counter in static device buffers and advances them in place:

* **On a CUDA device** one bounce pass is captured into a CUDA graph
  (``torch.cuda.CUDAGraph``), together with the copy of the pass's outputs
  back into the static state and the pass counter's increment. ``run(n)``
  replays the graph ``n`` times and returns once the replays are enqueued.
  The draw reads the pass counter on the device (``rng.DeviceKey``, the
  keyed entry of ``csrc/threefry.cu``), so every replay draws its own pass.
* **On the CPU** the same object runs the pass eagerly with the same
  in-place buffer handling: the plain path that the CPU tests hold, bit for
  bit, to eager ``render_steps``.

Two routes run eagerly on a CUDA device, by design: a pass that reads
device values on the host (the skip-link walk of
``RenderConfig(packet_traversal=False)`` reads its active ray count every
8 steps, ``integrator.host_reads``), and a call with grad enabled, which
records an autograd graph (the training step runs ``render_steps``).

A graph bakes in the scene's tensors, the config, the image size, ``row0``
and the draw's stream count, so it is captured again when one of them
changes (``update_scene`` recompiles the scene on a world edit). A camera
move, a reset or a loaded checkpoint copies new values into the static
buffers and replays the same graph. Capture never falls back: when capture
or a replay fails, :meth:`RenderCycle.run` raises ``RuntimeError``.

A captured kernel launches on every replay, but its wrapper's Python
counters (``launches``, and B1-B4's ``rays``: the registry
``ops/_kernels.py`` ``COUNTED``) ran only while the pass was captured. The
cycle records what each counter gained over the captured pass and adds it
per replay, so the counters count the launches that ran. B1-B4's
device-side work counters (``traverse_cluster.WorkCounter``) are added to
by the kernels themselves, on every replay.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.device_scene import TorchCamera, TorchScene
from ..ops import _kernels, rng
from ..utils.timing import span
from .config import RenderConfig
from .integrator import bounce_step, host_reads, n_streams
from .state import _ARRAYS, RenderState, init_state

_CAMERA = ("position", "rot", "fov", "near_far", "focal_distance", "aperture",
           "exposure_time")


def capture(warm_up, body, what: str):
    """Capture ``body()`` into a CUDA graph on a side stream of the current
    device, after ``warm_up()`` there, as PyTorch's graph rules ask (the
    first launch of every kernel, and the kernel build, run outside the
    capture); ``thread_local`` capture, so other threads, autograd's device
    thread among them, may launch into the capturing stream. The host
    counters of every kernel wrapper (``_kernels.COUNTED``) are left as
    they were before the capture. Returns (graph, ((wrapper, counter, gain
    per replay), ...)) for :func:`advance`; raises ``RuntimeError`` naming
    ``what`` when the capture fails."""
    counters = [(f, c) for f, names in _kernels.COUNTED.items()
                for c in names]
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        warm_up()
        before = [getattr(f, c) for f, c in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                body()
        except RuntimeError as e:
            raise RuntimeError(f"{what} could not be captured into a CUDA "
                               f"graph: {e}") from e
        finally:
            gained = [getattr(f, c) - b for (f, c), b in zip(counters, before)]
            for (f, c), b in zip(counters, before):
                setattr(f, c, b)    # capture launches nothing
    current.wait_stream(side)       # the warm-up read the static buffers
    return graph, tuple((f, c, k) for (f, c), k in zip(counters, gained) if k)


def advance(per_replay, n: int) -> None:
    """Add ``n`` replays' gains of :func:`capture` to the host counters."""
    for f, c, k in per_replay:
        setattr(f, c, getattr(f, c) + n * k)


def _int32(v: int) -> int:
    """``v`` wrapped to int32, as the device pass counter holds it."""
    return ((int(v) + 2 ** 31) % 2 ** 32) - 2 ** 31


class RenderCycle:
    """One camera view's render state, camera and pass counter in static
    buffers on ``device``, advanced in place by :meth:`run`."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.state: Optional[RenderState] = None
        self.camera: Optional[TorchCamera] = None
        self._key: Optional[rng.Key] = None
        self._words = torch.zeros(2, dtype=torch.int32, device=self.device)
        self._pass = torch.zeros((), dtype=torch.int32, device=self.device)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_scene: Optional[TorchScene] = None
        self._graph_key: Optional[tuple] = None
        self._per_replay: tuple = ()    # (wrapper, counter, gain per replay)
        #: captures made (each one's host time, its warm-up pass included,
        #: is the ``capture`` span of ``utils/timing.totals``)
        self.captures = 0

    # -- static buffers -------------------------------------------------------
    def load(self, state: RenderState) -> None:
        """Copy ``state`` into the static state (made on first use and
        whenever the image size changes)."""
        st = self.state
        if st is None or (st.width, st.height) != (state.width, state.height):
            self._drop_graph()
            self.state = state.replace(**{f: getattr(state, f).clone()
                                          for f in _ARRAYS})
        else:
            for f in _ARRAYS:
                getattr(st, f).copy_(getattr(state, f))
            st.pass_idx = state.pass_idx
        self._pass.fill_(_int32(state.pass_idx))

    def reset(self, width: int, height: int) -> None:
        """A fresh progressive state (``init_state``) in the static
        buffers."""
        self.load(init_state(width, height, self.device))

    def set_camera(self, cam: TorchCamera) -> None:
        """Copy a compiled camera into the static camera."""
        c = self.camera
        if c is None or (c.width, c.height) != (cam.width, cam.height):
            self._drop_graph()
            self.camera = dataclasses.replace(
                cam, **{f: getattr(cam, f).clone() for f in _CAMERA})
        else:
            for f in _CAMERA:
                getattr(c, f).copy_(getattr(cam, f))

    # -- passes ---------------------------------------------------------------
    def captures_passes(self, scene: TorchScene, cfg: RenderConfig) -> bool:
        """Whether :meth:`run` replays a captured graph (else it runs the
        passes eagerly)."""
        return (self.device.type == "cuda" and not torch.is_grad_enabled()
                and not host_reads(cfg, scene))

    def run(self, scene: TorchScene, cfg: RenderConfig, key: rng.Key, n: int,
            row0: int = 0) -> None:
        """Advance the static state by ``n`` passes under the render key
        ``key`` (``rng.key(seed)``): the passes of ``render_steps(scene,
        camera, cfg, state, key, n, row0)``, in place."""
        if n <= 0:
            return
        if key != self._key:        # in place: a captured graph reads it
            self._words.copy_(rng.key_words(key, "cpu"))
            self._key = tuple(key)
        if self.captures_passes(scene, cfg):
            # the graph launches on the current stream of the current
            # device: the view's, whatever device the calling thread has
            with torch.cuda.device(self.device):
                graph = self._captured(scene, cfg, row0)
                with span("replay"):
                    try:
                        for _ in range(n):
                            graph.replay()
                    except RuntimeError as e:
                        raise RuntimeError(f"render cycle: a replay failed: "
                                           f"{e}") from e
            advance(self._per_replay, n)
        else:
            with span("replay"):
                for _ in range(n):
                    self._step(scene, cfg, row0)
        self.state.pass_idx += n

    def _step(self, scene, cfg, row0) -> None:
        """One pass from the static buffers back into them."""
        out = bounce_step(scene, self.camera, cfg, self.state,
                          rng.DeviceKey(self._words, self._pass), row0=row0)
        for f in _ARRAYS:
            getattr(self.state, f).copy_(getattr(out, f))
        self._pass.add_(1)

    def _drop_graph(self) -> None:
        """Forget the graph: it read buffers that are being replaced."""
        self._graph = self._graph_scene = self._graph_key = None

    def _captured(self, scene, cfg, row0) -> torch.cuda.CUDAGraph:
        """The graph of one pass for these inputs, captured if the one held
        was captured for others."""
        st = self.state
        key = (cfg, st.width, st.height, row0, n_streams(cfg, scene))
        if (self._graph is not None and scene is self._graph_scene
                and key == self._graph_key):
            return self._graph
        self._drop_graph()      # and its memory pool, before capturing anew
        with span("capture"):
            # the warm-up pass's result is dropped: the static state stays
            graph, self._per_replay = capture(
                lambda: bounce_step(scene, self.camera, cfg, st,
                                    rng.DeviceKey(self._words, self._pass),
                                    row0=row0),
                lambda: self._step(scene, cfg, row0), "render cycle: the pass")
            self._graph, self._graph_scene, self._graph_key = graph, scene, key
            self.captures += 1
            torch.cuda.synchronize()
        return graph
