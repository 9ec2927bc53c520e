"""Row-band sharding of the render wavefront over several devices.

Counterpart of ``rayzath_tpu/parallel/mesh.py`` without ``shard_map``:
rays are row-major over the image (R = H*W), so splitting every [R, ...]
buffer and every [H, W, ...] buffer of a :class:`RenderState` into ``n``
equal blocks along axis 0 gives ``n`` bands of whole image rows. A "mesh"
is an ordered list of torch devices: band ``i`` renders rows
``[i*H/n, (i+1)*H/n)`` on ``mesh[i]``, with ``row0 = i*H/n``, so the
row-keyed random streams (``ops/rng.py``) and the pixel grid make each band
draw what the same rows of an unsharded render draw. The scene and camera
are copied once to each distinct device; no data crosses devices inside a
render, only when the bands are joined (and, for a training step, when the
gradients are summed on the first device).

A device may repeat, so one device (the CPU in the tests, or one card) can
run ``n`` bands. The bands run one after another from the calling thread;
on several cards the launches are asynchronous, so bands overlap between
host synchronizations.

Requires H % n == 0 (:func:`shard_state` raises otherwise).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..engine.integrator import render_steps
from ..engine.state import RenderState, _ARRAYS
from ..utils.device import DEFAULT, resolve
from .train import DIFF_PARAMS, _project, image_loss

RAYS_AXIS = "rays"


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The ordered band devices: the given ones (a device may repeat), or by
    default every CUDA device, raising ``RuntimeError`` without one. A
    ``"cuda"`` without an index becomes the current CUDA device."""
    if devices is None:
        resolve(DEFAULT)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        dev = resolve(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh.append(dev)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def on_device(dev: torch.device):
    """``torch.cuda.device(dev)`` for a card, else a null context."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def to_device(tree, dev: torch.device):
    """A copy of a dataclass (``TorchScene``, ``TorchCamera``,
    ``RenderState``) with every tensor field on ``dev`` (fields already
    there are shared, not copied)."""
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).to(dev)
        for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


def shard_state(state: RenderState, mesh: Sequence[torch.device]) -> List[RenderState]:
    """Split a RenderState into ``len(mesh)`` row bands, band ``i`` on
    ``mesh[i]`` with ``height = H / n``."""
    n = len(mesh)
    if state.height % n:
        raise ValueError(f"image height {state.height} not divisible by "
                         f"{n} devices")
    parts = {f: getattr(state, f).tensor_split(n) for f in _ARRAYS}
    return [state.replace(height=state.height // n,
                          **{f: parts[f][i].to(dev) for f in _ARRAYS})
            for i, dev in enumerate(mesh)]


def unshard_state(bands: Sequence[RenderState], dev: torch.device) -> RenderState:
    """Join row bands (top to bottom) into one RenderState on ``dev``."""
    joined = {f: torch.cat([getattr(b, f).to(dev) for b in bands])
              for f in _ARRAYS}
    return bands[0].replace(height=sum(b.height for b in bands), **joined)


def replicate_scene(tree, mesh: Sequence[torch.device]) -> Dict[torch.device, object]:
    """{device: copy of ``tree`` on it} for each distinct device of the
    mesh (a scene or camera is placed once per device)."""
    return {dev: to_device(tree, dev) for dev in dict.fromkeys(mesh)}


def sharded_render_steps(scene, cam, cfg, state: RenderState, key, n_steps: int,
                         mesh: Optional[Sequence[torch.device]] = None) -> RenderState:
    """Run ``n_steps`` bounce passes with the wavefront split into row bands
    over ``mesh`` (default: every card). Each band runs the port's
    ``render_steps`` at ``row0 = i * H / n`` on its device; the result is
    the joined state on ``mesh[0]``. ``state`` is not mutated. On the CPU
    (plain versions, ray by ray) the result equals the unsharded render bit
    for bit."""
    mesh = make_mesh(mesh)
    scenes, cams = replicate_scene(scene, mesh), replicate_scene(cam, mesh)
    out = []
    for i, (dev, band) in enumerate(zip(mesh, shard_state(state, mesh))):
        with on_device(dev):
            out.append(render_steps(scenes[dev], cams[dev], cfg, band, key,
                                    n_steps, row0=i * band.height))
    return unshard_state(out, mesh[0])


def sharded_value_and_grad(scene, cam, cfg, state: RenderState, seed: int,
                           target, n_steps: int,
                           mesh: Optional[Sequence[torch.device]] = None,
                           remat: bool = False):
    """``image_loss`` and its gradients with respect to the
    :data:`DIFF_PARAMS`, computed band by band: each band renders its rows
    (``row0``), takes its share of the loss (its mean squared error times
    its share of the rows, i.e. its sum of squares over H*W*3) and
    differentiates that share on its own device. Returns (loss, {name:
    gradient or None}, post-render state), all on ``mesh[0]`` and
    detached."""
    mesh = make_mesh(mesh)
    scenes, cams = replicate_scene(scene, mesh), replicate_scene(cam, mesh)
    bands = shard_state(state, mesh)
    targets = target.tensor_split(len(mesh))
    dev0 = mesh[0]
    loss = torch.zeros((), dtype=torch.float32, device=dev0)
    grads: Dict[str, Optional[torch.Tensor]] = dict.fromkeys(DIFF_PARAMS)
    out = []
    for i, (dev, band) in enumerate(zip(mesh, bands)):
        params = {k: getattr(scenes[dev], k).detach().requires_grad_(True)
                  for k in DIFF_PARAMS}
        with on_device(dev), torch.enable_grad():
            band_loss, st = image_loss(
                dataclasses.replace(scenes[dev], **params), cams[dev], cfg,
                band, seed, targets[i].to(dev), n_steps, remat=remat,
                row0=i * band.height)
            share = band_loss * (band.height / state.height)
            band_grads = torch.autograd.grad(share, list(params.values()),
                                             allow_unused=True)
        loss = loss + share.detach().to(dev0)
        for k, g in zip(params, band_grads):
            if g is not None:
                g = g.to(dev0)
                grads[k] = g if grads[k] is None else grads[k] + g
        out.append(st.replace(**{f: getattr(st, f).detach() for f in _ARRAYS}))
    return loss, grads, unshard_state(out, dev0)


def sharded_training_step(scene, cam, cfg, state: RenderState, seed: int,
                          target, lr, n_steps: int,
                          mesh: Optional[Sequence[torch.device]] = None,
                          remat: bool = False):
    """``parallel.train.training_step`` over row bands: what GSPMD does for
    the JAX ``training_step`` on a mesh. The gradients of the bands' loss
    shares (:func:`sharded_value_and_grad`) are summed on ``mesh[0]``, then
    one projected SGD update is applied there. Returns (updated scene,
    post-render state, loss), on ``mesh[0]`` and detached."""
    mesh = make_mesh(mesh)
    loss, grads, st = sharded_value_and_grad(scene, cam, cfg, state, seed,
                                             target, n_steps, mesh, remat)
    base = to_device(scene, mesh[0])
    with torch.no_grad():
        new = {k: (_project(k, getattr(base, k) - lr * g) if g is not None
                   else getattr(base, k).detach())
               for k, g in grads.items()}
    return dataclasses.replace(base, **new), st, loss
