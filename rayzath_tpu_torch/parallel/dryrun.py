"""One render cycle on one device, and a training step over several bands.

Counterpart of the repository's ``__graft_entry__.py`` for the port:

* :func:`entry` — (fn, example_args) of one 4-bounce render cycle of
  ``cornell_box(128, 128)``;
* :func:`dryrun_multichip` — one :func:`sharded_training_step` (the
  differentiable inverse render) over ``n`` row bands of
  ``cornell_box(8n, 8n)``, which must give a finite loss.

Run ``python -m rayzath_tpu_torch.parallel.dryrun`` on a card host: it runs
:func:`entry`'s cycle, then the dry run over every card.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from .. import scenes
from ..engine.config import RenderConfig
from ..engine.integrator import render_steps
from ..engine.state import init_state
from ..models.device_scene import compile_world, compile_camera
from ..ops import rng
from ..utils.device import DEFAULT
from .mesh import make_mesh, sharded_training_step


def entry(device=DEFAULT):
    """(fn, example_args): one 4-bounce render cycle of the Cornell box
    wavefront integrator at 128^2 on ``device``."""
    world = scenes.cornell_box(128, 128)
    cfg = RenderConfig()
    scene = compile_world(world, device=device)
    cam = compile_camera(world.cameras[0], device)
    state = init_state(128, 128, device)
    key = rng.key(0)

    def fn(scene, cam, state, key):
        return render_steps(scene, cam, cfg, state, key, 4)

    return fn, (scene, cam, state, key)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> float:
    """One training step over ``n_devices`` row bands on the first
    ``n_devices`` of ``devices`` (default: the cards of the host, raising
    with fewer); returns the loss, raising unless it is finite."""
    devs = make_mesh(devices)[:n_devices]
    if len(devs) != n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devs)}")
    h = w = 8 * n_devices                  # tiny; height divisible by n
    world = scenes.cornell_box(w, h)
    cfg = RenderConfig()
    scene = compile_world(world, device=devs[0])
    cam = compile_camera(world.cameras[0], devs[0])
    target = torch.zeros((h, w, 3), dtype=torch.float32, device=devs[0])
    _, _, loss = sharded_training_step(scene, cam, cfg,
                                       init_state(w, h, devs[0]), 0, target,
                                       1e-3, 2, devs)
    loss = float(loss)
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return loss


if __name__ == "__main__":
    f, args = entry()
    f(*args)
    torch.cuda.synchronize()
    print("entry() runs OK")
    n = torch.cuda.device_count()
    print(f"dryrun_multichip({n}) OK, loss {dryrun_multichip(n):.6f}")
