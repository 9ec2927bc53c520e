"""The training cell: textured_room at a given size, depth 3, 4 passes per
step, remat, lr 0.01, against the same scene with its panel's emission
halved.

:func:`train_setup` builds the scene, camera, config and target;
:func:`timed_steps` runs a first step and :data:`TRAIN` ``["steps"]`` timed
steps of a ``training_step``-like function, each from the previous one's
scene, and records for every step whether all :data:`DIFF_PARAMS
<rayzath_tpu_torch.parallel.train.DIFF_PARAMS>` stayed finite and how far
the colour atlas moved.

Used by ``chip_smoke.py`` phase 5 and ``tools/profile_torch.py --train``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import scenes
from ..engine.config import RenderConfig, Tracing
from ..engine.integrator import render_steps
from ..engine.state import init_state
from ..models.device_scene import compile_camera, compile_world
from ..ops import rng
from ..parallel.train import DIFF_PARAMS

TRAIN = dict(depth=3, passes=4, lr=0.01, seed=11, steps=3)


def train_setup(dev, res: int) -> dict:
    """textured_room at ``res``^2, depth 3, and its target: the mean image
    of 4 passes (seed 11) of the same scene with the panel's emission
    halved (with 2 passes the panel never enters the image: pass 0 traces
    the placeholder rays)."""
    world = scenes.textured_room(res, res)
    scene = compile_world(world, device=dev)
    cam = compile_camera(world.cameras[0], dev)
    cfg = RenderConfig(tracing=Tracing(max_depth=TRAIN["depth"]))
    panel = [m.name for m in world.materials].index("panel") + 2
    emission = scene.mat_emission.clone()
    emission[panel] *= 0.5
    with torch.no_grad():
        st = render_steps(dataclasses.replace(scene, mat_emission=emission), cam,
                          cfg, init_state(res, res, dev), rng.key(TRAIN["seed"]),
                          TRAIN["passes"])
    target = st.accum[..., :3] / torch.clamp(st.accum[..., 3:4], min=1.0)
    return dict(scene=scene, cam=cam, cfg=cfg, target=target, res=res)


def step_call(step, setup: dict, scene, dev):
    """One training step ``step`` (a ``training_step``-like function) from
    a fresh state with the cell's settings."""
    res = setup["res"]
    return step(scene, setup["cam"], setup["cfg"], init_state(res, res, dev),
                TRAIN["seed"], setup["target"], TRAIN["lr"], TRAIN["passes"],
                remat=True)


def step_check(before, after) -> dict:
    """Whether every parameter of the updated scene ``after`` is finite, and
    the max |change| of its colour atlas from ``before``."""
    return {"finite": all(bool(torch.isfinite(getattr(after, k)).all())
                          for k in DIFF_PARAMS),
            "atlas_step": float((after.color_atlas - before.color_atlas)
                                .abs().max())}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_steps(step, setup: dict, dev, steps: int = TRAIN["steps"]) -> dict:
    """A first step (a warm-up, or the compiled step's capture), then
    ``steps`` timed steps, each from the previous one's scene: s per step
    (host clock to a synchronize), the losses, :func:`step_check` of every
    step (the first included; taken after the step's time), the peak GiB
    from the first step on, the first step's (scene, loss) and the last
    scene."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    scene, _, loss = step_call(step, setup, setup["scene"], dev)
    _sync(dev)
    rec = {"first_s": time.perf_counter() - t0, "seconds": [],
           "losses": [float(loss)], "first": (scene, loss),
           "checks": [step_check(setup["scene"], scene)]}
    for _ in range(steps):
        t0 = time.perf_counter()
        new, _, loss = step_call(step, setup, scene, dev)
        _sync(dev)
        rec["seconds"].append(time.perf_counter() - t0)
        rec["losses"].append(float(loss))
        rec["checks"].append(step_check(scene, new))
        scene = new
    rec["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if dev.type == "cuda" else None)
    rec["scene"] = scene
    return rec
