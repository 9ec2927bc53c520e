"""The render cycle (``engine/cycle.py``) held to eager ``render_steps``.

:func:`against_eager` drives a ``Renderer`` (whose views advance through
their render cycles: captured CUDA graphs on a card, the eager in-place
pass on the CPU) and the eager, non-mutating ``render_steps`` through the
same script, from the same seed, and holds the two states equal bit for
bit after every step:

1. renders of ``rpps`` passes in turn (1, 3, 2 by default);
2. a camera move under ``temporal_blend > 0``: the eager side reprojects
   the previous accumulation (``ops/reproject.py``) into a fresh state, as
   the renderer must before its static buffers are reset, then one pass;
3. a material edit, which recompiles the scene (a new graph on a card) and
   restarts the accumulation, then two passes;
4. a checkpoint saved by that renderer, loaded into a fresh one, and two
   more passes.

Used by ``tests/test_torch_render_cycle.py``, ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` phase 7.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..engine.integrator import render_steps
from ..engine.renderer import Renderer
from ..engine.state import _ARRAYS, init_state
from ..models.device_scene import compile_camera
from ..ops import rng
from ..ops.reproject import primary_hits, reproject_accum


def assert_same_state(label: str, got, ref) -> None:
    """Every array of two RenderStates equal bit for bit, and their pass
    indices equal; raises AssertionError naming the first that differs."""
    for f in _ARRAYS:
        a, b = getattr(got, f), getattr(ref, f)
        if a.shape != b.shape or not torch.equal(a, b):
            n = int((a != b).sum()) if a.shape == b.shape else -1
            raise AssertionError(f"{label}: {f} differs from eager "
                                 f"render_steps on {n} of {b.numel()} values")
    if got.pass_idx != ref.pass_idx:
        raise AssertionError(f"{label}: pass_idx {got.pass_idx} against eager "
                             f"{ref.pass_idx}")


def against_eager(world, cfg, device, seed: int = 0, rpps=(1, 3, 2)) -> dict:
    """Run the module's script on ``world`` (its first camera) and return
    ``{"stages": [(label, pass_idx, samples)], "captures": [...]}``, the
    captures each renderer's view had made after each stage (0 where its
    passes run eagerly). Raises AssertionError where the renderer's state
    leaves eager ``render_steps``'s."""
    cam = world.cameras[0]
    key = rng.key(seed)
    w, h = cam.width, cam.height
    r = Renderer(world, cfg, seed=seed, device=device)
    scene = r.update_scene()
    tcam = compile_camera(cam, device)
    st = init_state(w, h, device)
    stages, captures = [], []

    def check(label, renderer, ref):
        view = renderer.views[id(cam)]
        assert_same_state(label, view.state, ref)
        stages.append((label, ref.pass_idx,
                       float(view.state.accum[..., 3].sum())))
        captures.append(view.cycle.captures)

    with torch.no_grad():
        for n in rpps:
            r.render(rpp=n)
            st = render_steps(scene, tcam, cfg, st, key, n)
            check(f"rpp {n}", r, st)

        prev = tcam
        cam.position = np.asarray(cam.position, np.float32) + np.float32(
            [0.02, 0.0, 0.0])
        cam.touch()
        r.render(rpp=1)
        tcam = compile_camera(cam, device)
        fresh = init_state(w, h, device)
        if cam.temporal_blend > 0.0:
            depth, space = primary_hits(scene, tcam, cfg)
            accum = reproject_accum(space, prev, st.accum, st.depth_buf,
                                    cam.temporal_blend)
            fresh = fresh.replace(accum=accum, depth_buf=depth,
                                  space_buf=space)
        st = render_steps(scene, tcam, cfg, fresh, key, 1)
        check("camera move", r, st)

        mat = world.materials[len(world.materials) - 1]
        mat.roughness = 0.5 if mat.roughness < 0.25 else 0.1
        r.render(rpp=2)
        if r.scene is scene:
            raise AssertionError("material edit: the scene was not recompiled")
        scene = r.scene
        st = render_steps(scene, tcam, cfg, init_state(w, h, device), key, 2)
        check("material edit", r, st)

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "checkpoint.npz")
            r.save_checkpoint(path)
            resumed = Renderer(world, cfg, seed=seed, device=device)
            resumed.load_checkpoint(path)
        resumed.render(rpp=2)
        st = render_steps(scene, tcam, cfg, st, key, 2)
        check("checkpoint resume", resumed, st)
    return {"stages": stages, "captures": captures}
