"""Multi-device scaling measurement (rays/s and efficiency at N devices).

Counterpart of ``rayzath_tpu/parallel/scaling.py``: ``measure_scaling``
renders the same progressive workload split into row bands over 1, 2, ...,
N devices (``parallel/mesh.py``, scene replicated) and reports rays/s and
efficiency relative to linear scaling from the first device count. By
default the devices are every CUDA card of the host (``--scaling`` of
``python -m rayzath_tpu_torch``), so a one-card host reports n = 1 only.
Passing the same device several times runs that many bands on it, which
checks the harness but measures no scaling.

Multi-process scaling is ``parallel/distributed.py``'s ``--bench`` under
``torchrun``.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import torch

from ..engine.config import RenderConfig, Tracing
from ..engine.state import init_state
from ..models.device_scene import compile_world, compile_camera
from ..ops import rng
from .mesh import make_mesh, sharded_render_steps


def _sync(mesh) -> None:
    for dev in dict.fromkeys(mesh):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def measure_scaling(scene_fn: Optional[Callable] = None,
                    n_devices_list: Optional[Sequence[int]] = None,
                    rpp: int = 64, size: int = 256, max_depth: int = 8,
                    repeats: int = 3, devices: Optional[Sequence] = None
                    ) -> List[dict]:
    """Returns one dict per device count: {n, rays_per_s, efficiency}.
    ``devices``: the devices to split over (default: every card, raising
    without one)."""
    if scene_fn is None:
        from .. import scenes
        scene_fn = scenes.cornell_box
    devs = make_mesh(devices)
    if n_devices_list is None:
        n_devices_list = sorted({n for n in (1, 2, 4, 8, len(devs))
                                 if n <= len(devs)})
    world = scene_fn(size, size)
    cfg = RenderConfig(tracing=Tracing(max_depth=max_depth, rpp=rpp))
    scene = compile_world(world, device=devs[0])
    cam = compile_camera(world.cameras[0], devs[0])
    key = rng.key(0)

    results: List[dict] = []
    base = None
    for n in n_devices_list:
        if size % n:
            raise ValueError(f"image height {size} not divisible by {n}")
        mesh = devs[:n]
        sharded_render_steps(scene, cam, cfg, init_state(size, size, devs[0]),
                             key, rpp, mesh)                  # warm-up
        _sync(mesh)
        t0 = time.perf_counter()
        for _ in range(repeats):
            sharded_render_steps(scene, cam, cfg,
                                 init_state(size, size, devs[0]), key, rpp,
                                 mesh)
        _sync(mesh)
        dt = (time.perf_counter() - t0) / repeats
        rps = rpp * size * size / dt
        if base is None:
            base = rps
        results.append({
            "n": n,
            "rays_per_s": rps,
            "efficiency": rps / (base * n / n_devices_list[0]),
        })
    return results


def format_report(results: List[dict]) -> str:
    lines = ["devices | Mrays/s | scaling efficiency"]
    for r in results:
        lines.append(f"{r['n']:7d} | {r['rays_per_s'] / 1e6:7.2f} | "
                     f"{r['efficiency'] * 100.0:5.1f}%")
    return "\n".join(lines)
