"""Renderer: per-camera progressive state + render cycles on one device.

Counterpart of ``rayzath_tpu/engine/renderer.py`` (the reference render
orchestration, cuda_engine_core.cu:32-128 + cuda_engine_renderer.cu:73-262):
the world is re-flattened into a TorchScene whenever its content version
changes, each camera keeps its own progressive RenderState, and a render
cycle runs ``rpp`` bounce passes under the renderer's key
(``rng.key(seed)``, as ``jax.random.key(seed)``). When a camera with
``temporal_blend > 0`` moves, its fresh accumulation is seeded by
reprojecting the previous one (``ops/reproject.py``). Everything lives on
``device``: the card by default, the CPU's plain versions with
``device="cpu"`` (``utils/device.py``).

Each camera's view owns a :class:`~.cycle.RenderCycle`, the counterpart of
the JAX package's jitted, donated ``render_steps``: its state lives in
static buffers updated in place, and on a card a render replays one
captured CUDA graph per pass, so ``render(block=False)`` returns once the
replays are enqueued, as the JAX renderer's jitted step does. The state's
arrays are those buffers: a caller that keeps one across a render sees it
change (copy it to keep it).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models.device_scene import (TorchScene, TorchCamera, compile_world,
                                   compile_camera)
from ..models.world import World
from ..utils.device import DEFAULT, resolve
from ..utils.timing import TimeTable
from ..ops import rng
from ..ops.reproject import primary_hits, reproject_accum
from ..ops.tonemap import final_color, to_u8
from .config import RenderConfig
from .cycle import RenderCycle
from .integrator import ray_cast
from .state import RenderState, save_state, load_state


class CameraView:
    """Per-camera progressive render state + counters (the analog of the
    reference's per-camera FrameBuffers/TracingStates). The state and the
    camera the passes read live in the view's render cycle."""

    def __init__(self, camera, device):
        self.camera = camera
        self.device = device
        self.device_camera: Optional[TorchCamera] = None   # last compiled
        self.cycle = RenderCycle(device)
        self.camera_version = -1
        self.ray_count = 0       # rays traced (W*H per bounce pass, as in reference)
        self.pass_count = 0      # bounce passes executed
        # (previous TorchCamera, accum, depth) captured on a camera move,
        # consumed by the renderer's reprojection step
        self.pending_reprojection = None

    @property
    def state(self) -> Optional[RenderState]:
        """The progressive state: the cycle's static buffers."""
        return self.cycle.state

    def ensure(self):
        st = self.state
        if (st is None or self.camera_version != self.camera.version
                or st.width != self.camera.width
                or st.height != self.camera.height):
            if (st is not None and st.width == self.camera.width
                    and st.height == self.camera.height
                    and self.camera.temporal_blend > 0.0):
                # snapshots: the reset below rewrites the static buffers
                self.pending_reprojection = (self.device_camera,
                                             st.accum.clone(),
                                             st.depth_buf.clone())
            self.device_camera = compile_camera(self.camera, self.device)
            self.cycle.set_camera(self.device_camera)
            self.cycle.reset(self.camera.width, self.camera.height)
            self.camera_version = self.camera.version
            self.ray_count = 0
            self.pass_count = 0


class Renderer:
    def __init__(self, world: World, config: Optional[RenderConfig] = None,
                 seed: int = 0, device=DEFAULT):
        self.world = world
        self.config = config or RenderConfig()
        self.key = rng.key(seed)
        self.device = resolve(device)
        self.scene: Optional[TorchScene] = None
        self._scene_version = -1
        self._compile_cache: dict = {}
        self.views: Dict[int, CameraView] = {}
        self.time_table = TimeTable()

    # -- scene mirroring ------------------------------------------------------
    def update_scene(self) -> TorchScene:
        v = self.world.content_version()
        if self.scene is None or v != self._scene_version:
            self.time_table.reset()
            self.scene = compile_world(self.world,
                                       leaf_size=self.config.bvh_leaf_size,
                                       two_level=self.config.two_level,
                                       cache=self._compile_cache,
                                       device=self.device)
            self._scene_version = v
            # a world change invalidates progressive accumulation (reference
            # update-flag path, cuda_engine_renderer.cu:91-113)
            for view in self.views.values():
                if view.state is not None:
                    view.cycle.reset(view.camera.width, view.camera.height)
                    view.ray_count = 0
                    view.pass_count = 0
                    view.pending_reprojection = None  # stale: scene changed
            self.time_table.update("update world")
        return self.scene

    def view(self, camera) -> CameraView:
        cv = self.views.get(id(camera))
        if cv is None:
            cv = CameraView(camera, self.device)
            self.views[id(camera)] = cv
        cv.ensure()
        return cv

    def _camera(self, camera):
        return camera or next(c for c in self.world.cameras if c.enabled)

    # -- rendering ------------------------------------------------------------
    def render(self, camera=None, rpp: Optional[int] = None, block: bool = True):
        """Run one render cycle: ``rpp`` cumulative bounce passes for the camera
        (default: every enabled camera / config rpp). On a card the passes
        replay the view's captured graph (``engine/cycle.py``); with
        ``block=False`` the call returns once they are enqueued."""
        scene = self.update_scene()
        cameras = [camera] if camera is not None else [
            c for c in self.world.cameras if c.enabled]
        n = rpp if rpp is not None else self.config.tracing.rpp
        sync = block and self.device.type == "cuda"
        for cam in cameras:
            cv = self.view(cam)
            if cv.pending_reprojection is not None:
                # temporal reuse across the camera move (reference
                # spacialReprojection, cuda_engine_renderer.cu:139)
                prev_cam, prev_accum, prev_depth = cv.pending_reprojection
                cv.pending_reprojection = None
                t0 = time.perf_counter()
                with torch.no_grad():
                    depth, space = primary_hits(scene, cv.device_camera,
                                                self.config)
                    accum = reproject_accum(space, prev_cam, prev_accum,
                                            prev_depth, cam.temporal_blend)
                cv.cycle.load(cv.state.replace(accum=accum, depth_buf=depth,
                                               space_buf=space))
                if sync:
                    torch.cuda.synchronize(self.device)
                self.time_table.set("temporal reproject",
                                    (time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            with torch.no_grad():       # serving records no autograd graph
                cv.cycle.run(scene, self.config, self.key, n)
            if sync:
                torch.cuda.synchronize(self.device)
            self.time_table.set("trace", (time.perf_counter() - t0) * 1e3)
            cv.pass_count += n
            cv.ray_count += n * cam.width * cam.height

    @torch.no_grad()
    def image_f32(self, camera=None, operator: str = "hyper") -> np.ndarray:
        cv = self.view(self._camera(camera))
        return final_color(cv.state.accum, cv.device_camera.aperture,
                           cv.device_camera.exposure_time,
                           operator).cpu().numpy()

    @torch.no_grad()
    def image(self, camera=None, operator: str = "hyper") -> np.ndarray:
        """Tone-mapped uint8 image [H,W,3] for a camera."""
        cv = self.view(self._camera(camera))
        t0 = time.perf_counter()
        rgb = final_color(cv.state.accum, cv.device_camera.aperture,
                          cv.device_camera.exposure_time, operator)
        out = to_u8(rgb).cpu().numpy()
        self.time_table.set("tone mapping", (time.perf_counter() - t0) * 1e3)
        return out

    def depth(self, camera=None) -> np.ndarray:
        # a copy: the state's buffer changes with the next render
        return self.view(self._camera(camera)).state.depth_buf.cpu().numpy().copy()

    def focus(self, camera, x: int, y: int) -> float:
        """Auto-focus: set the camera's focal distance from the rendered depth
        at a pixel (reference Camera::focus, camera.cpp:80-88). Returns the
        new focal distance."""
        cv = self.view(camera)
        xi = min(max(int(x), 0), camera.width - 1)
        yi = min(max(int(y), 0), camera.height - 1)
        dist = float(cv.state.depth_buf[yi, xi])
        camera.focal_point = (xi, yi)
        if dist > 0.0:
            camera.focal_distance = dist
            camera.touch()
        return camera.focal_distance

    def pick(self, camera, x: int, y: int):
        """Object picking at a pixel; returns (instance_idx, material_idx) or
        (-1, -1) (reference rayCast, cuda_render_kernel.cu:130-144)."""
        scene = self.update_scene()
        cv = self.view(camera)
        return ray_cast(scene, cv.device_camera, self.config, cv.state, x, y)

    # -- checkpointing --------------------------------------------------------
    def save_checkpoint(self, path: str, camera=None) -> None:
        save_state(path, self.view(self._camera(camera)).state)

    def load_checkpoint(self, path: str, camera=None) -> None:
        cam = self._camera(camera)
        # compile the world FIRST: the first update_scene of a fresh renderer
        # resets every view's progressive state, which would wipe the
        # checkpoint loaded below
        self.update_scene()
        cv = self.view(cam)
        cv.cycle.load(load_state(path, self.device))
        cv.pass_count = cv.state.pass_idx
        cv.ray_count = cv.pass_count * cam.width * cam.height

    def debug_info(self) -> str:
        return str(self.time_table)
