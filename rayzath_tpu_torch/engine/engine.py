"""Engine facade (reference RayZath/rayzath.hpp:45-60).

Counterpart of ``rayzath_tpu/engine/engine.py``: owns the World, the
RenderConfig and the Renderer. The reference's CUDA-vs-CPU backend switch
becomes the renderer's device. Unlike the JAX facade, which falls back to
the CPU when no accelerator initializes, the port's runs on the card by
default and raises without one; ``device="cpu"`` is the caller's explicit
request for the plain PyTorch versions (as the tests make it).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.world import World
from ..utils.device import DEFAULT, resolve
from .config import RenderConfig
from .renderer import Renderer

_instance: Optional["Engine"] = None


def pick_device(device=DEFAULT) -> torch.device:
    """The device the engine renders on: ``device`` (the card by default),
    raising ``RuntimeError`` when it names a card and there is none."""
    return resolve(device)


class Engine:
    def __init__(self, config: Optional[RenderConfig] = None, seed: int = 0,
                 device=DEFAULT):
        self._device = pick_device(device)
        self._world = World()
        self._config = config or RenderConfig()
        self._renderer = Renderer(self._world, self._config, seed=seed,
                                  device=self._device)

    @staticmethod
    def instance() -> "Engine":
        global _instance
        if _instance is None:
            _instance = Engine()
        return _instance

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def world(self) -> World:
        return self._world

    @world.setter
    def world(self, world: World) -> None:
        self._world = world
        self._renderer = Renderer(world, self._config, seed=0,
                                  device=self._device)

    @property
    def render_config(self) -> RenderConfig:
        return self._config

    @render_config.setter
    def render_config(self, cfg: RenderConfig) -> None:
        self._config = cfg
        self._renderer.config = cfg

    @property
    def renderer(self) -> Renderer:
        return self._renderer

    def render_world(self, block: bool = True, rpp: Optional[int] = None) -> None:
        """One render cycle over all enabled cameras (reference
        Engine::renderWorld, rayzath.cpp:64-94)."""
        self._renderer.render(rpp=rpp, block=block)

    def debug_info(self) -> str:
        return self._renderer.debug_info()
