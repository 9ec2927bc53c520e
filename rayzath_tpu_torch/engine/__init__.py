from .config import RenderConfig, Tracing, LightSampling
from .renderer import Renderer, CameraView
from .engine import Engine

__all__ = ["RenderConfig", "Tracing", "LightSampling", "Renderer", "CameraView",
           "Engine"]
