from .config import RenderConfig, Tracing, LightSampling
from .renderer import Renderer, CameraView

__all__ = ["RenderConfig", "Tracing", "LightSampling", "Renderer", "CameraView"]
