"""rayzath_tpu_torch — the PyTorch/CUDA port of rayzath_tpu.

A second package beside the JAX reference ``rayzath_tpu``, with the same
module layout and names. Host layers (models, scenes, BVH and cluster-table
builds) are jax-free NumPy copies of the reference's; device code is plain
torch, and the two traversal kernels of the render path are hand-written
CUDA for Hopper (``csrc/``). Its front ends (``Engine``, ``headless``,
``viewer``, ``editor``, ``python -m rayzath_tpu_torch``) and the row-band
runtime over several devices (``parallel/``) mirror the JAX package's. It
imports torch and numpy, never jax or flax.

TF32 is switched off for float32 matrix products and cuDNN convolutions:
TF32 keeps about three decimal digits, which moves hit ids at triangle
edges. The port's traversal runs no matrix product, but any later torch
matmul on ray geometry must stay in IEEE float32.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .engine import (Engine, Renderer, RenderConfig, Tracing,  # noqa: E402
                     LightSampling)
from .models import (World, Material, Mesh, Camera, SpotLight,  # noqa: E402
                     DirectLight, Instance, Group, Texture, NormalMap,
                     MetalnessMap, RoughnessMap, EmissionMap)
from . import scenes  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Engine", "Renderer", "RenderConfig", "Tracing", "LightSampling",
    "World", "Material", "Mesh", "Camera", "SpotLight", "DirectLight",
    "Instance", "Group", "Texture", "NormalMap", "MetalnessMap",
    "RoughnessMap", "EmissionMap", "scenes",
]
