"""Multi-device rendering and training: row-band sharding, multi-process
rendering, scaling measurement and the differentiable training step (the
counterpart of ``rayzath_tpu/parallel``).

The parallel axis of a path tracer is the ray/pixel wavefront: each device
renders a band of image rows with the scene replicated, and only the
joined image and the parameter gradients cross devices.
"""
from .mesh import (make_mesh, RAYS_AXIS, shard_state, replicate_scene,
                   sharded_render_steps, sharded_training_step)
from .train import DIFF_PARAMS, training_step, image_loss
from .scaling import measure_scaling, format_report

__all__ = [
    "make_mesh", "RAYS_AXIS", "shard_state", "replicate_scene",
    "sharded_render_steps", "sharded_training_step", "training_step",
    "image_loss", "measure_scaling", "format_report", "DIFF_PARAMS",
]
