"""Training on top of the differentiable integrator (the counterpart of
``rayzath_tpu/parallel``; the multi-GPU mesh is ROADMAP A14)."""
from .train import DIFF_PARAMS, image_loss, training_step

__all__ = ["DIFF_PARAMS", "image_loss", "training_step"]
