"""Tone mapping / final color (reference cuda_postprocess_kernel.cu:17-58).

Counterpart of ``rayzath_tpu/ops/tonemap.py``. ``final_color`` divides the
accumulated radiance by the sample count stored in the alpha channel, scales
by aperture area x exposure x 1e5 sensitivity, then applies the
Reinhard-like "Hyper" operator v/(v+1). ACES is provided for parity.
"""
from __future__ import annotations

import torch

PI = 3.141592653589793


def tonemap_hyper(v):
    return v / (v + 1.0)


def tonemap_aces(v):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((v * (v * a + b)) / (v * (v * c + d) + e), 0.0, 1.0)


def final_color(accum, aperture, exposure_time, operator: str = "hyper"):
    """accum [H,W,4] (rgb sum, alpha = sample count) -> tone-mapped rgb [H,W,3]."""
    samples = accum[..., 3:4]
    pixel = accum[..., :3] / torch.where(samples == 0.0, torch.ones_like(samples),
                                         samples)
    pixel = pixel * (PI * aperture * aperture) * exposure_time * 1.0e5
    if operator == "aces":
        return tonemap_aces(pixel)
    return tonemap_hyper(pixel)


def to_u8(rgb):
    return torch.clamp(rgb * 255.0, 0.0, 255.0).to(torch.uint8)
