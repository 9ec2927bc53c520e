"""Camera ray generation on torch tensors.

Counterpart of ``rayzath_tpu/ops/camera.py``, which mirrors the reference
``Cuda::Camera::generateRay`` (cuda_camera.cuh:335-379): pinhole direction
from the pixel center, anti-aliasing jitter (both axes use 0.5/width, a
reference quirk kept for parity), thin-lens aperture sampling toward the
focal point, then camera rotation + translation. ``simple_ray`` mirrors
``generateSimpleRay`` (no jitter/aperture; used for picking).
"""
from __future__ import annotations

import torch

from .vec import normalize, TWO_PI


def pixel_grid(width: int, height: int, row0=0, device=None):
    """Flat pixel coordinates [R,2] (x, y) in row-major order, R = W*height;
    ``row0`` offsets the y coordinates (a band of rows of a larger image)."""
    y = torch.arange(height, dtype=torch.float32, device=device) + row0
    x = torch.arange(width, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)


def _rotate(v, rot):
    """``v @ rot.T`` for [R,3] rows, summed over the axes in order."""
    return (v[:, 0:1] * rot[:, 0] + v[:, 1:2] * rot[:, 1]
            + v[:, 2:3] * rot[:, 2])


def _pinhole(cam, pixels):
    # made on the device by a fill, not copied from the host (a copy cannot
    # be captured into a CUDA graph); float32 division, as in the JAX package
    w = torch.full((), float(cam.width), dtype=torch.float32, device=pixels.device)
    h = torch.full((), float(cam.height), dtype=torch.float32, device=pixels.device)
    aspect = w / h
    tana = torch.tan(cam.fov * 0.5)
    dx = ((pixels[:, 0] + 0.5) / w - 0.5) * tana
    dy = ((pixels[:, 1] + 0.5) / h - 0.5) * (-tana / aspect)
    return w, dx, dy


def generate_rays(cam, pixels, u):
    """Thin-lens camera rays.

    cam: TorchCamera; pixels [R,2] float; u [R,4] uniforms
    (jitter_x, jitter_y, aperture_angle, aperture_radius).
    Returns (origin [R,3], direction [R,3]).
    """
    w, dx, dy = _pinhole(cam, pixels)
    # AA jitter: both axes scaled by 0.5/width (reference cuda_camera.cuh:351-355)
    dx = dx + (0.5 / w) * (u[:, 0] * 2.0 - 1.0)
    dy = dy + (0.5 / w) * (u[:, 1] * 2.0 - 1.0)
    direction = torch.stack([dx, dy, torch.ones_like(dx)], dim=1)

    focal_point = direction * cam.focal_distance
    ap_angle = u[:, 2] * TWO_PI
    ap_radius = torch.sqrt(u[:, 3]) * cam.aperture
    origin = torch.stack([ap_radius * torch.sin(ap_angle),
                          ap_radius * torch.cos(ap_angle),
                          torch.zeros_like(ap_angle)], dim=1)
    direction = focal_point - origin

    origin = _rotate(origin, cam.rot) + cam.position
    direction = normalize(_rotate(direction, cam.rot))
    return origin, direction


def simple_ray(cam, pixels):
    """Pinhole ray through the pixel center (reference generateSimpleRay,
    cuda_camera.cuh:305-328)."""
    _, dx, dy = _pinhole(cam, pixels)
    direction = torch.stack([dx, dy, torch.ones_like(dx)], dim=1)
    origin = cam.position.expand(direction.shape[0], 3)
    direction = normalize(_rotate(direction, cam.rot))
    return origin, direction


def sky_texcrd(direction):
    """Sky-sphere texture coordinates from a direction
    (reference World::calculateTexcrd, cuda_world.cuh:121-126)."""
    u = -(0.5 + torch.atan2(direction[:, 2], direction[:, 0]) / TWO_PI)
    v = 0.5 + torch.asin(torch.clamp(direction[:, 1], -1.0, 1.0)) / torch.pi
    return torch.stack([u, v], dim=1)
