"""Spatio-temporal reprojection on torch tensors.

Counterpart of ``rayzath_tpu/ops/reproject.py`` (reference
Cuda::Camera::reproject, cuda_camera.cuh:380-426, and the
spacialReprojection kernel, cuda_postprocess_kernel.cu:5-16). When a camera
with ``temporal_blend > 0`` moves, accumulation restarts, seeded from the
previous frame: each new primary-hit point is projected into the previous
camera, and where it lands on screen with a distance within 1% of the
previous depth buffer, the previous pixel's accumulation (rgb sum and
sample count) comes in scaled by ``temporal_blend``.

``primary_hits`` traces through the integrator's ``closest_hit``, so on the
card it runs B1 on a soup scene and B3 on a two-level one. The projection
is written out elementwise (no matrix product), so the card and the CPU
round it alike; the pixel index truncates toward zero, as the JAX
package's ``astype(int32)`` does.
"""
from __future__ import annotations

import torch

from . import camera as cam_ops


def _norm3(v):
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])


def primary_hits(scene, cam, cfg):
    """Depth and world-space hit points of the pinhole centre ray of every
    pixel: (depth [H,W], space [H,W,3]); a miss takes the camera's far
    distance. Seeds the reprojection after a camera move (the analog of the
    space buffer filled by renderFirstPass, cuda_render_kernel.cu:39-43)."""
    from ..engine.integrator import closest_hit  # the integrator imports ops
    H, W = cam.height, cam.width
    pix = cam_ops.pixel_grid(W, H, device=cam.position.device)
    o, d = cam_ops.simple_ray(cam, pix)
    r = o.shape[0]
    near = cam.near_far[0].expand(r).contiguous()
    far = cam.near_far[1].expand(r).contiguous()
    with torch.no_grad():
        t, tid, *_ = closest_hit(scene, cfg, o, d, near, far, hw=(H, W))
    t = torch.where(tid >= 0, t, far)
    space = o + d * t[:, None]
    return t.reshape(H, W), space.reshape(H, W, 3)


def reproject_accum(space_buf, prev_cam, prev_accum, prev_depth,
                    temporal_blend: float):
    """Blend the previous accumulation into a fresh one by reprojection.

    space_buf [H,W,3]: primary-hit points under the new camera; prev_cam:
    the previous TorchCamera; prev_accum [H,W,4]: its accumulation (rgb sum
    and sample count); prev_depth [H,W]: its primary depth buffer. Returns
    the seeded accumulation [H,W,4]."""
    H, W = prev_accum.shape[0], prev_accum.shape[1]
    p = space_buf.reshape(-1, 3)
    rel = p - prev_cam.position
    # previous camera space (transformBackward: the columns of rot are the
    # camera axes, so local = rel @ rot)
    rot = prev_cam.rot
    local = rel[:, 0:1] * rot[0] + rel[:, 1:2] * rot[1] + rel[:, 2:3] * rot[2]
    lz = local[:, 2]
    in_front = lz > 0.0

    # onto the previous screen (the inverse of ops/camera.py simple_ray)
    f32 = dict(dtype=torch.float32, device=p.device)
    aspect = torch.tensor(float(W), **f32) / torch.tensor(float(H), **f32)
    tana = torch.tan(prev_cam.fov * 0.5)
    lz_safe = torch.where(in_front, lz, torch.ones_like(lz))
    fx = ((local[:, 0] / lz_safe) / tana + 0.5) * W
    fy = ((local[:, 1] / lz_safe) / (-tana / aspect) + 0.5) * H
    on_screen = (fx >= 0.0) & (fx < W) & (fy >= 0.0) & (fy < H)
    # truncation toward zero; off-screen values are clamped first only so
    # the conversion stays in range (those pixels are masked below)
    ix = torch.clamp(torch.clamp(fx, -1.0, float(W)).to(torch.int32), 0, W - 1)
    iy = torch.clamp(torch.clamp(fy, -1.0, float(H)).to(torch.int32), 0, H - 1)

    # depth agreement within 1% (cuda_camera.cuh:414-419)
    point_dist = _norm3(rel)
    buffer_dist = prev_depth[iy.long(), ix.long()]
    ok = (in_front & on_screen
          & ((point_dist - buffer_dist).abs() < 0.01 * point_dist))

    prev = prev_accum[iy.long(), ix.long()]                  # [R, 4]
    seeded = torch.where(ok[:, None], prev * temporal_blend,
                         torch.zeros((), **f32))
    return seeded.reshape(H, W, 4)
