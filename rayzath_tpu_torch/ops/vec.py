"""Batched 3-vector helpers on torch tensors (last axis = xyz).

Counterpart of ``rayzath_tpu/ops/vec.py``: the reference helper functions of
RayZath/cuda_render_parts.cuh:1195-1368 (reflect, halfway, local frame,
sampling, Fresnel) as plain tensor functions. Sums over xyz are written out
left to right so that they round like the JAX package's reductions.
"""
from __future__ import annotations

import torch

EPS = 1e-20
TWO_PI = 6.283185307179586
PI = 3.141592653589793


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dot1(a, b):
    return dot(a, b)[..., None]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def length(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=1e-20))


def normalize(v):
    return v * (1.0 / torch.sqrt(torch.clamp(dot1(v, v), min=EPS)))


def lerp(a, b, t):
    return a + (b - a) * t


class _Prod(torch.autograd.Function):
    """``x.prod(dim)`` whose backward reads nothing on the host. Torch's
    own rule counts the zero factors on the host to choose between
    ``g * prod / x`` and a zero-safe form, which a captured CUDA graph
    cannot do (parallel/train.py); this one always takes the zero-safe
    form: each factor's gradient is g times the products of the factors
    before and after it (exclusive cumulative products from both ends)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.save_for_backward(x)
        ctx.dim = dim
        return x.prod(dim=dim)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        dim, n = ctx.dim, x.shape[ctx.dim]
        ones = torch.ones_like(x.narrow(dim, 0, 1))
        before = torch.cat([ones, x.narrow(dim, 0, n - 1).cumprod(dim)], dim)
        after = torch.cat([x.narrow(dim, 1, n - 1).flip(dim).cumprod(dim)
                           .flip(dim), ones], dim)
        return g.unsqueeze(dim) * before * after, None


def prod(x, dim: int):
    """``x.prod(dim)``, the same bits, with a backward that a CUDA graph
    can capture (:class:`_Prod`)."""
    return _Prod.apply(x, dim)


def reflect(vi, vn):
    """Reflect incident vi about normal vn (reference reflectVector)."""
    return vi - 2.0 * dot1(vn, vi) * vn


def halfway(vi, vr):
    """Halfway vector of incident vi and outgoing vr (reference halfwayVector)."""
    return normalize(vr - vi)


def local_frame(vn):
    """Orthonormal tangent frame (vX, vY) for normals vn [..,3]
    (reference localCoordinate, cuda_render_parts.cuh:1253-1265)."""
    b = (vn[..., 0].abs() > vn[..., 1].abs()).to(vn.dtype)
    vx0 = torch.stack([1.0 - b, b, torch.zeros_like(b)], dim=-1)
    vy = cross(vn, vx0)
    vx = cross(vn, vy)
    return vx, vy


def cosine_sample_hemisphere(r1, r2, vn):
    """Cosine-weighted hemisphere sample around vn (reference cuda_render_parts.cuh:1268-1284)."""
    vx, vy = local_frame(vn)
    phi = r1 * TWO_PI
    sq = torch.sqrt(r2)
    return (vx * (sq * torch.cos(phi))[..., None]
            + vy * (sq * torch.sin(phi))[..., None]
            + vn * torch.sqrt(torch.clamp(1.0 - r2, min=1e-12))[..., None])


def sample_sphere(r1, r2, vn):
    """Uniform sphere sample with pole at vn (reference cuda_render_parts.cuh:1285-1301).
    The sqrt argument is floored at 1e-12 as in the JAX package."""
    vx, vy = local_frame(vn)
    phi = r1 * TWO_PI
    cos_theta = 1.0 - 2.0 * r2
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=1e-12))
    return (vx * (sin_theta * torch.cos(phi))[..., None]
            + vy * (sin_theta * torch.sin(phi))[..., None]
            + vn * cos_theta[..., None])


def sample_hemisphere(r1, r2, vn):
    """Uniform hemisphere sample (reference: sampleSphere with r2 * 0.5)."""
    return sample_sphere(r1, r2 * 0.5, vn)


def sample_disk(r1, r2, vn, radius):
    """Point on a disk of ``radius`` perpendicular to vn
    (reference sampleDisk, cuda_render_parts.cuh:1322-1332)."""
    vx, vy = local_frame(vn)
    ang = r1 * TWO_PI
    rad = torch.sqrt(r2) * radius
    return vx * (torch.sin(ang) * rad)[..., None] + vy * (torch.cos(ang) * rad)[..., None]


#: Temperature of the sigmoid-relaxed total-internal-reflection indicator.
#: It shapes only the gradient of the fresnel term (the ior estimator of
#: parallel/train.py); the forward value is the hard branch.
TIR_TAU = 0.05


def fresnel_specular_ratio(vn, vi, n1, n2):
    """Exact dielectric Fresnel reflectance + refraction factors.

    Returns (fresnel, ratio, refr_b) where the refracted direction is
    ``vi * ratio + vn * refr_b`` (reference fresnelSpecularRatio,
    cuda_render_parts.cuh:1335-1355). Total internal reflection -> fresnel = 1.
    Straight-through, as in the JAX package: the value is
    ``f_relaxed + detach(f_hard - f_relaxed)``, the hard branch up to the
    rounding of that sum, and the gradient is that of the sigmoid-relaxed
    blend ``lerp(F, 1, sigmoid((sin2_t - 1) / TIR_TAU))``, which sees the
    total-internal-reflection boundary.
    """
    ratio = n1 / torch.clamp(n2, min=EPS)
    cosi = dot(vi, vn).abs()
    sin2_t = ratio * ratio * (1.0 - cosi * cosi)
    tir = sin2_t >= 1.0
    cost = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
    rp = (n1 * cosi - n2 * cost) / torch.clamp(n1 * cosi + n2 * cost, min=EPS)
    rs = (n2 * cosi - n1 * cost) / torch.clamp(n2 * cosi + n1 * cost, min=EPS)
    f_fresnel = 0.5 * (rs * rs + rp * rp)
    f_hard = torch.where(tir, torch.ones_like(f_fresnel), f_fresnel)
    w_tir = torch.sigmoid((sin2_t - 1.0) / TIR_TAU)
    f_relaxed = f_fresnel + (1.0 - f_fresnel) * w_tir
    f = f_relaxed + (f_hard - f_relaxed).detach()
    refr_b = ratio * cosi - cost
    return f, ratio, refr_b
