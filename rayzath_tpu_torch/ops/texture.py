"""Texture-map fetch from the packed atlases, on torch tensors.

Counterpart of ``rayzath_tpu/ops/texture.py``. Semantics mirror the
reference ``TextureBuffer::fetch`` (render_parts.hpp:209-221): the UV
transform ``uv += translation; uv.rotate(rotation); uv *= scale``, the v axis
flipped (image row 0 = top, v = 1), point or bilinear filtering with wrap /
clamp / mirror / border addressing, and zero outside a border-mode map.

All maps live in two atlases (color RGBA ``[Hc, Wc, 4]`` and scalar
``[Hs, Ws]``) with per-map integer rects. The bilinear corners come from the
static 2x2 block tables of :func:`block_indices` (built once per atlas at
scene compile), as in the JAX package's blocked fetch: one row of the table
gives the four texel indices of a corner block, with the +1 neighbours
clamped inside the map's rect. The texels are then read from the live atlas,
so gradients reach the atlas leaves. Every lookup, of the map tables, the
block tables and the atlases, goes through ``ops/gather.py``
``gather_rows`` (the G1 kernel on a card; G2 takes the atlases' gradient).
"""
from __future__ import annotations

import numpy as np
import torch

from .gather import gather_rows

FILTER_POINT = 0
FILTER_LINEAR = 1
ADDRESS_WRAP = 0
ADDRESS_CLAMP = 1
ADDRESS_MIRROR = 2
ADDRESS_BORDER = 3


def _apply_address(x, mode):
    """Address mode on a normalized coordinate ``x``; returns (coordinate in
    [0, 1), border mask). ``torch.remainder`` follows the divisor's sign, as
    ``jnp.mod`` does."""
    wrap = torch.remainder(x, 1.0)
    clamp = torch.clamp(x, 0.0, 1.0 - 1e-6)
    period = torch.remainder(x, 2.0)
    mirror = torch.clamp(torch.where(period > 1.0, 2.0 - period, period),
                         0.0, 1.0 - 1e-6)
    border_out = (x < 0.0) | (x >= 1.0)
    coord = torch.where(mode == ADDRESS_WRAP, wrap,
             torch.where(mode == ADDRESS_CLAMP, clamp,
              torch.where(mode == ADDRESS_MIRROR, mirror, clamp)))
    return coord, (mode == ADDRESS_BORDER) & border_out


def _transform_uv(uv, map_uv, map_id):
    """uv += translation; rotate; *= scale (reference render_parts.hpp:209-212)."""
    prm = gather_rows(map_uv, map_id)         # [R,5]: sx, sy, rot, tx, ty
    u = uv[:, 0] + prm[:, 3]
    v = uv[:, 1] + prm[:, 4]
    c, s = torch.cos(prm[:, 2]), torch.sin(prm[:, 2])
    ur = u * c - v * s
    vr = u * s + v * c
    return ur * prm[:, 0], vr * prm[:, 1]


def block_indices(rects, h_atlas: int, w_atlas: int) -> np.ndarray:
    """Host build (NumPy) of the [H*W, 4] linear indices of each texel's 2x2
    bilinear block (x0y0, x1y0, x0y1, x1y1), the +1 neighbours clamped
    within their map's rect; texels outside every rect clamp against the
    atlas edge (no valid fetch addresses them)."""
    yy, xx = np.meshgrid(np.arange(h_atlas), np.arange(w_atlas), indexing="ij")
    x1 = np.minimum(xx + 1, w_atlas - 1)
    y1 = np.minimum(yy + 1, h_atlas - 1)
    for (y0, x0, hh, ww) in np.asarray(rects).reshape(-1, 4):
        sl = (slice(y0, y0 + hh), slice(x0, x0 + ww))
        x1[sl] = np.minimum(x1[sl], x0 + ww - 1)
        y1[sl] = np.minimum(y1[sl], y0 + hh - 1)

    def lin(y, x):
        return (y * w_atlas + x).astype(np.int32)

    return np.stack([lin(yy, xx), lin(yy, x1), lin(y1, xx), lin(y1, x1)],
                    axis=-1).reshape(-1, 4)


def fetch(atlas, blk_idx, map_rect, map_flags, map_uv, map_id, uv):
    """Fetch maps of one atlas kind for a batch: ``atlas`` is the color
    atlas [Hc, Wc, 4] or the scalar atlas [Hs, Ws], ``blk_idx`` its
    :func:`block_indices` table, ``map_id`` [R] int (< 0 reads map 0; the
    caller masks it), ``uv`` [R, 2]. Returns [R, 4]: RGBA, or the scalar
    broadcast to four channels."""
    mid = torch.clamp(map_id, min=0)
    u, v = _transform_uv(uv, map_uv, mid)
    flags = gather_rows(map_flags, mid)
    filt, addr = flags[:, 0], flags[:, 1]
    rect = gather_rows(map_rect, mid).long()
    y0, x0, h, w = rect[:, 0], rect[:, 1], rect[:, 2], rect[:, 3]

    un, ub = _apply_address(u, addr)
    vn, vb = _apply_address(v, addr)
    vn = 1.0 - vn                             # v flip (render_parts.hpp:214)

    # bilinear corners (texel centres at +0.5)
    fx = un * w.to(un.dtype) - 0.5
    fy = vn * h.to(vn.dtype) - 0.5
    x_lo = torch.floor(fx)
    y_lo = torch.floor(fy)
    zero = torch.zeros((), dtype=fx.dtype, device=fx.device)
    # at the left/top edge both corners are the same texel: the weight is
    # irrelevant there and is zeroed, as in the JAX blocked fetch
    ax = torch.where(x_lo < 0, zero, fx - x_lo)[:, None]
    ay = torch.where(y_lo < 0, zero, fy - y_lo)[:, None]
    xc = torch.minimum(torch.clamp(x_lo.long(), min=0), w - 1) + x0
    yc = torch.minimum(torch.clamp(y_lo.long(), min=0), h - 1) + y0
    corners = gather_rows(blk_idx, yc * atlas.shape[1] + xc)    # [R, 4]
    if atlas.dim() == 3:
        vals = gather_rows(atlas.reshape(-1, 4), corners)        # [R, 4, 4]
    else:
        vals = gather_rows(atlas.reshape(-1), corners)[..., None]  # [R, 4, 1]
    v00, v10, v01, v11 = vals.unbind(1)
    linear = (v00 * (1 - ax) + v10 * ax) * (1 - ay) + (v01 * (1 - ax) + v11 * ax) * ay
    # point sample = the corner picked by rounding the fractional parts
    sx, sy = ax >= 0.5, ay >= 0.5
    point = torch.where(sy, torch.where(sx, v11, v01), torch.where(sx, v10, v00))
    out = torch.where((filt == FILTER_POINT)[:, None], point, linear)
    out = torch.where((ub | vb)[:, None], zero, out)
    return out.expand(-1, 4) if out.shape[1] == 1 else out


def fetch_scene(scene, map_id, uv, atlas: int):
    """:func:`fetch` from a TorchScene's color (``atlas=0``) or scalar
    (``atlas=1``) atlas."""
    if atlas == 0:
        return fetch(scene.color_atlas, scene.col_blk_idx, scene.map_rect,
                     scene.map_flags, scene.map_uv, map_id, uv)
    return fetch(scene.scalar_atlas, scene.sc_blk_idx, scene.map_rect,
                 scene.map_flags, scene.map_uv, map_id, uv)
