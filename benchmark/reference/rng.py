"""Counter-based uniforms of a render pass, computed per pixel.

The renderer draws jax's default threefry2x32 streams: a key is the word
pair (0, seed); ``fold_in(k, n)`` is both output words of
``threefry2x32(k, (0, n))``; the 32 bits at flat index i of an array drawn
from key k are ``x0 ^ x1`` of ``threefry2x32(k, (0, i))``, and the float is
``bitcast_f32((bits >> 9) | 0x3F800000) - 1``. A pass folds its index into
the render key, each image row folds its row index into the pass key, and
the row's [width, ns] block is drawn from the row key, so the ns numbers of
pixel (x, y) sit at flat indices x * ns + s.

Written from that description on int64 tensors holding uint32 words, so
that only the sampled pixels' numbers are computed.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds. Arguments are ints or int64 tensors of
    uint32 values; returns the two output words."""
    ks = (k0, k1, (k0 ^ k1 ^ PARITY) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def pass_key(seed: int, pass_idx: int):
    """The key of pass ``pass_idx`` of a render seeded with ``seed``."""
    return threefry(0, int(seed) & MASK, 0, int(pass_idx) & MASK)


def pixel_uniforms(seed: int, pass_idx: int, xs: torch.Tensor,
                   ys: torch.Tensor, ns: int) -> torch.Tensor:
    """[K, ns] float32 uniforms of the pixels (xs[k], ys[k]) (int64) at one
    pass of a render seeded with ``seed``."""
    k0, k1 = pass_key(seed, pass_idx)
    r0, r1 = threefry(k0, k1, torch.zeros_like(ys), ys & MASK)
    idx = xs[:, None] * ns + torch.arange(ns, dtype=torch.int64,
                                          device=xs.device)[None]
    a, b = threefry(r0[:, None], r1[:, None], torch.zeros_like(idx), idx)
    bits = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0
