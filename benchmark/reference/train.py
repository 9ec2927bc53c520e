"""The training job on the plain tracer: image loss, its gradient with
respect to the scene's leaves, and the projected SGD update.

The loss is the mean squared difference between the mean radiance of
``passes`` passes from fresh paths (radiance summed over the passes over
the paths ended, at least 1) and a target image, over every pixel and
channel. The update is ``p - lr * grad``, projected into the leaf's range:
colours, metalness, roughness and colour maps into [0, 1], the index of
refraction to at least 1, everything else to at least 0. Pixels are
independent, so the loss and its gradient are summed over blocks of
pixels, which bounds the memory.
"""
from __future__ import annotations

import torch

from . import tracer

UNIT = ("mat_color", "mat_metalness", "mat_roughness", "color_maps")


def project(name: str, v):
    if name in UNIT:
        return torch.clamp(v, 0.0, 1.0)
    if name == "mat_ior":
        return torch.clamp(v, min=1.0)
    return torch.clamp(v, min=0.0)


def leaf_list(sc: tracer.Scene) -> list:
    """[(kind, tensor)] of every leaf (one entry per map)."""
    out = []
    for k in tracer.LEAVES:
        v = sc.leaves[k]
        out += [(k, t) for t in v] if isinstance(v, list) else [(k, v)]
    return out


def image(sc, cfg: dict, seed: int, passes: int, xs, ys):
    _, rad, cnt = tracer.trace(sc, cfg, seed, 0, passes, xs, ys)
    return rad / torch.clamp(cnt, min=1.0)[:, None]


def render(sc, cfg: dict, seed: int, passes: int, width: int, height: int,
           block: int = 32768):
    """The mean image [H, W, 3] (no gradient)."""
    idx = torch.arange(width * height, device=sc.device)
    out = []
    with torch.no_grad():
        for i in range(0, idx.shape[0], block):
            j = idx[i:i + block]
            out.append(image(sc, cfg, seed, passes, j % width, j // width))
    return torch.cat(out).reshape(height, width, 3)


def loss_and_grads(sc, cfg: dict, seed: int, passes: int, target,
                   rows=None, block: int = 32768):
    """(loss as a float, [gradient or None per ``leaf_list`` entry], the
    mean image [rows * W, 3]) over the image rows ``rows`` (all when None;
    the loss is the mean over those rows)."""
    height, width = target.shape[0], target.shape[1]
    rows = torch.arange(height, device=sc.device) if rows is None else rows
    idx = (rows[:, None] * width
           + torch.arange(width, device=sc.device)[None]).reshape(-1)
    n = idx.shape[0] * 3
    leaves = [t for _, t in leaf_list(sc)]
    for t in leaves:
        t.requires_grad_(True)
    total, grads, imgs = 0.0, [None] * len(leaves), []
    for i in range(0, idx.shape[0], block):
        j = idx[i:i + block]
        xs, ys = j % width, j // width
        with torch.enable_grad():
            img = image(sc, cfg, seed, passes, xs, ys)
            loss = torch.square(img - target[ys, xs].to(img.dtype)).sum() / n
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        total += float(loss.detach().double())
        imgs.append(img.detach())
        grads = [g if a is None else (a if g is None else a + g)
                 for a, g in zip(grads, gs)]
    for t in leaves:
        t.requires_grad_(False)
    return total, grads, torch.cat(imgs)


def step(sc, cfg: dict, seed: int, passes: int, target, lr: float,
         rows=None):
    """One projected SGD step on ``sc``'s leaves in place. Returns (loss,
    {kind: [gradient per leaf]}, the mean image)."""
    loss, grads, img = loss_and_grads(sc, cfg, seed, passes, target, rows)
    by_kind: dict = {}
    with torch.no_grad():
        for (kind, t), g in zip(leaf_list(sc), grads):
            by_kind.setdefault(kind, []).append(g)
            if g is not None:
                t.copy_(project(kind, t - lr * g.to(t.dtype)))
    return loss, by_kind, img


def norms(tensors) -> float:
    """The norm of the concatenation of ``tensors`` (None counts 0)."""
    return float(sum(float(t.double().square().sum()) for t in tensors
                     if t is not None) ** 0.5)
