"""Counter-based uniforms: the JAX package's random streams, bit for bit.

Counterpart of the ``jax.random`` calls the JAX integrator makes
(``rayzath_tpu/engine/integrator.py`` ``pass_uniforms`` and
``_render_steps_impl``), with jax's default threefry2x32 generator in its
partitionable layout:

* a key is a pair of uint32 words; ``key(seed)`` is ``(0, seed)``;
* ``fold_in(k, d)`` is both output words of ``threefry2x32(k, (0, d))``;
* the 32 random bits at flat index i of an array drawn from key k are
  ``x0 ^ x1`` of ``threefry2x32(k, (0, i))``, and the float is
  ``bitcast_f32((bits >> 9) | 0x3F800000) - 1``, in [0, 1).

A pass's uniforms (:func:`uniform_rows`) key each global image row by
itself, ``fold_in(pass_key, row)``, and draw that row's [W, ns] block from
the row key, so a band of rows at ``row0`` draws exactly the numbers of the
same rows of the whole image.

:func:`threefry2x32` runs on Python ints (keys, on the host) and on int64
tensors holding uint32 words (the plain version of the draw, masked after
every add and shift). :func:`uniform_rows` takes that plain version on the
CPU and launches the hand-written kernel ``csrc/threefry.cu`` on a CUDA
device, counting its launches in ``uniform_rows.launches``.

:func:`uniform_rows_keyed` draws the same numbers under a
:class:`DeviceKey`, the render's key words and a pass counter that stay on
the device: the pass key is folded where the draw runs (the kernel's keyed
entry on a card, :func:`fold_in_tensor` before the plain draw on the CPU),
so a CUDA graph that captured the draw draws each replay's own pass
(``engine/cycle.py``). Its launches count in
``uniform_rows_keyed.launches``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import _kernels
from ._kernels import counted, launch as _launch, ptr as _ptr

MASK = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA                      # threefry's key-schedule constant
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
ONE_BITS = 0x3F800000                       # float32 1.0

Key = Tuple[int, int]


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax's ``threefry2x32``): key words
    (k0, k1), counter words (x0, x1) -> two output words. Each argument is a
    Python int or an int64 tensor of uint32 values (broadcast together)."""
    ks = (k0, k1, (k0 ^ k1 ^ KS_PARITY) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` as its two words."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return 0, seed & MASK


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` for 0 <= data < 2**32."""
    return threefry2x32(int(k[0]), int(k[1]), 0, int(data) & MASK)


class DeviceKey(NamedTuple):
    """A render key and a pass index that stay on the device: ``words`` is
    an int32 tensor [2] holding the key's two uint32 words (their bits),
    ``pass_idx`` an int32 scalar tensor. The pass key is
    ``fold_in(key, pass_idx)``, as the JAX package folds its device int32
    pass counter into the key."""
    words: torch.Tensor
    pass_idx: torch.Tensor


def key_words(k: Key, device) -> torch.Tensor:
    """The key's two uint32 words as an int32 tensor [2] on ``device``."""
    signed = [(int(w) & MASK) - ((int(w) & MASK) >> 31 << 32) for w in k]
    return torch.tensor(signed, dtype=torch.int32, device=device)


def fold_in_tensor(words: torch.Tensor, data: torch.Tensor):
    """:func:`fold_in` on tensors: ``words`` an int32 tensor [2] of a key's
    words, ``data`` an int32 tensor, read as uint32 as jax reads an int32.
    Returns the folded key's two words as int64 tensors of ``data``'s shape
    holding uint32 values."""
    w = words.to(torch.int64) & MASK
    return threefry2x32(w[0], w[1], 0, data.to(torch.int64) & MASK)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64 tensor) -> float32 uniforms in [0, 1)."""
    f = ((bits >> 9) | ONE_BITS).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform_rows_plain(k: Key, row0: int, height: int, width: int, ns: int,
                       device="cpu") -> torch.Tensor:
    """[height * width, ns] float32 uniforms of image rows
    [row0, row0 + height) under the pass key ``k``: row y draws
    ``uniform(fold_in(k, y), (width, ns))``. The key's words are ints or
    scalar int64 tensors on ``device`` (:func:`fold_in_tensor`)."""
    i64 = dict(dtype=torch.int64, device=device)
    rows = torch.arange(height, **i64) + int(row0)
    rk0, rk1 = threefry2x32(k[0], k[1], 0, rows)
    idx = torch.arange(width * ns, **i64)
    x0, x1 = threefry2x32(rk0[:, None], rk1[:, None], 0, idx[None, :])
    return bits_to_unit(x0 ^ x1).reshape(height * width, ns)


@counted()
def uniform_rows(k: Key, row0: int, height: int, width: int, ns: int,
                 device) -> torch.Tensor:
    """The uniforms of :func:`uniform_rows_plain`, on ``device``: the plain
    version on the CPU, the threefry kernel (``csrc/threefry.cu``, one
    launch) on a CUDA device; any other device raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return uniform_rows_plain(k, row0, height, width, ns, dev)
    _kernels.card(dev)
    lib = _kernels.load()
    out = torch.empty((height * width, ns), dtype=torch.float32, device=dev)
    if out.numel():
        _launch(uniform_rows, lib.rz_threefry_uniform, out.device, _ptr(out),
                int(k[0]) & MASK, int(k[1]) & MASK, int(row0), height, width,
                ns)
    return out


@counted()
def uniform_rows_keyed(dk: DeviceKey, row0: int, height: int, width: int,
                       ns: int, device) -> torch.Tensor:
    """The uniforms of :func:`uniform_rows` under the pass key
    ``fold_in(key, pass_idx)`` of a :class:`DeviceKey` on ``device``: on
    the CPU :func:`fold_in_tensor` and the plain draw, on a CUDA device one
    launch of the threefry kernel's keyed entry, which folds the key when
    it runs; any other device raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    words, pass_idx = dk
    _kernels.check(dev, "words", words, torch.int32, (2,))
    _kernels.check(dev, "pass_idx", pass_idx, torch.int32, ())
    if dev.type == "cpu":
        return uniform_rows_plain(fold_in_tensor(words, pass_idx), row0,
                                  height, width, ns, dev)
    _kernels.card(dev)
    lib = _kernels.load()
    out = torch.empty((height * width, ns), dtype=torch.float32, device=dev)
    if out.numel():
        _launch(uniform_rows_keyed, lib.rz_threefry_uniform_keyed, dev,
                _ptr(out), _ptr(words), _ptr(pass_idx), int(row0), height,
                width, ns)
    return out
