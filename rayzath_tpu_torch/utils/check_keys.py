"""Rays built to test the coherence key (``ops/sort_rays.py``), for the
port's tests: the plain key against the JAX package's on the CPU, the
kernels of ``csrc/sort_keys.cu`` against the plain key on the card.

:func:`key_rays` returns (origin, direction) as NumPy float32 [n, 3] of one
kind of :data:`KEY_KINDS`, from a seed:

* ``bounce``: origins uniform in a box, unit directions;
* ``camera``: every origin the same (the bounds' span clamps at 1e-20);
* ``axis``: directions along +-x, +-y or +-z at random lengths (two lanes
  tie at zero);
* ``diagonal``: |dx| = |dy| = |dz| (three lanes tie: the first is dominant);
* ``two_equal``: two lanes of equal magnitude, the third larger or smaller;
* ``signed_zero``: components drawn from +-0, +-0.5 and +-1, in origins and
  directions;
* ``zero``: half the directions all zero (of either sign), half unit.

:data:`CARD_KINDS` adds two kinds for the kernels against the plain key on
the card, where both are torch's arithmetic on the same device (the JAX
package converts a NaN to an integer otherwise):

* ``nonfinite``: a quarter of the directions with an inf, -inf or NaN
  lane, and one origin at +inf;
* ``nan_origin``: one origin lane NaN (torch's amin and amax keep it).
"""
from __future__ import annotations

import numpy as np

KEY_KINDS = ("bounce", "camera", "axis", "diagonal", "two_equal",
             "signed_zero", "zero")
CARD_KINDS = KEY_KINDS + ("nonfinite", "nan_origin")


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _signs(rng, shape):
    return rng.choice(np.asarray([-1.0, 1.0]), shape)


def key_rays(kind: str, n: int, seed: int = 0):
    """(origin, direction), NumPy float32 [n, 3], of ``kind``."""
    rng = np.random.default_rng([seed, CARD_KINDS.index(kind)])
    o = rng.uniform(-5.0, 5.0, (n, 3))
    d = _unit(rng, n)
    scale = rng.uniform(0.1, 10.0, (n, 1))
    if kind == "camera":
        o = np.tile(np.asarray([[0.3, 1.0, -4.0]]), (n, 1))
    elif kind == "axis":
        d = np.zeros((n, 3))
        d[np.arange(n), rng.integers(0, 3, n)] = 1.0
        d *= _signs(rng, (n, 1)) * scale
    elif kind == "diagonal":
        d = _signs(rng, (n, 3)) * scale
    elif kind == "two_equal":
        d = np.abs(_unit(rng, n))
        lanes = rng.permuted(np.tile(np.arange(3), (n, 1)), axis=1)
        rows = np.arange(n)
        d[rows, lanes[:, 1]] = d[rows, lanes[:, 0]]
        d *= _signs(rng, (n, 3))
    elif kind == "signed_zero":
        values = np.asarray([0.0, -0.0, 0.5, -0.5, 1.0, -1.0])
        o = values[rng.integers(0, 6, (n, 3))]
        d = values[rng.integers(0, 6, (n, 3))]
    elif kind == "zero":
        zero = np.arange(n) % 2 == 0
        d[zero] = _signs(rng, (int(zero.sum()), 3)) * 0.0
    elif kind == "nonfinite":
        rows = rng.permutation(n)[:max(n // 4, 1)]
        d[rows, rng.integers(0, 3, rows.size)] = rng.choice(
            np.asarray([np.inf, -np.inf, np.nan]), rows.size)
        o[rng.integers(0, n), rng.integers(0, 3)] = np.inf
    elif kind == "nan_origin":
        o[rng.integers(0, n), rng.integers(0, 3)] = np.nan
    elif kind != "bounce":
        raise ValueError(f"unknown kind {kind!r}; known: {CARD_KINDS}")
    return o.astype(np.float32), d.astype(np.float32)
