"""Text helpers mirroring reference RayZath/text_utils.h (scientificWithPrefix);
a copy of ``rayzath_tpu/utils/text.py``."""
from __future__ import annotations

_PREFIXES = [
    (1e18, "E"), (1e15, "P"), (1e12, "T"), (1e9, "G"),
    (1e6, "M"), (1e3, "k"), (1.0, ""),
]


def scientific_with_prefix(value: float, precision: int = 2) -> str:
    """Format a number with an SI prefix, e.g. 52_300_000 -> '52.30M'."""
    v = float(value)
    sign = "-" if v < 0 else ""
    v = abs(v)
    for scale, prefix in _PREFIXES:
        if v >= scale:
            return f"{sign}{v / scale:.{precision}f}{prefix}"
    return f"{sign}{v:.{precision}f}"
