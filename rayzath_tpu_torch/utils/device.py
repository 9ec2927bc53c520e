"""The device the port's entry points run on.

Every public entry point (``Renderer``, ``compile_world``,
``compile_camera``, ``scene_from_arrays``, ``init_state``,
``state_from_arrays``, ``load_state``) defaults to ``"cuda"``: the traversal
runs the hand-written kernels there. ``device="cpu"`` is the explicit way
to run the plain PyTorch versions, as the CPU tests do. Asking for a card
on a machine without one raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """``torch.device(device)``, raising ``RuntimeError`` when it names a
    CUDA device and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested, but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
