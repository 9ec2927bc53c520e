"""Progressive render state (counterpart of ``rayzath_tpu/engine/state.py``).

The state IS the checkpoint: accumulation image (rgb sum + alpha = sample
count), depth/space buffers, per-ray persistent path state (origin,
direction, throughput, medium material id, path depth, near/far, free-flight
score) and the pass counter. ``save_state``/``load_state`` use the JAX
package's ``.npz`` keys, so a checkpoint written by either package resumes
in the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import DEFAULT, resolve

BIG = 3.402823466e38
PATH_LIMIT = 255  # reference TracingState::sm_path_limit (cuda_camera.cuh:18)
WORLD_MATERIAL_ID = 0

_ARRAYS = ("accum", "depth_buf", "space_buf", "origin", "direction",
           "throughput", "medium", "path_depth", "near", "far", "score")


@dataclasses.dataclass
class RenderState:
    accum: torch.Tensor       # [H,W,4] rgb sum + alpha = terminated-sample count
    depth_buf: torch.Tensor   # [H,W]
    space_buf: torch.Tensor   # [H,W,3] first-hit points (reprojection)
    origin: torch.Tensor      # [R,3]
    direction: torch.Tensor   # [R,3]
    throughput: torch.Tensor  # [R,3]
    medium: torch.Tensor      # [R] i32 material id of the medium the ray travels in
    path_depth: torch.Tensor  # [R] i32
    near: torch.Tensor        # [R]
    far: torch.Tensor         # [R]
    #: cumulative log-likelihood of the path's free-flight events (kept for
    #: checkpoints; its gradient use is ROADMAP A12)
    score: torch.Tensor       # [R]
    pass_idx: int = 0         # pass counter: seeds each pass's uniforms
    width: int = 0
    height: int = 0

    def replace(self, **kw) -> "RenderState":
        return dataclasses.replace(self, **kw)


def init_state(width: int, height: int, device=DEFAULT) -> RenderState:
    """Fresh state: paths are 'terminated' so the first bounce regenerates
    camera rays for every pixel (regeneration-in-place, reference
    cuda_render_kernel.cu:50-65)."""
    device = resolve(device)
    r = width * height
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    direction = torch.zeros((r, 3), **f32)
    direction[:, 2] = 1.0
    return RenderState(
        accum=torch.zeros((height, width, 4), **f32),
        depth_buf=torch.zeros((height, width), **f32),
        space_buf=torch.zeros((height, width, 3), **f32),
        origin=torch.zeros((r, 3), **f32),
        direction=direction,
        throughput=torch.ones((r, 3), **f32),
        medium=torch.full((r,), WORLD_MATERIAL_ID, **i32),
        path_depth=torch.full((r,), PATH_LIMIT, **i32),
        near=torch.zeros(r, **f32),
        far=torch.full((r,), BIG, **f32),
        score=torch.zeros(r, **f32),
        pass_idx=0, width=width, height=height)


def state_from_arrays(arrays: dict, device=DEFAULT) -> RenderState:
    """RenderState from named NumPy arrays with the checkpoint keys (for
    example the leaves of a JAX ``RenderState``, each ``np.asarray``-ed,
    plus ``pass_idx``, ``width`` and ``height``)."""
    device = resolve(device)
    tensors = {}
    for k in _ARRAYS:
        if k == "score" and arrays.get(k) is None:
            a = np.zeros_like(np.asarray(arrays["near"]))
        else:
            a = np.asarray(arrays[k])
        a = a.astype(np.int32 if k in ("medium", "path_depth") else np.float32)
        tensors[k] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return RenderState(**tensors, pass_idx=int(arrays["pass_idx"]),
                       width=int(arrays["width"]), height=int(arrays["height"]))


def save_state(path: str, state: RenderState) -> None:
    np.savez_compressed(
        path,
        **{f: getattr(state, f).cpu().numpy() for f in _ARRAYS},
        pass_idx=np.int32(state.pass_idx),
        width=state.width, height=state.height,
    )


def load_state(path: str, device=DEFAULT) -> RenderState:
    device = resolve(device)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return state_from_arrays(arrays, device)
