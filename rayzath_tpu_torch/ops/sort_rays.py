"""Ray-coherence sorting ahead of the cluster traversal.

Counterpart of ``rayzath_tpu/ops/sort_rays.py``. Rays are ordered by a
32-bit coherence key with the JAX package's exact bit layout:

    [31:26] coarse origin cell    (2 bits/axis, batch-normalized bounds)
    [25:23] direction octant      (3 bits)
    [22:15] direction bits        (4+4 bits of the two minor |d| ratios)
    [14:0]  fine origin Morton    (5 bits/axis)

Origins are normalized by the batch's own min/max, so no scene bounds are
needed. A traversal result is a per-ray function, so sorting changes which
rays share a thread block and never what a ray returns; the results are put
back in the original order afterwards.

:func:`coherence_keys` takes the plain version :func:`coherence_keys_plain`
(torch ops) for tensors on the CPU and, for tensors on a CUDA device, the
hand-written kernels of ``csrc/sort_keys.cu`` (the batch's bounds, then a
key per ray: two launches, the same bits), counting its calls in a
``launches`` attribute; any other device raises (after the kernel
library's load, which raises without a card or nvcc), and there is no
fallback.
"""
from __future__ import annotations

import torch

from . import _kernels
from ._kernels import counted, launch as _launch, ptr as _ptr


def _spread3(x):
    """Interleave 7-bit ints with two zero bits (Morton): 0b1111111 ->
    0b1001001001001001001."""
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _quant(v, lo, hi, levels: float):
    span = (torch.clamp(hi - lo, min=1e-20) if torch.is_tensor(hi)
            else max(hi - lo, 1e-20))
    q = (v - lo) / span * levels
    return torch.clamp(q, 0.0, levels - 1.0).to(torch.int64)


def coherence_keys_plain(origin, direction):
    """Coherence key per ray as int64 holding the uint32 bit pattern (see
    module docstring), in torch ops."""
    lo = origin.amin(dim=0)
    hi = origin.amax(dim=0)
    qc = _quant(origin, lo, hi, 4.0)                        # [R,3] 2-bit
    coarse = qc[:, 0] | (qc[:, 1] << 2) | (qc[:, 2] << 4)   # 6 bits
    qf = _quant(origin, lo, hi, 32.0)                       # [R,3] 5-bit
    fine = (_spread3(qf[:, 0]) | (_spread3(qf[:, 1]) << 1)
            | (_spread3(qf[:, 2]) << 2)) & 0x7FFF           # 15 bits
    # 4 bits each from the two minor |direction| axes (scale-free in [0,1])
    ad = direction.abs()
    mx = ad.amax(dim=1, keepdim=True)
    r = ad / torch.clamp(mx, min=1e-20)                     # dominant axis -> 1
    axis = torch.argmax(ad, dim=1)
    # the two non-dominant ratios (dominant excluded by masking it to -1)
    lanes = torch.arange(3, device=origin.device)
    r0 = torch.where(lanes[None, :] == axis[:, None], torch.full_like(r, -1.0), r)
    top2 = torch.topk(r0, 2, dim=1).values                  # [R,2] in [0,1]
    db = (_quant(top2[:, 0], 0.0, 1.0, 16.0) << 4) | _quant(top2[:, 1], 0.0, 1.0, 16.0)
    octant = ((direction[:, 0] < 0).to(torch.int64)
              | ((direction[:, 1] < 0).to(torch.int64) << 1)
              | ((direction[:, 2] < 0).to(torch.int64) << 2))
    return (coarse << 26) | (octant << 23) | (db << 15) | fine


@counted()
def coherence_keys(origin, direction):
    """Coherence key per ray as int64 holding the uint32 bit pattern (see
    module docstring): origin and direction [R, 3] float32. CPU tensors take
    :func:`coherence_keys_plain`; CUDA tensors launch the kernels, which
    give its keys bit for bit. The keys carry no gradient."""
    if origin.device.type == "cpu":
        return coherence_keys_plain(origin, direction)
    lib = _kernels.load()
    dev = _kernels.card(origin.device)
    o, d = origin.detach().contiguous(), direction.detach().contiguous()
    n = o.shape[0] if o.dim() == 2 else -1      # -1: no [R, 3] matches
    _kernels.check(dev, "origin", o, torch.float32, (n, 3))
    _kernels.check(dev, "direction", d, torch.float32, (n, 3))
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        parts = torch.empty(lib.rz_ray_sort_partials(n), dtype=torch.float32,
                            device=dev)
        _launch(coherence_keys, lib.rz_ray_sort_keys, dev, _ptr(o), _ptr(d),
                n, _ptr(parts), _ptr(keys))
    return keys


def sort_payload(origin, direction, extras):
    """Coherence-sort rays with their per-ray columns.

    A stable ``torch.sort`` on the keys gives the permutation; every column
    is gathered through it. Returns (o_s, d_s, extras_s, idx_s) where
    ``idx_s`` is the original row of each sorted row; undo with
    :func:`unsort_payload`.
    """
    keys = coherence_keys(origin, direction)
    _, idx = torch.sort(keys, stable=True)
    return (origin[idx], direction[idx], tuple(e[idx] for e in extras), idx)


def unsort_payload(idx_s, outs):
    """Put per-ray results of sorted rays back in the original ray order."""
    result = []
    for y in outs:
        back = torch.empty_like(y)
        back[idx_s] = y
        result.append(back)
    return tuple(result)
