"""Multi-process rendering on ``torch.distributed``: one row band per process.

Counterpart of ``rayzath_tpu/parallel/distributed.py``. Each process (rank)
owns one band of image rows on one device, the scene replicated; processes
communicate only at start-up and when the image is gathered:

* :func:`init_distributed` — one call per process before any other; no-op
  for single-process runs, so the same program works everywhere. NCCL on
  cards (each rank on ``cuda:LOCAL_RANK``), gloo where the caller passes
  ``device="cpu"``.
* :func:`global_mesh` — one band per rank, in rank order.
* :func:`init_state_distributed` — this rank's band of a fresh RenderState;
  no process holds the whole image.
* :func:`render_steps_distributed` — advances this rank's band at its
  ``row0``.
* :func:`gather_image` — ``all_gather`` of the bands' accumulation buffers,
  the full [H, W, 4] array in every process.

Process-count invariance: the row-keyed random streams make every row's
samples a function of (key, global row) only, so on the CPU an N-process
render equals a one-process render bit for bit
(``tests/test_torch_multidevice.py`` runs two gloo processes).

``python -m rayzath_tpu_torch.parallel.distributed --bench`` under
``torchrun`` (or with ``RZ_COORDINATOR`` / ``RZ_NUM_PROCESSES`` /
``RZ_PROCESS_ID`` set in every process) renders the headline config and
rank 0 prints rays/s. NCCL refuses two ranks on one card, so on a one-card
host it runs at world size 1.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..engine.integrator import render_steps
from ..engine.state import RenderState, init_state
from ..utils.device import DEFAULT, resolve
from .mesh import make_mesh, on_device, to_device


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=DEFAULT) -> int:
    """Join the process group (idempotent); returns this process's rank.

    Arguments default to ``RZ_COORDINATOR`` / ``RZ_NUM_PROCESSES`` /
    ``RZ_PROCESS_ID`` (as in the JAX package), else torchrun's
    ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``. With none of
    them set this is a single process: nothing is initialized and the rank
    is 0. ``device``: the card by default (NCCL, this rank on
    ``cuda:LOCAL_RANK``, raising without a card); ``"cpu"`` selects gloo."""
    if dist.is_initialized():
        return dist.get_rank()
    addr = coordinator_address or os.environ.get("RZ_COORDINATOR")
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    n = (num_processes if num_processes is not None
         else _env_int("RZ_NUM_PROCESSES", "WORLD_SIZE"))
    pid = (process_id if process_id is not None
           else _env_int("RZ_PROCESS_ID", "RANK"))
    if addr is None and n is None:
        return 0
    if addr is None or n is None or pid is None:
        raise ValueError(f"init_distributed needs a coordinator address, a "
                         f"process count and a process id; got {addr!r}, "
                         f"{n!r}, {pid!r}")
    dev = resolve(device)
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else pid % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=n, rank=pid)
    return pid


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(device=DEFAULT) -> List[torch.device]:
    """One band per rank, in rank order. Each process runs only its own
    band, on this rank's device (entry ``rank()``): the current card under
    NCCL, the CPU under gloo; ``device`` (the card by default) in a single
    process."""
    if dist.is_initialized():
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
    else:
        dev = make_mesh([device])[0]
    return [dev] * world_size()


def host_row_band(height: int, mesh: Optional[Sequence] = None) -> Tuple[int, int]:
    """[row0, row1) of the image owned by this process."""
    n = len(mesh) if mesh is not None else world_size()
    if height % n:
        raise ValueError(f"image height {height} not divisible by {n} ranks")
    rows = height // n
    return rank() * rows, (rank() + 1) * rows


def init_state_distributed(width: int, height: int,
                           mesh: Optional[Sequence] = None) -> RenderState:
    """This process's band of a fresh ``init_state(width, height)``, on its
    device: ``height`` is the band's."""
    mesh = mesh if mesh is not None else global_mesh()
    row0, row1 = host_row_band(height, mesh)
    return init_state(width, row1 - row0, mesh[rank()])


def render_steps_distributed(scene, cam, cfg, state: RenderState, key,
                             n_steps: int) -> RenderState:
    """Advance this process's band (from :func:`init_state_distributed`)
    ``n_steps`` bounce passes at ``row0 = rank() * band height``, with the
    scene and camera copied to the band's device."""
    dev = state.accum.device
    row0 = rank() * state.height
    with on_device(dev):
        return render_steps(to_device(scene, dev), to_device(cam, dev), cfg,
                            state, key, n_steps, row0=row0)


def gather_image(state: RenderState) -> np.ndarray:
    """The full [H, W, 4] accumulation buffer in every process:
    ``all_gather`` of the bands' (the one deliberate crossing between
    processes)."""
    if not dist.is_initialized():
        return state.accum.cpu().numpy()
    accum = state.accum.contiguous()
    parts = [torch.empty_like(accum) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, accum)
    return torch.cat(parts).cpu().numpy()


def _bench(argv=None) -> None:
    """Scaling probe: run in every process under torchrun."""
    import argparse
    import time
    from .. import scenes
    from ..engine.config import RenderConfig, Tracing
    from ..models.device_scene import compile_world, compile_camera
    from ..ops import rng

    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--scene", default="cornell_box")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--rpp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=8)
    args = ap.parse_args(argv)

    pid = init_distributed()
    mesh = global_mesh()
    dev = mesh[pid]
    world = scenes.SCENES[args.scene](args.size, args.size)
    cfg = RenderConfig(tracing=Tracing(max_depth=args.depth, rpp=args.rpp))
    scene = compile_world(world, device=dev)
    cam = compile_camera(world.cameras[0], dev)
    key = rng.key(0)
    state = init_state_distributed(args.size, args.size, mesh)
    state = render_steps_distributed(scene, cam, cfg, state, key, args.rpp)
    gather_image(state)                                  # warm-up + barrier
    t0 = time.perf_counter()
    state = render_steps_distributed(scene, cam, cfg, state, key, args.rpp)
    img = gather_image(state)
    dt = time.perf_counter() - t0
    rays = args.rpp * args.size * args.size
    if pid == 0:
        print({"ranks": world_size(), "device": str(dev),
               "rays_per_s": rays / dt,
               "mean": float(img[..., :3].mean())})
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _bench()
