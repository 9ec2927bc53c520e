"""Where the time goes in the PyTorch/CUDA port (``rayzath_tpu_torch``).

For each scene, on one device, at ``--res``^2 and depth 8: one warm-up
render, ``--repeats`` timed renders of the scene's pass count (wall clock,
each ending in ``torch.cuda.synchronize``), then one ``torch.profiler``
trace of ``--profile-passes`` passes. From the trace it prints the wall time,
the device's busy time, the idle share, the busy time by group (B1 closest
kernel, B2 shadow kernel, B3/B4 their instanced twins, ray sort, everything
else) and the top device kernels. ``cutout_world`` is the texture-alpha
cutout scene of ``rayzath_tpu_torch/utils/check_worlds.py``.

Busy time is the union of the device-side intervals (kernels, memcpy,
memset). The host-side ``aten::*`` rows of ``key_averages()`` carry the
device time of the kernels they launched, so summing every row would count
those kernels twice; only device-side events are read here.

    python3 tools/profile_torch.py [--scenes a,b] [--res 512] [--repeats 3]

``--device cpu`` at a small ``--res`` runs the same code without a card; the
trace then holds no device events. The last line per scene is one JSON
object with the numbers above.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import rayzath_tpu_torch as rt
from rayzath_tpu_torch.utils.check_worlds import cutout_world

PASSES = {"cornell_box_nee": 16, "multi_light": 8, "mesh_heavy": 8,
          "instanced_field": 8, "textured_room": 8, "cutout_world": 8}
WORLDS = dict(rt.scenes.SCENES, cutout_world=lambda w, h: cutout_world(w))
GROUPS = (("B1", ("closest_kernel",)),
          ("B2", ("shadow_kernel",)),
          ("B3", ("closest_inst_kernel",)),
          ("B4", ("shadow_inst_kernel",)),
          ("ray sort", ("topk", "TopK", "Sort", "sort")))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"
    return out.strip().splitlines()[0].strip()


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals, in microseconds."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_scene(name: str, dev, res: int, repeats: int, passes: int,
                  top: int) -> dict:
    world = WORLDS[name](res, res)
    r = rt.Renderer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=8)),
                    device=dev)
    r.render(rpp=4)
    sync(dev)
    rpp = PASSES[name]
    reps = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        r.render(rpp=rpp)
        sync(dev)
        dt = time.perf_counter() - t0
        reps.append(rpp * res * res / dt / 1e6)
        print(f"{name}: {rpp} passes in {dt * 1e3:.2f} ms = {reps[-1]:.3f} "
              f"Mrays/s", flush=True)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r.render(rpp=passes)
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = union_us([(e.time_range.start, e.time_range.end)
                        for e in events]) / 1e3
    groups = {g: 0.0 for g, _ in GROUPS}
    groups["other"] = 0.0
    per_kernel: dict[str, list] = {}
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        groups[group_of(e.name)] += ms
        k = per_kernel.setdefault(e.name, [0.0, 0])
        k[0] += ms
        k[1] += 1
    print(f"{name} profiled {passes} passes: wall {wall_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), device "
          f"events {len(events)} ({len(events) / passes:.0f} per pass)",
          flush=True)
    rows_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    print(f"   (sum over every key_averages() row, which counts a kernel under "
          f"its aten op as well: {rows_ms:.2f} ms)")
    for g, ms in groups.items():
        share = 100 * ms / busy_ms if busy_ms else 0.0
        print(f"   {g:>9}: {ms:9.3f} ms ({share:.1f}% of busy)")
    for kname, (ms, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"   {ms:9.3f} ms  x{n:5d}  {kname[:90]}")
    rec = {"scene": name, "res": res, "passes": rpp, "mrays_s": reps,
           "profiled_passes": passes, "wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms, "device_events": len(events),
           "groups_ms": groups}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", default=",".join(PASSES))
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--profile-passes", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    print(f"card: {card_line()}; torch {torch.__version__}", flush=True)
    with torch.no_grad():
        for name in args.scenes.split(","):
            profile_scene(name, dev, args.res, args.repeats,
                          args.profile_passes, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
