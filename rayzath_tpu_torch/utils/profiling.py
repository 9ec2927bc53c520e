"""Where the time goes: a traced render-cycle turn and the split of a
training step, under ``torch.profiler``.

* :func:`cycle_turn`: one turn of a render, eager ``render_steps`` pass by
  pass or graph replays of ``Renderer.render``: timed renders, one trace
  (busy ms, idle share, events per pass, device ms by group), the device's
  own ms per graph pass, capture ms, peak MiB and the host ms of
  ``render(rpp=16, block=False)``.
* :func:`split_step`: one training step under :func:`step_labels`, its
  device ms split into the forward passes, the checkpointed recompute, the
  shadow backward, the gathers' backward (per call site), the rest of the
  backward and the update, with the top device kernels and the device ms
  of torch's index backward (``indexing_backward_kernel*``, which no
  differentiable gather of the port should reach).

Busy time is the union of the device-side intervals (kernels, memcpy,
memset). The host-side ``aten::*`` rows of ``key_averages()`` carry the
device time of the kernels they launched, so summing every row would count
those kernels twice; only device-side events are read here.

Used by ``chip_smoke.py`` phases 5 and 7 and by ``tools/profile_torch.py``,
which also runs this file against an older checkout's package: it reads
only modules that every tree since the compiled training step has, and
the gather module where the imported tree has one.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

#: passes of a timed render per scene (the six scenes of phase 7)
PASSES = {"cornell_box_nee": 16, "multi_light": 8, "mesh_heavy": 8,
          "instanced_field": 8, "textured_room": 8, "cutout_world": 8}
#: device-time groups of a render trace, by kernel name
GROUPS = (("B1", ("closest_kernel",)),
          ("B2", ("shadow_kernel",)),
          ("B3", ("closest_inst_kernel",)),
          ("B4", ("shadow_inst_kernel",)),
          ("G1", ("::gather_kernel<", "::gather_vec_kernel<")),
          ("ray sort", ("topk", "TopK", "Sort", "sort")))
#: the parts of a training step's device time
SPLIT = ("forward", "recompute", "shadow backward", "gather backward",
         "other backward", "update")
LABELS = {"rz::forward": "forward", "rz::bounce": "recompute",
          "rz::shadow_backward": "shadow backward", "rz::update": "update"}
GATHER_LABEL = "rz::gather_backward "
#: torch's index backward (the backward of ``table[idx]``)
INDEX_BACKWARD = "indexing_backward_kernel"


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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


def make_world(name: str, res: int):
    """A scene of :data:`PASSES` at ``res``^2 (``cutout_world``: the
    texture-alpha cutout scene of ``utils/check_worlds.py``)."""
    from .. import scenes
    if name == "cutout_world":
        from .check_worlds import cutout_world
        return cutout_world(res)
    return scenes.SCENES[name](res, res)


def trace_device(fn, dev) -> tuple:
    """``fn()`` under ``torch.profiler`` (CPU and, on a card, CUDA
    activity), then a synchronize. Returns (wall ms, the device-side
    events)."""
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return wall_ms, events


def cycle_turn(renderer, mode: str, dev, res: int, passes: int, repeats: int,
               trace_passes: int, top: int = 0, seed: int = 0) -> dict:
    """One turn of ``mode`` ("eager" or "graph") on ``renderer``'s world
    (its compiled scene and first camera; depth as its config). Returns the
    turn's record; prints the top ``top`` device kernels of its trace."""
    from ..engine.integrator import render_steps
    from ..engine.state import init_state
    from ..models.device_scene import compile_camera
    from ..ops import rng
    from .cuda_timing import device_ms
    scene, cfg = renderer.update_scene(), renderer.config
    cam = renderer.world.cameras[0]
    rec = {"mode": mode, "res": res, "passes": passes}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if mode == "graph":
        renderer.views.clear()                  # a new view: a new capture
        renderer.render(rpp=1)
        view = renderer.views[id(cam)]

        def run(n, block=True):
            renderer.render(rpp=n, block=block)
    else:
        tcam = compile_camera(cam, dev)
        key = rng.key(seed)
        state = [init_state(cam.width, cam.height, dev)]

        def run(n, block=True):
            state[0] = render_steps(scene, tcam, cfg, state[0], key, n)
            if block:
                sync(dev)
        run(1)
    rec["first_ms"] = (time.perf_counter() - t0) * 1e3
    rec["capture_ms"] = view.cycle.capture_ms if mode == "graph" else None
    reps, walls = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(passes)
        dt = time.perf_counter() - t0
        walls.append(dt * 1e3)
        reps.append(passes * res * res / dt / 1e6)
    rec["mrays_s"] = reps
    rec["peak_mib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                       if dev.type == "cuda" else None)
    wall_ms, events = trace_device(lambda: run(trace_passes), dev)
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
    rec.update(profiled_passes=trace_passes, wall_ms=wall_ms, busy_ms=busy_ms,
               busy_ms_per_pass=busy_ms / trace_passes,
               idle_share=1.0 - busy_ms / wall_ms,
               events_per_pass=len(events) / trace_passes, groups_ms=groups)
    # an eager pass's ~1,000 launches fill the launch queue behind the
    # sleep of device_ms, so only a graph pass (one launch) is timed so
    rec["device_ms_per_pass"] = rec["timed_idle_share"] = None
    if dev.type == "cuda" and mode == "graph":
        rec["device_ms_per_pass"] = device_ms(
            lambda: run(1, block=False), launches=4, repeats=3)
        # the timed renders' idle share: their wall time against the
        # device's own time of as many passes
        rec["timed_idle_share"] = [1.0 - rec["device_ms_per_pass"] * passes / w
                                   for w in walls]
        sync(dev)
        t0 = time.perf_counter()
        run(16, block=False)
        rec["nonblocking_host_ms"] = (time.perf_counter() - t0) * 1e3
        sync(dev)
    for kname, (ms, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"   {ms:9.3f} ms  x{n:5d}  {kname[:90]}")
    return rec


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _site(frame) -> str:
    """A gather's call site: the caller's file, line and function, and,
    for a caller outside the integrator (the texture fetch, the opacity
    tables), the integrator's line that led there."""
    def where(f):
        return (f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} "
                f"{f.f_code.co_name}")

    site = where(frame)
    if os.path.basename(frame.f_code.co_filename) != "integrator.py":
        f = frame.f_back
        while f is not None and os.path.basename(f.f_code.co_filename) != \
                "integrator.py":
            f = f.f_back
        if f is not None:
            site += " < " + where(f)
    return site


def _site_gather(gather, index_backward: bool):
    """A ``gather_rows`` that runs as the package's, but whose backward runs
    in a ``rz::gather_backward <site>`` range: G2, or with
    ``index_backward`` torch's index backward of the ``table[idx]`` that
    ``gather_rows`` replaced (an accumulating ``index_put_``)."""
    class SiteGather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, table, idx, site):
            ctx.save_for_backward(idx)
            ctx.shape, ctx.site = table.shape, site
            return gather.gather_rows_fwd(table, idx)

        @staticmethod
        def backward(ctx, g):
            (idx,) = ctx.saved_tensors
            with record_function(GATHER_LABEL + ctx.site):
                if index_backward:
                    d = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
                    d.index_put_((idx.long(),), g, accumulate=True)
                else:
                    d = gather.gather_rows_grad(idx, g, ctx.shape[0])
            return d.reshape(ctx.shape), None, None

    def gather_rows(table, idx):
        if torch.is_grad_enabled() and table.requires_grad:
            return SiteGather.apply(table, idx, _site(sys._getframe(1)))
        return gather.gather_rows_fwd(table, idx)
    return gather_rows


@contextlib.contextmanager
def step_labels(index_backward: bool = False):
    """Wrap the pieces of a training step in profiler ranges: the loss
    (rz::forward), the integrator's ``bounce_step`` (rz::bounce: inside
    rz::forward a forward pass, else the checkpointed recompute under
    autograd's backward), the ``backward`` of every autograd Function of
    ``ops/traverse_cluster.py`` (rz::shadow_backward), ``train._project``
    (rz::update) and, where the package has ``ops/gather.py``, the backward
    of every differentiable ``gather_rows`` call (``rz::gather_backward
    <site>``, in every module that gathers through it; with
    ``index_backward`` that backward is torch's index backward, as the
    step had it before the gather's port)."""
    from ..engine import integrator
    from ..ops import traverse_cluster as tc
    from ..parallel import train

    def labelled(fn, label):
        def run(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return run

    saved = []

    def replace(owner, name, value):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    def patch(owner, name, label, wrap=lambda f: f):
        replace(owner, name, wrap(labelled(getattr(owner, name), label)))

    patch(train, "image_loss", "rz::forward")
    patch(integrator, "bounce_step", "rz::bounce")
    patch(train, "_project", "rz::update")
    for cls in vars(tc).values():
        if (isinstance(cls, type) and issubclass(cls, torch.autograd.Function)
                and "backward" in cls.__dict__):
            patch(cls, "backward", "rz::shadow_backward", staticmethod)
    package = integrator.__name__.rsplit(".", 2)[0]
    gather = sys.modules.get(package + ".ops.gather")
    if gather is not None:
        sited = _site_gather(gather, index_backward)
        for name, module in list(sys.modules.items()):
            if (name.startswith(package + ".") and module is not gather
                    and getattr(module, "gather_rows", None) is gather.gather_rows):
                replace(module, "gather_rows", sited)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def split_step(fn, dev, index_backward: bool = False) -> dict:
    """``fn()`` (one training step) under torch.profiler with
    :func:`step_labels`: its wall ms, device busy ms (the union of the
    device events) and idle share, and the device ms of each part of
    :data:`SPLIT`. Each device event goes to the innermost part whose range
    holds its launch on the host (the CUDA runtime call with its
    correlation id; else the torch op it is linked to): the shadow and the
    gathers' backward before the update, the update before the forward, a
    bounce outside the forward is the recompute, and the rest is the rest
    of the backward. The ranges' own spans on the device timeline are left
    out. Also the gathers' backward per call site (ms, kernels), the 12
    device kernels of most ms with their part, and the ms and count of
    torch's index-backward kernels."""
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with step_labels(index_backward), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()

    def label_of(name):
        if name.startswith(GATHER_LABEL):
            return "gather backward", name[len(GATHER_LABEL):]
        return LABELS.get(name), None

    ranges = []
    for e in events:
        part, site = label_of(e.name)
        if part is not None and e.device_type != DeviceType.CUDA:
            ranges.append((e.time_range.start, e.time_range.end, part, site))
    host = {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            host.setdefault(("op", e.id), e.time_range.start)
            if e.name.startswith("cu"):
                host[("runtime", e.id)] = e.time_range.start
    parts = dict.fromkeys(SPLIT, 0.0)
    kernels: dict = {}
    sites: dict = {}
    unattributed, device, index_ms, index_n = 0, [], 0.0, 0
    for e in events:
        # the ranges' own spans on the device timeline are no device work
        if (e.device_type != DeviceType.CUDA or label_of(e.name)[0] is not None
                or getattr(e, "is_user_annotation", False)):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        device.append((e.time_range.start, e.time_range.end))
        t = host.get(("runtime", e.id),
                     host.get(("op", getattr(e, "linked_correlation_id", None))))
        inside = ([] if t is None
                  else [(b - a, p, s) for a, b, p, s in ranges if a <= t <= b])
        unattributed += t is None
        labels = {p for _, p, _ in inside}
        part = next((p for p in ("shadow backward", "gather backward", "update",
                                 "forward", "recompute") if p in labels),
                    "other backward")
        parts[part] += ms
        if part == "gather backward":
            site = min((r for r in inside if r[1] == part))[2]
            s = sites.setdefault(site, [0.0, 0])
            s[0] += ms
            s[1] += 1
        if INDEX_BACKWARD in e.name:
            index_ms += ms
            index_n += 1
        k = kernels.setdefault((part, e.name[:80]), [0.0, 0])
        k[0] += ms
        k[1] += 1
    busy_ms = union_us(device) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "device_ms": parts,
            "device_events": len(device), "unattributed_events": unattributed,
            "index_backward_ms": index_ms, "index_backward_kernels": index_n,
            "gather_sites": dict(sorted(sites.items(), key=lambda kv: -kv[1][0])),
            "top": [[part, name, ms, n] for (part, name), (ms, n) in top]}
