"""Kernel times and the training step of the PyTorch/CUDA port
(``rayzath_tpu_torch``), on one card. Where a render's time goes is the
benchmark's (``benchmark/``: its traced runs read the renderer's spans).

    python3 tools/profile_torch.py [--res 512]

prints the kernel times below for this tree, as one JSON line.

``--parent DIR`` times the kernels of two trees on the same card in
turns (parent, change, change, parent): DIR holds another checkout of the
repository (``git archive <commit> | tar -x -C DIR``), and each turn is one
process that imports ``rayzath_tpu_torch`` from its tree, builds that
tree's kernels, times the table gathers G1 and G2 on the seeded calls of
:data:`GATHER_CASES` (:func:`gather_times`) and prints them and the
median ms of 20 launches of B1 and B2 on
mesh_heavy's, B3 and B4 on instanced_field's and B3 on two-level
multi_light's bounce-like rays (``chip_smoke.py`` phase 2's rays, in the
integrator's order; the shadow kernels with dist = BIG and the scene's
opacities), and of the threefry draw of one pass at ``--res``^2 x 14, both
its call and its kernel's median device duration in a ``torch.profiler``
trace of 20 calls, and the ray sort's key on 921,600 rays
(:func:`sort_key_times`), as one JSON line:

    python3 tools/profile_torch.py --parent build/parent

``--bounce`` traces the bounce's device work op by op instead
(:func:`bounce_turn`): one 1280x720 ``bounce_step`` of textured_room and
of instanced_field (``RenderConfig()``, no autograd, eager, after three
warm-up bounces), five of them in one ``torch.profiler`` trace, each
kernel's device ms and launches a bounce, grouped as the benchmark groups
them (``benchmark/lib/trace.py`` ``group_of``: the elementwise layer is
``other``). With ``--parent DIR`` in turns, one process each:

    python3 tools/profile_torch.py --bounce --parent build/parent

``--train`` times the training step instead (:func:`train_turn`) in the
training cell of ``rayzath_tpu_torch/utils/check_train.py`` (also
``chip_smoke.py`` phase 5's): textured_room at ``--res``^2, depth 3, 4
passes per step, remat, lr 0.01, against the same scene with its panel's
emission halved. The tree's eager step (``train._eager_step``, or
``training_step`` in a tree without the compiled step): a warm-up step,
three timed steps (s per step, peak GiB) and one step under
``torch.profiler`` split into device ms of the forward passes, the
checkpointed recompute, the shadow backward (everything under a
``backward`` of an autograd Function of ``ops/traverse_cluster.py``), the
gathers' backward per call site (where the tree has ``ops/gather.py``), the
rest of the backward and the projected update, with the step's wall ms,
idle share and the device ms of torch's index backward (``split_step`` of
``utils/profiling.py``, this tree's file for a tree without it); where the
tree has ``ops/gather.py``, the same split again with each gather's
backward taken by torch's index backward on the same call sites (what the
step ran before the gather's port, site by site); then, where the tree has
it, the compiled
step (``training_step``: one captured CUDA graph per step): the capture
call's s and ms, three timed steps, peak GiB. With ``--parent DIR`` the
turns run parent, change, change, parent (or the order ``--order`` names),
one process each:

    python3 tools/profile_torch.py --train --parent build/parent
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = 20        # timed launches per kernel in a --parent turn

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, runs: int) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` launches (CUDA events,
    after one warm-up call)."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_times(res: int) -> dict:
    """:func:`gather_times` and the median ms of B1 and B2 on mesh_heavy's,
    of B3 and B4 on instanced_field's and of B3 on two-level multi_light's
    (whose meshes have at most 8 clusters) bounce-like rays at ``res``^2:
    from just before each camera ray's first hit, in uniform-sphere
    directions from a numpy seed, in the order the integrator hands them
    to the kernels; the shadow kernels with dist = BIG and the scene's
    opacities. Uses the
    ``rayzath_tpu_torch`` found first on ``sys.path`` and only the API every
    tree since the two-level port has."""
    import numpy as np
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.models.device_scene import compile_camera, compile_world
    from rayzath_tpu_torch.ops import camera as cam_ops
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    from rayzath_tpu_torch.ops.intersect import BIG
    dev = torch.device("cuda")
    cfg = rt.RenderConfig()
    out = {"package": os.path.dirname(os.path.abspath(rt.__file__)),
           "gathers": gather_times()}
    for key, shadow_key, name, two_level in (
            ("b1", "b2", "mesh_heavy", None),
            ("b3", "b4", "instanced_field", None),
            ("b3_small", None, "multi_light", True)):
        world = rt.scenes.SCENES[name](res, res)
        scene = compile_world(world, two_level=two_level, device=dev)
        cam = compile_camera(world.cameras[0], dev)
        r = res * res
        if scene.two_level:
            fn, tabs = tc.cluster_closest_inst, (scene.ti_rows, scene.cl_obox,
                                                 scene.cl_lw)
            shadow, shadow_tabs = tc.cluster_shadow_inst, (
                *tabs, scene.cl_slot, scene.inst_slot_map, scene.mat_color)
        else:
            fn, tabs = tc.cluster_closest, (scene.cl_box, scene.cl_lw,
                                            scene.cl_order)
            mat = scene.mat_color[scene.tri_mat.long()]
            shadow, shadow_tabs = tc.cluster_shadow, (
                *tabs, scene.cl_base, scene.cl_count, mat[:, :3].contiguous(),
                (1.0 - mat[:, 3]).contiguous())
        o, d = cam_ops.generate_rays(cam, cam_ops.pixel_grid(res, res, device=dev),
                                     torch.full((r, 4), 0.5, device=dev))
        near = torch.zeros(r, device=dev)
        far = torch.full((r,), 1e30, device=dev)
        t = fn(o, d, near, far, *tabs)[0]
        hit = (t > 0) & (t < 1e30)
        p = torch.where(hit[:, None], o + d * (t * 0.9999)[:, None], o)
        v = np.random.default_rng(sum(map(ord, name))).normal(size=(r, 3))
        v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
        handed = []
        I._run_coherent(cfg, (res, res), p.contiguous(),
                        torch.as_tensor(v, device=dev), (near, far),
                        lambda *rays: handed.append(rays) or rays,
                        sort=I._sort_traversal(cfg, scene))
        o, d, near, far = handed[0]
        out[f"{key}_ms"] = cuda_ms(lambda: fn(o, d, near, far, *tabs), RUNS)
        out[f"{key}_scene"] = name
        t, tid = fn(o, d, near, far, *tabs)[:2]
        # equal sums in two trees: the same hits (a cheap cross-tree check)
        out[f"{key}_sums"] = [float(t.double().sum()), int(tid.long().sum())]
        if shadow_key:
            big = torch.full((r,), BIG, device=dev)
            out[f"{shadow_key}_ms"] = cuda_ms(
                lambda: shadow(o, d, big, *shadow_tabs), RUNS)
            out[f"{shadow_key}_scene"] = name
            rgb, a = shadow(o, d, big, *shadow_tabs)
            out[f"{shadow_key}_sums"] = [float(rgb.double().sum()),
                                         float(a.double().sum())]
    from rayzath_tpu_torch.ops import rng
    k = rng.fold_in(rng.key(1), 0)

    def draw():
        return rng.uniform_rows(k, 0, res, res, 14, dev)

    out["draw_call_ms"] = cuda_ms(draw, RUNS)
    kernel = [ms for name, t in trace_kernels(draw, RUNS).items()
              if "uniform_kernel" in name for ms in t]
    if len(kernel) != RUNS:
        raise RuntimeError(f"{len(kernel)} threefry kernels in the trace of "
                           f"{RUNS} draws")
    out["draw_ms"] = statistics.median(kernel)
    out["draw_sum"] = int(draw().view(torch.int32).long().sum())
    out["sort_keys"] = sort_key_times()
    return out


def sort_key_times(n: int = 1280 * 720) -> dict:
    """The ray sort's key (``ops/sort_rays.py`` ``coherence_keys``) of the
    imported tree on ``n`` seeded bounce-like rays (origins in a box, unit
    directions; 720p by default): the call's median ms, the device ms of
    each kernel it launches and their sum per call (a ``torch.profiler``
    trace of 20 calls), the median ms of a whole ``sort_payload`` call
    without extras, and a checksum of the keys, equal in two trees when
    both give the same keys."""
    import numpy as np
    from rayzath_tpu_torch.ops import sort_rays
    dev = torch.device("cuda")
    rng = np.random.default_rng(16)
    v = rng.normal(size=(n, 3))
    o = torch.as_tensor(rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32),
                        device=dev)
    d = torch.as_tensor((v / np.linalg.norm(v, axis=1, keepdims=True))
                        .astype(np.float32), device=dev)

    def keys():
        return sort_rays.coherence_keys(o, d)

    kernels = {name: sum(t) / RUNS
               for name, t in trace_kernels(keys, RUNS).items()}
    k = keys()
    return {"rays": n, "call_ms": cuda_ms(keys, RUNS),
            "device_ms": sum(kernels.values()), "kernels": kernels,
            "payload_call_ms": cuda_ms(
                lambda: sort_rays.sort_payload(o, d, ()), RUNS),
            "sum": int((k * torch.arange(1, n + 1, device=dev)).sum())}


# ---------------------------------------------------------------------------
# the table gathers, G1 and G2
# ---------------------------------------------------------------------------

#: the gather calls a --parent turn times, on fixed seeded arguments:
#: name -> (table shape, table dtype, index shape, index pattern, index
#: dtype, kernels). "mat": a training step's material table (262,144 rays
#: over [6, 14]: G1 and G2's fixed-order path), indices half in runs of 64,
#: half at random; "mat_one": the same table, every index on one row (the
#: medium row and n2 of a world medium); "blk": the texture fetch's block
#: lookup (``ops/texture.py`` ``blk_idx``, [8192, 4] int32, 262,144 int64
#: texel indices, as the fetch computes them); "corners": its texel fetch
#: on a [8192, 4] colour atlas, 262,144 rays x 4 bilinear corners =
#: 1,048,576 int32 rows (G1, and G2's atomic path)
GATHER_CASES = {
    "mat": ((6, 14), "float32", (262144,), "mixed", "int32", ("G1", "G2")),
    "mat_one": ((6, 14), "float32", (262144,), "one", "int32", ("G1", "G2")),
    "blk": ((8192, 4), "int32", (262144,), "runs", "int64", ("G1",)),
    "corners": ((8192, 4), "float32", (262144, 4), "corners", "int32",
                ("G1", "G2")),
}


def gather_args(case: str, dev):
    """(table, idx, cotangent) of a GATHER_CASES entry, from a numpy seed."""
    import numpy as np
    tab_shape, dtype, idx_shape, pattern, idx_dtype, _ = GATHER_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    n, r = tab_shape[0], idx_shape[0]
    if dtype == "int32":
        table = rng.integers(0, n, size=tab_shape).astype(np.int32)
    else:
        table = rng.uniform(-10, 10, size=tab_shape).astype(np.float32)
    runs = np.repeat(rng.integers(0, n, size=-(-r // 64)), 64)[:r]
    if pattern == "one":
        idx = np.full(r, 3)
    elif pattern == "mixed":
        idx = np.where(rng.uniform(size=r) < 0.5, runs,
                       rng.integers(0, n, size=r))
    elif pattern == "runs":
        idx = runs
    else:       # bilinear corners of a 64 x 128 texel map, coherent texels
        x = np.repeat(rng.integers(0, 127, size=-(-r // 16)), 16)[:r]
        y = np.repeat(rng.integers(0, 63, size=-(-r // 16)), 16)[:r]
        x = np.minimum(x + rng.integers(0, 2, size=r), 126)
        base = y * 128 + x
        idx = base[:, None] + np.array([0, 1, 128, 129])
    idx = torch.as_tensor(idx.astype(idx_dtype).reshape(idx_shape), device=dev)
    g = torch.as_tensor(rng.normal(size=idx_shape + tab_shape[1:])
                        .astype(np.float32), device=dev)
    return torch.as_tensor(table, device=dev), idx, g


def trace_kernels(fn, runs: int) -> dict:
    """The device ms of each kernel launch of ``runs`` calls of ``fn()``
    (after a warm-up call) in one ``torch.profiler`` trace: kernel name ->
    list of ms."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
    return by_name


def gather_times() -> dict:
    """G1 and G2 of the imported tree on GATHER_CASES: per call, the
    device ms (``utils/cuda_timing.device_ms``), the device ms of each
    kernel it launches (a ``torch.profiler`` trace, so a fill of scratch
    shows apart), the library call's device ms (``table[idx]`` for G1,
    ``index_add_`` for G2) and a checksum of the result's bits, equal in
    two trees when both are right (G2's atomic path aside: its sum's
    order varies)."""
    from rayzath_tpu_torch.ops import gather
    timing = tree_module("rayzath_tpu_torch.utils.cuda_timing", "device_ms")
    dev = torch.device("cuda")
    out = {}
    for case, (tab_shape, *_, kernels) in GATHER_CASES.items():
        table, idx, g = gather_args(case, dev)
        n, k = tab_shape[0], g.numel() // idx.numel()
        flat, g2 = idx.reshape(-1), g.reshape(-1, k)
        calls = {"G1": (lambda: gather.gather_rows_fwd(table, idx),
                        lambda: table[idx]),
                 "G2": (lambda: gather.gather_rows_grad(idx, g, n),
                        lambda: torch.zeros((n, k), device=dev).index_add_(
                            0, flat, g2))}
        for kernel in kernels:
            fn, library = calls[kernel]
            bits = fn().reshape(-1).view(torch.int32).long()
            out[f"{kernel}_{case}"] = {
                "ms": timing.device_ms(fn),
                "library_ms": timing.device_ms(library),
                "kernels": {name: statistics.median(t) * len(t) / RUNS
                            for name, t in trace_kernels(fn, RUNS).items()},
                "sum": int((bits * torch.arange(1, bits.numel() + 1,
                                                device=dev)).sum())}
    return out


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def tree_module(name: str, needs: str):
    """Module ``name`` of the imported tree or, where that tree's module is
    missing or lacks ``needs`` (an older checkout), this tree's file of it
    bound to the imported package."""
    try:
        module = importlib.import_module(name)
        if hasattr(module, needs):
            return module
    except ModuleNotFoundError:
        pass
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *name.split(".")) + ".py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def profiling():
    """``rayzath_tpu_torch.utils.profiling`` (the step's split) of the
    imported tree, or this tree's."""
    return tree_module("rayzath_tpu_torch.utils.profiling", "split_step")


def train_turn(dev, res: int) -> dict:
    """The training record of the imported tree (see the module
    docstring)."""
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.parallel import train
    cell = tree_module("rayzath_tpu_torch.utils.check_train", "timed_steps")
    prof = profiling()
    setup = cell.train_setup(dev, res)
    compiled = hasattr(train, "_eager_step")
    eager = train._eager_step if compiled else train.training_step
    rec = {"package": os.path.dirname(os.path.abspath(rt.__file__)),
           "res": res, **{k: cell.TRAIN[k] for k in ("depth", "passes", "lr")}}
    rec["eager"] = cell.timed_steps(eager, setup, dev)
    scene = rec["eager"].pop("scene")
    rec["eager"].pop("first")
    rec["split"] = prof.split_step(
        lambda: cell.step_call(eager, setup, scene, dev), dev)
    if "rayzath_tpu_torch.ops.gather" in sys.modules:
        rec["split_index"] = prof.split_step(
            lambda: cell.step_call(eager, setup, scene, dev), dev,
            index_backward=True)
    if compiled:
        train._STEPS.clear()
        rec["graph"] = cell.timed_steps(train.training_step, setup, dev)
        rec["graph"].pop("scene")
        rec["graph"].pop("first")
        step = next(iter(train._STEPS.values()))
        rec["graph"].update(capture_ms=step.capture_ms, captures=step.captures)
        train._STEPS.clear()
    return rec


def split_line(sp: dict) -> str:
    """One split of ``utils/profiling.split_step`` as text."""
    return (f"wall {sp['wall_ms']:.1f} ms, busy {sp['busy_ms']:.1f} ms, idle "
            f"{100 * sp['idle_share']:.1f}%, "
            + ", ".join(f"{k} {v:.2f}" for k, v in sp["device_ms"].items())
            + f" device ms ({sp['unattributed_events']} of "
            f"{sp['device_events']} events unattributed); torch's index "
            f"backward {sp.get('index_backward_ms', 0.0):.2f} ms in "
            f"{sp.get('index_backward_kernels', 0)} kernels; gather backward "
            "by site: " + "; ".join(f"{site} {ms:.2f} ms x{n}" for site, (ms, n)
                                    in sp.get("gather_sites", {}).items())
            + "; top kernels "
            + "; ".join(f"{part}: {name} {ms:.2f} ms x{n}"
                        for part, name, ms, n in sp["top"]))


def train_line(rec: dict) -> str:
    e = rec["eager"]
    line = (f"eager s per step {', '.join(f'{x:.3f}' for x in e['seconds'])} "
            f"(first {e['first_s']:.2f}), peak {e['peak_gib']} GiB; split of a "
            f"profiled step: {split_line(rec['split'])}")
    if "split_index" in rec:
        line += (f"; the same step with torch's index backward at every "
                 f"gather: {split_line(rec['split_index'])}")
    if "graph" in rec:
        g = rec["graph"]
        line += (f"; graph s per step {', '.join(f'{x:.3f}' for x in g['seconds'])}"
                 f" (capture call {g['first_s']:.2f} s, capture "
                 f"{g['capture_ms']:.1f} ms), peak {g['peak_gib']} GiB")
    return line


BOUNCE_SCENES = ("textured_room", "instanced_field")
BOUNCE_RUNS = 5


def bounce_turn(dev) -> dict:
    """Per scene of :data:`BOUNCE_SCENES` at 1280x720: the device ms and
    launches a bounce of each kernel over :data:`BOUNCE_RUNS` eager
    no-grad ``bounce_step`` calls in one trace, by the benchmark's groups,
    and the ms a bounce of each group."""
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.engine import integrator
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.models import device_scene as tds
    from rayzath_tpu_torch.ops import rng
    sys.path.insert(0, ROOT)
    from benchmark.lib.trace import group_of
    out = {}
    for name in BOUNCE_SCENES:
        world = rt.scenes.SCENES[name](1280, 720)
        scene = tds.compile_world(world, device=dev)
        cam = tds.compile_camera(world.cameras[0], dev)
        cfg = rt.RenderConfig()
        state = init_state(1280, 720, dev)
        key = rng.key(7)
        with torch.no_grad():
            for p in range(3):
                state = integrator.bounce_step(scene, cam, cfg, state,
                                               rng.fold_in(key, p))

            def bounce():
                integrator.bounce_step(scene, cam, cfg, state,
                                       rng.fold_in(key, 3))

            ops = trace_kernels(bounce, BOUNCE_RUNS)
        kernels = {k: {"ms": sum(t) / BOUNCE_RUNS,
                       "launches": len(t) / BOUNCE_RUNS, "group": group_of(k)}
                   for k, t in ops.items()}
        groups = {}
        for k in kernels.values():
            g = groups.setdefault(k["group"], {"ms": 0.0, "launches": 0.0})
            g["ms"] += k["ms"]
            g["launches"] += k["launches"]
        top = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:12]
        out[name] = {"groups": groups,
                     "top": [[k[:90], round(v["ms"], 4), v["launches"],
                              v["group"]] for k, v in top]}
    return out


def parent_turns(parent: str, res: int, kind: str = "kernels",
                 device: str = "cuda",
                 order: str = "parent,change,change,parent") -> list:
    """The records of ``kind`` ("kernels": the kernel times; "train": the
    training records on ``device``; "bounce": :func:`bounce_turn`'s) of
    the parent tree and this one, in turns (``order``: by default parent,
    change, change, parent), one process per turn."""
    recs = []
    for label in order.split(","):
        root = {"parent": parent, "change": ROOT}[label]
        turn = {"kernels": [], "bounce": ["--bounce-turn"],
                "train": ["--train-turn", "--device", device]}[kind]
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), *turn,
             "--root", os.path.abspath(root), "--res", str(res)],
            capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"{label} turn failed ({p.returncode}):\n"
                               f"{p.stderr[-4000:]}")
        rec = dict(json.loads(p.stdout.strip().splitlines()[-1]), tree=label)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parent", default=None,
                    help="another checkout: time its kernels against this one's")
    ap.add_argument("--train", action="store_true",
                    help="time the training step (with --parent: in turns)")
    ap.add_argument("--train-turn", action="store_true",
                    help="one --parent --train turn: the --root tree's record")
    ap.add_argument("--bounce", action="store_true",
                    help="trace the bounce op by op (with --parent: in turns)")
    ap.add_argument("--bounce-turn", action="store_true",
                    help="one --parent --bounce turn: the --root tree's record")
    ap.add_argument("--order", default="parent,change,change,parent",
                    help="with --parent --train: the trees' turns in order")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    dev = torch.device(args.device)
    if args.train_turn:
        print(json.dumps(train_turn(dev, args.res)), flush=True)
        return 0
    if args.bounce_turn or (args.bounce and not args.parent):
        print(json.dumps(bounce_turn(dev)), flush=True)
        return 0
    if args.bounce:
        for rec in parent_turns(args.parent, args.res, kind="bounce",
                                order=args.order):
            for name, r in rec.items():
                if name != "tree":
                    print(f"{rec['tree']} {name} bounce [{card_line()}]: "
                          + json.dumps(r), flush=True)
        return 0
    if args.train and not args.parent:
        rec = train_turn(dev, args.res)
        print(f"training step [{card_line()}]: {train_line(rec)}", flush=True)
        print(json.dumps(rec), flush=True)
    elif args.train:
        for rec in parent_turns(args.parent, args.res, kind="train",
                                device=args.device, order=args.order):
            print(f"{rec['tree']} training step [{card_line()}]: "
                  f"{train_line(rec)}", flush=True)
    elif args.parent:
        recs = parent_turns(args.parent, args.res)
        for key in ("b1_ms", "b2_ms", "b3_ms", "b4_ms", "b3_small_ms",
                    "draw_ms", "draw_call_ms"):
            print(f"{key} parent / change / change / parent [{card_line()}]: "
                  + ", ".join(f"{r[key]:.4f}" for r in recs), flush=True)
        for key in ("call_ms", "device_ms", "payload_call_ms", "sum"):
            print(f"sort key {key} parent / change / change / parent "
                  f"[{card_line()}]: "
                  + ", ".join(str(r["sort_keys"][key]) for r in recs),
                  flush=True)
        for key in recs[0]["gathers"]:
            print(f"{key} device ms parent / change / change / parent "
                  f"[{card_line()}]: "
                  + ", ".join(f"{r['gathers'][key]['ms']:.4f}" for r in recs)
                  + "; library " + ", ".join(
                      f"{r['gathers'][key]['library_ms']:.4f}" for r in recs),
                  flush=True)
    else:
        with torch.no_grad():
            print(json.dumps(kernel_times(args.res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
