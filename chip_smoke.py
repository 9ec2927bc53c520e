#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rayzath_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. Environment: the card (``nvidia-smi``), torch and nvcc versions; build the
   hand-written kernels from ``rayzath_tpu_torch/csrc`` (timed) and the
   native library (``native/``, g++), and say which BVH builder runs.
2. Kernel against plain. The threefry kernel (``csrc/threefry.cu``) against
   ``ops/rng.py`` ``uniform_rows_plain`` on the card, bit for bit, on full
   512^2 passes at ns = 8 and 14, a band of rows at row0 > 0 at ns = 11 and
   an odd width; both timed on a 512^2 x 14 pass (median of 20), and its
   bound from the bytes written and the integer operations counted from
   the source over the int32 rate. Then B1 ``cluster_closest`` and B2 ``cluster_shadow``
   against their plain PyTorch versions on the card, for cornell_box_nee,
   multi_light and mesh_heavy, on 512^2 camera rays (u = 0.5) and 512^2
   bounce-like rays from the first hits (uniform-sphere directions from a
   numpy seed), in the order the integrator hands them over (32x32 tiles,
   or the coherence sort for scenes of >= 16 clusters); then B3
   ``cluster_closest_inst`` and B4 ``cluster_shadow_inst`` the same way on
   the two-level instanced_field (the plain versions on every 16th ray of
   the integrator's order: all 262,144 would take ~20 s a call) and on
   multi_light compiled two-level (all rays); B2 and B4 also with half the
   materials at alpha 0.5. B1 and B3 t, ids (and B3 instance ids) must
   equal the plain versions' bit for bit; shadow rgba to rtol 1e-5 / atol
   1e-6 where the plain alpha >= 1e-4, both below 1e-4 elsewhere. Median
   times of kernel and plain with CUDA events. On each timed (bounce-like)
   set: the needed visits per ray (the pairs of ray and (instance,) cluster
   whose exact slab interval meets [near, t_final], or for shadow
   (0, the first opaque hit or dist)), the visits per ray each kernel made
   (its optional visit counter, off the main path; at most twice the
   needed, or the phase fails), and each kernel's bound:
   max(bytes / 3.35 TB/s, operations / 67 TFLOP/s), the bytes being each
   input read once (rays, needed frame blocks, box and instance rows,
   opacity rows) and each output written once, the operations the needed
   triangle tests at 49 f32 operations each (plus 33 per needed instance
   for the object transform). Then B1 and B3 bit for bit on the tables of
   ``utils/check_tables.py``: exact ties across cluster and instance rows
   (also with near < 0 on every other ray), and walks of several windows
   of rows; B2 and B4 with dist = BIG on those window tables with
   translucent opacities, and on opaque walls hit by rays along (1, 1, 1)
   whose lines cross five times the needed clusters (at most twice the
   needed visits); and B1 and B2 on mesh_massive, whose table takes two
   windows (the plain versions on every 64th ray).
   Backward: B2's and B4's ``torch.autograd.Function`` (kernel forward,
   dense replay backward) against autograd through their plain twins on
   the card, for every input, on ``lit_world`` (tests/test_gradients.py) at
   64^2 bounce-like rays with half the materials at alpha 0.55 (B2) and on
   a two-level instanced_field(n=3, resolution=12) likewise (B4): the
   opacity (``mat_color``) gradient to rtol 1e-3 of its max |g|; the rays,
   the distance and the triangles get exactly zero from both (the product
   is piecewise constant in geometry). Cotangents are zero on rays whose
   plain alpha is below 1e-4 (the kernels stop there) or that an f64
   Moller-Trumbore calls chaotic. Then device times of the plain torch
   pieces of this slice at 512^2: the texture fetch, the cutout pass and
   B2's backward on textured_room.
3. End to end: cornell_box_nee and multi_light at 64^2, a two-level
   instanced_field(n=4, resolution=16), textured_room and the cutout world
   (each on both structures) at 64^2, depth 4, 4 passes, on the card
   (kernels) and on the CPU (plain versions) with the same numpy uniforms;
   sample counts equal, radiance as ``assert_images_match`` (frac 0.98 for
   textured_room, the JAX suite's own tolerance for its normal-mapped
   glossy bounces, ``tests/test_oracle_parity.py:85``). Then
   ``Renderer(seed=5)`` with no injected uniforms, card (threefry kernel)
   against CPU (plain draw) at 64^2, 3 passes and one more after: on
   cornell_box_nee; on multi_light with a camera move in between (the
   reprojection, which must seed samples); on cornell_box_nee with
   ``brute_force_threshold=64`` and on the empty world (the dense path,
   where B1 must not launch).
4. The slice at size: ``Renderer(device="cuda")`` renders cornell_box_nee
   (32 passes), multi_light, mesh_heavy, instanced_field (two-level by the
   automatic choice), textured_room and the cutout world (8 passes each) at
   512^2, depth 8; NaN-free, samples accumulated, image mean in (5, 220),
   and the launch counters of the path's two kernels and the threefry
   kernel (all five reset just before) at least one per pass. Then the
   slice's scene files: multi_light (soup, B1/B2) and instanced_field
   (two-level, B3/B4) written by the port's ``save_scene`` with one OBJ/MTL
   per mesh and an HDR sky, loaded into a fresh ``World`` and rendered at
   512^2, depth 8, 8 passes with no injected uniforms; then
   ``Renderer.focus``, a camera move, the reprojection alone (it must seed
   samples; its ``"temporal reproject"`` ms) and 8 more passes; Mrays/s,
   warm-up and launches of both renders.
5. Training: ``parallel.train.training_step`` on textured_room(512, 512),
   depth 3, 4 passes per step, remat, 3 steps at lr 0.01 against the same
   scene with the panel's emission halved (with 2 passes the panel never
   enters the image: pass 0 traces the initial placeholder rays, pass 1 the
   camera's first hits); the loss finite and descending, the atlas update
   finite and non-zero; seconds per step and peak device memory.
6. The front ends and the row-band runtime, at 512^2, depth 8 (training:
   depth 3, 4 passes). The headless runner in process (``Headless().run``
   with images saved, as ``-r``) on a task file of multi_light (soup) and
   instanced_field (two-level), each loaded from scene files, engine
   ``"CUDAGPU"``, rpp 64, timeout 30: the report's lines, a PNG per task
   (signature, IHDR 512x512), rays/s per task, and the launches of B1/B2,
   B3/B4 and the threefry kernel (all reset just before) at least one per
   pass; then ``python -m rayzath_tpu_torch --headless <tasks> <dir> -r``
   with rpp 8 in a subprocess, which must exit 0. ``Engine()`` on the
   default device renders cornell_box_nee bit for bit as
   ``Renderer(seed=0, device="cuda")``. The viewer on multi_light (port 0,
   4 passes per cycle): the page, ``/frame``, ``/stats``, ``/orbit`` (the
   next cycle reprojects), ``/pick`` at the centre (an instance),
   ``/focus``, ``/zoom``, ``/tree``, ``/props`` and an ``/edit`` of a
   roughness, which restarts the pass count; its rays/s. Row bands: 1, 2
   and 4 bands on the card against the unsharded render (4 passes) on
   cornell_box_nee and mesh_heavy, by ``images_match`` (sample counts
   equal; the bands' coherence sort changes B2's walk order, so shadow
   rgb may move in the last bits), with whether they came out
   bit-identical and each time. ``--scaling cornell_box_nee`` (its n = 1
   report on a one-card host). ``torch.distributed`` on NCCL at world size
   1: ``gather_image`` equals the plain render bit for bit.
   ``sharded_training_step`` over 2 bands of textured_room against phase
   5's first step: loss to rtol 1e-4, the update to 1e-4 of the step.

The last lines of standard output are the kernels' JSON record, the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``. The kernels' record lists B1-B4 and the
threefry kernel (``"replaces": null``: the JAX package draws in XLA), each
with its launches in phase 4 and in phase 6's headless run. Needs one CUDA
device and nvcc; there is no CPU fallback.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENES = ("cornell_box_nee", "multi_light", "mesh_heavy")
INST_SCENES = (("instanced_field", 16), ("multi_light", 1))  # (scene, stride)
RES = 512
PLAIN_BUDGET_MS = 8000.0     # timing budget of one plain version per scene
BACKWARD_RTOL = 1e-3         # B2/B4 backward against the plain twins' autograd
# cluster tests per ray at most this many times the needed visits: a walk
# without the front-to-back order and its stop also tests clusters behind
# the (opaque) hits
MADE_PER_NEEDED = 2.0


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def nvcc_release(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    m = re.search(r"release ([0-9.]+)", out)
    return m.group(1) if m else out.strip().splitlines()[-1]


def cuda_ms(fn, runs: int) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` launches (CUDA events,
    after one warm-up call)."""
    import torch
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


def plain_runs(fn) -> tuple[float, int]:
    """Median of up to 20 timed runs of a plain version, fewer when one run
    is slow (mesh_heavy's plain walk is an all-pairs pass over 65k
    triangles), so the script stays inside its time limit."""
    first = cuda_ms(fn, 1)
    runs = int(max(3, min(20, PLAIN_BUDGET_MS // max(first, 1e-3))))
    return cuda_ms(fn, runs), runs


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel call's work
# ---------------------------------------------------------------------------

HBM_BYTES_S = 3.35e12        # H100 SXM HBM3, published peak
F32_OPS_S = 67e12            # H100 SXM float32 outside the tensor cores
FRAME_BYTES = 4 * 3 * 128 * 4   # one cluster's frame block (rz_cluster.cuh)
# f32 operations of one ray-triangle test, counted from rz_cluster.cuh
# `project` and its caller: six dot products (3 x (3 mul + 3 add) +
# 3 x (3 mul + 2 add) = 33), the DET_EPS nudge (abs, compare, add: 3), the
# negation and the division (2), b1 and b2 (2 mul + 2 add: 4), the inside
# test (4 compares + 1 add: 5) and the caller's two t compares (2).
TEST_OPS = 49
# f32 operations of `to_object`: o' 3 x (3 mul + 3 add), d' 3 x (3 mul + 2 add)
TO_OBJECT_OPS = 33


def bound(n_bytes: float, n_ops: float,
          ops_s: float = F32_OPS_S) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their rate (float32 unless given), and which of the two
    it is."""
    tb, to = n_bytes / HBM_BYTES_S, n_ops / ops_s
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def coherent_order(scene, o, d, extras):
    """The ray order the integrator gives the kernels: its own
    ``_run_coherent`` and sort decision, with a ``run`` that keeps the rays
    it is handed."""
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.engine import integrator as I
    cfg = rt.RenderConfig()
    handed = []

    def keep(*rays):
        handed.append(rays)
        return rays

    I._run_coherent(cfg, (RES, RES), o, d, extras, keep,
                    sort=I._sort_traversal(cfg, scene))
    o, d, *extras = handed[0]
    return o, d, tuple(extras)


def scene_rays(name: str, dev):
    """(scene, camera rays, bounce-like rays), each ray set (o, d)."""
    import numpy as np
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.models.device_scene import compile_world, compile_camera
    from rayzath_tpu_torch.ops import camera as cam_ops
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    world = rt.scenes.SCENES[name](RES, RES)
    scene = compile_world(world, device=dev)
    cam = compile_camera(world.cameras[0], dev)
    r = RES * RES
    o, d = cam_ops.generate_rays(cam, cam_ops.pixel_grid(RES, RES, device=dev),
                                 torch.full((r, 4), 0.5, device=dev))
    t, tid = tc.cluster_closest_plain(o, d, torch.zeros(r, device=dev),
                                      torch.full((r,), 1e30, device=dev),
                                      scene.cl_box, scene.cl_lw)
    hit = tid >= 0
    tp = scene.tri_pack[torch.clamp(tid, min=0).long()]
    n = torch.linalg.cross(tp[:, 3:6], tp[:, 6:9])
    n = n / torch.clamp(n.norm(dim=1, keepdim=True), min=1e-20)
    n = torch.where(((n * d).sum(1) > 0)[:, None], -n, n)
    p = o + d * t[:, None] + n * (1e-4 * t)[:, None]
    o2 = torch.where(hit[:, None], p, o)
    rng = np.random.default_rng(sum(map(ord, name)))
    v = rng.normal(size=(r, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    d2 = torch.as_tensor(v, device=dev)
    return scene, (o, d), (o2.contiguous(), d2)


def world_rays(world, dev):
    """Camera rays (u = 0.5) of the world's first camera."""
    import torch
    from rayzath_tpu_torch.models.device_scene import compile_camera
    from rayzath_tpu_torch.ops import camera as cam_ops
    cam = compile_camera(world.cameras[0], dev)
    return cam_ops.generate_rays(cam, cam_ops.pixel_grid(RES, RES, device=dev),
                                 torch.full((RES * RES, 4), 0.5, device=dev))


def assert_bits(label, got, ref):
    """Raise unless every pair of tensors is equal bit for bit."""
    import torch
    for name, a, b in zip(("t", "id", "instance"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {int((a != b).sum())} of {len(a)} "
                                 f"{name} differ from the plain version")


def check_closest(box_tab, frames, order, o, d, near, far, label):
    """B1 kernel vs plain on one ray set, ids and t bit for bit. Returns
    the kernel's t and ids (original order)."""
    import torch
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    t_k, tid_k = tc.cluster_closest(o, d, near, far, box_tab, frames, order)
    t_p, rid_p = tc.cluster_closest_plain(o, d, near, far, box_tab, frames)
    torch.cuda.synchronize()
    assert_bits(label, (t_k, tid_k), (t_p, tc._map_ids(rid_p, order)))
    print(f"  {label}: B1 hits {int((tid_k >= 0).sum())}/{len(tid_k)}, ids and "
          "t bit for bit", flush=True)
    return t_k, tid_k


def shadow_gate(label, got, ref) -> float:
    """Raise unless the shadow rgba ``got`` meets the plain ``ref`` under the
    forward gate (rtol 1e-5 / atol 1e-6 where the plain alpha >= 1e-4, both
    below 1e-4 elsewhere). Returns the max abs error on the unblocked rays."""
    import torch
    (rgb_k, a_k), (rgb_p, a_p) = got, ref
    live = a_p >= 1e-4
    torch.testing.assert_close(a_k[live], a_p[live], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rgb_k[live], rgb_p[live], rtol=1e-5, atol=1e-6)
    if not bool((a_k[~live] < 1e-4).all()):
        raise AssertionError(f"{label}: kernel alpha >= 1e-4 where plain < 1e-4")
    if not bool(live.any()):
        return 0.0
    return max(float((a_k[live] - a_p[live]).abs().max()),
               float((rgb_k[live] - rgb_p[live]).abs().max()))


def check_shadow(scene, o, d, dist, label, mat_color=None):
    import torch
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    mc = scene.mat_color if mat_color is None else mat_color
    mat = mc[scene.tri_mat.long()]
    op_rgb, op_a = mat[:, :3].contiguous(), (1.0 - mat[:, 3]).contiguous()
    rgb_k, a_k = tc.cluster_shadow(o, d, dist, scene.cl_box, scene.cl_lw,
                                   scene.cl_order, scene.cl_base,
                                   scene.cl_count, op_rgb, op_a)
    op_tab = tc.cluster_opacity(op_rgb, op_a, scene.cl_order, scene.cl_base,
                                scene.cl_count)
    rgb_p, a_p = tc.cluster_shadow_plain(o, d, dist, scene.cl_box,
                                         scene.cl_lw, op_tab)
    torch.cuda.synchronize()
    err = shadow_gate(label, (rgb_k, a_k), (rgb_p, a_p))
    part = int(((a_p > 0) & (a_p < 1)).sum())
    print(f"  {label}: B2 unblocked {int((a_p >= 1e-4).sum())}/{len(a_p)}, "
          f"partial {part}, max |d rgba| {err:.3e}", flush=True)
    return err, op_rgb, op_a, op_tab


def visits_made(fn, r: int):
    """(cluster tests per ray, staged clusters per block) of one kernel call
    ``fn(visits)`` with the visit counter (off the main path)."""
    import torch
    blocks = -(-r // 128)
    visits = torch.zeros(r + blocks, dtype=torch.int32, device="cuda")
    fn(visits)
    torch.cuda.synchronize()
    return (float(visits[:r].sum()) / r, float(visits[r:].sum()) / blocks)


def check_made(label, made: float, needed: float) -> None:
    """Raise when a walk made more than MADE_PER_NEEDED times the needed
    visits per ray."""
    if made > MADE_PER_NEEDED * needed:
        raise AssertionError(f"{label}: {made:.3f} cluster tests per ray, more "
                             f"than {MADE_PER_NEEDED} x the {needed:.3f} needed")


def half_translucent(mat_color):
    """Every other material from index 2 at alpha 0.5, for products over
    translucent hits on the card."""
    mc = mat_color.clone()
    mc[2::2, 3] = 0.5
    return mc


def opaque_stop(t, hit, a_factor, big):
    """Per ray, where a shadow walk with dist = BIG may stop: the nearest
    hit when it is opaque (its 1 - alpha factor is 0), else BIG."""
    import torch
    return torch.where(hit & (a_factor == 0.0), t, big)


def phase_kernels(card: str, dev):
    import torch
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    from rayzath_tpu_torch.ops.intersect import BIG
    from rayzath_tpu_torch.utils.check_tables import needed_soup
    out = {"cluster_closest": {"err": 0.0}, "cluster_shadow": {"err": 0.0}}
    for name in SCENES:
        t0 = time.perf_counter()
        scene, cam_set, bounce_set = scene_rays(name, dev)
        tabs = (scene.cl_box, scene.cl_lw, scene.cl_order)
        r = RES * RES
        print(f"{name}: {scene.n_triangles} triangles, {scene.n_clusters} "
              f"clusters, rays {r} x 2 sets", flush=True)
        timing = {}
        for set_name, (o, d) in (("camera", cam_set), ("bounce", bounce_set)):
            near = torch.zeros(r, device=dev)
            far = torch.full((r,), 1e30, device=dev)
            o, d, (near, far) = coherent_order(scene, o, d, (near, far))
            t_k, tid_k = check_closest(*tabs, o, d, near, far,
                                       f"{name}/{set_name}")
            big = torch.full((r,), BIG, device=dev)
            dist_hit = torch.where(tid_k >= 0, t_k, big)
            e2, op_rgb, op_a, op_tab = check_shadow(
                scene, o, d, dist_hit, f"{name}/{set_name}/dist=hit")
            e3, *_ = check_shadow(scene, o, d, big, f"{name}/{set_name}/dist=BIG")
            e4, *_ = check_shadow(scene, o, d, big,
                                  f"{name}/{set_name}/dist=BIG,alpha=0.5",
                                  half_translucent(scene.mat_color))
            out["cluster_shadow"]["err"] = max(out["cluster_shadow"]["err"], e2,
                                               e3, e4)
            timing[set_name] = (o, d, near, far, big, op_rgb, op_a, op_tab,
                                t_k, tid_k)
        # times on the bounce-like set: the wavefront of every later bounce
        o, d, near, far, big, op_rgb, op_a, op_tab, t_k, tid_k = timing["bounce"]
        # the kernels first, before the plain versions' seconds of load
        k1 = cuda_ms(lambda: tc.cluster_closest(o, d, near, far, *tabs), 20)
        k2 = cuda_ms(lambda: tc.cluster_shadow(
            o, d, big, scene.cl_box, scene.cl_lw, scene.cl_order,
            scene.cl_base, scene.cl_count, op_rgb, op_a), 20)
        p1, n1 = plain_runs(lambda: tc.cluster_closest_plain(
            o, d, near, far, scene.cl_box, scene.cl_lw))
        p2, n2 = plain_runs(lambda: tc.cluster_shadow_plain(
            o, d, big, scene.cl_box, scene.cl_lw, op_tab))
        oc, dc, nc, fc, *_ = timing["camera"]
        kc = cuda_ms(lambda: tc.cluster_closest(oc, dc, nc, fc, *tabs), 20)
        # visits made against needed visits, and the bounds
        made, staged = visits_made(lambda v: tc.cluster_closest(
            o, d, near, far, *tabs, visits=v), r)
        pairs1, tests1, rows1, real = needed_soup(o, d, near, t_k, scene.cl_box)
        check_made(f"{name}/bounce B1", made, pairs1 / r)
        hit = tid_k >= 0
        stop = opaque_stop(t_k, hit, op_a[torch.clamp(tid_k, min=0).long()], big)
        pairs2, tests2, rows2, _ = needed_soup(o, d, torch.zeros_like(near),
                                               stop, scene.cl_box)
        made2, staged2 = visits_made(lambda v: tc.cluster_shadow(
            o, d, big, scene.cl_box, scene.cl_lw, scene.cl_order,
            scene.cl_base, scene.cl_count, op_rgb, op_a, visits=v), r)
        check_made(f"{name}/bounce B2", made2, pairs2 / r)
        b1 = bound(r * (32 + 8) + rows1 * FRAME_BYTES + real * 32,
                   tests1 * TEST_OPS)
        b2 = bound(r * (28 + 16) + rows2 * (FRAME_BYTES + 2048) + real * 32,
                   tests2 * TEST_OPS)
        print(f"  {name} times [{card}]: B1 kernel {k1:.3f} ms vs plain "
              f"{p1:.3f} ms (median of 20 / {n1}), bound {b1[0]:.4f} ms "
              f"({b1[1]}), visits per ray {made:.3f} made / {pairs1 / r:.3f} "
              f"needed, {staged:.2f} clusters staged per block; B2 kernel "
              f"{k2:.3f} ms vs plain {p2:.3f} ms (median of 20 / {n2}), bound "
              f"{b2[0]:.4f} ms ({b2[1]}), visits per ray {made2:.3f} made / "
              f"{pairs2 / r:.3f} needed, {staged2:.2f} clusters staged per "
              f"block; B1 on camera rays {kc:.3f} ms; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["cluster_closest"][name] = dict(
            ms=k1, plain_ms=p1, rays=r, plain_rays=r, bound=b1,
            needed_visits_per_ray=pairs1 / r, visits_per_ray=made)
        out["cluster_shadow"][name] = dict(
            ms=k2, plain_ms=p2, rays=r, plain_rays=r, bound=b2,
            needed_visits_per_ray=pairs2 / r, visits_per_ray=made2)
        del scene, cam_set, bounce_set, timing
        torch.cuda.empty_cache()
    return out


def inst_scene_rays(name: str, dev):
    """(two-level scene, camera rays, bounce-like rays): the bounce-like
    rays leave from just before each camera ray's first hit (found by the
    B3 kernel) in uniform-sphere directions from a numpy seed."""
    import numpy as np
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.models.device_scene import compile_world
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    world = rt.scenes.SCENES[name](RES, RES)
    scene = compile_world(world, two_level=True, device=dev)
    o, d = world_rays(world, dev)
    r = RES * RES
    t, tid, _ = tc.cluster_closest_inst(o, d, torch.zeros(r, device=dev),
                                        torch.full((r,), 1e30, device=dev),
                                        scene.ti_rows, scene.cl_obox, scene.cl_lw)
    p = torch.where((tid >= 0)[:, None], o + d * (t * 0.9999)[:, None], o)
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    v = rng.normal(size=(r, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return scene, (o, d), (p.contiguous(), torch.as_tensor(v, device=dev))


def check_closest_inst(tabs, o, d, near, far, sub, label):
    """B3 kernel on all rays vs plain on the rays ``sub``, t, ids and
    instance ids bit for bit. Returns the kernel's (t, ids, instance
    ids)."""
    import torch
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    got = tc.cluster_closest_inst(o, d, near, far, *tabs)
    ref = tc.cluster_closest_inst_plain(o[sub], d[sub], near[sub], far[sub],
                                        *tabs)
    torch.cuda.synchronize()
    assert_bits(label, [x[sub] for x in got], ref)
    print(f"  {label}: B3 hits {int((got[1] >= 0).sum())}/{len(got[1])}, plain "
          f"on {len(ref[1])} rays, t, ids and instances bit for bit", flush=True)
    return got


def check_shadow_inst(scene, o, d, dist, sub, mat_color, label):
    import torch
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    tabs = (scene.ti_rows, scene.cl_obox, scene.cl_lw, scene.cl_slot)
    rgb_k, a_k = tc.cluster_shadow_inst(o, d, dist, *tabs, scene.inst_slot_map,
                                        mat_color)
    op_tab = tc.instance_opacity(mat_color, scene.inst_slot_map)
    rgb_p, a_p = tc.cluster_shadow_inst_plain(o[sub], d[sub], dist[sub],
                                              *tabs, op_tab)
    torch.cuda.synchronize()
    err = shadow_gate(label, (rgb_k[sub], a_k[sub]), (rgb_p, a_p))
    part = int(((a_p > 0) & (a_p < 1)).sum())
    print(f"  {label}: B4 unblocked {int((a_p >= 1e-4).sum())}/{len(a_p)}, "
          f"partial {part}, max |d rgba| {err:.3e}", flush=True)
    return err, op_tab


def phase_inst_kernels(card: str, dev):
    """B3/B4 against their plain versions on two-level scenes."""
    import torch
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    from rayzath_tpu_torch.ops.intersect import BIG
    from rayzath_tpu_torch.utils.check_tables import needed_inst
    out = {"cluster_closest_inst": {"err": 0.0},
           "cluster_shadow_inst": {"err": 0.0}}
    for name, stride in INST_SCENES:
        t0 = time.perf_counter()
        scene, cam_set, bounce_set = inst_scene_rays(name, dev)
        r = RES * RES
        sub = torch.arange(0, r, stride, device=dev)
        n_ray_rows = int((scene.ti_rows[:, tc.TI_NCL] > 0).sum())
        print(f"{name} (two-level): {scene.n_triangles} object-space "
              f"triangles, {n_ray_rows} instances, up to {scene.max_ncl} "
              f"clusters per mesh, rays {r} x 2 sets, plain on {len(sub)}",
              flush=True)
        mc_half = half_translucent(scene.mat_color)
        tabs = (scene.ti_rows, scene.cl_obox, scene.cl_lw)
        timing = {}
        for set_name, (o, d) in (("camera", cam_set), ("bounce", bounce_set)):
            near = torch.zeros(r, device=dev)
            far = torch.full((r,), 1e30, device=dev)
            o, d, (near, far) = coherent_order(scene, o, d, (near, far))
            t_k, tid_k, inst_k = check_closest_inst(
                tabs, o, d, near, far, sub, f"{name}/{set_name}")
            big = torch.full((r,), BIG, device=dev)
            dist_hit = torch.where(tid_k >= 0, t_k, big)
            errs = [check_shadow_inst(scene, o, d, dist, sub, mc,
                                      f"{name}/{set_name}/{label}")[0]
                    for dist, mc, label in (
                        (dist_hit, scene.mat_color, "dist=hit"),
                        (big, scene.mat_color, "dist=BIG"),
                        (big, mc_half, "dist=BIG,alpha=0.5"))]
            out["cluster_shadow_inst"]["err"] = max(
                out["cluster_shadow_inst"]["err"], *errs)
            timing[set_name] = (o, d, near, far, big, t_k, tid_k, inst_k)
        # times on the bounce-like set: the kernels on all rays and on the
        # plain versions' subset, the plain versions on the subset
        o, d, near, far, big, t_k, tid_k, inst_k = timing["bounce"]
        op_tab = tc.instance_opacity(scene.mat_color, scene.inst_slot_map)
        os_, ds_, ns_, fs_, bs_ = (x[sub].contiguous()
                                   for x in (o, d, near, far, big))
        k3 = cuda_ms(lambda: tc.cluster_closest_inst(o, d, near, far, *tabs), 20)
        k3s = cuda_ms(lambda: tc.cluster_closest_inst(os_, ds_, ns_, fs_,
                                                      *tabs), 20)
        shadow_args = (scene.cl_slot, scene.inst_slot_map, scene.mat_color)
        k4 = cuda_ms(lambda: tc.cluster_shadow_inst(o, d, big, *tabs,
                                                    *shadow_args), 20)
        k4s = cuda_ms(lambda: tc.cluster_shadow_inst(os_, ds_, bs_, *tabs,
                                                     *shadow_args), 20)
        p3, n3 = plain_runs(lambda: tc.cluster_closest_inst_plain(
            os_, ds_, ns_, fs_, *tabs))
        p4, n4 = plain_runs(lambda: tc.cluster_shadow_inst_plain(
            os_, ds_, bs_, *tabs, scene.cl_slot, op_tab))
        oc, dc, nc, fc, *_ = timing["camera"]
        kc = cuda_ms(lambda: tc.cluster_closest_inst(oc, dc, nc, fc, *tabs), 20)
        # visits made against needed visits, and the bounds
        made, staged = visits_made(lambda v: tc.cluster_closest_inst(
            o, d, near, far, *tabs, visits=v), r)
        pairs3, tests3, ipairs3, cl3, in3, real = needed_inst(
            o, d, near, t_k, scene.ti_rows, scene.cl_obox)
        check_made(f"{name}/bounce B3", made, pairs3 / r)
        hit = tid_k >= 0
        a_factor = op_tab[torch.clamp(inst_k, min=0).long(), 3,
                          scene.tri_slot[torch.clamp(tid_k, min=0).long()].long()]
        stop = opaque_stop(t_k, hit, a_factor, big)
        pairs4, tests4, ipairs4, cl4, in4, _ = needed_inst(
            o, d, torch.zeros_like(near), stop, scene.ti_rows, scene.cl_obox)
        made4, staged4 = visits_made(lambda v: tc.cluster_shadow_inst(
            o, d, big, *tabs, *shadow_args, visits=v), r)
        check_made(f"{name}/bounce B4", made4, pairs4 / r)
        b3 = bound(r * (32 + 12) + cl3 * (FRAME_BYTES + 32) + real * 96,
                   tests3 * TEST_OPS + ipairs3 * TO_OBJECT_OPS)
        b4 = bound(r * (28 + 16) + cl4 * (FRAME_BYTES + 32 + 512) + real * 96
                   + in4 * 4 * 64 * 4, tests4 * TEST_OPS + ipairs4 * TO_OBJECT_OPS)
        print(f"  {name} times [{card}]: B3 kernel {k3:.3f} ms on {r} rays, "
              f"{k3s:.3f} ms on {len(sub)}, plain {p3:.3f} ms on {len(sub)} "
              f"(median of 20 / {n3}), bound {b3[0]:.4f} ms ({b3[1]}), "
              f"visits per ray {made:.3f} made / {pairs3 / r:.3f} needed "
              f"(instances {ipairs3 / r:.3f} needed), {staged:.2f} clusters "
              f"staged per block; B4 kernel {k4:.3f} ms on {r}, {k4s:.3f} ms "
              f"on {len(sub)}, plain {p4:.3f} ms on {len(sub)} (median of 20 / "
              f"{n4}), bound {b4[0]:.4f} ms ({b4[1]}), visits per ray "
              f"{made4:.3f} made / {pairs4 / r:.3f} needed, {staged4:.2f} "
              f"clusters staged per block; B3 on camera rays {kc:.3f} ms; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["cluster_closest_inst"][name] = dict(
            ms=k3, plain_ms=p3, rays=r, plain_rays=len(sub), bound=b3,
            needed_visits_per_ray=pairs3 / r, visits_per_ray=made)
        out["cluster_shadow_inst"][name] = dict(
            ms=k4, plain_ms=p4, rays=r, plain_rays=len(sub), bound=b4,
            needed_visits_per_ray=pairs4 / r, visits_per_ray=made4)
        del scene, cam_set, bounce_set, timing
        torch.cuda.empty_cache()
    return out


def phase_tables(dev):
    """B1 and B3 on the tables of ``utils/check_tables.py``: exact ties
    across cluster rows and instance rows (the later row entered first),
    the same with near < 0 on every other ray (blocks that walk in table
    order), and walks of several windows of rows; t and ids bit for bit."""
    import torch
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    from rayzath_tpu_torch.utils import check_tables as ct

    def rays(tabs, r, seed, behind):
        o, d = ct.aimed_rays(tabs["v0"], tabs["e1"], tabs["e2"], r, seed)
        near = torch.zeros(r, device=dev)
        if behind:
            near[::2] = -3.0
        return (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
                near, torch.full((r,), 1e30, device=dev))

    for label, make, r, behind in (
            ("tie table", ct.tie_tables, 16384, False),
            ("tie table, near < 0", ct.tie_tables, 16384, True),
            ("window table", ct.window_tables, 8192, False)):
        tabs = make()
        box, frames, order = (torch.as_tensor(tabs[k], device=dev)
                              for k in ("box_tab", "frames", "order"))
        ray_set = rays(tabs, r, 31, behind)
        check_closest(box, frames, order, *ray_set,
                      f"{label} ({tabs['real_rows']} cluster rows)")
        made, staged = visits_made(lambda v: tc.cluster_closest(
            *ray_set, box, frames, order, visits=v), r)
        print(f"    visits per ray {made:.3f}, clusters staged per block "
              f"{staged:.2f}", flush=True)
    for label, make, r, behind in (
            ("tie instance table", ct.tie_instance_tables, 16384, False),
            ("tie instance table, near < 0", ct.tie_instance_tables, 16384,
             True),
            ("window instance table", ct.window_instance_tables, 8192, False)):
        tabs = make()
        inst_tabs = tuple(torch.as_tensor(tabs[k], device=dev)
                          for k in ("ti_rows", "cl_obox", "frames"))
        ray_set = rays(tabs, r, 32, behind)
        check_closest_inst(inst_tabs, *ray_set, torch.arange(r, device=dev),
                           f"{label} ({inst_tabs[1].shape[0]} clusters)")
        made, staged = visits_made(lambda v: tc.cluster_closest_inst(
            *ray_set, *inst_tabs, visits=v), r)
        print(f"    visits per ray {made:.3f}, clusters staged per block "
              f"{staged:.2f}", flush=True)


def phase_shadow_tables(dev):
    """B2 and B4 on the tables of ``utils/check_tables.py`` with dist = BIG:
    translucent opacities on tables of several windows (B2: three windows
    of cluster rows; B4: a mesh of more clusters than one window), and
    opaque walls hit by rays along (1, 1, 1) whose lines cross five times
    the needed clusters, where a walk may make at most MADE_PER_NEEDED
    times the needed visits; rgba to the forward gate."""
    import torch
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    from rayzath_tpu_torch.utils import check_tables as ct

    def as_dev(tabs, keys):
        return [torch.as_tensor(tabs[k], device=dev) for k in keys]

    for case in ("window", "wall"):
        r = 8192
        big = torch.full((r,), 3.4e38, device=dev)
        zero = torch.zeros(r, device=dev)
        far = torch.full((r,), 1e30, device=dev)
        # B2
        tabs = (ct.window_tables() if case == "window"
                else ct.window_tables(rows=200, n=300, seed=8))
        box, frames, order = as_dev(tabs, ("box_tab", "frames", "order"))
        op = {k: torch.as_tensor(v, device=dev)
              for k, v in ct.soup_opacity(tabs, seed=33).items()}
        if case == "wall":
            op["op_a"].zero_()
        o, d = (torch.as_tensor(x, device=dev) for x in (
            ct.aimed_rays(tabs["v0"], tabs["e1"], tabs["e2"], r, 33)
            if case == "window" else
            ct.wall_rays(tabs["v0"], tabs["e1"], tabs["e2"], r)))
        args = (box, frames, order, op["base"], op["count"], op["op_rgb"],
                op["op_a"])
        ref = tc.cluster_shadow_plain(o, d, big, box, frames, tc.cluster_opacity(
            op["op_rgb"], op["op_a"], order, op["base"], op["count"]))
        label = f"{case} table ({tabs['real_rows']} cluster rows), B2"
        err = shadow_gate(label, tc.cluster_shadow(o, d, big, *args), ref)
        made, staged = visits_made(lambda v: tc.cluster_shadow(
            o, d, big, *args, visits=v), r)
        t = tc.cluster_closest_plain(o, d, zero, far, box, frames)[0]
        needed = ct.needed_soup(o, d, zero, t, box)[0] / r
        if case == "wall":
            check_made(label, made, needed)
        part = int(((ref[1] > 0) & (ref[1] < 1)).sum())
        print(f"  {label}: partial {part}/{r}, max |d rgba| {err:.3e}, visits "
              f"per ray {made:.3f} made / {needed:.3f} needed to the first hit, "
              f"{staged:.2f} clusters staged per block", flush=True)
        # B4
        tabs = (ct.window_instance_tables() if case == "window"
                else ct.window_instance_tables(rows=200, n=300, seed=9))
        ti, obox, frames = as_dev(tabs, ("ti_rows", "cl_obox", "frames"))
        mats = {k: torch.as_tensor(v, device=dev) for k, v in
                ct.instance_materials(tabs, seed=34, alpha=(
                    (0.05, 0.5) if case == "window" else (1.0, 1.0))).items()}
        o, d = (torch.as_tensor(x, device=dev) for x in (
            ct.aimed_rays(tabs["v0"], tabs["e1"], tabs["e2"], r, 34)
            if case == "window" else
            ct.wall_rays(tabs["v0"], tabs["e1"], tabs["e2"], r)))
        args = (ti, obox, frames, mats["cl_slot"], mats["inst_slot_map"],
                mats["mat_color"])
        ref = tc.cluster_shadow_inst_plain(
            o, d, big, ti, obox, frames, mats["cl_slot"],
            tc.instance_opacity(mats["mat_color"], mats["inst_slot_map"]))
        label = f"{case} instance table ({obox.shape[0]} clusters), B4"
        err = shadow_gate(label, tc.cluster_shadow_inst(o, d, big, *args), ref)
        made, staged = visits_made(lambda v: tc.cluster_shadow_inst(
            o, d, big, *args, visits=v), r)
        t = tc.cluster_closest_inst_plain(o, d, zero, far, ti, obox, frames)[0]
        needed = ct.needed_inst(o, d, zero, t, ti, obox)[0] / r
        if case == "wall":
            check_made(label, made, needed)
        part = int(((ref[1] > 0) & (ref[1] < 1)).sum())
        print(f"  {label}: partial {part}/{r}, max |d rgba| {err:.3e}, visits "
              f"per ray {made:.3f} made / {needed:.3f} needed to the first hit, "
              f"{staged:.2f} clusters staged per block", flush=True)


def phase_massive(card: str, dev):
    """B1 and B2 on mesh_massive, whose cluster table is larger than one
    ranked window: camera rays and bounce-like rays from their first hits
    (found by the kernel), in the integrator's order; B1 bit for bit and B2
    (dist = BIG, the scene's opacities and half of them at alpha 0.5) to
    the forward gate, against the plain versions on every 64th ray (all of
    them would take ~30 s a call), timed, with the visits made per ray."""
    import numpy as np
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.models.device_scene import compile_world
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    from rayzath_tpu_torch.ops.intersect import BIG
    t0 = time.perf_counter()
    world = rt.scenes.mesh_massive(RES, RES)
    scene = compile_world(world, device=dev)
    tabs = (scene.cl_box, scene.cl_lw, scene.cl_order)
    r = RES * RES
    real = int((scene.cl_box[tc.B_CNT] > 0).sum())
    print(f"mesh_massive: {scene.n_triangles} triangles, {real} clusters, "
          f"compiled in {time.perf_counter() - t0:.1f} s", flush=True)
    o, d = world_rays(world, dev)
    near = torch.zeros(r, device=dev)
    far = torch.full((r,), 1e30, device=dev)
    t = tc.cluster_closest(o, d, near, far, *tabs)[0]
    p = torch.where(((t > 0) & (t < 1e30))[:, None],
                    o + d * (t * 0.9999)[:, None], o)
    v = np.random.default_rng(29).normal(size=(r, 3))
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    sub = torch.arange(0, r, 64, device=dev)
    for set_name, (o_s, d_s) in (("camera", (o, d)),
                                 ("bounce", (p.contiguous(),
                                             torch.as_tensor(v, device=dev)))):
        o_s, d_s, (n_s, f_s) = coherent_order(scene, o_s, d_s, (near, far))
        got = tc.cluster_closest(o_s, d_s, n_s, f_s, *tabs)
        t_p, rid_p = tc.cluster_closest_plain(o_s[sub], d_s[sub], n_s[sub],
                                              f_s[sub], scene.cl_box,
                                              scene.cl_lw)
        torch.cuda.synchronize()
        assert_bits(f"mesh_massive/{set_name}", [x[sub] for x in got],
                    (t_p, tc._map_ids(rid_p, scene.cl_order)))
        ms = cuda_ms(lambda: tc.cluster_closest(o_s, d_s, n_s, f_s, *tabs), 10)
        made, staged = visits_made(lambda v: tc.cluster_closest(
            o_s, d_s, n_s, f_s, *tabs, visits=v), r)
        print(f"  mesh_massive/{set_name}: B1 hits {int((got[1] >= 0).sum())}"
              f"/{r}, plain on {len(sub)} rays bit for bit; {ms:.3f} ms "
              f"[{card}], visits per ray {made:.3f}, clusters staged per "
              f"block {staged:.2f}", flush=True)
        big = torch.full((r,), BIG, device=dev)
        for label, mc in (("", scene.mat_color),
                          (",alpha=0.5", half_translucent(scene.mat_color))):
            mat = mc[scene.tri_mat.long()]
            op = (mat[:, :3].contiguous(), (1.0 - mat[:, 3]).contiguous())
            shadow = (scene.cl_box, scene.cl_lw, scene.cl_order, scene.cl_base,
                      scene.cl_count, *op)
            got = tc.cluster_shadow(o_s, d_s, big, *shadow)
            ref = tc.cluster_shadow_plain(
                o_s[sub], d_s[sub], big[sub], scene.cl_box, scene.cl_lw,
                tc.cluster_opacity(*op, scene.cl_order, scene.cl_base,
                                   scene.cl_count))
            torch.cuda.synchronize()
            err = shadow_gate(f"mesh_massive/{set_name}/dist=BIG{label} B2",
                              [x[sub] for x in got], ref)
            ms = cuda_ms(lambda: tc.cluster_shadow(o_s, d_s, big, *shadow), 10)
            made, staged = visits_made(lambda v: tc.cluster_shadow(
                o_s, d_s, big, *shadow, visits=v), r)
            part = int(((ref[1] > 0) & (ref[1] < 1)).sum())
            print(f"  mesh_massive/{set_name}/dist=BIG{label}: B2 partial "
                  f"{part}/{len(sub)} on the plain's rays, max |d rgba| "
                  f"{err:.3e}; {ms:.3f} ms [{card}], visits per ray "
                  f"{made:.3f}, clusters staged per block {staged:.2f}",
                  flush=True)
    del scene, world
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2, backward: B2/B4 autograd.Functions against their plain twins
# ---------------------------------------------------------------------------

def translucent_half(world):
    """Every other user material at alpha 0.55."""
    import numpy as np
    for m in list(world.materials)[::2]:
        m.color = np.asarray([*m.color[:3], 0.55], np.float32)
    return world


def bounce_rays(scene, world, dev, res, seed):
    """Bounce-like rays: from just before each camera ray's first hit
    (plain twin), in uniform-sphere directions from a numpy seed."""
    import numpy as np
    import torch
    from rayzath_tpu_torch.models.device_scene import compile_camera
    from rayzath_tpu_torch.ops import camera as cam_ops
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    cam = compile_camera(world.cameras[0], dev)
    r = res * res
    o, d = cam_ops.generate_rays(cam, cam_ops.pixel_grid(res, res, device=dev),
                                 torch.full((r, 4), 0.5, device=dev))
    near, far = torch.zeros(r, device=dev), torch.full((r,), 1e30, device=dev)
    if scene.two_level:
        t = tc.cluster_closest_inst_plain(o, d, near, far, scene.ti_rows,
                                          scene.cl_obox, scene.cl_lw)[0]
    else:
        t = tc.cluster_closest_plain(o, d, near, far, scene.cl_box, scene.cl_lw)[0]
    hit = (t > 0) & (t < 1e30)
    p = torch.where(hit[:, None], o + d * (t * 0.9999)[:, None], o)
    v = np.random.default_rng(seed).normal(size=(r, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return p.contiguous(), torch.as_tensor(v, device=dev)


def _op(scene, mc):
    mat = mc[scene.tri_mat.long()]
    return mat[:, :3], 1.0 - mat[:, 3]


def shadow_fn(scene, leaves):
    """The shadow Function (B2, or B4 on a two-level scene) on fresh
    autograd leaves made from ``leaves`` = (origin, direction, dist,
    tri_v0, tri_e1, tri_e2, mat_color). Returns (rgb, a) and the leaves."""
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    xs = [x.detach().clone().requires_grad_(True) for x in leaves]
    o, d, dist, v0, e1, e2, mc = xs
    if scene.two_level:
        out = tc.cluster_shadow_inst(
            o, d, dist, scene.ti_rows, scene.cl_obox, scene.cl_lw,
            scene.cl_slot, scene.inst_slot_map, mc, tris=(v0, e1, e2),
            expanded=(scene.tri_slot, scene.exp_tri, scene.exp_inst,
                      scene.inst_fwd))
    else:
        out = tc.cluster_shadow(o, d, dist, scene.cl_box, scene.cl_lw,
                                scene.cl_order, scene.cl_base, scene.cl_count,
                                *_op(scene, mc), tris=(v0, e1, e2))
    return out, xs


def shadow_plain(scene, leaves):
    """The plain twin on fresh autograd leaves made from ``leaves`` =
    (origin, direction, dist, mat_color), its opacity table built
    differentiably. Returns (rgb, a) and the leaves."""
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    ys = [x.detach().clone().requires_grad_(True) for x in leaves]
    o, d, dist, mc = ys
    if scene.two_level:
        out = tc.cluster_shadow_inst_plain(
            o, d, dist, scene.ti_rows, scene.cl_obox, scene.cl_lw,
            scene.cl_slot, tc.instance_opacity(mc, scene.inst_slot_map))
    else:
        out = tc.cluster_shadow_plain(
            o, d, dist, scene.cl_box, scene.cl_lw,
            tc.cluster_opacity(*_op(scene, mc), scene.cl_order, scene.cl_base,
                               scene.cl_count))
    return out, ys


def check_backward(label, scene, o, d, dev):
    """Max relative error of the Function's gradients against autograd
    through the plain twin, over every input (see the module docstring)."""
    import numpy as np
    import torch
    from rayzath_tpu_torch.utils.parity import closest_f64, expand_instances
    r = o.shape[0]
    dist = torch.full((r,), 3e38, device=dev)
    fn, xs = shadow_fn(scene, (o, d, dist, scene.tri_v0, scene.tri_e1,
                               scene.tri_e2, scene.mat_color))
    plain, ys = shadow_plain(scene, (o, d, dist, scene.mat_color))
    tabs = [x.cpu().numpy() for x in (scene.tri_v0, scene.tri_e1, scene.tri_e2)]
    if scene.two_level:
        tabs = expand_instances(*(x.cpu().numpy() for x in (
            scene.ti_rows, scene.cl_obox, scene.inst_fwd)), *tabs)[:3]
    else:
        tabs = [x[:scene.n_triangles] for x in tabs]
    _, chaotic = closest_f64(o.cpu().numpy(), d.cpu().numpy(), *tabs)
    keep = (plain[1] >= 1e-4) & ~torch.as_tensor(chaotic, device=dev)
    rng = np.random.default_rng(17)
    g = (torch.as_tensor(rng.normal(size=(r, 3)).astype(np.float32), device=dev)
         * keep[:, None],
         torch.as_tensor(rng.normal(size=r).astype(np.float32), device=dev) * keep)
    for a, b in zip(fn, plain):
        torch.testing.assert_close(a[keep].detach(), b[keep].detach(),
                                   rtol=1e-5, atol=1e-6)
    got = torch.autograd.grad(fn, xs, g, allow_unused=True, materialize_grads=True)
    ref = torch.autograd.grad(plain, ys, g, allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    ref_mc = ref[3]
    err = float((got[6] - ref_mc).abs().max() / ref_mc.abs().max())
    zero = max(float(x.abs().max()) for x in (*got[:6], *ref[:3]))
    if not err <= BACKWARD_RTOL:
        raise AssertionError(f"{label}: mat_color gradient max rel err {err:.3e} "
                             f"> {BACKWARD_RTOL}")
    if zero != 0.0:
        raise AssertionError(f"{label}: a ray or triangle gradient is {zero}, "
                             "not 0")
    part = int(((plain[1] > 0) & (plain[1] < 1)).sum())
    print(f"  {label}: backward on {r} rays ({part} partial products, "
          f"{int(keep.sum())} with a cotangent): mat_color max rel err "
          f"{err:.3e} (rtol {BACKWARD_RTOL}); rays, dist and triangles 0",
          flush=True)
    return err


def phase_backward(card: str, dev):
    """B2/B4 backwards against the plain twins, then times of the plain
    pieces of this slice at 512^2."""
    import numpy as np
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.models.device_scene import compile_world
    from rayzath_tpu_torch.ops import texture as tex_ops
    from rayzath_tpu_torch.utils import check_worlds
    out = {}
    world = translucent_half(check_worlds.lit_world(64))
    scene = compile_world(world, device=dev)
    out["cluster_shadow"] = check_backward(
        "lit_world 64^2 (B2)", scene, *bounce_rays(scene, world, dev, 64, 21), dev)
    world = translucent_half(rt.scenes.instanced_field(64, 64, n=3, resolution=12))
    scene = compile_world(world, two_level=True, differentiable=True, device=dev)
    out["cluster_shadow_inst"] = check_backward(
        "instanced_field(n=3, resolution=12) two-level 64^2 (B4)", scene,
        *bounce_rays(scene, world, dev, 64, 22), dev)

    # device times of the slice's plain torch pieces at 512^2
    r = RES * RES
    rng = np.random.default_rng(23)
    world = rt.scenes.textured_room(RES, RES)
    scene = compile_world(world, device=dev)
    o, d = bounce_rays(scene, world, dev, RES, 24)
    uv = torch.as_tensor(rng.uniform(-1, 2, (r, 2)).astype(np.float32), device=dev)
    tex_id = torch.zeros(r, dtype=torch.int32, device=dev)
    t_fetch = cuda_ms(lambda: tex_ops.fetch_scene(scene, tex_id, uv, atlas=0), 20)
    dist = torch.full((r,), 3e38, device=dev)
    leaves = (o, d, dist, scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.mat_color)
    g = (torch.ones(r, 3, device=dev), torch.ones(r, device=dev))

    def fwd():
        return shadow_fn(scene, leaves)[0]

    def fwd_bwd():
        fn, xs = shadow_fn(scene, leaves)
        torch.autograd.grad(fn, xs[6], g)

    torch.cuda.reset_peak_memory_stats()
    t_fwd = cuda_ms(fwd, 5)
    t_bwd = cuda_ms(fwd_bwd, 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cworld = check_worlds.cutout_world(RES)
    cscene = compile_world(cworld, device=dev)
    co, cd = bounce_rays(cscene, cworld, dev, RES, 25)
    t_cut = cuda_ms(lambda: I.texture_shadow_factor(cscene, co, cd, dist), 20)
    print(f"  plain pieces at {RES}^2 [{card}]: texture fetch (color atlas) "
          f"{t_fetch:.3f} ms; cutout pass ({cscene.n_cutout} cutouts) "
          f"{t_cut:.3f} ms; B2 Function forward (kernel) {t_fwd:.3f} ms, "
          f"forward + backward (dense replay over {scene.tri_v0.shape[0]} "
          f"triangles) {t_bwd:.3f} ms, peak {peak:.2f} GiB", flush=True)
    out["times"] = dict(fetch_ms=t_fetch, cutout_ms=t_cut, b2_fwd_ms=t_fwd,
                        b2_fwd_bwd_ms=t_bwd)
    return out


# ---------------------------------------------------------------------------
# phase 2, the draw: the threefry kernel against its plain version
# ---------------------------------------------------------------------------

# 32-bit integer operations per second: a quarter of the float32 rate above,
# since an H100 SM has half as many INT32 lanes as FP32 lanes (64 vs 128)
# and the float32 rate counts a fused multiply-add as two operations
INT32_OPS_S = F32_OPS_S / 4
# integer operations of one threefry2x32, counted from csrc/threefry.cu: the
# two initial key adds, 20 rounds of (add, rotate, xor) and five key
# injections of two adds each (the constant folds into the key word)
HASH_OPS = 2 + 20 * 3 + 5 * 2
# per drawn float: the x0 ^ x1, the shift, the or and the float subtract
UNIT_OPS = 4
# (seed, pass, row0, rows, width, ns): full passes at the n_streams of the
# scenes (8, plus 3 per kind of light: 11, 14), a band at row0 > 0, and an
# odd width whose rows end inside a block
THREEFRY_SETS = ((0, 0, 0, RES, RES, 8), (7, 3, 0, RES, RES, 14),
                 (2 ** 31 - 1, 11, 300, 100, RES, 11), (5, 2, 17, 64, 513, 14))
THREEFRY_NS = (8, 11, 14)


def phase_threefry(card: str, dev):
    """The threefry kernel bit for bit against ``uniform_rows_plain`` on the
    card, then both timed on a full pass at ns = 14, and its bound."""
    import torch
    from rayzath_tpu_torch.ops import rng
    for seed, pass_idx, row0, h, w, ns in THREEFRY_SETS:
        k = rng.fold_in(rng.key(seed), pass_idx)
        got = rng.uniform_rows(k, row0, h, w, ns, dev)
        ref = rng.uniform_rows_plain(k, row0, h, w, ns, dev)
        torch.cuda.synchronize()
        if got.shape != (h * w, ns) or not torch.equal(
                got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"threefry seed {seed} pass {pass_idx} rows "
                                 f"{row0}+{h} width {w} ns {ns}: "
                                 f"{int((got != ref).sum())} floats differ")
        print(f"  threefry seed {seed} pass {pass_idx} rows {row0}+{h} x "
              f"{w} x {ns}: bit for bit, range [{float(got.min()):.6f}, "
              f"{float(got.max()):.6f}]", flush=True)
    k = rng.fold_in(rng.key(1), 0)
    h, w, ns = RES, RES, THREEFRY_NS[-1]
    ms = cuda_ms(lambda: rng.uniform_rows(k, 0, h, w, ns, dev), 20)
    plain_ms = cuda_ms(lambda: rng.uniform_rows_plain(k, 0, h, w, ns, dev), 20)
    n = h * w * ns
    # bytes: the uniforms written once (the key is an argument); operations:
    # one hash per row key and one hash and conversion per float
    b = bound(n * 4, n * (HASH_OPS + UNIT_OPS) + h * HASH_OPS, INT32_OPS_S)
    print(f"  threefry times [{card}]: {h}^2 x {ns} uniforms, kernel {ms:.4f} ms "
          f"vs plain {plain_ms:.3f} ms (median of 20), bound {b[0]:.4f} ms "
          f"({b[1]})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound=b, err=0.0)


# ---------------------------------------------------------------------------
# phase 3: end to end on the card against the CPU plain path
# ---------------------------------------------------------------------------

def render_passes(make_world, dev, res, passes, depth, seed, two_level=None):
    import numpy as np
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.models.device_scene import compile_world, compile_camera
    world = make_world(res)
    scene = compile_world(world, two_level=two_level, device=dev)
    cam = compile_camera(world.cameras[0], dev)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=depth))
    ns = I.n_streams(cfg, scene)
    rng = np.random.default_rng(seed)
    st = init_state(res, res, dev)
    for _ in range(passes):
        u = torch.as_tensor(rng.random((res * res, ns), dtype=np.float32),
                            device=dev)
        st = I.bounce_step(scene, cam, cfg, st, u=u)
    return st.accum.cpu().numpy()


def phase_end_to_end(dev):
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.utils import check_worlds
    from rayzath_tpu_torch.utils.parity import images_match
    cases = [(name, lambda res, name=name: rt.scenes.SCENES[name](res, res),
              None, 0.995) for name in ("cornell_box_nee", "multi_light")]
    cases.append(("instanced_field(n=4, resolution=16), two-level",
                  lambda res: rt.scenes.instanced_field(res, res, n=4,
                                                        resolution=16), True,
                  0.995))
    for two_level in (False, True):
        shape = "two-level" if two_level else "soup"
        cases.append((f"textured_room, {shape}",
                      lambda res: rt.scenes.textured_room(res, res), two_level,
                      0.98))
        cases.append((f"cutout world, {shape}", check_worlds.cutout_world,
                      two_level, 0.995))
    for label, make_world, two_level, frac in cases:
        a_gpu = render_passes(make_world, dev, 64, 4, 4, 7, two_level)
        a_cpu = render_passes(make_world, "cpu", 64, 4, 4, 7, two_level)
        close = images_match(a_gpu, a_cpu, frac=frac)
        print(f"{label}: 64^2 x 4 passes, CUDA kernels vs CPU plain: sample "
              f"counts equal, {close:.4f} of pixels within 2e-3 (frac "
              f"{frac})", flush=True)
    phase_seeded(dev)


def seeded_render(make_world, dev, cfg, passes, move):
    """``Renderer(seed=5)`` on ``dev`` with no injected uniforms: ``passes``
    passes, then ``move(world)`` and one more pass. Returns the accumulation
    [H,W,4] and the B1 launches."""
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    world = make_world()
    r = rt.Renderer(world, cfg, seed=5, device=dev)
    before = tc.cluster_closest.launches
    r.render(rpp=passes)
    move(world)
    r.render(rpp=1)
    accum = r.views[id(world.cameras[0])].state.accum.cpu().numpy()
    return accum, tc.cluster_closest.launches - before


def phase_seeded(dev):
    """Renders from a seed on the card (threefry kernel) against the CPU
    (plain draw): no injected uniforms, a reprojecting camera move, the
    dense path and the empty world; sample counts equal, radiance as
    ``images_match``."""
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.utils.check_worlds import empty_world
    from rayzath_tpu_torch.utils.parity import images_match
    res = 64
    tracing = rt.Tracing(max_depth=4)

    def still(world):
        pass

    def look_aside(world):
        world.cameras[0].look_at((0.1, 0.0, 1.0))

    cases = (
        ("cornell_box_nee, no injected uniforms", "cornell_box_nee",
         rt.RenderConfig(tracing=tracing), still),
        ("multi_light, camera move (reprojection)", "multi_light",
         rt.RenderConfig(tracing=tracing), look_aside),
        ("cornell_box_nee, brute_force_threshold=64 (dense path)",
         "cornell_box_nee",
         rt.RenderConfig(brute_force_threshold=64, tracing=tracing), still),
        ("the empty world (dense path)", "empty",
         rt.RenderConfig(tracing=tracing), still))
    for label, name, cfg, move in cases:
        def make(name=name):
            if name == "empty":
                return empty_world(res)
            return rt.scenes.SCENES[name](res, res)
        a_gpu, b1 = seeded_render(make, dev, cfg, 3, move)
        a_cpu, _ = seeded_render(make, "cpu", cfg, 3, move)
        close = images_match(a_gpu, a_cpu)
        samples = float(a_gpu[..., 3].sum())
        if move is look_aside and not samples > res * res:
            raise AssertionError(f"{label}: the reprojection seeded no samples")
        if cfg.brute_force_threshold or name == "empty":
            if b1:
                raise AssertionError(f"{label}: B1 launched {b1} times")
        elif not b1:
            raise AssertionError(f"{label}: B1 never launched")
        if not float(a_gpu[..., :3].max()) > 0.0:
            raise AssertionError(f"{label}: black image")
        print(f"{label}: {res}^2, Renderer(seed=5) 3 + 1 passes, CUDA vs CPU: "
              f"sample counts equal ({samples:.0f} samples), {close:.4f} of "
              f"pixels within 2e-3, B1 launches {b1}", flush=True)


# ---------------------------------------------------------------------------
# phase 4: the slice at size through the public entry point
# ---------------------------------------------------------------------------

def path_wrappers() -> dict:
    """{label: wrapper} of the main path's kernels; each wrapper counts
    the launches of its kernel in its ``launches`` attribute."""
    from rayzath_tpu_torch.ops import rng
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    return {"B1": tc.cluster_closest, "B2": tc.cluster_shadow,
            "B3": tc.cluster_closest_inst, "B4": tc.cluster_shadow_inst,
            "threefry": rng.uniform_rows}


def phase_slice(card: str, dev):
    """Returns the launches per kernel label of the six renders."""
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.utils import check_worlds
    wrappers = path_wrappers()
    launches = dict.fromkeys(wrappers, 0)
    for name, rpp in (("cornell_box_nee", 32), ("multi_light", 8),
                      ("mesh_heavy", 8), ("instanced_field", 8),
                      ("textured_room", 8), ("cutout world", 8)):
        world = (check_worlds.cutout_world(RES) if name == "cutout world"
                 else rt.scenes.SCENES[name](RES, RES))
        r = rt.Renderer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=8)),
                        device=dev)
        t0 = time.perf_counter()
        r.render(rpp=1)                      # warm-up: compile_world + 1 pass
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        for f in wrappers.values():
            f.launches = 0
        t0 = time.perf_counter()
        r.render(rpp=rpp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: f.launches for k, f in wrappers.items()}
        path = (("B3", "B4") if r.scene.two_level else ("B1", "B2")) + (
            "threefry",)
        if name == "instanced_field" and not r.scene.two_level:
            raise AssertionError("instanced_field did not compile two-level")
        if name == "textured_room" and r.scene.map_kinds_used != (True,) * 5:
            raise AssertionError("textured_room does not use every map kind")
        if name == "cutout world" and r.scene.n_cutout != 2:
            raise AssertionError("the cutout world has no cutout set")
        if min(counts[k] for k in path) < rpp:
            raise AssertionError(f"{name}: launches {counts} < {rpp} passes")
        for k in path:
            launches[k] += counts[k]
        accum = r.views[id(world.cameras[0])].state.accum
        if bool(torch.isnan(accum).any()):
            raise AssertionError(f"{name}: NaN in accum")
        if not float(accum[..., 3].sum()) > 0:
            raise AssertionError(f"{name}: no samples accumulated")
        mean = float(r.image().mean())
        if not 5.0 < mean < 220.0:
            raise AssertionError(f"{name}: image mean {mean} outside (5, 220)")
        mrays = rpp * RES * RES / dt / 1e6
        shown = " ".join(f"{k} {counts[k]}" for k in path)
        print(f"{name}: {RES}^2 depth 8, {rpp} passes in {dt:.3f} s = "
              f"{mrays:.3f} Mrays/s, warm-up {warm:.2f} s, launches {shown}, "
              f"image mean {mean:.1f} [{card}]", flush=True)
        del r, world
        torch.cuda.empty_cache()
    return launches


def phase_files(card: str, dev, launches: dict):
    """The slice's scene files: multi_light (soup) and instanced_field
    (two-level by the automatic choice) written with the port's own
    ``save_scene`` plus one OBJ/MTL per mesh and an HDR sky
    (``utils/check_worlds.scene_files``) into a temporary directory, loaded
    into a fresh ``World``, rendered at 512^2, depth 8, with no injected
    uniforms; then ``Renderer.focus`` on the centre pixel and a camera move,
    the reprojection alone (``render(rpp=0)``, which must seed samples) and
    a render that starts from the reprojected accumulation. Adds the
    launches of both renders to ``launches``."""
    import tempfile
    import numpy as np
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.utils.check_worlds import scene_files
    wrappers = path_wrappers()
    rpp = 8
    for name, two_level in (("multi_light", False), ("instanced_field", True)):
        with tempfile.TemporaryDirectory() as tmp:
            path = scene_files(rt.scenes.SCENES[name](RES, RES), tmp)
            world = rt.World()
            loaded = world.load_scene(path)
            if not loaded.ok:
                raise AssertionError(f"{name}: loading {path} failed: {loaded}")
        cam = world.cameras[0]
        r = rt.Renderer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=8)),
                        seed=3, device=dev)
        t0 = time.perf_counter()
        r.render(rpp=1)                      # warm-up: compile_world + 1 pass
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        if r.scene.two_level != two_level:
            raise AssertionError(f"{name}: two_level is {r.scene.two_level}")
        ns = I.n_streams(r.config, r.scene)
        if ns not in THREEFRY_NS:
            raise AssertionError(f"{name}: n_streams {ns} not checked")
        path_k = ("B3", "B4", "threefry") if two_level else ("B1", "B2",
                                                              "threefry")
        for f in wrappers.values():
            f.launches = 0
        t0 = time.perf_counter()
        r.render(rpp=rpp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: f.launches for k, f in wrappers.items()}
        r.focus(cam, cam.width // 2, cam.height // 2)
        cam.position = np.asarray(cam.position, np.float32) + (0.05, 0.02, 0.0)
        cam.touch()
        for f in wrappers.values():
            f.launches = 0
        r.render(rpp=0)                      # the reprojection alone
        reproject_ms = r.time_table.entries()["temporal reproject"][0]
        seeded = float(r.views[id(cam)].state.accum[..., 3].sum())
        if not seeded > 0.0:
            raise AssertionError(f"{name}: the reprojection seeded no samples")
        t0 = time.perf_counter()
        r.render(rpp=rpp)
        torch.cuda.synchronize()
        dt2 = time.perf_counter() - t0
        counts2 = {k: f.launches for k, f in wrappers.items()}
        for k in path_k:
            if min(counts[k], counts2[k]) < rpp:
                raise AssertionError(f"{name}: launches {counts} then "
                                     f"{counts2} < {rpp} passes")
            launches[k] += counts[k] + counts2[k]
        accum = r.views[id(cam)].state.accum
        if bool(torch.isnan(accum).any()):
            raise AssertionError(f"{name}: NaN in accum")
        if not float(accum[..., 3].sum()) > seeded:
            raise AssertionError(f"{name}: no samples accumulated after the move")
        mean = float(r.image().mean())
        if not 5.0 < mean < 220.0:
            raise AssertionError(f"{name}: image mean {mean} outside (5, 220)")
        shown = " ".join(f"{k} {counts[k]}+{counts2[k]}" for k in path_k)
        print(f"{name} from scene files ({len(world.meshes)} meshes, "
              f"{len(world.instances)} instances, "
              f"{'two-level' if two_level else 'soup'}): {RES}^2 depth 8, "
              f"{rpp} passes in {dt:.3f} s = {rpp * RES * RES / dt / 1e6:.3f} "
              f"Mrays/s, warm-up {warm:.2f} s; focus + camera move, temporal "
              f"reproject {reproject_ms:.3f} ms, {rpp} passes in {dt2:.3f} s "
              f"= {rpp * RES * RES / dt2 / 1e6:.3f} Mrays/s, reprojected "
              f"samples {seeded:.0f} of {RES * RES} pixels; launches {shown}, "
              f"image mean {mean:.1f} [{card}]", flush=True)
        del r, world
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: training at full width
# ---------------------------------------------------------------------------

def phase_train(card: str, dev):
    import dataclasses
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.engine.integrator import render_steps_preserve
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.models.device_scene import compile_world, compile_camera
    from rayzath_tpu_torch.ops import rng
    from rayzath_tpu_torch.parallel.train import training_step
    world = rt.scenes.textured_room(RES, RES)
    scene = compile_world(world, device=dev)
    cam = compile_camera(world.cameras[0], dev)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3))
    passes, lr, seed = 4, 0.01, 11
    panel = [m.name for m in world.materials].index("panel") + 2
    emission = scene.mat_emission.clone()
    emission[panel] *= 0.5
    with torch.no_grad():
        st = render_steps_preserve(dataclasses.replace(scene, mat_emission=emission),
                                   cam, cfg, init_state(RES, RES, dev),
                                   rng.key(seed), passes)
    target = st.accum[..., :3] / torch.clamp(st.accum[..., 3:4], min=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, first = [], [], None
    s = scene
    for _ in range(3):
        t0 = time.perf_counter()
        s_new, _, loss = training_step(s, cam, cfg, init_state(RES, RES, dev),
                                       seed, target, lr, passes, remat=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step = s_new.color_atlas - s.color_atlas
        if not bool(torch.isfinite(s_new.color_atlas).all()):
            raise AssertionError("training: non-finite atlas after a step")
        if not float(step.abs().max()) > 0.0:
            raise AssertionError("training: the atlas gradient is zero")
        losses.append(float(loss))
        first = first or (s_new, float(loss))
        s = s_new
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"training: loss not finite {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training: loss did not descend {losses}")
    print(f"training_step on textured_room {RES}^2, depth 3, {passes} passes per "
          f"step, remat, lr {lr}: losses {[f'{x:.6f}' for x in losses]}, "
          f"seconds per step {[f'{x:.3f}' for x in times]}, peak device memory "
          f"{peak:.2f} GiB, panel emission {float(scene.mat_emission[panel]):.4f}"
          f" -> {float(s.mat_emission[panel]):.4f} [{card}]", flush=True)
    return dict(losses=losses, seconds=times, peak_gib=peak, scene=scene,
                cam=cam, cfg=cfg, target=target, seed=seed, lr=lr,
                passes=passes, first=first)


# ---------------------------------------------------------------------------
# phase 6: the front ends and the row-band runtime
# ---------------------------------------------------------------------------

BAND_COUNTS = (1, 2, 4)
BAND_PASSES = 4
TRAIN_BANDS = 2
TRAIN_RTOL = 1e-4     # sharded against unsharded step on the card (see below)


def png_size(path) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR; raises unless the file starts with
    the PNG signature and an IHDR chunk."""
    import struct
    head = Path(path).read_bytes()[:24]
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path}: not a PNG with an IHDR")
    return struct.unpack(">II", head[16:24])


def headless_tasks(directory: Path, rpp: int) -> Path:
    """A task file of two tasks, multi_light (soup) and instanced_field
    (two-level), each loaded from scene files, engine "CUDAGPU", depth 8."""
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.utils.check_worlds import scene_files
    tasks = []
    for name in ("multi_light", "instanced_field"):
        sub = directory / name
        sub.mkdir(parents=True, exist_ok=True)
        path = sub / f"{name}.json"          # the image names start with it
        Path(scene_files(rt.scenes.SCENES[name](RES, RES), str(sub))).rename(path)
        tasks.append({"scene path": str(path.relative_to(directory)),
                      "engine": ["CUDAGPU"], "rpp": rpp, "timeout": 30,
                      "max depth": 8})
    task_file = directory / "tasks.json"
    task_file.write_text(json.dumps({"tasks": tasks}))
    return task_file


def phase_headless(card: str, tmp: Path) -> dict:
    """The headless runner in process (``Headless().run`` with images
    saved, as ``-r`` asks), then ``python -m rayzath_tpu_torch --headless
    ... -r`` in a subprocess. Returns the in-process run's launches per
    kernel label."""
    import io
    import os
    from rayzath_tpu_torch.headless import Headless
    wrappers = path_wrappers()
    task_file = headless_tasks(tmp / "headless", 64)
    report = tmp / "headless" / "report"
    runner = Headless(out=io.StringIO())
    for f in wrappers.values():
        f.launches = 0
    code = runner.run(str(task_file), str(report), save_images=True)
    counts = {k: f.launches for k, f in wrappers.items()}
    if code != 0:
        raise AssertionError(f"headless: exit {code}")
    results = runner.results
    lines = (report / "report.txt").read_text().splitlines()
    if len(results) != 2 or len(lines) != 6:
        raise AssertionError(f"headless: {len(results)} results, report "
                             f"{lines}")
    passes = {}
    for r, head in zip(results, (lines[0:3], lines[3:6])):
        name = Path(r.scene_path).stem
        if head[0] != f"Scene: {name}.json" or \
                head[1] != "\tengine: CUDAGPU | max depth: 8" or \
                not head[2].startswith("\tduration: ") or \
                not head[2].endswith("rps)"):
            raise AssertionError(f"headless {name}: report lines {head}")
        # the warm-up cycle renders one pass before the timed ones
        passes[name] = r.total_traced_rays // (RES * RES) + 1
        print(f"headless {name} (scene files, CUDAGPU): {RES}^2 depth 8, "
              f"{passes[name] - 1} passes in {r.duration:.3f} s = "
              f"{r.rays_per_second / 1e6:.3f} Mrays/s [{card}]", flush=True)
    pngs = sorted(report.glob("*.png"))
    if len(pngs) != 2 or any(png_size(p) != (RES, RES) for p in pngs):
        raise AssertionError(f"headless: PNGs {pngs}")
    need = {"B1": passes["multi_light"], "B2": passes["multi_light"],
            "B3": passes["instanced_field"], "B4": passes["instanced_field"],
            "threefry": sum(passes.values())}
    if any(counts[k] < n for k, n in need.items()):
        raise AssertionError(f"headless: launches {counts} < passes {need}")
    print(f"headless launches {counts} over passes {passes} (warm-up "
          f"included); report and {len(pngs)} PNGs of {RES}x{RES}", flush=True)

    task_file = headless_tasks(tmp / "cli", 8)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rayzath_tpu_torch", "--headless",
         str(task_file), str(tmp / "cli" / "report"), "-r"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"python -m rayzath_tpu_torch --headless exited "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    if len(list((tmp / "cli" / "report").glob("*.png"))) != 2:
        raise AssertionError("python -m rayzath_tpu_torch wrote no PNGs")
    print(f"python -m rayzath_tpu_torch --headless (rpp 8, two tasks, -r): "
          f"exit 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def phase_engine(card: str):
    import torch
    import rayzath_tpu_torch as rt
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=8))
    e = rt.Engine(cfg)
    if e.device.type != "cuda":
        raise AssertionError(f"Engine() chose {e.device}")
    e.world = rt.scenes.cornell_box_nee(RES, RES)
    e.render_world(rpp=8)
    w = rt.scenes.cornell_box_nee(RES, RES)
    r = rt.Renderer(w, cfg, seed=0, device="cuda")
    r.render(rpp=8)
    a = e.renderer.views[id(e.world.cameras[0])].state.accum
    if not torch.equal(a, r.views[id(w.cameras[0])].state.accum):
        raise AssertionError("Engine() differs from Renderer(seed=0, cuda)")
    print(f"Engine() on {e.device}: cornell_box_nee {RES}^2 depth 8, 8 passes, "
          f"bit for bit as Renderer(seed=0, device='cuda')", flush=True)


def http(port: int, path: str, body=None):
    import urllib.request
    url = f"http://127.0.0.1:{port}{path}"
    req = url if body is None else urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def wait_for(pred, what: str, seconds: float = 60.0) -> None:
    end = time.monotonic() + seconds
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"viewer: timed out waiting for {what}")
        time.sleep(0.02)


def phase_viewer(card: str):
    import threading
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.viewer import Viewer
    world = rt.scenes.multi_light(RES, RES)
    v = Viewer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=8)))
    server = v.make_server(port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    v.start()
    try:
        wait_for(lambda: v.stats()["pass_count"] >= 8 or v.error, "8 passes")
        code, page = http(port, "/")
        if code != 200 or b"orbit" not in page:
            raise AssertionError("viewer: no page")
        code, png = http(port, "/frame")
        if code != 200 or png[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError("viewer: /frame is not a PNG")
        stats = json.loads(http(port, "/stats")[1])
        if stats["width"] != RES or not stats["pass_count"] > 0:
            raise AssertionError(f"viewer: stats {stats}")
        rps = stats["rays_per_second"]
        http(port, "/orbit", {"dx": 40, "dy": 10})
        wait_for(lambda: "temporal reproject"
                 in v.renderer.time_table.entries() or v.error,
                 "a reprojecting cycle")
        reproject_ms = v.renderer.time_table.entries()["temporal reproject"][0]
        wait_for(lambda: v.stats()["pass_count"] >= 4 or v.error, "passes")
        picked = json.loads(http(port, "/pick", {"x": RES // 2, "y": RES // 2})[1])
        if not picked["instance"] >= 0:
            raise AssertionError(f"viewer: centre pick {picked}")
        fd = json.loads(http(port, "/focus", {"x": RES // 2,
                                              "y": RES // 2})[1])
        http(port, "/zoom", {"d": -120})
        tree = json.loads(http(port, "/tree")[1])
        props = json.loads(http(port, "/props?type=material&idx=0")[1])
        if not tree["instance"] or not props["fields"]:
            raise AssertionError("viewer: empty /tree or /props")
        wait_for(lambda: v.stats()["pass_count"] >= 12 or v.error, "12 passes")
        http(port, "/edit", {"type": "material", "idx": 0,
                             "attr": "roughness", "value": 0.4})
        wait_for(lambda: 0 < v.stats()["pass_count"] <= 8 or v.error,
                 "the pass count to restart after /edit")
        if v.error:
            raise AssertionError(f"viewer: the render thread failed: {v.error}")
        rps = max(rps, v.stats()["rays_per_second"])
    finally:
        v.stop()
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    print(f"viewer on multi_light {RES}^2 depth 8, 4 passes per cycle: "
          f"{rps / 1e6:.3f} Mrays/s (moving average); /orbit reprojected in "
          f"{reproject_ms:.3f} ms; /pick {picked['name']!r} (instance "
          f"{picked['instance']}), /focus {fd['focal_distance']:.3f}, /zoom, "
          f"/tree, /props, /edit restarted the pass count [{card}]",
          flush=True)


def phase_bands(card: str, dev):
    import numpy as np
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.engine.integrator import render_steps
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.models.device_scene import compile_world, compile_camera
    from rayzath_tpu_torch.ops import rng
    from rayzath_tpu_torch.parallel.mesh import sharded_render_steps
    from rayzath_tpu_torch.utils.parity import images_match
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=8))
    for name in ("cornell_box_nee", "mesh_heavy"):
        world = rt.scenes.SCENES[name](RES, RES)
        scene = compile_world(world, device=dev)
        cam = compile_camera(world.cameras[0], dev)
        key = rng.key(4)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        render_steps(scene, cam, cfg, init_state(RES, RES, dev), key, 1)
        ref, ref_ms = timed(lambda: render_steps(
            scene, cam, cfg, init_state(RES, RES, dev), key, BAND_PASSES))
        a_ref = ref.accum.cpu().numpy()
        shown = []
        for n in BAND_COUNTS:
            got, ms = timed(lambda: sharded_render_steps(
                scene, cam, cfg, init_state(RES, RES, dev), key, BAND_PASSES,
                [dev] * n))
            a = got.accum.cpu().numpy()
            close = images_match(a, a_ref)
            same = "yes" if np.array_equal(a, a_ref) else "no"
            shown.append(f"n={n} {ms:.1f} ms (within 2e-3: {close:.4f}, "
                         f"bit-identical: {same})")
        print(f"bands on {dev}, {name} {RES}^2 depth 8, {BAND_PASSES} passes: "
              f"unsharded {ref_ms:.1f} ms; " + "; ".join(shown) + f" [{card}]",
              flush=True)
        del scene, world
        torch.cuda.empty_cache()


def phase_scaling(card: str):
    import contextlib
    import io
    from rayzath_tpu_torch import headless
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = headless.main(["--scaling", "cornell_box_nee"])
    lines = out.getvalue().strip().splitlines()
    if code != 0 or len(lines) != 2 or \
            lines[0] != "devices | Mrays/s | scaling efficiency" or \
            lines[1].split("|")[0].strip() != "1":
        raise AssertionError(f"--scaling: exit {code}, {lines}")
    print(f"--scaling cornell_box_nee (256^2, depth 8, 64 passes): "
          f"{lines[1].strip()} [{card}]", flush=True)


def phase_distributed(card: str, dev):
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.engine.integrator import render_steps
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.models.device_scene import compile_world, compile_camera
    from rayzath_tpu_torch.ops import rng
    from rayzath_tpu_torch.parallel import distributed as D
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if D.init_distributed(f"localhost:{port}", 1, 0) != 0:
        raise AssertionError("distributed: rank is not 0")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"distributed: backend {dist.get_backend()}")
        world = rt.scenes.cornell_box_nee(RES, RES)
        scene = compile_world(world, device=dev)
        cam = compile_camera(world.cameras[0], dev)
        cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=8))
        state = D.init_state_distributed(RES, RES)
        state = D.render_steps_distributed(scene, cam, cfg, state, rng.key(6), 4)
        img = D.gather_image(state)
    finally:
        dist.destroy_process_group()
    ref = render_steps(scene, cam, cfg, init_state(RES, RES, dev), rng.key(6), 4)
    if not np.array_equal(img, ref.accum.cpu().numpy()):
        raise AssertionError("distributed: gather_image differs from the "
                             "plain render")
    print(f"torch.distributed on NCCL, world size 1: gather_image (all_gather) "
          f"of cornell_box_nee {RES}^2 depth 8, 4 passes, bit for bit as the "
          f"plain render [{card}]", flush=True)


def phase_sharded_train(card: str, dev, train: dict):
    """``sharded_training_step`` over two bands on the card against phase
    5's first unsharded step, same scene, target and seed. On the card the
    bands are coherence-sorted on their own (B2's products may differ in
    the last bits) and the dense shadow replay takes other chunks, so the
    gate is a tolerance: loss to rtol 1e-4 and the updated parameters to
    1e-4 of their max |step|."""
    import torch
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.parallel.mesh import sharded_training_step
    from rayzath_tpu_torch.parallel.train import DIFF_PARAMS
    scene, (ref_scene, ref_loss) = train["scene"], train["first"]
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, _, loss = sharded_training_step(
            scene, train["cam"], train["cfg"], init_state(RES, RES, dev),
            train["seed"], train["target"], train["lr"], train["passes"],
            [dev] * TRAIN_BANDS, remat=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not abs(float(loss) - ref_loss) <= TRAIN_RTOL * abs(ref_loss):
        raise AssertionError(f"sharded training: loss {float(loss)} against "
                             f"{ref_loss}")
    worst = 0.0
    for k in DIFF_PARAMS:
        step = (getattr(ref_scene, k) - getattr(scene, k)).abs().max()
        diff = (getattr(new, k) - getattr(ref_scene, k)).abs().max()
        if float(step) > 0:
            worst = max(worst, float(diff / step))
        if float(diff) > TRAIN_RTOL * max(float(step), 1e-30):
            raise AssertionError(f"sharded training: {k} differs by "
                                 f"{float(diff)}, step {float(step)}")
    print(f"sharded_training_step, {TRAIN_BANDS} bands on {dev}, textured_room "
          f"{RES}^2 depth 3, {train['passes']} passes, remat: loss "
          f"{float(loss):.6f} against {ref_loss:.6f}, update within "
          f"{worst:.2e} of the step; seconds per step "
          f"{[f'{x:.3f}' for x in times]} (unsharded "
          f"{[f'{x:.3f}' for x in train['seconds']]}) [{card}]", flush=True)


def phase_front_ends(card: str, dev, train: dict) -> dict:
    """Returns the headless run's launches per kernel label."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_headless(card, Path(tmp))
    phase_engine(card)
    phase_viewer(card)
    phase_bands(card, dev)
    phase_scaling(card)
    phase_distributed(card, dev)
    phase_sharded_train(card, dev, train)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "rayzath_tpu_torch" / "__init__.py").is_file():
        return fail(f"rayzath_tpu_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    from rayzath_tpu_torch.ops import _kernels
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"nvcc {nvcc_release(_kernels._nvcc())}", flush=True)
    t0 = time.perf_counter()
    built = _kernels.build()
    _kernels.load()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: "
          f"{built.relative_to(ROOT)}", flush=True)
    from rayzath_tpu_torch import native
    t0 = time.perf_counter()
    builder = ("the native C++ builder" if native.available()
               else "the NumPy builder (native library unavailable)")
    print(f"BVH builds: {builder} ({time.perf_counter() - t0:.2f} s to build "
          f"and load native/)", flush=True)

    t_phase = time.perf_counter()
    threefry = phase_threefry(card, dev)
    kernels = phase_kernels(card, dev)
    kernels.update(phase_inst_kernels(card, dev))
    phase_tables(dev)
    phase_shadow_tables(dev)
    phase_massive(card, dev)
    backward = phase_backward(card, dev)
    print(f"phase 2 (kernel vs plain, backward) "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    phase_end_to_end(dev)
    print(f"phase 3 (end to end) {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    launches = phase_slice(card, dev)
    phase_files(card, dev, launches)
    print(f"phase 4 (slice at size) {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    t_phase = time.perf_counter()
    train = phase_train(card, dev)
    print(f"phase 5 (training) {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    for k, n in phase_front_ends(card, dev, train).items():
        launches[k] = launches.get(k, 0) + n
    print(f"phase 6 (front ends) {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # times: B1/B2 on mesh_heavy, B3/B4 on instanced_field, bounce-like
    # rays; "rays" / "plain_rays" say which ray set each time was taken on;
    # the bound and the needed visits are this run's on the same rays
    record = []
    for label, name, line, scene in (
            ("B1", "cluster_closest", 872, "mesh_heavy"),
            ("B2", "cluster_shadow", 975, "mesh_heavy"),
            ("B3", "cluster_closest_inst", 1503, "instanced_field"),
            ("B4", "cluster_shadow_inst", 1636, "instanced_field")):
        m = kernels[name][scene]
        record.append({
            "name": name, "route": "cuda",
            "source": f"rayzath_tpu_torch/csrc/{name}.cu",
            "replaces": f"rayzath_tpu/ops/traverse_cluster.py:{line}",
            "launches": launches[label], "max_abs_err": kernels[name]["err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound"][0],
            "bound_by": m["bound"][1], "library_ms": None, "scene": scene,
            "rays": m["rays"], "plain_rays": m["plain_rays"],
            "needed_visits_per_ray": m["needed_visits_per_ray"]})
        if "visits_per_ray" in m:
            record[-1]["visits_per_ray"] = m["visits_per_ray"]
        if name in backward:
            record[-1].update(backward_max_rel_err=backward[name],
                              backward_rtol=BACKWARD_RTOL)
    # the draw replaces no TPU kernel (the JAX package draws in XLA); timed
    # on one 512^2 pass at ns = 14, bit for bit to the plain draw
    record.append({
        "name": "threefry", "route": "cuda",
        "source": "rayzath_tpu_torch/csrc/threefry.cu", "replaces": None,
        "launches": launches["threefry"], "max_abs_err": threefry["err"],
        "ms": threefry["ms"], "plain_ms": threefry["plain_ms"],
        "bound_ms": threefry["bound"][0], "bound_by": threefry["bound"][1],
        "library_ms": None, "rows": RES, "width": RES,
        "ns": THREEFRY_NS[-1]})
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
