#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rayzath_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. Environment: the card (``nvidia-smi``), torch and nvcc versions; build the
   hand-written kernels from ``rayzath_tpu_torch/csrc`` (timed) and the
   native library (``native/``, g++), and say which BVH builder runs.
2. Kernel against plain. The threefry kernel (``csrc/threefry.cu``) against
   ``ops/rng.py`` ``uniform_rows_plain`` on the card, bit for bit, on full
   512^2 passes at ns = 8 and 14, a band of rows at row0 > 0 at ns = 11, an
   odd width and rows of 3 floats; its keyed entry (the render cycle's
   draw, which folds the pass key on the device from the key words and an
   int32 pass counter) bit for bit on the same sets and at pass 2^32 - 1
   against the by-value entry and the plain draw under
   ``rng.fold_in_tensor``; each entry timed on a 512^2 x 14 pass: the
   kernel's own device time (``device_ms``: 50 launches queued behind a
   ``torch.cuda._sleep``, so the events hold no host time; median of 5),
   the call's time with its Python wrapper and the plain version's (CUDA
   events around one call, median of 20), and its bound from the bytes
   written and the fewest instructions of the function (70 per float) over
   the SM's issue rate. Then B1 ``cluster_closest`` and B2 ``cluster_shadow``
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
   times of kernel and plain with CUDA events, the kernel's both as its
   device time (``device_ms``) and as its call's. On each timed (bounce-like)
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
   B2-grad / B4-grad backward) against autograd through their plain twins on
   the card, for every input, on ``lit_world`` (tests/test_gradients.py) at
   64^2 bounce-like rays with half the materials at alpha 0.55 (B2) and on
   a two-level instanced_field(n=3, resolution=12) likewise (B4): the
   opacity (``mat_color``) gradient to rtol 1e-3 of its max |g|; the rays,
   the distance and the triangles get exactly zero from both (the product
   is piecewise constant in geometry). Cotangents are zero on rays whose
   plain alpha is below 1e-4 (the kernels stop there) or that an f64
   Moller-Trumbore calls chaotic. Then device times of the plain torch
   pieces of this slice at 512^2: the texture fetch, the cutout pass and
   B2's forward and forward + backward on textured_room. Then B2-grad
   (``csrc/cluster_shadow_grad.cu``) on mesh_heavy and B4-grad
   (``csrc/cluster_shadow_inst_grad.cu``) on instanced_field at 512^2 on
   bounce-like rays with dist = BIG, half the materials translucent and
   random cotangents: against ``cluster_shadow_grad_plain`` /
   ``cluster_shadow_inst_grad_plain`` on every 8th / 16th ray (max |d g| /
   max |g| <= 1e-3), whether two calls give the same bits (their atomics
   add in no fixed order), device and call ms, the plain version's ms,
   made visits (both walks) against the needed ones (the pairs on each
   ray's line in (0, dist), each once, no stop; more than 2x needed per
   walk fails) and the bound: operations the needed triangle tests x 49
   (+ 33 per needed instance), each once, plus 2 per hit and channel (hits
   counted on the plain version's rays and scaled), bytes each input once
   plus the gradient table.
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
   512^2, depth 8 (through the render cycle: replays of one captured graph
   per pass); NaN-free, samples accumulated, image mean in (5, 220),
   and the launch counters of the path's two kernels and the keyed
   threefry entry (all reset just before; a replay adds the captured
   pass's launches) at least one per pass. Then the
   slice's scene files: multi_light (soup, B1/B2) and instanced_field
   (two-level, B3/B4) written by the port's ``save_scene`` with one OBJ/MTL
   per mesh and an HDR sky, loaded into a fresh ``World`` and rendered at
   512^2, depth 8, 8 passes with no injected uniforms; then
   ``Renderer.focus``, a camera move, the reprojection alone (it must seed
   samples; its ``"temporal reproject"`` ms) and 8 more passes; Mrays/s,
   warm-up and launches of both renders. Then the skip-link BVH walk
   (``packet_traversal=False``, ``ops/traverse.py``: torch ops, no
   kernel): on cornell_box_nee's 512^2 camera rays the walk on the card
   bit for bit as on the CPU (closest t and ids, shadow rgba toward the
   spot light); ``Renderer(device="cuda", config=RenderConfig(
   packet_traversal=False))`` on cornell_box_nee (8 passes) and mesh_heavy
   (4) at 512^2, depth 8, after a warm-up pass: NaN-free, samples
   accumulated, B1-B4 never launched and the keyed threefry entry once
   per pass (the cycle runs this route eagerly); ms per pass and the walks' ms per pass. The walk and B1 give
   their hit ids apart only on rays an f64 Moller-Trumbore calls chaotic
   (checked on both scenes' 512^2 camera and bounce-like rays, and on the
   placeholder ray that pass 0 traces for every pixel), where a path may
   end a bounce sooner or later, so the image against the packet path's
   from the same seed may differ in the sample counts of at most 1e-4 of
   the pixels (1 of 262,144 on an H100 on cornell_box_nee), with radiance
   by ``images_match``'s rule over all pixels (``render_gate``; pass 0 is
   left out only where the two walks part on its f64-chaotic ray).
   mesh_massive (phase 2) also reports the skip-link tables' host time
   against its compile's.
5. Training on textured_room(512, 512), depth 3, 4 passes per step,
   remat, lr 0.01 against the same scene with the panel's emission halved
   (with 2 passes the panel never enters the image: pass 0 traces the
   initial placeholder rays, pass 1 the camera's first hits), the
   training cell of ``rayzath_tpu_torch/utils/check_train.py``: a first
   and three timed eager steps (``train._eager_step``, by-value draw) and
   the same with ``training_step`` (one captured CUDA graph per step,
   keyed draw): s per step, capture ms, peak GiB; the first graph step's
   loss bit for bit as the first eager step's, its parameters within 1e-4
   of the max |step|; after every eager and graph step the parameters
   finite and the atlas moved; the losses finite and descending; B2-grad
   launched in both. Then B2-grad against ``cluster_shadow_grad_plain``
   on the arguments (rays, dist, tables, cotangents) of every shadow
   backward of one more eager step, all 262,144 rays (max |d g| / max |g|
   <= 1e-3, and 0 exactly where the plain gradient is 0), as given and
   with half the materials translucent in the opacity table (the scene is
   opaque, so the gradient as given may be 0 throughout; with the
   translucent table some call must have one). Then, through
   ``rayzath_tpu_torch/utils/profiling.py``, one eager step under
   torch.profiler, split into device ms of the forward passes, the
   checkpointed recompute, the shadow backward (B2-grad), the gathers'
   backward (G2, per call site), the rest of the backward and the update,
   with its wall ms and idle share; it fails if torch's index backward
   (``indexing_backward_kernel*``) ran in that step: a differentiable
   gather that bypasses ``ops/gather.py``. Then G1 and G2 on the arguments
   of every gather of one more eager step: G1 bit for bit as
   ``gather_rows_plain``, G2 within 1e-6 of the max |g| of
   ``gather_rows_grad_plain`` (the float64 sum rounded once) and, on a
   table that fits in shared memory, the same bits twice; the material
   table's call and the largest colour atlas call timed (device and call
   ms, bound, plain ms, and ``table[idx]``, ``index_add_`` and
   ``index_put_(accumulate=True)`` on the same arguments). Then one
   two-level ``training_step`` on instanced_field at 512^2
   (``differentiable=True``): the loss finite, the materials' update
   non-zero, B4-grad launched; and B4-grad against its plain version on
   the arguments of one eager two-level step, every 32nd ray, in the same
   two cases.
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
   ``sharded_training_step`` over 2 bands of textured_room (eager)
   against phase 5's first graph step: loss to rtol 1e-4, the update to
   1e-4 of the step.
7. The render cycle (``engine/cycle.py``, the counterpart of the JAX
   package's jitted, donated ``render_steps``): on cornell_box_nee,
   multi_light, mesh_heavy, instanced_field, textured_room and the cutout
   world at 512^2, depth 8, ``Renderer.render`` (one captured CUDA graph
   per pass) leaves every state array bit for bit as eager
   ``render_steps`` from the same seed, so sample counts are equal, over
   rpp 1, 3, 2, a reprojecting camera move (no new capture), a material
   edit (a new capture) and a checkpoint resumed in a fresh renderer
   (``utils/check_cycle.py``). Where the render's time goes is the
   benchmark's (``benchmark/``), read from the renderer's spans.

The last lines of standard output are the render cycle's JSON record
(``{"render_cycle": ...}``), the kernels' JSON record, the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``. The kernels' record lists B1-B4, the
threefry kernel's two entries (``"replaces": null``: the JAX package draws
in XLA), B2-grad and B4-grad (``replaces``: the custom_vjp bwd rules,
a dense replay in XLA) and the table gather's G1 and G2 (``replaces``:
``rayzath_tpu/ops/gather.py`` ``gather_rows``), each with its launches in
the paths driven with the counters set to 0 just before and read just
after: phase 4's renders (B1-B4, G1 and the keyed draw), the skip-link
renders (the keyed draw), phase 5's training steps (B1, B2, B2-grad, G1,
G2 and both draws; the two-level step B3, B4 and B4-grad), phase 6's
headless run and phase 7's checks;
``ms`` its device time and ``call_ms`` its call's time. It fails if a
kernel never launched. Needs one CUDA device and nvcc; there is no CPU
fallback.
"""
from __future__ import annotations

import contextlib
import json
import re
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
# a training step's updated parameters against another route's (graph
# against eager, row bands against unsharded), of the max |step|: the
# backwards' atomics add in no fixed order
TRAIN_RTOL = 1e-4
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


def plain_runs(fn) -> tuple[float, int]:
    """Median of up to 20 timed runs of a plain version, fewer when one run
    is slow (mesh_heavy's plain walk is an all-pairs pass over 65k
    triangles), so the script stays inside its time limit."""
    from rayzath_tpu_torch.utils.cuda_timing import call_ms
    first = call_ms(fn, 1)
    runs = int(max(3, min(20, PLAIN_BUDGET_MS // max(first, 1e-3))))
    return call_ms(fn, runs), runs


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
    from rayzath_tpu_torch.utils.cuda_timing import call_ms, device_ms
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
        k1 = call_ms(lambda: tc.cluster_closest(o, d, near, far, *tabs), 20)
        k2 = call_ms(lambda: tc.cluster_shadow(
            o, d, big, scene.cl_box, scene.cl_lw, scene.cl_order,
            scene.cl_base, scene.cl_count, op_rgb, op_a), 20)
        d1 = device_ms(lambda: tc.cluster_closest(o, d, near, far, *tabs))
        d2 = device_ms(lambda: tc.cluster_shadow(
            o, d, big, scene.cl_box, scene.cl_lw, scene.cl_order,
            scene.cl_base, scene.cl_count, op_rgb, op_a))
        p1, n1 = plain_runs(lambda: tc.cluster_closest_plain(
            o, d, near, far, scene.cl_box, scene.cl_lw))
        p2, n2 = plain_runs(lambda: tc.cluster_shadow_plain(
            o, d, big, scene.cl_box, scene.cl_lw, op_tab))
        oc, dc, nc, fc, *_ = timing["camera"]
        kc = call_ms(lambda: tc.cluster_closest(oc, dc, nc, fc, *tabs), 20)
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
        print(f"  {name} times [{card}]: B1 kernel {d1:.4f} ms on the device "
              f"(call {k1:.3f} ms) vs plain "
              f"{p1:.3f} ms (median of 20 / {n1}), bound {b1[0]:.4f} ms "
              f"({b1[1]}), visits per ray {made:.3f} made / {pairs1 / r:.3f} "
              f"needed, {staged:.2f} clusters staged per block; B2 kernel "
              f"{d2:.4f} ms on the device (call {k2:.3f} ms) vs plain "
              f"{p2:.3f} ms (median of 20 / {n2}), bound "
              f"{b2[0]:.4f} ms ({b2[1]}), visits per ray {made2:.3f} made / "
              f"{pairs2 / r:.3f} needed, {staged2:.2f} clusters staged per "
              f"block; B1 on camera rays {kc:.3f} ms; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["cluster_closest"][name] = dict(
            ms=d1, call_ms=k1, plain_ms=p1, rays=r, plain_rays=r, bound=b1,
            needed_visits_per_ray=pairs1 / r, visits_per_ray=made)
        out["cluster_shadow"][name] = dict(
            ms=d2, call_ms=k2, plain_ms=p2, rays=r, plain_rays=r, bound=b2,
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
    from rayzath_tpu_torch.utils.cuda_timing import call_ms, device_ms
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
        k3 = call_ms(lambda: tc.cluster_closest_inst(o, d, near, far, *tabs), 20)
        k3s = call_ms(lambda: tc.cluster_closest_inst(os_, ds_, ns_, fs_,
                                                      *tabs), 20)
        shadow_args = (scene.cl_slot, scene.inst_slot_map, scene.mat_color)
        k4 = call_ms(lambda: tc.cluster_shadow_inst(o, d, big, *tabs,
                                                    *shadow_args), 20)
        k4s = call_ms(lambda: tc.cluster_shadow_inst(os_, ds_, bs_, *tabs,
                                                     *shadow_args), 20)
        d3 = device_ms(lambda: tc.cluster_closest_inst(o, d, near, far, *tabs))
        d4 = device_ms(lambda: tc.cluster_shadow_inst(o, d, big, *tabs,
                                                      *shadow_args))
        p3, n3 = plain_runs(lambda: tc.cluster_closest_inst_plain(
            os_, ds_, ns_, fs_, *tabs))
        p4, n4 = plain_runs(lambda: tc.cluster_shadow_inst_plain(
            os_, ds_, bs_, *tabs, scene.cl_slot, op_tab))
        oc, dc, nc, fc, *_ = timing["camera"]
        kc = call_ms(lambda: tc.cluster_closest_inst(oc, dc, nc, fc, *tabs), 20)
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
        print(f"  {name} times [{card}]: B3 kernel {d3:.4f} ms on the device "
              f"(call {k3:.3f} ms) on {r} rays, "
              f"{k3s:.3f} ms on {len(sub)}, plain {p3:.3f} ms on {len(sub)} "
              f"(median of 20 / {n3}), bound {b3[0]:.4f} ms ({b3[1]}), "
              f"visits per ray {made:.3f} made / {pairs3 / r:.3f} needed "
              f"(instances {ipairs3 / r:.3f} needed), {staged:.2f} clusters "
              f"staged per block; B4 kernel {d4:.4f} ms on the device (call "
              f"{k4:.3f} ms) on {r}, {k4s:.3f} ms "
              f"on {len(sub)}, plain {p4:.3f} ms on {len(sub)} (median of 20 / "
              f"{n4}), bound {b4[0]:.4f} ms ({b4[1]}), visits per ray "
              f"{made4:.3f} made / {pairs4 / r:.3f} needed, {staged4:.2f} "
              f"clusters staged per block; B3 on camera rays {kc:.3f} ms; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["cluster_closest_inst"][name] = dict(
            ms=d3, call_ms=k3, plain_ms=p3, rays=r, plain_rays=len(sub), bound=b3,
            needed_visits_per_ray=pairs3 / r, visits_per_ray=made)
        out["cluster_shadow_inst"][name] = dict(
            ms=d4, call_ms=k4, plain_ms=p4, rays=r, plain_rays=len(sub), bound=b4,
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
    from rayzath_tpu_torch.ops.bvh import (build_bvh, compute_skip_links,
                                           triangle_aabbs)
    from rayzath_tpu_torch.ops.intersect import BIG
    from rayzath_tpu_torch.ops.traverse import build_aabb_links, leaf_table
    from rayzath_tpu_torch.utils.cuda_timing import call_ms
    t0 = time.perf_counter()
    world = rt.scenes.mesh_massive(RES, RES)
    scene = compile_world(world, device=dev)
    compiled = time.perf_counter() - t0
    # the skip-link walk's tables, which every soup compile builds, timed
    # alone on a BVH of the same (leaf-ordered) triangles
    n = scene.n_triangles
    v0, e1, e2 = (x[:n].cpu().numpy() for x in (scene.tri_v0, scene.tri_e1,
                                                scene.tri_e2))
    bvh = build_bvh(*triangle_aabbs(v0, v0 + e1, v0 + e2), leaf_size=8)
    t0 = time.perf_counter()
    build_aabb_links(bvh.node_min, bvh.node_max, bvh.node_count,
                     *compute_skip_links(bvh.node_begin, bvh.node_count,
                                         bvh.node_axis))
    leaf_table(bvh.node_begin, bvh.node_count, 8)
    tables = time.perf_counter() - t0
    tabs = (scene.cl_box, scene.cl_lw, scene.cl_order)
    r = RES * RES
    real = int((scene.cl_box[tc.B_CNT] > 0).sum())
    print(f"mesh_massive: {n} triangles, {real} clusters, compiled in "
          f"{compiled:.2f} s; the skip-link tables of a {bvh.n_nodes}-node BVH "
          f"of them take {tables:.3f} s ({100 * tables / compiled:.1f}% of the "
          f"compile)", flush=True)
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
        ms = call_ms(lambda: tc.cluster_closest(o_s, d_s, n_s, f_s, *tabs), 10)
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
            ms = call_ms(lambda: tc.cluster_shadow(o_s, d_s, big, *shadow), 10)
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
    from rayzath_tpu_torch.utils.cuda_timing import call_ms
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
    t_fetch = call_ms(lambda: tex_ops.fetch_scene(scene, tex_id, uv, atlas=0), 20)
    dist = torch.full((r,), 3e38, device=dev)
    leaves = (o, d, dist, scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.mat_color)
    g = (torch.ones(r, 3, device=dev), torch.ones(r, device=dev))

    def fwd():
        return shadow_fn(scene, leaves)[0]

    def fwd_bwd():
        fn, xs = shadow_fn(scene, leaves)
        torch.autograd.grad(fn, xs[6], g)

    torch.cuda.reset_peak_memory_stats()
    t_fwd = call_ms(fwd, 5)
    t_bwd = call_ms(fwd_bwd, 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cworld = check_worlds.cutout_world(RES)
    cscene = compile_world(cworld, device=dev)
    co, cd = bounce_rays(cscene, cworld, dev, RES, 25)
    t_cut = call_ms(lambda: I.texture_shadow_factor(cscene, co, cd, dist), 20)
    print(f"  plain pieces at {RES}^2 [{card}]: texture fetch (color atlas) "
          f"{t_fetch:.3f} ms; cutout pass ({cscene.n_cutout} cutouts) "
          f"{t_cut:.3f} ms; B2 Function on textured_room "
          f"({scene.tri_v0.shape[0]} triangles) forward (B2) {t_fwd:.3f} ms, "
          f"forward + backward (B2-grad) {t_bwd:.3f} ms, peak {peak:.2f} GiB",
          flush=True)
    out["times"] = dict(fetch_ms=t_fetch, cutout_ms=t_cut, b2_fwd_ms=t_fwd,
                        b2_fwd_bwd_ms=t_bwd)
    return out


# ---------------------------------------------------------------------------
# phase 2, the shadow backwards at size: B2-grad and B4-grad
# ---------------------------------------------------------------------------

# the plain backwards on every n-th ray (two walks of [R, 4, 128] terms per
# cluster: all 262,144 rays would take tens of seconds a call)
GRAD_STRIDE = {"mesh_heavy": 8, "instanced_field": 16}
# operations of one hit's share per channel: the division (or the select of
# B) and the add
SCATTER_OPS = 2
# B2-grad and B4-grad walk each block's clusters twice by design (walk 1
# folds the products, walk 2 scatters the shares), where the function needs
# each (ray, cluster) pair tested once: their made visits are held to
# MADE_PER_NEEDED x the needed ones per walk
GRAD_WALKS = 2
# B4-grad's plain version on every n-th ray of a two-level training step's
# shadow calls (four calls, each held twice)
STEP_GRAD_STRIDE = 32


def check_grad_kernel(card: str, dev, name: str) -> dict:
    """B2-grad (mesh_heavy, soup) or B4-grad (instanced_field, two-level)
    at 512^2 on bounce-like rays in the integrator's order, dist = BIG,
    half the materials translucent, cotangents from a numpy seed: the
    kernel against its plain version on every GRAD_STRIDE-th ray (max
    |d g| / max |g| <= BACKWARD_RTOL), whether two calls on all rays give
    the same bits (the atomics' order), device and call ms on all rays, the
    plain version's ms on its rays, made visits (both walks) against the
    needed ones (the (instance,) cluster pairs on each ray's line in (0,
    dist), each once: no stop) and the bound (each needed pair tested once,
    each hit's share scattered once)."""
    import numpy as np
    import torch
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    from rayzath_tpu_torch.ops.intersect import BIG
    from rayzath_tpu_torch.utils import check_tables as ct
    from rayzath_tpu_torch.utils.cuda_timing import call_ms, device_ms
    two_level = name == "instanced_field"
    t0 = time.perf_counter()
    scene, _, (o, d) = (inst_scene_rays if two_level else scene_rays)(name, dev)
    r = RES * RES
    near = torch.zeros(r, device=dev)
    o, d, (near,) = coherent_order(scene, o, d, (near,))
    dist = torch.full((r,), BIG, device=dev)
    g = torch.as_tensor(np.random.default_rng(31).normal(size=(r, 4))
                        .astype(np.float32), device=dev)
    g_rgb, g_a = g[:, :3].contiguous(), g[:, 3].contiguous()
    mc = half_translucent(scene.mat_color)
    if two_level:
        label = "B4-grad"
        kernel, plain = tc.cluster_shadow_inst_grad, tc.cluster_shadow_inst_grad_plain
        tabs = (scene.ti_rows, scene.cl_obox, scene.cl_lw, scene.cl_slot,
                tc.instance_opacity(mc, scene.inst_slot_map))
    else:
        label = "B2-grad"
        kernel, plain = tc.cluster_shadow_grad, tc.cluster_shadow_grad_plain
        mat = mc[scene.tri_mat.long()]
        tabs = (scene.cl_box, scene.cl_lw,
                tc.cluster_opacity(mat[:, :3], 1.0 - mat[:, 3], scene.cl_order,
                                   scene.cl_base, scene.cl_count))
    stride = GRAD_STRIDE[name]
    sub = torch.arange(0, r, stride, device=dev)
    sub_args = [x[sub].contiguous() for x in (o, d, dist)]
    sub_g = [x[sub].contiguous() for x in (g_rgb, g_a)]
    got = kernel(*sub_args, *tabs, *sub_g)
    ref = plain(*sub_args, *tabs, *sub_g)
    full = [kernel(o, d, dist, *tabs, g_rgb, g_a) for _ in range(2)]
    torch.cuda.synchronize()
    max_abs = float((got - ref).abs().max())
    err = max_abs / float(ref.abs().max())
    if not err <= BACKWARD_RTOL:
        raise AssertionError(f"{name} {label}: max rel err {err:.3e} > "
                             f"{BACKWARD_RTOL}")
    same_bits = bool(torch.equal(full[0], full[1]))
    k_call = call_ms(lambda: kernel(o, d, dist, *tabs, g_rgb, g_a), 20)
    k_dev = device_ms(lambda: kernel(o, d, dist, *tabs, g_rgb, g_a))
    p_ms, n_runs = plain_runs(lambda: plain(*sub_args, *tabs, *sub_g))
    made, staged = visits_made(lambda v: kernel(o, d, dist, *tabs, g_rgb, g_a,
                                                visits=v), r)
    zero = torch.zeros(r, device=dev)
    d_op_bytes = tabs[-1].numel() * 4
    if two_level:
        pairs, tests, ipairs, cl, insts, real = ct.needed_inst(
            o, d, zero, dist, scene.ti_rows, scene.cl_obox)
        hits = stride * ct.shadow_hits_inst(*sub_args, *tabs[:3])
        n_bytes = (r * (28 + 16) + cl * (FRAME_BYTES + 32 + 512) + real * 96
                   + insts * 4 * 64 * 4 + d_op_bytes)
        n_ops = tests * TEST_OPS + ipairs * TO_OBJECT_OPS
    else:
        pairs, tests, rows, real = ct.needed_soup(o, d, zero, dist, scene.cl_box)
        hits = stride * ct.shadow_hits(*sub_args, *tabs[:2])
        n_bytes = r * (28 + 16) + rows * (FRAME_BYTES + 2048) + real * 32 + d_op_bytes
        n_ops = tests * TEST_OPS
    n_ops += hits * 4 * SCATTER_OPS
    needed = pairs / r
    check_made(f"{name} {label} (per walk)", made / GRAD_WALKS, needed)
    b = bound(n_bytes, n_ops)
    print(f"  {name} {label} [{card}]: against the plain version on "
          f"{len(sub)} rays max rel err {err:.3e} (max abs {max_abs:.3e}); "
          f"two calls on {r} rays bit for bit: {'yes' if same_bits else 'no'}; "
          f"kernel {k_dev:.4f} ms on the device (call {k_call:.3f} ms) on {r} "
          f"rays, plain {p_ms:.3f} ms on {len(sub)} (median of 20 / {n_runs}), "
          f"bound {b[0]:.4f} ms ({b[1]}; {hits} hits, scaled from every "
          f"{stride}th ray), visits per ray {made:.3f} made ({GRAD_WALKS} "
          f"walks) / {needed:.3f} needed, {staged:.2f} clusters staged per "
          f"block; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(ms=k_dev, call_ms=k_call, plain_ms=p_ms, rays=r,
                plain_rays=len(sub), bound=b, needed_visits_per_ray=needed,
                visits_per_ray=made, err=max_abs, rel_err=err,
                same_bits=same_bits, scene=name)


def phase_grad_kernels(card: str, dev) -> dict:
    import torch
    out = {}
    for key, name in (("cluster_shadow_grad", "mesh_heavy"),
                      ("cluster_shadow_inst_grad", "instanced_field")):
        out[key] = check_grad_kernel(card, dev, name)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 2, the draw: the threefry kernel against its plain version
# ---------------------------------------------------------------------------

# instructions per second, whatever their pipe: an SM issues at most four
# warp instructions a clock (128 lanes), the float32 rate above at a fused
# multiply-add counted as one
ISSUE_S = F32_OPS_S / 2
# the fewest instructions of one threefry2x32 with counter (0, e), a count
# of the function and not of a kernel: x1 = e + k1 (x0 = k0 needs none),
# 20 rounds of (add, funnel-shift rotate, xor), one add per middle key
# injection into x1 (the one into x0 folds into the next round's
# three-input add, the constant into the key word) and the two final adds
HASH_OPS = 1 + 20 * 3 + 4 + 2
# per drawn float: the x0 ^ x1, the shift-or (one LEA.HI) and the float
# subtract
UNIT_OPS = 3
# (seed, pass, row0, rows, width, ns): full passes at the n_streams of the
# scenes (8, plus 3 per kind of light: 11, 14), a band at row0 > 0, an odd
# width whose rows end inside a lane's 8 floats, and rows of 3 floats (a
# warp's 1,024 floats span more rows than its 32 lanes hold keys for)
THREEFRY_SETS = ((0, 0, 0, RES, RES, 8), (7, 3, 0, RES, RES, 14),
                 (2 ** 31 - 1, 11, 300, 100, RES, 11), (5, 2, 17, 64, 513, 14),
                 (3, 1, 2, 700, 1, 3))
THREEFRY_NS = (8, 11, 14)


def phase_threefry(card: str, dev):
    """The threefry kernel bit for bit against ``uniform_rows_plain`` on the
    card, then both timed on a full pass at ns = 14, and its bound."""
    import torch
    from rayzath_tpu_torch.ops import rng
    from rayzath_tpu_torch.utils.cuda_timing import call_ms, device_ms
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
    # the keyed entry (the render cycle's draw): the pass key folded on the
    # device from the key words and an int32 pass counter, bit for bit as
    # the by-value draw and the plain draw under the host-folded key
    for seed, pass_idx, row0, h, w, ns in THREEFRY_SETS + (
            (9, 2 ** 32 - 1, 0, RES, RES, 14),):
        k = rng.key(seed)
        dk = rng.DeviceKey(rng.key_words(k, dev), torch.tensor(
            pass_idx - (2 ** 32 if pass_idx >= 2 ** 31 else 0),
            dtype=torch.int32, device=dev))
        got = rng.uniform_rows_keyed(dk, row0, h, w, ns, dev)
        ref = rng.uniform_rows(rng.fold_in(k, pass_idx), row0, h, w, ns, dev)
        plain = rng.uniform_rows_plain(
            rng.fold_in_tensor(dk.words, dk.pass_idx), row0, h, w, ns, dev)
        torch.cuda.synchronize()
        if not (torch.equal(got.view(torch.int32), ref.view(torch.int32))
                and torch.equal(got.view(torch.int32), plain.view(torch.int32))):
            raise AssertionError(f"keyed threefry seed {seed} pass {pass_idx} "
                                 f"rows {row0}+{h} width {w} ns {ns}: "
                                 f"{int((got != plain).sum())} floats differ")
    print(f"  keyed threefry: {len(THREEFRY_SETS) + 1} sets bit for bit as the "
          f"by-value kernel and the plain draw under fold_in_tensor",
          flush=True)
    out = {}
    k = rng.fold_in(rng.key(1), 0)
    dk = rng.DeviceKey(rng.key_words(rng.key(1), dev),
                       torch.zeros((), dtype=torch.int32, device=dev))
    h, w, ns = RES, RES, THREEFRY_NS[-1]
    n = h * w * ns
    for name, draw, plain, key_hashes, key_bytes in (
            ("threefry", lambda: rng.uniform_rows(k, 0, h, w, ns, dev),
             lambda: rng.uniform_rows_plain(k, 0, h, w, ns, dev), 0, 0),
            ("threefry_keyed",
             lambda: rng.uniform_rows_keyed(dk, 0, h, w, ns, dev),
             lambda: rng.uniform_rows_plain(
                 rng.fold_in_tensor(dk.words, dk.pass_idx), 0, h, w, ns, dev),
             1, 12)):
        call = call_ms(draw, 20)
        ms = device_ms(draw, 50)
        plain_ms = call_ms(plain, 20)
        # bytes: the uniforms written once (and the keyed entry's key words
        # and pass counter read once); operations: one hash per row key and
        # one hash and conversion per float (and the keyed entry's fold)
        b = bound(n * 4 + key_bytes,
                  n * (HASH_OPS + UNIT_OPS) + (h + key_hashes) * HASH_OPS,
                  ISSUE_S)
        print(f"  {name} times [{card}]: {h}^2 x {ns} uniforms, kernel "
              f"{ms:.4f} ms on the device (50 launches behind a sleep, median "
              f"of 5), the call {call:.4f} ms (its Python wrapper included, "
              f"median of 20), plain {plain_ms:.3f} ms (median of 20), bound "
              f"{b[0]:.4f} ms ({b[1]}): the device time is {ms / b[0]:.2f}x "
              f"the bound", flush=True)
        out[name] = dict(ms=ms, call_ms=call, plain_ms=plain_ms, bound=b,
                         err=0.0)
    return out


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
    from rayzath_tpu_torch.ops import gather, rng
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    return {"B1": tc.cluster_closest, "B2": tc.cluster_shadow,
            "B3": tc.cluster_closest_inst, "B4": tc.cluster_shadow_inst,
            "B2-grad": tc.cluster_shadow_grad,
            "B4-grad": tc.cluster_shadow_inst_grad,
            "threefry": rng.uniform_rows,
            "threefry_keyed": rng.uniform_rows_keyed,
            "G1": gather.gather_rows_fwd, "G2": gather.gather_rows_grad}


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
            "threefry_keyed", "G1")
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
        path_k = (("B3", "B4") if two_level else ("B1", "B2")) + (
            "threefry_keyed", "G1")
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
# phase 4, the skip-link walk: RenderConfig(packet_traversal=False)
# ---------------------------------------------------------------------------

SKIP_PASSES = (("cornell_box_nee", 8), ("mesh_heavy", 4))   # (scene, passes)


def placeholder_ray(scene, dev) -> dict:
    """``init_state``'s placeholder ray (origin 0, direction +z, near 0,
    far BIG), which pass 0 traces for every pixel before it makes camera
    rays (ROADMAP C): B1's id, the skip-link walk's and the f64 Moller-
    Trumbore's, and whether f64 calls the ray chaotic."""
    import torch
    from rayzath_tpu_torch.engine.state import BIG
    from rayzath_tpu_torch.ops import traverse as tw
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    from rayzath_tpu_torch.utils.parity import closest_f64
    o = torch.zeros((1, 3), device=dev)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=dev)
    near, far = torch.zeros(1, device=dev), torch.full((1,), BIG, device=dev)
    b1 = tc.cluster_closest(o, d, near, far, scene.cl_box, scene.cl_lw,
                            scene.cl_order)
    walk = tw.bvh_closest(o, d, near, far, scene.aabb_links, scene.node_count,
                          scene.leaf_tri, scene.tri_v0, scene.tri_e1,
                          scene.tri_e2)
    n = scene.n_triangles
    ref, chaotic = closest_f64(*(x.cpu().numpy() for x in (o, d)),
                               *(x[:n].cpu().numpy() for x in (
                                   scene.tri_v0, scene.tri_e1, scene.tri_e2)),
                               *(x.cpu().numpy() for x in (near, far)))
    return dict(b1=int(b1[1][0]), b1_t=float(b1[0][0]), walk=int(walk[1][0]),
                walk_t=float(walk[0][0]), f64=int(ref[0]),
                chaotic=bool(chaotic[0]))


def walk_ids_vs_b1(card: str, dev) -> dict:
    """The skip-link walk's closest-hit ids against B1's on the 512^2
    camera and bounce-like rays of cornell_box_nee and mesh_heavy, and on
    the placeholder ray of pass 0 (:func:`placeholder_ray`): every ray
    where they differ must be one an f64 Moller-Trumbore calls chaotic (the
    walk's Moller-Trumbore and B1's projection test round apart only
    there). Returns, per scene, whether the two take one id on the
    placeholder ray, so that pass 0 belongs in ``render_gate``."""
    import torch
    from rayzath_tpu_torch.ops import traverse as tw
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    from rayzath_tpu_torch.utils.parity import closest_f64
    same_pass0 = {}
    for name, _ in SKIP_PASSES:
        scene, cam_set, bounce_set = scene_rays(name, dev)
        n = scene.n_triangles
        tris = [x[:n].cpu().numpy() for x in (scene.tri_v0, scene.tri_e1,
                                              scene.tri_e2)]
        shown = []
        for label, (o, d) in (("camera", cam_set), ("bounce", bounce_set)):
            r = o.shape[0]
            near = torch.zeros(r, device=dev)
            far = torch.full((r,), 1e30, device=dev)
            tid_b1 = tc.cluster_closest(o, d, near, far, scene.cl_box,
                                        scene.cl_lw, scene.cl_order)[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tid = tw.bvh_closest(o, d, near, far, scene.aabb_links,
                                 scene.node_count, scene.leaf_tri,
                                 scene.tri_v0, scene.tri_e1, scene.tri_e2)[1]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            bad = torch.nonzero(tid != tid_b1).flatten()
            _, chaotic = closest_f64(*(x[bad].cpu().numpy() for x in (o, d)),
                                     *tris, *(x[bad].cpu().numpy()
                                              for x in (near, far)))
            if not chaotic.all():
                raise AssertionError(
                    f"{name}/{label}: the skip-link walk and B1 differ on "
                    f"{int((~chaotic).sum())} rays f64 does not call chaotic")
            shown.append(f"{label} {len(bad)} of {r} (all f64-chaotic), walk "
                         f"{ms:.1f} ms")
        p = placeholder_ray(scene, dev)
        same_pass0[name] = p["b1"] == p["walk"]
        if not (same_pass0[name] or p["chaotic"]):
            raise AssertionError(f"{name}: B1 and the skip-link walk differ on "
                                 f"the placeholder ray, which f64 does not "
                                 f"call chaotic: {p}")
        shown.append(
            f"the placeholder ray of pass 0: B1 {p['b1']} at t {p['b1_t']:.7g}, "
            f"the walk {p['walk']} at t {p['walk_t']:.7g}, f64 {p['f64']} "
            f"({'chaotic' if p['chaotic'] else 'not chaotic'}), so pass 0 is "
            f"{'in' if same_pass0[name] else 'left out of'} the render gate")
        print(f"{name} skip-link walk ids against B1's: differ on "
              + "; ".join(shown) + f" [{card}]", flush=True)
        del scene
        torch.cuda.empty_cache()
    return same_pass0


def render_gate(name, a, b, max_differ=1e-4):
    """The skip-link render ``a`` against the packet path's ``b``, each the
    accumulation of the timed passes, and of pass 0 where both walks take
    one id on its placeholder ray (``walk_ids_vs_b1``; where they do not,
    the ray is f64-chaotic and pass 0 differs on every pixel, since every
    pixel's first sample traces it). The two walks round apart on
    f64-chaotic rays, so a path there may end a bounce sooner or later and
    move its pixel's sample count; at most ``max_differ`` of the pixels
    may, and the radiance must meet ``images_match``'s rule over all pixels
    (the bulk at fp noise, 0.995 within 2e-3). Returns (pixels whose counts
    differ, the fraction within 2e-3)."""
    import numpy as np
    differ = int((a[..., 3] != b[..., 3]).sum())
    scale = max(float(np.abs(b[..., :3]).max()), 1e-6)
    rel = np.abs(a[..., :3] - b[..., :3]) / scale
    close = float((rel < 2e-3).mean())
    if differ > max_differ * a[..., 3].size:
        raise AssertionError(f"{name}: sample counts differ on {differ} pixels")
    if not (np.percentile(rel, 75) < 1e-6 and close >= 0.995):
        raise AssertionError(f"{name}: only {close:.4f} of pixels within 2e-3")
    return differ, close


def walk_card_vs_cpu(dev):
    """The skip-link walk (``ops/traverse.py``) on the card against the
    same walk on the CPU on cornell_box_nee's 512^2 camera rays: closest
    hit t and ids, then the shadow rays from the hits toward the spot
    light, rgba, all bit for bit."""
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.models.device_scene import compile_world
    from rayzath_tpu_torch.ops import traverse as tw
    world = rt.scenes.cornell_box_nee(RES, RES)
    cpu = torch.device("cpu")
    r = RES * RES
    o, d = (x.cpu() for x in world_rays(world, dev))
    near, far = torch.zeros(r), torch.full((r,), 1e30)
    out, shadow_rays = [], None
    for where in (cpu, dev):      # the CPU first: it makes the shadow rays
        scene = compile_world(world, device=where)
        walk = (scene.aabb_links, scene.node_count, scene.leaf_tri,
                scene.tri_v0, scene.tri_e1, scene.tri_e2)
        t, tid = tw.bvh_closest(*(x.to(where) for x in (o, d, near, far)),
                                *walk)
        if shadow_rays is None:
            p = o + d * (t * 0.9999)[:, None]
            v = scene.spot_pos[0] - p
            dist = torch.linalg.norm(v, dim=1)
            shadow_rays = (p, v / dist[:, None], dist)
        mat = scene.mat_color[scene.tri_mat.long()]
        rgb, a = tw.bvh_shadow(*(x.to(where) for x in shadow_rays), *walk,
                               mat[:, :3], 1.0 - mat[:, 3])
        out.append([x.cpu() for x in (t, tid, rgb, a)])
    for label, a, b in zip(("t", "ids", "rgb", "alpha"), *out):
        if not torch.equal(a, b):
            raise AssertionError(f"skip-link walk, card vs CPU: {label} differ "
                                 f"on {int((a != b).reshape(r, -1).any(1).sum())} "
                                 f"of {r} rays")
    hits = int((out[0][1] >= 0).sum())
    lit = int((out[0][3] >= 1e-4).sum())
    print(f"skip-link walk on cornell_box_nee {RES}^2 camera rays: card bit for "
          f"bit as the CPU ({hits} hits; shadow rays to the spot light, {lit} "
          f"unblocked)", flush=True)


def phase_skiplink(card: str, dev, launches: dict):
    """``Renderer(device="cuda", config=RenderConfig(packet_traversal=
    False))``: the skip-link walk in torch ops, no kernel, on
    cornell_box_nee and mesh_heavy (65,026 triangles, the heaviest soup) at
    512^2, depth 8, a warm-up pass (pass 0) then SKIP_PASSES timed passes;
    NaN-free, samples accumulated, B1-B4 never launched, the threefry kernel
    once per pass; the image against the packet path's render from the same
    seed (``render_gate``); ms per pass and the walks' ms per pass (their
    ``seconds`` counters). Before them, ``walk_card_vs_cpu`` and
    ``walk_ids_vs_b1``. Adds the draw's launches to ``launches``."""
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.ops import traverse as tw
    walk_card_vs_cpu(dev)
    same_pass0 = walk_ids_vs_b1(card, dev)
    wrappers = path_wrappers()
    tracing = rt.Tracing(max_depth=8)
    walks = {"closest": tw.bvh_closest, "shadow": tw.bvh_shadow}
    for name, rpp in SKIP_PASSES:
        world = rt.scenes.SCENES[name](RES, RES)
        accum, shown = {}, ""
        for packet in (False, True):
            r = rt.Renderer(world, rt.RenderConfig(tracing=tracing,
                                                   packet_traversal=packet),
                            seed=9, device=dev)
            r.render(rpp=1)                  # warm-up: compile_world + pass 0
            torch.cuda.synchronize()
            acc0 = r.views[id(world.cameras[0])].state.accum.clone()
            for f in wrappers.values():
                f.launches = 0
            for f in walks.values():
                f.seconds = 0.0
            t0 = time.perf_counter()
            r.render(rpp=rpp)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: f.launches for k, f in wrappers.items()}
            walk_ms = {k: f.seconds * 1e3 / rpp for k, f in walks.items()}
            acc = r.views[id(world.cameras[0])].state.accum
            accum[packet] = (acc if same_pass0[name] else acc - acc0).cpu().numpy()
            if packet:
                shown += f"; the packet path {dt / rpp * 1e3:.1f} ms per pass"
                continue
            if any(counts[k] for k in ("B1", "B2", "B3", "B4")):
                raise AssertionError(f"{name}: a cluster kernel launched in "
                                     f"the skip-link render: {counts}")
            if counts["threefry_keyed"] != rpp:
                raise AssertionError(f"{name}: threefry_keyed launched "
                                     f"{counts['threefry_keyed']} times in "
                                     f"{rpp} passes")
            if not all(walk_ms.values()):
                raise AssertionError(f"{name}: a walk did not run: {walk_ms}")
            launches["threefry_keyed"] += counts["threefry_keyed"]
            if bool(torch.isnan(acc).any()):
                raise AssertionError(f"{name}: NaN in the skip-link accum")
            if not float(acc[..., 3].sum()) > 0:
                raise AssertionError(f"{name}: no samples accumulated")
            shown = (f"{rpp} passes in {dt:.3f} s = {dt / rpp * 1e3:.1f} ms per "
                     f"pass, walks {walk_ms['closest']:.1f} ms closest + "
                     f"{walk_ms['shadow']:.1f} ms shadow per pass, threefry "
                     f"(keyed) launches {counts['threefry_keyed']}, B1-B4 "
                     f"none")
        differ, close = render_gate(name, accum[False], accum[True])
        print(f"{name} skip-link walk (packet_traversal=False): {RES}^2 depth 8, "
              f"{shown}; against the packet path from seed 9 "
              f"({'with' if same_pass0[name] else 'without'} pass 0): sample "
              f"counts differ on {differ} of {RES * RES} pixels, {close:.4f} of "
              f"pixels within 2e-3 [{card}]", flush=True)
        del world
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: training at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_calls(module, name: str):
    """Calls of ``module.<name>`` (a kernel wrapper that a backward looks up
    as a module global) go through a recorder that keeps a copy of each
    call's positional arguments and then calls the wrapper; yields the list
    of those argument tuples."""
    import torch
    fn = getattr(module, name)
    calls = []

    def record(*args, **kw):
        calls.append(tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                           else a for a in args))
        return fn(*args, **kw)

    # the wrapper adds its launches to the counter of the name it is bound
    # to, here the recorder's
    record.launches = 0
    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def hold_step_grads(label: str, kernel, plain, calls, stride: int,
                    op_tab=None) -> dict:
    """A shadow backward's kernel against its plain version on the
    arguments ``calls`` that a training step gave it (every ``stride``-th
    ray), with ``op_tab``, when given, in place of each call's opacity
    table: max |d g| / max |g| <= BACKWARD_RTOL in each call whose plain
    gradient is non-zero, and 0 exactly where it is 0 everywhere. Returns
    the worst relative and absolute errors, the calls with a non-zero
    gradient, the rays held, those with a finite shadow distance and those
    with a cotangent."""
    import torch
    from rayzath_tpu_torch.ops.intersect import BIG
    worst, worst_abs, rays, finite, with_g, scaled = 0.0, 0.0, 0, 0, 0, 0
    for o, d, dist, *tabs, g_rgb, g_a in calls:
        if op_tab is not None:
            tabs[-1] = op_tab
        sub = torch.arange(0, o.shape[0], stride, device=o.device)
        ray_args = [x[sub].contiguous() for x in (o, d, dist)]
        gs = [x[sub].contiguous() for x in (g_rgb, g_a)]
        got, ref = kernel(*ray_args, *tabs, *gs), plain(*ray_args, *tabs, *gs)
        torch.cuda.synchronize()
        diff, scale = float((got - ref).abs().max()), float(ref.abs().max())
        if scale > 0.0:
            scaled += 1
            worst = max(worst, diff / scale)
        elif diff != 0.0:
            raise AssertionError(f"{label} on a training step's arguments: "
                                 f"{diff} where the plain gradient is 0")
        worst_abs = max(worst_abs, diff)
        rays += len(sub)
        finite += int((ray_args[2] < BIG).sum())
        with_g += int(((gs[0] != 0).any(dim=1) | (gs[1] != 0)).sum())
    if not worst <= BACKWARD_RTOL:
        raise AssertionError(f"{label} on a training step's arguments: max "
                             f"rel err {worst:.3e} (rtol {BACKWARD_RTOL})")
    return dict(rel_err=worst, err=worst_abs, calls=len(calls),
                with_grad=scaled, rays=rays, finite_dist=finite,
                with_cotangent=with_g)


def hold_step_grad_cases(label: str, kernel, plain, calls, stride: int,
                         op_tab) -> dict:
    """:func:`hold_step_grads` on the step's own arguments (on an opaque
    scene their gradient may be 0 throughout: a blocked ray meets two
    opaque faces of a closed mesh) and again with ``op_tab``, the scene's
    table with half its materials translucent, where some call must have a
    non-zero gradient. Returns both records, as "step" and "translucent"."""
    out = {"step": hold_step_grads(label, kernel, plain, calls, stride),
           "translucent": hold_step_grads(label, kernel, plain, calls, stride,
                                          op_tab)}
    if not out["translucent"]["with_grad"]:
        raise AssertionError(f"{label} on a training step's arguments, half "
                             f"the materials translucent: no call has a "
                             f"gradient")
    return out


def grad_case_text(rec: dict) -> str:
    a, b = rec["step"], rec["translucent"]
    return (f"{a['calls']} calls, {a['rays']} rays, {a['finite_dist']} with "
            f"a finite dist, {a['with_cotangent']} with a cotangent) against "
            f"the plain version: as given {a['with_grad']} calls with a "
            f"non-zero gradient, max rel err {a['rel_err']:.3e} (max abs "
            f"{a['err']:.3e}); half the materials translucent "
            f"{b['with_grad']} calls with a gradient, max rel err "
            f"{b['rel_err']:.3e} (max abs {b['err']:.3e})")


# G2 against its plain version (the float64 sum rounded once), of the max
# |g| of each call: G2 adds in another order (a tree over warps and blocks,
# or float atomics on the atlases)
GATHER_RTOL = 1e-6


def gather_timing(kernel, plain, library: dict, n_bytes: float,
                  n_ops: float) -> dict:
    """Device and call ms of ``kernel()`` (``utils/cuda_timing``), the
    plain version's ms, each ``library`` call's device ms, and the bound
    of the call's bytes and operations."""
    from rayzath_tpu_torch.utils.cuda_timing import call_ms, device_ms
    out = dict(ms=device_ms(kernel), call_ms=call_ms(kernel, 20),
               plain_ms=plain_runs(plain)[0], bound=bound(n_bytes, n_ops))
    out.update({k: device_ms(f) for k, f in library.items()})
    return out


def phase_gather(card: str, dev, setup: dict, scene) -> dict:
    """G1 and G2 (``ops/gather.py``) on the arguments of one eager training
    step's own gathers, every call recorded: G1 bit for bit as
    ``gather_rows_plain`` in every call, G2 within GATHER_RTOL of the max
    |g| of ``gather_rows_grad_plain`` in every call (0 exactly where that
    is 0), and every call on a table that fits in shared memory the same
    bits twice. Then, on the calls of the material table ``mp`` (262,144
    rays x 14: G1 and G2's fixed-order path), the texture fetch's two
    width-4 calls on the step's largest colour atlas (G1 on the int32 block
    lookup ``blk_idx[texel]`` and on the texels ``atlas[corners]``) and that
    atlas call's backward (G2's atomic path): device and call ms, the plain
    version's ms, the bound (the indices, the table or cotangent and the
    output, each once, over HBM_BYTES_S; G2 also its adds) and the library
    calls: ``table[idx]`` for G1, ``index_add_`` and
    ``index_put_(accumulate=True)`` for G2. The comparisons' launches are
    left out of the counters."""
    import torch
    from rayzath_tpu_torch.ops import _kernels, gather
    from rayzath_tpu_torch.parallel import train
    from rayzath_tpu_torch.utils import check_train as ctr
    t0 = time.perf_counter()
    wrappers = path_wrappers()
    held = {k: f.launches for k, f in wrappers.items()}
    with recorded_calls(gather, "gather_rows_fwd") as fwd, \
            recorded_calls(gather, "gather_rows_grad") as bwd:
        ctr.step_call(train._eager_step, setup, scene, dev)
    lib = _kernels.load()
    for table, idx in fwd:
        got = gather.gather_rows_fwd(table, idx)
        if not torch.equal(got.view(torch.int32),
                           gather.gather_rows_plain(table, idx).view(torch.int32)):
            raise AssertionError(f"G1 on a training step's {tuple(table.shape)} "
                                 f"table, {tuple(idx.shape)} indices: not bit "
                                 f"for bit as its plain version")
    worst, worst_abs, fixed, twice = 0.0, 0.0, 0, True
    for idx, g, n in bwd:
        got = gather.gather_rows_grad(idx, g, n)
        ref = gather.gather_rows_grad_plain(idx, g, n)
        diff, scale = float((got - ref).abs().max()), float(ref.abs().max())
        if scale > 0.0:
            worst = max(worst, diff / scale)
        elif diff != 0.0:
            raise AssertionError(f"G2 on a training step's arguments: {diff} "
                                 f"where the plain gradient is 0")
        worst_abs = max(worst_abs, diff)
        if lib.rz_gather_grad_partials(idx.numel(), n, got.shape[1]):
            fixed += 1
            twice &= torch.equal(got, gather.gather_rows_grad(idx, g, n))
    if not worst <= GATHER_RTOL:
        raise AssertionError(f"G2 on a training step's arguments: max rel err "
                             f"{worst:.3e} (rtol {GATHER_RTOL})")
    if not (fixed and twice):
        raise AssertionError(f"G2: {fixed} calls on tables that fit in shared "
                             f"memory, the same bits twice: {twice}")
    m_rows = scene.n_materials
    mp_fwd = next((t, i) for t, i in fwd if tuple(t.shape) == (m_rows, 14))
    mp_bwd = next((i, g, n) for i, g, n in bwd
                  if n == m_rows and g.shape[-1] == 14)
    hc, wc = scene.color_atlas.shape[:2]
    atlas = max((c for c in bwd if c[2] == hc * wc), key=lambda c: c[0].numel())

    def largest_fwd(dtype, idx_dim):
        return max((c for c in fwd if tuple(c[0].shape) == (hc * wc, 4)
                    and c[0].dtype == dtype and c[1].dim() == idx_dim),
                   key=lambda c: c[1].numel())

    blk_fwd = largest_fwd(torch.int32, 1)          # ops/texture.py blk_idx
    texel_fwd = largest_fwd(torch.float32, 2)      # the atlas at the corners

    def g1_record(table, idx):
        r = idx.numel()
        return dict(rows=r, table=list(table.shape), **gather_timing(
            lambda: gather.gather_rows_fwd(table, idx),
            lambda: gather.gather_rows_plain(table, idx),
            {"library_ms": lambda: table[idx]},
            idx.element_size() * r + table.numel() * 4 * (1 + r / table.shape[0]),
            0))

    def g2_record(idx, g, n):
        m, k = idx.numel(), g.numel() // idx.numel()
        flat, flat64, g2 = idx.reshape(-1), idx.reshape(-1).long(), g.reshape(m, k)
        return dict(rows=m, table=[n, k], **gather_timing(
            lambda: gather.gather_rows_grad(idx, g, n),
            lambda: gather.gather_rows_grad_plain(idx, g, n),
            {"library_ms": lambda: torch.zeros(
                (n, k), device=dev).index_add_(0, flat, g2),
             "index_put_ms": lambda: torch.zeros((n, k), device=dev).index_put_(
                 (flat64,), g2, accumulate=True)},
            idx.element_size() * m + g.numel() * 4 + n * k * 4, m * k))

    out = {"G1": dict(g1_record(*mp_fwd), calls=len(fwd)),
           "G1_blk": g1_record(*blk_fwd),
           "G1_texel": g1_record(*texel_fwd),
           "G2": dict(g2_record(*mp_bwd), calls=len(bwd), rel_err=worst,
                      err=worst_abs, fixed_order_calls=fixed,
                      same_bits_twice=twice),
           "G2_atlas": g2_record(*atlas)}
    del fwd, bwd
    for k, f in wrappers.items():
        f.launches = held[k]
    for key, rec in out.items():
        lib_text = (f"table[idx] {rec['library_ms']:.4f}"
                    if key.startswith("G1") else
                    f"index_add_ {rec['library_ms']:.4f}, index_put_(accumulate"
                    f"=True) {rec['index_put_ms']:.4f}")
        print(f"  {key} on a training step's {rec['table']} table, "
              f"{rec['rows']} rows [{card}]: {rec['ms']:.4f} ms on the device "
              f"(call {rec['call_ms']:.4f}), bound {rec['bound'][0]:.4f} ms "
              f"({rec['bound'][1]}), plain {rec['plain_ms']:.4f} ms, "
              f"{lib_text} ms", flush=True)
    print(f"G1/G2 on one eager training step's own arguments [{card}]: G1 "
          f"{out['G1']['calls']} calls bit for bit; G2 {out['G2']['calls']} "
          f"calls, max rel err {worst:.3e} (max abs {worst_abs:.3e}), "
          f"{fixed} on tables in shared memory the same bits twice: "
          f"{'yes' if twice else 'no'} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return out


def check_steps(label: str, rec: dict) -> None:
    """Every step of a ``check_train.timed_steps`` record left the
    parameters finite and moved the atlas, and its losses are finite and
    descend."""
    for i, c in enumerate(rec["checks"]):
        if not c["finite"]:
            raise AssertionError(f"training: non-finite parameters after "
                                 f"{label} step {i}")
        if not c["atlas_step"] > 0.0:
            raise AssertionError(f"training: {label} step {i} left the atlas "
                                 f"as it was")
    losses = rec["losses"]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"training: {label} loss not finite {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training: {label} loss did not descend {losses}")


def phase_train(card: str, dev, launches: dict):
    """The training step at full width (the training cell of
    ``utils/check_train.py``: textured_room at 512^2, depth 3, 4 passes per
    step, remat, lr 0.01): a first and three timed eager steps
    (``train._eager_step``) and the same with ``training_step`` (a capture,
    then one replay per step). Gates: the first graph step's loss equal to
    the first eager step's bit for bit and its updated parameters within
    TRAIN_RTOL of the max |step|; every eager and graph step leaves the
    parameters finite and moves the atlas; the losses finite and
    descending. Then B2-grad against its plain version on the arguments of
    every shadow backward of one more eager step (all rays; as given and
    with half the materials translucent), the split of one eager step
    under torch.profiler (``utils/profiling.py``, whose range wrappers are
    in place only for that step; no index backward may run in it) and
    :func:`phase_gather`. Then one
    two-level step on instanced_field at 512^2 (compiled with
    ``differentiable=True``, B4-grad's path): a finite loss and a non-zero
    update of the materials; and B4-grad against its plain version on one
    eager two-level step's arguments in the same two cases (every
    STEP_GRAD_STRIDE-th ray). Adds the
    launches of the steps (every path kernel, counters at 0 just before;
    the comparisons' launches left out) to ``launches``; returns what phase
    6 compares its bands with."""
    import dataclasses
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.engine.integrator import render_steps
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.models.device_scene import compile_world, compile_camera
    from rayzath_tpu_torch.ops import rng
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    from rayzath_tpu_torch.parallel import train
    from rayzath_tpu_torch.utils import check_train as ctr
    from rayzath_tpu_torch.utils import profiling
    setup = ctr.train_setup(dev, RES)
    scene = setup["scene"]
    passes, lr = ctr.TRAIN["passes"], ctr.TRAIN["lr"]
    wrappers = path_wrappers()
    for f in wrappers.values():
        f.launches = 0
    eager = ctr.timed_steps(train._eager_step, setup, dev)
    eager_grads = wrappers["B2-grad"].launches
    eager_draws = wrappers["threefry"].launches
    train._STEPS.clear()
    before = {k: f.launches for k, f in wrappers.items()}
    graph = ctr.timed_steps(train.training_step, setup, dev)
    step = train._STEPS[dev]
    counts = {k: f.launches - before[k] for k, f in wrappers.items()}
    steps = 1 + ctr.TRAIN["steps"]
    if not (min(eager_grads, eager_draws, counts["B2-grad"],
                counts["threefry_keyed"]) >= steps * passes):
        raise AssertionError(f"training: launches eager B2-grad {eager_grads}, "
                             f"by-value draw {eager_draws}, graph {counts} "
                             f"over {steps} steps of {passes} passes")
    (e_scene, e_loss), (g_scene, g_loss) = eager["first"], graph["first"]
    if not torch.equal(e_loss, g_loss):
        raise AssertionError(f"training: graph loss {float(g_loss)!r} against "
                             f"eager {float(e_loss)!r}")
    worst = 0.0
    for k in train.DIFF_PARAMS:
        change = float((getattr(e_scene, k) - getattr(scene, k)).abs().max())
        diff = float((getattr(g_scene, k) - getattr(e_scene, k)).abs().max())
        if diff > TRAIN_RTOL * max(change, 1e-30):
            raise AssertionError(f"training: graph {k} differs by {diff}, step "
                                 f"{change}")
        worst = max(worst, diff / change if change else 0.0)
    check_steps("eager", eager)
    check_steps("graph", graph)
    split = profiling.split_step(
        lambda: ctr.step_call(train._eager_step, setup, scene, dev), dev)
    if split["index_backward_kernels"]:
        raise AssertionError(
            f"training: {split['index_backward_kernels']} kernels of torch's "
            f"index backward ({split['index_backward_ms']:.2f} ms) in the "
            f"profiled step: a differentiable gather bypasses gather_rows")
    for k, f in wrappers.items():
        launches[k] += f.launches
    held = {k: f.launches for k, f in wrappers.items()}
    with recorded_calls(tc, "cluster_shadow_grad") as calls:
        ctr.step_call(train._eager_step, setup, scene, dev)
    mat = half_translucent(scene.mat_color)[scene.tri_mat.long()]
    b2 = hold_step_grad_cases(
        "B2-grad", tc.cluster_shadow_grad, tc.cluster_shadow_grad_plain, calls,
        1, tc.cluster_opacity(mat[:, :3], 1.0 - mat[:, 3], scene.cl_order,
                              scene.cl_base, scene.cl_count))
    del calls
    for k, f in wrappers.items():
        f.launches = held[k]
    sp = split["device_ms"]
    print(f"training_step on textured_room {RES}^2, depth 3, {passes} passes "
          f"per step, remat, lr {lr} [{card}]: split of an eager "
          f"step: wall {split['wall_ms']:.1f} ms, device busy "
          f"{split['busy_ms']:.1f} ms (idle {100 * split['idle_share']:.1f}%), "
          + ", ".join(f"{k} {v:.2f}" for k, v in sp.items())
          + f" device ms ({split['unattributed_events']} of "
          f"{split['device_events']} events unattributed); eager s per step "
          f"{[round(x, 4) for x in eager['seconds']]} (first "
          f"{eager['first_s']:.3f}), peak {eager['peak_gib']:.2f} GiB, losses "
          f"{[round(x, 6) for x in eager['losses']]}; graph s per step "
          f"{[round(x, 4) for x in graph['seconds']]} (capture call "
          f"{graph['first_s']:.3f} s, capture {step.capture_ms:.1f} ms), peak "
          f"{graph['peak_gib']:.2f} GiB, losses "
          f"{[round(x, 6) for x in graph['losses']]}; first step: loss bit for "
          f"bit, parameters within {worst:.2e} of the step; every eager and "
          f"graph step: parameters finite, atlas moved (min "
          f"{min(c['atlas_step'] for c in eager['checks'] + graph['checks']):.3e}"
          f"); launches per graph run {counts}; B2-grad on an eager step's "
          f"own arguments ({grad_case_text(b2)}; torch's index backward: "
          f"none; the gathers' backward by call site: "
          + "; ".join(f"{site} {ms:.3f} ms x{n}"
                      for site, (ms, n) in split["gather_sites"].items()),
          flush=True)
    gathers = phase_gather(card, dev, setup, scene)

    # two-level: instanced_field at full width, B4-grad's path
    world = rt.scenes.instanced_field(RES, RES)
    iscene = compile_world(world, two_level=True, differentiable=True, device=dev)
    cam = compile_camera(world.cameras[0], dev)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3), two_level=True)
    dim = iscene.mat_color.clone()
    dim[2:, :3] *= 0.8
    with torch.no_grad():
        st = render_steps(dataclasses.replace(iscene, mat_color=dim), cam, cfg,
                          init_state(RES, RES, dev), rng.key(12), passes)
    target = st.accum[..., :3] / torch.clamp(st.accum[..., 3:4], min=1.0)
    for f in wrappers.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, _, loss = train.training_step(iscene, cam, cfg, init_state(RES, RES, dev),
                                       12, target, lr, passes, remat=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    update = float((new.mat_color - iscene.mat_color)[2:].abs().max())
    grads = wrappers["B4-grad"].launches
    if not (float(loss) == float(loss) and abs(float(loss)) != float("inf")):
        raise AssertionError(f"two-level training: loss {float(loss)}")
    if not (grads >= passes and update > 0.0):
        raise AssertionError(f"two-level training: B4-grad launches {grads}, "
                             f"material update {update}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for k, f in wrappers.items():
        launches[k] += f.launches
    held = {k: f.launches for k, f in wrappers.items()}
    capture_ms = train._STEPS[dev].capture_ms
    train._STEPS.clear()
    stride = STEP_GRAD_STRIDE
    with recorded_calls(tc, "cluster_shadow_inst_grad") as calls:
        train._eager_step(iscene, cam, cfg, init_state(RES, RES, dev), 12,
                          target, lr, passes, remat=True)
    b4 = hold_step_grad_cases(
        "B4-grad", tc.cluster_shadow_inst_grad,
        tc.cluster_shadow_inst_grad_plain, calls, stride,
        tc.instance_opacity(half_translucent(iscene.mat_color),
                            iscene.inst_slot_map))
    del calls
    for k, f in wrappers.items():
        f.launches = held[k]
    print(f"two-level training_step on instanced_field {RES}^2 "
          f"({iscene.exp_tri.shape[0]} expanded triangles), depth 3, {passes} "
          f"passes, remat: loss {float(loss):.6f}, max material update "
          f"{update:.3e}, {dt:.3f} s with the capture ({capture_ms:.1f} ms), "
          f"peak {peak:.2f} GiB, B4-grad launches {grads}; B4-grad on an "
          f"eager step's own arguments (every {stride}th ray: "
          f"{grad_case_text(b4)} [{card}]", flush=True)
    return dict(scene=scene, cam=setup["cam"], cfg=setup["cfg"],
                target=setup["target"], seed=ctr.TRAIN["seed"], lr=lr,
                passes=passes, first=(g_scene, float(g_loss)),
                seconds=graph["seconds"], split=split,
                eager_seconds=eager["seconds"],
                step_grads={"cluster_shadow_grad": b2,
                            "cluster_shadow_inst_grad": b4}, gathers=gathers)


# ---------------------------------------------------------------------------
# phase 6: the front ends and the row-band runtime
# ---------------------------------------------------------------------------

BAND_COUNTS = (1, 2, 4)
BAND_PASSES = 4
TRAIN_BANDS = 2


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
            "threefry_keyed": sum(passes.values())}
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
    """``sharded_training_step`` over two bands on the card (eager, with
    the B2-grad backward) against phase 5's first graph step, same scene,
    target and seed. On the card the bands are coherence-sorted on their
    own (B2's products may differ in the last bits) and B2-grad's atomics
    add in no fixed order, so the gate is a tolerance: loss to rtol 1e-4
    and the updated parameters to 1e-4 of their max |step|."""
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
          f"{[f'{x:.3f}' for x in times]} (unsharded, graph "
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


# ---------------------------------------------------------------------------
# phase 7: the render cycle, one captured CUDA graph per pass
# ---------------------------------------------------------------------------

CYCLE_SCENES = ("cornell_box_nee", "multi_light", "mesh_heavy",
                "instanced_field", "textured_room", "cutout_world")
CYCLE_SEED = 6


def phase_cycle(card: str, dev, launches: dict) -> dict:
    """``Renderer.render`` replays one captured graph per pass
    (``engine/cycle.py``). On the six scenes of :data:`CYCLE_SCENES` at
    512^2, depth 8: ``utils/check_cycle.against_eager`` (every state array
    bit for bit as eager ``render_steps`` from one seed, so sample counts
    equal: an rpp sequence 1, 3, 2, a reprojecting camera move, a material
    edit that captures again, a checkpoint resumed in a fresh renderer).
    Adds the checks' launches to ``launches``; returns the
    ``render_cycle`` record."""
    import torch
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.utils.check_cycle import against_eager, make_world
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=8))
    wrappers = path_wrappers()
    record = {"card": card, "res": RES, "max_depth": 8, "seed": CYCLE_SEED,
              "scenes": {}}
    for name in CYCLE_SCENES:
        for f in wrappers.values():
            f.launches = 0
        t0 = time.perf_counter()
        out = against_eager(make_world(name, RES), cfg, dev, seed=CYCLE_SEED)
        check_s = time.perf_counter() - t0
        for k, f in wrappers.items():
            launches[k] += f.launches
        if out["captures"] != [1, 1, 1, 1, 2, 1]:
            raise AssertionError(f"{name}: captures after each stage "
                                 f"{out['captures']}, not [1, 1, 1, 1, 2, 1]")
        samples = {label: n for label, _, n in out["stages"]}
        if not samples["camera move"] > RES * RES:
            raise AssertionError(f"{name}: the reprojection seeded no samples")
        record["scenes"][name] = {"check_s": check_s, "samples": samples}
        print(f"{name} render cycle [{card}]: graph bit for bit as eager "
              f"render_steps at {RES}^2 depth 8 over rpp 1, 3, 2, a camera "
              f"move, an edit and a resume ({check_s:.1f} s)", flush=True)
        torch.cuda.empty_cache()
    return record


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
    grads = phase_grad_kernels(card, dev)
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
    phase_skiplink(card, dev, launches)
    print(f"phase 4, the skip-link walk {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    t_phase = time.perf_counter()
    train = phase_train(card, dev, launches)
    print(f"phase 5 (training) {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    for k, n in phase_front_ends(card, dev, train).items():
        launches[k] = launches.get(k, 0) + n
    print(f"phase 6 (front ends) {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    t_phase = time.perf_counter()
    cycle = phase_cycle(card, dev, launches)
    print(f"phase 7 (the render cycle) {time.perf_counter() - t_phase:.1f} s",
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
            "ms": m["ms"], "call_ms": m["call_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound"][0],
            "bound_by": m["bound"][1], "library_ms": None, "scene": scene,
            "rays": m["rays"], "plain_rays": m["plain_rays"],
            "needed_visits_per_ray": m["needed_visits_per_ray"]})
        if "visits_per_ray" in m:
            record[-1]["visits_per_ray"] = m["visits_per_ray"]
        if name in backward:
            record[-1].update(backward_max_rel_err=backward[name],
                              backward_rtol=BACKWARD_RTOL)
    # the shadow backwards replace the JAX package's custom_vjp bwd rules
    # (a dense replay compiled by XLA, not a Pallas kernel); B2-grad on
    # mesh_heavy, B4-grad on instanced_field, bounce-like rays, dist = BIG
    for label, name, line in (("B2-grad", "cluster_shadow_grad", 1327),
                              ("B4-grad", "cluster_shadow_inst_grad", 1957)):
        m = grads[name]
        record.append({
            "name": name, "route": "cuda",
            "source": f"rayzath_tpu_torch/csrc/{name}.cu",
            "replaces": f"rayzath_tpu/ops/traverse_cluster.py:{line}",
            "launches": launches[label], "max_abs_err": m["err"],
            "ms": m["ms"], "call_ms": m["call_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound"][0], "bound_by": m["bound"][1],
            "library_ms": None, "scene": m["scene"], "rays": m["rays"],
            "plain_rays": m["plain_rays"],
            "needed_visits_per_ray": m["needed_visits_per_ray"],
            "visits_per_ray": m["visits_per_ray"], "max_rel_err": m["rel_err"],
            "rtol": BACKWARD_RTOL, "same_bits_twice": m["same_bits"],
            "training_step_max_rel_err": max(
                c["rel_err"] for c in train["step_grads"][name].values())})
    # the table gather replaces the JAX package's gather_rows (a one-hot MXU
    # product for tables of at most 128 rows, not a Pallas kernel); timed on
    # a training step's material-table call (262,144 x 14), G2's atomic path
    # on its largest colour atlas call
    gathers = train["gathers"]
    for label, name, key in (("G1", "gather_rows", "G1"),
                             ("G2", "gather_rows_grad", "G2")):
        m = gathers[key]
        record.append({
            "name": name, "route": "cuda",
            "source": "rayzath_tpu_torch/csrc/gather_rows.cu",
            "replaces": "rayzath_tpu/ops/gather.py:16",
            "launches": launches[label],
            "max_abs_err": m.get("err", 0.0), "ms": m["ms"],
            "call_ms": m["call_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound"][0], "bound_by": m["bound"][1],
            "library_ms": m["library_ms"], "rows": m["rows"],
            "table": m["table"], "calls_per_step": m["calls"]})
    g1, g2 = record[-2:]
    timed = ("ms", "call_ms", "plain_ms", "bound", "library_ms", "rows",
             "table")
    g1.update(redesigned=True,
              blk={k: gathers["G1_blk"][k] for k in timed},
              texel={k: gathers["G1_texel"][k] for k in timed})
    g2.update(redesigned=True, index_put_ms=gathers["G2"]["index_put_ms"],
              max_rel_err=gathers["G2"]["rel_err"], rtol=GATHER_RTOL,
              same_bits_twice=gathers["G2"]["same_bits_twice"],
              atlas={k: gathers["G2_atlas"][k] for k in (
                  "ms", "call_ms", "plain_ms", "bound", "library_ms",
                  "index_put_ms", "rows", "table")})
    # the draw replaces no TPU kernel (the JAX package draws in XLA); both
    # entries timed on one 512^2 pass at ns = 14, bit for bit to the plain
    # draw; the keyed entry (the render cycle's) folds the pass key on the
    # device
    for name in ("threefry", "threefry_keyed"):
        m = threefry[name]
        record.append({
            "name": name, "route": "cuda",
            "source": "rayzath_tpu_torch/csrc/threefry.cu", "replaces": None,
            "launches": launches[name], "max_abs_err": m["err"],
            "ms": m["ms"], "call_ms": m["call_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound"][0], "bound_by": m["bound"][1],
            "library_ms": None, "rows": RES, "width": RES,
            "ns": THREEFRY_NS[-1]})
    idle = [r["name"] for r in record if not r["launches"]]
    if idle:
        return fail(f"kernels of the path never launched: {idle}")
    print(json.dumps({"render_cycle": cycle}))
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
