"""The one generator of the benchmark's traffic: a mix file names its kind
and parameters, and the configuration file the scene and render settings.

Every loop is closed: one caller waits for each result. Kinds:

* ``progressive``: ``Renderer.render()`` cycles of the configuration's
  ``rpp`` passes on a still camera, each blocking, from the fresh
  accumulation of set-up (the headless runner's loop). A unit is a cycle.
* ``train``: ``parallel.train.training_step`` (the captured step) step after
  step, each from the parameters the last returned, with seed = run seed +
  step index. A unit is a step.
* ``interactive``: a viewer user dragging the camera: each frame yaws the
  camera about a point, renders ``rpp`` passes and reads the tone-mapped
  image back to the host. A unit is a frame.

Set-up builds the world from the configuration's scene builder, warms
every shape the window uses (the graphs are captured there) and makes the
inputs from the seed. The checks that decide ``correct`` (:meth:`check`)
run after the window, once the program's state is released; they compare
what the window produced with the plain reference of ``reference/``.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from ..reference import tracer as ref
from ..reference import train as ref_train
from ..reference import world as ref_world
from .trace import span, traced

MASK32 = 0xFFFFFFFF


def _settings(config: dict) -> dict:
    r = config["render"]
    return dict(max_depth=int(r["max_depth"]), rpp=int(r["rpp"]),
                spot_light=int(r["spot_light"]),
                direct_light=int(r["direct_light"]))


def _render_config(rt, s: dict):
    return rt.RenderConfig(
        tracing=rt.Tracing(max_depth=s["max_depth"], rpp=s["rpp"]),
        light_sampling=rt.LightSampling(spot_light=s["spot_light"],
                                        direct_light=s["direct_light"]))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _release(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def share_mismatched(prog, want, prog_end=None, want_end=None,
                     tol: float = 1e-3) -> torch.Tensor:
    """Per sample (row) whether the program's ``prog`` [K, C] misses the
    reference's ``want``: the widest gap of a row over the larger of its
    own magnitude and a hundredth of the mean magnitude exceeds ``tol``
    (NaN misses), or, where end states are given, the path depths differ
    or the directions differ by more than ``tol``."""
    prog, want = prog.double(), want.double()
    floor = 1e-2 * want.abs().mean().clamp(min=1e-30)
    gap = (prog - want).abs().amax(1) / want.abs().amax(1).clamp(min=floor)
    bad = ~(gap <= tol)
    if prog_end is not None:
        bad |= prog_end["depth"].long() != want_end["depth"].long()
        dgap = (prog_end["d"].double() - want_end["d"].double()).abs().amax(1)
        bad |= ~(dgap <= tol)
    return bad


class Recorder:
    """Rows of device tensors gathered once per unit of work into blocks
    allocated ahead (a new block every ``BLOCK`` units), so that recording
    allocates nothing while the window runs. ``fields``: name -> row width
    (None: a scalar per pixel) and dtype."""

    BLOCK = 256

    def __init__(self, fields: dict, pixels):
        self.fields, self.pixels = fields, pixels
        self.blocks: list = []
        self.ok: list = []          # per unit: recorded (False: it raised)

    def __len__(self) -> int:
        return len(self.ok)

    def record(self, sources) -> None:
        """``sources``: name -> tensor [R, width] (or [R]), or None when the
        unit raised."""
        b, r = divmod(len(self.ok), self.BLOCK)
        if sources is not None:
            while b >= len(self.blocks):
                k, dev = self.pixels.shape[0], self.pixels.device
                self.blocks.append({
                    f: torch.empty((self.BLOCK, k) + (() if w is None else (w,)),
                                   dtype=dt, device=dev)
                    for f, (w, dt) in self.fields.items()})
            for f, src in sources.items():
                torch.index_select(src, 0, self.pixels, out=self.blocks[b][f][r])
        self.ok.append(sources is not None)

    def __getitem__(self, u: int):
        if not self.ok[u]:
            return None
        b, r = divmod(u, self.BLOCK)
        return {f: t[r] for f, t in self.blocks[b].items()}


_F32, _I32 = torch.float32, torch.int32
#: the path state a progressive cycle records per sampled pixel
PATH_FIELDS = {"accum": (4, _F32), "o": (3, _F32), "d": (3, _F32),
               "thr": (3, _F32), "med": (None, _I32), "depth": (None, _I32),
               "near": (None, _F32), "far": (None, _F32), "score": (None, _F32)}


class Progressive:
    """Traffic keys: ``check_pixels`` (pixels drawn from the seed whose
    every cycle is recorded), ``check_cycles`` (window cycles drawn from
    the seed and compared, besides set-up's cycle and the last),
    ``trace_cycles`` (cycles a traced run profiles)."""

    def __init__(self, config, traffic, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.s = _settings(config)
        self.width, self.height = int(config["width"]), int(config["height"])
        self.failed = 0

    # -- the program ----------------------------------------------------------
    def setup(self) -> None:
        import rayzath_tpu_torch as rt
        self.world = getattr(rt.scenes, self.config["scene"])(self.width,
                                                               self.height)
        self.renderer = rt.Renderer(self.world, _render_config(rt, self.s),
                                    seed=self.seed & MASK32, device=self.device)
        gen = np.random.default_rng(self.seed)
        k = min(int(self.traffic["check_pixels"]), self.width * self.height)
        self.pixels = torch.as_tensor(
            np.sort(gen.choice(self.width * self.height, k, replace=False)),
            device=self.device)
        self.snaps = Recorder(PATH_FIELDS, self.pixels)
        self.finite = torch.ones(1 << 16, dtype=torch.bool, device=self.device)
        self.cycle()            # builds the scene, captures the pass
        _sync(self.device)

    def cycle(self) -> None:
        with span("render"):
            try:
                self.renderer.render(rpp=self.s["rpp"])
            except RuntimeError:
                self.failed += 1
                self.snaps.record(None)
                return
        with span("record"):
            st = self.renderer.view(self.world.cameras[0]).state
            self.finite[len(self.snaps)] = torch.isfinite(st.accum).all()
            self.snaps.record({
                "accum": st.accum.reshape(-1, 4), "o": st.origin,
                "d": st.direction, "thr": st.throughput, "med": st.medium,
                "depth": st.path_depth, "near": st.near, "far": st.far,
                "score": st.score})

    def window(self, seconds: float, trace: bool) -> dict:
        first = len(self.snaps)
        tr = None
        t0 = time.perf_counter()
        if trace:
            k = int(self.traffic["trace_cycles"])
            tr = traced("progressive", lambda: [self.cycle() for _ in range(k)],
                        lambda _: k * self.s["rpp"], self.device)
        while time.perf_counter() - t0 < seconds:
            self.cycle()
        elapsed = time.perf_counter() - t0
        cycles = len(self.snaps) - first
        ok = torch.tensor(self.snaps.ok[first:], device=self.device)
        self.failed += int((ok & ~self.finite[first:len(self.snaps)]).sum())
        rays = self.width * self.height * self.s["rpp"] * cycles
        return dict(attempted=cycles, failed=self.failed, trace=tr,
                    e2e={"rays_per_s": rays / elapsed})

    def release(self) -> None:
        del self.renderer
        _release(self.device)

    # -- the check ------------------------------------------------------------
    def chosen_cycles(self) -> list:
        """Set-up's cycle (from fresh paths), the window's last, and
        ``check_cycles`` more of the window drawn from the seed."""
        n = len(self.snaps)
        gen = np.random.default_rng(self.seed + 1)
        inner = list(range(1, n - 1))
        k = min(int(self.traffic["check_cycles"]), len(inner))
        drawn = gen.choice(inner, k, replace=False) if k else []
        return sorted({0, n - 1} | {int(c) for c in drawn})

    def check(self, produce=None) -> list:
        """[(name, value, limit key)]: the share of (pixel, cycle) samples
        of :meth:`chosen_cycles` where the program's accumulation added
        over the cycle, or its paths after it, miss the reference's, which
        runs the cycle from the program's paths before it (from fresh
        paths for set-up's cycle). ``produce`` (a dtype) puts the
        reference in that precision in the program's place: the control."""
        sc = ref.Scene(ref_world.flatten(self.world), self.device, torch.float32)
        alt = None if produce is None else ref.Scene(
            ref_world.flatten(self.world), self.device, produce)
        xs = (self.pixels % self.width).long()
        ys = (self.pixels // self.width).long()
        cfg, rpp = self.s, self.s["rpp"]
        bad = []
        for c in self.chosen_cycles():
            after, before = self.snaps[c], (None if c == 0 else self.snaps[c - 1])
            if after is None or (c and before is None):
                bad.append(torch.ones(len(xs), dtype=torch.bool,
                                      device=self.device))
                continue
            start = None if before is None else {
                "o": before["o"], "d": before["d"], "thr": before["thr"],
                "med": before["med"].long(), "depth": before["depth"].long(),
                "near": before["near"], "far": before["far"],
                "score": before["score"]}
            with torch.no_grad():
                end, rad, cnt = ref.trace(sc, cfg, self.seed & MASK32, c * rpp,
                                          rpp, xs, ys, start)
                want = torch.cat([rad, cnt[:, None]], 1)
                if alt is None:
                    got = after["accum"] - (0.0 if before is None
                                            else before["accum"])
                    got_end = after
                else:
                    cast = None if start is None else {
                        k: (v.to(produce) if v.is_floating_point() else v)
                        for k, v in start.items()}
                    got_end, r2, c2 = ref.trace(alt, cfg, self.seed & MASK32,
                                                c * rpp, rpp, xs, ys, cast)
                    got = torch.cat([r2, c2[:, None]], 1).float()
            bad.append(share_mismatched(got, want, got_end, end))
        return [("mismatch_share", float(torch.cat(bad).double().mean()),
                 "mismatch_share")]


#: the program's training leaves and the reference's kind of leaf for each
LEAF_KIND = {"mat_color": "mat_color", "mat_metalness": "mat_metalness",
             "mat_roughness": "mat_roughness", "mat_emission": "mat_emission",
             "mat_ior": "mat_ior", "mat_scattering": "mat_scattering",
             "color_atlas": "color_maps", "scalar_atlas": "scalar_maps",
             "spot_emission": "spot_emission", "dir_emission": "dir_emission"}


def norm_gap(got: float, want: float, floor: float) -> float:
    """|got - want| over the larger of ``want`` and ``floor``."""
    return abs(got - want) / max(want, floor, 1e-30)


class Train:
    """Traffic keys: ``width``, ``height``, ``max_depth``, ``passes`` (per
    step), ``lr``, ``target_material``, ``target_emission_scale`` and
    ``target_seed`` (the target is the mean image of ``passes`` passes of
    the scene with that material's emission scaled, made by the
    reference), ``check_steps`` (the first steps the reference follows),
    ``trace_steps``."""

    def __init__(self, config, traffic, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        s = _settings(config)
        self.s = dict(s, max_depth=int(traffic["max_depth"]))
        self.width, self.height = int(traffic["width"]), int(traffic["height"])
        self.passes, self.lr = int(traffic["passes"]), float(traffic["lr"])
        self.failed, self.k = 0, 0

    def _flat(self) -> dict:
        return ref_world.flatten(self.world)

    def _target(self):
        flat = self._flat()
        names = [m.name for m in self.world.materials]
        mid = 2 + names.index(self.traffic["target_material"])
        flat["mat_emission"] = flat["mat_emission"].copy()
        flat["mat_emission"][mid] *= float(self.traffic["target_emission_scale"])
        sc = ref.Scene(flat, self.device, torch.float32)
        return ref_train.render(sc, self.s, int(self.traffic["target_seed"]),
                                self.passes, self.width, self.height)

    def setup(self) -> None:
        import rayzath_tpu_torch as rt
        from rayzath_tpu_torch.engine.state import init_state
        from rayzath_tpu_torch.models.device_scene import (compile_camera,
                                                           compile_world)
        from rayzath_tpu_torch.parallel.train import training_step
        self.world = getattr(rt.scenes, self.config["scene"])(self.width,
                                                               self.height)
        dev, w, h = self.device, self.width, self.height
        self.target = self._target()
        scene = compile_world(self.world, device=dev)
        cam = compile_camera(self.world.cameras[0], dev)
        cfg = _render_config(rt, self.s)

        def call(scene):
            with span("step"):
                out = training_step(scene, cam, cfg, init_state(w, h, dev),
                                    (self.seed + self.k) & MASK32, self.target,
                                    self.lr, self.passes, remat=True)
            self.k += 1
            return out

        self.call = call
        self.p = [{k: getattr(scene, k).clone() for k in LEAF_KIND}]
        self.losses, self.images = [], []
        for i in range(int(self.traffic["check_steps"])):
            scene, st, loss = call(scene)
            self.losses.append(float(loss))
            self.images.append(st.accum)
            if i == 0:
                self.p.append({k: getattr(scene, k).clone() for k in LEAF_KIND})
        self.p.append({k: getattr(scene, k).clone() for k in LEAF_KIND})
        self.scene = scene
        _sync(dev)

    def step(self) -> None:
        try:
            self.scene, _, loss = self.call(self.scene)
            if not math.isfinite(float(loss)):
                self.failed += 1
        except RuntimeError:
            self.failed += 1

    def window(self, seconds: float, trace: bool) -> dict:
        first, tr = self.k, None
        t0 = time.perf_counter()
        if trace:
            n = int(self.traffic["trace_steps"])
            tr = traced("train", lambda: [self.step() for _ in range(n)],
                        lambda _: n, self.device)
        while time.perf_counter() - t0 < seconds:
            self.step()
        elapsed = time.perf_counter() - t0
        steps = self.k - first
        return dict(attempted=steps, failed=self.failed, trace=tr,
                    e2e={"train_step_s": elapsed / steps})

    def release(self) -> None:
        del self.scene, self.call
        _release(self.device)

    # -- the check ------------------------------------------------------------
    def _follow(self, dtype, rows=None):
        """The reference's first steps in ``dtype`` (over image ``rows``):
        (losses, {kind: norm of the first gradient}, [{kind: [leaves]}
        before, after the first step, after the last], [each step's mean
        image [H * W, 3]])."""
        sc = ref.Scene(self._flat(), self.device, dtype)

        def leaves():
            out = {}
            for kind, t in ref_train.leaf_list(sc):
                out.setdefault(kind, []).append(t.detach().float().clone())
            return out

        states, losses, grad, images = [leaves()], [], {}, []
        for i in range(len(self.losses)):
            loss, g, img = ref_train.step(sc, self.s, (self.seed + i) & MASK32,
                                          self.passes, self.target, self.lr, rows)
            losses.append(loss)
            images.append(img.float())
            if i == 0:
                grad = {k: ref_train.norms(v) for k, v in g.items()}
                states.append(leaves())
        states.append(leaves())
        return losses, grad, states, images

    def check(self, produce=None, fault=None) -> list:
        """[(name, value, limit key)]: of the first ``check_steps`` steps,
        the widest relative gap of a step's loss; the worst leaf's gap
        between the norms of the first update (``update_gap``) and of the
        change over the steps (``change_gap``), against the reference's,
        each over the larger of the reference's norm and the median
        leaf's; leaves whose first gradient in the reference is under a
        thousandth of the median leaf's are not counted. ``produce`` (a
        dtype) puts the reference in that precision in the program's
        place (the control); ``fault="half_batch"`` puts there the
        reference whose loss is the mean over the first half of the
        rows."""
        losses, grad, want, want_img = self._follow(torch.float32)
        if produce is None and fault is None:
            got_losses = self.losses
            got = [{LEAF_KIND[k]: [v] for k, v in p.items()} for p in self.p]
            got_img = [(a[..., :3] / torch.clamp(a[..., 3:4], min=1.0)).reshape(-1, 3)
                       for a in self.images]
        else:
            rows = (torch.arange(self.height // 2, device=self.device)
                    if fault == "half_batch" else None)
            got_losses, _, got, got_img = self._follow(produce or torch.float32,
                                                       rows)
        med = float(np.median(list(grad.values())))
        counted = [k for k, g in grad.items() if g >= 1e-3 * med]

        def gaps(a, b):
            d_got = {k: ref_train.norms([x - y for x, y in zip(got[b][k], got[a][k])])
                     for k in counted}
            d_want = {k: ref_train.norms([x - y for x, y in zip(want[b][k], want[a][k])])
                      for k in counted}
            m = float(np.median(list(d_want.values())))
            return max(norm_gap(d_got[k], d_want[k], m) for k in counted)

        loss_gap = max(abs(g - w) / max(abs(w), 1e-30)
                       for g, w in zip(got_losses, losses))
        n = min(len(a) for a in got_img + want_img)
        pixels = float(torch.cat([share_mismatched(a[:n], b[:n]) for a, b in
                                  zip(got_img, want_img)]).double().mean())
        return [("image_mismatch_share", pixels, "image_mismatch_share"),
                ("loss_gap", loss_gap, "loss_gap"),
                ("update_gap", gaps(0, 1), "update_gap"),
                ("change_gap", gaps(0, 2), "change_gap")]


def tone_map(accum, aperture: float, exposure: float):
    """uint8 rgb of an accumulation [.., 4]: radiance over the sample count
    (1 where none), times the aperture's area, the exposure time and 1e5,
    through v / (v + 1), times 255, clamped and truncated."""
    n = accum[..., 3:4]
    v = accum[..., :3] / torch.where(n == 0.0, torch.ones_like(n), n)
    v = v * (math.pi * aperture * aperture) * exposure * 1.0e5
    return torch.clamp(v / (v + 1.0) * 255.0, 0.0, 255.0).to(torch.uint8)


class Interactive:
    """Traffic keys: ``rpp`` (passes a frame), ``yaw_deg`` (the camera's
    turn about the vertical axis through ``pivot`` each frame, looking at
    ``pivot``), ``warm_frames`` (frames of set-up), ``check_pixels``,
    ``check_frames`` (window frames drawn from the seed among the first
    ``check_span``, besides set-up's first frame and the window's last),
    ``trace_frames``."""

    def __init__(self, config, traffic, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.s = _settings(config)
        self.rpp = int(traffic["rpp"])
        self.width, self.height = int(config["width"]), int(config["height"])
        self.failed = 0
        self.frames: list = []      # per frame: camera, image rows, prev
        self.times: list = []
        self.timers: dict = {"temporal reproject": [], "tone mapping": []}

    def setup(self) -> None:
        import rayzath_tpu_torch as rt
        self.world = getattr(rt.scenes, self.config["scene"])(self.width,
                                                               self.height)
        self.camera = self.world.cameras[0]
        self.renderer = rt.Renderer(self.world, _render_config(rt, self.s),
                                    seed=self.seed & MASK32, device=self.device)
        gen = np.random.default_rng(self.seed)
        k = min(int(self.traffic["check_pixels"]), self.width * self.height)
        self.pixels = np.sort(gen.choice(self.width * self.height, k,
                                         replace=False))
        self.accums = Recorder({"accum": (4, _F32)},
                               torch.as_tensor(self.pixels, device=self.device))
        self.finite = torch.ones(1 << 16, dtype=torch.bool, device=self.device)
        span_ = int(self.traffic["check_span"])
        first = int(self.traffic["warm_frames"]) + 1
        self.chosen = {first + int(i) for i in gen.choice(
            span_, int(self.traffic["check_frames"]), replace=False)}
        self.pivot = np.asarray(self.traffic["pivot"], np.float64)
        self.frame(move=False)      # the first frame, from fresh paths
        for _ in range(int(self.traffic["warm_frames"])):
            self.frame()
        _sync(self.device)

    def _move(self) -> None:
        a = math.radians(float(self.traffic["yaw_deg"]))
        c, s = math.cos(a), math.sin(a)
        p = np.asarray(self.camera.position, np.float64) - self.pivot
        self.camera.position = (np.array([c * p[0] + s * p[2], p[1],
                                          -s * p[0] + c * p[2]])
                                + self.pivot).astype(np.float32)
        self.camera.look_at(self.pivot)

    def frame(self, move: bool = True) -> None:
        n = len(self.frames)
        t0 = time.perf_counter()
        try:
            with span("frame"):
                if move:
                    self._move()
                cv = self.renderer.view(self.camera)    # the move's reset
                prev = cv.pending_reprojection
                self.renderer.render(self.camera, rpp=self.rpp)
                img = self.renderer.image(self.camera)
        except RuntimeError:
            self.failed += 1
            self.frames.append(None)
            self.accums.record(None)
            return
        self.times.append(time.perf_counter() - t0)
        entries = self.renderer.time_table.entries()
        for k in self.timers:
            if k in entries and (move or k != "temporal reproject"):
                self.timers[k].append(entries[k][0])
        with span("record"):
            self.finite[n] = torch.isfinite(cv.state.accum).all()
            self.accums.record({"accum": cv.state.accum.reshape(-1, 4)})
            rec = dict(position=np.array(self.camera.position),
                       rotation=np.array(self.camera.rotation),
                       image=img.reshape(-1, 3)[self.pixels])
        # the program's previous accumulation and depth (its own snapshots
        # of the move), held for the frames the check follows and the last
        rec["prev"] = None if prev is None else (prev[1], prev[2])
        self.frames.append(rec)
        if n >= 1 and self.frames[n - 1] is not None and (n - 1) not in self.chosen:
            self.frames[n - 1]["prev"] = None

    def window(self, seconds: float, trace: bool) -> dict:
        first, tr = len(self.frames), None
        self.times.clear()
        for v in self.timers.values():
            v.clear()
        t0 = time.perf_counter()
        if trace:
            n = int(self.traffic["trace_frames"])
            tr = traced("interactive", lambda: [self.frame() for _ in range(n)],
                        lambda _: n, self.device)
        while time.perf_counter() - t0 < seconds:
            self.frame()
        frames = len(self.frames) - first
        ok = torch.tensor(self.accums.ok[first:], device=self.device)
        self.failed += int((ok & ~self.finite[first:len(self.frames)]).sum())
        if tr is not None:
            tr.timers = {k: list(v) for k, v in self.timers.items()}
        p95 = float(np.percentile(np.asarray(self.times) * 1e3, 95))
        return dict(attempted=frames, failed=self.failed, trace=tr,
                    e2e={"frame_ms_p95": p95})

    def release(self) -> None:
        del self.renderer
        _release(self.device)

    def _camera(self, sc, rec) -> dict:
        from ..reference.world import camera_axes
        return dict(sc.cam, position=torch.as_tensor(rec["position"], dtype=sc.dtype,
                                                     device=self.device),
                    axes=torch.as_tensor(camera_axes(rec["rotation"]),
                                         dtype=sc.dtype, device=self.device))

    def _reference_frame(self, sc, f: int, xs, ys):
        """The reference's frame ``f`` at the sampled pixels: for a moved
        frame the previous accumulation reprojected from the program's
        previous frame, then ``rpp`` passes from fresh paths, tone mapped."""
        rec = self.frames[f]
        sc.cam = self._camera(sc, rec)
        k = xs.shape[0]
        seeded = torch.zeros((k, 4), dtype=sc.dtype, device=self.device)
        if f > 0:
            prev_acc, prev_depth = rec["prev"]
            prev = self._camera(sc, self.frames[f - 1])
            seeded = ref.reproject(sc, prev, prev_acc.to(sc.dtype),
                                   prev_depth.to(sc.dtype),
                                   float(self.camera.temporal_blend), xs, ys)
        _, rad, cnt = ref.trace(sc, self.s, self.seed & MASK32, 0, self.rpp,
                                xs, ys)
        acc = seeded + torch.cat([rad, cnt[:, None]], 1)
        return acc.float(), tone_map(acc.float(), sc.cam["aperture"],
                                     sc.cam["exposure_time"])

    def check(self, produce=None) -> list:
        """[(name, value, limit key)]: the share of sampled pixels of the
        checked frames whose accumulation misses the reference's (as in
        :func:`share_mismatched`) or whose image differs from the
        reference's by more than one level in a channel (the tone map's
        rounding). The reference follows each checked
        frame from the program's previous accumulation and depth (the
        first frame from fresh paths); ``produce`` puts the reference in
        that precision in the program's place (the control)."""
        flat = ref_world.flatten(self.world)
        sc = ref.Scene(flat, self.device, torch.float32)
        alt = None if produce is None else ref.Scene(flat, self.device, produce)
        idx = torch.as_tensor(self.pixels, device=self.device)
        xs, ys = idx % self.width, idx // self.width
        last = len(self.frames) - 1
        bad = []
        for f in sorted(c for c in self.chosen | {0, last} if c <= last):
            rec = self.frames[f]
            if rec is None or (f > 0 and rec["prev"] is None):
                bad.append(torch.ones(len(xs), dtype=torch.bool))
                continue
            with torch.no_grad():
                acc, img = self._reference_frame(sc, f, xs, ys)
                got_acc, got_img = ((self.accums[f]["accum"],
                                     torch.as_tensor(rec["image"]))
                                    if alt is None else
                                    self._reference_frame(alt, f, xs, ys))
            bad.append(share_mismatched(got_acc, acc).cpu()
                       | ((got_img.cpu().int() - img.cpu().int()).abs().amax(1) > 1))
        return [("mismatch_share", float(torch.cat(bad).double().mean()),
                 "mismatch_share")]


KINDS = {"progressive": Progressive, "train": Train, "interactive": Interactive}
