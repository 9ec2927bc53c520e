"""The render cycle (``rayzath_tpu_torch/engine/cycle.py``) on the CPU.

The port's counterpart of the JAX package's jitted, donated
``render_steps``: a camera view's state in static buffers advanced in
place, on a card by replaying one captured CUDA graph per pass whose draw
folds the pass key on the device. Held here:

* the tensor ``fold_in`` against ``rng.fold_in`` and ``jax.random.fold_in``
  at pass indices 0, 1, 7, 2^31 - 1 and 2^32 - 1, and the plain draw under
  the device-folded key against the draw under the host key, bit for bit;
* the renderer's cycle against eager ``render_steps``, bit for bit (every
  state array and the pass index), on cornell_box_nee, instanced_field
  (two-level) and textured_room at 24^2 (``utils/check_cycle.py``): an rpp
  sequence 1, 3, 2; a camera move under temporal_blend 0.75, whose
  reprojection must read the previous image before the buffers reset; a
  material edit (a recompiled scene, a new capture on a card); a checkpoint
  resumed in a fresh renderer; and two cameras with their own views;
* the same renders against the JAX ``Renderer`` from the same seed
  (``assert_images_match``, as the other parity tests);
* the cycle's graph bookkeeping, with ``torch.cuda``'s graph API replaced
  by recorders (the CPU has no graphs): one capture per scene, config and
  size, none for a camera move, a reset or a checkpoint; the launch
  counters advance by the captured pass's launches per replay; a capture
  that fails raises instead of rendering eagerly.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine import cycle as tcycle  # noqa: E402
from rayzath_tpu_torch.engine.integrator import render_steps  # noqa: E402
from rayzath_tpu_torch.engine.state import init_state  # noqa: E402
from rayzath_tpu_torch.models.device_scene import compile_camera  # noqa: E402
from rayzath_tpu_torch.ops import rng  # noqa: E402
from rayzath_tpu_torch.ops import traverse_cluster as tc  # noqa: E402
from rayzath_tpu_torch.utils.check_cycle import (against_eager,  # noqa: E402
                                                 assert_same_state)

from test_oracle_parity import assert_images_match  # noqa: E402

RES = 24
SEED = 3
# name -> (world of a package, two_level)
SCENES = {
    "cornell_box_nee": (lambda pkg: pkg.scenes.cornell_box_nee(RES, RES), None),
    "instanced_field": (lambda pkg: pkg.scenes.instanced_field(
        RES, RES, n=3, resolution=12), True),
    "textured_room": (lambda pkg: pkg.scenes.textured_room(RES, RES), None),
}


def config(pkg, two_level):
    return pkg.RenderConfig(tracing=pkg.Tracing(max_depth=4),
                            two_level=two_level)


def int32(v: int) -> int:
    return v - 2 ** 32 if v >= 2 ** 31 else v


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1])
def test_fold_in_tensor_matches_jax(data):
    """The device pass counter is an int32, read as uint32 when folded, as
    jax folds its int32 pass counter."""
    for seed in (0, SEED, 2 ** 32 - 1):
        k = rng.key(seed)
        words = rng.key_words(k, "cpu")
        got = rng.fold_in_tensor(words, torch.tensor(int32(data),
                                                     dtype=torch.int32))
        got = (int(got[0]), int(got[1]))
        assert got == rng.fold_in(k, data)
        ref = jax.random.fold_in(jax.random.key(seed), np.uint32(data))
        assert got == tuple(int(x) for x in np.asarray(jax.random.key_data(ref)))


@pytest.mark.parametrize("seed,pass_idx,row0,h,w,ns", [
    (0, 0, 0, 4, 7, 8), (7, 2 ** 31 - 1, 5, 6, 9, 14),
    (2 ** 31 - 1, 2 ** 32 - 1, 300, 3, 16, 11)])
def test_keyed_plain_draw_equals_host_key(seed, pass_idx, row0, h, w, ns):
    k = rng.key(seed)
    dk = rng.DeviceKey(rng.key_words(k, "cpu"),
                       torch.tensor(int32(pass_idx), dtype=torch.int32))
    before = rng.uniform_rows_keyed.launches
    got = rng.uniform_rows_keyed(dk, row0, h, w, ns, "cpu")
    ref = rng.uniform_rows_plain(rng.fold_in(k, pass_idx), row0, h, w, ns)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert rng.uniform_rows_keyed.launches == before    # the plain version
    with pytest.raises(ValueError):                     # an int64 counter
        rng.uniform_rows_keyed(rng.DeviceKey(dk.words, dk.pass_idx.long()),
                               row0, h, w, ns, "cpu")


@pytest.mark.parametrize("name", list(SCENES))
def test_cycle_equals_eager_render_steps(name):
    make, two_level = SCENES[name]
    out = against_eager(make(rt), config(rt, two_level), "cpu", seed=SEED)
    labels = [s[0] for s in out["stages"]]
    assert labels == ["rpp 1", "rpp 3", "rpp 2", "camera move",
                      "material edit", "checkpoint resume"]
    samples = dict((s[0], s[2]) for s in out["stages"])
    # the reprojection seeded the moved view beyond its one pass
    assert samples["camera move"] > RES * RES
    assert out["captures"] == [0] * 6              # the CPU runs eagerly


def test_two_cameras_keep_their_own_views():
    world = rt.scenes.cornell_box_nee(RES, RES)
    first = world.cameras[0]
    second = world.create_camera("second", position=first.position,
                                 resolution=(16, 12))
    second.look_at((0.2, 0.1, 1.0))
    cfg = config(rt, None)
    r = rt.Renderer(world, cfg, seed=SEED, device="cpu")
    r.render(rpp=2)                       # every enabled camera
    r.render(camera=second, rpp=1)
    r.render(camera=first, rpp=3)
    scene = r.scene
    for cam, n in ((first, 5), (second, 3)):
        ref = render_steps(scene, compile_camera(cam, "cpu"), cfg,
                           init_state(cam.width, cam.height, "cpu"),
                           rng.key(SEED), n)
        assert_same_state(cam.name, r.views[id(cam)].state, ref)
        assert r.views[id(cam)].pass_count == n
    assert r.views[id(first)].cycle is not r.views[id(second)].cycle


@pytest.mark.parametrize("name", list(SCENES))
def test_cycle_matches_jax_renderer(name):
    """The port's Renderer (its cycle) against the JAX Renderer from the same
    seed, after an rpp sequence 1, 3, 2 and after a reprojecting camera
    move and one pass."""
    make, two_level = SCENES[name]
    renderers = [rz.Renderer(make(rz), config(rz, two_level), seed=SEED),
                 rt.Renderer(make(rt), config(rt, two_level), seed=SEED,
                             device="cpu")]

    def accum(r):
        return np.array(r.views[id(r.world.cameras[0])].state.accum)

    for n in (1, 3, 2):
        for r in renderers:
            r.render(rpp=n)
    assert_images_match(accum(renderers[1]), accum(renderers[0]))
    for r in renderers:
        r.world.cameras[0].look_at((0.1, 0.0, 1.0))
        r.render(rpp=1)
    moved = accum(renderers[1])
    assert moved[..., 3].sum() > RES * RES
    assert_images_match(moved, accum(renderers[0]))


# ---------------------------------------------------------------------------
# graph bookkeeping, with torch.cuda's graph API replaced by recorders
# ---------------------------------------------------------------------------

class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """On the CPU: ``RenderCycle`` takes its graph route, and ``torch.cuda``'s
    streams, graphs and syncs are recorders. A pass "captured" runs the
    cycle's ``_step``, here a stand-in that adds 1 to B1's and 2 to the
    keyed draw's launch counters and touches no buffer (a capture runs
    nothing on the device); a replay records itself. ``fail`` makes the
    next capture raise as CUDA's stream capture does."""
    rec = {"graphs": [], "fail": False}

    @contextlib.contextmanager
    def graph(g, stream, capture_error_mode):
        assert isinstance(stream, FakeStream)
        assert capture_error_mode == "thread_local"
        if rec["fail"]:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        yield
        rec["graphs"].append(g)

    def step(self, scene, cfg, row0):
        tc.cluster_closest.launches += 1
        rng.uniform_rows_keyed.launches += 2

    monkeypatch.setattr(tcycle.RenderCycle, "captures_passes",
                        lambda self, scene, cfg: True)
    monkeypatch.setattr(tcycle.RenderCycle, "_step", step)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return rec


def test_cycle_captures_once_and_counts_replays(fake_graphs, tmp_path):
    world = rt.scenes.cornell_box_nee(RES, RES)
    cam = world.cameras[0]
    r = rt.Renderer(world, config(rt, None), seed=SEED, device="cpu")
    counters = (tc.cluster_closest, rng.uniform_rows_keyed)
    start = [f.launches for f in counters]

    def gained():
        return [f.launches - s for f, s in zip(counters, start)]

    r.render(rpp=3)
    cv = r.views[id(cam)]
    assert cv.cycle.captures == 1 and len(fake_graphs["graphs"]) == 1
    g = fake_graphs["graphs"][0]
    assert g.replays == 3 and cv.state.pass_idx == 3
    assert gained() == [3, 6]              # the capture itself counts none
    r.render(rpp=5)                        # the same graph
    assert cv.cycle.captures == 1 and g.replays == 8 and gained() == [8, 16]
    cam.look_at((0.1, 0.0, 1.0))           # a move: copies, no capture
    r.render(rpp=1)
    assert cv.cycle.captures == 1 and g.replays == 9
    assert cv.pass_count == 1 and cv.state.pass_idx == 1
    p = str(tmp_path / "cp.npz")
    r.save_checkpoint(p)
    r.load_checkpoint(p)                   # the same size: no capture
    r.render(rpp=2)
    assert cv.cycle.captures == 1 and cv.state.pass_idx == 3
    world.materials[1].roughness = 0.3     # a recompiled scene
    r.render(rpp=1)
    assert cv.cycle.captures == 2 and fake_graphs["graphs"][1].replays == 1
    r.config = r.config.with_(tracing=rt.Tracing(max_depth=3))
    r.render(rpp=2)                        # another config
    assert cv.cycle.captures == 3 and fake_graphs["graphs"][2].replays == 2
    assert gained() == [14, 28]


def test_failed_capture_raises_and_renders_nothing(fake_graphs):
    world = rt.scenes.cornell_box_nee(RES, RES)
    r = rt.Renderer(world, config(rt, None), seed=SEED, device="cpu")
    r.render(rpp=2)
    cv = r.views[id(world.cameras[0])]
    fake_graphs["fail"] = True
    world.materials[1].roughness = 0.3     # a recompiled scene: a new capture
    launches = tc.cluster_closest.launches
    with pytest.raises(RuntimeError, match="could not be captured"):
        r.render(rpp=2)
    # no eager fallback: the state stays as the edit reset it
    assert cv.cycle.captures == 1 and cv.state.pass_idx == 0
    assert cv.pass_count == 0 and tc.cluster_closest.launches == launches
    assert float(cv.state.accum.abs().sum()) == 0.0
