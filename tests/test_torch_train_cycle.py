"""The compiled training step (``rayzath_tpu_torch/parallel/train.py``) on
the CPU.

The port's counterpart of the JAX package's ``jax.jit(training_step)``: a
step whose inputs and outputs live in static buffers, captured into one
CUDA graph on a card and run eagerly through the same buffers on the CPU.
Held here:

* the step object (what ``training_step`` runs) against the eager step
  ``train._eager_step``, bit for bit (the loss, every DIFF_PARAMS leaf,
  every state array and the pass index), over 3 steps on textured_room and
  on a two-level instanced_field(n=3) at 24^2, the third continuing the
  second's post-render state (a non-zero pass counter on the device key);
* the step against the JAX package's jitted ``training_step`` from the same
  seed (Pallas in interpret mode, JAX's gathers exact as in
  tests/test_torch_gradients.py): the loss to rtol 1e-5 and each updated
  parameter's step to rtol 1e-3 of its max |step|; and a fault of both
  (ROADMAP C): the world alpha's escape-distance gradient;
* the graph bookkeeping, with ``torch.cuda``'s graph API replaced by
  recorders (the CPU has no graphs): one capture per set of baked-in
  values, none for a new seed, lr, state or parameter values, the launch
  counters advancing by the captured step's launches per replay, and a
  capture or replay that fails raising instead of stepping eagerly;
* the checkpoints of ``render_steps(remat=True)`` and of the dense shadow
  test restoring no RNG state (a captured step could not read it; the
  render draws no torch numbers), with the same bits as without remat;
* ``ops/vec.prod``, whose backward reads nothing on the host, against
  torch's own ``prod`` and its gradient, with zero factors;
* the training cell of ``utils/check_train.py`` (``chip_smoke.py`` phase
  5's and ``tools/profile_torch.py --train``'s) at 16^2: the step object
  through ``timed_steps`` equal to the eager step bit for bit at every
  step, with a check of every step (parameters finite, atlas moved) that
  also sees a step that leaves the atlas as it was.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu.engine.state import init_state as jinit  # noqa: E402
from rayzath_tpu.models.device_scene import compile_camera as jcompile_camera  # noqa: E402
from rayzath_tpu.models.device_scene import compile_world as jcompile_world  # noqa: E402
from rayzath_tpu.parallel import train as jtrain  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine.integrator import render_steps  # noqa: E402
from rayzath_tpu_torch.engine.state import _ARRAYS, init_state  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import rng  # noqa: E402
from rayzath_tpu_torch.ops import traverse_cluster as tc  # noqa: E402
from rayzath_tpu_torch.ops import vec  # noqa: E402
from rayzath_tpu_torch.parallel import train  # noqa: E402
from rayzath_tpu_torch.utils import check_train as ctr  # noqa: E402

from test_torch_gradients import (assert_grads_match, exact_gathers,  # noqa: E402,F401
                                  lit_world)
from test_torch_render import port_scene  # noqa: E402

RES = 24
CPU = torch.device("cpu")
# name -> (world of a package, two_level)
SCENES = {
    "textured_room": (lambda pkg: pkg.scenes.textured_room(RES, RES), None),
    "instanced_field": (lambda pkg: pkg.scenes.instanced_field(
        RES, RES, n=3, resolution=12), True),
}


def setup(name, depth=3):
    make, two_level = SCENES[name]
    world = make(rt)
    scene = tds.compile_world(world, two_level=two_level,
                              differentiable=bool(two_level), device="cpu")
    cam = tds.compile_camera(world.cameras[0], "cpu")
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=depth),
                          two_level=two_level)
    # the scene's own image from another seed: a loss of noise, whose
    # gradients keep every parameter inside its range
    st = render_steps(scene, cam, cfg, init_state(RES, RES, "cpu"),
                      rng.key(99), 4)
    target = st.accum[..., :3] / torch.clamp(st.accum[..., 3:4], min=1.0)
    return scene, cam, cfg, target


def assert_same_step(a, b):
    (sa, sta, la), (sb, stb, lb) = a, b
    assert torch.equal(la, lb), (float(la), float(lb))
    for k in train.DIFF_PARAMS:
        assert torch.equal(getattr(sa, k), getattr(sb, k)), k
    for f in _ARRAYS:
        assert torch.equal(getattr(sta, f), getattr(stb, f)), f
    assert sta.pass_idx == stb.pass_idx


@pytest.mark.parametrize("name", list(SCENES))
def test_step_equals_eager_step(name):
    scene, cam, cfg, target = setup(name)
    a = b = (scene, init_state(RES, RES, "cpu"), None)
    for i, seed in enumerate((3, 4, 4)):
        # the third step continues the second's progressive estimate
        state_a = init_state(RES, RES, "cpu") if i < 2 else a[1]
        state_b = init_state(RES, RES, "cpu") if i < 2 else b[1]
        got = train.training_step(b[0], cam, cfg, state_b, seed, target, 0.01,
                                  4, remat=True)
        ref = train._eager_step(a[0], cam, cfg, state_a, seed, target, 0.01, 4,
                                remat=True)
        assert_same_step(got, ref)
        assert got[1].pass_idx == (8 if i == 2 else 4)
        if i == 0:
            assert any(float((getattr(got[0], k) - getattr(b[0], k)).abs().max())
                       > 0 for k in train.DIFF_PARAMS)
        a, b = ref, got
    step = train._STEPS[CPU]
    assert step.captures == 0                     # the CPU runs eagerly
    assert step.params["mat_color"].requires_grad


@pytest.mark.parametrize("two_level", [None, True])
def test_step_matches_jax_training_step(two_level, exact_gathers):
    """lit_world at 16^2, depth 3, 3 passes, one step from seed 5: the
    port's step against JAX's jitted training_step."""
    res, n_steps, lr, seed = 16, 3, 0.05, 5
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=3), two_level=two_level)
    tcfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3), two_level=two_level)
    world = lit_world(rz, res)
    js = jcompile_world(world, two_level=two_level)
    jcam = jcompile_camera(world.cameras[0])
    target = np.full((res, res, 3), 0.1, np.float32)
    jnew, _, jl = jtrain.training_step(js, jcam, cfg, jinit(res, res),
                                       jax.random.key(seed), jnp.asarray(target),
                                       lr, n_steps)
    ts = port_scene(js)
    tcam = tds.compile_camera(lit_world(rt, res).cameras[0], "cpu")
    tnew, _, tl = train.training_step(ts, tcam, tcfg, init_state(res, res, "cpu"),
                                      seed, torch.as_tensor(target), lr, n_steps)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    steps_j = {k: np.asarray(getattr(jnew, k)) - np.asarray(getattr(js, k))
               for k in train.DIFF_PARAMS}
    steps_t = {k: (getattr(tnew, k) - getattr(ts, k)).numpy()
               for k in train.DIFF_PARAMS}
    assert_grads_match(steps_j, steps_t, expect=("mat_color", "spot_emission"))


def test_world_alpha_step_blacks_out_both_packages():
    """Records a fault of both packages (ROADMAP C): the world medium's
    Beer's-law factor (1 - alpha)^t of a ray that escapes has the gradient
    -t with t the escape distance (up to BIG), so on instanced_field the
    world material's alpha gets a gradient of order -1e37 in JAX and in
    the port, and one step of even lr 1e-4 clamps that alpha from 0 to 1:
    an opaque world, a black image."""
    res, seed, lr = 16, 3, 1e-4
    world = rz.scenes.instanced_field(res, res, n=3, resolution=12)
    js = jcompile_world(world, two_level=True)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=3), two_level=True)
    target = np.full((res, res, 3), 0.1, np.float32)
    jnew, _, _ = jtrain.training_step(js, jcompile_camera(world.cameras[0]), cfg,
                                      jinit(res, res), jax.random.key(seed),
                                      jnp.asarray(target), lr, 4)
    ts = port_scene(js)
    tcam = tds.compile_camera(rt.scenes.instanced_field(
        res, res, n=3, resolution=12).cameras[0], "cpu")
    tcfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3), two_level=True)
    mc = ts.mat_color.clone().requires_grad_(True)
    loss, _ = train.image_loss(dataclasses.replace(ts, mat_color=mc), tcam, tcfg,
                               init_state(res, res, "cpu"), seed,
                               torch.as_tensor(target), 4)
    g, = torch.autograd.grad(loss, mc)
    tnew, _, _ = train.training_step(ts, tcam, tcfg, init_state(res, res, "cpu"),
                                     seed, torch.as_tensor(target), lr, 4)
    assert float(ts.mat_color[0, 3]) == 0.0
    assert float(g[0, 3]) < -1e30
    assert float(jnew.mat_color[0, 3]) == 1.0 == float(tnew.mat_color[0, 3])


# ---------------------------------------------------------------------------
# graph bookkeeping, with torch.cuda's graph API replaced by recorders
# ---------------------------------------------------------------------------

class FakeGraph:
    fail = False

    def __init__(self):
        self.replays = 0

    def replay(self):
        if FakeGraph.fail:
            raise RuntimeError("an illegal memory access was encountered")
        self.replays += 1


class FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """On the CPU: the step object takes its graph route, and ``torch.cuda``'s
    streams, graphs and syncs are recorders. The step's body is a stand-in
    that records its run and adds 2 to B2-grad's and 3 to the keyed draw's
    launch counters (a capture runs nothing on the device); a replay
    records itself. ``fail`` makes the next capture raise as CUDA's stream
    capture does."""
    rec = {"graphs": [], "fail": False, "bodies": 0}

    @contextlib.contextmanager
    def graph(g, stream, capture_error_mode):
        assert isinstance(stream, FakeStream)
        assert capture_error_mode == "thread_local"
        if rec["fail"]:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        yield
        rec["graphs"].append(g)

    def body(self):
        rec["bodies"] += 1
        tc.cluster_shadow_grad.launches += 2
        rng.uniform_rows_keyed.launches += 3

    step = train._Step(CPU)
    step.graphed = True
    monkeypatch.setattr(train, "_STEPS", {CPU: step})
    monkeypatch.setattr(train._Step, "_body", body)
    monkeypatch.setattr(FakeGraph, "fail", False)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return rec


def _small():
    world = rt.scenes.cornell_box_nee(8, 8)
    scene = tds.compile_world(world, device="cpu")
    cam = tds.compile_camera(world.cameras[0], "cpu")
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=2))
    return world, scene, cam, cfg, torch.full((8, 8, 3), 0.1)


def test_step_captures_once_and_counts_replays(fake_graphs):
    world, scene, cam, cfg, target = _small()
    counters = (tc.cluster_shadow_grad, rng.uniform_rows_keyed)
    start = [f.launches for f in counters]

    def gained():
        return [f.launches - s for f, s in zip(counters, start)]

    def step(s, seed=1, lr=0.01, config=cfg, camera=cam, state=None, **kw):
        st = init_state(8, 8, "cpu") if state is None else state
        return train.training_step(s, camera, config, st, seed, target, lr, 2,
                                   **kw)

    new, _, _ = step(scene)     # the stand-in body leaves the outputs unset
    obj = train._STEPS[CPU]
    graphs = fake_graphs["graphs"]
    assert obj.captures == 1 and len(graphs) == 1 and graphs[0].replays == 1
    assert fake_graphs["bodies"] == 2             # the warm-up and the capture
    assert gained() == [4, 6]                     # the warm-up and one replay
    # the next step (the new scene shares the baked-in tensors), another
    # seed, lr and a continued state: the same graph, the buffers reloaded
    st = dataclasses.replace(init_state(8, 8, "cpu"), pass_idx=5)
    st.accum.fill_(0.5)
    new = dataclasses.replace(new, mat_color=scene.mat_color * 0.5)
    step(new, seed=9, lr=0.25, state=st)
    assert obj.captures == 1 and graphs[0].replays == 2 and gained() == [6, 9]
    assert fake_graphs["bodies"] == 2
    assert torch.equal(obj.words, rng.key_words(rng.key(9), "cpu"))
    assert float(obj.lr) == 0.25 and int(obj.pass0) == 5
    assert torch.equal(obj.params["mat_color"].detach(), new.mat_color)
    assert torch.equal(obj.state.accum, st.accum)
    # each baked-in value captures anew
    other_cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3))
    recompiled = tds.compile_world(world, device="cpu")
    for kw in (dict(config=other_cfg), dict(config=other_cfg, remat=True),
               dict(camera=tds.compile_camera(world.cameras[0], "cpu"))):
        before = obj.captures
        step(new, **kw)
        assert obj.captures == before + 1
    step(recompiled)
    assert obj.captures == 5 and len(graphs) == 5
    assert [g.replays for g in graphs] == [2, 1, 1, 1, 1]
    assert gained() == [2 * (5 + 6), 3 * (5 + 6)]


@pytest.mark.parametrize("stage", ["capture", "replay"])
def test_failed_capture_or_replay_raises(fake_graphs, stage):
    _, scene, cam, cfg, target = _small()
    fake_graphs["fail"] = stage == "capture"
    FakeGraph.fail = stage == "replay"
    match = "could not be captured" if stage == "capture" else "replay failed"
    with pytest.raises(RuntimeError, match=match):
        train.training_step(scene, cam, cfg, init_state(8, 8, "cpu"), 1, target,
                            0.01, 2)
    obj = train._STEPS[CPU]
    # no eager step in place of the graph: the body ran as the warm-up (and,
    # for a replay that fails, as the capture) only
    assert fake_graphs["bodies"] == (1 if stage == "capture" else 2)
    assert obj.captures == (0 if stage == "capture" else 1)
    fake_graphs["fail"] = FakeGraph.fail = False
    train.training_step(scene, cam, cfg, init_state(8, 8, "cpu"), 1, target,
                        0.01, 2)
    assert obj.captures == 1


# ---------------------------------------------------------------------------
# the checkpoints, and a prod whose backward a graph can capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["clusters", "dense"])
def test_checkpoints_restore_no_rng_state(path, monkeypatch):
    """Every checkpoint of a remat step (each bounce, and on the dense path
    each chunk of the shadow test) is non-reentrant and restores no RNG
    state; the step equals the step without remat bit for bit."""
    world, scene, cam, cfg, target = _small()
    if path == "dense":
        cfg = cfg.with_(brute_force_threshold=64)
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    got = train.training_step(scene, cam, cfg, init_state(8, 8, "cpu"), 2,
                              target, 0.01, 3, remat=True)
    assert len(calls) >= 3
    assert all(kw.get("preserve_rng_state") is False
               and kw.get("use_reentrant") is False for kw in calls)
    if path == "dense":     # the shadow test's chunks inside the bounces
        assert len(calls) > 3
    ref = train._eager_step(scene, cam, cfg, init_state(8, 8, "cpu"), 2,
                            target, 0.01, 3, remat=False)
    assert_same_step(got, ref)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_capture_safe_prod_matches_torch(dim):
    """``vec.prod``: torch's product bit for bit, and torch's gradient (to
    rounding), over slices with no, one and two zero factors."""
    rng_ = np.random.default_rng(dim)
    x = rng_.uniform(0.2, 1.5, (3, 4, 5)).astype(np.float32)
    x[1, :, 0] = 0.0                 # one zero factor in each slice
    x[2, :, [1, 3]] = 0.0            # two zero factors
    x = np.ascontiguousarray(np.moveaxis(x, -1, dim))
    a = torch.as_tensor(x).requires_grad_(True)
    b = torch.as_tensor(x).requires_grad_(True)
    ya, yb = vec.prod(a, dim), b.prod(dim=dim)
    assert torch.equal(ya, yb)
    g = torch.as_tensor(rng_.normal(size=ya.shape).astype(np.float32))
    ga, = torch.autograd.grad(ya, a, g)
    gb, = torch.autograd.grad(yb, b, g)
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-7)
    zero_grad = torch.movedim(ga, dim, -1)
    assert bool((zero_grad[1, :, 0] != 0).all())      # the lone zero's
    assert bool((zero_grad[2] == 0).all())


def test_training_cell_checks_every_step():
    setup = ctr.train_setup(CPU, 16)
    eager = ctr.timed_steps(train._eager_step, setup, CPU, steps=2)
    train._STEPS.clear()
    stepped = ctr.timed_steps(train.training_step, setup, CPU, steps=2)
    for rec in (eager, stepped):
        assert len(rec["seconds"]) == 2 and len(rec["losses"]) == 3
        assert len(rec["checks"]) == 3 and rec["peak_gib"] is None
        assert all(c["finite"] and c["atlas_step"] > 0 for c in rec["checks"])
    assert eager["losses"] == stepped["losses"]
    assert eager["checks"] == stepped["checks"]
    for k in train.DIFF_PARAMS:
        assert torch.equal(getattr(eager["scene"], k),
                           getattr(stepped["scene"], k))
    same = ctr.step_check(setup["scene"], setup["scene"])
    assert same == {"finite": True, "atlas_step": 0.0}
    bad = dataclasses.replace(setup["scene"], mat_roughness=torch.full_like(
        setup["scene"].mat_roughness, float("nan")))
    assert not ctr.step_check(setup["scene"], bad)["finite"]
