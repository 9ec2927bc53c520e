"""The work counters of the instanced walk, B3 ``cluster_closest_inst`` and
B4 ``cluster_shadow_inst`` (``rayzath_tpu_torch/ops/traverse_cluster.py``
``WorkCounter``): ``rays`` on the host, and per device the instance visits
and (instance, cluster) tests that the kernels add to, one atomicAdd per
counter per block, and B4's live rays (dist > 0).

On the CPU: the plain versions' counts equal the sums of their per-ray
``visits``, a render counts each pass's rays, a captured graph's replays
advance ``rays`` as they advance ``launches`` (``torch.cuda``'s graph API
replaced by recorders), every kernel wrapper of ``ops/`` launches through
``_kernels.launch`` and is in its registry, whose every counter a capture
and its replays advance, and a soup scene counts nothing. On a card
(skipped without one; the file imports no jax, so run it there with
``python -m pytest --noconftest tests/test_torch_inst_counters.py``): the
counters of a replayed graph equal its ``visits`` buffers' sums, B3's and
B4's outputs are the same bits with and without counting, and a soup
render leaves the counters at zero while a two-level render moves them.
"""
import ast
import contextlib
import importlib
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import rayzath_tpu_torch as rt
from rayzath_tpu_torch.engine import cycle, integrator
from rayzath_tpu_torch.models import device_scene as tds
from rayzath_tpu_torch.ops import _kernels
from rayzath_tpu_torch.ops import camera as cam_ops
from rayzath_tpu_torch.ops import traverse_cluster as tc
from rayzath_tpu_torch.ops.intersect import BIG

torch.set_num_threads(2)

WRAPPERS = (tc.cluster_closest_inst, tc.cluster_shadow_inst)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def field(dev, res=8):
    """A 3 x 3 instanced_field compiled two-level on ``dev``: 10 instance
    rows, one cluster per ball (resolution 12) and one for the ground."""
    world = rt.scenes.instanced_field(res, res, n=3, resolution=12)
    return world, tds.compile_world(world, two_level=True, device=dev)


def bounce_rays(world, dev, r):
    """``r`` rays from camera-ray points towards seeded sphere directions;
    every 7th inactive (far and dist 0)."""
    res = int(np.ceil(np.sqrt(r)))
    cam = tds.compile_camera(world.cameras[0], dev)
    o, _ = cam_ops.generate_rays(cam, cam_ops.pixel_grid(res, res, device=dev),
                                 torch.full((res * res, 4), 0.5, device=dev))
    v = np.random.default_rng(r).normal(size=(r, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    reach = torch.full((r,), BIG, device=dev)
    reach[::7] = 0.0
    return (o[:r].contiguous(), torch.as_tensor(v, device=dev),
            torch.zeros(r, device=dev), reach)


def walk(kernel, scene, rays, visits=None):
    """One call of B3 (``closest``) or B4 (``shadow``) on ``rays``."""
    o, d, near, reach = rays
    tabs = (scene.ti_rows, scene.cl_obox, scene.cl_lw)
    if kernel == "closest":
        return tc.cluster_closest_inst(o, d, near, reach, *tabs, visits=visits)
    return tc.cluster_shadow_inst(o, d, reach, *tabs, scene.cl_slot,
                                  scene.inst_slot_map, scene.mat_color,
                                  visits=visits)


def wrapper(kernel):
    return tc.cluster_closest_inst if kernel == "closest" else tc.cluster_shadow_inst


def held():
    """Every counter of B3 and B4: (launches, rays, visits, tests) each,
    and B4's live rays last."""
    return [(f.launches, f.rays, *f.work.read().values()) for f in WRAPPERS]


@pytest.mark.parametrize("kernel", ["closest", "shadow"])
def test_plain_counts_equal_the_visits_sums(kernel):
    world, scene = field("cpu")
    r = 300
    rays = bounce_rays(world, "cpu", r)
    f = wrapper(kernel)
    before = (f.launches, f.rays, f.work.read())
    visits = torch.full((r + 3,), -1, dtype=torch.int32)
    walk(kernel, scene, rays, visits)
    got = f.work.read()
    walked = int((rays[3] > 0).sum())
    n_inst = int((scene.ti_rows[:, tc.TI_NCL] > 0).sum())
    assert (f.launches, f.rays) == (before[0], before[1] + r)   # no kernel
    assert got["cluster_tests"] - before[2]["cluster_tests"] == int(visits[:r].sum())
    assert got["instance_visits"] - before[2]["instance_visits"] == walked * n_inst
    assert int((visits[:r] == 0).sum()) == r - walked
    assert visits[r:].tolist() == [int(scene.ti_rows[:, tc.TI_NCL].sum())] * 3
    if kernel == "shadow":
        assert got["live"] - before[2]["live"] == walked < r
    else:
        assert "live" not in got


def test_a_render_counts_every_pass():
    world = rt.scenes.instanced_field(12, 8, n=3, resolution=12)
    r = rt.Renderer(world, rt.RenderConfig(two_level=True), seed=3, device="cpu")
    before = held()
    r.render(rpp=3)
    assert r.scene.two_level
    for (_, rays0, v0, t0, *l0), (_, rays1, v1, t1, *l1) in zip(before,
                                                                 held()):
        assert rays1 - rays0 == 3 * 12 * 8
        # one cluster per instance row here: a visit is one test
        assert 0 < t1 - t0 == v1 - v0 <= 3 * 12 * 8 * 10
        if l0:
            assert 0 < l1[0] - l0[0] <= rays1 - rays0


def test_a_soup_render_counts_nothing():
    world = rt.scenes.cornell_box_nee(8, 8)
    r = rt.Renderer(world, rt.RenderConfig(), seed=3, device="cpu")
    before = held()
    r.render(rpp=2)
    assert not r.scene.two_level and held() == before


@pytest.fixture
def fake_graphs(monkeypatch):
    """``torch.cuda``'s streams and graphs replaced by recorders, so that
    :func:`cycle.capture` runs on the CPU (a "capture" runs its body)."""
    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: types.SimpleNamespace())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, stream, capture_error_mode:
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())


def test_replays_advance_the_ray_counters(fake_graphs):
    world, scene = field("cpu")
    rays = bounce_rays(world, "cpu", 200)

    def body():
        walk("closest", scene, rays)
        walk("shadow", scene, rays)
        walk("shadow", scene, rays)

    body()                                  # counted as it ran
    before = [(f.launches, f.rays) for f in WRAPPERS]
    _, per_replay = cycle.capture(lambda: None, body, "test")
    assert [(f.launches, f.rays) for f in WRAPPERS] == before
    assert sorted((f.__name__, c, k) for f, c, k in per_replay) == [
        ("cluster_closest_inst", "rays", 200),
        ("cluster_shadow_inst", "rays", 400)]
    cycle.advance(per_replay, 5)
    assert [(f.launches, f.rays) for f in WRAPPERS] == [
        (before[0][0], before[0][1] + 1000), (before[1][0], before[1][1] + 2000)]


#: the library's entries that launch nothing: sizes, resources and the
#: error text
QUERIES = {"rz_ranked_smem", "rz_grouped_smem", "rz_closest_resources",
           "rz_shadow_resources", "rz_closest_inst_resources",
           "rz_shadow_inst_resources", "rz_gather_grad_partials",
           "rz_ray_sort_partials", "rz_error_string"}


def launch_sites():
    """(wrappers named by the ``_kernels.launch`` calls of ``ops/``, the
    library entries they launch, every ``rz_*`` entry ``ops/`` names)."""
    wrappers, launched, named = set(), set(), set()
    for path in sorted(Path(_kernels.__file__).parent.glob("*.py")):
        module = importlib.import_module(f"rayzath_tpu_torch.ops.{path.stem}")
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and node.attr.startswith("rz_"):
                named.add(node.attr)
            fn = getattr(node, "func", None)
            if isinstance(fn, ast.Name):
                target = getattr(module, fn.id, None)
            elif isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
                target = getattr(getattr(module, fn.value.id, None), fn.attr,
                                 None)
            else:
                continue
            if target is _kernels.launch:
                wrappers.add(getattr(module, node.args[0].id))
                launched.add(node.args[1].attr)
    return wrappers, launched, named


def test_capture_advances_every_registered_counter(fake_graphs, monkeypatch):
    """Every wrapper that launches through ``_kernels.launch`` is in
    ``_kernels.COUNTED`` (all 14, and no other but the dense cutout pass,
    which launches no kernel and counts its calls), every kernel entry of
    the library is launched through it, and a capture leaves each
    registered counter as it was while ``advance`` gives it n times its
    per-replay gain."""
    wrappers, launched, named = launch_sites()
    assert wrappers == set(_kernels.COUNTED) - {
        integrator.texture_shadow_factor} and len(wrappers) == 14
    assert launched == named - QUERIES == set(_kernels._SIGNATURES) - QUERIES
    assert len(launched) == 14
    assert {c for names in _kernels.COUNTED.values() for c in names} == {
        "launches", "rays", "grouped"}

    class Stream:
        cuda_stream = 0

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    gains = {(f, c): k for k, (f, c) in enumerate(
        ((f, c) for f, names in _kernels.COUNTED.items() for c in names), 1)}
    for f, c in gains:
        monkeypatch.setattr(f, c, getattr(f, c))    # restored afterwards

    def body():
        for (f, c), k in gains.items():
            for _ in range(k):
                if c == "launches":
                    _kernels.launch(f, lambda stream: 0, torch.device("cpu"))
                else:
                    setattr(f, c, getattr(f, c) + 1)

    before = {fc: getattr(*fc) for fc in gains}
    _, per_replay = cycle.capture(lambda: None, body, "test")
    assert {fc: getattr(*fc) for fc in gains} == before
    assert {(f, c): k for f, c, k in per_replay} == gains
    cycle.advance(per_replay, 3)
    assert {fc: getattr(*fc) - before[fc] for fc in gains} == {
        fc: 3 * k for fc, k in gains.items()}


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["closest", "shadow"])
def test_graph_counters_equal_the_visits_sums(cuda, kernel):
    """A graph of one B3 or B4 call with a visits buffer, replayed 3 times
    after its warm-up: the device counters gained 4 times the buffer's
    per-ray sum, ``rays`` and ``launches`` 4 calls' worth."""
    world, scene = field(cuda)
    r = 128 * 128 + 5
    rays = bounce_rays(world, cuda, r)
    f = wrapper(kernel)
    start = f.work.read()
    visits = torch.zeros(r + -(-r // 128), dtype=torch.int32, device=cuda)
    launches, count = f.launches, f.rays
    graph, per_replay = cycle.capture(lambda: walk(kernel, scene, rays, visits),
                                      lambda: walk(kernel, scene, rays, visits),
                                      "test")
    for _ in range(3):
        graph.replay()
    cycle.advance(per_replay, 3)
    torch.cuda.synchronize()
    got = {k: v - start[k] for k, v in f.work.read().items()}
    tests = int(visits[:r].sum())
    walked = int((rays[3] > 0).sum())
    assert tests > 0 and got["cluster_tests"] == 4 * tests
    assert 0 < got["instance_visits"] <= 4 * walked * 10
    assert got["instance_visits"] % 4 == 0
    assert (f.launches - launches, f.rays - count) == (4, 4 * r)
    assert got.get("live", 4 * walked) == 4 * walked


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["closest", "shadow"])
def test_counting_leaves_the_outputs_bit_equal(cuda, kernel, monkeypatch):
    """B3's t, ids and instance ids, B4's rgba: the same bits with the
    counters and with none (a null pointer, which the kernels skip)."""
    world, scene = field(cuda)
    rays = bounce_rays(world, cuda, 64 * 64)
    counted = walk(kernel, scene, rays)
    off = types.SimpleNamespace(pair=lambda dev: types.SimpleNamespace(
        data_ptr=lambda: 0))
    monkeypatch.setattr(wrapper(kernel), "work", off)
    uncounted = walk(kernel, scene, rays)
    for a, b in zip(counted, uncounted):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_only_a_two_level_render_counts(cuda):
    """A soup render (cornell_box_nee) launches no B3/B4 and leaves their
    counters as they were; a two-level render counts every pass's rays in
    both, and tests on the device."""
    r = rt.Renderer(rt.scenes.cornell_box_nee(64, 64), rt.RenderConfig(),
                    seed=3, device=cuda)
    before = held()
    r.render(rpp=3)
    torch.cuda.synchronize()
    assert held() == before
    world = rt.scenes.instanced_field(64, 64, n=3, resolution=12)
    r = rt.Renderer(world, rt.RenderConfig(two_level=True), seed=3, device=cuda)
    r.render(rpp=1)                          # capture
    before = held()
    r.render(rpp=4)
    torch.cuda.synchronize()
    for (l0, rays0, v0, t0, *n0), (l1, rays1, v1, t1, *n1) in zip(before,
                                                                   held()):
        assert (l1 - l0, rays1 - rays0) == (4, 4 * 64 * 64)
        assert t1 > t0 and v1 > v0
        if n0:
            assert 0 < n1[0] - n0[0] < rays1 - rays0
