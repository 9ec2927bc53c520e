"""The work counters of the flat cluster walk, B1 ``cluster_closest`` and B2
``cluster_shadow`` (``rayzath_tpu_torch/ops/traverse_cluster.py``
``WorkCounter``): ``rays`` on the host, and per device the cluster tests,
triangle tests and slab tests that the kernels add to, one atomicAdd per
counter per block, on the flat and the grouped walk alike, and B2's live
rays (dist > 0).

On the CPU: the plain versions' counts equal the sums of their per-ray
``visits`` (each cluster test its cluster's real triangles, and no slab
test), a render counts every pass's rays, and
a captured graph's replays advance ``rays`` as they advance ``launches``
(``torch.cuda``'s graph API replaced by recorders). On a card (skipped
without one; the file imports no jax, so run it there with ``python -m
pytest --noconftest tests/test_torch_soup_counters.py``): the counters of
a replayed graph equal its ``visits`` buffers' sums on both walks, each
cluster test counting its cluster's real triangles, B1's
outputs are the same bits with and without counting and B2's within the
forward gate, and a render of ``cornell_box_nee`` at 1280x720 through
``Renderer.render`` is finite, takes no ray sort and counts at most one
cluster test a ray.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

import rayzath_tpu_torch as rt
from rayzath_tpu_torch.engine import cycle, integrator
from rayzath_tpu_torch.models import device_scene as tds
from rayzath_tpu_torch.ops import camera as cam_ops
from rayzath_tpu_torch.ops import sort_rays
from rayzath_tpu_torch.ops import traverse_cluster as tc
from rayzath_tpu_torch.ops.gather import gather_rows
from rayzath_tpu_torch.ops.intersect import BIG

torch.set_num_threads(2)

WRAPPERS = (tc.cluster_closest, tc.cluster_shadow)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def soup(dev, big=False):
    """(world, scene) of a soup compiled on ``dev``: textured_room (21
    clusters, the flat walk), or with ``big`` mesh_heavy at resolution 400
    (above the grouped line)."""
    world = (rt.scenes.mesh_heavy(16, 16, resolution=400) if big
             else rt.scenes.textured_room(16, 16))
    return world, tds.compile_world(world, device=dev)


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
    """One call of B1 (``closest``) or B2 (``shadow``) on ``rays``, through
    the group table where the scene has one."""
    o, d, near, reach = rays
    if kernel == "closest":
        return tc.cluster_closest(o, d, near, reach, scene.cl_box, scene.cl_lw,
                                  scene.cl_order, groups=scene.cl_group,
                                  visits=visits)
    mat = gather_rows(scene.mat_color, scene.tri_mat)
    return tc.cluster_shadow(o, d, reach, scene.cl_box, scene.cl_lw,
                             scene.cl_order, scene.cl_base, scene.cl_count,
                             mat[:, :3].contiguous(),
                             (1.0 - mat[:, 3]).contiguous(),
                             groups=scene.cl_group, visits=visits)


def wrapper(kernel):
    return tc.cluster_closest if kernel == "closest" else tc.cluster_shadow


def held():
    """Every counter of B1 and B2: (launches, rays, cluster tests, triangle
    tests, slab tests) each, and B2's live rays last."""
    return [(f.launches, f.rays, *f.work.read().values()) for f in WRAPPERS]


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["closest", "shadow"])
def test_plain_counts_equal_the_visits_sums(kernel):
    """A plain B1 or B2 call counts every real cluster and its real
    triangles for each ray that walks, as its ``visits`` say ray by ray,
    and no slab test; B2 the rays that walk as live."""
    world, scene = soup("cpu")
    r = 300
    blocks = -(-r // 128)
    rays = bounce_rays(world, "cpu", r)
    f = wrapper(kernel)
    before = (f.launches, f.rays, f.work.read())
    visits = torch.full((r + blocks,), -1, dtype=torch.int32)
    walk(kernel, scene, rays, visits)
    got = f.work.read()
    walked = int((rays[3] > 0).sum())
    n_real = int((scene.cl_box[tc.B_CNT] > 0).sum())
    assert n_real == scene.n_clusters > 1
    assert (f.launches, f.rays) == (before[0], before[1] + r)   # no kernel
    tests = got["cluster_tests"] - before[2]["cluster_tests"]
    assert tests == int(visits[:r].sum()) == walked * n_real
    tris = got["triangle_tests"] - before[2]["triangle_tests"]
    assert tris == walked * scene.n_triangles
    assert 0 < tris < walked * n_real * tc.CLUSTER_T    # no padding slot
    assert got["slab_tests"] == before[2]["slab_tests"]
    assert int((visits[:r] == 0).sum()) == r - walked
    assert visits[r:].tolist() == [n_real] * blocks
    if kernel == "shadow":
        assert got["live"] - before[2]["live"] == walked < r
    else:
        assert "live" not in got


@pytest.mark.parametrize("kernel", ["closest", "shadow"])
def test_plain_walk_refuses_a_grouped_visit_buffer(kernel):
    """The plain version enters no group, so a visits buffer with the
    kernels' per-block groups part (R + 2 B entries) is refused on the CPU,
    and nothing is counted."""
    world, scene = soup("cpu")
    r = 300
    rays = bounce_rays(world, "cpu", r)
    f = wrapper(kernel)
    visits = torch.zeros(r + 2 * (-(-r // 128)), dtype=torch.int32)
    before = held()
    with pytest.raises(ValueError, match="visits"):
        walk(kernel, scene, rays, visits)
    assert held() == before


def test_a_render_counts_every_pass():
    """A CPU render of cornell_box_nee: B1 and B2 each take every pass's
    rays once, and test the one real cluster at most once a ray; B2 walks
    only its live rays, each of which tests the cluster."""
    w, h = 12, 8
    r = rt.Renderer(rt.scenes.cornell_box_nee(w, h), rt.RenderConfig(), seed=3,
                    device="cpu")
    before = held()
    r.render(rpp=3)
    assert r.scene.n_clusters == 1 and not r.scene.two_level
    for (_, rays0, t0, n0, s0, *l0), (_, rays1, t1, n1, s1, *l1) in zip(
            before, held()):
        assert rays1 - rays0 == 3 * w * h
        assert 0 < t1 - t0 <= rays1 - rays0
        assert n1 - n0 == 36 * (t1 - t0)        # 36 triangles, one cluster
        assert s1 == s0
        if l0:
            assert l1[0] - l0[0] == t1 - t0


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
    world, scene = soup("cpu")
    rays = bounce_rays(world, "cpu", 200)

    def body():
        walk("closest", scene, rays)
        walk("shadow", scene, rays)
        walk("shadow", scene, rays)

    body()                                  # counted as it ran
    before = [(f.launches, f.rays, f.grouped) for f in WRAPPERS]
    _, per_replay = cycle.capture(lambda: None, body, "test")
    assert [(f.launches, f.rays, f.grouped) for f in WRAPPERS] == before
    assert sorted((f.__name__, c, k) for f, c, k in per_replay) == [
        ("cluster_closest", "rays", 200), ("cluster_shadow", "rays", 400)]
    cycle.advance(per_replay, 5)
    assert [(f.launches, f.rays) for f in WRAPPERS] == [
        (before[0][0], before[0][1] + 1000), (before[1][0], before[1][1] + 2000)]


def test_the_work_counter_keeps_its_keys():
    """B1's and B2's counts read as cluster, triangle and slab tests, B3's
    and B4's as instance visits and (instance, cluster) tests, B2's and
    B4's then as live rays; a device's counts are made on its first use,
    one for each key, and summed over devices."""
    soup_keys = ("cluster_tests", "triangle_tests", "slab_tests")
    assert [f.work.keys for f in WRAPPERS] == [soup_keys,
                                               soup_keys + ("live",)]
    inst_keys = ("instance_visits", "cluster_tests")
    assert [f.work.keys for f in (tc.cluster_closest_inst,
                                  tc.cluster_shadow_inst)] == [
        inst_keys, inst_keys + ("live",)]
    w = tc.WorkCounter(("a", "b", "c"))
    assert w.read() == {"a": 0, "b": 0, "c": 0}
    w.pair(torch.device("cpu")).add_(torch.tensor([2, 5, 7]))
    assert w.pair(torch.device("cpu")).tolist() == [2, 5, 7]
    assert w.read() == {"a": 2, "b": 5, "c": 7}
    assert tc.WorkCounter().pair(torch.device("cpu")).tolist() == [0, 0]


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("big", [False, True], ids=["flat", "grouped"])
@pytest.mark.parametrize("kernel", ["closest", "shadow"])
def test_graph_counters_equal_the_visits_sums(cuda, kernel, big):
    """A graph of one B1 or B2 call with a visits buffer of R + 2 B
    entries, replayed 3 times after its warm-up: the device counters gained
    4 times the buffer's per-ray cluster tests, between the fewest and the
    most real triangles of a cluster for each, and slab tests at most two
    a walking ray for each real row and group row it could gate (the vote
    and the visit); ``rays`` and ``launches`` 4 calls' worth."""
    world, scene = soup(cuda, big)
    assert (scene.cl_box.shape[1] > tc.GROUPED_ROWS) == big
    r = 128 * 128 + 5
    blocks = -(-r // 128)
    rays = bounce_rays(world, cuda, r)
    f = wrapper(kernel)
    start = f.work.read()
    visits = torch.zeros(r + 2 * blocks, dtype=torch.int32, device=cuda)
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
    assert tests > 0 and got["cluster_tests"] == 4 * tests
    cnt = scene.cl_box[tc.B_CNT]
    real = cnt[cnt > 0]
    assert (int(real.min()) * got["cluster_tests"] <= got["triangle_tests"]
            <= int(real.max()) * got["cluster_tests"])
    assert got["triangle_tests"] % 4 == 0
    walked = int((rays[3] > 0).sum())
    rows = len(real) + (int((scene.cl_group[tc.B_CNT] > 0).sum()) if big else 0)
    assert 0 < got["slab_tests"] <= 4 * 2 * walked * rows
    assert got["slab_tests"] % 4 == 0
    entered = visits[r + blocks:]
    assert (int(entered.max()) > 0) == big    # the flat walk leaves it 0
    assert (f.launches - launches, f.rays - count) == (4, 4 * r)
    assert got.get("live", 4 * walked) == 4 * walked


@pytest.mark.gpu
@pytest.mark.parametrize("big", [False, True], ids=["flat", "grouped"])
@pytest.mark.parametrize("kernel", ["closest", "shadow"])
def test_counting_leaves_the_outputs_equal(cuda, kernel, big, monkeypatch):
    """B1's t and ids the same bits with the counters and with none (a
    null pointer, which the kernels skip); B2's rgba within the forward
    gate of each other and of the plain version."""
    world, scene = soup(cuda, big)
    rays = bounce_rays(world, cuda, 64 * 64)
    counted = walk(kernel, scene, rays)
    off = types.SimpleNamespace(pair=lambda dev: types.SimpleNamespace(
        data_ptr=lambda: 0))
    monkeypatch.setattr(wrapper(kernel), "work", off)
    uncounted = walk(kernel, scene, rays)
    if kernel == "closest":
        for a, b in zip(counted, uncounted):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        return
    o, d, _, dist = rays
    mat = gather_rows(scene.mat_color, scene.tri_mat)
    ref = tc.cluster_shadow_plain(o, d, dist, scene.cl_box, scene.cl_lw,
                                  tc.cluster_opacity(mat[:, :3],
                                                     1.0 - mat[:, 3],
                                                     scene.cl_order,
                                                     scene.cl_base,
                                                     scene.cl_count))
    for got, want in ((counted, uncounted), (counted, ref)):
        (rgb_k, a_k), (rgb_p, a_p) = got, want
        live = a_p >= 1e-4
        torch.testing.assert_close(a_k[live], a_p[live], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(rgb_k[live], rgb_p[live], rtol=1e-5,
                                   atol=1e-6)
        assert bool((a_k[~live] < 1e-4).all())


@pytest.mark.gpu
def test_cornell_box_nee_renders_at_720p(cuda):
    """The benchmark's cornell_box_nee configuration through
    ``Renderer.render`` at 1280x720, depth 16: every sample finite, no ray
    sort (``coherence_keys`` never launched), B1 and B2 once each a pass on
    every ray, and at most one cluster test a ray (one real cluster)."""
    from benchmark.lib import cells, mixes
    cfg = cells.load("cornell_box_nee.progressive").config
    world = rt.scenes.cornell_box_nee(cfg["width"], cfg["height"])
    r = rt.Renderer(world, mixes._render_config(rt, mixes._settings(cfg)),
                    seed=2 ** 31 + 7, device=cuda)
    r.render(rpp=1)                                  # capture
    assert not integrator._sort_traversal(r.config, r.scene)
    keys, before = sort_rays.coherence_keys.launches, held()
    r.render(rpp=8)
    torch.cuda.synchronize()
    pixels = cfg["width"] * cfg["height"]
    assert sort_rays.coherence_keys.launches == keys
    for (l0, rays0, t0, n0, s0, *v0), (l1, rays1, t1, n1, s1, *v1) in zip(
            before, held()):
        assert (l1 - l0, rays1 - rays0) == (8, 8 * pixels)
        assert 0 < t1 - t0 <= rays1 - rays0
        assert n1 - n0 == 36 * (t1 - t0)        # 36 triangles, one cluster
        assert s1 > s0
        if v0:
            assert 0 < v1[0] - v0[0] < rays1 - rays0
    st = r.view(world.cameras[0]).state
    assert bool(torch.isfinite(st.accum).all())
    assert float(st.accum[..., :3].mean()) > 0.0
