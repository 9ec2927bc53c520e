"""The benchmark's cornell_box_nee configuration on the CPU: the renderer's
plain path against the plain reference of ``benchmark/reference/``, the
route its 1280x720 frame takes (no ray sort, no tiles: B1 and B2 walk the
rays in raster order), and the arithmetic of the flat walk's two readers
(``benchmark/lib/soup_work.py``: ``cluster_tests_per_ray``,
``traversal_bound_share``) on synthetic traces."""
import pytest
import torch

import rayzath_tpu_torch as rt
from benchmark.lib import cells, mixes, soup_work
from benchmark.lib.trace import Trace
from benchmark.reference import tracer, world as ref_world
from rayzath_tpu_torch.engine import integrator
from rayzath_tpu_torch.models.device_scene import compile_world
from rayzath_tpu_torch.ops import traverse_cluster as tc

torch.set_num_threads(2)

CELL = "cornell_box_nee.progressive"
SEED = 2 ** 31 + 99


def config() -> dict:
    return cells.load(CELL).config


def renderer(w: int, h: int):
    cfg = config()
    return rt.Renderer(rt.scenes.cornell_box_nee(w, h),
                       mixes._render_config(rt, mixes._settings(cfg)),
                       seed=SEED, device="cpu")


@pytest.mark.parametrize("w,h", [(40, 24), (64, 32)], ids=["raster", "tiles"])
def test_whole_image_matches_the_reference(w, h):
    """Every pixel of an 8-pass render from fresh paths at depth 16, the
    renderer's plain CPU path against the reference, within 1e-4 of the
    larger of the pixel and a hundredth of the mean; all path depths and
    directions equal. 40x24 walks in raster order as 1280x720 does, 64x32
    in 32x32 tiles."""
    r = renderer(w, h)
    r.render(rpp=8)
    wld = r.world
    st = r.view(wld.cameras[0]).state
    sc = tracer.Scene(ref_world.flatten(wld), "cpu")
    idx = torch.arange(w * h)
    paths, rad, cnt = tracer.trace(sc, mixes._settings(config()), SEED, 0, 8,
                                   idx % w, idx // w)
    want = torch.cat([rad, cnt[:, None]], 1)
    bad = mixes.share_mismatched(st.accum.reshape(-1, 4), want,
                                 {"depth": st.path_depth, "d": st.direction},
                                 paths, tol=1e-4)
    assert int(bad.sum()) == 0


def test_the_configuration_takes_neither_sort_nor_tiles():
    """The configuration file loads through ``lib/cells.py`` as one card's
    cell of 64 passes a cycle at 1280x720, depth 16, and its frame takes
    neither the ray sort (one real cluster, under 16) nor tiles (720 is no
    multiple of 32)."""
    cell = cells.load(CELL)
    cfg = cell.config
    assert (cell.chips, cell.traffic["kind"]) == (1, "progressive")
    assert (cfg["scene"], cfg["width"], cfg["height"]) == ("cornell_box_nee",
                                                           1280, 720)
    assert mixes._settings(cfg) == {"max_depth": 16, "rpp": 64,
                                    "spot_light": 1, "direct_light": 1}
    scene = compile_world(rt.scenes.cornell_box_nee(1280, 720), device="cpu")
    assert scene.n_clusters == 1 and scene.cl_box.shape == (8, 128)
    assert not integrator._sort_traversal(
        mixes._render_config(rt, mixes._settings(cfg)), scene)
    hw = (cfg["height"], cfg["width"])
    assert not integrator._tileable(hw, cfg["width"] * cfg["height"])
    per_layer = {m["name"] for m in cell.per_layer}
    assert {"cluster_tests_per_ray", "traversal_bound_share",
            "traversal_ms_per_pass", "busy_ms_per_pass",
            "elementwise_ms_per_pass"} <= per_layer
    assert not per_layer & {"sort_ms_per_pass", "inst_cluster_tests_per_ray",
                            "traversal_inst_bound_share"}
    assert [m["name"] for m in cell.end_to_end] == ["rays_per_s", "setup_s"]


@pytest.mark.parametrize("w,h,tiled", [(40, 24, False), (64, 32, True)],
                         ids=["raster", "tiles"])
def test_a_render_sorts_nothing(monkeypatch, w, h, tiled):
    """A render of the scene calls the coherence sort (``coherence_keys``
    through ``sort_payload``) no time, B1 and B2 once each a pass on every
    ray, and tiles the rays only where the image is a multiple of 32."""
    calls = {"sort": 0, "tile": 0}

    def spy(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(integrator, "sort_payload",
                        spy("sort", integrator.sort_payload))
    monkeypatch.setattr(integrator, "_tile", spy("tile", integrator._tile))
    r = renderer(w, h)
    rays = [f.rays for f in (tc.cluster_closest, tc.cluster_shadow)]
    r.render(rpp=3)
    assert calls["sort"] == 0
    assert (calls["tile"] > 0) == tiled
    assert [f.rays - n for f, n in zip((tc.cluster_closest, tc.cluster_shadow),
                                       rays)] == [3 * w * h] * 2


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

B1 = "void (anonymous namespace)::closest_kernel<false, 6>(float const*)"
B2 = "void (anonymous namespace)::shadow_kernel<false, 8>(float const*)"


def synthetic(kind="progressive", names=(B1, B2)):
    """Two passes: B1 0.1 ms and B2 0.3 ms each, beside an elementwise
    kernel and a B3 launch the readers leave out."""
    dev = []
    for p in range(2):
        t = 1000.0 * p
        for name, us in zip(names, (100.0, 300.0)):
            dev.append((name, t, t + us))
            t += us
        dev.append(("bounce_tail_kernel", t, t + 50.0))
        dev.append(("void closest_inst_kernel(float const*)", t + 50, t + 80))
    return Trace(kind, units=2, wall_s=0.002, device=dev)


@pytest.fixture
def counted(monkeypatch):
    """B1 and B2 as after 10 launches each: B1 of 1,000 rays and 900
    cluster, 32,400 triangle and 5,000 slab tests, B2 of 2,000 rays and
    1,500, 54,000 and 7,000, and 1,600 live rays."""
    for f, (rays, *work_done) in (
            (tc.cluster_closest, (1000, 900, 32400, 5000)),
            (tc.cluster_shadow, (2000, 1500, 54000, 7000, 1600))):
        work = tc.WorkCounter(f.work.keys)
        assert work.keys[:3] == soup_work.WORK
        work.pair(torch.device("cpu")).add_(torch.tensor(work_done))
        monkeypatch.setattr(f, "work", work)
        monkeypatch.setattr(f, "launches", 10)
        monkeypatch.setattr(f, "rays", rays)


def read(name, trace):
    return cells.reader(name)(trace)


def test_tests_per_ray_reads_the_counters(counted):
    assert read("cluster_tests_per_ray", synthetic()) == pytest.approx(
        (900 + 1500) / (1000 + 2000))


def test_bound_share_reads_the_counters_and_the_trace(counted):
    ops = {"closest": (49 * 32400 + 25 * 5000) / 10,
           "shadow": (49 * 54000 + 25 * 7000) / 10}
    bound_ms = 2 * (ops["closest"] + ops["shadow"]) / 67e12 * 1e3
    busy_ms = 2 * (0.1 + 0.3)
    assert soup_work.SLAB_OPS == 25
    assert read("traversal_bound_share", synthetic()) == pytest.approx(
        100.0 * bound_ms / busy_ms)
    got = cells.read_metrics(cells.load(CELL).per_layer, synthetic())
    assert set(got) >= {"cluster_tests_per_ray", "traversal_bound_share"}
    assert got["traversal_bound_share"]["unit"] == "%"


@pytest.mark.parametrize("case", ["no_counter", "no_triangle_count",
                                  "no_launch", "not_traced", "interactive"])
def test_the_readers_read_nothing_without_counts(counted, monkeypatch, case):
    """None where the program keeps no work counter (an older program) or
    one without the triangle tests, counted no launch, the trace holds no
    B1/B2 launch, or the trace is not of progressive cycles."""
    trace = synthetic()
    if case == "no_counter":
        monkeypatch.delattr(tc.cluster_shadow, "work")
    elif case == "no_triangle_count":
        monkeypatch.setattr(tc.cluster_shadow, "work", tc.WorkCounter(
            ("cluster_tests", "slab_tests")))
    elif case == "no_launch":
        monkeypatch.setattr(tc.cluster_closest, "launches", 0)
    elif case == "not_traced":
        trace = synthetic(names=("some_kernel", "other_kernel"))
    else:
        trace = synthetic(kind="interactive")
    for name in ("cluster_tests_per_ray", "traversal_bound_share"):
        assert read(name, trace) is None
