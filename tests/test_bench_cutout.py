"""The benchmark's cutout_world configuration on the CPU: its manifest
entries and configuration file, the leaf canopy's cutout set and the soup's
per-slot cutout tables (``models/device_scene.py`` ``cutout_slots``), the
renderer's plain path on a small crown against the plain reference of
``benchmark/reference/`` through the progressive mix's own check, and the
arithmetic of the three readers of B2's cutout variant
(``benchmark/lib/cutout_work.py``: ``cutout_fetches_per_ray``,
``cutout_shadow_ms_per_pass``, ``cutout_shadow_bound_share``) on synthetic
traces."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import rayzath_tpu_torch as rt
from benchmark.lib import cells, cutout_work, mixes, soup_work
from benchmark.lib.trace import Trace
from rayzath_tpu_torch.models.device_scene import compile_world
from rayzath_tpu_torch.ops import traverse_cluster as tc

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CELL = "cutout_world.progressive"
SEED = 2 ** 31 + 123
NEW = ("cutout_fetches_per_ray", "cutout_shadow_ms_per_pass",
       "cutout_shadow_bound_share")


def test_the_configuration_and_its_cell():
    """One configuration, ``cutout_world`` (the leaf canopy at 1280x720,
    depth 16, 8 passes, a spot and a direct sample, nothing reduced, every
    figure of the scene assumed with its reason), and one cell on one card
    with the progressive traffic, which reports rays_per_s and setup_s, the
    per-pass metrics of the soup cells, the three readers of the cutout
    variant and not traversal_bound_share, which prices no fetch."""
    man = cells.manifest()
    conf, = [c for c in man["configs"] if c["name"] == "cutout_world"]
    assert conf["reduced"] == [] and conf["file"] == \
        "benchmark/configs/cutout_world.json"
    assert "cuda_instance.cuh:92-164" in conf["source"]
    assert len(conf["source"]) <= 200 and len(conf["why"]) <= 200
    work, = [w for w in man["workloads"] if w["name"] == CELL]
    assert (work["config"], work["traffic"], work["chips"]) == (
        "cutout_world", "progressive", 1)
    cell = cells.load(CELL)
    cfg = cell.config
    assert (cfg["scene"], cfg["width"], cfg["height"]) == ("leaf_canopy",
                                                           1280, 720)
    assert mixes._settings(cfg) == {"max_depth": 16, "rpp": 8,
                                    "spot_light": 1, "direct_light": 1}
    assert cfg["source"] == conf["source"] and cfg["reduced"] == []
    assert {"cards", "crown", "card side", "leaf maps", "lights", "camera",
            "sky"} <= set(cfg["assumed"])
    assert [m["name"] for m in cell.end_to_end] == ["rays_per_s", "setup_s"]
    per_layer = {m["name"] for m in cell.per_layer}
    assert set(NEW) | {"device_idle_share.render", "busy_ms_per_pass",
                       "traversal_ms_per_pass", "sort_ms_per_pass",
                       "gather_ms_per_pass", "elementwise_ms_per_pass",
                       "compile_s.setup", "capture_s.setup",
                       "launch_gap_ms.render",
                       "cluster_tests_per_ray", "shadow_live_share"} == per_layer
    for m in man["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and m["moves"] == "rays_per_s"
            assert m["layer"] == "traversal kernels"
    with open(ROOT / "benchmark" / "limits" / f"{CELL}.json") as f:
        assert set(json.load(f)) == {"mismatch_share"}


def test_the_full_canopy():
    """``leaf_canopy`` at the cell's size: one crown mesh of 65,536 cards
    (131,072 triangles) in one instance over the ground, 4 leaf maps of
    256x256 whose alpha covers 55% of a card, one spot and one direct
    light, a 1280x720 camera."""
    w = rt.scenes.leaf_canopy(1280, 720)
    crown, = [i.mesh for i in w.instances if i.name == "crown"]
    assert crown.triangle_count == 131072 and len(w.instances) == 2
    assert len(w.textures) == 4
    for tex in w.textures:
        assert tex.data.shape == (256, 256, 4)
        assert abs(float(tex.data[..., 3].mean()) - 0.55) < 0.005
    assert (len(w.spot_lights), len(w.direct_lights)) == (1, 1)
    cam = w.cameras[0]
    assert (cam.width, cam.height) == (1280, 720)
    side = np.linalg.norm(crown.vertices[1] - crown.vertices[0])
    assert side == pytest.approx(0.093, rel=1e-5)


@pytest.fixture(scope="module")
def small():
    world = rt.scenes.leaf_canopy(24, 16, cards=300)
    return world, compile_world(world, device="cpu")


def test_the_cutout_set(small):
    """Every leaf triangle is in the cutout set and the ground's two are
    not: 600 cutouts of a 602-triangle soup, each with its leaf map."""
    world, scene = small
    assert not scene.two_level and scene.n_triangles == 602
    assert scene.n_cutout == 600 == scene.cut_map.shape[0]
    leaf_maps = set(range(4))                 # the four textures, in order
    assert set(scene.cut_map.tolist()) == leaf_maps
    n = scene.n_triangles
    leaf = scene.mat_maps[scene.tri_mat[:n].long(), 0] >= 0
    assert int(leaf.sum()) == 600 and int((~leaf).sum()) == 2


def test_the_slot_tables_follow_the_cluster_order(small):
    """``cl_cut_map`` / ``cl_cut_uv`` [Cp, 128]: slot j of row c holds the
    soup triangle ``cl_order[cl_base[c] + j]``, its colour map id where it
    is a cutout (-1 on the ground, on padding slots and rows) and its
    texture coordinates t0, t1 - t0, t2 - t0 (``tri_pack`` columns
    18:24)."""
    _, scene = small
    cp = scene.cl_box.shape[1]
    assert scene.cl_cut_map.shape == (cp, 128)
    assert scene.cl_cut_uv.shape == (cp, 128, 6)
    seen = 0
    for c in range(cp):
        base, cnt = int(scene.cl_base[c]), int(scene.cl_count[c])
        assert bool((scene.cl_cut_map[c, cnt:] == -1).all())
        assert bool((scene.cl_cut_uv[c, cnt:] == 0).all())
        for j in range(cnt):
            tri = int(scene.cl_order[base + j])
            mid = int(scene.mat_maps[int(scene.tri_mat[tri]), 0])
            cut = mid >= 0
            assert int(scene.cl_cut_map[c, j]) == (mid if cut else -1)
            tp = scene.tri_pack[tri]
            t0, t1, t2 = tp[18:20], tp[20:22], tp[22:24]
            want = (torch.cat([t0, t1 - t0, t2 - t0]) if cut
                    else torch.zeros(6))
            assert torch.equal(scene.cl_cut_uv[c, j], want)
            seen += cut
    assert seen == scene.n_cutout


@pytest.fixture
def small_crown(monkeypatch):
    """The cell's scene builder, by its name, gives a crown of 300 cards."""
    full = rt.scenes.leaf_canopy
    monkeypatch.setattr(rt.scenes, "leaf_canopy",
                        lambda width, height: full(width, height, cards=300))


def test_the_cell_matches_the_reference_and_the_control_does_not(small_crown):
    """The progressive mix's own check on a tiny cutout_world cell (a crown
    of 300 cards at 32x24, depth 16, 4 passes a cycle): the renderer's
    plain path (the dense cutout pass) reads within a tenth of the cell's
    limit, and the reference in bfloat16 in the program's place reads over
    it."""
    with open(ROOT / "benchmark" / "limits" / f"{CELL}.json") as f:
        limit = json.load(f)["mismatch_share"]
    with open(ROOT / "benchmark" / "traffic" / "progressive.json") as f:
        traffic = dict(json.load(f), check_pixels=96, check_cycles=2,
                       trace_cycles=1)
    config = {"scene": "leaf_canopy", "width": 32, "height": 24,
              "render": {"max_depth": 16, "rpp": 4, "spot_light": 1,
                         "direct_light": 1}}
    mix = mixes.Progressive(config, traffic, SEED, "cpu")
    mix.setup()
    assert mix.renderer.scene.n_cutout == 600
    mix.window(0.2, False)
    mix.release()
    (_, share, _), = mix.check()
    assert share <= limit / 10, share
    (_, control, _), = mix.check(produce=torch.bfloat16)
    assert control > limit, control


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

CUT = ("void (anonymous namespace)::shadow_kernel<true, 0, true>(float "
       "const*, (anonymous namespace)::Cutouts)")
PLAIN = ("void (anonymous namespace)::shadow_kernel<false, 8, false>(float "
         "const*, (anonymous namespace)::Cutouts)")
OLDER = "void (anonymous namespace)::shadow_kernel<false, 8>(float const*)"


def synthetic(kind="progressive", names=(CUT,)):
    """Two passes: each B2 launch of ``names`` 0.3 ms, beside B1 and an
    elementwise kernel that the readers leave out."""
    dev = []
    for p in range(2):
        t = 1000.0 * p
        dev.append(("void (anonymous namespace)::closest_kernel<true, 0>("
                    "float const*)", t, t + 100.0))
        t += 100.0
        for name in names:
            dev.append((name, t, t + 300.0))
            t += 300.0
        dev.append(("bounce_tail_kernel", t, t + 50.0))
    return Trace(kind, units=2, wall_s=0.002, device=dev)


@pytest.fixture
def counted(monkeypatch):
    """B2 as after 10 launches of 2,000 rays: 1,500 cluster, 54,000
    triangle and 7,000 slab tests, 600 live rays, 3,000 texel fetches."""
    f = tc.cluster_shadow
    work = tc.WorkCounter(f.work.keys)
    work.pair(torch.device("cpu")).add_(torch.tensor([1500, 54000, 7000,
                                                      600]))
    fetches = tc.WorkCounter(f.fetches.keys)
    fetches.pair(torch.device("cpu")).add_(torch.tensor([3000]))
    monkeypatch.setattr(f, "work", work)
    monkeypatch.setattr(f, "fetches", fetches)
    monkeypatch.setattr(f, "launches", 10)
    monkeypatch.setattr(f, "rays", 2000)


def read(name, trace):
    return cells.reader(name)(trace)


def test_fetches_per_ray_reads_the_counters(counted):
    assert read("cutout_fetches_per_ray", synthetic()) == pytest.approx(1.5)


def test_ms_per_pass_reads_the_cutout_variant(counted):
    """Only the variant with the third template argument true counts."""
    assert read("cutout_shadow_ms_per_pass", synthetic()) == pytest.approx(0.3)
    both = synthetic(names=(CUT, PLAIN, OLDER))
    assert read("cutout_shadow_ms_per_pass", both) == pytest.approx(0.3)


def test_bound_share_reads_the_counters_and_the_trace(counted):
    """The larger of 49 a triangle test + 25 a slab test + 76 a fetch over
    67 TFLOP/s and 80 B a fetch over 3.35 TB/s, for each of the two traced
    launches, against their 0.6 ms."""
    ops = (49 * 54000 + 25 * 7000 + 76 * 3000) / 10
    byts = 80 * 3000 / 10
    bound_ms = 2 * max(ops / 67e12, byts / 3.35e12) * 1e3
    assert (soup_work.SLAB_OPS, cutout_work.FETCH_OPS,
            cutout_work.FETCH_BYTES) == (25, 76, 80)
    assert read("cutout_shadow_bound_share", synthetic()) == pytest.approx(
        100.0 * bound_ms / 0.6)
    got = cells.read_metrics(cells.load(CELL).per_layer, synthetic())
    assert set(NEW) <= set(got) and got["cutout_shadow_bound_share"]["unit"] == "%"


@pytest.mark.parametrize("case", ["no_fetch_counter", "no_launch",
                                  "older_names", "plain_variant",
                                  "interactive", "empty"])
def test_the_readers_read_nothing_without_the_variant(counted, monkeypatch,
                                                       case):
    """None where the program keeps no fetch counter (a program older than
    the cutout variant), counted no B2 launch, the trace holds no launch of
    the variant (an older program's names, or B2 without cutouts), or the
    trace is not of progressive cycles."""
    trace = synthetic()
    if case == "no_fetch_counter":
        monkeypatch.delattr(tc.cluster_shadow, "fetches")
    elif case == "no_launch":
        monkeypatch.setattr(tc.cluster_shadow, "launches", 0)
    elif case == "older_names":
        trace = synthetic(names=(OLDER,))
    elif case == "plain_variant":
        trace = synthetic(names=(PLAIN,))
    elif case == "interactive":
        trace = synthetic(kind="interactive")
    else:
        trace = Trace("none")
    for name in NEW:
        assert read(name, trace) is None
