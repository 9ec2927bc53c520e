"""The benchmark's reader of the shadow walks' live share
(``benchmark/metrics/shadow_live_share.py``): its manifest entry, its
arithmetic on synthetic traces over B2's and B4's counters, None where the
program keeps no ``live`` count (a program older than it) or the trace
launches neither kernel, and its reading after a render on the CPU."""
import pytest
import torch

import rayzath_tpu_torch as rt
from benchmark.lib import cells
from benchmark.lib.trace import Trace
from rayzath_tpu_torch.ops import traverse_cluster as tc

torch.set_num_threads(2)

NAME = "shadow_live_share"
CELLS = ["mesh_massive.progressive", "textured_room.progressive",
         "instanced_field.progressive", "cornell_box_nee.progressive",
         "cutout_world.progressive"]
B1 = "void (anonymous namespace)::closest_kernel<true, 0>(float const*)"
B2 = "void (anonymous namespace)::shadow_kernel<false, 8, false>(float const*)"
B2_CUT = "void (anonymous namespace)::shadow_kernel<true, 0, true>(float const*)"
B4 = "void (anonymous namespace)::shadow_inst_kernel(float const*)"


def read(trace):
    return cells.reader(NAME)(trace)


def synthetic(kind="progressive", names=(B2, B4)):
    """Two passes: B1, then one launch of each of ``names``, then the
    tail."""
    dev = []
    for p in range(2):
        t = 1000.0 * p
        for name in (B1,) + tuple(names) + ("bounce_tail_kernel",):
            dev.append((name, t, t + 100.0))
            t += 100.0
    return Trace(kind, units=2, wall_s=0.002, device=dev)


def counter(keys, values):
    work = tc.WorkCounter(keys)
    work.pair(torch.device("cpu")).add_(torch.tensor(values))
    return work


@pytest.fixture
def counted(monkeypatch):
    """B2 as after 10 launches of 2,000 rays of which 600 were live, B4 as
    after 5 launches of 1,000 rays of which 900 were live."""
    for f, rays, launches, values in (
            (tc.cluster_shadow, 2000, 10, [1500, 54000, 7000, 600]),
            (tc.cluster_shadow_inst, 1000, 5, [800, 1200, 900])):
        monkeypatch.setattr(f, "work", counter(f.work.keys, values))
        monkeypatch.setattr(f, "launches", launches)
        monkeypatch.setattr(f, "rays", rays)


def test_the_manifest_entry():
    """One per-layer metric of the traversal kernels, a percentage read
    from the program's counters, better lower, moving rays_per_s in the
    five progressive cells, and reported in each of them."""
    entry, = [m for m in cells.manifest()["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "lower",
                     "source": "program_counter",
                     "layer": "traversal kernels", "moves": "rays_per_s",
                     "workloads": CELLS}
    for cell in CELLS:
        assert NAME in {m["name"] for m in cells.load(cell).per_layer}
    assert NAME not in {m["name"] for m in
                        cells.load("mesh_massive.interactive").per_layer}


@pytest.mark.parametrize("names, want", [
    ((B2, B4), 100.0 * (600 + 900) / (2000 + 1000)),
    ((B2,), 100.0 * 600 / 2000),
    ((B2_CUT,), 100.0 * 600 / 2000),
    ((B4,), 100.0 * 900 / 1000)], ids=["both", "b2", "b2_cutouts", "b4"])
def test_the_share_of_the_traced_kernels(counted, names, want):
    """The live rays over every ray launched into the kernels the trace
    holds, B2's cutout variant counted as B2."""
    assert read(synthetic(names=names)) == pytest.approx(want)
    got = cells.read_metrics(cells.load(CELLS[-1]).per_layer,
                             synthetic(names=names))
    assert got[NAME] == {"value": pytest.approx(want), "unit": "%"}


@pytest.mark.parametrize("case", ["older_program", "older_b4", "no_launch",
                                  "not_traced", "interactive", "empty"])
def test_nothing_to_read(counted, monkeypatch, case):
    """None where the program keeps B2's and B4's work counters without the
    ``live`` key (the program before it), counted no launch, the trace
    holds neither shadow kernel, or it is not of progressive cycles."""
    trace = synthetic()
    if case == "older_program":
        monkeypatch.setattr(tc.cluster_shadow, "work",
                            counter(tc.SOUP_WORK, [1500, 54000, 7000]))
        monkeypatch.setattr(tc.cluster_shadow_inst, "work",
                            counter(tc.INST_WORK, [800, 1200]))
    elif case == "older_b4":
        monkeypatch.setattr(tc.cluster_shadow_inst, "work",
                            counter(tc.INST_WORK, [800, 1200]))
    elif case == "no_launch":
        monkeypatch.setattr(tc.cluster_shadow, "launches", 0)
        trace = synthetic(names=(B2,))
    elif case == "not_traced":
        trace = synthetic(names=("some_kernel",))
    elif case == "interactive":
        trace = synthetic(kind="interactive")
    else:
        trace = Trace("none")
    assert read(trace) is None


def test_a_render_reads_its_live_share(monkeypatch):
    """After a CPU render of cornell_box_nee (B2 on every lane's spot
    sample), the share is what B2's counters say: above 0, below 100 (the
    samples outside the spot's beam or facing away weigh zero), and equal
    to the live rays over the rays that the render's passes added. (The
    plain walk launches nothing, so the launches read as one.)"""
    f = tc.cluster_shadow
    monkeypatch.setattr(f, "launches", 1)
    start = (f.rays, f.work.read()["live"])
    r = rt.Renderer(rt.scenes.cornell_box_nee(16, 12), rt.RenderConfig(),
                    seed=5, device="cpu")
    r.render(rpp=4)
    rays, live = f.rays - start[0], f.work.read()["live"] - start[1]
    assert rays == 4 * 16 * 12 and 0 < live < rays
    got = read(synthetic(names=(B2,)))
    assert 0.0 < got < 100.0
    assert got == pytest.approx(100.0 * f.work.read()["live"] / f.rays)
