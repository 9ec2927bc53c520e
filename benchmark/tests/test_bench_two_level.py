"""The two-level (instanced) path against the plain reference at a tiny size
on the CPU: the renderer's plain path walks instance rows over shared
object-space cluster tables (B3/B4's plain versions, the instance
transforms, the slot-table materials), the reference flattens every
instance into world-space triangles and brute-forces them, so the two
share none of that code."""
from __future__ import annotations

import json

import pytest
import torch

from _tiny import ROOT, progressive  # noqa: E402

from benchmark.lib import mixes  # noqa: E402
from benchmark.reference import tracer, world  # noqa: E402

SEED = 2 ** 31 + 17


def test_whole_image_matches_the_renderer():
    """Every pixel of an 8-pass render of a small instanced_field from fresh
    paths, the renderer's plain CPU path compiled two-level against the
    reference, within 1e-4 of the larger of the pixel and a hundredth of
    the mean; all path depths equal."""
    import rayzath_tpu_torch as rt
    w, h = 24, 16
    wld = rt.scenes.instanced_field(w, h, n=3, resolution=12)
    r = rt.Renderer(wld, rt.RenderConfig(two_level=True), seed=SEED,
                    device="cpu")
    r.render(rpp=8)
    assert r.scene.two_level
    st = r.views[id(wld.cameras[0])].state
    sc = tracer.Scene(world.flatten(wld), "cpu")
    idx = torch.arange(w * h)
    paths, rad, cnt = tracer.trace(sc, dict(max_depth=16, spot_light=1,
                                            direct_light=1),
                                   SEED, 0, 8, idx % w, idx // w)
    want = torch.cat([rad, cnt[:, None]], 1)
    bad = mixes.share_mismatched(st.accum.reshape(-1, 4), want,
                                 {"depth": st.path_depth, "d": st.direction},
                                 paths, tol=1e-4)
    assert int(bad.sum()) == 0


@pytest.fixture
def small_field(monkeypatch):
    """The cell's scene builder, by its name, gives a 3 x 3 field of
    960-triangle spheres: 8,642 expanded triangles, which the renderer's
    automatic rule compiles two-level as it does the full field."""
    import rayzath_tpu_torch as rt
    full = rt.scenes.instanced_field
    monkeypatch.setattr(rt.scenes, "instanced_field",
                        lambda width, height: full(width, height, n=3,
                                                   resolution=32))


def test_the_cell_matches_and_the_control_does_not(small_field):
    """The progressive mix's own check on a tiny two-level cell: the
    program's reading is 0, and the reference in bfloat16 in the program's
    place reads over the cell's limit."""
    with open(ROOT / "benchmark" / "limits" /
              "instanced_field.progressive.json") as f:
        limit = json.load(f)["mismatch_share"]
    cell = progressive("instanced_field")
    mix = mixes.Progressive(cell.config, cell.traffic, SEED, "cpu")
    mix.setup()
    assert mix.renderer.scene.two_level
    mix.window(0.2, False)
    mix.release()
    (_, share, _), = mix.check()
    assert share == 0.0
    (_, control, _), = mix.check(produce=torch.bfloat16)
    assert control > limit, control
