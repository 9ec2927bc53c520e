"""The plain reference against the renderer at a tiny size on the CPU, and
its independence from the renderer."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest
import torch

from _tiny import LIMITS, ROOT, interactive, progressive, train  # noqa: E402

from benchmark.lib import mixes  # noqa: E402
from benchmark.reference import tracer, world  # noqa: E402

REFERENCE = ROOT / "benchmark" / "reference"


def test_reference_imports_nothing_of_the_renderer():
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert not n.split(".")[0].startswith(("rayzath", "jax", "flax")), \
                    f"{path.name} imports {n}"
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.tracer, benchmark.reference.train, "
            "benchmark.reference.world; "
            "print(sorted(m for m in sys.modules if m.startswith(('rayzath', 'jax'))))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("scene", ["textured_room", "multi_light", "mesh_heavy"])
def test_whole_image_matches_the_renderer(scene):
    """Every pixel of an 8-pass render from fresh paths, the renderer's
    plain CPU path against the reference, within 1e-4 of the larger of
    the pixel and a hundredth of the mean; all path depths equal."""
    import rayzath_tpu_torch as rt
    w, h = 24, 16
    kw = {"resolution": 24} if scene == "mesh_heavy" else {}
    wld = getattr(rt.scenes, scene)(w, h, **kw)
    r = rt.Renderer(wld, rt.RenderConfig(), seed=2 ** 31 + 99, device="cpu")
    r.render(rpp=8)
    st = r.views[id(wld.cameras[0])].state
    sc = tracer.Scene(world.flatten(wld), "cpu")
    idx = torch.arange(w * h)
    paths, rad, cnt = tracer.trace(sc, dict(max_depth=16, spot_light=1,
                                            direct_light=1),
                                   2 ** 31 + 99, 0, 8, idx % w, idx // w)
    want = torch.cat([rad, cnt[:, None]], 1)
    bad = mixes.share_mismatched(st.accum.reshape(-1, 4), want,
                                 {"depth": st.path_depth, "d": st.direction},
                                 paths, tol=1e-4)
    assert int(bad.sum()) == 0


def test_cells_match_the_reference():
    """The mixes' own checks at a tiny size: the renderer's readings are
    under the limits (one pixel of a tiny image is a large share)."""
    for make in (progressive, interactive):
        cell = make()
        mix = mixes.KINDS[cell.traffic["kind"]](cell.config, cell.traffic,
                                                 12345, "cpu")
        mix.setup()
        mix.window(0.3, False)
        mix.release()
        (_, share, _), = mix.check()
        assert share == 0.0
    cell = train()
    mix = mixes.Train(cell.config, cell.traffic, 54321, "cpu")
    mix.setup()
    mix.window(0.1, False)
    mix.release()
    for name, value, key in mix.check():
        assert value <= LIMITS[key], name
