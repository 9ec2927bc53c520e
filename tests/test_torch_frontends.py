"""The port's front ends against the JAX package's, on the CPU.

The CLI helpers (``utils/args.py``, ``utils/text.py``), the headless runner
(``prepare_tasks``, ``balance_rpp``, ``Headless``, ``python -m
rayzath_tpu_torch``), the ``Engine`` facade, the editor and the viewer are
fed the same inputs as the JAX package's and must give the same results:
the same parses, tasks, rpp sequences, explorer trees and properties; the
same compiled scene arrays after the same edits; renders with equal sample
counts and radiance within ``assert_images_match`` (tol 2e-3, frac 0.995).
Also the repaired faults: PNG is written without PIL, and the package
exports the JAX package's names.
"""
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu import editor as jeditor  # noqa: E402
from rayzath_tpu import headless as jheadless  # noqa: E402
from rayzath_tpu.models import device_scene as jds  # noqa: E402
from rayzath_tpu.utils import args as jargs  # noqa: E402
from rayzath_tpu.utils import text as jtext  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch import editor as teditor  # noqa: E402
from rayzath_tpu_torch import headless as theadless  # noqa: E402
from rayzath_tpu_torch.io import bitmap  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.utils import args as targs  # noqa: E402
from rayzath_tpu_torch.utils import text as ttext  # noqa: E402
from rayzath_tpu_torch.viewer import Viewer  # noqa: E402

from test_headless import SCENE  # noqa: E402
from test_oracle_parity import assert_images_match  # noqa: E402
from test_torch_host import assert_scene_equal, jax_leaves, numpy_bvh  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# CLI helpers
# ---------------------------------------------------------------------------

def _headless_args(m):
    return (m.Args()
            .arg(m.Arg({"-h", "--help"}, "help", []))
            .arg(m.Arg({"--headless"}, "headless",
                       [m.Option("task_path", True),
                        m.Option("report_path", False)]))
            .arg(m.Arg({"-r"}, "render", [])))


def _files_args(m):
    return m.Args().arg(m.Arg({"--files"}, "files", [m.Option("file", True, True)]))


def _parse(m, make, argv):
    """("ok", dict) or ("raise", exception type name, message)."""
    try:
        return ("ok", make(m).parse(argv))
    except Exception as e:  # noqa: BLE001 - the exception is the result
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("make,argv", [
    (_headless_args, ["--nope"]),
    (_headless_args, ["-h", "-h"]),
    (_headless_args, ["--headless"]),
    (_headless_args, ["--headless", "task.json", "out_dir", "-r"]),
    (_headless_args, ["--headless", "task.json", "-r"]),
    (_files_args, ["--files", "a", "b", "c"]),
], ids=["unknown", "duplicate", "required_missing", "required_and_optional",
        "optional_stops", "multiple"])
def test_args_parse_like_jax(make, argv):
    """Each argv of tests/test_headless.py: the same dict, or the same
    exception type and message; and the same usage string."""
    assert _parse(targs, make, argv) == _parse(jargs, make, argv)
    assert make(targs).usage_string() == make(jargs).usage_string()


def test_scientific_with_prefix_like_jax():
    values = [0, 0.5, 1, 999, 1000, 1234.5, -52_300_000, 7.1e9, 3e12, 9.9e15,
              4e18, 1e21]
    for v in values:
        for p in (0, 2, 3):
            assert (ttext.scientific_with_prefix(v, p)
                    == jtext.scientific_with_prefix(v, p)), (v, p)


# ---------------------------------------------------------------------------
# headless runner
# ---------------------------------------------------------------------------

def _task_dir(tmp_path, tasks):
    (tmp_path / "scene.json").write_text(json.dumps(SCENE))
    task_file = tmp_path / "tasks.json"
    task_file.write_text(json.dumps({"tasks": tasks}))
    return str(task_file)


@pytest.mark.parametrize("tasks", [
    [{"scene path": "scene.json", "engine": ["CPU", "CUDAGPU", "TPU"],
      "rpp": 8, "timeout": 30, "max depth": 4}],
    {"scene path": "/abs/scene.json"},
    [{"scene path": "a.json", "engine": "CPU"}, {"scene path": "b.json"}],
], ids=["engines", "single_object", "defaults"])
def test_prepare_tasks_like_jax(tmp_path, tasks):
    """The same tasks, up to the engine's name: the JAX runner's "TPU" is
    the port's "CUDAGPU" (the card), "CPU" is "CPU" in both."""
    path = _task_dir(tmp_path, tasks)
    ours, ref = theadless.prepare_tasks(path), jheadless.prepare_tasks(path)
    assert len(ours) == len(ref) > 0
    to_port = {"TPU": "CUDAGPU", "CPU": "CPU"}
    for a, b in zip(ours, ref):
        assert (a.scene_path, a.rpp, a.timeout, a.max_depth) == (
            b.scene_path, b.rpp, b.timeout, b.max_depth)
        assert a.engine == [to_port[e] for e in b.engine]


def test_unknown_engine_raises_like_jax(tmp_path):
    path = _task_dir(tmp_path, [{"scene path": "x.json", "engine": "Metal"}])
    with pytest.raises(ValueError) as ours:
        theadless.prepare_tasks(path)
    with pytest.raises(ValueError) as ref:
        jheadless.prepare_tasks(path)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("per_pass,overhead", [
    (0.02, 0.002), (0.0004, 0.001), (0.5, 0.01), (1e-6, 1e-5)])
def test_balance_rpp_like_jax(per_pass, overhead):
    """The cost models of test_rpp_balancer_converges_and_bounds_recompiles:
    the same (floaty, rpp) sequence, power-of-two rpp in [1, 1024]."""
    assert theadless.LOAD_TIME_TARGET == jheadless.LOAD_TIME_TARGET
    a = b = (1.0, 1)
    for _ in range(60):
        a = theadless.balance_rpp(*a, overhead + per_pass * a[1])
        b = jheadless.balance_rpp(*b, overhead + per_pass * b[1])
        assert a == b
        assert 1 <= a[1] <= 1024 and a[1] & (a[1] - 1) == 0


def test_headless_run_on_cpu(tmp_path):
    """tests/test_headless.py's end-to-end run, engine "CPU", with -r: the
    report's lines and one PNG, decoded (PIL) to the camera's size."""
    from PIL import Image
    path = _task_dir(tmp_path, [{"scene path": "scene.json", "engine": "CPU",
                                 "rpp": 4, "timeout": 30, "max depth": 3}])
    report_dir = str(tmp_path / "report")
    out = io.StringIO()
    assert theadless.Headless(out=out).run(path, report_dir,
                                           save_images=True) == 0
    lines = open(os.path.join(report_dir, "report.txt")).read().splitlines()
    assert lines[0] == "Scene: scene.json"
    assert lines[1] == "\tengine: CPU | max depth: 3"
    assert lines[2].startswith("\tduration: ") and lines[2].endswith("rps)")
    assert "traced 1.02k rays" in lines[2]          # 4 passes x 16 x 16
    assert "Rendering... 4/4" in out.getvalue()
    images = [f for f in os.listdir(report_dir) if f.endswith(".png")]
    assert images == ["scene.json_cam_1.02k_CPU.png"]
    img = np.asarray(Image.open(os.path.join(report_dir, images[0])))
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8


def test_python_m_help_is_jax_free():
    """``python -m rayzath_tpu_torch --help`` exits 0 and prints the usage;
    run as ``__main__`` in a fresh interpreter it imports no jax."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "rayzath_tpu_torch", "--help"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("Arguments:") and "--headless" in out.stdout
    assert "--scaling" in out.stdout and "torch.profiler" in out.stdout
    code = ("import runpy, sys\n"
            "sys.argv = ['rayzath_tpu_torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('rayzath_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, capture_output=True, timeout=120)


def test_main_headless_profile_writes_a_trace(tmp_path):
    """``--headless tasks out -r --profile dir`` on a "CPU" task: the report,
    the image and a torch.profiler Chrome trace."""
    path = _task_dir(tmp_path, [{"scene path": "scene.json", "engine": "CPU",
                                 "rpp": 2, "max depth": 2}])
    out, trace = tmp_path / "out", tmp_path / "trace"
    assert theadless.main(["--headless", path, str(out), "-r",
                           "--profile", str(trace)]) == 0
    assert (out / "report.txt").exists() and list(out.glob("*.png"))
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_headless_card_engine_needs_a_card(tmp_path):
    """A "CUDAGPU" task renders on the card; without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_gpu.py renders there")
    path = _task_dir(tmp_path, [{"scene path": "scene.json", "rpp": 1}])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        theadless.Headless(out=io.StringIO()).run(path, str(tmp_path / "r"))


# ---------------------------------------------------------------------------
# Engine, exports, PNG
# ---------------------------------------------------------------------------

def test_engine_defaults_to_the_card():
    import inspect
    assert inspect.signature(rt.Engine).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_gpu.py renders there")
    with pytest.raises(RuntimeError, match="'cuda' requested, but no CUDA device"):
        rt.Engine()


def test_engine_render_world_matches_jax():
    """Engine(device="cpu").render_world on cornell_box(32, 32), depth 3, 2
    passes, against the JAX Engine (both seed 0 through the world setter)."""
    cfg = dict(tracing=dict(max_depth=3))
    je = rz.Engine(rz.RenderConfig(tracing=rz.Tracing(**cfg["tracing"])))
    te = rt.Engine(rt.RenderConfig(tracing=rt.Tracing(**cfg["tracing"])),
                   device="cpu")
    assert te.device == torch.device("cpu")
    je.world = rz.scenes.cornell_box(32, 32)
    te.world = rt.scenes.cornell_box(32, 32)
    je.render_world(rpp=2)
    te.render_world(rpp=2)
    a_jax = np.asarray(je.renderer.views[id(je.world.cameras[0])].state.accum)
    a_port = te.renderer.views[id(te.world.cameras[0])].state.accum.numpy()
    assert a_port[..., 3].sum() > 0
    assert_images_match(a_port, a_jax)
    assert "trace" in te.debug_info()


def test_exports_match_jax():
    """rt.Material(name=...) works where rz.Material does: the package
    exports every name of the JAX package's __all__."""
    assert set(rz.__all__) <= set(rt.__all__)
    for name in rz.__all__:
        assert hasattr(rt, name), name
    m = rt.Material(name="rogue")
    assert m.name == "rogue"


@pytest.mark.parametrize("channels", [3, 4])
def test_save_png_without_pil(tmp_path, monkeypatch, channels):
    """save_image writes PNG with no PIL (``_HAS_PIL`` forced False); PIL
    decodes the file to the same pixels. JPEG still needs PIL."""
    from PIL import Image
    a = np.random.default_rng(channels).integers(
        0, 256, (13, 21, channels)).astype(np.uint8)
    monkeypatch.setattr(bitmap, "_HAS_PIL", False)
    path = str(tmp_path / "sub" / "img.png")
    bitmap.save_image(path, a)
    with pytest.raises(RuntimeError, match="PIL"):
        bitmap.save_image(str(tmp_path / "img.jpg"), a)
    im = Image.open(path)
    assert im.mode == ("RGB" if channels == 3 else "RGBA")
    assert np.array_equal(np.asarray(im), a)
    f = a.astype(np.float32) / 255.0                # float input in [0, 1]
    bitmap.save_image(path, f)
    assert np.array_equal(np.asarray(Image.open(path)),
                          np.clip(f * 255.0, 0, 255).astype(np.uint8))


# ---------------------------------------------------------------------------
# editor
# ---------------------------------------------------------------------------

def _every_props(editor, world):
    tree = editor.scene_tree(world)
    return tree, [editor.get_props(world, t, it["idx"])
                  for t, items in tree.items() for it in items
                  if it["editable"]]


@pytest.mark.parametrize("name", ["multi_light", "textured_room"])
def test_editor_tree_and_props_like_jax(name):
    ours = _every_props(teditor, getattr(rt.scenes, name)(32, 32))
    ref = _every_props(jeditor, getattr(rz.scenes, name)(32, 32))
    assert json.dumps(ours) == json.dumps(ref)


def _edits(editor, pkg, tmp_path):
    """The same sequence of editor actions on a package's textured_room."""
    w = pkg.scenes.textured_room(16, 16)
    editor.set_prop(w, "material", 0, "roughness", 0.37)
    editor.set_prop(w, "material", 1, "color", [0.2, 0.3, 0.4])
    ball = next(i for i, it in enumerate(w.instances) if it.name == "ball 1")
    editor.set_prop(w, "instance", ball, "transform.position", [0.9, 0.8, 0.7])
    editor.set_prop(w, "instance", ball, "transform.rotation", [0.1, 0.2, 0.3])
    editor.set_prop(w, "spot_light", 0, "direction", [2.0, -1.0, 0.0])
    made = editor.new_object(w, "material", {"name": "fresh"})
    editor.set_prop(w, "material", made["idx"], "emission", 2.5)
    editor.new_object(w, "mesh", {"kind": "cube", "name": "extra cube"})
    editor.new_object(w, "instance", {"mesh": len(w.meshes) - 1,
                                      "material": made["idx"],
                                      "name": "extra"})
    editor.destroy_object(w, "instance", 0)
    return w, made


def test_editor_edits_compile_like_jax(tmp_path, numpy_bvh):
    """set_prop, new_object and destroy_object applied to both packages'
    worlds give equal compile_world arrays."""
    tw, tmade = _edits(teditor, rt, tmp_path)
    jw, jmade = _edits(jeditor, rz, tmp_path)
    assert tmade == jmade
    ts = tds.compile_world(tw, device="cpu")
    assert_scene_equal(ts, *jax_leaves(jds.compile_world(jw)))


def test_editor_load_scene_compiles_like_jax(tmp_path, numpy_bvh):
    """load_scene into a world that already holds a scene: the result and
    the compiled arrays equal the JAX editor's."""
    path = str(tmp_path / "scene" / "multi_light.json")
    rt.scenes.multi_light(16, 16).save_scene(path)
    tw, jw = rt.scenes.cornell_box(16, 16), rz.scenes.cornell_box(16, 16)
    assert teditor.load_scene(tw, path) == jeditor.load_scene(jw, path)
    assert_scene_equal(tds.compile_world(tw, device="cpu"),
                       *jax_leaves(jds.compile_world(jw)))
    with pytest.raises(OSError):
        teditor.load_scene(tw, str(tmp_path / "missing.json"))
    assert len(tw.instances) == len(jw.instances) > 0   # the scene survived


# tests/test_destroy.py's five cases on the port

def _destroy_world():
    w = rt.World()
    m = w.create_material("red", color=(1.0, 0.1, 0.1, 1.0))
    mesh = w.generate_mesh("cube")
    inst = w.create_instance(name="box", mesh=mesh, materials=[m])
    w.create_camera(resolution=(16, 16))
    return w, m, mesh, inst


def test_destroy_material_detaches_instance_slots():
    w, m, mesh, inst = _destroy_world()
    assert inst.materials[0] is m
    assert w.materials.destroy(m)
    assert inst.materials[0] is None
    scene = tds.compile_world(w, device="cpu")
    tri_mat = scene.tri_mat.numpy()[:mesh.triangle_count]
    assert (tri_mat == tds.DEFAULT_MATERIAL_ID).all()


def test_destroy_mesh_detaches_instances():
    w, m, mesh, inst = _destroy_world()
    assert w.meshes.destroy(mesh)
    assert inst.mesh is None
    assert tds.compile_world(w, device="cpu").n_triangles == 0


def test_destroy_map_detaches_materials():
    w, m, mesh, inst = _destroy_world()
    tex = rt.Texture(name="t", data=np.zeros((4, 4, 4), np.float32))
    w.textures.create(tex)
    m.texture = tex
    assert w.textures.destroy(tex)
    assert m.texture is None


def test_dangling_material_warns_and_substitutes_default():
    w, m, mesh, inst = _destroy_world()
    rogue = rt.Material(name="rogue")
    inst.materials[0] = rogue
    w.touch()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        scene = tds.compile_world(w, device="cpu")
    assert any("rogue" in str(r.message) for r in rec)
    tri_mat = scene.tri_mat.numpy()[:mesh.triangle_count]
    assert (tri_mat == tds.DEFAULT_MATERIAL_ID).all()


def test_destroy_group_unlinks_children_and_instances():
    w, m, mesh, inst = _destroy_world()
    g = w.create_group()
    sub = w.create_group()
    g.add_group(sub)
    g.add_instance(inst) if hasattr(g, "add_instance") else g.instances.append(inst)
    inst.group = g
    assert w.groups.destroy(g)
    assert inst.group is None
    assert sub.parent is None


# ---------------------------------------------------------------------------
# viewer
# ---------------------------------------------------------------------------

def _req(port, path, body=None):
    url = f"http://127.0.0.1:{port}{path}"
    if body is None:
        r = urllib.request.urlopen(url, timeout=60)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        r = urllib.request.urlopen(req, timeout=60)
    return r.status, r.read()


def _wait(pred, seconds=60.0):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


@pytest.fixture
def served():
    """A viewer on cornell_box(32, 32), depth 2, rendering on the CPU, with
    its server on a free port; stopped (render thread joined) afterwards."""
    world = rt.scenes.cornell_box(32, 32)
    v = Viewer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=2, rpp=2)),
               rpp_per_cycle=2, device="cpu")
    server = v.make_server(port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    v.start()
    try:
        yield v, server.server_address[1], world
    finally:
        v.stop()
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not v.thread and not t.is_alive()


def test_viewer_endpoints(served):
    """tests/test_viewer.py's endpoints, plus /tree, /props and /edit (which
    restarts the pass count), and an /orbit that reprojects."""
    from PIL import Image
    v, port, world = served
    assert _wait(lambda: v.stats()["pass_count"] > 0), v.stats()

    code, page = _req(port, "/")
    assert code == 200 and b"orbit" in page and b'width="32"' in page
    code, png = _req(port, "/frame")
    assert code == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.asarray(Image.open(io.BytesIO(png))).shape == (32, 32, 3)
    stats = json.loads(_req(port, "/stats")[1])
    assert stats["width"] == 32 and stats["pass_count"] > 0
    assert stats["error"] == ""

    pos0 = np.asarray(world.cameras[0].position).copy()
    assert _req(port, "/orbit", {"dx": 40, "dy": 10})[0] == 200
    assert not np.allclose(np.asarray(world.cameras[0].position), pos0)
    assert _wait(lambda: "temporal reproject" in v.renderer.time_table.entries())

    picked = json.loads(_req(port, "/pick", {"x": 16, "y": 16})[1])
    assert picked["instance"] >= 0 and picked["name"]
    fd = json.loads(_req(port, "/focus", {"x": 16, "y": 16})[1])["focal_distance"]
    assert fd > 0
    assert _req(port, "/zoom", {"d": -120})[0] == 200

    tree = json.loads(_req(port, "/tree")[1])
    assert tree == teditor.scene_tree(world)
    props = json.loads(_req(port, "/props?type=material&idx=0")[1])
    assert any(f["attr"] == "roughness" for f in props["fields"])
    assert _wait(lambda: v.stats()["pass_count"] > 4)
    code, body = _req(port, "/edit", {"type": "material", "idx": 0,
                                      "attr": "roughness", "value": 0.3})
    assert code == 200 and world.materials[0].roughness == pytest.approx(0.3)
    assert _wait(lambda: 0 < v.stats()["pass_count"] <= 4), v.stats()
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(port, "/edit", {"type": "material", "idx": 0, "attr": "name",
                             "value": "x"})
    assert e.value.code == 400
    assert v.stats()["error"] == ""


def test_viewer_render_failure_is_kept(monkeypatch):
    """A render cycle that raises stops the render thread, is kept in
    stats()["error"], and stop() still joins the thread."""
    v = Viewer(rt.scenes.cornell_box(8, 8), device="cpu")

    def broken(**kw):
        raise ValueError("broken cycle")

    monkeypatch.setattr(v.renderer, "render", broken)
    v.start()
    thread = v.thread
    assert _wait(lambda: v.stats()["error"] != "")
    v.stop()
    assert v.stats()["error"] == "ValueError: broken cycle"
    assert not thread.is_alive() and not v.running


def test_viewer_defaults_to_the_card():
    import inspect
    assert inspect.signature(Viewer).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Viewer(rt.scenes.cornell_box(8, 8))
