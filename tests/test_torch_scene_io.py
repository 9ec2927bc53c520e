"""The port's scene files (``rayzath_tpu_torch/io``), mirroring
tests/test_scene_io.py and tests/test_hdr.py with the port's classes and
the fixtures written here, then held to the JAX package's ``io``: the same
files load into worlds that compile to the same arrays (array for array,
both packages on their default BVH builders) and render alike from one
seed (``assert_images_match``: sample counts equal; radiance tol 2e-3,
frac 0.995). HDR maps decode to the JAX package's floats bit for bit.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu.io import bitmap as jbitmap  # noqa: E402
from rayzath_tpu.models import device_scene as jds  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.io import bitmap as tbitmap  # noqa: E402
from rayzath_tpu_torch.io.bitmap import hdr_to_texture_emission, load_hdr  # noqa: E402
from rayzath_tpu_torch.io.loader import (SaveOptions, load_hdr as load_hdr_pair,  # noqa: E402
                                         load_scene, save_scene)
from rayzath_tpu_torch.io.json_scene import JsonSaver  # noqa: E402
from rayzath_tpu_torch.io.obj import (load_instances, load_mtl, parse_obj,  # noqa: E402
                                      save_mtl, save_obj)
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.models.world import World  # noqa: E402
from rayzath_tpu_torch.ops import rng  # noqa: E402
from rayzath_tpu_torch.utils.check_worlds import scene_files, write_hdr  # noqa: E402

from test_oracle_parity import assert_images_match  # noqa: E402
from test_scene_io import MTL_TEXT, OBJ_TEXT, SCENE  # noqa: E402
from test_torch_host import assert_scene_equal, jax_leaves  # noqa: E402


@pytest.fixture
def scene_path(tmp_path):
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(SCENE))
    return str(p)


def test_json_load(scene_path):
    w = World()
    result = w.load_scene(scene_path)
    assert result.ok, str(result)
    assert len(w.materials) == 2
    red = w.materials.find("red")
    assert np.allclose(red.color, [1.0, 10 / 255, 10 / 255, 1.0])
    assert red.roughness == 0.5
    glassy = w.materials.find("glassy")
    assert glassy.ior == pytest.approx(1.45)   # generate glass preset
    assert glassy.emission == 2.0              # override after generate

    assert len(w.meshes) == 2
    box = w.meshes.find("box")
    assert box.triangle_count == 12
    tri = w.meshes.find("tri")
    assert tri.triangle_count == 1 and len(tri.vertices) == 3

    cam = w.cameras.find("cam")
    assert cam.resolution == (64, 48)
    assert cam.near_far[0] == pytest.approx(0.1)
    assert cam.near_far[1] == pytest.approx(500.0)
    assert cam.exposure_time == 0.5

    lamp = w.spot_lights.find("lamp")
    assert lamp.emission == 50.0 and lamp.beam_angle == pytest.approx(0.8)
    sun = w.direct_lights.find("sun")
    assert sun.angular_size == pytest.approx(0.05)

    box1 = w.instances.find("box1")
    assert box1.mesh is box
    assert box1.materials[0] is red
    assert np.allclose(box1.transform.scale, [2, 1, 1])

    inner = w.groups.find("inner")
    outer = w.groups.find("outer")
    assert box1.group is inner
    assert inner.parent is outer
    et = box1.effective_transform()
    assert np.allclose(et.points_l2g(np.zeros((1, 3)))[0], [1, 1, 0], atol=1e-5)

    assert w.material.emission == 1.5
    assert np.allclose(w.material.color, [0.2, 0.3, 0.4, 0.0])
    assert w.default_material.ior == 1.0  # paper preset


def test_json_roundtrip(scene_path, tmp_path):
    w = World()
    w.load_scene(scene_path)
    out = str(tmp_path / "resaved" / "scene.json")
    w.save_scene(out)

    w2 = World()
    result = w2.load_scene(out)
    assert result.ok, str(result)
    assert len(w2.materials) == len(w.materials)
    assert len(w2.meshes) == len(w.meshes)
    assert len(w2.instances) == len(w.instances)
    assert len(w2.groups) == len(w.groups)
    assert w2.meshes.find("box").triangle_count == 12
    b1 = w.instances.find("box1").effective_transform()
    b2 = w2.instances.find("box1").effective_transform()
    pts = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    assert np.allclose(b1.points_l2g(pts), b2.points_l2g(pts), atol=1e-5)


def test_json_save_matches_jax(scene_path, tmp_path):
    """Both packages load the fixture and save it: the same JSON."""
    docs = []
    for pkg in (rz, rt):
        w = pkg.World()
        assert w.load_scene(scene_path).ok
        out = tmp_path / pkg.__name__ / "scene.json"
        w.save_scene(str(out))
        docs.append(json.loads(out.read_text()))
    assert docs[0] == docs[1]


def test_circular_group_detection(tmp_path):
    scene = {"Objects": {"Group": [
        {"name": "a", "groups": ["b"]},
        {"name": "b", "groups": ["a"]},
    ]}}
    p = tmp_path / "circ.json"
    p.write_text(json.dumps(scene))
    result = World().load_scene(str(p))
    assert any("Circular" in e for e in result.errors)


@pytest.fixture
def obj_path(tmp_path):
    (tmp_path / "test.obj").write_text(OBJ_TEXT)
    (tmp_path / "test.mtl").write_text(MTL_TEXT)
    return str(tmp_path / "test.obj")


def test_obj_parse(obj_path):
    meshes, mtllibs = parse_obj(obj_path)
    assert mtllibs == ["test.mtl"]
    assert len(meshes) == 2
    quad = meshes[0].mesh
    assert quad.name == "quad"
    assert len(quad.vertices) == 4
    assert quad.triangle_count == 2  # quad fan-triangulated
    assert np.allclose(quad.normals[0], [0, 0, 1])     # z negated
    assert quad.tri_v[0].tolist() == [0, 2, 1]         # fan (0, i+2, i+1)
    assert quad.tri_v[1].tolist() == [0, 3, 2]
    tri = meshes[1].mesh
    assert tri.name == "tri_neg"
    assert tri.triangle_count == 1
    assert sorted(tri.tri_v[0].tolist()) == [0, 1, 2]
    assert meshes[0].material_slots == {"matA": 0}
    assert meshes[1].material_slots == {"matB": 0}


def test_mtl_parse(tmp_path):
    p = tmp_path / "m.mtl"
    p.write_text(MTL_TEXT)
    a, b = load_mtl(str(p))
    assert np.allclose(a.color[:3], [0.5, 0.25, 0.125])
    assert a.color[3] == pytest.approx(0.75)     # d
    assert a.roughness == pytest.approx(0.0)     # Ns 1000 -> roughness 0
    assert a.ior == 1.5
    assert a.emission == 2.0
    assert np.allclose(b.color[:3], 0.8)         # single-value Kd broadcast
    assert b.metalness == pytest.approx(0.9)
    assert b.roughness == pytest.approx(0.2)
    assert b.color[3] == pytest.approx(0.75)     # Tr 0.25 -> alpha 0.75


def test_obj_instances_and_roundtrip(obj_path, tmp_path):
    w = World()
    instances = load_instances(obj_path, w)
    assert len(instances) == 2
    assert instances[0].materials[0].name == "matA"
    assert instances[1].materials[0].name == "matB"
    out_obj = str(tmp_path / "out" / "resave.obj")
    save_mtl(str(tmp_path / "out" / "resave.mtl"), list(w.materials),
             save_maps=False)
    save_obj(out_obj, list(w.meshes), mtl_name="resave.mtl")
    meshes2, _ = parse_obj(out_obj)
    assert len(meshes2) == 2
    q1, q2 = w.meshes[0], meshes2[0].mesh
    assert np.allclose(q1.vertices, q2.vertices, atol=1e-5)
    assert np.array_equal(q1.tri_v, q2.tri_v)


def test_save_options_selective_and_dedup(tmp_path):
    """SaveOptions (reference saver.hpp:104-111): selective group save,
    content-hash map dedup (no rewrite). The maps are PNG (PIL)."""
    w = rt.scenes.textured_room(32, 24)
    out = str(tmp_path / "scene.json")
    save_scene(w, out, SaveOptions(only=frozenset({"lights"})))
    doc = json.loads(open(out).read())
    assert "SpotLight" in doc["Objects"] or "DirectLight" in doc["Objects"]
    assert "Mesh" not in doc["Objects"]
    assert "Instance" not in doc["Objects"]

    save_scene(w, out)
    maps_dir = tmp_path / "maps"
    files = sorted(os.listdir(maps_dir))
    mtimes = {f: os.path.getmtime(maps_dir / f) for f in files}
    time.sleep(0.05)
    save_scene(w, out)
    assert sorted(os.listdir(maps_dir)) == files
    for f in files:
        assert os.path.getmtime(maps_dir / f) == mtimes[f], f"{f} rewritten"
    save_scene(w, out, SaveOptions(duplicate_textures=True))
    assert any("_0_" in f for f in os.listdir(maps_dir))


def test_save_options_rollback_on_failure(tmp_path, monkeypatch):
    w = rt.scenes.textured_room(32, 24)
    saver = JsonSaver(w, str(tmp_path / "x" / "scene.json"))
    calls = {"n": 0}
    orig = JsonSaver._write_map_file

    def failing(self, kind, i, m, options):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise OSError("disk full")
        return orig(self, kind, i, m, options)

    monkeypatch.setattr(JsonSaver, "_write_map_file", failing)
    with pytest.raises(OSError):
        saver.save(SaveOptions(allow_partial_write=False))
    maps = tmp_path / "x" / "maps"
    assert not maps.exists() or os.listdir(maps) == []


def test_cross_load_dedup_reuses_maps(tmp_path):
    """Two scenes referencing one map file load it once into one world."""
    img = np.random.default_rng(0).random((8, 8, 4)).astype(np.float32)
    tbitmap.save_image(str(tmp_path / "shared.png"), img)
    scene = {"Objects": {"Texture": [{"name": "tex", "file": "shared.png"}]}}
    for name in ("a.json", "b.json"):
        (tmp_path / name).write_text(json.dumps(scene))
    w = World()
    w.load_scene(str(tmp_path / "a.json"))
    assert len(w.textures) == 1
    w.load_scene(str(tmp_path / "b.json"))
    assert len(w.textures) == 1, "same-path map duplicated across loads"


def test_png_needs_pil(tmp_path, monkeypatch):
    """Without PIL a PNG map raises; .hdr and .npy maps still decode."""
    monkeypatch.setattr(tbitmap, "_HAS_PIL", False)
    with pytest.raises(RuntimeError, match="PIL"):
        tbitmap.load_image(str(tmp_path / "any.png"))
    write_hdr(str(tmp_path / "a.hdr"), np.full((2, 3, 3), 2.0, np.float32))
    assert load_hdr(str(tmp_path / "a.hdr")).shape == (2, 3, 3)


# -- HDR (tests/test_hdr.py) ---------------------------------------------------

def test_hdr_roundtrip(tmp_path):
    rgb = np.random.default_rng(0).uniform(0.1, 50.0, (6, 7, 3)).astype(np.float32)
    p = str(tmp_path / "probe.hdr")
    write_hdr(p, rgb)
    out = load_hdr(p)
    assert out.shape == (6, 7, 3)
    quantum = rgb.max(axis=2, keepdims=True) / 256.0
    assert np.all(np.abs(out - rgb) <= quantum * 2.1 + 1e-4)
    assert np.array_equal(out, jbitmap.load_hdr(p))      # JAX package's decode


def test_hdr_npy_and_pair_split(tmp_path):
    rgb = np.asarray([[[2.0, 4.0, 1.0]]], np.float32)
    p = str(tmp_path / "e.npy")
    np.save(p, rgb)
    out = load_hdr(p)
    np.testing.assert_allclose(out, rgb)
    tex, emi = hdr_to_texture_emission(out)
    np.testing.assert_allclose(emi, [[4.0]])
    np.testing.assert_allclose(tex[0, 0], [0.5, 1.0, 0.25, 1.0])


def test_loader_hdr_pair_api(tmp_path):
    rgb = np.full((4, 8, 3), 3.0, np.float32)
    rgb[:, :, 1] = 6.0
    p = str(tmp_path / "sky.hdr")
    write_hdr(p, rgb)
    w = World()
    tex, emi = load_hdr_pair(w, p, address_mode="clamp")
    assert tex in list(w.textures) and emi in list(w.emission_maps)
    assert emi.name == "sky emission"
    np.testing.assert_allclose(np.asarray(emi.data).max(), 6.0, rtol=0.02)


def test_json_scene_hdr_texture(tmp_path):
    write_hdr(str(tmp_path / "env.hdr"), np.full((4, 4, 3), 2.0, np.float32))
    scene = {"Objects": {"Texture": [{"name": "env", "file": "env.hdr"}]}}
    sp = tmp_path / "scene.json"
    sp.write_text(json.dumps(scene))
    w = World()
    res = load_scene(w, str(sp))
    assert not res.errors
    assert "env" in [t.name for t in w.textures]
    assert any(m.name == "env emission" for m in w.emission_maps)


def test_hdr_environment_lights_scene(tmp_path):
    """An HDR sky (texture and emission on the world material) lights a
    diffuse scene through the miss path, with no injected uniforms."""
    from rayzath_tpu_torch.engine.integrator import render_steps
    from rayzath_tpu_torch.engine.state import init_state
    rgb = np.full((8, 16, 3), 0.05, np.float32)
    rgb[0:2] = (20.0, 10.0, 5.0)
    p = str(tmp_path / "sky.hdr")
    write_hdr(p, rgb)
    w = World()
    tex, emi = load_hdr_pair(w, p)
    w.material.texture = tex
    w.material.emission_map = emi
    w.material.emission = 1.0
    white = w.create_material("white", color=(0.8, 0.8, 0.8, 1.0))
    plane = w.generate_mesh("plane", sides=4, width=6.0, height=6.0)
    w.create_instance(name="ground", mesh=plane, materials=[white])
    cam = w.create_camera("camera", position=(0, 1.0, -4.0),
                          resolution=(32, 32), fov=1.1, focal_distance=4.0,
                          aperture=0.01, exposure_time=0.5)
    cam.look_at((0, 0.0, 0))
    scene = tds.compile_world(w, device="cpu")
    dcam = tds.compile_camera(w.cameras[0], device="cpu")
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3, rpp=4))
    st = render_steps(scene, dcam, cfg, init_state(32, 32, device="cpu"),
                      rng.key(0), 6)
    img = st.accum[..., :3].numpy()
    assert np.isfinite(img).all()
    assert img.max() > 0.05, "HDR environment contributed no light"


def test_old_rle_hdr_decodes(tmp_path):
    """Old-style RLE (repeat marker (1,1,1,count)) decodes."""
    h, w = 4, 16
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., 0], rgbe[..., 1], rgbe[..., 2], rgbe[..., 3] = 64, 32, 16, 128
    rgbe[1, :, 0] = 200
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        out += bytes(rgbe[y, 0])                  # literal first pixel
        out += bytes([1, 1, 1, w - 1])            # repeat it w-1 times
    (tmp_path / "old.hdr").write_bytes(bytes(out))
    img = load_hdr(str(tmp_path / "old.hdr"))
    assert img.shape == (h, w, 3)
    assert np.all(img == img[:, :1, :])
    assert img[1, 0, 0] != img[0, 0, 0]
    assert np.isclose(img[0, 0, 0], 64 / 256, rtol=1e-6)


# -- the same files in both packages -------------------------------------------

def _instanced(pkg):
    return pkg.scenes.instanced_field(16, 16, n=3, resolution=12)


@pytest.mark.parametrize("name", ["multi_light", "instanced_field"])
def test_loaded_world_compiles_like_jax(name, tmp_path):
    """``scene_files`` writes a world as a JSON scene with one OBJ/MTL per
    mesh and an HDR sky; both packages load it, and the loaded worlds
    compile to the same arrays (the instanced field two-level)."""
    make = _instanced if name == "instanced_field" else (
        lambda pkg: pkg.scenes.multi_light(16, 16))
    path = scene_files(make(rt), str(tmp_path))
    tw, jw = World(), rz.World()
    r_port, r_jax = tw.load_scene(path), jw.load_scene(path)
    assert r_port.ok and r_jax.ok, (r_port, r_jax)
    assert r_port.errors == r_jax.errors and r_port.warnings == r_jax.warnings
    src = make(rt)
    assert len(tw.meshes) == len(src.meshes)
    assert len(tw.instances) == len(src.instances)
    assert tw.triangle_count() == src.triangle_count()
    assert [t.name for t in tw.textures] == ["sky"]
    two_level = True if name == "instanced_field" else None
    ts = tds.compile_world(tw, two_level=two_level, device="cpu")
    js = jds.compile_world(jw, two_level=two_level)
    assert ts.two_level == (name == "instanced_field")
    assert_scene_equal(ts, *jax_leaves(js))


def test_loaded_world_renders_like_jax(tmp_path):
    """The loaded multi_light, Renderer(seed=4) in both packages, no
    injected uniforms, then a camera move (reprojection)."""
    path = scene_files(rt.scenes.multi_light(16, 16), str(tmp_path))
    out = []
    for pkg in (rz, rt):
        w = pkg.World()
        assert w.load_scene(path).ok
        kw = {} if pkg is rz else dict(device="cpu")
        r = pkg.Renderer(w, pkg.RenderConfig(tracing=pkg.Tracing(max_depth=3)),
                         seed=4, **kw)
        r.render(rpp=2)
        w.cameras[0].look_at((0.2, 0.3, 0.0))
        r.render(rpp=1)
        out.append(np.asarray(r.views[id(w.cameras[0])].state.accum))
    assert out[1][..., 3].sum() > 16 * 16
    assert_images_match(out[1], out[0])
