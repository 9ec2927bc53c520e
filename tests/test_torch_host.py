"""The port's host layer against the JAX package's.

The port carries jax-free copies of the host model, the scene builders, the
BVH and cluster-table builds and the soup branch of ``compile_world``; these
tests pin the copies to the originals array for array.

Both packages' ``build_bvh`` prefer their C++ builder (``native/``) and
fall back to the NumPy one, which is not bit-identical to it (see
``test_native_bvh_builder_differs``). The ``numpy_bvh`` fixture routes both
packages to their NumPy builders, so these tests hold the NumPy copies to
the originals; ``tests/test_torch_native.py`` holds the defaults.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu import native as rz_native  # noqa: E402
from rayzath_tpu.models import device_scene as jds  # noqa: E402
from rayzath_tpu.ops import bvh as jbvh  # noqa: E402
from rayzath_tpu.ops import traverse_cluster as jtc  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch import native as rt_native  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import bvh as tbvh  # noqa: E402
from rayzath_tpu_torch.ops import traverse as ttw  # noqa: E402
from rayzath_tpu_torch.ops import traverse_cluster as ttc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def numpy_bvh(monkeypatch):
    """Route both packages' build_bvh to their NumPy builders."""
    monkeypatch.setattr(rz_native, "bvh_build", lambda *a, **k: None)
    monkeypatch.setattr(rt_native, "bvh_build", lambda *a, **k: None)


def jax_leaves(scene):
    """{name: np.ndarray} of a JAX DeviceScene's array leaves + its statics."""
    leaves, statics = {}, {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if v is None:
            continue
        if isinstance(v, (bool, int, tuple)):
            statics[f.name] = v
        else:
            leaves[f.name] = np.asarray(v)
    return leaves, statics


def assert_scene_equal(ts, leaves, statics):
    """Every field of the port scene equals the JAX leaf or static of the
    same name; a field the JAX scene leaves out (None) must be one of the
    port's placeholders for the other structure, or None in the port too.
    The expanded lists ``exp_tri``/``exp_inst`` may be None in the port,
    which builds them only for ``differentiable=True``. ``leaf_tri``, the
    port's own, holds the skip-link walk's leaf blocks of the JAX scene's
    BVH (default leaf size) on a soup scene; ``cl_group``, the port's own
    too, the group table of the scene's ``cl_box``; ``cl_cut_map`` /
    ``cl_cut_uv``, the port's own too, a soup's cutout set per slot of its
    cluster table (``cutout_slots`` of the JAX scene's cluster order,
    materials and ``tri_pack`` texture coordinates)."""
    stand_in = tds.placeholders(ts.two_level)
    if not ts.two_level and "node_count" in leaves:
        stand_in["leaf_tri"] = ttw.leaf_table(leaves["node_begin"],
                                              leaves["node_count"], 8)
    box = leaves.get("cl_box", stand_in.get("cl_box"))
    if box is not None:
        stand_in["cl_group"] = ttc.group_table(box)
    if ts.cl_cut_map is not None:
        tp = leaves["tri_pack"]
        geo = {"cl_fields": {k: leaves[k] for k in ("cl_order", "cl_base",
                                                     "cl_count")},
               "tri_t0": tp[:, 18:20], "tri_t1": tp[:, 20:22],
               "tri_t2": tp[:, 22:24]}
        stand_in.update(tds.cutout_slots(geo, leaves["tri_mat"],
                                         leaves["mat_color"],
                                         leaves["mat_maps"]))
    for f in dataclasses.fields(tds.TorchScene):
        a = getattr(ts, f.name)
        if a is None:
            assert f.name not in leaves or f.name in ("exp_tri", "exp_inst"), f.name
            continue
        if isinstance(a, (int, tuple)):
            assert a == statics[f.name], f.name
            continue
        if f.name not in leaves:
            assert np.array_equal(a.numpy(), stand_in[f.name]), f.name
            continue
        b = leaves[f.name]
        assert a.shape == b.shape and a.numpy().dtype == b.dtype, f.name
        assert np.array_equal(a.numpy(), b), f.name


@pytest.mark.parametrize("name", ["cornell_box_nee", "multi_light",
                                  "glass_and_fog"])
def test_compile_world_leaves_match(name, numpy_bvh):
    js = jds.compile_world(getattr(rz.scenes, name)(24, 24))
    ts = tds.compile_world(getattr(rt.scenes, name)(24, 24), device="cpu")
    leaves, statics = jax_leaves(js)
    assert_scene_equal(ts, leaves, statics)
    assert ts.n_clusters == js.n_clusters >= 1


def test_scene_from_arrays_roundtrip(numpy_bvh):
    js = jds.compile_world(rz.scenes.multi_light(24, 24))
    leaves, statics = jax_leaves(js)
    ts = tds.scene_from_arrays(leaves, statics, device="cpu")
    assert_scene_equal(ts, leaves, statics)
    # and back: the port scene's own arrays rebuild an equal scene
    own = {f.name: getattr(ts, f.name).numpy()
           for f in dataclasses.fields(ts)
           if isinstance(getattr(ts, f.name), torch.Tensor)}
    again = tds.scene_from_arrays(own, dataclasses.asdict(ts), device="cpu")
    for k, v in own.items():
        assert torch.equal(getattr(again, k), torch.as_tensor(v)), k


def test_compile_camera_matches():
    w = rt.scenes.glass_and_fog(40, 24)
    tc = tds.compile_camera(w.cameras[0], device="cpu")
    jc = jds.compile_camera(rz.scenes.glass_and_fog(40, 24).cameras[0])
    for f in dataclasses.fields(tc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if isinstance(a, int):
            assert a == b
        else:
            assert np.array_equal(a.numpy(), np.asarray(b)), f.name


def test_import_is_jax_free():
    code = ("import rayzath_tpu_torch, sys; "
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules; "
            "import rayzath_tpu_torch.engine.integrator, "
            "rayzath_tpu_torch.engine.renderer, "
            "rayzath_tpu_torch.models.device_scene, "
            "rayzath_tpu_torch.ops.traverse_cluster, "
            "rayzath_tpu_torch.ops._kernels, rayzath_tpu_torch.utils.parity; "
            "from rayzath_tpu_torch.ops.traverse_cluster import "
            "cluster_closest_inst, cluster_shadow_inst, instance_opacity; "
            "from rayzath_tpu_torch.models.device_scene import "
            "_two_level_arrays; "
            "import rayzath_tpu_torch.ops.texture, rayzath_tpu_torch.ops.intersect, "
            "rayzath_tpu_torch.parallel.train, rayzath_tpu_torch.utils.check_worlds, "
            "rayzath_tpu_torch.ops.rng, rayzath_tpu_torch.ops.reproject, "
            "rayzath_tpu_torch.ops.traverse, rayzath_tpu_torch.utils.cuda_timing, "
            "rayzath_tpu_torch.native, rayzath_tpu_torch.io; "
            "import rayzath_tpu_torch.utils.exceptions, "
            "rayzath_tpu_torch.utils.text, rayzath_tpu_torch.utils.args, "
            "rayzath_tpu_torch.engine.engine, rayzath_tpu_torch.editor, "
            "rayzath_tpu_torch.headless, rayzath_tpu_torch.viewer, "
            "rayzath_tpu_torch.parallel, rayzath_tpu_torch.parallel.mesh, "
            "rayzath_tpu_torch.parallel.distributed, "
            "rayzath_tpu_torch.parallel.scaling, "
            "rayzath_tpu_torch.parallel.dryrun; "
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules and "
            "not any(m == 'rayzath_tpu' or m.startswith('rayzath_tpu.') "
            "for m in sys.modules)")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env,
                   timeout=300)


@pytest.mark.parametrize("case", ["two_level_maps", "two_level_cutout",
                                  "maps", "cutout"])
def test_map_and_cutout_worlds_compile_like_jax(case, numpy_bvh):
    """Texture maps and texture-alpha cutouts on both structures: every
    array of the port scene, among them the atlases, the map tables, the
    block tables, the cutout set and (two-level) the expanded lists, equals
    the JAX scene's."""
    from test_torch_textures import cutout_world
    two_level = case.startswith("two_level")
    if case.endswith("maps"):
        def make(pkg):
            return pkg.scenes.textured_room(8, 8)
    else:
        def make(pkg):
            return cutout_world(pkg, 8)
    js = jds.compile_world(make(rz), two_level=two_level)
    ts = tds.compile_world(make(rt), two_level=two_level, differentiable=True, device="cpu")
    leaves, statics = jax_leaves(js)
    assert_scene_equal(ts, leaves, statics)
    assert ts.two_level == two_level and ts.has_maps
    if case.endswith("maps"):
        assert ts.map_kinds_used == (True,) * 5 and ts.n_cutout == 0
    else:
        assert ts.n_cutout == 2 and ts.cut_pw.shape == (3, 6)
    if two_level:
        assert ts.exp_tri is not None and np.array_equal(
            ts.exp_tri.numpy(), leaves["exp_tri"])


def test_skip_link_and_dense_configs_render_like_the_cluster_path():
    """Both other traversals of the JAX package's config are ported: with
    ``packet_traversal=False`` the render takes the skip-link walk (A17)
    and with ``brute_force_threshold`` above the triangle count
    ``project_closest``/``project_shadow`` (A4), and each draws the cluster
    path's image from the same seed (the same hits; radiance by
    ``images_match``, sample counts equal). The dense path still comes
    first when both are asked for."""
    from rayzath_tpu_torch.engine import integrator as tint
    from rayzath_tpu_torch.ops import traverse as ttw
    from rayzath_tpu_torch.utils.parity import images_match
    w = rt.scenes.cornell_box_nee(8, 8)
    walks = []

    def counted(fn):
        def call(*args, **kwargs):
            walks.append(fn.__name__)
            return fn(*args, **kwargs)
        return call

    out = {}
    saved = tint.bvh_closest, tint.bvh_shadow
    tint.bvh_closest, tint.bvh_shadow = map(counted, saved)
    try:
        for label, kw in (("cluster", {}), ("skip", dict(packet_traversal=False)),
                          ("dense", dict(brute_force_threshold=64)),
                          ("dense first", dict(brute_force_threshold=64,
                                               packet_traversal=False))):
            walks.clear()
            cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3), **kw)
            r = rt.Renderer(w, cfg, seed=4, device="cpu")
            r.render(rpp=3)
            assert tint._dense(cfg, r.scene) == label.startswith("dense")
            assert (walks == ["bvh_closest", "bvh_shadow"] * 3) == (label == "skip")
            out[label] = r.views[id(w.cameras[0])].state.accum.numpy()
    finally:
        tint.bvh_closest, tint.bvh_shadow = saved
    assert ttw.bvh_closest is saved[0]
    for label in ("skip", "dense", "dense first"):
        images_match(out[label], out["cluster"])
    assert np.array_equal(out["dense"], out["dense first"])


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("n", [1, 9, 37, 900])
def test_skip_links_match_jax(monkeypatch, builder, n):
    """``compute_skip_links`` and ``build_aabb_links`` array for array
    against the JAX package's, through each package's C++ builder (skips
    where it cannot be built) and through both NumPy sweeps."""
    from rayzath_tpu.ops import traverse as jtw
    from rayzath_tpu_torch.ops import traverse as ttw
    if builder == "native":
        if not (rt_native.available() and rz_native.get_lib() is not None):
            pytest.skip("the C++ builder is not available here")
    else:
        monkeypatch.setattr(rz_native, "bvh_skip_links", lambda *a: None)
        monkeypatch.setattr(rt_native, "bvh_skip_links", lambda *a: None)
    rng = np.random.default_rng(n)
    lo = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.5, (n, 3)).astype(np.float32)
    lo[: n // 10] = -6.0                  # some primitives span every split
    hi[: n // 10] = 6.0
    bvh = tbvh.build_bvh(lo, hi, leaf_size=8)
    ours = tbvh.compute_skip_links(bvh.node_begin, bvh.node_count, bvh.node_axis)
    ref = jbvh.compute_skip_links(bvh.node_begin, bvh.node_count, bvh.node_axis)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    args = (bvh.node_min, bvh.node_max, bvh.node_count, *ours)
    assert np.array_equal(ttw.build_aabb_links(*args), jtw.build_aabb_links(*args))


@pytest.mark.parametrize("name", ["cornell_box_nee", "mesh_heavy",
                                  "instanced_field"])
def test_compile_world_skip_tables_match(name):
    """``aabb_links``, ``node_begin`` and ``node_count`` of ``compile_world``
    (default builders) equal the JAX scene's: the soup's tables, and on the
    two-level instanced_field the JAX scene's inert placeholders."""
    js = jds.compile_world(getattr(rz.scenes, name)(16, 16))
    ts = tds.compile_world(getattr(rt.scenes, name)(16, 16), device="cpu")
    assert ts.two_level == js.two_level == (name == "instanced_field")
    for f in ("aabb_links", "node_begin", "node_count"):
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    n = ts.node_count.numel()
    assert ts.aabb_links.shape == (8, 8 * n)
    if not ts.two_level:
        assert int(ts.node_count.sum()) == ts.n_triangles
        # the walk's leaf blocks: every triangle in exactly one lane
        ids = ts.leaf_tri.numpy()
        assert np.array_equal(ids, ttw.leaf_table(js.node_begin, js.node_count, 8))
        assert np.array_equal(np.sort(ids[ids >= 0]), np.arange(ts.n_triangles))


@pytest.mark.parametrize("n", [9, 37, 900])
def test_leaf_table_matches_jax_leaf_ids(n):
    """``leaf_table`` against the id group of the JAX walk's ``_leaf_table``
    over the same BVH: row for row where no leaf holds more than the lanes;
    with 4 lanes, a leaf of up to 8 takes two rows, the first equal to the
    JAX row and the second its next 4 triangles."""
    from rayzath_tpu.ops import traverse as jtw
    rng = np.random.default_rng(n)
    lo = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.5, (n, 3)).astype(np.float32)
    bvh = tbvh.build_bvh(lo, hi, leaf_size=8)
    assert bvh.node_count.max() <= 8
    ids = np.arange(n, dtype=np.float32)
    for lanes in (8, 4):
        ref = np.asarray(jtw._leaf_table(jnp.asarray(bvh.node_begin),
                                         jnp.asarray(bvh.node_count), lanes,
                                         [jnp.asarray(ids)]))[:, lanes:]
        ours = ttw.leaf_table(bvh.node_begin, bvh.node_count, lanes)
        first = np.cumsum(np.maximum(-(-bvh.node_count // lanes), 1))
        first -= np.maximum(-(-bvh.node_count // lanes), 1)
        assert ours.dtype == np.int32 and ours.shape[1] == lanes
        assert np.array_equal(ours[first], ref.astype(np.int32))
        big = bvh.node_count > lanes
        assert (big.any() or lanes == 8) and np.array_equal(
            ours[first[big] + 1],
            np.where(np.arange(lanes) < bvh.node_count[big, None] - lanes,
                     bvh.node_begin[big, None] + lanes + np.arange(lanes), -1))
        assert len(ours) == len(bvh.node_count) + int(big.sum())


@pytest.mark.parametrize("n", [1, 37, 900])
def test_bvh_numpy_copy_matches(n):
    rng = np.random.default_rng(n)
    lo = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.5, (n, 3)).astype(np.float32)
    a = tbvh.build_bvh_numpy(lo, hi, leaf_size=8)
    b = jbvh.build_bvh_numpy(lo, hi, leaf_size=8)
    for f in dataclasses.fields(a):
        assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_native_bvh_builder_differs():
    """Records a reference-side fault: the C++ builder accumulates the
    centroid statistics in f64, the NumPy builder in f32, so the JAX
    package's native leaf order differs from the port's NumPy builder on
    the glass_and_fog soup (README claims bit-identity). Skips where the
    C++ builder is not available."""
    geo = jds._soup_geometry(rz.scenes.glass_and_fog(8, 8), 8, None)
    n = geo["n_tri"]
    v0, e1, e2 = geo["tri_v0"][:n], geo["tri_e1"][:n], geo["tri_e2"][:n]
    lo, hi = jbvh.triangle_aabbs(v0, v0 + e1, v0 + e2)
    out = rz_native.bvh_build(lo, hi, 128, jbvh.MAX_DEPTH)
    if out is None:
        pytest.skip("the C++ BVH builder is not available here")
    assert not np.array_equal(out[5], tbvh.build_bvh_numpy(lo, hi, 128).order)


def test_cluster_tables_match(numpy_bvh):
    rng = np.random.default_rng(3)
    v0 = rng.uniform(-4, 4, (700, 3)).astype(np.float32)
    e1 = rng.uniform(-0.35, 0.35, (700, 3)).astype(np.float32)
    e2 = rng.uniform(-0.35, 0.35, (700, 3)).astype(np.float32)
    ours = ttc.build_cluster_tables(v0, e1, e2)
    ref = jtc.build_cluster_tables(v0, e1, e2)
    for a, b in zip(ours, ref):
        assert np.array_equal(a, b)


def test_cluster_opacity_matches():
    rng = np.random.default_rng(4)
    v0 = rng.uniform(-4, 4, (300, 3)).astype(np.float32)
    e1 = rng.uniform(-0.35, 0.35, (300, 3)).astype(np.float32)
    e2 = rng.uniform(-0.35, 0.35, (300, 3)).astype(np.float32)
    box, frames, order, base, count = ttc.build_cluster_tables(v0, e1, e2)
    op_rgb = rng.uniform(0.2, 1.0, (300, 3)).astype(np.float32)
    op_a = rng.uniform(0.2, 1.0, 300).astype(np.float32)
    ours = ttc.cluster_opacity(*map(torch.as_tensor,
                                    (op_rgb, op_a, order, base, count)))
    ref = jtc.cluster_opacity(op_rgb, op_a, order, base, count)
    assert np.array_equal(ours.numpy(), np.asarray(ref))


def _entry_points():
    from rayzath_tpu_torch.engine import state as tstate
    world = rt.scenes.cornell_box(8, 8)
    return {
        "Renderer": (rt.Renderer, lambda: rt.Renderer(world)),
        "compile_world": (tds.compile_world, lambda: tds.compile_world(world)),
        "compile_camera": (tds.compile_camera,
                           lambda: tds.compile_camera(world.cameras[0])),
        "scene_from_arrays": (tds.scene_from_arrays,
                              lambda: tds.scene_from_arrays({}, {})),
        "init_state": (tstate.init_state, lambda: tstate.init_state(4, 4)),
        "state_from_arrays": (tstate.state_from_arrays,
                              lambda: tstate.state_from_arrays({})),
        "load_state": (tstate.load_state,
                       lambda: tstate.load_state("missing.npz")),
    }


@pytest.mark.parametrize("name", ["Renderer", "compile_world", "compile_camera",
                                  "scene_from_arrays", "init_state",
                                  "state_from_arrays", "load_state"])
def test_entry_points_default_to_cuda(name):
    """Every public entry point defaults to the card; without one the
    default raises a RuntimeError naming the device, with no CPU fallback."""
    import inspect
    fn, call = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="'cuda' requested, but no CUDA device"):
        call()
