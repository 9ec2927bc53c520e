"""The port's native (C++) layer (``rayzath_tpu_torch/native``), mirroring
tests/test_native.py, and the defaults it sets.

The native BVH builder and OBJ parser are held to the port's own NumPy
builder and Python parser (the behavioural spec) as the JAX package's are
to theirs, and to the JAX package's native library, output for output.
Then the point of the copy: with no builder patched, the port's default
``compile_world`` equals the JAX package's default one array for array
(both prefer their C++ builder), on glass_and_fog, where the C++ and NumPy
builders part (tests/test_torch_host.py ``test_native_bvh_builder_differs``)
and on mesh_heavy, whose cluster count the NumPy builder's float32
statistics made depend on the numpy build.
"""
import os
import shutil

import numpy as np
import pytest

from rayzath_tpu import native as rz_native
import rayzath_tpu as rz
from rayzath_tpu.io.load_result import LoadResult as JLoadResult
from rayzath_tpu.io.obj import _parse_obj_py as jparse_obj_py
from rayzath_tpu.models import device_scene as jds
from rayzath_tpu.ops.bvh import validate_bvh

import rayzath_tpu_torch as rt
from rayzath_tpu_torch import native
from rayzath_tpu_torch.io.load_result import LoadResult
from rayzath_tpu_torch.io.obj import parse_obj, _parse_obj_py
from rayzath_tpu_torch.models import device_scene as tds
from rayzath_tpu_torch.ops.bvh import FlatBVH, build_bvh, build_bvh_numpy

from test_native import OBJ_TEXT
from test_torch_host import assert_scene_equal, jax_leaves

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library unavailable")


def test_native_available_when_toolchain_present():
    if shutil.which("g++") is None:
        pytest.skip("no g++ in environment")
    assert native.available(), "native library should build with g++ present"
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-3:] == ("rayzath_tpu_torch", "build", "native")


def assert_bvh_equal(a: FlatBVH, b: FlatBVH):
    assert a.n_nodes == b.n_nodes
    for f in ("node_begin", "node_count", "node_axis", "order"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@needs_native
@pytest.mark.parametrize("n,leaf", [(1, 8), (7, 8), (9, 2), (100, 8),
                                    (1000, 8), (5000, 4)])
def test_bvh_native_identical_to_numpy(n, leaf):
    rng = np.random.default_rng(n)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 1.0, (n, 3)).astype(np.float32)
    pmin, pmax = c - h, c + h
    out = native.bvh_build(pmin, pmax, leaf, 31)
    assert out is not None
    bn = FlatBVH(*out)
    bp = build_bvh_numpy(pmin, pmax, leaf_size=leaf)
    validate_bvh(bn, pmin, pmax)
    assert_bvh_equal(bn, bp)
    np.testing.assert_allclose(bn.node_min, bp.node_min)
    np.testing.assert_allclose(bn.node_max, bp.node_max)


@needs_native
def test_bvh_degenerate_identical_centroids():
    # all centroids equal -> median-split fallback path
    n = 40
    pmin = np.zeros((n, 3), np.float32)
    pmax = np.ones((n, 3), np.float32)
    bn = FlatBVH(*native.bvh_build(pmin, pmax, 8, 31))
    bp = build_bvh_numpy(pmin, pmax)
    validate_bvh(bn, pmin, pmax)
    np.testing.assert_array_equal(bn.order, bp.order)
    np.testing.assert_array_equal(bn.node_count, bp.node_count)


@needs_native
def test_bvh_empty():
    bn = FlatBVH(*native.bvh_build(np.zeros((0, 3), np.float32),
                                   np.zeros((0, 3), np.float32), 8, 31))
    assert bn.n_nodes == 1
    assert bn.node_count[0] == 0
    assert build_bvh(np.zeros((0, 3)), np.zeros((0, 3))).order.shape == (0,)


def test_build_bvh_dispatch_matches_numpy():
    # public build_bvh (native when available) must agree with the oracle
    rng = np.random.default_rng(7)
    c = rng.uniform(-5, 5, (321, 3)).astype(np.float32)
    pmin, pmax = c - 0.1, c + 0.1
    a = build_bvh(pmin, pmax)
    b = build_bvh_numpy(pmin, pmax)
    np.testing.assert_array_equal(a.order, b.order)
    np.testing.assert_array_equal(a.node_begin, b.node_begin)


@needs_native
@pytest.mark.parametrize("case", ["random", "glass_and_fog"])
def test_bvh_native_identical_to_jax_native(case):
    """The copied sources build the JAX package's native BVH, bit for bit,
    also where both part from the NumPy builders (glass_and_fog)."""
    if not rz_native.available():
        pytest.skip("the JAX package's native library is unavailable")
    if case == "random":
        rng = np.random.default_rng(3)
        c = rng.uniform(-10, 10, (3000, 3)).astype(np.float32)
        pmin, pmax = c - 0.3, c + 0.3
    else:
        geo = jds._soup_geometry(rz.scenes.glass_and_fog(8, 8), 8, None)
        n = geo["n_tri"]
        v0, e1, e2 = geo["tri_v0"][:n], geo["tri_e1"][:n], geo["tri_e2"][:n]
        pts = np.stack([v0, v0 + e1, v0 + e2])
        pmin, pmax = pts.min(0), pts.max(0)
    for leaf in (8, 128):
        a = native.bvh_build(pmin, pmax, leaf, 31)
        b = rz_native.bvh_build(pmin, pmax, leaf, 31)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _both_parse(tmp_path, text):
    p = tmp_path / "scene.obj"
    p.write_text(text)
    rn, rp = LoadResult(), LoadResult()
    mn, ln = parse_obj(str(p), rn)          # dispatches to native
    mp, lp = _parse_obj_py(str(p), rp)      # spec
    return (mn, ln, rn), (mp, lp, rp), p


@needs_native
def test_obj_native_identical_to_python(tmp_path):
    (mn, ln, rn), (mp, lp, rp), p = _both_parse(tmp_path, OBJ_TEXT)
    assert ln == lp
    assert len(mn) == len(mp) == 2
    rj = JLoadResult()
    mj, lj = jparse_obj_py(str(p), rj)      # and the JAX package's spec
    assert lj == lp and len(mj) == 2
    for a, b, c in zip(mn, mp, mj):
        assert a.mesh.name == b.mesh.name == c.mesh.name
        assert a.material_slots == b.material_slots == c.material_slots
        for f in ("vertices", "texcrds", "normals",
                  "tri_v", "tri_t", "tri_n", "tri_mat"):
            np.testing.assert_array_equal(getattr(a.mesh, f),
                                          getattr(b.mesh, f), err_msg=f)
            np.testing.assert_array_equal(getattr(b.mesh, f),
                                          getattr(c.mesh, f), err_msg=f)
    # same number of diagnostics (native formats match the python messages)
    assert len(rn.errors) == len(rp.errors) == len(rj.errors)
    assert len(rn.warnings) == len(rp.warnings) == len(rj.warnings)


@needs_native
def test_obj_native_statement_before_object(tmp_path):
    (mn, _, rn), (mp, _, rp), _ = _both_parse(
        tmp_path, "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\no late\nf 1 2 3\n")
    assert len(mn) == len(mp) == 1
    np.testing.assert_array_equal(mn[0].mesh.tri_v, mp[0].mesh.tri_v)
    np.testing.assert_array_equal(mn[0].mesh.vertices, mp[0].mesh.vertices)
    assert len(rn.warnings) == len(rp.warnings) == 1


def test_rz_native_env_disables(monkeypatch):
    # RZ_NATIVE=0 forces the fallback without breaking anything
    monkeypatch.setenv("RZ_NATIVE", "0")
    assert native.get_lib() is None and not native.available()
    assert native.bvh_build(np.zeros((4, 3), np.float32),
                            np.ones((4, 3), np.float32), 8, 31) is None
    pmin = np.zeros((4, 3), np.float32)
    pmax = np.ones((4, 3), np.float32)
    b = build_bvh(pmin, pmax)   # falls back to numpy
    validate_bvh(b, pmin, pmax)


@pytest.mark.parametrize("name", ["glass_and_fog", "mesh_heavy"])
def test_default_compile_world_matches_jax(name):
    """No builder patched: both packages take their default builder (the
    C++ one wherever it builds) and compile the same arrays."""
    if native.available() != rz_native.available():
        pytest.skip("only one package's native library is available")
    js = jds.compile_world(getattr(rz.scenes, name)(8, 8))
    ts = tds.compile_world(getattr(rt.scenes, name)(8, 8), device="cpu")
    assert_scene_equal(ts, *jax_leaves(js))
    assert ts.n_clusters == js.n_clusters


def test_native_sources_are_the_jax_packages():
    """The port keeps copies of the JAX package's C++ sources: equal but
    for the header comment that names the package."""
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    for name in ("bvh.cpp", "obj.cpp"):
        with open(os.path.join(repo, "rayzath_tpu", "native", "src", name)) as f:
            ref = f.read().splitlines()
        with open(os.path.join(repo, "rayzath_tpu_torch", "native", "src",
                               name)) as f:
            ours = f.read().splitlines()
        # the first comment block differs (1 line there, 3 here)
        assert ours[3:] == ref[1:], name
