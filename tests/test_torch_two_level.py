"""The two-level instanced path, port against the JAX package: the host
tables of ``compile_world(two_level=True)``, instanced closest hit (B3) and
instanced shadow (B4), the two-level branches of the integrator and picking.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, and both packages build
their BVHs with their NumPy builders (the ``numpy_bvh`` fixture of
test_torch_host.py). Rules, as in
tests/test_torch_traverse.py, with the f64 Moller-Trumbore reference run
over the expanded world-space (instance, triangle) set:

* hit ids and instance ids equal except on f64-chaotic rays;
* t to rtol 1e-5 (grazing hits: against f64, scaled by 0.01/cos);
* rgba to rtol 1e-5 / atol 1e-6 where alpha >= 1e-4.

The CUDA kernels themselves are compared with the plain versions in
tests/test_torch_gpu.py, which needs a card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu.engine import integrator as jint  # noqa: E402
from rayzath_tpu.engine import state as jstate  # noqa: E402
from rayzath_tpu.models import device_scene as jds  # noqa: E402
from rayzath_tpu.ops import traverse_cluster as jtc  # noqa: E402
from rayzath_tpu.models.mesh import Mesh as JMesh  # noqa: E402
from rayzath_tpu.utils.hostmath import Transform as JTransform  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine import integrator as tint  # noqa: E402
from rayzath_tpu_torch.engine import state as tstate  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import _kernels  # noqa: E402
from rayzath_tpu_torch.ops import traverse_cluster as ttc  # noqa: E402
from rayzath_tpu_torch.models.mesh import Mesh  # noqa: E402
from rayzath_tpu_torch.utils.hostmath import Transform  # noqa: E402
from rayzath_tpu_torch.utils.parity import closest_f64, expand_instances, mt_f64  # noqa: E402

from test_oracle_parity import assert_images_match  # noqa: E402
from test_torch_gpu import stack_rays, stacked_world  # noqa: E402
from test_torch_host import assert_scene_equal, jax_leaves, numpy_bvh  # noqa: E402,F401
from test_torch_render import port_scene  # noqa: E402

# small two-level worlds: instanced_field(n=3, resolution=8) has 48
# triangles and 1 cluster per ball (JAX's direct sweep);
# instanced_field(n=2, resolution=40) 1,520 triangles and 16 clusters per
# ball (JAX's ranked path); multi_light as a two-level scene
WORLDS = {
    "field_direct": lambda pkg, res: pkg.scenes.instanced_field(res, res, n=3,
                                                                resolution=8),
    "field_ranked": lambda pkg, res: pkg.scenes.instanced_field(res, res, n=2,
                                                                resolution=40),
    "multi_light": lambda pkg, res: pkg.scenes.multi_light(res, res),
}


def translucent(world):
    """Every other user material at alpha 0.5, so shadow rays carry
    products of several factors."""
    for m in list(world.materials)[::2]:
        m.color = np.asarray([*m.color[:3], 0.5], np.float32)
    return world


def both_scenes(case, res=16, shade=False):
    jw, tw = WORLDS[case](rz, res), WORLDS[case](rt, res)
    if shade:
        translucent(jw), translucent(tw)
    return (jds.compile_world(jw, two_level=True),
            tds.compile_world(tw, two_level=True, device="cpu"), tw)


def sample_rays(ts, world, res=16, seed=0):
    """Camera rays (u = 0.5) plus as many rays from random origins aimed at
    random points of random expanded triangles."""
    cam = tds.compile_camera(world.cameras[0], device="cpu")
    from rayzath_tpu_torch.ops.camera import generate_rays, pixel_grid
    o, d = generate_rays(cam, pixel_grid(res, res), torch.full((res * res, 4), 0.5))
    v0, e1, e2, _, _ = expand_instances(ts.ti_rows, ts.cl_obox, ts.inst_fwd,
                                        ts.tri_v0, ts.tri_e1, ts.tri_e2)
    rng = np.random.default_rng(seed)
    n = res * res
    k = rng.integers(0, len(v0), n)
    b = rng.uniform(0.0, 0.6, (n, 2))
    p = v0[k] + b[:, :1] * e1[k] + b[:, 1:] * e2[k]
    lo, hi = v0.min(0), v0.max(0)
    oa = rng.uniform(lo - 1.0, hi + 1.0, (n, 3))
    da = (p - oa) / np.linalg.norm(p - oa, axis=1, keepdims=True)
    o = np.concatenate([o.numpy(), oa]).astype(np.float32)
    d = np.concatenate([d.numpy(), da]).astype(np.float32)
    return o, d



def _t(*xs):
    return [torch.as_tensor(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("case", list(WORLDS))
def test_two_level_leaves_match(case, numpy_bvh):
    """Every array of the two-level scene equals JAX's, among them ti_rows,
    cl_obox, cl_lw, cl_slot, tri_pack, inst_fwd, inst_nrm, inst_slot_map."""
    js, ts, _ = both_scenes(case)
    assert js.two_level and ts.two_level
    leaves, statics = jax_leaves(js)
    for name in ("ti_rows", "cl_obox", "cl_lw", "cl_slot", "tri_pack",
                 "inst_fwd", "inst_nrm", "inst_slot_map"):
        assert name in leaves
    assert_scene_equal(ts, leaves, statics)
    assert ts.max_ncl == js.max_ncl == {"field_direct": 1, "field_ranked": 16,
                                        "multi_light": 8}[case]


@pytest.mark.parametrize("case", list(WORLDS))
def test_closest_inst_matches_jax_and_f64(case, numpy_bvh):
    js, ts, world = both_scenes(case)
    o, d = sample_rays(ts, world)
    r = len(o)
    near = np.zeros(r, np.float32)
    far = np.full(r, 1e30, np.float32)
    t, tid, inst = (x.numpy() for x in ttc.cluster_closest_inst(
        *_t(o, d, near, far), ts.ti_rows, ts.cl_obox, ts.cl_lw))
    tj, tidj, instj = (np.asarray(x) for x in jtc.cluster_closest_inst(
        *map(jnp.asarray, (o, d, near, far)), js.ti_box, js.ti_rows,
        js.cl_obox, js.cl_lw, max_ncl=js.max_ncl))
    v0, e1, e2, tri_x, inst_x = expand_instances(
        ts.ti_rows, ts.cl_obox, ts.inst_fwd, ts.tri_v0, ts.tri_e1, ts.tri_e2)
    k, chaotic = closest_f64(o, d, v0, e1, e2, near, far)
    ref_tid = np.where(k >= 0, tri_x[k], -1)
    ref_inst = np.where(k >= 0, inst_x[k], -1)
    safe = ~chaotic
    assert safe.mean() > 0.97, f"chaotic fraction {1 - safe.mean()}"
    for ours, jax_ids, ref in ((tid, tidj, ref_tid), (inst, instj, ref_inst)):
        assert np.array_equal(ours[safe], jax_ids[safe])
        assert np.array_equal(ours[safe], ref[safe])
    hit = np.nonzero(safe & (tid >= 0))[0]
    assert len(hit) > r // 4
    kk = k[hit]
    t64 = mt_f64(o[hit], d[hit], v0[kk], e1[kk], e2[kk])[0]
    t64 = t64[np.arange(len(hit)), np.arange(len(hit))]
    n = np.cross(e1[kk], e2[kk])
    cos = np.abs(np.sum(n * d[hit], 1)) / np.linalg.norm(n, axis=1)
    assert (np.abs(t[hit] - t64) <= 1e-5 * t64 * np.maximum(1.0, 0.01 / cos)).all()
    steep = hit[cos >= 0.01]
    np.testing.assert_allclose(t[steep], tj[steep], rtol=1e-5)


@pytest.mark.parametrize("case", list(WORLDS))
def test_shadow_inst_matches_jax(case, numpy_bvh):
    js, ts, world = both_scenes(case, shade=True)
    assert (ts.mat_color[:, 3] == 0.5).any()
    o, d = sample_rays(ts, world, seed=1)
    dist = np.full(len(o), 30.0, np.float32)
    rgb, a = (x.numpy() for x in ttc.cluster_shadow_inst(
        *_t(o, d, dist), ts.ti_rows, ts.cl_obox, ts.cl_lw, ts.cl_slot,
        ts.inst_slot_map, ts.mat_color))
    rgbj, aj = (np.asarray(x) for x in jtc.cluster_shadow_inst(
        *map(jnp.asarray, (o, d, dist)), js.ti_box, js.ti_rows, js.cl_obox,
        js.cl_lw, js.cl_slot, js.tri_slot, js.inst_slot_map, js.mat_color,
        js.tri_v0, js.tri_e1, js.tri_e2, js.exp_tri, js.exp_inst, js.inst_fwd,
        max_ncl=js.max_ncl))
    v0, e1, e2, _, _ = expand_instances(
        ts.ti_rows, ts.cl_obox, ts.inst_fwd, ts.tri_v0, ts.tri_e1, ts.tri_e2)
    # rays whose f64 hit set is ambiguous may differ by a whole factor
    _, chaotic = closest_f64(o, d, v0, e1, e2, None, dist)
    live = (a >= 1e-4) & ~chaotic
    assert live.mean() > 0.5 and ((a[live] > 0.0) & (a[live] < 1.0)).sum() > 10
    np.testing.assert_allclose(a[live], aj[live], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rgb[live], rgbj[live], rtol=1e-5, atol=1e-6)


def run_both_two_level(case, n_passes=4, max_depth=4, res=24, seed=3):
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=max_depth))
    tcfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=max_depth))
    world = WORLDS[case](rz, res)
    scene = jds.compile_world(world, two_level=True)
    cam = jds.compile_camera(world.cameras[0])
    tscene = port_scene(scene)
    assert tscene.two_level and tscene.max_ncl == scene.max_ncl
    tcam = tds.compile_camera(WORLDS[case](rt, res).cameras[0], device="cpu")
    key = jax.random.key(seed)
    ns = jint.n_streams(cfg, scene)
    assert tint.n_streams(tcfg, tscene) == ns
    js = jstate.init_state(res, res)
    ts = tstate.init_state(res, res, device="cpu")
    for p in range(n_passes):
        k = jax.random.fold_in(key, p)
        u = jint.pass_uniforms(k, 0, res, res, ns)
        js = jint.bounce_step(scene, cam, cfg, js, k)
        ts = tint.bounce_step(tscene, tcam, tcfg, ts,
                              u=torch.as_tensor(np.array(u)))
    return np.asarray(js.accum), ts.accum.numpy(), ts


@pytest.mark.parametrize("case", ["field_direct", "multi_light"])
def test_bounce_two_level_matches_jax(case, numpy_bvh):
    a_jax, a_port, ts = run_both_two_level(case)
    assert ts.pass_idx == 4
    assert_images_match(a_port, a_jax)


def test_two_level_render_matches_soup():
    """The port's two-level render against its own soup render of the same
    world, same seed (JAX test_two_level_render_matches_soup's rule)."""
    world = rt.scenes.instanced_field(32, 32, n=3, resolution=12)
    out = []
    for two_level in (True, False):
        r = rt.Renderer(world, rt.RenderConfig(
            tracing=rt.Tracing(max_depth=3), two_level=two_level), seed=7, device="cpu")
        r.render(rpp=3)
        assert r.scene.two_level == two_level
        out.append(r.views[id(world.cameras[0])].state.accum.numpy())
    assert not np.isnan(out[0]).any()
    assert np.array_equal(out[0][..., 3], out[1][..., 3])
    rel = np.abs(out[0] - out[1]) / (np.abs(out[1]) + 1e-3)
    assert (rel < 1e-3).mean() > 0.999


def test_pick_matches_jax_two_level(numpy_bvh):
    res = 32
    world = rz.scenes.instanced_field(res, res, n=3, resolution=8)
    scene = jds.compile_world(world, two_level=True)
    cam = jds.compile_camera(world.cameras[0])
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=4))
    js = jint.render_steps(scene, cam, cfg, jstate.init_state(res, res),
                           jax.random.key(1), 2)
    arrays = {f.name: np.array(getattr(js, f.name))
              for f in dataclasses.fields(js)}
    ts = tstate.state_from_arrays(arrays, device="cpu")
    tscene = port_scene(scene)
    tcam = tds.compile_camera(rt.scenes.instanced_field(res, res, n=3,
                                                        resolution=8).cameras[0], device="cpu")
    tcfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
    picks = []
    for y in range(2, res, 5):
        for x in range(1, res, 5):
            ji, jm = jint.ray_cast(scene, cam, cfg, js, x, y)
            picks.append(((int(ji), int(jm)),
                          tint.ray_cast(tscene, tcam, tcfg, ts, x, y)))
    assert all(a == b for a, b in picks), picks
    hits = {a[0] for a, _ in picks if a[0] >= 0}
    assert len(hits) >= 3, hits          # the ground and several balls


def test_moving_one_instance_only_moves_it():
    """Editing one instance's transform changes its instance row, not the
    shared mesh cluster frames or the object-space geometry."""
    world = rt.scenes.instanced_field(16, 16, n=3, resolution=8)
    cache = {}
    a = tds.compile_world(world, two_level=True, cache=cache, device="cpu")
    ball = next(i for i in world.instances if i.name.startswith("ball"))
    ball.transform = Transform(position=(0.5, 0.9, -0.5),
                               scale=ball.transform.scale)
    b = tds.compile_world(world, two_level=True, cache=cache, device="cpu")
    assert torch.equal(a.cl_lw, b.cl_lw) and torch.equal(a.tri_v0, b.tri_v0)
    assert torch.equal(a.cl_obox, b.cl_obox)
    changed = (a.ti_rows != b.ti_rows).any(dim=1).nonzero().flatten().tolist()
    assert changed == [world.instances.index_of(ball)]


def test_removed_mesh_evicts_its_cache_entry():
    world = rt.scenes.instanced_field(16, 16, n=3, resolution=8)
    plane = next(i.mesh for i in world.instances if i.name == "ground")
    cache = {}

    def mesh_keys():
        return {k[1] for k in cache if isinstance(k, tuple) and k[0] == "mesh_cl"}

    tds.compile_world(world, two_level=True, cache=cache, device="cpu")
    assert id(plane) in mesh_keys() and len(mesh_keys()) == 2
    world.meshes.destroy(plane)
    s = tds.compile_world(world, two_level=True, cache=cache, device="cpu")
    assert id(plane) not in mesh_keys() and len(mesh_keys()) == 1
    assert int((s.ti_rows[:, ttc.TI_NCL] > 0).sum()) == 9     # the balls


@pytest.mark.parametrize("case", ["instances", "clusters"])
def test_128_row_stack_takes_every_factor(case, numpy_bvh, record_property):
    """Reference fault (ROADMAP C): the JAX instanced walks stop their
    ranked loops one short of the table (k < ip - 1, j < cmp_ - 1), so a
    128-row table whose rows are all feasible for a block loses its last
    ranked row. The port's walk visits every row: a ray through the whole
    stack of 128 layers at alpha 0.01 keeps the analytic 0.99^128 ~ 0.276,
    well above the 1e-4 early stop. JAX's value is recorded, not asserted:
    with 128 instances (Ip = 128) it takes every factor too, because its
    instance table gets 128 more padding lanes (``_pad_ti``); with one mesh
    of exactly 128 clusters it misses one (0.99^127 ~ 0.279)."""
    o, d, dist = stack_rays(case)
    ts = tds.compile_world(stacked_world(case, rt.World, Mesh, Transform),
                           two_level=True, device="cpu")
    rows = int((ts.ti_rows[:, ttc.TI_NCL] > 0).sum())
    assert (rows, ts.max_ncl) == ((128, 1) if case == "instances" else (1, 128))
    rgb, a = ttc.cluster_shadow_inst(*_t(o, d, dist), ts.ti_rows, ts.cl_obox,
                                     ts.cl_lw, ts.cl_slot, ts.inst_slot_map,
                                     ts.mat_color)
    np.testing.assert_allclose(a.numpy(), 0.99 ** 128, rtol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), 1.0, rtol=1e-6)
    js = jds.compile_world(stacked_world(case, rz.World, JMesh, JTransform),
                           two_level=True)
    _, aj = jtc.cluster_shadow_inst(
        *map(jnp.asarray, (o, d, dist)), js.ti_box, js.ti_rows, js.cl_obox,
        js.cl_lw, js.cl_slot, js.tri_slot, js.inst_slot_map, js.mat_color,
        js.tri_v0, js.tri_e1, js.tri_e2, js.exp_tri, js.exp_inst, js.inst_fwd,
        max_ncl=js.max_ncl)
    jax_a = float(np.median(np.asarray(aj)))
    record_property("jax_alpha_median", jax_a)
    print(f"{case}: port alpha {float(a.median()):.6f} (0.99^128 = "
          f"{0.99 ** 128:.6f}), JAX alpha {jax_a:.6f} (0.99^127 = "
          f"{0.99 ** 127:.6f})")


def test_cpu_inst_wrappers_launch_nothing():
    before = (ttc.cluster_closest_inst.launches, ttc.cluster_shadow_inst.launches)
    o, d, dist = stack_rays("instances")
    ts = tds.compile_world(stacked_world("instances", rt.World, Mesh, Transform),
                           two_level=True, device="cpu")
    ttc.cluster_closest_inst(*_t(o, d, np.zeros(128, np.float32), dist),
                             ts.ti_rows, ts.cl_obox, ts.cl_lw)
    ttc.cluster_shadow_inst(*_t(o, d, dist), ts.ti_rows, ts.cl_obox, ts.cl_lw,
                            ts.cl_slot, ts.inst_slot_map, ts.mat_color)
    assert (ttc.cluster_closest_inst.launches,
            ttc.cluster_shadow_inst.launches) == before


@pytest.mark.parametrize("loader", ["real", "raises", "fake_library"])
def test_non_cpu_inst_tensor_never_falls_back(monkeypatch, loader):
    """A tensor off the CPU launches B3/B4 or raises: the plain versions are
    never taken for it."""
    def boom(*a, **k):
        raise AssertionError("plain version taken for a non-CPU tensor")
    monkeypatch.setattr(ttc, "cluster_closest_inst_plain", boom)
    monkeypatch.setattr(ttc, "cluster_shadow_inst_plain", boom)
    if loader == "raises":
        def no_build():
            raise RuntimeError("nvcc not found")
        monkeypatch.setattr(_kernels, "load", no_build)
        err = RuntimeError
    elif loader == "fake_library":
        class Lib:
            def __getattr__(self, name):
                raise AssertionError("kernel launched with non-CUDA pointers")
        monkeypatch.setattr(_kernels, "load", lambda: Lib())
        err = ValueError                   # meta tensors fail the device check
    else:
        err = RuntimeError                 # no CUDA device / no nvcc here
        if torch.cuda.is_available():
            err = ValueError
    ts = tds.compile_world(rt.scenes.instanced_field(8, 8, n=2, resolution=8),
                           two_level=True, device="meta")
    r = 8
    o, d = torch.zeros((r, 3), device="meta"), torch.ones((r, 3), device="meta")
    with pytest.raises(err):
        ttc.cluster_closest_inst(o, d, torch.zeros(r, device="meta"),
                                 torch.ones(r, device="meta"), ts.ti_rows,
                                 ts.cl_obox, ts.cl_lw)
    with pytest.raises(err):
        ttc.cluster_shadow_inst(o, d, torch.ones(r, device="meta"), ts.ti_rows,
                                ts.cl_obox, ts.cl_lw, ts.cl_slot,
                                ts.inst_slot_map, ts.mat_color)
