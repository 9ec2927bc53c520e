"""The B2 and B4 backwards (``torch.autograd.Function``s around
``cluster_shadow`` / ``cluster_shadow_inst``) against the JAX package's
custom_vjp rules and against autograd through the plain twins.

* Operator level: the port's vector-Jacobian products for every
  differentiable input against ``jax.vjp`` of the JAX entry points (for the
  rays and the triangles both are exactly zero: each factor of the product
  is a constant opacity, and the geometry only decides which factors
  enter), on a
  random translucent soup (B2) and on translucent two-level worlds (B4),
  with the cotangent zeroed where the shadow rules of the forward tests
  skip a ray: where an f64 Moller-Trumbore calls it chaotic (its hit set
  may legitimately differ, and with it a whole factor) and where its alpha
  is below 1e-4 (an opaque hit; the integrator scales rgb by alpha, so
  what else it hits never reaches the image).
* Against the plain twins: autograd through ``cluster_shadow_plain`` /
  ``cluster_shadow_inst_plain`` (their opacity tables built
  differentiably) gives the Function's gradients for the rays and the
  opacities.
* End to end: ``jax.grad`` of the image loss at 64^2 on ``lit_world``,
  where the blocker's alpha reaches the loss only through B2's backward,
  and on ``lit_world`` compiled two-level, where ``mat_color`` reaches it
  through B4's.

Tolerance: rtol 1e-3 of each gradient's max |g| (tests/test_torch_gradients.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu.models import device_scene as jds  # noqa: E402
from rayzath_tpu.ops import traverse_cluster as jtc  # noqa: E402

from rayzath_tpu_torch.ops import traverse_cluster as ttc  # noqa: E402
from rayzath_tpu_torch.utils import check_tables  # noqa: E402
from rayzath_tpu_torch.utils.parity import closest_f64, expand_instances  # noqa: E402

from test_torch_gradients import (assert_grads_match, both_grads,  # noqa: E402
                                  exact_gathers, lit_world)  # noqa: F401
from test_torch_render import port_scene  # noqa: E402
from test_torch_traverse import aimed_rays, make_soup  # noqa: E402
from test_torch_two_level import WORLDS, sample_rays, translucent  # noqa: E402

RTOL = 1e-3


def assert_close_rel(got, ref, name, rtol=RTOL):
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(np.asarray(got) - np.asarray(ref)).max() / scale
    assert err <= rtol, f"{name}: max |dg| / max |g| = {err:.3e}"


def soup_case(n=300, r=512):
    v0, e1, e2 = make_soup(n, seed=7)
    tabs = ttc.build_cluster_tables(v0, e1, e2)
    rng = np.random.default_rng(8)
    op_rgb = rng.uniform(0.3, 1.0, (n, 3)).astype(np.float32)
    op_a = rng.uniform(0.4, 1.0, n).astype(np.float32)
    op_a[::5] = 0.0                                  # opaque: factors of exactly 0
    o, d = aimed_rays(v0, e1, e2, r, seed=9)
    dist = np.full(r, 8.0, np.float32)
    _, chaotic = closest_f64(o, d, v0, e1, e2, None, dist)
    _, a = ttc.cluster_shadow(*map(torch.as_tensor, (o, d, dist, *tabs, op_rgb, op_a)))
    return ((o, d, dist, v0, e1, e2, op_rgb, op_a), tabs,
            cotangents(chaotic | (a.numpy() < 1e-4), rng))


def cotangents(skip, rng):
    """Random cotangents (rgb [R,3], a [R]), zero on the rays ``skip``."""
    g_rgb = rng.normal(size=(len(skip), 3)).astype(np.float32)
    g_a = rng.normal(size=len(skip)).astype(np.float32)
    g_rgb[skip], g_a[skip] = 0.0, 0.0
    return g_rgb, g_a


def _leaves(*xs):
    return [torch.as_tensor(np.ascontiguousarray(x)).requires_grad_(True) for x in xs]


def test_b2_backward_matches_jax_vjp():
    (o, d, dist, v0, e1, e2, op_rgb, op_a), tabs, (g_rgb, g_a) = soup_case()
    n_real = int((tabs[4] > 0).sum())

    def jf(o, d, v0, e1, e2, op_rgb, op_a):
        return jtc.cluster_shadow(o, d, jnp.asarray(dist), *map(jnp.asarray, tabs),
                                  v0, e1, e2, op_rgb, op_a, n_real=n_real)

    _, vjp = jax.vjp(jf, *map(jnp.asarray, (o, d, v0, e1, e2, op_rgb, op_a)))
    ref = vjp((jnp.asarray(g_rgb), jnp.asarray(g_a)))
    xs = _leaves(o, d, v0, e1, e2, op_rgb, op_a)
    rgb, a = ttc.cluster_shadow(xs[0], xs[1], torch.as_tensor(dist),
                                *map(torch.as_tensor, tabs), xs[5], xs[6],
                                tris=tuple(xs[2:5]))
    assert a.grad_fn is not None
    got = torch.autograd.grad((rgb, a), xs, (torch.as_tensor(g_rgb),
                                             torch.as_tensor(g_a)),
                              allow_unused=True, materialize_grads=True)
    names = ("origin", "direction", "tri_v0", "tri_e1", "tri_e2", "op_rgb", "op_a")
    for name, g, gj in zip(names, got, ref):
        assert_close_rel(g.numpy(), gj, name)
    assert np.abs(got[6].numpy()).max() > 0


def test_opaque_factor_passes_gradient():
    """A ray through an opaque triangle (factor exactly 0) and a translucent
    one (0.5): alpha is 0, its gradient is 0.5 for the opaque factor and 0
    for the other, with no division by a zero factor."""
    v0 = np.array([[-1, -1, 1], [-1, -1, 2]], np.float32)
    e1 = np.array([[3, 0, 0], [3, 0, 0]], np.float32)
    e2 = np.array([[0, 3, 0], [0, 3, 0]], np.float32)
    tabs = map(torch.as_tensor, ttc.build_cluster_tables(v0, e1, e2))
    op_rgb = torch.ones((2, 3), requires_grad=True)
    op_a = torch.tensor([0.0, 0.5], requires_grad=True)
    _, a = ttc.cluster_shadow(torch.tensor([[0.1, 0.2, 0.0]]),
                                torch.tensor([[0.0, 0.0, 1.0]]),
                                torch.tensor([10.0]), *tabs, op_rgb, op_a,
                                tris=tuple(map(torch.as_tensor, (v0, e1, e2))))
    assert float(a.detach()) == 0.0
    g, = torch.autograd.grad(a.sum(), op_a)
    assert g.tolist() == [0.5, 0.0]


@pytest.mark.parametrize("case", ["field_ranked", "multi_light"])
def test_b4_backward_matches_jax_vjp(case):
    jw, tw = translucent(WORLDS[case](rz, 16)), translucent(WORLDS[case](
        __import__("rayzath_tpu_torch"), 16))
    js = jds.compile_world(jw, two_level=True)
    ts = port_scene(js)
    assert ts.exp_tri is not None
    o, d = sample_rays(ts, tw, seed=2)
    r = len(o)
    dist = np.full(r, 30.0, np.float32)
    v0, e1, e2, _, _ = expand_instances(ts.ti_rows, ts.cl_obox, ts.inst_fwd,
                                        ts.tri_v0, ts.tri_e1, ts.tri_e2)
    _, chaotic = closest_f64(o, d, v0, e1, e2, None, dist)
    _, a = ttc.cluster_shadow_inst(*map(torch.as_tensor, (o, d, dist)), ts.ti_rows,
                                   ts.cl_obox, ts.cl_lw, ts.cl_slot,
                                   ts.inst_slot_map, ts.mat_color)
    g_rgb, g_a = cotangents(chaotic | (a.numpy() < 1e-4), np.random.default_rng(3))

    def jf(o, d, tv0, te1, te2, mc):
        return jtc.cluster_shadow_inst(
            o, d, jnp.asarray(dist), js.ti_box, js.ti_rows, js.cl_obox,
            js.cl_lw, js.cl_slot, js.tri_slot, js.inst_slot_map, mc,
            tv0, te1, te2, js.exp_tri, js.exp_inst, js.inst_fwd,
            max_ncl=js.max_ncl)

    _, vjp = jax.vjp(jf, jnp.asarray(o), jnp.asarray(d), js.tri_v0, js.tri_e1,
                     js.tri_e2, js.mat_color)
    ref = vjp((jnp.asarray(g_rgb), jnp.asarray(g_a)))
    xs = _leaves(o, d, ts.tri_v0, ts.tri_e1, ts.tri_e2, ts.mat_color)
    rgb, a = ttc.cluster_shadow_inst(
        xs[0], xs[1], torch.as_tensor(dist), ts.ti_rows, ts.cl_obox, ts.cl_lw,
        ts.cl_slot, ts.inst_slot_map, xs[5], tris=tuple(xs[2:5]),
        expanded=(ts.tri_slot, ts.exp_tri, ts.exp_inst, ts.inst_fwd))
    got = torch.autograd.grad((rgb, a), xs, (torch.as_tensor(g_rgb),
                                             torch.as_tensor(g_a)),
                              allow_unused=True, materialize_grads=True)
    for name, g, gj in zip(("origin", "direction", "tri_v0", "tri_e1",
                            "tri_e2", "mat_color"), got, ref):
        assert_close_rel(g.numpy(), gj, name)
    assert np.abs(got[5].numpy()).max() > 0


@pytest.mark.parametrize("kind", ["b2", "b4"])
def test_backward_matches_plain_twin_autograd(kind):
    """The Function's gradients for the rays and the opacities equal
    autograd through the plain twin (which differentiates its own per-cluster
    products)."""
    if kind == "b2":
        (o, d, dist, v0, e1, e2, op_rgb, op_a), tabs, (g_rgb, g_a) = soup_case(r=256)
        box, frames, order, base, count = map(torch.as_tensor, tabs)
        xs = _leaves(o, d, op_rgb, op_a)
        fn = ttc.cluster_shadow(xs[0], xs[1], torch.as_tensor(dist), box, frames,
                                order, base, count, xs[2], xs[3],
                                tris=tuple(map(torch.as_tensor, (v0, e1, e2))))
        ys = _leaves(o, d, op_rgb, op_a)
        plain = ttc.cluster_shadow_plain(
            ys[0], ys[1], torch.as_tensor(dist), box, frames,
            ttc.cluster_opacity(ys[2], ys[3], order, base, count))
    else:
        tw = translucent(WORLDS["field_ranked"](__import__("rayzath_tpu_torch"), 16))
        from rayzath_tpu_torch.models import device_scene as tds
        ts = tds.compile_world(tw, two_level=True, differentiable=True, device="cpu")
        o, d = sample_rays(ts, tw, seed=4)
        r = len(o)
        dist = torch.full((r,), 30.0)
        v0, e1, e2, _, _ = expand_instances(ts.ti_rows, ts.cl_obox, ts.inst_fwd,
                                            ts.tri_v0, ts.tri_e1, ts.tri_e2)
        _, chaotic = closest_f64(o, d, v0, e1, e2, None, dist.numpy())
        tabs = (ts.ti_rows, ts.cl_obox, ts.cl_lw)
        _, a = ttc.cluster_shadow_inst(*map(torch.as_tensor, (o, d)), dist, *tabs,
                                       ts.cl_slot, ts.inst_slot_map, ts.mat_color)
        g_rgb, g_a = cotangents(chaotic | (a.numpy() < 1e-4),
                                np.random.default_rng(5))
        xs = _leaves(o, d, ts.mat_color)
        fn = ttc.cluster_shadow_inst(
            xs[0], xs[1], dist, *tabs, ts.cl_slot, ts.inst_slot_map, xs[2],
            tris=(ts.tri_v0, ts.tri_e1, ts.tri_e2),
            expanded=(ts.tri_slot, ts.exp_tri, ts.exp_inst, ts.inst_fwd))
        ys = _leaves(o, d, ts.mat_color)
        plain = ttc.cluster_shadow_inst_plain(
            ys[0], ys[1], dist, *tabs, ts.cl_slot,
            ttc.instance_opacity(ys[2], ts.inst_slot_map))
    for out_f, out_p in zip(fn, plain):
        np.testing.assert_allclose(out_f.detach().numpy(), out_p.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    g = (torch.as_tensor(g_rgb), torch.as_tensor(g_a))
    got = torch.autograd.grad(fn, xs, g, allow_unused=True, materialize_grads=True)
    ref = torch.autograd.grad(plain, ys, g, allow_unused=True, materialize_grads=True)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert_close_rel(a.numpy(), b.numpy(), f"input {i}")


def test_alpha_grad_through_b2_at_64px(exact_gathers):
    """tests/test_gradients.py's 64^2 lit_world (2 passes, depth 2): all ten
    parameters against jax.grad; the blocker's alpha gets its gradient
    from B2's backward alone."""
    jl, jg, tl, tg = both_grads(lambda pkg: lit_world(pkg, 64), n_steps=2,
                                max_depth=2, seed=4)
    assert tl == pytest.approx(jl, rel=1e-5)
    assert_grads_match(jg, tg, expect=("mat_color", "spot_emission"))
    bi = 3                                  # world, default, floor, blocker
    assert abs(tg["mat_color"][bi, 3]) > 1e-6 * np.abs(tg["mat_color"]).max()


def test_two_level_grads_match_jax(exact_gathers):
    """lit_world compiled two-level: mat_color's shadow gradient goes
    through B4's backward over the expanded (instance, triangle) set."""
    jl, jg, tl, tg = both_grads(lit_world, n_steps=3, max_depth=3, seed=3,
                                two_level=True)
    assert tl == pytest.approx(jl, rel=1e-5)
    assert_grads_match(jg, tg, expect=("mat_color", "mat_roughness",
                                       "spot_emission", "dir_emission"))


# ---------------------------------------------------------------------------
# B2-grad and B4-grad: the Functions' backwards (their plain versions here)
# against the dense replay and jax.vjp, and the cases of zero factors
# ---------------------------------------------------------------------------

def _mat_op(mc, tri_mat):
    """(op_rgb, op_a) of a soup's triangles from a material table, as the
    integrator forms them."""
    mat = mc[tri_mat]
    return mat[:, :3], 1.0 - mat[:, 3]


def _port_and_replay_grads(ts, o, d, dist, g):
    """The mat_color gradient of the cotangents ``g`` through the port's
    shadow Function (B2 on a soup scene, B4 on a two-level one) and through
    the dense replay of the JAX package's backward rule."""
    mc = ts.mat_color.clone().requires_grad_(True)
    mc_r = ts.mat_color.clone().requires_grad_(True)
    tris = (ts.tri_v0, ts.tri_e1, ts.tri_e2)
    tri_mat = ts.tri_mat.long()
    if ts.two_level:
        expanded = (ts.tri_slot, ts.exp_tri, ts.exp_inst, ts.inst_fwd)
        fn = ttc.cluster_shadow_inst(o, d, dist, ts.ti_rows, ts.cl_obox,
                                     ts.cl_lw, ts.cl_slot, ts.inst_slot_map,
                                     mc, tris=tris, expanded=expanded)
        ref = check_tables.inst_replay(*expanded, ts.inst_slot_map, o, d,
                                       dist, *tris, mc_r)
    else:
        fn = ttc.cluster_shadow(o, d, dist, ts.cl_box, ts.cl_lw, ts.cl_order,
                                ts.cl_base, ts.cl_count, *_mat_op(mc, tri_mat),
                                tris=tris)
        ref = check_tables.soup_replay(o, d, dist, *tris,
                                      *_mat_op(mc_r, tri_mat))
    got, = torch.autograd.grad(fn, mc, g)
    want, = torch.autograd.grad(ref, mc_r, g)
    return fn[1].detach(), got.numpy(), want.numpy()


@pytest.mark.parametrize("kind,case", [("b2", "multi_light"),
                                       ("b4", "field_ranked"),
                                       ("b4", "multi_light")])
def test_function_grads_match_dense_replay_and_jax(kind, case):
    """mat_color gradients of the B2 / B4 Functions (B2-grad / B4-grad's
    plain versions: two walks of the cluster tables, no alpha stop) against
    autograd through the dense replay (``check_tables.soup_replay`` /
    ``inst_replay``)
    and ``jax.vjp`` of the JAX entry points, on translucent worlds; the
    cotangent is zero only on f64-chaotic rays, so blocked rays (alpha below
    1e-4) and the products behind opaque hits count too."""
    two_level = kind == "b4"
    jw = translucent(WORLDS[case](rz, 16))
    tw = translucent(WORLDS[case](__import__("rayzath_tpu_torch"), 16))
    js = jds.compile_world(jw, two_level=two_level)
    ts = port_scene(js)
    if two_level:
        o, d = sample_rays(ts, tw, seed=6)
        v0, e1, e2, _, _ = expand_instances(ts.ti_rows, ts.cl_obox, ts.inst_fwd,
                                            ts.tri_v0, ts.tri_e1, ts.tri_e2)
    else:
        n = ts.n_triangles
        v0, e1, e2 = (x[:n].numpy() for x in (ts.tri_v0, ts.tri_e1, ts.tri_e2))
        o, d = aimed_rays(v0, e1, e2, 512, seed=6)
    r = len(o)
    dist = np.full(r, 30.0, np.float32)
    _, chaotic = closest_f64(o, d, v0, e1, e2, None, dist)
    g_rgb, g_a = cotangents(chaotic, np.random.default_rng(7))
    g = (torch.as_tensor(g_rgb), torch.as_tensor(g_a))
    a, got, want = _port_and_replay_grads(ts, *map(torch.as_tensor, (o, d, dist)), g)
    assert_close_rel(got, want, f"{kind} {case}: Function against the replay")
    assert int(((a < 1e-4).numpy() & ~chaotic).sum()) > 0     # blocked rays count
    assert np.abs(got).max() > 0

    if two_level:
        def jf(mc):
            return jtc.cluster_shadow_inst(
                jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist), js.ti_box,
                js.ti_rows, js.cl_obox, js.cl_lw, js.cl_slot, js.tri_slot,
                js.inst_slot_map, mc, js.tri_v0, js.tri_e1, js.tri_e2,
                js.exp_tri, js.exp_inst, js.inst_fwd, max_ncl=js.max_ncl)
    else:
        def jf(mc):
            return jtc.cluster_shadow(
                jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist), js.cl_box,
                js.cl_lw, js.cl_order, js.cl_base, js.cl_count, js.tri_v0,
                js.tri_e1, js.tri_e2, *_mat_op(mc, js.tri_mat),
                n_real=js.n_clusters)

    _, vjp = jax.vjp(jf, js.mat_color)
    ref, = vjp((jnp.asarray(g_rgb), jnp.asarray(g_a)))
    assert_close_rel(got, np.asarray(ref), f"{kind} {case}: Function against jax.vjp")


def layer_scene(alphas, two_level):
    """Quads 2 wide at z = 1, 2, ..., one instance each, of materials of
    colour (0.9, 0.7, 0.5) and the given alphas (1 - alpha is the factor),
    compiled as a soup (B2) or two-level (B4) scene on the CPU; and the
    material index of each layer."""
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.models import device_scene as tds
    from rayzath_tpu_torch.models.mesh import Mesh
    from rayzath_tpu_torch.utils.hostmath import Transform
    w = rt.World()
    verts = np.asarray([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                       np.float32)
    mesh = w.meshes.create(Mesh("quad", vertices=verts,
                                tri_v=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)))
    for i, a in enumerate(alphas):
        m = w.create_material(f"layer {i}", color=(0.9, 0.7, 0.5, a))
        w.create_instance(name=f"layer {i}", mesh=mesh, materials=[m],
                          transform=Transform(position=(0.0, 0.0, 1.0 + i)))
    names = [m.name for m in w.materials]
    scene = tds.compile_world(w, two_level=two_level,
                              differentiable=two_level, device="cpu")
    return scene, [names.index(f"layer {i}") + 2 for i in range(len(alphas))]


@pytest.mark.parametrize("kind", ["b2", "b4"])
@pytest.mark.parametrize("case,alphas,want", [
    # one opaque hit (factor 0) before a translucent one (0.5): the opaque
    # factor's gradient is the other factor, the translucent one's is 0
    ("opaque+translucent", (1.0, 0.5), (-0.5, 0.0)),
    # two opaque hits: each one's gradient is the other factor, 0
    ("two opaque", (1.0, 1.0), (0.0, 0.0)),
    # three factors of 0.01: alpha 1e-6, below the forward's 1e-4 stop, and
    # each factor's gradient the product of the other two, 1e-4
    ("below the stop", (0.99, 0.99, 0.99), (-1e-4, -1e-4, -1e-4))])
def test_zero_factors_and_no_stop(kind, case, alphas, want):
    """A ray through stacked layers: d alpha_out / d alpha_material of each
    layer (the mat_color alpha column) from the Function's backward equals
    the product of the other factors, without a division by a zero factor
    and without the alpha stop, and equals the dense replay's."""
    scene, mats = layer_scene(alphas, kind == "b4")
    o = torch.tensor([[0.1, 0.2, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    dist = torch.tensor([100.0])
    g = (torch.zeros(1, 3), torch.ones(1))
    a, got, replay = _port_and_replay_grads(scene, o, d, dist, g)
    ref_a = np.prod([np.float32(1.0) - np.float32(x) for x in alphas])
    np.testing.assert_allclose(float(a), ref_a, rtol=1e-5)
    np.testing.assert_allclose(got[mats, 3], want, rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(got, replay, rtol=1e-5, atol=1e-12)
    if case == "below the stop":
        assert float(a) < 1e-4 and np.abs(got[mats, 3]).min() > 9e-5
