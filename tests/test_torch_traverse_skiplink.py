"""The skip-link BVH walk (``packet_traversal=False``): the port's
``ops/traverse.py`` against ``rayzath_tpu/ops/traverse.py``.

Both walks run on the CPU over the same tables (the port's host tables
equal the JAX package's array for array, tests/test_torch_host.py), from
numpy seeds, on a random soup and on glass_and_fog's soup, with random
rays and grazing rays. Rules, those of tests/test_torch_traverse.py:

* hit ids are equal except on rays an f64 Moller-Trumbore calls chaotic (a
  tie, an edge, a near miss, a candidate at the window's ends) or grazing
  (incidence cos < 0.01 at its hit), and equal the f64 ids there too;
* t agrees with the f64 t to rtol 1e-5 x max(1, 0.1 / cos) on those
  hits (float32 rounding in t grows as 1 / cos: both walks stay within
  3.5e-7 / cos), and with the JAX t to rtol 1e-5 where cos >= 0.1;
* shadow rgba agrees to rtol 1e-5 (atol 1e-6) where alpha >= 1e-4, on rays
  with no f64 candidate within rounding of an edge or of the (0, dist)
  window.

The JAX walk gives a leaf ``leaf_size`` lanes and never tests a leaf's
triangles past them, while the builder makes larger leaves (ROADMAP C);
the port walks such a leaf in blocks of ``leaf_size``. So the JAX walk is
run with lanes for the largest leaf (its ``leaf_size`` argument, the BVH
unchanged), where it tests every triangle, and
:func:`test_reference_walk_drops_lanes_past_the_leaf_size` pins what it
does with the default 8.
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
from rayzath_tpu.models.device_scene import compile_world, compile_camera  # noqa: E402
from rayzath_tpu.ops import traverse as jtw  # noqa: E402
from rayzath_tpu.parallel import train as jtrain  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine import integrator as tint  # noqa: E402
from rayzath_tpu_torch.engine.state import init_state  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import bvh as tbvh  # noqa: E402
from rayzath_tpu_torch.ops import traverse as ttw  # noqa: E402
from rayzath_tpu_torch.parallel import train as ttrain  # noqa: E402
from rayzath_tpu_torch.utils.parity import EPS_B, closest_f64, mt_f64  # noqa: E402

from test_oracle_parity import assert_images_match  # noqa: E402
from test_torch_gradients import (DIFF_PARAMS, assert_grads_match,  # noqa: E402
                                  exact_gathers, lit_world, tiny_world)  # noqa: F401
from test_torch_render import port_scene  # noqa: E402
from test_torch_textures import cutout_world  # noqa: E402
from test_torch_traverse import aimed_rays, make_soup  # noqa: E402


@dataclasses.dataclass
class Soup:
    """A world-space soup in BVH leaf order with its skip-link tables."""
    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    links: np.ndarray
    node_begin: np.ndarray
    node_count: np.ndarray

    @property
    def walk(self):
        """The JAX walk's tables."""
        return (self.links, self.node_begin, self.node_count, self.v0,
                self.e1, self.e2)

    def port_walk(self, lanes=8):
        """The port walk's tables, its leaf blocks of ``lanes`` lanes."""
        return (self.links, self.node_count,
                ttw.leaf_table(self.node_begin, self.node_count, lanes),
                self.v0, self.e1, self.e2)

    @property
    def lanes(self) -> int:
        """The JAX walk's lanes that cover the largest leaf (a power of
        two, at least 8)."""
        return max(8, 1 << int(np.ceil(np.log2(max(self.node_count.max(), 1)))))


def random_soup(n, seed, leaf_size=8) -> Soup:
    v0, e1, e2 = make_soup(n, seed=seed)
    lo, hi = tbvh.triangle_aabbs(v0, v0 + e1, v0 + e2)
    bvh = tbvh.build_bvh(lo, hi, leaf_size)
    o = bvh.order
    first8, skip8 = tbvh.compute_skip_links(bvh.node_begin, bvh.node_count,
                                            bvh.node_axis)
    links = ttw.build_aabb_links(bvh.node_min, bvh.node_max, bvh.node_count,
                                 first8, skip8)
    return Soup(v0[o], e1[o], e2[o], links, bvh.node_begin, bvh.node_count)


def scene_soup(world) -> Soup:
    s = tds.compile_world(world, device="cpu")
    n = s.n_triangles
    return Soup(*(x[:n].numpy() for x in (s.tri_v0, s.tri_e1, s.tri_e2)),
                s.aabb_links.numpy(), s.node_begin.numpy(), s.node_count.numpy())


SOUPS = {"soup": lambda: random_soup(700, 0),
         "small mesh": lambda: random_soup(5, 2),
         "glass_and_fog": lambda: scene_soup(rt.scenes.glass_and_fog(16, 16))}


def grazing_rays(soup: Soup, r, seed):
    """Rays that meet a random point of a random triangle at incidence cos
    in (0.002, 0.03), from 1 to 3 units away."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, len(soup.v0), r)
    b = rng.uniform(0.1, 0.45, (r, 2)).astype(np.float32)
    p = soup.v0[k] + b[:, :1] * soup.e1[k] + b[:, 1:] * soup.e2[k]
    n = np.cross(soup.e1[k], soup.e2[k])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    tan = np.cross(n, rng.normal(size=(r, 3)))
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    c = rng.uniform(0.002, 0.03, r)[:, None] * np.where(rng.random((r, 1)) < 0.5, 1, -1)
    d = tan * np.sqrt(1 - c * c) + n * c
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = (p - d * rng.uniform(1.0, 3.0, (r, 1))).astype(np.float32)
    return o, d


def ray_set(soup: Soup, kind: str, r=512):
    if kind == "random":
        return aimed_rays(soup.v0, soup.e1, soup.e2, r, seed=11)
    return grazing_rays(soup, r, seed=12)


def _np(*xs):
    return [np.ascontiguousarray(x) for x in xs]


def port_closest(soup, o, d, near, far):
    return ttw.bvh_closest(*map(torch.as_tensor,
                                _np(o, d, near, far, *soup.port_walk())))


def jax_closest(soup, o, d, near, far, lanes):
    return jtw.bvh_closest(*map(jnp.asarray, _np(o, d, near, far, *soup.walk)),
                           leaf_size=lanes)


def port_shadow(soup, o, d, dist, op_rgb, op_a):
    return ttw.bvh_shadow(*map(torch.as_tensor, _np(o, d, dist, *soup.port_walk(),
                                                    op_rgb, op_a)))


def jax_shadow(soup, o, d, dist, op_rgb, op_a, lanes):
    return jtw.bvh_shadow(*map(jnp.asarray, _np(o, d, dist, *soup.walk,
                                                op_rgb, op_a)), leaf_size=lanes)


def exempt_closest(soup, o, d, near, far, chunk=128):
    """(f64 ids, rays exempt from the id rule, grazing rays): exempt are
    the chaotic rays and the grazing ones, which pass within 0.01 (in
    barycentrics) of a triangle they meet at cos < 0.01 inside the window
    (there float32 rounding, and the DET_EPS nudge of a determinant near
    0, decide the hit)."""
    ref, chaotic = closest_f64(o, d, soup.v0, soup.e1, soup.e2, near, far)
    n = np.cross(soup.e1, soup.e2).astype(np.float64)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)
    grazing = np.zeros(len(o), bool)
    for s in range(0, len(o), chunk):
        sl = slice(s, s + chunk)
        t, b1, b2, _ = mt_f64(o[sl], d[sl], soup.v0, soup.e1, soup.e2)
        cos = np.abs(np.asarray(d[sl], np.float64) @ n.T)
        meets = ((b1 > -0.01) & (b1 < 1.01) & (b2 > -0.01) & (b1 + b2 < 1.01)
                 & (t > near[sl, None]) & (t < far[sl, None]))
        grazing[sl] = (meets & (cos < 0.01)).any(1)
    return ref, chaotic | grazing, grazing


def shadow_chaotic(soup, o, d, dist):
    """Rays with an f64 candidate within rounding of an edge (inside the
    (0, dist) window) or of the window's ends."""
    t, b1, b2, valid = mt_f64(o, d, soup.v0, soup.e1, soup.e2)
    margin = np.minimum.reduce([b1, 1.0 - b1, b2, 1.0 - b1 - b2])
    dd = np.asarray(dist, np.float64)[:, None]
    edge = (np.abs(margin) < EPS_B) & (t > -1e-6) & (t < dd * (1 + 1e-4) + 1e-6)
    ends = valid & ((np.abs(t - dd) < 1e-4 * np.maximum(dd, 1.0))
                    | (np.abs(t) < 1e-5))
    return (edge | ends).any(1)


@pytest.mark.parametrize("kind", ["random", "grazing"])
@pytest.mark.parametrize("name", list(SOUPS))
def test_closest_matches_jax(name, kind):
    soup = SOUPS[name]()
    o, d = ray_set(soup, kind)
    r = len(o)
    near, far = np.zeros(r, np.float32), np.full(r, 1e30, np.float32)
    t, tid = (x.numpy() for x in port_closest(soup, o, d, near, far))
    tj, tidj = (np.asarray(x) for x in jax_closest(soup, o, d, near, far,
                                                   soup.lanes))
    ref, exempt, grazing = exempt_closest(soup, o, d, near, far)
    safe = ~exempt
    assert safe.mean() > (0.9 if kind == "random" else 0.4), safe.mean()
    assert np.array_equal(tid[safe], tidj[safe])
    assert np.array_equal(tid[safe], ref[safe])
    hit = np.nonzero(safe & (tid >= 0))[0]
    t64 = mt_f64(o[hit], d[hit], soup.v0[tid[hit]], soup.e1[tid[hit]],
                 soup.e2[tid[hit]])[0][np.arange(len(hit)), np.arange(len(hit))]
    n = np.cross(soup.e1[tid[hit]], soup.e2[tid[hit]])
    cos = np.abs(np.sum(n * d[hit], 1)) / np.linalg.norm(n, axis=1)
    assert (np.abs(t[hit] - t64) <= 1e-5 * t64 * np.maximum(1.0, 0.1 / cos)).all()
    steep = hit[cos >= 0.1]
    np.testing.assert_allclose(t[steep], tj[steep], rtol=1e-5)
    assert (tid >= 0).sum() > (2 if name == "small mesh" else 50)
    if kind == "grazing" and name != "small mesh":
        assert grazing.sum() > 20           # the set holds grazing hits


@pytest.mark.parametrize("name", list(SOUPS))
def test_shadow_matches_jax(name):
    soup = SOUPS[name]()
    rng = np.random.default_rng(21)
    n_tri = len(soup.v0)
    op_rgb = rng.uniform(0.3, 1.0, (n_tri, 3)).astype(np.float32)
    op_a = rng.uniform(0.4, 1.0, n_tri).astype(np.float32)
    op_a[rng.random(n_tri) < 0.1] = 0.0          # some opaque triangles
    o, d = ray_set(soup, "random")
    dist = rng.uniform(2.0, 10.0, len(o)).astype(np.float32)
    rgb, a = (x.numpy() for x in port_shadow(soup, o, d, dist, op_rgb, op_a))
    rgbj, aj = (np.asarray(x) for x in jax_shadow(soup, o, d, dist, op_rgb,
                                                  op_a, soup.lanes))
    live = (aj >= 1e-4) & ~shadow_chaotic(soup, o, d, dist)
    assert live.mean() > 0.5 and ((a[live] < 1.0).sum() > 2 or name == "small mesh")
    np.testing.assert_allclose(a[live], aj[live], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rgb[live], rgbj[live], rtol=1e-5, atol=1e-6)
    assert (a[aj < 1e-4] < 1e-4).all()


def test_odd_leaf_size_matches_jax():
    """``bvh_leaf_size`` is a public option: at 6 the port's blocks (and
    its pairwise lane product) hold an odd lane count, against the JAX walk
    with lanes for the largest leaf."""
    soup = random_soup(300, 4, leaf_size=6)
    lanes = max(6, int(soup.node_count.max()))
    rng = np.random.default_rng(6)
    op_rgb = rng.uniform(0.3, 1.0, (len(soup.v0), 3)).astype(np.float32)
    op_a = rng.uniform(0.4, 1.0, len(soup.v0)).astype(np.float32)
    o, d = ray_set(soup, "random")
    r = len(o)
    near, far = np.zeros(r, np.float32), np.full(r, 1e30, np.float32)
    dist = np.full(r, 9.0, np.float32)
    T = torch.as_tensor
    walk = soup.port_walk(lanes=6)
    tid = ttw.bvh_closest(*map(T, _np(o, d, near, far, *walk)))[1].numpy()
    rgb, a = (x.numpy() for x in ttw.bvh_shadow(
        *map(T, _np(o, d, dist, *walk, op_rgb, op_a))))
    tidj = np.asarray(jax_closest(soup, o, d, near, far, lanes)[1])
    rgbj, aj = (np.asarray(x) for x in jax_shadow(soup, o, d, dist, op_rgb,
                                                  op_a, lanes))
    ref, exempt, _ = exempt_closest(soup, o, d, near, far)
    assert np.array_equal(tid[~exempt], tidj[~exempt])
    assert np.array_equal(tid[~exempt], ref[~exempt])
    live = (aj >= 1e-4) & ~shadow_chaotic(soup, o, d, dist)
    assert (a[live] < 1.0).sum() > 20
    np.testing.assert_allclose(a[live], aj[live], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rgb[live], rgbj[live], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("r, rungs", [(200, 0), (256, 1), (4096, 3)])
def test_compaction_ladder_changes_cost_not_results(monkeypatch, r, rungs):
    """Below 256 rays there is no rung (cap = r // 4 < 64); above, one per
    quarter. The walk over all rays equals the walk over chunks of 50 (no
    rung) bit for bit, and so does a walk that reads the active count at
    every step (CHECK_EVERY = 1)."""
    soup = random_soup(700, 0)
    o, d = aimed_rays(soup.v0, soup.e1, soup.e2, r, seed=r)
    near, far = np.zeros(r, np.float32), np.full(r, 1e30, np.float32)
    dist = np.full(r, 6.0, np.float32)
    op = (np.full((len(soup.v0), 3), 0.7, np.float32),
          np.full(len(soup.v0), 0.6, np.float32))
    calls = []
    compact = ttw._compact_slots
    monkeypatch.setattr(ttw, "_compact_slots",
                        lambda *a: calls.append(a[1]) or compact(*a))
    whole = (*port_closest(soup, o, d, near, far),
             *port_shadow(soup, o, d, dist, *op))
    assert len(calls) == 2 * rungs
    chunks = [(*port_closest(soup, o[s:s + 50], d[s:s + 50], near[s:s + 50],
                             far[s:s + 50]),
               *port_shadow(soup, o[s:s + 50], d[s:s + 50], dist[s:s + 50], *op))
              for s in range(0, r, 50)]
    monkeypatch.setattr(ttw, "CHECK_EVERY", 1)
    every_step = (*port_closest(soup, o, d, near, far),
                  *port_shadow(soup, o, d, dist, *op))
    for k, x in enumerate(whole):
        assert torch.equal(x, torch.cat([c[k] for c in chunks]))
        assert torch.equal(x, every_step[k])
    assert (whole[1] >= 0).sum() > r // 4


def dropped_triangles(node_begin, node_count, lanes=8):
    """Ids of the triangles past the first ``lanes`` of each leaf."""
    return np.concatenate([np.arange(b + lanes, b + c) for b, c in
                           zip(node_begin, node_count) if c > lanes] or
                          [np.zeros(0, np.int64)])


def test_reference_walk_drops_lanes_past_the_leaf_size():
    """Records a reference-side fault (ROADMAP C): cornell_box's BVH has a
    leaf of 10 triangles (the builder keeps primitives that span their node
    in one leaf), and the JAX walk's 8 lanes never test its last two. Rays
    aimed from the camera at those two find nothing (or what lies behind)
    in the JAX walk, while the port's walk and an f64 Moller-Trumbore find
    them; with 16 lanes the JAX walk finds them too."""
    soup = scene_soup(rt.scenes.cornell_box(16, 16))
    dropped = dropped_triangles(soup.node_begin, soup.node_count)
    assert len(dropped) == 2
    rng = np.random.default_rng(5)
    k = rng.choice(dropped, 256)
    b = rng.uniform(0.1, 0.45, (256, 2)).astype(np.float32)
    p = soup.v0[k] + b[:, :1] * soup.e1[k] + b[:, 1:] * soup.e2[k]
    o = np.tile(np.asarray(rt.scenes.cornell_box(16, 16).cameras[0].position,
                           np.float32), (256, 1))
    d = (p - o) / np.linalg.norm(p - o, axis=1, keepdims=True)
    near, far = np.zeros(256, np.float32), np.full(256, 1e30, np.float32)
    ref, exempt, _ = exempt_closest(soup, o, d, near, far)
    mine = ~exempt & np.isin(ref, dropped)
    assert mine.sum() > 100
    tid = port_closest(soup, o, d, near, far)[1].numpy()
    tid8 = np.asarray(jax_closest(soup, o, d, near, far, 8)[1])
    tid16 = np.asarray(jax_closest(soup, o, d, near, far, 16)[1])
    assert np.array_equal(tid[mine], ref[mine])
    assert np.array_equal(tid16[mine], ref[mine])
    assert not np.isin(tid8[mine], dropped).any()


def render_both(jworld, tworld, lanes, n_passes=4, max_depth=4, seed=3):
    """(JAX accum, port accum): the same scene (the JAX leaves carried
    across) and uniforms, ``packet_traversal=False`` on both, the JAX walk
    with ``lanes`` lanes over the same leaf-8 BVH."""
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=max_depth),
                          packet_traversal=False, bvh_leaf_size=lanes)
    tcfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=max_depth),
                           packet_traversal=False)
    scene = compile_world(jworld)
    cam = compile_camera(jworld.cameras[0])
    tscene = port_scene(scene)
    tcam = tds.compile_camera(tworld.cameras[0], device="cpu")
    res = jworld.cameras[0].width
    key = jax.random.key(seed)
    ns = jint.n_streams(cfg, scene)
    js, ts = jstate.init_state(res, res), init_state(res, res, device="cpu")
    for p in range(n_passes):
        k = jax.random.fold_in(key, p)
        u = torch.as_tensor(np.array(jint.pass_uniforms(k, 0, res, res, ns)))
        js = jint.bounce_step(scene, cam, cfg, js, k)
        ts = tint.bounce_step(tscene, tcam, tcfg, ts, u=u)
    return np.asarray(js.accum), ts.accum.numpy()


@pytest.mark.parametrize("name", ["cornell_box_nee", "multi_light", "cutout"])
def test_render_matches_jax(name):
    """The integrator's skip-link branches (closest hit and the NEE shadow
    rays; the cutout world's texture factor on top) against the JAX
    integrator's from one seed: sample counts equal, radiance as
    ``assert_images_match``."""
    def make(pkg):
        if name == "cutout":
            return cutout_world(pkg, 24)
        return getattr(pkg.scenes, name)(24, 24)
    lanes = scene_soup(make(rt)).lanes
    a_jax, a_port = render_both(make(rz), make(rt), lanes)
    assert_images_match(a_port, a_jax)
    assert a_port[..., :3].max() > 0


def both_grads(make_world, n_steps, max_depth, seed, target=0.1):
    """(JAX grads, port grads) of the MSE image loss of the skip-link
    render (tests/test_torch_gradients.py ``both_grads`` with
    ``packet_traversal=False``; the JAX walk with 16 lanes)."""
    world = make_world(rz)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=max_depth),
                          packet_traversal=False, bvh_leaf_size=16)
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])
    w_, h_ = world.cameras[0].width, world.cameras[0].height
    key = jax.random.key(seed)
    tgt = np.full((h_, w_, 3), target, np.float32)

    def loss_fn(p):
        return jtrain.image_loss(scene.replace(**p), cam, cfg, jstate.init_state(w_, h_),
                                 key, jnp.asarray(tgt), n_steps)[0]

    jg = jax.grad(loss_fn)({k: getattr(scene, k) for k in DIFF_PARAMS})
    ts = port_scene(scene)
    tcam = tds.compile_camera(make_world(rt).cameras[0], device="cpu")
    ns = jint.n_streams(cfg, scene)
    us = [torch.as_tensor(np.array(jint.pass_uniforms(
        jax.random.fold_in(key, p), 0, h_, w_, ns))) for p in range(n_steps)]
    leaves = {k: getattr(ts, k).detach().requires_grad_(True) for k in DIFF_PARAMS}
    tl, _ = ttrain.image_loss(
        dataclasses.replace(ts, **leaves), tcam,
        rt.RenderConfig(tracing=rt.Tracing(max_depth=max_depth),
                        packet_traversal=False),
        init_state(w_, h_, device="cpu"), 0, torch.as_tensor(tgt), n_steps, u=us)
    tg = torch.autograd.grad(tl, list(leaves.values()), allow_unused=True)
    return ({k: np.asarray(v) for k, v in jg.items()},
            {k: (np.zeros(v.shape, np.float32) if g is None else g.numpy())
             for (k, v), g in zip(leaves.items(), tg)})


def test_gradients_match_jax_without_shadow_rays(exact_gathers):
    """tiny_world has no light to sample, so the skip-link walk answers
    only closest hits, whose ids carry no gradient: ``jax.grad`` returns
    gradients through it, and the port's match them (rtol 1e-3 of max |g|)."""
    jg, tg = both_grads(tiny_world, n_steps=4, max_depth=3, seed=7)
    assert_grads_match(jg, tg, expect=("mat_color", "mat_emission"))


def test_reverse_mode_through_the_shadow_walk_raises_like_jax():
    """lit_world's NEE shadow rays carry the material opacities through the
    walk's loop: ``jax.grad`` refuses reverse mode through its
    ``lax.while_loop``, and the port raises a ValueError before its walk
    records a step; without autograd both render."""
    world = lit_world(rz, res=8)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=2),
                          packet_traversal=False)
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])

    def loss_fn(p):
        return jtrain.image_loss(scene.replace(**p), cam, cfg, jstate.init_state(8, 8),
                                 jax.random.key(1), jnp.zeros((8, 8, 3)), 1)[0]

    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        jax.grad(loss_fn)({"mat_color": scene.mat_color})
    ts = port_scene(scene)
    tcam = tds.compile_camera(lit_world(rt, res=8).cameras[0], device="cpu")
    tcfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=2), packet_traversal=False)
    leaf = ts.mat_color.detach().requires_grad_(True)
    with pytest.raises(ValueError, match="no reverse mode"):
        ttrain.image_loss(dataclasses.replace(ts, mat_color=leaf), tcam, tcfg,
                          init_state(8, 8, device="cpu"), 1, torch.zeros(8, 8, 3), 1)
    with torch.no_grad():
        loss, _ = ttrain.image_loss(dataclasses.replace(ts, mat_color=leaf), tcam,
                                    tcfg, init_state(8, 8, device="cpu"), 1,
                                    torch.zeros(8, 8, 3), 1)
    assert np.isfinite(float(loss))


def test_placeholder_ray_meets_mesh_heavy_on_an_edge():
    """Pass 0 traces ``init_state``'s placeholder ray (origin 0, direction
    +z) for every pixel (ROADMAP C). On mesh_heavy that ray runs along the
    edge shared by two triangles: f64 puts both at one t with a barycentric
    margin below 1e-4 and calls the ray chaotic, so float32 walks may take
    either triangle or neither (chip_smoke.py leaves pass 0 out of its
    skip-link render gate there). The port's walk takes the JAX walk's
    triangle at its t."""
    soup = scene_soup(rt.scenes.mesh_heavy(16, 16))
    o = np.zeros((1, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    near, far = np.zeros(1, np.float32), np.full(1, 3.4028235e38, np.float32)
    ref, chaotic = closest_f64(o, d, soup.v0, soup.e1, soup.e2, near, far)
    t, b1, b2, valid = mt_f64(o, d, soup.v0, soup.e1, soup.e2)
    hits = np.nonzero(valid[0])[0]
    first = hits[np.isclose(t[0, hits], t[0, ref[0]], rtol=1e-9)]
    margin = np.minimum.reduce([b1[0], 1 - b1[0], b2[0], 1 - b1[0] - b2[0]])
    assert chaotic[0] and len(first) == 2 and (margin[first] < EPS_B).all()
    tp, idp = (x.numpy() for x in port_closest(soup, o, d, near, far))
    tj, idj = (np.asarray(x) for x in jax_closest(soup, o, d, near, far,
                                                  soup.lanes))
    assert idp[0] == idj[0] and idp[0] in first
    np.testing.assert_allclose(tp, tj, rtol=1e-6)
    np.testing.assert_allclose(tp, t[0, ref[0]], rtol=1e-6)
