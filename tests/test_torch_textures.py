"""Texture maps and texture-alpha cutout shadows, port against the JAX package.

* ``ops/texture.py`` ``fetch`` against JAX ``fetch``: every address mode and
  filter, both atlases, uv inside and outside [0, 1), against the JAX
  blocked fetch (block tables) and its four-gather fetch (no tables);
  values to 1e-6 absolute.
* The host build: ``block_indices`` and the atlas cache.
* ``texture_shadow_factor`` against JAX's on the same rays.
* Render parity with injected uniforms (the JAX scene carried across with
  ``scene_from_arrays``): ``textured_room`` at 24^2, 5 passes, depth 3, on
  both structures, with each pass's hit ids pinned; the cutout world of
  ``tests/test_oracle_parity.py``; and the port's own render of a cutout
  shadow, which must not be solid.

Tolerances: images as ``assert_images_match``; normal-mapped glossy bounces
amplify the last-bit differences of XLA's fused multiply-adds on the CPU,
so ``textured_room`` holds frac 0.98, the JAX suite's own oracle tolerance
for the scene (``test_oracle_parity.py:85``).
"""
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
from rayzath_tpu.ops import texture as jtex  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine import integrator as tint  # noqa: E402
from rayzath_tpu_torch.engine import state as tstate  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import texture as ttex  # noqa: E402
from rayzath_tpu_torch.utils import check_worlds  # noqa: E402
from rayzath_tpu_torch.utils.parity import closest_f64, expand_instances  # noqa: E402

from test_oracle_parity import _cutout_scene, assert_images_match  # noqa: E402
from test_torch_render import port_scene  # noqa: E402


def cutout_world(pkg, res):
    """``test_oracle_parity._cutout_scene`` from either package: a
    transparent leaf quad with a checker-alpha texture between a spot light
    and a floor."""
    return _cutout_scene(res) if pkg is rz else check_worlds.cutout_world(res)


# ---------------------------------------------------------------------------
# fetch
# ---------------------------------------------------------------------------

def fetch_tables(rng, rotate=False):
    """Two color maps (7x5, 4x9) and two scalar maps (6x6, 3x8) packed into
    atlases with junk texels around them, one map per (filter, address)
    pair, random UV scales and translations; random rotations with
    ``rotate``."""
    col = rng.uniform(0, 1, (16, 16, 4)).astype(np.float32)
    sc = rng.uniform(0, 1, (8, 16)).astype(np.float32)
    rects, flags, uvp = [], [], []
    for atlas, rect in ((0, (1, 2, 7, 5)), (0, (9, 3, 4, 9)),
                        (1, (0, 0, 6, 6)), (1, (2, 7, 3, 8))):
        for filt in (0, 1):
            for addr in range(4):
                rects.append(rect)
                flags.append((filt, addr, atlas))
                uvp.append((rng.uniform(0.5, 2.0), rng.uniform(0.5, 2.0),
                            rng.uniform(-1, 1) if rotate else 0.0,
                            rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5)))
    rects = np.asarray(rects, np.int32)
    flags = np.asarray(flags, np.int32)
    return col, sc, rects, flags, np.asarray(uvp, np.float32)


@pytest.mark.parametrize("atlas", [0, 1])
@pytest.mark.parametrize("blocked", [True, False])
def test_fetch_matches_jax(atlas, blocked):
    """Every map of one atlas kind (both filters x four address modes) at
    uv inside and outside [0, 1): the port (block tables) against JAX's
    blocked fetch and its four-gather fetch, to 1e-6 absolute. The maps are
    unrotated here: a rotation's ``u*c - v*s`` is fused into one
    multiply-add by XLA on the CPU, and the texel coordinate scales that
    last-bit difference by the map width (rotations:
    :func:`test_uv_transform_matches_jax`)."""
    rng = np.random.default_rng(5 + atlas)
    col, sc, rects, flags, uvp = fetch_tables(rng)
    ids = np.nonzero(flags[:, 2] == atlas)[0]
    n = 4000
    map_id = rng.choice(ids, n).astype(np.int32)
    uv = np.concatenate([rng.uniform(0, 1, (n // 2, 2)),
                         rng.uniform(-2.5, 2.5, (n - n // 2, 2))]).astype(np.float32)
    col_blk = jtex.block_indices(rects[flags[:, 2] == 0], 16, 16)
    sc_blk = jtex.block_indices(rects[flags[:, 2] == 1], 8, 16)
    assert np.array_equal(ttex.block_indices(rects[flags[:, 2] == 0], 16, 16), col_blk)
    assert np.array_equal(ttex.block_indices(rects[flags[:, 2] == 1], 8, 16), sc_blk)
    kw = {}
    if blocked:
        kw = (dict(col_blk=jnp.take(jnp.asarray(col).reshape(-1, 4),
                                    col_blk.reshape(-1), axis=0).reshape(-1, 16))
              if atlas == 0 else
              dict(sc_blk=jnp.take(jnp.asarray(sc).reshape(-1),
                                   sc_blk.reshape(-1), axis=0).reshape(-1, 4)))
    ref = np.asarray(jtex.fetch(*map(jnp.asarray, (col, sc, rects, flags, uvp,
                                                   map_id, uv)),
                                atlas=atlas, **kw))
    table, blk = (col, col_blk) if atlas == 0 else (sc, sc_blk)
    got = ttex.fetch(*map(torch.as_tensor, (table, blk, rects, flags, uvp,
                                            map_id, uv))).numpy()
    assert got.shape == (n, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # each mode is exercised: border zeros, and values from inside the rects
    assert (got == 0).all(1).sum() > 50 and (got > 0).all(1).sum() > n // 2


def test_uv_transform_matches_jax():
    """Scale, rotation and translation of the UV transform, to 1e-6 of the
    coordinate's magnitude (XLA fuses the rotation's multiply-adds)."""
    rng = np.random.default_rng(8)
    uvp = fetch_tables(rng, rotate=True)[4]
    map_id = rng.integers(0, len(uvp), 3000).astype(np.int32)
    uv = rng.uniform(-2.5, 2.5, (3000, 2)).astype(np.float32)
    ref = np.stack(jtex._transform_uv(jnp.asarray(uv), jnp.asarray(uvp),
                                      jnp.asarray(map_id)), 1)
    got = torch.stack(ttex._transform_uv(torch.as_tensor(uv), torch.as_tensor(uvp),
                                         torch.as_tensor(map_id).long()), 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_fetch_gradient_reaches_texels():
    """The atlas stays an autograd leaf: the bilinear weights of a fetch
    land on its four corner texels."""
    rng = np.random.default_rng(2)
    col, _, rects, flags, uvp = fetch_tables(rng)
    blk = ttex.block_indices(rects[flags[:, 2] == 0], 16, 16)
    atlas = torch.as_tensor(col).requires_grad_(True)
    lin = int(np.nonzero((flags[:, 0] == 1) & (flags[:, 2] == 0))[0][0])
    uvp[lin] = (1.0, 1.0, 0.0, 0.0, 0.0)
    out = ttex.fetch(atlas, *map(torch.as_tensor, (blk, rects, flags, uvp,
                                                   np.array([lin], np.int32),
                                                   np.array([[0.33, 0.61]], np.float32))))
    out[0, 1].backward()
    g = atlas.grad.numpy()[..., 1]
    assert np.count_nonzero(g) == 4 and g.sum() == pytest.approx(1.0, abs=1e-6)
    y0, x0, h, w = rects[lin]
    ys, xs = np.nonzero(g)
    assert (ys >= y0).all() and (ys < y0 + h).all()
    assert (xs >= x0).all() and (xs < x0 + w).all()


# ---------------------------------------------------------------------------
# host build
# ---------------------------------------------------------------------------

def test_atlas_cache_follows_map_versions():
    """A materials-only edit reuses the packed atlases; an edited map
    repacks them."""
    world = rt.scenes.textured_room(8, 8)
    cache = {}
    first = tds.compile_world(world, cache=cache, device="cpu")
    (key, entry), = [(k, v) for k, v in cache.items() if k[0] == "atlas"]
    world.materials[0].roughness = 0.5
    tds.compile_world(world, cache=cache, device="cpu")
    assert cache[key] is entry
    tex = world.textures[0]
    tex.data = np.zeros_like(tex.data)
    tex.touch()
    again = tds.compile_world(world, cache=cache, device="cpu")
    assert key not in cache and len([k for k in cache if k[0] == "atlas"]) == 1
    assert float(again.color_atlas.abs().sum()) < float(first.color_atlas.abs().sum())


@pytest.mark.parametrize("two_level", [False, True])
def test_texture_shadow_factor_matches_jax(two_level):
    """The dense cutout pass on rays from above the leaf down to the floor,
    against JAX's, on the same scene."""
    scene = jds.compile_world(_cutout_scene(8), two_level=two_level)
    ts = port_scene(scene)
    assert ts.n_cutout == scene.n_cutout == 2
    rng = np.random.default_rng(9)
    o = np.concatenate([rng.uniform(-1.5, 1.5, (600, 2))[:, :1],
                        np.full((600, 1), 3.0),
                        rng.uniform(-1.5, 1.5, (600, 1))], 1).astype(np.float32)
    tgt = np.concatenate([rng.uniform(-2, 2, (600, 1)), np.zeros((600, 1)),
                          rng.uniform(-2, 2, (600, 1))], 1)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    dist = np.full(600, 1e30, np.float32)
    rgb_j, a_j = jint.texture_shadow_factor(scene, *map(jnp.asarray, (o, d, dist)))
    rgb_t, a_t = tint.texture_shadow_factor(ts, *map(torch.as_tensor, (o, d, dist)))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-5, atol=1e-6)
    # rays through holes and through opaque texels both occur
    assert (a_t.numpy() == 1.0).sum() > 50 and (a_t.numpy() == 0.0).sum() > 50


# ---------------------------------------------------------------------------
# render parity
# ---------------------------------------------------------------------------

def run_both(make_world, two_level, n_passes, max_depth, res=24, seed=3,
             pin=False):
    """JAX and port bounce steps on the same scene and uniforms. With
    ``pin``, every pass's closest-hit ids (on the JAX state's wavefront)
    must agree with JAX's and with the f64 reference except on f64-chaotic
    rays."""
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=max_depth))
    tcfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=max_depth))
    world = make_world(rz, res)
    scene = jds.compile_world(world, two_level=two_level)
    cam = jds.compile_camera(world.cameras[0])
    tscene = port_scene(scene)
    assert tscene.has_maps == scene.has_maps
    assert tscene.map_kinds_used == scene.map_kinds_used
    tcam = tds.compile_camera(make_world(rt, res).cameras[0], device="cpu")
    key = jax.random.key(seed)
    ns = jint.n_streams(cfg, scene)
    js = jstate.init_state(res, res)
    ts = tstate.init_state(res, res, device="cpu")
    if pin:
        if two_level:
            tabs = [x.numpy() for x in (tscene.ti_rows, tscene.cl_obox,
                                        tscene.inst_fwd, tscene.tri_v0,
                                        tscene.tri_e1, tscene.tri_e2)]
            tris = expand_instances(*tabs)[:3]
        else:
            n = tscene.n_triangles
            tris = [x[:n].numpy() for x in (tscene.tri_v0, tscene.tri_e1,
                                            tscene.tri_e2)]
    for p in range(n_passes):
        k = jax.random.fold_in(key, p)
        u = jint.pass_uniforms(k, 0, res, res, ns)
        if pin and p > 0:
            o, d = np.array(js.origin), np.array(js.direction)
            depth0 = np.asarray(js.path_depth)
            nf = np.asarray(cam.near_far)
            near = np.where(depth0 == 0, nf[0], np.asarray(js.near)).astype(np.float32)
            far = np.where(depth0 == 0, nf[1], np.asarray(js.far)).astype(np.float32)
            _, tid_j, inst_j, *_ = jint.closest_hit(
                scene, cfg, *map(jnp.asarray, (o, d, near, far)), hw=(res, res))
            _, tid_t, inst_t, *_ = tint.closest_hit(
                tscene, tcfg, *map(torch.as_tensor, (o, d, near, far)), hw=(res, res))
            _, chaotic = closest_f64(o, d, *tris, near, far)
            safe = ~chaotic
            assert safe.mean() > 0.8, safe.mean()
            assert np.array_equal(tid_t.numpy()[safe], np.asarray(tid_j)[safe])
            if two_level:
                assert np.array_equal(inst_t.numpy()[safe], np.asarray(inst_j)[safe])
        js = jint.bounce_step(scene, cam, cfg, js, k)
        ts = tint.bounce_step(tscene, tcam, tcfg, ts, u=torch.as_tensor(np.array(u)))
    return np.asarray(js.accum), ts.accum.numpy()


@pytest.mark.parametrize("two_level", [False, True])
def test_textured_room_matches_jax(two_level):
    """All five map kinds, normal mapping included, through 5 passes."""
    a_jax, a_port = run_both(lambda pkg, res: pkg.scenes.textured_room(res, res),
                             two_level, n_passes=5, max_depth=3, pin=True)
    assert_images_match(a_port, a_jax, frac=0.98)


@pytest.mark.parametrize("two_level", [False, True])
def test_cutout_shadows_match_jax(two_level):
    a_jax, a_port = run_both(cutout_world, two_level, n_passes=5, max_depth=3)
    assert_images_match(a_port, a_jax)


def test_texture_alpha_shadow_not_solid():
    """The port's own render (``Renderer``, its own uniforms): a cutout
    texture casts a non-solid shadow, lit floor under the holes and
    shadowed floor under opaque texels (the JAX suite's
    ``test_texture_alpha_shadow_not_solid``)."""
    world = cutout_world(rt, 48)
    r = rt.Renderer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=2)), device="cpu")
    r.render(rpp=8)
    assert r.scene.n_cutout == 2
    img = r.views[id(world.cameras[0])].state.accum[..., :3].sum(-1).numpy()
    mid = img[20:40, 8:40]
    assert mid.max() > 4.0 * max(mid.min(), 1e-3), (mid.min(), mid.max())
