"""B2 with texture-alpha cutouts on the CPU: the plain twin of its cutout
variant (``ops/traverse_cluster.py`` ``cluster_shadow_plain`` with
``cutouts=``) against the dense route (``engine/integrator.py``
``_shadow_core`` times ``texture_shadow_factor``), the CPU model of the
kernel's walk (``tests/test_torch_ranked_walk.py`` ``model_shadow``) with
its alpha stop against the plain twin, the fetch counter, and the choice
of route (``integrator.shadow_route``).

Shadow rays come from ``scenes.leaf_canopy``: a small crown of 3,000
cards (a flat table of 71 rows) and the full crown of 65,536 (1,664 rows,
above ``GROUPED_ROWS``: B2 walks it through its group table).

Tolerances. The plain twin and the dense route multiply the same texels
at the same hits, but they take each hit's barycentrics from different
frames: the plain twin (and the kernel) from the cluster-local frames of
the cluster table, the dense pass from world-space frames of the cutout
set, which round to some 1e-6 at 5-8 m from the origin for a card of
9.3 cm. The leaf maps are 256 texels across and bilinear, so at the edge
of a leaf's silhouette alpha changes by up to 256 per unit of texture
coordinate, and there the two routes' alphas part: the dense frame's b =
M p + c sums terms of up to |p| / 0.093 m = 86, so three float32
roundings leave about 86 x 3 x 2^-24 = 1.5e-5 in b, and 256 times that
is 3.9e-3 in alpha at one edge hit. So a ray's a and rgb * a agree within
1e-4 on all but 1% of the rays, and within 5e-3 on every ray, where the
rays start on the ground or inside the crown's volume. A ray that starts
on a card (``canopy_shadow_rays(..., on_cards=True)``, a bounce off a
leaf) meets that card within rounding of t = 0, where the two frames can
put the hit on either side of 0: there the routes part by the card's
whole texel factor on a quarter of the rays of the small crown, and the
rule (``cluster_shadow``'s docstring) is that each route takes the card
or leaves it, so the fused result lies, to the same bounds, at the dense
route's result with the card (the origin moved 3e-5 m back along the
ray) or without it (moved 3e-5 m on). 3e-5 m is above the rounding of
t at the card (the barycentrics' 1.5e-5 of a 9.3 cm card is 1.4e-6 m
off its plane, 8e-6 m along a ray at 10 degrees to it, the flattest
that ``on_cards`` casts). Another card within 3e-5 m of the origin falls
into the bracket too: on the full crown, whose mean free path is about
a metre, about one ray in 30,000, so the 5e-3 bound holds on all but
one ray in 1,000 there. The kernel's walk also stops a ray once
its alpha is below 1e-4 (B2's stop; the dense pass has none): against
the plain twin it meets the shadow gate of ``tests/test_torch_gpu.py``
(to rtol 1e-5 / atol 1e-6 where the plain alpha is at least 1e-4, both
below 1e-4 elsewhere), and on rays whose plain alpha stays above 2e-4,
where the stop never fired, it fetches as many texels as the plain twin.
"""
import dataclasses

import pytest
import torch

import rayzath_tpu_torch as rt
from rayzath_tpu_torch.engine import integrator as I
from rayzath_tpu_torch.models import device_scene as tds
from rayzath_tpu_torch.ops import traverse_cluster as tc
from rayzath_tpu_torch.utils.check_worlds import canopy_shadow_rays
from test_torch_gpu import shadow_gate  # noqa: E402
from test_torch_ranked_walk import model_shadow  # noqa: E402

torch.set_num_threads(2)

CARDS = {"flat": 3000, "grouped": 65536}


@pytest.fixture(scope="module", params=["flat", "grouped"])
def canopy(request):
    world = rt.scenes.leaf_canopy(16, 16, cards=CARDS[request.param])
    scene = tds.compile_world(world, device="cpu")
    grouped = scene.cl_box.shape[1] > tc.GROUPED_ROWS
    assert grouped == (request.param == "grouped")
    return world, scene


def _op_tab(scene):
    mat = scene.mat_color[scene.tri_mat.long()]
    return tc.cluster_opacity(mat[:, :3], 1.0 - mat[:, 3], scene.cl_order,
                              scene.cl_base, scene.cl_count)


def _dense(scene, o, d, dist):
    cfg = rt.RenderConfig()
    base = I._shadow_core(scene, cfg, o, d, dist)
    tex = I.texture_shadow_factor(scene, o, d, dist)
    return base[0] * tex[0], base[1] * tex[1]


def _fused(scene, o, d, dist):
    mat = scene.mat_color[scene.tri_mat.long()]
    return tc.cluster_shadow(o, d, dist, scene.cl_box, scene.cl_lw,
                             scene.cl_order, scene.cl_base, scene.cl_count,
                             mat[:, :3].contiguous(),
                             (1.0 - mat[:, 3]).contiguous(),
                             groups=scene.cl_group,
                             cutouts=tc.Cutouts.of(scene))


def test_plain_twin_matches_the_dense_route(canopy):
    """``cluster_shadow`` with the scene's cutouts (the plain twin on the
    CPU) against the dense route on 1,024 shadow rays (384 through the
    full crown, whose dense pass takes 256 chunks): a and rgb * a within
    1e-4 on all but 1% of the rays and within 5e-3 on each (the frames'
    rounding at a silhouette's edge, module docstring); the rays cross
    leaves (a texel fetch a ray at least), and some are blocked, some
    free."""
    world, scene = canopy
    n = 1024 if scene.cl_box.shape[1] <= tc.GROUPED_ROWS else 384
    o, d, dist = canopy_shadow_rays(world, n, seed=5)
    rgb_f, a_f = _fused(scene, o, d, dist)
    rgb_d, a_d = _dense(scene, o, d, dist)
    gap = torch.maximum((a_f - a_d).abs(),
                        (rgb_f * a_f[:, None] - rgb_d * a_d[:, None])
                        .abs().amax(1))
    assert float((gap > 1e-4).float().mean()) <= 0.01, float(gap.max())
    assert float(gap.max()) <= 5e-3
    assert int((a_d < 1e-4).sum()) > n // 20
    assert int((a_d == 1.0).sum()) > n // 20
    _, _, fetches = tc._shadow_plain(o, d, dist, scene.cl_box, scene.cl_lw,
                                     _op_tab(scene), tc.Cutouts.of(scene))
    assert float(fetches.float().mean()) >= 0.25


def _gap(x, y):
    return torch.maximum((x[1] - y[1]).abs(),
                         (x[0] * x[1][:, None] - y[0] * y[1][:, None])
                         .abs().amax(1))


def test_rays_from_a_card_take_it_or_leave_it(canopy):
    """Shadow rays that start on a card (``on_cards=True``; 1,024 through
    the small crown, 256 through the full one): the plain twin with
    cutouts lies within 1e-4 (a and rgb * a) of the dense route's result
    with the ray's own card (origin moved 3e-5 m back along the ray) or
    without it (moved 3e-5 m on) on all but 1% of the rays, and within
    5e-3 on all but one in 1,000 (module docstring); the own card changes
    a by more than 1e-3 on a tenth of the rays, and the fused and dense
    results on the same rays part by more than 1e-4 on some (the rule is
    not vacuous)."""
    world, scene = canopy
    n = 1024 if scene.cl_box.shape[1] <= tc.GROUPED_ROWS else 256
    o, d, dist = canopy_shadow_rays(world, n, seed=10, on_cards=True)
    got = _fused(scene, o, d, dist)
    eps = 3e-5
    take = _dense(scene, o - eps * d, d, dist + eps)
    leave = _dense(scene, o + eps * d, d, dist - eps)
    gap = torch.minimum(_gap(got, take), _gap(got, leave))
    assert float((gap > 1e-4).float().mean()) <= 0.01, float(gap.max())
    assert int((gap > 5e-3).sum()) <= n // 1000, float(gap.max())
    assert float(((take[1] - leave[1]).abs() > 1e-3).float().mean()) >= 0.1
    assert int((_gap(got, _dense(scene, o, d, dist)) > 1e-4).sum()) > 0


def test_model_walk_matches_the_plain_twin(canopy):
    """The kernel's walk (the CPU model: ranked, voted, stopped below 1e-4)
    with the cutout variant's texel factor, flat or grouped, against the
    plain twin: the shadow gate on 384 rays, fetches per ray at most the
    plain twin's and equal on rays whose plain alpha stays above 2e-4."""
    world, scene = canopy
    o, d, dist = canopy_shadow_rays(world, 384, seed=6)
    op_tab, cut = _op_tab(scene), tc.Cutouts.of(scene)
    *ref, want = tc._shadow_plain(o, d, dist, scene.cl_box, scene.cl_lw,
                                  op_tab, cut)
    grouped = scene.cl_box.shape[1] > tc.GROUPED_ROWS
    fetches, entered = [], []
    *got, visits, _ = model_shadow(
        o, d, dist, scene.cl_box, scene.cl_lw, op_tab, cutouts=cut,
        fetches=fetches, groups=scene.cl_group if grouped else None,
        entered=entered)
    shadow_gate(got, ref)
    got_f = torch.cat(fetches)
    assert bool((got_f <= want).all())
    free = ref[1] >= 2e-4
    assert torch.equal(got_f[free], want[free])
    assert int(want.sum()) > len(o) // 4 and visits > 0
    assert int((ref[1] < 1e-4).sum()) > 20
    assert (max(entered) > 0) if grouped else not entered


def test_plain_walk_counts_its_fetches():
    """A CPU ``cluster_shadow`` call with cutouts adds the plain twin's
    texel fetches to ``cluster_shadow.fetches``; one without adds none;
    B2's ``work`` keeps B1's three keys and its live rays."""
    world = rt.scenes.leaf_canopy(16, 16, cards=600)
    scene = tds.compile_world(world, device="cpu")
    o, d, dist = canopy_shadow_rays(world, 256, seed=7)
    *_, want = tc._shadow_plain(o, d, dist, scene.cl_box, scene.cl_lw,
                                _op_tab(scene), tc.Cutouts.of(scene))
    start = tc.cluster_shadow.fetches.read()["cutout_fetches"]
    _fused(scene, o, d, dist)
    got = tc.cluster_shadow.fetches.read()["cutout_fetches"] - start
    assert got == int(want.sum()) > 0
    I._shadow_core(scene, rt.RenderConfig(), o, d, dist)
    assert tc.cluster_shadow.fetches.read()["cutout_fetches"] - start == got
    assert tc.cluster_shadow.work.keys == tc.SOUP_WORK + ("live",)
    assert tc.cluster_shadow.fetches.keys == ("cutout_fetches",)


def test_cutouts_refuse_autograd():
    """The texel factor has no backward in B2-grad: a differentiable call
    with cutouts raises, and training takes the dense route."""
    scene = tds.compile_world(rt.scenes.leaf_canopy(8, 8, cards=50),
                              device="cpu")
    o, d, dist = canopy_shadow_rays(rt.scenes.leaf_canopy(8, 8, cards=50),
                                    8, seed=8)
    mat = scene.mat_color[scene.tri_mat.long()]
    op_rgb = mat[:, :3].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="dense cutout pass"):
        tc.cluster_shadow(o, d, dist, scene.cl_box, scene.cl_lw,
                          scene.cl_order, scene.cl_base, scene.cl_count,
                          op_rgb, 1.0 - mat[:, 3],
                          tris=(scene.tri_v0, scene.tri_e1, scene.tri_e2),
                          cutouts=tc.Cutouts.of(scene))


def test_the_route_of_each_case(monkeypatch):
    """``shadow_route``: the fused B2 on a CUDA device with autograd off
    for a soup scene with cutouts walked by B2; the dense pass on the CPU,
    under autograd, on a two-level scene, on the dense and the skip-link
    routes; nothing for a scene without cutouts. On the CPU a shadow test
    calls the dense pass (its counter moves) and B2 without cutouts."""
    world = rt.scenes.leaf_canopy(8, 8, cards=50)
    soup = tds.compile_world(world, device="cpu")
    two = tds.compile_world(world, two_level=True, device="cpu")
    cfg = rt.RenderConfig()
    cuda = torch.device("cuda")
    assert soup.cl_cut_map is not None and two.cl_cut_map is None
    with torch.no_grad():
        assert I.shadow_route(soup, cfg, cuda) == "fused"
        assert I.shadow_route(soup, cfg, "cpu") == "dense"
        assert I.shadow_route(two, cfg, cuda) == "dense"
        assert I.shadow_route(soup, rt.RenderConfig(packet_traversal=False),
                              cuda) == "dense"
        assert I.shadow_route(soup, rt.RenderConfig(
            brute_force_threshold=10 ** 6), cuda) == "dense"
        plain = tds.compile_world(rt.scenes.cornell_box_nee(8, 8),
                                  device="cpu")
        assert I.shadow_route(plain, cfg, cuda) == "none"
    with torch.enable_grad():
        assert I.shadow_route(soup, cfg, cuda) == "dense"
    seen = []
    real = I.cluster_shadow

    def spy(*a, **k):
        seen.append(k.get("cutouts"))
        return real(*a, **k)

    monkeypatch.setattr(I, "cluster_shadow", spy)
    o, d, dist = canopy_shadow_rays(world, 16, seed=9)
    before = I.texture_shadow_factor.launches
    with torch.no_grad():
        I.shadow_test(soup, cfg, o, d, dist)
    assert I.texture_shadow_factor.launches == before + 1
    assert seen == [None]


def test_scene_from_arrays_builds_the_slot_tables():
    """A soup scene with cutouts built from named arrays that lack the
    per-slot tables gets them from its cluster order, materials and
    ``tri_pack`` (equal to ``compile_world``'s), so the card's render takes
    the fused route on it; a two-level scene gets none."""
    world = rt.scenes.leaf_canopy(8, 8, cards=300)
    for two_level in (False, True):
        scene = tds.compile_world(world, two_level=two_level, device="cpu")
        own = {f.name: getattr(scene, f.name).numpy()
               for f in dataclasses.fields(scene)
               if isinstance(getattr(scene, f.name), torch.Tensor)
               and f.name not in ("cl_cut_map", "cl_cut_uv")}
        again = tds.scene_from_arrays(own, dataclasses.asdict(scene),
                                      device="cpu")
        if two_level:
            assert again.cl_cut_map is None and again.cl_cut_uv is None
            continue
        assert torch.equal(again.cl_cut_map, scene.cl_cut_map)
        assert torch.equal(again.cl_cut_uv, scene.cl_cut_uv)
        assert int((again.cl_cut_map >= 0).sum()) == again.n_cutout > 0
        with torch.no_grad():
            assert I.shadow_route(again, rt.RenderConfig(),
                                  torch.device("cuda")) == "fused"
