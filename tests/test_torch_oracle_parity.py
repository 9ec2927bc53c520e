"""The port against the independent NumPy oracle (``rayzath_tpu/oracle.py``).

The pattern of tests/test_oracle_parity.py with the port in place of the
JAX integrator: the same worlds, built and compiled by each package, and
the same uniforms (the port's ``pass_uniforms``, jax's threefry streams bit
for bit) go through the port's ``bounce_step`` on the CPU (its plain
versions) and through the oracle's brute-force bounce, once per traversal
path: the cluster walk (``packet_traversal=True``, B1/B2's plain versions)
and the skip-link BVH walk (``packet_traversal=False``, ops/traverse.py).

* Every bounce's closest-hit ids are pinned: on the port's own wavefront
  of that bounce (its rays, near and far), the port's ids equal the
  oracle's Moller-Trumbore (``oracle.mt_closest``) on every ray that an f64
  Moller-Trumbore does not call chaotic (a tie, an edge, a near miss), as
  ``test_decision_exact_hit_ids_pinned`` does for the JAX kernel, or that
  meets a triangle within rounding of its origin: a bounce ray leaves its
  surface at t ~ 1e-8, where the cluster walk's projection test and
  Moller-Trumbore round either side of near = 0 (glass_scattering has such
  rays).
* Images: ``assert_images_match`` at the JAX suite's tolerances (frac 0.98
  for textured_maps). glass_scattering's image is held to exact sample
  counts and the fp-noise bulk only, not to a fraction of close pixels
  (the JAX suite accepts 0.85 there): refraction at the curved glass and
  the free flight in the fog carry last-bit differences into other paths,
  so its hit ids, pinned per bounce, are the check.

The oracle is read from the JAX package; the port has no copy of it.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu import oracle  # noqa: E402
from rayzath_tpu.models.device_scene import compile_world, compile_camera  # noqa: E402

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine import integrator as tint  # noqa: E402
from rayzath_tpu_torch.engine.state import init_state  # noqa: E402
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import rng  # noqa: E402
from rayzath_tpu_torch.utils.parity import EPS_B, closest_f64, mt_f64  # noqa: E402

from test_oracle_parity import assert_images_match  # noqa: E402
from test_torch_textures import cutout_world  # noqa: E402

RES = 24

# world: (builder of either package, passes, depth, image frac or None)
WORLDS = {
    "cornell": (lambda pkg: pkg.scenes.cornell_box(RES, RES), 6, 4, 0.995),
    "lights_nee": (lambda pkg: pkg.scenes.multi_light(RES, RES), 5, 3, 0.995),
    "glass_scattering": (lambda pkg: pkg.scenes.glass_and_fog(RES, RES), 5, 4,
                         None),
    "smooth_normals": (lambda pkg: pkg.scenes.teapot_like(RES, RES), 5, 3, 0.995),
    "textured_maps": (lambda pkg: pkg.scenes.textured_room(RES, RES), 5, 3, 0.98),
    "texture_alpha_shadows": (lambda pkg: cutout_world(pkg, RES), 5, 3, 0.995),
}


def at_origin(o, d, v0, e1, e2, near, chunk=128):
    """Rays with an f64 candidate inside its triangle (to EPS_B) at a t
    within 1e-6 of ``near`` (relative past 1), behind it or not. A bounce
    ray leaves its surface nudged 1e-4 t off it, which stays outside."""
    out = np.zeros(len(o), bool)
    for s in range(0, len(o), chunk):
        sl = slice(s, s + chunk)
        t, b1, b2, _ = mt_f64(o[sl], d[sl], v0, e1, e2)
        inside = ((b1 >= -EPS_B) & (b1 <= 1 + EPS_B) & (b2 >= -EPS_B)
                  & (b1 + b2 <= 1 + EPS_B))
        nr = np.asarray(near[sl], np.float64)[:, None]
        out[sl] = (inside & (np.abs(t - nr) < 1e-6 * np.maximum(np.abs(nr), 1.0))
                   ).any(1)
    return out


def run_both(monkeypatch, make, n_passes, max_depth, packet, seed=3):
    """(port accum, oracle accum, per bounce (port ids, oracle ids,
    chaotic))."""
    jscene = compile_world(make(rz))
    oscene = oracle.OracleScene(jscene)
    ocam = oracle.OracleCamera(compile_camera(make(rz).cameras[0]))
    world = make(rt)
    scene = tds.compile_world(world, device="cpu")
    cam = tds.compile_camera(world.cameras[0], device="cpu")
    assert scene.n_triangles == jscene.n_triangles
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=max_depth),
                          packet_traversal=packet)
    jcfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=max_depth))
    n = scene.n_triangles
    tris = [x[:n].numpy() for x in (scene.tri_v0, scene.tri_e1, scene.tri_e2)]
    bounces = []
    closest_walk = tint._closest_walk

    def pinned(scene, cfg, o, d, near, far, hw=None):
        out = closest_walk(scene, cfg, o, d, near, far, hw=hw)
        rays = [x.detach().numpy() for x in (o, d, near, far)]
        ids = oracle.mt_closest(*rays, *tris)[1]
        chaotic = (closest_f64(*rays[:2], *tris, *rays[2:])[1]
                   | at_origin(*rays[:2], *tris, rays[2]))
        bounces.append((out[1].numpy(), ids, chaotic))
        return out

    monkeypatch.setattr(tint, "_closest_walk", pinned)
    key = rng.key(seed)
    ns = tint.n_streams(cfg, scene)
    state = init_state(RES, RES, device="cpu")
    ostate = oracle.OracleState(RES, RES)
    for p in range(n_passes):
        u = tint.pass_uniforms(rng.fold_in(key, p), 0, RES, RES, ns, "cpu")
        state = tint.bounce_step(scene, cam, cfg, state, u=u)
        oracle.bounce_step(oscene, ocam, jcfg, ostate, u.numpy())
    assert len(bounces) == n_passes
    return state.accum.numpy(), ostate.accum, bounces


@pytest.mark.parametrize("packet", [True, False],
                         ids=["packet_traversal", "skip_link_walk"])
@pytest.mark.parametrize("name", list(WORLDS))
def test_port_matches_oracle(monkeypatch, name, packet):
    make, n_passes, max_depth, frac = WORLDS[name]
    a, b, bounces = run_both(monkeypatch, make, n_passes, max_depth, packet)
    for p, (ids, ids_oracle, chaotic) in enumerate(bounces):
        safe = ~chaotic
        # pass 0 traces init_state's placeholder rays: one ray from the
        # origin along +z, repeated (chaotic or not as a whole)
        assert p == 0 or safe.mean() > 0.8, (p, safe.mean())
        bad = np.nonzero(safe & (ids != ids_oracle))[0]
        assert not len(bad), f"bounce {p}: {len(bad)} hit ids differ, rays {bad[:5]}"
    assert sum((ids >= 0).sum() for ids, _, _ in bounces) > RES * RES
    if frac is None:
        assert np.array_equal(a[..., 3], b[..., 3]), "sample counts diverged"
        rel = np.abs(a[..., :3] - b[..., :3]) / max(np.abs(b[..., :3]).max(), 1e-6)
        assert np.percentile(rel, 75) < 1e-6, "bulk mismatch: not an fp-noise tail"
    else:
        assert_images_match(a, b, frac=frac)
