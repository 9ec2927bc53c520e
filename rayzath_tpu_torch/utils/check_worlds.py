"""Small worlds of the JAX package's test suite, built from the port's
classes, for the checks that run where jax is not installed
(``chip_smoke.py``, ``tools/profile_torch.py``) and for the port's tests.

* :func:`cutout_world`: ``tests/test_oracle_parity.py`` ``_cutout_scene``, a
  transparent leaf quad with a checker-alpha texture between a spot light
  and a floor, whose shadow must be filtered through the texture alpha.
* :func:`lit_world`: ``tests/test_gradients.py`` ``lit_world``, a spot and
  a direct light over a glossy floor with a translucent blocker.
* :func:`empty_world`: no geometry at all (the dense path's empty case).
* :func:`canopy_shadow_rays`: seeded shadow rays through the leaf canopy
  of ``scenes.leaf_canopy``, the checks of B2's cutout variant.
* :func:`scene_files`: a world written out as scene files (a JSON scene,
  one OBJ and MTL per mesh, an HDR sky), the fixture of the scene-file
  checks; :func:`write_hdr` writes the ``.hdr``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .. import scenes
from ..models.texture import Texture
from ..models.world import World
from .hostmath import Transform


def cutout_world(res: int) -> World:
    w = World()
    floor_mat = w.create_material("floor", color=(0.8, 0.8, 0.8, 1.0))
    n = 32
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    holes = ((xx // 4 + yy // 4) % 2).astype(np.float32)       # checker alpha
    rgba = np.stack([np.full((n, n), 0.2, np.float32),
                     np.full((n, n), 0.7, np.float32),
                     np.full((n, n), 0.2, np.float32), holes], -1)
    tex = Texture(name="leaf", data=rgba, filter_mode="point",
                  address_mode="clamp")
    w.textures.create(tex)
    leaf_mat = w.create_material("leaf", color=(1, 1, 1, 0.0))  # transparent
    leaf_mat.texture = tex
    floor = scenes._quad("floor", (-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3))
    w.meshes.create(floor)
    w.create_instance(name="floor", mesh=floor, materials=[floor_mat])
    leaf = scenes._quad("leaf", (-1, 1.5, -1), (1, 1.5, -1), (1, 1.5, 1),
                        (-1, 1.5, 1))
    w.meshes.create(leaf)
    w.create_instance(name="leaf", mesh=leaf, materials=[leaf_mat])
    w.create_spot_light(position=(0, 4.0, 0), direction=(0, -1, 0),
                        color=(1, 1, 1), size=0.2, emission=120.0,
                        beam_angle=1.2)
    cam = w.create_camera("camera", position=(0, 3.2, -3.4),
                          resolution=(res, res), fov=1.1, focal_distance=4.0,
                          aperture=0.001, exposure_time=3.0)
    cam.look_at((0, 0, 0))
    return w


def lit_world(res: int) -> World:
    w = World()
    floor_m = w.create_material("floor", color=(0.6, 0.6, 0.6, 1.0),
                                roughness=0.3, metalness=0.2)
    blocker_m = w.create_material("blocker", color=(0.8, 0.3, 0.2, 0.55))
    plane = w.generate_mesh("plane", sides=4, width=6.0, height=6.0)
    w.create_instance(name="floor", mesh=plane, materials=[floor_m])
    cube = w.generate_mesh("cube")
    w.create_instance(name="blocker", mesh=cube, materials=[blocker_m],
                      transform=Transform(position=(0, 1.0, 0),
                                          scale=(0.8, 0.2, 0.8)))
    w.create_spot_light(position=(0.0, 3.0, 0.0), direction=(0, -1, 0),
                        size=0.4, emission=30.0, beam_angle=1.2)
    w.create_direct_light(direction=(-0.4, -1.0, 0.2), emission=5.0,
                          angular_size=0.1)
    cam = w.create_camera("cam", position=(0, 2.0, -4.0), resolution=(res, res),
                          aperture=0.01, exposure_time=1.0)
    cam.look_at((0, 0.3, 0))
    return w


def canopy_shadow_rays(world: World, n: int, seed: int, device="cpu",
                       on_cards: bool = False):
    """(origin [n,3], direction [n,3], dist [n]) of ``n`` shadow rays as a
    bounce of ``scenes.leaf_canopy`` casts them: from points on the ground
    under the crown (first half) and inside the crown (second half), drawn
    from ``seed``, every other ray to a point on the spot light's disk
    (dist: its distance) and the rest against the direct light's direction
    (dist: 3e38), except every fourth ray, which passes through a random
    point of a random card (dist: 3e38), so that a sparse crown is hit
    too. With ``on_cards`` every ray starts instead at a random point of a
    random card (drawn from a second generator of ``seed``; the rest as
    above), as a bounce off a leaf does before the integrator's nudge
    along the normal: the ray meets its own card within float rounding of
    t = 0, on its front or its back. A ray of those within 10 degrees of
    its card's plane leaves along the card's upward normal instead (dist:
    3e38): the rounding of the hit's barycentrics on its own card grows
    as 1 / |cos| of the angle between the ray and the card's normal, so
    that at a grazing angle it moves the hit by a texel of the leaf map
    and more."""
    import torch
    g = np.random.default_rng(seed)
    half = n // 2
    o = np.empty((n, 3), np.float64)
    o[:half, 0] = g.uniform(-6.0, 6.0, half)
    o[:half, 1] = 1e-3
    o[:half, 2] = g.uniform(-6.0, 6.0, half)
    v = g.normal(size=(n - half, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o[half:] = (v * g.random((n - half, 1)) ** (1.0 / 3.0) * (5.0, 2.5, 5.0)
                + (0.0, 4.5, 0.0))
    crown = next(i.mesh for i in world.instances if i.name == "crown")
    quads = crown.vertices.reshape(-1, 4, 3).astype(np.float64)
    if on_cards:
        g2 = np.random.default_rng([seed, 1])
        own = quads[g2.integers(0, len(quads), n)]
        s, t = g2.random((2, n, 1))
        o = (own[:, 0] + s * (own[:, 1] - own[:, 0])
             + t * (own[:, 3] - own[:, 0]))
    spot, = world.spot_lights
    sun, = world.direct_lights
    d = np.empty((n, 3), np.float64)
    dist = np.full(n, 3e38)
    to_spot = np.arange(n) % 2 == 0
    disk = np.asarray(spot.position, np.float64) + np.concatenate(
        [g.uniform(-spot.size, spot.size, (n, 1)), np.zeros((n, 1)),
         g.uniform(-spot.size, spot.size, (n, 1))], 1)
    d[to_spot] = disk[to_spot] - o[to_spot]
    dist[to_spot] = np.linalg.norm(d[to_spot], axis=1)
    d[~to_spot] = -np.asarray(sun.direction, np.float64)
    # every fourth ray from its origin through a point of a random card of
    # the crown (within its square), on to the sky
    pick = quads[g.integers(0, len(quads), n)]
    s, t = g.random((2, n, 1))
    target = (pick[:, 0] + s * (pick[:, 1] - pick[:, 0])
              + t * (pick[:, 3] - pick[:, 0]))
    aim = np.arange(n) % 4 == 1
    d[aim] = target[aim] - o[aim]
    dist[aim] = 3e38
    d[np.linalg.norm(d, axis=1) == 0.0] = -np.asarray(sun.direction)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if on_cards:
        up = np.cross(own[:, 1] - own[:, 0], own[:, 3] - own[:, 0])
        up *= np.sign(up[:, 1:2]) / np.linalg.norm(up, axis=1, keepdims=True)
        graze = np.abs((d * up).sum(1)) < np.sin(np.radians(10.0))
        d[graze], dist[graze] = up[graze], 3e38

    def t(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    return t(o), t(d), t(dist)


def empty_world(res: int, world_cls=World) -> World:
    """A camera, a direct light and a glowing sky, and no geometry: it
    compiles no cluster table, so every ray takes the dense path and misses.
    ``world_cls`` builds it from another package's ``World`` (the JAX
    package's, in the parity tests)."""
    w = world_cls()
    w.material.emission = 0.7
    w.create_direct_light(direction=(-0.4, -1.0, 0.2), emission=5.0,
                          angular_size=0.1)
    w.create_camera("cam", position=(0, 1.0, -3.0), resolution=(res, res),
                    aperture=0.01, exposure_time=1.0)
    return w


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write float rgb [H,W,3] as a flat (uncompressed) Radiance RGBE file,
    the encoding of ``tests/test_hdr.py``'s fixture writer."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    mx = rgb.max(axis=2)
    nz = mx > 1e-32
    e = np.zeros((h, w), np.int32)
    e[nz] = np.frexp(mx[nz])[1]               # mx = m * 2^e, m in [0.5, 1)
    scale = np.where(nz, np.ldexp(1.0, -e + 8), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(np.rint(rgb * scale[..., None]), 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def scene_files(world: World, directory: str) -> str:
    """Write ``world`` into ``directory`` as scene files and return the path
    of the JSON scene: ``save_scene`` writes ``scene.json`` (texture maps as
    PNG, which need PIL to load back); each mesh then moves into
    ``meshes/<name>.obj`` (``save_obj``, with an ``mtllib`` line) beside
    ``meshes/<name>.mtl``
    (``save_mtl``, the materials of the instances that use it), referenced
    from the JSON by ``"file"``; and the world material gets an HDR sky,
    ``sky.hdr`` (a blue-to-white gradient of radiance 0.6-1.2), loaded as
    its texture and its emission map. Mesh names must be unique."""
    from ..io.obj import save_mtl, save_obj
    path = os.path.join(directory, "scene.json")
    world.save_scene(path)
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    os.makedirs(os.path.join(directory, "meshes"), exist_ok=True)
    entries = []
    for mesh in world.meshes:
        stem = os.path.join("meshes", mesh.name)
        mats = {id(m): m for inst in world.instances if inst.mesh is mesh
                for m in inst.materials if m is not None}
        save_mtl(os.path.join(directory, stem + ".mtl"), list(mats.values()),
                 save_maps=False)
        save_obj(os.path.join(directory, stem + ".obj"), [mesh],
                 mtl_name=mesh.name + ".mtl")
        entries.append({"name": mesh.name, "file": stem + ".obj"})
    if entries:
        doc["Objects"]["Mesh"] = entries
    t = np.linspace(0.0, 1.0, 16, dtype=np.float32)[:, None, None]
    sky = (1.0 - t) * np.asarray([0.6, 0.8, 1.2], np.float32) + t * 1.0
    write_hdr(os.path.join(directory, "sky.hdr"),
              np.broadcast_to(sky, (16, 32, 3)))
    doc["Objects"].setdefault("Texture", []).append(
        {"name": "sky", "file": "sky.hdr"})
    doc["Material"]["texture"] = "sky"
    doc["Material"]["emission map"] = "sky emission"
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
    return path
