"""Small worlds of the JAX package's test suite, built from the port's
classes, for the checks that run where jax is not installed
(``chip_smoke.py``, ``tools/profile_torch.py``) and for the port's tests.

* :func:`cutout_world`: ``tests/test_oracle_parity.py`` ``_cutout_scene``, a
  transparent leaf quad with a checker-alpha texture between a spot light
  and a floor, whose shadow must be filtered through the texture alpha.
* :func:`lit_world`: ``tests/test_gradients.py`` ``lit_world``, a spot and
  a direct light over a glossy floor with a translucent blocker.
"""
from __future__ import annotations

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
