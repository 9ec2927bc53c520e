"""Built-in benchmark scenes (BASELINE.md configs).

These mirror the driver's benchmark configurations: Cornell box (diffuse, the
headline perf scene), a mesh + mirror/glossy scene, a multi-light NEE scene,
and a refractive/scattering + depth-of-field scene.
"""
from __future__ import annotations

import numpy as np

from .models import World, Material
from .models.mesh import Mesh
from .utils.hostmath import Transform


def _quad(name: str, p0, p1, p2, p3) -> Mesh:
    """Two-triangle quad with consistent winding (normal = cross(p1-p0, p3-p0))."""
    v = np.asarray([p0, p1, p2, p3], np.float32)
    t = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tri_v = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return Mesh(name, vertices=v, texcrds=t, tri_v=tri_v, tri_t=tri_v.copy())


def cornell_box(width: int = 512, height: int = 512,
                light_emission: float = 40.0) -> World:
    """Classic Cornell box: white floor/ceiling/back, red left, green right,
    two boxes, emissive ceiling quad. Diffuse-only materials (BASELINE config 1).

    Box is [-1,1]^3 in x/y, z in [0,2]; camera looks down +z.
    """
    w = World()
    white = w.create_material("white", color=(0.73, 0.73, 0.73, 1.0))
    red = w.create_material("red", color=(0.65, 0.05, 0.05, 1.0))
    green = w.create_material("green", color=(0.12, 0.45, 0.15, 1.0))
    light = w.create_material("light", color=(1.0, 0.84, 0.6, 1.0),
                              emission=light_emission)

    def add(mesh: Mesh, mat: Material):
        w.meshes.create(mesh)
        w.create_instance(name=mesh.name, mesh=mesh, materials=[mat])

    # walls (normals facing inward)
    add(_quad("floor", (-1, -1, 0), (1, -1, 0), (1, -1, 2), (-1, -1, 2)), white)
    add(_quad("ceiling", (-1, 1, 0), (-1, 1, 2), (1, 1, 2), (1, 1, 0)), white)
    add(_quad("back", (-1, -1, 2), (1, -1, 2), (1, 1, 2), (-1, 1, 2)), white)
    add(_quad("left", (-1, -1, 0), (-1, -1, 2), (-1, 1, 2), (-1, 1, 0)), red)
    add(_quad("right", (1, -1, 0), (1, 1, 0), (1, 1, 2), (1, -1, 2)), green)
    # ceiling light (slightly below ceiling, facing down)
    add(_quad("lamp", (-0.3, 0.995, 0.7), (-0.3, 0.995, 1.3),
              (0.3, 0.995, 1.3), (0.3, 0.995, 0.7)), light)

    # two boxes
    tall = w.generate_mesh("cube")
    tall.name = "tall box"
    w.create_instance(
        name="tall box", mesh=tall, materials=[white],
        transform=Transform(position=(-0.35, -0.4, 1.4), rotation=(0, 0.3, 0),
                            scale=(0.6, 1.2, 0.6)))
    short = w.generate_mesh("cube")
    short.name = "short box"
    w.create_instance(
        name="short box", mesh=short, materials=[white],
        transform=Transform(position=(0.4, -0.7, 0.9), rotation=(0, -0.35, 0),
                            scale=(0.6, 0.6, 0.6)))

    cam = w.create_camera(
        "camera", position=(0.0, 0.0, -1.95), resolution=(width, height),
        fov=float(np.pi / 4) * 1.6, focal_distance=3.0, aperture=0.02,
        exposure_time=1.0 / 60.0)
    cam.look_at((0.0, 0.0, 1.0))
    return w


def teapot_like(width: int = 512, height: int = 512) -> World:
    """Mesh + mirror/glossy + per-vertex normals (BASELINE config 2):
    a smooth uv-sphere and a torus on a plane, mirror + glossy materials,
    one direct light."""
    w = World()
    ground = w.generate_material("paper")
    mirror = w.generate_material("mirror")
    gold = w.generate_material("gold")
    plane = w.generate_mesh("plane", sides=4, width=8.0, height=8.0)
    w.create_instance(name="ground", mesh=plane, materials=[ground],
                      transform=Transform(position=(0, -1, 0)))
    sphere = w.generate_mesh("sphere", resolution=32)
    w.create_instance(name="mirror sphere", mesh=sphere, materials=[mirror],
                      transform=Transform(position=(-1.2, 0, 0)))
    torus = w.generate_mesh("torus", major_resolution=48, minor_resolution=24)
    w.create_instance(name="gold torus", mesh=torus, materials=[gold],
                      transform=Transform(position=(1.2, -0.5, 0), rotation=(0.9, 0, 0)))
    w.create_direct_light(direction=(-0.5, -1.0, 0.5), emission=8.0, angular_size=0.1)
    w.material.emission = 0.6  # dim sky dome
    cam = w.create_camera("camera", position=(0, 1.2, -4.5), resolution=(width, height),
                          fov=float(np.pi / 3), focal_distance=4.5, aperture=0.001,
                          exposure_time=6.7)
    cam.look_at((0, -0.2, 0))
    return w


def multi_light(width: int = 512, height: int = 512) -> World:
    """NEE + MIS scene (BASELINE config 3): spot + direct lights, soft shadows."""
    w = World()
    white = w.create_material("white", color=(0.8, 0.8, 0.8, 1.0))
    rough = w.create_material("rough", color=(0.6, 0.6, 0.9, 1.0), roughness=0.3, ior=1.5)
    plane = w.generate_mesh("plane", sides=4, width=10.0, height=10.0)
    w.create_instance(name="ground", mesh=plane, materials=[white],
                      transform=Transform(position=(0, 0, 0)))
    cube = w.generate_mesh("cube")
    w.create_instance(name="cube", mesh=cube, materials=[rough],
                      transform=Transform(position=(0, 0.5, 0)))
    sph = w.generate_mesh("sphere", resolution=24)
    w.create_instance(name="sphere", mesh=sph, materials=[white],
                      transform=Transform(position=(1.8, 0.5, 0.5), scale=(0.5, 0.5, 0.5)))
    w.create_spot_light(position=(-2.0, 3.0, -1.0), direction=(0.5, -1.0, 0.3),
                        color=(1.0, 0.9, 0.7), size=0.3, emission=120.0, beam_angle=0.7)
    w.create_spot_light(position=(2.5, 2.5, -2.0), direction=(-0.6, -0.8, 0.6),
                        color=(0.4, 0.6, 1.0), size=0.2, emission=90.0, beam_angle=0.5)
    w.create_direct_light(direction=(0.3, -1.0, 0.2), emission=3.0, angular_size=0.05)
    cam = w.create_camera("camera", position=(0, 2.0, -5.0), resolution=(width, height),
                          fov=float(np.pi / 3), focal_distance=5.0, aperture=0.002,
                          exposure_time=1.67)
    cam.look_at((0, 0.4, 0))
    return w


def glass_and_fog(width: int = 512, height: int = 512) -> World:
    """Refractive/scattering nested objects + DoF camera (BASELINE config 4)."""
    w = World()
    white = w.create_material("white", color=(0.75, 0.75, 0.75, 1.0))
    glass = w.generate_material("glass")
    fog = w.create_material("fog", color=(0.9, 0.95, 1.0, 0.0), ior=1.0, scattering=0.8)
    plane = w.generate_mesh("plane", sides=4, width=8.0, height=8.0)
    w.create_instance(name="ground", mesh=plane, materials=[white],
                      transform=Transform(position=(0, -1, 0)))
    sph = w.generate_mesh("sphere", resolution=32)
    w.create_instance(name="glass sphere", mesh=sph, materials=[glass],
                      transform=Transform(position=(-0.9, 0, 0)))
    w.create_instance(name="fog sphere", mesh=sph, materials=[fog],
                      transform=Transform(position=(1.1, 0, 0.6)))
    w.create_direct_light(direction=(-0.4, -1.0, 0.3), emission=6.0, angular_size=0.1)
    w.material.emission = 0.8
    cam = w.create_camera("camera", position=(0.3, 0.6, -4.0), resolution=(width, height),
                          fov=float(np.pi / 3), focal_distance=4.0, aperture=0.06,
                          exposure_time=0.0019)
    cam.look_at((0, -0.1, 0))
    return w


def textured_room(width: int = 512, height: int = 512) -> World:
    """All map kinds + instancing + progressive (BASELINE config 5, the
    living-room analog): checkerboard floor texture, normal-mapped back wall,
    metalness/roughness-mapped spheres (several instances of one mesh), an
    emission-mapped panel light, and a spot light for NEE."""
    from .models.texture import (Texture, NormalMap, MetalnessMap,
                                 RoughnessMap, EmissionMap)
    w = World()

    # checkerboard color texture (wrap + linear, tiled via UV scale)
    n = 64
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    check = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    check_rgba = np.stack([0.2 + 0.6 * check, 0.2 + 0.3 * check,
                           0.25 + 0.15 * check, np.ones((n, n), np.float32)], -1)
    tex = Texture(name="checker", data=check_rgba, filter_mode="linear",
                  address_mode="wrap", scale=(4.0, 4.0))
    w.textures.create(tex)

    # sine-ripple normal map
    u = np.linspace(0, 8 * np.pi, n)
    nx = 0.35 * np.sin(u)[None, :] * np.ones((n, 1), np.float32)
    ny = 0.35 * np.sin(u)[:, None] * np.ones((1, n), np.float32)
    nz = np.sqrt(np.maximum(1.0 - nx * nx - ny * ny, 0.0))
    nmap = NormalMap(name="ripple",
                     data=np.stack([nx, ny, nz], -1) * 0.5 + 0.5,
                     filter_mode="linear", address_mode="mirror")
    w.normal_maps.create(nmap)

    # radial metalness + roughness maps
    r = np.sqrt((xx / n - 0.5) ** 2 + (yy / n - 0.5) ** 2).astype(np.float32)
    met = MetalnessMap(name="radial metal", data=np.clip(1.2 - 2.0 * r, 0, 1))
    rgh = RoughnessMap(name="radial rough", data=np.clip(2.0 * r, 0.02, 1.0))
    w.metalness_maps.create(met)
    w.roughness_maps.create(rgh)

    # emission grid panel
    egrid = (((xx // 16 + yy // 16) % 2) * 1.0).astype(np.float32)
    emap = EmissionMap(name="panel grid", data=egrid)
    w.emission_maps.create(emap)

    floor_mat = w.create_material("floor", color=(1, 1, 1, 1), roughness=0.8)
    floor_mat.texture = tex
    wall_mat = w.create_material("wall", color=(0.7, 0.68, 0.6, 1.0), roughness=0.6)
    wall_mat.normal_map = nmap
    ball_mat = w.create_material("ball", color=(0.9, 0.6, 0.3, 1.0))
    ball_mat.metalness_map = met
    ball_mat.roughness_map = rgh
    panel_mat = w.create_material("panel", color=(1.0, 0.95, 0.8, 1.0), emission=25.0)
    panel_mat.emission_map = emap

    floor = _quad("floor", (-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4))
    w.meshes.create(floor)
    w.create_instance(name="floor", mesh=floor, materials=[floor_mat])
    wall = _quad("wall", (-4, 0, 4), (4, 0, 4), (4, 4, 4), (-4, 4, 4))
    w.meshes.create(wall)
    w.create_instance(name="wall", mesh=wall, materials=[wall_mat])
    panel = _quad("panel", (-1, 3.6, 1), (1, 3.6, 1), (1, 3.6, -1), (-1, 3.6, -1))
    w.meshes.create(panel)
    w.create_instance(name="panel", mesh=panel, materials=[panel_mat])

    sph = w.generate_mesh("sphere", resolution=24)
    for i, (px, pz, s) in enumerate([(-1.6, 0.6, 0.8), (0.0, -0.4, 0.6),
                                     (1.7, 0.9, 1.0)]):
        w.create_instance(name=f"ball {i}", mesh=sph, materials=[ball_mat],
                          transform=Transform(position=(px, 0.6 * s, pz),
                                              scale=(0.6 * s,) * 3))

    w.create_spot_light(position=(-3.0, 3.5, -3.0), direction=(0.7, -0.8, 0.7),
                        color=(1.0, 0.95, 0.9), size=0.25, emission=80.0,
                        beam_angle=0.8)
    cam = w.create_camera("camera", position=(0, 1.8, -5.5),
                          resolution=(width, height), fov=float(np.pi / 3),
                          focal_distance=6.0, aperture=0.01, exposure_time=0.12)
    cam.look_at((0, 0.8, 0.5))
    return w


def mesh_heavy(width: int = 512, height: int = 512,
               resolution: int = 256) -> World:
    """One big displaced mesh (~2*resolution^2 triangles; 131k at the default)
    on a ground plane. Nothing here fits a VMEM-resident packet table — this
    is the honest BVH-scaling benchmark: traversal must stream the segmented
    cluster frames from HBM (ops/traverse_cluster.py)."""
    w = World()
    ground = w.generate_material("paper")
    body = w.create_material("body", color=(0.7, 0.55, 0.4, 1.0),
                             roughness=0.35, ior=1.4)
    sph = w.generate_mesh("sphere", resolution=resolution)
    # radial displacement turns the sphere into a lumpy blob so the BVH is
    # non-trivial (deep, uneven subtrees) and normals stay per-vertex smooth
    v = sph.vertices
    r = np.linalg.norm(v, axis=1, keepdims=True)
    bump = (0.18 * np.sin(6.0 * v[:, 0:1] / np.maximum(r, 1e-6))
            * np.cos(5.0 * v[:, 1:2] / np.maximum(r, 1e-6))
            + 0.1 * np.sin(9.0 * v[:, 2:3] / np.maximum(r, 1e-6)))
    sph.vertices = (v * (1.0 + bump)).astype(np.float32)
    sph.normals = np.zeros((0, 3), np.float32)  # flat normals from geometry
    sph.tri_n = np.full_like(sph.tri_v, -1)
    sph.name = "blob"
    w.create_instance(name="blob", mesh=sph, materials=[body],
                      transform=Transform(position=(0, 0.2, 0)))
    plane = w.generate_mesh("plane", sides=4, width=10.0, height=10.0)
    w.create_instance(name="ground", mesh=plane, materials=[ground],
                      transform=Transform(position=(0, -1.05, 0)))
    w.create_direct_light(direction=(-0.5, -1.0, 0.4), emission=7.0,
                          angular_size=0.08)
    w.material.emission = 0.5
    cam = w.create_camera("camera", position=(0, 0.9, -3.6),
                          resolution=(width, height), fov=float(np.pi / 3),
                          focal_distance=3.6, aperture=0.001,
                          exposure_time=5.0)
    cam.look_at((0, 0.0, 0))
    return w


def instanced_field(width: int = 512, height: int = 512,
                    n: int = 12, resolution: int = 48) -> World:
    """A ground plane and n*n instances of ONE sphere mesh (2,208 triangles
    at resolution 48: 317,954 expanded triangles at the defaults, one
    2,210-triangle object-space table in memory). Exercises the
    TLAS-over-instances path (reference cuda_bvh.cuh:114-171) at a scale the
    world-space soup could not hold."""
    w = World()
    ground = w.generate_material("paper")
    mats = [w.create_material(f"m{i}", color=c, roughness=rg, ior=1.45)
            for i, (c, rg) in enumerate([
                ((0.8, 0.3, 0.25, 1.0), 0.6), ((0.3, 0.6, 0.8, 1.0), 0.2),
                ((0.85, 0.7, 0.3, 1.0), 0.05), ((0.4, 0.75, 0.4, 1.0), 0.9)])]
    sph = w.generate_mesh("sphere", resolution=resolution)
    plane = w.generate_mesh("plane", sides=4, width=40.0, height=40.0)
    w.create_instance(name="ground", mesh=plane, materials=[ground],
                      transform=Transform(position=(0, -0.5, 0)))
    rng = np.random.default_rng(5)
    for i in range(n):
        for j in range(n):
            s = float(0.25 + 0.3 * rng.random())
            x = (i - (n - 1) / 2) * 1.25 + float(rng.normal(0, 0.15))
            z = (j - (n - 1) / 2) * 1.25 + float(rng.normal(0, 0.15))
            w.create_instance(
                name=f"ball {i}-{j}", mesh=sph,
                materials=[mats[(i * n + j) % len(mats)]],
                transform=Transform(position=(x, -0.5 + s, z),
                                    scale=(s, s, s)))
    w.create_direct_light(direction=(-0.4, -1.0, 0.5), emission=6.0,
                          angular_size=0.1)
    w.material.emission = 0.55
    cam = w.create_camera("camera", position=(0, 4.2, -9.5),
                          resolution=(width, height), fov=float(np.pi / 3),
                          focal_distance=10.0, aperture=0.001,
                          exposure_time=6.0)
    cam.look_at((0, 0.0, 0))
    return w


def cornell_box_nee(width: int = 512, height: int = 512) -> World:
    """Cornell box with an explicit spot light at the lamp: the NEE-honest
    headline config. Plain ``cornell_box`` is lit only by its emissive quad,
    so its benchmark never pays shadow rays; the reference's benchmark loop
    always does (Application/headless.cpp:207-246). This variant keeps the
    emissive quad (dimmed) and adds a disk spot light just below it, so the
    measured rays/s includes NEE + shadow traversal every bounce."""
    w = cornell_box(width, height, light_emission=8.0)
    w.create_spot_light(name="lamp light", position=(0.0, 0.97, 1.0),
                        direction=(0.0, -1.0, 0.0), color=(1.0, 0.84, 0.6),
                        size=0.3, emission=40.0, beam_angle=1.5)
    return w


def mesh_massive(width: int = 512, height: int = 512) -> World:
    """~500k-triangle displaced blob: the streamed-HBM scale proof (VERDICT
    r4 item 6). Cluster tables run to ~5.5k clusters — far past
    RESIDENT_CLUSTERS — so every visit DMAs its frames from HBM."""
    return mesh_heavy(width, height, resolution=708)


def _leaf_maps(size: int = 256):
    """Four 256x256 RGBA leaf textures: green RGB with a darker midrib and
    a leaf silhouette in alpha (1 on the leaf, 0 around it) that covers
    55% of the card, each leaf a little longer or wider than the next."""
    from .models.texture import Texture
    c = (np.arange(size, dtype=np.float64) + 0.5) / size * 2.0 - 1.0
    y, x = np.meshgrid(c, c, indexing="ij")          # rows: v, columns: u
    greens = [(0.16, 0.42, 0.10), (0.22, 0.50, 0.14), (0.12, 0.36, 0.08),
              (0.26, 0.55, 0.17)]
    maps = []
    for k, rgb in enumerate(greens):
        a = 0.98 - 0.04 * k                # half-length along v
        # a lens-shaped leaf |x| < b (1 - (y / a)^2)^0.75, its width b set
        # so that the silhouette covers 55% of the card
        shape = np.clip(1.0 - (y / a) ** 2, 0.0, None) ** 0.75
        b = 0.55 / shape.mean()
        alpha = (np.abs(x) < b * shape).astype(np.float32)
        vein = 1.0 - 0.35 * np.exp(-(x / 0.03) ** 2)
        rgba = np.stack([np.full_like(x, rgb[0]) * vein,
                         np.full_like(x, rgb[1]) * vein,
                         np.full_like(x, rgb[2]) * vein, alpha], -1)
        maps.append(Texture(name=f"leaf {k}", data=rgba.astype(np.float32),
                            filter_mode="linear", address_mode="clamp"))
    return maps


def leaf_canopy(width: int = 512, height: int = 512,
                cards: int = 65536) -> World:
    """A tree crown of leaf cards over a ground plane: the texture-alpha
    cutout world of ``utils/check_worlds.py`` (a leaf quad with an alpha
    texture between a spot light and the floor) scaled up to a broadleaf
    crown, the scale of the foliage RayZath users render (cutout shadows:
    cuda_instance.cuh:92-164, cuda_material.cuh:86-95).

    ``cards`` square cards of side 0.093 m (two triangles each: 131,072 at
    the default), centred uniformly in an ellipsoid of radii (5, 2.5, 5) m
    whose centre is 4.5 m above a 40 m ground plane, their normals and
    in-plane turns uniform (vectorised draws of a fixed
    ``np.random.default_rng``), in one mesh and one instance, so the scene
    compiles as a soup. Four transparent leaf materials (colour (1, 1, 1,
    0)) each carry a 256x256 RGBA map (:func:`_leaf_maps`) whose alpha
    silhouette covers 55% of a card: a leaf area index of about 4 over the
    crown's footprint, so the ground under it is dappled, not black. A
    direct "sun" from above and a spot light above the crown pointing down
    through it send both NEE samples' shadow rays through the leaves; the
    sky glows as in the other scenes. The camera stands 1.7 m above the
    ground, 9 m from the trunk axis, and sees ground in and out of the
    crown's shadow, the crown, and sky beside and through it."""
    w = World()
    ground = w.generate_material("paper")
    maps = _leaf_maps()
    leaves = []
    for k, tex in enumerate(maps):
        w.textures.create(tex)
        m = w.create_material(f"leaf {k}", color=(1.0, 1.0, 1.0, 0.0))
        m.texture = tex
        leaves.append(m)

    rng = np.random.default_rng(11)
    n = int(cards)
    # centres uniform in the ellipsoid: a point of the unit ball, scaled
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    centre = (dirs * rng.random((n, 1)) ** (1.0 / 3.0) * (5.0, 2.5, 5.0)
              + (0.0, 4.5, 0.0))
    # card normals uniform on the sphere, then a uniform turn in the plane
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    helper = np.where(np.abs(nrm[:, 1:2]) < 0.9, (0.0, 1.0, 0.0), (1.0, 0.0, 0.0))
    tu = np.cross(nrm, helper)
    tu /= np.linalg.norm(tu, axis=1, keepdims=True)
    tv = np.cross(nrm, tu)
    turn = rng.random((n, 1)) * 2.0 * np.pi
    eu = np.cos(turn) * tu + np.sin(turn) * tv
    ev = -np.sin(turn) * tu + np.cos(turn) * tv
    h = 0.093 * 0.5
    corners = np.stack([centre - h * eu - h * ev, centre + h * eu - h * ev,
                        centre + h * eu + h * ev, centre - h * eu + h * ev], 1)
    base = 4 * np.arange(n, dtype=np.int32)[:, None]
    tri_v = np.concatenate([base + (0, 1, 2), base + (0, 2, 3)], 1).reshape(-1, 3)
    tri_t = np.tile(np.asarray([[0, 1, 2], [0, 2, 3]], np.int32), (n, 1))
    crown = Mesh("crown", vertices=corners.reshape(-1, 3).astype(np.float32),
                 texcrds=np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                 tri_v=tri_v, tri_t=tri_t,
                 tri_mat=np.repeat(rng.integers(0, len(leaves), n), 2))
    w.meshes.create(crown)
    w.create_instance(name="crown", mesh=crown, materials=leaves)
    plane = w.generate_mesh("plane", sides=4, width=40.0, height=40.0)
    w.create_instance(name="ground", mesh=plane, materials=[ground])

    w.create_direct_light(direction=(-0.25, -1.0, 0.2), emission=6.0,
                          angular_size=0.1)
    w.create_spot_light(position=(0.0, 9.5, 0.0), direction=(0.0, -1.0, 0.0),
                        color=(1.0, 0.96, 0.9), size=0.3, emission=400.0,
                        beam_angle=0.65)
    w.material.emission = 0.55
    cam = w.create_camera("camera", position=(0.0, 1.7, -9.0),
                          resolution=(width, height), fov=2.3,
                          focal_distance=9.0, aperture=0.001,
                          exposure_time=6.0)
    cam.look_at((0.0, 2.95, 0.0))
    return w


SCENES = {
    "cornell_box": cornell_box,
    "cornell_box_nee": cornell_box_nee,
    "teapot_like": teapot_like,
    "multi_light": multi_light,
    "glass_and_fog": glass_and_fog,
    "textured_room": textured_room,
    "mesh_heavy": mesh_heavy,
    "mesh_massive": mesh_massive,
    "instanced_field": instanced_field,
    "leaf_canopy": leaf_canopy,
}
