"""Built-in demo scenes.

The reference hard-codes its demo scene in main (src/rvpt/main.cpp:102-107:
rabbit.obj + two Lambert materials).  These constructors cover the benchmark
configs from BASELINE.md: sphere+plane, Cornell box, and the OBJ mesh scene.
"""

from __future__ import annotations

import numpy as np

from ..models.camera import Camera
from .materials import DIELECTRIC, LAMBERT, MIRROR
from .scene import Scene, SceneBuilder


def sphere_plane(aspect: float = 1.0) -> tuple[Scene, Camera]:
    """Config 1: single sphere + ground plane, analytic intersections."""
    b = SceneBuilder()
    m_ground = b.add_material(albedo=(0.8, 0.8, 0.8), kind=LAMBERT)
    m_ball = b.add_material(albedo=(0.7, 0.3, 0.2), kind=LAMBERT)
    b.add_plane((0.0, 1.0, 0.0), -1.0, m_ground)
    b.add_sphere((0.0, 0.0, 4.0), 1.0, m_ball)
    cam = Camera.create(translation=(0, 0, 0), fov=90.0, aspect=aspect)
    return b.build(), cam


def cornell_box(aspect: float = 1.0, light_emission: float = 12.0) -> tuple[Scene, Camera]:
    """Config 2: Cornell box from quads + two spheres, area light in the
    ceiling.  Built from triangles (quads split exactly like SceneBuilder
    .add_quad) so both the brute-force and BVH paths exercise it."""
    b = SceneBuilder()
    white = b.add_material(albedo=(0.73, 0.73, 0.73), kind=LAMBERT)
    red = b.add_material(albedo=(0.65, 0.05, 0.05), kind=LAMBERT)
    green = b.add_material(albedo=(0.12, 0.45, 0.15), kind=LAMBERT)
    light = b.add_material(
        albedo=(0.0, 0.0, 0.0),
        emission=(light_emission, light_emission, light_emission),
        kind=LAMBERT,
    )
    mirror = b.add_material(albedo=(0.9, 0.9, 0.9), kind=MIRROR)
    glass = b.add_material(albedo=(0.98, 0.98, 0.98), kind=DIELECTRIC, ior=1.5)

    s = 1.0  # half-extent; box spans [-1,1]^2 in x,y and [2,4] in z
    z0, z1 = 2.0, 4.0
    # floor (y=-1)
    b.add_quad((-s, -s, z0), (s, -s, z0), (s, -s, z1), (-s, -s, z1), white)
    # ceiling (y=+1)
    b.add_quad((-s, s, z0), (-s, s, z1), (s, s, z1), (s, s, z0), white)
    # back wall (z=z1)
    b.add_quad((-s, -s, z1), (s, -s, z1), (s, s, z1), (-s, s, z1), white)
    # left wall (x=-1), red
    b.add_quad((-s, -s, z0), (-s, -s, z1), (-s, s, z1), (-s, s, z0), red)
    # right wall (x=+1), green
    b.add_quad((s, -s, z0), (s, s, z0), (s, s, z1), (s, -s, z1), green)
    # ceiling light patch
    l = 0.35
    lz0, lz1 = 2.65, 3.35
    eps = 1e-3
    b.add_quad(
        (-l, s - eps, lz0), (-l, s - eps, lz1), (l, s - eps, lz1), (l, s - eps, lz0),
        light,
    )
    # two spheres
    b.add_sphere((-0.45, -0.62, 3.3), 0.38, mirror)
    b.add_sphere((0.45, -0.62, 2.8), 0.38, glass)

    cam = Camera.create(translation=(0, 0, 0), fov=68.0, aspect=aspect)
    return b.build(), cam


def mesh_demo(
    subdiv: int = 4, aspect: float = 1.0
) -> tuple[Scene, Camera]:
    """Config 4 workload: a dense icosphere (20*4^subdiv triangles) on a
    floor plane under an area light, BVH-attached (the CPU search route
    traverses it; ops.route)."""
    from .bvh import attach_bvh
    from .obj_io import make_icosphere

    b = SceneBuilder()
    floor = b.add_material(albedo=(0.75, 0.75, 0.75), kind=LAMBERT)
    body = b.add_material(albedo=(0.7, 0.25, 0.2), kind=LAMBERT)
    light = b.add_material(
        albedo=(0.0, 0.0, 0.0), emission=(10.0, 10.0, 10.0), kind=LAMBERT
    )
    b.add_plane((0.0, 1.0, 0.0), -1.0, floor)
    v, f = make_icosphere(subdiv=subdiv, radius=1.0)
    b.add_mesh(v + np.asarray([0.0, 0.0, 4.0], np.float32), f, body)
    b.add_quad(
        (-1.2, 2.4, 3.0), (-1.2, 2.4, 5.0), (1.2, 2.4, 5.0), (1.2, 2.4, 3.0),
        light,
    )
    cam = Camera.create(translation=(0.0, 0.4, 0.0), fov=70.0, aspect=aspect)
    return attach_bvh(b.build()), cam


def terrain_demo(n: int = 225, aspect: float = 1.0) -> tuple[Scene, Camera]:
    """>=100k-triangle workload (n=225 -> 100,352 tris): a sinusoidal
    heightfield under an area light, BVH-attached."""
    from .bvh import attach_bvh
    from .obj_io import make_terrain

    b = SceneBuilder()
    ground = b.add_material(albedo=(0.55, 0.5, 0.4), kind=LAMBERT)
    light = b.add_material(
        albedo=(0.0, 0.0, 0.0), emission=(8.0, 8.0, 8.0), kind=LAMBERT
    )
    v, f = make_terrain(n=n)
    b.add_mesh(v, f, ground)
    b.add_quad(
        (-1.5, 4.0, -1.5), (-1.5, 4.0, 1.5), (1.5, 4.0, 1.5), (1.5, 4.0, -1.5),
        light,
    )
    cam = Camera.create(
        translation=(0.0, 2.6, -4.2), rotation=(0.0, 30.0, 0.0),
        fov=70.0, aspect=aspect,
    )
    return attach_bvh(b.build()), cam


def rabbit(aspect: float = 2.0, use_bvh: bool = True) -> tuple["Scene", Camera]:
    """THE reference demo scene (src/rvpt/main.cpp:96-107): models/rabbit.obj
    (76 verts / 143 tris) as material 1, with material 0 = Lambert(1,1,1) +
    emission(0.1,0.4,0.6) and material 1 = plain white Lambert, on the
    reference's fixed 1024x512 film (aspect 2).  BVH-attached by default,
    like the reference's GPU BVH traversal
    (assets/shaders/intersection.glsl:361-413)."""
    from ..config import get_asset_path
    from .bvh import attach_bvh
    from .obj_io import load_obj

    v, f = load_obj(get_asset_path("models/rabbit.obj"))
    scene, cam = mesh_scene(v, f, aspect=aspect)
    return (attach_bvh(scene) if use_bvh else scene), cam


def mesh_scene(
    vertices: np.ndarray, faces: np.ndarray, aspect: float = 2.0
) -> tuple[Scene, Camera]:
    """Config 3: a triangle mesh with the reference's two demo materials
    (main.cpp:105-107): material 0 emissive-ish Lambert, material 1 white
    Lambert assigned to the mesh."""
    b = SceneBuilder()
    b.add_material(albedo=(1.0, 1.0, 1.0), emission=(0.1, 0.4, 0.6), kind=LAMBERT)
    m_mesh = b.add_material(albedo=(1.0, 1.0, 1.0), kind=LAMBERT)
    b.add_mesh(vertices, faces, m_mesh)
    cam = Camera.create(translation=(0.0, 1.0, -3.0), fov=90.0, aspect=aspect)
    return b.build(), cam
