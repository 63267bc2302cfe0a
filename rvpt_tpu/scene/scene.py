"""Scene: differentiable structure-of-arrays pytree + host-side builder.

The reference's scene is `std::vector<Triangle>` + `std::vector<Material>`
mem-copied into SSBOs every frame (src/rvpt/rvpt.cpp:118-126,1041-1043).  The
scene here is an immutable pytree of arrays that lives on device and is
donated/reused across jit steps.  Analytic spheres and planes are first-class
primitive families alongside triangles (the reference keeps sphere/plane
intersectors in GLSL but only wires triangles into the scene —
assets/shaders/intersection.glsl:76-129; here they are fully wired).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..pytree import pytree_dataclass, static_field
from .materials import Materials


@pytree_dataclass
class Scene:
    # Triangles, SoA over [T]: vertices and per-face material id.
    tri_v0: jnp.ndarray  # f32[T,3]
    tri_v1: jnp.ndarray  # f32[T,3]
    tri_v2: jnp.ndarray  # f32[T,3]
    tri_mat: jnp.ndarray  # i32[T]
    # Spheres, SoA over [S].
    sph_center: jnp.ndarray  # f32[S,3]
    sph_radius: jnp.ndarray  # f32[S]
    sph_mat: jnp.ndarray  # i32[S]
    # Planes <p,n> = d, SoA over [P].
    pln_normal: jnp.ndarray  # f32[P,3]
    pln_d: jnp.ndarray  # f32[P]
    pln_mat: jnp.ndarray  # i32[P]
    materials: Materials
    # BVH over the triangle family (None until accel.build_bvh attaches one).
    bvh: object = None

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_planes(self) -> int:
        return self.pln_normal.shape[0]

    # Flat primitive-id layout: [triangles | spheres | planes].
    def prim_base(self) -> tuple[int, int, int]:
        t = self.num_triangles
        s = self.num_spheres
        return 0, t, t + s


class SceneBuilder:
    """Host-side mutable builder (the analog of RVPT::add_triangle /
    add_material, src/rvpt/rvpt.cpp:1041-1043)."""

    def __init__(self):
        self._tris: list[tuple] = []
        self._sphs: list[tuple] = []
        self._plns: list[tuple] = []
        self._mats: list[dict] = []

    def add_material(self, albedo, emission=(0.0, 0.0, 0.0), kind=0, ior=1.5) -> int:
        self._mats.append(
            dict(albedo=tuple(albedo), emission=tuple(emission), kind=int(kind), ior=float(ior))
        )
        return len(self._mats) - 1

    def add_triangle(self, v0, v1, v2, mat: int) -> "SceneBuilder":
        self._tris.append((tuple(v0), tuple(v1), tuple(v2), int(mat)))
        return self

    def add_quad(self, v0, v1, v2, v3, mat: int) -> "SceneBuilder":
        """Adds two triangles (v0,v1,v2) and (v0,v2,v3)."""
        self.add_triangle(v0, v1, v2, mat)
        self.add_triangle(v0, v2, v3, mat)
        return self

    def add_sphere(self, center, radius: float, mat: int) -> "SceneBuilder":
        self._sphs.append((tuple(center), float(radius), int(mat)))
        return self

    def add_plane(self, normal, d: float, mat: int) -> "SceneBuilder":
        self._plns.append((tuple(normal), float(d), int(mat)))
        return self

    def add_mesh(self, vertices: np.ndarray, faces: np.ndarray, mat: int) -> "SceneBuilder":
        """Bulk-add a triangle mesh: vertices f32[V,3], faces i32[F,3]."""
        v = np.asarray(vertices, np.float32)
        f = np.asarray(faces, np.int64)
        for a, b, c in f:
            self._tris.append((tuple(v[a]), tuple(v[b]), tuple(v[c]), int(mat)))
        return self

    def build(self) -> Scene:
        if self._tris:
            tv0 = jnp.asarray([t[0] for t in self._tris], jnp.float32)
            tv1 = jnp.asarray([t[1] for t in self._tris], jnp.float32)
            tv2 = jnp.asarray([t[2] for t in self._tris], jnp.float32)
            tm = jnp.asarray([t[3] for t in self._tris], jnp.int32)
        else:
            tv0 = tv1 = tv2 = jnp.zeros((0, 3), jnp.float32)
            tm = jnp.zeros((0,), jnp.int32)
        if self._sphs:
            sc = jnp.asarray([s[0] for s in self._sphs], jnp.float32)
            sr = jnp.asarray([s[1] for s in self._sphs], jnp.float32)
            sm = jnp.asarray([s[2] for s in self._sphs], jnp.int32)
        else:
            sc = jnp.zeros((0, 3), jnp.float32)
            sr = jnp.zeros((0,), jnp.float32)
            sm = jnp.zeros((0,), jnp.int32)
        if self._plns:
            pn = jnp.asarray([p[0] for p in self._plns], jnp.float32)
            pd = jnp.asarray([p[1] for p in self._plns], jnp.float32)
            pm = jnp.asarray([p[2] for p in self._plns], jnp.int32)
        else:
            pn = jnp.zeros((0, 3), jnp.float32)
            pd = jnp.zeros((0,), jnp.float32)
            pm = jnp.zeros((0,), jnp.int32)
        return Scene(
            tri_v0=tv0,
            tri_v1=tv1,
            tri_v2=tv2,
            tri_mat=tm,
            sph_center=sc,
            sph_radius=sr,
            sph_mat=sm,
            pln_normal=pn,
            pln_d=pd,
            pln_mat=pm,
            materials=Materials.from_list(self._mats),
        )
