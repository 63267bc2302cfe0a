"""Camera model: a differentiable pytree + three ray generators.

The reference packs the camera as a 4x4 matrix plus (aspect, hfov, scale)
params uploaded per frame (src/rvpt/camera.cpp:55-66) and generates rays in
GLSL per pixel (assets/shaders/camera.glsl:29-99).  Here the camera is a
pytree whose leaves (translation, rotation, fov, scale) are differentiable,
and ray generation is one vectorized function over all film coordinates.

Matrix convention (matches glm usage in src/rvpt/camera.cpp:17-25):
``M = T(translation) @ R_y(rot.x) @ R_x(rot.y) @ R_z(rot.z)`` where rot is in
degrees, R_y is a rotation about the +Y ("UP") axis, R_x about +X ("RIGHT"),
R_z about +Z ("FORWARD").  ``M[:3, 3]`` is the camera origin, ``M[:3, 2]`` the
forward axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.math import PI, TWO_PI, normalize, unit_spherical_to_cartesian
from ..core.types import Ray
from ..pytree import pytree_dataclass, static_field

PINHOLE = 0
ORTHO = 1
SPHERICAL = 2

CAMERA_MODE_NAMES = {"pinhole": PINHOLE, "ortho": ORTHO, "spherical": SPHERICAL}


@pytree_dataclass
class Camera:
    translation: jnp.ndarray  # f32[3]
    rotation: jnp.ndarray  # f32[3], degrees, (yaw-about-Y, pitch-about-X, roll-about-Z)
    fov: jnp.ndarray  # f32 scalar, horizontal fov in degrees
    scale: jnp.ndarray  # f32 scalar, ortho half-extent scale
    aspect: float = static_field(default=2.0)
    mode: int = static_field(default=PINHOLE)

    @staticmethod
    def create(
        translation=(0.0, 0.0, 0.0),
        rotation=(0.0, 0.0, 0.0),
        fov: float = 90.0,
        scale: float = 5.0,
        aspect: float = 2.0,
        mode: int = PINHOLE,
    ) -> "Camera":
        return Camera(
            translation=jnp.asarray(translation, jnp.float32),
            rotation=jnp.asarray(rotation, jnp.float32),
            fov=jnp.asarray(fov, jnp.float32),
            scale=jnp.asarray(scale, jnp.float32),
            aspect=float(aspect),
            mode=int(mode),
        )


def _mm(a, b):
    """float32 matrix product at full precision: a plain ``@`` may run in
    TF32 on a GPU (~1e-3 relative error in every primary ray)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _axis_rotation(axis: int, radians: jnp.ndarray) -> jnp.ndarray:
    """3x3 right-handed rotation about a coordinate axis."""
    c, s = jnp.cos(radians), jnp.sin(radians)
    one, zero = jnp.ones_like(c), jnp.zeros_like(c)
    if axis == 0:  # X
        rows = [(one, zero, zero), (zero, c, -s), (zero, s, c)]
    elif axis == 1:  # Y
        rows = [(c, zero, s), (zero, one, zero), (-s, zero, c)]
    else:  # Z
        rows = [(c, -s, zero), (s, c, zero), (zero, zero, one)]
    return jnp.stack([jnp.stack(r) for r in rows])


def camera_matrix(cam: Camera) -> jnp.ndarray:
    """4x4 camera-to-world matrix (src/rvpt/camera.cpp:17-25 semantics)."""
    rot = cam.rotation * (PI / 180.0)
    r = _mm(_mm(_axis_rotation(1, rot[0]), _axis_rotation(0, rot[1])),
            _axis_rotation(2, rot[2]))
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[:3, :3].set(r)
    m = m.at[:3, 3].set(cam.translation)
    return m


def generate_rays(cam: Camera, x: jnp.ndarray, y: jnp.ndarray) -> Ray:
    """Rays through film coordinates ``(x, y)`` in [0,1]^2, any batch shape.

    Dispatch over camera mode is static (mode is jit-cache metadata), matching
    the reference's uniform-driven switch (assets/shaders/compute_pass.comp:102-118).
    """
    m = camera_matrix(cam)
    if cam.mode == PINHOLE:
        return _pinhole(cam, m, x, y)
    if cam.mode == ORTHO:
        return _ortho(cam, m, x, y)
    return _spherical(cam, m, x, y)


def _pinhole(cam: Camera, m: jnp.ndarray, x, y) -> Ray:
    """Pinhole rays (reference: assets/shaders/camera.glsl:29-51)."""
    hfov = cam.fov * (PI / 180.0)
    u = cam.aspect * (2.0 * x - 1.0)
    v = 2.0 * y - 1.0
    w = 1.0 / jnp.tan(0.5 * hfov)
    local = jnp.stack([u, v, jnp.broadcast_to(w, u.shape)], axis=-1)
    direction = _mm(local, m[:3, :3].T)
    origin = jnp.broadcast_to(m[:3, 3], direction.shape)
    return Ray(origin=origin, direction=normalize(direction))


def _ortho(cam: Camera, m: jnp.ndarray, x, y) -> Ray:
    """Orthographic rays (reference: assets/shaders/camera.glsl:55-76)."""
    u = cam.aspect * (2.0 * x - 1.0)
    v = 2.0 * y - 1.0
    local = jnp.stack(
        [cam.scale * u, cam.scale * v, jnp.zeros_like(u)], axis=-1
    )
    origin = _mm(local, m[:3, :3].T) + m[:3, 3]
    direction = jnp.broadcast_to(m[:3, 2], origin.shape)
    return Ray(origin=origin, direction=direction)


def _spherical(cam: Camera, m: jnp.ndarray, x, y) -> Ray:
    """Spherical/environment rays (reference: assets/shaders/camera.glsl:80-99).

    Note the reference swizzles the physics-convention point ``.xzy`` so that
    theta sweeps the vertical (Y) axis; reproduced here.
    """
    phi = x * TWO_PI
    theta = y * PI
    p = unit_spherical_to_cartesian(phi, theta)
    local = jnp.stack([p[..., 0], p[..., 2], p[..., 1]], axis=-1)
    direction = _mm(local, m[:3, :3].T)
    origin = jnp.broadcast_to(m[:3, 3], direction.shape)
    return Ray(origin=origin, direction=direction)


def generate_rays_soa(cam: Camera, x: jnp.ndarray, y: jnp.ndarray):
    """Component-SoA ray generation: returns (ox,oy,oz,dx,dy,dz) flat [N]
    arrays, with no [N,3] buffer (the layout of ops.replay_soa)."""
    m = camera_matrix(cam)
    if cam.mode == PINHOLE:
        hfov = cam.fov * (PI / 180.0)
        u = cam.aspect * (2.0 * x - 1.0)
        v = 2.0 * y - 1.0
        w = 1.0 / jnp.tan(0.5 * hfov)
        dx = m[0, 0] * u + m[0, 1] * v + m[0, 2] * w
        dy = m[1, 0] * u + m[1, 1] * v + m[1, 2] * w
        dz = m[2, 0] * u + m[2, 1] * v + m[2, 2] * w
        inv = jax.lax.rsqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-30))
        ones = jnp.ones_like(u)
        return (m[0, 3] * ones, m[1, 3] * ones, m[2, 3] * ones,
                dx * inv, dy * inv, dz * inv)
    if cam.mode == ORTHO:
        u = cam.aspect * (2.0 * x - 1.0) * cam.scale
        v = (2.0 * y - 1.0) * cam.scale
        ox = m[0, 0] * u + m[0, 1] * v + m[0, 3]
        oy = m[1, 0] * u + m[1, 1] * v + m[1, 3]
        oz = m[2, 0] * u + m[2, 1] * v + m[2, 3]
        ones = jnp.ones_like(u)
        return (ox, oy, oz, m[0, 2] * ones, m[1, 2] * ones, m[2, 2] * ones)
    phi = x * TWO_PI
    theta = y * PI
    sin_t = jnp.sin(theta)
    lx = sin_t * jnp.cos(phi)
    lz = sin_t * jnp.sin(phi)  # .xzy swizzle (camera.glsl:95)
    ly = jnp.cos(theta)
    dx = m[0, 0] * lx + m[0, 1] * ly + m[0, 2] * lz
    dy = m[1, 0] * lx + m[1, 1] * ly + m[1, 2] * lz
    dz = m[2, 0] * lx + m[2, 1] * ly + m[2, 2] * lz
    ones = jnp.ones_like(phi)
    return (m[0, 3] * ones, m[1, 3] * ones, m[2, 3] * ones, dx, dy, dz)


def translate(cam: Camera, delta) -> Camera:
    """Camera-local translation (src/rvpt/camera.cpp:29-33): the delta is
    rotated into world space by the current camera matrix before being added,
    so +z moves forward, +x strafes right, +y rises — FPS-style."""
    import dataclasses

    m = camera_matrix(cam)
    world = _mm(m[:3, :3], jnp.asarray(delta, jnp.float32))
    return dataclasses.replace(cam, translation=cam.translation + world)


def rotate(cam: Camera, delta, clamp_vertical: bool = False) -> Camera:
    """Additive rotation in degrees (src/rvpt/camera.cpp:35-39);
    ``clamp_vertical`` clamps pitch to [-90, 90] as the reference's
    ``vertical_view_angle_clamp`` (off by default, camera.h:46)."""
    import dataclasses

    rot = cam.rotation + jnp.asarray(delta, jnp.float32)
    if clamp_vertical:
        rot = rot.at[1].set(jnp.clip(rot[1], -90.0, 90.0))
    return dataclasses.replace(cam, rotation=rot)
