"""Geometry recovery: fit a sphere's radius by gradient descent through the
path tracer (the trainer's "spheres" param group).

The scene is a MIRROR sphere under the gradient sky: the reflected sky color
varies continuously with the radius-dependent normal field, so the interior
pathwise gradient (the custom VJP's sph_radius cotangent, ops/fast_grad.py)
carries a strong, correctly-signed signal.

Configuration notes (measured, tests/test_inverse.py):
* A Lambert sphere would NOT converge this way — its radius signal is
  silhouette growth, a visibility/edge gradient that pathwise estimators
  cannot see (SURVEY.md §7 "hard parts"; same reason pose translation is fit
  with a depth loss in examples/camera_pose_recovery.py).
* Radius and depth couple weakly through angular size, so the recovered
  (radius, center-z) pair may trade off a few percent against truth.
* Free-vertex recovery from one small noisy view is under-constrained
  (many normal-field-equivalent vertex sets); constrain vertices (shared
  offsets, laplacian regularizers) before attempting it at this scale.

Run (CPU or GPU), from the repository root:
  PYTHONPATH=. python examples/geometry_recovery.py
"""

import jax.numpy as jnp
import numpy as np

from rvpt_tpu import FilmConfig, RenderSettings
from rvpt_tpu.models.camera import Camera
from rvpt_tpu.render import render_sample_chw
from rvpt_tpu.scene.scene import SceneBuilder
from rvpt_tpu.train import inverse


def mirror_scene(radius: float):
    b = SceneBuilder()
    mir = b.add_material(albedo=(0.95, 0.95, 0.95), kind=1)
    b.add_sphere((0.0, 0.0, 3.0), radius, mir)
    return b.build()


def main() -> float:
    cfg = FilmConfig(width=48, height=48)
    cam = Camera.create(aspect=1.0, fov=60.0)
    settings = RenderSettings(max_bounces=2, style="standard")

    true_radius = 1.0
    target = render_sample_chw(mirror_scene(true_radius), cam, settings,
                               cfg, 0)

    scene_rec, losses, _ = inverse.recover(
        mirror_scene(0.7), cam, settings, cfg, None, target,
        steps=120, learning_rate=2e-2, groups=("spheres",), log_every=20,
    )
    got = float(np.asarray(scene_rec.sph_radius)[0])
    cz = float(np.asarray(scene_rec.sph_center)[0, 2])
    print(f"recovered radius {got:.3f} (true {true_radius}), "
          f"center z {cz:.3f} (true 3.0), "
          f"angular size {got / cz:.4f} (true {true_radius / 3.0:.4f})")
    return abs(got - true_radius)


if __name__ == "__main__":
    main()
