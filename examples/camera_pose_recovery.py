"""Camera pose recovery by gradient descent through the renderer.

The camera is a differentiable pytree (models/camera.py; the reference's
matrix camera, src/rvpt/camera.cpp:17-155): gradients flow
camera -> camera_matrix -> generate_rays -> trace, and with the hit-record
gradient (ops.fast_grad) the replay's pullback hands ray origin/direction
cotangents back to XLA, which transposes them through generate_rays.

What this example demonstrates — and what it deliberately does not:

* Interior camera gradients are exact (pinned against finite differences in
  tests/test_camera_grad.py).
* Edge/visibility transport is OUT of scope (SURVEY.md §7): a path-traced
  radiance MSE between poses is dominated by silhouette/horizon/bounce-flip
  terms that interior autodiff cannot see, so naive radiance-MSE pose
  fitting diverges (measured; see the test docstring).
* Pose from a DEPTH target is fully interior for silhouette-free framing:
  the depth render is deterministic and smooth in the pose, and recovery
  converges to machine precision.  That is the honest formulation and the
  one shown here.

Run:  python examples/camera_pose_recovery.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def main():
    import optax

    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.models import camera as camera_mod
    from rvpt_tpu.models.integrators import eval_integrator
    from rvpt_tpu.render import _INTEGRATOR_SITE, _pixel_grid
    from rvpt_tpu.scene import builtin

    cfg = FilmConfig(width=64, height=64)
    settings = RenderSettings(max_bounces=1)
    scene, _ = builtin.sphere_plane(aspect=cfg.aspect)
    pixel, xs, ys = _pixel_grid(cfg)

    def depth_image(translation, rotation):
        cam = camera_mod.Camera.create(aspect=cfg.aspect, fov=55.0)
        cam = dataclasses.replace(
            cam, translation=translation, rotation=rotation
        )
        cx = (xs.astype(jnp.float32) + 0.5) / cfg.width
        cy = 1.0 - (ys.astype(jnp.float32) + 0.5) / cfg.height
        ray = camera_mod.generate_rays(cam, cx, cy)
        return eval_integrator(
            2, scene, ray, pixel, jnp.uint32(0), settings,
            jnp.uint32(_INTEGRATOR_SITE),
        )

    # Ground-truth pose: close to the sphere so it fills the frame
    # (silhouette-free; see module docstring).
    t_true = jnp.asarray([0.0, 0.0, 2.6], jnp.float32)
    r_true = jnp.zeros(3, jnp.float32)
    target = jax.lax.stop_gradient(depth_image(t_true, r_true))

    def loss_fn(params):
        img = depth_image(params["t"], r_true)
        return jnp.mean(jnp.square(img - target))

    opt = optax.adam(1e-2)
    params = {"t": t_true + jnp.asarray([0.12, -0.09, -0.18], jnp.float32)}
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(g, state, params)
        return optax.apply_updates(params, updates), state, loss

    print(f"initial pose error: {np.abs(np.asarray(params['t'] - t_true))}")
    for i in range(300):
        params, state, loss = step(params, state)
        if i % 50 == 0:
            print(f"step {i:3d}  loss {float(loss):.3e}  "
                  f"err {float(jnp.abs(params['t'] - t_true).max()):.5f}")
    err = np.abs(np.asarray(params["t"] - t_true))
    print(f"final pose error: {err}  (loss {float(loss):.3e})")
    assert err.max() < 5e-3
    print("camera pose recovered.")


if __name__ == "__main__":
    main()
