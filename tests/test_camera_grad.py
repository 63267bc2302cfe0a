"""Camera-parameter gradients end-to-end (PARITY row 5).

The reference's camera is a packed matrix rebuilt from (translation,
rotation, fov, scale) every frame (src/rvpt/camera.cpp:17-155); here those
leaves are differentiable and the chain
camera -> camera_matrix -> generate_rays -> trace couples them to the image.
These tests pin that chain through BOTH gradient paths:

* the hit-record gradient (ops.fast_grad): the replay's pullback returns ray
  origin/direction cotangents, which XLA chains back through generate_rays;
* XLA autodiff of the integrator path (the oracle).

Finite differences validate the absolute scale on a Lambert-only scene
(no stochastic Fresnel branch; hit/miss edges contribute only a few pixels).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rvpt_tpu import FilmConfig, RenderSettings
from rvpt_tpu.core import rng as rng_mod
from rvpt_tpu.models import camera as camera_mod
from rvpt_tpu.ops.fast_grad import make_fast_kajiya
from rvpt_tpu.render import _INTEGRATOR_SITE, _JITTER_SITE, _pixel_grid
from rvpt_tpu.scene import builtin

BOUNCES = 2
SETTINGS = RenderSettings(max_bounces=BOUNCES, style="standard")
CFG = FilmConfig(width=32, height=32)


def _loss_fn(scene, trace_fast=None):
    """mean-image loss as a function of (translation, fov)."""
    pixel, xs, ys = _pixel_grid(CFG)
    frame = jnp.uint32(0)

    def loss(translation, fov):
        cam = camera_mod.Camera.create(aspect=CFG.aspect)
        cam = dataclasses.replace(
            cam,
            translation=jnp.asarray(translation, jnp.float32),
            fov=jnp.asarray(fov, jnp.float32),
        )
        ju, jv = rng_mod.uniform2(pixel, frame, jnp.uint32(_JITTER_SITE))
        cx = (xs.astype(jnp.float32) + ju) / CFG.width
        cy = 1.0 - (ys.astype(jnp.float32) + jv) / CFG.height
        ray = camera_mod.generate_rays(cam, cx, cy)
        if trace_fast is not None:
            img = trace_fast(scene, ray.origin, ray.direction, pixel, frame)
        else:
            from rvpt_tpu.models.integrators import integrator_kajiya

            img = integrator_kajiya(
                scene, ray, pixel, frame, SETTINGS,
                salt_base=jnp.uint32(_INTEGRATOR_SITE),
            )
        return jnp.mean(img)

    return loss


@pytest.fixture(scope="module")
def scene():
    s, _ = builtin.sphere_plane(aspect=1.0)
    return s


def test_camera_grads_fast_vjp_matches_xla_autodiff(scene):
    """The hit-record chain (XLA fwd + replay bwd -> ray cotangents ->
    generate_rays transpose) must agree with XLA autodiff of the same math."""
    trace = make_fast_kajiya(scene, _INTEGRATOR_SITE, BOUNCES,
                             style="standard")
    loss_fast = _loss_fn(scene, trace)
    loss_xla = _loss_fn(scene, None)

    t0 = jnp.asarray([0.05, -0.02, 0.1], jnp.float32)
    fov0 = jnp.float32(90.0)
    gt_fast, gf_fast = jax.grad(loss_fast, argnums=(0, 1))(t0, fov0)
    gt_xla, gf_xla = jax.grad(loss_xla, argnums=(0, 1))(t0, fov0)

    np.testing.assert_allclose(np.asarray(gt_fast), np.asarray(gt_xla),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(float(gf_fast), float(gf_xla),
                               rtol=2e-4, atol=1e-7)
    # the chain is live: translation toward/away from the scene changes loss
    assert float(jnp.abs(gt_fast).max()) > 1e-5
    assert abs(float(gf_fast)) > 1e-7


def test_camera_grads_match_finite_differences(scene):
    """Absolute scale check vs central differences (Lambert-only scene)."""
    loss = _loss_fn(scene, None)
    t0 = jnp.asarray([0.05, -0.02, 0.1], jnp.float32)
    fov0 = jnp.float32(90.0)
    gt, gf = jax.grad(loss, argnums=(0, 1))(t0, fov0)

    eps = 2e-3
    fd_t = np.zeros(3, np.float32)
    for k in range(3):
        e = jnp.zeros(3, jnp.float32).at[k].set(eps)
        fd_t[k] = (float(loss(t0 + e, fov0)) - float(loss(t0 - e, fov0))) / (
            2 * eps
        )
    fd_f = (float(loss(t0, fov0 + 0.1)) - float(loss(t0, fov0 - 0.1))) / 0.2

    np.testing.assert_allclose(np.asarray(gt), fd_t, rtol=0.08, atol=2e-4)
    np.testing.assert_allclose(float(gf), fd_f, rtol=0.08, atol=2e-5)


def test_camera_pose_recovery_converges(scene):
    """Recover camera translation by gradient descent on a DEPTH-image loss
    (the small-scale version of examples/camera_pose_recovery.py).

    Why depth and not radiance: interior autodiff cannot see edge/visibility
    transport (SURVEY.md §7 scopes edge gradients out), and a path-traced
    radiance MSE is dominated by exactly those terms — silhouettes, horizon
    rows, bounce-ray hit/miss flips — so radiance-MSE pose fitting diverges
    (measured).  The depth render of a silhouette-free close-up framing is
    deterministic and smooth in the pose, making interior gradients the FULL
    gradient; recovery then converges to machine precision."""
    import optax

    from rvpt_tpu.models.integrators import eval_integrator

    pixel, xs, ys = _pixel_grid(CFG)
    depth_settings = RenderSettings(max_bounces=1)

    def depth_image(translation):
        cam = camera_mod.Camera.create(aspect=CFG.aspect, fov=55.0)
        cam = dataclasses.replace(cam, translation=translation)
        cx = (xs.astype(jnp.float32) + 0.5) / CFG.width
        cy = 1.0 - (ys.astype(jnp.float32) + 0.5) / CFG.height
        ray = camera_mod.generate_rays(cam, cx, cy)
        return eval_integrator(2, scene, ray, pixel, jnp.uint32(0),
                               depth_settings, jnp.uint32(_INTEGRATOR_SITE))

    # Close-up: the sphere (center (0,0,4), r=1) fills the film at fov 55
    # from z=2.6, keeping its silhouette out of frame.
    t_true = jnp.asarray([0.0, 0.0, 2.6], jnp.float32)
    target = jax.lax.stop_gradient(depth_image(t_true))

    def mse(t):
        return jnp.mean(jnp.square(depth_image(t) - target))

    opt = optax.adam(1e-2)
    t = t_true + jnp.asarray([0.1, -0.08, -0.15], jnp.float32)
    state = opt.init(t)

    @jax.jit
    def step(t, state):
        loss, g = jax.value_and_grad(mse)(t)
        updates, state = opt.update(g, state, t)
        return optax.apply_updates(t, updates), state, loss

    l0 = float(mse(t))
    for _ in range(250):
        t, state, loss = step(t, state)
    err = float(jnp.abs(t - t_true).max())
    assert float(loss) < 1e-6 * l0, f"pose recovery stalled: {l0} -> {loss}"
    assert err < 5e-3, f"recovered pose off by {err}"
