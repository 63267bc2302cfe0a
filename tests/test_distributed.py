"""Multi-PROCESS (multi-host analog) tests over the JAX coordination service.

The reference is strictly single-process (SURVEY.md §2); this exercises the
capability it lacks: two OS processes, each with 4 virtual CPU devices, wire
up through ``jax.distributed.initialize`` (the PJRT coordination service a
multi-process GPU run uses), render disjoint halves of the film locally, and
assemble the frame on process 0 via ``gather_film_to_host``.  RNG streams are
keyed by GLOBAL pixel id, so the assembled image must equal the
single-process render bit for bit.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]
out = sys.argv[3]

import jax
jax.config.update("jax_platforms", "cpu")

from rvpt_tpu.parallel.distributed import (gather_film_to_host,
                                           initialize_distributed)

# Importing rvpt_tpu touches jax.devices(), which initializes the XLA
# backend; jax.distributed.initialize refuses after that — reset first
# (the real multi-host launcher initializes before any imports instead).
import jax.extend.backend as jxb
jxb.clear_backends()

initialize_distributed(f"localhost:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()       # 2 x 4 virtual CPU
assert len(jax.local_devices()) == 4

# Cross-process sanity: an allgather sees both ranks.
from jax.experimental import multihost_utils
ranks = np.asarray(multihost_utils.process_allgather(np.array([pid])))
assert sorted(ranks.ravel().tolist()) == [0, 1], ranks

# Each process renders its contiguous half of the film locally; global
# pixel ids key the RNG, so the assembly equals a single-process render.
import jax.numpy as jnp
from rvpt_tpu import FilmConfig, RenderSettings
from rvpt_tpu.render import _pixel_grid, render_pixels
from rvpt_tpu.scene import builtin

cfg = FilmConfig(width=32, height=16)
st = RenderSettings(max_bounces=2)
scene, cam = builtin.cornell_box(aspect=cfg.aspect)
pixel, xs, ys = _pixel_grid(cfg)
n = pixel.shape[0]
lo, hi = pid * n // 2, (pid + 1) * n // 2
local = render_pixels(scene, cam, st, cfg, jnp.uint32(1),
                      pixel[lo:hi], xs[lo:hi], ys[lo:hi])
full = gather_film_to_host(local)
if pid == 0:
    assert full is not None and full.shape == (n, 3)
    np.save(out, full)
else:
    assert full is None
jax.distributed.shutdown()
print("WORKER_OK", pid)
"""


TRAIN_WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]
out = sys.argv[3]

import jax
jax.config.update("jax_platforms", "cpu")

from rvpt_tpu.parallel.distributed import initialize_distributed

import jax.extend.backend as jxb
jxb.clear_backends()

initialize_distributed(f"localhost:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2 and jax.device_count() == 8

import jax.numpy as jnp
from rvpt_tpu import FilmConfig, RenderSettings
from rvpt_tpu.parallel import mesh as mesh_mod
from rvpt_tpu.render import render_sample_chw
from rvpt_tpu.train import inverse

cfg = FilmConfig(width=32, height=16)
st = RenderSettings(max_bounces=2, style="standard")
from rvpt_tpu.scene import builtin
scene, cam = builtin.cornell_box(aspect=cfg.aspect)

# Every input to the distributed step is replicated (identical on both
# hosts); the film pixels are built INSIDE the jitted step and sharded over
# the global (tiles,) mesh spanning both processes, so the shard_map
# transpose's psum of the replicated scene cotangent crosses processes.
target = jnp.zeros((3, cfg.height, cfg.width), jnp.float32)
mesh = mesh_mod.make_mesh(8, 1, devices=jax.devices())

step, opt_state = inverse.make_train_step(
    scene, cam, st, cfg, mesh, target, fast=True)
params = inverse.trainable_params(scene)
new_params, _, loss = step(params, opt_state, jnp.uint32(0))
loss = float(loss)
assert np.isfinite(loss), loss

# Single-process reference: the same step on THIS process's local devices
# only (mesh=None).  The distributed step's psum'd gradient must reproduce
# it (same RNG keyed by global pixel id; same dual-buffer estimator).
step1, opt1 = inverse.make_train_step(
    scene, cam, st, cfg, None, target, fast=True)
ref_params, _, ref_loss = step1(params, opt1, jnp.uint32(0))
assert np.allclose(loss, float(ref_loss), rtol=1e-5), (loss, float(ref_loss))
for k in new_params:
    a = np.asarray(new_params[k])
    b = np.asarray(ref_params[k])
    assert np.allclose(a, b, rtol=1e-4, atol=1e-6), (k, np.abs(a - b).max())

if pid == 0:
    np.save(out, np.asarray(new_params["materials.albedo"]))
jax.distributed.shutdown()
print("WORKER_OK", pid)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_training_step(tmp_path):
    """A 2-process inverse-rendering step: the global (tiles,) mesh spans
    both processes, so the shard_map-transpose psum of the replicated scene
    gradient crosses the two processes — and must reproduce the
    single-process step's update exactly (VERDICT r3 item 7)."""
    out = str(tmp_path / "albedo.npy")
    worker_py = tmp_path / "train_worker.py"
    worker_py.write_text(TRAIN_WORKER)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    for attempt in range(3):
        procs, outputs = _run_workers(worker_py, out, env, _free_port())
        if all(p.returncode == 0 for p in procs):
            break
        bindish = any("bind" in o.lower() or "address" in o.lower()
                      for o in outputs)
        if attempt == 2 or not bindish:
            for p, stdout in zip(procs, outputs):
                assert p.returncode == 0, f"worker failed:\n{stdout}"
    assert "WORKER_OK 0" in outputs[0] + outputs[1]
    got = np.load(out)
    assert np.isfinite(got).all() and got.shape[-1] == 3


def _run_workers(worker_py, out, env, port):
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(pid), str(port), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout)
    return procs, outputs


def test_two_process_render_and_gather(tmp_path):
    out = str(tmp_path / "film.npy")
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    # _free_port is a TOCTOU probe — another process can grab the port
    # before the coordinator binds it, so retry with a fresh port.
    for attempt in range(3):
        procs, outputs = _run_workers(worker_py, out, env, _free_port())
        if all(p.returncode == 0 for p in procs):
            break
        bindish = any("bind" in o.lower() or "address" in o.lower()
                      for o in outputs)
        if attempt == 2 or not bindish:
            for p, stdout in zip(procs, outputs):
                assert p.returncode == 0, f"worker failed:\n{stdout}"
    assert "WORKER_OK 0" in outputs[0] + outputs[1]

    # single-process reference in THIS process (8 virtual devices, same RNG)
    import jax.numpy as jnp

    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.render import _pixel_grid, render_pixels
    from rvpt_tpu.scene import builtin

    cfg = FilmConfig(width=32, height=16)
    st = RenderSettings(max_bounces=2)
    scene, cam = builtin.cornell_box(aspect=cfg.aspect)
    pixel, xs, ys = _pixel_grid(cfg)
    ref = np.asarray(
        render_pixels(scene, cam, st, cfg, jnp.uint32(1), pixel, xs, ys)
    )
    got = np.load(out)
    assert np.array_equal(got, ref), (
        f"max diff {np.abs(got - ref).max()}"
    )
