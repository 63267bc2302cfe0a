"""Multi-host rendering launcher (the distributed flow of PARITY.md).

Run one copy per GPU; pass the coordinator address, the process count and
this process's rank.  With ``--pin-device`` each process claims only the
card whose index equals its rank (one process per card on a 4-GPU host:
ranks 0-3, ``--pin-device``).  For a local 2-process demo on CPU (4 virtual
devices each, as in tests/test_distributed.py):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
      python examples/multihost_render.py --coordinator localhost:9781 \
          --num-processes 2 --process-id 0 &
    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
      python examples/multihost_render.py --coordinator localhost:9781 \
          --num-processes 2 --process-id 1

Process 0 writes out/multihost.png.  Every process renders only its tile
shard; the scene is replicated, RNG streams are keyed by global pixel id,
and the assembled image is bit-identical to a single-process render.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--size", default="256x128")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", default="out/multihost.png")
    p.add_argument("--pin-device", action="store_true",
                   help="use only the local card whose index is the rank")
    args = p.parse_args()

    # jax.distributed.initialize must run before anything touches devices
    # (importing rvpt_tpu does), so it is called here directly.
    import jax

    jax.distributed.initialize(**{
        k: v for k, v in dict(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            local_device_ids=[args.process_id] if args.pin_device else None,
        ).items() if v is not None
    })

    import jax.numpy as jnp
    import numpy as np

    from rvpt_tpu import FilmConfig, RenderSettings
    from rvpt_tpu.parallel.distributed import gather_film_to_host
    from rvpt_tpu.render import _pixel_grid, render_pixels
    from rvpt_tpu.scene import builtin
    from rvpt_tpu.utils.image import write_png

    w, h = (int(v) for v in args.size.lower().split("x"))
    cfg = FilmConfig(width=w, height=h)
    settings = RenderSettings(max_bounces=4)
    scene, camera = builtin.cornell_box(aspect=cfg.aspect)

    rank, world = jax.process_index(), jax.process_count()
    pixel, xs, ys = _pixel_grid(cfg)
    n = pixel.shape[0]
    # Equal shard sizes: process_allgather(tiled=True) needs identical
    # local shapes, so pad the grid to a multiple of the process count
    # (padding replicates pixel 0; dropped after the gather).
    per = -(-n // world)
    pad = per * world - n
    if pad:
        pixel = jnp.concatenate([pixel, pixel[:pad]])
        xs = jnp.concatenate([xs, xs[:pad]])
        ys = jnp.concatenate([ys, ys[:pad]])
    lo, hi = rank * per, (rank + 1) * per
    print(f"process {rank}/{world}: pixels [{lo}, {hi}) on "
          f"{len(jax.local_devices())} local devices")

    acc = jnp.zeros((per, 3), jnp.float32)
    for f in range(args.frames):
        sample = render_pixels(scene, camera, settings, cfg, jnp.uint32(f),
                               pixel[lo:hi], xs[lo:hi], ys[lo:hi])
        acc = (acc * f + sample) / (f + 1)  # reference EMA semantics

    full = gather_film_to_host(acc)
    if full is not None:
        write_png(args.out, np.asarray(full)[:n].reshape(h, w, 3))
        print(f"wrote {args.out}")
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
