"""Command-line interface — the application layer.

The reference's main() is a fixed 1024x512 interactive window with hardcoded
scene and hotkeys (src/rvpt/main.cpp:88-159).  Headless rendering turns
that into a CLI: pick a scene (builtin or OBJ), film size, integrator,
camera, frames to accumulate; writes PNG output and optional debug overlays.

    python -m rvpt_tpu.cli --scene cornell --size 512x512 --frames 16 \
        --integrator kajiya --out out/cornell.png
"""

from __future__ import annotations

import argparse
import re
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rvpt_tpu", description="differentiable path tracer"
    )
    p.add_argument("--scene", default="cornell",
                   help="builtin scene (cornell|sphere_plane|rabbit|"
                        "mesh[:subdiv]) or path to .obj")
    p.add_argument("--size", default="1024x512",
                   help="film WxH (reference default 1024x512, main.cpp:96-97)")
    p.add_argument("--frames", type=int, default=8,
                   help="frames to accumulate (temporal EMA)")
    p.add_argument("--integrator", default="kajiya",
                   help="binary|color|depth|normal|utah|ao|appel|whitted|cook|kajiya|hart")
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--aa", type=int, default=1, help="samples per pixel per frame")
    p.add_argument("--camera-mode", default="pinhole",
                   choices=["pinhole", "ortho", "spherical"])
    p.add_argument("--camera-pos", default=None, help="x,y,z")
    p.add_argument("--camera-rot", default=None, help="yaw,pitch,roll degrees")
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--bvh", action="store_true", help="use BVH traversal")
    p.add_argument("--split", default=None,
                   help="4 integrators tl,tr,bl,br for split-screen compare")
    p.add_argument("--out", default="out/render.png")
    p.add_argument("--debug-view", default=None, choices=["triangles", "bvh"],
                   help="also write a debug overlay PNG")
    p.add_argument("--checkpoint", default=None,
                   help="save film checkpoint here (resume with --resume)")
    p.add_argument("--resume", default=None, help="checkpoint to resume from")
    p.add_argument("--stats", action="store_true", help="print frame stats")
    p.add_argument("--style", default="reference", choices=["reference", "standard"])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import dataclasses
    import os

    import numpy as np

    from .utils import compile_cache

    compile_cache.enable()  # persistent XLA cache (GPU; see module doc)

    from . import FilmConfig, RenderSettings
    from .models.camera import CAMERA_MODE_NAMES
    from .models.integrators import INTEGRATOR_NAMES
    from .renderer import Renderer
    from .scene import builtin, obj_io
    from .utils.image import write_png

    w, h = (int(v) for v in args.size.lower().split("x"))
    cfg = FilmConfig(width=w, height=h)

    if args.scene == "cornell":
        scene, camera = builtin.cornell_box(aspect=cfg.aspect)
    elif args.scene == "sphere_plane":
        scene, camera = builtin.sphere_plane(aspect=cfg.aspect)
    elif args.scene == "rabbit":
        # The reference's demo scene (main.cpp:96-107).
        scene, camera = builtin.rabbit(aspect=cfg.aspect)
    elif re.fullmatch(r"mesh(:\d+)?", args.scene):
        # "mesh" or "mesh:N" — the icosphere demo at subdivision N (BVH
        # attached; larger N is the mesh-scale configuration).
        subdiv = int(args.scene.split(":")[1]) if ":" in args.scene else 2
        scene, camera = builtin.mesh_demo(subdiv=subdiv, aspect=cfg.aspect)
    elif args.scene.endswith(".obj"):
        v, f = obj_io.load_obj(args.scene)
        scene, camera = builtin.mesh_scene(v, f, aspect=cfg.aspect)
    else:
        print(f"unknown scene {args.scene!r}", file=sys.stderr)
        return 2

    mode = INTEGRATOR_NAMES.get(args.integrator)
    if mode is None:
        print(f"unknown integrator {args.integrator!r}", file=sys.stderr)
        return 2
    modes = dict(
        top_left_render_mode=mode, top_right_render_mode=mode,
        bottom_left_render_mode=mode, bottom_right_render_mode=mode,
    )
    if args.split:
        names = args.split.split(",")
        if len(names) != 4 or any(n not in INTEGRATOR_NAMES for n in names):
            print("--split needs 4 integrator names tl,tr,bl,br", file=sys.stderr)
            return 2
        keys = ["top_left", "top_right", "bottom_left", "bottom_right"]
        modes = {f"{k}_render_mode": INTEGRATOR_NAMES[n] for k, n in zip(keys, names)}

    settings = RenderSettings(
        max_bounces=args.bounces, aa=args.aa,
        camera_mode=CAMERA_MODE_NAMES[args.camera_mode], style=args.style, **modes,
    )
    camera = dataclasses.replace(camera, mode=CAMERA_MODE_NAMES[args.camera_mode])
    if args.camera_pos:
        camera = dataclasses.replace(
            camera, translation=np.asarray(
                [float(x) for x in args.camera_pos.split(",")], np.float32)
        )
    if args.camera_rot:
        camera = dataclasses.replace(
            camera, rotation=np.asarray(
                [float(x) for x in args.camera_rot.split(",")], np.float32)
        )
    if args.fov is not None:
        camera = dataclasses.replace(camera, fov=np.float32(args.fov))

    r = Renderer(scene, camera, settings, cfg, use_bvh=args.bvh)
    if args.resume:
        r.load_checkpoint(args.resume)
        print(f"resumed at frame {int(r.film.frame)}", file=sys.stderr)

    for _ in range(args.frames):
        r.draw()
    if args.stats:
        print(r.stats(), file=sys.stderr)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    r.save_image(args.out)
    print(f"wrote {args.out}", file=sys.stderr)

    if args.debug_view:
        dbg = r.debug_view(args.debug_view)
        dbg_path = args.out.replace(".png", f"_{args.debug_view}.png")
        write_png(dbg_path, dbg)
        print(f"wrote {dbg_path}", file=sys.stderr)

    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
        print(f"checkpointed to {args.checkpoint}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
