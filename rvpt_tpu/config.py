"""Render settings & film configuration.

The analog of the reference's ``RVPT::RenderSettings`` (src/rvpt/rvpt.h:77-89)
mirrored 1:1 into a uniform block (compute_pass.comp:28-40).  Here it is a
frozen, hashable dataclass used as a jit-static argument: changing a setting
re-specializes the compiled program — the counterpart of the
reference rebuilding its command buffers on settings change.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass(frozen=True)
class RenderSettings:
    max_bounces: int = 8  # reference default rvpt.h:79
    aa: int = 1  # samples per pixel per frame, rvpt.h:80
    camera_mode: int = 0  # 0 pinhole / 1 ortho / 2 spherical
    # Split-screen integrator comparison (rvpt.cpp:301-339): integrator ids
    # per quadrant; all default to Kajiya (9) like the reference.
    top_left_render_mode: int = 9
    top_right_render_mode: int = 9
    bottom_left_render_mode: int = 9
    bottom_right_render_mode: int = 9
    split_ratio: tuple[float, float] = (0.5, 0.5)
    # 'reference' reproduces the reference's drop-unfinished-paths rule
    # (integrators.glsl:675); 'standard' keeps accumulated emission.
    style: str = "reference"

    def modes(self) -> tuple[int, int, int, int]:
        return (
            self.top_left_render_mode,
            self.top_right_render_mode,
            self.bottom_left_render_mode,
            self.bottom_right_render_mode,
        )

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["split_ratio"] = list(d["split_ratio"])
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "RenderSettings":
        d = json.loads(s)
        if "split_ratio" in d:
            d["split_ratio"] = tuple(d["split_ratio"])
        return RenderSettings(**d)


@dataclass(frozen=True)
class FilmConfig:
    width: int = 1024  # reference fixed film, main.cpp:96-97
    height: int = 512

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def get_asset_path(relative: str) -> str:
    """Resolve a path under the project's assets directory.

    The reference generates project_configuration.json at build time carrying
    the source dir and resolves assets against it, falling back to "."
    (scripts/project_configuration.json.in:1-3, src/rvpt/rvpt.cpp:39-49,
    1045-1054).  Here: $RVPT_TPU_ASSETS overrides; otherwise the repo's
    assets/ next to this package; otherwise the path as given.
    """
    import os

    override = os.environ.get("RVPT_TPU_ASSETS")
    roots = [override] if override else []
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots.append(os.path.join(pkg_root, "assets"))
    for root in roots:
        cand = os.path.join(root, relative)
        if os.path.exists(cand):
            return cand
    return relative
