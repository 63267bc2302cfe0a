"""rvpt_tpu: a differentiable path tracer in JAX.

A framework with the capabilities of GraphicsProgramming/RVPT (a real-time
Vulkan compute-shader path tracer), rebuilt on JAX/XLA, with one
Pallas-Triton search kernel for the GPU.  See SURVEY.md at the repo root for
the component map.
"""

from .config import FilmConfig, RenderSettings
from .core.types import Isect, Ray
from .models.camera import Camera
from .ops.film import Film
from .scene.scene import Scene, SceneBuilder

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Film",
    "FilmConfig",
    "Isect",
    "Ray",
    "RenderSettings",
    "Scene",
    "SceneBuilder",
]
