"""Hot reload: source-watch -> re-jit.

The reference's shader hot reload shells out to glslangValidator and rebuilds
every pipeline while handles stay valid through an index indirection
(src/rvpt/rvpt.cpp:444-468, vk_util.cpp:799-813).  The equivalent here:
watch Python source files, re-import the changed modules, and drop the jit
cache — function *names* are the stable handles, re-resolved per frame by the
Renderer exactly like PipelineBuilder.get_pipeline resolves indices.
"""

from __future__ import annotations

import importlib
import os
import sys
from types import ModuleType


class SourceWatcher:
    """Tracks mtimes of a package's source files; ``reload_if_changed``
    re-imports dirty modules and clears jit caches."""

    def __init__(self, package: str = "rvpt_tpu") -> None:
        self.package = package
        self._mtimes: dict[str, float] = {}
        self.scan()

    def _files(self):
        for name, mod in list(sys.modules.items()):
            if not name.startswith(self.package):
                continue
            f = getattr(mod, "__file__", None)
            if f and os.path.exists(f):
                yield name, f

    def scan(self) -> None:
        for name, f in self._files():
            self._mtimes[name] = os.path.getmtime(f)

    def dirty_modules(self) -> list[str]:
        out = []
        for name, f in self._files():
            m = os.path.getmtime(f)
            if m > self._mtimes.get(name, 0):
                out.append(name)
        return out

    def reload_if_changed(self, clear_caches: bool = True) -> list[str]:
        """Reload modified modules (leaf-first); on any reload, clear the jit
        cache so traced code picks up the new source.  Returns reloaded module
        names."""
        dirty = self.dirty_modules()
        if not dirty:
            return []
        # reload deepest-first so parents see refreshed children
        for name in sorted(dirty, key=lambda n: -n.count(".")):
            mod = sys.modules.get(name)
            if isinstance(mod, ModuleType):
                importlib.reload(mod)
            self._mtimes[name] = os.path.getmtime(sys.modules[name].__file__)
        if clear_caches:
            import jax

            jax.clear_caches()
        return dirty
