"""Shader-hot-reload equivalent: watch shading modules, re-import, re-trace.

The reference polls one GLSL file's mtime per frame and rebuilds that pass's
pipeline on change (HotreloadShaders, render.cpp:62-627; error box + retry at
render.cpp:18-24).  Our "shaders" are Python modules under shade/, so the
live-editing workflow becomes: watch mtimes -> importlib.reload -> clear the
jit cache so the next frame re-traces.  Errors are caught and reported; the
previous working trace keeps rendering (no blocking message box needed).
"""

from __future__ import annotations

import importlib
import os
import sys
import traceback

WATCHED_PREFIX = "vulkan_pbr_renderer.shade"


class ShaderWatcher:
    def __init__(self, prefix=WATCHED_PREFIX):
        self.prefix = prefix
        self.mtimes = {}
        self._scan(initial=True)
        self._round_robin = []

    def _modules(self):
        return [m for name, m in sys.modules.items()
                if name.startswith(self.prefix) and getattr(m, "__file__", None)]

    def _scan(self, initial=False):
        changed = []
        for m in self._modules():
            try:
                t = os.path.getmtime(m.__file__)
            except OSError:
                continue
            old = self.mtimes.get(m.__name__)
            self.mtimes[m.__name__] = t
            if not initial and old is not None and t > old:
                changed.append(m)
        return changed

    def poll(self, renderer=None):
        """Call once per frame (like render.cpp:66-83: one stat per frame).

        Returns True if modules were reloaded (the caller's next render
        re-traces).  On reload errors the old code keeps running.
        """
        changed = self._scan()
        if not changed:
            return False
        ok = True
        for m in changed:
            try:
                importlib.reload(m)
            except Exception:
                traceback.print_exc()
                ok = False
        if ok:
            # Drop ONLY the frame trace — jax.clear_caches() would also nuke
            # the IBL bakes / pack helpers and every other live jit, turning a
            # one-pass edit into a cold-start.  The full
            # frame necessarily re-traces (it is one fused jit; per-pass jits
            # would cost cross-pass XLA fusion every frame to save occasional
            # reload time).  The package's persistent compilation cache
            # (JAX_COMPILATION_CACHE_DIR or .jax_cache/) makes reloading
            # *unchanged* code instant.
            from . import renderer as renderer_mod

            try:
                renderer_mod.render_frame.clear_cache()
            except AttributeError:  # older jax: fall back to the big hammer
                import jax

                jax.clear_caches()
            if renderer is not None and hasattr(renderer, "state"):
                pass  # temporal state survives; only traces are invalidated
        return ok
