"""Attribute the first-compile cost of the bench-scale frame.

This probe splits the cost into its stages and knobs:

  * trace+lower (Python tracing, host-bound) vs backend compile (XLA)
  * per-knob deltas, one process per knob set (the persistent compile cache
    is DISABLED here so every number is a true cold compile)

Usage:   python docs/compile_probe.py [variant ...]
Variants: default | unroll_full | unroll1 | no_trace | reference | il2 |
          scan1 | noscan
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {
    "default": dict(),                         # r5: interleaved (div=2)
    "no_il": dict(gi_temporal_div=1),          # the r4 full-rate default
    # compile-cost suspects
    "unroll_full": dict(gi_trace_unroll=24),   # >= budget: straight-line trace
    "unroll1": dict(gi_trace_unroll=1),        # pure while-loop trace
    "no_trace": dict(gi_fast_screen_mode="probes"),  # drop the screen trace
    "reference": dict(gi_mode="reference"),
    "notaa": dict(enable_taa=False),
    "nogi": dict(enable_gi=False),
    "noshafts": dict(enable_light_shafts=False),
}


def main():
    import jax
    import jax.numpy as jnp

    import vulkan_pbr_renderer  # noqa: F401  (sets the cache; undone below)

    jax.config.update("jax_enable_compilation_cache", False)

    from vulkan_pbr_renderer.app.renderer import (
        CameraState, Renderer, init_frame_state, make_camera, render_frame,
    )
    from vulkan_pbr_renderer.assets import build_scene, suntemple
    from vulkan_pbr_renderer.config import RenderConfig

    names = sys.argv[1:] or ["default"]
    frames = int(os.environ.get("PROBE_FRAMES", "8"))
    scan = os.environ.get("PROBE_SCAN", "1") == "1"

    cfg0 = RenderConfig(width=1920, height=1088)
    scene = build_scene(suntemple.build_parts(detail=4.5),
                        suntemple.materials(), texture_size=256)
    sun = jnp.asarray([35.0, 80.0], jnp.float32)

    for name in names:
        cfg = cfg0.replace(**VARIANTS[name])
        t0 = time.perf_counter()
        r = Renderer(cfg, scene, raster_backend="pallas")
        cfg = r.cfg
        t_bake = time.perf_counter() - t0

        def render_n(state, cam_batch, sun, pre, lut):
            img0 = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

            def body(carry, cam_leaves):
                st, _ = carry
                cam = CameraState(*cam_leaves)
                st, img = render_frame(scene, st, cam, sun, pre, lut,
                                       cfg, "pallas")
                return (st, img), jnp.mean(img)

            if scan:
                (state, img), means = jax.lax.scan(body, (state, img0),
                                                   tuple(cam_batch))
            else:
                means = []
                carry = (state, img0)
                for i in range(frames):
                    cam = jax.tree.map(lambda x: x[i], cam_batch)
                    carry, m = body(carry, tuple(cam))
                    means.append(m)
                state, img = carry
                means = jnp.stack(means)
            return state, img, means

        cams = [make_camera(*suntemple.camera_path(i / max(frames - 1, 1)),
                            cfg) for i in range(frames)]
        cam_batch = CameraState(*[
            jnp.stack([getattr(c, f) for c in cams])
            for f in CameraState._fields])
        state = init_frame_state(cfg)
        args = (state, cam_batch, sun, r.prefiltered_env, r.brdf_lut)

        t0 = time.perf_counter()
        lowered = jax.jit(render_n).lower(*args)
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = lowered.compile()
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = compiled(*args)
        float(out[2][-1])
        t_first = time.perf_counter() - t0
        hlo_ops = None
        try:
            hlo_ops = sum(
                1 for _ in compiled.as_text().splitlines())
        except Exception:
            pass
        print(f"{name:12s} bake={t_bake:6.1f}s lower={t_lower:6.1f}s "
              f"compile={t_compile:6.1f}s first_run={t_first:6.1f}s "
              f"hlo_lines={hlo_ops}", flush=True)


if __name__ == "__main__":
    main()
