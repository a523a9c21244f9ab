"""Interleaved A/B frame timing: N configs, one process, alternating reps.

Two processes can land on different cards, power limits and neighbours, so
config cost comparisons are only meaningful INTERLEAVED in one process:
compile all variants first, then time rep k of every variant before rep k+1
of any.

Usage: python docs/ab_time.py name=kw:v,kw:v name2=...   (bench-scale scene)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp


def main():
    from vulkan_pbr_renderer.app.renderer import (
        CameraState, Renderer, init_frame_state, make_camera, render_frame,
    )
    from vulkan_pbr_renderer.assets import build_scene, suntemple
    from vulkan_pbr_renderer.config import RenderConfig
    import jax

    def parse(v):
        for conv in (int, float):
            try:
                return conv(v)
            except ValueError:
                pass
        return {"True": True, "False": False}.get(v, v)

    variants = {}
    for arg in sys.argv[1:]:
        name, _, kws = arg.partition("=")
        variants[name] = {k: parse(v) for k, v in
                          (kv.split(":") for kv in kws.split(",") if kv)}

    scene = build_scene(suntemple.build_parts(detail=4.5),
                        suntemple.materials(), texture_size=256)
    frames, reps = 8, 3
    sun = jnp.asarray([35.0, 80.0], jnp.float32)

    runs = {}
    for name, kw in variants.items():
        cfg = RenderConfig(width=1920, height=1088).replace(**kw)
        r = Renderer(cfg, scene, raster_backend="pallas")
        cfg = r.cfg

        def make(the_cfg):
            @jax.jit
            def render_n(state, cam_batch, sun, pre, lut):
                def body(st, cam_leaves):
                    st, img = render_frame(scene, st, CameraState(*cam_leaves),
                                           sun, pre, lut, the_cfg, "pallas")
                    return st, jnp.mean(img)
                return jax.lax.scan(body, state, tuple(cam_batch))
            return render_n

        def cams(shift, the_cfg):
            cs = [make_camera(*suntemple.camera_path(
                (i + shift) / (frames - 1)), the_cfg) for i in range(frames)]
            return CameraState(*[
                jnp.stack([getattr(c, f) for c in cs])
                for f in CameraState._fields])

        fn = make(cfg)
        state = init_frame_state(cfg)
        batches = [cams(0.003 * k, cfg) for k in range(reps + 1)]
        state, mm = fn(state, batches[0], sun, r.prefiltered_env, r.brdf_lut)
        float(mm[-1])
        runs[name] = (fn, state, batches, r)
        print(f"# {name} compiled", file=sys.stderr)

    times = {n: [] for n in runs}
    for k in range(reps):
        for name, (fn, state, batches, r) in runs.items():
            t0 = time.perf_counter()
            state, mm = fn(state, batches[k + 1], sun,
                           r.prefiltered_env, r.brdf_lut)
            float(mm[-1])
            times[name].append((time.perf_counter() - t0) / frames * 1000.0)
            runs[name] = (fn, state, batches, r)
    for name, ts in times.items():
        print(f"{name:24s} " + " ".join(f"{t:7.1f}" for t in ts)
              + f"   med={sorted(ts)[len(ts)//2]:.1f}")


if __name__ == "__main__":
    main()
