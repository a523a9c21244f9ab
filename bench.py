"""Benchmark harness: SunTemple-class scene, full pipeline, one JSON line.

On the GPU it renders the procedural SunTemple stand-in at 1920x1088 with
every pass enabled (shadows, voxel GI, light shafts, TAA, bloom, ACES) along
the fly-through camera path, timing whole frames amortized over an in-device
lax.scan.  Any other backend is refused unless BENCH_SMALL=1 asks for the
tiny smoke run (320x192, XLA raster), which runs anywhere; the JSON names
the device either way.

Env knobs: BENCH_DETAIL (default 4.5 — ~600k tris, the original SunTemple's
budget), BENCH_FRAMES (default 8), BENCH_SMALL=1 (tiny smoke run).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _nvidia_smi():
    """The card's name and power limit as nvidia-smi reports them (None
    where there is no nvidia-smi, e.g. a BENCH_SMALL run on the CPU)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main():
    import jax

    small = os.environ.get("BENCH_SMALL") == "1"
    if not small and jax.default_backend() != "gpu":
        sys.exit(f"bench: no GPU (backend {jax.default_backend()!r}); "
                 "BENCH_SMALL=1 runs the small smoke size anywhere")

    import jax.numpy as jnp
    import numpy as np

    from vulkan_pbr_renderer.app.renderer import (
        CameraState, init_frame_state, make_camera, render_frame,
    )
    from vulkan_pbr_renderer.assets import build_scene, suntemple
    from vulkan_pbr_renderer.config import RenderConfig

    if small:
        detail = float(os.environ.get("BENCH_DETAIL", "0.3"))
        frames = int(os.environ.get("BENCH_FRAMES", "2"))
        cfg = RenderConfig(
            width=320, height=192, shadow_map_size=256, lightgrid_size=32,
            prefiltered_env_size=16, prefiltered_env_min_size=8,
            prefilter_samples=128, brdf_lut_size=32, brdf_lut_samples=128,
            irradiance_size=8, irradiance_samples=32, bloom_pass_count=4,
            gi_screen_trace_steps=6, gi_diffuse_steps=6, gi_specular_steps=6,
            light_shaft_steps=6,
        )
        backend = "xla"
    else:
        detail = float(os.environ.get("BENCH_DETAIL", "4.5"))
        frames = int(os.environ.get("BENCH_FRAMES", "8"))
        cfg = RenderConfig(width=1920, height=1088)
        backend = "pallas"

    parts = suntemple.build_parts(detail=detail)
    scene = build_scene(parts, suntemple.materials(),
                        texture_size=64 if small else 256)
    n_tris = scene.num_tris
    print(f"# scene: {n_tris} tris, {cfg.width}x{cfg.height}, backend={backend}",
          file=sys.stderr)

    from vulkan_pbr_renderer.app.renderer import Renderer

    r = Renderer(cfg, scene, raster_backend=backend)
    cfg = r.cfg  # pick up the auto-sized voxelize stream

    cams = [make_camera(*suntemple.camera_path(i / max(frames - 1, 1)), cfg)
            for i in range(frames)]
    cam_batch = CameraState(*[
        jnp.stack([getattr(c, f) for c in cams]) for f in CameraState._fields
    ])
    sun = jnp.asarray([35.0, 80.0], jnp.float32)

    def make_render_n(the_cfg):
        # ONE compiled graph per GI mode serves the timing loop, the SSIM
        # settle loops, and the reference-GI timing (round 3: the five
        # separately-jitted variants cost 5 full-frame compiles and timed out
        # the harness).  Returns (new_state, final frame image, per-frame means).
        @jax.jit
        def render_n(state, cam_batch, sun, pre, lut):
            img0 = jnp.zeros((the_cfg.height, the_cfg.width, 3), jnp.float32)

            def body(carry, cam_leaves):
                st, _ = carry
                cam = CameraState(*cam_leaves)
                st, img = render_frame(scene, st, cam, sun, pre, lut,
                                       the_cfg, backend)
                return (st, img), jnp.mean(img)

            (state, img), means = jax.lax.scan(body, (state, img0),
                                               tuple(cam_batch))
            return state, img, means

        return render_n

    render_n = make_render_n(cfg)

    state = init_frame_state(cfg)
    t0 = time.perf_counter()
    state, _, means = render_n(state, cam_batch, sun, r.prefiltered_env, r.brdf_lut)
    float(means[-1])
    compile_s = time.perf_counter() - t0
    print(f"# compile+first: {compile_s:.1f}s", file=sys.stderr)

    # Per-rep input change: nudge the CAMERA path, not the sun — a sun
    # nudge re-triggers voxelize + the sun-shadow raster, a cost the
    # reference only pays when the sun MOVES (render.cpp: revoxelize =
    # frame_idx == 0 || sun_angle != prev_frame).
    reps = 3

    def cam_batch_at(shift):
        cs = [make_camera(*suntemple.camera_path(
            (i + shift) / max(frames - 1, 1)), cfg) for i in range(frames)]
        return CameraState(*[
            jnp.stack([getattr(c, f) for c in cs]) for f in CameraState._fields
        ])

    rep_batches = [cam_batch_at(0.003 * (k + 1)) for k in range(reps)]
    # per-rep timing, report the MIN of the in-device scans
    rep_ms = []
    for k in range(reps):
        t0 = time.perf_counter()
        state, _, means = render_n(state, rep_batches[k], sun,
                                   r.prefiltered_env, r.brdf_lut)
        float(means[-1])
        rep_ms.append((time.perf_counter() - t0) / frames * 1000.0)
    ms = min(rep_ms)
    print(f"# frame_ms: {ms:.2f} (reps: "
          + " ".join(f"{t:.1f}" for t in rep_ms) + ")", file=sys.stderr)
    # record every rep and the min/median/spread beside the headline
    rep_sorted = sorted(rep_ms)
    steady = rep_ms[1:] or rep_ms  # rep 1 often carries residual warm-up
    rep_stats = {
        "reps_ms": [round(t, 2) for t in rep_ms],
        "rep_median_ms": round(rep_sorted[len(rep_sorted) // 2], 2),
        "rep_spread": round(rep_sorted[-1] / max(rep_sorted[0], 1e-9), 3),
        # spread of the post-warm-up reps (rep 1 may carry warm-up)
        "rep_steady_spread": round(max(steady) / max(min(steady), 1e-9), 3),
    }

    # an overflowing bench frame would silently drop triangles and report a
    # BETTER number — one host fetch, outside timing
    r.state = state
    ok, msg = r.check_overflow(strict=True)
    print(f"# overflow check: {msg}", file=sys.stderr)

    dev = jax.devices()[0]
    out = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": _nvidia_smi(),
        "metric": "suntemple_1080p_frame_ms",
        "value": round(ms, 2),
        "unit": "ms",
        "vs_baseline": round(16.6 / ms, 4),
        "mpix_per_s_shaded": round(cfg.width * cfg.height / ms / 1000.0, 2),
        "tris": n_tris,
        "compile_first_s": round(compile_s, 1),
        **rep_stats,
    }

    if os.environ.get("BENCH_SSIM", "1") == "1":
        # fidelity of the fast GI vs the reference-parity hybrid march:
        # FULL-res matched frames at two camera points, settled to steady
        # state, SSIM over the final sRGB images.  The settle loop is the
        # SAME compiled scan as the timing loop (cam_batch = one camera
        # repeated `frames` times): the fast mode costs zero extra compiles,
        # the reference mode exactly one — which the reference-GI timing
        # below then reuses.
        from vulkan_pbr_renderer.utils.image import ssim
        import numpy as np

        rcfg = cfg.replace(gi_mode="reference")
        rr = Renderer(rcfg, scene, raster_backend=backend)
        render_ref_n = make_render_n(rcfg)
        points = (0.3,) if small else (0.3, 0.7)
        ssims = []
        ref_ms = []

        def settle_batch(t):
            c = make_camera(*suntemple.camera_path(t), cfg)
            return CameraState(*[
                jnp.stack([getattr(c, f)] * frames) for f in CameraState._fields
            ])

        # 6 scans x `frames` = 48 in-device settle frames per point (at
        # taa_blend 0.05 a 16-frame settle leaves 0.95^16 = 44% of the TAA
        # transient in BOTH images, amplifying the noise-correlation
        # artifact).  Every scan gets a byte-distinct ~1e-6 camera nudge
        # (visually identical, and BOTH modes see the same nudge sequence so
        # the SSIM compares matched frames); sun fixed, so the settled scans
        # pay no voxelize — matching the reference's revoxelize-on-sun-change
        # rule (render.cpp).
        settle_scans = 6 if not small else 2
        for i, t in enumerate(points):
            imgs = {}
            for mode, fn, rend in (("fast", render_n, r),
                                   ("reference", render_ref_n, rr)):
                # each mode's state from its own config: the fast graph's
                # temporal-interleave cache has a shape the reference
                # config does not allocate
                st = init_frame_state(rend.cfg)
                img = None
                for k in range(settle_scans):
                    t0 = time.perf_counter()
                    st, img, mm = fn(st, settle_batch(t + k * 1e-6), sun,
                                     rend.prefiltered_env, rend.brdf_lut)
                    float(mm[-1])
                if mode == "reference":  # steady state: the final scan
                    ref_ms.append((time.perf_counter() - t0) / frames * 1000.0)
                imgs[mode] = np.asarray(img)
            ssims.append(float(ssim(imgs["fast"], imgs["reference"])))
            print(f"# ssim point {t}: {ssims[-1]:.4f}", file=sys.stderr)
        out["gi_fast_ssim_vs_reference"] = round(float(np.mean(ssims)), 4)
        # per-point values next to the aggregate (a rounded 2-point mean
        # can hide a per-point gate miss)
        out["gi_fast_ssim_points"] = {str(t): round(s, 4)
                                      for t, s in zip(points, ssims)}
        # context for reading the number: both sides dither their GI with
        # frame-index noise, and below ~0.97 this metric measures dither-
        # phase CORRELATION, not image quality — the control
        # (docs/eval_ssim.py --variants off1 --ref-variant default; identical
        # full-rate algorithm, GI noise offset one frame) scored 0.9686
        # against itself.  The shipped interleave must clear that floor; the
        # full-rate correlated anchor (gi_temporal_div=1) is 0.9847.  See
        # docs/VISUAL_PARITY.md "The honest fidelity gate".
        out["ssim_decorrelated_noise_floor"] = 0.9686
        # cost of the reference-parity GI mode at bench scale:
        # steady-state frames of the settle scan above
        out["reference_gi_frame_ms"] = round(float(np.mean(ref_ms)), 2)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
