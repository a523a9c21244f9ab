"""Full-res fast-GI SSIM eval with bench.py's EXACT methodology.

docs/tune_gi.py settles 4 host-call frames with a per-frame sun nudge — that
re-voxelizes every frame and leaves the lightgrid only 4 sweeps converged.
bench.py settles 16 in-device frames with the sun FIXED (per-rep camera
nudge), so the sweep has rotated axes 16 times and the GI field is brighter
and smoother — fast-vs-reference SSIM reads ~0.02-0.04 LOWER there (tune_gi
0.9245 vs bench 0.8807 on the same config).  Since the bench's
`gi_fast_ssim_vs_reference` is the number that counts, variants must be
judged under its methodology.  This harness reproduces bench.py's SSIM block
(two 8-frame scans per camera point, 1e-6 camera-nudged second batch, SSIM of
the final sRGB frames at t=0.3 and 0.7) for a list of config-override
variants, plus the same in-device frame timing as bench.py.

Usage:  python docs/eval_ssim.py --variants default,trace16
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# reference caches and diff images stay inside the checkout (gitignored)
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "chiprun_out")
os.makedirs(OUT, exist_ok=True)

VARIANTS = {
    "default": dict(),
    # noise-floor control: full-rate fast GI with the GI
    # dither schedule offset by one frame — scored against "default" via
    # --ref-variant it measures the SSIM cost of pure noise DEcorrelation
    # between two otherwise-identical steady-state renders
    "off1": dict(gi_noise_offset=1),
    "off2": dict(gi_noise_offset=2),
    # faithful linear screen trace (gi.screen_trace_linear)
    "trace16": dict(gi_fast_screen_mode="trace"),
    "trace24": dict(gi_fast_screen_mode="trace", gi_trace_steps=24),
    "trace12_t1": dict(gi_fast_screen_mode="trace", gi_trace_steps=12,
                       gi_trace_solid_taps=1),
    "trace16_d2": dict(gi_fast_screen_mode="trace", gi_trace_depth_div=2),
    "trace16_r1": dict(gi_fast_screen_mode="trace", gi_trace_rounds=1),
    "trace16_d4": dict(gi_fast_screen_mode="trace", gi_trace_depth_div=4),
    "trace12_d2": dict(gi_fast_screen_mode="trace", gi_trace_steps=12,
                       gi_trace_depth_div=2),
    "trace16_d2_t1": dict(gi_fast_screen_mode="trace", gi_trace_depth_div=2,
                          gi_trace_solid_taps=1),
    # trace diet candidates: the full-res f32 depth table is the trace's
    # main memory traffic
    "d2": dict(gi_trace_depth_div=2),
    "d2min": dict(gi_trace_depth_div=2, gi_trace_depth_mode="min"),
    "d4": dict(gi_trace_depth_div=4),
    "s84_d2": dict(gi_trace_steps=8, gi_trace_steps2=4, gi_trace_depth_div=2),
    "s105_d2": dict(gi_trace_steps=10, gi_trace_steps2=5,
                    gi_trace_depth_div=2),
    # temporal column interleave of the whole fast-GI block (r4 wave 2);
    # the settle loop converges the cache, so this measures steady-state
    # fidelity — motion quality is TAA-integrated dither lag (see config)
    "il2": dict(gi_temporal_div=2, gi_temporal_pattern="columns"),
    # r4 wave-3 fixes for il2's 0.9675: checkerboard staleness (highest
    # spatial frequency — upsample+TAA average it away) and EMA cache merge
    # (integrates the march noise instead of flip-flopping 2-frame samples)
    "il2_ck": dict(gi_temporal_div=2, gi_temporal_pattern="checker"),
    # the 2-frame hold doubles the settled GI variance under TAA (measured:
    # il2 0.9675 vs full 0.9850); EMA over-smooths instead (0.9486).  Try
    # matching the full-rate settled variance by halving the march jitter.
    "il2_j1": dict(gi_temporal_div=2, gi_temporal_pattern="columns",
                   gi_fast_jitter_scale=1.0),
    "il2_ck_j1": dict(gi_temporal_div=2, gi_fast_jitter_scale=1.0),
    "j1": dict(gi_fast_jitter_scale=1.0),  # attribution: jitter alone
    "s84_d2_now": dict(gi_trace_steps=8, gi_trace_steps2=4),
    # stale-lane rescue #2 (after EMA + jitter failed): spatial infill
    # (substitute a half-texel spatial error for the temporal decorrelation)
    # and spec-only scope (diffuse carries the indoor structure, keep it
    # full-rate; spec is fresnel-weighted small)
    # r4 wave-4: period-2 GI noise — the cache never holds two decorrelated
    # noise instances (the wave-3a mechanism); measured vs replace's 0.967
    "il2_nc": dict(gi_temporal_div=2, gi_temporal_noise="cycle"),
    "il2_nc_cols": dict(gi_temporal_div=2, gi_temporal_noise="cycle",
                        gi_temporal_pattern="columns"),
    # r4 wave-5: period-2 sweep axis — the 3-period rotation against the
    # 2-frame cycle was the OTHER decorrelation between fresh/stale lanes
    # (stale lanes always marched a different sweep rotation of the grid)
    "il2_sw": dict(gi_temporal_div=2, gi_temporal_sweep="cycle"),
    "il2_nc_sw": dict(gi_temporal_div=2, gi_temporal_noise="cycle",
                      gi_temporal_sweep="cycle"),
    # r4 wave-5b: settled-variance matching — the 2-frame hold halves TAA's
    # effective GI sample rate, doubling settled variance vs the reference's
    # full-rate dither; halve the march jitter under nc to compensate ("j1"
    # anchors what jitter=1 does to the full-rate path)
    "il2_nc_j1": dict(gi_temporal_div=2, gi_temporal_noise="cycle",
                      gi_fast_jitter_scale=1.0),
    # non-temporal lane diet: diffuse march+trace at /4 (spec stays /2) —
    # if SSIM holds this halves the diffuse block without any staleness
    "dif4": dict(gi_res_divisor_diffuse=4),
    # the pre-champion round-3 default, for reference
    "probes3": dict(gi_fast_probe_points=3, gi_fast_edge_fallback=False,
                    gi_fast_skip_steps=3, gi_fast_hit_steps=8,
                    gi_fast_hit_step_scale=1.0, gi_fast_jitter_scale=1.0),
    # REFERENCE_PRODUCT candidates: the parity march with
    # the fast-path levers; scored vs the exact reference (default --ref)
    "ref_exact": dict(gi_mode="reference"),
    "ref_il2": dict(gi_mode="reference", gi_temporal_reference=True,
                    gi_temporal_noise="cycle"),
    "ref_d2": dict(gi_mode="reference", gi_reference_depth_div=2),
    "ref_prod": dict(gi_mode="reference", gi_temporal_reference=True,
                     gi_temporal_noise="cycle", gi_reference_depth_div=2),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="default")
    ap.add_argument("--points", default="0.3,0.7")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--detail", type=float, default=4.5)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--diff", action="store_true")
    # total settle+measure scans per point (frames per scan = --frames):
    # 6 x 8 = 48 in-device frames (at taa_blend 0.05 the old
    # 16-frame settle left 0.95^16 = 44% of the TAA transient in BOTH images,
    # amplifying exactly the noise-correlation artifact under test)
    ap.add_argument("--scans", type=int, default=6)
    # score variants against another VARIANT's settled frames instead of the
    # gi_mode="reference" parity march (e.g. --ref-variant default with
    # --variants off1 measures the decorrelated-noise SSIM floor)
    ap.add_argument("--ref-variant", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vulkan_pbr_renderer.app.renderer import (
        CameraState, Renderer, init_frame_state, make_camera, render_frame,
    )
    from vulkan_pbr_renderer.assets import build_scene, suntemple
    from vulkan_pbr_renderer.config import RenderConfig
    from vulkan_pbr_renderer.utils import image

    frames = args.frames
    cfg0 = RenderConfig(width=args.width, height=args.height // 32 * 32)
    scene = build_scene(suntemple.build_parts(detail=args.detail),
                        suntemple.materials(), texture_size=256)
    points = [float(t) for t in args.points.split(",")]
    sun = jnp.asarray([35.0, 80.0], jnp.float32)

    def make_render_n(the_cfg):
        @jax.jit
        def render_n(state, cam_batch, sun, pre, lut):
            img0 = jnp.zeros((the_cfg.height, the_cfg.width, 3), jnp.float32)

            def body(carry, cam_leaves):
                st, _ = carry
                cam = CameraState(*cam_leaves)
                st, img = render_frame(scene, st, cam, sun, pre, lut,
                                       the_cfg, "pallas")
                return (st, img), jnp.mean(img)

            (state, img), means = jax.lax.scan(body, (state, img0),
                                               tuple(cam_batch))
            return state, img, means

        return render_n

    def settle_batch(t, cfg, shift=0.0):
        c = make_camera(*suntemple.camera_path(t + shift), cfg)
        return CameraState(*[
            jnp.stack([getattr(c, f)] * frames) for f in CameraState._fields
        ])

    def settled(cfg, rend, fn, t):
        # args.scans scan calls of `frames` frames each; every call gets a
        # distinct camera nudge ~1e-6 of the path
        # apart — visually identical, and every variant sees the SAME nudge
        # sequence so the final frames are matched.  Only the last scan is
        # timed (steady state).
        st = init_frame_state(cfg)
        img, ms = None, 0.0
        for k in range(max(args.scans, 2)):
            t0 = time.perf_counter()
            st, img, mm = fn(st, settle_batch(t, cfg, k * 1e-6), sun,
                             rend.prefiltered_env, rend.brdf_lut)
            float(mm[-1])
            ms = (time.perf_counter() - t0) / frames * 1000.0
        return np.asarray(img), ms

    # reference frames cached on disk (the parity march costs ~1 s/frame x 32
    # settle frames x 2 points + a minutes-long compile per eval process);
    # keyed by the config/scene knobs that affect the reference image.
    # Delete chiprun_out/ev_ref_cache_* after changing the reference GI path.
    if args.ref_variant is not None:
        rcfg = cfg0.replace(**VARIANTS[args.ref_variant])
        refname = f"v-{args.ref_variant}"
    else:
        rcfg = cfg0.replace(gi_mode="reference")
        refname = "reference"
    refs = {}
    key = (f"{args.width}x{args.height}_d{args.detail}_f{frames}"
           f"_s{max(args.scans, 2)}"
           + (f"_{refname}" if args.ref_variant is not None else "")
           if os.environ.get("EV_REF_CACHE", "1") == "1" else None)
    todo = [t for t in points
            if key is None
            or not os.path.exists(f"{OUT}/ev_ref_cache_{key}_t{t}.npy")]
    if todo:
        rr = Renderer(rcfg, scene, raster_backend="pallas")
        render_ref = make_render_n(rcfg)
        for t in todo:
            refs[t], ref_ms = settled(rcfg, rr, render_ref, t)
            print(f"# {refname} t={t} done ({ref_ms:.0f} ms/frame)",
                  file=sys.stderr)
            if key is not None:
                np.save(f"{OUT}/ev_ref_cache_{key}_t{t}.npy", refs[t])
    for t in points:
        if t not in refs:
            refs[t] = np.load(f"{OUT}/ev_ref_cache_{key}_t{t}.npy")
            print(f"# {refname} t={t} loaded from cache", file=sys.stderr)

    def timed(cfg, rend):
        # bench.py's timing loop: camera-path batches nudged per rep
        fn = make_render_n(cfg)
        cams = lambda s: CameraState(*[
            jnp.stack([getattr(make_camera(*suntemple.camera_path(
                (i + s) / max(frames - 1, 1)), cfg), f) for i in range(frames)])
            for f in CameraState._fields])
        state = init_frame_state(cfg)
        state, _, mm = fn(state, cams(0.0), sun, rend.prefiltered_env,
                          rend.brdf_lut)
        float(mm[-1])
        t0 = time.perf_counter()
        for k in range(2):
            state, _, mm = fn(state, cams(0.003 * (k + 1)), sun,
                              rend.prefiltered_env, rend.brdf_lut)
            float(mm[-1])
        return (time.perf_counter() - t0) / (2 * frames) * 1000.0

    for name in args.variants.split(","):
        vcfg = cfg0.replace(**VARIANTS[name])
        vr = Renderer(vcfg, scene, raster_backend="pallas")
        fn = make_render_n(vcfg)
        ssims = []
        for t in points:
            img, _ = settled(vcfg, vr, fn, t)
            ssims.append(float(image.ssim(img, refs[t])))
            if args.diff:
                d = np.abs(img - refs[t]).mean(-1)
                d = np.clip(d / max(d.max(), 1e-6), 0, 1)
                image.write_png(f"{OUT}/ev_diff_{name}_t{t}.png",
                                np.stack([d] * 3, -1))
                image.write_png(f"{OUT}/ev_img_{name}_t{t}.png", img)
                image.write_png(f"{OUT}/ev_ref_t{t}.png", refs[t])
        line = (f"{name:16s} ssim={['%.4f' % s for s in ssims]} "
                f"mean={np.mean(ssims):.4f}")
        if args.time:
            line += f" frame_ms={timed(vcfg, vr):.1f}"
        print(line, flush=True)


if __name__ == "__main__":
    main()
