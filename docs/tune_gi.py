"""Fast-GI fidelity tuner: SSIM + frame-ms for config variants vs the
reference-parity hybrid march (target: fast SSIM >= 0.95).

Renders matched settled frames at 960x544 (camera t in --points), prints one
line per variant, and (with --diff) writes diff heatmaps to chiprun_out/gi_diff_*.png.

Usage (GPU):  python docs/tune_gi.py [--variants base,skip4,...] [--diff]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# reference caches and diff images stay inside the checkout (gitignored)
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "chiprun_out")
os.makedirs(OUT, exist_ok=True)

VARIANTS = {
    # --- round-3 fog march on the 8-byte nearest f16 grid -----------------
    "fog": dict(gi_fast_fog_march=True),
    "fog_h8": dict(gi_fast_fog_march=True, gi_fast_hit_steps=8,
                   gi_fast_hit_steps_spec=8, gi_fast_hit_step_scale_spec=2.0),
    "fog_h12": dict(gi_fast_fog_march=True, gi_fast_hit_steps=12,
                    gi_fast_hit_steps_spec=12,
                    gi_fast_hit_step_scale_spec=1.5),
    "fog_skip4": dict(gi_fast_fog_march=True, gi_fast_skip_steps=4),
    "fog_d4": dict(gi_fast_fog_march=True, gi_res_divisor_diffuse=4),
    "fog_p5": dict(gi_fast_fog_march=True, gi_fast_probe_points=5),
    "fog_l0": dict(gi_fast_fog_march=True, gi_fast_probe_level=0),
    "fog_ss05": dict(gi_fast_fog_march=True, gi_fast_hit_step_scale=0.5,
                     gi_fast_hit_steps=12, gi_fast_hit_steps_spec=12,
                     gi_fast_hit_step_scale_spec=1.25),
    # reference-exact step counts/spacing (glsl diffuse 12x0.5, spec 16x1.0)
    "fog_ref16": dict(gi_fast_fog_march=True, gi_fast_hit_steps=12,
                      gi_fast_hit_step_scale=0.5, gi_fast_hit_steps_spec=16,
                      gi_fast_hit_step_scale_spec=1.0),
    "fog_spec16": dict(gi_fast_fog_march=True, gi_fast_hit_steps=8,
                       gi_fast_hit_steps_spec=16,
                       gi_fast_hit_step_scale_spec=1.0),
    "fog_stop": dict(gi_fast_fog_march=True, gi_fast_hit_steps=8,
                     gi_fast_hit_steps_spec=8, gi_fast_hit_step_scale_spec=2.0,
                     gi_fast_probe_to_stop=True),
    "fog_ref16_stop": dict(gi_fast_fog_march=True, gi_fast_hit_steps=12,
                           gi_fast_hit_step_scale=0.5,
                           gi_fast_hit_steps_spec=16,
                           gi_fast_hit_step_scale_spec=1.0,
                           gi_fast_probe_to_stop=True),
    # trilinear fog march (u8 rgb pack) — quantifies the nearest bias
    "fog_tri": dict(gi_fast_fog_march=True, gi_fast_fog_trilinear=True,
                    gi_fast_hit_steps=8, gi_fast_hit_steps_spec=16,
                    gi_fast_hit_step_scale_spec=1.0),
    "fog_s16": dict(gi_fast_fog_march=True, gi_fast_hit_steps=8,
                    gi_fast_hit_steps_spec=16,
                    gi_fast_hit_step_scale_spec=1.0),  # = fog_spec16 alias
    "fog_s16_p5": dict(gi_fast_fog_march=True, gi_fast_hit_steps=8,
                       gi_fast_hit_steps_spec=16,
                       gi_fast_hit_step_scale_spec=1.0,
                       gi_fast_probe_points=5),
    "fog_s16_l0": dict(gi_fast_fog_march=True, gi_fast_hit_steps=8,
                       gi_fast_hit_steps_spec=16,
                       gi_fast_hit_step_scale_spec=1.0,
                       gi_fast_probe_level=0),
    # wave-14 screen-term upgrades (reference textureLod mip + edge fallback)
    "mip1": dict(gi_fast_probe_dist_mip=1.0),
    "mip2": dict(gi_fast_probe_dist_mip=2.0),
    "mip05": dict(gi_fast_probe_dist_mip=0.5),
    "edge": dict(gi_fast_edge_fallback=True),
    "mip1_edge": dict(gi_fast_probe_dist_mip=1.0, gi_fast_edge_fallback=True),
    "mip1_edge_p5": dict(gi_fast_probe_dist_mip=1.0,
                         gi_fast_edge_fallback=True, gi_fast_probe_points=5),
    "edge_p5": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5),
    "edge_p7": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=7),
    "mip2_edge_p5": dict(gi_fast_probe_dist_mip=2.0,
                         gi_fast_edge_fallback=True, gi_fast_probe_points=5),
    "edge_p5_sk4": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                        gi_fast_skip_steps=4),
    "mip1_edge_p5_m2": dict(gi_fast_probe_dist_mip=1.0,
                            gi_fast_edge_fallback=True,
                            gi_fast_probe_points=5,
                            gi_fast_probe_margin=2e-4),
    # sweep 3: solidity + step combos on top of edge_p5_sk4 (0.9351)
    "e5s4": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                 gi_fast_skip_steps=4),
    "e5s4_solid1": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                        gi_fast_skip_steps=4, gi_fast_probe_solid_taps=1),
    "e5s4_solid3": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                        gi_fast_skip_steps=4, gi_fast_probe_solid_taps=3),
    "e7s4": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=7,
                 gi_fast_skip_steps=4),
    "e5s4_ref16": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                       gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                       gi_fast_hit_step_scale=0.5),
    "e5s4_l0": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                    gi_fast_skip_steps=4, gi_fast_probe_level=0),
    # sweep 4 (wave 14): reference-exact jitter (2x the march step,
    # glsl:406-410) + full-res probe depth, on top of e5s4_ref16 (0.9367)
    "e5r16": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                  gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                  gi_fast_hit_step_scale=0.5),
    "e5r16_j2": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                     gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                     gi_fast_hit_step_scale=0.5, gi_fast_jitter_scale=2.0),
    "e5r16_pfd": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                      gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                      gi_fast_hit_step_scale=0.5,
                      gi_fast_probe_fullres_depth=True),
    "e5r16_j2pfd": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                        gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                        gi_fast_hit_step_scale=0.5,
                        gi_fast_jitter_scale=2.0,
                        gi_fast_probe_fullres_depth=True),
    "e7r16_j2pfd": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=7,
                        gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                        gi_fast_hit_step_scale=0.5,
                        gi_fast_jitter_scale=2.0,
                        gi_fast_probe_fullres_depth=True),
    "e5r16_j2_solid1": dict(gi_fast_edge_fallback=True,
                            gi_fast_probe_points=5, gi_fast_skip_steps=4,
                            gi_fast_hit_steps=12, gi_fast_hit_step_scale=0.5,
                            gi_fast_jitter_scale=2.0,
                            gi_fast_probe_solid_taps=1),
    # sweep 5: probe spacing gamma (geometric density toward the surface)
    "e5r16_j2_g15": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                         gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                         gi_fast_hit_step_scale=0.5,
                         gi_fast_jitter_scale=2.0, gi_fast_probe_gamma=1.5),
    "e5r16_j2_g2": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                        gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                        gi_fast_hit_step_scale=0.5,
                        gi_fast_jitter_scale=2.0, gi_fast_probe_gamma=2.0),
    "e5r16_j2_g07": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                         gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                         gi_fast_hit_step_scale=0.5,
                         gi_fast_jitter_scale=2.0, gi_fast_probe_gamma=0.7),
    # sweep 6: noise-dithered probe points (soft TAA-averaged boundaries)
    "e5r16_j2_pj1": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                         gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                         gi_fast_hit_step_scale=0.5,
                         gi_fast_jitter_scale=2.0, gi_fast_probe_jitter=1.0),
    "e5r16_j2_pj2": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                         gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                         gi_fast_hit_step_scale=0.5,
                         gi_fast_jitter_scale=2.0, gi_fast_probe_jitter=2.0),
    # sweep 7: geometric probe schedule (the trace's own density profile)
    "e5r16_j2_gr2": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                         gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                         gi_fast_hit_step_scale=0.5,
                         gi_fast_jitter_scale=2.0, gi_fast_probe_growth=2.0),
    "e5r16_j2_gr3": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                         gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                         gi_fast_hit_step_scale=0.5,
                         gi_fast_jitter_scale=2.0, gi_fast_probe_growth=3.0),
    "e5r16_j2_gr2_pj1": dict(gi_fast_edge_fallback=True,
                             gi_fast_probe_points=5, gi_fast_skip_steps=4,
                             gi_fast_hit_steps=12, gi_fast_hit_step_scale=0.5,
                             gi_fast_jitter_scale=2.0,
                             gi_fast_probe_growth=2.0,
                             gi_fast_probe_jitter=1.0),
    "e7r16_j2_gr2_pj1": dict(gi_fast_edge_fallback=True,
                             gi_fast_probe_points=7, gi_fast_skip_steps=4,
                             gi_fast_hit_steps=12, gi_fast_hit_step_scale=0.5,
                             gi_fast_jitter_scale=2.0,
                             gi_fast_probe_growth=2.0,
                             gi_fast_probe_jitter=1.0),
    # sweep 8: trace-range overshoot |to_open|/|to_open.xy| (glsl:302,308)
    "e5r16_j2_ov4": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                         gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                         gi_fast_hit_step_scale=0.5,
                         gi_fast_jitter_scale=2.0,
                         gi_fast_probe_overshoot=4.0),
    "e5r16_j2_ov8": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                         gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                         gi_fast_hit_step_scale=0.5,
                         gi_fast_jitter_scale=2.0,
                         gi_fast_probe_overshoot=8.0),
    "e5r16_j2_ov4_gr2": dict(gi_fast_edge_fallback=True,
                             gi_fast_probe_points=5, gi_fast_skip_steps=4,
                             gi_fast_hit_steps=12, gi_fast_hit_step_scale=0.5,
                             gi_fast_jitter_scale=2.0,
                             gi_fast_probe_overshoot=4.0,
                             gi_fast_probe_growth=2.0),
    "e5r16_j2_ov4_gr2_pj1": dict(gi_fast_edge_fallback=True,
                                 gi_fast_probe_points=5,
                                 gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                                 gi_fast_hit_step_scale=0.5,
                                 gi_fast_jitter_scale=2.0,
                                 gi_fast_probe_overshoot=4.0,
                                 gi_fast_probe_growth=2.0,
                                 gi_fast_probe_jitter=1.0),
    "e5r16_j2_ov4_gr2_s1": dict(gi_fast_edge_fallback=True,
                                gi_fast_probe_points=5,
                                gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                                gi_fast_hit_step_scale=0.5,
                                gi_fast_jitter_scale=2.0,
                                gi_fast_probe_overshoot=4.0,
                                gi_fast_probe_growth=2.0,
                                gi_fast_probe_solid_taps=1),
    # probe depth table at /4 (0.25 MB vs 2 MB)
    "e5r16_j2_ov4_dd4": dict(gi_fast_edge_fallback=True,
                             gi_fast_probe_points=5, gi_fast_skip_steps=4,
                             gi_fast_hit_steps=12, gi_fast_hit_step_scale=0.5,
                             gi_fast_jitter_scale=2.0,
                             gi_fast_probe_overshoot=4.0,
                             gi_fast_probe_depth_div=4),
    # final knob checks on the champion base
    "e5r16_j2_m0": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                        gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                        gi_fast_hit_step_scale=0.5, gi_fast_jitter_scale=2.0,
                        gi_fast_probe_margin=0.0),
    "e5r16_j2_m2e4": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                          gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                          gi_fast_hit_step_scale=0.5,
                          gi_fast_jitter_scale=2.0,
                          gi_fast_probe_margin=2e-4),
    "e5r16_j2_l0": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                        gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                        gi_fast_hit_step_scale=0.5, gi_fast_jitter_scale=2.0,
                        gi_fast_probe_level=0),
    # mip-lod prev resolve revisited on the e5r16_j2 base (the reference's
    # textureLod(step_len*5) far-softening, glsl:377)
    "e5r16_j2_mip1": dict(gi_fast_edge_fallback=True, gi_fast_probe_points=5,
                          gi_fast_skip_steps=4, gi_fast_hit_steps=12,
                          gi_fast_hit_step_scale=0.5,
                          gi_fast_jitter_scale=2.0,
                          gi_fast_probe_dist_mip=1.0),
    # refinements on top of the trilinear fog default
    "tri_ref": dict(gi_fast_fog_march=True, gi_fast_fog_trilinear=True,
                    gi_fast_hit_steps=12, gi_fast_hit_step_scale=0.5,
                    gi_fast_hit_steps_spec=16,
                    gi_fast_hit_step_scale_spec=1.0),
    "tri_l0": dict(gi_fast_fog_march=True, gi_fast_fog_trilinear=True,
                   gi_fast_probe_level=0),
    "tri_skip4": dict(gi_fast_fog_march=True, gi_fast_fog_trilinear=True,
                      gi_fast_skip_steps=4),
    "tri_d1": dict(gi_fast_fog_march=True, gi_fast_fog_trilinear=True,
                   gi_res_divisor=1),
    # --- round-3 hi-z screen trace (gi_fast_screen_mode="hiz" default) ----
    "v5": dict(),
    "v5_i10": dict(gi_hiz_iters=10),
    "v5_i20": dict(gi_hiz_iters=20),
    "v5_th03": dict(gi_hiz_thickness=0.3),
    "v5_th15": dict(gi_hiz_thickness=1.5),
    "v5_thinf": dict(gi_hiz_thickness=1e9),   # one-sided, the reference rule
    "v5_solid": dict(gi_hiz_solid=0.25),
    "v5_b02": dict(gi_hiz_bias=0.02),
    "v5_b10": dict(gi_hiz_bias=0.10),
    "v5_b20": dict(gi_hiz_bias=0.20),
    "v5_h8": dict(gi_fast_hit_steps=8, gi_fast_hit_steps_spec=8,
                  gi_fast_hit_step_scale_spec=2.0),
    "v5_l0": dict(gi_fast_probe_level=0),
    "v5_d4": dict(gi_res_divisor_diffuse=4),
    # --- round-3 march-structured path with k-point probes ----------------
    "v4": dict(gi_fast_screen_mode="probes"),
    "v4_noss": dict(gi_fast_screen_probe=False),
    "v4_s3": dict(gi_fast_samples=3),
    "v4_p1": dict(gi_fast_probe_points=1),
    "v4_p5": dict(gi_fast_probe_points=5),
    "v4_d4": dict(gi_res_divisor_diffuse=4),
    "v4_h8": dict(gi_fast_hit_steps=8, gi_fast_hit_steps_spec=8,
                  gi_fast_hit_step_scale_spec=2.0),
    "v4_l0": dict(gi_fast_probe_level=0),
    # --- round-2 quadrature path ------------------------------------------
    "base": dict(gi_fast_march=False, gi_fast_spec_hit_steps=0,
                 gi_fast_probe_level=1),
    "skip4": dict(gi_fast_skip_steps=4),
    "samples3": dict(gi_fast_samples=3),
    "skip4_samples3": dict(gi_fast_skip_steps=4, gi_fast_samples=3),
    "noprobe": dict(gi_fast_screen_probe=False),
    "spread2": dict(gi_fast_sample_spread=2.0),
    "hit6": dict(gi_fast_spec_hit_steps=6, gi_fast_probe_level=1),
    "hit6_l0": dict(gi_fast_spec_hit_steps=6, gi_fast_probe_level=0),
    "hit10_l0": dict(gi_fast_spec_hit_steps=10, gi_fast_probe_level=0),
    "hit6_dh4_l0": dict(gi_fast_spec_hit_steps=6, gi_fast_diffuse_hit_steps=4,
                        gi_fast_probe_level=0),
    "margin0": dict(gi_fast_spec_hit_steps=0, gi_fast_probe_margin=0.0),
    "dssi1": dict(gi_fast_spec_hit_steps=0, gi_diffuse_ss_intensity=1.0),
    "dh2_m0": dict(gi_fast_spec_hit_steps=2, gi_fast_diffuse_hit_steps=2,
                   gi_fast_probe_margin=0.0),
    "probe3": dict(gi_fast_spec_hit_steps=0, gi_fast_probe_points=3),
    "probe3_l0": dict(gi_fast_spec_hit_steps=0, gi_fast_probe_points=3,
                      gi_fast_probe_level=0),
    "probe4": dict(gi_fast_spec_hit_steps=0, gi_fast_probe_points=4),
    "probe3_s3": dict(gi_fast_spec_hit_steps=0, gi_fast_probe_points=3,
                      gi_fast_samples=3),
    # reference-path ablations (gi_mode stays "reference"): which term of the
    # hybrid march carries the steady-state difference?
    "ref_noss": dict(gi_mode="reference", gi_diffuse_ss_intensity=0.0,
                     gi_specular_ss_intensity=0.0),
    "ref_nofog": dict(gi_mode="reference", gi_diffuse_steps=1,
                      gi_specular_steps=1),
    "ref_nost": dict(gi_mode="reference", gi_screen_trace_steps=1),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="base")
    ap.add_argument("--points", default="0.3,0.7")
    ap.add_argument("--settle", type=int, default=4)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--detail", type=float, default=4.5)
    ap.add_argument("--diff", action="store_true")
    ap.add_argument("--time", action="store_true",
                    help="also time each variant (8-frame in-device scan)")
    ap.add_argument("--ceiling", action="store_true",
                    help="measure the reference-vs-reference SSIM noise floor")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vulkan_pbr_renderer.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer.assets import build_scene, suntemple
    from vulkan_pbr_renderer.config import RenderConfig
    from vulkan_pbr_renderer.utils import image

    cfg = RenderConfig(width=args.width, height=args.height // 32 * 32)
    scene = build_scene(suntemple.build_parts(detail=args.detail),
                        suntemple.materials(), texture_size=256)
    points = [float(t) for t in args.points.split(",")]

    def settled(mode_cfg, t):
        r = Renderer(mode_cfg, scene, raster_backend="pallas")
        cam = make_camera(*suntemple.camera_path(t), mode_cfg)
        img = None
        for k in range(args.settle):
            img = r.render(cam, sun_angle=(35.0 + 0.001 * k, 80.0))
        return np.asarray(img)

    refs = {}
    for t in points:
        refs[t] = settled(cfg.replace(gi_mode="reference"), t)
        print(f"# reference frame t={t} done", file=sys.stderr)

    if args.ceiling:
        # SSIM noise floor: the reference path vs ITSELF at a 1e-6 camera
        # nudge (byte-distinct inputs, visually identical).  Fast-GI SSIM
        # can't beat this — TAA-integrated jitter/noise isn't bit-stable.
        for t in points:
            img2 = settled(cfg.replace(gi_mode="reference"), t + 1e-6)
            s = float(image.ssim(img2, refs[t]))
            print(f"ceiling ref-vs-ref t={t}: ssim={s:.4f}")

    for name in args.variants.split(","):
        kw = dict(VARIANTS[name])
        kw.setdefault("gi_mode", "fast")
        vcfg = cfg.replace(**kw)
        ssims = []
        for t in points:
            img = settled(vcfg, t)
            s = float(image.ssim(img, refs[t]))
            ssims.append(s)
            if args.diff:
                d = np.abs(img - refs[t]).mean(-1)
                d = (np.clip(d / max(d.max(), 1e-6), 0, 1) * 255).astype(np.uint8)
                image.write_png(f"{OUT}/gi_diff_{name}_t{t}.png",
                                np.stack([d, d, d], -1) / 255.0)
                image.write_png(f"{OUT}/gi_fast_{name}_t{t}.png", img)
                if name == args.variants.split(",")[0]:
                    image.write_png(f"{OUT}/gi_ref_t{t}.png", refs[t])
        line = (f"{name:20s} ssim={['%.4f' % s for s in ssims]} "
                f"mean={np.mean(ssims):.4f}")
        if args.time:
            line += f" frame_ms={_time_variant(vcfg, scene, points[0]):.1f}"
        print(line)


def _time_variant(vcfg, scene, t, frames=6, reps=2):
    """Frame-ms for a config: in-device lax.scan over `frames` frames
    (bench.py methodology), sun nudged per rep."""
    import functools
    import time as _time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vulkan_pbr_renderer.app.renderer import (
        CameraState, Renderer, init_frame_state, make_camera, render_frame,
    )
    from vulkan_pbr_renderer.assets import suntemple

    r = Renderer(vcfg, scene, raster_backend="pallas")
    cams = [make_camera(*suntemple.camera_path(t + 0.02 * i), vcfg)
            for i in range(frames)]
    cam_batch = CameraState(*[
        jnp.stack([getattr(c, f) for c in cams]) for f in CameraState._fields
    ])
    sun = jnp.asarray([35.0, 80.0], jnp.float32)

    @functools.partial(jax.jit, static_argnames=("n",))
    def render_n(state, cam_batch, sun, pre, lut, n):
        def body(state, cam_leaves):
            cam = CameraState(*cam_leaves)
            state, img = render_frame(scene, state, cam, sun, pre, lut, vcfg,
                                      "pallas")
            return state, jnp.mean(img)
        state, means = jax.lax.scan(body, state, tuple(cam_batch))
        return state, means

    state = init_frame_state(vcfg)
    state, means = render_n(state, cam_batch, sun, r.prefiltered_env,
                            r.brdf_lut, frames)
    float(means[-1])
    t0 = _time.perf_counter()
    for k in range(reps):
        state, means = render_n(state, cam_batch, sun + 0.001 * (k + 1),
                                r.prefiltered_env, r.brdf_lut, frames)
        float(means[-1])
    return (_time.perf_counter() - t0) / (reps * frames) * 1000.0


if __name__ == "__main__":
    main()
