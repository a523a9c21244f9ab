"""Renderer configuration.

The reference scatters its tuning constants across shaders and render.cpp
(SURVEY.md §5 "Config / flag system": BLOOM_PASS_COUNT render.h:2,
LIGHTGRID_SIZE render.cpp:7, sun emission lighting_pass.glsl:616, bloom factor
bloom_upsample.glsl:37, GI step counts lighting_pass.glsl:684-701, FOV / z range
main.cpp:85-87, sun ortho extent render.cpp:959-961...).  Here every one of
those literals becomes a named field of one frozen dataclass; the dataclass is
hashable so it can be a static argument of jitted frame functions.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- framebuffer ------------------------------------------------------
    width: int = 1920
    height: int = 1080

    # --- camera (main.cpp:83-87) -----------------------------------------
    fov_y_deg: float = 75.0
    z_near: float = 0.02
    z_far: float = 10000.0

    # --- sun + shadow map (render.cpp:677, 959-971) -----------------------
    shadow_map_size: int = 2048
    sun_half_size: float = 40.0            # ortho extent, world units
    sun_color: Tuple[float, float, float] = (1.0, 0.9, 0.7)
    sun_emission_scale: float = 25.0       # lighting_pass.glsl:616
    voxelize_sun_emission_scale: float = 5.0  # lightgrid_voxelize.glsl:102
    shadow_normal_offset: float = 0.1      # lighting_pass.glsl:596
    # 'taps4': 4 one-row taps from the 2x2 u16 window pack; 'split4x4': 2
    # wider rows from the split 4x4 pack (sampling.py)
    pcf_mode: str = "split4x4"

    # --- lightgrid GI (render.cpp:7,678; lightgrid_sweep.glsl) ------------
    lightgrid_size: int = 128
    lightgrid_extent: float = 40.0         # world units; scale = 1/extent (render.cpp:960)
    skylight: Tuple[float, float, float] = (1.0, 1.2, 2.0)  # lightgrid_sweep.glsl:23
    sweep_move_ratio: float = 0.5          # lightgrid_sweep.glsl:32
    sweep_blend: float = 0.35              # lightgrid_sweep.glsl:70
    gi_diffuse_steps: int = 12             # lighting_pass.glsl:685
    gi_specular_steps: int = 16            # lighting_pass.glsl:701
    gi_diffuse_step_scale: float = 1.0
    gi_specular_step_scale: float = 2.0
    gi_diffuse_foggyness: float = 0.5
    gi_specular_foggyness_is_roughness: bool = True
    gi_diffuse_ss_intensity: float = 0.75
    gi_specular_ss_intensity: float = 0.9
    gi_screen_trace_steps: int = 24        # bounded replacement for while(true) @ glsl:315
    world_bounds: float = 99.0             # sky fallback bound (lighting_pass.glsl:708)
    # Quality/perf knobs (no reference equivalent): the GI marches and the
    # shaft march are gather-heavy; computing them at reduced resolution and
    # bilinearly upsampling cuts their work by the square of the factor.
    # 1 = reference-exact full resolution.
    gi_res_divisor: int = 2
    gi_res_divisor_diffuse: int = 0        # 0 = same as gi_res_divisor; 4 =
                                           # quarter-res diffuse ray only
                                           # (diffuse GI is low-frequency and
                                           # TAA-integrated; specular keeps
                                           # gi_res_divisor for reflections)
    shaft_res_divisor: int = 4
    sky_res_divisor: int = 2               # 2 = sky env lookups at half res
                                           # (one env texel covers several
                                           # pixels at 1080p); 1 = full res
    gi_temporal_div: int = 2               # 1 = off; 2 = temporally
                                           # interleave the fast-GI march +
                                           # screen trace: each frame computes
                                           # alternating half-res COLUMNS
                                           # (parity = frame_idx % 2) into a
                                           # persistent per-lane cache
                                           # (FrameState.gi_cache) and shades
                                           # from the cache — halves the
                                           # gather-bound GI block; converges
                                           # in 2 frames statically, one-frame
                                           # -stale lanes in motion (TAA
                                           # integrates, like the march's own
                                           # noise dither).  Single-chip only
                                           # (parallel/sharding.py forces 1,
                                           # like the res divisors).
                                           # DEFAULT 2 since r5: the measured
                                           # SSIM noise FLOOR (two full-rate
                                           # runs, dither offset 1 frame:
                                           # 0.9686) showed the old 0.985
                                           # gate rewarded noise-pattern
                                           # correlation; the interleave
                                           # scores 0.9690 vs reference —
                                           # ABOVE the floor — at half the
                                           # GI work (docs/VISUAL_PARITY.md
                                           # "honest gate").
    gi_temporal_pattern: str = "checker"   # which half of the GI lanes each
                                           # frame refreshes: "columns" =
                                           # alternating columns (lowest-
                                           # frequency staleness); "checker" =
                                           # checkerboard (odd rows use the
                                           # opposite column parity) — the
                                           # stale pattern is then the highest
                                           # spatial frequency.  Settled SSIM
                                           # is equal (eval_ssim r4: checker
                                           # 0.9669 vs columns 0.9675);
                                           # checker is kept for motion,
                                           # where its staleness is sub-TAA-
                                           # kernel instead of column bands.
    gi_temporal_noise: str = "cycle"       # GI noise schedule under the
                                           # interleave: "frame" = the noise
                                           # fields advance every frame (the
                                           # reference's own cadence) — the
                                           # cache then always holds TWO
                                           # decorrelated noise instances
                                           # (fresh lanes noise(T), stale
                                           # noise(T-1)), which the r4 wave-3a
                                           # analysis identified as the
                                           # interleave's dominant SSIM cost;
                                           # "cycle" = GI noise (march jitter,
                                           # bent normal, trace dither)
                                           # advances once per 2-frame refresh
                                           # CYCLE (frame_idx | 1), so a
                                           # completed cycle carries ONE
                                           # coherent noise instance — the
                                           # field then looks like the
                                           # reference's at a single frame.
                                           # TAA integrates half the dither
                                           # instances per unit time (same
                                           # class as the interleave's own
                                           # staleness).  GI-scoped only: PCF
                                           # / shafts / TAA keep frame noise.
    gi_temporal_sweep: str = "frame"       # lightgrid sweep-axis schedule
                                           # under the interleave: "frame" =
                                           # rotate the swept axis every frame
                                           # (render.cpp:1064-1069, the
                                           # reference cadence) — the 3-period
                                           # rotation against the 2-frame
                                           # refresh cycle means stale lanes
                                           # always sampled a DIFFERENT sweep
                                           # rotation of the grid than fresh
                                           # ones (period-6 decorrelation);
                                           # "cycle" = hold each axis for the
                                           # 2-frame cycle (0,0,1,1,2,2): both
                                           # halves of a completed cycle
                                           # marched near-identical grids.
                                           # Same sweeps/frame, full rotation
                                           # every 6 frames instead of 3 —
                                           # light propagates at half the
                                           # frame rate (steady state
                                           # unchanged).  Ignored when the
                                           # interleave is off.
    gi_noise_offset: int = 0               # offsets the GI block's noise
                                           # frame index (march jitter, bent
                                           # normal, trace dither) by N frames
                                           # — every other noise consumer
                                           # (PCF, shafts, TAA jitter) keeps
                                           # the frame schedule.  A pure
                                           # MEASUREMENT control: two runs
                                           # offset by 1 render the same
                                           # steady-state field with
                                           # decorrelated dither, giving the
                                           # SSIM noise FLOOR the fidelity
                                           # gate must be read against
                                           # (r4 wave-3a: SSIM partly rewards
                                           # noise-pattern correlation, not
                                           # image quality).  0 in production.
    gi_temporal_reference: bool = False    # opt-in: apply the temporal
                                           # interleave to gi_mode=
                                           # "reference" too (halves the full
                                           # parity march's cost, same TAA-
                                           # integrated staleness class).
                                           # OFF by default so the reference
                                           # mode stays the exact SSIM
                                           # yardstick bench.py measures
                                           # against.
    gi_reference_depth_div: int = 1        # reference-mode screen-trace depth
                                           # table divisor — the r4 fast-path
                                           # lever (gi_trace_depth_div)
                                           # applied to the parity march's
                                           # own trace.  1 = exact (the SSIM
                                           # yardstick + the 480x272
                                           # reference golden stay
                                           # byte-identical); 2 = the
                                           # REFERENCE_PRODUCT affordable
                                           # mode (plain [::2,::2] subsample,
                                           # same rationale as
                                           # gi_trace_depth_mode="plain").
    # 'reference': full hybrid screen/voxel march (lighting_pass.glsl:273-424)
    # 'fast': irradiance-cache sampling of the swept grid (~10x fewer gathers)
    gi_mode: str = "fast"
    gi_fast_skip_steps: int = 4            # blockage skip, reference-exact
                                           # (glsl:280-288; champion sweep 4)
    gi_fast_open_thresh: float = 0.3
    gi_fast_samples: int = 2               # fog-weighted samples along the ray
    gi_fast_sample_spread: float = 3.0     # voxels between extra samples
    gi_fast_screen_probe: bool = True      # one-probe prev-frame bounce
    gi_fast_probe_margin: float = 5e-5     # ndc-z hit margin for the probe
    gi_fast_spec_hit_steps: int = 0        # alpha-march the specular ray to
                                           # its next BLOCKED voxel and probe
                                           # the prev frame THERE (the
                                           # reference's march resolves
                                           # reflections at the hit point,
                                           # lighting_pass.glsl:371-384);
                                           # 0 = probe the first-open point
                                           # (measured BETTER, docs/tune_gi)
    gi_fast_diffuse_hit_steps: int = 0     # same for the diffuse bent ray
    gi_fast_probe_level: int = 1           # prev-frame pyramid level for the
                                           # probe (0 = half res, sharper)
    gi_fast_probe_points: int = 5          # >1: also depth-test the interior
                                           # of the surface->first-open
                                           # segment (gi.screen_probe_multi) —
                                           # catches rays dipping behind
                                           # geometry mid-path (lamp halos)
    gi_fast_probe_dist_mip: float = 0.0    # >0: probe resolves sample the
                                           # prev pyramid at level ~=
                                           # dist_world * this (reference:
                                           # textureLod mip min(step*5, 5),
                                           # glsl:377 — far resolves soft);
                                           # 0 = fixed gi_fast_probe_level
    gi_fast_edge_fallback: bool = True    # probes leaving the screen fall
                                           # back to a 2.5-voxel camera-ward
                                           # lightgrid sample (glsl:324-331)
    gi_fast_probe_solid_taps: int = 0      # >0: require the occluder to be
                                           # voxel-solid before resolving
                                           # (glsl:348-363 does 3 taps >=1.5;
                                           # 1 = midpoint economy), costs
                                           # k_points*taps alpha rows
    # round-3 march-structured fast GI (gi.sample_radiance_march): reproduces
    # the reference march's termination + fog-average structure on the cheap
    # alpha rows (the round-2 quadrature plateaued at SSIM 0.87, below even
    # whole-term reference ablations — docs/tune_gi)
    gi_fast_march: bool = True
    # fog-march rgb: phase A + C of the reference march run EXACTLY (same
    # accumulation, same termination) on an 8-byte nearest-sampled f16 rgba
    # grid (gi.sample_radiance_fog) instead of the trilinear alpha march +
    # 3-quantile EMA reconstruction — structurally exact.  docs/tune_gi,
    # 960x544, 2 camera points: SSIM 0.9124 vs the older march's 0.9101.
    gi_fast_fog_march: bool = True
    # screen term of the march path: "probes" = k-point depth probes of the
    # [surface, first-open] segment; "hiz" = hierarchical-z trace of the same
    # segment (gi.hiz_trace); "trace" (default, round 3) = the reference's
    # OWN linear trace, bounded (gi.screen_trace_linear).  Measured at bench
    # methodology (docs/eval_ssim, full-res 2-point SSIM vs the parity
    # march): trace 0.9890 vs probes 0.9301 vs the round-2 probe sweep
    # ceiling ~0.94 — the probe fidelity wall was the missing continuous
    # march structure, not its tuning.
    gi_fast_screen_mode: str = "trace"
    # "trace" = gi.screen_trace_linear: the reference's OWN linear screen
    # trace (step schedule, occlusion test, 3-tap solidity, boost past thin
    # occluders, off-screen fallback — lighting_pass.glsl:301-397), bounded
    # and with solidity deferred to depth crossings.  The faithful screen
    # term: its only deltas vs the parity path are the trip-count bounds.
    gi_trace_steps: int = 12               # round-1 step budget (the parity
                                           # path bounds the same loop at 24)
    gi_trace_rounds: int = 2               # translucent crossings a lane may
                                           # boost past (glsl:357-361)
    gi_trace_steps2: int = 6               # steps per re-armed round
    gi_trace_solid_taps: int = 1           # 3 = reference-exact (glsl:348);
                                           # 1 = midpoint economy (measured
                                           # equal: docs/eval_ssim r3)
    gi_trace_depth_div: int = 2            # 1 = full-res depth (exact);
                                           # 2/4 = reduced table.  2 is the
                                           # default: the [H,W] f32 table
                                           # is the trace's gather working
                                           # set.  eval_ssim:
                                           # div1 0.9889, div2 plain 0.9850,
                                           # div2 min 0.9846, div4 0.9750
                                           # (too coarse)
    gi_trace_depth_mode: str = "plain"     # reduction for the trace table:
                                           # "plain" = [::k,::k] subsample
                                           # (unbiased quantization of the
                                           # sample positions; one strided
                                           # slice per frame), "min" =
                                           # reduce_window min (free but
                                           # dilates silhouettes one texel
                                           # nearer -> false resolves;
                                           # eval_ssim: min 0.9846 vs plain
                                           # 0.9850)
    gi_trace_unroll: int = 6               # steps per XLA while iteration;
                                           # >= the step budget emits straight-
                                           # line code (numerically identical
                                           # decisions, float-ulp op-order
                                           # deltas — tests/test_gi_trace.py).
                                           # Full unroll multiplies the
                                           # compile time; its speed on the
                                           # GPU is not measured
    gi_fast_probe_to_stop: bool = False    # probe the [surface, march-stop]
                                           # segment instead of [surface,
                                           # first-open] (measured WORSE:
                                           # 0.8885 vs 0.9124, docs/tune_gi
                                           # fog_stop — false resolves)
    gi_fast_fog_trilinear: bool = True     # fog march samples the rgb window
                                           # pack trilinearly through the u16
                                           # BITCAST view (gi._gs_uvw).
                                           # tune_gi SSIM: 0.9244 vs
                                           # nearest's 0.9150 — the nearest
                                           # march's point samples average
                                           # darker through the concave tone
                                           # compression
    gi_hiz_iters: int = 14                 # fixed traversal budget
    gi_hiz_levels: int = 6                 # pyramid depth (cell up to 32 px)
    gi_hiz_thickness: float = 0.75         # two-sided hit window, VIEW-space
                                           # world units (ref: one-sided ->
                                           # infinity; finite rejects rays
                                           # passing far behind thin geo)
    gi_hiz_bias: float = 0.05              # view-space behind-ness required
                                           # before a crossing counts (self-
                                           # hit guard, gi.hiz_trace)
    gi_hiz_solid: float = 0.0              # >0: reject hits whose lightgrid
                                           # alpha at the hit is below this
                                           # (glsl:348-356); 0 = off (see
                                           # gi.screen_trace_hiz rationale)
    gi_fast_jitter_scale: float = 2.0      # march-start jitter in units of the
                                           # march step.  The reference jitters
                                           # by the PRE-halving step (ro +=
                                           # rd*noise before the 0.5*rd steps,
                                           # lighting_pass.glsl:399-407), i.e.
                                           # 2.0 in our parameterization
    gi_fast_probe_gamma: float = 1.0       # probe-point spacing exponent:
                                           # fractions (k/K)^gamma along the
                                           # surface->open segment; >1 packs
                                           # points toward the surface like
                                           # the reference's 1.2x-growing
                                           # trace steps (glsl:333-334)
    gi_fast_probe_overshoot: float = 0.0   # >0: extend the probed segment by
                                           # the reference trace's own range
                                           # factor |to_open|/|to_open.xy|
                                           # (view space), clamped to this —
                                           # ssray_dir is normalized by the XY
                                           # length only (glsl:302), so view-
                                           # aligned rays trace FAR past the
                                           # open point and resolve distant
                                           # geometry; 0 = probe only to open
    gi_fast_probe_growth: float = 0.0      # >1: geometric probe fractions
                                           # (g^k-1)/(g^K-1) — the reference
                                           # trace's own density profile
                                           # (steps grow 1.2x from ~z/100,
                                           # glsl:301,333); 0 = use gamma
    gi_fast_probe_jitter: float = 0.0      # noise-dither each probe fraction
                                           # by +-jitter/K: soft TAA-averaged
                                           # hit boundaries like the
                                           # reference's noise-scaled trace
                                           # start (glsl:301); 0 = off
    gi_trace_impl: str = "v2"              # "v2" = the r4 scalar-s trace
                                           # (squared-norm occlusion, closed-
                                           # form unprojection, 7-ch state);
                                           # "v1" = the r3 carried-pos form
                                           # (kept for the in-process A/B)
    gi_fog_unroll: int = 1                 # fog-march fori_loop unroll (r4
                                           # A/B: in-process ab_time decides;
                                           # unrolling a gather-bound body
                                           # can HURT by growing the working
                                           # set)
    gi_fast_probe_depth_div: int = 2       # probe z-test depth reduction: 2 =
                                           # min-2x2 half res (2 MB table),
                                           # 4 = min-4x4 quarter res
                                           # (0.25 MB) — more
                                           # conservative at silhouettes
    gi_fast_probe_fullres_depth: bool = False  # screen probes depth-test the
                                           # full-res depth (8 MB table)
                                           # instead of the conservative
                                           # min-2x2 half-res reduction —
                                           # min-depth moves surfaces NEARER,
                                           # inflating "behind geometry" hits
                                           # at silhouettes (false resolves)
    gi_fast_hit_steps: int = 12            # diffuse: reference-exact
    gi_fast_hit_step_scale: float = 0.5    # 12 steps x 0.5 voxel (glsl:685
                                           # + the 0.5*rd halving glsl:409;
                                           # part of the e5r16_j2 champion
                                           # bundle: full-res 2-point SSIM
                                           # 0.9443 vs 0.9245)
    gi_fast_hit_steps_spec: int = 16       # specular ray: reference-exact
    gi_fast_hit_step_scale_spec: float = 1.0  # 16 x 1.0 voxel (glsl:701);
                                           # the coarser 8x2.0 skips small
                                           # emitter voxels (pillar lamp
                                           # reflections): 0.9124 -> 0.9151
    voxelize_samples: int = 0              # static voxelize sample-stream
                                           # capacity; 0 = 1<<20 (the
                                           # historical default) — Renderer
                                           # init auto-sizes it exactly via
                                           # gi.voxelize_sample_capacity

    # --- light shafts (lighting_pass.glsl:622-651) ------------------------
    light_shaft_intensity: float = 0.001
    light_shaft_steps: int = 16
    # 'polar': epipolar shadow profile, 1 gather row/pixel (shadow.py
    # light_shafts_polar); 'march': the reference's per-step sampling
    light_shaft_mode: str = "polar"
    shaft_polar_thetas: int = 4096

    # --- post stack -------------------------------------------------------
    bloom_pass_count: int = 6              # render.h:2
    bloom_strength: float = 0.06           # bloom_upsample.glsl:37
    taa_blend: float = 0.05                # taa_resolve.glsl:246
    taa_catmull_history: bool = True       # 9-tap Catmull-Rom (taa_resolve.glsl:125);
                                           # False = single bilinear (4 vs 36 gathers)
    taa_full_rgb_catmull: bool = False     # reference-exact full-RGB Catmull
                                           # history (one 96B 4x4 rgb window
                                           # row via the i32 bitcast view +
                                           # a 16B prev-velocity row) instead
                                           # of the YCoCg split (32B luma
                                           # Catmull + 32B bilinear chroma)
    taa_velocity_rejection: float = 1000.0  # taa_resolve.glsl:263
    exposure: float = 2.0                  # final_post_process.glsl:32
    emissive_scale: float = 10.0           # lighting_pass.glsl:440

    # --- IBL bake (render.cpp:794-796, gen_*.glsl) ------------------------
    irradiance_size: int = 32
    irradiance_samples: int = 1024         # gen_irradiance_map.glsl:73
    prefiltered_env_size: int = 256
    prefiltered_env_min_size: int = 16     # render.cpp:564-579
    prefilter_samples: int = 8192          # gen_prefiltered_env_map.glsl:120
    brdf_lut_size: int = 256
    brdf_lut_samples: int = 4096           # gen_brdf_integration_map.glsl:142

    # --- alpha test + material (geometry_pass.glsl:259) -------------------
    alpha_test_threshold: float = 0.3
    f0_dielectric: float = 0.04            # lighting_pass.glsl:657
    # 'trilinear' = the reference's fixed-function mip filtering
    # (gpu_vulkan.c:613-634), 2 gather rows/px; 'nearest' = 1 row (the
    # round-1/2 economy; a documented VISUAL_PARITY.md delta)
    material_filter: str = "stochastic"     # mip-dithered 1-row unbiased
                                           # estimator of trilinear, TAA-
                                           # integrated (gbuffer.py
                                           # rationale); 'trilinear' = the
                                           # exact 2-row fixed-function lerp
                                           # (gpu_vulkan.c:613-634),
                                           # 'nearest' = 1-row economy

    # --- rasterizer (tile kernel; no reference equivalent) -----------------
    raster_tile: int = 32                  # square pixel tile of the binning
                                           # and of raster/tiled.py (one
                                           # program per tile)
    pair_capacity_factor: int = 3          # binning pair buffer = factor * tris.
                                           # Round-3 sweep after the crossing-
                                           # triangle bbox fix (setup.py):
                                           # fly-through peak 0.80 pairs/tri,
                                           # sun pass 1.26 — the old 5.6-6.2
                                           # was full-screen bbox fallbacks.
                                           # 3 covers the ~2.1/tri floor of
                                           # small closed meshes under the
                                           # cull=none shadow pass.  Every
                                           # fill/sort/gather cost is
                                           # proportional to this buffer; the
                                           # overflow counter catches worse
                                           # scenes (check_overflow)

    # --- pass toggles -----------------------------------------------------
    enable_shadows: bool = True
    enable_gi: bool = True
    enable_light_shafts: bool = True
    enable_taa: bool = True
    enable_bloom: bool = True
    enable_ibl: bool = True
    visualize_lightgrid: bool = False

    # (precision note: the reference keeps HDR RTs at RGBA16F; moving our
    # dense intermediates to bf16 is on the round-2 roadmap)

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def lightgrid_scale(self) -> float:
        return 1.0 / self.lightgrid_extent

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Preset configs mirroring BASELINE.json "configs".
TRIANGLE = RenderConfig(width=1280, height=720, enable_gi=False, enable_taa=False,
                        enable_bloom=False, enable_shadows=False, enable_ibl=False,
                        enable_light_shafts=False)
SUNTEMPLE_1080P = RenderConfig()

# The affordable reference-GI product mode: the full-rate
# bit-exact parity march stays the eval yardstick (gi_mode="reference"
# alone); this preset applies the two measured fast-path levers to it —
# the temporal interleave and the subsampled trace depth table — without
# touching the yardstick's code path (both knobs default off).  SSIM vs
# the exact reference: docs/VISUAL_PARITY.md; its GPU cost is not measured.
REFERENCE_PRODUCT = RenderConfig(gi_mode="reference",
                                 gi_temporal_reference=True,
                                 gi_reference_depth_div=2)
