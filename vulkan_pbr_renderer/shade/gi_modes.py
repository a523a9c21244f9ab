"""GI dispatch — one named function per GI mode (lighting_pass.glsl:683-702).

The lighting pass's GI block grew to ~450 lines of nested closures across
round 2-4 (4 modes x interleave variants); this module splits it into named
per-mode resolvers sharing one explicit context:

  * fast_march_gi  — the shipped default: reference-structured fog march
    (gi.sample_radiance_fog) + the faithful bounded linear screen trace
    (gi.screen_trace_linear) or probe/hiz screen terms
  * fast_probe_gi  — the round-2 irradiance-cache economy path
    (gi.sample_radiance_fast + screen probes)
  * reference_gi   — the bit-exact parity port of
    SampleRadianceWithScreenSpaceTrace (gi.sample_radiance_with_screen_trace)

Each returns (ambient, spec, new_gi_cache|None) at the gi_res_divisor grid;
lighting_pass applies the split-sum weights and upsampling.  The temporal
interleave (config.gi_temporal_div) is a lane split/merge pair built by
interleave_ops() and threaded identically through every mode.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp

from ..gpu import sampling
from ..utils import color as colorlib
from ..utils import math3d as m3
from . import gi


def gi_temporal_active(cfg):
    """True when the temporal GI interleave (cfg.gi_temporal_div) can run:
    fast march mode (or reference mode with the gi_temporal_reference
    opt-in), matching diffuse/specular GI resolution, and an even number of
    half-res columns to split.  app.renderer.init_frame_state sizes
    FrameState.gi_cache by this, and render_frame plumbs the cache through
    lighting_pass when it holds."""
    kg = cfg.gi_res_divisor
    mode_ok = ((cfg.gi_mode == "fast" and cfg.gi_fast_march)
               or (cfg.gi_mode == "reference" and cfg.gi_temporal_reference))
    return (cfg.gi_temporal_div >= 2 and cfg.enable_gi and mode_ok
            and (cfg.gi_res_divisor_diffuse or kg) == kg
            and cfg.height % kg == 0 and cfg.width % kg == 0
            and (cfg.width // kg) % 2 == 0
            and (cfg.gi_temporal_pattern != "checker"
                 or (cfg.height // kg) % 2 == 0))


def bent_normal_cosine(n, noise_1, noise_3):
    """Random cosine-hemisphere direction about N (lighting_pass.glsl:551-585)."""
    some_vector = m3.normalize(jnp.array([0.7128864983, 0.8217892113, 0.948912748]))
    tangent = m3.normalize(jnp.cross(jnp.broadcast_to(some_vector, n.shape), n))
    bitangent = jnp.cross(n, tangent)
    pitch = jnp.arccos(jnp.sqrt(jnp.clip(1.0 - noise_1, 0.0, 1.0)))
    yaw = 2.0 * jnp.pi * noise_3
    sp = jnp.sin(pitch)
    local = jnp.stack([sp * jnp.cos(yaw), sp * jnp.sin(yaw), jnp.cos(pitch)], -1)
    return (
        tangent * local[..., 0:1] + bitangent * local[..., 1:2] + n * local[..., 2:3]
    )


def interleave_ops(cfg, frame_idx):
    """(half, merge) lane ops for the gi_temporal_div=2 interleave.

    half(x): the parity-selected half of the GI lanes.  "columns":
    x[:, par::2] (roll by a TRACED shift then stride — a static slice of a
    dynamic rotation, both lower cheaply).  "checker": even rows take parity
    `par` columns, odd rows the opposite — the stale lanes then form the
    highest-frequency spatial pattern, which the bilinear upsample + TAA
    average away.

    merge(slot, half_val): write the freshly-traced half back into the cache
    slot at its parity positions.  Refreshed lanes REPLACE their slots — the
    r4 rescue knobs (EMA merge, spatial infill, spec-only scope) all measured
    neutral-to-harmful (eval_ssim: ema 0.9486 vs replace 0.967; SSIM here
    rewards noise-pattern correlation) and were removed."""
    par = (frame_idx % 2).astype(jnp.int32)
    checker = cfg.gi_temporal_pattern == "checker"

    def _rows(x):
        # split into (even-row, odd-row) planes [Hg/2, Wg, ...]
        return x[0::2], x[1::2]

    def _cols(x, p):
        return jnp.roll(x, -p, axis=1)[:, ::2]

    def half(x):
        if not checker:
            return _cols(x, par)
        ev, od = _rows(x)
        ev, od = _cols(ev, par), _cols(od, 1 - par)
        return jnp.stack([ev, od], 1).reshape(
            x.shape[0], x.shape[1] // 2, *x.shape[2:])

    def _set_cols(slot, half_val, p):
        cr = jnp.roll(slot, -p, axis=1)
        cr = cr.at[:, ::2].set(half_val)
        return jnp.roll(cr, p, axis=1)

    def merge(slot, half_val):
        if not checker:
            return _set_cols(slot, half_val, par)
        sev, sod = _rows(slot)
        hev, hod = _rows(half_val)
        sev = _set_cols(sev, hev, par)
        sod = _set_cols(sod, hod, 1 - par)
        return jnp.stack([sev, sod], 1).reshape(slot.shape)

    return half, merge


def _specular_ray(ctx):
    """Noise-roughened reflection direction, biased toward N at high
    roughness (lighting_pass.glsl:691-697)."""
    nd, roughd = ctx.nd, ctx.roughd
    r = m3.reflect(-ctx.vd, nd)
    r = m3.normalize(
        r + 0.6 * roughd[..., None]
        * (jnp.stack([ctx.n1d, ctx.n2d, ctx.n3d], -1) - 0.5)
    )
    r2 = roughd * roughd
    return r + (nd - r) * (r2 * r2)[..., None]   # bias toward N (glsl:697)


def _min_depth(trace_depth, kdp):
    """min-of-kxk reduced depth: a dense reduce-window, no gather; min is
    CONSERVATIVE for the probes' "behind visible geometry" test
    (never fakes a hit a full-res ray would miss — it can only move the
    surface nearer)."""
    if kdp == 1:
        return trace_depth
    th_, tw_ = trace_depth.shape
    if th_ % kdp == 0 and tw_ % kdp == 0:
        return jax.lax.reduce_window(
            trace_depth, jnp.float32(jnp.inf), jax.lax.min,
            (kdp, kdp), (kdp, kdp), "valid",
        )
    return trace_depth[::kdp, ::kdp]


def _probe_prev_setup(ctx):
    """Window-packed prev-frame level(s) + the probe closure for the
    probe/hiz screen modes (NOT the trace mode, which samples the mip atlas
    directly at the resolve)."""
    cfg, res, glob = ctx.cfg, ctx.res, ctx.glob
    dist_mip = cfg.gi_fast_probe_dist_mip
    if dist_mip > 0.0:
        # window pack of the WHOLE prev pyramid atlas: march probes resolve
        # at a distance-scaled level (the reference's
        # textureLod(PREV_FRAME_RESULT, uv, min(step*5, 5)), glsl:377 —
        # far resolves are a soft wide average)
        plh, plw = ctx.fh // 2, ctx.w // 2
        wprev = sampling.window_pack(
            res.prev_frame_atlas.astype(jnp.float32), 2, 2,
            dtype=jnp.float16,
        )
    else:
        # reduced-res prev-frame level for the screen probe: one bilinear
        # window row per probe (gi.screen_probe rationale); level 0 = half
        # res (sharper reflections), 1 = quarter res
        lv = cfg.gi_fast_probe_level
        offs, _ = sampling.mip_offsets(ctx.fh // 2, ctx.w // 2,
                                       cfg.bloom_pass_count)
        plh, plw = ctx.fh // (2 << lv), ctx.w // (2 << lv)
        prev_lvl = res.prev_frame_atlas[:plh, offs[lv]:offs[lv] + plw]
        wprev = sampling.window_pack(prev_lvl, 2, 2, dtype=jnp.float16)
    probe_mip_kw = (
        dict(prev_levels=cfg.bloom_pass_count, dist_mip=dist_mip)
        if dist_mip > 0.0 else {}
    )

    def probe(ro_open, ss_intensity, ro0=None):
        if cfg.gi_fast_probe_points > 1 and ro0 is not None:
            return gi.screen_probe_multi(
                ro0, ro_open, cfg.lightgrid_scale,
                glob.clip_from_world, ctx.trace_depth, wprev, (plh, plw),
                ss_intensity, z_margin=cfg.gi_fast_probe_margin,
                k_points=cfg.gi_fast_probe_points, **probe_mip_kw,
            )
        return gi.screen_probe(
            ro_open, cfg.lightgrid_scale, glob.clip_from_world,
            ctx.trace_depth, wprev, (plh, plw), ss_intensity,
            z_margin=cfg.gi_fast_probe_margin,
        )

    return wprev, (plh, plw), probe_mip_kw, probe


# ---------------------------------------------------------------------------
# Mode resolvers: each returns (ambient, spec, new_gi_cache | None)


def fast_march_gi(ctx):
    """March-structured fast GI (the shipped default): the reference's fog
    march run on the f16 nearest grid (gi.sample_radiance_fog) with the
    faithful bounded linear screen trace / probes / hiz as the screen term."""
    cfg, glob, res = ctx.cfg, ctx.glob, ctx.res
    kg = cfg.gi_res_divisor
    depth_half = _min_depth(ctx.trace_depth, cfg.gi_fast_probe_depth_div)
    use_probe_screen = (cfg.gi_fast_screen_probe
                        and cfg.gi_fast_screen_mode != "trace")
    if use_probe_screen:
        wprev, plhw, probe_mip_kw, _probe = _probe_prev_setup(ctx)
    if cfg.gi_fast_screen_probe and cfg.gi_fast_screen_mode == "trace":
        kdt = cfg.gi_trace_depth_div
        if kdt > 1 and cfg.gi_trace_depth_mode == "plain":
            # unbiased position quantization (vs min's one-texel silhouette
            # dilation -> false resolves); the strided slice is one gather
            # per frame, repaid by the smaller table every trace step reads
            # (config.gi_trace_depth_mode)
            trace_tbl = ctx.trace_depth[::kdt, ::kdt]
        else:
            trace_tbl = _min_depth(ctx.trace_depth, kdt)
    if cfg.gi_fast_screen_probe and cfg.gi_fast_screen_mode == "hiz":
        # one min-depth pyramid shared by the diffuse + specular traces
        # (and, sharded, identical on every shard — built from the gathered
        # full depth, so parity is trivially exact)
        hiz, hiz_offs = gi.build_hiz_atlas(depth_half, cfg.gi_hiz_levels)
    fgrid = gi.pack_grid_f16_nearest(res.lightgrid) if cfg.gi_fast_fog_march \
        else None
    voxel_step = 2.0 / cfg.lightgrid_size

    def march_resolve(pw, rd_unit, hit_steps, step_scale,
                      ss_intensity, noise, foggyness=0.5, pv=None):
        if cfg.gi_fast_fog_march:
            rgb, ro_open, ro_stop, hitm, _ = gi.sample_radiance_fog(
                fgrid, pw, rd_unit, cfg.lightgrid_scale,
                skip_steps=cfg.gi_fast_skip_steps,
                open_thresh=cfg.gi_fast_open_thresh,
                march_steps=hit_steps, step_scale=step_scale,
                noise=noise, foggyness=foggyness,
                trilinear_grid=(ctx.wgrid if cfg.gi_fast_fog_trilinear
                                else None),
                jitter_scale=cfg.gi_fast_jitter_scale,
                unroll=cfg.gi_fog_unroll,
            )
        else:
            rgb, ro_open, ro_stop, hitm, _ = gi.sample_radiance_march(
                ctx.wgrid, ctx.walpha, pw, rd_unit, cfg.lightgrid_scale,
                skip_steps=cfg.gi_fast_skip_steps,
                open_thresh=cfg.gi_fast_open_thresh,
                hit_steps=hit_steps, step_scale=step_scale,
                noise=noise, rgb_samples=cfg.gi_fast_samples,
            )
        if cfg.gi_fast_screen_probe and cfg.gi_fast_screen_mode == "trace":
            # faithful bounded port of the reference's linear screen trace
            # (gi.screen_trace_linear) — same tables as the parity path:
            # nearest full-res depth, u16 alpha solidity, prev-frame mip
            # atlas with the textureLod distance mip (glsl:301-397)
            open_vs = m3.transform_points(
                glob.view_from_world, ro_open / cfg.lightgrid_scale
            )[..., :3]
            v_cam = m3.normalize(glob.camera_pos - pw)
            fb_pos = pw * cfg.lightgrid_scale + 2.5 * v_cam * voxel_step
            fb = gi.grid_sample(ctx.wgrid, fb_pos)
            fb_rgb = colorlib.tone_compress_sqrt(fb[..., :3])
            trace_kw = dict(
                steps=cfg.gi_trace_steps,
                rounds=cfg.gi_trace_rounds,
                steps2=cfg.gi_trace_steps2,
                solid_taps=cfg.gi_trace_solid_taps,
                unroll=cfg.gi_trace_unroll,
            )
            if cfg.gi_trace_impl == "v1":
                status, res_uv, res_slen = gi.screen_trace_linear_v1(
                    trace_tbl, ctx.walpha, pv, open_vs, fb_rgb,
                    glob.clip_from_view, glob.view_from_clip,
                    glob.world_from_view, cfg.lightgrid_scale, noise,
                    **trace_kw,
                )
            else:
                status, res_uv, res_slen = gi.screen_trace_linear(
                    trace_tbl, ctx.walpha, pv, open_vs,
                    glob.clip_from_view,
                    glob.world_from_view, cfg.lightgrid_scale, noise,
                    **trace_kw,
                )
            lod = jnp.minimum(res_slen * 5.0, 5.0)
            prev = sampling.sample_mip_atlas(
                res.prev_frame_atlas, ctx.fh // 2, ctx.w // 2, res_uv, lod,
                levels=cfg.bloom_pass_count,
            )[..., :3]
            rgb = jnp.where((status == 1)[..., None], fb_rgb, rgb)
            rgb = jnp.where((status == 3)[..., None],
                            prev * ss_intensity, rgb)
        elif cfg.gi_fast_screen_probe:
            if cfg.gi_fast_probe_to_stop:
                # probe the full [surface, march stop] segment — for
                # specular rays the interesting on-screen target (the
                # reflected wall/lamp) is usually PAST first-open
                ro_open = ro_stop
            if cfg.gi_fast_screen_mode == "hiz":
                res_m, ss_rgb = gi.screen_trace_hiz(
                    pw * cfg.lightgrid_scale, ro_open,
                    cfg.lightgrid_scale, glob.clip_from_world,
                    hiz, hiz_offs, depth_half.shape, wprev,
                    plhw, ss_intensity, alpha_grid=ctx.walpha,
                    iters=cfg.gi_hiz_iters,
                    thickness=cfg.gi_hiz_thickness,
                    z_bias=cfg.gi_hiz_bias,
                    solid_thresh=cfg.gi_hiz_solid,
                    zview_nf=(cfg.z_near, cfg.z_far),
                )
            else:
                ro_probe_end = ro_open
                if cfg.gi_fast_probe_overshoot > 0.0:
                    # the reference trace travels |to_open| in units of a
                    # step normalized by |to_open.xy| (glsl:302, 308): its
                    # 3D range is |to_open|/|to_open.xy| x the open distance
                    # — view-aligned rays sweep far past first-open and
                    # resolve distant geometry
                    seg_g = ro_open - pw * cfg.lightgrid_scale
                    dvs = m3.transform_dirs(glob.view_from_world, seg_g)
                    ov = jnp.linalg.norm(dvs, axis=-1) / jnp.maximum(
                        jnp.linalg.norm(dvs[..., :2], axis=-1), 1e-6)
                    ov = jnp.minimum(ov, cfg.gi_fast_probe_overshoot)
                    ro_probe_end = (pw * cfg.lightgrid_scale
                                    + seg_g * ov[..., None])
                res_m, ss_rgb, off_m = gi.screen_probe_multi(
                    pw * cfg.lightgrid_scale, ro_probe_end,
                    cfg.lightgrid_scale, glob.clip_from_world,
                    (ctx.trace_depth if cfg.gi_fast_probe_fullres_depth
                     else depth_half),
                    wprev, plhw, ss_intensity,
                    z_margin=cfg.gi_fast_probe_margin,
                    k_points=cfg.gi_fast_probe_points,
                    want_offscreen=True,
                    spacing_gamma=cfg.gi_fast_probe_gamma,
                    spacing_growth=cfg.gi_fast_probe_growth,
                    point_jitter=cfg.gi_fast_probe_jitter,
                    solid_taps=cfg.gi_fast_probe_solid_taps,
                    alpha_grid=ctx.walpha,
                    world_from_clip=glob.world_from_clip,
                    noise=noise, **probe_mip_kw,
                )
                if cfg.gi_fast_edge_fallback:
                    # trace left the screen before any hit: the reference
                    # samples the lightgrid 2.5 voxels toward the camera,
                    # tone-compressed, and stops (glsl:324-331) — without
                    # this the screen-edge pixels keep the fog result the
                    # reference never computes there
                    v_cam = m3.normalize(glob.camera_pos - pw)
                    fb_pos = (pw * cfg.lightgrid_scale
                              + v_cam * (2.5 * 2.0 / cfg.lightgrid_size))
                    fb = gi.grid_sample(ctx.wgrid, fb_pos)[..., :3]
                    fb = colorlib.tone_compress_sqrt(fb)
                    rgb = jnp.where(off_m[..., None], fb, rgb)
            rgb = jnp.where(res_m[..., None], ss_rgb, rgb)
        return rgb

    # diffuse ray — optionally at its own coarser grid (gi_res_divisor_diffuse)
    kdif = cfg.gi_res_divisor_diffuse or kg
    if kdif != kg:
        nd_d, _, pwd_d, pvd_d, (n1dd, _, n3dd) = ctx.sub_inputs(kdif,
                                                                ctx.f59_gi)
        bent_d = bent_normal_cosine(nd_d, n1dd, n3dd)
    else:
        pwd_d, pvd_d, bent_d, n3dd = ctx.pwd, ctx.pvd, ctx.bent, ctx.n3d
    if ctx.half is not None:
        amb_h = march_resolve(
            ctx.half(pwd_d), ctx.half(bent_d), cfg.gi_fast_hit_steps,
            cfg.gi_fast_hit_step_scale, cfg.gi_diffuse_ss_intensity,
            ctx.half(n3dd), foggyness=cfg.gi_diffuse_foggyness,
            pv=ctx.half(pvd_d),
        )
        ambient = ctx.merge(ctx.gi_cache[0], amb_h)
    else:
        ambient = march_resolve(
            pwd_d, bent_d, cfg.gi_fast_hit_steps,
            cfg.gi_fast_hit_step_scale, cfg.gi_diffuse_ss_intensity,
            n3dd, foggyness=cfg.gi_diffuse_foggyness, pv=pvd_d,
        )

    r = _specular_ray(ctx)
    spec_fog = (ctx.roughd if cfg.gi_specular_foggyness_is_roughness
                else 0.9)
    if ctx.half is not None:
        spec_h = march_resolve(
            ctx.half(ctx.pwd), ctx.half(r), cfg.gi_fast_hit_steps_spec,
            cfg.gi_fast_hit_step_scale_spec,
            cfg.gi_specular_ss_intensity, ctx.half(ctx.n3d),
            foggyness=(ctx.half(spec_fog) if jnp.ndim(spec_fog)
                       else spec_fog),
            pv=ctx.half(ctx.pvd),
        )
        spec = ctx.merge(ctx.gi_cache[1], spec_h)
        return ambient, spec, jnp.stack([ambient, spec])
    spec = march_resolve(
        ctx.pwd, r, cfg.gi_fast_hit_steps_spec,
        cfg.gi_fast_hit_step_scale_spec,
        cfg.gi_specular_ss_intensity,
        ctx.n3d, foggyness=spec_fog, pv=ctx.pvd,
    )
    return ambient, spec, None


def fast_probe_gi(ctx):
    """The round-2 irradiance-cache economy path: open-segment quadrature
    of the swept grid (gi.sample_radiance_fast) + screen probes.  Kept as
    the cheap non-march fallback (no interleave support — renderer only
    activates the cache for march/reference modes, gi_temporal_active)."""
    cfg = ctx.cfg
    fast_kw = dict(
        skip_steps=cfg.gi_fast_skip_steps,
        open_thresh=cfg.gi_fast_open_thresh,
        n_samples=cfg.gi_fast_samples,
        sample_spread=cfg.gi_fast_sample_spread,
        alpha_grid=ctx.walpha,
    )
    probe = None
    if cfg.gi_fast_screen_probe and cfg.gi_fast_screen_mode != "trace":
        _, _, _, probe = _probe_prev_setup(ctx)
    voxel_step = 2.0 / cfg.lightgrid_size
    ro0_grid = ctx.pwd * cfg.lightgrid_scale

    ambient, ro_open = gi.sample_radiance_fast(
        ctx.wgrid, ctx.pwd, ctx.bent, cfg.lightgrid_scale, **fast_kw
    )
    if probe is not None:
        if cfg.gi_fast_diffuse_hit_steps > 0:
            ro_p, hit_m = gi.march_to_hit(
                ctx.walpha, ro_open,
                ctx.bent * (voxel_step * cfg.gi_diffuse_step_scale),
                cfg.gi_fast_diffuse_hit_steps,
            )
        else:
            ro_p, hit_m = ro_open, True
        hit, ss_rgb = probe(ro_p, cfg.gi_diffuse_ss_intensity, ro0=ro0_grid)
        hit = hit & hit_m
        ambient = jnp.where(hit[..., None], ss_rgb, ambient)

    r = _specular_ray(ctx)
    spec, ro_open_s = gi.sample_radiance_fast(
        ctx.wgrid, ctx.pwd, r, cfg.lightgrid_scale, dist_voxels=4.0, **fast_kw
    )
    if probe is not None:
        if cfg.gi_fast_spec_hit_steps > 0:
            ro_ps, hit_ms = gi.march_to_hit(
                ctx.walpha, ro_open_s,
                r * (voxel_step * cfg.gi_specular_step_scale),
                cfg.gi_fast_spec_hit_steps,
            )
        else:
            ro_ps, hit_ms = ro_open_s, True
        hit_s, ss_rgb_s = probe(ro_ps, cfg.gi_specular_ss_intensity,
                                ro0=ro0_grid)
        hit_s = hit_s & hit_ms
        spec = jnp.where(hit_s[..., None], ss_rgb_s, spec)
    return ambient, spec, None


def reference_gi(ctx):
    """Bit-exact parity port of the reference's full hybrid march
    (gi.sample_radiance_with_screen_trace, lighting_pass.glsl:273-424) —
    the SSIM yardstick.  The interleave leg is the gi_temporal_reference
    opt-in; bench/eval reference legs keep div=1 so the yardstick stays
    exact."""
    cfg, glob, res = ctx.cfg, ctx.glob, ctx.res

    # REFERENCE_PRODUCT lever (config.gi_reference_depth_div): the parity
    # trace against a plain-subsampled depth table — the r4 fast-path
    # finding (the full-res f32 table gathers ~3x slower) applied to the
    # reference march.  Default 1 keeps the yardstick bit-exact.
    kdr = cfg.gi_reference_depth_div
    ref_depth = ctx.trace_depth[::kdr, ::kdr] if kdr > 1 else ctx.trace_depth

    def ref_resolve(pw_, pv_, vd_, dir_, n3_, steps, step_scale,
                    fog, intensity):
        return gi.sample_radiance_with_screen_trace(
            ctx.wgrid, ref_depth, res.prev_frame_atlas,
            glob.view_from_world, glob.clip_from_view,
            glob.view_from_clip, glob.world_from_view,
            vd_,
            jnp.concatenate([pv_, jnp.ones_like(pv_[..., :1])], -1),
            pw_, dir_, cfg.lightgrid_scale, steps, step_scale, n3_,
            fog, intensity,
            max_ss_steps=cfg.gi_screen_trace_steps,
            prev_base=(ctx.fh // 2, ctx.w // 2),
            prev_levels=cfg.bloom_pass_count,
            alpha_grid=ctx.walpha,
        )

    if ctx.half is not None:
        amb_h = ref_resolve(
            ctx.half(ctx.pwd), ctx.half(ctx.pvd), ctx.half(ctx.vd),
            ctx.half(ctx.bent), ctx.half(ctx.n3d), cfg.gi_diffuse_steps,
            cfg.gi_diffuse_step_scale, cfg.gi_diffuse_foggyness,
            cfg.gi_diffuse_ss_intensity)
        ambient = ctx.merge(ctx.gi_cache[0], amb_h)
    else:
        ambient = ref_resolve(
            ctx.pwd, ctx.pvd, ctx.vd, ctx.bent, ctx.n3d,
            cfg.gi_diffuse_steps, cfg.gi_diffuse_step_scale,
            cfg.gi_diffuse_foggyness, cfg.gi_diffuse_ss_intensity)

    r = _specular_ray(ctx)
    spec_fog = (ctx.roughd if cfg.gi_specular_foggyness_is_roughness
                else 0.9)
    if ctx.half is not None:
        spec_h = ref_resolve(
            ctx.half(ctx.pwd), ctx.half(ctx.pvd), ctx.half(ctx.vd),
            ctx.half(r), ctx.half(ctx.n3d), cfg.gi_specular_steps,
            cfg.gi_specular_step_scale,
            ctx.half(spec_fog) if jnp.ndim(spec_fog) else spec_fog,
            cfg.gi_specular_ss_intensity)
        spec = ctx.merge(ctx.gi_cache[1], spec_h)
        return ambient, spec, jnp.stack([ambient, spec])
    spec = ref_resolve(
        ctx.pwd, ctx.pvd, ctx.vd, r, ctx.n3d, cfg.gi_specular_steps,
        cfg.gi_specular_step_scale, spec_fog, cfg.gi_specular_ss_intensity)
    return ambient, spec, None


def gi_pass(cfg, glob, res, sub_inputs, trace_depth, fh, w, f59,
            gi_cache=None, frame_idx=None):
    """Dispatch to the configured GI mode.  Returns (ambient, spec,
    new_gi_cache | None) at the gi_res_divisor grid; the caller applies the
    split-sum weights and bilinear upsampling (lighting_pass.glsl:683-702)."""
    kg = cfg.gi_res_divisor
    # u8 tone-compressed pack: 32-byte rows from a 67 MB table
    # (gi.pack_grid_u8 rationale); the blockage skips read the 16-byte
    # alpha-only u16 pack instead
    wgrid = gi.pack_grid_u8(res.lightgrid)
    walpha = gi.pack_grid_alpha_u16(res.lightgrid)
    # interleave noise schedule (config.gi_temporal_noise): "cycle" advances
    # the GI noise once per 2-frame refresh cycle (frame_idx|1 — the cycle
    # completes at odd frames carrying THAT frame's noise instance), so the
    # cache never holds two decorrelated instances
    f59_gi = None
    if gi_cache is not None and cfg.gi_temporal_noise == "cycle":
        f59_gi = (((frame_idx | 1) + cfg.gi_noise_offset) % 59).astype(
            jnp.float32)
    elif cfg.gi_noise_offset:
        # measurement control (config.gi_noise_offset): decorrelate the GI
        # dither from a matched run while everything else stays byte-
        # identical — the SSIM noise-floor experiment
        f59_gi = jnp.mod(f59 + jnp.float32(cfg.gi_noise_offset), 59.0)
    nd, roughd, pwd, pvd, (n1d, n2d, n3d) = sub_inputs(kg, f59_gi)
    if gi_cache is not None:
        assert gi_temporal_active(cfg)
        half, merge = interleave_ops(cfg, frame_idx)
    else:
        half = merge = None
    ctx = SimpleNamespace(
        cfg=cfg, glob=glob, res=res, sub_inputs=sub_inputs,
        trace_depth=trace_depth, fh=fh, w=w, f59_gi=f59_gi,
        wgrid=wgrid, walpha=walpha,
        nd=nd, roughd=roughd, pwd=pwd, pvd=pvd,
        n1d=n1d, n2d=n2d, n3d=n3d,
        vd=m3.normalize(glob.camera_pos - pwd),
        bent=bent_normal_cosine(nd, n1d, n3d),
        gi_cache=gi_cache, half=half, merge=merge,
    )
    if cfg.gi_mode == "fast" and cfg.gi_fast_march:
        return fast_march_gi(ctx)
    if cfg.gi_mode == "fast":
        return fast_probe_gi(ctx)
    return reference_gi(ctx)
