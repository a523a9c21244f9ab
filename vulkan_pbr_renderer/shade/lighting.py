"""The deferred lighting pass — port of lighting_pass.glsl:432-716.

Per pixel: reconstruct positions from depth, cosine-hemisphere bent normal,
4-tap PCF sun shadow, volumetric light shafts, Cook-Torrance sun lighting,
hybrid-traced diffuse + specular GI weighted by the split-sum BRDF LUT,
emissive, and the sky fallback.  Everything is dense [H,W,...] tensor math —
the replacement for the reference's 16-resource fullscreen fragment pass
(render.cpp:1117-1127).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..gpu import sampling
from ..utils import color as colorlib
from ..utils import math3d as m3
from ..utils import noise as noiselib
from . import brdf, gi, shadow
from .gi_modes import bent_normal_cosine, gi_pass, gi_temporal_active  # noqa: F401 (re-exported for app.renderer)


class Globals(NamedTuple):
    """Per-frame uniforms — mirrors RendererGlobalsBuffer (render.h:122-136)."""

    clip_from_world: jnp.ndarray
    clip_from_view: jnp.ndarray
    world_from_clip: jnp.ndarray
    view_from_clip: jnp.ndarray
    view_from_world: jnp.ndarray
    world_from_view: jnp.ndarray
    sun_from_world: jnp.ndarray
    old_clip_from_world: jnp.ndarray
    sun_direction: jnp.ndarray     # [3]
    camera_pos: jnp.ndarray        # [3]
    frame_idx_mod_59: jnp.ndarray  # scalar f32
    taa_jitter: jnp.ndarray        # [2] ndc
    taa_jitter_prev: jnp.ndarray   # [2]


class LightingResources(NamedTuple):
    """Textures read by the lighting pass (render.cpp:829-871 bindings)."""

    sun_depth: jnp.ndarray            # [S,S]
    lightgrid: jnp.ndarray            # [D,D,D,4]
    prefiltered_env: jnp.ndarray      # [6,S,Wa,6] i32 bitcast view of the
                                      # WINDOW-packed f16 cube mip atlas
                                      # (pack_cube_mip_atlas_window):
                                      # static-level samples = 1 gather
                                      # row, dynamic-LOD = 2
    brdf_lut: jnp.ndarray             # [L,L,2]
    prev_frame_atlas: jnp.ndarray     # [H/2,Wa,3] prev frame's bloom downscale
                                      # pyramid (render.cpp:862 binds it as
                                      # PREV_FRAME_RESULT in the lighting pass)


def reconstruct_positions(depth, world_from_clip, view_from_clip,
                          row_offset=0, full_height=None, stride=1):
    """depth [H,W] -> (p_world [H,W,3], p_view [H,W,3]) via inverse projection
    (lighting_pass.glsl:444-451).  For row-sharded frames, depth holds rows
    [row_offset, row_offset+H) of a full_height-tall framebuffer.  For
    stride>1, depth holds the [::stride,::stride] subsample of a
    (full_height, W*stride) framebuffer and positions are reconstructed at the
    subsampled pixels' original centers (exactly p_world[::stride,::stride])."""
    h, w = depth.shape
    fh = full_height or h * stride
    fw = w * stride
    u = (jnp.arange(w, dtype=jnp.float32)[None, :] * stride + 0.5) / fw
    v = (jnp.arange(h, dtype=jnp.float32)[:, None] * stride + row_offset + 0.5) / fh
    ndc = jnp.stack(
        [
            jnp.broadcast_to(u * 2.0 - 1.0, (h, w)),
            jnp.broadcast_to(v * 2.0 - 1.0, (h, w)),
            depth,
        ],
        -1,
    )
    pw = m3.transform_points(world_from_clip, ndc)
    p_world = pw[..., :3] / pw[..., 3:4]
    pv = m3.transform_points(view_from_clip, ndc)
    p_view = pv[..., :3] / pv[..., 3:4]
    return p_world, p_view


def _down(x, k):
    """Subsample [H,W,...] by k (top-left of each k x k block)."""
    return x if k == 1 else x[::k, ::k]


def _up(x, h, w):
    """Bilinear upsample [h/k,w/k,...] back to [h,w,...] — dense 2x phase
    interleaves (jax.image.resize lowers to gathers); repeated for
    power-of-two divisors."""
    from .bloom import _up2

    while x.shape[0] * 2 <= h and x.shape[1] * 2 <= w:
        x = _up2(x if x.ndim == 3 else x[..., None])
    x = x if x.ndim == 3 else x[..., None]
    if x.shape[:2] != (h, w):
        x = jax.image.resize(x, (h, w) + x.shape[2:], method="linear")
    return x


def lighting_pass(
    g,                      # GBuffer
    glob: Globals,
    res: LightingResources,
    cfg: RenderConfig,
    row_offset=0,
    full_height=None,
    depth_full=None,
    gi_cache=None,
    frame_idx=None,
):
    """Returns the HDR lighting result [H,W,3] — or (hdr, new_gi_cache) when
    gi_cache is passed (the cfg.gi_temporal_div interleave; single-chip only).

    For the row-sharded multi-chip path, pass row_offset/full_height and a
    gathered full-screen depth (depth_full) so the GI screen-space trace can
    march outside the shard's rows.

    Temporal interleave (gi_cache is not None, requires gi_temporal_active):
    the two gather-bound march_resolve calls (ambient + specular — together
    the largest block of the frame) run on alternating half-res COLUMNS
    (parity = frame_idx % 2) and merge into the persistent [2,Hg,Wg,3] cache;
    shading consumes the cache, so the untouched half is one frame stale —
    statically it converges in 2 frames, in motion TAA integrates it exactly
    like the march's own per-frame noise dither."""
    h, w = g.depth.shape
    fh = full_height or h
    base_color = g.base_color
    n = g.normal
    roughness = g.orm[..., 1]
    metallic = g.orm[..., 2]
    emissive = g.emissive * cfg.emissive_scale

    p_world, p_view = reconstruct_positions(
        g.depth, glob.world_from_clip, glob.view_from_clip, row_offset, fh
    )

    px = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w)) + 0.5
    py = jnp.broadcast_to(
        jnp.arange(h, dtype=jnp.float32)[:, None] + row_offset, (h, w)
    ) + 0.5
    f59 = glob.frame_idx_mod_59
    noise_1 = noiselib.frame_noise(px, py, f59)
    noise_2 = noiselib.frame_noise(px, py, f59, offset=(90.0, 20.0))
    noise_3 = noiselib.frame_noise(px, py, f59, offset=(522.0, 55.0))

    sun_emission = cfg.sun_emission_scale * jnp.asarray(cfg.sun_color, jnp.float32)

    v = m3.normalize(glob.camera_pos - p_world)
    v_dot_n = jnp.maximum(m3.dot(v, n), 0.0)

    outgoing = jnp.zeros((h, w, 3), jnp.float32)

    # Subsampled inputs for the reduced-res GI / shaft passes.  The naive
    # [::k,::k] strided slices each lowered to an XLA gather (6 of them);
    # instead everything analytic is
    # recomputed at the subsampled pixel coords (noise, positions from depth,
    # v from position) and the rest (depth, normal, roughness) rides ONE
    # packed 5-channel gather.
    need_sub = (cfg.enable_gi and cfg.gi_res_divisor > 1) or (
        cfg.enable_light_shafts and cfg.enable_shadows
        and cfg.shaft_res_divisor > 1
    )
    packed_gnr = (
        jnp.concatenate([g.depth[..., None], n, roughness[..., None]], -1)
        if need_sub else None
    )

    def sub_inputs(k, f59_=None):
        """(n, roughness, p_world, p_view, noise_1/2/3) at the [::k,::k] grid,
        exactly equal to subsampling the full-res arrays.  f59_ overrides the
        noise frame index (the GI block's cfg.gi_temporal_noise="cycle"
        schedule); None = the frame's own f59."""
        if f59_ is None:
            f59_ = f59
        if k == 1:
            if f59_ is f59:
                return n, roughness, p_world, p_view, (noise_1, noise_2, noise_3)
            return n, roughness, p_world, p_view, (
                noiselib.frame_noise(px, py, f59_),
                noiselib.frame_noise(px, py, f59_, offset=(90.0, 20.0)),
                noiselib.frame_noise(px, py, f59_, offset=(522.0, 55.0)),
            )
        sub = _down(packed_gnr, k)
        depth_d = sub[..., 0]
        nd = sub[..., 1:4]
        roughd = sub[..., 4]
        pwd, pvd = reconstruct_positions(
            depth_d, glob.world_from_clip, glob.view_from_clip,
            row_offset, fh, stride=k,
        )
        hd, wd = depth_d.shape
        pxd = (jnp.arange(wd, dtype=jnp.float32)[None, :] * k + 0.5)
        pyd = (jnp.arange(hd, dtype=jnp.float32)[:, None] * k
               + row_offset + 0.5)
        pxd = jnp.broadcast_to(pxd, (hd, wd))
        pyd = jnp.broadcast_to(pyd, (hd, wd))
        noises = (
            noiselib.frame_noise(pxd, pyd, f59_),
            noiselib.frame_noise(pxd, pyd, f59_, offset=(90.0, 20.0)),
            noiselib.frame_noise(pxd, pyd, f59_, offset=(522.0, 55.0)),
        )
        return nd, roughd, pwd, pvd, noises

    # --- sun shadow + direct light (glsl:592-679) -------------------------
    if not cfg.enable_shadows:
        wdepth = None
        vis = jnp.ones((h, w), jnp.float32)
    else:
        if cfg.pcf_mode == "split4x4":
            wdepth_pcf = sampling.pack_depth_window_u16_4x4_split(res.sun_depth)
        else:
            wdepth_pcf = sampling.pack_depth_window_u16(res.sun_depth)
        # the march-mode shaft sampler needs the single-table 2x2 pack
        wdepth = (wdepth_pcf if not isinstance(wdepth_pcf, tuple)
                  else sampling.pack_depth_window_u16(res.sun_depth)
                  if cfg.light_shaft_mode == "march" else None)
        vis = shadow.sun_visibility(
            res.sun_depth, glob.sun_from_world, p_world, n, noise_1, noise_2,
            cfg.shadow_normal_offset, wdepth=wdepth_pcf,
        )

    l = -glob.sun_direction
    direct = brdf.cook_torrance_direct(
        n, v, jnp.broadcast_to(l, n.shape), base_color, roughness, metallic,
        cfg.f0_dielectric,
    )
    outgoing = outgoing + vis[..., None] * direct * sun_emission

    # --- volumetric light shafts (glsl:620-651) ---------------------------
    if cfg.enable_light_shafts and cfg.enable_shadows:
        ks_ = cfg.shaft_res_divisor
        n_s, _, pw_s, _, noises_s = sub_inputs(ks_)
        if cfg.light_shaft_mode == "polar":
            shafts = shadow.light_shafts_polar(
                res.sun_depth, glob.sun_from_world, glob.camera_pos,
                pw_s, n_s, noises_s[0],
                sun_emission, cfg.light_shaft_intensity,
                cfg.shadow_normal_offset,
                max_steps=cfg.light_shaft_steps * 3,
                n_theta=cfg.shaft_polar_thetas,
                n_r=cfg.light_shaft_steps * 3,
            )
        else:
            shafts = shadow.light_shafts(
                res.sun_depth, glob.sun_from_world, glob.camera_pos,
                pw_s, n_s, noises_s[0],
                sun_emission, cfg.light_shaft_intensity,
                cfg.shadow_normal_offset, max_steps=cfg.light_shaft_steps * 3,
                wdepth=wdepth,
            )
        outgoing = outgoing + _up(shafts, h, w)

    # --- split-sum weights (glsl:681) -------------------------------------
    f0 = brdf.f0_from_metallic(base_color, metallic, cfg.f0_dielectric)
    lut_uv = jnp.stack([v_dot_n, jnp.maximum(roughness, 0.05)], -1)
    # f16 window rows: the LUT holds [0,1] split-sum weights; halves the
    # 2M-row full-res fetch's bytes
    wlut = sampling.window_pack(res.brdf_lut, 2, 2, dtype=jnp.float16)
    scale_bias = sampling.sample_bilinear_window(
        wlut, res.brdf_lut.shape[0], res.brdf_lut.shape[1], lut_uv, 2
    )
    fresnel_scale = scale_bias[..., 0:1]
    fresnel_bias = scale_bias[..., 1:2]

    # --- GI (glsl:683-702) ------------------------------------------------
    if cfg.enable_gi:
        # per-mode resolvers live in gi_modes (fast_march_gi / fast_probe_gi
        # / reference_gi); this pass applies the split-sum weights and the
        # bilinear upsample to their gi_res_divisor-grid results
        ambient, spec, new_gi_cache = gi_pass(
            cfg, glob, res, sub_inputs,
            depth_full if depth_full is not None else g.depth,
            fh, w, f59, gi_cache=gi_cache, frame_idx=frame_idx,
        )
        ks = brdf.fresnel_schlick(v_dot_n, f0)
        kd = (1.0 - ks) * (1.0 - metallic[..., None])
        outgoing = outgoing + kd * _up(ambient, h, w) * base_color
        outgoing = outgoing + _up(spec, h, w) * (f0 * fresnel_scale + fresnel_bias)
    elif cfg.enable_ibl:
        # static split-sum IBL path (the pre-GI pipeline, geometry_pass.glsl:322-346
        # commented reference) — used by the Cerberus config
        env_size = res.prefiltered_env.shape[1]
        irr = sampling.sample_cubemap_level_window(res.prefiltered_env, env_size, n, 4)
        ks = brdf.fresnel_schlick(v_dot_n, f0)
        kd = (1.0 - ks) * (1.0 - metallic[..., None])
        outgoing = outgoing + kd * irr * base_color
        r = m3.reflect(-v, n)
        r2 = roughness * roughness
        r = r + (n - r) * (r2 * r2)[..., None]
        spec = sampling.sample_cubemap_lod_window(res.prefiltered_env, env_size, r, roughness * 4.0)
        outgoing = outgoing + spec * (f0 * fresnel_scale + fresnel_bias)

    outgoing = outgoing + emissive

    # --- sky fallback (glsl:708-710) --------------------------------------
    # Sampled at mip 0 (the roughness-0 prefilter level == the raw env map):
    # the reference draws the skybox geometry with the full-res env texture
    # (render.cpp:1103-1115), so the sky must be crisp, not a blurred mip.
    # With sky_res_divisor=2 it is computed at HALF res from analytic
    # pixel-ray directions (no gathers for the inputs) and bilinearly
    # upsampled: at 1080p one 256^2 env texel covers ~7 screen pixels, so
    # half-res sampling loses nothing while quartering the 2M-row fetch.
    out_of_bounds = jnp.any(jnp.abs(p_world) > cfg.world_bounds, axis=-1) | ~g.coverage
    env_size = res.prefiltered_env.shape[1]
    # full-res in the row-sharded frame (fh > h): the half-res upsample would
    # edge-clamp at shard boundaries and seam — parallel/sharding.py forces
    # sky_res_divisor=1, like the GI/shaft divisors
    if cfg.sky_res_divisor == 2 and h % 2 == 0 and w % 2 == 0 and fh == h:
        hu = (jnp.arange(w // 2, dtype=jnp.float32)[None, :] * 2 + 1.0) / w
        hv = (jnp.arange(h // 2, dtype=jnp.float32)[:, None] * 2
              + row_offset + 1.0) / fh
        ndc_far = jnp.stack(
            [
                jnp.broadcast_to(hu * 2.0 - 1.0, (h // 2, w // 2)),
                jnp.broadcast_to(hv * 2.0 - 1.0, (h // 2, w // 2)),
                jnp.full((h // 2, w // 2), 0.5),
            ],
            -1,
        )
        far4 = m3.transform_points(glob.world_from_clip, ndc_far)
        ray = far4[..., :3] / far4[..., 3:4] - glob.camera_pos
        sky_h = sampling.sample_cubemap_level_window(
            res.prefiltered_env, env_size, ray, 0
        )
        sky = _up(sky_h, h, w)
    else:
        sky = sampling.sample_cubemap_level_window(
            res.prefiltered_env, env_size, -v, 0
        )
    outgoing = jnp.where(out_of_bounds[..., None], sky, outgoing)

    out = jnp.maximum(outgoing, 0.0)
    if gi_cache is not None:
        return out, new_gi_cache
    return out


def visualize_lightgrid_pass(glob: Globals, res: LightingResources, cfg, width, height):
    """Debug DDA view of the lightgrid (lighting_pass.glsl:463-491)."""
    h, w = height, width
    u = (jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5) / w * 2.0 - 1.0
    v = (jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5) / h * 2.0 - 1.0
    ndc = jnp.stack([jnp.broadcast_to(u, (h, w)), jnp.broadcast_to(v, (h, w)),
                     jnp.zeros((h, w))], -1)
    near4 = m3.transform_points(glob.world_from_clip, ndc)
    near = near4[..., :3] / near4[..., 3:4]

    px = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w)) + 0.5
    py = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w)) + 0.5
    noise_1 = noiselib.frame_noise(px, py, glob.frame_idx_mod_59)

    ro = near * cfg.lightgrid_scale
    rd = m3.normalize(near - glob.camera_pos) * (1.0 / cfg.lightgrid_size)
    ro = ro + noise_1[..., None] * rd

    def body(i, carry):
        ro_c, sum4, done = carry
        ro_n = jnp.where(done[..., None], ro_c, ro_c + rd)
        s = gi.grid_sample(res.lightgrid, ro_n)
        hit = (s[..., 3] > 0.3) & ~done
        add = 10.0 * jnp.concatenate([s[..., :3], jnp.ones_like(s[..., :1])], -1)
        sum4 = jnp.where(hit[..., None], add, sum4)
        return ro_n, sum4, done | hit

    sum0 = jnp.zeros((h, w, 4)).at[..., 3].set(1e-5)
    _, sum4, _ = jax.lax.fori_loop(0, 512, body, (ro, sum0, jnp.zeros((h, w), bool)))
    return gi._tone(sum4)
