"""Sun shadowing: shadow matrix, rotated-grid PCF, volumetric light shafts.

Covers the reference's sun pipeline: the ortho sun matrix construction
(render.cpp:959-971), the 4-tap rotated-grid PCF with normal-offset bias
(lighting_pass.glsl:592-608), and the 16-steps-per-unit shadow-space march
for volumetric light shafts (lighting_pass.glsl:620-651).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..gpu import sampling
from ..utils import math3d as m3

# rotated-grid PCF offsets in shadow-map texels (lighting_pass.glsl:604-608)
PCF_OFFSETS = (
    (0.75, 0.25),
    (-0.25, 0.75),
    (0.25, -0.75),
    (-0.75, -0.25),
)


def sun_matrices(sun_angle_x_deg, sun_angle_y_deg, half_size=40.0):
    """(sun_space_from_world, sun_dir) per render.cpp:962-970.

    sun_ori = Rotate_RH(angle.x, axis=(cos(angle.y), sin(angle.y), 0));
    sun_space = ortho(-h..h)^3 @ inv(sun_ori); sun_dir = sun_ori @ (0,0,-1).
    """
    ax = jnp.deg2rad(jnp.asarray(sun_angle_x_deg, jnp.float32))
    ay = jnp.deg2rad(jnp.asarray(sun_angle_y_deg, jnp.float32))
    axis = jnp.stack([jnp.cos(ay), jnp.sin(ay), jnp.zeros_like(ay)], -1)
    sun_ori = m3.rotate_rh(ax, axis)
    ortho = m3.orthographic_rh_zo(-half_size, half_size, -half_size, half_size,
                                  -half_size, half_size)
    sun_space_from_world = ortho @ m3.inverse(sun_ori)
    sun_dir = m3.transform_dirs(sun_ori, jnp.array([0.0, 0.0, -1.0]))
    return sun_space_from_world, sun_dir


def sun_visibility(sun_depth, sun_space_from_world, world_pos, normal,
                   noise_1, noise_2, normal_offset=0.1, wdepth=None):
    """4-tap PCF sun visibility in [0,1] (lighting_pass.glsl:592-608).

    sun_depth [S,S]; world_pos/normal [...,3]; noise_* [...] per-pixel.
    Pass wdepth = sampling.pack_depth_window_u16(sun_depth) ([S,S,4]): each
    tap is one 8-byte gather row from a 33 MB table instead of one row from
    the 268 MB 4x4 f32 pack (see pack_depth_window_u16).  A [S,S,16] 4x4
    pack routes to the legacy 1-row sampler.
    """
    s = sun_depth.shape[0]
    px = 1.0 / s
    p = world_pos + normal * normal_offset
    sun_p = m3.transform_points(sun_space_from_world, p)[..., :3]
    uv = sun_p[..., :2] * 0.5 + 0.5
    ref = sun_p[..., 2]
    # per-pixel jitter of the tap centre (glsl:600)
    uv = uv + 2.0 * jnp.stack([noise_2 - 0.5, noise_1 - 0.5], -1) * px
    if isinstance(wdepth, tuple):       # split 4x4 pack: 2 gather rows
        return sampling.sample_pcf4_window_split(
            wdepth[0], wdepth[1], s, uv, ref, PCF_OFFSETS
        )
    if wdepth is not None and wdepth.shape[-1] == 4:
        vis = 0.0
        for (ox, oy) in PCF_OFFSETS:
            off = jnp.array([ox * px, oy * px], jnp.float32)
            vis = vis + sampling.sample_depth_compare_window(
                wdepth, s, uv + off, ref
            )
        return vis * 0.25
    if wdepth is not None:
        return sampling.sample_pcf4_window(wdepth, s, uv, ref, PCF_OFFSETS)
    vis = 0.0
    for (ox, oy) in PCF_OFFSETS:
        vis = vis + sampling.sample_depth_compare(
            sun_depth, uv + jnp.array([ox * px, oy * px], jnp.float32), ref
        )
    return vis * 0.25


def light_shafts_polar(sun_depth, sun_space_from_world, camera_pos, world_pos,
                       normal, noise_1, sun_emission, intensity=0.001,
                       normal_offset=0.1, max_steps=48, n_theta=4096, n_r=48):
    """Volumetric shaft march via a polar shadow profile — the epipolar
    redesign of light_shafts (lighting_pass.glsl:620-651 semantics).

    Key observation: every pixel's march walks a ray FROM THE SAME POINT
    (the camera) in sun space, so the union of all march samples lies on a
    polar bundle around cam_sun.xy.  Tabulate the shadow depth once per frame
    on that polar grid D[theta, rho] (n_theta*n_r ~200k gather rows), then
    each pixel fetches ONE [n_r]-wide row and does its depth compares on the
    vector units.  Replaces max_steps gather rows per pixel (6.3M rows at
    1080p) with ~0.33M rows total.

    Discretization matches the reference march: radial bin = 1/16 sun-NDC
    (the reference's step_size), bins weighted by arc-steps-per-bin
    dist/r_xy, truncated at max_steps like the bounded march.  Pixels whose
    ray is near-parallel to the sun axis (r_xy < one bin) get no shaft —
    a measure-zero direction the dither/TAA hides.
    """
    two_pi = 2.0 * jnp.pi
    step_size = 1.0 / 16.0
    cam_sun = m3.transform_points(sun_space_from_world, camera_pos)[..., :3]
    p_sun = m3.transform_points(
        sun_space_from_world, world_pos + normal * normal_offset
    )[..., :3]
    delta = p_sun - cam_sun
    dist = jnp.linalg.norm(delta, axis=-1)
    r_xy = jnp.linalg.norm(delta[..., :2], axis=-1)

    # --- per-frame polar profile build (dense; one ~200k-row gather) ------
    # bin centers (j + 1.5)*dr match the reference march positions
    # t = (noise + i)/16, i = 1..max_steps, at the dither midpoint noise=0.5
    dr = step_size
    theta = (jnp.arange(n_theta, dtype=jnp.float32) + 0.5) * (two_pi / n_theta)
    rho = (jnp.arange(n_r, dtype=jnp.float32) + 1.5) * dr
    pxy = (
        cam_sun[:2]
        + jnp.stack([jnp.cos(theta), jnp.sin(theta)], -1)[:, None, :]
        * rho[None, :, None]
    )                                                     # [K,J,2]
    uv = pxy * 0.5 + 0.5
    prof = sampling.sample_bilinear(sun_depth[..., None], uv)[..., 0]  # [K,J]
    prof_u16 = jnp.clip(jnp.round(prof * 65535.0), 0.0, 65535.0).astype(jnp.uint16)

    # --- per-pixel: one row fetch + n_r VPU compares -----------------------
    ang = jnp.arctan2(delta[..., 1], delta[..., 0])       # [-pi, pi]
    kf = ang / two_pi * n_theta + (noise_1 - 0.5)         # theta dither
    k = jnp.mod(jnp.round(kf).astype(jnp.int32), n_theta)
    row = jnp.take(prof_u16, k, axis=0).astype(jnp.float32) * (1.0 / 65535.0)

    s = dist / jnp.maximum(r_xy, 1e-6)                    # arc-steps per bin
    z_j = cam_sun[2] + rho * (delta[..., 2:3] / jnp.maximum(r_xy[..., None], 1e-6))
    vis = (z_j < row).astype(jnp.float32)
    active = (rho <= r_xy[..., None]) & (
        rho * s[..., None] <= max_steps * step_size
    )
    acc = jnp.sum(jnp.where(active, vis, 0.0), axis=-1) * s
    acc = jnp.minimum(acc, float(max_steps))
    return acc[..., None] * (intensity * sun_emission)


def light_shafts(sun_depth, sun_space_from_world, camera_pos, world_pos, normal,
                 noise_1, sun_emission, intensity=0.001, normal_offset=0.1,
                 max_steps=48, wdepth=None):
    """Volumetric shaft march (lighting_pass.glsl:620-651).

    March from the camera to the surface point in shadow-map space with
    absolute step 1/16; accumulate intensity * visibility * sun_emission per
    step.  The reference's while(true) is bounded here by max_steps (48 covers
    the worst-case corner-to-corner distance of ~3 sun-NDC units).
    """
    cam_sun = m3.transform_points(sun_space_from_world, camera_pos)[..., :3]
    p_sun = m3.transform_points(
        sun_space_from_world, world_pos + normal * normal_offset
    )[..., :3]
    delta = p_sun - cam_sun
    dist = jnp.linalg.norm(delta, axis=-1)
    step_size = 1.0 / 16.0
    step = step_size * delta / jnp.maximum(dist, 1e-8)[..., None]

    s = sun_depth.shape[0]

    # The march positions are AFFINE in the step index (there is no early
    # break — the reference's `if (traveled > distance) break` only truncates
    # the sum), so the whole march batches into ONE gather of [*, max_steps]
    # rows instead of max_steps sequential small gathers in a `while` loop
    # (loop overhead plus latency-bound small-batch gathers).
    i = jnp.arange(1, max_steps + 1, dtype=jnp.float32)          # [S]
    t = noise_1[..., None] + i                                   # [*, S]
    pos = cam_sun[..., None, :] + step[..., None, :] * t[..., None]
    trav = step_size * t
    active = trav <= dist[..., None]
    uv = pos[..., :2] * 0.5 + 0.5
    if wdepth is not None:
        vis = sampling.sample_depth_compare_window(wdepth, s, uv, pos[..., 2])
    else:
        vis = sampling.sample_depth_compare(sun_depth, uv, pos[..., 2])
    acc = jnp.sum(jnp.where(active, vis, 0.0), axis=-1)
    return acc[..., None] * (intensity * sun_emission)
