"""Temporal anti-aliasing resolve — port of taa_resolve.glsl:180-287.

Per pixel: Mitchell-Netravali-weighted 3x3 source filter, neighborhood
first/second moments, closest-depth velocity dilation, Catmull-Rom history
resampling at the reprojected uv, variance clipping to mu +/- gamma*sigma,
and velocity-difference-based history rejection.

Deviation from the reference, on purpose: the reference's dilation loop reads
the depth at the *unshifted* uv (taa_resolve.glsl:215 samples `uv`, not
`sample_uv`), which degenerates closest_depth_uv to the constant (-1,-1)
neighbor.  We implement the intended closest-depth dilation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..gpu import sampling


def _mitchell(x, b=1.0 / 3.0, c=1.0 / 3.0):
    ax = abs(x)
    if ax < 1:
        return ((12 - 9 * b - 6 * c) * ax**3 + (-18 + 12 * b + 6 * c) * ax**2 + (6 - 2 * b)) / 6
    if ax < 2:
        return ((-b - 6 * c) * ax**3 + (6 * b + 30 * c) * ax**2 + (-12 * b - 48 * c) * ax + (8 * b + 24 * c)) / 6
    return 0.0


def taa_resolve(
    lighting,        # [H,W,3] current lighting result (+2 halo rows if halo=1)
    depth,           # [H,W] (+halo)
    velocity,        # [H,W,2] current ndc velocity (+halo)
    velocity_prev,   # [FH,W,2] previous frame's velocity buffer (full height)
    history,         # [FH,W,3] previous TAA output (full height)
    blend=0.05,
    velocity_rejection=1000.0,
    gamma=1.0,
    catmull_history=True,
    halo=0,
    row_offset=0,
    full_height=None,
    full_rgb_catmull=False,
):
    """Returns the new TAA output [H,W,3] (H = input rows − 2*halo).

    Row-sharded mode (parallel/sharding.py): pass lighting/depth/velocity as
    this shard's rows WITH one edge-clamped halo row on each side (halo=1),
    plus row_offset/full_height; history and velocity_prev stay full-height
    (they are replicated state, and the reprojected uv can land on any row).
    The halo supplies the 3x3 neighborhoods, so the sharded output equals the
    matching rows of the single-chip resolve.
    """
    w = depth.shape[1]
    h = depth.shape[0] - 2 * halo
    fh = full_height or h
    offsets = [(dy, dx) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    weights = [_mitchell(np.hypot(dx, dy)) for (dy, dx) in offsets]
    wsum = float(sum(weights))

    # 3x3 source filter + moments, accumulated incrementally over edge-clamped
    # shifts of ONE padded copy — a jnp.stack would materialize a
    # [9,H,W,3] tensor (226 MB of memory traffic at 1080p).
    # With halo=1 the rows are already haloed; only x needs the edge pad.
    ypad = (1 - halo, 1 - halo)
    pad = jnp.pad(lighting, [ypad, (1, 1), (0, 0)], mode="edge")
    out3 = (h, w, 3)
    source = jnp.zeros(out3, lighting.dtype)
    m1 = jnp.zeros(out3, lighting.dtype)
    m2 = jnp.zeros(out3, lighting.dtype)
    for (dy, dx), wgt in zip(offsets, weights):
        nb = jax.lax.dynamic_slice(pad, (1 + dy, 1 + dx, 0), out3)
        source = source + jnp.float32(wgt) * nb
        m1 = m1 + nb
        m2 = m2 + nb * nb
    source = source * jnp.float32(1.0 / wsum)
    m1 = m1 * jnp.float32(1.0 / 9.0)
    m2 = m2 * jnp.float32(1.0 / 9.0)
    sigma = jnp.sqrt(jnp.abs(m2 - m1 * m1))
    minc = m1 - gamma * sigma
    maxc = m1 + gamma * sigma

    # closest-depth velocity dilation — dense select tournament (argmin +
    # take_along_axis would lower to gathers)
    dpad = jnp.pad(depth, [ypad, (1, 1)], mode="edge")
    vpad = jnp.pad(velocity, [ypad, (1, 1), (0, 0)], mode="edge")
    best_d = jax.lax.dynamic_slice(dpad, (1, 1), (h, w))
    vel = jax.lax.dynamic_slice(vpad, (1, 1, 0), (h, w, 2))
    for (dy, dx) in offsets:
        if dy == 0 and dx == 0:
            continue
        d_n = jax.lax.dynamic_slice(dpad, (1 + dy, 1 + dx), (h, w))
        v_n = jax.lax.dynamic_slice(vpad, (1 + dy, 1 + dx, 0), (h, w, 2))
        take = d_n < best_d
        best_d = jnp.where(take, d_n, best_d)
        vel = jnp.where(take[..., None], v_n, vel)

    u = (jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5) / w
    v = (jnp.arange(h, dtype=jnp.float32)[:, None] + row_offset + 0.5) / fh
    uv = jnp.stack([jnp.broadcast_to(u, (h, w)), jnp.broadcast_to(v, (h, w))], -1)
    reproj_uv = uv - vel * 0.5

    # History resample in YCoCg, split by what the eye needs (narrow rows
    # instead of the 4x4 f16 RGB window's 96B rows from a 200 MB table, or
    # the 2x2 5-tap's 5 x 24B rows):
    #  * luma: full 16-tap Catmull-Rom from a 4x4 window of f16 luma
    #    ([H,W,16], 32B rows, 67 MB) — sharpness lives in luma;
    #  * chroma + prev velocity: ONE bilinear 2x2 f16 window of (Co,Cg,vx,vy)
    #    ([H,W,16], 32B rows) — both are sampled at the same reprojected uv,
    #    so sharing the row halves what used to be two separate fetches.
    # 2 gather rows/pixel total.  The reference's RGB Catmull
    # (taa_resolve.glsl:125-174) differs only by the chroma filter.
    if catmull_history and full_rgb_catmull:
        # reference-exact full-RGB Catmull-Rom (taa_resolve.glsl:125-174):
        # one 96-byte 4x4 rgb window row (f16[48], gathered through the i32
        # bitcast view — sampling.take_rows) + one 16-byte 2x2 prev-velocity
        # row.  The YCoCg split below is the economy mode (32B + 32B) whose
        # only delta is bilinear chroma (VISUAL_PARITY.md).
        wrgb = sampling.window_pack(history, 4, 4, dtype=jnp.float16)
        prev_color = sampling.sample_catmull_rom_window_decode(
            wrgb, fh, w, reproj_uv, 3
        )
        prev_color = jnp.maximum(prev_color, 0.0)   # Catmull undershoot
        wvel = sampling.window_pack(velocity_prev, 2, 2, dtype=jnp.float16)
        prev_vel = sampling.sample_bilinear_window(wvel, fh, w, reproj_uv, 2)
    elif catmull_history:
        y = (0.25 * history[..., 0] + 0.5 * history[..., 1]
             + 0.25 * history[..., 2])
        co = 0.5 * history[..., 0] - 0.5 * history[..., 2]
        cg = (-0.25 * history[..., 0] + 0.5 * history[..., 1]
              - 0.25 * history[..., 2])
        # f16 luma: log-distributed 0.05% relative precision at every scale —
        # exactly the reference's RGBA16F RT precision — and decode-free.
        # (Two compressed-u16 schemes lost to it: y/(1+y) needed a divide per
        # decoded texel, and sqrt-scale had
        # 0.36% low-end steps that amplified benign fp noise past the
        # sharded-parity tolerance.)
        wluma = sampling.window_pack(y[..., None], 4, 4, dtype=jnp.float16)
        wcv = sampling.window_pack(
            jnp.concatenate([jnp.stack([co, cg], -1), velocity_prev], -1),
            2, 2, dtype=jnp.float16,
        )

        y_s = sampling.sample_catmull_rom_window_decode(
            wluma, fh, w, reproj_uv, 1
        )[..., 0]
        y_s = jnp.maximum(y_s, 0.0)   # Catmull undershoot
        cv = sampling.sample_bilinear_window(wcv, fh, w, reproj_uv, 4)
        co_s, cg_s = cv[..., 0], cv[..., 1]
        prev_vel = cv[..., 2:4]
        prev_color = jnp.stack(
            [y_s + co_s - cg_s, y_s + cg_s, y_s - co_s - cg_s], -1
        )
    else:
        whv = sampling.window_pack(
            jnp.concatenate([history, velocity_prev], -1), 2, 2,
            dtype=jnp.float16,
        )
        hv = sampling.sample_bilinear_window(whv, fh, w, reproj_uv, 5)
        prev_color = hv[..., :3]
        prev_vel = hv[..., 3:5]
    prev_color = jnp.clip(prev_color, minc, maxc)

    weight_b = blend + velocity_rejection * jnp.linalg.norm(prev_vel - vel, axis=-1)
    offscreen = jnp.any((reproj_uv < 0.0) | (reproj_uv > 1.0), axis=-1)
    weight_b = jnp.where(offscreen, 1.0, weight_b)[..., None]
    weight_a = jnp.where(offscreen[..., None], 0.0, 1.0 - blend)

    return (source * weight_b + prev_color * weight_a) / jnp.maximum(
        weight_b + weight_a, 1e-5
    )
