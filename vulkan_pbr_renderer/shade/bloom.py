"""Physically-based bloom — port of bloom_downsample.glsl / bloom_upsample.glsl.

The reference runs 6 fullscreen passes down a half-res mip chain with the
13-tap Jimenez/CoD filter (downsample, weights 0.125/0.03125/0.0625/0.125 and
a firefly clamp at mip 1), then 6 additive 9-tap tent upsample passes with the
final level scaled by 0.06 (bloom strength).

Gather-free formulation: every tap at `uv + k*src_texel` equals a bilinear
resize of the integer-shifted source, so each pass is a weighted sum of
`resize(shift(src))` terms — dense VPU math with zero gathers, uv-exact for
any resolution (shift is edge-clamped like SAMPLER_LINEAR_CLAMP).  The tent
taps at +/-1.5 src texels become +/-3-dst-pixel shifts of the 2x-upsampled
image (exact at 2:1 ratios).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _shift_edge(img, dy, dx):
    h, w = img.shape[:2]
    ay, ax = abs(dy), abs(dx)
    pad = [(ay, ay), (ax, ax), (0, 0)]
    p = jnp.pad(img, pad, mode="edge")
    return p[ay + dy : ay + dy + h, ax + dx : ax + dx + w]


def _box2(img):
    """Exact 2x2 box mean (even dims) — what bilinear-at-half-res reduces to."""
    h, w, c = img.shape
    return img.reshape(h // 2, 2, w // 2, 2, c).mean((1, 3))


def _up2(img):
    """Exact 2x bilinear upsample with half-pixel centers (edge clamped).

    dst(2i+p, 2j+q) = bilinear at src (i + (2p-1)/4): per axis the two phases
    mix the texel with its left/right neighbor at weights (0.75, 0.25).
    """
    def axis_up(x):  # upsample leading axis
        lo = jnp.concatenate([x[:1], x[:-1]], 0)       # shift +1 (edge)
        hi = jnp.concatenate([x[1:], x[-1:]], 0)       # shift -1 (edge)
        ph0 = 0.75 * x + 0.25 * lo
        ph1 = 0.75 * x + 0.25 * hi
        return jnp.stack([ph0, ph1], 1).reshape((-1,) + x.shape[1:])

    return jnp.swapaxes(axis_up(jnp.swapaxes(axis_up(img), 0, 1)), 0, 1)


def _resize(img, h, w):
    """Bilinear resize; exact dense paths for the 2:1 cases (jax.image.resize
    lowers to gathers)."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img
    if sh == 2 * h and sw == 2 * w:
        return _box2(img)
    if h == 2 * sh and w == 2 * sw:
        return _up2(img)
    return jax.image.resize(img, (h, w) + img.shape[2:], method="linear")


def downsample_13tap(src, dst_h, dst_w, firefly_clamp=False):
    """One bloom downsample level (bloom_downsample.glsl:38-99).

    At exact 2:1 every tap is a 2x2 source-block mean at an integer offset,
    and all 13 offsets have matching parity per axis — so the filter
    decomposes into TWO box2 phase images (even-aligned b00, odd-aligned b11)
    plus cheap half-res shifts, instead of the naive 13 x shift+box2 at
    source res; this computes the identical sum (interior; borders clamp at
    half res)."""
    sh, sw = src.shape[:2]
    if (sh, sw) == (2 * dst_h, 2 * dst_w) and sh % 2 == 0 and sw % 2 == 0:
        b00 = _box2(src)
        b11 = _box2(_shift_edge(src, 1, 1))
        out = 0.125 * b00
        for (dy, dx) in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
            out = out + 0.03125 * _shift_edge(b00, dy, dx)
        for (dy, dx) in ((-1, 0), (0, -1), (1, 0), (0, 1)):
            out = out + 0.0625 * _shift_edge(b00, dy, dx)
        # diagonal +-1 source taps: odd-aligned blocks (b11 at half shifts)
        for (dy, dx) in ((-1, -1), (-1, 0), (0, -1), (0, 0)):
            out = out + 0.125 * _shift_edge(b11, dy, dx)
    else:
        taps = [
            (0, 0, 0.125),
            (-2, -2, 0.03125), (2, -2, 0.03125), (-2, 2, 0.03125), (2, 2, 0.03125),
            (0, -2, 0.0625), (-2, 0, 0.0625), (2, 0, 0.0625), (0, 2, 0.0625),
            (-1, -1, 0.125), (1, -1, 0.125), (-1, 1, 0.125), (1, 1, 0.125),
        ]
        out = 0.0
        for (dx, dy, wgt) in taps:
            out = out + wgt * _resize(_shift_edge(src, dy, dx), dst_h, dst_w)
    if firefly_clamp:
        out = jnp.minimum(out, 1.0)
    return out


def upsample_tent9(src, dst_h, dst_w, factor=1.0):
    """One bloom upsample level (bloom_upsample.glsl:23-59): 9-tap tent of
    radius 1.5 src texels, scaled by `factor` (0.06 at the final level)."""
    up = _resize(src, dst_h, dst_w)
    out = 0.0
    for dy, wy in ((-3, 1.0), (0, 2.0), (3, 1.0)):
        for dx, wx in ((-3, 1.0), (0, 2.0), (3, 1.0)):
            out = out + (wx * wy) * _shift_edge(up, dy, dx)
    return out * (factor / 16.0)


def bloom(hdr, passes=6, strength=0.06):
    """Full bloom pyramid (render.cpp:1142-1178): 6 downsamples to 1/64 res,
    then 6 tent upsamples; intermediate upscale RTs are cleared in the
    reference (render.cpp:1157), so the up chain reads ONLY the previous
    upsample — no down-level accumulation.  Mip 0 holds the blitted TAA image
    plus the final tent scaled by `strength` (0.06): out = hdr + s*tent(up1).
    """
    out, _ = bloom_with_pyramid(hdr, passes, strength)
    return out


def bloom_with_pyramid(hdr, passes=6, strength=0.06):
    """bloom() + the downsample chain [down1..downN] (sizes H/2..H/2^N).

    The chain is exactly what the reference's lighting pass reads next frame
    as PREV_FRAME_RESULT (render.cpp:862 binds bloom_downscale_rt there).
    """
    h, w = hdr.shape[:2]
    sizes = [(max(1, h >> i), max(1, w >> i)) for i in range(passes + 1)]
    downs = []
    # chain arithmetic stays f32: a bf16 chain was measured to break the
    # sharded-vs-single-chip exactness contract (different op order amplifies
    # f32 reassociation noise ~2e-4 to bf16-ulp ~1e-3, tests/test_parallel).
    # The capacity/bandwidth win lives in the STORED prev-frame atlas instead
    # (renderer.py packs it bf16 — the reference's RGBA16F RTs,
    # render.cpp:693-697).
    cur = hdr
    for i in range(1, passes + 1):
        cur = downsample_13tap(cur, *sizes[i], firefly_clamp=(i == 1))
        downs.append(cur)
    for i in range(passes - 1, 0, -1):
        cur = upsample_tent9(cur, *sizes[i], factor=1.0)
    tent = upsample_tent9(cur, *sizes[0], factor=strength)
    return hdr + tent.astype(hdr.dtype), downs
