"""Texture sampling library — the replacement for Vulkan samplers.

The reference binds fixed-function samplers (GPU_MakeSampler, gpu_vulkan.c:613-634;
six common samplers at :1126-1136): linear/nearest x wrap/clamp, LOD-clamped, and a
percentage-closer compare sampler (compare_op=Less, render.cpp:672).  Here each of
those becomes a gather-based jnp function over plain arrays:

* 2D textures are [H, W, C] arrays; uv in [0,1]^2 with texel centers at
  (i+0.5)/N; v=0 is row 0 (top), matching Vulkan's y-down texture space.
* 3D textures are [D, H, W, C] (z-major), uvw = (x, y, z) like GLSL texture3D.
* Cubemaps are [6, S, S, C] in Vulkan layer order +X,-X,+Y,-Y,+Z,-Z with the
  face-UV mapping from the Vulkan spec (documented in the reference at
  gen_irradiance_map.glsl:11-66).
* Mip chains are packed into a single "mip atlas" [H, Wa, C] with level k
  occupying rows [0, H>>k) and a static column offset — this makes per-pixel
  dynamic-LOD sampling a single arithmetic gather instead of a switch over
  differently-shaped arrays (which XLA cannot express).

Everything is jit-safe and shape-static.  XLA fuses the gather + filter
arithmetic on its own, so these jnp functions ARE the production sampling
path; only the rasterizer has a hand-written kernel (raster/).  The
window/quad/split packs below were sized for an earlier platform's gather
costs; each is kept until a GPU measurement says whether it pays.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Address modes


def _wrap_coord(i, n, mode):
    if mode == "clamp":
        return jnp.clip(i, 0, n - 1)
    elif mode == "wrap":
        return jnp.mod(i, n)
    raise ValueError(f"unknown address mode {mode!r}")


def take_rows(flat, idx):
    """jnp.take(flat, idx, axis=0) through an i32 BITCAST view of the rows
    when the table is 8/16-bit typed with a 4-byte-divisible row.

    Same bytes move either way; the 32-bit view gathers whole 4-byte words
    instead of narrow elements.  Integer bitcast is bit-exact (no NaN
    canonicalization risk).
    Returns rows in the ORIGINAL dtype."""
    n, c = flat.shape
    per = {jnp.uint16.dtype: 2, jnp.float16.dtype: 2,
           jnp.uint8.dtype: 4, jnp.int8.dtype: 4}.get(flat.dtype, None)
    if per is None or c % per != 0:
        return jnp.take(flat, idx, axis=0)
    v32 = jax.lax.bitcast_convert_type(
        flat.reshape(n, c // per, per), jnp.int32
    )
    r = jnp.take(v32, idx, axis=0)
    return jax.lax.bitcast_convert_type(r, flat.dtype).reshape(
        idx.shape + (c,)
    )


def _gather2d(tex, iy, ix):
    """tex [H,W,C] gathered at int arrays iy/ix [...] -> [...,C]."""
    h, w, c = tex.shape
    flat = tex.reshape(h * w, c)
    idx = iy * w + ix
    return jnp.take(flat, idx, axis=0)


def _gather3d(vol, iz, iy, ix):
    d, h, w, c = vol.shape
    flat = vol.reshape(d * h * w, c)
    idx = (iz * h + iy) * w + ix
    return jnp.take(flat, idx, axis=0)


# ---------------------------------------------------------------------------
# 2D sampling


def sample_nearest(tex, uv, mode="clamp"):
    """Nearest-neighbor 2D sample. tex [H,W,C], uv [...,2] -> [...,C]."""
    h, w, _ = tex.shape
    ix = jnp.floor(uv[..., 0] * w).astype(jnp.int32)
    iy = jnp.floor(uv[..., 1] * h).astype(jnp.int32)
    return _gather2d(tex, _wrap_coord(iy, h, mode), _wrap_coord(ix, w, mode))


def sample_nearest8(tex2d, uv):
    """Bit-exact `sample_nearest` of a single-channel [H,W] texture through a
    32-byte blocked view: the row-major [H,W] f32 buffer reshaped [H*W/8, 8]
    (a free relayout) is gathered one ROW per sample and the wanted texel
    selected in-register with a one-hot where/sum.

    Rationale: per-row overhead dominates narrow gather rows, so fetching
    the 8-texel block containing the sample costs one 32-byte row instead
    of a 4-byte one, at zero fidelity cost.  Clamp addressing, like
    sample_nearest(mode="clamp").

    Exactness caveat: the one-hot where/sum select is arithmetic,
    so a -0.0 texel comes back as +0.0 (-0.0 + 0.0 == +0.0).  All callers
    pass [0,1] depth (never -0.0), and every downstream use is a comparison
    where -0.0 == +0.0 anyway.

    The w % 8 guard is an ALIGNMENT/PERF choice, not correctness: the flat
    linear index would be legal whenever h*w % 8 == 0, but a row-straddling
    block means adjacent samples hit different cache rows; odd widths only
    occur in tests, so they take the plain per-texel path."""
    h, w = tex2d.shape
    if w % 8 != 0:
        return sample_nearest(tex2d[..., None], uv)[..., 0]
    packed = tex2d.reshape(h * w // 8, 8)
    ix = jnp.clip(jnp.floor(uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip(jnp.floor(uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    lin = iy * w + ix
    rows = jnp.take(packed, lin >> 3, axis=0)
    onehot = (lin & 7)[..., None] == jnp.arange(8, dtype=jnp.int32)
    return jnp.where(onehot, rows, 0.0).sum(-1)


def sample_bilinear(tex, uv, mode="clamp"):
    """Bilinear 2D sample. tex [H,W,C], uv [...,2] -> [...,C]."""
    h, w, _ = tex.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    x0c = _wrap_coord(x0, w, mode)
    x1c = _wrap_coord(x0 + 1, w, mode)
    y0c = _wrap_coord(y0, h, mode)
    y1c = _wrap_coord(y0 + 1, h, mode)
    t00 = _gather2d(tex, y0c, x0c)
    t10 = _gather2d(tex, y0c, x1c)
    t01 = _gather2d(tex, y1c, x0c)
    t11 = _gather2d(tex, y1c, x1c)
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def sample_catmull_rom(tex, uv):
    """9-tap Catmull-Rom sampling (bicubic via bilinear taps).

    Reproduces SampleHistoryTextureCatmullRom (taa_resolve.glsl:125-174,
    MJP's technique): 4x4 support evaluated with 9 bilinear fetches.
    """
    h, w, _ = tex.shape
    tex_size = jnp.array([w, h], jnp.float32)
    sample_pos = uv * tex_size
    tex_pos1 = jnp.floor(sample_pos - 0.5) + 0.5
    f = sample_pos - tex_pos1
    w0 = f * (-0.5 + f * (1.0 - 0.5 * f))
    w1 = 1.0 + f * f * (-2.5 + 1.5 * f)
    w2 = f * (0.5 + f * (2.0 - 1.5 * f))
    w3 = f * f * (-0.5 + 0.5 * f)
    w12 = w1 + w2
    offset12 = w2 / w12
    tex_pos0 = (tex_pos1 - 1.0) / tex_size
    tex_pos3 = (tex_pos1 + 2.0) / tex_size
    tex_pos12 = (tex_pos1 + offset12) / tex_size

    def tap(px, py, wx, wy):
        return sample_bilinear(tex, jnp.stack([px, py], -1)) * (wx * wy)[..., None]

    xs = (tex_pos0[..., 0], tex_pos12[..., 0], tex_pos3[..., 0])
    ys = (tex_pos0[..., 1], tex_pos12[..., 1], tex_pos3[..., 1])
    wxs = (w0[..., 0], w12[..., 0], w3[..., 0])
    wys = (w0[..., 1], w12[..., 1], w3[..., 1])
    out = 0.0
    for j in range(3):
        for i in range(3):
            out = out + tap(xs[i], ys[j], wxs[i], wys[j])
    return out


def sample_depth_compare(depth, uv, ref, offset_texels=None):
    """PCF compare sample: bilinear filter of (ref < stored) tests.

    Matches sampler2DShadow with VK_COMPARE_OP_LESS (render.cpp:672 +
    lighting_pass.glsl:604-608): returns filtered visibility in [0,1],
    1 where the reference depth is closer than the stored occluder depth.
    depth [H,W], uv [...,2], ref [...] -> [...].
    """
    h, w = depth.shape
    if offset_texels is not None:
        uv = uv + jnp.asarray(offset_texels, jnp.float32) / jnp.array([w, h], jnp.float32)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    d = depth[..., None]

    def cmp(iy, ix):
        t = _gather2d(d, jnp.clip(iy, 0, h - 1), jnp.clip(ix, 0, w - 1))[..., 0]
        return (ref < t).astype(jnp.float32)

    c00 = cmp(y0, x0)
    c10 = cmp(y0, x0 + 1)
    c01 = cmp(y0 + 1, x0)
    c11 = cmp(y0 + 1, x0 + 1)
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


# ---------------------------------------------------------------------------
# 3D sampling (the 128^3 lightgrid)


def sample_trilinear_3d(vol, uvw, mode="clamp"):
    """Trilinear 3D sample. vol [D,H,W,C], uvw [...,3] (x,y,z) -> [...,C]."""
    d, h, w, _ = vol.shape
    x = uvw[..., 0] * w - 0.5
    y = uvw[..., 1] * h - 0.5
    z = uvw[..., 2] * d - 0.5
    x0f, y0f, z0f = jnp.floor(x), jnp.floor(y), jnp.floor(z)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    fz = (z - z0f)[..., None]
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    z0 = z0f.astype(jnp.int32)

    def g(dz, dy, dx):
        return _gather3d(
            vol,
            _wrap_coord(z0 + dz, d, mode),
            _wrap_coord(y0 + dy, h, mode),
            _wrap_coord(x0 + dx, w, mode),
        )

    c000, c100 = g(0, 0, 0), g(0, 0, 1)
    c010, c110 = g(0, 1, 0), g(0, 1, 1)
    c001, c101 = g(1, 0, 0), g(1, 0, 1)
    c011, c111 = g(1, 1, 0), g(1, 1, 1)
    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


# ---------------------------------------------------------------------------
# Cubemaps — Vulkan face order and UV mapping (gen_irradiance_map.glsl:11-66)


def cubemap_dir_from_face_uv(face_index, face_uv):
    """Unit direction for (face, uv). face_index int [...] , face_uv [...,2]."""
    sc = 2.0 * (face_uv[..., 0] - 0.5)
    tc = 2.0 * (face_uv[..., 1] - 0.5)
    one = jnp.ones_like(sc)
    # per-face (x, y, z) as functions of (sc, tc)
    dirs = jnp.stack(
        [
            jnp.stack([one, -tc, -sc], -1),   # +X
            jnp.stack([-one, -tc, sc], -1),   # -X
            jnp.stack([sc, one, tc], -1),     # +Y
            jnp.stack([sc, -one, -tc], -1),   # -Y
            jnp.stack([sc, -tc, one], -1),    # +Z
            jnp.stack([-sc, -tc, -one], -1),  # -Z
        ],
        axis=0,
    )
    f = jnp.broadcast_to(face_index, sc.shape)
    sel = jnp.take_along_axis(
        dirs.reshape(6, -1, 3), f.reshape(1, -1, 1).astype(jnp.int32), axis=0
    )[0]
    d = sel.reshape(sc.shape + (3,))
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def cubemap_face_uv_from_dir(r):
    """Inverse mapping: direction [...,3] -> (face int [...], uv [...,2])."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    # major axis selection
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    is_z = ~(is_x | is_y)
    face = jnp.where(
        is_x,
        jnp.where(x >= 0, 0, 1),
        jnp.where(is_y, jnp.where(y >= 0, 2, 3), jnp.where(z >= 0, 4, 5)),
    ).astype(jnp.int32)
    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az))
    ma = jnp.maximum(ma, 1e-20)
    # sc/tc per Vulkan spec table
    sc = jnp.where(
        is_x, jnp.where(x >= 0, -z, z), jnp.where(is_y, x, jnp.where(z >= 0, x, -x))
    )
    tc = jnp.where(is_x, -y, jnp.where(is_y, jnp.where(y >= 0, z, -z), -y))
    u = 0.5 * sc / ma + 0.5
    v = 0.5 * tc / ma + 0.5
    return face, jnp.stack([u, v], -1)


def sample_cubemap(faces, r):
    """Bilinear cubemap sample (no seam blending; clamps at face edges).

    faces [6,S,S,C], r [...,3] (need not be normalized) -> [...,C].
    """
    six, s, s2, c = faces.shape
    face, uv = cubemap_face_uv_from_dir(r)
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0f, y0f = jnp.floor(x), jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    flat = faces.reshape(6 * s * s, c)

    def g(iy, ix):
        iy = jnp.clip(iy, 0, s - 1)
        ix = jnp.clip(ix, 0, s - 1)
        return jnp.take(flat, (face * s + iy) * s + ix, axis=0)

    t00, t10 = g(y0, x0), g(y0, x0 + 1)
    t01, t11 = g(y0 + 1, x0), g(y0 + 1, x0 + 1)
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


# ---------------------------------------------------------------------------
# Mip atlases: single-array mip pyramids for dynamic-LOD sampling


def n_mip_levels(h, w):
    return int(math.floor(math.log2(max(1, min(h, w))))) + 1


def mip_sizes(h, w, levels=None):
    levels = levels or n_mip_levels(h, w)
    return [(max(1, h >> k), max(1, w >> k)) for k in range(levels)]


def mip_offsets(h, w, levels=None):
    """Static column offsets of each level inside the atlas."""
    offs = []
    x = 0
    for (lh, lw) in mip_sizes(h, w, levels):
        offs.append(x)
        x += lw
    return offs, x  # offsets, total atlas width


def downsample2x(tex):
    """2x2 box filter downsample — matches blit-chain mip generation
    (GPU_OpGenerateMipmaps, gpu_vulkan.c:1458-1483, linear filter)."""
    h, w, c = tex.shape
    h2, w2 = max(1, h // 2), max(1, w // 2)
    t = tex[: h2 * 2, : w2 * 2]
    t = t.reshape(h2, 2, w2, 2, c)
    return t.mean(axis=(1, 3))


def build_mip_atlas(tex, levels=None):
    """Pack tex [H,W,C] and its mip chain into one [H, Wa, C] atlas array."""
    h, w, c = tex.shape
    levels = levels or n_mip_levels(h, w)
    offs, wa = mip_offsets(h, w, levels)
    atlas = jnp.zeros((h, wa, c), tex.dtype)
    cur = tex
    for k in range(levels):
        lh, lw = max(1, h >> k), max(1, w >> k)
        atlas = atlas.at[:lh, offs[k] : offs[k] + lw].set(cur)
        if k + 1 < levels:
            cur = downsample2x(cur)
    return atlas


# ---------------------------------------------------------------------------
# Window ("shingled") packing: store each texel's whole filter window in its
# row.  Where a gather costs per ROW more than per byte, trading memory
# (wy*wx*C floats per texel) for ONE gather per multi-tap filter evaluation
# pays: PCF 16 rows -> 1, TAA Catmull-Rom 36 -> 1, GI trilinear 8 -> 1.
# Packs are dense reshifts rebuilt per frame.


def window_pack(tex, wy, wx, pad_mode="edge", dtype=None):
    """[H,W,C] -> [H,W,wy*wx*C]; row (y,x) holds tex[y:y+wy, x:x+wx],
    channel layout (dy*wx+dx)*C + c.  pad_mode 'edge' = clamp addressing,
    'wrap' = repeat addressing (exact for tiled material textures).

    dtype: optional storage dtype for the pack (e.g. jnp.float16 — matches the
    reference's RGBA16F render targets, render.cpp:693-697, and HALVES the
    gather row bytes)."""
    h, w, c = tex.shape
    if dtype is not None:
        tex = tex.astype(dtype)
    p = jnp.pad(tex, ((0, wy - 1), (0, wx - 1), (0, 0)), mode=pad_mode)
    return jnp.concatenate(
        [p[dy : dy + h, dx : dx + w] for dy in range(wy) for dx in range(wx)],
        axis=-1,
    )


def window_pack3d(vol, dtype=None):
    """[D,H,W,C] -> [D,H,W,8C]; row (z,y,x) holds the 2x2x2 corner block
    (dz*4+dy*2+dx)*C + c, edge-clamped.  dtype: see window_pack."""
    d, h, w, c = vol.shape
    if dtype is not None:
        vol = vol.astype(dtype)
    p = jnp.pad(vol, ((0, 1), (0, 1), (0, 1), (0, 0)), mode="edge")
    return jnp.concatenate(
        [
            p[dz : dz + d, dy : dy + h, dx : dx + w]
            for dz in range(2)
            for dy in range(2)
            for dx in range(2)
        ],
        axis=-1,
    )


def sample_trilinear_window(wvol, uvw, channels, decode=None):
    """Trilinear 3D sample from a window_pack3d volume — ONE gather row.

    wvol [D,H,W,8C]; uvw [...,3] (x,y,z) clamp-addressed; returns [...,C].
    decode: optional per-corner [...,C]->[...,C] transform applied BEFORE the
    lerp (for quantized packs where interpolation must happen in the decoded
    space, e.g. gi.pack_grid_u8's range-compressed radiance).
    """
    d, h, w, c8 = wvol.shape
    x = uvw[..., 0] * w - 0.5
    y = uvw[..., 1] * h - 0.5
    z = uvw[..., 2] * d - 0.5
    x0f, y0f, z0f = jnp.floor(x), jnp.floor(y), jnp.floor(z)
    fx = jnp.clip(x - x0f, 0.0, 1.0)[..., None]
    fy = jnp.clip(y - y0f, 0.0, 1.0)[..., None]
    fz = jnp.clip(z - z0f, 0.0, 1.0)[..., None]
    ix = jnp.clip(x0f.astype(jnp.int32), 0, w - 1)
    iy = jnp.clip(y0f.astype(jnp.int32), 0, h - 1)
    iz = jnp.clip(z0f.astype(jnp.int32), 0, d - 1)
    # clamp below 0: fractional must also clamp so the edge texel repeats
    fx = jnp.where((x0f < 0)[..., None], 0.0, fx)
    fy = jnp.where((y0f < 0)[..., None], 0.0, fy)
    fz = jnp.where((z0f < 0)[..., None], 0.0, fz)

    flat = wvol.reshape(d * h * w, c8)
    row = take_rows(flat, (iz * h + iy) * w + ix)
    if row.dtype != jnp.float32:
        row = row.astype(jnp.float32)
    cc = channels

    def corner(dz, dy, dx):
        k = (dz * 4 + dy * 2 + dx) * cc
        v = row[..., k : k + cc]
        return decode(v) if decode is not None else v

    c00 = corner(0, 0, 0) + (corner(0, 0, 1) - corner(0, 0, 0)) * fx
    c10 = corner(0, 1, 0) + (corner(0, 1, 1) - corner(0, 1, 0)) * fx
    c01 = corner(1, 0, 0) + (corner(1, 0, 1) - corner(1, 0, 0)) * fx
    c11 = corner(1, 1, 0) + (corner(1, 1, 1) - corner(1, 1, 0)) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def sample_catmull_rom_window(wtex, base_h, base_w, uv, channels):
    """Catmull-Rom resample from a 4x4 window_pack — ONE gather row.
    Matches sample_catmull_rom away from a 2-texel border."""
    tex_size = jnp.array([base_w, base_h], jnp.float32)
    sample_pos = uv * tex_size
    t1 = jnp.floor(sample_pos - 0.5)
    f = sample_pos - 0.5 - t1
    w0 = f * (-0.5 + f * (1.0 - 0.5 * f))
    w1 = 1.0 + f * f * (-2.5 + 1.5 * f)
    w2 = f * (0.5 + f * (2.0 - 1.5 * f))
    w3 = f * f * (-0.5 + 0.5 * f)
    wx = [w0[..., 0], w1[..., 0], w2[..., 0], w3[..., 0]]
    wy = [w0[..., 1], w1[..., 1], w2[..., 1], w3[..., 1]]

    t0x = jnp.clip(t1[..., 0].astype(jnp.int32) - 1, 0, base_w - 4)
    t0y = jnp.clip(t1[..., 1].astype(jnp.int32) - 1, 0, base_h - 4)
    flat = wtex.reshape(base_h * base_w, -1)
    row = take_rows(flat, t0y * base_w + t0x)
    if row.dtype != jnp.float32:
        row = row.astype(jnp.float32)
    cc = channels
    out = 0.0
    for i in range(4):
        for j in range(4):
            k = (i * 4 + j) * cc
            out = out + row[..., k : k + cc] * (wy[i] * wx[j])[..., None]
    return out


def sample_bilinear_window(wtex, base_h, base_w, uv, channels, mode="clamp"):
    """Bilinear sample from a 2x2 window_pack(tex, 2, 2) — ONE gather row.

    In wrap mode the last row/column's window clamps instead of wrapping
    (window packs are edge-clamped): a 1-texel seam error at tile borders.
    """
    x = uv[..., 0] * base_w - 0.5
    y = uv[..., 1] * base_h - 0.5
    x0f, y0f = jnp.floor(x), jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    if mode == "wrap":
        ix = jnp.mod(x0f.astype(jnp.int32), base_w)
        iy = jnp.mod(y0f.astype(jnp.int32), base_h)
    else:
        ix = jnp.clip(x0f.astype(jnp.int32), 0, base_w - 1)
        iy = jnp.clip(y0f.astype(jnp.int32), 0, base_h - 1)
        fx = jnp.where((x0f < 0)[..., None], 0.0, fx)
        fy = jnp.where((y0f < 0)[..., None], 0.0, fy)
    flat = wtex.reshape(base_h * base_w, -1)
    row = take_rows(flat, iy * base_w + ix)
    if row.dtype != jnp.float32:
        row = row.astype(jnp.float32)
    c = channels
    t00 = row[..., 0 * c : 1 * c]
    t10 = row[..., 1 * c : 2 * c]
    t01 = row[..., 2 * c : 3 * c]
    t11 = row[..., 3 * c : 4 * c]
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def sample_screen_atlas_window(watlas, base_h, base_w, levels, uv, level,
                               channels):
    """Bilinear sample at a PER-LANE pyramid level from a window-packed
    screen mip atlas — ONE gather row.

    watlas: window_pack(atlas, 2, 2) of a [base_h, Wa, C] screen mip atlas
    (level k of size (base_h>>k, base_w>>k) at column mip_offsets[k] — the
    layout of the prev-frame pyramid / build_hiz_atlas).  level [...] int
    per lane.  The 2x2 base index is clamped one texel short of each level's
    edge so the window never reads the neighbouring level; the fractional
    weight is re-derived against the clamped base (pure-edge-texel results
    at the border, CLAMP semantics).

    Matches the reference's textureLod(PREV_FRAME_RESULT, uv, mip)
    (lighting_pass.glsl:377) at nearest-mip."""
    offs_list, wa = mip_offsets(base_h, base_w, levels)
    offs = jnp.asarray(offs_list, jnp.int32)
    lv = jnp.clip(jnp.asarray(level, jnp.int32), 0, levels - 1)
    ls_h = jnp.maximum(jnp.right_shift(jnp.int32(base_h), lv), 1)
    ls_w = jnp.maximum(jnp.right_shift(jnp.int32(base_w), lv), 1)
    off = jnp.take(offs, lv)
    x = uv[..., 0] * ls_w - 0.5
    y = uv[..., 1] * ls_h - 0.5
    ix = jnp.clip(jnp.floor(x).astype(jnp.int32), 0,
                  jnp.maximum(ls_w - 2, 0))
    iy = jnp.clip(jnp.floor(y).astype(jnp.int32), 0,
                  jnp.maximum(ls_h - 2, 0))
    fx = jnp.clip(x - ix, 0.0, 1.0)[..., None]
    fy = jnp.clip(y - iy, 0.0, 1.0)[..., None]
    flat = watlas.reshape(watlas.shape[0] * watlas.shape[1], -1)
    row = take_rows(flat, iy * watlas.shape[1] + off + ix)
    if row.dtype != jnp.float32:
        row = row.astype(jnp.float32)
    c = channels
    t00 = row[..., 0 * c : 1 * c]
    t10 = row[..., 1 * c : 2 * c]
    t01 = row[..., 2 * c : 3 * c]
    t11 = row[..., 3 * c : 4 * c]
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def pack_depth_window_u16(depth):
    """[S,S] f32 depth in [0,1] -> 2x2-window pack stored as uint16
    ([S,S,4], 8-byte gather rows, S=2048 -> 33 MB).

    Rationale: the 4x4 f32 window pack is 268 MB; the u16 2x2 pack is
    8x smaller, so every PCF/shaft gather touches far fewer bytes (on the
    H100 the 33 MB table fits the 50 MB L2).  u16 quantization error
    (<=7.6e-6) is far below the shadow biases (normal offset ~1.25e-3 in sun
    NDC, voxelize z-bias 1e-3), so compares are unaffected."""
    q = jnp.clip(jnp.round(depth * 65535.0), 0.0, 65535.0).astype(jnp.uint16)
    return window_pack(q[..., None], 2, 2)


def _dequant_depth_row(row):
    if row.dtype == jnp.uint16:
        return row.astype(jnp.float32) * (1.0 / 65535.0)
    if row.dtype != jnp.float32:
        return row.astype(jnp.float32)
    return row


def sample_depth_compare_window(wdepth, base_size, uv, ref):
    """Single bilinear-compare tap from a depth window pack — ONE gather row.
    Accepts the 2x2 pack ([S,S,4], pack_depth_window_u16) or the legacy 4x4
    pack ([S,S,16]; corner set = channels 0,1,4,5).  Used per step of the
    light-shaft march (lighting_pass.glsl:640-650): 4 rows/step -> 1."""
    s = base_size
    wx = 2 if wdepth.shape[-1] == 4 else 4
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0f, y0f = jnp.floor(x), jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    ix = jnp.clip(x0f.astype(jnp.int32), 0, s - 1)
    iy = jnp.clip(y0f.astype(jnp.int32), 0, s - 1)
    fx = jnp.where(x0f < 0, 0.0, fx)
    fy = jnp.where(y0f < 0, 0.0, fy)
    flat = wdepth.reshape(s * s, -1)
    row = _dequant_depth_row(take_rows(flat, iy * s + ix))
    c00 = (ref < row[..., 0]).astype(jnp.float32)
    c10 = (ref < row[..., 1]).astype(jnp.float32)
    c01 = (ref < row[..., wx]).astype(jnp.float32)
    c11 = (ref < row[..., wx + 1]).astype(jnp.float32)
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def sample_catmull_rom_window5(w2tex, base_h, base_w, uv, channels):
    """5-tap Catmull-Rom from a 2x2 window_pack — FIVE 1-row bilinear taps.

    MJP's optimized bicubic drops the 4 corner taps of the 9-bilinear-tap
    formulation and renormalizes (their combined weight (w0+w3)_x*(w0+w3)_y is
    <2% for all fractional positions).  Matches SampleHistoryTextureCatmullRom
    (taa_resolve.glsl:125-174) to within the dropped-corner error.  Library
    sampler; the TAA history resample itself moved on to the YCoCg split
    (shade/taa.py): 2 gather rows per pixel instead of 5."""
    tex_size = jnp.array([base_w, base_h], jnp.float32)
    sample_pos = uv * tex_size
    t1 = jnp.floor(sample_pos - 0.5) + 0.5
    f = sample_pos - t1
    w0 = f * (-0.5 + f * (1.0 - 0.5 * f))
    w1 = 1.0 + f * f * (-2.5 + 1.5 * f)
    w2 = f * (0.5 + f * (2.0 - 1.5 * f))
    w3 = f * f * (-0.5 + 0.5 * f)
    w12 = w1 + w2
    offset12 = w2 / w12
    pos0 = (t1 - 1.0) / tex_size
    pos3 = (t1 + 2.0) / tex_size
    pos12 = (t1 + offset12) / tex_size

    def tap(px, py, wgt):
        p = jnp.stack([px, py], -1)
        return (
            sample_bilinear_window(w2tex, base_h, base_w, p, channels)
            * wgt[..., None]
        )

    out = tap(pos12[..., 0], pos12[..., 1], w12[..., 0] * w12[..., 1])
    out = out + tap(pos0[..., 0], pos12[..., 1], w0[..., 0] * w12[..., 1])
    out = out + tap(pos3[..., 0], pos12[..., 1], w3[..., 0] * w12[..., 1])
    out = out + tap(pos12[..., 0], pos0[..., 1], w12[..., 0] * w0[..., 1])
    out = out + tap(pos12[..., 0], pos3[..., 1], w12[..., 0] * w3[..., 1])
    wsum = (
        w12[..., 0] * w12[..., 1]
        + w0[..., 0] * w12[..., 1]
        + w3[..., 0] * w12[..., 1]
        + w12[..., 0] * w0[..., 1]
        + w12[..., 0] * w3[..., 1]
    )
    return out / wsum[..., None]


def sample_catmull_rom_window_decode(wtex, base_h, base_w, uv, channels,
                                     decode=None):
    """Full 16-texel Catmull-Rom from a 4x4 window pack — ONE gather row —
    with an optional per-texel decode applied BEFORE weighting (for quantized
    packs, where weighting encoded values would distort HDR edges).
    Same math as sample_catmull_rom_window."""
    tex_size = jnp.array([base_w, base_h], jnp.float32)
    sample_pos = uv * tex_size
    t1 = jnp.floor(sample_pos - 0.5)
    f = sample_pos - 0.5 - t1
    w0 = f * (-0.5 + f * (1.0 - 0.5 * f))
    w1 = 1.0 + f * f * (-2.5 + 1.5 * f)
    w2 = f * (0.5 + f * (2.0 - 1.5 * f))
    w3 = f * f * (-0.5 + 0.5 * f)
    wx = [w0[..., 0], w1[..., 0], w2[..., 0], w3[..., 0]]
    wy = [w0[..., 1], w1[..., 1], w2[..., 1], w3[..., 1]]

    t0x = jnp.clip(t1[..., 0].astype(jnp.int32) - 1, 0, base_w - 4)
    t0y = jnp.clip(t1[..., 1].astype(jnp.int32) - 1, 0, base_h - 4)
    flat = wtex.reshape(base_h * base_w, -1)
    row = take_rows(flat, t0y * base_w + t0x)
    if row.dtype != jnp.float32:
        row = row.astype(jnp.float32)
    cc = channels
    out = 0.0
    for i in range(4):
        for j in range(4):
            k = (i * 4 + j) * cc
            v = row[..., k : k + cc]
            if decode is not None:
                v = decode(v)
            out = out + v * (wy[i] * wx[j])[..., None]
    return out


def build_mip_atlas_window(tex, levels=None):
    """Mip atlas whose texels carry their 2x2 bilinear window (4C channels):
    dynamic-LOD material sampling drops from 8 gather rows to 2.  Each level
    is window-packed separately (windows never cross level boundaries);
    windows wrap at level borders (exact for SAMPLER_LINEAR_WRAP tiling)."""
    h, w, c = tex.shape
    levels = levels or n_mip_levels(h, w)
    offs, wa = mip_offsets(h, w, levels)
    atlas = jnp.zeros((h, wa, 4 * c), tex.dtype)
    cur = tex
    for k in range(levels):
        lh, lw = max(1, h >> k), max(1, w >> k)
        atlas = atlas.at[:lh, offs[k] : offs[k] + lw].set(
            window_pack(cur, 2, 2, pad_mode="wrap")
        )
        if k + 1 < levels:
            cur = downsample2x(cur)
    return atlas


def sample_mip_atlas_array_window(atlas, layer, uv, lod, channels, mode="wrap"):
    """Layered dynamic-LOD sampling from a build_mip_atlas_window atlas:
    2 gather rows per sample (vs 8).  Matches sample_mip_atlas_array away
    from level borders in wrap mode."""
    nl, base_h, wa, c4 = atlas.shape
    base_w = base_h
    c = channels
    levels = n_mip_levels(base_h, base_w)
    offs, wa_expect = mip_offsets(base_h, base_w, levels)
    assert wa == wa_expect
    offs_arr = jnp.array(offs, jnp.int32)
    size_arr = jnp.array([max(1, base_h >> k) for k in range(levels)], jnp.int32)

    lod = jnp.clip(jnp.asarray(lod, jnp.float32), 0.0, levels - 1)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, levels - 1)
    fl = (lod - l0.astype(jnp.float32))[..., None]
    flat = atlas.reshape(nl * base_h * wa, c4)

    def level_sample(lv):
        ls = jnp.take(size_arr, lv)
        off = jnp.take(offs_arr, lv)
        x = uv[..., 0] * ls - 0.5
        y = uv[..., 1] * ls - 0.5
        x0f, y0f = jnp.floor(x), jnp.floor(y)
        fx = (x - x0f)[..., None]
        fy = (y - y0f)[..., None]
        if mode == "wrap":
            ix = jnp.mod(x0f.astype(jnp.int32), ls)
            iy = jnp.mod(y0f.astype(jnp.int32), ls)
        else:
            ix = jnp.clip(x0f.astype(jnp.int32), 0, ls - 1)
            iy = jnp.clip(y0f.astype(jnp.int32), 0, ls - 1)
            fx = jnp.where((x0f < 0)[..., None], 0.0, fx)
            fy = jnp.where((y0f < 0)[..., None], 0.0, fy)
        row = take_rows(flat, (layer * base_h + iy) * wa + off + ix)
        t00 = row[..., 0 * c : 1 * c]
        t10 = row[..., 1 * c : 2 * c]
        t01 = row[..., 2 * c : 3 * c]
        t11 = row[..., 3 * c : 4 * c]
        top = t00 + (t10 - t00) * fx
        bot = t01 + (t11 - t01) * fx
        return top + (bot - top) * fy

    s0 = level_sample(l0)
    s1 = level_sample(l1)
    return s0 + (s1 - s0) * fl


def pack_depth_window_u16_4x4_split(depth):
    """[S,S] depth -> TWO u16 tables [S,S,8]: the top half (window rows 0-1)
    and bottom half (rows 2-3) of each texel's 4x4 window.  One PCF
    evaluation = 2 gather rows of 16 B (vs 4 rows of 8 B from the 2x2 pack);
    each table is 67 MB."""
    q = jnp.clip(jnp.round(depth * 65535.0), 0.0, 65535.0).astype(jnp.uint16)
    wp = window_pack(q[..., None], 4, 4)
    return wp[..., 0:8], wp[..., 8:16]


def sample_pcf4_window_split(wa, wb, base_size, uv, ref, offsets):
    """4-tap bilinear PCF from the split 4x4 window pack — TWO gather rows."""
    s = base_size
    p = uv * s - 0.5
    base_x = jnp.clip(jnp.floor(p[..., 0]).astype(jnp.int32) - 1, 0, s - 4)
    base_y = jnp.clip(jnp.floor(p[..., 1]).astype(jnp.int32) - 1, 0, s - 4)
    idx = base_y * s + base_x
    row_a = jnp.take(wa.reshape(s * s, 8), idx, axis=0)
    row_b = jnp.take(wb.reshape(s * s, 8), idx, axis=0)
    row = jnp.concatenate([_dequant_depth_row(row_a),
                           _dequant_depth_row(row_b)], -1)
    return _pcf4_eval(row, base_x, base_y, p, ref, offsets)


def _pcf4_eval(row, base_x, base_y, p, ref, offsets):
    """Shared 4-tap evaluation over a gathered 16-channel 4x4 window row."""
    T = [[row[..., i * 4 + j] for j in range(4)] for i in range(4)]
    cmp = [[(ref < T[i][j]).astype(jnp.float32) for j in range(4)] for i in range(4)]

    vis = 0.0
    for (ox, oy) in offsets:
        tx = p[..., 0] + ox
        ty = p[..., 1] + oy
        x0 = jnp.floor(tx).astype(jnp.int32)
        y0 = jnp.floor(ty).astype(jnp.int32)
        fx = tx - x0.astype(jnp.float32)
        fy = ty - y0.astype(jnp.float32)
        ux = jnp.clip(x0 - base_x, 0, 2)
        uy = jnp.clip(y0 - base_y, 0, 2)

        def pick(dy, dx):
            def col(j):
                return jnp.where(
                    uy == 0, cmp[0 + dy][j],
                    jnp.where(uy == 1, cmp[1 + dy][j], cmp[2 + dy][j]),
                )
            return jnp.where(
                ux == 0, col(0 + dx),
                jnp.where(ux == 1, col(1 + dx), col(2 + dx)),
            )

        c00 = pick(0, 0)
        c10 = pick(0, 1)
        c01 = pick(1, 0)
        c11 = pick(1, 1)
        top = c00 + (c10 - c00) * fx
        bot = c01 + (c11 - c01) * fx
        vis = vis + top + (bot - top) * fy
    return vis / len(offsets)


def sample_pcf4_window(wdepth, base_size, uv, ref, offsets):
    """4-tap bilinear PCF from a 4x4 window_pack — ONE gather row.
    Equivalent to averaging sample_depth_compare over the taps (interior)."""
    s = base_size
    p = uv * s - 0.5
    base_x = jnp.clip(jnp.floor(p[..., 0]).astype(jnp.int32) - 1, 0, s - 4)
    base_y = jnp.clip(jnp.floor(p[..., 1]).astype(jnp.int32) - 1, 0, s - 4)
    flat = wdepth.reshape(s * s, -1)
    row = take_rows(flat, base_y * s + base_x)

    T = [[row[..., i * 4 + j] for j in range(4)] for i in range(4)]
    cmp = [[(ref < T[i][j]).astype(jnp.float32) for j in range(4)] for i in range(4)]

    vis = 0.0
    for (ox, oy) in offsets:
        tx = p[..., 0] + ox
        ty = p[..., 1] + oy
        x0 = jnp.floor(tx).astype(jnp.int32)
        y0 = jnp.floor(ty).astype(jnp.int32)
        fx = tx - x0.astype(jnp.float32)
        fy = ty - y0.astype(jnp.float32)
        ux = jnp.clip(x0 - base_x, 0, 2)
        uy = jnp.clip(y0 - base_y, 0, 2)

        def pick(dy, dx):
            # value of window texel (uy+dy, ux+dx) via a static select chain
            # (a dynamic channel index would lower to a gather again)
            def col(j):
                return jnp.where(
                    uy == 0, cmp[0 + dy][j],
                    jnp.where(uy == 1, cmp[1 + dy][j], cmp[2 + dy][j]),
                )
            return jnp.where(
                ux == 0, col(0 + dx),
                jnp.where(ux == 1, col(1 + dx), col(2 + dx)),
            )

        c00 = pick(0, 0)
        c10 = pick(0, 1)
        c01 = pick(1, 0)
        c11 = pick(1, 1)
        top = c00 + (c10 - c00) * fx
        bot = c01 + (c11 - c01) * fx
        vis = vis + top + (bot - top) * fy
    return vis / len(offsets)


def quad_pack(tex):
    """[H,W,C] -> [H/2, W/2, 4C]; block channel layout (dy*2+dx)*C + c.
    Odd dims are edge-padded."""
    h, w, c = tex.shape
    if h % 2 or w % 2:
        tex = jnp.pad(tex, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
        h, w = tex.shape[:2]
    t = tex.reshape(h // 2, 2, w // 2, 2, c)
    return t.transpose(0, 2, 1, 3, 4).reshape(h // 2, w // 2, 4 * c)


def _quad_window(qtex, base_y, base_x, n_blocks):
    """Fetch an n_blocks x n_blocks block window -> texel grid list
    U[u][v] ([...,C] each) for u,v in [0, 2*n_blocks)."""
    hb, wb, c4 = qtex.shape
    c = c4 // 4
    flat = qtex.reshape(hb * wb, c4)
    rows = {}
    for a in range(n_blocks):
        for b in range(n_blocks):
            iy = jnp.clip(base_y + a, 0, hb - 1)
            ix = jnp.clip(base_x + b, 0, wb - 1)
            rows[(a, b)] = take_rows(flat, iy * wb + ix)
    u_grid = {}
    for a in range(n_blocks):
        for b in range(n_blocks):
            blk = rows[(a, b)]
            for dy in range(2):
                for dx in range(2):
                    u_grid[(2 * a + dy, 2 * b + dx)] = blk[
                        ..., (dy * 2 + dx) * c : (dy * 2 + dx + 1) * c
                    ]
    return u_grid


def _parity_select(u_grid, ry, rx, i, j):
    """Texel (i,j) relative to a dynamic 0/1 parity offset (ry, rx)."""
    a = jnp.where(
        rx[..., None] > 0, u_grid[(i, j + 1)], u_grid[(i, j)]
    )
    b = jnp.where(
        rx[..., None] > 0, u_grid[(i + 1, j + 1)], u_grid[(i + 1, j)]
    )
    return jnp.where(ry[..., None] > 0, b, a)


def sample_catmull_rom_quad(qtex, base_h, base_w, uv):
    """Catmull-Rom resampling from a quad-packed texture: 9 packed rows fetch
    the full 4x4 footprint (vs 36 rows for 9 bilinear taps).  Matches
    sample_catmull_rom away from a 2-texel border (edge clamping differs)."""
    tex_size = jnp.array([base_w, base_h], jnp.float32)
    sample_pos = uv * tex_size
    t1 = jnp.floor(sample_pos - 0.5)
    f = sample_pos - 0.5 - t1
    # per-axis Catmull-Rom weights for taps t0..t3 (t0 = t1 - 1)
    w0 = f * (-0.5 + f * (1.0 - 0.5 * f))
    w1 = 1.0 + f * f * (-2.5 + 1.5 * f)
    w2 = f * (0.5 + f * (2.0 - 1.5 * f))
    w3 = f * f * (-0.5 + 0.5 * f)
    wx = [w0[..., 0], w1[..., 0], w2[..., 0], w3[..., 0]]
    wy = [w0[..., 1], w1[..., 1], w2[..., 1], w3[..., 1]]

    t0x = jnp.clip(t1[..., 0].astype(jnp.int32) - 1, 0, base_w - 4)
    t0y = jnp.clip(t1[..., 1].astype(jnp.int32) - 1, 0, base_h - 4)
    by = t0y // 2
    bx = t0x // 2
    ry = t0y - 2 * by
    rx = t0x - 2 * bx
    u_grid = _quad_window(qtex, by, bx, 3)

    out = 0.0
    for i in range(4):
        for j in range(4):
            t = _parity_select(u_grid, ry, rx, i, j)
            out = out + t * (wy[i] * wx[j])[..., None]
    return out


def sample_pcf4_quad(qdepth, base_size, uv, ref, offsets):
    """4-tap bilinear PCF from a quad-packed depth map: 9 packed rows cover
    the shared 4x4 texel window of all taps (vs 16 scalar-row gathers).

    qdepth [S/2,S/2,4]; uv already includes any per-pixel jitter; offsets are
    the tap centres in texels (lighting_pass.glsl:604-608 rotated grid).
    Equivalent to averaging sample_depth_compare over the taps.
    """
    s = base_size
    p = uv * s - 0.5                       # texel coords of the un-offset tap
    base_x = jnp.clip(jnp.floor(p[..., 0]).astype(jnp.int32) - 1, 0, s - 4)
    base_y = jnp.clip(jnp.floor(p[..., 1]).astype(jnp.int32) - 1, 0, s - 4)
    by = base_y // 2
    bx = base_x // 2
    ry = base_y - 2 * by
    rx = base_x - 2 * bx
    u_grid = _quad_window(qdepth, by, bx, 3)

    # accumulated bilinear weight of each window texel over all taps
    w = [[0.0] * 4 for _ in range(4)]
    for (ox, oy) in offsets:
        tx = p[..., 0] + ox
        ty = p[..., 1] + oy
        x0 = jnp.floor(tx).astype(jnp.int32)
        y0 = jnp.floor(ty).astype(jnp.int32)
        fx = tx - x0.astype(jnp.float32)
        fy = ty - y0.astype(jnp.float32)
        ux = jnp.clip(x0 - base_x, 0, 3)   # clamp guards the clipped bases
        uy = jnp.clip(y0 - base_y, 0, 3)
        for j in range(4):
            hit_x0 = (ux == j).astype(jnp.float32)
            hit_x1 = (ux == j - 1).astype(jnp.float32)
            wxj = hit_x0 * (1.0 - fx) + hit_x1 * fx
            for i in range(4):
                hit_y0 = (uy == i).astype(jnp.float32)
                hit_y1 = (uy == i - 1).astype(jnp.float32)
                wyi = hit_y0 * (1.0 - fy) + hit_y1 * fy
                w[i][j] = w[i][j] + wxj * wyi

    vis = 0.0
    for i in range(4):
        for j in range(4):
            t = _parity_select(u_grid, ry, rx, i, j)[..., 0]
            vis = vis + w[i][j] * (ref < t).astype(jnp.float32)
    return vis / len(offsets)


def pack_mip_atlas(levels_list):
    """Pack an explicit list of mip images (level k shaped ~[H>>k, W>>k, C])
    into one atlas compatible with sample_mip_atlas.  Used to expose the bloom
    downsample chain as the lighting pass's PREV_FRAME_RESULT pyramid
    (render.cpp:862 binds bloom_downscale_rt there)."""
    h, w, c = levels_list[0].shape
    n = len(levels_list)
    offs, wa = mip_offsets(h, w, n)
    atlas = jnp.zeros((h, wa, c), levels_list[0].dtype)
    for k, lv in enumerate(levels_list):
        lh, lw = lv.shape[:2]
        atlas = atlas.at[:lh, offs[k] : offs[k] + lw].set(lv)
    return atlas


def sample_mip_atlas(atlas, base_h, base_w, uv, lod, mode="clamp", levels=None):
    """Trilinear (bilinear + mip lerp) sample from a mip atlas.

    atlas [H,Wa,C] built by build_mip_atlas (full chain) or pack_mip_atlas
    (pass `levels`); uv [...,2]; lod [...] continuous.  Matches textureLod
    semantics for the prev-frame GI reads (lighting_pass.glsl:377).
    """
    levels = levels or n_mip_levels(base_h, base_w)
    offs, _ = mip_offsets(base_h, base_w, levels)
    offs_arr = jnp.array(offs, jnp.int32)
    lh_arr = jnp.array([max(1, base_h >> k) for k in range(levels)], jnp.int32)
    lw_arr = jnp.array([max(1, base_w >> k) for k in range(levels)], jnp.int32)

    lod = jnp.clip(jnp.asarray(lod, jnp.float32), 0.0, levels - 1)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, levels - 1)
    fl = (lod - l0.astype(jnp.float32))[..., None]

    def level_sample(lv):
        lh = jnp.take(lh_arr, lv)
        lw = jnp.take(lw_arr, lv)
        off = jnp.take(offs_arr, lv)
        x = uv[..., 0] * lw - 0.5
        y = uv[..., 1] * lh - 0.5
        x0f, y0f = jnp.floor(x), jnp.floor(y)
        fx = (x - x0f)[..., None]
        fy = (y - y0f)[..., None]
        x0 = x0f.astype(jnp.int32)
        y0 = y0f.astype(jnp.int32)

        def wrapc(i, n):
            if mode == "clamp":
                return jnp.clip(i, 0, n - 1)
            return jnp.mod(i, n)

        def g(iy, ix):
            return _gather2d(atlas, wrapc(iy, lh), off + wrapc(ix, lw))

        t00, t10 = g(y0, x0), g(y0, x0 + 1)
        t01, t11 = g(y0 + 1, x0), g(y0 + 1, x0 + 1)
        top = t00 + (t10 - t00) * fx
        bot = t01 + (t11 - t01) * fx
        return top + (bot - top) * fy

    s0 = level_sample(l0)
    s1 = level_sample(l1)
    return s0 + (s1 - s0) * fl


def sample_mip_atlas_array(atlas, layer, uv, lod, mode="wrap"):
    """Trilinear sample from a *layered* mip atlas — the material texture unit.

    atlas [L,H,Wa,C] (one mip atlas per material layer, see build_mip_atlas),
    layer [...] int32, uv [...,2], lod [...] -> [...,C].  Default wrap
    addressing matches SAMPLER_LINEAR_WRAP used for material textures
    (geometry_pass.glsl:258-263).
    """
    nl, base_h, wa, c = atlas.shape
    base_w = base_h  # square power-of-two material textures only
    levels = n_mip_levels(base_h, base_w)
    offs, wa_expect = mip_offsets(base_h, base_w, levels)
    assert wa == wa_expect, "layered atlas requires square power-of-two textures"
    offs_arr = jnp.array(offs, jnp.int32)
    size_arr = jnp.array([max(1, base_h >> k) for k in range(levels)], jnp.int32)

    lod = jnp.clip(jnp.asarray(lod, jnp.float32), 0.0, levels - 1)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, levels - 1)
    fl = (lod - l0.astype(jnp.float32))[..., None]
    flat = atlas.reshape(nl * base_h * wa, c)

    def level_sample(lv):
        ls = jnp.take(size_arr, lv)
        off = jnp.take(offs_arr, lv)
        x = uv[..., 0] * ls - 0.5
        y = uv[..., 1] * ls - 0.5
        x0f, y0f = jnp.floor(x), jnp.floor(y)
        fx = (x - x0f)[..., None]
        fy = (y - y0f)[..., None]
        x0 = x0f.astype(jnp.int32)
        y0 = y0f.astype(jnp.int32)

        def wrapc(i, n):
            if mode == "clamp":
                return jnp.clip(i, 0, n - 1)
            return jnp.mod(i, n)

        def g(iy, ix):
            iy = wrapc(iy, ls)
            ix = off + wrapc(ix, ls)
            return jnp.take(flat, (layer * base_h + iy) * wa + ix, axis=0)

        t00, t10 = g(y0, x0), g(y0, x0 + 1)
        t01, t11 = g(y0 + 1, x0), g(y0 + 1, x0 + 1)
        top = t00 + (t10 - t00) * fx
        bot = t01 + (t11 - t01) * fx
        return top + (bot - top) * fy

    s0 = level_sample(l0)
    s1 = level_sample(l1)
    return s0 + (s1 - s0) * fl


def build_cube_mip_atlas(faces, levels=None):
    """[6,S,S,C] cubemap -> [6,S,Wa,C] per-face mip atlas (jitted whole —
    eagerly, the per-face/per-level loop dispatches ~100 tiny ops)."""
    import jax

    six, s, _, c = faces.shape
    levels = levels or n_mip_levels(s, s)

    @jax.jit
    def _build(fcs):
        return jnp.stack([build_mip_atlas(fcs[i], levels) for i in range(six)])

    return _build(faces)


def sample_cubemap_level(cube_atlas, base_size, r, level):
    """Bilinear cubemap sample at one STATIC mip level (4 gather rows vs 8+
    for the dynamic-lod trilinear path — use when the lod is a constant,
    e.g. the sky fallback's textureLod(..., 1.) at lighting_pass.glsl:709)."""
    six, s, wa, c = cube_atlas.shape
    levels = n_mip_levels(base_size, base_size)
    level = min(int(level), levels - 1)
    offs, _ = mip_offsets(base_size, base_size, levels)
    ls = max(1, base_size >> level)
    off = offs[level]

    face, uv = cubemap_face_uv_from_dir(r)
    x = uv[..., 0] * ls - 0.5
    y = uv[..., 1] * ls - 0.5
    x0f, y0f = jnp.floor(x), jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    flat = cube_atlas.reshape(6 * s * wa, c)

    def g(iy, ix):
        iy = jnp.clip(iy, 0, ls - 1)
        ix = off + jnp.clip(ix, 0, ls - 1)
        return jnp.take(flat, (face * s + iy) * wa + ix, axis=0)

    t00, t10 = g(y0, x0), g(y0, x0 + 1)
    t01, t11 = g(y0 + 1, x0), g(y0 + 1, x0 + 1)
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def sample_cubemap_lod(cube_atlas, base_size, r, lod):
    """Trilinear cubemap sample with dynamic LOD from a cube mip atlas.

    cube_atlas [6,S,Wa,C]; matches textureLod(samplerCube, dir, lod) for the
    prefiltered env reads (lighting_pass.glsl:699,709).
    """
    six, s, wa, c = cube_atlas.shape
    levels = n_mip_levels(base_size, base_size)
    offs, _ = mip_offsets(base_size, base_size, levels)
    offs_arr = jnp.array(offs, jnp.int32)
    size_arr = jnp.array([max(1, base_size >> k) for k in range(levels)], jnp.int32)

    face, uv = cubemap_face_uv_from_dir(r)
    lod = jnp.clip(jnp.asarray(lod, jnp.float32), 0.0, levels - 1)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, levels - 1)
    fl = (lod - l0.astype(jnp.float32))[..., None]
    flat = cube_atlas.reshape(6 * s * wa, c)

    def level_sample(lv):
        ls = jnp.take(size_arr, lv)
        off = jnp.take(offs_arr, lv)
        x = uv[..., 0] * ls - 0.5
        y = uv[..., 1] * ls - 0.5
        x0f, y0f = jnp.floor(x), jnp.floor(y)
        fx = (x - x0f)[..., None]
        fy = (y - y0f)[..., None]
        x0 = x0f.astype(jnp.int32)
        y0 = y0f.astype(jnp.int32)

        def g(iy, ix):
            iy = jnp.clip(iy, 0, ls - 1)
            ix = off + jnp.clip(ix, 0, ls - 1)
            return jnp.take(flat, (face * s + iy) * wa + ix, axis=0)

        t00, t10 = g(y0, x0), g(y0, x0 + 1)
        t01, t11 = g(y0 + 1, x0), g(y0 + 1, x0 + 1)
        top = t00 + (t10 - t00) * fx
        bot = t01 + (t11 - t01) * fx
        return top + (bot - top) * fy

    s0 = level_sample(l0)
    s1 = level_sample(l1)
    return s0 + (s1 - s0) * fl


# ---------------------------------------------------------------------------
# uint8 quantized material atlases + nearest-mip sampling.
#
# The reference's material textures are 8-bit (BC-compressed DDS / TGA,
# asset_import.cpp + ddspp) sampled by texture units; our f32 window atlas
# paid 192-byte gather rows.  Storing the packed 12-channel texel set as
# uint8 with a per-channel dequantization scale makes the window row 48
# bytes, and
# nearest-mip selection (GL_*_MIPMAP_NEAREST) halves rows again: material
# sampling drops from 2x192B rows to 1x48B per pixel.


def quantize_u8(tex, scale):
    """f32 [..,C] in [0, scale_c] -> uint8 with round-to-nearest."""
    s = jnp.asarray(scale, jnp.float32)
    return jnp.clip(jnp.round(tex / s * 255.0), 0.0, 255.0).astype(jnp.uint8)


def build_mip_atlas_window_u8(tex, scale, levels=None):
    """build_mip_atlas_window with uint8 storage: mips are generated in f32
    (box filter) then each level quantizes by the per-channel `scale`."""
    h, w, c = tex.shape
    levels = levels or n_mip_levels(h, w)
    offs, wa = mip_offsets(h, w, levels)
    atlas = jnp.zeros((h, wa, 4 * c), jnp.uint8)
    cur = tex
    for k in range(levels):
        lh, lw = max(1, h >> k), max(1, w >> k)
        atlas = atlas.at[:lh, offs[k] : offs[k] + lw].set(
            quantize_u8(window_pack(cur, 2, 2, pad_mode="wrap"),
                        jnp.tile(jnp.asarray(scale, jnp.float32), 4))
        )
        if k + 1 < levels:
            cur = downsample2x(cur)
    return atlas


def sample_mip_atlas_array_window_nearest(atlas, layer, uv, lod, channels,
                                          scale=None, mode="wrap"):
    """Bilinear sample at the NEAREST mip level from a layered window atlas —
    ONE gather row per sample (vs 2 for trilinear mip lerp, vs 8 unpacked).

    atlas [L,H,Wa,4C] (uint8 or float); scale [C] dequantization scale for
    uint8 atlases (value = u8/255*scale).  Matches the trilinear sampler to
    within half a mip transition (GL *_MIPMAP_NEAREST semantics).
    """
    nl, base_h, wa, c4 = atlas.shape
    base_w = base_h
    c = channels
    levels = n_mip_levels(base_h, base_w)
    offs, wa_expect = mip_offsets(base_h, base_w, levels)
    assert wa == wa_expect
    offs_arr = jnp.array(offs, jnp.int32)
    size_arr = jnp.array([max(1, base_h >> k) for k in range(levels)], jnp.int32)

    lod = jnp.clip(jnp.asarray(lod, jnp.float32), 0.0, levels - 1)
    lv = jnp.round(lod).astype(jnp.int32)
    flat = atlas.reshape(nl * base_h * wa, c4)

    ls = jnp.take(size_arr, lv)
    off = jnp.take(offs_arr, lv)
    x = uv[..., 0] * ls - 0.5
    y = uv[..., 1] * ls - 0.5
    x0f, y0f = jnp.floor(x), jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    if mode == "wrap":
        ix = jnp.mod(x0f.astype(jnp.int32), ls)
        iy = jnp.mod(y0f.astype(jnp.int32), ls)
    else:
        ix = jnp.clip(x0f.astype(jnp.int32), 0, ls - 1)
        iy = jnp.clip(y0f.astype(jnp.int32), 0, ls - 1)
        fx = jnp.where((x0f < 0)[..., None], 0.0, fx)
        fy = jnp.where((y0f < 0)[..., None], 0.0, fy)
    row = take_rows(flat, (layer * base_h + iy) * wa + off + ix)
    row = row.astype(jnp.float32)
    if scale is not None:
        row = row * (jnp.tile(jnp.asarray(scale, jnp.float32), 4) / 255.0)
    t00 = row[..., 0 * c : 1 * c]
    t10 = row[..., 1 * c : 2 * c]
    t01 = row[..., 2 * c : 3 * c]
    t11 = row[..., 3 * c : 4 * c]
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def sample_mip_atlas_array_window_trilinear(atlas, layer, uv, lod, channels,
                                            scale=None, mode="wrap"):
    """Full trilinear (bilinear x 2 mips + lod lerp) from a layered window
    atlas — TWO gather rows per sample.  The reference's material samplers
    are fixed-function trilinear (gpu_vulkan.c:613-634); the nearest-mip
    variant above is the 1-row economy mode."""
    levels = n_mip_levels(atlas.shape[1], atlas.shape[1])
    lod = jnp.clip(jnp.asarray(lod, jnp.float32), 0.0, levels - 1)
    l0 = jnp.floor(lod)
    fl = (lod - l0)[..., None]
    a = sample_mip_atlas_array_window_nearest(atlas, layer, uv, l0, channels,
                                              scale=scale, mode=mode)
    b = sample_mip_atlas_array_window_nearest(
        atlas, layer, uv, jnp.minimum(l0 + 1.0, levels - 1.0), channels,
        scale=scale, mode=mode)
    return a + (b - a) * fl


# ---------------------------------------------------------------------------
# Window-packed cube mip atlas: 1 gather row per static-level cubemap sample,
# 2 rows for dynamic-LOD trilinear (vs 4 / 8+ from the plain cube atlas).


def build_cube_mip_atlas_window(faces, levels=None, dtype=jnp.float16):
    """[6,S,S,C] cubemap -> [6,S,Wa,4C] per-face window-packed mip atlas.
    Each level is window-packed separately (edge-clamped, matching the
    face-local clamp of sample_cubemap_level).  f16 storage by default —
    the reference's env maps are RGBA16F (render.cpp:564-579)."""
    six, s, _, c = faces.shape
    levels = levels or n_mip_levels(s, s)
    offs, wa = mip_offsets(s, s, levels)
    out = jnp.zeros((six, s, wa, 4 * c), dtype)
    for f in range(six):
        cur = faces[f]
        for k in range(levels):
            ls = max(1, s >> k)
            out = out.at[f, :ls, offs[k] : offs[k] + ls].set(
                window_pack(cur, 2, 2, pad_mode="edge").astype(dtype)
            )
            if k + 1 < levels:
                cur = downsample2x(cur)
    return out


def pack_cube_mip_atlas_window(cube_atlas, base_size, dtype=jnp.float16):
    """Convert an existing cube mip atlas [6,S,Wa,C] (e.g. the prefiltered
    env bake, which has DIFFERENT content per level — not a box chain) into
    the window-packed layout used by the 1-row samplers.  Jitted as a whole:
    the 6*levels python loop is ~100 tiny ops."""
    import jax

    @jax.jit
    def _pack(atlas):
        six, s, wa, c = atlas.shape
        levels = n_mip_levels(base_size, base_size)
        offs, _ = mip_offsets(base_size, base_size, levels)
        out = jnp.zeros((six, s, wa, 4 * c), dtype)
        for f in range(six):
            for k in range(levels):
                ls = max(1, base_size >> k)
                lvl = atlas[f, :ls, offs[k] : offs[k] + ls]
                out = out.at[f, :ls, offs[k] : offs[k] + ls].set(
                    window_pack(lvl, 2, 2, pad_mode="edge").astype(dtype)
                )
        # Store the i32 BITCAST view, not the narrow dtype: take_rows'
        # per-call bitcast of a 16-bit table can make XLA relayout the
        # whole loop-invariant table inside every frame.
        # Baked once here, the samplers gather i32 rows directly and
        # bitcast the 8 gathered values back (free, register-level).
        c4 = 4 * c
        if dtype in (jnp.float16, jnp.uint16) and c4 % 2 == 0:
            return jax.lax.bitcast_convert_type(
                out.reshape(six, s, wa, c4 // 2, 2), jnp.int32)
        return out

    return _pack(cube_atlas)


def _cube_window_level_sample(flat, s, wa, c, face, uv, ls, off):
    """One bilinear sample from a window-packed cube atlas level."""
    x = uv[..., 0] * ls - 0.5
    y = uv[..., 1] * ls - 0.5
    x0f, y0f = jnp.floor(x), jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    ix = jnp.clip(x0f.astype(jnp.int32), 0, ls - 1)
    iy = jnp.clip(y0f.astype(jnp.int32), 0, ls - 1)
    fx = jnp.where((x0f < 0)[..., None], 0.0, fx)
    fy = jnp.where((y0f < 0)[..., None], 0.0, fy)
    row = take_rows(flat, (face * s + iy) * wa + off + ix)
    if row.dtype == jnp.int32:
        # pre-bitcast atlas (pack_cube_mip_atlas_window): decode the i32
        # pairs back to f16 in-register
        row = jax.lax.bitcast_convert_type(row, jnp.float16).reshape(
            row.shape[:-1] + (row.shape[-1] * 2,))
    row = row.astype(jnp.float32)
    t00 = row[..., 0 * c : 1 * c]
    t10 = row[..., 1 * c : 2 * c]
    t01 = row[..., 2 * c : 3 * c]
    t11 = row[..., 3 * c : 4 * c]
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def sample_cubemap_level_window(wcube, base_size, r, level):
    """Bilinear cubemap sample at one STATIC mip level — ONE gather row
    (the sky fallback's textureLod(..., 0.), lighting_pass.glsl:709)."""
    six, s, wa, cl = wcube.shape
    c4 = cl * 2 if wcube.dtype == jnp.int32 else cl  # logical f16 channels
    c = c4 // 4
    levels = n_mip_levels(base_size, base_size)
    level = min(int(level), levels - 1)
    offs, _ = mip_offsets(base_size, base_size, levels)
    face, uv = cubemap_face_uv_from_dir(r)
    flat = wcube.reshape(six * s * wa, cl)
    return _cube_window_level_sample(
        flat, s, wa, c, face, uv, max(1, base_size >> level), offs[level]
    )


def sample_cubemap_lod_window(wcube, base_size, r, lod):
    """Trilinear (bilinear + mip lerp) cubemap sample — TWO gather rows
    (textureLod with dynamic lod, lighting_pass.glsl:699)."""
    six, s, wa, cl = wcube.shape
    c4 = cl * 2 if wcube.dtype == jnp.int32 else cl  # logical f16 channels
    c = c4 // 4
    levels = n_mip_levels(base_size, base_size)
    offs, _ = mip_offsets(base_size, base_size, levels)
    offs_arr = jnp.array(offs, jnp.int32)
    size_arr = jnp.array([max(1, base_size >> k) for k in range(levels)], jnp.int32)
    face, uv = cubemap_face_uv_from_dir(r)
    lod = jnp.clip(jnp.asarray(lod, jnp.float32), 0.0, levels - 1)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, levels - 1)
    fl = (lod - l0.astype(jnp.float32))[..., None]
    flat = wcube.reshape(six * s * wa, cl)
    s0 = _cube_window_level_sample(
        flat, s, wa, c, face, uv, jnp.take(size_arr, l0), jnp.take(offs_arr, l0))
    s1 = _cube_window_level_sample(
        flat, s, wa, c, face, uv, jnp.take(size_arr, l1), jnp.take(offs_arr, l1))
    return s0 + (s1 - s0) * fl
