"""Deferred G-buffer assembly from the visibility buffer.

Replaces the reference's geometry pass fragment shader
(geometry_pass.glsl:255-352).  The rasterizer gives us (depth, tri_id) per
pixel; this pass gathers the 3 vertices of each pixel's triangle, interpolates
attributes with perspective-correct barycentrics, computes **analytic** screen
derivatives (the replacement for dFdx/dFdy), samples the four material
texture arrays with derivative-based mip selection, applies the alpha test and
the derivative-TBN normal mapping (geometry_pass.glsl:284-310), and emits the
same five G-buffer targets as the reference (render.cpp:680-691):
base_color, world normal, ORM, emissive, velocity — plus depth and a coverage
mask (the stand-in for "background pixel").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..gpu import sampling
from ..raster.setup import TriSetup
from ..utils import math3d as m3
from ..utils import noise as noiselib


class GBuffer(NamedTuple):
    base_color: jnp.ndarray   # [H,W,3] linear albedo
    normal: jnp.ndarray       # [H,W,3] world-space, unit (mapped)
    orm: jnp.ndarray          # [H,W,3]
    emissive: jnp.ndarray     # [H,W,3]
    depth: jnp.ndarray        # [H,W] ndc z in [0,1]; 1.0 where empty
    velocity: jnp.ndarray     # [H,W,2] ndc velocity (cur - prev), jitter-free
    coverage: jnp.ndarray     # [H,W] bool


def _f32_to_u16(x):
    n = x.shape[0]
    return jax.lax.bitcast_convert_type(x, jnp.uint16).reshape(n, -1)


def pack_gbuffer_static(scene):
    """Static u16[T,24] half-row: uv0..2 (6 f32 bitcast -> 12 u16 — uv must
    stay exact because its *derivatives* feed mip selection and TBN), nrm0..2
    (9 f16 — renormalized after interpolation, f16 is plenty), mat id + alpha
    flag (f16), pad.  Loop-invariant: XLA hoists it out of frame scans."""
    n = scene.tri_attr.shape[0]
    uv16 = _f32_to_u16(scene.tri_attr[:, 18:24])
    f16part = jnp.concatenate(
        [
            scene.tri_attr[:, 9:18].astype(jnp.float16),
            scene.mat_id.astype(jnp.float16)[:, None],
            scene.tri_alpha.astype(jnp.float16)[:, None],
            jnp.zeros((n, 1), jnp.float16),
        ],
        axis=1,
    )
    return jnp.concatenate(
        [uv16, jax.lax.bitcast_convert_type(f16part, jnp.uint16)], axis=1
    )


def pack_gbuffer_row(setup: TriSetup, scene):
    """Per-triangle u16[T,48] row (96 B): adj (9 f32 bitcast), z_vert (3 f32
    bitcast) + the static half (pack_gbuffer_static).

    ONE gather row per pixel — the merge of two earlier streams (64 B
    per-frame raster row + 96 B f32 tri_attr = 160 B across two gathers).
    c_w is NOT stored: it is
    adj @ ones (raster/setup.py), two VPU adds per pixel.  World position and
    its screen derivatives are not fetched either — they are reconstructed
    from the rasterizer's hi-precision depth by unprojection (gbuffer_pass),
    which z_vert's depth-gradient coefficients make exact."""
    return jnp.concatenate(
        [
            _f32_to_u16(setup.adj.reshape(-1, 9)),
            _f32_to_u16(setup.z_vert),
            pack_gbuffer_static(scene),
        ],
        axis=1,
    )


def _lambda_and_derivs(adj, cw, px, py):
    """Perspective-correct barycentrics + their exact screen-x/y derivatives.

    lambda_j(p) = e_j(p) / W(p) with e_j, W affine in p =>
    d(lambda_j)/dx = (a_jx * W - e_j * W_x) / W^2  (a_jx = x-coefficient).
    This replaces hardware dFdx/dFdy (geometry_pass.glsl:284-287) with exact
    derivatives (no 2x2 quad quantization).  adj [...,3,3] (columns = edges),
    cw [...,3] fetched by the caller.
    """
    p = jnp.stack([px + 0.5, py + 0.5, jnp.ones_like(px)], -1)
    e = jnp.einsum("...ij,...i->...j", adj, p)     # [...,3]
    w = jnp.einsum("...i,...i->...", cw, p)
    w = jnp.where(jnp.abs(w) < 1e-20, 1e-20, w)
    lam = e / w[..., None]
    ex = adj[..., 0, :]                            # x-coeff of each edge fn
    ey = adj[..., 1, :]
    wx = cw[..., 0:1]
    wy = cw[..., 1:2]
    dlam_dx = (ex - lam * wx) / w[..., None]
    dlam_dy = (ey - lam * wy) / w[..., None]
    return lam, dlam_dx, dlam_dy


def _interp(attr_tri, lam):
    """attr_tri [...,3,A] interpolated by lam [...,3] -> [...,A].

    Written as explicit elementwise mul/adds: the einsum form lowers to a
    batched dot_general with a 3-wide contraction, which a matrix unit pads
    and runs at `highest` f32 precision in several passes.
    """
    return (
        attr_tri[..., 0, :] * lam[..., 0:1]
        + attr_tri[..., 1, :] * lam[..., 1:2]
        + attr_tri[..., 2, :] * lam[..., 2:3]
    )


def gbuffer_pass(
    scene,
    setup: TriSetup,
    depth,
    tri_id,
    clip_from_world,
    old_clip_from_world,
    alpha_threshold=0.3,
    row_offset=0,
    world_from_clip=None,
    jitter=None,
    full_size=None,
    material_filter="nearest",
    frame_idx_mod_59=None,
):
    """Assemble the G-buffer.  All inputs are device arrays; fully jit-safe.

    scene: assets.scene.Scene; depth/tri_id: [H,W] from the rasterizer
    (rows starting at global pixel row `row_offset` for the sharded path;
    full_size=(H_full, W) then gives the full framebuffer extent the pixel->
    ndc mapping is relative to).  world_from_clip: inverse of the UNJITTERED
    clip_from_world (computed here if absent); jitter: the TAA ndc jitter the
    rasterizer applied (the unprojection removes it).
    """
    h, w = depth.shape
    fh = full_size[0] if full_size is not None else h
    fw = full_size[1] if full_size is not None else w
    covered = tri_id >= 0
    tid = jnp.maximum(tri_id, 0)
    if world_from_clip is None:
        world_from_clip = jnp.linalg.inv(clip_from_world)

    px = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    py = jnp.broadcast_to(
        jnp.arange(h, dtype=jnp.float32)[:, None] + row_offset, (h, w)
    )

    # ONE gather row per pixel (pack_gbuffer_row), fetched through the i32
    # bitcast view (sampling.take_rows: u16[48] 96B rows gather at the
    # 16-bit-dtype penalty rate; the same bytes as i32[24] go ~30% faster)
    row = sampling.take_rows(
        pack_gbuffer_row(setup, scene).reshape(-1, 48), tid
    )                                              # [H,W,48] u16
    sh = row.shape[:-1]
    adj = jax.lax.bitcast_convert_type(
        row[..., 0:18].reshape(sh + (9, 2)), jnp.float32
    ).reshape(sh + (3, 3))
    z_vert = jax.lax.bitcast_convert_type(
        row[..., 18:24].reshape(sh + (3, 2)), jnp.float32
    )
    uv_tri = jax.lax.bitcast_convert_type(
        row[..., 24:36].reshape(sh + (6, 2)), jnp.float32
    ).reshape(sh + (3, 2))
    f16part = jax.lax.bitcast_convert_type(row[..., 36:47], jnp.float16)
    nrm_tri = f16part[..., 0:9].astype(jnp.float32).reshape(sh + (3, 3))
    mat = f16part[..., 9].astype(jnp.int32)
    do_test = f16part[..., 10].astype(jnp.float32) > 0.5
    cw = jnp.sum(adj, axis=-1)                     # = setup.c_w (adj @ ones)

    lam, dlam_dx, dlam_dy = _lambda_and_derivs(adj, cw, px, py)

    normal_geo = _interp(nrm_tri, lam)
    normal_geo = m3.normalize(normal_geo)
    uv = _interp(uv_tri, lam)

    duv_dx = _interp(uv_tri, dlam_dx)              # exact d(uv)/d(pixel x)
    duv_dy = _interp(uv_tri, dlam_dy)

    # --- world position + derivatives by unprojecting depth ---------------
    # The pixel's unjittered ndc is exact; depth is the rasterizer's
    # hi-precision vertex-interpolated z (raster/setup.py TriSetup) — the
    # unprojected point is the intersection of the pixel ray with the
    # triangle, i.e. the same point the removed 9-column pos_tri fetch
    # interpolated, to depth precision.
    jx = jnp.float32(0.0) if jitter is None else jitter[0]
    jy = jnp.float32(0.0) if jitter is None else jitter[1]
    ndc_x = (px + 0.5) * (2.0 / fw) - 1.0 - jx
    ndc_y = (py + 0.5) * (2.0 / fh) - 1.0 - jy
    # explicit FMA broadcasts — a [H,W,3]@[3,4] dot_general would pad onto a
    # matrix unit at `highest` f32 (see _interp docstring)
    q = (
        world_from_clip[:, 0] * ndc_x[..., None]
        + world_from_clip[:, 1] * ndc_y[..., None]
        + world_from_clip[:, 2] * depth[..., None]
        + world_from_clip[:, 3]
    )
    qw = jnp.where(jnp.abs(q[..., 3:4]) < 1e-20, 1e-20, q[..., 3:4])
    world_pos = q[..., :3] / qw

    # d(z_ndc)/d(pixel): z = z0 + (e1*dz1 + e2*dz2)/S with S = cw . p
    # (the rasterizer's z formula) => quotient rule with the adj x/y coeffs.
    p3 = jnp.stack([px + 0.5, py + 0.5, jnp.ones_like(px)], -1)
    e = jnp.einsum("...ij,...i->...j", adj, p3)
    s_den = jnp.einsum("...i,...i->...", cw, p3)
    s_den = jnp.where(jnp.abs(s_den) < 1e-20, 1e-20, s_den)
    num = e[..., 1] * z_vert[..., 1] + e[..., 2] * z_vert[..., 2]
    dnum_dx = adj[..., 0, 1] * z_vert[..., 1] + adj[..., 0, 2] * z_vert[..., 2]
    dnum_dy = adj[..., 1, 1] * z_vert[..., 1] + adj[..., 1, 2] * z_vert[..., 2]
    dz_dx = (dnum_dx - (num / s_den) * cw[..., 0]) / s_den
    dz_dy = (dnum_dy - (num / s_den) * cw[..., 1]) / s_den

    # d(world)/d(pixel) = d/dx of the projective unproject: with
    # q = M @ (ndc,1), U = q_xyz/q_w and d(ndc)/dx = (2/W, 0, dz/dx):
    def dworld(dndc_x, dndc_y, dndc_z):
        dq = (
            world_from_clip[:, 0] * dndc_x[..., None]
            + world_from_clip[:, 1] * dndc_y[..., None]
            + world_from_clip[:, 2] * dndc_z[..., None]
        )
        return (dq[..., :3] - world_pos * dq[..., 3:4]) / qw

    dpos_dx = dworld(jnp.full_like(px, 2.0 / fw), jnp.zeros_like(px), dz_dx)
    dpos_dy = dworld(jnp.zeros_like(px), jnp.full_like(px, 2.0 / fh), dz_dy)

    # mip level from uv footprint in texels (standard GL lod rule)
    ts = scene.tex_packed.shape[1]
    du = jnp.maximum(
        jnp.sum((duv_dx * ts) ** 2, -1), jnp.sum((duv_dy * ts) ** 2, -1)
    )
    lod = 0.5 * jnp.log2(jnp.maximum(du, 1e-12))
    lod = jnp.clip(lod, 0.0, 16.0)

    # material fetch from the uint8 window atlas.  "trilinear" matches the
    # reference's fixed-function samplers (gpu_vulkan.c:613-634) at TWO
    # 48-byte gather rows per pixel; "stochastic" is the TAA-era shape of the
    # same filter at ONE row: the mip level is dithered by IGN frame noise
    # (round(lod + u - 0.5), u uniform in [0,1)) so the nearest-mip fetch is
    # an UNBIASED estimator of the trilinear lerp — P(level = floor(lod)) =
    # 1 - frac(lod) — and TAA integrates it to the trilinear mean (the same
    # amortization the GI march dithers already lean on): one 48-byte row
    # fetch per pixel instead of trilinear's two.
    # "nearest" (GL *_MIPMAP_NEAREST) is the economy mode.
    if material_filter == "stochastic" and frame_idx_mod_59 is not None:
        u = noiselib.frame_noise(px + 0.5, py + 0.5, frame_idx_mod_59,
                                 offset=(71.0, 13.0))
        texel = sampling.sample_mip_atlas_array_window_nearest(
            scene.tex_packed, mat, uv, lod + (u - 0.5), 12,
            scale=scene.tex_scale,
        )
    else:
        sampler = (sampling.sample_mip_atlas_array_window_trilinear
                   if material_filter == "trilinear"
                   else sampling.sample_mip_atlas_array_window_nearest)
        texel = sampler(scene.tex_packed, mat, uv, lod, 12,
                        scale=scene.tex_scale)
    base_color = texel[..., 0:4]
    nrm_xy = texel[..., 4:6]
    orm = texel[..., 6:9]
    emissive = texel[..., 9:12]

    # alpha test (geometry_pass.glsl:259): discard -> background
    alpha_ok = jnp.where(do_test, base_color[..., 3] >= alpha_threshold, True)
    covered = covered & alpha_ok

    albedo = jnp.power(jnp.maximum(base_color[..., :3], 0.0), 2.2)  # sRGB->linear (glsl:260)

    # --- derivative TBN + normal mapping (geometry_pass.glsl:277-310) -----
    tsn_xy = nrm_xy * 2.0 - 1.0
    tsn_z = jnp.sqrt(jnp.maximum(1.0 - jnp.sum(tsn_xy**2, -1), 0.0))
    n_geo = normal_geo
    handed = duv_dx[..., 0] * duv_dy[..., 1] - duv_dx[..., 1] * duv_dy[..., 0]

    def _ortho(v, n):
        return m3.normalize(v - n * m3.dot(v, n, keepdims=True))

    # branch 1 (mirrored uv): B from texcoord-X
    denorm_b = dpos_dx * duv_dy[..., 0:1] - dpos_dy * duv_dx[..., 0:1]
    b1 = _ortho(denorm_b, n_geo)
    t1 = jnp.cross(b1, n_geo)
    # branch 2: T from texcoord-Y
    denorm_t = dpos_dx * duv_dy[..., 1:2] - dpos_dy * duv_dx[..., 1:2]
    t2 = _ortho(denorm_t, n_geo)
    b2 = jnp.cross(t2, n_geo)
    mirrored = (handed < 0.0)[..., None]
    t_vec = jnp.where(mirrored, t1, t2)
    b_vec = jnp.where(mirrored, b1, b2)
    normal = (
        t_vec * tsn_xy[..., 0:1] + b_vec * tsn_xy[..., 1:2] + n_geo * tsn_z[..., None]
    )
    normal = m3.normalize(normal)
    # degenerate uv derivatives -> fall back to geometric normal
    degenerate = (jnp.abs(handed) < 1e-20)[..., None]
    normal = jnp.where(degenerate, n_geo, normal)

    # --- velocity (geometry_pass.glsl:312): jitter-free ndc motion --------
    ndc_cur, _ = m3.project_points(clip_from_world, world_pos)
    ndc_old, _ = m3.project_points(old_clip_from_world, world_pos)
    velocity = ndc_cur[..., :2] - ndc_old[..., :2]

    cov3 = covered[..., None]
    return GBuffer(
        base_color=jnp.where(cov3, albedo, 0.0),
        normal=jnp.where(cov3, normal, jnp.array([0.0, 0.0, 1.0])),
        orm=jnp.where(cov3, orm, 0.0),
        emissive=jnp.where(cov3, emissive, 0.0),
        depth=jnp.where(covered, depth, 1.0),
        velocity=jnp.where(covered[..., None], velocity, 0.0),
        coverage=covered,
    )
