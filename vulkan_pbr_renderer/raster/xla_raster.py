"""Reference rasterizer in pure XLA (no Pallas) — brute force, O(pixels x tris).

This is the semantic baseline: the tile kernel (tiled.py) must match it.  It
is also the production path for *small* scenes (Renderer picks it up to 4096
triangles, e.g. the triangle demo, triangle.cpp parity): the scan below is
dense elementwise math, but it tests every triangle against every pixel.

Output is a **visibility buffer**: per-pixel nearest-depth + triangle id
(-1 = background).  Attribute interpolation happens in the deferred G-buffer
pass (shade/gbuffer.py) — the replacement for the reference's
fragment-shader varyings (geometry_pass.glsl:101-123).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .setup import TriSetup

BG_TRI = jnp.int32(-1)
FAR_DEPTH = jnp.float32(jnp.inf)


def rasterize_vis(setup: TriSetup, width, height, tri_chunk=256, y_origin=0):
    """Brute-force depth-tested rasterization of all triangles over rows
    [y_origin, y_origin+height).

    Returns (depth [H,W] f32 — +inf where empty, tri_id [H,W] i32 — -1 empty).
    Depth test: less (GPU_REVERSE_DEPTH disabled in the reference).
    """
    # the scan body materializes [tri_chunk, H, W] temporaries — cap the chunk
    # so peak memory stays ~1 GB even for a 2048^2 shadow viewport
    tri_chunk = max(8, min(tri_chunk, (1 << 26) // max(1, height * width)))
    n = setup.adj.shape[0]
    pad = (-n) % tri_chunk
    if pad:
        padz = lambda a: jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], 0)
        setup = TriSetup(
            adj=padz(setup.adj),
            c_w=padz(setup.c_w),
            c_z=padz(setup.c_z),
            z_vert=padz(setup.z_vert),
            z_mode=jnp.concatenate([setup.z_mode, jnp.zeros((pad,), bool)], 0),
            det=padz(setup.det),
            bbox=padz(setup.bbox),
            valid=jnp.concatenate([setup.valid, jnp.zeros((pad,), bool)], 0),
        )
        n += pad
    n_chunks = n // tri_chunk

    px = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1) + 0.5
    py = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0) + 0.5 + y_origin
    p = jnp.stack([px, py, jnp.ones_like(px)], axis=-1)  # [H,W,3]

    adj = setup.adj.reshape(n_chunks, tri_chunk, 3, 3)
    c_z = setup.c_z.reshape(n_chunks, tri_chunk, 3)
    z_vert = setup.z_vert.reshape(n_chunks, tri_chunk, 3)
    z_mode = setup.z_mode.reshape(n_chunks, tri_chunk)
    valid = setup.valid.reshape(n_chunks, tri_chunk)

    def body(carry, chunk):
        best_z, best_id = carry
        adj_c, cz_c, zv_c, zm_c, valid_c, base_id = chunk
        # e [T,H,W,3]: edge values for every tri at every pixel
        e = jnp.einsum("tij,hwi->thwj", adj_c, p)
        w_num = jnp.sum(e, axis=-1)                       # [T,H,W]
        z_plane = jnp.einsum("ti,hwi->thw", cz_c, p)      # screen-linear z_ndc
        # high-precision depth as ONE rational N/D: N = z0*sum(e) + e1*dz1 +
        # e2*dz2, D = sum(e).  Same value as z0 + (e1*dz1 + e2*dz2)/sum(e) to
        # ~ulp, but phrased so the Pallas kernel can DEFER the division and
        # depth-test rationally (N_a*D_b < N_b*D_a) — this file must use the
        # exact same op order so pallas-vs-xla parity stays bitwise.
        num = (e[..., 1] * zv_c[:, 1, None, None]
               + e[..., 2] * zv_c[:, 2, None, None])
        n_hp = zv_c[:, 0, None, None] * w_num + num
        vert = zm_c[:, None, None]
        n_sel = jnp.where(vert, n_hp, z_plane)
        d_sel = jnp.where(vert, w_num, 1.0)
        covered = jnp.all(e >= 0.0, axis=-1) & (w_num > 0.0) & valid_c[:, None, None]
        # depth range test PRE-division (n in [0, d]; d > 0 under coverage) —
        # bitwise the test the kernel applies to its rational accumulators
        covered &= (n_sel >= 0.0) & (n_sel <= d_sel)
        z = n_sel / jnp.where(d_sel == 0, 1e-20, d_sel)
        z = jnp.where(covered, z, FAR_DEPTH)
        # nearest among this chunk
        zmin = jnp.min(z, axis=0)
        arg = jnp.argmin(z, axis=0).astype(jnp.int32) + base_id
        take = zmin < best_z
        return (jnp.where(take, zmin, best_z), jnp.where(take, arg, best_id)), None

    init = (
        jnp.full((height, width), FAR_DEPTH, jnp.float32),
        jnp.full((height, width), BG_TRI, jnp.int32),
    )
    base_ids = jnp.arange(n_chunks, dtype=jnp.int32) * tri_chunk
    (depth, tri_id), _ = jax.lax.scan(
        body, init, (adj, c_z, z_vert, z_mode, valid, base_ids)
    )
    return depth, tri_id
