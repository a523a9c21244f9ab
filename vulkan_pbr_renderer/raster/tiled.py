"""Per-tile visibility kernel (Pallas, Triton route) — the replacement for
the fixed-function rasterizer the reference gets from Vulkan
(gpu_vulkan.c:1680-1872 graphics pipelines).

Consumes the per-tile pair segments from binning.py and writes the
visibility buffer (nearest depth + triangle id per pixel), the same contract
as xla_raster.rasterize_vis but with ~pairs x tile-pixels of work instead of
triangles x pixels.

Kernel anatomy (one program per `tile` x `tile` pixel tile):
* the program reads its own segment [starts[t], starts[t+1]) and the band
  origin y_origin (which may be traced, e.g. lax.axis_index-derived in the
  row-sharded frame) from ordinary operands;
* a fori_loop walks the segment in chunks of `chunk` pairs; inside a chunk
  each pair's 13 coefficients are scalar loads from the column-major [13, P]
  pair rows (uniform addresses: one transaction per warp) and the pair is
  evaluated against the whole tile held in registers.  Indices past the
  segment end clamp to its last pair, which cannot displace itself, so the
  tail needs no mask;
* per pixel only the rational depth (N, D) and the id code ride across
  pairs.  Depth is N/D (N = z0*esum + e1*dz1 + e2*dz2, D = esum for
  vertex-interp rows; N = plane z, D = 1 for w-crossing rows) with the range
  test PRE-division — the scheme of xla_raster.rasterize_vis — and the depth
  test compares rationally (N_a*D_b < N_b*D_a, both D > 0), so the loop
  divides nothing; the one divide per pixel happens at the store.  Products
  stay far from f32 overflow: |N| <= |D| under coverage and |D| = |esum| <~
  1e15, so cross-products <= ~1e30;
* ties: segments hold pairs in ascending triangle id (binning sorts by
  (tile, tri)) and the test is strict, so on exactly equal depth the
  smallest id wins — xla_raster's argmin rule;
* depth and id go straight into the [height, width] images with a masked
  store for partial edge tiles.

There is no per-tile capacity: a segment of any length is walked in full;
only a pair_capacity overrun (total_pairs > pair_capacity) can drop
triangles.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..gpu import device
from .binning import TileBins, bin_triangles
from .setup import TriSetup

NCOL = 13  # binning.pack_tri_data rows
FAR = 3.4e38  # python float: a jnp scalar would be a captured constant


def _tile_kernel(starts_ref, yorg_ref, pairs_ref, depth_ref, id_ref, *,
                 tile, chunk, tiles_x, width, height):
    t = pl.program_id(0)
    y0 = (t // tiles_x) * tile
    x0 = (t % tiles_x) * tile
    start = starts_ref[t]
    end = starts_ref[t + 1]

    rows = jax.lax.broadcasted_iota(jnp.int32, (tile, tile), 0) + y0
    cols = jax.lax.broadcasted_iota(jnp.int32, (tile, tile), 1) + x0
    px = cols.astype(jnp.float32) + 0.5
    py = (rows + yorg_ref[0]).astype(jnp.float32) + 0.5

    def eval_pair(j, acc):
        acc_n, acc_d, acc_enc = acc
        c = [pairs_ref[k, j] for k in range(NCOL)]
        e0 = c[0] * px + c[1] * py + c[2]
        e1 = c[3] * px + c[4] * py + c[5]
        e2 = c[6] * px + c[7] * py + c[8]
        esum = e0 + e1 + e2
        em = jnp.minimum(jnp.minimum(e0, e1), e2)
        zx, zy, zc, enc = c[9], c[10], c[11], c[12]
        vert = enc > 0.0  # + = vertex-interp depth, - = screen-linear plane
        n_sel = jnp.where(vert, zx * esum + (e1 * zy + e2 * zc),
                          zx * px + zy * py + zc)
        d_sel = jnp.where(vert, esum, 1.0)
        take = ((em >= 0.0) & (esum > 0.0)
                & (n_sel >= 0.0) & (n_sel <= d_sel)
                & (n_sel * acc_d < acc_n * d_sel))
        return (jnp.where(take, n_sel, acc_n), jnp.where(take, d_sel, acc_d),
                jnp.where(take, enc, acc_enc))

    def chunk_body(i, acc):
        base = start + i * chunk
        for k in range(chunk):
            acc = eval_pair(jnp.minimum(base + k, end - 1), acc)
        return acc

    full = functools.partial(jnp.full, (tile, tile))
    # empty pixel: depth FAR/1, id code 0 (decodes to -1)
    acc = (full(FAR, jnp.float32), full(1.0, jnp.float32),
           full(0.0, jnp.float32))
    n_chunks = (end - start + chunk - 1) // chunk
    acc_n, acc_d, acc_enc = jax.lax.fori_loop(0, n_chunks, chunk_body, acc)

    hit = acc_enc != 0.0
    mask = (rows < height) & (cols < width)
    win = (pl.ds(y0, tile), pl.ds(x0, tile))
    plt.store(depth_ref.at[win], jnp.where(hit, acc_n / acc_d, jnp.inf),
              mask=mask)
    plt.store(id_ref.at[win], jnp.abs(acc_enc).astype(jnp.int32) - 1,
              mask=mask)


def rasterize_tiled(setup: TriSetup, width, height, tile=32,
                    pair_capacity=None, y_origin=0, **kernel_kw):
    """Tiled rasterization of rows [y_origin, y_origin+height).

    Returns (depth [H,W] f32 — +inf empty, tri_id [H,W] i32 — -1 empty,
    total_pairs i32 scalar).  total_pairs > pair_capacity means binning
    dropped pairs this call (Renderer.check_overflow surfaces it).
    kernel_kw go to raster_bins.
    """
    bins = bin_triangles(setup, width, height, tile, pair_capacity,
                         y_origin=y_origin)
    depth, tri = raster_bins(bins, width, height, tile, y_origin=y_origin,
                             **kernel_kw)
    return depth, tri, bins.total_pairs


def raster_bins(bins: TileBins, width, height, tile, y_origin=0, chunk=4,
                num_warps=4, num_stages=2, interpret=None):
    """The visibility kernel over binned pairs (binning.bin_triangles with
    the same width, height, tile and y_origin).  Returns (depth, tri_id)."""
    if interpret is None:
        interpret = device.pallas_interpret()
    tiles_x, tiles_y = -(-width // tile), -(-height // tile)
    kernel = functools.partial(
        _tile_kernel, tile=tile, chunk=chunk, tiles_x=tiles_x,
        width=width, height=height,
    )
    return pl.pallas_call(
        kernel,
        grid=(tiles_y * tiles_x,),
        out_shape=[
            jax.ShapeDtypeStruct((height, width), jnp.float32),
            jax.ShapeDtypeStruct((height, width), jnp.int32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=num_stages),
        interpret=interpret,
        name="raster_tiles",
    )(bins.starts, jnp.asarray(y_origin, jnp.int32).reshape(1),
      bins.pair_data)
