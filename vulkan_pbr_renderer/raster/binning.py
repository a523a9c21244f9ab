"""Tile binning: exact per-tile triangle lists, built gather-free.

The reference's rasterizer gets binning for free from fixed-function hardware;
here it is built from data-parallel primitives with **static shapes**, and
with no per-pair gather of triangle attributes except the final one:

1. per-triangle tile-bbox spans -> pair counts (ntx*nty), exclusive cumsum
2. stream expansion by scatter + cummax forward-fill: each triangle scatters
   a *monotone* packed value at its pair-run start; cummax fills the run.
   The fills carry (run start offset | ntx) and (tri id | base_tile), so the
   per-pair tile id is pure dense arithmetic.
3. one i32 sort of (tile << tri_bits) | tri — the low bits both keep the
   per-tile order stable (ascending triangle id) AND recover the triangle id
   without a gather.
4. per-tile start offsets via a tiny searchsorted (n_tiles+1 queries); the
   packed coefficients are gathered once into PAIR order.  The kernel
   (raster/tiled.py) consumes each tile's segment [starts[t], starts[t+1]).

Pair layout [13, P] f32, column-major so that each coefficient of a run of
pairs is contiguous: rows 0-8 edge functions, 9-11 depth (vertex-interp
(z0,dz1,dz2) or the screen-linear plane), 12 = ±(id+1) with the sign carrying
the depth mode (+ = vertex-interp, − = plane).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .setup import TriSetup


class TileBins(NamedTuple):
    pair_data: jnp.ndarray   # [13, P] f32 pair-ordered coefficient rows
    starts: jnp.ndarray      # [T+1] i32 pair-array segment starts per tile
    tiles_x: int
    tiles_y: int
    total_pairs: jnp.ndarray  # i32 scalar: true pair count before clipping
                              # to pair_capacity (scatter drops the excess)


def pack_tri_data(setup: TriSetup):
    """[13, N] f32: rows 0-8 edges, 9-11 depth, 12 = ±(id+1) with the sign
    carrying z_mode (+ = vertex-interp depth, − = screen-linear plane).  The
    id is exact in f32 (< 2^24 triangles).

    Invalid triangles get e0 = -1 constant so the coverage test always fails.
    """
    n = setup.adj.shape[0]
    e = jnp.transpose(setup.adj, (0, 2, 1)).reshape(n, 9)
    dead = jnp.tile(
        jnp.array([0, 0, -1, 0, 0, 1, 0, 0, 1], jnp.float32), (n, 1)
    )
    e = jnp.where(setup.valid[:, None], e, dead)
    z = jnp.where(setup.z_mode[:, None], setup.z_vert, setup.c_z)
    ids1 = jnp.arange(1, n + 1, dtype=jnp.float32)
    enc = jnp.where(setup.z_mode, ids1, -ids1)[:, None]
    return jnp.concatenate([e, z, enc], axis=1).T


def _fill(scatter_idx, values, capacity):
    """Scatter `values` (must be monotone over the scatter order) at
    scatter_idx into a length-`capacity` array, then cummax-forward-fill."""
    arr = jnp.full((capacity,), -1, jnp.int32)
    arr = arr.at[scatter_idx].max(values)
    return jax.lax.cummax(arr)


def bin_triangles(
    setup: TriSetup,
    width,
    height,
    tile=32,
    pair_capacity=None,
    y_origin=0,
) -> TileBins:
    """Bin triangles into square `tile`-pixel tiles.  height counts rows
    starting at pixel row `y_origin` (sub-viewport binning for the
    row-sharded multi-card path, parallel/sharding.py); y_origin may be
    traced."""
    n = setup.adj.shape[0]
    tiles_x = -(-width // tile)
    tiles_y = -(-height // tile)
    n_tiles = tiles_x * tiles_y
    if pair_capacity is None:
        pair_capacity = 4 * n

    bbox = setup.bbox
    valid = setup.valid
    by0 = bbox[:, 1] - y_origin
    by1 = bbox[:, 3] - y_origin
    valid = valid & (by1 > 0) & (by0 < height)
    tx0 = jnp.clip(bbox[:, 0] // tile, 0, tiles_x - 1)
    ty0 = jnp.clip(by0 // tile, 0, tiles_y - 1)
    tx1 = jnp.clip((bbox[:, 2] - 1) // tile, 0, tiles_x - 1)
    ty1 = jnp.clip((by1 - 1) // tile, 0, tiles_y - 1)
    ntx = jnp.where(valid, tx1 - tx0 + 1, 0).astype(jnp.int32)
    nty = jnp.where(valid, ty1 - ty0 + 1, 0).astype(jnp.int32)
    counts = ntx * nty
    offsets = jnp.cumsum(counts) - counts
    total = offsets[-1] + counts[-1]

    tri_ids32 = jnp.arange(n, dtype=jnp.int32)
    scatter_idx = jnp.where(counts > 0, offsets, pair_capacity)  # OOB drops
    base_tile = (ty0 * tiles_x + tx0).astype(jnp.int32)

    tile_bits = max(1, int(n_tiles).bit_length())  # holds values <= n_tiles
    span_bits = 8
    # ntx is clamped to span_max below, so a screen wider than 255 tiles
    # would silently drop the rightmost tile columns of full-width triangles:
    # fail loudly instead.  255 tiles = 8160px at 32px tiles.
    assert tiles_x <= (1 << span_bits) - 1, (
        f"screen {width}px = {tiles_x} tile columns exceeds the {span_bits}-bit "
        "binning span; raise span_bits in binning.py"
    )
    tri_bits = max(1, int(n - 1).bit_length())
    half_bits = (tile_bits + 1) // 2
    # packed fill values must stay positive int32 (tri in the high bits keeps
    # them monotone over the scatter order)
    assert (n << max(span_bits, half_bits)) <= (1 << 31) and n < (
        1 << 24
    ), "triangle count too large for packed binning keys"
    assert pair_capacity < (1 << (31 - span_bits)), (
        "pair_capacity too large for the packed (run_start | ntx) fill"
    )

    # Monotone forward-fills — 2 scatter+cummax passes in the common case
    # (each pass is a full scatter + scan over the pair buffer, so fills are
    # packed to the int32 bit limit):
    #   * (run_start | ntx): run_start strictly increases between runs (every
    #     run has >= 1 pair), so the packed value stays monotone over the
    #     scatter order with ntx in the low bits — one fill carries both
    #   * (tri | base_tile): tri id rides the high bits — ALSO recovered from
    #     here (>> tile_bits), so no dedicated tri fill; when
    #     tri_bits+tile_bits exceeds int31 (e.g. the 4096-tile sun map at
    #     >512k tris) base_tile splits into two half-width fills and tri
    #     rides the first
    span_max = (1 << span_bits) - 1
    rs_packed = jnp.maximum(
        _fill(
            scatter_idx, (offsets << span_bits) | jnp.minimum(ntx, span_max),
            pair_capacity,
        ),
        0,
    )
    run_start = rs_packed >> span_bits
    ntx_fill = rs_packed & span_max
    if tri_bits + tile_bits <= 31:
        base_packed = _fill(
            scatter_idx, (tri_ids32 << tile_bits) | base_tile, pair_capacity
        )
        base_fill = base_packed & ((1 << tile_bits) - 1)
        tri_of = jnp.clip(base_packed >> tile_bits, 0, n - 1)
    else:
        half_max = (1 << half_bits) - 1
        lo_packed = _fill(
            scatter_idx, (tri_ids32 << half_bits) | (base_tile & half_max),
            pair_capacity,
        )
        base_lo = lo_packed & half_max
        tri_of = jnp.clip(lo_packed >> half_bits, 0, n - 1)
        base_hi = _fill(
            scatter_idx, (tri_ids32 << half_bits) | (base_tile >> half_bits),
            pair_capacity,
        ) & half_max
        base_fill = (base_hi << half_bits) | base_lo

    p = jnp.arange(pair_capacity, dtype=jnp.int32)
    in_range = p < total
    m = p - run_start
    ntx_p = jnp.maximum(ntx_fill, 1)
    pair_tile = base_fill + (m // ntx_p) * tiles_x + (m % ntx_p)
    pair_tile = jnp.where(in_range, pair_tile, n_tiles)  # overflow sorts last

    # sort pairs by (tile, tri) — the low key bits recover the triangle id
    # gather-free.  One packed key when the bits fit, else a two-key sort.
    if tile_bits + tri_bits <= 31:
        key = (pair_tile << tri_bits) | tri_of
        skey = jax.lax.sort(key)
        sort_tile = skey >> tri_bits
        sort_tri = skey & ((1 << tri_bits) - 1)
    else:
        sort_tile, sort_tri = jax.lax.sort((pair_tile, tri_of), num_keys=2)

    # per-tile segment starts into the sorted pair array
    tile_range = jnp.arange(n_tiles + 1, dtype=jnp.int32)
    starts = jnp.searchsorted(sort_tile, tile_range, side="left").astype(jnp.int32)

    # pair-ordered packed data — the single gather of the pipeline.  Pairs
    # past total_pairs sort behind the last tile's segment and are never read.
    return TileBins(
        pair_data=pack_tri_data(setup)[:, sort_tri],
        starts=starts,
        tiles_x=tiles_x,
        tiles_y=tiles_y,
        total_pairs=total,
    )
