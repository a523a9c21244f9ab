"""Dynamic voxel-grid global illumination.

A JAX re-design of the reference's three GI stages:

1. **Voxelize** (lightgrid_voxelize.glsl): the reference conservative-rasterizes
   triangles along their dominant axis and imageStores sun-lit radiance into a
   128^3 RGBA grid.  Scatter-raster does not map onto XLA; instead we
   **point-sample triangle surfaces** (area-proportional low-discrepancy
   samples) and scatter radiance with jnp scatters — the pass only runs on
   frame 0 / sun changes (render.cpp:1024), so it is off the frame hot path.

2. **Sweep** (lightgrid_sweep.glsl): per-axis bidirectional "moving light"
   propagation.  The per-voxel update is a first-order linear recurrence
   L[i] = a[i]*L[i-1] + b[i], so the 128-step sequential loop becomes a
   log-depth `jax.lax.associative_scan` over the grid axis — the SP-analogue
   noted in SURVEY.md §5.

3. **Radiance marches** (lighting_pass.glsl:236-424): bounded masked
   fori_loops over the grid with the hybrid screen-space trace; early breaks
   become per-lane masks (the marches are dense array programs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..gpu import sampling
from ..utils import color as colorlib
from ..utils import math3d as m3

# (An all-lane early-exit while loop was tried and removed: at 2M dense
# lanes some ray always consumes the full step budget, so the exit never
# fires early enough to pay for its per-iteration all-lane reduce.)

# ---------------------------------------------------------------------------
# 2. Lightgrid sweep


def _sweep_linrec(values, occupied, rad, skylight, move_ratio, reverse):
    """One directional sweep: returns (new_values_rgb, final moving light).

    Recurrence per step (empty voxel): L_out = mr*(v + L_in), v' = (1-mr)/mr*L_out;
    occupied voxel: L_out = rad, v' = v.  Seed L = skylight.
    """
    axis = 0  # caller moves the swept axis to the front
    a = jnp.where(occupied[..., None], 0.0, move_ratio)
    b = jnp.where(occupied[..., None], rad, move_ratio * values)

    def combine(f1, f2):
        a1, b1 = f1
        a2, b2 = f2
        return a1 * a2, a2 * b1 + b2

    A, B = jax.lax.associative_scan(combine, (a, b), axis=axis, reverse=reverse)
    L = A * skylight + B  # L[i] after processing voxel i
    new_vals = jnp.where(occupied[..., None], values, (1.0 - move_ratio) / move_ratio * L)
    # boundary: the final moving light is added to the last processed voxel
    if reverse:
        new_vals = new_vals.at[0].add(L[0])
    else:
        new_vals = new_vals.at[-1].add(L[-1])
    return new_vals


def sweep_lightgrid(grid, axis, skylight=(1.0, 1.2, 2.0), move_ratio=0.5, blend=0.35):
    """One frame's sweep along `axis` (0=z,1=y,2=x of the [D,H,W,4] grid).

    Forward then backward scans using the ORIGINAL occupancy/radiance
    (lightgrid_sweep.glsl:25-67), then blend 35% into empty voxels only.
    """
    sky = jnp.asarray(skylight, grid.dtype)
    g = jnp.moveaxis(grid, axis, 0)
    old_rgb = g[..., :3]
    alpha = g[..., 3]
    occupied = alpha > 0.5

    fwd = _sweep_linrec(old_rgb, occupied, old_rgb, sky, move_ratio, reverse=False)
    bwd = _sweep_linrec(fwd, occupied, old_rgb, sky, move_ratio, reverse=True)

    mixed = old_rgb + (bwd - old_rgb) * blend
    new_rgb = jnp.where(occupied[..., None], old_rgb, mixed)
    out = jnp.concatenate([new_rgb, alpha[..., None]], -1)
    return jnp.moveaxis(out, 0, axis)


# ---------------------------------------------------------------------------
# 1. Voxelization by surface point sampling


def voxelize_sample_capacity(scene, grid_size, lightgrid_scale,
                             samples_per_voxel_area=4.0, cap=1 << 20,
                             align=1024):
    """Host-side (numpy) exact sizing of voxelize_scene's sample stream.

    The stream capacity is a STATIC shape; the historical fixed 1<<20 meant
    every tiny test scene paid a 1M-lane gather/scatter voxelize (and its
    compile-time constant folding).  The true sample count is a pure function
    of the static scene + grid config, so compute it once at Renderer init
    and right-size the stream.  Returns a multiple of `align` (the sharded
    path needs total_samples % shard_count == 0), capped at `cap` (the
    historical limit, so bench-scale behavior is unchanged).  Any capacity
    >= the true total yields BIT-IDENTICAL samples — positions depend only on
    each sample's index within its triangle's run."""
    import numpy as np

    ta = np.asarray(scene.tri_attr[:, :9], np.float32)
    p0, p1, p2 = ta[:, 0:3], ta[:, 3:6], ta[:, 6:9]
    n = np.cross(p1 - p0, p2 - p0)
    area = 0.5 * np.linalg.norm(n, axis=-1)
    voxel_size = 2.0 / (grid_size * lightgrid_scale)
    counts = np.ceil(area / (voxel_size * voxel_size)
                     * samples_per_voxel_area).astype(np.int64)
    total = int(np.clip(counts, 1, cap).sum())
    return int(min(-(-total // align) * align, cap))


def voxelize_scene(
    scene,
    grid_size,
    lightgrid_scale,
    sun_depth,
    sun_space_from_world,
    sun_dir,
    sun_emission,
    samples_per_voxel_area=4.0,
    total_samples=1 << 20,
    texture_lod=4.0,
    sample_offset=0,
    shard_idx=None,
    shard_count=1,
):
    """Build the [D,D,D,4] radiance grid from sun-lit surface samples.

    Per-sample radiance matches lightgrid_voxelize.glsl:100-129: emissive +
    shadow * base_color * LdotN * sun_emission, 1-tap PCF with z-bias 0.001,
    alpha = 1.  Point density is proportional to triangle area in voxel units.

    Multi-chip: pass (shard_idx, shard_count) to process only samples
    [shard_idx*S, (shard_idx+1)*S) of the SAME sample stream (S = total/count).
    The per-shard partial grids combine with an elementwise max (scatter-max is
    order-independent), so pmax over shards reproduces the single-chip grid
    EXACTLY — the parity contract tested in tests/test_parallel.py.

    Gather diet: triangle corners/uvs come from the static
    scene.tri_attr rows (dense slices — tri_attr[:, :9] IS positions[indices]
    bit-identically), and all per-sample triangle data is packed into ONE
    [T,19] row so the sample stream does a single gather instead of eight
    separate ones; the row is f16 (38 B — position error ~0.02 world units
    against 0.625-unit voxels).

    Returns the grid PACKED as [D,D,D] uint32 — one luminance-keyed scatter
    word per sample (see _pack_voxel_sample) instead of four f32 channels,
    a quarter of the scatter-max traffic per sun change.
    Decode with decode_voxel_grid.  The sharded path pmax-combines the PACKED
    partials (u32 max is associative and total on the packed order), which
    keeps shard-count-invariant exactness (tests/test_parallel.py).
    """
    tri_attr = scene.tri_attr                       # [T,24]
    p0 = tri_attr[:, 0:3]
    e1 = tri_attr[:, 3:6] - p0
    e2 = tri_attr[:, 6:9] - p0
    n = jnp.cross(e1, e2)
    area = 0.5 * jnp.linalg.norm(n, axis=-1)
    tri_normal = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    voxel_size = 2.0 / (grid_size * lightgrid_scale)
    area_vox = area / (voxel_size * voxel_size)
    counts = jnp.ceil(area_vox * samples_per_voxel_area).astype(jnp.int32)
    counts = jnp.clip(counts, 1, total_samples)
    offsets = jnp.cumsum(counts) - counts           # exclusive
    total = offsets[-1] + counts[-1]

    # stream expansion by scatter + cummax (searchsorted costs O(P log N)
    # gathers — see raster/binning.py for the pattern)
    n_tris = counts.shape[0]
    tri_ids = jnp.arange(n_tris, dtype=jnp.int32)
    if shard_count > 1:
        # Sharded fills: each shard builds tri_of/run_start
        # for ITS [start, start+s_len) slice only — O(total/sp) cummax work
        # instead of the full-stream fill every shard used to run.  Runs
        # whose start falls inside the slice scatter locally; the run already
        # in flight at `start` is the CARRY-IN triangle = (#offsets <= start)
        # - 1 (a dense O(T) reduction — counts are all >= 1 so offsets is
        # strictly increasing and every offset is a live run start), seeded
        # at local position 0.  Values are bit-identical to slicing the
        # full-stream fills (tests/test_parallel.py shard-invariance).
        assert total_samples % shard_count == 0
        s_len = total_samples // shard_count
        start = jnp.asarray(shard_idx, jnp.int32) * s_len
        pid = start + jnp.arange(s_len, dtype=jnp.int32)
        loc = offsets - start
        scat_l = jnp.where((loc >= 0) & (loc < s_len), loc, s_len)
        carry_tri = jnp.sum((offsets <= start).astype(jnp.int32)) - 1
        tri_sc = jnp.full((s_len,), -1, jnp.int32).at[scat_l].max(tri_ids)
        tri_sc = tri_sc.at[0].max(carry_tri)
        tri_of = jnp.clip(jax.lax.cummax(tri_sc), 0, n_tris - 1)
        rs_sc = jnp.full((s_len,), -1, jnp.int32).at[scat_l].max(offsets)
        rs_sc = rs_sc.at[0].max(offsets[carry_tri])
        run_start = jnp.maximum(jax.lax.cummax(rs_sc), 0)
    else:
        pid = jnp.arange(total_samples, dtype=jnp.int32)
        scat = jnp.where(counts > 0, offsets, total_samples)
        arr = jnp.full((total_samples,), -1, jnp.int32)
        tri_of = jnp.clip(jax.lax.cummax(arr.at[scat].max(tri_ids)),
                          0, n_tris - 1)
        run_start = jnp.maximum(
            jax.lax.cummax(
                jnp.full((total_samples,), -1, jnp.int32).at[scat].max(offsets)
            ),
            0,
        )
    local = pid - run_start
    in_range = pid < total

    # low-discrepancy barycentric points (R2 sequence folded into the triangle)
    phase = jnp.asarray(sample_offset, jnp.float32)
    r = jnp.stack(
        [
            jnp.mod(local.astype(jnp.float32) * 0.7548776662466927 + 0.13 + phase * 0.371, 1.0),
            jnp.mod(local.astype(jnp.float32) * 0.5698402909980532 + 0.29 + phase * 0.613, 1.0),
        ],
        -1,
    )
    flip = (r[:, 0] + r[:, 1]) > 1.0
    r = jnp.where(flip[:, None], 1.0 - r, r)

    # ONE per-sample gather row: p0(3) e1(3) e2(3) uv0(2) duv1(2) duv2(2)
    # normal(3) mat(1) — 19 f16.  (uv cols 18:24 of tri_attr == uvs[indices].)
    uv0 = tri_attr[:, 18:20]
    packrow = jnp.concatenate(
        [
            p0, e1, e2,
            uv0,
            tri_attr[:, 20:22] - uv0,
            tri_attr[:, 22:24] - uv0,
            tri_normal,
            scene.mat_id.astype(jnp.float32)[:, None],
        ],
        axis=1,
    ).astype(jnp.float16)                           # [T,19]
    row = packrow[tri_of].astype(jnp.float32)       # [S,19] — THE gather
    pos = row[:, 0:3] + r[:, 0:1] * row[:, 3:6] + r[:, 1:2] * row[:, 6:9]
    uv = row[:, 9:11] + r[:, 0:1] * row[:, 11:13] + r[:, 1:2] * row[:, 13:15]
    sample_normal = row[:, 15:18]
    mat = row[:, 18].astype(jnp.int32)

    lod = jnp.full(pid.shape, texture_lod, jnp.float32)
    texel = sampling.sample_mip_atlas_array_window_nearest(
        scene.tex_packed, mat, uv, lod, 12, scale=scene.tex_scale
    )
    base_color = texel[..., 0:3]
    emissive = texel[..., 9:12]

    # 1-tap shadow with (+1,+1) texel offset and z bias (voxelize glsl:104-110)
    # through the u16 2x2 window pack: ONE 8-byte gather row per sample vs the
    # raw-depth bilinear compare's four scalar gathers; u16 quantization is far
    # below the 1e-3 z bias (pack_depth_window_u16 rationale)
    p_sun = m3.transform_points(sun_space_from_world, pos)[..., :3]
    uv_sun = p_sun[..., :2] * 0.5 + 0.5 + 1.0 / sun_depth.shape[0]
    wdepth = sampling.pack_depth_window_u16(sun_depth)
    shadow = sampling.sample_depth_compare_window(
        wdepth, sun_depth.shape[0], uv_sun, p_sun[..., 2] - 0.001)

    l = -sun_dir
    ldotn = jnp.maximum(jnp.sum(sample_normal * l, -1), 0.0)
    radiance = emissive + (shadow * ldotn)[..., None] * base_color * jnp.asarray(
        sun_emission, jnp.float32
    )

    uvw = pos * lightgrid_scale * 0.5 + 0.5
    coord = jnp.floor(uvw * grid_size).astype(jnp.int32)
    inside = jnp.all((coord >= 0) & (coord < grid_size), axis=-1) & in_range
    # grid layout [D(z), H(y), W(x)]
    iz, iy, ix = coord[:, 2], coord[:, 1], coord[:, 0]
    flat_idx = jnp.where(inside, (iz * grid_size + iy) * grid_size + ix, 0)
    packed = jnp.where(inside, _pack_voxel_sample(radiance), jnp.uint32(0))

    grid = jnp.zeros((grid_size * grid_size * grid_size,), jnp.uint32)
    grid = grid.at[flat_idx].max(packed)
    return grid.reshape(grid_size, grid_size, grid_size)


def _pack_voxel_sample(rgb):
    """radiance [...,3] -> one u32 scatter word: luma key (8b, x/(1+x)) in
    the high bits, then sqrt-compressed rgb (8b each — the SAME transform
    pack_grid_u8 later stores, so packing here loses nothing downstream).
    Scatter-max on the word keeps the brightest-luminance sample per voxel
    (the f32 predecessor kept a per-CHANNEL max — visually equivalent for
    emitters, 1/4 the scatter traffic).  Occupancy: any in-range sample packs
    to >= 1, so word != 0 <=> alpha 1."""
    lum = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])
    key = jnp.clip(jnp.round(lum / (1.0 + lum) * 255.0), 0.0, 255.0)
    c = jnp.sqrt(jnp.maximum(rgb, 0.0) / (1.0 + jnp.maximum(rgb, 0.0)))
    q = jnp.clip(jnp.round(c * 255.0), 0.0, 254.0)
    word = (
        key.astype(jnp.uint32) * jnp.uint32(1 << 24)
        + q[..., 0].astype(jnp.uint32) * jnp.uint32(1 << 16)
        + q[..., 1].astype(jnp.uint32) * jnp.uint32(1 << 8)
        + q[..., 2].astype(jnp.uint32)
    )
    return jnp.maximum(word, jnp.uint32(1))


def decode_voxel_grid(packed):
    """[D,D,D] u32 (voxelize_scene) -> [D,D,D,4] f32 radiance + occupancy."""
    q = jnp.stack(
        [
            (packed >> 16) & jnp.uint32(0xFF),
            (packed >> 8) & jnp.uint32(0xFF),
            packed & jnp.uint32(0xFF),
        ],
        -1,
    ).astype(jnp.float32) * (1.0 / 255.0)
    c2 = q * q
    rgb = c2 / jnp.maximum(1.0 - c2, 1.0 / 256.0)
    alpha = (packed != 0).astype(jnp.float32)[..., None]
    return jnp.concatenate([rgb * alpha, alpha], -1)


def pack_grid_u8(grid):
    """[D,H,W,4] radiance grid -> 2x2x2-window pack stored uint8 [D,H,W,32].

    rgb is stored per-channel range-compressed, c = sqrt(x/(1+x)) (invertible,
    steps are finer where radiance is darker); alpha is stored raw (the sweep
    only writes 0/1).  Why u8: the f16 window pack of the 128^3 grid is
    134 MB; the u8 pack is 67 MB and decompression is two elementwise ops.
    Quantization error ~2% of radiance at x=1 — invisible in GI."""
    rgb = jnp.maximum(grid[..., :3], 0.0)
    c = jnp.sqrt(rgb / (1.0 + rgb))
    q = jnp.concatenate([c, grid[..., 3:4]], -1)
    q8 = jnp.clip(jnp.round(q * 255.0), 0.0, 254.0).astype(jnp.uint8)
    p = jnp.pad(q8, ((0, 1), (0, 1), (0, 1), (0, 0)), mode="edge")
    d, h, w = grid.shape[:3]
    return jnp.concatenate(
        [
            p[dz : dz + d, dy : dy + h, dx : dx + w]
            for dz in range(2)
            for dy in range(2)
            for dx in range(2)
        ],
        axis=-1,
    )


def pack_grid_alpha_u16(grid):
    """[D,H,W,4] grid -> alpha-only 2x2x2-window pack, uint16 [D,H,W,8].

    The fast-GI blockage skip needs ONLY alpha: 16-byte u16 rows instead of
    the 32-byte u8 rgb pack's.  Alpha is quantized
    exactly like pack_grid_u8's alpha channel (round*255, clip 254), so the
    skip's open/blocked decisions are bit-identical to sampling the rgb pack.
    """
    a = jnp.clip(jnp.round(grid[..., 3:4] * 255.0), 0.0, 254.0).astype(jnp.uint16)
    p = jnp.pad(a, ((0, 1), (0, 1), (0, 1), (0, 0)), mode="edge")
    d, h, w = grid.shape[:3]
    return jnp.concatenate(
        [
            p[dz : dz + d, dy : dy + h, dx : dx + w]
            for dz in range(2)
            for dy in range(2)
            for dx in range(2)
        ],
        axis=-1,
    )


def pack_grid_f16_nearest(grid):
    """[D,H,W,4] radiance grid -> f16 rgba for NEAREST-sampled marches.

    8-byte rows vs the trilinear u8[32] window pack's 32, and the table is
    16.8 MB at 128^3.  Nearest sampling is exact for alpha (the sweep writes 0/1) and
    the swept radiance is smooth enough that the march's noise dither + TAA
    integrate away the voxel banding trilinear would hide (measured SSIM
    delta in docs/tune_gi 'fog' variants)."""
    return grid.astype(jnp.float16)


def _sample_nearest_grid(fgrid, ro):
    """One 8-byte rgba row at grid-NDC ro (uvw = ro*0.5+0.5), nearest voxel."""
    d, h, w = fgrid.shape[:3]
    uvw = ro * 0.5 + 0.5
    iz = jnp.clip((uvw[..., 2] * d).astype(jnp.int32), 0, d - 1)
    iy = jnp.clip((uvw[..., 1] * h).astype(jnp.int32), 0, h - 1)
    ix = jnp.clip((uvw[..., 0] * w).astype(jnp.int32), 0, w - 1)
    return fgrid[iz, iy, ix].astype(jnp.float32)


def sample_radiance_fog(fgrid, ro_world, rd_unit, lightgrid_scale,
                        skip_steps=4, open_thresh=0.3, march_steps=8,
                        hit_thresh=0.3, step_scale=1.0, foggyness=0.5,
                        noise=None, trilinear_grid=None, jitter_scale=1.0,
                        unroll=1):
    """Reference-structured fast GI: the EXACT phase A + phase C march of
    SampleRadianceWithScreenSpaceTrace (lighting_pass.glsl:280-288, 399-423)
    on an 8-byte nearest-sampled rgba grid (pack_grid_f16_nearest).

    Phase A skips initial blockage (alpha < open_thresh ends the skip),
    seeding the sum with the first open voxel's radiance (glsl:288).  Phase C
    then fog-marches: each open voxel folds into the exponential average
    sum = sum*foggyness + (rgb, 1) (glsl:409-418); a voxel with alpha >
    hit_thresh stops the lane.  noise jitters the march start by one sub-step
    (glsl:399) so quantized stops dither and TAA integrates them smooth.

    vs sample_radiance_march (the wave-9 path): that marched 16-byte
    TRILINEAR alpha rows and reconstructed the fog average from 3 quantile
    rgb rows of the 32-byte u8 pack; this pays ~the same row count of
    narrower rows AND reproduces the reference's accumulation exactly
    instead of approximating it.  foggyness may be a scalar or a
    per-lane array (the reference uses roughness for the specular ray).

    trilinear_grid (a pack_grid_u8 window table): sample it trilinearly
    instead of the nearest fgrid rows — 32-byte u8 rows vs 8-byte f16
    (diagnostic: quantifies the nearest-sampling
    darkening bias — tone compression is concave, so the higher-variance
    nearest samples average darker after TAA).

    Returns (rgb, ro_open, ro_stop, hit, found) in sample_radiance_march's
    contract so the screen-probe wiring is shared."""
    gsize = fgrid.shape[0]
    voxel = 2.0 / gsize
    rd = rd_unit * voxel
    ro = ro_world * lightgrid_scale
    fetch = (_sample_nearest_grid if trilinear_grid is None
             else lambda _g, p: grid_sample(trilinear_grid, p))

    found0 = jnp.zeros(ro.shape[:-1], bool)

    def body_skip(i, carry):
        ro_c, found, seed = carry
        ro_n = jnp.where(found[..., None], ro_c, ro_c + rd)
        s = fetch(fgrid, ro_n)
        newly = (~found) & (s[..., 3] < open_thresh)
        seed = jnp.where(newly[..., None], s[..., :3], seed)
        return ro_n, found | newly, seed

    seed0 = jnp.zeros(ro.shape[:-1] + (3,), jnp.float32)
    carry = (ro, found0, seed0)
    if skip_steps <= 4:
        for i in range(skip_steps):
            carry = body_skip(i, carry)
    else:
        carry = jax.lax.fori_loop(0, skip_steps, body_skip, carry,
                                  unroll=min(unroll, skip_steps))
    ro_open, found, seed = carry

    # phase C: sum seeded with (first-open rgb, 1) (glsl:288 -> 399)
    sum0 = jnp.concatenate(
        [seed, found[..., None].astype(jnp.float32)], -1
    ).at[..., 3].add(1e-4)
    rdm = rd * step_scale
    # jitter_scale=2 matches the reference exactly: it jitters by the
    # PRE-halving step (ro += rd*noise, then marches 0.5*rd steps,
    # lighting_pass.glsl:399-407) — twice our march step
    ro_m0 = (ro_open if noise is None
             else ro_open + rdm * (jitter_scale * noise[..., None]))
    fog = (foggyness[..., None] if jnp.ndim(foggyness) else
           jnp.asarray(foggyness, jnp.float32))
    hit0 = jnp.zeros(ro.shape[:-1], bool)

    def body_fog(i, carry):
        ro_c, sum_c, hit = carry
        live = found & ~hit
        ro_n = jnp.where(live[..., None], ro_c + rdm, ro_c)
        s = fetch(fgrid, ro_n)
        hits = s[..., 3] > hit_thresh
        open_live = live & ~hits
        add = jnp.concatenate([s[..., :3], jnp.ones_like(s[..., 3:])], -1)
        sum_n = jnp.where(open_live[..., None], sum_c * fog + add, sum_c)
        return ro_n, sum_n, hit | (hits & live)

    carry = (ro_m0, sum0, hit0)
    if march_steps <= 8:
        for i in range(march_steps):
            carry = body_fog(i, carry)
    else:
        carry = jax.lax.fori_loop(0, march_steps, body_fog, carry,
                                  unroll=min(unroll, march_steps))
    ro_stop, sum4, hit = carry

    rgb = _tone(sum4)
    rgb = jnp.where(found[..., None], rgb, 0.0)
    return rgb, ro_open, ro_stop, hit & found, found


def _sample_alpha_u16(agrid, ro):
    """Trilinear alpha at grid-NDC ro from a pack_grid_alpha_u16 table."""
    return sampling.sample_trilinear_window(
        agrid, ro * 0.5 + 0.5, 1,
        decode=lambda v: v * (1.0 / 255.0),
    )[..., 0]


def _decode_grid_u8(v):
    """Per-corner decode for pack_grid_u8 rows: u8 -> raw radiance + alpha.
    Runs BEFORE the trilinear lerp — interpolating in the compressed space
    would badly underestimate radiance between bright and dark voxels
    (midpoint of x=0 and x=6 would decode to 0.27 instead of 3.0)."""
    s = v * (1.0 / 255.0)
    c2 = s[..., :3] * s[..., :3]
    rgb = c2 / jnp.maximum(1.0 - c2, 1.0 / 256.0)
    return jnp.concatenate([rgb, s[..., 3:]], -1)


def _decode_grid_u16pair(v):
    """Per-corner decode for the u16-BITCAST view of pack_grid_u8 rows.
    v [...,2] holds (r | g<<8, b | a<<8) as exact f32 integers; the byte
    split is exact float math (values < 2^16), so the result is BIT-IDENTICAL
    to _decode_grid_u8 on the original u8 row."""
    hi0 = jnp.floor(v[..., 0] * (1.0 / 256.0))
    hi1 = jnp.floor(v[..., 1] * (1.0 / 256.0))
    q = jnp.stack(
        [v[..., 0] - hi0 * 256.0, hi0, v[..., 1] - hi1 * 256.0], -1
    )
    s = q * (1.0 / 255.0)
    c2 = s * s
    rgb = c2 / jnp.maximum(1.0 - c2, 1.0 / 256.0)
    return jnp.concatenate([rgb, hi1[..., None] * (1.0 / 255.0)], -1)


def _gs_uvw(vol, uvw):
    """Trilinear fetch accepting a raw [D,H,W,4] grid or a window-packed
    [D,H,W,32] one (pack_grid_u8 / sampling.window_pack3d — ONE gather row).

    uint8 packs are gathered through a u16 BITCAST view (the same 32 bytes
    as u16[16] words instead of narrow u8 elements); the per-corner byte
    split is exact f32 math, so results are bit-identical to the u8 path."""
    if vol.shape[-1] == 32:
        if vol.dtype == jnp.uint8:
            d, h, w, _ = vol.shape
            v16 = jax.lax.bitcast_convert_type(
                vol.reshape(d, h, w, 16, 2), jnp.uint16
            )
            return sampling.sample_trilinear_window(
                v16, uvw, 2, decode=_decode_grid_u16pair
            )
        return sampling.sample_trilinear_window(vol, uvw, 4)
    return sampling.sample_trilinear_3d(vol, uvw)


def grid_sample(grid, ro_grid):
    """Trilinear lightgrid fetch at grid-NDC position ro (uvw = ro*0.5+0.5)."""
    return _gs_uvw(grid, ro_grid * 0.5 + 0.5)


# ---------------------------------------------------------------------------
# 3. Radiance marches


def _skip_blockage(grid, ro, rd, steps, open_thresh, alpha_grid=None):
    """Advance until the first non-solid voxel (glsl:243-251 / 280-288).

    Returns (ro_after, sum4) where sum4 accumulates (rgb,1) of the first open
    sample; sum4.a stays ~0 if no opening was found.

    With alpha_grid (pack_grid_alpha_u16): the march reads the 16-byte
    alpha-only rows (~2x the gather rate of the rgb pack) and ONE rgb row is
    fetched at the stop position afterwards — the stop position equals the
    first-open sample point (ro freezes on found), and the alpha quantization
    matches the rgb pack exactly, so the result is identical to the rgb-row
    march.
    """
    sum0 = jnp.zeros(ro.shape[:-1] + (4,), ro.dtype).at[..., 3].set(1e-4)
    found0 = jnp.zeros(ro.shape[:-1], bool)

    if alpha_grid is not None:
        def body_a(i, carry):
            ro_c, found = carry
            ro_n = jnp.where(found[..., None], ro_c, ro_c + rd)
            a = _sample_alpha_u16(alpha_grid, ro_n)
            return ro_n, found | (a < open_thresh)

        carry = (ro, found0)
        if steps <= 4:
            for i in range(steps):
                carry = body_a(i, carry)
        else:
            carry = jax.lax.fori_loop(0, steps, body_a, carry)
        ro_f, found = carry
        s = grid_sample(grid, ro_f)
        sum4 = jnp.concatenate(
            [
                jnp.where(found[..., None], s[..., :3], 0.0),
                1e-4 + found[..., None].astype(ro.dtype),
            ],
            -1,
        )
        return ro_f, sum4, found

    def body(i, carry):
        ro_c, sum_c, found = carry
        ro_n = jnp.where(found[..., None], ro_c, ro_c + rd)
        s = grid_sample(grid, ro_n)
        newly = (~found) & (s[..., 3] < open_thresh)
        add = jnp.concatenate([s[..., :3], jnp.ones_like(s[..., 3:])], -1)
        sum_n = sum_c + jnp.where(newly[..., None], add, 0.0)
        return ro_n, sum_n, found | newly

    carry = (ro, sum0, found0)
    if steps <= 4:  # unrolled: skips XLA while-loop overhead on the hot path
        for i in range(steps):
            carry = body(i, carry)
        return carry
    return jax.lax.fori_loop(0, steps, body, carry)


def _voxel_march(grid, ro, rd, sum4, num_steps, foggyness, accumulate_fog):
    """March until hitting a voxel with alpha > 0.3 (glsl:257-265 / 409-418).

    Deliberately a PLAIN fori_loop: unrolling it (and the parity trace loop)
    grew the reference-mode compile ~4x for no runtime win on an earlier
    platform; on the GPU the trade is not measured."""

    def body(i, carry):
        ro_c, sum_c, stopped = carry
        ro_n = jnp.where(stopped[..., None], ro_c, ro_c + rd)
        s = grid_sample(grid, ro_n)
        hit = s[..., 3] > 0.3
        live = ~stopped & ~hit
        add = jnp.concatenate([s[..., :3], jnp.ones_like(s[..., 3:])], -1)
        if accumulate_fog:
            sum_n = jnp.where(live[..., None], sum_c * foggyness + add, sum_c)
        else:
            sum_n = sum_c + jnp.where(live[..., None], add, 0.0)
        return ro_n, sum_n, stopped | hit

    stopped0 = jnp.zeros(ro.shape[:-1], bool)
    _, sum4, _ = jax.lax.fori_loop(0, num_steps, body, (ro, sum4, stopped0))
    return sum4


def _tone(sum4):
    """sum/=w then luminance-sqrt compression (glsl:267-270)."""
    mean = sum4[..., :3] / jnp.maximum(sum4[..., 3:4], 1e-4)
    return colorlib.tone_compress_sqrt(mean)


def sample_radiance_fast(grid, ro_world, rd_unit, lightgrid_scale,
                         dist_voxels=2.5, skip_steps=4, open_thresh=0.3,
                         n_samples=1, sample_spread=3.5, alpha_grid=None):
    """Irradiance-cache GI: the swept lightgrid already holds propagated
    radiance in every empty voxel (sweep_lightgrid), so instead of the
    reference's ~40-step hybrid march we take one tone-compressed trilinear
    sample a couple of voxels along the ray, after a blockage skip matching
    the reference's phase A (4 steps at open threshold 0.3,
    lighting_pass.glsl:280-288 — the round-2 2-step/0.5 variant left thick
    shadowed geometry black where the skip gave up, SSIM 0.85 vs reference).
    ~10x fewer gathers than sample_radiance_with_screen_trace; the fast
    default (config.gi_mode='fast'); 'reference' keeps the full march."""
    gsize = grid.shape[0]
    voxel_scale = 2.0 / gsize
    rd = rd_unit * voxel_scale
    ro = ro_world * lightgrid_scale

    ro, sum4, found = _skip_blockage(grid, ro, rd, steps=skip_steps,
                                     open_thresh=open_thresh,
                                     alpha_grid=alpha_grid)
    # seed with the first-open voxel's radiance — the march seeds its sum
    # with phase A's sample too (glsl:288 -> 399), and near-emitter voxels
    # carry the warm glow the far samples miss (round-2 A/B diff)
    acc_rgb = sum4[..., :3]
    acc_w = jnp.minimum(sum4[..., 3:4], 1.0)
    trans = 1.0
    for k in range(max(1, n_samples)):
        s = grid_sample(grid, ro + rd * (dist_voxels - 2.0 + k * sample_spread))
        open_k = jnp.clip((0.5 - s[..., 3:4]) * 4.0, 0.0, 1.0)
        acc_rgb = acc_rgb + trans * open_k * s[..., :3]
        acc_w = acc_w + trans * open_k
        trans = trans * open_k     # occluders attenuate farther samples
    rgb = colorlib.tone_compress_sqrt(acc_rgb / jnp.maximum(acc_w, 1e-4))
    blocked = sum4[..., 3:4] < 0.5
    return jnp.where(blocked, 0.0, rgb * jnp.minimum(acc_w, 1.0)), ro


def sample_radiance_march(grid, alpha_grid, ro_world, rd_unit, lightgrid_scale,
                          skip_steps=3, open_thresh=0.3, hit_steps=6,
                          hit_thresh=0.3, step_scale=1.0, noise=None,
                          rgb_samples=2):
    """March-structured fast GI.

    The round-2 fast path (sample_radiance_fast: fixed-distance quadrature of
    the swept grid) plateaued at SSIM ~0.87 vs the reference march at steady
    state — BELOW what removing whole terms from the reference costs
    (docs/tune_gi ablations: screen-resolve off 0.947, fog march off 0.952).
    The march's structure is what matters, so this reproduces it on the cheap
    16-byte alpha rows:

      phase A  skip initial blockage  (skip_steps alpha rows; glsl:280-288)
      phase B  march to the next blocked voxel — the reference phase C's
               termination (lighting_pass.glsl:409-418) — at step_scale-sized
               steps (hit_steps alpha rows)
      phase C  the fog march's exponential average (foggyness 0.5 => recent
               open samples dominate: weights 1, 0.5, 0.25, ... back from the
               stop) is reconstructed from `rgb_samples` rgb rows placed at
               EMA-quantile distances behind the stop, plus the first-open
               seed (weight ~fog^1.5, which dominates when the ray stops
               immediately).

    noise ([...] in [0,1], the per-pixel frame noise the reference feeds the
    march, lighting_pass.glsl:399) jitters the march start by one sub-step —
    quantized stop positions dither and TAA integrates them to the reference's
    smooth gradients; without it the stops band at step_scale granularity.

    Cost per ray at the defaults: (skip_steps + hit_steps) 16-byte alpha rows
    + rgb_samples+1 rgb rows, vs the reference's (4 + num_steps) 32-byte rgb
    rows + the 24-step screen trace.  Returns (rgb, ro_open, ro_stop, hit,
    open_found); [ro0, ro_open] is the segment the reference's screen trace
    covers (screen_probe_multi probes its interior).
    """
    gsize = grid.shape[0]
    voxel = 2.0 / gsize
    rd = rd_unit * voxel
    ro = ro_world * lightgrid_scale

    found0 = jnp.zeros(ro.shape[:-1], bool)

    def body_skip(i, carry):
        ro_c, found = carry
        ro_n = jnp.where(found[..., None], ro_c, ro_c + rd)
        a = _sample_alpha_u16(alpha_grid, ro_n)
        return ro_n, found | (a < open_thresh)

    carry = (ro, found0)
    for i in range(skip_steps):
        carry = body_skip(i, carry)
    ro_open, found = carry

    rdm = rd * step_scale
    hit0 = jnp.zeros(ro.shape[:-1], bool)
    ro_m0 = ro_open if noise is None else ro_open + rdm * noise[..., None]

    def body_hit(i, carry):
        ro_c, hit = carry
        ro_n = jnp.where((hit | ~found)[..., None], ro_c, ro_c + rdm)
        a = _sample_alpha_u16(alpha_grid, ro_n)
        return ro_n, hit | (a > hit_thresh)

    carry = (ro_m0, hit0)
    if hit_steps <= 8:
        for i in range(hit_steps):
            carry = body_hit(i, carry)
    else:
        carry = jax.lax.fori_loop(0, hit_steps, body_hit, carry)
    ro_stop, hit = carry

    # EMA reconstruction: sample k quantiles of the fog weighting behind the
    # stop (weights halve per step; 1 / 2.5 / 5 steps back carry ~1/.45/.15),
    # each soft-gated by its own openness so a stop-at-step-1 doesn't average
    # in wall, plus the first-open seed.
    dists = [1.0, 2.5, 5.0][: max(1, rgb_samples)]
    wgts = [1.0, 0.45, 0.15][: max(1, rgb_samples)]
    s0 = grid_sample(grid, ro_open)
    o0 = jnp.clip((0.5 - s0[..., 3:4]) * 4.0, 0.0, 1.0)
    w0 = 0.35
    acc = w0 * o0 * s0[..., :3]
    den = w0 * o0
    for d, wk in zip(dists, wgts):
        sk = grid_sample(grid, ro_stop - rdm * d)
        ok = jnp.clip((0.5 - sk[..., 3:4]) * 4.0, 0.0, 1.0)
        acc = acc + wk * ok * sk[..., :3]
        den = den + wk * ok
    mean = acc / jnp.maximum(den, 1e-4)
    rgb = colorlib.tone_compress_sqrt(mean)
    rgb = jnp.where(found[..., None], rgb, 0.0)
    return rgb, ro_open, ro_stop, hit & found, found


def march_to_hit(alpha_grid, ro, rd, steps, thresh=0.3):
    """March the 16-byte alpha table until alpha > thresh; returns
    (ro_at_hit — frozen on hit, hit mask).

    The fidelity fix: the screen probe was projecting
    the ray's FIRST-OPEN point, which for specular rays crossing open space
    sits a couple of voxels from the surface — not the far geometry the
    reference's hybrid march resolves to (lighting_pass.glsl:315-384).
    Marching the cheap alpha rows to the next BLOCKED voxel gives the probe
    the actual reflected target, which carries the warm emitter reflections
    the pillars were missing (the biggest term of the 0.90-SSIM residual).
    """
    hit0 = jnp.zeros(ro.shape[:-1], bool)

    def body(i, carry):
        ro_c, hit = carry
        ro_n = jnp.where(hit[..., None], ro_c, ro_c + rd)
        a = _sample_alpha_u16(alpha_grid, ro_n)
        return ro_n, hit | (a > thresh)

    carry = (ro, hit0)
    if steps <= 4:
        for i in range(steps):
            carry = body(i, carry)
        return carry
    return jax.lax.fori_loop(0, steps, body, carry)


def screen_probe_multi(ro_grid_ndc, open_grid_ndc, lightgrid_scale,
                       clip_from_world, depth_tex, wprev, prev_hw,
                       ss_intensity, z_margin=2e-4, k_points=3,
                       prev_levels=0, dist_mip=0.0, want_offscreen=False,
                       solid_taps=0, alpha_grid=None, world_from_clip=None,
                       noise=None, spacing_gamma=1.0, point_jitter=0.0,
                       spacing_growth=0.0):
    """K-point screen probe: test k/K points along the surface->first-open
    segment (the reference march's trajectory, lighting_pass.glsl:315-384)
    and resolve the prev frame at the FIRST one behind visible geometry.

    Single-point probing (screen_probe) misses rays that dip behind geometry
    mid-path — exactly the near-emitter bounces that dominate the fast-vs-
    reference residual (lamp halos, docs/tune_gi.py region diffs).  Each extra
    point costs ONE depth row (the [H,W] f32 depth table is ~8 MB — the fast
    end of the gather-rate curve); the prev-frame row is fetched once at the
    selected uv.  Returns (hit mask, rgb[, first_offscreen]).

    dist_mip > 0 (with prev_levels set): wprev is the window pack of the
    WHOLE prev pyramid atlas and the resolve level grows with the world-space
    distance to the resolved probe — the reference samples PREV_FRAME_RESULT
    at textureLod mip min(step_length*5, 5) (lighting_pass.glsl:377), so far
    resolves are a soft wide average (the pillar-forest glow) rather than a
    sharp half-res tap.  level = clip(round(dist_world * dist_mip), 0, L-1).
    want_offscreen: also return the mask of rays whose FIRST probe leaving
    the screen precedes any hit — the reference falls back to a near-surface
    lightgrid sample there (glsl:324-331) instead of continuing."""
    from ..utils import math3d as m3

    d = ro_grid_ndc
    seg = open_grid_ndc - ro_grid_ndc
    seg_world = jnp.linalg.norm(seg, axis=-1) / jnp.maximum(lightgrid_scale,
                                                            1e-8)
    best_hit = jnp.zeros(d.shape[:-1], bool)
    first_off = jnp.zeros(d.shape[:-1], bool)
    best_uv = jnp.zeros(d.shape[:-1] + (2,), jnp.float32)
    best_t = jnp.zeros(d.shape[:-1], jnp.float32)
    for k in range(1, k_points + 1):
        # Probe-point schedules.  The reference trace's step starts at
        # ~z_view/100 and grows 1.2x per step (glsl:301, 333-334): its test
        # density is GEOMETRIC — centimeter-dense at the surface (it never
        # straddles a thin bright emitter like the altar slab) yet still
        # covering the whole segment.  spacing_growth=g replicates that:
        # frac_k = (g^k - 1)/(g^K - 1).  spacing_gamma is the power-law
        # alternative (distorts mid-range coverage; measured weaker).
        # point_jitter noise-dithers each fraction by +-jitter/K: the
        # reference's trace start is noise-scaled ((1+noise), glsl:301), so
        # its hit boundaries are soft and TAA-integrated — deterministic
        # probes give hard boundaries TAA cannot dither.
        if spacing_growth > 1.0:
            frac = (spacing_growth ** k - 1.0) / (
                spacing_growth ** k_points - 1.0)
        else:
            frac = (k / k_points) ** spacing_gamma
        if point_jitter > 0.0 and noise is not None:
            frac = jnp.clip(
                frac + (noise - 0.5) * (point_jitter / k_points), 0.0, 1.0
            )
        p = ro_grid_ndc + seg * (frac[..., None] if jnp.ndim(frac) else frac)
        p4 = m3.transform_points(clip_from_world, p / lightgrid_scale)
        w = p4[..., 3]
        ndc = p4[..., :3] / jnp.where(jnp.abs(w[..., None]) < 1e-8, 1e-8,
                                      w[..., None])
        uv = ndc[..., :2] * 0.5 + 0.5
        onscreen = (w > 0.0) & jnp.all(jnp.abs(ndc[..., :2]) < 1.0, axis=-1)
        first_off = first_off | (~onscreen & ~best_hit)
        d_scene = sampling.sample_nearest8(depth_tex, uv)
        # an off-screen probe is terminal (the reference falls back the step
        # its trace leaves the screen, glsl:322-331) — no later-k hits
        hit_k = (onscreen & ~first_off
                 & (ndc[..., 2] > d_scene + z_margin) & (d_scene < 1.0))
        if solid_taps > 0:
            # the reference resolves only when the occluder is voxel-SOLID
            # between the visible surface and the ray point (3 lightgrid
            # alpha taps >= 1.5, glsl:348-363) — a thin occluder (column in
            # front of the ray) skips instead of resolving the wrong surface.
            # solid_taps=1 is the single midpoint economy form.
            surf4 = m3.transform_points(
                world_from_clip,
                jnp.concatenate([ndc[..., :2], d_scene[..., None]], -1),
            )
            surf_g = (surf4[..., :3] / jnp.where(
                jnp.abs(surf4[..., 3:4]) < 1e-8, 1e-8, surf4[..., 3:4]
            )) * lightgrid_scale
            n0 = (noise * 0.2) if noise is not None else 0.0
            asum = 0.0
            for t in range(1, solid_taps + 1):
                frac = n0 + t / (solid_taps + 1.0)
                pos = surf_g + (p - surf_g) * (frac[..., None]
                                               if jnp.ndim(frac) else frac)
                asum = asum + _sample_alpha_u16(alpha_grid, pos)
            hit_k = hit_k & (asum >= 0.5 * solid_taps)
        newly = hit_k & ~best_hit
        best_uv = jnp.where(newly[..., None], uv, best_uv)
        best_t = jnp.where(newly, frac, best_t)
        best_hit = best_hit | hit_k
    if dist_mip > 0.0 and prev_levels > 0:
        lv = jnp.round(seg_world * best_t * dist_mip).astype(jnp.int32)
        prev = sampling.sample_screen_atlas_window(
            wprev, prev_hw[0], prev_hw[1], prev_levels, best_uv, lv, 3
        )
    else:
        prev = sampling.sample_bilinear_window(wprev, prev_hw[0], prev_hw[1],
                                               best_uv, 3)
    if want_offscreen:
        return best_hit, prev * ss_intensity, first_off & ~best_hit
    return best_hit, prev * ss_intensity


def screen_trace_linear(depth_tex, alpha_grid, p0_vs, open_vs,
                        clip_from_view, world_from_view,
                        lightgrid_scale, noise_01,
                        steps=16, rounds=2, steps2=6, solid_taps=3,
                        unroll=6):
    """Faithful bounded port of the reference's linear screen trace
    (lighting_pass.glsl:301-397) for the FAST GI path — the same step
    schedule, occlusion test, solidity gate, boost-continuation, and
    off-screen fallback as sample_radiance_with_screen_trace's phase B, but
    restructured so the voxel-solidity taps are paid per depth-CROSSING
    instead of per step:

      * the in-loop body tests only the depth buffer (ONE 4-byte row/step)
        and FREEZES the lane at its first crossing;
      * after each round, the 3-tap lightgrid solidity test (glsl:348-356)
        runs once per frozen lane; translucent crossings re-arm the lane
        with the reference's (2+noise)x boosted step (glsl:357-361) for the
        next round of `steps2` steps.

    The reference evaluates solidity inline and continues marching in the
    same loop; `rounds` bounds how many translucent crossings a lane can
    skip (2 covers a column + a railing — deeper stacks fall through to the
    voxel march, exactly like the reference's own trip-count bound in the
    parity path, max_ss_steps=24).

    Reference-exact details preserved: step_len0 = max(z_view,1)*(1+noise)/
    100 (glsl:301); dir normalized by |to_open.xy| so travelled distance is
    measured in XY-projected units against the 3-D |to_open| (glsl:302-312
    — the view-aligned overshoot); step growth 1.2x BEFORE the depth fetch
    (glsl:333-336); occlusion = euclidean view-space |surface| < |ray|
    (glsl:343); the distance-exhaustion check skipped on boost steps
    (glsl:361 `continue`); resolve lod = post-growth step_length (glsl:377,
    fetched by the caller at the returned uv/slen).

    Restructure (the dense per-step math was half the trace's work): the
    body is re-parameterized on ONE
    per-lane scalar — s, the travelled distance in the reference's
    XY-normalized units — instead of carrying the 3-D ray position:

      * the step vector is always collinear with ss_dir (growth and boost
        scale its LENGTH only), so pos_vs = p0 + s*dir EXACTLY and the clip
        coords are linear in s: clip = c0 + s*cd — 3 madds/step vs a 4x4
        transform_points;
      * the euclidean occlusion test compares SQUARED norms (monotonic-
        equivalent, drops 2 sqrt/step): |pos|^2 = a + (2b + c*s)*s from 3
        precomputed per-lane scalars, and |surf|^2 via the CLOSED-FORM
        inverse of the pure perspective clip_from_view (z_view =
        P23/(d - P22), math3d.perspective_lh_zo — this function requires a
        perspective clip_from_view, which Globals always carries) — no
        per-step view_from_clip transform or divide chain;
      * the carried state shrinks 14 -> 7 channels; the frozen crossing's
        surface point is reconstructed once per solidity round from the
        recorded (uv, depth) instead of being carried.

    Mathematically identical to the r3 form, different float-op order — the
    0.98-SSIM goldens and the full-res eval_ssim A/B pin the result.

    Returns (status, res_uv, res_slen) with status 0/2 = fall through to
    the voxel-march result, 1 = off-screen fallback (the caller substitutes
    its lightgrid fallback sample there), 3 = screen-resolved (sample the
    prev-frame atlas at res_uv, lod res_slen*5).
    """
    to_open = open_vs - p0_vs
    step_len0 = jnp.maximum(p0_vs[..., 2], 1.0) * (1.0 + noise_01) / 100.0
    ss_dir = to_open / jnp.maximum(
        jnp.linalg.norm(to_open[..., :2], axis=-1, keepdims=True), 1e-8
    )
    dist_to_travel = jnp.linalg.norm(to_open, axis=-1)

    m = clip_from_view
    p00, p11, p22, p23 = m[0, 0], m[1, 1], m[2, 2], m[2, 3]
    inv00 = 1.0 / (p00 * p00)
    inv11 = 1.0 / (p11 * p11)
    # clip-space line (x, y, w rows; w = z_view since M[3] = (0,0,1,0))
    c0x = p00 * p0_vs[..., 0]
    cdx = p00 * ss_dir[..., 0]
    c0y = p11 * p0_vs[..., 1]
    cdy = p11 * ss_dir[..., 1]
    c0w = p0_vs[..., 2]
    cdw = ss_dir[..., 2]
    # |p0 + s*dir|^2 = a2 + (b2 + c2*s)*s
    a2 = jnp.sum(p0_vs * p0_vs, -1)
    b2 = 2.0 * jnp.sum(p0_vs * ss_dir, -1)
    c2 = jnp.sum(ss_dir * ss_dir, -1)

    shape = step_len0.shape
    st = dict(
        slen=step_len0,
        trav=jnp.zeros(shape, jnp.float32),
        # 0 marching, 1 offscreen-fallback, 2 exhausted (voxel march),
        # 3 resolved, 4 frozen at a depth crossing (solidity pending)
        status=jnp.zeros(shape, jnp.int32),
        res_uv=jnp.zeros(shape + (2,), jnp.float32),
        res_d=jnp.ones(shape, jnp.float32),
    )

    def body(i, st):
        active = st["status"] == 0
        s = jnp.where(active, st["trav"] + st["slen"], st["trav"])

        cx = c0x + s * cdx
        cy = c0y + s * cdy
        cw = c0w + s * cdw
        iw = 1.0 / jnp.where(jnp.abs(cw) < 1e-8, 1e-8, cw)
        nx = cx * iw
        ny = cy * iw
        offscreen = (jnp.maximum(jnp.abs(nx), jnp.abs(ny)) > 1.0) & active
        status = jnp.where(offscreen, 1, st["status"])

        slen = jnp.where(active, st["slen"] * 1.2, st["slen"])

        uv = jnp.stack([nx * 0.5 + 0.5, ny * 0.5 + 0.5], -1)
        # blocked 32B-row depth fetch — bit-exact sample_nearest in one
        # wider row (sampling.sample_nearest8 rationale; the per-step depth
        # fetch is the trace's main memory traffic)
        d = sampling.sample_nearest8(depth_tex, uv)
        zv = p23 / (d - p22)            # d <= 1 < P22, so the denom is < 0
        surf2 = zv * zv * (nx * nx * inv00 + ny * ny * inv11 + 1.0)
        pos2 = a2 + (b2 + c2 * s) * s
        hit = (surf2 < pos2) & active & ~offscreen
        status = jnp.where(hit, 4, status)
        res_uv = jnp.where(hit[..., None], uv, st["res_uv"])
        res_d = jnp.where(hit, d, st["res_d"])

        done = (s > dist_to_travel) & active & ~offscreen & ~hit
        status = jnp.where(done, 2, status)
        return dict(slen=slen, trav=s, status=status, res_uv=res_uv,
                    res_d=res_d)

    def solidity(st):
        """3 alpha taps between the crossed surface and the ray (glsl:348-356);
        resolves solid crossings, re-arms translucent ones with the boosted
        step (glsl:357-361).  The frozen crossing's ray point is p0 +
        trav*dir (trav froze with the lane); the surface point comes from the
        recorded (uv, depth) through the same closed-form unprojection."""
        pending = st["status"] == 4
        pos = p0_vs + ss_dir * st["trav"][..., None]
        rn = st["res_uv"] * 2.0 - 1.0
        rzv = p23 / (st["res_d"] - p22)
        surf_vs = jnp.stack(
            [rn[..., 0] * rzv / p00, rn[..., 1] * rzv / p11, rzv], -1
        )
        t_start = m3.transform_points(
            world_from_view, surf_vs
        )[..., :3] * (lightgrid_scale * 0.5) + 0.5
        t_end = m3.transform_points(
            world_from_view, pos
        )[..., :3] * (lightgrid_scale * 0.5) + 0.5
        noff = noise_01 * 0.2
        fracs = ((0.2, 0.4, 0.6) if solid_taps >= 3 else
                 (0.4,) if solid_taps == 1 else (0.3, 0.5))
        asum = 0.0
        for k in fracs:
            mixk = t_start + (t_end - t_start) * (noff + k)[..., None]
            asum = asum + sampling.sample_trilinear_window(
                alpha_grid, mixk, 1, decode=lambda v: v * (1.0 / 255.0)
            )[..., 0]
        solid = asum >= 0.5 * len(fracs)
        resolve = pending & solid
        boost = pending & ~solid
        status = jnp.where(resolve, 3, jnp.where(boost, 0, st["status"]))
        slen = jnp.where(boost, st["slen"] * (2.0 + noise_01), st["slen"])
        return dict(st, status=status, slen=slen)

    # unroll: each XLA while iteration carries a fixed overhead on top of
    # its body; unrolling 6 steps per iteration cuts that overhead 6x and
    # lets XLA fuse the dense projection math across steps, with bounded
    # compile growth.  unroll >= steps emits a plain Python loop (no while
    # at all): numerically identical, at more compile time.
    def run_loop(n, st):
        if unroll >= n:
            for i in range(n):
                st = body(i, st)
            return st
        return jax.lax.fori_loop(0, n, body, st, unroll=min(unroll, n))

    st = run_loop(steps, st)
    st = solidity(st)
    for _ in range(max(0, rounds - 1)):
        st = run_loop(steps2, st)
        st = solidity(st)
    # lanes still marching at the budget: fall through to the voxel march,
    # like the parity path's own max_ss_steps bound
    status = jnp.where(st["status"] == 0, 2, st["status"])
    return status, st["res_uv"], st["slen"]


def screen_trace_linear_v1(depth_tex, alpha_grid, p0_vs, open_vs, fb_rgb,
                        clip_from_view, view_from_clip, world_from_view,
                        lightgrid_scale, noise_01,
                        steps=16, rounds=2, steps2=6, solid_taps=3,
                        unroll=6):
    """The r3 form of screen_trace_linear (carried 3-D ray pos,
    per-step 4x4 transforms, euclidean norms) — kept for the in-process
    ab_time A/B against the v2 rewrite; selected by
    cfg.gi_trace_impl="v1".  Same contract and
    reference citations as screen_trace_linear."""
    to_open = open_vs - p0_vs
    step_len0 = jnp.maximum(p0_vs[..., 2], 1.0) * (1.0 + noise_01) / 100.0
    ss_dir = to_open / jnp.maximum(
        jnp.linalg.norm(to_open[..., :2], axis=-1, keepdims=True), 1e-8
    )
    dist_to_travel = jnp.linalg.norm(to_open, axis=-1)

    shape = step_len0.shape
    st = dict(
        pos=p0_vs,
        step=ss_dir * step_len0[..., None],
        slen=step_len0,
        trav=jnp.zeros(shape, jnp.float32),
        # 0 marching, 1 offscreen-fallback, 2 exhausted (voxel march),
        # 3 resolved, 4 frozen at a depth crossing (solidity pending)
        status=jnp.zeros(shape, jnp.int32),
        res_uv=jnp.zeros(shape + (2,), jnp.float32),
        surf_vs=jnp.zeros(shape + (3,), jnp.float32),
    )

    def body(i, st):
        active = st["status"] == 0
        pos = jnp.where(active[..., None], st["pos"] + st["step"], st["pos"])
        trav = jnp.where(active, st["trav"] + st["slen"], st["trav"])

        ndc4 = m3.transform_points(clip_from_view, pos)
        ndc = ndc4[..., :3] / jnp.where(
            jnp.abs(ndc4[..., 3:4]) < 1e-8, 1e-8, ndc4[..., 3:4]
        )
        offscreen = jnp.any(jnp.abs(ndc[..., :2]) > 1.0, axis=-1) & active
        status = jnp.where(offscreen, 1, st["status"])

        step = jnp.where(active[..., None], st["step"] * 1.2, st["step"])
        slen = jnp.where(active, st["slen"] * 1.2, st["slen"])

        uv = ndc[..., :2] * 0.5 + 0.5
        # blocked 32B-row depth fetch — bit-exact sample_nearest in one
        # wider row (sampling.sample_nearest8 rationale; the per-step depth
        # fetch is the trace's main memory traffic)
        d = sampling.sample_nearest8(depth_tex, uv)
        sp4 = m3.transform_points(
            view_from_clip, jnp.concatenate([ndc[..., :2], d[..., None]], -1)
        )
        surf_vs = sp4[..., :3] / jnp.where(
            jnp.abs(sp4[..., 3:4]) < 1e-8, 1e-8, sp4[..., 3:4]
        )
        hit = (
            (jnp.linalg.norm(surf_vs, axis=-1) < jnp.linalg.norm(pos, axis=-1))
            & active & ~offscreen
        )
        status = jnp.where(hit, 4, status)
        res_uv = jnp.where(hit[..., None], uv, st["res_uv"])
        surf_keep = jnp.where(hit[..., None], surf_vs, st["surf_vs"])

        done = (trav > dist_to_travel) & active & ~offscreen & ~hit
        status = jnp.where(done, 2, status)
        return dict(pos=pos, step=step, slen=slen, trav=trav, status=status,
                    res_uv=res_uv, surf_vs=surf_keep)

    def solidity(st):
        """3 alpha taps between the crossed surface and the ray (glsl:348-356);
        resolves solid crossings, re-arms translucent ones with the boosted
        step (glsl:357-361)."""
        pending = st["status"] == 4
        t_start = m3.transform_points(
            world_from_view, st["surf_vs"]
        )[..., :3] * (lightgrid_scale * 0.5) + 0.5
        t_end = m3.transform_points(
            world_from_view, st["pos"]
        )[..., :3] * (lightgrid_scale * 0.5) + 0.5
        noff = noise_01 * 0.2
        fracs = ((0.2, 0.4, 0.6) if solid_taps >= 3 else
                 (0.4,) if solid_taps == 1 else (0.3, 0.5))
        asum = 0.0
        for k in fracs:
            mixk = t_start + (t_end - t_start) * (noff + k)[..., None]
            asum = asum + sampling.sample_trilinear_window(
                alpha_grid, mixk, 1, decode=lambda v: v * (1.0 / 255.0)
            )[..., 0]
        solid = asum >= 0.5 * len(fracs)
        resolve = pending & solid
        boost = pending & ~solid
        bf = (2.0 + noise_01)[..., None]
        status = jnp.where(resolve, 3, jnp.where(boost, 0, st["status"]))
        step = jnp.where(boost[..., None], st["step"] * bf, st["step"])
        slen = jnp.where(boost, st["slen"] * bf[..., 0], st["slen"])
        return dict(st, status=status, step=step, slen=slen)

    # unroll: each XLA while iteration carries a fixed overhead on top of
    # its body; unrolling 6 steps per iteration cuts that overhead 6x and
    # lets XLA fuse the dense projection math across steps, with bounded
    # compile growth.  unroll >= steps emits a plain Python loop (no while
    # at all): numerically identical, at more compile time.
    def run_loop(n, st):
        if unroll >= n:
            for i in range(n):
                st = body(i, st)
            return st
        return jax.lax.fori_loop(0, n, body, st, unroll=min(unroll, n))

    st = run_loop(steps, st)
    st = solidity(st)
    for _ in range(max(0, rounds - 1)):
        st = run_loop(steps2, st)
        st = solidity(st)
    # lanes still marching at the budget: fall through to the voxel march,
    # like the parity path's own max_ss_steps bound
    status = jnp.where(st["status"] == 0, 2, st["status"])
    return status, st["res_uv"], st["slen"]


def build_hiz_atlas(depth, levels=6):
    """Min-depth mip pyramid of the depth buffer packed into one [H, Wa]
    f32 atlas (level k at column offset mip_offsets[k], cell = 2^k texels).

    An alternative to the reference's 24-step linear screen trace
    (lighting_pass.glsl:315-397): a hierarchical-z trace takes large steps
    where the min-pyramid proves the ray clears everything in a cell, so a
    FIXED budget of ~10 iterations covers the same screen distance the
    reference's growing linear steps do — at ONE 4-byte gather row per
    iteration instead of (1 depth + 3 solidity) rows per step.  Unused atlas
    rows hold 1.0 (far) so clamped addressing never fakes an occluder.
    Returns (atlas, offsets int32[levels])."""
    h, w = depth.shape
    offs, wa = sampling.mip_offsets(h, w, levels)
    atlas = jnp.ones((h, wa), jnp.float32)
    cur = depth
    for k in range(levels):
        lh, lw = cur.shape
        atlas = atlas.at[:lh, offs[k]:offs[k] + lw].set(cur)
        if k + 1 < levels:
            c = cur[: lh // 2 * 2, : lw // 2 * 2].reshape(lh // 2, 2,
                                                          lw // 2, 2)
            cur = c.min(axis=(1, 3))
    return atlas, jnp.asarray(offs, jnp.int32)


def hiz_trace(atlas, offs, base_hw, p0, p1, iters=10, start_level=1,
              max_level=5, thickness=0.015, z_bias=2e-4, t0_px=2.0,
              zview_nf=None):
    """Hierarchical-z DDA from p0 toward p1 (both [..., 3] = (u, v, z_ndc),
    uv in [0,1], z in [0,1] Vulkan depth, v row 0 = top — the same mapping
    screen_probe uses).  Dense lockstep: every lane runs exactly `iters`
    rounds of {advance to the cell exit if the segment's z stays in front of
    the cell's min depth, else refine one level}; a lane at level 0 whose
    segment passes behind the surface within `thickness` records a hit and
    freezes.  Rays passing MORE than `thickness` behind (occluder is thin —
    e.g. a column in front of the ray) skip the cell and continue, the
    two-sided test the one-sided probes lacked.

    zview_nf: optional (z_near, z_far) — then `thickness` is measured in
    VIEW-SPACE units (z_view = f*n / (f - z_ndc*(f-n)), the LH_ZO inverse,
    math3d.perspective_lh_zo).  A constant z_ndc thickness warps wildly with
    distance under the 0.02/10000 depth range (0.015 ndc is ~19 world units
    at 5 m but millimetres near the far field), which made the two-sided
    test meaningless — always pass zview_nf in renderer use; the raw-ndc
    form exists for resolution-agnostic unit tests.

    Returns (hit, t_hit, dead) with t in [0,1] along p0->p1; dead marks
    lanes that left the screen / exhausted the segment without hitting.
    """
    h, w = base_hw
    if zview_nf is not None:
        zn, zf = zview_nf
        _zv = lambda z: (zf * zn) / jnp.maximum(zf - z * (zf - zn), 1e-6)
    else:
        _zv = lambda z: z
    u0, v0, z0 = p0[..., 0], p0[..., 1], p0[..., 2]
    du = p1[..., 0] - u0
    dv = p1[..., 1] - v0
    dz = p1[..., 2] - z0

    big = jnp.float32(1e9)

    def exit_t(o, d):
        # t at which o + t*d leaves [0,1] in the + or - direction
        t_hi = jnp.where(d > 1e-9, (1.0 - o) / jnp.where(d > 1e-9, d, 1.0),
                         big)
        t_lo = jnp.where(d < -1e-9, (0.0 - o) / jnp.where(d < -1e-9, d, -1.0),
                         big)
        return jnp.minimum(t_hi, t_lo)

    t_max = jnp.minimum(1.0, jnp.minimum(exit_t(u0, du), exit_t(v0, dv)))

    seg_px = jnp.maximum(
        jnp.sqrt((du * w) ** 2 + (dv * h) ** 2), 1e-6
    )
    eps_t = 0.05 / seg_px                       # 1/20 px past each boundary
    t = jnp.minimum(t0_px / seg_px, t_max)      # skip the self-hit cells
    lvl = jnp.full(t.shape, start_level, jnp.int32)
    hit = jnp.zeros(t.shape, bool)
    t_hit = jnp.zeros_like(t)
    dead = t >= t_max

    lw = jnp.asarray([max(1, w >> k) for k in range(max_level + 1)],
                     jnp.int32)
    lh = jnp.asarray([max(1, h >> k) for k in range(max_level + 1)],
                     jnp.int32)

    inv_du = jnp.where(jnp.abs(du) > 1e-9, 1.0 / jnp.where(du == 0, 1.0, du),
                       big)
    inv_dv = jnp.where(jnp.abs(dv) > 1e-9, 1.0 / jnp.where(dv == 0, 1.0, dv),
                       big)

    def step(_, carry):
        t, lvl, hit, t_hit, dead = carry
        active = ~hit & ~dead
        cs = jnp.exp2(lvl.astype(jnp.float32))          # cell size in texels
        pu = (u0 + du * t) * w
        pv = (v0 + dv * t) * h
        cx = jnp.floor(pu / cs)
        cy = jnp.floor(pv / cs)
        # t at the cell exit (next boundary along the ray in each axis)
        bx = (cx + (du > 0)) * cs
        by = (cy + (dv > 0)) * cs
        tx = (bx / w - u0) * inv_du
        ty = (by / h - v0) * inv_dv
        tx = jnp.where(jnp.abs(du) > 1e-9, tx, big)
        ty = jnp.where(jnp.abs(dv) > 1e-9, ty, big)
        t_cross = jnp.minimum(jnp.minimum(tx, ty), t_max)

        ix = jnp.clip(cx.astype(jnp.int32), 0, jnp.take(lw, lvl) - 1)
        iy = jnp.clip(cy.astype(jnp.int32), 0, jnp.take(lh, lvl) - 1)
        zcell = atlas[iy, jnp.take(offs, lvl) + ix]     # THE gather

        z_enter = z0 + dz * t
        z_exit = z0 + dz * t_cross
        zmax = jnp.maximum(z_enter, z_exit)
        if zview_nf is not None:
            # view-space bias: the ndc form is microscopic in world units at
            # the 0.02/10000 depth range, so a ray leaving its own surface at
            # a grazing angle "hits" its own depth plane within 1-2 texels
            # and resolves its own pixel (self-illumination feedback)
            cross = (_zv(zmax) - z_bias >= _zv(zcell)) & (zcell < 1.0)
        else:
            cross = (zmax + z_bias >= zcell) & (zcell < 1.0)

        at0 = lvl == 0
        real_hit = active & cross & at0 & \
            (_zv(jnp.minimum(z_enter, z_exit)) - _zv(zcell) < thickness)
        skip_behind = active & cross & at0 & ~real_hit
        hit = hit | real_hit
        t_hit = jnp.where(real_hit, t, t_hit)

        refine = active & cross & ~at0
        advance = active & (~cross | skip_behind)
        lvl = jnp.where(refine, lvl - 1,
                        jnp.where(advance, jnp.minimum(lvl + 1, max_level),
                                  lvl))
        # on refine, jump t to the in-interval z-crossing first — without
        # this, grazing rays ping-pong refine/advance around the crossing
        # and exhaust the iteration budget (z is linear in t, so the jump
        # is exact; clamped into [t, t_cross])
        dzi = z_exit - z_enter
        t_z = t + (zcell - z_enter) / jnp.where(jnp.abs(dzi) < 1e-9, 1.0,
                                                dzi) * (t_cross - t)
        t_z = jnp.where(dzi > 1e-9, jnp.clip(t_z, t, t_cross), t)
        t_new = jnp.where(advance, t_cross + eps_t,
                          jnp.where(refine, t_z, t))
        dead = dead | (advance & (t_new >= t_max))
        return t_new, lvl, hit, t_hit, dead

    # fori_loop, NOT a Python unroll: the unrolled 14-iteration body doubled
    # the whole FRAME's XLA compile time (326 s vs 109 s small-config CPU,
    # round 3) for no measurable runtime gain — the body is gather-bound
    t, lvl, hit, t_hit, dead = jax.lax.fori_loop(
        0, iters, step, (t, lvl, hit, t_hit, dead))
    return hit, t_hit, dead


def screen_trace_hiz(ro_grid_ndc, open_grid_ndc, lightgrid_scale,
                     clip_from_world, hiz, hiz_offs, base_hw, wprev, prev_hw,
                     ss_intensity, alpha_grid=None, iters=10,
                     thickness=0.5, z_bias=2e-4, solid_thresh=0.0,
                     zview_nf=None):
    """Hi-z screen resolve of the [surface, first-open] segment — the fast
    path's replacement for the reference's linear screen trace
    (lighting_pass.glsl:315-397); see hiz_trace for the traversal.

    With solid_thresh > 0 and alpha_grid: the reference's solidity test
    (glsl:348-356) becomes ONE 16-byte alpha row at the perspective-correct
    hit point — translucent hits are rejected and fall back to the voxel
    march.  Off by default: at 128^3 over 80 world units a one-voxel-thin
    wall averages well under 0.5 alpha trilinearly, and the measured effect
    of the gate was to kill most VALID resolves (v5 solid sweep scored at
    the no-screen-term floor, docs/tune_gi).  thickness is view-space via
    zview_nf=(z_near, z_far) — see hiz_trace.  Resolve fetches the
    prev-frame window at the hit uv.  Returns (hit, rgb)."""
    from ..utils import math3d as m3

    c0 = m3.transform_points(clip_from_world, ro_grid_ndc / lightgrid_scale)
    c1 = m3.transform_points(clip_from_world, open_grid_ndc / lightgrid_scale)
    w0, w1 = c0[..., 3], c1[..., 3]
    # clip the segment before the w=0 plane (open point behind the camera)
    w_min = 1e-3
    t_end = jnp.where(w1 < w_min,
                      jnp.clip((w0 - w_min) / jnp.maximum(w0 - w1, 1e-6),
                               0.0, 1.0),
                      1.0)
    c1 = c0 + (c1 - c0) * t_end[..., None]
    w1 = jnp.maximum(c1[..., 3], w_min)
    w0s = jnp.maximum(w0, w_min)
    ndc0 = c0[..., :3] / w0s[..., None]
    ndc1 = c1[..., :3] / w1[..., None]
    p0 = jnp.concatenate([ndc0[..., :2] * 0.5 + 0.5, ndc0[..., 2:3]], -1)
    p1 = jnp.concatenate([ndc1[..., :2] * 0.5 + 0.5, ndc1[..., 2:3]], -1)

    valid = w0 > w_min
    hit, t_hit, _ = hiz_trace(hiz, hiz_offs, base_hw, p0, p1, iters=iters,
                              thickness=thickness, z_bias=z_bias,
                              zview_nf=zview_nf)
    hit = hit & valid

    if alpha_grid is not None and solid_thresh > 0.0:
        # perspective-correct world point at the hit (attributes over w
        # interpolate linearly in screen space) — where the reference taps
        # its solidity samples (between ray pos and depth surface, which
        # project to the same uv)
        iw0, iw1 = 1.0 / w0s, 1.0 / w1
        th = t_hit
        denom = (1.0 - th) * iw0 + th * iw1
        mid_grid = ((1.0 - th[..., None]) * ro_grid_ndc * iw0[..., None]
                    + th[..., None] * open_grid_ndc * iw1[..., None]) \
            / denom[..., None]
        a_mid = _sample_alpha_u16(alpha_grid, mid_grid)
        hit = hit & (a_mid >= solid_thresh)

    # endpoint fallback: a lane whose trace missed (budget exhausted on a
    # long grazing segment, or the crossing rejected by the thickness rule)
    # but whose FIRST-OPEN point projects behind visible geometry still
    # resolves there — the single test the k-point probes (screen_probe)
    # score most of their value from; one extra level-0 row from the same
    # atlas
    hh, ww = base_hw
    e_ix = jnp.clip((p1[..., 0] * ww).astype(jnp.int32), 0, ww - 1)
    e_iy = jnp.clip((p1[..., 1] * hh).astype(jnp.int32), 0, hh - 1)
    d_end = hiz[e_iy, e_ix]
    onscreen = valid & (t_end >= 1.0) & \
        jnp.all((p1[..., :2] > 0.0) & (p1[..., :2] < 1.0), axis=-1)
    end_hit = onscreen & ~hit & (p1[..., 2] > d_end) & (d_end < 1.0)
    t_res = jnp.where(end_hit, 1.0, t_hit)
    hit = hit | end_hit

    uv_hit = p0[..., :2] + (p1[..., :2] - p0[..., :2]) * t_res[..., None]
    prev = sampling.sample_bilinear_window(wprev, prev_hw[0], prev_hw[1],
                                           uv_hit, 3)
    return hit, prev * ss_intensity


def screen_probe(open_grid_ndc, lightgrid_scale, clip_from_world, depth_tex,
                 wprev, prev_hw, ss_intensity, z_margin=2e-4):
    """One-probe screen-space bounce for the fast GI path.

    The reference's hybrid trace resolves to the PREVIOUS FRAME's radiance
    where the GI ray crosses visible geometry (lighting_pass.glsl:371-384) —
    that term carries most of the warm bounce light the pure voxel lookup
    misses (measured: fast-vs-reference SSIM 0.85, diff concentrated on
    shadowed surfaces near emitters).  Instead of the 24-step march, project
    the ray's first-open point once: if it lands on-screen BEHIND the visible
    surface, the ray hit that surface — take the prev-frame color there.

    Cost: 2 gather rows per call (nearest depth + one bilinear window row of
    the quarter-res prev pyramid level).  Returns (hit mask [...], rgb).
    Known approximation: a point merely OCCLUDED from the camera (not on the
    ray's path) can false-hit — local color bleeding the reference's
    translucency boost also exhibits in milder form; TAA integrates it.
    """
    from ..utils import math3d as m3

    open_world = open_grid_ndc / lightgrid_scale
    p4 = m3.transform_points(clip_from_world, open_world)
    w = p4[..., 3]
    ndc = p4[..., :3] / jnp.where(jnp.abs(w[..., None]) < 1e-8, 1e-8,
                                  w[..., None])
    uv = ndc[..., :2] * 0.5 + 0.5
    onscreen = (w > 0.0) & jnp.all(jnp.abs(ndc[..., :2]) < 1.0, axis=-1)
    d_scene = sampling.sample_nearest8(depth_tex, uv)
    hit = onscreen & (ndc[..., 2] > d_scene + z_margin) & (d_scene < 1.0)
    prev = sampling.sample_bilinear_window(wprev, prev_hw[0], prev_hw[1],
                                           uv, 3)
    return hit, prev * ss_intensity


def sample_radiance(grid, ro_world, rd_unit, lightgrid_scale, num_steps=12,
                    step_scale=1.0, alpha_grid=None):
    """Pure voxel-space GI march, SampleRadiance (lighting_pass.glsl:236-271)."""
    gsize = grid.shape[0]
    voxel_scale = 2.0 / gsize
    rd = rd_unit * voxel_scale
    ro = ro_world * lightgrid_scale

    ro, sum4, _ = _skip_blockage(grid, ro, rd, steps=12, open_thresh=0.1,
                                 alpha_grid=alpha_grid)
    no_open = sum4[..., 3] < 0.5
    sum4 = _voxel_march(grid, ro, rd * step_scale, sum4, num_steps, 0.0, False)
    out = _tone(sum4)
    return jnp.where(no_open[..., None], 0.0, out)


def sample_radiance_with_screen_trace(
    grid,
    depth_tex,
    prev_frame_atlas,
    view_from_world,
    clip_from_view,
    view_from_clip,
    world_from_view,
    v_dir,
    p0_view,
    ro_world,
    rd_unit,
    lightgrid_scale,
    num_steps,
    step_scale,
    noise_01,
    foggyness,
    ss_intensity,
    max_ss_steps=24,
    prev_base=None,
    prev_levels=None,
    alpha_grid=None,
):
    """Hybrid screen-space + voxel GI march — the port of
    SampleRadianceWithScreenSpaceTrace (lighting_pass.glsl:273-424).

    All per-pixel inputs are [...,k] dense arrays; the reference's early
    returns/breaks become per-lane status flags.  prev_frame_atlas is a mip
    atlas of the previous frame's radiance — the reference binds the
    *bloom downscale pyramid* there (render.cpp:862), i.e. half-res base;
    prev_base=(base_h, base_w) and prev_levels describe the atlas layout.
    """
    gsize = grid.shape[0]
    h, w = depth_tex.shape
    if prev_base is None:
        prev_base = (prev_frame_atlas.shape[0], prev_frame_atlas.shape[0])
    voxel_scale = 2.0 / gsize
    rd = rd_unit * voxel_scale
    ro0 = ro_world * lightgrid_scale

    # -- phase A: skip initial blockage (4 steps, open threshold 0.3)
    ro, sum4, _ = _skip_blockage(grid, ro0, rd, steps=4, open_thresh=0.3,
                                 alpha_grid=alpha_grid)

    # -- phase B: screen-space trace toward the first open point
    open_world = ro / lightgrid_scale
    open_vs = m3.transform_points(view_from_world, open_world)[..., :3]
    p0_vs = p0_view[..., :3]
    to_open = open_vs - p0_vs
    step_len0 = jnp.maximum(p0_vs[..., 2], 1.0) * (1.0 + noise_01) / 100.0
    ss_dir = to_open / jnp.maximum(
        jnp.linalg.norm(to_open[..., :2], axis=-1, keepdims=True), 1e-8
    )
    dist_to_travel = jnp.linalg.norm(to_open, axis=-1)

    # status: 0 = marching, 1 = off-screen fallback, 2 = fall through to
    # voxel march, 3 = screen-resolved (prev frame fetched ONCE after the
    # loop at res_uv/res_slen — the in-loop fetch paid 2 mip-atlas gather
    # rows x max_ss_steps per ray for values discarded on all but the
    # resolve step; recording the uv instead is bit-exact and removes ~46
    # rows/ray from the parity path, round 3)
    st0 = dict(
        pos=p0_vs,
        step=ss_dir * step_len0[..., None],
        slen=step_len0,
        trav=jnp.zeros_like(step_len0),
        status=jnp.zeros(step_len0.shape, jnp.int32),
        res_uv=jnp.zeros(p0_vs.shape[:-1] + (2,), jnp.float32),
        res_slen=jnp.zeros_like(step_len0),
    )

    fallback_pos = ro0 + 2.5 * v_dir * voxel_scale
    fb = grid_sample(grid, fallback_pos)
    fb_rgb = colorlib.tone_compress_sqrt(fb[..., :3])

    def ss_body(i, st):
        active = st["status"] == 0
        pos = jnp.where(active[..., None], st["pos"] + st["step"], st["pos"])
        trav = jnp.where(active, st["trav"] + st["slen"], st["trav"])

        ndc4 = m3.transform_points(clip_from_view, pos)
        ndc = ndc4[..., :3] / jnp.where(
            jnp.abs(ndc4[..., 3:4]) < 1e-8, 1e-8, ndc4[..., 3:4]
        )
        offscreen = jnp.any(jnp.abs(ndc[..., :2]) > 1.0, axis=-1) & active
        # off-screen -> fallback lightgrid sample (glsl:322-330)
        status = jnp.where(offscreen, 1, st["status"])

        step = jnp.where(active[..., None], st["step"] * 1.2, st["step"])
        slen = jnp.where(active, st["slen"] * 1.2, st["slen"])

        uv = ndc[..., :2] * 0.5 + 0.5
        # blocked 32B-row depth fetch — bit-exact sample_nearest in one
        # wider row (sampling.sample_nearest8 rationale; the per-step depth
        # fetch is the trace's main memory traffic)
        d = sampling.sample_nearest8(depth_tex, uv)
        sp4 = m3.transform_points(
            view_from_clip, jnp.concatenate([ndc[..., :2], d[..., None]], -1)
        )
        surf_vs = sp4[..., :3] / jnp.where(
            jnp.abs(sp4[..., 3:4]) < 1e-8, 1e-8, sp4[..., 3:4]
        )
        hit = (
            (jnp.linalg.norm(surf_vs, axis=-1) < jnp.linalg.norm(pos, axis=-1))
            & active
            & ~offscreen
        )

        # solidity: 3 lightgrid alpha taps between surface and ray pos (glsl:348-356)
        t_start = m3.transform_points(world_from_view, surf_vs)[..., :3] * (
            lightgrid_scale * 0.5
        ) + 0.5
        t_end = m3.transform_points(world_from_view, pos)[..., :3] * (
            lightgrid_scale * 0.5
        ) + 0.5
        noff = noise_01 * 0.2
        asum = 0.0
        for k in (0.2, 0.4, 0.6):
            mixk = t_start + (t_end - t_start) * (noff + k)[..., None]
            if alpha_grid is not None:  # 16B alpha rows, ~2x gather rate
                asum = asum + sampling.sample_trilinear_window(
                    alpha_grid, mixk, 1, decode=lambda v: v * (1.0 / 255.0)
                )[..., 0]
            else:
                asum = asum + _gs_uvw(grid, mixk)[..., 3]
        solid = asum >= 1.5

        # translucent surface: boost the step and keep going (glsl:357-361)
        boost = hit & ~solid
        bf = (2.0 + noise_01)[..., None]
        step = jnp.where(boost[..., None], step * bf, step)
        slen = jnp.where(boost, slen * bf[..., 0], slen)

        # solid hit: record the resolve uv + step length (glsl:371-384; the
        # prev-frame mip fetch happens once, after the loop)
        resolve = hit & solid
        status = jnp.where(resolve, 3, status)
        res_uv = jnp.where(resolve[..., None], uv, st["res_uv"])
        res_slen = jnp.where(resolve, slen, st["res_slen"])

        # distance exhausted -> proceed to voxel march (glsl:392)
        done = (trav > dist_to_travel) & active & ~offscreen & ~resolve & ~boost
        status = jnp.where(done, 2, status)

        return dict(pos=pos, step=step, slen=slen, trav=trav, status=status,
                    res_uv=res_uv, res_slen=res_slen)

    # plain fori_loop: unroll=6 cost ~4x the compile time for no runtime
    # win on an earlier platform (the body's 4 gather rows hide the loop
    # overhead); not re-measured on the GPU
    st = jax.lax.fori_loop(0, max_ss_steps, ss_body, st0)
    # lanes that ran out of iterations: treat like distance-exhausted
    status = jnp.where(st["status"] == 0, 2, st["status"])
    lod = jnp.minimum(st["res_slen"] * 5.0, 5.0)
    prev = sampling.sample_mip_atlas(
        prev_frame_atlas, prev_base[0], prev_base[1], st["res_uv"], lod,
        levels=prev_levels,
    )[..., :3]
    result = jnp.where((status == 1)[..., None], fb_rgb,
                       prev * ss_intensity)

    # -- phase C: continue in voxel space (glsl:399-423)
    no_open = sum4[..., 3] < 0.5
    rd2 = rd * step_scale
    ro_c = ro + rd2 * noise_01[..., None]
    sum_c = _voxel_march(grid, ro_c, 0.5 * rd2, sum4, num_steps, foggyness[..., None]
                         if jnp.ndim(foggyness) else foggyness, True)
    voxel_rgb = jnp.where(no_open[..., None], 0.0, _tone(sum_c))

    return jnp.where(((status == 1) | (status == 3))[..., None], result,
                     voxel_rgb)
