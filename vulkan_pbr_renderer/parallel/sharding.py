"""Multi-card frame execution via jax.sharding + shard_map.

The reference is strictly single-GPU (SURVEY.md §2.2 parallelism inventory:
one Vulkan queue, no multi-device code).  This module is the new capability:
the frame is laid out over a 2-D device mesh

  dp — data parallel over independent frames (camera-path batches: offline
       rendering / bench sweeps are embarrassingly parallel; each dp slice
       carries its OWN FrameState so temporal effects evolve per path)
  sp — "spatial parallel": framebuffer rows sharded across chips

Inside one frame (per dp slice), each sp shard:
  1. rasterizes its rows of the sun shadow map; all_gather -> full map
     (every shard needs arbitrary shadow lookups)
  2. voxelizes a 1/sp slice of the SAME GI sample stream; the partial
     radiance grids combine with pmax — scatter-max is order-independent,
     so the combined grid EXACTLY matches the single-chip voxelization
  3. sweeps the (replicated) lightgrid locally — cheaper than communicating
  4. rasterizes + G-buffers + lights its own rows (the heavy per-pixel work;
     the GI screen-space trace reads the all_gathered full depth)
  5. all_gathers the HDR/velocity rows, then runs TAA, the level-1 bloom
     downsample, the final full-res tent and the tonemap row-sharded via
     edge-clamped halo slabs of the gathered buffers (_post_stack_sharded);
     only the <= H/4-sized deep bloom levels stay replicated

Collectives (all_gather/pmax over 'sp') are XLA's, which hands them to
NCCL on the GPU; every card reaches every other over NVLink, so the mesh is a
plain reshape of jax.devices().  Temporal state is carried
replicated within a dp slice and the step returns the full new FrameState, so
a multi-frame loop works exactly like the single-chip `render_frame` loop —
**sharding is invisible**: with matching config the sharded image equals the
single-chip `render_frame` image (pinned by tests/test_parallel.py).

The single caveat: the reduced-resolution GI/shaft/sky upsampling of the
single-chip config would clamp at shard row edges and seam, so this path
forces gi_res_divisor = shaft_res_divisor = sky_res_divisor = 1 (full-res
GI/shafts/sky — with the work spread over chips there is no need for the
reduced-res trade anyway).  Parity therefore holds vs. `render_frame` under
the same divisor-1 config.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..app import renderer as rmod
from ..config import RenderConfig
from ..gpu import sampling
from ..shade import bloom as bloom_mod
from ..shade import gbuffer as gb
from ..shade import gi, lighting, taa
from ..utils import color as colorlib


def make_mesh(n_devices=None, dp=1):
    devices = jax.devices()
    n = n_devices or len(devices)
    assert n % dp == 0, "dp must divide device count"
    arr = np.array(devices[:n]).reshape(dp, n // dp)
    return Mesh(arr, ("dp", "sp"))


def _edge_slab(full, y0, rows, top, bottom):
    """Rows [y0-top, y0+rows+bottom) of `full` with edge clamping (y0 may be
    traced) — edge-pad then dynamic-slice, exactly matching jnp.pad 'edge'."""
    p = jnp.pad(full, [(top, bottom)] + [(0, 0)] * (full.ndim - 1), mode="edge")
    return jax.lax.dynamic_slice_in_dim(p, y0, rows + top + bottom, 0)


def _post_stack_sharded(hdr_full, depth_full, vel_full, state, cfg, y0, rows):
    """Row-sharded passes 6-9: each shard resolves TAA, the
    level-1 bloom downsample, the final full-res tent, and the tonemap for its
    OWN rows; only the tiny deep bloom levels (<= H/4 x W/4) run replicated.
    The history/velocity-prev tables stay replicated state (the reprojected uv
    can land on any row), so no halo is needed for them; the 3x3/13-tap/9-tap
    neighborhoods come from edge-clamped halo slabs of the all_gathered
    full-height buffers.  Exactness vs renderer.post_stack is pinned by
    tests/test_parallel.py.

    Returns (final srgb rows, taa_out FULL [via all_gather], pyramid)."""
    h, w = cfg.height, cfg.width
    sx = bloom_mod._shift_edge

    if cfg.enable_taa:
        history = jnp.where(state.frame_idx == 0, hdr_full, state.taa_history)
        taa_rows = taa.taa_resolve(
            _edge_slab(hdr_full, y0, rows, 1, 1),
            _edge_slab(depth_full, y0, rows, 1, 1),
            _edge_slab(vel_full, y0, rows, 1, 1),
            state.velocity_prev, history,
            cfg.taa_blend, cfg.taa_velocity_rejection,
            catmull_history=cfg.taa_catmull_history,
            full_rgb_catmull=cfg.taa_full_rgb_catmull,
            halo=1, row_offset=y0, full_height=h,
        )
        taa_out = jax.lax.all_gather(taa_rows, "sp", axis=0, tiled=True)
    else:
        taa_rows = jax.lax.dynamic_slice_in_dim(hdr_full, y0, rows, 0)
        taa_out = hdr_full

    if not cfg.enable_bloom:
        bloom_rows = taa_rows
        pyramid = state.prev_pyramid
    else:
        # ---- level-1 13-tap downsample, sharded (the only full-res level).
        # The 2:1 fast path = two box2 phase images + half-res shifts
        # (bloom_mod.downsample_13tap); build both phase slabs with one
        # half-res halo row each side from an even-aligned source slab, then
        # fix the two frame-boundary halo rows so the half-res edge clamp
        # matches the single-chip _shift_edge exactly (the source-level edge
        # pad would give box2(src0, src0) where single-chip replicates
        # box2(src0, src1)).
        hr = rows // 2
        slab = _edge_slab(taa_out, y0, rows, 2, 4)        # rows+6, even-aligned
        b00 = bloom_mod._box2(slab)                       # [hr+3] half rows
        b11 = bloom_mod._box2(sx(slab, 1, 1))
        at_top = y0 == 0
        at_bot = y0 + rows == h
        b00 = b00.at[0].set(jnp.where(at_top, b00[1], b00[0]))
        b00 = b00.at[hr + 1].set(jnp.where(at_bot, b00[hr], b00[hr + 1]))
        b11 = b11.at[0].set(jnp.where(at_top, b11[1], b11[0]))

        def c(a, dy):  # center rows of a phase slab, shifted dy in y
            return jax.lax.dynamic_slice_in_dim(a, 1 + dy, hr, 0)

        d1 = 0.125 * c(b00, 0)
        for (dy, dx) in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
            d1 = d1 + 0.03125 * sx(c(b00, dy), 0, dx)
        for (dy, dx) in ((-1, 0), (0, -1), (1, 0), (0, 1)):
            d1 = d1 + 0.0625 * sx(c(b00, dy), 0, dx)
        for (dy, dx) in ((-1, -1), (-1, 0), (0, -1), (0, 0)):
            d1 = d1 + 0.125 * sx(c(b11, dy), 0, dx)
        d1 = jnp.minimum(d1, 1.0)                         # mip-1 firefly clamp
        d1_full = jax.lax.all_gather(d1, "sp", axis=0, tiled=True)

        # ---- deeper levels + the up chain: <= [H/4, W/4] — replicated ----
        passes = cfg.bloom_pass_count
        sizes = [(max(1, h >> i), max(1, w >> i)) for i in range(passes + 1)]
        downs = [d1_full]
        cur = d1_full
        for i in range(2, passes + 1):
            cur = bloom_mod.downsample_13tap(cur, *sizes[i])
            downs.append(cur)
        for i in range(passes - 1, 0, -1):
            cur = bloom_mod.upsample_tent9(cur, *sizes[i], factor=1.0)

        # ---- final full-res tent, sharded: up2 slab covering dst rows
        # [y0-3, y0+rows+3); boundary clamps are exact because up[0]==up1[0]
        # and up[-1]==up1[-1] under the half-pixel 2x upsample
        up_slab = bloom_mod._up2(_edge_slab(cur, y0 // 2, rows // 2, 2, 2))
        tent = jnp.zeros_like(taa_rows)
        for dy, wy in ((-3, 1.0), (0, 2.0), (3, 1.0)):
            for dx, wx in ((-3, 1.0), (0, 2.0), (3, 1.0)):
                tent = tent + (wx * wy) * sx(
                    jax.lax.dynamic_slice_in_dim(up_slab, 4 + dy, rows, 0),
                    0, dx,
                )
        bloom_rows = taa_rows + tent * (cfg.bloom_strength / 16.0)
        # bf16 storage matching the single-chip path (renderer.py): the
        # f32 level values are identical between paths, so the rounding is too
        pyramid = sampling.pack_mip_atlas(downs).astype(jnp.bfloat16)

    final_rows = colorlib.gamma_encode(
        colorlib.aces_approx(cfg.exposure * bloom_rows)
    )
    return final_rows, taa_out, pyramid


def sharded_frame_fn(scene, cfg: RenderConfig, mesh: Mesh, raster_backend="xla"):
    """Builds the jitted sharded step — the multi-card `render_frame`.

    step(states [dp-stacked FrameState], cams [dp-stacked CameraState tuple],
         sun_angle [2], prefiltered_env, brdf_lut)
      -> (new states [dp-stacked], final images [dp, H, W, 3])

    Mirrors app.renderer.render_frame pass for pass (the single-queue frame,
    render.cpp:954-1196) via the shared frame_inputs/build_globals/post_stack
    helpers; see module docstring for what is sharded vs replicated.
    """
    sp = mesh.shape["sp"]
    # reduced-res GI/shaft upsampling would clamp at shard edges and seam;
    # with the work already spread over chips, run those passes at full res
    # (gi_temporal_div likewise: the column-interleave cache is a
    # single-chip latency optimization — with dp*sp chips the GI block is
    # already divided by sp, and a row-sharded stale-column cache would need
    # its own all_gather to stay seam-free)
    cfg = cfg.replace(gi_res_divisor=1, gi_res_divisor_diffuse=1,
                      shaft_res_divisor=1, sky_res_divisor=1,
                      gi_temporal_div=1)
    h, w = cfg.height, cfg.width
    # the tile kernel masks partial edge tiles, so any band height works
    assert h % sp == 0, "height must be divisible by sp"
    rows = h // sp
    sm = cfg.shadow_map_size
    assert sm % sp == 0, "shadow_map_size must be divisible by sp"
    sm_rows = sm // sp

    def per_frame(state: rmod.FrameState, cam: rmod.CameraState, sun_angle,
                  pre_env, lut):
        """Runs inside shard_map for one dp slice; sp = row sharding."""
        frame_idx = state.frame_idx
        sp_idx = jax.lax.axis_index("sp")
        y0 = sp_idx * rows

        fi = rmod.frame_inputs(state, cam, sun_angle, cfg)

        # ---- pass 1: sun depth — shard shadow-map rows, gather -----------
        if cfg.enable_shadows:
            def draw_sun(_):
                _, sd, _, pairs = rmod._rasterize(
                    scene, fi.sun_from_world, sm, sm, cfg, cull="none",
                    backend=raster_backend, rows=sm_rows,
                    y_origin=sp_idx * sm_rows,
                )
                return jnp.where(jnp.isinf(sd), 1.0, sd), pairs

            def cached_sun(_):
                sd = jax.lax.dynamic_slice_in_dim(
                    state.sun_depth, sp_idx * sm_rows, sm_rows, 0
                )
                return sd, jnp.int32(0)

            sd_rows, sun_pairs = jax.lax.cond(fi.sun_changed, draw_sun,
                                              cached_sun, None)
            # collective outside the cond: every shard takes the same branch
            # (sun_changed is replicated) but keep the gather unconditional
            sun_depth = jax.lax.all_gather(sd_rows, "sp", axis=0, tiled=True)
        else:
            sun_depth = state.sun_depth
            sun_pairs = jnp.int32(0)

        # ---- pass 2: voxelize (cond) — exact sample-stream split ---------
        if cfg.enable_gi:
            def do_voxelize(_):
                return gi.voxelize_scene(
                    scene, cfg.lightgrid_size, cfg.lightgrid_scale, sun_depth,
                    fi.sun_from_world, fi.sun_dir,
                    cfg.voxelize_sun_emission_scale * jnp.asarray(cfg.sun_color),
                    total_samples=cfg.voxelize_samples or (1 << 20),
                    shard_idx=sp_idx, shard_count=sp,
                )

            part = jax.lax.cond(
                fi.sun_changed, do_voxelize,
                lambda _: jnp.zeros((cfg.lightgrid_size,) * 3, jnp.uint32),
                None,
            )
            # combine the PACKED partials: u32 max is associative/total on the
            # packed order, so pmax-then-decode == single-chip scatter-max
            # regardless of shard count (the exactness contract)
            full = gi.decode_voxel_grid(jax.lax.pmax(part, "sp"))
            lightgrid = jnp.where(fi.sun_changed, full, state.lightgrid)
            # ---- pass 3: sweep (replicated math), axis rotates per frame -
            lightgrid = rmod.sweep_rotated(lightgrid, frame_idx, cfg)
        else:
            lightgrid = state.lightgrid

        # ---- pass 4: raster + G-buffer for my rows -----------------------
        s, depth, tri, main_pairs = rmod._rasterize(
            scene, cam.clip_from_world, w, h, cfg, jitter=fi.jitter,
            cull="back", backend=raster_backend, rows=rows, y_origin=y0,
        )
        gbuf = gb.gbuffer_pass(
            scene, s, jnp.where(jnp.isinf(depth), 1.0, depth), tri,
            cam.clip_from_world, fi.old_clip_from_world,
            cfg.alpha_test_threshold, row_offset=y0,
            world_from_clip=cam.world_from_clip, jitter=fi.jitter,
            full_size=(h, w), material_filter=cfg.material_filter,
            frame_idx_mod_59=(frame_idx % 59).astype(jnp.float32),
        )
        depth_full = jax.lax.all_gather(gbuf.depth, "sp", axis=0, tiled=True)

        # ---- pass 5: lighting for my rows --------------------------------
        glob = rmod.build_globals(cam, fi, frame_idx)
        res = lighting.LightingResources(
            sun_depth=sun_depth, lightgrid=lightgrid, prefiltered_env=pre_env,
            brdf_lut=lut, prev_frame_atlas=state.prev_pyramid,
        )
        hdr_rows = lighting.lighting_pass(
            gbuf, glob, res, cfg, row_offset=y0, full_height=h,
            depth_full=depth_full,
        )

        # ---- gather HDR + velocity; passes 6-9 run row-sharded -----------
        hdr = jax.lax.all_gather(hdr_rows, "sp", axis=0, tiled=True)
        velocity = jax.lax.all_gather(gbuf.velocity, "sp", axis=0, tiled=True)
        final_rows, taa_out, pyramid = _post_stack_sharded(
            hdr, depth_full, velocity, state, cfg, y0, rows
        )
        final = jax.lax.all_gather(final_rows, "sp", axis=0, tiled=True)

        new_state = rmod.FrameState(
            lightgrid=lightgrid,
            sun_depth=sun_depth,
            taa_history=taa_out,
            velocity_prev=velocity,
            prev_pyramid=pyramid,
            clip_from_world_prev=cam.clip_from_world,
            sun_angle_prev=jnp.asarray(sun_angle, jnp.float32),
            frame_idx=frame_idx + 1,
            raster_pairs=jnp.maximum(
                state.raster_pairs,
                jax.lax.pmax(jnp.maximum(sun_pairs, main_pairs), "sp"),
            ),
            gi_cache=state.gi_cache,
        )
        return new_state, final

    def step(states, cams, sun_angle, pre_env, lut):
        """states/cams: pytrees with a leading [dp] axis on every leaf."""

        def shard_fn(state_l, cams_l, sun_l, pre_l, lut_l):
            state = jax.tree.map(lambda x: x[0], state_l)
            cam = rmod.CameraState(*(x[0] for x in cams_l))
            new_state, img = per_frame(state, cam, sun_l, pre_l, lut_l)
            return jax.tree.map(lambda x: x[None], new_state), img[None]

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("dp"), P("dp"), P(), P(), P()),
            out_specs=(P("dp"), P("dp")),
            check_vma=False,
        )(states, tuple(cams), sun_angle, pre_env, lut)

    return jax.jit(step)


def stack_states(states):
    """Stack per-dp-slice FrameStates into the [dp, ...] pytree `step` takes."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def stack_cams(cams):
    """Stack CameraStates into the [dp, ...] tuple `step` takes."""
    return tuple(
        jnp.stack([np.asarray(getattr(c, f)) for c in cams])
        for f in rmod.CameraState._fields
    )
