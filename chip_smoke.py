#!/usr/bin/env python3
"""Smoke test of the renderer on an NVIDIA GPU, through its normal entry points.

    python chip_smoke.py           # phases 1-4 on one card
    python chip_smoke.py --four    # only the sharded frame on four cards

Phases (one process; any failure exits nonzero before the result line):

1. Device: JAX must see a GPU; the card's name and power limit are printed.
2. Tile raster kernel vs the plain XLA rasterizer on the full SunTemple
   stand-in (638,700 triangles): the whole 1920x1080 main view and 2048^2
   sun view, and bands of rows rasterized on their own (traced y_origin,
   partial edge tiles).
3. Frame correctness: the 960x544 scale config through the kernel, SSIM
   against tests/goldens/suntemple_960_fast.png.
4. The main path at full size: Renderer.render at 1920x1080 with every pass
   (2048^2 shadow map, 128^3 lightgrid, fast GI with the temporal
   interleave) for 6 frames along the fly-through.

--four runs only the row-sharded frame (dp=1 x sp=4) against single-card
render_frame on device 0 under the same config.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain reference, over whole views: triangle ids agree on >= 99.99%
# of the pixels, and where they agree depth is within 1e-6 on >= 99.99% of
# them and within 1e-4 everywhere.  Triton and XLA may contract the
# edge-function FMAs differently: a pixel centre lying on an edge can flip to
# the neighbouring triangle, and where two surfaces meet within an ulp of
# depth the kernel's rational depth test and XLA's divided one may pick
# different ones.  The edge functions are evaluated in pixel space, so their
# rounding is relative to |a*px| + |b*py| + |c|; a steep triangle (a wall
# seen edge-on from the sun) multiplies it by its depth slope.  1e-4 stays
# an order of magnitude under the shadow-map biases (1e-3).  A band
# rasterized on its own must equal the same rows of the full view exactly.
ID_AGREE_MIN = 0.9999
DEPTH_ATOL = 1e-6
DEPTH_AGREE_MIN = 0.9999
DEPTH_ATOL_ALL = 1e-4
SSIM_MIN = 0.97       # the scale golden's own threshold (test_goldens_scale)
# --four: sharded vs single-card image at the tolerance of
# tests/test_parallel.py's pallas parity test (atol = rtol = 2e-4), on all
# but 0.01% of the pixels: the sharded frame sets up its triangles in another
# XLA program, which may contract the edge FMAs differently, so a pixel
# centre on an edge can flip as in the raster check above.
FOUR_ATOL = 2e-4
FOUR_RTOL = 2e-4
FOUR_OFF_MAX = 1e-4


def log(msg):
    print(msg, flush=True)


def gpu_name_and_power():
    """nvidia-smi's name and power limit, from a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def require_gpu(count):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX found {devs[0].platform!r})")
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX found {len(devs)}")
    return devs


def full_scene():
    from vulkan_pbr_renderer.assets import build_scene, suntemple

    scene = build_scene(suntemple.build_parts(detail=4.5),
                        suntemple.materials(), texture_size=256)
    assert scene.num_tris == 638_700, scene.num_tris
    return scene


def _edge_margin(setup, tri_ids, ys, xs):
    """Relative distance of pixel centres from the nearest edge of each
    given triangle, in float64: min_j |e_j| / sum_i |adj_ij p_i|.  A pixel
    whose margin is at rounding level lies on an edge, where f32 evaluation
    order decides coverage."""
    import numpy as np

    adj = np.asarray(setup.adj, np.float64)[tri_ids]          # [n,3,3]
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    p = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1)
    terms = adj * p[:, :, None]                                # [n,3(i),3(j)]
    e = terms.sum(1)
    return (np.abs(e) / np.abs(terms).sum(1)).min(-1)


def view_check(name, depth, tri, depth_ref, tri_ref, setup):
    """Kernel vs xla_raster over one view, at the tolerances above."""
    import numpy as np

    depth, tri = np.asarray(depth), np.asarray(tri)
    depth_ref, tri_ref = np.asarray(depth_ref), np.asarray(tri_ref)
    agree = tri == tri_ref
    frac = float(agree.mean())
    fin = lambda d: np.where(np.isinf(d), -1.0, d)
    dz = np.abs(fin(depth) - fin(depth_ref))
    dz_agree = dz[agree]
    near = float((dz_agree <= DEPTH_ATOL).mean())
    covered = float((tri_ref >= 0).mean())
    log(f"  {name}: ids agree {frac:.6f} ({int((~agree).sum())} px differ); "
        f"where they agree depth within {DEPTH_ATOL:g} on {near:.6f}, max "
        f"|d depth| {dz_agree.max():.3g}; covered {covered:.3f}")
    if not agree.all():
        ys, xs = np.nonzero(~agree)
        m_k = _edge_margin(setup, np.maximum(tri[ys, xs], 0), ys, xs)
        m_r = _edge_margin(setup, np.maximum(tri_ref[ys, xs], 0), ys, xs)
        both = (tri[ys, xs] >= 0) & (tri_ref[ys, xs] >= 0)
        log(f"    differing px: {int(both.sum())} covered by both; |d depth| "
            f"there max {dz[ys, xs].max():.3g}; edge margin min(kernel tri, "
            f"ref tri) max {np.minimum(m_k, m_r).max():.3g} (f32 ulp 6e-8)")
    if near < 1.0:
        y, x = np.unravel_index(np.argmax(np.where(agree, dz, 0.0)), dz.shape)
        log(f"    worst agreeing px y {y} x {x}: tri {tri[y, x]}, |d depth| "
            f"{dz[y, x]:.3g}, edge-rounding bound "
            f"{_depth_rounding(setup, tri[y, x], y, x):.3g}")
    assert covered > 0.0, f"{name}: empty view compares nothing"
    assert frac >= ID_AGREE_MIN, f"{name}: ids agree on {frac} < {ID_AGREE_MIN}"
    assert near >= DEPTH_AGREE_MIN, f"{name}: depth within {DEPTH_ATOL} on {near}"
    assert dz_agree.max() <= DEPTH_ATOL_ALL, f"{name}: depth differs by {dz.max()}"


def _depth_rounding(setup, tri_id, y, x):
    """Depth error that one f32 rounding of each edge function causes at a
    pixel: sum_j |dz_j| * ulp(sum_i |adj_ij p_i|) / |esum|, in float64."""
    import numpy as np

    adj = np.asarray(setup.adj[tri_id], np.float64)
    zv = np.asarray(setup.z_vert[tri_id], np.float64)
    p = np.array([x + 0.5, y + 0.5, 1.0])
    terms = np.abs(adj * p[:, None]).sum(0)
    esum = (adj * p[:, None]).sum()
    ulp = 2.0 ** -24
    return float((abs(zv[1]) * terms[1] + abs(zv[2]) * terms[2]) * ulp
                 / max(abs(esum), 1e-30))


def phase_raster(scene):
    """Kernel vs xla_raster at real widths on banded rows."""
    import functools

    import jax
    import numpy as np

    from vulkan_pbr_renderer.app.renderer import make_camera
    from vulkan_pbr_renderer.assets import suntemple
    from vulkan_pbr_renderer.config import RenderConfig
    from vulkan_pbr_renderer.raster import setup as rsetup
    from vulkan_pbr_renderer.raster import tiled, xla_raster
    from vulkan_pbr_renderer.shade import shadow

    cfg = RenderConfig()
    tri_pos = scene.tri_attr[:, :9].reshape(-1, 3, 3)
    cap = cfg.pair_capacity_factor * scene.num_tris

    @functools.partial(jax.jit, static_argnums=(2, 3, 4))
    def setup(pos, mat, w, h, cull):
        return rsetup.setup_triangles(rsetup.transform_to_clip(pos, mat),
                                      w, h, cull=cull)

    @functools.partial(jax.jit, static_argnums=(1, 2))
    def kernel(s, w, h, y0):
        return tiled.rasterize_tiled(s, w, h, tile=cfg.raster_tile,
                                     pair_capacity=cap, y_origin=y0)

    @functools.partial(jax.jit, static_argnums=(1, 2))
    def plain(s, w, h, y0):
        return xla_raster.rasterize_vis(s, w, h, y_origin=y0)

    cam = make_camera(*suntemple.camera_path(0.3), cfg)
    sun_mat, _ = shadow.sun_matrices(35.0, 80.0, cfg.sun_half_size)
    sm = cfg.shadow_map_size
    views = [
        # (name, matrix, width, height, cull, [(band y0, band rows)]); the
        # main view's last tile row is partial (1080 = 33 * 32 + 24)
        ("main 1920x1080", cam.clip_from_world, cfg.width, cfg.height,
         "back", [(512, 32), (cfg.height - 40, 40)]),
        ("sun 2048x2048", sun_mat, sm, sm, "none", [(1000, 40)]),
    ]
    for name, mat, w, h, cull, bands in views:
        s = setup(tri_pos, mat, w, h, cull)
        t0 = time.perf_counter()
        depth, tri, pairs = jax.block_until_ready(kernel(s, w, h, 0))
        log(f"{name}: kernel compile+run {time.perf_counter() - t0:.2f} s, "
            f"{int(pairs)} pairs (capacity {cap})")
        assert int(pairs) <= cap
        t0 = time.perf_counter()
        d_ref, t_ref = jax.block_until_ready(plain(s, w, h, 0))
        log(f"{name}: xla_raster compile+run {time.perf_counter() - t0:.2f} s")
        view_check(f"{name} full view", depth, tri, d_ref, t_ref, s)
        for y0, rows in bands:
            # the band rasterized on its own (traced y_origin, a partial
            # tile wherever rows is not a multiple of the tile) runs the same
            # per-pixel arithmetic over the same ascending-id triangles
            d_b, t_b, _ = kernel(s, w, rows, y0)
            np.testing.assert_array_equal(np.asarray(t_b),
                                          np.asarray(tri[y0:y0 + rows]))
            np.testing.assert_array_equal(np.asarray(d_b),
                                          np.asarray(depth[y0:y0 + rows]))
            log(f"  {name} rows [{y0}, {y0 + rows}) as a band: equal to the "
                "full view's rows")


def phase_golden():
    """The 960x544 scale config through the kernel vs its golden image."""
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_goldens_scale import GOLDEN_DIR, SCALE, _scene

    from vulkan_pbr_renderer.app import Renderer, make_camera
    from vulkan_pbr_renderer.assets import suntemple
    from vulkan_pbr_renderer.utils import image

    cfg = SCALE.replace(gi_mode="fast")
    r = Renderer(cfg, _scene(), use_cache=False, raster_backend="pallas")
    cam = make_camera(*suntemple.camera_path(0.3), cfg)
    for _ in range(2):  # settle GI sweep + TAA one step, as the golden test
        img = r.render(cam, sun_angle=(35.0, 80.0))
    img = np.asarray(img)
    golden = image.read_png(
        os.path.join(GOLDEN_DIR, "suntemple_960_fast.png")
    ).astype(np.float32) / 255.0
    s = float(image.ssim(img, golden))
    log(f"960x544 scale frame: SSIM {s:.4f} vs suntemple_960_fast.png "
        f"(min {SSIM_MIN})")
    assert np.isfinite(img).all()
    assert s >= SSIM_MIN, f"SSIM {s} < {SSIM_MIN}"
    r.check_overflow(strict=True)


def phase_full(scene, card):
    """Renderer.render at 1920x1080, every pass, 6 frames."""
    import jax
    import numpy as np

    from vulkan_pbr_renderer.app import Renderer, make_camera
    from vulkan_pbr_renderer.assets import suntemple
    from vulkan_pbr_renderer.config import RenderConfig

    cfg = RenderConfig()
    r = Renderer(cfg, scene, raster_backend="pallas")
    frames = 6
    cams = [make_camera(*suntemple.camera_path(i / (frames - 1)), r.cfg)
            for i in range(frames)]
    imgs, times = [], []
    for cam in cams:
        t0 = time.perf_counter()
        img = jax.block_until_ready(r.render(cam, sun_angle=(35.0, 80.0)))
        times.append(time.perf_counter() - t0)
        imgs.append(np.asarray(img))
    for i, img in enumerate(imgs):
        assert img.shape == (cfg.height, cfg.width, 3), img.shape
        assert np.isfinite(img).all(), f"frame {i} not finite"
    for i in range(1, frames):
        diff = float(np.abs(imgs[i] - imgs[i - 1]).mean())
        assert diff > 1e-4, f"frame {i} equals frame {i - 1} ({diff})"
    ok, msg = r.check_overflow(strict=True)
    log(f"full frame 1920x1080, {scene.num_tris} tris: overflow check {msg}")
    steady = sorted(times[1:])
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0)
    log(f"full frame on {card}: compile+first {times[0]:.1f} s, steady "
        f"frame {1e3 * steady[len(steady) // 2]:.2f} ms median of "
        f"{len(steady)} (" + " ".join(f"{1e3 * t:.2f}" for t in times[1:])
        + f"), peak device memory {peak / 2**30:.2f} GiB")


def phase_four(scene, cfg):
    """Row-sharded frame on dp=1 x sp=4 vs single-card render_frame."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vulkan_pbr_renderer.app.renderer import (
        Renderer, init_frame_state, make_camera, render_frame,
    )
    from vulkan_pbr_renderer.assets import suntemple
    from vulkan_pbr_renderer.parallel import sharding

    r = Renderer(cfg, scene, raster_backend="pallas")
    cfg = r.cfg  # auto-sized voxelize stream
    # the sharded frame runs GI, shafts and sky at full resolution without
    # the temporal interleave (sharding.sharded_frame_fn); compare like for like
    ref_cfg = cfg.replace(gi_res_divisor=1, gi_res_divisor_diffuse=1,
                          shaft_res_divisor=1, sky_res_divisor=1,
                          gi_temporal_div=1)
    sun = jnp.asarray([35.0, 80.0], jnp.float32)
    cams = [make_camera(*suntemple.camera_path(0.3 + 0.02 * i), cfg)
            for i in range(3)]

    dev0 = jax.devices()[0]
    put0 = lambda x: jax.device_put(x, dev0)
    ref_state = put0(init_frame_state(ref_cfg))
    ref_imgs, ref_states = [], []
    for i, cam in enumerate(cams):
        t0 = time.perf_counter()
        ref_state, img = jax.block_until_ready(render_frame(
            put0(scene), ref_state, put0(cam), put0(sun),
            put0(r.prefiltered_env), put0(r.brdf_lut), ref_cfg, "pallas"))
        log(f"single-card frame {i}: {time.perf_counter() - t0:.3f} s")
        ref_imgs.append(np.asarray(img))
        ref_states.append(jax.tree.map(np.asarray, ref_state))

    mesh = sharding.make_mesh(4, dp=1)
    step = sharding.sharded_frame_fn(scene, cfg, mesh, raster_backend="pallas")
    states = sharding.stack_states([init_frame_state(ref_cfg)])
    for i, cam in enumerate(cams):
        t0 = time.perf_counter()
        states, out = jax.block_until_ready(step(
            states, sharding.stack_cams([cam]), sun, r.prefiltered_env,
            r.brdf_lut))
        dt = time.perf_counter() - t0
        out = np.asarray(out[0])
        err = np.abs(out - ref_imgs[i])
        off = (err > FOUR_ATOL + FOUR_RTOL * np.abs(ref_imgs[i])).any(-1)
        y, x = np.unravel_index(np.argmax(err.max(-1)), off.shape)
        log(f"sharded frame {i}: {dt:.3f} s; vs single card max |d| "
            f"{err.max():.3g} at y {y} x {x}, mean |d| {err.mean():.3g}, "
            f"{int(off.sum())} px ({off.mean():.2e}) outside atol {FOUR_ATOL} "
            f"rtol {FOUR_RTOL} (allowed {FOUR_OFF_MAX:g})")
        # where the two frames part: the sun depth map (sun raster), the
        # velocity (main raster: a flipped pixel takes another triangle's
        # motion) and the TAA output (the HDR image before bloom spreads it)
        for leaf in ("sun_depth", "velocity_prev", "taa_history"):
            a = np.asarray(getattr(states, leaf)[0], np.float32)
            b = np.asarray(getattr(ref_states[i], leaf), np.float32)
            d = np.abs(a - b).reshape(a.shape[0], a.shape[1], -1).max(-1)
            log(f"  {leaf}: max |d| {d.max():.3g}, {int((d > 0).sum())} "
                f"differ, {int((d > FOUR_ATOL).sum())} beyond {FOUR_ATOL}")
        assert out.shape == ref_imgs[i].shape and np.isfinite(out).all()
        assert off.mean() <= FOUR_OFF_MAX, f"frame {i}: {off.mean()} px off"
    pairs = int(np.asarray(states.raster_pairs).max())
    cap = cfg.pair_capacity_factor * scene.num_tris
    log(f"sharded pairs {pairs} (capacity {cap})")
    assert 0 < pairs <= cap


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the row-sharded frame on four cards")
    args = ap.parse_args()
    count = 4 if args.four else 1

    devs = require_gpu(count)
    card = gpu_name_and_power()
    log(f"device: {devs[0].device_kind} x{len(devs)}; nvidia-smi: {card}")

    sys.path.insert(0, HERE)
    import vulkan_pbr_renderer  # noqa: F401  (package config: precision, cache)

    t0 = time.perf_counter()
    scene = full_scene()
    log(f"scene: {scene.num_tris} tris, built in "
        f"{time.perf_counter() - t0:.1f} s")
    if args.four:
        from vulkan_pbr_renderer.config import RenderConfig

        phase_four(scene, RenderConfig(width=1920, height=1088))
    else:
        phase_raster(scene)
        phase_golden()
        phase_full(scene, card)

    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
