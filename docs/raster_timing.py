"""Time the tile raster kernel, its binning, and the plain XLA rasterizer.

    python docs/raster_timing.py [--tiles 16,32] [--sweep] [--xla-full]
                                 [--reps N] [--out FILE]

Runs on the GPU (exits on any other backend).  For each view it times, with
block_until_ready around jitted calls (median of --reps after one warm-up):

  bin     raster.binning.bin_triangles alone
  kernel  raster.tiled.raster_bins alone, on precomputed bins
  tiled   bin + kernel (what the frame runs)
  xla     raster.xla_raster.rasterize_vis (every triangle against every
          pixel; fewer reps; at full size only with --xla-full, where one
          call takes tens of seconds)

Views: the 960x544 scale config of tests/test_goldens_scale.py (SunTemple
stand-in at detail 0.4, 512^2 sun map) and the full size (detail 4.5,
638,700 triangles, 1920x1080 main view, 2048^2 sun view), each at every
tile of --tiles (default: the config's raster_tile).  --sweep also times
the kernel alone over chunk / num_warps at each tile at full size.  One JSON
object per line goes to --out; a summary goes to stdout.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_ms(fn, reps):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(1e3 * (time.perf_counter() - t0))
    ts.sort()
    return ts[len(ts) // 2], ts[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", default="",
                    help="comma-separated tile sizes (default: raster_tile)")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--xla-full", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/raster_timing.jsonl")
    args = ap.parse_args()

    import jax
    import numpy as np

    if jax.default_backend() != "gpu":
        sys.exit(f"raster_timing: needs a GPU, found {jax.default_backend()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    from vulkan_pbr_renderer.app.renderer import make_camera
    from vulkan_pbr_renderer.assets import build_scene, suntemple
    from vulkan_pbr_renderer.config import RenderConfig
    from vulkan_pbr_renderer.raster import binning, tiled, xla_raster
    from vulkan_pbr_renderer.raster import setup as rsetup
    from vulkan_pbr_renderer.shade import shadow

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "a")

    def record(**kw):
        kw.update(card=card, device_kind=jax.devices()[0].device_kind)
        out.write(json.dumps(kw) + "\n")
        out.flush()
        print(json.dumps(kw), flush=True)

    @functools.partial(jax.jit, static_argnums=(2, 3, 4))
    def setup(pos, mat, w, h, cull):
        return rsetup.setup_triangles(rsetup.transform_to_clip(pos, mat),
                                      w, h, cull=cull)

    def views(detail, cfg):
        scene = build_scene(suntemple.build_parts(detail),
                            suntemple.materials(), texture_size=16)
        pos = scene.tri_attr[:, :9].reshape(-1, 3, 3)
        cam = make_camera(*suntemple.camera_path(0.3), cfg)
        sun, _ = shadow.sun_matrices(35.0, 80.0, cfg.sun_half_size)
        sm = cfg.shadow_map_size
        cap = cfg.pair_capacity_factor * scene.num_tris
        return scene.num_tris, cap, [
            ("main", setup(pos, cam.clip_from_world, cfg.width, cfg.height,
                           "back"), cfg.width, cfg.height),
            ("sun", setup(pos, sun, sm, sm, "none"), sm, sm),
        ]

    def time_kernel(size, cap, name, s, w, h, tile, **kw):
        bins = jax.block_until_ready(jax.jit(
            lambda s: binning.bin_triangles(s, w, h, tile, cap))(s))
        ker_fn = jax.jit(lambda b: tiled.raster_bins(b, w, h, tile, **kw))
        t0 = time.perf_counter()
        jax.block_until_ready(ker_fn(bins))
        row = dict(size=size, view=name, pairs=int(bins.total_pairs),
                   pair_capacity=cap, tile=tile, **kw,
                   compile_and_first_s=round(time.perf_counter() - t0, 3))
        row["kernel_ms"], row["kernel_min_ms"] = _median_ms(
            lambda: ker_fn(bins), args.reps)
        record(**row)

    def time_view(size, n_tris, cap, name, s, w, h, xla_reps, tile, **kw):
        bin_fn = jax.jit(lambda s: binning.bin_triangles(s, w, h, tile, cap))
        bins = jax.block_until_ready(bin_fn(s))
        ker_fn = jax.jit(lambda b: tiled.raster_bins(b, w, h, tile, **kw))
        full_fn = jax.jit(lambda s: tiled.rasterize_tiled(
            s, w, h, tile, cap, **kw))
        t0 = time.perf_counter()
        depth, tri, pairs = jax.block_until_ready(full_fn(s))
        compile_s = time.perf_counter() - t0
        row = dict(size=size, view=name, width=w, height=h, tris=n_tris,
                   pairs=int(pairs), pair_capacity=cap, tile=tile, **kw,
                   compile_and_first_s=round(compile_s, 3))
        row["bin_ms"], row["bin_min_ms"] = _median_ms(lambda: bin_fn(s),
                                                      args.reps)
        row["kernel_ms"], row["kernel_min_ms"] = _median_ms(
            lambda: ker_fn(bins), args.reps)
        row["tiled_ms"], row["tiled_min_ms"] = _median_ms(
            lambda: full_fn(s), args.reps)
        if xla_reps:
            xla_fn = jax.jit(lambda s: xla_raster.rasterize_vis(s, w, h))
            d_ref, t_ref = jax.block_until_ready(xla_fn(s))
            row["xla_ms"], row["xla_min_ms"] = _median_ms(
                lambda: xla_fn(s), xla_reps)
            row["ids_agree"] = float(np.mean(np.asarray(tri)
                                             == np.asarray(t_ref)))
        record(**row)

    full = RenderConfig()
    tiles = [int(t) for t in args.tiles.split(",") if t] or [full.raster_tile]
    scale = RenderConfig(width=960, height=544, shadow_map_size=512)
    n, cap, vs = views(0.4, scale)
    for tile in tiles:
        for name, s, w, h in vs:
            time_view("scale", n, cap, name, s, w, h, 5, tile)

    n, cap, vs = views(4.5, full)
    for tile in tiles:
        for name, s, w, h in vs:
            time_view("full", n, cap, name, s, w, h,
                      2 if args.xla_full else 0, tile)
    if args.sweep:
        for tile in tiles:
            for name, s, w, h in vs:
                for warps in (2, 4, 8):
                    for chunk in (1, 2, 4, 8):
                        time_kernel("full", cap, name, s, w, h, tile,
                                    chunk=chunk, num_warps=warps)


if __name__ == "__main__":
    main()
