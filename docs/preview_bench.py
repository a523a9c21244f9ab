"""End-to-end latency of the interactive preview loop.

The preview client (app/preview.py) is the parity feature for the
reference's live window (main.cpp:58-101): tick = input poll -> camera ->
render -> PNG encode -> HTTP.  This harness drives PreviewSession.tick()
exactly as the serve loop does — real device render step, real frame
encode, a small mouse-look event stream each tick (so the camera moves
every tick) — and reports the per-stage split.

Usage: python docs/preview_bench.py [--width 960 --height 544 --ticks 12]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--detail", type=float, default=1.0)
    ap.add_argument("--texture-size", type=int, default=128)
    ap.add_argument("--ticks", type=int, default=12)
    ap.add_argument("--raster", default="auto")
    args = ap.parse_args()

    import numpy as np

    from vulkan_pbr_renderer.app.headless import build_scene_by_name
    from vulkan_pbr_renderer.app.preview import PreviewSession
    from vulkan_pbr_renderer.app.renderer import Renderer
    from vulkan_pbr_renderer.config import RenderConfig
    from vulkan_pbr_renderer.gpu import device
    from vulkan_pbr_renderer.utils import image as imglib

    device.init_devices()
    cfg = RenderConfig(width=args.width, height=args.height)
    scene = build_scene_by_name("suntemple", detail=args.detail,
                                texture_size=args.texture_size)
    r = Renderer(cfg, scene, raster_backend=args.raster)

    render_ms = []

    def render_step(cam, sun_angle, visualize):
        t0 = time.perf_counter()
        img = np.asarray(r.render(cam, sun_angle=sun_angle))
        render_ms.append((time.perf_counter() - t0) * 1000.0)
        return img

    session = PreviewSession(render_step, cfg,
                             start_pos=(0.0, -20.0, 3.0))

    t0 = time.perf_counter()
    session.tick()
    print(f"# compile+first tick: {time.perf_counter() - t0:.1f}s",
          flush=True)

    render_ms.clear()
    tick_ms = []
    encode_ms = []
    for k in range(args.ticks):
        # a small right-drag look each tick: the camera matrix changes, so
        # every render call is distinct, and the event path (push_events -> InputFrame -> camera_controls)
        # is exercised like a real browser client
        session.push_events([["press", "MouseRight"], ["mouse", 3, 1],
                             ["release", "MouseRight"]])
        t0 = time.perf_counter()
        session.tick()
        tick_ms.append((time.perf_counter() - t0) * 1000.0)
        # re-measure the transport encode alone on a noise frame (a real
        # frame's entropy; a blank frame underestimates it)
        noise = np.random.default_rng(k).random(
            (cfg.height, cfg.width, 3), np.float32)
        te = time.perf_counter()
        imglib.encode_jpeg(noise)
        encode_ms.append((time.perf_counter() - te) * 1000.0)

    def stats(xs):
        xs = sorted(xs)
        return f"min {xs[0]:.0f} / med {xs[len(xs) // 2]:.0f} / max {xs[-1]:.0f} ms"

    print(f"# {args.width}x{args.height}, {scene.num_tris} tris, "
          f"backend={r.raster_backend}")
    print(f"tick end-to-end: {stats(tick_ms)}")
    print(f"  render (jit call + device + host fetch):   {stats(render_ms)}")
    print(f"  transport encode (noise-frame estimate):   {stats(encode_ms)}")


if __name__ == "__main__":
    main()
