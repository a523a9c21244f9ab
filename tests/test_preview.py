"""Interactive preview client: session loop + HTTP protocol (the stand-in
for the reference's live window loop, main.cpp:53-101)."""

import json
import urllib.request

import numpy as np

from vulkan_pbr_renderer.app import preview
from vulkan_pbr_renderer.config import RenderConfig

CFG = RenderConfig(width=32, height=16)


def _render_step(calls):
    def step(cam, sun_angle, visualize):
        calls.append((np.asarray(cam.position), tuple(sun_angle), visualize))
        img = np.zeros((CFG.height, CFG.width, 3), np.float32)
        img[..., 0] = float(np.asarray(cam.position)[1])  # encode camera y
        return img

    return step


def test_session_tick_applies_input():
    calls = []
    s = preview.PreviewSession(_render_step(calls), CFG, start_pos=(0, -6, 2.5))
    s.tick()  # no input
    p0 = np.asarray(s.camera.pos).copy()
    # movement requires focus = MouseRight-or-Ctrl held (camera.h:51-67)
    s.push_events([["press", "KeyW"]])
    s.tick()
    assert abs(s.camera.pos[1] - p0[1]) < 1e-6  # no focus -> no movement
    s.push_events([["press", "MouseRight"]])
    for _ in range(5):
        s.tick()
    assert s.camera.pos[1] > p0[1] + 0.05  # moved forward (+Y view dir)
    s.push_events([["release", "MouseRight"]])
    # W held across ticks (reset keeps down-state)
    assert s.inputs.is_down(ord("W"))
    s.push_events([["release", "KeyW"], ["press", "Digit0"]])
    s.tick()
    assert s.sun_angle[0] > 35.0
    s.push_events([["press", "KeyG"]])
    s.tick()
    assert calls[-1][2] is True  # visualize_lightgrid passed to render step
    s.push_events([["press", "Escape"]])
    s.tick()
    assert s.quit


def test_mouse_look_requires_right_button():
    calls = []
    s = preview.PreviewSession(_render_step(calls), CFG)
    yaw0 = s.camera.yaw
    s.push_events([["mouse", 50, 0]])
    s.tick()
    assert s.camera.yaw == yaw0
    s.push_events([["press", "MouseRight"], ["mouse", 50, 0]])
    s.tick()
    assert s.camera.yaw != yaw0


def test_session_with_real_renderer():
    """End-to-end: the preview session drives the actual Renderer on a tiny
    scene — input moves the camera, the lightgrid debug toggle switches the
    render path, and frames encode."""
    import jax.numpy as jnp

    from vulkan_pbr_renderer.app.renderer import Renderer, render_frame
    from vulkan_pbr_renderer.assets import MaterialDesc, build_scene, procedural

    cfg = RenderConfig(
        width=64, height=32, shadow_map_size=32, lightgrid_size=8,
        lightgrid_extent=8.0, prefiltered_env_size=16,
        prefiltered_env_min_size=8, prefilter_samples=16, brdf_lut_size=16,
        brdf_lut_samples=16, bloom_pass_count=2, gi_screen_trace_steps=2,
        gi_diffuse_steps=2, gi_specular_steps=2, light_shaft_steps=2,
    )
    scene = build_scene(
        [procedural.make_plane((0, 0, 0), (10, 10), 2, 0),
         procedural.make_cube((0, 0, 1.0), (1, 1, 2), 0)],
        [MaterialDesc()], texture_size=16)
    r = Renderer(cfg, scene, use_cache=False, raster_backend="xla")

    def render_step(cam, sun_angle, visualize):
        c = r.cfg.replace(visualize_lightgrid=visualize)
        r.state, img = render_frame(
            r.scene, r.state, cam, jnp.asarray(sun_angle, jnp.float32),
            r.prefiltered_env, r.brdf_lut, c, r.raster_backend)
        return img

    s = preview.PreviewSession(render_step, cfg, start_pos=(0, -5, 2))
    s.push_events([["press", "KeyW"], ["press", "MouseRight"]])
    s.tick()
    magic = bytes(s.frame_png[:8])
    # JPEG (SOI marker) when PIL is present, PNG otherwise (image.encode_jpeg)
    assert (magic[:2] == b"\xff\xd8" or magic == b"\x89PNG\r\n\x1a\n")
    assert s.frame_count == 1
    s.push_events([["press", "KeyG"]])
    s.tick()   # lightgrid debug view renders through the DDA path
    assert s.visualize_lightgrid and s.frame_count == 2
    assert s.camera.pos[1] > -5.0


def test_http_server_roundtrip():
    calls = []
    s = preview.PreviewSession(_render_step(calls), CFG)
    server = preview.serve(s, port=0, run_loop=False)
    try:
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"
        page = urllib.request.urlopen(f"{base}/").read()
        assert b"frame.png" in page
        body = json.dumps([["press", "KeyW"]]).encode()
        req = urllib.request.Request(f"{base}/input", data=body, method="POST")
        assert urllib.request.urlopen(req).status == 200
        s.tick()
        png = urllib.request.urlopen(f"{base}/frame.png").read()
        assert png[:2] == b"\xff\xd8" or png[:8] == b"\x89PNG\r\n\x1a\n"
        stats = urllib.request.urlopen(f"{base}/stats").read().decode()
        assert "frame 1" in stats and "sun" in stats
        assert s.inputs.is_down(ord("W"))
    finally:
        server.shutdown()
