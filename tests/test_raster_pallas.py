"""The tile raster kernel (raster/tiled.py, Pallas on the Triton route) must
match the XLA reference rasterizer exactly.  On the CPU the kernel runs in the
Pallas interpreter; the `gpu`-marked test compiles it for the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vulkan_pbr_renderer.assets import MaterialDesc, build_scene, procedural
from vulkan_pbr_renderer.gpu import device
from vulkan_pbr_renderer.raster import binning, setup as rs, tiled, xla_raster as rr
from vulkan_pbr_renderer.utils import math3d as m3


def _random_tris(n, seed=0, depth_range=(0.1, 0.9)):
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1, 1, (n, 1, 2))
    verts = center + rng.uniform(-0.4, 0.4, (n, 3, 2))
    z = rng.uniform(*depth_range, (n, 1, 1)).repeat(3, 1)
    w = np.ones((n, 3, 1), np.float32)
    return jnp.asarray(np.concatenate([verts, z, w], -1).astype(np.float32))


def _single():
    return jnp.asarray(np.array(
        [[[-0.5, -0.5, 0.5, 1.0], [0.5, -0.5, 0.5, 1.0], [0.0, 0.5, 0.5, 1.0]]],
        np.float32))


def _multi_tile():
    # few huge triangles spanning many tiles
    return _random_tris(8, seed=2).at[:, :, :2].multiply(3.0)


def _depth_order():
    # heavy overlap: many tris at the same place, distinct depths
    rng = np.random.default_rng(3)
    n = 64
    base = np.array([[[-0.6, -0.6], [0.6, -0.6], [0.0, 0.6]]], np.float32)
    verts = base + rng.uniform(-0.05, 0.05, (n, 3, 2)).astype(np.float32)
    z = np.linspace(0.2, 0.8, n, dtype=np.float32)[:, None, None].repeat(3, 1)
    w = np.ones((n, 3, 1), np.float32)
    return jnp.asarray(np.concatenate([verts, z, w], -1))


def _scene_tris():
    mats = [MaterialDesc()]
    parts = [procedural.make_plane((0, 0, 0), (10, 10), 2, 0),
             procedural.make_cube((0, 0, 1), (1.5, 1.5, 1.5), 0),
             procedural.make_uv_sphere((2, 1, 1), 0.8, 8, 16, 0)]
    scene = build_scene(parts, mats, texture_size=16)
    cam = m3.perspective_lh_zo(np.deg2rad(60.0), 1.5, 0.1, 100.0) @ m3.look_at(
        jnp.array([4.0, -5.0, 3.0]), jnp.array([0.0, 0.0, 0.5])
    )
    clip = rs.transform_to_clip(scene.positions, cam)
    return clip[scene.indices]


def _near_plane():
    # w spans negative..positive so many triangles cross the camera plane:
    # the directional-extension bbox (setup.py) must still cover every pixel
    # the XLA baseline covers
    rng = np.random.default_rng(21)
    n = 40
    verts = rng.uniform(-2, 2, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).astype(np.float32).repeat(3, 1)
    w = rng.uniform(-0.5, 1.5, (n, 3, 1)).astype(np.float32)
    return jnp.asarray(np.concatenate([verts * np.abs(w), z * np.abs(w), w], -1))


# name: (clip tris, width, height, cull, kernel kwargs, y_origin, setup height)
_CASES = {
    "single": (_single, 256, 128, "none", {}, 0, None),
    "random": (lambda: _random_tris(300, seed=1), 256, 160, "none",
               dict(chunk=2), 0, None),
    "multi_tile": (_multi_tile, 384, 160, "none", dict(tile=16), 0, None),
    "depth_order": (_depth_order, 128, 128, "none", {}, 0, None),
    "scene": (_scene_tris, 192, 128, "back", {}, 0, None),
    "near_plane": (_near_plane, 160, 96, "none", {}, 0, None),
    # heavy overdraw: 600 stacked triangles, deep per-tile segments
    "overdraw": (lambda: _random_tris(600, seed=11), 128, 96, "none",
                 dict(chunk=8), 0, None),
    # partial edge tiles on both axes: masked stores
    "partial_edge_tile": (lambda: _random_tris(200, seed=5), 200, 135, "none",
                          dict(chunk=1, tile=16), 0, None),
    # a band [50, 90) of a 200-row viewport: traced y_origin, partial tile
    "y_origin_band": (lambda: _random_tris(300, seed=6), 200, 40, "none", {},
                      50, 200),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_kernel_matches_xla(case):
    make, w, h, cull, kw, y0, setup_h = _CASES[case]
    clip = make()
    s = rs.setup_triangles(clip, w, setup_h or h, cull=cull)
    d_ref, t_ref = rr.rasterize_vis(s, w, h, y_origin=y0)
    d_got, t_got, pairs = jax.jit(
        lambda s, y0: tiled.rasterize_tiled(
            s, w, h, pair_capacity=16 * clip.shape[0], y_origin=y0, **kw)
    )(s, y0)
    assert 0 < int(pairs) <= 16 * clip.shape[0]
    t_ref = np.asarray(t_ref)
    assert (t_ref >= 0).any()
    np.testing.assert_array_equal(t_ref, np.asarray(t_got))
    dr = np.asarray(d_ref)
    dg = np.asarray(d_got)
    np.testing.assert_array_equal(np.isinf(dr), np.isinf(dg))
    np.testing.assert_allclose(
        np.where(np.isinf(dr), -1, dr), np.where(np.isinf(dg), -1, dg), atol=1e-6
    )


def test_binning_segments_consistent():
    clip = _random_tris(100, seed=4)
    s = rs.setup_triangles(clip, 256, 128, cull="none")
    bins = binning.bin_triangles(s, 256, 128, tile=64, pair_capacity=1024)
    assert bins.tiles_x == 4 and bins.tiles_y == 2
    assert bins.pair_data.shape == (13, 1024)
    starts = np.asarray(bins.starts)
    total = int(bins.total_pairs)
    assert starts[0] == 0 and starts[-1] == total
    enc = np.asarray(bins.pair_data[12])[:total]
    ids = (np.abs(enc) - 1).astype(np.int64)
    assert (np.diff(starts) >= 0).all()
    assert (ids >= 0).all()
    # the sign of the id code carries the depth mode
    np.testing.assert_array_equal(enc > 0, np.asarray(s.z_mode)[ids])
    # per-tile segments hold ascending tri ids (the kernel's tie-break rule)
    for t in range(starts.shape[0] - 1):
        seg = ids[starts[t] : starts[t + 1]]
        assert (np.diff(seg) > 0).all()  # each tri at most once per tile
    # every valid triangle appears in at least one tile
    valid_ids = set(np.nonzero(np.asarray(s.valid))[0].tolist())
    assert valid_ids == set(ids.tolist())


def test_pair_capacity_overrun_is_counted():
    # 40 big triangles each spanning several 32px tiles: the true pair count
    # exceeds a pair_capacity of one pair per triangle, binning drops pairs,
    # and total_pairs reports the true count so the host can tell
    clip = _random_tris(40, seed=7).at[:, :, :2].multiply(2.0)
    s = rs.setup_triangles(clip, 128, 96, cull="none")
    _, t_small, pairs = tiled.rasterize_tiled(s, 128, 96, pair_capacity=40)
    assert int(pairs) > 40
    d_ref, t_ref = rr.rasterize_vis(s, 128, 96)
    assert (np.asarray(t_small) != np.asarray(t_ref)).any()  # pairs dropped
    # with ample capacity the same scene is exact and reports the same count
    _, t_big, pairs2 = tiled.rasterize_tiled(s, 128, 96, pair_capacity=4096)
    assert int(pairs2) == int(pairs) <= 4096
    np.testing.assert_array_equal(np.asarray(t_big), np.asarray(t_ref))


def test_interpret_policy(monkeypatch):
    # the CPU suite interprets, the GPU compiles; any other backend is an
    # error, never a silent fall back to the interpreter
    assert device.pallas_interpret() is True
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert device.pallas_interpret() is False
    monkeypatch.setattr(jax, "default_backend", lambda: "other")
    with pytest.raises(RuntimeError):
        device.pallas_interpret()


def test_renderer_check_overflow(tmp_path):
    # end-to-end: render a frame through the pallas backend with a pair
    # budget too small for the scene and confirm the host-side check flags
    # the drop; the default budget renders clean
    from vulkan_pbr_renderer.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer.config import RenderConfig

    mats = [MaterialDesc()]
    parts = [procedural.make_uv_sphere((0, 0, 1), 1.0, 12, 24, 0)]
    scene = build_scene(parts, mats, texture_size=16)
    cfg = RenderConfig(
        width=128, height=64, shadow_map_size=64, lightgrid_size=8,
        prefiltered_env_size=16, prefiltered_env_min_size=8,
        prefilter_samples=16, brdf_lut_size=16, brdf_lut_samples=16,
        bloom_pass_count=2, gi_screen_trace_steps=2, gi_diffuse_steps=2,
        gi_specular_steps=2, light_shaft_steps=2, raster_tile=16,
        # the subject is the overflow counter (main + sun raster); the
        # shading stack behind it is irrelevant, and with it off the two
        # Renderer compiles are ~5x cheaper
        enable_gi=False, enable_taa=False, enable_bloom=False,
        enable_light_shafts=False, enable_ibl=False,
    )
    cam = make_camera((0.0, -4.0, 1.0), (0.0, 0.0, 1.0), cfg)
    r = Renderer(cfg.replace(pair_capacity_factor=1), scene, use_cache=False,
                 raster_backend="pallas")
    r.render(cam)
    ok, msg = r.check_overflow()
    assert not ok and "overflow" in msg
    with pytest.raises(RuntimeError):
        r.check_overflow(strict=True)

    r2 = Renderer(cfg, scene, use_cache=False, raster_backend="pallas")
    r2.render(cam)
    ok2, msg2 = r2.check_overflow()
    assert ok2, msg2  # the default pair budget is ample


@pytest.mark.gpu
def test_kernel_compiled_on_gpu_matches_xla(gpu):
    """The compiled Triton kernel (no interpreter) vs the XLA reference, at
    the tolerance chip_smoke.py states: Triton and XLA may contract the edge
    FMAs differently, so a pixel centre on a shared edge can flip."""
    clip = _random_tris(2000, seed=9)
    s = rs.setup_triangles(clip, 1000, 540, cull="none")
    d_ref, t_ref = rr.rasterize_vis(s, 1000, 540)
    d_got, t_got, _ = jax.jit(lambda s: tiled.rasterize_tiled(
        s, 1000, 540, pair_capacity=40000, interpret=False))(s)
    agree = np.asarray(t_got) == np.asarray(t_ref)
    assert agree.mean() >= 0.9999
    fin = lambda d: np.where(np.isinf(d), -1.0, np.asarray(d))
    assert np.abs(fin(d_got) - fin(d_ref))[agree].max() <= 1e-6
