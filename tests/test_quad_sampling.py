"""Quad-packed samplers must match their scalar-gather references."""

import jax.numpy as jnp
import numpy as np

from vulkan_pbr_renderer.gpu import sampling as S
from vulkan_pbr_renderer.shade.shadow import PCF_OFFSETS


def test_quad_pack_layout():
    tex = jnp.arange(4 * 6 * 2, dtype=jnp.float32).reshape(4, 6, 2)
    q = S.quad_pack(tex)
    assert q.shape == (2, 3, 8)
    # block (0,0): texels (0,0),(0,1),(1,0),(1,1)
    np.testing.assert_array_equal(np.asarray(q[0, 0]).reshape(4, 2),
                                  np.asarray(tex[:2, :2].reshape(4, 2)))


def test_catmull_quad_matches_reference_interior():
    rng = np.random.default_rng(0)
    tex = jnp.asarray(rng.random((32, 48, 3)).astype(np.float32))
    uv = jnp.asarray(rng.uniform(0.15, 0.85, (500, 2)).astype(np.float32))
    ref = np.asarray(S.sample_catmull_rom(tex, uv))
    got = np.asarray(S.sample_catmull_rom_quad(S.quad_pack(tex), 32, 48, uv))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_catmull_quad_reproduces_linear_ramp():
    y, x = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    tex = jnp.asarray(np.stack([x, y, x + y], -1).astype(np.float32))
    rng = np.random.default_rng(1)
    uv = jnp.asarray(rng.uniform(0.2, 0.8, (100, 2)).astype(np.float32))
    got = np.asarray(S.sample_catmull_rom_quad(S.quad_pack(tex), 32, 32, uv))
    np.testing.assert_allclose(got[:, 0], np.asarray(uv)[:, 0] * 32 - 0.5, atol=1e-3)


def test_pcf_quad_matches_scalar_taps():
    rng = np.random.default_rng(2)
    depth = jnp.asarray(rng.random((64, 64)).astype(np.float32))
    uv = jnp.asarray(rng.uniform(0.15, 0.85, (400, 2)).astype(np.float32))
    ref_z = jnp.asarray(rng.random(400).astype(np.float32))
    s = 64
    expect = 0.0
    for (ox, oy) in PCF_OFFSETS:
        expect = expect + S.sample_depth_compare(
            depth, uv + jnp.array([ox / s, oy / s]), ref_z
        )
    expect = np.asarray(expect) * 0.25
    got = np.asarray(
        S.sample_pcf4_quad(S.quad_pack(depth[..., None]), s, uv, ref_z, PCF_OFFSETS)
    )
    np.testing.assert_allclose(got, expect, atol=2e-5)


def test_pcf_quad_edges_sane():
    depth = jnp.full((32, 32), 0.5)
    uv = jnp.asarray(np.array([[0.01, 0.01], [0.99, 0.99], [0.5, 0.01]], np.float32))
    got = np.asarray(
        S.sample_pcf4_quad(S.quad_pack(depth[..., None]), 32, uv,
                           jnp.array([0.4, 0.6, 0.4]), PCF_OFFSETS)
    )
    assert got[0] == 1.0 and got[1] == 0.0 and got[2] == 1.0


# ---------------------------------------------------------------------------
# Window ("shingled") packed samplers — ONE gather row per filter evaluation


def test_catmull_window_matches_reference_interior():
    rng = np.random.default_rng(4)
    tex = jnp.asarray(rng.random((32, 48, 3)).astype(np.float32))
    uv = jnp.asarray(rng.uniform(0.15, 0.85, (500, 2)).astype(np.float32))
    ref = np.asarray(S.sample_catmull_rom(tex, uv))
    got = np.asarray(
        S.sample_catmull_rom_window(S.window_pack(tex, 4, 4), 32, 48, uv, 3)
    )
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_pcf_window_matches_scalar_taps():
    rng = np.random.default_rng(5)
    depth = jnp.asarray(rng.random((64, 64)).astype(np.float32))
    uv = jnp.asarray(rng.uniform(0.15, 0.85, (400, 2)).astype(np.float32))
    ref_z = jnp.asarray(rng.random(400).astype(np.float32))
    s = 64
    expect = 0.0
    for (ox, oy) in PCF_OFFSETS:
        expect = expect + S.sample_depth_compare(
            depth, uv + jnp.array([ox / s, oy / s]), ref_z
        )
    expect = np.asarray(expect) * 0.25
    got = np.asarray(
        S.sample_pcf4_window(S.window_pack(depth[..., None], 4, 4), s, uv,
                             ref_z, PCF_OFFSETS)
    )
    np.testing.assert_allclose(got, expect, atol=2e-5)


def test_trilinear_window_matches_reference():
    rng = np.random.default_rng(6)
    vol = jnp.asarray(rng.random((16, 16, 16, 4)).astype(np.float32))
    uvw = jnp.asarray(rng.uniform(0.1, 0.9, (300, 3)).astype(np.float32))
    ref = np.asarray(S.sample_trilinear_3d(vol, uvw))
    got = np.asarray(S.sample_trilinear_window(S.window_pack3d(vol), uvw, 4))
    np.testing.assert_allclose(got, ref, atol=2e-5)
    # edge clamping matches too
    uvw_edge = jnp.asarray(np.array([[0.01, 0.5, 0.99], [0.99, 0.01, 0.5]], np.float32))
    np.testing.assert_allclose(
        np.asarray(S.sample_trilinear_window(S.window_pack3d(vol), uvw_edge, 4)),
        np.asarray(S.sample_trilinear_3d(vol, uvw_edge)), atol=2e-5)


def test_bilinear_window_matches_reference():
    rng = np.random.default_rng(7)
    tex = jnp.asarray(rng.random((16, 24, 2)).astype(np.float32))
    uv = jnp.asarray(rng.uniform(0.1, 0.9, (200, 2)).astype(np.float32))
    ref = np.asarray(S.sample_bilinear(tex, uv))
    got = np.asarray(S.sample_bilinear_window(S.window_pack(tex, 2, 2), 16, 24, uv, 2))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_depth_compare_window_matches():
    rng = np.random.default_rng(8)
    depth = jnp.asarray(rng.random((32, 32)).astype(np.float32))
    uv = jnp.asarray(rng.uniform(0.1, 0.9, (200, 2)).astype(np.float32))
    ref_z = jnp.asarray(rng.random(200).astype(np.float32))
    ref = np.asarray(S.sample_depth_compare(depth, uv, ref_z))
    got = np.asarray(S.sample_depth_compare_window(
        S.window_pack(depth[..., None], 4, 4), 32, uv, ref_z))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_depth_compare_window2_u16_matches():
    """The 2x2 u16 pack (the 33 MB shadow table) must match the
    scalar-gather compare exactly when depths are u16-representable."""
    rng = np.random.default_rng(10)
    depth = jnp.asarray(
        (rng.integers(0, 65536, (32, 32)) / 65535.0).astype(np.float32)
    )
    uv = jnp.asarray(rng.uniform(0.1, 0.9, (200, 2)).astype(np.float32))
    ref_z = jnp.asarray(rng.random(200).astype(np.float32))
    ref = np.asarray(S.sample_depth_compare(depth, uv, ref_z))
    got = np.asarray(S.sample_depth_compare_window(
        S.pack_depth_window_u16(depth), 32, uv, ref_z))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_pcf_window2_matches_scalar_taps():
    rng = np.random.default_rng(11)
    depth = jnp.asarray(
        (rng.integers(0, 65536, (64, 64)) / 65535.0).astype(np.float32)
    )
    uv = jnp.asarray(rng.uniform(0.15, 0.85, (400, 2)).astype(np.float32))
    ref_z = jnp.asarray(rng.random(400).astype(np.float32))
    s = 64
    expect = 0.0
    for (ox, oy) in PCF_OFFSETS:
        expect = expect + S.sample_depth_compare(
            depth, uv + jnp.array([ox / s, oy / s]), ref_z
        )
    expect = np.asarray(expect) * 0.25
    wdepth = S.pack_depth_window_u16(depth)
    got = 0.0
    for (ox, oy) in PCF_OFFSETS:
        got = got + S.sample_depth_compare_window(
            wdepth, s, uv + jnp.array([ox / s, oy / s]), ref_z
        )
    got = np.asarray(got) * 0.25
    np.testing.assert_allclose(got, expect, atol=2e-5)


def test_pcf_window_split_matches_scalar_taps():
    rng = np.random.default_rng(14)
    depth = jnp.asarray(
        (rng.integers(0, 65536, (64, 64)) / 65535.0).astype(np.float32)
    )
    uv = jnp.asarray(rng.uniform(0.15, 0.85, (400, 2)).astype(np.float32))
    ref_z = jnp.asarray(rng.random(400).astype(np.float32))
    s = 64
    expect = 0.0
    for (ox, oy) in PCF_OFFSETS:
        expect = expect + S.sample_depth_compare(
            depth, uv + jnp.array([ox / s, oy / s]), ref_z
        )
    expect = np.asarray(expect) * 0.25
    wa, wb = S.pack_depth_window_u16_4x4_split(depth)
    got = np.asarray(S.sample_pcf4_window_split(wa, wb, s, uv, ref_z,
                                                PCF_OFFSETS))
    np.testing.assert_allclose(got, expect, atol=2e-5)


def test_catmull5_window_close_to_full_catmull():
    """5-tap approx: dropped corner weight is <2% of the kernel — the result
    must track the full 16-tap Catmull-Rom closely and beat bilinear."""
    rng = np.random.default_rng(12)
    tex = jnp.asarray(rng.random((32, 48, 3)).astype(np.float32))
    uv = jnp.asarray(rng.uniform(0.15, 0.85, (500, 2)).astype(np.float32))
    full = np.asarray(S.sample_catmull_rom(tex, uv))
    got = np.asarray(S.sample_catmull_rom_window5(
        S.window_pack(tex, 2, 2), 32, 48, uv, 3))
    err5 = np.abs(got - full).max()
    assert err5 < 0.05, err5
    bil = np.asarray(S.sample_bilinear(tex, uv))
    assert np.abs(got - full).mean() < np.abs(bil - full).mean()


def test_grid_u8_pack_roundtrip():
    from vulkan_pbr_renderer.shade import gi

    rng = np.random.default_rng(13)
    grid = np.zeros((8, 8, 8, 4), np.float32)
    grid[..., :3] = rng.random((8, 8, 8, 3)) * 6.0   # radiance range
    grid[..., 3] = (rng.random((8, 8, 8)) > 0.5).astype(np.float32)
    grid = jnp.asarray(grid)
    uvw = jnp.asarray(rng.uniform(0.1, 0.9, (300, 3)).astype(np.float32))
    ref = np.asarray(gi._gs_uvw(S.window_pack3d(grid), uvw))
    got = np.asarray(gi._gs_uvw(gi.pack_grid_u8(grid), uvw))
    # corners decode before the lerp, so only u8 quantization error remains
    # (~3% relative at the top of the radiance range)
    np.testing.assert_allclose(got[..., :3], ref[..., :3],
                               rtol=0.06, atol=0.02)
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=0.01)


def test_mip_atlas_window_matches_interior():
    rng = np.random.default_rng(9)
    texs = jnp.asarray(rng.random((3, 16, 16, 12)).astype(np.float32))
    plain = jnp.stack([S.build_mip_atlas(texs[i]) for i in range(3)])
    win = jnp.stack([S.build_mip_atlas_window(texs[i]) for i in range(3)])
    # window atlas wraps at level borders — exact across the full uv range
    uv = jnp.asarray(rng.uniform(0.0, 1.0, (200, 2)).astype(np.float32))
    layer = jnp.asarray(rng.integers(0, 3, 200, dtype=np.int32))
    for lod in [0.0, 0.7, 1.5, 2.0]:
        ref = np.asarray(S.sample_mip_atlas_array(plain, layer, uv, jnp.full(200, lod)))
        got = np.asarray(S.sample_mip_atlas_array_window(win, layer, uv, jnp.full(200, lod), 12))
        np.testing.assert_allclose(got, ref, atol=3e-5, err_msg=f"lod {lod}")
