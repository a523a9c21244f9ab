import jax.numpy as jnp
import numpy as np
import pytest

from vulkan_pbr_renderer.gpu import sampling as S


def _ramp_tex(h, w, c=3):
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    t = np.stack([x, y, x + y] if c == 3 else [x] * c, -1).astype(np.float32)
    return jnp.asarray(t)


def test_nearest_exact_texel():
    tex = _ramp_tex(8, 16)
    # uv at texel center (3+0.5)/16, (5+0.5)/8 -> texel (x=3, y=5)
    uv = jnp.array([[(3 + 0.5) / 16, (5 + 0.5) / 8]])
    v = np.asarray(S.sample_nearest(tex, uv))[0]
    np.testing.assert_allclose(v, [3, 5, 8])


def test_nearest8_bitexact_vs_nearest():
    # the blocked 32B-row depth fetch must reproduce sample_nearest EXACTLY
    # (clamp addressing, incl. out-of-range uv) — it is used inside the GI
    # screen traces where any delta would shift occlusion boundaries
    rng = np.random.default_rng(7)
    for h, w in ((16, 24), (17, 24), (16, 25)):  # w%8!=0 exercises fallback
        tex = jnp.asarray(rng.random((h, w), dtype=np.float32))
        uv = jnp.asarray(rng.random((500, 2), dtype=np.float32) * 1.6 - 0.3)
        a = np.asarray(S.sample_nearest(tex[..., None], uv))[..., 0]
        b = np.asarray(S.sample_nearest8(tex, uv))
        np.testing.assert_array_equal(a, b)


def test_bilinear_center_and_midpoint():
    tex = _ramp_tex(8, 8)
    uv = jnp.array([[(2 + 0.5) / 8, (4 + 0.5) / 8]])
    np.testing.assert_allclose(np.asarray(S.sample_bilinear(tex, uv))[0], [2, 4, 6], atol=1e-5)
    # halfway between texels 2 and 3 in x
    uv = jnp.array([[(3.0) / 8, (4 + 0.5) / 8]])
    np.testing.assert_allclose(np.asarray(S.sample_bilinear(tex, uv))[0], [2.5, 4, 6.5], atol=1e-5)


def test_bilinear_wrap_vs_clamp():
    tex = _ramp_tex(4, 4)
    uv = jnp.array([[1.0 + (0.5 / 4), 0.5 / 4]])  # one full wrap + texel 0 center
    wrapped = np.asarray(S.sample_bilinear(tex, uv, mode="wrap"))[0]
    np.testing.assert_allclose(wrapped, [0, 0, 0], atol=1e-5)
    clamped = np.asarray(S.sample_bilinear(tex, uv, mode="clamp"))[0]
    np.testing.assert_allclose(clamped, [3, 0, 3], atol=1e-5)


def test_bilinear_interpolates_linear_ramp_everywhere():
    tex = _ramp_tex(16, 16)
    rng = np.random.default_rng(0)
    uv = jnp.asarray(rng.uniform(0.1, 0.9, (256, 2)).astype(np.float32))
    got = np.asarray(S.sample_bilinear(tex, uv))
    # a bilinear filter reproduces a linear function exactly (away from edges)
    expect_x = np.asarray(uv)[:, 0] * 16 - 0.5
    expect_y = np.asarray(uv)[:, 1] * 16 - 0.5
    np.testing.assert_allclose(got[:, 0], expect_x, atol=1e-4)
    np.testing.assert_allclose(got[:, 1], expect_y, atol=1e-4)


def test_catmull_rom_reproduces_linear_ramp():
    tex = _ramp_tex(32, 32)
    rng = np.random.default_rng(1)
    uv = jnp.asarray(rng.uniform(0.2, 0.8, (64, 2)).astype(np.float32))
    got = np.asarray(S.sample_catmull_rom(tex, uv))
    np.testing.assert_allclose(got[:, 0], np.asarray(uv)[:, 0] * 32 - 0.5, atol=1e-3)
    # weights sum to 1 (constant texture is preserved)
    const = jnp.ones((16, 16, 3))
    got = np.asarray(S.sample_catmull_rom(const, uv))
    np.testing.assert_allclose(got, 1.0, atol=1e-5)


def test_trilinear_3d():
    d = h = w = 8
    z, y, x = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    vol = jnp.asarray(np.stack([x, y, z], -1).astype(np.float32))
    rng = np.random.default_rng(2)
    uvw = jnp.asarray(rng.uniform(0.2, 0.8, (64, 3)).astype(np.float32))
    got = np.asarray(S.sample_trilinear_3d(vol, uvw))
    np.testing.assert_allclose(got, np.asarray(uvw) * 8 - 0.5, atol=1e-4)


def test_depth_compare_pcf():
    depth = jnp.full((16, 16), 0.5)
    uv = jnp.array([[0.5, 0.5]])
    assert float(S.sample_depth_compare(depth, uv, jnp.array([0.4]))[0]) == 1.0
    assert float(S.sample_depth_compare(depth, uv, jnp.array([0.6]))[0]) == 0.0
    # half-occluded edge: left half depth 0.5, right half 0.2; ref 0.3
    depth = depth.at[:, 8:].set(0.2)
    vis = float(S.sample_depth_compare(depth, jnp.array([[0.5, 0.5]]), jnp.array([0.3]))[0])
    assert 0.0 < vis < 1.0


def test_cubemap_face_uv_roundtrip():
    rng = np.random.default_rng(3)
    for face in range(6):
        uv = jnp.asarray(rng.uniform(0.05, 0.95, (32, 2)).astype(np.float32))
        d = S.cubemap_dir_from_face_uv(jnp.full((32,), face, jnp.int32), uv)
        f2, uv2 = S.cubemap_face_uv_from_dir(d)
        np.testing.assert_array_equal(np.asarray(f2), face)
        np.testing.assert_allclose(np.asarray(uv2), np.asarray(uv), atol=1e-5)


def test_cubemap_axis_dirs():
    # sampling along +X must hit the center of face 0, etc.
    faces = jnp.zeros((6, 4, 4, 3)).at[:].add(jnp.arange(6, dtype=jnp.float32)[:, None, None, None])
    dirs = jnp.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], jnp.float32
    )
    got = np.asarray(S.sample_cubemap(faces, dirs))
    np.testing.assert_allclose(got[:, 0], np.arange(6), atol=1e-5)


def test_mip_atlas_levels():
    tex = jnp.ones((16, 16, 3))
    atlas = S.build_mip_atlas(tex)
    assert atlas.shape == (16, 16 + 8 + 4 + 2 + 1, 3)
    # constant texture: every level samples to 1
    uv = jnp.array([[0.3, 0.7]])
    for lod in [0.0, 1.3, 2.7, 4.0]:
        v = np.asarray(S.sample_mip_atlas(atlas, 16, 16, uv, jnp.array([lod])))
        np.testing.assert_allclose(v, 1.0, atol=1e-5)


def test_mip_atlas_lod_selects_level():
    # texture with checkerboard: mip 1+ average to 0.5
    h = w = 8
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    checker = ((x + y) % 2).astype(np.float32)[..., None]
    atlas = S.build_mip_atlas(jnp.asarray(checker))
    uv = jnp.array([[0.5, 0.5]])
    v1 = float(S.sample_mip_atlas(atlas, h, w, uv, jnp.array([1.0]))[0, 0])
    assert v1 == pytest.approx(0.5, abs=1e-5)
    v3 = float(S.sample_mip_atlas(atlas, h, w, uv, jnp.array([3.0]))[0, 0])
    assert v3 == pytest.approx(0.5, abs=1e-5)


def test_cube_mip_atlas():
    faces = jnp.asarray(np.random.default_rng(4).random((6, 8, 8, 3)).astype(np.float32))
    atlas = S.build_cube_mip_atlas(faces)
    dirs = jnp.array([[1, 0.2, -0.1], [0, -1, 0.3]], jnp.float32)
    # lod 0 matches direct cubemap sampling
    v0 = np.asarray(S.sample_cubemap_lod(atlas, 8, dirs, jnp.zeros(2)))
    direct = np.asarray(S.sample_cubemap(faces, dirs))
    np.testing.assert_allclose(v0, direct, atol=1e-5)
    # max lod = global mean per face region (clamped bilinear of 1x1)
    vmax = np.asarray(S.sample_cubemap_lod(atlas, 8, dirs, jnp.full(2, 3.0)))
    assert np.all(np.abs(vmax - np.asarray(faces).mean((1, 2))[[0, 3]]) < 1e-4)


def test_mip_atlas_array_window_trilinear():
    # trilinear(lod) must equal lerp(nearest(l0), nearest(l0+1), frac) and
    # reduce to the bilinear single-level fetch at integer lods
    rng = np.random.RandomState(7)
    tex = rng.rand(8, 8, 12).astype(np.float32)
    scale = jnp.ones((12,), jnp.float32)
    atlas = S.build_mip_atlas_window_u8(jnp.asarray(tex), scale)[None]
    layer = jnp.zeros((5,), jnp.int32)
    uv = jnp.asarray(rng.rand(5, 2), jnp.float32)

    a0 = S.sample_mip_atlas_array_window_nearest(atlas, layer, uv,
                                                 jnp.zeros(5), 12, scale=scale)
    a1 = S.sample_mip_atlas_array_window_nearest(atlas, layer, uv,
                                                 jnp.ones(5), 12, scale=scale)
    tri_int = S.sample_mip_atlas_array_window_trilinear(
        atlas, layer, uv, jnp.zeros(5), 12, scale=scale)
    np.testing.assert_allclose(np.asarray(tri_int), np.asarray(a0),
                               rtol=0, atol=1e-6)
    tri_mid = S.sample_mip_atlas_array_window_trilinear(
        atlas, layer, uv, jnp.full(5, 0.25), 12, scale=scale)
    np.testing.assert_allclose(np.asarray(tri_mid),
                               np.asarray(a0 * 0.75 + a1 * 0.25),
                               rtol=0, atol=1e-6)
