import jax.numpy as jnp
import numpy as np
import pytest

from vulkan_pbr_renderer.assets import procedural
from vulkan_pbr_renderer.bake import cache, ibl
from vulkan_pbr_renderer.gpu import sampling


@pytest.fixture(scope="module")
def env_atlas():
    env = jnp.asarray(procedural.make_sky_cubemap(32, sun_intensity=0.0))
    return sampling.build_cube_mip_atlas(env), 32


def test_irradiance_constant_env():
    """A constant env must bake to irradiance = mean(cos(pitch)) * color."""
    const = jnp.ones((6, 16, 16, 3)) * jnp.array([2.0, 1.0, 0.5])
    atlas = sampling.build_cube_mip_atlas(const)
    irr = np.asarray(ibl.bake_irradiance(atlas, 16, size=8, samples=256))
    # mean of cos(pitch) over the equal-area set: E[cos] = 0.5 for cosine... the
    # equal-area hemisphere gives E[cos(pitch)] = 0.5
    np.testing.assert_allclose(irr[..., 0], 2.0 * 0.5, rtol=0.05)
    np.testing.assert_allclose(irr[..., 2] / irr[..., 0], 0.25, rtol=0.01)


def test_irradiance_follows_sky_gradient(env_atlas):
    atlas, base = env_atlas
    irr = np.asarray(ibl.bake_irradiance(atlas, base, size=8, samples=256))
    # +Z face (up) must be bluer/brighter-in-zenith than -Z face (ground)
    up_mean = irr[4 - 0].mean() if False else irr[2].mean()   # face 2 = +Y? no...
    # faces: 0 +X, 1 -X, 2 +Y, 3 -Y, 4 +Z, 5 -Z; world up is +Z => face 4 sees sky
    assert irr[4].mean() > irr[5].mean()


def test_prefiltered_env_levels(env_atlas):
    atlas, base = env_atlas
    pre = ibl.bake_prefiltered_env(atlas, base, size=16, min_size=8, samples=128)
    assert pre.shape[0] == 6 and pre.shape[1] == 16
    # lod 0 ~ env itself (at lod 1); rougher mips are smoother
    d = jnp.array([[0.0, 0.0, 1.0]])
    v0 = np.asarray(sampling.sample_cubemap_lod(pre, 16, d, jnp.zeros(1)))
    assert np.isfinite(v0).all() and (v0 >= 0).all()
    # variance decreases with mip level on a gradient env
    lvl1 = np.asarray(sampling.sample_cubemap_lod(pre, 16, jnp.asarray(
        np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)), jnp.full(64, 1.0)))
    lvl3 = np.asarray(sampling.sample_cubemap_lod(pre, 16, jnp.asarray(
        np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)), jnp.full(64, 3.0)))
    assert lvl3.std() <= lvl1.std() + 1e-3


def test_brdf_lut_properties():
    lut = np.asarray(ibl.bake_brdf_lut(size=32, samples=1024))
    assert lut.shape == (32, 32, 2)
    scale, bias = lut[..., 0], lut[..., 1]
    assert (scale >= 0).all() and (bias >= 0).all()
    # rows below roughness 0.05 are never read (the lighting pass clamps the
    # lookup, lighting_pass.glsl:681) and are noisy with spiky Beckmann lobes;
    # check energy conservation on the used region only
    used = scale[2:] + bias[2:]
    assert used.max() < 1.35
    # moderate roughness, head-on view: scale dominates, bias small
    assert scale[4, -1] > 0.5
    assert bias[4, -1] < 0.2
    # bias grows toward grazing angles
    assert bias[4, 2] > bias[4, -1] - 1e-6


def test_cached_bake(tmp_path):
    calls = []

    def fn():
        calls.append(1)
        return jnp.ones((4, 4))

    a = cache.cached_bake("t", fn, 123, cache_dir=str(tmp_path))
    b = cache.cached_bake("t", fn, 123, cache_dir=str(tmp_path))
    assert len(calls) == 1
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    cache.cached_bake("t", fn, 456, cache_dir=str(tmp_path))
    assert len(calls) == 2
