import jax.numpy as jnp
import numpy as np

from vulkan_pbr_renderer.utils import color, image, noise


def test_ign_range_and_determinism():
    px, py = jnp.meshgrid(jnp.arange(64.0), jnp.arange(64.0), indexing="xy")
    n1 = noise.interleaved_gradient_noise(px, py)
    n2 = noise.interleaved_gradient_noise(px, py)
    assert float(n1.min()) >= 0.0 and float(n1.max()) < 1.0
    np.testing.assert_array_equal(np.asarray(n1), np.asarray(n2))
    # low discrepancy-ish: mean near 0.5
    assert abs(float(n1.mean()) - 0.5) < 0.02


def test_r2_sequence_known_value():
    v = np.asarray(noise.r2_sequence(1.0))
    np.testing.assert_allclose(v, [0.7548776662466927, 0.5698402909980532], atol=1e-6)


def test_taa_jitter_halfpixel_bound():
    j = np.asarray(noise.taa_jitter(jnp.arange(32.0), 1920, 1080))
    assert np.all(np.abs(j[:, 0]) <= 1.0 / 1920)
    assert np.all(np.abs(j[:, 1]) <= 1.0 / 1080)


def test_bayer_is_permutation():
    vals = np.sort(np.asarray(noise.BAYER4).ravel() * 16.0)
    np.testing.assert_allclose(vals, np.arange(16.0), atol=1e-6)


def test_aces_clamps_and_monotone():
    x = jnp.linspace(0.0, 20.0, 100)[:, None].repeat(3, 1)
    y = np.asarray(color.aces_approx(x))
    assert y.min() >= 0.0 and y.max() <= 1.0
    assert np.all(np.diff(y[:, 0]) >= -1e-6)
    # known value: aces_approx(0) == 0
    assert y[0, 0] == 0.0


def test_ssim_identity_and_noise():
    rng = np.random.default_rng(0)
    a = rng.random((64, 64, 3))
    assert image.ssim(a, a) == 1.0
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1)
    assert image.ssim(a, b) < 0.9


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    img = (rng.random((33, 47, 3)) * 255).astype(np.uint8)
    p = tmp_path / "t.png"
    image.write_png(p, img)
    back = image.read_png(p)
    np.testing.assert_array_equal(img, back)
