import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vulkan_pbr_renderer.assets import MaterialDesc, build_scene, procedural
from vulkan_pbr_renderer.app import Renderer, make_camera
from vulkan_pbr_renderer.config import RenderConfig


SMALL = RenderConfig(
    width=96, height=64, shadow_map_size=128, lightgrid_size=16,
    lightgrid_extent=8.0, prefiltered_env_size=16, prefiltered_env_min_size=8,
    prefilter_samples=512, brdf_lut_size=16, brdf_lut_samples=128,
    irradiance_size=8, irradiance_samples=64, bloom_pass_count=3,
    gi_screen_trace_steps=6, gi_diffuse_steps=4, gi_specular_steps=4,
    light_shaft_steps=4,
)


def _test_scene():
    mats = [
        MaterialDesc(base_color=procedural.checker_texture(32, 4, (1, 1, 1), (0.3, 0.3, 0.35)),
                     orm_factor=(1.0, 0.6, 0.0)),
        MaterialDesc(base_color_factor=(0.8, 0.2, 0.2, 1.0), orm_factor=(1.0, 0.3, 0.0)),
    ]
    parts = [
        procedural.make_plane((0, 0, 0), (12, 12), 2, 0, uv_scale=4),
        procedural.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1),
    ]
    return build_scene(parts, mats, texture_size=32)


@pytest.fixture(scope="module")
def small_renderer():
    scene = _test_scene()
    return Renderer(SMALL.replace(enable_gi=False), scene, use_cache=False)


def test_frame_basic_sanity(small_renderer):
    r = small_renderer
    cam = make_camera((5.0, -6.0, 3.0), (0.0, 0.0, 1.0), r.cfg)
    img = np.asarray(r.render(cam, sun_angle=(40.0, 20.0)))
    assert img.shape == (64, 96, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0
    # the sky (top rows) is mostly blue-ish; ground is visible below
    assert img[2, :, 2].mean() > img[2, :, 0].mean()
    # there is *some* image content (not all black / all sky)
    assert img[40:, :, :].std() > 0.02


def test_frame_temporal_state_advances(small_renderer):
    r = small_renderer
    cam = make_camera((5.0, -6.0, 3.0), (0.0, 0.0, 1.0), r.cfg)
    idx0 = int(r.state.frame_idx)
    img1 = np.asarray(r.render(cam))
    img2 = np.asarray(r.render(cam))
    assert int(r.state.frame_idx) == idx0 + 2
    # TAA jitter makes consecutive frames slightly different but close
    assert np.abs(img1 - img2).mean() < 0.1


def test_frame_shadow_darkens_ground():
    scene = _test_scene()
    cfg = SMALL.replace(enable_gi=False, enable_taa=False, enable_bloom=False,
                        enable_light_shafts=False)
    r = Renderer(cfg, scene, use_cache=False)
    cam = make_camera((0.0, -8.0, 5.0), (0.0, 0.0, 0.5), cfg)
    # sun from +y tilted: cube casts a shadow on the plane away from the sun
    img = np.asarray(r.render(cam, sun_angle=(45.0, 90.0)))
    assert np.isfinite(img).all()
    cfg2 = cfg.replace(enable_shadows=False)
    r2 = Renderer(cfg2, scene, use_cache=False)
    img2 = np.asarray(r2.render(cam, sun_angle=(45.0, 90.0)))
    # disabling shadows must brighten the scene overall (no occlusion, no shafts)
    assert img2.mean() >= img.mean() - 1e-3


def test_frame_with_gi_runs():
    scene = _test_scene()
    cfg = SMALL.replace(enable_gi=True)
    r = Renderer(cfg, scene, use_cache=False)
    cam = make_camera((5.0, -6.0, 3.0), (0.0, 0.0, 1.0), cfg)
    img1 = np.asarray(r.render(cam))
    img2 = np.asarray(r.render(cam))
    assert np.isfinite(img1).all() and np.isfinite(img2).all()
    # lightgrid got populated by voxelization
    assert float(jnp.abs(r.state.lightgrid).sum()) > 0.0


def test_visualize_lightgrid_mode():
    scene = _test_scene()
    cfg = SMALL.replace(enable_gi=True, visualize_lightgrid=True)
    r = Renderer(cfg, scene, use_cache=False)
    cam = make_camera((5.0, -6.0, 3.0), (0.0, 0.0, 1.0), cfg)
    img = np.asarray(r.render(cam))
    assert np.isfinite(img).all()


@pytest.mark.parametrize("pattern", ["columns", "checker"])
def test_gi_temporal_interleave_converges_to_full(pattern):
    """gi_temporal_div=2 (alternating half-res GI lanes into a persistent
    cache, config.py:67) must converge to the non-interleaved frame once both
    parities have been traced.  Not bit-equal by design: alternate lanes
    carry the march noise of different frame indices (the same class of
    TAA-integrated dither as the march's own jitter), so the bound is a tight
    mean-abs one on the settled sRGB frame."""
    scene = _test_scene()
    cam_pos, cam_tgt = (5.0, -6.0, 3.0), (0.0, 0.0, 1.0)

    def settled(div, frames=8):
        # bloom + shafts are independent of the GI cache under test; off,
        # the two full-frame compiles (div 1 + div 2) drop substantially
        # (this test dominated the fast tier with them on).  TAA
        # stays ON: the interleave's staleness is TAA-integrated by design
        # and the convergence bound is calibrated to the settled frame.
        # pattern is meaningless at div=1 — pin it so the div=1 graph is
        # ONE compile shared by both parametrize legs (configs that differ
        # only in an ignored field still compile separately)
        cfg = SMALL.replace(enable_gi=True, gi_temporal_div=div,
                            gi_temporal_pattern=(pattern if div > 1
                                                 else "checker"),
                            enable_bloom=False, enable_light_shafts=False)
        r = Renderer(cfg, scene, use_cache=False)
        cam = make_camera(cam_pos, cam_tgt, cfg)
        for _ in range(frames):
            img = r.render(cam)
        return np.asarray(img), r.state

    full, _ = settled(1)
    inter, st = settled(2)
    assert np.isfinite(inter).all()
    # the cache was allocated and populated by both parities
    assert st.gi_cache.shape[0] == 2
    assert np.isfinite(np.asarray(st.gi_cache)).all()
    assert float(jnp.abs(st.gi_cache).sum()) > 0.0
    diff = np.abs(inter - full).mean()
    assert diff < 0.015, f"interleaved GI drifted from full: mean|diff|={diff:.4f}"
