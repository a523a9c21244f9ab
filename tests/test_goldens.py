"""Golden-image regression tests (SURVEY.md §4).

The reference verifies by eye against screenshots/; we pin small deterministic
renders and compare SSIM.  Regenerate after intentional changes with:
    UPDATE_GOLDENS=1 python -m pytest tests/test_goldens.py
"""

import os

import jax
import numpy as np
import pytest

from vulkan_pbr_renderer.app import Renderer, make_camera
from vulkan_pbr_renderer.assets import MaterialDesc, build_scene, procedural, suntemple
from vulkan_pbr_renderer.config import RenderConfig
from vulkan_pbr_renderer.utils import image

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
UPDATE = os.environ.get("UPDATE_GOLDENS") == "1"

TINY = RenderConfig(
    gi_mode="reference",  # goldens pin the full reference-parity GI march
    width=160, height=96, shadow_map_size=128, lightgrid_size=16,
    lightgrid_extent=10.0, prefiltered_env_size=16, prefiltered_env_min_size=8,
    prefilter_samples=256, brdf_lut_size=16, brdf_lut_samples=256,
    irradiance_size=8, irradiance_samples=64, bloom_pass_count=3,
    gi_screen_trace_steps=4, gi_diffuse_steps=4, gi_specular_steps=4,
    light_shaft_steps=4,
)


def _check(name, img, threshold=0.985):
    img = np.asarray(img)
    path = os.path.join(GOLDEN_DIR, f"{name}.png")
    if UPDATE or not os.path.exists(path):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        image.write_png(path, img)
        if not UPDATE:
            pytest.skip(f"golden {name} created; re-run to compare")
        return
    golden = image.read_png(path).astype(np.float32) / 255.0
    s = image.ssim(img, golden)
    assert s >= threshold, f"{name}: SSIM {s:.4f} < {threshold}"


def test_golden_cube_shadow():
    mats = [MaterialDesc(base_color=procedural.checker_texture(32, 4, (0.6, 0.6, 0.6), (0.3, 0.3, 0.35)),
                         orm_factor=(1.0, 0.6, 0.0)),
            MaterialDesc(base_color_factor=(0.7, 0.2, 0.15, 1.0), orm_factor=(1.0, 0.35, 0.0))]
    parts = [procedural.make_plane((0, 0, 0), (14, 14), 2, 0, uv_scale=4),
             procedural.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1)]
    scene = build_scene(parts, mats, texture_size=32)
    cfg = TINY.replace(enable_gi=False)
    r = Renderer(cfg, scene, use_cache=False, raster_backend="xla")
    cam = make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), cfg)
    img = r.render(cam, sun_angle=(40.0, 120.0))
    _check("cube_shadow", img)


def test_golden_spheres_ibl():
    mats, parts = [], []
    for i, rough in enumerate(np.linspace(0.1, 0.9, 3)):
        for j, metal in enumerate([0.0, 1.0]):
            mats.append(MaterialDesc(
                base_color_factor=(0.7, 0.3, 0.3, 1.0) if metal < 0.5 else (0.9, 0.75, 0.4, 1.0),
                orm_factor=(1.0, float(rough), float(metal))))
            parts.append(procedural.make_uv_sphere(
                (-3.0 + 3.0 * i, 0, 1.2 + 2.6 * j), 1.1, 12, 24, len(mats) - 1))
    scene = build_scene(parts, mats, texture_size=16)
    cfg = TINY.replace(enable_gi=False)
    r = Renderer(cfg, scene, use_cache=False, raster_backend="xla")
    cam = make_camera((0.0, -9.0, 2.6), (0.0, 0.0, 2.4), cfg)
    img = r.render(cam, sun_angle=(45.0, 60.0))
    _check("spheres_ibl", img)


def test_golden_suntemple_gi():
    scene = build_scene(suntemple.build_parts(0.2), suntemple.materials(), texture_size=32)
    cfg = TINY
    r = Renderer(cfg, scene, use_cache=False, raster_backend="xla")
    cam = make_camera(*suntemple.camera_path(0.3), cfg)
    img = None
    for _ in range(2):  # warm GI + TAA one step
        img = r.render(cam, sun_angle=(35.0, 80.0))
    # stochastic GI: compare with a slightly looser threshold
    _check("suntemple_gi", img, threshold=0.97)


def test_golden_pallas_matches_xla_frame():
    """Same frame through both raster backends must be nearly identical."""
    mats = [MaterialDesc(orm_factor=(1.0, 0.5, 0.0))]
    parts = [procedural.make_plane((0, 0, 0), (12, 12), 2, 0),
             procedural.make_cube((0, 0, 1.0), (2, 2, 2), 0)]
    scene = build_scene(parts, mats, texture_size=16)
    cfg = TINY.replace(enable_gi=False, enable_taa=False)
    imgs = []
    for backend in ("xla", "pallas"):
        r = Renderer(cfg, scene, use_cache=False, raster_backend=backend)
        cam = make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), cfg)
        imgs.append(np.asarray(r.render(cam, sun_angle=(40.0, 120.0))))
    s = image.ssim(imgs[0], imgs[1])
    assert s > 0.995, s
