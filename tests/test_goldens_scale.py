"""Large-scale + per-pass-toggle golden images.

Round 2's optimizations trade precision for speed (uint8 materials, f16
window packs, nearest-mip sampling); these goldens are the safety net the
160x96 smoke goldens are too coarse to provide:

* DEFAULT-ON: one 480x272 SunTemple frame per GI mode (fast +
  reference-parity hybrid) and per-pass toggle goldens at 320x192 (each
  pass's contribution pinned separately, so a regression localizes to the
  pass that caused it).  These run in the normal CPU suite — precision
  changes (e.g. the round-3 bf16 conversion) MUST go through them.
* OPT-IN (RUN_SCALE_GOLDENS=1): the 960x544 pair — minutes-long on the CPU
  backend (the reference-parity GI march dominates).

Regenerate after intentional changes:
    UPDATE_GOLDENS=1 python -m pytest tests/test_goldens_scale.py
"""

import os

import numpy as np
import pytest

FULL_TIER = os.environ.get("RUN_SCALE_GOLDENS") == "1"

from vulkan_pbr_renderer.app import Renderer, make_camera
from vulkan_pbr_renderer.assets import build_scene, suntemple
from vulkan_pbr_renderer.config import RenderConfig
from vulkan_pbr_renderer.utils import image

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
UPDATE = os.environ.get("UPDATE_GOLDENS") == "1"


def _check(name, img, threshold=0.98):
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


def _scene(detail=0.4, tex=64):
    return build_scene(suntemple.build_parts(detail), suntemple.materials(),
                       texture_size=tex)


SCALE = RenderConfig(
    width=960, height=544, shadow_map_size=512, lightgrid_size=32,
    lightgrid_extent=20.0, prefiltered_env_size=32, prefiltered_env_min_size=8,
    prefilter_samples=256, brdf_lut_size=32, brdf_lut_samples=256,
    irradiance_size=8, irradiance_samples=32, bloom_pass_count=5,
    gi_screen_trace_steps=8, gi_diffuse_steps=8, gi_specular_steps=8,
    light_shaft_steps=8,
)

MID = SCALE.replace(width=480, height=272, shadow_map_size=256)
# fast-tier golden size (the 480x272 fast golden dominated the tier's time;
# the 320x192 class keeps the same full-pipeline precision net at
# ~40% of the pixels).  The reference-parity golden keeps MID: it is the
# parity yardstick and lives in the slow tier anyway.
MID_FAST = MID.replace(width=320, height=192)


@pytest.mark.parametrize("mode", [
    "fast",
    # the reference-parity march golden is multi-minute on CPU — slow tier
    # the fast golden stays default-on as the precision net
    pytest.param("reference", marks=pytest.mark.slow),
])
def test_golden_suntemple_480(mode):
    cfg = (MID_FAST if mode == "fast" else MID).replace(gi_mode=mode)
    name = f"suntemple_{cfg.width}_{mode}"
    r = Renderer(cfg, _scene(), use_cache=False, raster_backend="xla")
    cam = make_camera(*suntemple.camera_path(0.3), cfg)
    img = None
    for _ in range(2):  # settle GI sweep + TAA one step
        img = r.render(cam, sun_angle=(35.0, 80.0))
    _check(name, img, threshold=0.97)


@pytest.mark.skipif(not FULL_TIER, reason="960x544 tier: RUN_SCALE_GOLDENS=1")
@pytest.mark.parametrize("mode", ["fast", "reference"])
def test_golden_suntemple_960(mode):
    cfg = SCALE.replace(gi_mode=mode)
    r = Renderer(cfg, _scene(), use_cache=False, raster_backend="xla")
    cam = make_camera(*suntemple.camera_path(0.3), cfg)
    img = None
    for _ in range(2):  # settle GI sweep + TAA one step
        img = r.render(cam, sun_angle=(35.0, 80.0))
    _check(f"suntemple_960_{mode}", img, threshold=0.97)


TOGGLE = RenderConfig(
    width=320, height=192, shadow_map_size=256, lightgrid_size=16,
    lightgrid_extent=10.0, prefiltered_env_size=16, prefiltered_env_min_size=8,
    prefilter_samples=128, brdf_lut_size=16, brdf_lut_samples=128,
    irradiance_size=8, irradiance_samples=32, bloom_pass_count=4,
    gi_screen_trace_steps=4, gi_diffuse_steps=4, gi_specular_steps=4,
    light_shaft_steps=4,
)

_TOGGLES = {
    "all_on": {},
    "no_shadows": dict(enable_shadows=False),
    "no_gi": dict(enable_gi=False, enable_ibl=False),
    "no_shafts": dict(enable_light_shafts=False),
    "no_taa": dict(enable_taa=False),
    "no_bloom": dict(enable_bloom=False),
}


@pytest.mark.slow  # 6 configs x 2 settle frames of march-heavy compiles
@pytest.mark.parametrize("toggle", sorted(_TOGGLES))
def test_golden_pass_toggles(toggle):
    cfg = TOGGLE.replace(**_TOGGLES[toggle])
    r = Renderer(cfg, _scene(detail=0.25, tex=32), use_cache=False,
                 raster_backend="xla")
    cam = make_camera(*suntemple.camera_path(0.3), cfg)
    img = None
    for _ in range(2):
        img = r.render(cam, sun_angle=(35.0, 80.0))
    _check(f"toggle_{toggle}", img, threshold=0.975)
