"""Multi-device sharded frame on the 8-device virtual CPU mesh.

The contract: sharding must be invisible — the sharded step
produces the SAME image and temporal state as the single-chip `render_frame`
under matching config (the sharded path forces gi/shaft res divisors to 1),
and a multi-frame loop carries state exactly like the single-chip loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vulkan_pbr_renderer.app.renderer import (
    init_frame_state, make_camera, render_frame,
)
from vulkan_pbr_renderer.assets import build_scene, suntemple, procedural
from vulkan_pbr_renderer.bake import ibl
from vulkan_pbr_renderer.config import RenderConfig
from vulkan_pbr_renderer.gpu import sampling
from vulkan_pbr_renderer.parallel import sharding

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def _small_cfg(**kw):
    base = dict(
        width=128, height=256, shadow_map_size=128, lightgrid_size=16,
        lightgrid_extent=10.0, prefiltered_env_size=16, prefiltered_env_min_size=8,
        prefilter_samples=64, brdf_lut_size=16, brdf_lut_samples=64,
        irradiance_size=8, irradiance_samples=32, bloom_pass_count=3,
        gi_screen_trace_steps=4, gi_diffuse_steps=4, gi_specular_steps=4,
        light_shaft_steps=4,
    )
    base.update(kw)
    return RenderConfig(**base)


def _resources(cfg):
    scene = build_scene(suntemple.build_parts(0.15), suntemple.materials(),
                        texture_size=16)
    env = jnp.asarray(procedural.make_sky_cubemap(16))
    atlas = sampling.build_cube_mip_atlas(env)
    pre = sampling.pack_cube_mip_atlas_window(
        ibl.bake_prefiltered_env(atlas, 16, cfg.prefiltered_env_size,
                                 cfg.prefiltered_env_min_size, 64),
        cfg.prefiltered_env_size)
    lut = ibl.bake_brdf_lut(cfg.brdf_lut_size, 64)
    return scene, pre, lut


@pytest.mark.slow  # the pallas-parity test below covers the production path
def test_sharded_frame_matches_single_chip_exactly():
    """One sharded step == render_frame, image AND temporal state."""
    cfg = _small_cfg()
    mesh = sharding.make_mesh(8, dp=2)
    scene, pre, lut = _resources(cfg)
    sun = jnp.asarray([35.0, 80.0], jnp.float32)

    cams = [make_camera((0.0, -20.0 + i, 3.0), (0.0, 0.0, 3.0), cfg)
            for i in range(2)]

    # reference: single-chip render_frame with the SAME divisor-1 config the
    # sharded path uses (it forces full-res GI/shafts — see sharding.py)
    ref_cfg = cfg.replace(gi_res_divisor=1, shaft_res_divisor=1,
                          sky_res_divisor=1, gi_temporal_div=1)
    ref_states, ref_imgs = [], []
    for cam in cams:
        st, img = render_frame(scene, init_frame_state(ref_cfg), cam, sun,
                               pre, lut, ref_cfg, "xla")
        ref_states.append(st)
        ref_imgs.append(np.asarray(img))

    step = sharding.sharded_frame_fn(scene, cfg, mesh, raster_backend="xla")
    states = sharding.stack_states([init_frame_state(ref_cfg)] * 2)
    new_states, out = step(states, sharding.stack_cams(cams), sun, pre, lut)

    assert out.shape == (2, cfg.height, cfg.width, 3)
    for i in range(2):
        np.testing.assert_allclose(np.asarray(out[i]), ref_imgs[i],
                                   rtol=2e-4, atol=2e-4)
        # temporal state parity: every FrameState leaf matches (1e-3: XLA
        # fuses the sharded and unsharded HLO differently, so isolated
        # pixels can differ by a few float ulps through the post stack;
        # bf16-STORED leaves like prev_pyramid additionally round that f32
        # noise to different bf16 ulps, so their bound is one bf16 ulp
        # [2^-7 relative] — the IMAGE tolerance above is unaffected)
        for name in ref_states[i]._fields:
            a = np.asarray(getattr(new_states, name)[i])
            b = np.asarray(getattr(ref_states[i], name))
            rt = 2 ** -7 if a.dtype == np.dtype("bfloat16") or \
                str(a.dtype) == "bfloat16" else 1e-3
            np.testing.assert_allclose(a.astype(np.float32),
                                       b.astype(np.float32),
                                       rtol=rt, atol=1e-3,
                                       err_msg=f"state leaf {name}")


@pytest.mark.slow  # 3-frame temporal carry: 2 more full-frame compiles
def test_sharded_frame_loop_matches_single_chip():
    """3-frame loop: temporal carry (TAA, lightgrid sweep axis rotation,
    cached sun depth, bloom pyramid) matches the single-chip loop."""
    cfg = _small_cfg()
    ref_cfg = cfg.replace(gi_res_divisor=1, shaft_res_divisor=1,
                          sky_res_divisor=1, gi_temporal_div=1)
    mesh = sharding.make_mesh(8, dp=1)
    scene, pre, lut = _resources(cfg)
    sun = jnp.asarray([35.0, 80.0], jnp.float32)

    cams = [make_camera((0.0, -20.0 + 0.5 * i, 3.0 + 0.1 * i),
                        (0.0, 0.0, 3.0), cfg) for i in range(3)]

    ref_state = init_frame_state(ref_cfg)
    ref_imgs = []
    for cam in cams:
        ref_state, img = render_frame(scene, ref_state, cam, sun, pre, lut,
                                      ref_cfg, "xla")
        ref_imgs.append(np.asarray(img))

    step = sharding.sharded_frame_fn(scene, cfg, mesh, raster_backend="xla")
    states = sharding.stack_states([init_frame_state(ref_cfg)])
    for i, cam in enumerate(cams):
        states, out = step(states, sharding.stack_cams([cam]), sun, pre, lut)
        np.testing.assert_allclose(np.asarray(out[0]), ref_imgs[i],
                                   rtol=5e-4, atol=5e-4,
                                   err_msg=f"frame {i}")
    assert int(states.frame_idx[0]) == 3


def test_sharded_pallas_matches_single_chip_pallas():
    """The PRODUCTION multi-card config: the tile kernel through shard_map
    (exercising the traced y_origin band), interpret mode on the CPU mesh,
    vs the single-card pallas renderer."""
    cfg = _small_cfg()
    mesh = sharding.make_mesh(8, dp=2)   # sp=4: height 256 = 4 * 2 tiles
    scene, pre, lut = _resources(cfg)
    sun = jnp.asarray([35.0, 80.0], jnp.float32)
    cams = [make_camera((0.0, -20.0 + i, 3.0), (0.0, 0.0, 3.0), cfg)
            for i in range(2)]

    ref_cfg = cfg.replace(gi_res_divisor=1, shaft_res_divisor=1,
                          sky_res_divisor=1, gi_temporal_div=1)
    ref_imgs = []
    for cam in cams:
        _, img = render_frame(scene, init_frame_state(ref_cfg), cam, sun,
                              pre, lut, ref_cfg, "pallas")
        ref_imgs.append(np.asarray(img))

    step = sharding.sharded_frame_fn(scene, cfg, mesh, raster_backend="pallas")
    states = sharding.stack_states([init_frame_state(ref_cfg)] * 2)
    new_states, out = step(states, sharding.stack_cams(cams), sun, pre, lut)
    for i in range(2):
        np.testing.assert_allclose(np.asarray(out[i]), ref_imgs[i],
                                   rtol=2e-4, atol=2e-4)
    # the sharded raster found real work and flagged no overflow
    pairs = np.asarray(new_states.raster_pairs)
    assert (pairs > 0).all()
    assert (pairs <= cfg.pair_capacity_factor * scene.num_tris).all()


def test_sharded_dp_slices_are_independent():
    cfg = _small_cfg(enable_taa=False)
    mesh = sharding.make_mesh(8, dp=2)
    scene, pre, lut = _resources(cfg)
    sun = jnp.asarray([35.0, 80.0], jnp.float32)
    cams = [make_camera((0.0, -20.0 + 4 * i, 3.0), (0.0, 0.0, 3.0), cfg)
            for i in range(2)]
    step = sharding.sharded_frame_fn(scene, cfg, mesh, raster_backend="xla")
    states = sharding.stack_states([init_frame_state(cfg)] * 2)
    _, out = step(states, sharding.stack_cams(cams), sun, pre, lut)
    o = np.asarray(out)
    assert bool(np.isfinite(o).all())
    # the two dp frames use different cameras -> different images
    assert np.abs(o[0] - o[1]).mean() > 1e-4
