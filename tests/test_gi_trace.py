"""screen_trace_linear v2 (scalar-s reparameterization) vs the r3 v1 form.

The v2 trace (shade/gi.py) carries one travelled-distance scalar per lane and
uses the closed-form perspective inverse for the occlusion test; v1 carries
the full 3-D ray position through per-step 4x4 transforms.  The two are the
SAME algorithm (lighting_pass.glsl:301-397) in different float-op orders, so
every lane must make the same march decisions away from razor-thin depth
ties.  This pins the r4 rewrite against the r3 yardstick on a randomized
scene of lanes (the 480x272 fast-GI golden pins the full-frame integration).
"""

import jax
import jax.numpy as jnp
import numpy as np

from vulkan_pbr_renderer.shade import gi
from vulkan_pbr_renderer.utils import math3d as m3


def _inputs(seed=0, h=24, w=32):
    rng = np.random.default_rng(seed)
    clip_from_view = jnp.asarray(
        m3.perspective_lh_zo(np.deg2rad(60.0), w / h, 0.1, 100.0))
    view_from_clip = jnp.asarray(
        np.linalg.inv(np.asarray(clip_from_view)).astype(np.float32))
    # arbitrary rigid world_from_view (identical input to both impls)
    ang = 0.7
    wv = np.eye(4, dtype=np.float32)
    wv[:3, :3] = np.array([[np.cos(ang), -np.sin(ang), 0],
                           [np.sin(ang), np.cos(ang), 0],
                           [0, 0, 1]], np.float32)
    wv[:3, 3] = (1.0, -2.0, 0.5)
    world_from_view = jnp.asarray(wv)

    # lanes: on-screen view-space starts with z in [1.5, 12]; the open point
    # a short positive-z hop away (like the fast path's first-open march stop)
    z = rng.uniform(1.5, 12.0, (h, w)).astype(np.float32)
    nx = rng.uniform(-0.7, 0.7, (h, w)).astype(np.float32)
    ny = rng.uniform(-0.7, 0.7, (h, w)).astype(np.float32)
    f = 1.0 / np.tan(np.deg2rad(30.0))
    p0 = np.stack([nx * z / (f * h / w), ny * z / f, z], -1)
    step = rng.uniform(-1.0, 1.0, (h, w, 3)).astype(np.float32)
    step[..., 2] = np.abs(step[..., 2]) * 0.5
    # a slice of lanes starting near the screen edge marching outward and
    # toward the camera, so they exit the frustum unoccluded within the
    # z/100-scaled step budget (exercises the status=1 offscreen fallback)
    q = h // 4
    z[:q] = 1.6
    nx[:q] = 0.93
    p0 = np.stack([nx * z / (f * h / w), ny * z / f, z], -1)
    step[:q, :, 0] = 1.0
    step[:q, :, 1] = 0.0
    step[:q, :, 2] = -0.2
    open_vs = p0 + step * rng.uniform(0.5, 4.0, (h, w, 1)).astype(np.float32)

    # bumpy depth buffer in (0.3, 1) and a random half-open alpha grid
    d = rng.uniform(0.35, 0.99, (34, 40)).astype(np.float32)
    depth = jnp.asarray(np.minimum.reduce(
        [np.roll(np.roll(d, i, 0), j, 1) for i in (0, 1) for j in (0, 1)]))
    grid = rng.uniform(0.0, 1.0, (16, 16, 16, 4)).astype(np.float32)
    grid[..., 3] = (grid[..., 3] > 0.55) * grid[..., 3]
    walpha = gi.pack_grid_alpha_u16(jnp.asarray(grid))
    noise = jnp.asarray(rng.uniform(0.0, 1.0, (h, w)).astype(np.float32))
    return dict(depth=depth, walpha=walpha, p0=jnp.asarray(p0),
                open_vs=jnp.asarray(open_vs), cfv=clip_from_view,
                vfc=view_from_clip, wfv=world_from_view, noise=noise)


def test_trace_v2_matches_v1_decisions():
    i = _inputs()
    kw = dict(lightgrid_scale=0.1, steps=12, rounds=2, steps2=6,
              solid_taps=3, unroll=24)
    s2, uv2, sl2 = jax.jit(
        lambda: gi.screen_trace_linear(
            i["depth"], i["walpha"], i["p0"], i["open_vs"], i["cfv"],
            i["wfv"], noise_01=i["noise"], **kw))()
    s1, uv1, sl1 = jax.jit(
        lambda: gi.screen_trace_linear_v1(
            i["depth"], i["walpha"], i["p0"], i["open_vs"], None, i["cfv"],
            i["vfc"], i["wfv"], noise_01=i["noise"], **kw))()
    s1, s2 = np.asarray(s1), np.asarray(s2)
    agree = (s1 == s2).mean()
    # different float-op order: razor-thin occlusion/solidity ties may flip;
    # everything else must agree
    assert agree >= 0.995, f"status agreement {agree:.4f}"
    both_res = (s1 == 3) & (s2 == 3)
    assert both_res.sum() > 20, "trace never resolved — inputs degenerate"
    np.testing.assert_allclose(np.asarray(uv2)[both_res],
                               np.asarray(uv1)[both_res], atol=1e-4)
    np.testing.assert_allclose(np.asarray(sl2)[both_res],
                               np.asarray(sl1)[both_res], rtol=1e-4)
    # every terminal status exercised (0 is remapped to 2 at exit)
    assert set(np.unique(s2)) == {1, 2, 3}, np.unique(s2)


def test_trace_v2_loop_equals_unrolled():
    """unroll=k fori_loop vs the straight-line unroll: same march decisions.

    Not bit-identical — XLA contracts FMAs differently in loop bodies vs
    straight-line code (observed: one lane, 3e-8 uv delta) — so statuses
    must match exactly and floats to 1e-6."""
    i = _inputs(seed=3)
    kw = dict(lightgrid_scale=0.1, steps=12, rounds=2, steps2=6,
              solid_taps=3)
    outs = []
    for unroll in (24, 4):
        outs.append(jax.jit(
            lambda u=unroll: gi.screen_trace_linear(
                i["depth"], i["walpha"], i["p0"], i["open_vs"], i["cfv"],
                i["wfv"], noise_01=i["noise"], unroll=u, **kw))())
    (sa, uva, sla), (sb, uvb, slb) = outs
    np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
    np.testing.assert_allclose(np.asarray(uva), np.asarray(uvb), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sla), np.asarray(slb), rtol=1e-6)


