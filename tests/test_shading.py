import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vulkan_pbr_renderer.shade import bloom as bloom_mod
from vulkan_pbr_renderer.shade import brdf, gi, shadow, taa
from vulkan_pbr_renderer.utils import math3d as m3


# ---------------------------------------------------------------------------
# BRDF


def test_ggx_normalization():
    """Integral of D(h) cos(h) over the hemisphere must be ~1."""
    n = 512
    theta = (np.arange(n) + 0.5) * (np.pi / 2) / n
    for rough in [0.1, 0.3, 0.7, 1.0]:
        d = np.asarray(brdf.distribution_ggx(jnp.cos(jnp.asarray(theta)), rough))
        integral = np.sum(d * np.cos(theta) * np.sin(theta)) * (np.pi / 2 / n) * 2 * np.pi
        assert abs(integral - 1.0) < 0.02, (rough, integral)


def test_fresnel_limits():
    f0 = jnp.array([0.04, 0.04, 0.04])
    assert np.allclose(np.asarray(brdf.fresnel_schlick(jnp.array(1.0), f0)), 0.04)
    assert np.allclose(np.asarray(brdf.fresnel_schlick(jnp.array(0.0), f0)), 1.0)


def test_geometry_terms_bounded():
    rng = np.random.default_rng(0)
    nh, vn, ln, vh = [jnp.asarray(rng.uniform(0.01, 1, 64).astype(np.float32)) for _ in range(4)]
    g = np.asarray(brdf.geometry_mikkelsen(nh, vn, ln, vh))
    assert (g >= 0).all() and (g <= 1).all()
    g2 = np.asarray(brdf.geometry_smith_direct(vn, ln, jnp.float32(0.5)))
    assert (g2 >= 0).all() and (g2 <= 1).all()


def test_cook_torrance_energy():
    """A white lambertian-ish surface must reflect less than the incident light."""
    n = jnp.array([[0.0, 0.0, 1.0]])
    v = m3.normalize(jnp.array([[0.3, 0.2, 0.9]]))
    l = m3.normalize(jnp.array([[-0.2, 0.1, 0.95]]))
    out = np.asarray(
        brdf.cook_torrance_direct(n, v, l, jnp.ones((1, 3)), jnp.array([0.5]), jnp.array([0.0]))
    )
    assert (out >= 0).all() and (out < 2.0).all()


# ---------------------------------------------------------------------------
# Lightgrid sweep vs direct GLSL-semantics simulation


def _sweep_numpy_line(vals, move_ratio=0.5, sky=(1.0, 1.2, 2.0), blend=0.35):
    """Literal numpy translation of lightgrid_sweep.glsl:25-74 for one line."""
    old = vals.copy()
    v = vals.copy()
    ml = np.asarray(sky, np.float32)
    for x in range(v.shape[0]):
        if old[x, 3] > 0.5:
            ml = old[x, :3].copy()
        else:
            v[x, :3] += ml
            ml = move_ratio * v[x, :3]
            v[x, :3] -= ml
    v[-1, :3] += ml
    ml = np.asarray(sky, np.float32)
    for x in range(v.shape[0] - 1, -1, -1):
        if old[x, 3] > 0.5:
            ml = old[x, :3].copy()
        else:
            v[x, :3] += ml
            ml = move_ratio * v[x, :3]
            v[x, :3] -= ml
    v[0, :3] += ml
    out = old.copy()
    for x in range(v.shape[0]):
        if old[x, 3] < 0.5:
            out[x] = old[x] + (v[x] - old[x]) * blend
            out[x, 3] = old[x, 3]
    return out


def test_sweep_matches_glsl_semantics():
    rng = np.random.default_rng(1)
    n = 32
    grid = np.zeros((n, 4, 4, 4), np.float32)
    grid[..., :3] = rng.uniform(0, 2, (n, 4, 4, 3))
    occ = rng.random((n, 4, 4)) < 0.3
    grid[..., 3] = occ.astype(np.float32)
    got = np.asarray(gi.sweep_lightgrid(jnp.asarray(grid), axis=0))
    for y in range(4):
        for x in range(4):
            expect = _sweep_numpy_line(grid[:, y, x].copy())
            np.testing.assert_allclose(got[:, y, x], expect, rtol=1e-4, atol=1e-4)


def test_sweep_axis_rotation():
    grid = jnp.zeros((8, 8, 8, 4))
    for axis in range(3):
        out = gi.sweep_lightgrid(grid, axis=axis)
        assert out.shape == grid.shape
        # empty grid fills with skylight-derived values > 0
        assert float(out[..., :3].min()) > 0.0


# ---------------------------------------------------------------------------
# Shadowing


def test_sun_matrices_angles():
    sun_from_world, sun_dir = shadow.sun_matrices(0.0, 0.0)
    # angle 0: no rotation; sun looks along -z (straight down)
    np.testing.assert_allclose(np.asarray(sun_dir), [0, 0, -1], atol=1e-6)
    p = m3.transform_points(sun_from_world, jnp.array([[0.0, 0.0, 40.0]]))
    assert float(p[0, 2]) == pytest.approx(0.0, abs=1e-5)  # +40 up -> depth 0
    sun_from_world, sun_dir = shadow.sun_matrices(45.0, 0.0)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(sun_dir)), 1.0, atol=1e-5)
    assert abs(float(sun_dir[1])) > 0.5  # tilted toward +-y


def test_sun_visibility_occluder():
    # depth map: occluder at depth 0.3 over left half, far (1.0) right half
    s = 64
    depth = np.ones((s, s), np.float32)
    depth[:, : s // 2] = 0.3
    sun_from_world, _ = shadow.sun_matrices(0.0, 0.0)
    # points below the occluder (z<0 -> depth>0.5) on each side
    pts = jnp.array([[-20.0, 0.0, -10.0], [20.0, 0.0, -10.0]])
    nrm = jnp.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    z = jnp.zeros(2)
    vis = np.asarray(
        shadow.sun_visibility(jnp.asarray(depth), sun_from_world, pts, nrm, z, z)
    )
    assert vis[0] < 0.1  # shadowed under the occluder
    assert vis[1] > 0.9  # lit


def test_light_shafts_accumulate_when_visible():
    s = 32
    depth = jnp.ones((s, s), jnp.float32)  # fully open sky
    sun_from_world, _ = shadow.sun_matrices(0.0, 0.0)
    cam = jnp.array([0.0, 0.0, 0.0])
    target = jnp.array([[10.0, 0.0, 0.0]])
    nrm = jnp.array([[0.0, 0.0, 1.0]])
    shafts = np.asarray(
        shadow.light_shafts(depth, sun_from_world, cam, target, nrm,
                            jnp.zeros(1), jnp.array([1.0, 0.9, 0.7]))
    )
    assert shafts[0, 0] > 0.0
    # fully occluded map -> zero
    shafts0 = np.asarray(
        shadow.light_shafts(jnp.zeros((s, s)) - 1.0, sun_from_world, cam, target, nrm,
                            jnp.zeros(1), jnp.array([1.0, 0.9, 0.7]))
    )
    assert shafts0[0, 0] == 0.0


def test_light_shafts_polar_matches_march():
    """The epipolar profile must reproduce the per-step march closely on a
    structured occluder field (the two discretize the same integral: radial
    bins == the reference's 1/16 step; the polar path adds only theta
    quantization)."""
    rng = np.random.default_rng(3)
    s = 256
    # blocky occluder field: depth 0.35 patches over open sky
    depth = np.ones((s, s), np.float32)
    mask = rng.random((8, 8)) > 0.5
    depth[np.kron(mask, np.ones((32, 32), bool))] = 0.35
    depth = jnp.asarray(depth)
    sun_from_world, _ = shadow.sun_matrices(25.0, 40.0)
    cam = jnp.array([3.0, -6.0, 2.0])
    # a grid of surface points across the volume
    g = np.stack(np.meshgrid(np.linspace(-25, 25, 12),
                             np.linspace(-25, 25, 12), indexing="ij"), -1)
    pts = jnp.asarray(np.concatenate(
        [g.reshape(-1, 2), np.full((144, 1), -5.0)], -1).astype(np.float32))
    nrm = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), pts.shape)
    noise = jnp.full(pts.shape[:1], 0.5)
    emission = jnp.array([1.0, 0.9, 0.7])
    march = np.asarray(shadow.light_shafts(
        depth, sun_from_world, cam, pts, nrm, noise, emission))[..., 0]
    polar = np.asarray(shadow.light_shafts_polar(
        depth, sun_from_world, cam, pts, nrm, noise, emission,
        n_theta=8192))[..., 0]
    # same scale, high correlation, small mean error
    assert march.max() > 0.0 and polar.max() > 0.0
    denom = march.max()
    err = np.abs(polar - march) / denom
    assert err.mean() < 0.08, err.mean()
    corr = np.corrcoef(march.ravel(), polar.ravel())[0, 1]
    assert corr > 0.95, corr


def test_taa_ycocg_history_close_to_rgb_catmull():
    """The YCoCg split history (Catmull luma + bilinear chroma) must track
    the reference's full RGB Catmull resample."""
    from vulkan_pbr_renderer.gpu import sampling as S

    rng = np.random.default_rng(4)
    h, w = 48, 64
    lighting = jnp.asarray(rng.random((h, w, 3)).astype(np.float32) * 2.0)
    history = jnp.asarray(rng.random((h, w, 3)).astype(np.float32) * 2.0)
    depth = jnp.asarray(rng.random((h, w)).astype(np.float32))
    vel = jnp.full((h, w, 2), 0.013)   # subpixel-ish reprojection
    out_ycocg = np.asarray(taa.taa_resolve(
        lighting, depth, vel, vel, history, catmull_history=True))
    # reference resample path: full RGB Catmull-Rom on the same reproj uv
    out_bilin = np.asarray(taa.taa_resolve(
        lighting, depth, vel, vel, history, catmull_history=False))
    # the ycocg path must stay finite, in-range, and differ from bilinear by
    # less than the source-vs-history spread (it is a *history filter* detail)
    assert np.isfinite(out_ycocg).all()
    assert np.abs(out_ycocg - out_bilin).mean() < 0.1
    # luma of the resampled history is Catmull-exact: verify directly
    y = 0.25 * history[..., 0] + 0.5 * history[..., 1] + 0.25 * history[..., 2]
    uv = jnp.stack(jnp.meshgrid(
        (jnp.arange(w) + 0.5) / w, (jnp.arange(h) + 0.5) / h,
        indexing="xy"), -1) - vel * 0.5
    ref_y = np.asarray(S.sample_catmull_rom(y[..., None], uv))[..., 0]
    wl = S.window_pack(y[..., None], 4, 4, dtype=jnp.float16)
    got_y = np.asarray(S.sample_catmull_rom_window_decode(
        wl, h, w, uv, 1))[..., 0]
    interior = np.s_[4:-4, 4:-4]
    np.testing.assert_allclose(got_y[interior], ref_y[interior],
                               rtol=0.005, atol=0.002)


# ---------------------------------------------------------------------------
# GI marches


def test_sample_radiance_sees_lit_voxel():
    n = 32
    grid = np.zeros((n, n, n, 4), np.float32)
    # a lit wall at x index 20..21 (alpha keeps it "open" in front)
    grid[:, :, 20:22, :3] = 5.0
    grid[:, :, 20:22, 3] = 0.0  # radiant fog, stays open
    out = np.asarray(
        gi.sample_radiance(
            jnp.asarray(grid),
            jnp.array([[0.0, 0.0, 0.0]]),
            jnp.array([[1.0, 0.0, 0.0]]),  # +x ray
            lightgrid_scale=1.0 / 16.0,
            num_steps=12,
        )
    )
    assert out[0].max() > 0.0


def test_sample_radiance_fast_multisample():
    """Fast GI: farther fog-weighted samples pick up radiance beyond the
    first (near-field) sample, and transmittance blocks samples behind
    occluders."""
    n = 32
    grid = np.zeros((n, n, n, 4), np.float32)
    grid[:, :, 8:13, :3] = 4.0       # radiant fog slab at x 8..12 (open)
    g = jnp.asarray(grid)
    # ray starts in empty space at voxel ~1; the skip stops after 1 step, so
    # samples land at voxels ~2.6 / 5.6 / 8.6 (spread 3): only the third
    # reaches the slab
    ro = jnp.array([[-0.9, 0.0, 0.0]])
    rd = jnp.array([[1.0, 0.0, 0.0]])
    one = np.asarray(gi.sample_radiance_fast(g, ro, rd, 1.0, n_samples=1)[0])
    multi = np.asarray(gi.sample_radiance_fast(g, ro, rd, 1.0, n_samples=3,
                                               sample_spread=3.0)[0])
    assert multi[0].max() > one[0].max()    # far samples add the slab's light
    # opaque wall between: the middle sample's occupancy must kill the far
    # sample's contribution (transmittance gating)
    grid2 = grid.copy()
    grid2[:, :, 5:8, 3] = 0.5
    multi_blocked = np.asarray(gi.sample_radiance_fast(
        jnp.asarray(grid2), ro, rd, 1.0, n_samples=3, sample_spread=3.0)[0])
    assert multi_blocked[0].max() < 1e-5


def test_screen_probe_hit_semantics():
    """The fast-GI screen probe reports a hit only when the projected open
    point lands on-screen BEHIND visible geometry, and returns the prev-frame
    color there (lighting_pass.glsl:371-384 resolve analog)."""
    from vulkan_pbr_renderer.gpu import sampling as S
    from vulkan_pbr_renderer.utils import math3d as m3

    h, w = 32, 32
    clip_from_world = m3.perspective_lh_zo(1.0, 1.0, 0.1, 100.0)  # cam at 0, +z fwd...
    # use a simple look-down-+Y view instead: identity view, project +Z fwd
    view = m3.look_at(jnp.array([0.0, 0.0, 0.0]), jnp.array([0.0, 1.0, 0.0]),
                      jnp.array([0.0, 0.0, 1.0]))
    cfw = clip_from_world @ view
    # LH_ZO depth is strongly nonlinear (near=0.1, far=100): geometry plane
    # at ndc z 0.9 corresponds to view distance ~1.0
    depth = jnp.full((h, w), 0.9)
    prev = jnp.ones((h, w, 3)) * jnp.array([2.0, 1.0, 0.5])
    wprev = S.window_pack(prev, 2, 2, dtype=jnp.float16)

    # world points along +Y (view fwd): one in FRONT of the depth surface
    # (y=0.5 -> ndc z 0.80), one BEHIND it (y=5 -> 0.98), one off-screen
    pts = jnp.array([[0.0, 0.5, 0.0],
                     [0.0, 5.0, 0.0],
                     [80.0, 1.0, 0.0]])
    hit, rgb = gi.screen_probe(pts, 1.0, cfw, depth, wprev, (h, w), 0.75)
    hit = np.asarray(hit)
    assert not hit[0] and hit[1] and not hit[2]
    np.testing.assert_allclose(np.asarray(rgb)[1], [1.5, 0.75, 0.375],
                               rtol=1e-2)


def test_sample_radiance_blocked_returns_zero():
    n = 16
    grid = np.zeros((n, n, n, 4), np.float32)
    grid[..., 3] = 1.0  # fully solid everywhere
    out = np.asarray(
        gi.sample_radiance(
            jnp.asarray(grid),
            jnp.array([[0.0, 0.0, 0.0]]),
            jnp.array([[1.0, 0.0, 0.0]]),
            lightgrid_scale=1.0 / 8.0,
        )
    )
    np.testing.assert_allclose(out[0], 0.0)


# ---------------------------------------------------------------------------
# TAA


def test_taa_static_scene_converges():
    rng = np.random.default_rng(2)
    y, x = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    clean = jnp.asarray(
        np.stack([x / 32, y / 32, (x + y) / 64], -1).astype(np.float32)
    )  # smooth: the Mitchell source filter reproduces linear ramps
    depth = jnp.full((32, 32), 0.5)
    vel = jnp.zeros((32, 32, 2))
    history = clean
    noisy = clean + 0.01 * jnp.asarray(rng.normal(0, 1, (32, 32, 3)).astype(np.float32))
    out = taa.taa_resolve(noisy, depth, vel, vel, history)
    # with zero velocity and matching history, output stays close to history
    err_out = float(jnp.abs(out - clean).mean())
    err_in = float(jnp.abs(noisy - clean).mean())
    assert err_out < err_in


def test_taa_offscreen_reprojection_rejects_history():
    clean = jnp.ones((16, 16, 3))
    depth = jnp.full((16, 16), 0.5)
    vel = jnp.full((16, 16, 2), 5.0)  # reprojects far off screen
    history = jnp.zeros((16, 16, 3))
    out = taa.taa_resolve(clean, depth, vel, vel, history)
    np.testing.assert_allclose(np.asarray(out), 1.0, atol=1e-4)


# ---------------------------------------------------------------------------
# Bloom


def test_bloom_preserves_dark_and_spreads_bright():
    img = jnp.zeros((64, 64, 3)).at[32, 32].set(100.0)
    out = np.asarray(bloom_mod.bloom(img, passes=4, strength=0.06))
    # energy spread: neighbors of the spike gain light
    assert out[20, 20].sum() > 0.0
    # the spike itself keeps most of its energy
    assert out[32, 32, 0] > 90.0
    # black stays black-ish far away... (tent chain reaches everywhere at 1/16 res,
    # but magnitude is tiny)
    assert out[2, 2, 0] < 1.0


def test_bloom_constant_image_adds_strength_fraction():
    img = jnp.full((64, 64, 3), 0.5)
    out = np.asarray(bloom_mod.bloom(img, passes=4, strength=0.06))
    # downsamples of a constant are constant (weights sum 1); firefly clamp no-op;
    # final = 0.5 + 0.06*0.5 in the interior
    np.testing.assert_allclose(out[16:48, 16:48], 0.5 * 1.06, rtol=1e-3)


def test_grid_u16_bitcast_sampling_bit_identical():
    # the u16-bitcast gather view of pack_grid_u8 must reproduce the u8
    # decode path exactly (gi._gs_uvw rationale)
    from vulkan_pbr_renderer.gpu import sampling as S

    rng = np.random.RandomState(3)
    grid = jnp.asarray(rng.rand(8, 8, 8, 4).astype(np.float32) * 4.0)
    grid = grid.at[..., 3].set((grid[..., 3] > 2.0).astype(jnp.float32))
    pack = gi.pack_grid_u8(grid)
    uvw = jnp.asarray(rng.rand(64, 3).astype(np.float32))
    via_u16 = gi._gs_uvw(pack, uvw)
    direct = S.sample_trilinear_window(pack, uvw, 4, decode=gi._decode_grid_u8)
    np.testing.assert_array_equal(np.asarray(via_u16), np.asarray(direct))


def test_sample_radiance_fog_sees_lit_voxel():
    # a bright voxel within march reach shows up in the fog result; a fully
    # blocked start returns 0 (sample_radiance_fog contract)
    D = 16
    grid = jnp.zeros((D, D, D, 4), jnp.float32)
    # solid wall at z index 8 and a bright voxel just before it
    grid = grid.at[8, :, :, 3].set(1.0)
    grid = grid.at[7, 8, 8, :3].set(5.0)
    fgrid = gi.pack_grid_f16_nearest(grid)
    scale = 1.0 / 10.0  # world [-10,10] -> ndc
    # start below the wall, ray +z (grid dim 0 = z)
    ro = jnp.asarray([[0.5, 0.5, -5.0]], jnp.float32)  # world
    rd = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    rgb, ro_open, ro_stop, hit, found = gi.sample_radiance_fog(
        fgrid, ro, rd, scale, skip_steps=3, march_steps=12)
    assert bool(found[0])
    assert bool(hit[0])                      # the wall stops the march
    assert float(rgb[0].max()) > 0.0         # picked up the bright voxel
    # fully enclosed start: no opening within skip budget -> black
    solid = jnp.zeros((D, D, D, 4), jnp.float32).at[..., 3].set(1.0)
    rgb2, _, _, _, found2 = gi.sample_radiance_fog(
        gi.pack_grid_f16_nearest(solid), ro, rd, scale, skip_steps=3,
        march_steps=6)
    assert not bool(found2[0])
    assert float(jnp.abs(rgb2).max()) == 0.0


def test_taa_full_rgb_catmull_matches_dense_reference():
    """full_rgb_catmull resamples history with the exact 16-tap RGB
    Catmull-Rom (taa_resolve.glsl:125-174) — verify the window-pack path
    against the dense sampler on the same reprojected uv."""
    from vulkan_pbr_renderer.gpu import sampling as S

    rng = np.random.default_rng(9)
    h, w = 48, 64
    history = jnp.asarray(rng.random((h, w, 3)).astype(np.float32) * 2.0)
    vel = jnp.full((h, w, 2), 0.013)
    uv = jnp.stack(jnp.meshgrid(
        (jnp.arange(w) + 0.5) / w, (jnp.arange(h) + 0.5) / h,
        indexing="xy"), -1) - vel * 0.5
    ref = np.asarray(S.sample_catmull_rom(history, uv))
    wrgb = S.window_pack(history, 4, 4, dtype=jnp.float16)
    got = np.asarray(S.sample_catmull_rom_window_decode(wrgb, h, w, uv, 3))
    interior = np.s_[4:-4, 4:-4]
    np.testing.assert_allclose(got[interior], ref[interior],
                               rtol=0.005, atol=0.004)
    # and the resolve path wires it in without blowing up
    lighting = jnp.asarray(rng.random((h, w, 3)).astype(np.float32))
    depth = jnp.asarray(rng.random((h, w)).astype(np.float32))
    out = np.asarray(taa.taa_resolve(lighting, depth, vel, vel, history,
                                     full_rgb_catmull=True))
    assert np.isfinite(out).all()
