"""Hierarchical-z screen trace (gi.build_hiz_atlas / gi.hiz_trace).

The hi-z DDA is the fast-GI screen term's replacement for the reference's
linear screen trace (lighting_pass.glsl:315-397): these tests pin its
traversal semantics — hit positions against analytic cases and agreement
with a dense 1-px brute-force trace on random depth fields.
"""

import jax
import jax.numpy as jnp
import numpy as np

from vulkan_pbr_renderer.shade import gi


def _trace(depth, p0, p1, **kw):
    atlas, offs = gi.build_hiz_atlas(jnp.asarray(depth), levels=5)
    f = jax.jit(lambda a, o, x, y: gi.hiz_trace(
        a, o, depth.shape, x, y, max_level=4, **kw))
    hit, t, dead = f(atlas, offs, jnp.asarray(p0, jnp.float32),
                     jnp.asarray(p1, jnp.float32))
    return np.asarray(hit), np.asarray(t), np.asarray(dead)


def test_flat_wall_hit_position():
    """Segment crossing a flat z=0.5 wall hits at the crossing t."""
    depth = np.full((64, 64), 0.5, np.float32)
    p0 = np.array([[0.2, 0.5, 0.40]])
    p1 = np.array([[0.8, 0.5, 0.60]])
    hit, t, _ = _trace(depth, p0, p1)
    assert hit[0]
    # z(t)=0.4+0.2t crosses 0.5 at t=0.5; the DDA lands within one cell
    assert abs(t[0] - 0.5) < 0.06


def test_in_front_no_hit():
    depth = np.full((64, 64), 0.5, np.float32)
    p0 = np.array([[0.2, 0.3, 0.10]])
    p1 = np.array([[0.9, 0.8, 0.30]])
    hit, _, dead = _trace(depth, p0, p1)
    assert not hit[0]


def test_thin_occluder_is_skipped():
    """A ray far behind a thin column passes it (two-sided thickness test)
    instead of false-hitting like a one-sided probe would."""
    depth = np.full((64, 64), 0.9, np.float32)
    depth[:, 30:33] = 0.5                     # thin near column
    p0 = np.array([[0.1, 0.5, 0.70]])
    p1 = np.array([[0.9, 0.5, 0.70]])         # constant z=0.7 < 0.9 backdrop
    hit, _, _ = _trace(depth, p0, p1, iters=14, thickness=0.015)
    assert not hit[0]


def test_thick_occluder_hits():
    """Same geometry but the ray passes just behind the surface -> hit."""
    depth = np.full((64, 64), 0.9, np.float32)
    depth[:, 30:] = 0.5
    p0 = np.array([[0.1, 0.5, 0.502]])
    p1 = np.array([[0.9, 0.5, 0.510]])
    hit, t, _ = _trace(depth, p0, p1, iters=14)
    assert hit[0]
    # the wall starts at u = 30/64 = 0.469 -> t = (0.469-0.1)/0.8 = 0.461
    assert abs(t[0] - 0.461) < 0.08


def _brute_force(depth, p0, p1, thickness, steps=512):
    """1-px-class dense reference trace with the same two-sided rule."""
    h, w = depth.shape
    hits = np.zeros(p0.shape[0], bool)
    ts = np.zeros(p0.shape[0], np.float32)
    for i in range(p0.shape[0]):
        for k in range(1, steps + 1):
            t = k / steps
            p = p0[i] + (p1[i] - p0[i]) * t
            if not (0 <= p[0] < 1 and 0 <= p[1] < 1):
                break
            x = min(int(p[0] * w), w - 1)
            y = min(int(p[1] * h), h - 1)
            z = depth[y, x]
            if z < 1.0 and p[2] >= z and p[2] - z < thickness:
                hits[i] = True
                ts[i] = t
                break
    return hits, ts


def test_agrees_with_brute_force_on_random_field():
    rng = np.random.default_rng(0)
    # smooth-ish random depth: base gradient + low-frequency bumps
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    depth = (0.45 + 0.3 * xx + 0.1 * np.sin(6 * xx + 2) * np.sin(5 * yy)
             ).astype(np.float32)
    n = 128
    p0 = np.stack([rng.uniform(0.1, 0.9, n), rng.uniform(0.1, 0.9, n),
                   rng.uniform(0.2, 0.9, n)], -1).astype(np.float32)
    p1 = np.clip(p0 + rng.uniform(-0.6, 0.6, (n, 3)), 0.01, 0.99
                 ).astype(np.float32)
    hit, t, _ = _trace(depth, p0, p1, iters=14, thickness=0.05)
    bhit, bt = _brute_force(depth, p0, p1, thickness=0.05)
    agree = hit == bhit
    # the fixed 14-iteration budget may terminate long traces early (counts
    # as disagree); everything else should match
    assert agree.mean() >= 0.9, f"agreement {agree.mean():.3f}"
    both = hit & bhit
    if both.any():
        assert np.abs(t[both] - bt[both]).max() < 0.12
