import jax.numpy as jnp
import numpy as np
import pytest

from vulkan_pbr_renderer.utils import math3d as m3


def test_perspective_lh_zo_depth_range():
    # view space: +Y down, +Z forward; near -> 0, far -> 1 (camera.h:110-115)
    p = m3.perspective_lh_zo(np.deg2rad(75.0), 16 / 9, 0.02, 10000.0)
    near_pt = jnp.array([[0.0, 0.0, 0.02]])
    far_pt = jnp.array([[0.0, 0.0, 10000.0]])
    ndc_n, w_n = m3.project_points(p, near_pt)
    ndc_f, w_f = m3.project_points(p, far_pt)
    assert abs(float(ndc_n[0, 2])) < 1e-6
    assert abs(float(ndc_f[0, 2]) - 1.0) < 1e-5
    assert float(w_n[0]) == pytest.approx(0.02)


def test_perspective_fov():
    # a point at the top edge of the frustum maps to ndc y = -1 (y down)
    fov = np.deg2rad(90.0)
    p = m3.perspective_lh_zo(fov, 1.0, 0.1, 100.0)
    # +Y down view space: "up" is -y.  At z=10, half-height = 10*tan(45) = 10.
    top = jnp.array([[0.0, -10.0, 10.0]])
    ndc, _ = m3.project_points(p, top)
    assert float(ndc[0, 1]) == pytest.approx(-1.0, abs=1e-5)


def test_orthographic_sun_slab():
    # render.cpp:969: ortho(-40,40,-40,40,-40,40); camera looks down -z (RH)
    o = m3.orthographic_rh_zo(-40, 40, -40, 40, -40, 40)
    # a point 40 units in front (view z = -40) maps to depth 1
    ndc, _ = m3.project_points(o, jnp.array([[0.0, 0.0, -40.0]]))
    assert float(ndc[0, 2]) == pytest.approx(1.0)
    ndc, _ = m3.project_points(o, jnp.array([[0.0, 0.0, 40.0]]))
    assert float(ndc[0, 2]) == pytest.approx(0.0)
    ndc, _ = m3.project_points(o, jnp.array([[40.0, -40.0, 0.0]]))
    assert float(ndc[0, 0]) == pytest.approx(1.0)
    assert float(ndc[0, 1]) == pytest.approx(-1.0)
    assert float(ndc[0, 2]) == pytest.approx(0.5)


def test_quat_roundtrip():
    q = m3.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), jnp.pi / 2)
    m = m3.quat_to_mat4(q)
    v = m3.transform_dirs(m, jnp.array([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(np.asarray(v), [0.0, 1.0, 0.0], atol=1e-6)


def test_quat_mul_compose():
    qa = m3.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), 0.3)
    qb = m3.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), 0.5)
    q = m3.quat_mul(qa, qb)
    expect = m3.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), 0.8)
    np.testing.assert_allclose(np.asarray(q), np.asarray(expect), atol=1e-6)


def test_inverse():
    m = m3.translate([1.0, 2.0, 3.0]) @ m3.rotate_rh(0.7, [0.0, 0.0, 1.0])
    mi = m3.inverse(m)
    np.testing.assert_allclose(np.asarray(m @ mi), np.eye(4), atol=1e-5)


def test_rotate_about_axis_matches_matrix():
    v = jnp.array([0.3, -0.5, 0.8])
    axis = m3.normalize(jnp.array([0.2, 0.9, -0.1]))
    got = m3.rotate_about_axis(v, axis, 1.1)
    expect = m3.transform_dirs(m3.rotate_rh(1.1, axis), v)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect), atol=1e-5)


def test_reflect():
    i = jnp.array([1.0, -1.0, 0.0])
    n = jnp.array([0.0, 1.0, 0.0])
    np.testing.assert_allclose(np.asarray(m3.reflect(i, n)), [1.0, 1.0, 0.0], atol=1e-6)
