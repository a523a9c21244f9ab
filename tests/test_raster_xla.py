import jax
import jax.numpy as jnp
import numpy as np

from vulkan_pbr_renderer.raster import setup as rs
from vulkan_pbr_renderer.raster import xla_raster as rr


def _clip_from_ndc2d(verts2d, z=0.5):
    """Build clip-space tris from 2D NDC verts (w=1)."""
    v = np.asarray(verts2d, np.float32)
    n = v.shape[0] // 3
    clip = np.concatenate(
        [v, np.full((v.shape[0], 1), z, np.float32), np.ones((v.shape[0], 1), np.float32)], -1
    )
    return jnp.asarray(clip.reshape(n, 3, 4))


def test_triangle_demo_parity():
    """The reference triangle demo (triangle.cpp:66-70): verts at
    (-0.5,-0.5) (0.5,-0.5) (0,0.5), clear (0.1,0.2,0.5).  NDC y-down means
    the first two verts are in the upper half of the image."""
    clip = _clip_from_ndc2d([[-0.5, -0.5], [0.5, -0.5], [0.0, 0.5]])
    W, H = 64, 64
    s = rs.setup_triangles(clip, W, H, cull="none")
    depth, tri = jax.jit(lambda s: rr.rasterize_vis(s, W, H))(s)
    tri = np.asarray(tri)
    depth = np.asarray(depth)
    # center covered
    assert tri[32, 32] == 0 and depth[32, 32] == np.float32(0.5)
    # triangle apex is at ndc y=+0.5 -> lower half; top rows empty
    assert tri[2, 32] == -1
    assert tri[40, 32] == 0
    # corners empty
    for y, x in [(0, 0), (0, 63), (63, 0), (63, 63)]:
        assert tri[y, x] == -1
    # coverage roughly half-base * height* : area 0.5*1.0*... in ndc: base 1, h 1 -> area .5 ndc^2
    # = 0.5/4 of screen = 512 px of 4096
    count = (tri >= 0).sum()
    assert abs(count - 512) < 40


def test_depth_test_two_triangles():
    # two overlapping fullscreen-ish tris at different depths
    clip = _clip_from_ndc2d(
        [[-1, -1], [3, -1], [-1, 3], [-1, -1], [3, -1], [-1, 3]], z=0.5
    )
    clip = clip.at[1, :, 2].set(0.25)  # second closer
    s = rs.setup_triangles(clip, 32, 32, cull="none")
    depth, tri = rr.rasterize_vis(s, 32, 32)
    assert int(tri[16, 16]) == 1
    assert float(depth[16, 16]) == 0.25


def test_winding_cull():
    cw = _clip_from_ndc2d([[-0.5, -0.5], [0.5, -0.5], [0.0, 0.5]])  # y-down: this is CW? determined below
    ccw = cw[:, ::-1, :]
    s_cw = rs.setup_triangles(cw, 32, 32, cull="back")
    s_ccw = rs.setup_triangles(ccw, 32, 32, cull="back")
    # exactly one of the two windings survives ccw culling
    assert bool(s_cw.valid[0]) != bool(s_ccw.valid[0])
    # and 'none' keeps both
    assert bool(rs.setup_triangles(cw, 32, 32, cull="none").valid[0])
    assert bool(rs.setup_triangles(ccw, 32, 32, cull="none").valid[0])
    # both windings rasterize identical coverage under cull='none'
    d1, t1 = rr.rasterize_vis(rs.setup_triangles(cw, 32, 32, cull="none"), 32, 32)
    d2, t2 = rr.rasterize_vis(rs.setup_triangles(ccw, 32, 32, cull="none"), 32, 32)
    np.testing.assert_array_equal(np.asarray(t1) >= 0, np.asarray(t2) >= 0)


def test_perspective_interpolation():
    """A triangle with differing w: perspective-correct barycentrics must
    reproduce attr = a/w interpolation (checked against manual ref)."""
    # vertex 0 near (w=1), vertices 1,2 far (w=4): attr = [0,1,1]
    clip = jnp.asarray(
        np.array(
            [[[-0.9, -0.9, 0.5, 1.0], [3.6, -3.6, 2.0, 4.0], [-3.6, 3.6, 2.0, 4.0]]],
            np.float32,
        )
    )
    W = H = 64
    s = rs.setup_triangles(clip, W, H, cull="none")
    depth, tri = rr.rasterize_vis(s, W, H)
    ys, xs = np.nonzero(np.asarray(tri) == 0)
    lam = rs.barycentrics_at(s, jnp.zeros_like(jnp.asarray(xs)), jnp.asarray(xs, jnp.float32), jnp.asarray(ys, jnp.float32))
    lam = np.asarray(lam)
    np.testing.assert_allclose(lam.sum(-1), 1.0, atol=1e-4)
    # at pixel nearest to vertex 0's projection (ndc -0.9,-0.9 -> px 3.2,3.2): lambda0 ~ 1
    i = np.argmin((xs - 3) ** 2 + (ys - 3) ** 2)
    assert lam[i, 0] > 0.9


def test_behind_camera_culled():
    # all three verts behind the camera (w<0) -> nothing drawn
    clip = jnp.asarray(
        np.array([[[0, 0, 0.5, -1.0], [1, 0, 0.5, -1.0], [0, 1, 0.5, -1.0]]], np.float32)
    )
    s = rs.setup_triangles(clip, 32, 32, cull="none")
    depth, tri = rr.rasterize_vis(s, 32, 32)
    assert (np.asarray(tri) == -1).all()


def test_crossing_near_plane_rasterizes():
    """A triangle with one vertex behind the eye must still fill toward the
    screen edge (2DH raster needs no clipping)."""
    clip = jnp.asarray(
        np.array(
            [[[-0.5, 0.5, 0.5, 1.0], [0.5, 0.5, 0.5, 1.0], [0.0, 0.1, -0.1, -0.2]]],
            np.float32,
        )
    )
    s = rs.setup_triangles(clip, 64, 64, cull="none")
    depth, tri = rr.rasterize_vis(s, 64, 64)
    tri = np.asarray(tri)
    assert (tri >= 0).sum() > 100  # a large fan toward the screen border
    # bbox must CONTAIN all covered pixels (conservative) without falling
    # back to full screen (round 3: directional extensions from the w=eps
    # crossings — here the fan opens downward only, so y0 stays at the
    # projected front edge)
    ys, xs = np.nonzero(tri >= 0)
    x0, y0, x1, y1 = np.asarray(s.bbox[0])
    assert x0 <= xs.min() and xs.max() < x1
    assert y0 <= ys.min() and ys.max() < y1
    assert y0 > 0  # tighter than the old full-screen fallback


def test_bbox_tight_for_front_triangles():
    clip = _clip_from_ndc2d([[-0.5, -0.5], [0.5, -0.5], [0.0, 0.5]])
    s = rs.setup_triangles(clip, 64, 64, cull="none")
    x0, y0, x1, y1 = np.asarray(s.bbox[0])
    assert 14 <= x0 <= 16 and 46 <= x1 <= 50
    assert 14 <= y0 <= 16 and 46 <= y1 <= 50
