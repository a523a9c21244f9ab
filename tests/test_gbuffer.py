import jax
import jax.numpy as jnp
import numpy as np

from vulkan_pbr_renderer.assets import MaterialDesc, build_scene, procedural
from vulkan_pbr_renderer.raster import setup as rs
from vulkan_pbr_renderer.raster import xla_raster as rr
from vulkan_pbr_renderer.shade import gbuffer as gb
from vulkan_pbr_renderer.utils import math3d as m3


def _camera_looking_plus_y(pos=(0, -4, 0), fov=60.0, aspect=1.0):
    """View matrices per reference conventions: world Z-up, view +Y-down +Z-fwd."""
    q = m3.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), -np.pi / 2)
    world_from_view = m3.translate(jnp.asarray(pos, jnp.float32)) @ m3.quat_to_mat4(q)
    view_from_world = m3.inverse(world_from_view)
    proj = m3.perspective_lh_zo(np.deg2rad(fov), aspect, 0.1, 100.0)
    return proj @ view_from_world


def _render_scene(scene, clip_from_world, W, H, cull="back"):
    clip = rs.transform_to_clip(scene.positions, clip_from_world)
    tri_clip = clip[scene.indices]
    s = rs.setup_triangles(tri_clip, W, H, cull=cull)
    depth, tri = rr.rasterize_vis(s, W, H)
    return s, depth, tri


def test_cube_gbuffer_front_face():
    mats = [MaterialDesc(base_color=procedural.checker_texture(32, 4, (1, 0, 0), (0, 0, 1)),
                         orm_factor=(1.0, 0.5, 0.0))]
    scene = build_scene([procedural.make_cube(center=(0, 0, 0), size=(2, 2, 2))], mats,
                        texture_size=32)
    cam = _camera_looking_plus_y()
    W = H = 64
    s, depth, tri = _render_scene(scene, cam, W, H)
    assert int((np.asarray(tri) >= 0).sum()) > 400  # cube visible
    g = gb.gbuffer_pass(scene, s, depth, tri, cam, cam)
    g = jax.tree.map(np.asarray, g)
    cy, cx = H // 2, W // 2
    assert g.coverage[cy, cx]
    # front face of the cube faces -Y toward the camera
    # atol 6e-3: the uint8 material atlas quantizes the flat normal (0.5 is
    # not representable in UNORM8 — 127/255 -> 1/255 tilt), exactly like the
    # reference's 8-bit TGA normal maps
    np.testing.assert_allclose(g.normal[cy, cx], [0, -1, 0], atol=6e-3)
    # static scene + same matrices -> zero velocity
    np.testing.assert_allclose(g.velocity[cy, cx], 0.0, atol=1e-6)
    # checker texture: red or blue (sRGB->linear applied)
    c = g.base_color[cy, cx]
    assert (c[0] > 0.5 and c[2] < 0.1) or (c[2] > 0.5 and c[0] < 0.1)
    # roughness from orm_factor
    assert abs(g.orm[cy, cx][1] - 0.5) < 3e-3  # UNORM8 quantization step
    # background pixel
    assert not g.coverage[2, 2]
    assert g.depth[2, 2] == 1.0


def test_gbuffer_depth_monotone_with_distance():
    mats = [MaterialDesc()]
    near_cube = procedural.make_cube(center=(-1.2, 0, 0), size=(1, 1, 1))
    far_cube = procedural.make_cube(center=(1.2, 4, 0), size=(1, 1, 1))
    scene = build_scene([near_cube, far_cube], mats, texture_size=16)
    cam = _camera_looking_plus_y(pos=(0, -4, 0))
    s, depth, tri = _render_scene(scene, cam, 64, 64)
    d = np.asarray(depth)
    left = d[32, 10:28]
    right = d[32, 40:60]
    lm = left[left < np.inf]
    rm = right[right < np.inf]
    assert lm.size and rm.size and lm.mean() < rm.mean()


def test_normal_mapping_perturbs_normal():
    flat = MaterialDesc()
    bumpy = MaterialDesc(normal=procedural.bump_normal_texture(64, 2, 0.8))
    plane_flat = procedural.make_plane(center=(-1.5, 0, 0), size=(2, 2), normal_axis=1, material=0)
    plane_bump = procedural.make_plane(center=(1.5, 0, 0), size=(2, 2), normal_axis=1, material=1)
    # make_plane normal is +axis; camera at -Y so flip normals toward camera
    for p in (plane_flat, plane_bump):
        p.normals *= -1
        p.indices = p.indices[:, ::-1].copy()
    scene = build_scene([plane_flat, plane_bump], [flat, bumpy], texture_size=64)
    cam = _camera_looking_plus_y(pos=(0, -4, 0), fov=75.0)
    s, depth, tri = _render_scene(scene, cam, 96, 96, cull="none")
    g = gb.gbuffer_pass(scene, s, depth, tri, cam, cam)
    g = jax.tree.map(np.asarray, g)
    ys, xs = np.nonzero(g.coverage)
    left_px = (xs < 48) & g.coverage[ys, xs]
    flat_n = g.normal[ys[left_px], xs[left_px]]
    np.testing.assert_allclose(flat_n, np.tile([[0, -1, 0]], (flat_n.shape[0], 1)), atol=1e-2)
    right_n = g.normal[ys[~left_px], xs[~left_px]]
    # bumpy side: normals vary, but stay roughly facing the camera
    assert right_n[:, 1].max() < -0.3
    assert right_n[:, 0].std() > 0.05


def test_velocity_under_camera_motion():
    mats = [MaterialDesc()]
    scene = build_scene([procedural.make_cube(center=(0, 0, 0), size=(2, 2, 2))], mats,
                        texture_size=16)
    cam_old = _camera_looking_plus_y(pos=(0, -4, 0))
    cam_new = _camera_looking_plus_y(pos=(0.2, -4, 0))  # camera moved +x
    s, depth, tri = _render_scene(scene, cam_new, 64, 64)
    g = gb.gbuffer_pass(scene, s, depth, tri, cam_new, cam_old)
    v = np.asarray(g.velocity)[np.asarray(g.coverage)]
    # moving camera +x makes geometry move -x in ndc
    assert v[:, 0].mean() < -1e-3
    assert abs(v[:, 1].mean()) < 1e-3
