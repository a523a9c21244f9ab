import os
import struct

import numpy as np
import pytest

from vulkan_pbr_renderer.assets import dds, fbx, gltf, hdr, native_bcdec, suntemple, tga

RES = "/root/reference/resources"


# ---------------------------------------------------------------------------
# BC decode: native vs numpy reference on synthetic blocks


def _synthetic_bc1(bw, bh, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, bw * bh * 8, dtype=np.uint8).tobytes()


def _synthetic_bc16(bw, bh, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, bw * bh * 16, dtype=np.uint8).tobytes()


def test_bc1_native_matches_numpy():
    raw = _synthetic_bc1(4, 3, 1)
    ref = dds.decode_bc1(raw, 16, 12)
    got = native_bcdec.decode("BC1", raw, 16, 12)
    if got is None:
        pytest.skip("no native compiler")
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_bc3_native_matches_numpy():
    raw = _synthetic_bc16(4, 4, 2)
    ref = dds.decode_bc3(raw, 16, 16)
    got = native_bcdec.decode("BC3", raw, 16, 16)
    if got is None:
        pytest.skip("no native compiler")
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_bc5_native_matches_numpy():
    raw = _synthetic_bc16(3, 2, 3)
    ref = dds.decode_bc5(raw, 12, 8)
    got = native_bcdec.decode("BC5", raw, 12, 8)
    if got is None:
        pytest.skip("no native compiler")
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_bc1_known_block():
    # c0 = pure red (0xF800), c1 = pure blue (0x001F), c0 > c1 -> 4-color mode
    block = struct.pack("<HH", 0xF800, 0x001F) + bytes([0b01000100] * 4)
    out = dds.decode_bc1(block, 4, 4)
    np.testing.assert_allclose(out[0, 0], [1, 0, 0, 1], atol=1e-6)   # idx 0 = c0
    np.testing.assert_allclose(out[0, 1], [0, 0, 1, 1], atol=1e-6)   # idx 1 = c1


def test_dds_container_roundtrip(tmp_path):
    # minimal uncompressed RGBA8 DDS
    w = h = 4
    header = bytearray(128)
    header[:4] = b"DDS "
    struct.pack_into("<7I", header, 4, 124, 0x1007, h, w, w * 4, 0, 1)
    struct.pack_into("<II", header, 80, 0x41, 0)  # RGB|ALPHA
    struct.pack_into("<I", header, 88, 32)
    rng = np.random.default_rng(0)
    px = rng.integers(0, 255, (h, w, 4), dtype=np.uint8)
    p = tmp_path / "t.dds"
    p.write_bytes(bytes(header) + px.tobytes())
    img = dds.read_dds(str(p))
    np.testing.assert_allclose(img, px.astype(np.float32) / 255.0, atol=1e-6)


# ---------------------------------------------------------------------------
# Real reference assets (present in the mount)


@pytest.mark.skipif(not os.path.exists(f"{RES}/Cerberus.glb"), reason="no assets")
def test_load_cerberus():
    parts, mats = gltf.load_glb(f"{RES}/Cerberus.glb")
    assert sum(p.indices.shape[0] for p in parts) > 30000
    p = parts[0]
    assert np.isfinite(p.positions).all()
    assert abs(np.linalg.norm(p.normals, axis=1) - 1).max() < 1e-3


@pytest.mark.skipif(not os.path.exists(f"{RES}/UnitCube.glb"), reason="no assets")
def test_load_unitcube_material():
    parts, mats = gltf.load_glb(f"{RES}/UnitCube.glb")
    assert parts[0].indices.shape[0] == 12
    assert mats[0].orm_factor[1] == pytest.approx(0.5)   # roughnessFactor
    assert mats[0].orm_factor[2] == pytest.approx(0.0)   # metallicFactor


@pytest.mark.skipif(not os.path.exists(f"{RES}/Skybox_200x200x200.fbx"), reason="no assets")
def test_load_skybox_fbx():
    parts, mats = fbx.load_fbx(f"{RES}/Skybox_200x200x200.fbx")
    assert len(parts) == 1 and parts[0].indices.shape[0] == 12
    b = parts[0].positions
    np.testing.assert_allclose(b.min(0), [-100, -100, -100], atol=1e-3)
    np.testing.assert_allclose(b.max(0), [100, 100, 100], atol=1e-3)


@pytest.mark.skipif(not os.path.exists(f"{RES}/MetalRoughSpheres_Albedo.tga"),
                    reason="no assets")
def test_load_tga():
    img = tga.read_tga(f"{RES}/MetalRoughSpheres_Albedo.tga")
    assert img.shape[2] in (3, 4) and img.shape[0] == img.shape[1] == 1024
    assert 0.0 <= img.min() and img.max() <= 1.0


def test_hdr_roundtrip(tmp_path):
    # write a flat (non-RLE) Radiance file and read it back
    w, h = 8, 48  # stacked cube: h == 6w
    rgb = np.random.default_rng(1).uniform(0.1, 4.0, (h, w, 3)).astype(np.float32)
    # encode RGBE
    m = rgb.max(-1)
    e = np.ceil(np.log2(np.maximum(m, 1e-9))).astype(np.int32) + 1
    scale = np.ldexp(1.0, -e + 8)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe[..., 3] = (e + 128).astype(np.uint8)
    path = tmp_path / "t.hdr"
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    back = hdr.read_hdr(str(path))
    # RGBE quantizes each channel relative to the pixel's max component
    # (8-bit shared-exponent mantissa): error bound ~max/128 per channel
    bound = rgb.max(-1, keepdims=True) / 100.0
    assert (np.abs(back - rgb) <= bound).all()
    cube = hdr.read_hdr_cubemap(str(path))
    assert cube.shape == (6, 8, 8, 3)


def test_suntemple_watertight_walls():
    """All 6 hall boundary planes must be front-facing from inside."""
    import jax.numpy as jnp

    from vulkan_pbr_renderer.raster import setup as rs, xla_raster as rr
    from vulkan_pbr_renderer.assets import build_scene
    from vulkan_pbr_renderer.app.renderer import make_camera
    from vulkan_pbr_renderer.config import RenderConfig

    cfg = RenderConfig(width=96, height=64)
    scene = build_scene(suntemple.build_parts(0.2), suntemple.materials(), texture_size=16)
    # look in each axis direction from hall center
    for tgt in [(10, 0, 5), (-10, 0, 5), (0, 20, 5), (0, -20, 5), (0, 0.1, 13)]:
        cam = make_camera((0.0, 0.0, 5.0), tgt, cfg)
        clip = rs.transform_to_clip(scene.positions, cam.clip_from_world)
        s = rs.setup_triangles(clip[scene.indices], 96, 64, cull="back")
        d, t = rr.rasterize_vis(s, 96, 64)
        cov = float((np.asarray(t) >= 0).mean())
        assert cov > 0.65, (tgt, cov)  # walls present (ceiling gaps allowed)

def test_bc3_color_block_always_four_color():
    # BC3 spec: the color block ignores the c0<=c1 comparison and always
    # decodes in 4-color mode.  Build a BC3 block whose color
    # part has c0 < c1 and all selectors = 3: must be (c0+2*c1)/3, not black.
    alpha = bytes([255, 255] + [0] * 6)                  # constant alpha
    color = struct.pack("<HH", 0x001F, 0xF800) + bytes([0xFF] * 4)  # sel=3
    out = dds.decode_bc3(alpha + color, 4, 4)
    expect = (np.array([0, 0, 1.0]) + 2 * np.array([1.0, 0, 0])) / 3
    np.testing.assert_allclose(out[0, 0, :3], expect, atol=1e-6)
    got = native_bcdec.decode("BC3", alpha + color, 4, 4)
    if got is not None:
        np.testing.assert_allclose(got[0, 0, :3], expect, atol=1e-6)


def test_native_decode_rejects_truncated_buffer():
    raw = _synthetic_bc16(4, 4, 5)
    assert native_bcdec.decode("BC3", raw[: len(raw) // 2], 16, 16) is None
