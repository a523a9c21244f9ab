"""Scene container: geometry + materials as device arrays.

The equivalent of the reference's RenderObject (render.h:104-120, built by
LoadMesh, asset_import.cpp:79-178): one merged vertex/index buffer grouped by
material, with per-material base-color/normal/ORM/emissive textures and dummy
fallbacks (white / flat-normal / black, asset_import.cpp:194-197).  Instead of
per-part descriptor sets, materials become one packed mip-atlas texture array
and each triangle carries a material id — so the whole scene renders
in one pass with no per-material dispatch (a draw loop would defeat XLA).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..gpu import sampling


@dataclasses.dataclass
class MaterialDesc:
    """Host-side material description; textures are numpy [h,w,c] float in [0,1]."""

    base_color: Optional[np.ndarray] = None   # rgba; alpha used for alpha test
    normal: Optional[np.ndarray] = None       # tangent-space, xy in [0,1]
    orm: Optional[np.ndarray] = None          # occlusion/roughness/metallic
    emissive: Optional[np.ndarray] = None
    base_color_factor: tuple = (1.0, 1.0, 1.0, 1.0)
    orm_factor: tuple = (1.0, 0.7, 0.0)       # default mid roughness, dielectric
    emissive_factor: tuple = (0.0, 0.0, 0.0)
    alpha_test: bool = False


@dataclasses.dataclass
class MeshPart:
    """Host-side mesh part: one material, triangle soup."""

    positions: np.ndarray       # [V,3]
    normals: np.ndarray         # [V,3]
    uvs: np.ndarray             # [V,2]
    indices: np.ndarray         # [T,3] int32
    material: int               # index into the scene's material list


class Scene(NamedTuple):
    """Device-side scene (pytree of arrays, jit-ready)."""

    positions: jnp.ndarray        # [V,3] f32 world space
    normals: jnp.ndarray          # [V,3] f32
    uvs: jnp.ndarray              # [V,2] f32
    indices: jnp.ndarray          # [T,3] i32
    mat_id: jnp.ndarray           # [T] i32
    # ONE packed material mip-atlas array: channels 0-3 base_color rgba,
    # 4-5 normal xy, 6-8 orm, 9-11 emissive.  Packing all maps into one
    # texture means a single gather row fetches every material channel (4
    # separate atlases would be 4 gathers per pixel in the G-buffer pass).  Stored uint8 (the reference's sources are 8-bit
    # BC/TGA textures, asset_import.cpp) with per-channel dequant scales:
    # 48-byte rows gather ~3x faster than the f32 192-byte rows did.
    tex_packed: jnp.ndarray       # [M,TS,Wa,48] uint8: each texel carries its
                                  # 2x2 bilinear window (build_mip_atlas_window_u8)
    tex_scale: jnp.ndarray        # [12] f32: value = u8/255 * tex_scale[c]
    alpha_test: jnp.ndarray       # [M] bool
    # gather-friendly packing (gathers cost per ROW): all vertex attributes in
    # one row, and (i0,i1,i2,mat) in one row per triangle
    vertex_packed: jnp.ndarray    # [V,8] f32: pos xyz, normal xyz, uv
    tri_meta: jnp.ndarray         # [T,4] i32: i0, i1, i2, mat_id
    # triangle-major attribute row: ONE 96-byte gather fetches all three
    # vertices' attributes (vs tri_meta + 3x vertex_packed = 4 rows/pixel in
    # round 1 — sharing verts across tris is not worth 4x the gather rows)
    tri_attr: jnp.ndarray         # [T,24] f32: pos0..2 (9), nrm0..2 (9), uv0..2 (6)
    tri_alpha: jnp.ndarray        # [T] f32: 1.0 where the material alpha-tests

    @property
    def num_tris(self) -> int:
        return self.indices.shape[0]


def _resize_bilinear_np(img, size):
    """Host-side bilinear resize to (size,size)."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img.astype(np.float32)
    ys = (np.arange(size) + 0.5) * h / size - 0.5
    xs = (np.arange(size) + 0.5) * w / size - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def _prep_tex(tex, factor, size, channels, fill):
    """Resize/constant-fill one material texture to [size,size,channels]."""
    if tex is None:
        base = np.broadcast_to(np.asarray(fill, np.float32), (size, size, channels)).copy()
    else:
        t = np.asarray(tex, np.float32)
        if t.ndim == 2:
            t = t[..., None]
        if t.shape[-1] < channels:  # pad missing channels (e.g. rgb->rgba alpha=1)
            pad = np.ones(t.shape[:-1] + (channels - t.shape[-1],), np.float32)
            if channels == 4 and t.shape[-1] == 3:
                pass  # alpha defaults to 1
            t = np.concatenate([t, pad], -1)
        t = t[..., :channels]
        base = _resize_bilinear_np(t, size)
    f = np.asarray(factor, np.float32)[:channels]
    return base * f


def build_scene(
    parts: Sequence[MeshPart],
    materials: Sequence[MaterialDesc],
    texture_size: int = 256,
    dtype=jnp.float32,
) -> Scene:
    """Merge parts into one triangle soup + build material texture atlases.

    Mirrors the by-material grouping of asset_import.cpp:92-170 but flattens
    to per-triangle material ids instead of per-part draws.
    """
    assert texture_size & (texture_size - 1) == 0, "texture_size must be pow2"
    all_pos, all_nrm, all_uv, all_idx, all_mat = [], [], [], [], []
    v_off = 0
    for part in parts:
        t = part.indices.shape[0]
        all_pos.append(np.asarray(part.positions, np.float32))
        all_nrm.append(np.asarray(part.normals, np.float32))
        all_uv.append(np.asarray(part.uvs, np.float32))
        all_idx.append(np.asarray(part.indices, np.int64) + v_off)
        all_mat.append(np.full((t,), part.material, np.int32))
        v_off += part.positions.shape[0]

    pos = np.concatenate(all_pos)
    nrm = np.concatenate(all_nrm)
    uv = np.concatenate(all_uv)
    idx = np.concatenate(all_idx).astype(np.int32)
    mat = np.concatenate(all_mat)

    ts = texture_size
    bc, nm, orm, em, at = [], [], [], [], []
    for m in materials:
        bc.append(_prep_tex(m.base_color, m.base_color_factor, ts, 4, (1, 1, 1, 1)))
        nm.append(_prep_tex(m.normal, (1, 1), ts, 2, (0.5, 0.5)))
        orm.append(_prep_tex(m.orm, (1, 1, 1), ts, 3, m.orm_factor))
        em.append(_prep_tex(m.emissive, (1, 1, 1), ts, 3, m.emissive_factor))
        at.append(m.alpha_test)

    packed = np.concatenate(
        [np.stack(bc), np.stack(nm), np.stack(orm), np.stack(em)], axis=-1
    )
    # per-channel dequant scale = max over all materials (min 1 so unit-range
    # channels keep exact 1/255 steps; emissive factors > 1 stay representable)
    tex_scale = np.maximum(packed.reshape(-1, 12).max(axis=0), 1.0).astype(np.float32)
    arr = jnp.asarray(packed, jnp.float32)

    # one jit around the whole atlas build: eagerly it is hundreds of tiny
    # ops, each compiling its own executable
    import jax as _jax

    @_jax.jit
    def _build_atlases(a, scale):
        return jnp.stack(
            [sampling.build_mip_atlas_window_u8(a[i], scale)
             for i in range(a.shape[0])]
        )

    tex_packed = _build_atlases(arr, jnp.asarray(tex_scale))

    vertex_packed = np.concatenate([pos, nrm, uv], axis=1).astype(np.float32)
    tri_meta = np.concatenate([idx, mat[:, None]], axis=1).astype(np.int32)
    tri_attr = np.concatenate(
        [pos[idx].reshape(-1, 9), nrm[idx].reshape(-1, 9), uv[idx].reshape(-1, 6)],
        axis=1,
    ).astype(np.float32)
    at_arr = np.asarray(at, bool)
    tri_alpha = at_arr[mat].astype(np.float32)

    return Scene(
        positions=jnp.asarray(pos),
        normals=jnp.asarray(nrm),
        uvs=jnp.asarray(uv),
        indices=jnp.asarray(idx),
        mat_id=jnp.asarray(mat),
        tex_packed=tex_packed,
        tex_scale=jnp.asarray(tex_scale),
        alpha_test=jnp.asarray(np.asarray(at, bool)),
        vertex_packed=jnp.asarray(vertex_packed),
        tri_meta=jnp.asarray(tri_meta),
        tri_attr=jnp.asarray(tri_attr),
        tri_alpha=jnp.asarray(tri_alpha),
    )
