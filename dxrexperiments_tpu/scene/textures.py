"""Albedo textures: per-material images sampled at hit UVs.

BEYOND-reference capability (BASELINE config 2 asks for textured
multi-mesh scenes): the DXR reference's materials are constants
(/root/reference/assets/shaders/RaytracingHlslCompat.h:87-96) and its only
texture units are the environment maps
(/root/reference/src/ProgressiveRaytracingPipeline.cpp:104-125). We reuse
the environment machinery's quad-packed layout (scene/envmap.py
_quad_pack_latlong): every texel row carries its full 2x2 bilinear
footprint with WRAP addressing baked in, so a bilinear albedo sample is
ONE XLA gather per hit.

All materials' textures live in one concatenated row table; a per-material
meta row (base, W, H) turns (mid, uv) into a row index, so scenes mixing
texture sizes still sample with a single gather. Untextured materials get
meta (0, 0, 0) and multiply albedo by 1.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np


def quad_pack_wrap(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] -> [H*W, 12] quad-packed rows (c00,c10,c01,c11) with WRAP
    addressing on both axes (the standard repeat sampler for surface
    textures; the envmap variants wrap U / clamp V instead)."""
    img = np.asarray(img, np.float32)
    right = np.roll(img, -1, axis=1)
    down = np.roll(img, -1, axis=0)
    down_right = np.roll(right, -1, axis=0)
    quad = np.concatenate([img, right, down, down_right], axis=-1)
    return np.ascontiguousarray(quad.reshape(-1, 12), dtype=np.float32)


def pack_texture_table(materials: list) -> dict | None:
    """Pack every material's `albedo_texture` into one device table.

    Returns None when no material is textured (scenes then omit the
    "textures" key entirely). Otherwise:
      rows  [R, 12] float32  — concatenated quad-packed texels
      meta  [M, 3]  int32    — (base_row, width, height); (0,0,0) = none
    """
    metas = np.zeros((max(len(materials), 1), 3), np.int64)
    tables = []
    base = 0
    any_tex = False
    for i, m in enumerate(materials):
        tex = getattr(m, "albedo_texture", None)
        if tex is None:
            continue
        img = np.asarray(tex, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        h, w = img.shape[0], img.shape[1]
        tables.append(quad_pack_wrap(img[..., :3]))
        metas[i] = (base, w, h)
        base += h * w
        any_tex = True
    if not any_tex:
        return None
    return {
        "rows": jnp.asarray(np.concatenate(tables)),
        "meta": jnp.asarray(metas.astype(np.int32)),
    }


def _meta_select(meta: jnp.ndarray, mid: jnp.ndarray) -> jnp.ndarray:
    """Per-row (base, w, h) for [N] material ids WITHOUT a gather.

    XLA charges ~25 ns per gathered ROW regardless of table size, so
    `meta[mid]` costs as much as the full texel gather itself (measured:
    the albedo slice was 47.6% of the config-2 frame, ~2x the texel
    gathers alone). For the handful of materials a scene has, a static
    compare-select chain is pure VPU work and ~free."""
    m = int(meta.shape[0])
    if m > 32:
        return meta[mid]
    out = jnp.zeros(mid.shape + (3,), meta.dtype)
    for i in range(m):
        out = jnp.where((mid == i)[..., None], meta[i], out)
    return out


def sample_albedo(textures: dict, mid: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear albedo multiplier for hits: [N] material ids + [N, 2] UVs
    -> [N, 3] (1.0 for untextured materials). One wide gather per hit."""
    meta = _meta_select(textures["meta"], mid)  # [N, 3]
    base, w, h = meta[..., 0], meta[..., 1], meta[..., 2]
    has = w > 0
    ws = jnp.maximum(w, 1).astype(jnp.float32)
    hs = jnp.maximum(h, 1).astype(jnp.float32)
    x = uv[..., 0] * ws - 0.5
    y = uv[..., 1] * hs - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), jnp.maximum(w, 1))
    y0i = jnp.mod(y0.astype(jnp.int32), jnp.maximum(h, 1))
    row = base + y0i * w + x0i
    q = jnp.take(textures["rows"], jnp.where(has, row, 0), axis=0)
    c00, c10, c01, c11 = (
        q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12]
    )
    tex = (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )
    return jnp.where(has[..., None], tex, 1.0)


def checker_texture(n: int = 8, c0=(1.0, 1.0, 1.0), c1=(0.2, 0.2, 0.2),
                    size: int = 64) -> np.ndarray:
    """n x n checkerboard, `size` px square — procedural demo/test texture."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cell = ((xx * n // size) + (yy * n // size)) % 2
    c0 = np.asarray(c0, np.float32)
    c1 = np.asarray(c1, np.float32)
    return np.where(cell[..., None] == 0, c0, c1).astype(np.float32)


def planar_uvs(mesh, scale: float = 1.0, axes=(0, 2)) -> None:
    """Assign planar per-corner UVs from two position axes (default XZ —
    ground planes). For meshes imported without texture coordinates
    (e.g. the reference's ground.fbx); uv = position[axes] / scale, WRAP
    addressing tiles the texture."""
    tri = mesh.indices
    corners = mesh.positions[tri]  # [F, 3, 3]
    mesh.uv_corners = (
        corners[..., list(axes)] / np.float32(scale)
    ).astype(np.float32)


def load_texture_image(path: str) -> np.ndarray | None:
    """Best-effort image load for MTL map_Kd: Radiance .hdr (native
    decoder), binary PPM (P6), .npy. Returns float32 [H, W, 3] linear, or
    None for unsupported formats (the material keeps its constant albedo)."""
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".hdr":
            from ..utils.image import read_hdr

            return np.asarray(read_hdr(path), np.float32)
        if ext == ".npy":
            return np.asarray(np.load(path), np.float32)[..., :3]
        if ext in (".ppm", ".pnm"):
            with open(path, "rb") as f:
                data = f.read()
            if not data.startswith(b"P6"):
                return None
            fields, pos = [], 2
            while len(fields) < 3:
                while pos < len(data) and data[pos : pos + 1].isspace():
                    pos += 1
                if data[pos : pos + 1] == b"#":
                    pos = data.index(b"\n", pos) + 1
                    continue
                end = pos
                while end < len(data) and not data[end : end + 1].isspace():
                    end += 1
                fields.append(int(data[pos:end]))
                pos = end
            pos += 1  # single whitespace after maxval
            w, h, maxv = fields
            raw = np.frombuffer(data, np.uint8, count=w * h * 3, offset=pos)
            srgb = raw.reshape(h, w, 3).astype(np.float32) / float(maxv)
            return srgb**2.2  # linearize
    except Exception:
        return None
    return None
