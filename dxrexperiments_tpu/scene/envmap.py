"""Environment lighting: constant, procedural gradient, lat-long, cubemap.

JAX replacement for the reference's miss-shader environment sampling
(``sampleEnvironment``, /root/reference/assets/shaders/RaytracingCommon.hlsli:149-159):
a cubemap SampleLevel with a commented-out lat-long alternative
(``wsVectorToLatLong``, RaytracingUtils.hlsli:214-220). Texture units become
bilinear gathers into device arrays.

The environment is a fixed-structure pytree so one jitted render function
serves every env kind: unused slots hold 1x1 dummies and a ``kind`` scalar
selects the contribution (all branches are cheap gathers, so we evaluate and
blend rather than lax.switch).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

ENV_CONSTANT = 0
ENV_GRADIENT = 1
ENV_LATLONG = 2
ENV_CUBEMAP = 3

_DUMMY2D = np.zeros((1, 1, 3), np.float32)
_DUMMY_CUBE = np.zeros((6, 1, 1, 3), np.float32)
_DUMMY_QUAD = np.zeros((1, 12), np.float32)


def _quad_pack_latlong(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] -> [H*W, 12]: each texel carries its 2x2 bilinear
    footprint (c00, c10, c01, c11) with x-wrap and y-clamp baked in, so a
    bilinear sample is ONE gather instead of four, at 4x texture memory,
    bit-exact with the 4-gather formulation."""
    right = np.roll(img, -1, axis=1)  # x+1 with wrap
    down = np.concatenate([img[1:], img[-1:]], axis=0)  # y+1 clamped
    down_right = np.concatenate([right[1:], right[-1:]], axis=0)
    quad = np.concatenate([img, right, down, down_right], axis=-1)
    return np.ascontiguousarray(quad.reshape(-1, 12), dtype=np.float32)


def _quad_pack_cube(faces: np.ndarray) -> np.ndarray:
    """[6, S, S, 3] -> [6*S*S, 12]: per-face 2x2 footprints with x/y both
    CLAMPED inside the face (matches _bilinear_cube's addressing; no
    cross-face filtering, same as the original)."""
    right = np.concatenate([faces[:, :, 1:], faces[:, :, -1:]], axis=2)
    down = np.concatenate([faces[:, 1:], faces[:, -1:]], axis=1)
    down_right = np.concatenate([right[:, 1:], right[:, -1:]], axis=1)
    quad = np.concatenate([faces, right, down, down_right], axis=-1)
    return np.ascontiguousarray(quad.reshape(-1, 12), dtype=np.float32)


def _base(kind: int, strength: float) -> dict:
    return {
        "kind": jnp.asarray(kind, jnp.int32),
        "strength": jnp.asarray(strength, jnp.float32),
        "const_color": jnp.zeros(3, jnp.float32),
        "grad_horizon": jnp.zeros(3, jnp.float32),
        "grad_zenith": jnp.zeros(3, jnp.float32),
        "latlong": jnp.asarray(_DUMMY2D),
        "latlong_quad": jnp.asarray(_DUMMY_QUAD),
        "cube": jnp.asarray(_DUMMY_CUBE),
        "cube_quad": jnp.asarray(_DUMMY_QUAD),
    }


def constant_env(color=(0.0, 0.0, 0.0), strength: float = 1.0) -> dict:
    env = _base(ENV_CONSTANT, strength)
    env["const_color"] = jnp.asarray(np.asarray(color, np.float32))
    return env


def gradient_env(horizon=(0.8, 0.85, 1.0), zenith=(0.2, 0.35, 0.7), strength=1.0) -> dict:
    env = _base(ENV_GRADIENT, strength)
    env["grad_horizon"] = jnp.asarray(np.asarray(horizon, np.float32))
    env["grad_zenith"] = jnp.asarray(np.asarray(zenith, np.float32))
    return env


def latlong_env(image: np.ndarray, strength: float = 1.0) -> dict:
    """Equirectangular [H, W, 3] float image."""
    env = _base(ENV_LATLONG, strength)
    img = np.asarray(image, np.float32)
    env["latlong"] = jnp.asarray(img)
    env["latlong_quad"] = jnp.asarray(_quad_pack_latlong(img))
    return env


def cubemap_env(faces: np.ndarray, strength: float = 1.0) -> dict:
    """[6, S, S, 3] float faces in D3D order +X -X +Y -Y +Z -Z."""
    env = _base(ENV_CUBEMAP, strength)
    f = np.asarray(faces, np.float32)
    env["cube"] = jnp.asarray(f)
    env["cube_quad"] = jnp.asarray(_quad_pack_cube(f))
    return env


# --------------------------------------------------------------------------- #
# Sampling
# --------------------------------------------------------------------------- #
def _bilinear_mix(q: jnp.ndarray, fx: jnp.ndarray, fy: jnp.ndarray):
    c00, c10, c01, c11 = (
        q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12]
    )
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def _bilinear_wrap_u(
    img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray, quad=None
) -> jnp.ndarray:
    """Bilinear sample of [H,W,3] at uv in [0,1]; wrap U, clamp V (the
    reference's WRAP sampler on a lat-long would wrap both; poles clamp).

    With a quad-packed texture ([H*W, 12], see _quad_pack_latlong) the four
    footprint texels come from ONE gather, bit-exact with the 4-gather
    path, which remains for quad-less callers and as the test oracle."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    if quad is not None and quad.shape[0] == h * w:
        q = jnp.take(quad, y0i * w + x0i, axis=0)
        return _bilinear_mix(q, fx, fy)
    x1i = jnp.mod(x0i + 1, w)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    c00 = img[y0i, x0i]
    c10 = img[y0i, x1i]
    c01 = img[y1i, x0i]
    c11 = img[y1i, x1i]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def dir_to_latlong_uv(d: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Parity with wsVectorToLatLong (RaytracingUtils.hlsli:214-220)."""
    inv_pi = 1.0 / jnp.pi
    u = (1.0 + jnp.arctan2(d[..., 0], -d[..., 2]) * inv_pi) * 0.5
    v = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) * inv_pi
    return u, v


def dir_to_cube_face_uv(d: jnp.ndarray):
    """D3D cubemap addressing: returns (face [..], u [..], v [..]) in [0,1]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    # major axis selection
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = jnp.where(
        is_x,
        jnp.where(x >= 0, 0, 1),
        jnp.where(is_y, jnp.where(y >= 0, 2, 3), jnp.where(z >= 0, 4, 5)),
    ).astype(jnp.int32)
    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az))
    ma = jnp.maximum(ma, 1e-12)
    # D3D face (sc, tc) conventions
    sc = jnp.where(
        is_x,
        jnp.where(x >= 0, -z, z),
        jnp.where(is_y, x, jnp.where(z >= 0, x, -x)),
    )
    tc = jnp.where(is_x, -y, jnp.where(is_y, jnp.where(y >= 0, z, -z), -y))
    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5
    return face, u, v


def _bilinear_cube(cube: jnp.ndarray, face, u, v, quad=None) -> jnp.ndarray:
    s = cube.shape[1]
    x = u * s - 0.5
    y = v * s - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, s - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, s - 1)
    if quad is not None and quad.shape[0] == 6 * s * s:
        q = jnp.take(quad, (face * s + y0i) * s + x0i, axis=0)
        return _bilinear_mix(q, fx, fy)
    x1i = jnp.clip(x0i + 1, 0, s - 1)
    y1i = jnp.clip(y0i + 1, 0, s - 1)
    c00 = cube[face, y0i, x0i]
    c10 = cube[face, y0i, x1i]
    c01 = cube[face, y1i, x0i]
    c11 = cube[face, y1i, x1i]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def sample_environment(
    env: dict, directions: jnp.ndarray, static_kind: int | None = None
) -> jnp.ndarray:
    """Radiance for unit directions [..., 3] — the miss "shader".

    Includes the environmentStrength multiplier
    (/root/reference/assets/shaders/RaytracingCommon.hlsli:158).

    ``static_kind`` specializes the compiled code to one env kind (the
    compiled-step factories pass it): with a traced kind every frame pays
    the texture gathers of ALL kinds just to select one.
    """
    kind = env["kind"]

    def compute(k: int):
        if k == ENV_CONSTANT:
            return jnp.broadcast_to(env["const_color"], directions.shape)
        if k == ENV_GRADIENT:
            t = jnp.clip(directions[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
            return env["grad_horizon"] * (1 - t) + env["grad_zenith"] * t
        if k == ENV_LATLONG:
            u, v = dir_to_latlong_uv(directions)
            return _bilinear_wrap_u(
                env["latlong"], u, v, env.get("latlong_quad")
            )
        face, cu, cv = dir_to_cube_face_uv(directions)
        return _bilinear_cube(env["cube"], face, cu, cv, env.get("cube_quad"))

    if static_kind is not None:
        return compute(static_kind) * env["strength"]

    out = jnp.where(
        (kind == ENV_CONSTANT)[..., None],
        compute(ENV_CONSTANT),
        jnp.where(
            (kind == ENV_GRADIENT)[..., None],
            compute(ENV_GRADIENT),
            jnp.where(
                (kind == ENV_LATLONG)[..., None],
                compute(ENV_LATLONG),
                compute(ENV_CUBEMAP),
            ),
        ),
    )
    return out * env["strength"]
