"""Vector math over SoA ``[..., 3]`` arrays.

JAX replacement for the reference's SIMD vector math
(``/root/reference/libs/MiniEngine/Math/Vector.h`` and DirectXMath usage
throughout). Instead of 4-wide SSE vectors, every op is written over batched
``[..., 3]`` jnp arrays so the device vectorizes across rays/pixels, not
across xyz components.

All functions are jit-safe (static shapes, no Python branching on values).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-8


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product of [..., 3] arrays -> [...]."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product of [..., 3] arrays -> [..., 3].

    Written out by components (cheaper than jnp.cross's generalized path).
    """
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a: jnp.ndarray, eps: float = EPS) -> jnp.ndarray:
    """Normalize [..., 3]; zero vectors map to zero (no NaN)."""
    n2 = dot(a, a)
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, eps)), 0.0)
    return a * inv[..., None]


def saturate(x: jnp.ndarray) -> jnp.ndarray:
    """HLSL saturate(): clamp to [0, 1]."""
    return jnp.clip(x, 0.0, 1.0)


def reflect(i: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """HLSL reflect(): i - 2*dot(i,n)*n (i points toward the surface)."""
    return i - 2.0 * dot(i, n)[..., None] * n


def get_perpendicular(u: jnp.ndarray) -> jnp.ndarray:
    """Branchless perpendicular vector.

    Behavior-parity with ``getPerpendicularVector``
    (/root/reference/assets/shaders/RaytracingUtils.hlsli:49-56): pick the
    smallest-magnitude axis and cross with it.
    """
    a = jnp.abs(u)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    xm = ((ax - ay) < 0) & ((ax - az) < 0)
    ym = ((ay - az) < 0) & ~xm
    zm = ~(xm | ym)
    axis = jnp.stack(
        [xm.astype(u.dtype), ym.astype(u.dtype), zm.astype(u.dtype)], axis=-1
    )
    return cross(u, axis)


def orthonormal_basis(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(tangent, bitangent) frame around normal n.

    Matches the frame construction used by the hemisphere samplers
    (/root/reference/assets/shaders/RaytracingUtils.hlsli:62-66):
    bitangent = perpendicular(n), tangent = cross(bitangent, n).
    """
    bitangent = get_perpendicular(n)
    tangent = cross(bitangent, n)
    return tangent, bitangent


def luminance(color: jnp.ndarray) -> jnp.ndarray:
    """Rec.601 luma, parity with calcLuminance
    (/root/reference/assets/shaders/DenoiseCommon.hlsli:29-32)."""
    w = jnp.asarray([0.299, 0.587, 0.114], dtype=color.dtype)
    return jnp.sum(color * w, axis=-1)


def refract(i: jnp.ndarray, n: jnp.ndarray, ior: jnp.ndarray):
    """Refraction with total-internal-reflection flag.

    Behavior-parity with ``refract``
    (/root/reference/assets/shaders/RaytracingUtils.hlsli:141-165).
    Returns (r, ok) where ok=False lanes have r=0.
    """
    neg_ndotv = dot(i, n)
    entering = neg_ndotv <= 0.0
    eta = jnp.where(entering, 1.0 / ior, ior)
    nn = jnp.where(entering[..., None], n, -n)
    ndotv = jnp.where(entering, neg_ndotv, -neg_ndotv)
    k = 1.0 - eta * eta * (1.0 - ndotv * ndotv)
    ok = k >= 0.0
    k_safe = jnp.maximum(k, 0.0)
    r = normalize(i * eta[..., None] - (eta * ndotv + jnp.sqrt(k_safe))[..., None] * nn)
    return jnp.where(ok[..., None], r, jnp.zeros_like(r)), ok


# 3x3 transforms at full f32 precision: a default-precision product may run
# at reduced precision (TF32) on the device, which geometry cannot afford.
_HIGHEST = jax.lax.Precision.HIGHEST


def transform_points(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply a [3,4] or [4,4] affine matrix to points [..., 3]."""
    r = m[:3, :3]
    t = m[:3, 3]
    return jnp.matmul(p, r.T, precision=_HIGHEST) + t


def transform_vectors(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Apply the linear part of a [3,4]/[4,4] matrix to direction vectors."""
    return jnp.matmul(v, m[:3, :3].T, precision=_HIGHEST)


def transform_normals(m: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Transform normals by the inverse-transpose of the linear part."""
    inv = jnp.linalg.inv(m[:3, :3])
    return jnp.matmul(n, inv, precision=_HIGHEST)  # (inv.T).T = inv
