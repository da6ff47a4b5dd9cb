"""Ray-triangle intersection over SoA batches: every ray against every triangle.

JAX replacement for the Fallback Layer's compute-shader intersection (the
closed-source heart of the reference, /root/reference/README.md:23-29) and
the per-ray ``TraceRay`` HLSL intrinsic, for scenes too small to need a BVH
(accel/traverse.py walks the larger ones) and as the brute-force oracle.

Formulation
-----------
Möller–Trumbore re-written with scalar triple products (Plücker form) so the
[R rays] x [T triangles] test is a chain of 3-term dot products against
per-triangle precomputes instead of per-pair cross products:

    det   = -(D . pn)              pn = e1 x e2
    u*det =  (OxD) . e2 + D . c1   c1 = v0 x e2
    v*det = -(OxD) . e1 - D . c2   c2 = v0 x e1
    t*det =   O . pn - d0          d0 = v0 . pn

pn/c1/c2/d0 are precomputed per triangle at scene build
(scene/scene.py). Validity is decided with sign-multiplied comparisons (no
per-pair divide); the winning triangle's exact (t, u, v) is recomputed per
ray after the argmin. Padding triangles are all-zero => det == 0 => miss.
The BVH walk (accel/traverse.py) tests its leaves with the same terms and
predicate, so both routes agree on every hit/miss decision, including rays
through an edge two triangles share.

Two entry points mirror the two DXR ray types:
  * ``intersect_closest``  — closest-hit (TraceRay with a closest-hit shader)
  * ``intersect_any``      — boolean occlusion (RAY_FLAG_ACCEPT_FIRST_HIT_AND
    _END_SEARCH | SKIP_CLOSEST_HIT, RaytracingCommon.hlsli:94)

Both scan over triangle chunks with a running best-hit state, which bounds
the [R, chunk] intermediate.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core import vecmath as vm

RAY_MAX_T = 1.0e38  # RaytracingCommon.hlsli:8
RAY_EPSILON = 1.0e-4  # RaytracingCommon.hlsli:9

DEFAULT_CHUNK = 512


def _dot3(a, b):
    """Dot product over the last axis of size 3, broadcasting the others,
    written out so every route (brute force here, the BVH walk in
    accel/traverse.py) rounds it the same way and full f32 products are
    kept (no reduced-precision matrix unit)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def pair_terms(origins, directions, moments, tri):
    """Raw intersection terms of rays against triangles whose Plücker
    precomputes (``tri``: pn, c1, c2, e1, e2 [..., 3], d0 [...]) broadcast
    against the rays' [..., 3] origin, direction and moment o x d."""
    det = -_dot3(directions, tri["pn"])
    u_d = _dot3(moments, tri["e2"]) + _dot3(directions, tri["c1"])
    v_d = -_dot3(moments, tri["e1"]) - _dot3(directions, tri["c2"])
    t_d = _dot3(origins, tri["pn"]) - tri["d0"]
    return det, u_d, v_d, t_d


def valid_mask(det, u_d, v_d, t_d, t_min, t_max, cull_backface: bool):
    """Hit predicate on pair_terms (t_min/t_max broadcast against them)."""
    s = jnp.sign(det)
    det_abs = det * s  # |det|
    eps = 1e-12
    if cull_backface:
        # Front face (CCW winding seen by the ray) has det > 0; culling
        # backfaces = requiring positive det, parity with
        # RAY_FLAG_CULL_BACK_FACING_TRIANGLES on primary rays
        # (ProgressiveRaytracing.hlsl:34).
        alive = det > eps
    else:
        alive = det_abs > eps
    us = u_d * s
    vs = v_d * s
    ts = t_d * s
    return (
        alive
        & (us >= 0.0)
        & (vs >= 0.0)
        & (us + vs <= det_abs)
        & (ts > t_min * det_abs)
        & (ts < t_max * det_abs)
    )


def exact_hit(v0, e1, e2, origins, directions):
    """(t, u, v) of each ray against its own winning triangle by classic
    Möller–Trumbore: the selection t = t_d / det loses digits to
    cancellation on short rays, this recompute does not."""
    p = vm.cross(directions, e2)
    det = vm.dot(e1, p)
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tv = origins - v0
    u = vm.dot(tv, p) * inv
    q = vm.cross(tv, e1)
    v = vm.dot(directions, q) * inv
    return vm.dot(e2, q) * inv, u, v


def _rays_vs_chunk(origins, directions, moments, tri):
    """[R] rays against a [C] chunk of triangles -> [R, C] terms."""
    return pair_terms(
        origins[:, None], directions[:, None], moments[:, None],
        {k: v[None] for k, v in tri.items()},
    )


_TRI_KEYS = ("pn", "c1", "c2", "e1", "e2", "d0")


def _chunked_tris(scene: dict, chunk: int) -> tuple[dict, int]:
    """The Plücker terms zero-padded to a whole number of chunks (padding
    triangles have det == 0 and never hit). Returns (arrays, chunk)."""
    t = scene["v0"].shape[0]
    chunk = max(min(chunk, t), 1)
    pad = -t % chunk
    tris = {
        k: jnp.pad(scene[k], [(0, pad)] + [(0, 0)] * (scene[k].ndim - 1))
        for k in _TRI_KEYS
    }
    return tris, chunk


def _slice_tris(tris: dict, start: int, size: int) -> dict:
    return {
        k: jax.lax.dynamic_slice_in_dim(v, start, size, axis=0)
        for k, v in tris.items()
    }


@functools.partial(
    jax.jit, static_argnames=("cull_backface", "chunk")
)
def intersect_closest(
    scene: dict,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    t_min: jnp.ndarray | float = RAY_EPSILON,
    t_max: jnp.ndarray | float = RAY_MAX_T,
    cull_backface: bool = False,
    chunk: int = DEFAULT_CHUNK,
) -> dict:
    """Closest hit for rays [R,3]x[R,3] against every scene triangle.

    Returns {"hit" [R] bool, "t" [R], "tri" [R] int32, "u","v" [R]}.
    """
    R = origins.shape[0]
    if scene["v0"].shape[0] == 0:
        return {
            "hit": jnp.zeros((R,), bool),
            "t": jnp.full((R,), -1.0, jnp.float32),
            "tri": jnp.full((R,), -1, jnp.int32),
            "u": jnp.zeros((R,), jnp.float32),
            "v": jnp.zeros((R,), jnp.float32),
        }
    tris, chunk = _chunked_tris(scene, chunk)
    T = tris["d0"].shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (R,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))
    moments = vm.cross(origins, directions)

    def body(carry, start):
        best_t, best_tri = carry
        tri = _slice_tris(tris, start, chunk)
        det, u_d, v_d, t_d = _rays_vs_chunk(origins, directions, moments, tri)
        valid = valid_mask(det, u_d, v_d, t_d, t_min[:, None], t_max[:, None],
                           cull_backface)
        # Approximate t for selection only; exact recompute after argmin.
        t_pair = t_d / jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
        t_pair = jnp.where(valid, t_pair, jnp.float32(jnp.inf))
        c_best = jnp.min(t_pair, axis=1)
        c_idx = jnp.argmin(t_pair, axis=1).astype(jnp.int32) + start
        better = c_best < best_t
        return (
            (jnp.where(better, c_best, best_t), jnp.where(better, c_idx, best_tri)),
            None,
        )

    init = (jnp.full((R,), jnp.inf, jnp.float32), jnp.zeros((R,), jnp.int32))
    starts = jnp.arange(0, T, chunk, dtype=jnp.int32)
    (best_t, best_tri), _ = jax.lax.scan(body, init, starts)

    hit = jnp.isfinite(best_t)
    tri_safe = jnp.where(hit, best_tri, 0)
    t, u, v = exact_hit(scene["v0"][tri_safe], scene["e1"][tri_safe],
                        scene["e2"][tri_safe], origins, directions)
    return {
        "hit": hit,
        "t": jnp.where(hit, t, -1.0),
        "tri": jnp.where(hit, best_tri, -1),
        "u": jnp.where(hit, u, 0.0),
        "v": jnp.where(hit, v, 0.0),
    }


@functools.partial(jax.jit, static_argnames=("chunk",))
def intersect_any(
    scene: dict,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    t_min: jnp.ndarray | float = RAY_EPSILON,
    t_max: jnp.ndarray | float = RAY_MAX_T,
    chunk: int = DEFAULT_CHUNK,
) -> jnp.ndarray:
    """Occlusion query: True where ANY triangle blocks the segment.

    The analogue of the shadow ray type
    (shootShadowRay, RaytracingCommon.hlsli:84-96): no closest-hit resolution,
    no backface culling.
    """
    R = origins.shape[0]
    tris, chunk = _chunked_tris(scene, chunk)
    T = tris["d0"].shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (R,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))
    moments = vm.cross(origins, directions)

    def body(occluded, start):
        tri = _slice_tris(tris, start, chunk)
        det, u_d, v_d, t_d = _rays_vs_chunk(origins, directions, moments, tri)
        valid = valid_mask(det, u_d, v_d, t_d, t_min[:, None], t_max[:, None],
                           cull_backface=False)
        return occluded | jnp.any(valid, axis=1), None

    starts = jnp.arange(0, T, chunk, dtype=jnp.int32)
    occluded, _ = jax.lax.scan(body, jnp.zeros((R,), bool), starts)
    return occluded
