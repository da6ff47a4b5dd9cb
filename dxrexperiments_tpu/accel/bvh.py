"""Acceleration structure: implicit balanced BVH over Morton-sorted triangles.

JAX replacement for the Fallback Layer's BLAS build
(/root/reference/libs/DXRFramework/Helpers/BottomLevelASGenerator.cpp) and its
compute-shader BVH:

  * **Morton sort + median split**: triangles are sorted by the Morton code
    of their centroid, and the tree is the implicit complete binary tree
    over that order — node k's children are 2k+1/2k+2, leaves are K
    consecutive sorted triangles. No child pointers, no variable topology:
    the whole build is a sort plus log2(N) vectorized min/max reductions
    (the LBVH-with-median-splits variant of Karras-style builders), so it
    also runs on the device (`build_bvh_device`).
  * Empty padding leaves get +inf AABBs and degenerate triangles, which
    self-mask in traversal and intersection.

The build runs on the host (NumPy) and on the device (jnp). A C++ SAH
builder for maximum-quality static scenes lives in native/. Both emit the
explicit node arrays that ``accel/traverse.pack_bvh`` lays out for the walk.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd bit (for 30-bit 3D Morton codes)."""
    v = v.astype(np.uint32)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(centroids: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """30-bit Morton code of each centroid within [lo, hi]."""
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip((centroids - lo) / extent, 0.0, 1.0)
    q = np.minimum((q * 1024.0).astype(np.uint32), 1023)
    return (
        (_expand_bits(q[:, 0]) << 2)
        | (_expand_bits(q[:, 1]) << 1)
        | _expand_bits(q[:, 2])
    )


@dataclasses.dataclass
class BVHLayout:
    """Static description of an implicit BVH (shapes only)."""

    levels: int  # leaf level depth; 2**levels leaves
    leaf_size: int  # triangles per leaf

    @property
    def num_leaves(self) -> int:
        return 1 << self.levels

    @property
    def num_nodes(self) -> int:
        return (1 << (self.levels + 1)) - 1

    @property
    def padded_tris(self) -> int:
        return self.num_leaves * self.leaf_size


def choose_layout(num_tris: int, leaf_size: int = 8, max_levels: int = 16) -> BVHLayout:
    levels = 0
    while (1 << levels) * leaf_size < num_tris and levels < max_levels:
        levels += 1
    return BVHLayout(levels=levels, leaf_size=leaf_size)


def build_bvh(
    v0: np.ndarray,
    e1: np.ndarray,
    e2: np.ndarray,
    num_tris: int,
    leaf_size: int = 8,
) -> dict:
    """Build the implicit BVH on host (NumPy). Inputs may include padding
    (degenerate) triangles beyond num_tris; they are ignored.

    Returns {"order" [P] int32 (sorted triangle permutation, padded entries
    = num_tris padding slots), "nodes_lo"/"nodes_hi" [M, 3] f32 (heap
    order), "levels", "leaf_size"}.
    """
    v0 = np.asarray(v0, np.float32)[:num_tris]
    e1 = np.asarray(e1, np.float32)[:num_tris]
    e2 = np.asarray(e2, np.float32)[:num_tris]
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    centroid = (tri_lo + tri_hi) * 0.5

    layout = choose_layout(max(num_tris, 1), leaf_size)
    P = layout.padded_tris

    if num_tris > 0:
        codes = morton_codes(centroid, tri_lo.min(0), tri_hi.max(0))
        order = np.argsort(codes, kind="stable").astype(np.int32)
    else:
        order = np.zeros((0,), np.int32)

    # Pad the permutation with -1 (empty slots).
    order_p = np.full((P,), -1, np.int32)
    order_p[:num_tris] = order

    # Leaf AABBs: per leaf, min/max over its K sorted triangles.
    INF = np.float32(np.inf)
    slot_lo = np.full((P, 3), INF, np.float32)
    slot_hi = np.full((P, 3), -INF, np.float32)
    slot_lo[:num_tris] = tri_lo[order]
    slot_hi[:num_tris] = tri_hi[order]
    leaf_lo = slot_lo.reshape(layout.num_leaves, leaf_size, 3).min(1)
    leaf_hi = slot_hi.reshape(layout.num_leaves, leaf_size, 3).max(1)

    # Bottom-up heap fit.
    nodes_lo = np.full((layout.num_nodes, 3), INF, np.float32)
    nodes_hi = np.full((layout.num_nodes, 3), -INF, np.float32)
    first_leaf = layout.num_leaves - 1
    nodes_lo[first_leaf:] = leaf_lo
    nodes_hi[first_leaf:] = leaf_hi
    for level in range(layout.levels - 1, -1, -1):
        start = (1 << level) - 1
        end = (1 << (level + 1)) - 1
        child = 2 * np.arange(start, end) + 1
        nodes_lo[start:end] = np.minimum(nodes_lo[child], nodes_lo[child + 1])
        nodes_hi[start:end] = np.maximum(nodes_hi[child], nodes_hi[child + 1])

    return {
        "order": order_p,
        "nodes_lo": nodes_lo,
        "nodes_hi": nodes_hi,
        "levels": layout.levels,
        "leaf_size": leaf_size,
    }


# --------------------------------------------------------------------------- #
# Device-side build (for dynamic geometry; same structure, jnp ops)
# --------------------------------------------------------------------------- #
@functools.partial(jax.jit, static_argnames=("num_tris", "leaf_size"))
def build_bvh_device(v0, e1, e2, num_tris: int, leaf_size: int = 8) -> dict:
    """jnp build of the same structure — a sort + log2(N) reshaped min/max
    reductions, all fusable; suitable for per-frame rebuilds of deforming
    geometry (the analogue of D3D12 BLAS refit/rebuild)."""
    v0 = v0[:num_tris]
    e1 = e1[:num_tris]
    e2 = e2[:num_tris]
    p1, p2 = v0 + e1, v0 + e2
    tri_lo = jnp.minimum(jnp.minimum(v0, p1), p2)
    tri_hi = jnp.maximum(jnp.maximum(v0, p1), p2)
    centroid = (tri_lo + tri_hi) * 0.5

    layout = choose_layout(max(num_tris, 1), leaf_size)
    P = layout.padded_tris

    lo = jnp.min(tri_lo, axis=0)
    extent = jnp.maximum(jnp.max(tri_hi, axis=0) - lo, 1e-12)
    q = jnp.clip((centroid - lo) / extent, 0.0, 1.0)
    q = jnp.minimum((q * 1024.0).astype(jnp.uint32), 1023)

    def expand(v):
        v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
        v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
        v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
        v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
        return v

    codes = (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])
    order = jnp.argsort(codes).astype(jnp.int32)

    inf = jnp.float32(jnp.inf)
    slot_lo = jnp.full((P, 3), inf)
    slot_hi = jnp.full((P, 3), -inf)
    slot_lo = slot_lo.at[: num_tris].set(tri_lo[order])
    slot_hi = slot_hi.at[: num_tris].set(tri_hi[order])
    order_p = jnp.full((P,), -1, jnp.int32).at[:num_tris].set(order)

    levels_lo = [slot_lo.reshape(layout.num_leaves, leaf_size, 3).min(1)]
    levels_hi = [slot_hi.reshape(layout.num_leaves, leaf_size, 3).max(1)]
    for _ in range(layout.levels):
        levels_lo.append(
            jnp.minimum(levels_lo[-1][0::2], levels_lo[-1][1::2])
        )
        levels_hi.append(
            jnp.maximum(levels_hi[-1][0::2], levels_hi[-1][1::2])
        )
    # heap order: root level last in the lists
    nodes_lo = jnp.concatenate(list(reversed(levels_lo)), axis=0)
    nodes_hi = jnp.concatenate(list(reversed(levels_hi)), axis=0)

    return {
        "order": order_p,
        "nodes_lo": nodes_lo,
        "nodes_hi": nodes_hi,
        "levels": layout.levels,
        "leaf_size": leaf_size,
    }


# --------------------------------------------------------------------------- #
# Explicit node-array format — the interchange both builders emit and
# accel/traverse.pack_bvh consumes:
#   nodes_lo/hi [M, 3] f32; child [M, 2] i32
#     internal: child[m] = {left, right}
#     leaf:     child[m] = {-(start+1), count}   (range into `order`)
#   order [T] i32 (contiguous leaf runs)
# --------------------------------------------------------------------------- #
def to_node_arrays(bvh: dict) -> dict:
    """Convert the implicit heap BVH to explicit node arrays (leaves become
    ranges of `leaf_size` slots; empty padding slots are dropped per leaf)."""
    levels, leaf_size = bvh["levels"], bvh["leaf_size"]
    num_leaves = 1 << levels
    num_nodes = 2 * num_leaves - 1
    first_leaf = num_leaves - 1
    order = bvh["order"]
    child = np.zeros((num_nodes, 2), np.int32)
    internal = np.arange(first_leaf)
    child[internal, 0] = 2 * internal + 1
    child[internal, 1] = 2 * internal + 2
    leaf_ids = np.arange(num_leaves)
    starts = leaf_ids * leaf_size
    counts = np.minimum(
        np.maximum((order >= 0).sum() - starts, 0), leaf_size
    ).astype(np.int32)
    child[first_leaf:, 0] = -(starts + 1)
    child[first_leaf:, 1] = counts
    return {
        "nodes_lo": np.asarray(bvh["nodes_lo"], np.float32),
        "nodes_hi": np.asarray(bvh["nodes_hi"], np.float32),
        "child": child,
        "order": np.asarray(order, np.int32),
    }


def build_bvh_sah(
    v0: np.ndarray,
    e1: np.ndarray,
    e2: np.ndarray,
    num_tris: int,
    leaf_size: int = 8,
    spatial: bool = False,
) -> dict | None:
    """Maximum-quality binned-SAH build via the native C++ builder
    (native/sah_bvh.cpp), optionally with SBVH spatial splits (straddling
    triangles clipped + referenced by several leaves — len(order) may exceed
    num_tris; every consumer resolves slots through `order`). Returns
    explicit node arrays, or None when the native toolchain is unavailable
    (callers fall back to the Morton build). Spatial splits are off by
    default: their SAH-cost gains on this framework's scene classes are
    small (susanne -8%, random soup -1.2% in SAH cost)."""
    from ..utils import native

    res = native.build_sah_native(
        np.asarray(v0, np.float32)[:num_tris],
        np.asarray(e1, np.float32)[:num_tris],
        np.asarray(e2, np.float32)[:num_tris],
        leaf_size,
        spatial=spatial,
    )
    if res is None:
        return None
    nodes_lo, nodes_hi, child, order = res
    return {
        "nodes_lo": nodes_lo,
        "nodes_hi": nodes_hi,
        "child": child,
        "order": order,
    }


def traverse_nodes_numpy(nodes: dict, tri_test, o, d, t_min, t_max) -> tuple:
    """Scalar host traversal of explicit node arrays (correctness oracle)."""
    inv_d = 1.0 / np.where(np.abs(d) > 1e-12, d, 1e-12)
    best = (np.inf, -1)
    if len(nodes["child"]) == 0:
        return best
    stack = [0]
    while stack:
        node = stack.pop()
        if not ray_aabb(
            o,
            inv_d,
            nodes["nodes_lo"][node],
            nodes["nodes_hi"][node],
            t_min,
            min(t_max, best[0]),
        ):
            continue
        left, right = nodes["child"][node]
        if left < 0:  # leaf
            start, count = -left - 1, right
            for s in range(start, start + count):
                tri = nodes["order"][s]
                if tri < 0:
                    continue
                t = tri_test(int(tri), o, d)
                if t is not None and t_min < t < min(t_max, best[0]):
                    best = (t, int(tri))
        else:
            stack.append(int(left))
            stack.append(int(right))
    return best


# --------------------------------------------------------------------------- #
# Reference traversal (NumPy; correctness oracle for the walk)
# --------------------------------------------------------------------------- #
def ray_aabb(o, inv_d, lo, hi, t_min, t_max):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = np.minimum(t0, t1).max()
    tf = np.maximum(t0, t1).min()
    return max(tn, t_min) <= min(tf, t_max)


def traverse_numpy(bvh: dict, tri_test, o, d, t_min, t_max) -> tuple:
    """Scalar host traversal: returns (t, tri_index) or (inf, -1).
    tri_test(global_tri_idx, o, d) -> t or None."""
    inv_d = 1.0 / np.where(np.abs(d) > 1e-12, d, 1e-12)
    levels = bvh["levels"]
    leaf_size = bvh["leaf_size"]
    first_leaf = (1 << levels) - 1
    best = (np.inf, -1)
    stack = [0]
    while stack:
        node = stack.pop()
        if not ray_aabb(
            o, inv_d, bvh["nodes_lo"][node], bvh["nodes_hi"][node], t_min, min(t_max, best[0])
        ):
            continue
        if node >= first_leaf:
            leaf = node - first_leaf
            for s in range(leaf * leaf_size, (leaf + 1) * leaf_size):
                tri = bvh["order"][s]
                if tri < 0:
                    continue
                t = tri_test(int(tri), o, d)
                if t is not None and t_min < t < min(t_max, best[0]):
                    best = (t, int(tri))
        else:
            stack.append(2 * node + 1)
            stack.append(2 * node + 2)
    return best
