"""BVH traversal in plain ``lax``: one stack per ray, a fixed stack depth.

The device route for BVH scenes, single- and two-level (the reference's
``TraceRay`` over a BLAS/TLAS, /root/reference/assets/shaders/
RaytracingCommon.hlsli:84-96). Every ray of a batch walks the tree inside
one ``lax.while_loop``. Each iteration pops one stack entry per ray and
either tests the two child boxes of an interior node, pushing the children
it hits far-first so the nearer one is popped next, or tests the triangles
of a leaf and keeps the nearest hit. An entry whose box is entered beyond
the best hit so far is dropped unvisited. Any-hit rays stop at their first
hit. The loop ends when every stack is empty.

Layout (``pack_bvh``; two-level scenes add a TLAS in ``accel/tlas.py``):

  nodes [N, 12] f32  child boxes of each interior node: lo0, hi0, lo1, hi1
  child [N, 2]  i32  child codes: >= 0 interior node, < 0 leaf -(leaf+1),
                     EMPTY for a missing child
  tris  [L, K, 16] f32  each leaf's K triangles in slot order, as the
                     Plücker precomputes of ops/intersect.py (pn, c1, c2, e1,
                     e2, d0); empty slots are all-zero and never hit
  tri   [L*K] i32    scene triangle index of each leaf slot (-1 empty)
  v0    [L*K, 3] f32  first vertex of each slot's triangle, for the exact
                     (t, u, v) of the winning hit (ops.intersect.exact_hit)

Two-level walks put the TLAS nodes first. A TLAS child that is an instance
carries that instance's id, and every stack entry remembers the instance
whose object space its node lives in, so boxes and triangles below it are
tested against the ray mapped by that instance's inverse transform. The map
is affine, so object-space t equals world-space t and hits from different
instances compare directly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import vecmath as vm
from ..ops.intersect import exact_hit, pair_terms, valid_mask

STACK_DEPTH = 64  # entries per ray; pack_bvh rejects deeper trees
EMPTY = -(2**31 - 1)  # child code of a missing child
_BIG = np.float32(3.0e38)


# --------------------------------------------------------------------------- #
# Layout
# --------------------------------------------------------------------------- #
def _leaf_depth(child: np.ndarray) -> int:
    """Deepest leaf of explicit binary node arrays (root depth 0)."""
    depth = np.zeros(len(child), np.int64)
    best = 0
    for n in range(len(child)):  # children follow their parent in DFS order
        if child[n, 0] < 0:
            best = max(best, int(depth[n]))
        else:
            depth[child[n]] = depth[n] + 1
    return best


def pack_bvh(nodes: dict, v0, e1, e2, leaf_size: int) -> tuple[dict, int]:
    """Binary node arrays (``accel.bvh`` format) -> the walk's layout.

    Returns (numpy arrays {nodes, child, tris, tri}, stack entries a walk
    over this tree needs). Raises ValueError for a leaf wider than
    ``leaf_size`` or a tree deeper than the fixed stack."""
    lo = np.asarray(nodes["nodes_lo"], np.float32)
    hi = np.asarray(nodes["nodes_hi"], np.float32)
    child = np.asarray(nodes["child"], np.int64)
    order = np.asarray(nodes["order"], np.int64)
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    k = leaf_size

    is_leaf = child[:, 0] < 0
    leaf_ids = np.nonzero(is_leaf)[0]
    counts = child[leaf_ids, 1]
    if len(counts) and counts.max() > k:
        raise ValueError(f"leaf holds {counts.max()} triangles > leaf_size {k}")
    leaf_of = np.full(len(child), -1, np.int64)
    leaf_of[leaf_ids] = np.arange(len(leaf_ids))

    # Leaf slots: K per leaf, empty slots -1.
    starts = -child[leaf_ids, 0] - 1
    lane = np.arange(k)[None, :]
    src = np.clip(starts[:, None] + lane, 0, max(len(order) - 1, 0))
    tri = np.where(lane < counts[:, None], order[src], -1).reshape(-1)
    ok = tri >= 0
    sv0, se1, se2 = v0[tri[ok]], e1[tri[ok]], e2[tri[ok]]
    pn = np.cross(se1, se2)  # the same float32 products as Scene.build
    tris = np.zeros((len(tri), 16), np.float32)
    slot_v0 = np.zeros((len(tri), 3), np.float32)
    slot_v0[ok] = sv0
    tris[ok, 0:3] = pn
    tris[ok, 3:6] = np.cross(sv0, se2)
    tris[ok, 6:9] = np.cross(sv0, se1)
    tris[ok, 9:12] = se1
    tris[ok, 12:15] = se2
    tris[ok, 15] = np.sum(sv0 * pn, axis=-1)

    if is_leaf[0]:
        # Single-leaf tree: one node whose second child is missing.
        boxes = np.full((1, 12), _BIG, np.float32)
        boxes[0, 0:3], boxes[0, 3:6] = lo[0], hi[0]
        codes = np.array([[-1, EMPTY]], np.int64)
    else:
        internal = np.nonzero(~is_leaf)[0]
        fat_of = np.full(len(child), -1, np.int64)
        fat_of[internal] = np.arange(len(internal))
        c = child[internal]  # [N, 2] binary ids
        codes = np.where(is_leaf[c], -(leaf_of[c] + 1), fat_of[c])
        boxes = np.concatenate(
            [lo[c[:, 0]], hi[c[:, 0]], lo[c[:, 1]], hi[c[:, 1]]], axis=1
        )
    need = _leaf_depth(child) + 1
    if need > STACK_DEPTH:
        raise ValueError(
            f"BVH needs {need} stack entries; the walk has {STACK_DEPTH}"
        )
    return {
        "nodes": boxes.astype(np.float32),
        "child": codes.astype(np.int32),
        "tris": tris.reshape(-1, k, 16),
        "tri": tri.astype(np.int32),
        "v0": slot_v0,
    }, need


# --------------------------------------------------------------------------- #
# Walk
# --------------------------------------------------------------------------- #
def _safe_inv(d):
    return 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)


def _take(a, idx):
    """a[r, idx[r]] for a [R, C, ...] array."""
    return jnp.take_along_axis(
        a, idx.reshape(idx.shape + (1,) * (a.ndim - 1)), axis=1
    )[:, 0]


def _object_ray(x, origins, directions):
    """Rays mapped by per-ray inverse transform rows x [R, 12] (A row-major,
    then b): o' = A o + b, d' = A d."""
    a = x[:, 0:9].reshape(-1, 3, 3)
    return (jnp.sum(a * origins[:, None, :], axis=-1) + x[:, 9:12],
            jnp.sum(a * directions[:, None, :], axis=-1))


def _leaf_test(tris, o, d, m, t_lo, t_hi, cull: bool):
    """R rays against their leaf's K triangles with the brute-force
    intersector's terms, predicate and selection distance
    (ops/intersect.py), so both routes make the same hit/miss decisions.
    Returns (t, ok) [R, K]."""
    tri = {
        "pn": tris[..., 0:3], "c1": tris[..., 3:6], "c2": tris[..., 6:9],
        "e1": tris[..., 9:12], "e2": tris[..., 12:15], "d0": tris[..., 15],
    }
    det, u_d, v_d, t_d = pair_terms(o[:, None], d[:, None], m[:, None], tri)
    ok = valid_mask(det, u_d, v_d, t_d, t_lo[:, None], t_hi[:, None], cull)
    return t_d / jnp.where(ok, det, 1.0), ok


def _walk(nodes, child, tris, origins, directions, t_min, t_max, *,
          any_hit: bool, cull: bool, xf=None, child_inst=None):
    """The lockstep stack walk. xf [I+1, 12] (inverse transform rows, the
    last one identity) and child_inst [N, 2] (-1 = same instance as the
    parent) make it two-level; the root lives in instance I (world space)."""
    r = origins.shape[0]
    k = tris.shape[1]
    two = xf is not None
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (r,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))
    rows = jnp.arange(r)
    # Stack entries: (node code, entry distance bits[, instance]). Rays with
    # an empty interval or no direction start with an empty stack.
    live0 = (t_max >= t_min) & jnp.any(directions != 0.0, axis=-1)
    width = 3 if two else 2
    stack = jnp.zeros((r, STACK_DEPTH, width), jnp.int32)
    stack = stack.at[:, 0, 1].set(jax.lax.bitcast_convert_type(t_min, jnp.int32))
    if two:
        stack = stack.at[:, 0, 2].set(xf.shape[0] - 1)
    inv_world = _safe_inv(directions)
    m_world = vm.cross(origins, directions)

    def cond(state):
        return jnp.any(state[0] > 0)

    def body(state):
        sp, stack, best_t, best_slot, best_inst = state
        alive = sp > 0
        top = _take(stack, jnp.maximum(sp - 1, 0))  # [R, width]
        sp = sp - alive.astype(jnp.int32)
        code = top[:, 0]
        t_entry = jax.lax.bitcast_convert_type(top[:, 1], jnp.float32)
        live = alive & (t_entry <= best_t)
        if two:
            inst = top[:, 2]
            o, d = _object_ray(xf[inst], origins, directions)
            inv_d = _safe_inv(d)
            m = vm.cross(o, d)
        else:
            o, d, inv_d, m = origins, directions, inv_world, m_world
        is_leaf = code < 0

        # Interior: test both child boxes, push the hits far-first.
        ni = jnp.where(live & ~is_leaf, code, 0)
        box = nodes[ni].reshape(r, 2, 2, 3)
        t0 = (box[:, :, 0] - o[:, None]) * inv_d[:, None]
        t1 = (box[:, :, 1] - o[:, None]) * inv_d[:, None]
        tn = jnp.maximum(jnp.max(jnp.minimum(t0, t1), -1), t_min[:, None])
        tf = jnp.minimum(jnp.min(jnp.maximum(t0, t1), -1), best_t[:, None])
        ch = child[ni]
        hit = (tn <= tf) & (ch != EMPTY) & (live & ~is_leaf)[:, None]
        far = (tn[:, 0] <= tn[:, 1]).astype(jnp.int32)  # near = 1 - far
        order = jnp.stack([far, 1 - far], axis=1)  # push far, then near
        push = jnp.take_along_axis(hit, order, 1)
        entry = [
            jnp.take_along_axis(ch, order, 1),
            jax.lax.bitcast_convert_type(
                jnp.take_along_axis(tn, order, 1), jnp.int32
            ),
        ]
        if two:
            ci = jnp.take_along_axis(child_inst[ni], order, 1)
            entry.append(jnp.where(ci >= 0, ci, inst[:, None]))
        p0 = push[:, 0].astype(jnp.int32)
        slot = jnp.stack(
            [jnp.where(push[:, 0], sp, STACK_DEPTH),
             jnp.where(push[:, 1], sp + p0, STACK_DEPTH)], axis=1,
        )
        stack = stack.at[rows[:, None], slot].set(
            jnp.stack(entry, axis=-1), mode="drop"
        )
        sp = sp + p0 + push[:, 1].astype(jnp.int32)

        # Leaf: test its K triangles.
        at_leaf = live & is_leaf
        leaf = jnp.where(at_leaf, -code - 1, 0)
        t, ok = _leaf_test(tris[leaf], o, d, m, t_min, best_t, cull)
        ok = ok & at_leaf[:, None]
        if any_hit:
            found = jnp.any(ok, axis=-1)
            best_slot = jnp.where(found, 0, best_slot)
            sp = jnp.where(found, 0, sp)
        else:
            tk = jnp.where(ok, t, jnp.inf)
            kk = jnp.argmin(tk, axis=-1)
            tb = jnp.min(tk, axis=-1)
            better = tb < best_t
            best_t = jnp.where(better, tb, best_t)
            best_slot = jnp.where(better, leaf * k + kk, best_slot)
            if two:
                best_inst = jnp.where(better, inst, best_inst)
        return sp, stack, best_t, best_slot, best_inst

    init = (
        live0.astype(jnp.int32), stack, t_max,
        jnp.full((r,), -1, jnp.int32), jnp.full((r,), -1, jnp.int32),
    )
    _, _, _, best_slot, best_inst = jax.lax.while_loop(cond, body, init)
    return best_slot, best_inst


def _hit_record(bvh_tri, bvh_v0, tris, best_slot, origins, directions):
    """The closest-hit record {"hit", "t", "tri", "u", "v"} of the winning
    slots, with (t, u, v) recomputed exactly (rays in the slot's space)."""
    hit = best_slot >= 0
    slot = jnp.maximum(best_slot, 0)
    row = tris.reshape(-1, tris.shape[-1])[slot]
    t, u, v = exact_hit(bvh_v0[slot], row[:, 9:12], row[:, 12:15],
                        origins, directions)
    return {
        "hit": hit,
        "t": jnp.where(hit, t, -1.0),
        "tri": jnp.where(hit, bvh_tri[slot], -1),
        "u": jnp.where(hit, u, 0.0),
        "v": jnp.where(hit, v, 0.0),
    }


@functools.partial(jax.jit, static_argnames=("cull_backface",))
def closest(bvh: dict, origins, directions, t_min=1e-4, t_max=1.0e38,
            cull_backface: bool = False) -> dict:
    """Closest hit over a single-level BVH: {"hit", "t", "tri", "u", "v"},
    the same record as ``ops.intersect.intersect_closest``."""
    slot, _ = _walk(bvh["nodes"], bvh["child"], bvh["tris"], origins,
                    directions, t_min, t_max, any_hit=False,
                    cull=cull_backface)
    return _hit_record(bvh["tri"], bvh["v0"], bvh["tris"], slot, origins,
                       directions)


@jax.jit
def any_hit(bvh: dict, origins, directions, t_min=1e-4, t_max=1.0e38):
    """Occlusion over a single-level BVH: True where any triangle lies in
    (t_min, t_max) (no culling, like the shadow ray type)."""
    slot, _ = _walk(bvh["nodes"], bvh["child"], bvh["tris"], origins,
                    directions, t_min, t_max, any_hit=True, cull=False)
    return slot >= 0


def _two_level_arrays(tl: dict):
    nodes = jnp.concatenate([tl["tlas_nodes"], tl["blas_nodes"]], axis=0)
    return nodes, tl["child"], tl["blas_tris"], tl["xf"], tl["child_inst"]


@functools.partial(jax.jit, static_argnames=("cull_backface",))
def two_level_closest(tl: dict, origins, directions, t_min=1e-4,
                      t_max=1.0e38, cull_backface: bool = False) -> dict:
    """Closest hit over a TLAS of instanced BLASes (``accel/tlas.py``):
    the single-level record plus "inst", the hit's instance slot (TLAS
    order); "tri" indexes the concatenated object-space triangles."""
    nodes, child, tris, xf, child_inst = _two_level_arrays(tl)
    slot, inst = _walk(nodes, child, tris, origins, directions, t_min, t_max,
                       any_hit=False, cull=cull_backface, xf=xf,
                       child_inst=child_inst)
    # (t, u, v) in the winning instance's object space
    o_obj, d_obj = _object_ray(xf[jnp.maximum(inst, 0)], origins, directions)
    rec = _hit_record(tl["blas_tri"], tl["blas_v0"], tris, slot, o_obj, d_obj)
    rec["inst"] = jnp.where(rec["hit"], inst, -1)
    return rec


@jax.jit
def two_level_any(tl: dict, origins, directions, t_min=1e-4, t_max=1.0e38):
    nodes, child, tris, xf, child_inst = _two_level_arrays(tl)
    slot, _ = _walk(nodes, child, tris, origins, directions, t_min, t_max,
                    any_hit=True, cull=False, xf=xf, child_inst=child_inst)
    return slot >= 0
