"""Two-level acceleration structure: TLAS over instances, shared per-mesh BLAS.

JAX re-expression of the reference's TLAS/BLAS split
(/root/reference/Helpers/TopLevelASGenerator.cpp:64-83,309+,
/root/reference/libs/DXRFramework/RtScene.cpp:27-51): each unique mesh gets
ONE object-space BLAS (built once), the TLAS is a small BVH over instance
world AABBs, and every instance stores its inverse transform. The walk
(``accel/traverse.py``) maps the ray into an instance's object space when it
enters that instance and runs the BLAS below it there. Because the map is
affine, the object-space ray parameter t equals the world-space one, so hits
from different instances compare directly.

Animation = TLAS REFIT (`refit_instances_arrays`): the analogue of the D3D12
PERFORM_UPDATE acceleration-structure flag. Topology (the Morton order of
instances at build time) is frozen; per frame we recompute instance world
AABBs + inverse/normal matrices and reduce the implicit-heap node boxes
bottom-up — O(instances) device work, no triangle re-baking, no BVH rebuild.

Device pytree (``build_two_level``):
  blas_nodes [Nb, 12], blas_tris [L, K, 16], blas_tri [L*K],
    blas_v0 [L*K, 3]: every unique mesh's BLAS in the walk's layout,
    concatenated (static).
  child, child_inst [Nt+Nb, 2]: child codes of the combined node array, TLAS
    nodes first; an instance child of a TLAS node names the instance slot
    (static, frozen topology).
  tlas_nodes [Nt, 12]: TLAS child boxes in world space (refit).
  xf [I+1, 12]: per instance slot the inverse transform rows A (row-major)
    and b, x_obj = A x_world + b; the last row is the identity (refit).
  inst_nm [I, 3, 3], inst_mat_override [I], inst_orig [I]: normal matrix,
    material override and original instance index per slot (refit).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .traverse import EMPTY, STACK_DEPTH, pack_bvh

BIG = 3.0e38


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True, eq=False)
class HostStatic:
    """Host-side static payload carried inside a scene pytree.

    Registered as a STATIC pytree node (no array leaves), so scene dicts
    containing it pass through jit boundaries — the payload is baked into
    the traced computation like a static_argname, hashed by identity."""

    value: object


def _build_mesh_blas(v0, e1, e2, leaf_size: int) -> dict:
    """Object-space BLAS node arrays for one mesh (native SAH, else Morton)."""
    from . import bvh as bvh_mod

    n = len(v0)
    nodes = bvh_mod.build_bvh_sah(v0, e1, e2, n, leaf_size)
    if nodes is None:
        nodes = bvh_mod.to_node_arrays(bvh_mod.build_bvh(v0, e1, e2, n, leaf_size))
    return nodes


@dataclasses.dataclass
class TlasRefitContext:
    """Host-side statics for device refits (frozen at build)."""

    inst_order: np.ndarray  # [I] original index per sorted slot
    slot_mesh_lo: np.ndarray  # [I, 3] object AABB of each slot's mesh
    slot_mesh_hi: np.ndarray  # [I, 3]
    slot_mat_override: np.ndarray  # [I] i32 (-1 = none)
    levels: int  # TLAS depth (2**levels leaf slots)
    num_instances: int


def _tlas_topology(levels: int, num_inst: int, slot_root: np.ndarray):
    """Static child codes / instance ids of the fat TLAS over the implicit
    heap (instance leaf slots at heap ids >= 2**levels - 1). Subtrees that
    hold only padding slots become EMPTY children."""
    n_leaves = 1 << levels
    first_leaf = n_leaves - 1
    if first_leaf == 0:
        child = np.array([[slot_root[0], EMPTY]], np.int64)
        inst = np.array([[0, -1]], np.int64)
        return child, inst
    c = 2 * np.arange(first_leaf)[:, None] + np.array([[1, 2]])  # heap ids
    leftmost = c.copy()
    while (leftmost < first_leaf).any():
        leftmost = np.where(leftmost < first_leaf, 2 * leftmost + 1, leftmost)
    slot = c - first_leaf
    is_inst = c >= first_leaf
    child = np.where(
        leftmost - first_leaf >= num_inst, EMPTY,
        np.where(is_inst, slot_root[np.clip(slot, 0, num_inst - 1)], c),
    )
    inst = np.where(is_inst & (slot < num_inst), slot, -1)
    return child, inst


def build_two_level(
    meshes: list,  # list of (v0 [T,3], e1, e2) object-space triangle arrays
    inst_mesh: np.ndarray,  # [I] mesh index per instance
    transforms: np.ndarray,  # [I, 4, 4]
    mat_override: np.ndarray | None = None,  # [I] int (-1 = keep mesh ids)
    leaf_size: int = 8,
) -> tuple[dict, TlasRefitContext]:
    """Build the full two-level structure. Returns (device pytree, refit ctx).

    The pytree's tlas_nodes/xf/inst_* are exactly what
    `refit_instances_arrays` regenerates per frame; the rest is immutable.
    """
    inst_mesh = np.asarray(inst_mesh, np.int64)
    transforms = np.asarray(transforms, np.float32)
    num_inst = len(inst_mesh)
    if mat_override is None:
        mat_override = np.full((num_inst,), -1, np.int64)
    mat_override = np.asarray(mat_override, np.int64)

    # ---- per-mesh BLAS, concatenated with rebased codes --------------------
    packs = []
    mesh_root = np.zeros((len(meshes),), np.int64)
    mesh_lo = np.zeros((len(meshes), 3), np.float32)
    mesh_hi = np.zeros((len(meshes), 3), np.float32)
    node_base = leaf_base = tri_base = 0
    blas_depth = 0
    for k, (v0, e1, e2) in enumerate(meshes):
        nodes = _build_mesh_blas(v0, e1, e2, leaf_size)
        pk, need = pack_bvh(nodes, v0, e1, e2, leaf_size)
        blas_depth = max(blas_depth, need)
        ch = pk["child"].astype(np.int64)
        pk["child"] = np.where(
            ch == EMPTY, EMPTY,
            np.where(ch >= 0, ch + node_base, ch - leaf_base),
        )
        pk["tri"] = np.where(pk["tri"] >= 0, pk["tri"] + tri_base, -1)
        mesh_root[k] = node_base
        mesh_lo[k] = np.asarray(nodes["nodes_lo"], np.float32)[0]
        mesh_hi[k] = np.asarray(nodes["nodes_hi"], np.float32)[0]
        node_base += len(pk["nodes"])
        leaf_base += len(pk["tris"])
        tri_base += len(v0)
        packs.append(pk)

    # ---- TLAS over instance world AABBs (implicit heap; Morton order) -----
    lo_w, hi_w = _world_aabbs_numpy(
        mesh_lo[inst_mesh], mesh_hi[inst_mesh], transforms
    )
    centroid = (lo_w + hi_w) * 0.5
    from .bvh import morton_codes

    codes = morton_codes(centroid, lo_w.min(0), hi_w.max(0))
    inst_order = np.argsort(codes, kind="stable").astype(np.int32)

    levels = 0
    while (1 << levels) < num_inst:
        levels += 1
    if levels + blas_depth + 1 > STACK_DEPTH:
        raise ValueError(
            f"two-level tree needs {levels + blas_depth + 1} stack entries; "
            f"the walk has {STACK_DEPTH}"
        )
    n_tlas = max((1 << levels) - 1, 1)
    # BLAS nodes follow the TLAS nodes in the combined array.
    slot_root = mesh_root[inst_mesh[inst_order]] + n_tlas
    tl_child, tl_inst = _tlas_topology(levels, num_inst, slot_root)
    blas_child = np.concatenate([p["child"] for p in packs])
    blas_child = np.where(blas_child >= 0, blas_child + n_tlas, blas_child)

    ctx = TlasRefitContext(
        inst_order=inst_order,
        slot_mesh_lo=mesh_lo[inst_mesh][inst_order],
        slot_mesh_hi=mesh_hi[inst_mesh][inst_order],
        slot_mat_override=mat_override[inst_order].astype(np.int32),
        levels=levels,
        num_instances=num_inst,
    )
    tl = {
        "blas_nodes": jnp.asarray(np.concatenate([p["nodes"] for p in packs])),
        "blas_tris": jnp.asarray(np.concatenate([p["tris"] for p in packs])),
        "blas_tri": jnp.asarray(
            np.concatenate([p["tri"] for p in packs]).astype(np.int32)
        ),
        "blas_v0": jnp.asarray(np.concatenate([p["v0"] for p in packs])),
        "child": jnp.asarray(
            np.concatenate([tl_child, blas_child]).astype(np.int32)
        ),
        "child_inst": jnp.asarray(
            np.concatenate(
                [tl_inst, np.full_like(blas_child, -1)]
            ).astype(np.int32)
        ),
        **refit_instances_arrays(ctx, transforms),
    }
    return tl, ctx


def _world_aabbs_numpy(mesh_lo, mesh_hi, transforms):
    corners = _aabb_corners(mesh_lo, mesh_hi, np)  # [I, 8, 3]
    rot = transforms[:, :3, :3]
    trans = transforms[:, :3, 3]
    world = np.einsum("ikj,icj->ick", rot, corners) + trans[:, None, :]
    return world.min(axis=1), world.max(axis=1)


def _aabb_corners(lo, hi, xp):
    """[I, 8, 3] corners of per-instance AABBs."""
    picks = xp.asarray(
        [[(c >> a) & 1 for a in range(3)] for c in range(8)], lo.dtype
    )  # [8, 3] of 0/1
    return lo[:, None, :] * (1 - picks)[None] + hi[:, None, :] * picks[None]


@functools.partial(jax.jit, static_argnames=("levels", "num_instances"))
def _refit_device(
    transforms,  # [I, 4, 4] (ORIGINAL instance order)
    inst_order,  # [I] i32
    slot_mesh_lo,  # [I, 3]
    slot_mesh_hi,
    slot_mat_override,  # [I] i32
    levels: int,
    num_instances: int,
):
    i = num_instances
    hp = jax.lax.Precision.HIGHEST  # f32 products (no TF32) for the rays' maps
    tf = transforms[inst_order]
    rot = tf[:, :3, :3]
    trans = tf[:, :3, 3]
    a = jnp.linalg.inv(rot)  # [I, 3, 3]
    b = -jnp.einsum("ikj,ij->ik", a, trans, precision=hp)
    nm = jnp.transpose(a, (0, 2, 1))  # normal matrix = inv(R)^T

    corners = _aabb_corners(slot_mesh_lo, slot_mesh_hi, jnp)
    world = jnp.einsum("ikj,icj->ick", rot, corners,
                       precision=hp) + trans[:, None, :]
    lo_w = world.min(axis=1)
    hi_w = world.max(axis=1)

    # Implicit heap reduce. Padding slots are inverted boxes that reduce
    # away; the children that point at them are EMPTY (static topology).
    n_leaves = 1 << levels
    los = [jnp.full((n_leaves, 3), BIG, jnp.float32).at[:i].set(lo_w)]
    his = [jnp.full((n_leaves, 3), -BIG, jnp.float32).at[:i].set(hi_w)]
    for _ in range(levels):
        los.append(jnp.minimum(los[-1][0::2], los[-1][1::2]))
        his.append(jnp.maximum(his[-1][0::2], his[-1][1::2]))
    heap_lo = jnp.concatenate(list(reversed(los)), axis=0)  # heap order
    heap_hi = jnp.concatenate(list(reversed(his)), axis=0)

    first_leaf = n_leaves - 1
    if first_leaf == 0:
        empty = jnp.full((1, 3), BIG, jnp.float32)
        tlas = jnp.concatenate([lo_w, hi_w, empty, empty], axis=1)
    else:
        c0 = 2 * np.arange(first_leaf) + 1
        tlas = jnp.concatenate(
            [heap_lo[c0], heap_hi[c0], heap_lo[c0 + 1], heap_hi[c0 + 1]],
            axis=1,
        )

    xf = jnp.concatenate([a.reshape(i, 9), b], axis=1)
    identity = jnp.asarray([[1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0]], jnp.float32)
    return {
        "tlas_nodes": tlas,
        "xf": jnp.concatenate([xf, identity], axis=0),
        "inst_nm": nm,
        "inst_mat_override": slot_mat_override,
        "inst_orig": inst_order,
    }


def refit_instances_arrays(ctx: TlasRefitContext, transforms) -> dict:
    """Device refit: new transforms -> fresh TLAS/instance arrays (no
    triangle work; the D3D12 PERFORM_UPDATE analogue)."""
    return _refit_device(
        jnp.asarray(transforms, jnp.float32),
        jnp.asarray(ctx.inst_order),
        jnp.asarray(ctx.slot_mesh_lo),
        jnp.asarray(ctx.slot_mesh_hi),
        jnp.asarray(ctx.slot_mat_override),
        ctx.levels,
        ctx.num_instances,
    )


# --------------------------------------------------------------------------- #
# Brute-force two-level oracle (tests only: it unrolls a loop over instances)
# --------------------------------------------------------------------------- #
def _object_rays(tl: dict, slot: int, origins, directions):
    x = tl["xf"][slot]
    a, b = x[0:9].reshape(3, 3), x[9:12]
    hp = jax.lax.Precision.HIGHEST
    return (jnp.matmul(origins, a.T, precision=hp) + b,
            jnp.matmul(directions, a.T, precision=hp))


def _mesh_tris(scene: dict, slot: int) -> dict:
    meta = scene["tlas_meta"].value
    lo_t, hi_t = meta["mesh_tri_ranges"][meta["slot_mesh"][slot]]
    return lo_t, {
        k: scene[f"{k}_obj"][lo_t:hi_t]
        for k in ("v0", "e1", "e2", "pn", "c1", "c2", "d0")
    }


def two_level_closest_jnp(scene: dict, origins, directions, t_min, t_max,
                          cull: bool):
    """Brute-force two-level closest hit: per instance, transform rays into
    object space and test against its mesh's triangle range. The oracle for
    the walk at small instance counts.

    Returns {"hit", "t", "tri" (global object-space index), "u", "v",
    "inst" (slot into the sorted instance table)}.
    """
    from ..ops import intersect

    meta = scene["tlas_meta"].value  # HostStatic (see Scene.build_two_level)
    n = origins.shape[0]
    best = {
        "t": jnp.full((n,), np.inf, jnp.float32),
        "tri": jnp.full((n,), -1, jnp.int32),
        "u": jnp.zeros((n,), jnp.float32),
        "v": jnp.zeros((n,), jnp.float32),
        "inst": jnp.full((n,), -1, jnp.int32),
    }
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    for slot in range(meta["num_instances"]):
        o2, d2 = _object_rays(scene["tlas"], slot, origins, directions)
        lo_t, sub = _mesh_tris(scene, slot)
        h = intersect.intersect_closest(
            sub, o2, d2, t_min, jnp.minimum(t_max, best["t"]),
            cull_backface=cull,
        )
        better = h["hit"] & (h["t"] < best["t"])
        best["t"] = jnp.where(better, h["t"], best["t"])
        best["tri"] = jnp.where(better, h["tri"] + lo_t, best["tri"])
        best["u"] = jnp.where(better, h["u"], best["u"])
        best["v"] = jnp.where(better, h["v"], best["v"])
        best["inst"] = jnp.where(better, slot, best["inst"])
    hit = best["tri"] >= 0
    return {
        "hit": hit,
        "t": jnp.where(hit, best["t"], -1.0),
        "tri": best["tri"],
        "u": best["u"],
        "v": best["v"],
        "inst": best["inst"],
    }


def two_level_any_jnp(scene: dict, origins, directions, t_min, t_max):
    from ..ops import intersect

    meta = scene["tlas_meta"].value
    occ = jnp.zeros((origins.shape[0],), bool)
    for slot in range(meta["num_instances"]):
        o2, d2 = _object_rays(scene["tlas"], slot, origins, directions)
        _, sub = _mesh_tris(scene, slot)
        occ = occ | intersect.intersect_any(sub, o2, d2, t_min, t_max)
    return occ
