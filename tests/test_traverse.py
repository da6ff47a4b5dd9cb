"""The lax BVH walk (accel/traverse.py) against brute force (ops/intersect.py)
and the host traversal (accel.bvh.traverse_nodes_numpy): leaf sizes, both
builders, backface culling, per-ray t_max, dead and empty rays, any-hit, the
layout checks of pack_bvh and the deepest tree the fixed stack holds."""

import jax.numpy as jnp
import numpy as np
import pytest

from dxrexperiments_tpu.accel import bvh as bvh_mod
from dxrexperiments_tpu.accel import traverse
from dxrexperiments_tpu.ops import intersect
from dxrexperiments_tpu.scene import Scene, cornell_box
from dxrexperiments_tpu.scene.procedural import random_triangle_soup
from dxrexperiments_tpu.utils import native


def build(mesh_kind, leaf_size=8, builder="morton", n=3000):
    mesh = (cornell_box(glossy_tall_box=True)[0] if mesh_kind == "cornell"
            else random_triangle_soup(n, seed=2, extent=10.0))
    sc = Scene()
    sc.add_model(mesh)
    data = sc.build(accel="none")
    t = int(data["num_tris"])
    v0, e1, e2 = (np.asarray(data[k]) for k in ("v0", "e1", "e2"))
    if builder == "morton":
        nodes = bvh_mod.to_node_arrays(bvh_mod.build_bvh(v0, e1, e2, t, leaf_size))
    elif builder == "device":
        dev = bvh_mod.build_bvh_device(jnp.asarray(v0), jnp.asarray(e1),
                                       jnp.asarray(e2), t, leaf_size)
        nodes = bvh_mod.to_node_arrays(
            {k: np.asarray(v) if hasattr(v, "shape") else v
             for k, v in dev.items()})
    else:
        if not native.available():
            pytest.skip("native SAH builder unavailable")
        nodes = bvh_mod.build_bvh_sah(v0, e1, e2, t, leaf_size,
                                      spatial=builder == "sbvh")
    packed, need = traverse.pack_bvh(nodes, v0, e1, e2, leaf_size)
    return data, nodes, {k: jnp.asarray(v) for k, v in packed.items()}, need


def rays_for(mesh_kind, n, seed=0):
    rs = np.random.default_rng(seed)
    if mesh_kind == "cornell":
        o = rs.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)
        o[:, 1] = rs.uniform(0.1, 1.9, size=n)
        d = rs.normal(size=(n, 3)).astype(np.float32)
    else:
        o = rs.uniform(-14, 14, size=(n, 3)).astype(np.float32)
        d = (-o + rs.normal(scale=2.0, size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def assert_hits_match(got, ref, min_agree=0.98):
    """Same hit flags and t; the same triangle except on exact edge ties."""
    hit = np.asarray(ref["hit"])
    np.testing.assert_array_equal(np.asarray(got["hit"]), hit)
    np.testing.assert_allclose(np.asarray(got["t"])[hit],
                               np.asarray(ref["t"])[hit], rtol=2e-4, atol=2e-5)
    same = np.asarray(got["tri"])[hit] == np.asarray(ref["tri"])[hit]
    assert same.mean() >= min_agree, same.mean()


@pytest.mark.parametrize("leaf_size", [4, 8, 16])
@pytest.mark.parametrize("builder", ["morton", "sah"])
@pytest.mark.parametrize("mesh_kind", ["cornell", "soup"])
def test_closest_matches_brute_force(mesh_kind, builder, leaf_size):
    data, _, bvh, _ = build(mesh_kind, leaf_size, builder)
    o, d = rays_for(mesh_kind, 400, seed=3)
    ref = intersect.intersect_closest(data, o, d, t_min=1e-4)
    got = traverse.closest(bvh, o, d, t_min=1e-4)
    assert_hits_match(got, ref)
    # u, v agree where the triangle does
    same = np.asarray(got["tri"]) == np.asarray(ref["tri"])
    same &= np.asarray(ref["hit"])
    for k in ("u", "v"):
        np.testing.assert_allclose(np.asarray(got[k])[same],
                                   np.asarray(ref[k])[same], atol=1e-4)


@pytest.mark.parametrize("builder", ["sbvh", "device"])
def test_closest_other_builders(builder):
    """SBVH spatial splits (triangles referenced by several leaves) and the
    device Morton build walk to the same hits."""
    data, _, bvh, _ = build("soup", 8, builder, n=1500)
    o, d = rays_for("soup", 300, seed=4)
    assert_hits_match(traverse.closest(bvh, o, d, t_min=1e-4),
                      intersect.intersect_closest(data, o, d, t_min=1e-4))


@pytest.mark.parametrize("builder", ["morton", "sah"])
def test_backface_cull(builder):
    data, _, bvh, _ = build("cornell", 8, builder)
    o, d = rays_for("cornell", 300, seed=5)
    ref = intersect.intersect_closest(data, o, d, t_min=1e-4,
                                      cull_backface=True)
    got = traverse.closest(bvh, o, d, t_min=1e-4, cull_backface=True)
    assert_hits_match(got, ref)


@pytest.mark.parametrize("builder", ["morton", "sah"])
@pytest.mark.parametrize("mesh_kind", ["cornell", "soup"])
def test_any_matches_brute_force(mesh_kind, builder):
    data, _, bvh, _ = build(mesh_kind, 8, builder, n=2000)
    o, d = rays_for(mesh_kind, 500, seed=7)
    hi = 4.0 if mesh_kind == "cornell" else 30.0
    tmax = jnp.asarray(np.random.default_rng(8).uniform(0.05, hi, 500)
                       .astype(np.float32))
    ref = intersect.intersect_any(data, o, d, t_min=1e-4, t_max=tmax)
    got = traverse.any_hit(bvh, o, d, t_min=1e-4, t_max=tmax)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_any_agrees_with_closest():
    """Occluded exactly where the closest hit lies inside (t_min, t_max)."""
    _, _, bvh, _ = build("soup", 16, "morton", n=2000)
    o, d = rays_for("soup", 500, seed=9)
    tmax = 8.0
    near = traverse.closest(bvh, o, d, t_min=1e-4, t_max=tmax)
    occ = traverse.any_hit(bvh, o, d, t_min=1e-4, t_max=tmax)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(near["hit"]))


def test_per_ray_tmax_masks_lanes():
    """t_max = 0 lanes (the integrator's inactive-lane mask) report a clean
    miss whatever their origin and direction; the others are unaffected."""
    _, _, bvh, _ = build("soup", 16, "morton", n=2000)
    o, d = rays_for("soup", 500, seed=9)
    t_max = jnp.where(jnp.arange(500) % 3 == 0, 0.0, 3.0e37)
    got = traverse.closest(bvh, o, d, t_min=1e-4, t_max=t_max)
    masked = np.asarray(t_max) == 0.0
    assert not np.asarray(got["hit"])[masked].any()
    assert (np.asarray(got["tri"])[masked] == -1).all()
    full = traverse.closest(bvh, o, d, t_min=1e-4)
    for k in ("hit", "t", "tri"):
        np.testing.assert_array_equal(np.asarray(got[k])[~masked],
                                      np.asarray(full[k])[~masked])


def test_dead_rays_zero_direction():
    """Zero-direction rays (inactive shadow lanes) start with an empty stack:
    never hit, never occluded."""
    _, _, bvh, _ = build("cornell", 8, "morton")
    o, d = rays_for("cornell", 64, seed=2)
    d = d.at[::2].set(0.0)
    got = traverse.closest(bvh, o, d, t_min=1e-4)
    assert not np.asarray(got["hit"])[::2].any()
    assert not np.asarray(traverse.any_hit(bvh, o, d, 1e-4, 1e30))[::2].any()
    assert np.asarray(got["hit"])[1::2].any()


def test_empty_interval_misses():
    """t_max < t_min is an empty segment: a miss even through geometry."""
    _, _, bvh, _ = build("cornell", 8, "morton")
    o, d = rays_for("cornell", 64, seed=6)
    got = traverse.closest(bvh, o, d, t_min=0.5, t_max=0.25)
    assert not np.asarray(got["hit"]).any()
    assert not np.asarray(traverse.any_hit(bvh, o, d, 0.5, 0.25)).any()


@pytest.mark.parametrize("builder", ["morton", "sah"])
def test_matches_host_traversal(builder):
    """Against the scalar host walk over the same node arrays (float64)."""
    data, nodes, bvh, _ = build("soup", 8, builder, n=1000)
    v0, e1, e2 = (np.asarray(data[k], np.float64) for k in ("v0", "e1", "e2"))

    def tri_test(k, o, d):
        p = np.cross(d, e2[k])
        det = np.dot(e1[k], p)
        if abs(det) < 1e-12:
            return None
        tv = o - v0[k]
        u = np.dot(tv, p) / det
        q = np.cross(tv, e1[k])
        v = np.dot(d, q) / det
        if u < 0 or v < 0 or u + v > 1:
            return None
        return np.dot(e2[k], q) / det

    o, d = rays_for("soup", 60, seed=12)
    got = traverse.closest(bvh, o, d, t_min=1e-4)
    for i in range(60):
        t, tri = bvh_mod.traverse_nodes_numpy(
            nodes, tri_test, np.asarray(o[i], np.float64),
            np.asarray(d[i], np.float64), 1e-4, np.inf)
        assert int(got["tri"][i]) == tri, i
        if tri >= 0:
            np.testing.assert_allclose(float(got["t"][i]), t, rtol=1e-5)


def test_ray_count_not_power_of_two():
    data, _, bvh, _ = build("cornell", 8, "morton")
    o, d = rays_for("cornell", 77, seed=11)
    got = traverse.closest(bvh, o, d, t_min=1e-4)
    assert got["hit"].shape == (77,)
    assert_hits_match(got, intersect.intersect_closest(data, o, d, t_min=1e-4))


def test_single_leaf_tree():
    """A mesh below any split packs as one node with an EMPTY second child."""
    data, nodes, bvh, need = build("soup", 16, "morton", n=4)
    assert len(nodes["child"]) == 1 and need == 1
    assert int(bvh["child"][0, 1]) == traverse.EMPTY
    o, _ = rays_for("soup", 200, seed=17)
    cen = np.asarray(data["v0"]) + (np.asarray(data["e1"])
                                    + np.asarray(data["e2"])) / 3.0
    aim = cen[np.arange(200) % 4] - np.asarray(o)
    d = jnp.asarray(aim / np.linalg.norm(aim, axis=-1, keepdims=True))
    ref = intersect.intersect_closest(data, o, d, t_min=1e-4)
    assert np.asarray(ref["hit"]).any()
    assert_hits_match(traverse.closest(bvh, o, d, t_min=1e-4), ref)


@pytest.mark.parametrize("builder", ["morton", "sah"])
def test_pack_covers_every_triangle_once(builder):
    """Every scene triangle sits in exactly one leaf slot, with its own
    Plücker terms and first vertex; empty slots are all zero."""
    data, _, bvh, _ = build("soup", 4, builder, n=700)
    tri = np.asarray(bvh["tri"])
    real = tri[tri >= 0]
    np.testing.assert_array_equal(np.sort(real), np.arange(700))
    rows = np.asarray(bvh["tris"]).reshape(len(tri), -1)
    np.testing.assert_array_equal(rows[tri >= 0, 0:3],
                                  np.asarray(data["pn"])[real])
    np.testing.assert_array_equal(np.asarray(bvh["v0"])[tri >= 0],
                                  np.asarray(data["v0"])[real])
    assert not rows[tri < 0].any()


def test_pack_rejects_wide_leaf():
    data, nodes, _, _ = build("soup", 16, "morton", n=200)
    v0, e1, e2 = (np.asarray(data[k]) for k in ("v0", "e1", "e2"))
    with pytest.raises(ValueError, match="leaf_size"):
        traverse.pack_bvh(nodes, v0, e1, e2, 8)


def comb_tree(depth):
    """A maximally unbalanced BVH over `depth` triangles stacked along -z:
    node k holds triangle k in its left leaf and the rest of the comb in its
    right child, so a ray down the z axis visits every level."""
    n_tri = depth
    z = -np.arange(n_tri, dtype=np.float32)
    v0 = np.stack([np.full(n_tri, -1.0), np.full(n_tri, -1.0), z], 1)
    e1 = np.tile(np.float32([[3.0, 0.0, 0.0]]), (n_tri, 1))
    e2 = np.tile(np.float32([[0.0, 3.0, 0.0]]), (n_tri, 1))
    lo, hi, child = [], [], []

    def add(lo_, hi_, ch):
        lo.append(lo_)
        hi.append(hi_)
        child.append(ch)
        return len(child) - 1

    def sub(k):  # subtree over triangles k..n-1, DFS order
        box_lo = [-1.0, -1.0, z[-1]]
        box_hi = [2.0, 2.0, z[k]]
        if k == n_tri - 1:
            return add(box_lo, box_hi, [-(k + 1), 1])
        me = add(box_lo, box_hi, [0, 0])
        left = add([-1.0, -1.0, z[k]], [2.0, 2.0, z[k]], [-(k + 1), 1])
        right = sub(k + 1)
        child[me] = [left, right]
        return me

    sub(0)
    nodes = {
        "nodes_lo": np.asarray(lo, np.float32),
        "nodes_hi": np.asarray(hi, np.float32),
        "child": np.asarray(child, np.int32),
        "order": np.arange(n_tri, dtype=np.int32),
    }
    return nodes, v0.astype(np.float32), e1, e2


def test_stack_depth_worst_case():
    """The deepest comb the fixed stack holds walks to the right hits, from
    both ends (near-first pops the leaves first from +z, last from -z);
    one level deeper is rejected at pack time."""
    depth = traverse.STACK_DEPTH  # a comb of n triangles needs n entries
    nodes, v0, e1, e2 = comb_tree(depth)
    packed, need = traverse.pack_bvh(nodes, v0, e1, e2, 1)
    assert need == traverse.STACK_DEPTH
    bvh = {k: jnp.asarray(v) for k, v in packed.items()}
    o = jnp.asarray([[0.5, 0.5, 1.0], [0.5, 0.5, -depth - 1.0],
                     [0.4, 0.6, 1.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1.0], [0, 0, 1.0], [0, 0, -1.0]], jnp.float32)
    got = traverse.closest(bvh, o, d, t_min=1e-4)
    np.testing.assert_array_equal(np.asarray(got["tri"]), [0, depth - 1, 0])
    np.testing.assert_allclose(np.asarray(got["t"]), [1.0, 2.0, 1.0],
                               atol=1e-5)
    # a segment that stops between the last two triangles
    far = traverse.closest(bvh, o[1:2], d[1:2], t_min=2.5)
    assert int(far["tri"][0]) == depth - 2
    assert bool(traverse.any_hit(bvh, o[:1], d[:1], 1e-4, 1e30)[0])

    nodes, v0, e1, e2 = comb_tree(depth + 1)
    with pytest.raises(ValueError, match="stack"):
        traverse.pack_bvh(nodes, v0, e1, e2, 1)
