"""Intersector tests against closed forms and a NumPy reference MT."""

import jax.numpy as jnp
import numpy as np

from dxrexperiments_tpu.ops import intersect
from dxrexperiments_tpu.scene import Scene, cornell_box
from dxrexperiments_tpu.scene.mesh import Mesh


def single_triangle_scene(v0, v1, v2):
    sc = Scene()
    pos = np.asarray([v0, v1, v2], np.float32)
    mesh = Mesh(pos, None, np.array([[0, 1, 2]], np.int32))
    sc.add_model(mesh)
    return sc.build()


def numpy_mt(v0, e1, e2, o, d):
    """Classic scalar Möller–Trumbore for verification."""
    p = np.cross(d, e2)
    det = np.dot(e1, p)
    if abs(det) < 1e-12:
        return None
    inv = 1.0 / det
    tv = o - v0
    u = np.dot(tv, p) * inv
    if u < 0 or u > 1:
        return None
    q = np.cross(tv, e1)
    v = np.dot(d, q) * inv
    if v < 0 or u + v > 1:
        return None
    t = np.dot(e2, q) * inv
    return (t, u, v)


def test_single_triangle_hit_miss():
    data = single_triangle_scene([0, 0, 0], [1, 0, 0], [0, 1, 0])
    origins = jnp.asarray(
        [[0.2, 0.2, 1.0], [0.9, 0.9, 1.0], [0.2, 0.2, -1.0]], jnp.float32
    )
    dirs = jnp.asarray([[0, 0, -1], [0, 0, -1], [0, 0, -1]], jnp.float32)
    h = intersect.intersect_closest(data, origins, dirs)
    hits = np.asarray(h["hit"])
    assert hits[0] and not hits[1]  # u+v>1 outside
    assert not hits[2]  # behind the ray? no: origin z=-1 going -z, plane z=0 behind
    np.testing.assert_allclose(float(h["t"][0]), 1.0, atol=1e-5)
    np.testing.assert_allclose(float(h["u"][0]), 0.2, atol=1e-5)
    np.testing.assert_allclose(float(h["v"][0]), 0.2, atol=1e-5)


def test_backface_culling():
    data = single_triangle_scene([0, 0, 0], [1, 0, 0], [0, 1, 0])
    # CCW triangle faces +z; a ray traveling +z (from behind) hits the backface.
    o = jnp.asarray([[0.2, 0.2, -1.0]], jnp.float32)
    d = jnp.asarray([[0, 0, 1]], jnp.float32)
    h_nocull = intersect.intersect_closest(data, o, d, cull_backface=False)
    h_cull = intersect.intersect_closest(data, o, d, cull_backface=True)
    assert bool(h_nocull["hit"][0])
    assert not bool(h_cull["hit"][0])
    # Frontal ray still hits with culling on.
    o2 = jnp.asarray([[0.2, 0.2, 1.0]], jnp.float32)
    d2 = jnp.asarray([[0, 0, -1]], jnp.float32)
    assert bool(intersect.intersect_closest(data, o2, d2, cull_backface=True)["hit"][0])


def test_t_range_clipping():
    data = single_triangle_scene([0, 0, 0], [1, 0, 0], [0, 1, 0])
    o = jnp.asarray([[0.2, 0.2, 1.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1]], jnp.float32)
    assert not bool(
        intersect.intersect_closest(data, o, d, t_min=0.0, t_max=0.5)["hit"][0]
    )
    assert bool(
        intersect.intersect_closest(data, o, d, t_min=0.0, t_max=1.5)["hit"][0]
    )
    assert not bool(
        intersect.intersect_closest(data, o, d, t_min=1.5, t_max=10.0)["hit"][0]
    )


def test_closest_of_two():
    sc = Scene()
    for z in (0.0, -1.0):
        pos = np.array([[0, 0, z], [1, 0, z], [0, 1, z]], np.float32)
        sc.add_model(Mesh(pos, None, np.array([[0, 1, 2]], np.int32)))
    data = sc.build()
    o = jnp.asarray([[0.2, 0.2, 2.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1]], jnp.float32)
    h = intersect.intersect_closest(data, o, d)
    assert bool(h["hit"][0])
    np.testing.assert_allclose(float(h["t"][0]), 2.0, atol=1e-5)  # nearer plane z=0
    assert int(h["tri"][0]) == 0


def test_matches_numpy_mt_random():
    mesh, materials = cornell_box()
    sc = Scene()
    sc.add_model(mesh)
    data = sc.build()
    n = int(data["num_tris"])
    v0 = np.asarray(data["v0"][:n])
    e1 = np.asarray(data["e1"][:n])
    e2 = np.asarray(data["e2"][:n])

    rs = np.random.default_rng(7)
    origins = rs.uniform(-0.9, 0.9, size=(64, 3)).astype(np.float32)
    origins[:, 1] = rs.uniform(0.1, 1.9, size=64)
    dirs = rs.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    h = intersect.intersect_closest(
        data, jnp.asarray(origins), jnp.asarray(dirs), t_min=1e-4
    )
    for i in range(64):
        best = (np.inf, -1)
        for k in range(n):
            r = numpy_mt(v0[k], e1[k], e2[k], origins[i].astype(np.float64), dirs[i].astype(np.float64))
            if r and 1e-4 < r[0] < best[0]:
                best = (r[0], k)
        if best[1] < 0:
            assert not bool(h["hit"][i]), i
        else:
            assert bool(h["hit"][i]), i
            np.testing.assert_allclose(float(h["t"][i]), best[0], rtol=1e-3)
            assert int(h["tri"][i]) == best[1], i


def test_any_hit_occlusion():
    data = single_triangle_scene([-10, -10, 0], [10, -10, 0], [0, 10, 0])
    o = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1], [0, 0, 1]], jnp.float32)
    occ = np.asarray(intersect.intersect_any(data, o, d))
    assert occ[0] and not occ[1]
    # Segment shorter than the distance: not occluded.
    occ2 = np.asarray(intersect.intersect_any(data, o, d, t_max=jnp.asarray([0.5, 0.5])))
    assert not occ2[0]


def test_padding_triangles_never_hit():
    """Triangle counts that are not a whole number of chunks are padded with
    all-zero triangles inside the intersector; those must never hit."""
    sc = Scene()
    for x in (3.0, 4.0, 5.0):
        pos = np.array([[x, 0, 0], [x + 0.5, 0, 0], [x, 0.5, 0]], np.float32)
        sc.add_model(Mesh(pos, None, np.array([[0, 1, 2]], np.int32)))
    data = sc.build()
    assert data["v0"].shape[0] == 3  # the scene itself is not padded
    # A ray through the origin, where the zero padding triangle sits.
    o = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    assert not bool(intersect.intersect_closest(data, o, d, chunk=2)["hit"][0])
    assert not bool(intersect.intersect_any(data, o, d, chunk=2)[0])


# --------------------------------------------------------------------------- #
# Many rays against a vectorised NumPy oracle (float64 Möller–Trumbore).
# --------------------------------------------------------------------------- #
def oracle(data, o, d, t_min=1e-4, t_max=np.inf, cull=False):
    """Closest hit per ray: (t, tri, u, v) arrays, tri = -1 on a miss."""
    v0, e1, e2 = (np.asarray(data[k], np.float64) for k in ("v0", "e1", "e2"))
    o = np.asarray(o, np.float64)[:, None]
    d = np.asarray(d, np.float64)[:, None]
    p = np.cross(d, e2[None])
    det = np.sum(e1[None] * p, -1)
    ok = det > 1e-12 if cull else np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = o - v0[None]
    u = np.sum(tv * p, -1) * inv
    q = np.cross(tv, e1[None])
    v = np.sum(d * q, -1) * inv
    t = np.sum(e2[None] * q, -1) * inv
    t_max = np.broadcast_to(np.asarray(t_max, np.float64), (o.shape[0],))
    hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
           & (t < t_max[:, None]))
    tt = np.where(hit, t, np.inf)
    tri = np.argmin(tt, -1)
    rows = np.arange(len(tri))
    found = np.isfinite(tt[rows, tri])
    return (np.where(found, tt[rows, tri], -1.0), np.where(found, tri, -1),
            u[rows, tri], v[rows, tri])


def cornell_scene():
    mesh, materials = cornell_box(glossy_tall_box=True)
    sc = Scene()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh)
    return sc.build()


def random_rays(n, seed=0, inside=True):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)
    if inside:
        o[:, 1] = rs.uniform(0.1, 1.9, size=n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def assert_matches_oracle(data, got, o, d, **kw):
    """Same hits at the same t; the same triangle except on exact ties (a
    ray through an edge two triangles share may report either)."""
    t, tri, u, v = oracle(data, o, d, **kw)
    hit = tri >= 0
    np.testing.assert_array_equal(np.asarray(got["hit"]), hit)
    np.testing.assert_allclose(np.asarray(got["t"])[hit], t[hit], rtol=2e-4,
                               atol=2e-5)
    same = hit & (np.asarray(got["tri"]) == tri)
    assert same.sum() >= 0.98 * hit.sum(), (same.sum(), hit.sum())
    np.testing.assert_allclose(np.asarray(got["u"])[same], u[same], atol=2e-4)
    np.testing.assert_allclose(np.asarray(got["v"])[same], v[same], atol=2e-4)


def test_closest_matches_oracle():
    data = cornell_scene()
    o, d = random_rays(300)
    got = intersect.intersect_closest(data, o, d, t_min=1e-4)
    assert_matches_oracle(data, got, o, d)


def test_closest_attributes_match_interpolation():
    """Hit attributes (position, normal, material) from the intersector's
    record match barycentric interpolation done in NumPy."""
    from dxrexperiments_tpu.trace.integrator import _interpolate_hit

    data = cornell_scene()
    o, d = random_rays(300, seed=3)
    rec = intersect.intersect_closest(data, o, d, t_min=1e-4)
    pos, nrm, mat = _interpolate_hit(data, rec, o, d)
    t, tri, u, v = oracle(data, o, d)
    hit = tri >= 0
    w = 1.0 - u - v
    n = (w[:, None] * np.asarray(data["n0"])[tri]
         + u[:, None] * np.asarray(data["n1"])[tri]
         + v[:, None] * np.asarray(data["n2"])[tri])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(nrm)[hit], n[hit], atol=1e-3)
    p = np.asarray(o) + t[:, None] * np.asarray(d)
    np.testing.assert_allclose(np.asarray(pos)[hit], p[hit], atol=1e-3)
    mid = np.asarray(data["mat_id"])[tri]
    np.testing.assert_allclose(
        np.asarray(mat["albedo"])[hit],
        np.asarray(data["materials"]["albedo"])[mid][hit], atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(mat["type"])[hit],
        np.asarray(data["materials"]["type"])[mid][hit])


def test_closest_backface_culling_matches_oracle():
    data = cornell_scene()
    o, d = random_rays(200, seed=5)
    got = intersect.intersect_closest(data, o, d, t_min=1e-4,
                                      cull_backface=True)
    assert_matches_oracle(data, got, o, d, cull=True)


def test_any_matches_oracle():
    data = cornell_scene()
    o, d = random_rays(300, seed=9)
    tmax = np.random.default_rng(1).uniform(0.1, 5.0, size=300).astype(
        np.float32)
    got = intersect.intersect_any(data, o, d, t_min=1e-4,
                                  t_max=jnp.asarray(tmax))
    _, tri, _, _ = oracle(data, o, d, t_max=tmax)
    np.testing.assert_array_equal(np.asarray(got), tri >= 0)


def test_ray_count_not_chunk_aligned():
    data = cornell_scene()
    o, d = random_rays(77, seed=11)
    got = intersect.intersect_closest(data, o, d, t_min=1e-4)
    assert got["hit"].shape == (77,)
    assert_matches_oracle(data, got, o, d)


def test_multi_chunk_scene():
    """960 triangles: one full 512-triangle chunk and one padded chunk."""
    from dxrexperiments_tpu.scene.procedural import sphere_mesh

    sc = Scene()
    sc.add_model(sphere_mesh((0, 0, 0), 1.0, lat=16, lon=32))
    data = sc.build(accel="none")
    assert data["v0"].shape[0] == 960
    o, d = random_rays(200, seed=13, inside=False)
    got = intersect.intersect_closest(data, o, d, t_min=1e-4)
    assert_matches_oracle(data, got, o, d)
