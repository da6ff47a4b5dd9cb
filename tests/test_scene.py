"""Scene layer tests: mesh import, procedural geometry, scene lowering, env maps."""

import os
import textwrap

import jax.numpy as jnp
import numpy as np

from dxrexperiments_tpu.scene import Material, Scene, cornell_box, load_mesh, load_obj
from dxrexperiments_tpu.scene import envmap, lights, procedural
from dxrexperiments_tpu.scene.mesh import Mesh, compute_smooth_normals, fallback_triangle


def test_smooth_normals_flat_quad():
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = compute_smooth_normals(pos, idx)
    np.testing.assert_allclose(n, [[0, 0, 1]] * 4, atol=1e-6)


def test_obj_roundtrip(tmp_path):
    obj = textwrap.dedent(
        """
        mtllib cube.mtl
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        vn 0 0 1
        usemtl redmat
        f 1//1 2//1 3//1 4//1
        """
    )
    mtl = "newmtl redmat\nKd 0.9 0.1 0.2\nNs 100\n"
    p = tmp_path / "quad.obj"
    p.write_text(obj)
    (tmp_path / "cube.mtl").write_text(mtl)
    mesh = load_obj(str(p))
    assert mesh.num_triangles == 2  # fan triangulated
    assert len(mesh.materials) == 1
    np.testing.assert_allclose(mesh.materials[0].albedo[:3], (0.9, 0.1, 0.2))
    np.testing.assert_allclose(mesh.normals, [[0, 0, 1]] * len(mesh.normals), atol=1e-6)


def test_obj_negative_indices(tmp_path):
    p = tmp_path / "neg.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    mesh = load_obj(str(p))
    assert mesh.num_triangles == 1
    np.testing.assert_allclose(mesh.positions[mesh.indices[0]][1], [1, 0, 0])


def test_load_mesh_fallback_on_garbage(tmp_path):
    p = tmp_path / "broken.obj"
    p.write_text("not an obj at all ((((")
    mesh = load_mesh(str(p))
    assert mesh.name == "fallback_triangle"
    assert mesh.num_triangles == 1


def test_load_mesh_unknown_format_raises_when_strict(tmp_path):
    p = tmp_path / "model.xyz"
    p.write_text("")
    try:
        load_mesh(str(p), on_error="raise")
        assert False, "should have raised"
    except ValueError:
        pass


def test_ply_binary_roundtrip(tmp_path):
    import struct

    header = (
        b"ply\nformat binary_little_endian 1.0\n"
        b"element vertex 3\nproperty float x\nproperty float y\nproperty float z\n"
        b"element face 1\nproperty list uchar int vertex_indices\nend_header\n"
    )
    body = b"".join(struct.pack("<3f", *v) for v in [(0, 0, 0), (1, 0, 0), (0, 1, 0)])
    body += struct.pack("<B3i", 3, 0, 1, 2)
    p = tmp_path / "tri.ply"
    p.write_bytes(header + body)
    mesh = load_mesh(str(p))
    assert mesh.num_triangles == 1
    np.testing.assert_allclose(mesh.positions[1], [1, 0, 0])


def test_reference_cornell_obj_parses_if_present():
    path = "/root/reference/assets/models/cornell.obj"
    if not os.path.exists(path):
        return
    mesh = load_obj(path)
    assert mesh.num_triangles > 10
    lo, hi = mesh.aabb()
    assert np.all(hi > lo)


def test_cornell_box_geometry():
    mesh, materials = cornell_box()
    assert mesh.num_triangles == 12 + 24  # 6 quads + 2 boxes
    assert len(materials) == 5
    lo, hi = mesh.aabb()
    np.testing.assert_allclose(lo, [-1, 0, -1], atol=1e-5)
    np.testing.assert_allclose(hi, [1, 2, 1], atol=1e-5)


def test_scene_build_padding_and_precomputes():
    mesh, materials = cornell_box()
    sc = Scene()
    for m in materials:
        sc.add_material(m)
    sc.add_model(mesh)
    data = sc.build()
    n = int(data["num_tris"])
    assert n == mesh.num_triangles
    # The scene arrays are not padded (the intersector pads its own chunks).
    assert all(data[k].shape[0] == n for k in ("v0", "pn", "mat_id"))
    # Plücker precomputes match definitions.
    v0 = np.asarray(data["v0"][:n])
    e1 = np.asarray(data["e1"][:n])
    e2 = np.asarray(data["e2"][:n])
    np.testing.assert_allclose(
        np.asarray(data["pn"][:n]), np.cross(e1, e2), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(data["d0"][:n]), np.sum(v0 * np.cross(e1, e2), axis=-1), atol=1e-4
    )


def test_scene_transform_and_material_override():
    tri = fallback_triangle()
    sc = Scene()
    white = sc.add_material(Material())
    red = sc.add_material(Material(albedo=(1, 0, 0, 1)))
    t = np.eye(4, dtype=np.float32)
    t[0, 3] = 5.0  # translate +x
    sc.add_model(tri, material=white)
    sc.add_model(tri, transform=t, material=red)
    data = sc.build()
    n = int(data["num_tris"])
    assert n == 2
    np.testing.assert_allclose(
        np.asarray(data["v0"][1]) - np.asarray(data["v0"][0]), [5, 0, 0], atol=1e-6
    )
    assert int(data["mat_id"][0]) == white and int(data["mat_id"][1]) == red
    assert int(data["inst_id"][1]) == 1


def test_animated_dir_light():
    f0 = lights.animated_dir_light_forward(0.0)
    np.testing.assert_allclose(f0, [0.3, -0.2, -1.0], atol=1e-6)
    f1 = lights.animated_dir_light_forward(3.0)
    assert not np.allclose(f0, f1)
    # Y component is invariant under Y rotation.
    np.testing.assert_allclose(f1[1], -0.2, atol=1e-6)


def test_env_constant_and_gradient():
    d = jnp.asarray([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    env = envmap.constant_env((0.5, 0.25, 0.125), strength=2.0)
    out = np.asarray(envmap.sample_environment(env, d))
    np.testing.assert_allclose(out, [[1.0, 0.5, 0.25]] * 2, atol=1e-6)
    env2 = envmap.gradient_env(horizon=(1, 0, 0), zenith=(0, 0, 1))
    out2 = np.asarray(envmap.sample_environment(env2, d))
    np.testing.assert_allclose(out2[0], [0, 0, 1], atol=1e-6)  # up = zenith
    np.testing.assert_allclose(out2[1], [1, 0, 0], atol=1e-6)  # down = horizon


def test_env_latlong_sampling():
    img = np.zeros((4, 8, 3), np.float32)
    img[0, :] = [0, 0, 1]  # top rows = +y
    img[-1, :] = [1, 0, 0]
    env = envmap.latlong_env(img)
    up = np.asarray(
        envmap.sample_environment(env, jnp.asarray([[0.0, 1.0, 0.0]]))
    )[0]
    down = np.asarray(
        envmap.sample_environment(env, jnp.asarray([[0.0, -1.0, 0.0]]))
    )[0]
    # Poles land between the edge row and its clamp copy (bilinear), so the
    # pole color dominates but isn't exactly 1.
    assert up[2] >= 0.45 and up[0] < 0.05
    assert down[0] >= 0.45 and down[2] < 0.05


def test_env_cubemap_face_selection():
    faces = np.zeros((6, 4, 4, 3), np.float32)
    for i in range(6):
        faces[i, :, :, :] = 0
        faces[i, :, :, i % 3] = i + 1
    env = envmap.cubemap_env(faces)
    dirs = jnp.asarray(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        jnp.float32,
    )
    out = np.asarray(envmap.sample_environment(env, dirs))
    for i in range(6):
        np.testing.assert_allclose(out[i].max(), i + 1, atol=1e-5)


def test_sphere_mesh_normals_outward():
    m = procedural.sphere_mesh((1, 2, 3), 2.0)
    rel = m.positions - np.array([1, 2, 3], np.float32)
    np.testing.assert_allclose(np.linalg.norm(rel, axis=-1), 2.0, atol=1e-5)
    cos = np.sum(rel / 2.0 * m.normals, axis=-1)
    assert cos.min() > 0.99


def test_env_quad_pack_matches_four_gathers():
    """The quad-packed single-gather bilinear (latlong + cube) must be
    bit-exact with the 4-gather formulation, including wrap/clamp edges."""
    import numpy as np
    import jax.numpy as jnp
    from dxrexperiments_tpu.scene import envmap

    rs = np.random.default_rng(3)
    img = rs.random((7, 9, 3)).astype(np.float32)
    env = envmap.latlong_env(img)
    # uv grid hitting wrap (u near 1) and clamp (v near 0/1) edges
    u = jnp.asarray(rs.random(500).astype(np.float32))
    v = jnp.asarray(rs.random(500).astype(np.float32))
    fast = envmap._bilinear_wrap_u(env["latlong"], u, v, env["latlong_quad"])
    ref = envmap._bilinear_wrap_u(env["latlong"], u, v, None)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(ref))

    faces = rs.random((6, 8, 8, 3)).astype(np.float32)
    cenv = envmap.cubemap_env(faces)
    d = rs.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    face, cu, cv = envmap.dir_to_cube_face_uv(jnp.asarray(d))
    fast_c = envmap._bilinear_cube(cenv["cube"], face, cu, cv, cenv["cube_quad"])
    ref_c = envmap._bilinear_cube(cenv["cube"], face, cu, cv, None)
    np.testing.assert_array_equal(np.asarray(fast_c), np.asarray(ref_c))
