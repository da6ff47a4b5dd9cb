"""Albedo textures (BASELINE config 2's "textures"): packing, sampling,
OBJ vt/map_Kd import, and the textured render paths.

BEYOND-reference capability — the DXR reference's materials are constants
(/root/reference/assets/shaders/RaytracingHlslCompat.h:87-96); BASELINE
config 2 nonetheless asks for textured multi-mesh scenes, so the quad-
packed env-texture machinery is generalized to per-material albedo maps
(dxrexperiments_tpu/scene/textures.py).
"""

import os
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

from dxrexperiments_tpu.core.camera import Camera, camera_params
from dxrexperiments_tpu.scene.materials import Material
from dxrexperiments_tpu.scene.textures import (
    checker_texture,
    pack_texture_table,
    quad_pack_wrap,
    sample_albedo,
)
from dxrexperiments_tpu.trace.integrator import default_options, render_sample


def _ref_bilinear_wrap(img, uv):
    """NumPy reference: bilinear with WRAP addressing on both axes."""
    h, w = img.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    c00 = img[y0 % h, x0 % w]
    c10 = img[y0 % h, (x0 + 1) % w]
    c01 = img[(y0 + 1) % h, x0 % w]
    c11 = img[(y0 + 1) % h, (x0 + 1) % w]
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def test_sample_albedo_matches_numpy_bilinear():
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(7, 5, 3)).astype(np.float32)
    mats = [Material(), Material(albedo_texture=img)]
    table = pack_texture_table(mats)
    uv = rng.uniform(-1.5, 2.5, size=(256, 2)).astype(np.float32)  # wraps
    mid = np.full((256,), 1, np.int32)
    got = np.asarray(sample_albedo(table, jnp.asarray(mid), jnp.asarray(uv)))
    want = _ref_bilinear_wrap(img, uv)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_untextured_materials_sample_to_one():
    img = checker_texture(4, size=8)
    mats = [Material(), Material(albedo_texture=img), Material()]
    table = pack_texture_table(mats)
    uv = np.random.default_rng(0).uniform(size=(64, 2)).astype(np.float32)
    for mid_val in (0, 2):
        mid = np.full((64,), mid_val, np.int32)
        got = np.asarray(
            sample_albedo(table, jnp.asarray(mid), jnp.asarray(uv))
        )
        np.testing.assert_array_equal(got, 1.0)


def test_pack_table_none_when_untextured():
    assert pack_texture_table([Material(), Material()]) is None


def test_pack_table_mixed_sizes_meta():
    a = np.zeros((4, 8, 3), np.float32)
    b = np.ones((2, 2, 3), np.float32)
    mats = [Material(albedo_texture=a), Material(), Material(albedo_texture=b)]
    table = pack_texture_table(mats)
    meta = np.asarray(table["meta"])
    np.testing.assert_array_equal(meta[0], (0, 8, 4))
    np.testing.assert_array_equal(meta[1], (0, 0, 0))
    np.testing.assert_array_equal(meta[2], (32, 2, 2))
    assert table["rows"].shape == (36, 12)


def test_quad_pack_wrap_layout():
    img = np.arange(2 * 3 * 3, dtype=np.float32).reshape(2, 3, 3)
    rows = quad_pack_wrap(img)
    assert rows.shape == (6, 12)
    # row for texel (y=1, x=2): neighbors wrap to x=0 / y=0.
    r = rows[1 * 3 + 2]
    np.testing.assert_array_equal(r[0:3], img[1, 2])
    np.testing.assert_array_equal(r[3:6], img[1, 0])
    np.testing.assert_array_equal(r[6:9], img[0, 2])
    np.testing.assert_array_equal(r[9:12], img[0, 0])


# ---------------------------------------------------------------------------
# OBJ vt + MTL map_Kd import
# ---------------------------------------------------------------------------


def _write_ppm(path, img):
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write((np.clip(img, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8).tobytes())


def test_obj_vt_and_map_kd_roundtrip(tmp_path):
    tex = checker_texture(2, size=4)
    _write_ppm(str(tmp_path / "albedo.ppm"), tex)
    (tmp_path / "m.mtl").write_text(textwrap.dedent("""\
        newmtl painted
        Kd 0.5 0.5 0.5
        map_Kd albedo.ppm
    """))
    (tmp_path / "quad.obj").write_text(textwrap.dedent("""\
        mtllib m.mtl
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        vt 0 0
        vt 1 0
        vt 1 1
        vt 0 1
        vn 0 0 1
        usemtl painted
        f 1/1/1 2/2/1 3/3/1 4/4/1
    """))
    from dxrexperiments_tpu.scene.mesh import load_obj

    mesh = load_obj(str(tmp_path / "quad.obj"))
    assert mesh.uv_corners is not None and mesh.uv_corners.shape == (2, 3, 2)
    # OBJ v-origin flip: vt (0,0) becomes uv (0,1).
    np.testing.assert_allclose(mesh.uv_corners[0, 0], (0.0, 1.0))
    np.testing.assert_allclose(mesh.uv_corners[0, 2], (1.0, 0.0))
    assert mesh.materials[0].albedo_texture is not None
    # PPM round-trips through sRGB encode/decode; generous tolerance.
    np.testing.assert_allclose(
        mesh.materials[0].albedo_texture, tex, atol=0.02
    )


def test_obj_without_vt_keeps_native_path(tmp_path):
    (tmp_path / "tri.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
    )
    from dxrexperiments_tpu.scene.mesh import load_obj

    mesh = load_obj(str(tmp_path / "tri.obj"))
    assert mesh.uv_corners is None
    assert mesh.num_triangles == 1


# ---------------------------------------------------------------------------
# Render paths
# ---------------------------------------------------------------------------


def _textured_quad_scene(two_level=False):
    """Unit floor quad with a 2x2 checker albedo texture, camera above."""
    from dxrexperiments_tpu.scene.mesh import Mesh, compute_smooth_normals
    from dxrexperiments_tpu.scene.procedural import quad
    from dxrexperiments_tpu.scene.scene import Scene
    from dxrexperiments_tpu.scene.lights import directional_light

    pos, idx = quad([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1])
    mesh = Mesh(
        pos, compute_smooth_normals(pos, idx), idx,
        uv_corners=np.array(
            [[[0, 0], [0, 1], [1, 1]], [[0, 0], [1, 1], [1, 0]]], np.float32
        ),
    )
    sc = Scene()
    sc.add_material(Material(
        albedo=(1.0, 1.0, 1.0, 1.0),
        albedo_texture=checker_texture(2, (1, 1, 1), (0.1, 0.1, 0.1), size=8),
    ))
    sc.add_model(mesh)
    sc.lights = {"dir": directional_light((0, -1, 0), (1, 1, 1, 1.0))}
    if two_level:
        return sc.build_two_level()
    return sc.build(accel="none")


def _render_albedo(scene, n=32):
    cam = Camera()
    cam.set_eye_at_up((0, 2.0, 1e-4), (0, 0, 0), (0, 0, -1))
    cam.set_aspect(n, n)
    cp = camera_params(cam, frame_count=1, accum_count=0)
    opts = default_options(show_gbuffer_albedo_only=True)
    return np.asarray(
        render_sample(
            scene, opts, cp, n, n, mode="progressive",
            env_kind=int(scene["env"]["kind"]),
        )["color"]
    )


def test_textured_render_shows_checker():
    img = _render_albedo(_textured_quad_scene())
    lum = img.mean(-1)
    # the checker yields two distinct populations over the floor
    assert (lum > 0.6).mean() > 0.2 and (lum < 0.3).mean() > 0.2


def test_two_level_textured_matches_flattened():
    flat = _render_albedo(_textured_quad_scene(two_level=False))
    two = _render_albedo(_textured_quad_scene(two_level=True))
    np.testing.assert_allclose(flat, two, atol=1e-5)


def test_textured_scene_takes_wavefront_path():
    """Textured scenes run the one wavefront route whatever their
    acceleration structure: the BVH walk and brute force see the same
    texels."""
    scene = _textured_quad_scene()
    assert "textures" in scene and "bvh" not in scene
    sc_bvh = dict(scene)
    from dxrexperiments_tpu.accel.traverse import pack_bvh
    from dxrexperiments_tpu.accel import bvh as bvh_mod

    v0, e1, e2 = (np.asarray(scene[k]) for k in ("v0", "e1", "e2"))
    n = int(scene["num_tris"])
    packed, _ = pack_bvh(
        bvh_mod.to_node_arrays(bvh_mod.build_bvh(v0, e1, e2, n, 8)),
        v0, e1, e2, 8,
    )
    sc_bvh["bvh"] = {k: jnp.asarray(v) for k, v in packed.items()}
    np.testing.assert_allclose(
        _render_albedo(sc_bvh), _render_albedo(scene), atol=1e-6
    )


def test_cornell_tex_end_to_end():
    """The cornell-tex demo scene (textured floor + area light) renders
    finite and non-black through the full progressive step."""
    from dxrexperiments_tpu.app.headless import build_scene
    from dxrexperiments_tpu.models import ProgressiveRaytracingPipeline

    sc, cam = build_scene("cornell-tex")
    cam.set_aspect(1, 1)
    pipe = ProgressiveRaytracingPipeline(32, 32, seed=7)
    pipe.set_camera(cam)
    pipe.set_scene(sc)
    for f in range(2):
        pipe.update(elapsed_time=f / 60.0, elapsed_frames=f)
        pipe.render()
    img = np.asarray(pipe.get_output())
    assert np.isfinite(img).all() and img.max() > 0.05
