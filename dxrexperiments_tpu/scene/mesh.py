"""Triangle mesh container + native importers (OBJ/MTL, PLY).

JAX replacement for ``RtModel``'s Assimp import path
(/root/reference/libs/DXRFramework/RtModel.cpp:24-82): meshes are flattened
to position+normal arrays with smooth normals generated when absent
(aiProcess_GenSmoothNormals equivalent) and a degenerate-load fallback
triangle (RtModel.cpp:58-68).

Formats: OBJ (+MTL materials) and binary/ascii PLY are parsed natively here;
a C++ fast-path parser lives in native/ for large assets. FBX/Collada import
is gated behind optional assimp bindings (not available in this image) with a
clear error, mirroring how the reference gates on its DLL.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from .materials import Material


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh on the host.

    positions: [V, 3] float32, normals: [V, 3] float32 (unit),
    indices: [F, 3] int32, material_ids: [F] int32 (index into materials),
    materials: list of Material declared by the file (may be empty).
    """

    positions: np.ndarray
    normals: np.ndarray
    indices: np.ndarray
    material_ids: np.ndarray | None = None
    materials: list[Material] = dataclasses.field(default_factory=list)
    name: str = ""
    # Per-face-corner texture UVs [F, 3, 2] (None = untextured). Stored per
    # corner rather than per vertex so OBJ's independent vt indexing needs
    # no vertex splitting (scene.textures).
    uv_corners: np.ndarray | None = None

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, np.int32).reshape(-1, 3)
        if self.normals is None or len(self.normals) == 0:
            self.normals = compute_smooth_normals(self.positions, self.indices)
        self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)
        if self.material_ids is None:
            self.material_ids = np.zeros(len(self.indices), np.int32)
        self.material_ids = np.asarray(self.material_ids, np.int32)
        if self.uv_corners is not None:
            self.uv_corners = np.asarray(
                self.uv_corners, np.float32
            ).reshape(-1, 3, 2)

    @property
    def num_triangles(self) -> int:
        return len(self.indices)

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        return self.positions.min(axis=0), self.positions.max(axis=0)


def compute_smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (aiProcess_GenSmoothNormals
    equivalent, cf. /root/reference/libs/DXRFramework/RtModel.cpp:26-27)."""
    normals = np.zeros_like(positions, dtype=np.float64)
    v0 = positions[indices[:, 0]].astype(np.float64)
    v1 = positions[indices[:, 1]].astype(np.float64)
    v2 = positions[indices[:, 2]].astype(np.float64)
    face_n = np.cross(v1 - v0, v2 - v0)  # length = 2*area (area weighting)
    for k in range(3):
        np.add.at(normals, indices[:, k], face_n)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    lens = np.where(lens > 1e-12, lens, 1.0)
    return (normals / lens).astype(np.float32)


def fallback_triangle() -> Mesh:
    """Built-in triangle used when a mesh fails to load, same vertices as the
    reference fallback (/root/reference/libs/DXRFramework/RtModel.cpp:58-68
    spirit: a single visible triangle)."""
    positions = np.array(
        [[0.0, 1.0, 0.0], [-1.0, -1.0, 0.0], [1.0, -1.0, 0.0]], np.float32
    )  # CCW seen from +z so the +z-facing side is the front face
    normals = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (3, 1))
    indices = np.array([[0, 1, 2]], np.int32)
    return Mesh(positions, normals, indices, name="fallback_triangle")


# --------------------------------------------------------------------------- #
# OBJ / MTL
# --------------------------------------------------------------------------- #
def _parse_mtl(path: str) -> dict[str, Material]:
    """Minimal MTL parser: Kd/Ks/Ke/Ns/Ni map onto our material model."""
    materials: dict[str, Material] = {}
    cur: Material | None = None
    name = None
    if not os.path.exists(path):
        return materials
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "newmtl":
                name = parts[1] if len(parts) > 1 else f"mtl{len(materials)}"
                cur = Material()
                materials[name] = cur
            elif cur is None:
                continue
            elif tag == "Kd" and len(parts) >= 4:
                cur.albedo = (float(parts[1]), float(parts[2]), float(parts[3]), 1.0)
            elif tag == "Ks" and len(parts) >= 4:
                ks = (float(parts[1]), float(parts[2]), float(parts[3]))
                cur.specular = (*ks, 1.0)
                if max(ks) > 1e-3:
                    cur.type = 1  # glossy
                    cur.reflectivity = max(ks)
            elif tag == "Ke" and len(parts) >= 4:
                ke = (float(parts[1]), float(parts[2]), float(parts[3]))
                if max(ke) > 0:
                    cur.emissive = (*ke, 1.0)
            elif tag == "Ns" and len(parts) >= 2:
                # Phong exponent -> roughness via the inverse of the shading
                # mapping exponent = exp((1-roughness)*12)
                # (/root/reference/assets/shaders/ProgressiveRaytracing.hlsl:119).
                ns = max(float(parts[1]), 1.0)
                cur.roughness = float(np.clip(1.0 - np.log(ns) / 12.0, 0.0, 1.0))
            elif tag == "Ni" and len(parts) >= 2:
                cur.ior = float(parts[1])
            elif tag == "d" and len(parts) >= 2:
                if float(parts[1]) < 0.99:
                    cur.type = 2  # treat translucent as glass
            elif tag == "map_Kd" and len(parts) >= 2:
                from .textures import load_texture_image

                tex = load_texture_image(
                    os.path.join(os.path.dirname(path), parts[-1])
                )
                if tex is not None:
                    cur.albedo_texture = tex
    return materials


def _finish_obj(
    pos, nrm_arr, fp, fn, face_mat, mtl_lib, mat_order, path,
    uv_arr=None, ft=None,
) -> Mesh:
    """Shared tail of the Python/native OBJ paths: normal re-indexing or
    generation, material list resolution, per-corner UV resolution."""
    uv_corners = None
    if uv_arr is not None and len(uv_arr) and ft is not None and (ft >= 0).any():
        # OBJ v-origin is bottom-left; our samplers are top-left row 0.
        uvs = np.asarray(uv_arr, np.float32)
        uvs[:, 1] = 1.0 - uvs[:, 1]
        uv_corners = np.where(
            (ft >= 0)[..., None], uvs[np.maximum(ft, 0)], 0.0
        ).astype(np.float32)
    have_normals = len(nrm_arr) > 0 and (fn >= 0).all() and len(fp) > 0
    if have_normals:
        corner_pos = pos[fp.reshape(-1)]
        corner_nrm = nrm_arr[fn.reshape(-1)]
        key = np.concatenate([corner_pos, corner_nrm], axis=-1)
        uniq, inverse = np.unique(key, axis=0, return_inverse=True)
        mesh_pos = uniq[:, :3].astype(np.float32)
        mesh_nrm = uniq[:, 3:].astype(np.float32)
        indices = inverse.astype(np.int32).reshape(-1, 3)
    else:
        mesh_pos = pos
        mesh_nrm = compute_smooth_normals(pos, fp)
        indices = fp
    materials = [mtl_lib.get(nm, Material()) for nm in mat_order]
    return Mesh(
        mesh_pos,
        mesh_nrm,
        indices,
        material_ids=np.asarray(face_mat, np.int32),
        materials=materials,
        name=os.path.basename(path),
        uv_corners=uv_corners,
    )


def _scan_obj_materials(path: str) -> tuple[dict, list[str]]:
    """Collect mtllib/usemtl declarations without parsing geometry (used by
    the native fast path, whose material ids follow usemtl order)."""
    mtl_lib: dict[str, Material] = {}
    mat_order: list[str] = []
    with open(path, "rb") as f:
        data = f.read()
    for tag in (b"mtllib ", b"usemtl "):
        start = 0
        while True:
            i = data.find(tag, start)
            if i < 0:
                break
            # only at line starts
            if i > 0 and data[i - 1 : i] not in (b"\n", b"\r"):
                start = i + 1
                continue
            j = data.find(b"\n", i)
            arg = data[i + 7 : j if j > 0 else None].decode(errors="replace").strip()
            if tag == b"mtllib ":
                mtl_lib.update(
                    _parse_mtl(os.path.join(os.path.dirname(path), arg))
                )
            elif arg not in mat_order:
                mat_order.append(arg)
            start = i + 1
    return mtl_lib, mat_order


def load_obj(path: str, use_native: bool = True) -> Mesh:
    """OBJ loader: v/vn/f (v, v//vn, v/vt/vn), negative indices,
    usemtl/mtllib. Faces are fan-triangulated (aiProcess_Triangulate
    equivalent). Uses the C++ fast parser (native/mesh_io.cpp) when the
    toolchain is available; this Python parser is the reference fallback."""
    if use_native:
        try:
            with open(path, "rb") as f:
                raw = f.read()
            has_vt = raw.startswith(b"vt ") or b"\nvt " in raw or b"\rvt " in raw
        except OSError:
            has_vt = False
        if has_vt:
            # The C++ fast path drops vt; textured meshes take the Python
            # parser so per-corner UVs survive.
            return _load_obj_python(path)
        try:
            from ..utils.native import parse_obj_native

            res = parse_obj_native(path)
        except Exception:
            res = None
        if res is not None:
            pos, nrm_arr, fp, fn, face_mat = res
            if len(fp) == 0:
                return fallback_triangle()
            mtl_lib, mat_order = _scan_obj_materials(path)
            return _finish_obj(pos, nrm_arr, fp, fn, face_mat, mtl_lib, mat_order, path)
    return _load_obj_python(path)


def _load_obj_python(path: str) -> Mesh:
    positions: list[tuple] = []
    normals: list[tuple] = []
    uvs: list[tuple] = []
    face_pos: list[list[int]] = []
    face_nrm: list[list[int]] = []
    face_uv: list[list[int]] = []
    face_mat: list[int] = []
    mtl_lib: dict[str, Material] = {}
    mat_order: list[str] = []
    cur_mat = -1

    def resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vt":
                uvs.append(tuple(float(x) for x in parts[1:3]))
            elif tag == "mtllib" and len(parts) > 1:
                mtl_path = os.path.join(os.path.dirname(path), " ".join(parts[1:]))
                mtl_lib.update(_parse_mtl(mtl_path))
            elif tag == "usemtl" and len(parts) > 1:
                mname = parts[1]
                if mname not in mat_order:
                    mat_order.append(mname)
                cur_mat = mat_order.index(mname)
            elif tag == "f":
                vs, ns, ts = [], [], []
                for vert in parts[1:]:
                    comps = vert.split("/")
                    vs.append(resolve(int(comps[0]), len(positions)))
                    if len(comps) >= 2 and comps[1]:
                        ts.append(resolve(int(comps[1]), len(uvs)))
                    else:
                        ts.append(-1)
                    if len(comps) >= 3 and comps[2]:
                        ns.append(resolve(int(comps[2]), len(normals)))
                    else:
                        ns.append(-1)
                for i in range(1, len(vs) - 1):  # fan triangulation
                    face_pos.append([vs[0], vs[i], vs[i + 1]])
                    face_nrm.append([ns[0], ns[i], ns[i + 1]])
                    face_uv.append([ts[0], ts[i], ts[i + 1]])
                    face_mat.append(max(cur_mat, 0))

    if not face_pos:
        return fallback_triangle()

    return _finish_obj(
        np.asarray(positions, np.float32),
        np.asarray(normals, np.float32).reshape(-1, 3),
        np.asarray(face_pos, np.int32),
        np.asarray(face_nrm, np.int32),
        np.asarray(face_mat, np.int32),
        mtl_lib,
        mat_order,
        path,
        uv_arr=np.asarray(uvs, np.float32).reshape(-1, 2),
        ft=np.asarray(face_uv, np.int32),
    )


# --------------------------------------------------------------------------- #
# PLY (ascii + binary_little_endian)
# --------------------------------------------------------------------------- #
def load_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise ValueError(f"not a PLY file: {path}")
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = None
    elements = []  # (name, count, [(prop_type, prop_name) | ('list', ct, t, name)])
    for line in header[1:]:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    type_map = {
        "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
        "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
        "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
        "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    }

    verts = None
    vert_normals = None
    faces: list[list[int]] = []
    if fmt == "ascii":
        tokens = body.decode("ascii", errors="replace").split("\n")
        row = 0
        for name, count, props in elements:
            rows = tokens[row : row + count]
            row += count
            if name == "vertex":
                arr = np.array([r.split() for r in rows if r.strip()], np.float64)
                cols = [p[1] for p in props]
                xi, yi, zi = cols.index("x"), cols.index("y"), cols.index("z")
                verts = arr[:, [xi, yi, zi]].astype(np.float32)
                if "nx" in cols:
                    vert_normals = arr[
                        :, [cols.index("nx"), cols.index("ny"), cols.index("nz")]
                    ].astype(np.float32)
            elif name == "face":
                for r in rows:
                    if not r.strip():
                        continue
                    vals = [int(x) for x in r.split()]
                    n, idxs = vals[0], vals[1:]
                    for i in range(1, n - 1):
                        faces.append([idxs[0], idxs[i], idxs[i + 1]])
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] != "list" for p in props):
                dt = np.dtype([(p[1], "<" + type_map[p[0]]) for p in props])
                arr = np.frombuffer(body, dt, count=count, offset=off)
                off += dt.itemsize * count
                verts = np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=-1
                ).astype(np.float32)
                if "nx" in dt.names:
                    vert_normals = np.stack(
                        [arr["nx"], arr["ny"], arr["nz"]], axis=-1
                    ).astype(np.float32)
            elif name == "face":
                (ct, it) = (props[0][1], props[0][2])
                ct_sz = np.dtype(type_map[ct]).itemsize
                it_dt = np.dtype("<" + type_map[it])
                for _ in range(count):
                    n = int(
                        np.frombuffer(body, "<" + type_map[ct], count=1, offset=off)[0]
                    )
                    off += ct_sz
                    idxs = np.frombuffer(body, it_dt, count=n, offset=off)
                    off += it_dt.itemsize * n
                    for i in range(1, n - 1):
                        faces.append([int(idxs[0]), int(idxs[i]), int(idxs[i + 1])])
    else:
        raise ValueError(f"unsupported PLY format {fmt!r}")

    if verts is None or not faces:
        return fallback_triangle()
    return Mesh(
        verts, vert_normals, np.asarray(faces, np.int32), name=os.path.basename(path)
    )


def load_mesh(path: str, on_error: str = "fallback") -> Mesh:
    """Dispatch by extension; unknown/failed loads degrade to the fallback
    triangle like the reference (/root/reference/libs/DXRFramework/RtModel.cpp:58-68)
    when on_error='fallback', else raise."""
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".obj":
            return load_obj(path)
        if ext == ".ply":
            return load_ply(path)
        if ext in (".gltf", ".glb"):
            from .gltf import load_gltf

            return load_gltf(path)
        if ext == ".fbx":
            from .fbx import load_fbx

            return load_fbx(path)
        if ext == ".dae":
            from .collada import load_collada

            return load_collada(path)
        raise ValueError(f"unknown mesh format {ext!r}")
    except Exception:
        if on_error == "fallback":
            return fallback_triangle()
        raise
