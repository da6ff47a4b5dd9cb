"""Scene assembly: instances -> flattened device SoA + intersection precomputes.

JAX replacement for ``RtScene``/``RtModel`` + BLAS/TLAS build
(/root/reference/libs/DXRFramework/RtScene.cpp:18-52, RtModel.cpp:86-118).
Where D3D12 builds opaque driver acceleration structures, we lower the scene
to explicit arrays:

  * world-space triangle SoA (v0/e1/e2 + per-vertex normals),
  * precomputed Plücker-form Möller–Trumbore terms, which the brute-force
    intersector (ops/intersect.py) and the BVH walk both test against,
  * a stacked material table and per-triangle material ids (replacing
    per-instance SBT hit records),
  * above BVH_THRESHOLD triangles, a BVH in the walk's layout
    (accel/traverse.py),
  * lights + environment.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np

from .lights import default_lights
from .materials import Material, stack_materials
from .mesh import Mesh
from . import envmap as envmap_mod


@dataclasses.dataclass
class Instance:
    """One placed model: mesh + 3x4/4x4 transform + optional material override.

    Mirrors RtScene::Node (model + transform,
    /root/reference/libs/DXRFramework/RtScene.h:17-32) with the per-instance
    material assignment the pipelines do via SBT hit records
    (/root/reference/src/ProgressiveRaytracingPipeline.cpp:220-226).
    """

    mesh: Mesh
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    material_override: int | None = None  # global material index for all faces


# Above this triangle count a scene gets a BVH. On an H100 (700 W), one
# 512x512 progressive sample of the instanced:K sphere grid took 38.6 / 73.8
# ms brute force and 56.6 / 68.6 ms through the walk at 3,842 / 8,642
# triangles (benchmarks/gpu_constants.py): brute force grows linearly, the
# walk slowly, and the two lines cross near 7,600 triangles.
BVH_THRESHOLD = 7500
# Triangles per BVH leaf (the walk tests a whole leaf at once). Leaves of 4,
# 8 and 16 gave 250, 286 and 311 ms per 512x512 sample of the 983k-triangle
# instanced:32 scene on an H100 (700 W).
BVH_LEAF_SIZE = 4


class Scene:
    """Host-side scene graph; ``build()`` lowers to the device pytree."""

    def __init__(self):
        self.instances: list[Instance] = []
        self.materials: list[Material] = []
        self.lights: dict | None = None
        self.environment: dict | None = None

    # -- assembly -------------------------------------------------------- #
    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_model(
        self,
        mesh: Mesh,
        transform: np.ndarray | None = None,
        material: int | Material | None = None,
    ) -> int:
        """Add an instance. `material` may be a global material index or a
        Material (auto-registered); None uses the mesh's own materials."""
        t = np.eye(4, dtype=np.float32) if transform is None else np.asarray(
            transform, np.float32
        )
        if t.shape == (3, 4):
            t = np.concatenate([t, [[0, 0, 0, 1]]], axis=0).astype(np.float32)
        override: int | None
        if isinstance(material, Material):
            override = self.add_material(material)
        else:
            override = material
        self.instances.append(Instance(mesh, t, override))
        return len(self.instances) - 1

    @property
    def num_instances(self) -> int:
        return len(self.instances)

    # -- lowering ---------------------------------------------------------- #
    def build(self, accel: str = "auto") -> dict[str, Any]:
        """Flatten all instances into world space and precompute intersection
        terms. Returns the SceneData pytree (all jnp arrays).

        accel: 'auto' attaches a BVH (native SAH if available, else the
        Morton build) when the scene exceeds BVH_THRESHOLD triangles — the
        analogue of the reference's BLAS/TLAS build step
        (/root/reference/libs/DXRFramework/RtScene.cpp:18-52); 'bvh' forces
        it; 'none' keeps the brute-force-only scene."""
        v0s, e1s, e2s = [], [], []
        n0s, n1s, n2s = [], [], []
        uvcs = []
        mat_ids = []
        inst_ids = []
        mat_offset_for_mesh: dict[int, int] = {}

        materials = list(self.materials)

        for inst_idx, inst in enumerate(self.instances):
            mesh = inst.mesh
            m = inst.transform
            rot = m[:3, :3]
            trans = m[:3, 3]
            # normal matrix = inverse-transpose of rotation part
            nrm_m = np.linalg.inv(rot).T if abs(np.linalg.det(rot)) > 1e-12 else rot

            pos = mesh.positions @ rot.T + trans
            nrm = mesh.normals @ nrm_m.T
            nl = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.where(nl > 1e-12, nl, 1.0)

            tri = mesh.indices
            p0, p1, p2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
            v0s.append(p0)
            e1s.append(p1 - p0)
            e2s.append(p2 - p0)
            n0s.append(nrm[tri[:, 0]])
            n1s.append(nrm[tri[:, 1]])
            n2s.append(nrm[tri[:, 2]])
            uvcs.append(
                mesh.uv_corners
                if mesh.uv_corners is not None
                else np.zeros((len(tri), 3, 2), np.float32)
            )

            if inst.material_override is not None:
                ids = np.full(len(tri), inst.material_override, np.int32)
            elif mesh.materials:
                key = id(mesh)
                if key not in mat_offset_for_mesh:
                    mat_offset_for_mesh[key] = len(materials)
                    materials.extend(mesh.materials)
                ids = mesh.material_ids + mat_offset_for_mesh[key]
            else:
                # Mesh faces index the scene-global material table directly
                # (e.g. procedural scenes registering materials up front).
                ids = np.clip(mesh.material_ids, 0, max(len(materials) - 1, 0))
            mat_ids.append(ids)
            inst_ids.append(np.full(len(tri), inst_idx, np.int32))

        if not materials:
            materials = [Material()]

        if v0s:
            v0 = np.concatenate(v0s).astype(np.float32)
            e1 = np.concatenate(e1s).astype(np.float32)
            e2 = np.concatenate(e2s).astype(np.float32)
            n0 = np.concatenate(n0s).astype(np.float32)
            n1 = np.concatenate(n1s).astype(np.float32)
            n2 = np.concatenate(n2s).astype(np.float32)
            mid = np.concatenate(mat_ids).astype(np.int32)
            iid = np.concatenate(inst_ids).astype(np.int32)
        else:
            v0 = e1 = e2 = n0 = n1 = n2 = np.zeros((0, 3), np.float32)
            mid = iid = np.zeros((0,), np.int32)

        num_tris = len(v0)

        # Plücker / scalar-triple-product precomputes (see ops/intersect.py):
        #   det = -(D . pn)            pn = e1 x e2  (unnormalized face normal)
        #   u*det =  M . e2 + D . c1   M  = O x D,  c1 = v0 x e2
        #   v*det = -M . e1 - D . c2   c2 = v0 x e1
        #   t*det =  O . pn - d0       d0 = v0 . pn
        pn = np.cross(e1, e2)
        c1 = np.cross(v0, e2)
        c2 = np.cross(v0, e1)
        d0 = np.sum(v0 * pn, axis=-1)

        lights = self.lights if self.lights is not None else default_lights()
        env = (
            self.environment
            if self.environment is not None
            else envmap_mod.constant_env((0.0, 0.0, 0.0))
        )

        mats = stack_materials(materials)
        scene_dict = {
            "v0": jnp.asarray(v0),
            "e1": jnp.asarray(e1),
            "e2": jnp.asarray(e2),
            "n0": jnp.asarray(n0),
            "n1": jnp.asarray(n1),
            "n2": jnp.asarray(n2),
            "pn": jnp.asarray(pn.astype(np.float32)),
            "c1": jnp.asarray(c1.astype(np.float32)),
            "c2": jnp.asarray(c2.astype(np.float32)),
            "d0": jnp.asarray(d0.astype(np.float32)),
            "mat_id": jnp.asarray(mid),
            "inst_id": jnp.asarray(iid),
            "num_tris": jnp.asarray(num_tris, jnp.int32),
            "materials": mats,
            "lights": lights,
            "env": env,
        }

        # Albedo textures (scene.textures): only attach the table + per-
        # corner UVs when some material is textured.
        from .textures import pack_texture_table

        textures = pack_texture_table(materials)
        if textures is not None:
            uvc = (
                np.concatenate(uvcs).astype(np.float32)
                if uvcs
                else np.zeros((0, 3, 2), np.float32)
            )
            scene_dict["textures"] = textures
            scene_dict["uv0"] = jnp.asarray(uvc[:, 0])
            scene_dict["uv1"] = jnp.asarray(uvc[:, 1])
            scene_dict["uv2"] = jnp.asarray(uvc[:, 2])

        want_bvh = accel == "bvh" or (accel == "auto" and num_tris > BVH_THRESHOLD)
        if want_bvh and num_tris > 0:
            from ..accel import bvh as bvh_mod
            from ..accel.traverse import pack_bvh

            nodes = bvh_mod.build_bvh_sah(v0, e1, e2, num_tris, BVH_LEAF_SIZE)
            if nodes is None:  # no native toolchain -> Morton build
                nodes = bvh_mod.to_node_arrays(
                    bvh_mod.build_bvh(v0, e1, e2, num_tris, BVH_LEAF_SIZE)
                )
            packed, _ = pack_bvh(nodes, v0, e1, e2, BVH_LEAF_SIZE)
            scene_dict["bvh"] = {k: jnp.asarray(v) for k, v in packed.items()}

        return scene_dict


    # -- two-level lowering ------------------------------------------------ #
    def build_two_level(self) -> dict[str, Any]:
        """Lower to the two-level TLAS/BLAS pytree (accel/tlas.py): one
        object-space BLAS per UNIQUE mesh (shared by all its instances), a
        refittable TLAS over instance AABBs, per-instance inverse transforms.

        The analogue of the reference's real TLAS build
        (/root/reference/libs/DXRFramework/RtScene.cpp:27-51) — unlike
        ``build()``, geometry is NOT flattened per instance, so memory is
        O(unique geometry) and animating transforms is a pure TLAS refit
        (scene/dynamic.py:refit_scene_instances).
        """
        from ..accel import tlas as tlas_mod

        materials = list(self.materials)
        mat_offset_for_mesh: dict[int, int] = {}
        mesh_index: dict[int, int] = {}
        meshes_geo = []  # (v0, e1, e2) per unique mesh
        mesh_attr = []  # (n0, n1, n2, mat_id, uv_corners) per unique mesh
        inst_mesh = np.zeros((len(self.instances),), np.int64)
        transforms = np.zeros((len(self.instances), 4, 4), np.float32)
        overrides = np.full((len(self.instances),), -1, np.int64)

        for inst_idx, inst in enumerate(self.instances):
            mesh = inst.mesh
            key = id(mesh)
            if key not in mesh_index:
                mesh_index[key] = len(meshes_geo)
                tri = mesh.indices
                p0 = mesh.positions[tri[:, 0]]
                p1 = mesh.positions[tri[:, 1]]
                p2 = mesh.positions[tri[:, 2]]
                if mesh.materials:
                    if key not in mat_offset_for_mesh:
                        mat_offset_for_mesh[key] = len(materials)
                        materials.extend(mesh.materials)
                    mid = mesh.material_ids + mat_offset_for_mesh[key]
                else:
                    mid = np.clip(
                        mesh.material_ids, 0, max(len(materials) - 1, 0)
                    )
                meshes_geo.append(
                    (
                        p0.astype(np.float32),
                        (p1 - p0).astype(np.float32),
                        (p2 - p0).astype(np.float32),
                    )
                )
                mesh_attr.append(
                    (
                        mesh.normals[tri[:, 0]].astype(np.float32),
                        mesh.normals[tri[:, 1]].astype(np.float32),
                        mesh.normals[tri[:, 2]].astype(np.float32),
                        mid.astype(np.int32),
                        mesh.uv_corners
                        if mesh.uv_corners is not None
                        else np.zeros((len(tri), 3, 2), np.float32),
                    )
                )
            inst_mesh[inst_idx] = mesh_index[key]
            transforms[inst_idx] = inst.transform
            if inst.material_override is not None:
                overrides[inst_idx] = inst.material_override

        if not materials:
            materials = [Material()]
        if not meshes_geo:
            raise ValueError("two-level build requires at least one instance")

        tl, ctx = tlas_mod.build_two_level(
            meshes_geo, inst_mesh, transforms, overrides,
            leaf_size=BVH_LEAF_SIZE,
        )

        # Concatenated object-space attribute / oracle arrays.
        v0 = np.concatenate([g[0] for g in meshes_geo])
        e1 = np.concatenate([g[1] for g in meshes_geo])
        e2 = np.concatenate([g[2] for g in meshes_geo])
        pn = np.cross(e1, e2)
        c1 = np.cross(v0, e2)
        c2 = np.cross(v0, e1)
        d0 = np.sum(v0 * pn, axis=-1)
        n0 = np.concatenate([a[0] for a in mesh_attr])
        n1 = np.concatenate([a[1] for a in mesh_attr])
        n2 = np.concatenate([a[2] for a in mesh_attr])
        mid = np.concatenate([a[3] for a in mesh_attr])

        ranges = []
        base = 0
        for g in meshes_geo:
            ranges.append((base, base + len(g[0])))
            base += len(g[0])

        num_tris = int(
            sum(len(meshes_geo[int(m)][0]) for m in inst_mesh)
        )
        lights = self.lights if self.lights is not None else default_lights()
        env = (
            self.environment
            if self.environment is not None
            else envmap_mod.constant_env((0.0, 0.0, 0.0))
        )
        out = {
            "tlas": tl,
            "tlas_meta": tlas_mod.HostStatic({
                "num_instances": ctx.num_instances,
                "slot_mesh": inst_mesh[ctx.inst_order].astype(np.int32),
                "mesh_tri_ranges": ranges,
                "refit_ctx": ctx,
            }),
            "v0_obj": jnp.asarray(v0.astype(np.float32)),
            "e1_obj": jnp.asarray(e1.astype(np.float32)),
            "e2_obj": jnp.asarray(e2.astype(np.float32)),
            "pn_obj": jnp.asarray(pn.astype(np.float32)),
            "c1_obj": jnp.asarray(c1.astype(np.float32)),
            "c2_obj": jnp.asarray(c2.astype(np.float32)),
            "d0_obj": jnp.asarray(d0.astype(np.float32)),
            "n0_obj": jnp.asarray(n0),
            "n1_obj": jnp.asarray(n1),
            "n2_obj": jnp.asarray(n2),
            "mat_id_obj": jnp.asarray(mid),
            "materials": stack_materials(materials),
            "lights": lights,
            "env": env,
            "num_tris": jnp.asarray(num_tris, jnp.int32),
        }
        from .textures import pack_texture_table

        textures = pack_texture_table(materials)
        if textures is not None:
            uvc = np.concatenate([a[4] for a in mesh_attr]).astype(np.float32)
            out["textures"] = textures
            out["uv0_obj"] = jnp.asarray(uvc[:, 0])
            out["uv1_obj"] = jnp.asarray(uvc[:, 1])
            out["uv2_obj"] = jnp.asarray(uvc[:, 2])
        return out


def rebake_material(scene: dict, index: int, material: Material) -> dict:
    """Return a scene pytree with material `index` replaced.

    The live material-editing path (parity with the reference's imgui
    material sliders + frameDirty accumulation restart,
    /root/reference/src/ProgressiveRaytracingPipeline.cpp:253-267,309-311):
    updates the stacked material table; per-triangle material ids are
    unchanged. Pipelines whose compiled steps bake geometry as constants
    recompile on the new identity — the analogue of the SBT rewrite the
    reference performs each frame.
    """
    m = stack_materials([material])
    mats = {k: scene["materials"][k].at[index].set(m[k][0]) for k in m}
    return dict(scene, materials=mats)
