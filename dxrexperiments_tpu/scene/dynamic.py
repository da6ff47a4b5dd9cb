"""Dynamic instancing: device-side scene re-baking.

The reference updates instance transforms by rebuilding the TLAS on the GPU
(/root/reference/libs/DXRFramework/Helpers/TopLevelASGenerator.cpp). Here a
jitted re-bake turns (base-mesh arrays, per-instance transforms) into the
flattened world-space scene arrays entirely ON DEVICE — no host round trip
per frame. For animated transforms:

    base = prepare_base(scene_data_of_base_mesh, num_instances)
    scene_t = bake_instances(base, transforms_t, materials_override)
    # render scene_t with the normal pipelines (brute force), or rebuild a
    # device BVH with accel.bvh.build_bvh_device for big scenes.

Composable with build_bvh_device for per-frame acceleration rebuilds of
deforming/instanced geometry.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def refit_scene_instances(scene: dict, transforms) -> dict:
    """Per-frame animation for TWO-LEVEL scenes (Scene.build_two_level):
    recompute the TLAS boxes + instance inverse/normal matrices for new
    [I, 4, 4] transforms — O(instances) device work, no triangle re-bake, no
    BVH rebuild. The analogue of a D3D12 TLAS update-build
    (/root/reference/Helpers/TopLevelASGenerator.cpp:85-203 with
    PERFORM_UPDATE). Pass the result's geometry as the step's geo_arg
    (make_render_step, make_progressive_step): the refitted arrays flow as
    jit arguments, with no recompile per frame."""
    from ..accel import tlas as tlas_mod

    ctx = scene["tlas_meta"].value["refit_ctx"]
    dyn = tlas_mod.refit_instances_arrays(ctx, transforms)
    return dict(scene, tlas=dict(scene["tlas"], **dyn))


def prepare_base(base_scene: dict, num_instances: int) -> dict:
    """Static inputs for the jitted bake: the base mesh's object-space arrays
    (from Scene.build of the base mesh alone) + instance count."""
    keys = ("v0", "e1", "e2", "n0", "n1", "n2", "mat_id")
    return {
        "mesh": {k: base_scene[k] for k in keys},
        "materials": base_scene["materials"],
        "num_instances": num_instances,
        "num_base_tris": int(base_scene["num_tris"]),
    }


@functools.partial(jax.jit, static_argnames=("num_instances",))
def _bake(mesh: dict, materials: dict, transforms: jnp.ndarray,
          mat_override: jnp.ndarray, num_instances: int) -> dict:
    """transforms: [I, 4, 4]; mat_override: [I] int32 (-1 = keep mesh ids).
    Returns the flattened scene geometry arrays (T = I * T_base)."""
    rot = transforms[:, :3, :3]  # [I, 3, 3]
    trans = transforms[:, :3, 3]  # [I, 3]
    inv_rot_t = jnp.transpose(jnp.linalg.inv(rot), (0, 2, 1))  # normal matrices
    # HIGHEST: f32 products (no TF32) for world-space geometry.
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    def one(i):
        r, t = rot[i], trans[i]
        v0 = mm(mesh["v0"], r.T) + t
        p1 = mm(mesh["v0"] + mesh["e1"], r.T) + t
        p2 = mm(mesh["v0"] + mesh["e2"], r.T) + t
        nm = inv_rot_t[i]

        def nrm(n):
            out = mm(n, nm.T)
            l2 = jnp.sum(out * out, axis=-1, keepdims=True)
            return out * jax.lax.rsqrt(jnp.maximum(l2, 1e-24))

        mid = jnp.where(mat_override[i] >= 0, mat_override[i], mesh["mat_id"])
        return {
            "v0": v0, "e1": p1 - v0, "e2": p2 - v0,
            "n0": nrm(mesh["n0"]), "n1": nrm(mesh["n1"]), "n2": nrm(mesh["n2"]),
            "mat_id": mid,
        }

    stacked = jax.vmap(one)(jnp.arange(num_instances))
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in stacked.items()}

    v0, e1, e2 = flat["v0"], flat["e1"], flat["e2"]
    pn = jnp.cross(e1, e2)
    c1 = jnp.cross(v0, e2)
    c2 = jnp.cross(v0, e1)
    d0 = jnp.sum(v0 * pn, axis=-1)

    t_total = v0.shape[0]

    return dict(
        flat,
        pn=pn, c1=c1, c2=c2, d0=d0,
        num_tris=jnp.asarray(t_total, jnp.int32),
        inst_id=jnp.repeat(
            jnp.arange(num_instances, dtype=jnp.int32), t_total // num_instances
        ),
    )


def bake_instances(
    base: dict,
    transforms: jnp.ndarray,
    mat_override: jnp.ndarray | None = None,
    lights: dict | None = None,
    env: dict | None = None,
) -> dict:
    """Re-bake the instanced scene on device. The result renders through the
    normal pipelines (brute-force path; compose with build_bvh_device for a
    per-frame BVH)."""
    i = base["num_instances"]
    if mat_override is None:
        mat_override = jnp.full((i,), -1, jnp.int32)
    scene = _bake(base["mesh"], base["materials"], transforms, mat_override, i)
    scene["materials"] = base["materials"]
    if lights is not None:
        scene["lights"] = lights
    if env is not None:
        scene["env"] = env
    return scene
