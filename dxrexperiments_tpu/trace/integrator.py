"""Wavefront integrator: the JAX re-expression of the reference's device code.

Replaces the DXR shader stack — RayGen/ClosestHit/Miss/shadow shaders plus
``TraceRay`` recursion (/root/reference/assets/shaders/ProgressiveRaytracing.hlsl,
RealtimeRaytracing.hlsl, RaytracingCommon.hlsli) — with a statically-unrolled
trace tree inside one jitted function. The reference's recursion is bounded
(MAX_RADIANCE_RAY_DEPTH=1, MAX_SHADOW_RAY_DEPTH=2,
RaytracingCommon.hlsli:11-12), so the whole per-sample ray tree is fixed:

    primary closest-hit
      +- directional-light shadow ray      (any-hit)
      +- point-light shadow ray            (any-hit)
      +- indirect-diffuse secondary ray    (closest, progressive only)
      |    +- 2 shadow rays at depth 1
      +- Phong-lobe specular secondary ray (closest)
           +- 2 shadow rays at depth 1

i.e. 3 closest + 6 any-hit traces per progressive sample (2+4 realtime) over
dense [N]-ray batches — no dynamic control flow, no compaction needed at this
depth, everything fuses under jit.

RNG parity: each shade invocation re-seeds from the pixel hash exactly like
the HLSL (shade() calls initRand every invocation —
ProgressiveRaytracing.hlsl:87-89 — so depth-1 draws alias depth-0 draws; we
reproduce that faithfully), and seeds advance conditionally where the HLSL
consumes draws inside branches (debug==2 light picking, noIndirectDiffuse).

Material/AOV debug selection is traced (cheap selects); ambient-occlusion-only
mode is a static variant (it changes the ray tree), the analogue of compiling
a different RTPSO.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core import rng
from ..core import vecmath as vm
from ..accel import traverse
from ..ops import intersect
from ..scene.envmap import sample_environment
from . import sampling

RAY_EPSILON = intersect.RAY_EPSILON
RAY_MAX_T = intersect.RAY_MAX_T
M_PI = jnp.pi


# --------------------------------------------------------------------------- #
# Per-frame options (traced) — parity with DebugOptions
# (/root/reference/assets/shaders/RaytracingHlslCompat.h:64-77). Defaults match
# the pipeline ctor (/root/reference/src/ProgressiveRaytracingPipeline.cpp:74-84).
# --------------------------------------------------------------------------- #
def default_options(**overrides) -> dict:
    opts = {
        "max_iterations": jnp.asarray(1024, jnp.int32),
        "cosine_hemisphere_sampling": jnp.asarray(True),
        "show_indirect_diffuse_only": jnp.asarray(False),
        "show_indirect_specular_only": jnp.asarray(False),
        "show_gbuffer_albedo_only": jnp.asarray(False),
        "show_direct_lighting_only": jnp.asarray(False),
        "show_fresnel_term": jnp.asarray(False),
        "no_indirect_diffuse": jnp.asarray(False),
        "debug": jnp.asarray(0, jnp.int32),
    }
    for k, v in overrides.items():
        opts[k] = jnp.asarray(v, opts[k].dtype) if k in opts else jnp.asarray(v)
    return opts


def _trace_closest(scene, origins, directions, t_min, t_max, cull):
    """Closest hit + hit attributes: returns (hit, position, normal, mat)
    where mat is the per-ray material field dict.

    Two-level scenes walk their TLAS/BLAS, scenes with a BVH walk it
    (accel/traverse.py), and small scenes test every triangle
    (ops/intersect.py)."""
    if "tlas" in scene:
        # Two-level TLAS/BLAS scene (accel/tlas.py): shared per-mesh BLAS +
        # instance transforms — the true RtScene analogue
        # (/root/reference/libs/DXRFramework/RtScene.cpp:27-51).
        hits = traverse.two_level_closest(
            scene["tlas"], origins, directions, t_min, t_max,
            cull_backface=cull,
        )
        position, normal, mat = _interpolate_hit_two_level(
            scene, hits, origins, directions
        )
        return hits["hit"], position, normal, mat
    if "bvh" in scene:
        hits = traverse.closest(
            scene["bvh"], origins, directions, t_min, t_max,
            cull_backface=cull,
        )
    else:
        hits = intersect.intersect_closest(
            scene, origins, directions, t_min, t_max, cull_backface=cull
        )
    position, normal, mat = _interpolate_hit(scene, hits, origins, directions)
    return hits["hit"], position, normal, mat


def _trace_any(scene, origins, directions, t_min, t_max):
    """Occlusion along each ray segment, routed like _trace_closest."""
    if "tlas" in scene:
        return traverse.two_level_any(
            scene["tlas"], origins, directions, t_min, t_max
        )
    if "bvh" in scene:
        return traverse.any_hit(scene["bvh"], origins, directions, t_min, t_max)
    return intersect.intersect_any(scene, origins, directions, t_min, t_max)


def _gather_material(materials: dict, mat_id: jnp.ndarray) -> dict:
    return {k: v[mat_id] for k, v in materials.items()}


def _interpolate_hit_two_level(scene: dict, hits: dict, origins, directions):
    """Attribute interpolation for two-level hits: barycentrics over the
    OBJECT-space vertex normals, then the per-instance normal matrix
    (inv(R)^T, accel/tlas.py) back to world; material id comes from the mesh
    unless the instance carries an override — the SBT-hit-record analogue
    (/root/reference/src/ProgressiveRaytracingPipeline.cpp:220-226)."""
    tri = jnp.maximum(hits["tri"], 0)
    inst = jnp.maximum(hits["inst"], 0)
    u, v = hits["u"], hits["v"]
    w = 1.0 - u - v
    n_obj = (
        w[..., None] * scene["n0_obj"][tri]
        + u[..., None] * scene["n1_obj"][tri]
        + v[..., None] * scene["n2_obj"][tri]
    )
    nm = scene["tlas"]["inst_nm"][inst]  # [N, 3, 3]
    # HIGHEST: normals feed shading directly; keep the product in f32.
    normal = vm.normalize(jnp.einsum(
        "nij,nj->ni", nm, n_obj, precision=jax.lax.Precision.HIGHEST))
    position = origins + hits["t"][..., None] * directions
    override = scene["tlas"]["inst_mat_override"][inst]
    mid = jnp.where(override >= 0, override, scene["mat_id_obj"][tri])
    mat = _gather_material(scene["materials"], mid)
    if "textures" in scene:
        from ..scene.textures import sample_albedo

        uv = (
            w[..., None] * scene["uv0_obj"][tri]
            + u[..., None] * scene["uv1_obj"][tri]
            + v[..., None] * scene["uv2_obj"][tri]
        )
        mat["albedo"] = mat["albedo"] * sample_albedo(
            scene["textures"], mid, uv
        )
    return position, normal, mat


def _interpolate_hit(scene: dict, hits: dict, origins, directions):
    """Barycentric position/normal + material fetch — the analogue of
    interpolateVertexAttributes + HitWorldPosition
    (RaytracingCommon.hlsli:53-82, RaytracingUtils.hlsli:209-212)."""
    tri = jnp.maximum(hits["tri"], 0)
    u, v = hits["u"], hits["v"]
    w = 1.0 - u - v
    n = (
        w[..., None] * scene["n0"][tri]
        + u[..., None] * scene["n1"][tri]
        + v[..., None] * scene["n2"][tri]
    )
    normal = vm.normalize(n)
    position = origins + hits["t"][..., None] * directions
    mid = scene["mat_id"][tri]
    mat = _gather_material(scene["materials"], mid)
    if "textures" in scene:
        # Albedo texture modulation (scene/textures.py): one quad-packed
        # gather per hit; BEYOND-reference (DXR materials are constants).
        from ..scene.textures import sample_albedo

        uv = (
            w[..., None] * scene["uv0"][tri]
            + u[..., None] * scene["uv1"][tri]
            + v[..., None] * scene["uv2"][tri]
        )
        mat["albedo"] = mat["albedo"] * sample_albedo(
            scene["textures"], mid, uv
        )
    return position, normal, mat


# --------------------------------------------------------------------------- #
# Lights (RaytracingCommon.hlsli:126-147)
# --------------------------------------------------------------------------- #
# Stratified area-light sample count (scene/lights.py).
from ..scene.lights import AREA_LIGHT_SAMPLES  # noqa: E402  (re-export)


def _direct_lighting(scene, options, position, normal, seed, active):
    """Direct term over an ARBITRARY light rig (D directional + P point +
    A area, stacked arrays — see scene.lights.normalize_lights; the
    reference's fixed 1+1 rig is the D=P=1, A=0 case and reproduces it
    lane-for-lane), including the debug==2 one-of-L-lights MC estimator
    (ProgressiveRaytracing.hlsl:92-104 generalised: pick uniformly, scale by
    L; at L=2 the selection and weights match the HLSL bit-exactly).
    Returns (seed, direct [N,3]).

    Area lights (BEYOND-reference, BASELINE config 2) draw
    AREA_LIGHT_SAMPLES stratified points on the emitting quad from a
    DECOUPLED TEA seed (so adding an area light leaves the reference-parity
    draw sequence untouched) and estimate soft-shadowed irradiance
    L * mean_j(NoL * cos_l * area / dist_j^2 * vis_j).

    ALL lights' shadow rays — including every area sample — are batched into
    ONE any-hit trace (the DXR version issues one TraceRay per light; one
    batched trace keeps the launch count constant in L and S)."""
    from ..scene.lights import normalize_lights

    lights = normalize_lights(scene["lights"])
    dl, pl_, al = lights["dir"], lights["point"], lights["area"]
    d_count = int(dl["forward"].shape[0])
    p_count = int(pl_["position"].shape[0])
    a_count = int(al["corner"].shape[0])
    l_count = d_count + p_count + a_count
    n = position.shape[0]

    if l_count == 0:
        return seed, jnp.zeros_like(position)

    seed_mc, pick = rng.next_rand(seed)
    is_mc = options["debug"] == 2
    # HLSL consumes the picking draw only when debug==2.
    seed_out = jnp.where(is_mc, seed_mc, seed)

    dirs = []
    t_maxs = []
    if d_count:
        # identical op order to the 1-light path: normalize(-forward)
        l_dir = jnp.broadcast_to(
            vm.normalize(-dl["forward"])[:, None, :], (d_count, n, 3)
        )
        dirs.append(l_dir)
        t_maxs.append(jnp.full((d_count, n), RAY_MAX_T, jnp.float32))
    if p_count:
        path = pl_["position"][:, None, :] - position[None]  # [P, N, 3]
        dist = vm.length(path)
        dirs.append(vm.normalize(path))
        t_maxs.append(jnp.maximum(dist - RAY_EPSILON, RAY_EPSILON))
    if a_count:
        from ..scene.lights import area_light_draws

        a_dist2 = []
        for r0, r1 in area_light_draws(seed):
            # [A, N, 3] sample points on each quad
            p_l = (
                al["corner"][:, None, :]
                + r0[None, :, None] * al["eu"][:, None, :]
                + r1[None, :, None] * al["ev"][:, None, :]
            )
            apath = p_l - position[None]
            adist = vm.length(apath)
            dirs.append(vm.normalize(apath))
            t_maxs.append(jnp.maximum(adist - RAY_EPSILON, RAY_EPSILON))
            a_dist2.append(jnp.maximum(adist * adist, 1e-12))

    # One shadow ray per dir/point light, AREA_LIGHT_SAMPLES per area light.
    r_count = d_count + p_count + a_count * AREA_LIGHT_SAMPLES
    all_dirs = jnp.concatenate(dirs).reshape(r_count * n, 3)
    all_tmax = jnp.concatenate(t_maxs).reshape(r_count * n)
    # Zero the direction of inactive lanes (their `vis` is masked below):
    # the BVH walk starts such rays with an empty stack, so garbage origins
    # never traverse.
    act = jnp.broadcast_to(active[None], (r_count, n)).reshape(-1, 1)
    all_dirs = jnp.where(act, all_dirs, 0.0)
    occ = _trace_any(
        scene,
        jnp.broadcast_to(position[None], (r_count, n, 3)).reshape(-1, 3),
        all_dirs,
        RAY_EPSILON,
        all_tmax,
    ).reshape(r_count, n)
    vis = jnp.where(active[None] & ~occ, 1.0, 0.0)

    contribs = []
    if d_count:
        l_dir = dirs[0]
        nol = vm.saturate(vm.dot(normal[None], l_dir))
        contribs.append(
            (dl["color"] * dl["intensity"][:, None])[:, None, :]
            * (nol * vis[:d_count])[..., None]
        )
    if p_count:
        l_pnt = dirs[1 if d_count else 0]
        nol = vm.saturate(vm.dot(normal[None], l_pnt))
        falloff = 1.0 / (2.0 * M_PI * jnp.maximum(dist * dist, 1e-12))
        contribs.append(
            (pl_["color"] * pl_["intensity"][:, None])[:, None, :]
            * (nol * vis[d_count : d_count + p_count] * falloff)[..., None]
        )
    if a_count:
        s_total = AREA_LIGHT_SAMPLES
        cross = jnp.cross(al["eu"], al["ev"])  # [A, 3]
        quad_area = vm.length(cross)  # [A]
        n_l = cross / jnp.maximum(quad_area, 1e-12)[:, None]
        base = d_count + p_count
        geo = jnp.zeros((a_count, n), jnp.float32)
        for j in range(s_total):
            wi = dirs[(1 if d_count else 0) + (1 if p_count else 0) + j]
            nol = vm.saturate(vm.dot(normal[None], wi))
            # emits from BOTH faces of the quad (|cos| at the light)
            cos_l = jnp.abs(vm.dot(n_l[:, None, :], wi))
            geo = geo + (
                nol * cos_l / a_dist2[j]
                * vis[base + j * a_count : base + (j + 1) * a_count]
            )
        geo = geo * (quad_area / s_total)[:, None]
        contribs.append(
            (al["color"] * al["intensity"][:, None])[:, None, :]
            * geo[..., None]
        )
    per_light = jnp.concatenate(contribs)  # [L, N, 3]

    full = jnp.sum(per_light, axis=0)
    idx = jnp.minimum((pick * l_count).astype(jnp.int32), l_count - 1)
    sel = (jnp.arange(l_count)[:, None] == idx[None]).astype(jnp.float32)
    mc = jnp.sum(per_light * sel[..., None], axis=0) * float(l_count)
    return seed_out, jnp.where(is_mc, mc, full)


def _ambient_occlusion(scene, options, position, normal, seed, active):
    """4-ray AO (evaluateAO, RaytracingCommon.hlsli:98-124)."""
    visibility = jnp.zeros(position.shape[:-1], jnp.float32)
    cosine = options["cosine_hemisphere_sampling"]
    for _ in range(4):
        seed, r0, r1 = rng.next_rand2(seed)
        # Rebuild both sampler outputs from the same draws, select traced.
        tangent, bitangent = vm.orthonormal_basis(normal)
        r = jnp.sqrt(r0)
        phi = 2.0 * M_PI * r1
        cos_dir = (
            (r * jnp.cos(phi))[..., None] * tangent
            + jnp.sqrt(jnp.maximum(1.0 - r0, 0.0))[..., None] * normal
            + (r * jnp.sin(phi))[..., None] * bitangent
        )
        sin_t = jnp.sqrt(jnp.maximum(1.0 - r0 * r0, 0.0))
        uni_dir = (
            (sin_t * jnp.cos(phi))[..., None] * tangent
            + r0[..., None] * normal
            + (sin_t * jnp.sin(phi))[..., None] * bitangent
        )
        sample_dir = jnp.where(cosine, cos_dir, uni_dir)
        nol = vm.saturate(vm.dot(normal, sample_dir))
        pdf = jnp.where(cosine, nol / M_PI, 1.0 / (2.0 * M_PI))
        traced_dir = jnp.where(active[..., None], sample_dir, 0.0)
        occluded = _trace_any(scene, position, traced_dir, RAY_EPSILON, 10.0)
        vis = jnp.where(active & ~occluded, 1.0, 0.0)
        visibility += vis * nol / jnp.maximum(pdf, 1e-8)
    return visibility / 4.0


# --------------------------------------------------------------------------- #
# Depth-1 (secondary) radiance: direct lighting + emissive only — specular
# and indirect cut off by MAX_RADIANCE_RAY_DEPTH
# (ProgressiveRaytracing.hlsl:41-55 via shade() at depth 1).
# --------------------------------------------------------------------------- #
def _secondary_radiance(
    scene, options, origins, directions, seeds, active, mode: str,
    env_kind: int | None = None,
):
    # Inactive lanes (primary misses, non-specular materials) carry garbage
    # origins — often (0,0,0), INSIDE the scene — and every return field is
    # masked below, so collapse their ray interval to empty (t_max = 0 <
    # t_min): the BVH walk then starts them with an empty stack.
    t_max_eff = jnp.where(active, RAY_MAX_T, 0.0)
    is_hit, position, normal, mat = _trace_closest(
        scene, origins, directions, RAY_EPSILON, t_max_eff, cull=False
    )
    hit = is_hit & active
    # Env contributes only where an ACTIVE lane MISSED
    # (ProgressiveRaytracing.hlsl:160-164).
    env_col = sample_environment(scene["env"], directions, env_kind)
    env_term = jnp.where(active[..., None], env_col, 0.0)

    seed = seeds  # shade() re-seeds identically per invocation
    seed, direct = _direct_lighting(scene, options, position, normal, seed, hit)

    if mode == "progressive":
        # emissive + albedo * direct / pi  (ProgressiveRaytracing.hlsl:112,147)
        shade_col = (
            mat["emissive"] * mat["emissive_strength"][..., None]
            + mat["albedo"] * direct / M_PI
        )
    else:
        # realtime: albedo * direct / pi (RealtimeRaytracing.hlsl:102)
        shade_col = mat["albedo"] * direct / M_PI

    return jnp.where(hit[..., None], shade_col, env_term)


# --------------------------------------------------------------------------- #
# Primary shade (depth 0)
# --------------------------------------------------------------------------- #
def trace_rays(
    scene: dict,
    options: dict,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    seeds: jnp.ndarray,
    mode: str = "progressive",
    ao_only: bool = False,
    env_kind: int | None = None,
    refraction: bool = False,
) -> dict:
    """Trace one sample for a dense batch of primary rays.

    origins/directions: [N, 3]; seeds: [N] uint32 (pixel hash for this frame).
    mode: 'progressive' (ProgressiveRaytracing.hlsl) or 'realtime'
    (RealtimeRaytracing.hlsl). ao_only statically switches to the AO view
    (showAmbientOcclusionOnly, ProgressiveRaytracing.hlsl:82-84).

    refraction (progressive; BEYOND-reference, opt-in): glass materials
    (type 2) additionally trace a TRANSMISSION bounce through vm.refract —
    the utility the reference ships but never calls
    (/root/reference/assets/shaders/RaytracingUtils.hlsli:141-165; its glass
    only reflects) — weighted reflectivity * (1 - fresnel); total internal
    reflection lanes contribute nothing (the reflect branch already carries
    them). Default off = exact reference parity.

    Returns {"color" [N,3]} plus, for realtime mode, "direct" and
    "indirect_specular" AOVs (the two UAV outputs,
    RealtimeRaytracing.hlsl:44-45).
    """
    # Primary rays cull backfaces (ProgressiveRaytracing.hlsl:34).
    hit, position, normal, mat = _trace_closest(
        scene, origins, directions, 0.0, RAY_MAX_T, cull=True
    )
    # env_col is consumed only under ~hit (miss shader semantics).
    env_col = sample_environment(scene["env"], directions, env_kind)

    if ao_only:
        ao = _ambient_occlusion(scene, options, position, normal, seeds, hit)
        color = jnp.where(hit[..., None], ao[..., None], env_col)
        return {"color": _sanitize(color)}

    seed = seeds  # initRand restart per shade invocation
    seed, direct = _direct_lighting(scene, options, position, normal, seed, hit)

    # ---- indirect diffuse direction (progressive only; depth 0 only) ------
    indirect = jnp.zeros_like(direct)
    sample_dir = None
    if mode == "progressive":
        seed_drawn, r0, r1 = rng.next_rand2(seed)
        cosine = options["cosine_hemisphere_sampling"]
        tangent, bitangent = vm.orthonormal_basis(normal)
        rr = jnp.sqrt(r0)
        phi = 2.0 * M_PI * r1
        cos_dir = (
            (rr * jnp.cos(phi))[..., None] * tangent
            + jnp.sqrt(jnp.maximum(1.0 - r0, 0.0))[..., None] * normal
            + (rr * jnp.sin(phi))[..., None] * bitangent
        )
        sin_t = jnp.sqrt(jnp.maximum(1.0 - r0 * r0, 0.0))
        uni_dir = (
            (sin_t * jnp.cos(phi))[..., None] * tangent
            + r0[..., None] * normal
            + (sin_t * jnp.sin(phi))[..., None] * bitangent
        )
        sample_dir = jnp.where(cosine, cos_dir, uni_dir)
        no_ind = options["no_indirect_diffuse"]
        # HLSL consumes the 2 draws only when indirect diffuse runs.
        seed = jnp.where(no_ind, seed, seed_drawn)

    # ---- indirect specular direction (Phong lobe) ---------------------------
    # (ProgressiveRaytracing.hlsl:114-130 / RealtimeRaytracing.hlsl:77-93)
    is_spec_mat = (mat["type"] == 1) | (mat["type"] == 2)
    spec_active = hit & is_spec_mat & (mat["reflectivity"] > 0.001)
    exponent = jnp.exp((1.0 - mat["roughness"]) * 12.0)
    mirror = vm.normalize(vm.reflect(directions, normal))
    seed, phong_dir, pdf, brdf = sampling.phong_lobe_sample(seed, mirror, exponent)

    # ---- ONE batched secondary trace for diffuse + specular bounce rays ----
    # (the DXR version recurses twice; batching halves launch count and
    # doubles lane occupancy with lane-identical results)
    trans_active = None
    if mode == "progressive":
        n = position.shape[0]
        dirs_list = [sample_dir, phong_dir]
        act_list = [hit, spec_active]
        if refraction:
            trans_dir, trans_ok = vm.refract(directions, normal, mat["ior"])
            trans_active = (
                hit & (mat["type"] == 2) & (mat["reflectivity"] > 0.001)
                & trans_ok
            )
            dirs_list.append(trans_dir)
            act_list.append(trans_active)
        reps = len(dirs_list)
        sec_both = _secondary_radiance(
            scene,
            options,
            jnp.concatenate([position] * reps),
            jnp.concatenate(dirs_list),
            jnp.concatenate([seeds] * reps),
            jnp.concatenate(act_list),
            mode,
            env_kind,
        )
        sec = sec_both[:n]
        spec_rad = sec_both[n : 2 * n]
        trans_rad = sec_both[2 * n :] if refraction else None
        nol = vm.saturate(vm.dot(normal, sample_dir))
        # cosine: pdf term cancels -> L * pi; uniform: L * NoL * 2pi
        # (evaluateIndirectDiffuse, ProgressiveRaytracing.hlsl:57-78).
        contrib = jnp.where(cosine, sec * M_PI, sec * (nol * 2.0 * M_PI)[..., None])
        indirect = jnp.where(options["no_indirect_diffuse"], 0.0, contrib)
    else:
        spec_rad = _secondary_radiance(
            scene, options, position, phong_dir, seeds, spec_active, mode,
            env_kind,
        )
    # brdf/pdf = (e+2)/(e+1) analytically; guard the 0/0 underflow that the
    # HLSL lets become NaN (then kills via max()).
    ratio = jnp.where(pdf > 1e-30, brdf / jnp.maximum(pdf, 1e-30), (exponent + 2.0) / (exponent + 1.0))
    specular = spec_rad * ratio[..., None]
    specular = jnp.where(spec_active[..., None], specular, 0.0)
    fresnel = sampling.fresnel_schlick(directions, normal, mat["specular"])
    fresnel = jnp.where(spec_active[..., None], fresnel, 0.0)

    diffuse_comp = (direct + indirect) / M_PI
    refl = mat["reflectivity"][..., None]
    emissive = mat["emissive"] * mat["emissive_strength"][..., None]
    full = emissive + mat["albedo"] * diffuse_comp + refl * specular * fresnel
    if refraction and trans_active is not None:
        # transmission: deterministic refraction ray (pdf = brdf = 1),
        # energy split against the reflect branch by the same Schlick term
        transmitted = jnp.where(trans_active[..., None], trans_rad, 0.0)
        full = full + refl * (1.0 - fresnel) * transmitted

    if mode == "realtime":
        direct_aov = mat["albedo"] * direct / M_PI
        spec_aov = refl * specular * fresnel
        color = mat["albedo"] * direct / M_PI + refl * specular * fresnel
        color = jnp.where(hit[..., None], color, env_col)
        # Miss routes env into the direct AOV (RealtimeRaytracing.hlsl:119-126).
        direct_aov = jnp.where(hit[..., None], direct_aov, env_col)
        spec_aov = jnp.where(hit[..., None], spec_aov, 0.0)
        return {
            "color": _sanitize(color),
            "direct": _sanitize(direct_aov),
            "indirect_specular": _sanitize(spec_aov),
            "albedo": jnp.where(hit[..., None], mat["albedo"], 0.0),
            "roughness": jnp.where(hit, mat["roughness"], 0.0),
        }

    # ---- debug AOV selection at depth 0 (ProgressiveRaytracing.hlsl:132-145)
    color = full
    color = jnp.where(
        options["show_direct_lighting_only"], mat["albedo"] * direct / M_PI, color
    )
    color = jnp.where(
        options["show_gbuffer_albedo_only"], mat["albedo"], color
    )
    color = jnp.where(options["show_fresnel_term"], fresnel, color)
    color = jnp.where(
        options["show_indirect_specular_only"], refl * specular * fresnel, color
    )
    color = jnp.where(
        options["show_indirect_diffuse_only"],
        mat["albedo"] * indirect / M_PI,
        color,
    )
    color = jnp.where(hit[..., None], color, env_col)
    return {"color": _sanitize(color)}


def _sanitize(color: jnp.ndarray) -> jnp.ndarray:
    """max(c, 0) with HLSL NaN semantics (max returns the non-NaN operand),
    parity with the accumulation clamp (ProgressiveRaytracing.hlsl:37)."""
    return jnp.where(jnp.isnan(color), 0.0, jnp.maximum(color, 0.0))


def scene_geometry(scene: dict) -> dict:
    """Everything of a scene pytree but its lights and environment."""
    return {k: v for k, v in scene.items() if k not in ("lights", "env")}


def make_render_step(
    scene: dict,
    width: int,
    height: int,
    mode: str = "progressive",
    ao_only: bool = False,
    jitter_scale: float = 30.0,
    frames_per_step: int = 1,
):
    """Compile a per-frame render step for a scene — the analogue of
    compiling an RTPSO (/root/reference/libs/DXRFramework/RtState.cpp:18-65).
    Geometry, lights and env are all arguments, so light animation, UI edits
    and TLAS refits never recompile. (Geometry baked in as constants gave
    no steady gain on an H100: 7.5 vs 7.0 ms per 512x512 Cornell sample and
    250.7 vs 248.9 ms for the 983k-triangle instanced:32 scene, with other
    runs going either way, while its first call took 22 s on the latter;
    benchmarks/gpu_constants.py.)

    Returns ``step(options, camera, lights, env, geo_arg=None) -> dict of
    images``; ``geo_arg`` (scene_geometry of a scene with the same
    structure, e.g. a refitted one) defaults to this scene's geometry.

    frames_per_step (realtime only): K FRAMES in one dispatch — the
    reference's frames-in-flight pipelining (3 deep:
    /root/reference/include/DXRExperimentsApp.h:27,
    src/utils/DeviceResources.cpp:580-598) as one device call at the cost
    of K frames of input latency. The returned step takes CameraParams
    stacked on a leading [K] frame axis and returns AOVs with a leading [K]
    axis, equal to K sequential single-frame steps (tested).
    """
    geo = scene_geometry(scene)
    env_kind = int(scene["env"]["kind"])
    if frames_per_step > 1 and mode != "realtime":
        raise ValueError(
            "frames_per_step > 1 is the realtime frames-in-flight batch"
        )

    def render_one(options, camera, full):
        return render_sample(
            full, options, camera, width, height,
            mode=mode, ao_only=ao_only, jitter_scale=jitter_scale,
            env_kind=env_kind,
        )

    @jax.jit
    def inner(options, camera, lights, env, geo_arg):
        full = dict(geo_arg, lights=lights, env=env)
        if frames_per_step == 1:
            return render_one(options, camera, full)
        # K single-frame renders in ONE dispatch: lax.map compiles the body
        # once and runs the frames back-to-back on the device.
        return jax.lax.map(lambda cam: render_one(options, cam, full), camera)

    def step(options, camera, lights, env, geo_arg=None):
        return inner(options, camera, lights, env,
                     geo if geo_arg is None else geo_arg)

    return step


@functools.partial(
    jax.jit,
    static_argnames=(
        "mode", "ao_only", "width", "height", "jitter_scale", "env_kind",
        "full_height", "refraction",
    ),
)
def render_sample(
    scene: dict,
    options: dict,
    camera: dict,
    width: int,
    height: int,
    mode: str = "progressive",
    ao_only: bool = False,
    jitter_scale: float = 30.0,
    env_kind: int | None = None,
    row0=None,
    full_height: int = 0,
    refraction: bool = False,
) -> dict:
    """Render one sample for the full [H, W] grid; the jitted per-frame kernel.

    The analogue of one DispatchRays(w, h)
    (/root/reference/libs/DXRFramework/RtContext.cpp:192-222).
    Returns dict of [H, W, ...] images.

    row0/full_height: render rows [row0, row0+height) of a full_height-tall
    image with global NDC + pixel seeds (multi-chip row sharding).
    """
    from ..core.camera import primary_ray_grid  # local import to avoid cycle

    origins, directions = primary_ray_grid(
        camera, width, height, jitter_scale, row0=row0, full_height=full_height
    )
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    seeds = rng.pixel_seeds(
        width, height, camera["frame_count"], row0=row0
    ).reshape(-1)

    out = trace_rays(
        scene, options, o, d, seeds,
        mode=mode, ao_only=ao_only, env_kind=env_kind, refraction=refraction,
    )
    reshaped = {}
    for k, v in out.items():
        if v.ndim == 2:
            reshaped[k] = v.reshape(height, width, v.shape[-1])
        else:
            reshaped[k] = v.reshape(height, width)
    return reshaped
