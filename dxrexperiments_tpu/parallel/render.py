"""Multi-chip rendering: pixel-tile + sample (SPP) sharding over a device mesh.

The reference is single-GPU (SURVEY.md §2.8); its scaling axes re-imagined for
several cards are:

  * tile parallelism — shard image rows across the "tile" mesh axis (zero
    collectives until composite/blit),
  * sample parallelism — shard samples-per-pixel across the "spp" axis, with
    one mean-reduction per frame over the interconnect,
  * scene replication — triangles/BVH/materials are read-only and replicated.

The mesh is plain ``jax.devices()`` reshaped: the cards of one host are
joined all to all, so nothing is shaped for a particular topology.

Implementation is GSPMD-style: we annotate shardings on the stacked-sample
render and let XLA partition the whole traced computation and insert the
collectives — no hand-written NCCL analogues.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..trace.integrator import render_sample, scene_geometry


def make_render_mesh(
    n_tile: int | None = None, n_spp: int | None = None, devices=None
) -> Mesh:
    """Create a ("tile", "spp") mesh. Defaults: all devices on "tile"."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_tile is None and n_spp is None:
        n_tile, n_spp = n, 1
    elif n_tile is None:
        n_tile = n // n_spp
    elif n_spp is None:
        n_spp = n // n_tile
    if n_tile * n_spp != n or len(set(devices)) != n:
        raise ValueError(
            f"mesh {n_tile}x{n_spp} needs {n_tile * n_spp} distinct devices, "
            f"got {n} ({len(set(devices))} distinct)"
        )
    dev_array = np.asarray(devices).reshape(n_tile, n_spp)
    return Mesh(dev_array, ("tile", "spp"))


def stack_cameras(camera_params_list: list[dict]) -> dict:
    """Stack per-sample camera pytrees along a leading [S] axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *camera_params_list)


@functools.partial(
    jax.jit, static_argnames=("width", "height", "mode", "mesh", "ao_only")
)
def render_samples_sharded(
    scene: dict,
    options: dict,
    cameras: dict,
    width: int,
    height: int,
    mesh: Mesh,
    mode: str = "progressive",
    ao_only: bool = False,
) -> jnp.ndarray:
    """Render S decorrelated samples (vmapped over stacked cameras) with the
    [S, H, W, 3] output sharded P("spp", "tile") and return the sample mean
    — one psum-mean over the "spp" axis, image rows staying sharded.
    """
    color_sharding = NamedSharding(mesh, P("spp", "tile", None, None))

    def one(cam):
        return render_sample(
            scene, options, cam, width, height, mode=mode, ao_only=ao_only
        )["color"]

    colors = jax.vmap(one)(cameras)
    colors = jax.lax.with_sharding_constraint(colors, color_sharding)
    mean = jnp.mean(colors, axis=0)
    return jax.lax.with_sharding_constraint(
        mean, NamedSharding(mesh, P("tile", None, None))
    )


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "mesh"),
    donate_argnames=("accum",),
)
def progressive_step_sharded(
    scene: dict,
    options: dict,
    cameras: dict,
    accum: jnp.ndarray,
    width: int,
    height: int,
    mesh: Mesh,
) -> jnp.ndarray:
    """Multi-chip progressive accumulation step: S samples/frame folded into
    the row-sharded accumulator (accum stays resident and sharded; donated).

    accumCount semantics match the single-chip step but advance by S per
    frame: accum' = (count*accum + S*mean)/(count + S).
    """
    s = jax.tree.leaves(cameras)[0].shape[0]
    mean = render_samples_sharded(
        scene, options, cameras, width, height, mesh, mode="progressive"
    )
    count = cameras["accum_count"][0]
    new = (count * accum + s * mean) / (count + s)
    return jax.lax.with_sharding_constraint(
        new, NamedSharding(mesh, P("tile", None, None))
    )


def replicate_scene(scene: dict, mesh: Mesh) -> dict:
    """Place the read-only scene pytree replicated on every device."""
    return jax.device_put(scene, NamedSharding(mesh, P()))


# --------------------------------------------------------------------------
# shard_map paths: row-sharded wavefront render + halo-exchange denoiser.
#
# Each device renders its row block of the global image (row0/full_height
# keep NDC and the TEA pixel seeds GLOBAL, so the sharded image equals the
# single-device image); sample batches shard over "spp" with one psum.
# --------------------------------------------------------------------------


def make_sharded_progressive_step(
    scene: dict,
    width: int,
    height: int,
    mesh: Mesh,
    samples_per_step: int = 1,
    ao_only: bool = False,
):
    """Compile the multi-device progressive accumulation step.

    Image rows shard over the "tile" mesh axis, the per-frame sample batch
    over "spp" (one psum-mean per step). Per shard the render is the
    single-device wavefront render_sample, row-offset via row0/full_height
    so the result matches the single-device image.

    Returns ``step(accum, options, cameras, lights, env, max_iterations,
    geo_arg=None)`` with accum row-sharded P("tile") (donated) and cameras
    stacked [S] (sharded over "spp"); accumCount advances by S like the
    single-device samples_per_step path. Geometry is an argument, placed
    replicated on every device once, here; callers keep their per-step
    constants (options, lights, env) resident the same way with
    ``replicate_scene`` instead of handing the step single-device arrays to
    copy out on every call.
    """
    n_tile, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    if height % n_tile:
        raise ValueError(f"height {height} % tile axis {n_tile} != 0")
    if samples_per_step % n_spp:
        raise ValueError(
            f"samples_per_step {samples_per_step} % spp axis {n_spp} != 0"
        )
    h_local = height // n_tile
    env_kind = int(scene["env"]["kind"])
    geo = replicate_scene(scene_geometry(scene), mesh)  # placed once
    s = samples_per_step

    def shard_body(accum, options, cameras, lights, env, max_iterations,
                   geo_in):
        full = dict(geo_in, lights=lights, env=env)
        py0 = (jax.lax.axis_index("tile") * h_local).astype(jnp.float32)

        def one(cam):
            return render_sample(
                full, options, cam, width, h_local, mode="progressive",
                ao_only=ao_only, env_kind=env_kind,
                row0=py0, full_height=height,
            )["color"]

        local_sum = jnp.sum(jax.lax.map(one, cameras), axis=0)
        mean = jax.lax.psum(local_sum, "spp") / s
        count = cameras["accum_count"][0]
        new = (count * accum + s * mean) / (count + s)
        return jnp.where(
            count >= max_iterations.astype(jnp.float32), accum, new
        )

    row = P("tile", None, None)
    smap = jax.jit(jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(row, P(), P("spp"), P(), P(), P(), P()),
        out_specs=row,
        check_vma=False,
    ), donate_argnums=(0,))

    def step(accum, options, cameras, lights, env, max_iterations,
             geo_arg=None):
        return smap(accum, options, cameras, lights, env, max_iterations,
                    geo if geo_arg is None else geo_arg)

    return step


def _halo_rows(x: jnp.ndarray, r: int, n_tile: int) -> jnp.ndarray:
    """Pad a row shard with r rows from each "tile" neighbour via ppermute.

    Edge shards receive zeros (ppermute's missing-pair semantics) — exactly
    the D3D out-of-bounds-reads-return-0 convention the unsharded shift
    chain reproduces with zero padding, so halo'd vertical filtering is
    bit-identical to the single-chip pass."""
    from_above = jax.lax.ppermute(
        x[-r:], "tile", [(i, i + 1) for i in range(n_tile - 1)]
    )
    from_below = jax.lax.ppermute(
        x[:r], "tile", [(i, i - 1) for i in range(1, n_tile)]
    )
    return jnp.concatenate([from_above, x, from_below], axis=0)


def _denoise_local(
    direct: jnp.ndarray,
    indirect: jnp.ndarray,
    params: dict,
    n_tile: int,
    h_local: int,
) -> jnp.ndarray:
    """DenoiseCompositor on row shards (inside shard_map over "tile").

    The horizontal pass is row-local; the vertical pass reads ±MAX_EXTENT
    rows across shard borders — exchanged with one ppermute halo when the
    shard is tall enough, via an all_gather fallback otherwise (tiny
    shards). Composite/tonemap parity via models.denoise.composite_tail."""
    from ..models.denoise import (
        MAX_EXTENT,
        _bilateral_pass,
        composite_tail,
    )

    radius = params["max_kernel_size"].astype(jnp.float32)
    dbg = params["debug_visualize"]

    pass0 = _bilateral_pass(indirect, direct, radius, axis=1)
    pass0 = jnp.where(dbg == 2, indirect, pass0)

    if n_tile == 1:
        pass1 = _bilateral_pass(pass0, direct, radius, axis=0)
    elif h_local >= MAX_EXTENT:
        r = MAX_EXTENT
        pass1 = _bilateral_pass(
            _halo_rows(pass0, r, n_tile),
            _halo_rows(direct, r, n_tile),
            radius,
            axis=0,
        )[r:-r]
    else:
        # Shard shorter than the filter support: gather full columns once.
        full_p0 = jax.lax.all_gather(pass0, "tile", axis=0, tiled=True)
        full_d = jax.lax.all_gather(direct, "tile", axis=0, tiled=True)
        full_p1 = _bilateral_pass(full_p0, full_d, radius, axis=0)
        t = jax.lax.axis_index("tile")
        pass1 = jax.lax.dynamic_slice_in_dim(
            full_p1, t * h_local, h_local, axis=0
        )
    pass1 = jnp.where(dbg == 2, pass0, pass1)
    return composite_tail(direct, pass1, params)


def make_sharded_realtime_step(
    scene: dict,
    width: int,
    height: int,
    mesh: Mesh,
    denoise: bool = True,
):
    """Compile the multi-device realtime frame: row-sharded wavefront
    raytrace plus the row-sharded DenoiseCompositor whose vertical bilateral
    pass exchanges a ±MAX_EXTENT row halo between neighbouring devices —
    rows never leave their device between raygen and tonemap.

    Requires a tile-only mesh (spp axis of size 1; realtime is 1 spp by
    construction). Returns ``step(options, camera, lights, env,
    denoise_params, geo_arg=None) -> dict`` of row-sharded AOVs plus
    "display" (the denoised composite) when denoise=True. Geometry is placed
    replicated once, as in make_sharded_progressive_step.
    """
    n_tile, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    if n_spp != 1:
        raise ValueError("realtime sharding uses a tile-only mesh (n_spp=1)")
    if height % n_tile:
        raise ValueError(f"height {height} % tile axis {n_tile} != 0")
    h_local = height // n_tile
    env_kind = int(scene["env"]["kind"])
    geo = replicate_scene(scene_geometry(scene), mesh)  # placed once

    def shard_body(options, camera, lights, env, dparams, geo_in):
        full = dict(geo_in, lights=lights, env=env)
        py0 = (jax.lax.axis_index("tile") * h_local).astype(jnp.float32)
        out = render_sample(
            full, options, camera, width, h_local, mode="realtime",
            jitter_scale=10.0, env_kind=env_kind,
            row0=py0, full_height=height,
        )
        if denoise:
            out = dict(
                out,
                display=_denoise_local(
                    out["direct"], out["indirect_specular"], dparams,
                    n_tile, h_local,
                ),
            )
        return out

    img = P("tile", None, None)
    out_specs = {
        "direct": img,
        "indirect_specular": img,
        "albedo": img,
        "roughness": P("tile", None),
        "color": img,
    }
    if denoise:
        out_specs["display"] = img

    smap = jax.jit(jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    ))

    def step(options, camera, lights, env, denoise_params, geo_arg=None):
        return smap(options, camera, lights, env, denoise_params,
                    geo if geo_arg is None else geo_arg)

    return step
