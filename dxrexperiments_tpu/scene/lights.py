"""Light definitions and per-frame animation.

Parity with ``DirectionalLightParams``/``PointLightParams``
(/root/reference/assets/shaders/RaytracingHlslCompat.h:52-62) and the
animated directional light in the pipeline update
(/root/reference/src/ProgressiveRaytracingPipeline.cpp:197-208).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

# Reference default light colors
# (/root/reference/src/ProgressiveRaytracingPipeline.cpp:13-14).
DEFAULT_POINT_COLOR = (0.2, 0.8, 0.6, 2.0)
DEFAULT_DIR_COLOR = (0.9, 0.9, 0.9, 1.0)

# Stratified samples drawn on each area light per shading point (soft
# shadows). 4 = a 2x2 stratum grid; BEYOND-reference (the DXR rig has no
# area lights) so no parity constraint pins the value. Consumed by the
# wavefront integrator (_direct_lighting).
AREA_LIGHT_SAMPLES = 4


def area_light_draws(seed):
    """Stratified [0,1)^2 draws for the AREA_LIGHT_SAMPLES soft-shadow
    samples: a DECOUPLED TEA/LCG chain (aseed = initRand(seed, golden
    ratio)) so the main shade chain is unaffected, stratified on a
    su x sv grid (remainder samples unstratified). Returns a list of
    (r0, r1) pairs shaped like `seed`.

    Used by the wavefront integrator (trace/integrator._direct_lighting)."""
    import math

    import jax.numpy as jnp

    from ..core import rng

    su = max(int(math.isqrt(AREA_LIGHT_SAMPLES)), 1)
    sv = AREA_LIGHT_SAMPLES // su
    aseed = rng.init_rand(seed, jnp.uint32(0x9E3779B9))
    out = []
    for j in range(AREA_LIGHT_SAMPLES):
        aseed, r0, r1 = rng.next_rand2(aseed)
        if j < su * sv:
            r0 = (jnp.float32(j % su) + r0) / su
            r1 = (jnp.float32(j // su % sv) + r1) / sv
        out.append((r0, r1))
    return out


def directional_light(forward_dir, color=DEFAULT_DIR_COLOR) -> dict:
    return {
        "forward": jnp.asarray(np.asarray(forward_dir, np.float32)[:3]),
        "color": jnp.asarray(np.asarray(color, np.float32)[:3]),
        "intensity": jnp.asarray(np.float32(color[3])),
    }


def point_light(position, color=DEFAULT_POINT_COLOR) -> dict:
    return {
        "position": jnp.asarray(np.asarray(position, np.float32)[:3]),
        "color": jnp.asarray(np.asarray(color, np.float32)[:3]),
        "intensity": jnp.asarray(np.float32(color[3])),
    }


def area_light(corner, edge_u, edge_v, color=(1.0, 1.0, 1.0, 10.0)) -> dict:
    """Rectangular (quad) area light: emits `color * intensity` diffusely
    from the parallelogram corner + s*edge_u + t*edge_v, s,t in [0,1].

    BEYOND-reference capability (the reference's rig is one directional + one
    point light, RaytracingHlslCompat.h:52-62); BASELINE config 2 asks for
    area-light soft shadows. Shading draws N stratified samples on the quad
    per pixel (integrator._direct_lighting) — every sample's shadow ray joins
    the same single batched any-hit launch as the other lights' rays.
    """
    return {
        "corner": jnp.asarray(np.asarray(corner, np.float32)[:3]),
        "eu": jnp.asarray(np.asarray(edge_u, np.float32)[:3]),
        "ev": jnp.asarray(np.asarray(edge_v, np.float32)[:3]),
        "color": jnp.asarray(np.asarray(color, np.float32)[:3]),
        "intensity": jnp.asarray(np.float32(color[3])),
    }


def _stack_group(entries, keys) -> dict:
    """Stack a list of single-light dicts into [K, ...] arrays (K may be 0)."""
    if not entries:
        return {
            k: jnp.zeros((0, 3) if k != "intensity" else (0,), jnp.float32)
            for k in keys
        }
    return {k: jnp.stack([jnp.asarray(e[k], jnp.float32) for e in entries])
            for k in keys}


def dir_lights(entries: list) -> dict:
    """Stacked directional rig: list of directional_light() dicts -> arrays."""
    return _stack_group(entries, ("forward", "color", "intensity"))


def point_lights(entries: list) -> dict:
    """Stacked point rig: list of point_light() dicts -> arrays."""
    return _stack_group(entries, ("position", "color", "intensity"))


def area_lights(entries: list) -> dict:
    """Stacked area-light rig: list of area_light() dicts -> arrays."""
    return _stack_group(entries, ("corner", "eu", "ev", "color", "intensity"))


def normalize_lights(lights: dict) -> dict:
    """Canonicalize a light rig to stacked arrays.

    Accepts the classic exactly-one-of-each form (single dicts, parity with
    the reference's fixed DirectionalLightParams + PointLightParams rig,
    /root/reference/assets/shaders/RaytracingHlslCompat.h:52-62), lists of
    lights, already-stacked arrays, or missing groups — plus the
    beyond-reference "area" group (area_light) — and returns
    {"dir": [D,...], "point": [P,...], "area": [A,...]} arrays with
    D, P, A >= 0. Pure reshapes, so it is safe to call inside jit (shapes
    are static per pytree structure).
    """
    out = {}
    for group, keys in (
        ("dir", ("forward", "color", "intensity")),
        ("point", ("position", "color", "intensity")),
        ("area", ("corner", "eu", "ev", "color", "intensity")),
    ):
        g = lights.get(group)
        if g is None:
            out[group] = _stack_group([], keys)
        elif isinstance(g, (list, tuple)):
            out[group] = _stack_group(list(g), keys)
        elif jnp.ndim(g[keys[0]]) == 1:  # single light
            out[group] = {k: jnp.asarray(g[k], jnp.float32)[None] for k in keys}
        else:  # already stacked
            out[group] = {k: jnp.asarray(g[k], jnp.float32) for k in keys}
    return out


def light_counts(lights: dict) -> tuple[int, int, int]:
    """(num directional, num point, num area) for a rig in any form."""
    n = normalize_lights(lights)
    return (
        int(n["dir"]["forward"].shape[0]),
        int(n["point"]["position"].shape[0]),
        int(n["area"]["corner"].shape[0]),
    )


def animated_dir_light_forward(elapsed_time: float) -> np.ndarray:
    """The reference's animated sun: base (0.3, -0.2, -1.0) rotated about Y by
    sin(t*0.2)*pi/2 (/root/reference/src/ProgressiveRaytracingPipeline.cpp:197-199).

    Note the animation is frozen at t=142 s while "Pause Animation" is on
    (the default — ProgressiveRaytracingPipeline.cpp:179-181).
    """
    base = np.array([0.3, -0.2, -1.0], np.float64)
    angle = math.sin(elapsed_time * 0.2) * math.pi * 0.5
    c, s = math.cos(angle), math.sin(angle)
    # XMMatrixRotationY with row-vector convention: v' = v @ R
    rot = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    return (base @ rot).astype(np.float32)


def default_lights(elapsed_time: float = 142.0) -> dict:
    """Default light rig matching the reference pipeline update
    (/root/reference/src/ProgressiveRaytracingPipeline.cpp:197-208)."""
    return {
        "dir": directional_light(animated_dir_light_forward(elapsed_time)),
        "point": point_light((0.0, 0.0, 0.0)),
    }
