"""Material model.

Field-parity with ``MaterialParams``
(/root/reference/assets/shaders/RaytracingHlslCompat.h:87-96): albedo,
specular, emissive (rgb + strength in .a), reflectivity, roughness, index of
refraction, and an integer type (0 diffuse, 1 glossy, 2 glass).

Host-side materials are small dataclasses; the scene builder stacks them into
an SoA ``[M, ...]`` pytree so shading gathers per-hit material rows — the
JAX replacement for per-hit-group root constants
(/root/reference/src/ProgressiveRaytracingPipeline.cpp:220-226).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

MATERIAL_DIFFUSE = 0
MATERIAL_GLOSSY = 1
MATERIAL_GLASS = 2


@dataclasses.dataclass
class Material:
    """One material, reference-default values
    (cf. /root/reference/src/DXRExperimentsApp.cpp:95-104)."""

    albedo: tuple = (1.0, 1.0, 1.0, 1.0)
    specular: tuple = (0.0, 0.0, 0.0, 1.0)
    emissive: tuple = (0.0, 0.0, 0.0, 0.0)  # rgb + strength
    reflectivity: float = 0.0
    roughness: float = 1.0
    ior: float = 1.5
    type: int = MATERIAL_DIFFUSE
    # Optional [H, W, 3] float albedo image multiplied into `albedo` at hit
    # UVs (scene.textures — BEYOND-reference; the DXR materials are
    # constants, RaytracingHlslCompat.h:87-96).
    albedo_texture: "np.ndarray | None" = None

    @staticmethod
    def reference_default() -> "Material":
        """The single material the reference app creates
        (/root/reference/src/DXRExperimentsApp.cpp:98-103)."""
        return Material(
            albedo=(0.95, 0.05, 0.0, 1.0),
            specular=(0.58, 0.58, 0.58, 1.0),
            roughness=0.5,
            reflectivity=0.7,
            type=MATERIAL_GLOSSY,
        )


def stack_materials(materials: list[Material]) -> dict:
    """Stack host materials into the device SoA pytree [M, ...]."""
    if not materials:
        materials = [Material()]
    return {
        "albedo": jnp.asarray(
            np.array([m.albedo[:3] for m in materials], np.float32)
        ),
        "specular": jnp.asarray(
            np.array([m.specular[:3] for m in materials], np.float32)
        ),
        "emissive": jnp.asarray(
            np.array([m.emissive[:3] for m in materials], np.float32)
        ),
        "emissive_strength": jnp.asarray(
            np.array([m.emissive[3] for m in materials], np.float32)
        ),
        "reflectivity": jnp.asarray(
            np.array([m.reflectivity for m in materials], np.float32)
        ),
        "roughness": jnp.asarray(
            np.array([m.roughness for m in materials], np.float32)
        ),
        "ior": jnp.asarray(np.array([m.ior for m in materials], np.float32)),
        "type": jnp.asarray(np.array([m.type for m in materials], np.int32)),
    }
