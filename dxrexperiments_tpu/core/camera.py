"""Pinhole camera with U/V/W ray-generation basis.

JAX replacement for ``Math::Camera``
(/root/reference/libs/MiniEngine/Camera.h:21-115) plus the pipeline-side
``calculateCameraVariables``
(/root/reference/src/ProgressiveRaytracingPipeline.cpp:151-168).

The camera itself is tiny host-side state (NumPy); each frame it is lowered
to a ``CameraParams`` pytree of jnp arrays that the jitted render step
consumes — the analogue of the reference's per-frame ``CameraParams``
constant-buffer struct (/root/reference/assets/shaders/RaytracingHlslCompat.h:41-50).

Conventions (identical to the reference):
  * right-handed view basis; forward = -Z of the camera basis
    (/root/reference/libs/MiniEngine/Camera.h:40-42)
  * vertical FOV in radians, default pi/4
    (/root/reference/libs/MiniEngine/Camera.h:141)
  * aspect = width / height (/root/reference/src/utils/DXSample.cpp:44)
  * W = forward (unnormalized => focal length), U = normalize(W x up)*ulen,
    V = normalize(U x W)*vlen, vlen = |W| tan(fov/2), ulen = vlen*aspect
    (/root/reference/src/ProgressiveRaytracingPipeline.cpp:151-168)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import jax.numpy as jnp
import numpy as np


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 1e-12 else v


@dataclasses.dataclass
class Camera:
    """Mutable host-side camera (the interactive object)."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    # Orthonormal basis rows: right, up, forward (forward = look direction).
    right: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1, 0, 0], np.float32)
    )
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 1, 0], np.float32)
    )
    forward: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 0, -1], np.float32)
    )
    fov_y: float = math.pi / 4.0
    aspect: float = 16.0 / 9.0  # width / height
    near: float = 1.0
    far: float = 1000.0

    # ------------------------------------------------------------------ #
    # Reference-parity control surface
    # ------------------------------------------------------------------ #
    def set_look_direction(self, forward, up) -> None:
        """Parity with BaseCamera::SetLookDirection
        (/root/reference/libs/MiniEngine/Camera.cpp:19-36)."""
        forward = np.asarray(forward, np.float32)
        up = np.asarray(up, np.float32)
        if np.dot(forward, forward) < 1e-6:
            forward = np.array([0, 0, -1], np.float32)
        forward = _normalize(forward)
        right = np.cross(forward, up)
        if np.dot(right, right) < 1e-6:
            # up parallel to forward: rotate forward -90deg about Y.
            right = np.array([-forward[2], 0.0, forward[0]], np.float32)
        right = _normalize(right)
        self.forward = forward
        self.right = right
        self.up = np.cross(right, forward).astype(np.float32)

    def set_eye_at_up(self, eye, at, up) -> None:
        eye = np.asarray(eye, np.float32)
        at = np.asarray(at, np.float32)
        self.set_look_direction(at - eye, up)
        self.position = eye

    def set_aspect(self, width: int, height: int) -> None:
        self.aspect = float(width) / float(height)

    # ------------------------------------------------------------------ #
    # Derived quantities
    # ------------------------------------------------------------------ #
    def uvw(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Ray-generation basis, parity with calculateCameraVariables
        (/root/reference/src/ProgressiveRaytracingPipeline.cpp:151-168)."""
        w = self.forward.astype(np.float32)  # unit here; length = focal
        wlen = float(np.linalg.norm(w))
        u = _normalize(np.cross(w, self.up))
        v = _normalize(np.cross(u, w))
        vlen = wlen * math.tan(0.5 * self.fov_y)
        ulen = vlen * self.aspect
        return (u * ulen).astype(np.float32), (v * vlen).astype(np.float32), w

    def view_matrix(self) -> np.ndarray:
        """World->view (view: +X right, +Y up, -Z forward), row-vector style."""
        r, u, f = self.right, self.up, self.forward
        rot = np.stack([r, u, -f], axis=0).astype(np.float32)  # [3,3]
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot
        m[:3, 3] = -rot @ self.position
        return m

    def proj_matrix(self) -> np.ndarray:
        """Reverse-Z perspective, parity with Camera::UpdateProjMatrix
        (/root/reference/libs/MiniEngine/Camera.cpp:51-79)."""
        y = 1.0 / math.tan(0.5 * self.fov_y)
        x = y / self.aspect
        q1 = self.near / (self.far - self.near)
        q2 = q1 * self.far
        m = np.zeros((4, 4), np.float32)
        m[0, 0] = x
        m[1, 1] = y
        m[2, 2] = q1
        m[2, 3] = q2
        m[3, 2] = -1.0
        return m

    def view_proj_matrix(self) -> np.ndarray:
        return (self.proj_matrix() @ self.view_matrix()).astype(np.float32)


def camera_params(
    camera: Camera,
    jitter: tuple[float, float] = (0.0, 0.0),
    frame_count: int = 0,
    accum_count: int = 0,
) -> dict[str, Any]:
    """Lower a Camera to the device-side CameraParams pytree.

    Field-parity with the reference CameraParams struct
    (/root/reference/assets/shaders/RaytracingHlslCompat.h:41-50).
    """
    u, v, w = camera.uvw()
    return {
        "eye": jnp.asarray(camera.position, jnp.float32),
        "u": jnp.asarray(u, jnp.float32),
        "v": jnp.asarray(v, jnp.float32),
        "w": jnp.asarray(w, jnp.float32),
        "jitter": jnp.asarray(jitter, jnp.float32),
        "frame_count": jnp.asarray(frame_count, jnp.uint32),
        "accum_count": jnp.asarray(accum_count, jnp.float32),
    }


def primary_ray_grid(
    params: dict,
    width: int,
    height: int,
    jitter_scale: float = 30.0,
    row0=None,
    full_height: int = 0,
):
    """Generate the [H, W] grid of primary rays from CameraParams.

    Parity with the RayGen shaders
    (/root/reference/assets/shaders/ProgressiveRaytracing.hlsl:18-32,
    RealtimeRaytracing.hlsl:25-40): NDC from pixel centers, direction
    ``normalize(d.x*U - d.y*V + W)``, origin = eye + jitter*scale in XY.
    jitter_scale is 30 for the progressive pipeline, 10 for realtime.

    row0/full_height: generate rays for rows [row0, row0+height) of a
    full_height-tall image (multi-chip row sharding, parallel/render.py).

    Returns (origins [H,W,3], directions [H,W,3]).
    """
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    ys_pix = jnp.arange(height, dtype=jnp.float32)
    if row0 is not None:
        ys_pix = ys_pix + jnp.asarray(row0, jnp.float32)
    ys = (ys_pix + 0.5) / (full_height or height) * 2.0 - 1.0
    dx, dy = jnp.meshgrid(xs, ys, indexing="xy")  # [H, W] each (rows = y)
    u, v, w = params["u"], params["v"], params["w"]
    d = dx[..., None] * u + (-dy)[..., None] * v + w
    norm = jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    directions = d / norm
    jit = params["jitter"] * jitter_scale
    origin = params["eye"] + jnp.concatenate([jit, jnp.zeros(1, jnp.float32)])
    origins = jnp.broadcast_to(origin, directions.shape)
    return origins, directions
