"""DenoiseCompositor: separable joint-bilateral filter + composite + tonemap.

JAX replacement for the reference's two compute passes
(/root/reference/src/DenoiseCompositor.cpp,
assets/shaders/BilateralFilter.hlsli, DenoiseCommon.hlsli): pass 0 filters
the indirect-specular AOV horizontally with direct lighting as the joint
guide; pass 1 filters vertically, then composites (adds direct lighting),
applies exposure, Reinhard tonemap and gamma.

Design notes:
  * The HLSL loops ``-maxKernelSize..maxKernelSize`` with a runtime radius
    (slider 1..25). Its disk-like weight table evaluates to 0 for every tap
    beyond ~0.96*radius, so a STATIC 51-tap loop with the same traced weight
    formula is bit-equivalent for any radius <= 25 — which is exactly what
    XLA wants (static shapes; taps are shifted adds that fuse).
  * D3D out-of-bounds texture reads return 0; we reproduce with zero-padded
    shifts.
  * Group-shared row caching (BilateralFilter.hlsli:40-73) is an HLSL
    bandwidth optimization; XLA fuses the shift chain into one pass per
    axis instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core import vecmath as vm

MAX_EXTENT = 25  # UI slider max (DenoiseCompositor.cpp:104)
KERNEL_TAPS = 6


def default_denoise_params(**overrides) -> dict:
    """Defaults parity with DenoiseCompositor::loadResources
    (/root/reference/src/DenoiseCompositor.cpp:45-50)."""
    p = {
        "exposure": jnp.asarray(1.0, jnp.float32),
        "gamma": jnp.asarray(2.2, jnp.float32),
        "tonemap": jnp.asarray(True),
        "gamma_correct": jnp.asarray(False),
        "max_kernel_size": jnp.asarray(12, jnp.int32),
        "debug_visualize": jnp.asarray(0, jnp.int32),
    }
    for k, v in overrides.items():
        p[k] = jnp.asarray(v, p[k].dtype)
    return p


def _tap_weight(i: int, radius: jnp.ndarray) -> jnp.ndarray:
    """Disk-like spatial weight, parity with the precalculated table
    (BilateralFilter.hlsli:81-91): idx = clamp(|i|*(TAPS-1)/(0.001+|r*0.8|)),
    weights {1,1,.9,.75,.6,.5,0}."""
    idx = jnp.clip(
        (jnp.abs(float(i)) * (KERNEL_TAPS - 1) / (0.001 + jnp.abs(radius * 0.8)))
        .astype(jnp.int32),
        0,
        KERNEL_TAPS,
    )
    table = jnp.asarray([1.0, 1.0, 0.9, 0.75, 0.6, 0.5, 0.0], jnp.float32)
    return table[idx]


def _shift2d(img: jnp.ndarray, offset: int, axis: int) -> jnp.ndarray:
    """img shifted so out[p] = img[p + offset*e_axis], zero-filled OOB
    (D3D OOB texture reads return 0)."""
    if offset == 0:
        return img
    n = img.shape[axis]
    pad = [(0, 0)] * img.ndim
    if offset > 0:
        pad[axis] = (0, offset)
        padded = jnp.pad(img, pad)
        return jax.lax.slice_in_dim(padded, offset, offset + n, axis=axis)
    pad[axis] = (-offset, 0)
    padded = jnp.pad(img, pad)
    return jax.lax.slice_in_dim(padded, 0, n, axis=axis)


def _color_weight(joint_center: jnp.ndarray, joint_sample: jnp.ndarray) -> jnp.ndarray:
    """calcColorWeight (BilateralFilter.hlsli:30-38): 1 - clamp(L1*10, 0, 1)."""
    dist = jnp.sum(jnp.abs(joint_center - joint_sample), axis=-1) * 10.0
    return 1.0 - jnp.clip(dist, 0.0, 1.0)


def _bilateral_pass(
    inp: jnp.ndarray, joint: jnp.ndarray, radius: jnp.ndarray, axis: int
) -> jnp.ndarray:
    """One separable pass along `axis` (0=vertical, 1=horizontal) on [H,W,3]."""
    color = jnp.zeros_like(inp)
    weight = jnp.zeros(inp.shape[:-1], inp.dtype)
    for i in range(-MAX_EXTENT, MAX_EXTENT + 1):
        s_in = _shift2d(inp, i, axis)
        s_joint = _shift2d(joint, i, axis)
        w = _tap_weight(i, radius) * _color_weight(joint, s_joint)
        color = color + s_in * w[..., None]
        weight = weight + w
    return color / jnp.maximum(weight, 1e-8)[..., None]


def reinhard_tonemap(color: jnp.ndarray) -> jnp.ndarray:
    """Luma-based Reinhard (DenoiseCommon.hlsli:34-39)."""
    lum = vm.luminance(color)
    reinhard = lum / (lum + 1.0)
    scale = jnp.where(lum > 1e-12, reinhard / jnp.maximum(lum, 1e-12), 0.0)
    return color * scale[..., None]


def linear_to_srgb(color: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
    return jnp.power(jnp.maximum(color, 0.0), 1.0 / gamma)


@jax.jit
def denoise_composite(
    direct_lighting: jnp.ndarray,
    indirect_specular: jnp.ndarray,
    params: dict,
) -> jnp.ndarray:
    """Full DenoiseCompositor::dispatch equivalent
    (/root/reference/src/DenoiseCompositor.cpp:109-148): H pass over the
    indirect-specular AOV -> V pass -> composite + exposure + tonemap + gamma.

    Inputs are [H, W, 3] linear HDR; returns [H, W, 3] display-ready.
    """
    radius = params["max_kernel_size"].astype(jnp.float32)
    dbg = params["debug_visualize"]

    def run_pass(img, axis):
        return _bilateral_pass(img, direct_lighting, radius, axis=axis)

    # Pass 0 (horizontal): filter indirect specular guided by direct lighting.
    # debugVisualize==2 bypasses the filter (DenoiseCommon.hlsli:50-54).
    pass0 = run_pass(indirect_specular, axis=1)
    pass0 = jnp.where(dbg == 2, indirect_specular, pass0)

    # Pass 1 (vertical): filter pass0, same guide.
    pass1 = run_pass(pass0, axis=0)
    pass1 = jnp.where(dbg == 2, pass0, pass1)

    return composite_tail(direct_lighting, pass1, params)


@jax.jit
def denoise_composite_frames(
    direct_lighting: jnp.ndarray,
    indirect_specular: jnp.ndarray,
    params: dict,
) -> jnp.ndarray:
    """K frames' denoise+composite in ONE dispatch (the frames-in-flight
    batch, models/realtime.py): inputs are [K, H, W, 3]; lax.map compiles
    the per-frame body once and runs the K filter chains back-to-back on
    device, so the host pays a single dispatch round-trip."""

    def body(args):
        d, s = args
        return denoise_composite(d, s, params)

    return jax.lax.map(body, (direct_lighting, indirect_specular))


@jax.jit
def denoise_composite_frames_temporal(
    direct_lighting: jnp.ndarray,
    indirect_specular: jnp.ndarray,
    params: dict,
    history: jnp.ndarray,
    history_valid: jnp.ndarray,
    alpha: jnp.ndarray,
):
    """Temporal variant of the frames batch: the exponential blend is
    sequential across frames, so a lax.scan carries the history through the
    K composites inside the same dispatch. history_valid=False seeds the
    carry with the first frame's composite (matching the sequential
    DenoiseCompositor.dispatch semantics). Returns (final_history,
    blended frames [K, H, W, 3])."""

    def body(carry, args):
        h, valid = carry
        d, s = args
        out = denoise_composite(d, s, params)
        h2 = jnp.where(valid, temporal_blend(h, out, alpha), out)
        return (h2, jnp.ones_like(valid)), h2

    (h_final, _), outs = jax.lax.scan(
        body, (history, history_valid), (direct_lighting, indirect_specular)
    )
    return h_final, outs


def composite_tail(
    direct_lighting: jnp.ndarray, pass1: jnp.ndarray, params: dict
) -> jnp.ndarray:
    """Composite + exposure + tonemap + gamma (DenoiseCommon.hlsli:56-65)
    after the two bilateral passes. Shared with the row-sharded denoiser
    (parallel/render.py), whose vertical pass needs a halo exchange first.

    debug modes: 0 filtered + direct; 1 filtered only; 2 raw input;
    3 direct only."""
    dbg = params["debug_visualize"]
    color = jnp.where(
        dbg == 0,
        pass1 + direct_lighting,
        jnp.where(dbg == 3, direct_lighting, pass1),
    )

    color = color * params["exposure"]
    color = jnp.where(
        params["tonemap"], jnp.maximum(reinhard_tonemap(color), 0.0), color
    )
    color = jnp.where(
        params["gamma_correct"],
        jnp.clip(linear_to_srgb(color, params["gamma"]), 0.0, 1.0),
        color,
    )
    return color


@functools.partial(jax.jit)
def temporal_blend(history: jnp.ndarray, current: jnp.ndarray, alpha) -> jnp.ndarray:
    """Exponential temporal accumulation (the 'temporal' half of a
    spatio-temporal denoiser; the reference's filter is spatial-only, this
    extends it): out = lerp(history, current, alpha)."""
    return history + (current - history) * alpha


class DenoiseCompositor:
    """Host-side wrapper mirroring the reference class shape
    (create/loadResources/dispatch, /root/reference/include/DenoiseCompositor.h:13-27).
    Holds the parameter pytree (the UI surface), optional mock inputs, and
    optional temporal history (reset on camera move, like the progressive
    pipeline's accumulation reset)."""

    def __init__(self, params: dict | None = None, temporal_alpha: float | None = None):
        self.params = params or default_denoise_params()
        self.active = True
        self.mock_inputs: tuple | None = None
        self.temporal_alpha = temporal_alpha  # None = spatial only (reference parity)
        self._history: jnp.ndarray | None = None

    def load_mock_resources(self, direct_img, indirect_img) -> None:
        """Parity with the PNG-fixture mock-input mode
        (/root/reference/src/DenoiseCompositor.cpp:52-68)."""
        self.mock_inputs = (
            jnp.asarray(direct_img, jnp.float32),
            jnp.asarray(indirect_img, jnp.float32),
        )

    def reset_history(self) -> None:
        """Call on camera move / scene change (ghosting guard)."""
        self._history = None

    def dispatch(self, direct_lighting=None, indirect_specular=None) -> jnp.ndarray:
        if direct_lighting is None:
            if self.mock_inputs is None:
                raise ValueError("no inputs and no mock resources loaded")
            direct_lighting, indirect_specular = self.mock_inputs
        out = denoise_composite(direct_lighting, indirect_specular, self.params)
        if self.temporal_alpha is not None:
            if self._history is None or self._history.shape != out.shape:
                self._history = out
            else:
                self._history = temporal_blend(
                    self._history, out, jnp.float32(self.temporal_alpha)
                )
            return self._history
        return out

    def dispatch_frames(self, direct_lighting, indirect_specular) -> jnp.ndarray:
        """Batched dispatch over a leading [K] frame axis (the
        frames-in-flight batch, models/realtime.py) — one device dispatch
        for the K filter chains, temporal history scanned through in-device
        when temporal_alpha is set. Returns [K, H, W, 3]; history advances
        exactly as K sequential dispatch() calls would."""
        if self.temporal_alpha is None:
            return denoise_composite_frames(
                direct_lighting, indirect_specular, self.params
            )
        frame_shape = direct_lighting.shape[1:]
        if self._history is None or self._history.shape != frame_shape:
            hist = jnp.zeros(frame_shape, jnp.float32)
            valid = jnp.asarray(False)
        else:
            hist, valid = self._history, jnp.asarray(True)
        self._history, outs = denoise_composite_frames_temporal(
            direct_lighting, indirect_specular, self.params, hist, valid,
            jnp.float32(self.temporal_alpha),
        )
        return outs
