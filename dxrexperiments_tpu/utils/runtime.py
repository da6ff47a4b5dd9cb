"""Process set-up shared by the entry points: device choice and the
persistent compilation cache."""

from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
PLATFORMS = ("cpu", "gpu")


def compile_cache_dir() -> str:
    """Where compiled programs are kept: ``JAX_COMPILATION_CACHE_DIR`` when
    it is set, else ``<repo>/.jax_cache`` (a fixed path, so every process
    of this checkout hits the same cache)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.
    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when that is set
    nothing is configured here."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_description() -> str:
    """The GPU's name and power limit as ``nvidia-smi`` reports them (one
    line per card), or a note saying why they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines())


def check_platform(requested: str, devices) -> None:
    """Raise unless JAX's default devices are on the requested platform."""
    found = devices[0].platform if devices else None
    if found != requested:
        raise RuntimeError(
            f"platform {requested!r} was requested but JAX runs on {found!r}"
        )


def select_platform(platform: str | None) -> None:
    """Run on `platform` ('cpu' or 'gpu') or fail; None keeps JAX's default
    choice. Nothing falls back to another platform."""
    if platform is None:
        return
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got {platform!r}")
    jax.config.update("jax_platforms", platform)
    check_platform(platform, jax.devices())
