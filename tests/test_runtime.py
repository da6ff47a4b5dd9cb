"""Process set-up shared by the entry points (utils/runtime.py) and the
standard-library PNG codec (utils/image.py)."""

import os
import struct
import zlib

import jax
import numpy as np
import pytest

from dxrexperiments_tpu.utils import runtime
from dxrexperiments_tpu.utils.image import read_image, read_png, write_png


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls made by utils/runtime instead of
    applying them (the test process keeps its CPU backend and cache)."""
    calls = []
    monkeypatch.setattr(runtime.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_compile_cache_follows_env(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert config_updates == []  # JAX reads the variable itself


def test_compile_cache_default_is_fixed_repo_dir(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert runtime.compile_cache_dir() == want
    assert runtime.enable_compile_cache() == want
    assert config_updates == [("jax_compilation_cache_dir", want)]
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_check_platform_rejects_other_device():
    runtime.check_platform("cpu", jax.devices())
    with pytest.raises(RuntimeError, match="'gpu' was requested"):
        runtime.check_platform("gpu", jax.devices())


def test_select_platform_fails_instead_of_falling_back(config_updates):
    with pytest.raises(RuntimeError):
        runtime.select_platform("gpu")
    assert config_updates == [("jax_platforms", "gpu")]
    with pytest.raises(ValueError):
        runtime.select_platform("metal")
    runtime.select_platform(None)  # JAX's own choice: nothing to do


@pytest.mark.parametrize("cli", ["headless", "viewer"])
def test_cli_platform_guard(cli, config_updates, capsys):
    """--platform takes cpu|gpu only, and a GPU request on a machine
    without one ends the program instead of running on the CPU."""
    if cli == "headless":
        from dxrexperiments_tpu.app.headless import main
    else:
        from dxrexperiments_tpu.app.viewer import main
    for argv in (["--platform", "metal"], ["--platform", "gpu"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_card_description_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert runtime.card_description().startswith("nvidia-smi unavailable")


# --------------------------------------------------------------------------- #
# PNG
# --------------------------------------------------------------------------- #
def test_png_round_trip(tmp_path):
    rs = np.random.default_rng(0)
    img = rs.integers(0, 256, (7, 11, 3)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, img.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(read_png(path), img)
    # linear -> sRGB on write, sRGB -> linear on read
    lin = rs.uniform(0.05, 1.0, (4, 5, 3)).astype(np.float32)
    write_png(path, lin, srgb_encode=True)
    np.testing.assert_allclose(read_image(path), lin, atol=0.02)


def _png_with_filters(img, color_type):
    """Encode with a different scanline filter (0-4) on every row."""
    h, w, c = img.shape
    data = img.astype(np.int32)
    rows = []
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        cur = data[y].reshape(-1)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        ftype = y % 5
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, up_left))
        rows.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("color_type,channels", [(2, 3), (6, 4), (0, 1)])
def test_read_png_scanline_filters(tmp_path, color_type, channels):
    rs = np.random.default_rng(color_type)
    img = rs.integers(0, 256, (10, 6, channels)).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(img, color_type))
    got = read_png(str(path))
    want = np.repeat(img, 3, axis=-1) if channels == 1 else img[..., :3]
    np.testing.assert_array_equal(got, want)


def test_read_image_jpeg_names_pillow(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)  # as if not installed
    with pytest.raises(ImportError, match="Pillow"):
        read_image(str(tmp_path / "photo.jpg"))
