"""Image IO: PNG read+write, JPEG read, Radiance HDR read, tonemapping helpers.

JAX-side replacement for the DirectXTK12 WIC/DDS loaders used at
/root/reference/src/ProgressiveRaytracingPipeline.cpp:111-118 and
/root/reference/src/DenoiseCompositor.cpp:57-62. PNG and Radiance .hdr
(RGBE) are coded here with the standard library; JPEG needs Pillow; DDS
lives in utils/dds.py.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1 / 2.4) - 0.055)


def read_image(path: str, linearize: bool = True) -> np.ndarray:
    """Read an image file to float32 [H, W, 3].

    LDR formats are converted from sRGB to linear when `linearize` (the WIC
    loader at ProgressiveRaytracingPipeline.cpp:114 also forces sRGB)."""
    lower = path.lower()
    if lower.endswith(".hdr"):
        return read_hdr(path)
    if lower.endswith(".png"):
        arr = read_png(path).astype(np.float32) / 255.0
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                f"reading {path!r} needs Pillow (only PNG and .hdr are "
                "decoded without it)"
            ) from e
        arr = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return srgb_to_linear(arr).astype(np.float32) if linearize else arr


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )


def write_png(path: str, image: np.ndarray, srgb_encode: bool = False) -> None:
    """Write [H, W, 3] float (0..1) to an 8-bit RGB PNG."""
    arr = np.asarray(image, np.float32)
    if srgb_encode:
        arr = linear_to_srgb(arr)
    arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    raw = np.concatenate(  # filter type 0 (None) on every scanline
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1
    )
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG (gray, gray+alpha, RGB or RGBA)
    to uint8 [H, W, 3] RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"\x89PNG\r\n\x1a\n"):
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _PNG_CHANNELS:
        raise ValueError(
            f"unsupported PNG {path}: depth {depth}, color type {ctype}, "
            f"interlace {interlace}"
        )
    c = _PNG_CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:  # Sub, Average, Paeth depend on the pixel to the left
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - c] if x >= c else 0
                b = prev[x]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:
                    cc = prev[x - c] if x >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    img = out.reshape(h, w, c).astype(np.uint8)
    if c in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def read_hdr(path: str) -> np.ndarray:
    """Native Radiance RGBE (.hdr) decoder, RLE and flat scanlines."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    pos = data.index(b"\n\n") + 2
    dim_end = data.index(b"\n", pos)
    dims = data[pos:dim_end].split()
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {dims!r}")
    height, width = int(dims[1]), int(dims[3])
    pos = dim_end + 1

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = data
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and buf[pos] == 2
            and buf[pos + 1] == 2
            and (buf[pos + 2] << 8 | buf[pos + 3]) == width
        ):
            pos += 4
            for c in range(4):
                x = 0
                while x < width:
                    n = buf[pos]
                    pos += 1
                    if n > 128:  # run
                        rgbe[y, x : x + n - 128, c] = buf[pos]
                        pos += 1
                        x += n - 128
                    else:  # literal
                        rgbe[y, x : x + n, c] = np.frombuffer(
                            buf, np.uint8, n, pos
                        )
                        pos += n
                        x += n
        else:  # flat scanline
            row = np.frombuffer(buf, np.uint8, width * 4, pos).reshape(width, 4)
            rgbe[y] = row
            pos += width * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None] * np.where(
        exp[..., None] > 0, 1.0, 0.0
    )


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    m = mse(a, b)
    return float("inf") if m == 0 else 10.0 * np.log10(peak * peak / m)
