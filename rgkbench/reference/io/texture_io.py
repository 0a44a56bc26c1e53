# The port's own copy of rgk_tpu/io/texture_io.py, kept equal to it.
"""Texture image loading: PNG / JPEG (sRGB, gamma-decoded) and HDR
(linear), plus EXR via io/exr.py.

Behavioral parity with the reference loaders (reference
src/texture.cpp:189-321): 8-bit formats are decoded with a pow-2.2
gamma curve; JPEGs are flipped vertically (the reference stores them
bottom-up); HDR is read linearly.  Returns float32 [H, W, 3] arrays in
top-down row order as consumed by the bilinear fetch.
"""

from __future__ import annotations

import os

import numpy as np

from . import exr as exr_io

GAMMA = 2.2


def gamma_decode(img: np.ndarray, gamma: float = GAMMA) -> np.ndarray:
    return np.power(np.clip(img, 0.0, 1.0), gamma).astype(np.float32)


def load_texture(path: str) -> np.ndarray:
    """Load an image file as float32 [H, W, 3] linear radiance."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return _load_hdr(path)
    if ext == ".exr":
        return exr_io.read_exr(path)[..., :3].astype(np.float32)
    from PIL import Image

    with Image.open(path) as im:
        flip = ext in (".jpg", ".jpeg")
        arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    if flip:
        arr = arr[::-1].copy()
    return gamma_decode(arr)


def _load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) reader (replaces the reference's stb_image
    use).  Supports the common 32-bit_rle_rgbe format with new-style
    RLE scanlines."""
    with open(path, "rb") as f:
        data = f.read()
    # Header
    pos = data.index(b"\n\n") if b"\n\n" in data else -1
    if pos < 0:
        raise ValueError("malformed HDR header")
    header = data[:pos].decode("latin-1")
    if "32-bit_rle_rgbe" not in header and not header.startswith("#?"):
        raise ValueError("not an RGBE HDR file")
    pos += 2
    dim_end = data.index(b"\n", pos)
    dims = data[pos:dim_end].decode("latin-1").split()
    if len(dims) != 4 or dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {dims}")
    h, w = int(dims[1]), int(dims[3])
    pos = dim_end + 1

    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = memoryview(data)
    for y in range(h):
        if w < 8 or w > 0x7FFF or buf[pos] != 2 or buf[pos + 1] != 2:
            # Flat (non-RLE) scanline
            row = np.frombuffer(buf[pos:pos + w * 4], np.uint8)
            rgbe[y] = row.reshape(w, 4)
            pos += w * 4
            continue
        scan_w = (buf[pos + 2] << 8) | buf[pos + 3]
        if scan_w != w:
            raise ValueError("HDR scanline width mismatch")
        pos += 4
        for ch in range(4):
            x = 0
            while x < w:
                count = buf[pos]
                pos += 1
                if count > 128:  # run
                    rgbe[y, x:x + count - 128, ch] = buf[pos]
                    pos += 1
                    x += count - 128
                else:  # literal
                    rgbe[y, x:x + count, ch] = np.frombuffer(
                        buf[pos:pos + count], np.uint8)
                    pos += count
                    x += count

    mantissa = rgbe[..., :3].astype(np.float32)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(1.0, exponent - 136).astype(np.float32)  # 128 + 8
    out = mantissa * scale[..., None]
    out[exponent == 0] = 0.0
    return out.astype(np.float32)


def gamma_encode(img: np.ndarray, gamma: float = GAMMA) -> np.ndarray:
    return np.power(np.clip(img, 0.0, 1.0),
                    1.0 / gamma).astype(np.float32)


def _to_u8(img: np.ndarray, encode_gamma: bool) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] image, got {img.shape}")
    if encode_gamma:
        img = gamma_encode(img)
    return (255.0 * np.clip(img, 0.0, 1.0)).astype(np.uint8)


def write_png(path: str, img: np.ndarray,
              encode_gamma: bool = False) -> None:
    """Write [H,W,3] float image as 8-bit RGB PNG (reference
    FileTexture::WriteToPNG, texture.cpp:125-140: 255*clamp per
    channel).  Dependency-free (zlib + struct).  Set encode_gamma for
    linear-radiance inputs."""
    import struct
    import zlib

    u8 = _to_u8(img, encode_gamma)
    h, w, _ = u8.shape
    # filter byte 0 per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), u8.reshape(h, w * 3)],
        axis=1).tobytes()

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_bmp(path: str, img: np.ndarray,
              encode_gamma: bool = False) -> None:
    """Write [H,W,3] float image as 24-bit BMP: bottom-up BGR rows
    padded to 4 bytes (reference FileTexture::WriteToBMP,
    texture.cpp:141-187)."""
    import struct

    u8 = _to_u8(img, encode_gamma)
    h, w, _ = u8.shape
    pad = w % 4  # equals (4 - (3*w) % 4) % 4 for 24-bit rows
    row_bytes = 3 * w + pad
    size = 54 + h * row_bytes
    header = struct.pack("<2sIHHIIiiHHIIIIII",
                         b"BM", size, 0, 0, 54, 40, w, h, 1, 24, 0,
                         h * row_bytes, 0, 0, 0, 0)
    bgr = u8[::-1, :, ::-1]  # bottom-up, BGR
    rows = np.concatenate(
        [bgr.reshape(h, w * 3),
         np.zeros((h, pad), np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rows.tobytes())


def write_texture(path: str, img: np.ndarray,
                  encode_gamma: bool = False) -> None:
    """Dispatch on extension: PNG or BMP (reference
    FileTexture::Write, texture.cpp:109-123) plus EXR."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, img, encode_gamma)
    elif ext == ".bmp":
        write_bmp(path, img, encode_gamma)
    elif ext == ".exr":
        exr_io.write_exr(path, np.asarray(img, np.float32))
    else:
        raise ValueError(f"output file format '{ext}' is not supported")
