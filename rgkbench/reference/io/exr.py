# The port's own copy of rgk_tpu/io/exr.py, kept equal to it.
"""Minimal self-contained OpenEXR scanline IO (no native dependency).

Implements the subset of OpenEXR 2.0 needed by the renderer: RGB(A)
scanline images, float32 or half channels, NONE or ZIP/ZIPS compression.
This replaces the reference's use of libOpenEXR (reference
src/texture.cpp:356-374 writes half RGBA) with a dependency-free module
usable from tests and the render driver alike.

write_exr / read_exr operate on numpy float32 arrays shaped [H, W, 3]
(or [H, W, 4]).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_VERSION = 2

_PIXELTYPE_HALF = 1
_PIXELTYPE_FLOAT = 2

_COMPRESSION_NONE = 0
_COMPRESSION_ZIPS = 2  # zlib, 1 scanline per block
_COMPRESSION_ZIP = 3   # zlib, 16 scanlines per block


def _attr(name: str, type_: str, payload: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_.encode() + b"\x00"
        + struct.pack("<i", len(payload)) + payload
    )


def _chlist(channels, pixel_type: int) -> bytes:
    out = b""
    for ch in channels:  # must be alphabetically sorted
        out += ch.encode() + b"\x00"
        out += struct.pack("<iiii", pixel_type, 0, 1, 1)
    return out + b"\x00"


def _zip_reorder_encode(data: bytes) -> bytes:
    """OpenEXR ZIP pre-transform: split bytes into two halves
    interleaved, then delta-encode."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size
    half = (n + 1) // 2
    reordered = np.empty(n, dtype=np.uint8)
    reordered[:half] = arr[0::2]
    reordered[half:] = arr[1::2]
    d = reordered.astype(np.int16)
    d[1:] = (d[1:] - d[:-1] + 128 + 256) % 256
    return d.astype(np.uint8).tobytes()


def _zip_reorder_decode(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.int16)
    arr[1:] = arr[1:] - 128
    out = np.cumsum(arr) % 256
    out = out.astype(np.uint8)
    n = out.size
    half = (n + 1) // 2
    result = np.empty(n, dtype=np.uint8)
    result[0::2] = out[:half]
    result[1::2] = out[half:]
    return result.tobytes()


def write_exr(path: str, image: np.ndarray, pixel_type: str = "float",
              compression: str = "zip") -> None:
    """Write [H, W, 3|4] float32 image as a scanline EXR."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"expected [H,W,3|4] image, got {image.shape}")
    h, w, nch = image.shape
    channels = ["A", "B", "G", "R"] if nch == 4 else ["B", "G", "R"]
    # Map channel name -> image plane index (RGB(A) order in memory).
    plane = {"R": 0, "G": 1, "B": 2, "A": 3}

    ptype = _PIXELTYPE_FLOAT if pixel_type == "float" else _PIXELTYPE_HALF
    comp = {"none": _COMPRESSION_NONE, "zips": _COMPRESSION_ZIPS,
            "zip": _COMPRESSION_ZIP}[compression]
    lines_per_block = {_COMPRESSION_NONE: 1, _COMPRESSION_ZIPS: 1,
                       _COMPRESSION_ZIP: 16}[comp]

    header = b""
    header += _attr("channels", "chlist", _chlist(channels, ptype))
    header += _attr("compression", "compression", struct.pack("<B", comp))
    header += _attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"  # end of header

    dtype = np.float32 if ptype == _PIXELTYPE_FLOAT else np.float16

    blocks = []
    y = 0
    while y < h:
        ny = min(lines_per_block, h - y)
        raw = b""
        for yy in range(y, y + ny):
            for ch in channels:
                raw += image[yy, :, plane[ch]].astype(dtype).tobytes()
        if comp == _COMPRESSION_NONE:
            payload = raw
        else:
            z = zlib.compress(_zip_reorder_encode(raw))
            payload = z if len(z) < len(raw) else raw
        blocks.append((y, payload))
        y += ny

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, _VERSION))
        f.write(header)
        # offset table
        offset_table_size = 8 * len(blocks)
        pos = 8 + len(header) + offset_table_size
        offsets = []
        for _, payload in blocks:
            offsets.append(pos)
            pos += 8 + len(payload)  # y + size + data
        for off in offsets:
            f.write(struct.pack("<Q", off))
        for by, payload in blocks:
            f.write(struct.pack("<ii", by, len(payload)))
            f.write(payload)


def _read_attrs(buf: bytes, pos: int):
    attrs = {}
    while buf[pos] != 0:
        name_end = buf.index(b"\x00", pos)
        name = buf[pos:name_end].decode()
        pos = name_end + 1
        type_end = buf.index(b"\x00", pos)
        type_ = buf[pos:type_end].decode()
        pos = type_end + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (type_, buf[pos:pos + size])
        pos += size
    return attrs, pos + 1


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR written with NONE/ZIP/ZIPS compression.

    Returns float32 [H, W, C] with channels in R, G, B(, A) order when
    present, otherwise alphabetical channel order.
    """
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("multipart EXR not supported")
    attrs, pos = _read_attrs(buf, 8)

    # channels
    chbuf = attrs["channels"][1]
    channels = []
    cpos = 0
    while chbuf[cpos] != 0:
        nend = chbuf.index(b"\x00", cpos)
        cname = chbuf[cpos:nend].decode()
        cpos = nend + 1
        ptype, _, xs, ys = struct.unpack_from("<iiii", chbuf, cpos)
        cpos += 16
        if xs != 1 or ys != 1:
            raise ValueError("subsampled channels not supported")
        channels.append((cname, ptype))

    comp = attrs["compression"][1][0]
    if comp not in (_COMPRESSION_NONE, _COMPRESSION_ZIPS, _COMPRESSION_ZIP):
        raise ValueError(f"unsupported compression {comp}")
    lines_per_block = 16 if comp == _COMPRESSION_ZIP else 1

    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)

    planes = {c: np.zeros((h, w), np.float32) for c, _ in channels}
    dtypes = {c: (np.float32 if t == _PIXELTYPE_FLOAT else np.float16)
              for c, t in channels}

    for off in offsets:
        by, size = struct.unpack_from("<ii", buf, off)
        payload = buf[off + 8: off + 8 + size]
        ny = min(lines_per_block, y1 - by + 1)
        raw_size = sum(ny * w * np.dtype(dtypes[c]).itemsize for c, _ in channels)
        if comp != _COMPRESSION_NONE and size != raw_size:
            payload = _zip_reorder_decode(zlib.decompress(payload))
        rp = 0
        for yy in range(by, by + ny):
            for cname, _ in channels:
                nbytes = w * np.dtype(dtypes[cname]).itemsize
                row = np.frombuffer(payload[rp:rp + nbytes], dtype=dtypes[cname])
                planes[cname][yy - y0] = row.astype(np.float32)
                rp += nbytes

    names = [c for c, _ in channels]
    if set("RGB").issubset(names):
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
    else:
        order = sorted(names)
    return np.stack([planes[c] for c in order], axis=-1)


class AccumulationImage:
    """Progressive accumulation buffer: per-pixel radiance sum + weight.

    TPU-side equivalent of the reference's EXRTexture sum/count pair
    (reference src/texture.hpp:83-118): the renderer adds whole-round
    [H, W, 3] sums and [H, W] counts; `resolve` divides, `normalize`
    applies a fixed or automatic exposure scale
    (src/texture.cpp:376-400), and `save` writes the EXR.
    """

    def __init__(self, xres: int, yres: int):
        self.sum = np.zeros((yres, xres, 3), np.float64)
        self.count = np.zeros((yres, xres), np.float64)

    def add(self, radiance_sum: np.ndarray, counts: np.ndarray) -> None:
        self.sum += np.asarray(radiance_sum, np.float64)
        self.count += np.asarray(counts, np.float64)

    def resolve(self) -> np.ndarray:
        c = np.maximum(self.count, 1e-30)[..., None]
        out = (self.sum / c).astype(np.float32)
        out[self.count <= 0] = 0.0
        return out

    def normalize(self, scale: float) -> np.ndarray:
        """scale <= 0 selects auto exposure: max channel -> 1.0."""
        img = self.resolve()
        if scale <= 0.0:
            m = float(img.max())
            scale = 1.0 / m if m > 0 else 1.0
        return img * scale

    def save(self, path: str, scale: float = 1.0) -> None:
        write_exr(path, self.normalize(scale))
