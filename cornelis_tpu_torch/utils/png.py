"""Minimal dependency-free PNG writer and reader, in numpy and zlib.

Replaces the reference's vendored stb_image_write (only stbi_write_png is
used, src/Render.cpp:263). The same codec as `cornelis_tpu/utils/png.py`;
the native encoder (native/) writes the same bytes. The film writes with
this one (film.py says why).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import trace


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode an (H, W, 3) uint8 RGB image as PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("encode_png expects an (H, W, 3) uint8 array.")
    h, w, _ = img.shape

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    # Filter byte 0 (None) per scanline.
    raw = np.empty((h, 1 + w * 3), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(h, w * 3)
    with trace.span("ct.png.deflate") as deflate:
        idat = zlib.compress(raw.tobytes(), compress_level)
        deflate.set("bytes_in", raw.nbytes)
        deflate.set("bytes_out", len(idat))

    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            _chunk(b"IHDR", ihdr),
            _chunk(b"IDAT", idat),
            _chunk(b"IEND", b""),
        ]
    )


def write_png(path: str, image: np.ndarray, compress_level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image, compress_level))


def read_png(path: str) -> np.ndarray:
    """Tiny PNG reader for round-trip tests and golden images.

    Supports only what encode_png writes: 8-bit RGB, non-interlaced, filter
    types 0-4 (full defilter implemented for robustness against external
    tools' output).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("Not a PNG file.")

    pos = 8
    width = height = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if bit_depth != 8 or color_type != 2 or interlace != 0:
                raise ValueError("read_png supports only 8-bit RGB non-interlaced.")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break

    raw = zlib.decompress(idat)
    stride = width * 3
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for row in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).astype(np.int32)
        pos += 1 + stride
        cur = np.zeros(stride, np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        else:  # Sub(1) / Average(3) / Paeth(4) need left-neighbor recurrence
            for x in range(stride):
                left = cur[x - 3] if x >= 3 else 0
                up = prev[x]
                ul = prev[x - 3] if x >= 3 else 0
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + up) // 2
                elif ftype == 4:
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = left if (pa <= pb and pa <= pc) else (up if pb <= pc else ul)
                else:
                    raise ValueError(f"Unsupported PNG filter {ftype}.")
                cur[x] = (line[x] + pred) & 0xFF
        out[row] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(height, width, 3)
