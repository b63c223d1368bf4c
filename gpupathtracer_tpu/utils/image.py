"""Image IO: PPM (reference-parity P3) and PNG (numpy + zlib).

``write_ppm`` reproduces the reference ``saveToPPM`` format exactly
(utilities.h:842-856): ASCII "P3", "<w> <h>", "255", then one int-cast RGB
triple per line. Note the reference function is fed a buffer the GPU never
writes (SURVEY.md §2.3.10) — here the renderer output actually reaches disk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_ppm(path: str, u8_image: np.ndarray) -> None:
    """ASCII P3 writer, format-identical to reference saveToPPM."""
    h, w = u8_image.shape[:2]
    flat = u8_image.reshape(-1, 3).astype(np.int64)
    with open(path, "w") as f:
        f.write("P3\n")
        f.write(f"{w} {h}\n")
        f.write("255\n")
        np.savetxt(f, flat, fmt="%d")


def read_ppm(path: str) -> np.ndarray:
    """Read ASCII P3 (e.g. the reference's committed render.ppm) → (H, W, 3) u8."""
    with open(path, "r") as f:
        tokens: list[str] = []
        for line in f:
            hash_pos = line.find("#")
            if hash_pos >= 0:
                line = line[:hash_pos]
            tokens.extend(line.split())
    assert tokens[0] == "P3", f"not an ASCII PPM: {tokens[0]}"
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    data = np.asarray(tokens[4 : 4 + w * h * 3], dtype=np.int64)
    # The reference writes raw int casts that may exceed 255 (overflow quirk,
    # SURVEY.md §2.3.1) — clamp on read.
    return np.clip(data, 0, maxv).astype(np.uint8).reshape(h, w, 3)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> grey / RGB / RGBA


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def write_png(path: str, u8_image: np.ndarray) -> None:
    """8-bit PNG (grey, RGB or RGBA by channel count), numpy + zlib only.

    Every scanline uses filter type 0 (None); zlib does the compression.
    """
    img = np.ascontiguousarray(u8_image, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0)
    data = (
        _PNG_SIGNATURE
        + _png_chunk(b"IHDR", header)
        + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG as :func:`write_png` writes it → (H, W, C) uint8.

    Supports 8-bit grey/RGB/RGBA, no interlace, and filter type 0 on every
    scanline; anything else raises ValueError.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {tag!r} chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    channels = {v: k for k, v in _PNG_COLOR_TYPES.items()}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: unsupported PNG layout {header}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: scanline filters other than 0 are not supported")
    return rows[:, 1:].reshape(h, w, channels).copy()


def write_image(path: str, u8_image: np.ndarray) -> None:
    if path.endswith(".ppm"):
        write_ppm(path, u8_image)
    else:
        write_png(path, u8_image)
