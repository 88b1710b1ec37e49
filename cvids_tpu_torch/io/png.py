"""A minimal 8-bit PNG codec on `zlib` and `struct` (port-only).

The JAX package reads and writes the EuRoC frames through imageio or PIL
(`cvids_tpu/io/euroc.py:40-43`, `euroc_synth.py:142`); the port carries its
own codec so that it needs neither.

- `read_png`: 8-bit gray (color type 0), RGB (2) and RGBA (6) images,
  every row filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), no
  interlace. Returns uint8 (H, W) or (H, W, C). Anything else raises
  ValueError naming the file.
- `write_png`: an 8-bit gray image, filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}     # color type -> samples per pixel


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length


def _unfilter_sequential(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte depends on the reconstructed byte
    `bpp` to its left, so these go byte by byte."""
    out = bytearray(line.tobytes())
    up = prior.tobytes()
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = up[x]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        out[x] = (out[x] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit gray, RGB or RGBA PNG as uint8 (H, W) or (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, color type {color}, "
                         f"interlace {interlace}); 8-bit gray, RGB or RGBA without "
                         "interlace is read")
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, not {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = (np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint64) & 0xFF) \
                .astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior          # uint8 arithmetic wraps mod 256
        elif kind in (3, 4):
            cur = _unfilter_sequential(kind, line, prior, bpp)
        else:
            raise ValueError(f"{path}: PNG row {y} has filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str, image: np.ndarray) -> None:
    """Write a (H, W) uint8 image as an 8-bit gray PNG, filter 0 on every
    row."""
    img = np.ascontiguousarray(image)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"{path}: write_png takes a (H, W) uint8 image, not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
