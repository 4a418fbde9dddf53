"""Minimal PNG codec on zlib + numpy.

Decodes the non-interlaced PNGs glTF files embed: greyscale, greyscale +
alpha, RGB and RGBA at 8 or 16 bits, and palette images at 1-8 bits
(with tRNS alpha). Encodes 8-bit greyscale, RGB or RGBA with no filter,
which is what the viewer's frames need. Interlaced (Adam7) files raise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples/pixel


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters; returns [height, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if len(rows) < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = rows[:height * (stride + 1)].reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sum per byte lane, mod 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)])
            cur = np.cumsum(lanes.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur_b = bytearray(stride)
            up = prev.tolist()
            src = line.tolist()
            for i in range(stride):
                a = cur_b[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pred = _paeth(a, up[i], c)
                cur_b[i] = (src[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> float32 [h, w, 4] RGBA in [0, 1] (no transfer
    function applied; greyscale is replicated, missing alpha is 1)."""
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"bad PNG colour type {ctype}")
    channels = _CHANNELS[ctype]
    bits = channels * depth
    stride = (width * bits + 7) // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), height, stride,
                   max(bits // 8, 1))

    if depth == 16:
        samples = px.view(">u2").astype(np.float32) / 65535.0
        samples = samples.reshape(height, width, channels)
    elif depth == 8:
        samples = px.reshape(height, width, channels)
    else:  # 1/2/4-bit greyscale or palette indices, MSB first
        per = 8 // depth
        shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
        vals = (px[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = vals.reshape(height, -1)[:, :width, None]

    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = samples[..., 0].astype(np.int64)
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            t = np.frombuffer(trns, np.uint8)[:len(palette)]
            alpha[:len(t)] = t
        rgba = np.concatenate([palette, alpha[:, None]], axis=1)[idx]
        return rgba.astype(np.float32) / 255.0

    if depth != 16:
        samples = samples.astype(np.float32) / float((1 << depth) - 1)
    grey = ctype in (0, 4)
    rgb = np.repeat(samples[..., :1], 3, axis=-1) if grey else samples[..., :3]
    if ctype in (4, 6):
        alpha = samples[..., -1:]
    else:
        alpha = np.ones((height, width, 1), np.float32)
    return np.concatenate([rgb, alpha], axis=-1).astype(np.float32)


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode(image: np.ndarray) -> bytes:
    """uint8 [h, w], [h, w, 1], [h, w, 3] or [h, w, 4] -> PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encode expects uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    height, width, channels = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(channels)
    if ctype is None:
        raise ValueError(f"PNG encode takes 1, 3 or 4 channels, not {channels}")
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8), img.reshape(height, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
