"""io/png.py: the zlib + numpy PNG codec behind glTF textures and the
viewer's frames. Test files are assembled here chunk by chunk, so each
colour type, bit depth and scanline filter is decoded from known bytes."""

import struct
import zlib

import numpy as np
import pytest

from moonshine_tpu.io import png


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(rows: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """Forward PNG filter of [h, stride] uint8 scanlines."""
    x = rows.astype(np.int64)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2,
            4: _paeth(left, up, upleft)}[kind]
    out = ((x - pred) % 256).astype(np.uint8)
    return np.concatenate(
        [np.full((len(rows), 1), kind, np.uint8), out], axis=1)


def _png(rows, width, height, depth, ctype, kind=0, bpp=1, extra=(),
         interlace=0):
    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0,
                       interlace)
    data = zlib.compress(_filter(rows, kind, bpp).tobytes())
    chunks = [(b"IHDR", ihdr), *extra, (b"IDAT", data), (b"IEND", b"")]
    out = png.SIGNATURE
    for k, body in chunks:
        out += png._chunk(k, body)
    return out


def _rgba(h=5, w=7, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4),
                                                dtype=np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_encode_decode_roundtrip(channels):
    img = _rgba()[..., :channels]
    out = png.decode(png.encode(img))
    assert out.shape == (5, 7, 4) and out.dtype == np.float32
    want = img.astype(np.float32) / 255.0
    if channels == 1:
        want = np.repeat(want, 3, axis=-1)
    np.testing.assert_array_equal(out[..., :3], want[..., :3])
    alpha = want[..., 3] if channels == 4 else 1.0
    np.testing.assert_array_equal(out[..., 3], alpha)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_decode_each_filter(kind):
    img = _rgba(9, 11, seed=kind)
    data = _png(img.reshape(9, -1), 11, 9, 8, 6, kind=kind, bpp=4)
    np.testing.assert_array_equal(png.decode(data),
                                  img.astype(np.float32) / 255.0)


def test_decode_16_bit_rgb():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 65536, (4, 6, 3), dtype=np.uint16)
    rows = img.astype(">u2").view(np.uint8).reshape(4, -1)
    out = png.decode(_png(rows, 6, 4, 16, 2, kind=4, bpp=6))
    np.testing.assert_allclose(out[..., :3], img / 65535.0, rtol=1e-6)
    assert (out[..., 3] == 1.0).all()


def test_decode_grey_alpha():
    ga = _rgba(3, 5)[..., :2]
    out = png.decode(_png(ga.reshape(3, -1), 5, 3, 8, 4, kind=1, bpp=2))
    np.testing.assert_array_equal(
        out[..., 0], ga[..., 0].astype(np.float32) / 255.0)
    np.testing.assert_array_equal(out[..., 0], out[..., 2])
    np.testing.assert_array_equal(
        out[..., 3], ga[..., 1].astype(np.float32) / 255.0)


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_decode_palette_with_transparency(depth):
    n = 1 << depth
    rng = np.random.default_rng(depth)
    palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    alpha = rng.integers(0, 256, n // 2 + 1, dtype=np.uint8)
    h, w = 3, 13
    idx = rng.integers(0, n, (h, w))
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.int64)
    padded[:, :w] = idx
    groups = padded.reshape(h, -1, per)
    shifts = np.arange(per - 1, -1, -1) * depth
    rows = (groups << shifts).sum(-1).astype(np.uint8)
    extra = [(b"PLTE", palette.tobytes()), (b"tRNS", alpha.tobytes())]
    out = png.decode(_png(rows, w, h, depth, 3, kind=2, extra=extra))
    full_alpha = np.full(n, 255, np.uint8)
    full_alpha[:len(alpha)] = alpha
    want = np.concatenate([palette, full_alpha[:, None]], axis=1)[idx]
    np.testing.assert_array_equal(out, want.astype(np.float32) / 255.0)


def test_rejects_interlaced_and_foreign_files():
    img = _rgba(2, 2)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode(_png(img.reshape(2, -1), 2, 2, 8, 6, interlace=1))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a" + bytes(20))
