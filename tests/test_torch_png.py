"""The port's PNG reader (``oavif_tpu_torch/io/png8.py``, ``png16.py``)
against the reference's ``load_png`` (Pillow for bit depths up to 8, its
own reader for 16): equal pixels, channels, depth flag and ICC profile on
every legal color type and bit depth, with and without ``tRNS``, with
each filter type forced, interlaced and not, at widths that are not a
multiple of 8. The files are written here, so that each filter type and
the Adam7 layout are chosen, not left to an encoder.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import pytest

from oavif_tpu.io.image import load_png as ref_load_png
from oavif_tpu_torch.io.image import load_png

SIG = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
NCH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
SIZES = ((13, 11), (1, 1), (9, 17), (8, 30))  # (h, w)
FILTER_SETS = ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4))


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, n) samples -> (h, stride) bytes, big-endian bit order."""
    h, w, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * n * 2)
    v = samples.reshape(h, w * n).astype(np.uint16)
    if depth == 8:
        return v.astype(np.uint8)
    per = 8 // depth
    v = np.pad(v, ((0, 0), (0, (-v.shape[1]) % per))).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint16)
    return (v << shifts).sum(-1).astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """Filter each row with the next type of ``ftypes``, in turn."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y, r in enumerate(rows.astype(np.int32)):
        ftype = ftypes[y % len(ftypes)]
        left = np.concatenate([np.zeros(bpp, np.int32), r])[: len(r)]
        ul = np.concatenate([np.zeros(bpp, np.int32), prev])[: len(r)]
        p = left + prev - ul
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul))
        pred = (0, left, prev, (left + prev) >> 1, paeth)[ftype]
        out.append(bytes([ftype]) + ((r - pred) & 255).astype(
            np.uint8).tobytes())
        prev = r
    return b"".join(out)


def write_png(path, samples, color_type, depth, ftypes=(0,), interlace=0,
              palette=None, trns=None, icc=None) -> bytes:
    h, w, n = samples.shape
    bpp = max(1, n * depth // 8)
    if interlace:
        raw = b"".join(_filter(_pack(samples[y0::dy, x0::dx], depth), bpp,
                               ftypes)
                       for x0, y0, dx, dy in ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _filter(_pack(samples, depth), bpp, ftypes)
    data = SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                             color_type, 0, 0, interlace))
    if icc is not None:
        data += _chunk(b"iCCP", b"profile\x00\x00" + zlib.compress(icc))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    z = zlib.compress(raw)
    data += _chunk(b"IDAT", z[: len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    data += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)
    return data


def _image(rng, color_type, depth, trns_on, h, w):
    """Seeded samples, and the palette and tRNS payload that go with them."""
    s = rng.integers(0, 1 << depth, (h, w, NCH[color_type]))
    palette = trns = None
    if color_type == 3:
        palette = rng.integers(0, 256, (min(1 << depth, 200), 3))
        s %= len(palette)
        if trns_on:
            trns = rng.integers(0, 256, min(len(palette), 5)).astype(
                np.uint8).tobytes()
    elif trns_on and color_type == 0:
        trns = struct.pack(">H", int(s[0, 0, 0]))  # a key that occurs
    elif trns_on and color_type == 2:
        trns = struct.pack(">HHH", *(int(v) for v in s[0, 0]))
    return s, palette, trns


def _assert_same(path):
    want, got = ref_load_png(str(path)), load_png(str(path))
    assert (got.width, got.height) == (want.width, want.height)
    assert got.channels == want.channels
    assert got.hbd == want.hbd
    assert got.icc == want.icc
    assert got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data, want.data)
    return got


GRID = [(ct, depth, trns)
        for ct, depths in {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8),
                           4: (8,), 6: (8,)}.items()
        for depth in depths
        for trns in ((False, True) if ct in (0, 2, 3) else (False,))]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color_type,depth,trns_on", GRID)
def test_png_equals_pillow(tmp_path, color_type, depth, trns_on, interlace):
    rng = np.random.default_rng(100 * color_type + depth)
    for ftypes in FILTER_SETS:
        for h, w in SIZES:
            s, palette, trns = _image(rng, color_type, depth, trns_on, h, w)
            path = tmp_path / f"f{ftypes[0]}_{h}x{w}.png"
            write_png(path, s, color_type, depth, ftypes, interlace,
                      palette, trns, icc=b"ICC" * (h % 2))
            img = _assert_same(path)
            assert img.channels == (3 if color_type == 2 else 4)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_each_filter_forced(tmp_path, ftype):
    """Every row of a 37x45 RGBA and a 37x45 RGB image in one filter."""
    rng = np.random.default_rng(ftype)
    for color_type in (2, 6):
        s = rng.integers(0, 256, (37, 45, NCH[color_type]))
        path = tmp_path / f"{color_type}.png"
        write_png(path, s, color_type, 8, (ftype,))
        img = _assert_same(path)
        np.testing.assert_array_equal(img.data, s)


@pytest.mark.parametrize("color_type", [0, 2, 4, 6])
def test_png_16bit_equals_reference(tmp_path, color_type):
    rng = np.random.default_rng(16 + color_type)
    s = rng.integers(0, 1 << 16, (9, 13, NCH[color_type]))
    path = tmp_path / "a.png"
    write_png(path, s, color_type, 16, (0, 1, 2, 3, 4), icc=b"wide")
    img = _assert_same(path)
    assert img.hbd and img.channels == 4


def test_png_truncated_raises_and_tail_cut_decodes(tmp_path):
    """Cut inside the image data, both readers refuse the file (Pillow
    with OSError, the port with ValueError; the CLI reports either as
    ``Error: ...``); cut after the image data, both decode it."""
    rng = np.random.default_rng(9)
    data = write_png(tmp_path / "full.png", rng.integers(0, 256, (40, 50, 3)),
                     2, 8, (4,))
    for cut in (10, 40, len(data) // 2):
        path = tmp_path / f"cut{cut}.png"
        path.write_bytes(data[:cut])
        with pytest.raises(OSError):
            ref_load_png(str(path))
        with pytest.raises(ValueError):
            load_png(str(path))
    for cut in (len(data) - 20, len(data) - 5):
        path = tmp_path / f"tail{cut}.png"
        path.write_bytes(data[:cut])
        _assert_same(path)


def test_png_bad_crc_and_bad_filter_raise(tmp_path):
    rng = np.random.default_rng(10)
    data = bytearray(write_png(tmp_path / "a.png",
                               rng.integers(0, 256, (8, 8, 3)), 2, 8))
    bad = bytearray(data)
    bad[29] ^= 1  # the IHDR's CRC
    (tmp_path / "crc.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        load_png(str(tmp_path / "crc.png"))
    raw = b"".join(bytes([7]) + bytes(24) for _ in range(8))
    bad = (SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    (tmp_path / "filter.png").write_bytes(bad)
    with pytest.raises(ValueError, match="filter"):
        load_png(str(tmp_path / "filter.png"))
