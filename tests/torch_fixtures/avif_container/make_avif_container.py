"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_container.py``,
``tests/test_torch_avif_segmentation.py`` and ``chip_smoke.py``: grids,
premultiplied alpha, image sequences and segmentation, and their
``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_container/make_avif_container.py

The system's ``libavif.so.15`` (0.11.1, with libaom) writes, through
ctypes:

- ``grid`` images (``avifEncoderAddImageGrid``): 2x2 cells of 64x64 in
  4:2:0, 1x3 cells of 128x64 in 4:2:2, 2x1 cells of 10-bit full-range
  BT.601 4:4:4 without alpha (the reference's 16-bit route), 12-bit 4:2:0,
  RGBA (an alpha grid beside the colour grid), RGBA with premultiplied
  alpha, film grain (``denoise-noise-level``), a 3x2 grid whose
  descriptor and ``ispe`` are edited afterwards to a smaller even output
  size (``crop_grid``), and a 3840x2160 grid of 2x2 cells of 1920x1080
  (``chip_smoke.frame_4k``) for the card;
- premultiplied alpha (``avifImage.alphaPremultiplied``, which writes the
  ``prem`` reference; ``make_avif_tools.libavif_encode``) at 8, 10 and 12 bits in 4:4:4 and 4:2:0, and one in
  4:2:0 under matrix 4, which libavif 1.3 converts on its slow path;
- sequences (``avifEncoderAddImage`` per frame): a 10-bit 4:4:4 one, and
  10- and 12-bit ones whose key frame libaom codes with segmentation
  (``aq-mode=1``).

Pillow's AVIF plugin (libavif 1.3 with libaom) writes sequences
(``save_all``): RGB 4:2:0 and 4:4:4, RGBA, and with ``aq-mode=1``
(segmentation in the first key frame) at qualities 30, 60 and 90, 4:2:0
and 4:4:4, 256x256 and 512x512, RGBA, and with ``deltaq-mode=1`` too; and
the same RGB sequence with its ``meta`` box renamed ``free``, so that its
only image is the track.

Two refusals are made by hand from a Pillow still: the primary item typed
``iovl``, and its data located by ``iloc`` construction method 2. The
reference raises on both, and the port names the feature.

The manifest holds, per file, the fields of the other AVIF folders (how
it was written; the CRC32 of dav1d's Y'UV through the system libavif; the
shape, ``hbd`` flag, ICC length and CRC32 of the reference's
``load_avif`` pixels and the CRC32 of its ``decode_avif_to_rgb8``
pixels; the count of each tool the port's decoder met), and the
container's: the source libavif 1.3 picks (``item`` or ``track``), the
grid's rows and columns, whether the file has alpha and whether its
colour is premultiplied. A refusal holds the feature the port names and
that the reference raises too. A sequence carries its creation time, so
its bytes (not its size or pixels) change from one run to the next.
"""

from __future__ import annotations

import ctypes as C
import io
import json
import os
import struct
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "avif_tools"))

from chip_smoke import frame_4k, with_alpha  # noqa: E402
from make_avif_tools import (_box, _libavif, avif_image, crc,  # noqa: E402
                             libavif_encode)
from oavif_tpu_torch.io.avif import read_container  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

PILLOW = "Pillow (libavif 1.3, libaom)"
LIBAVIF = "libavif 0.11.1 (libaom)"
AQ = ("aq-mode", "1")


def _ss(ss: str) -> str:
    return ss.replace(":", "")


def alpha_mix(rgb: np.ndarray) -> np.ndarray:
    """``chip_smoke.with_alpha``'s ramp (transparent in its top-left
    quarter) made opaque in its bottom-right quarter: alpha 0, 255 and
    every value between."""
    rgba = with_alpha(rgb)
    h, w = rgb.shape[:2]
    rgba[h - h // 4:, w - w // 4:, 3] = 255
    return rgba


# --- libavif 0.11.1 through ctypes -------------------------------------------


def _encode(images: list, quantizer: int, speed: int, options: dict,
            add) -> bytes:
    lib = _libavif()
    lib.avifEncoderSetCodecSpecificOption.argtypes = [
        C.c_void_p, C.c_char_p, C.c_char_p]
    lib.avifEncoderFinish.argtypes = [C.c_void_p, C.c_void_p]
    enc = lib.avifEncoderCreate()
    e32 = C.cast(C.c_void_p(enc), C.POINTER(C.c_int32))
    # avifEncoder (0.11): codecChoice, maxThreads, speed, ...,
    # minQuantizer, maxQuantizer at 24 and 28 (alpha's left lossless)
    e32[0], e32[1], e32[2] = 1, 1, speed  # libaom, one thread
    e32[6] = e32[7] = quantizer
    e32[8] = e32[9] = 0
    for k, v in dict(options).items():
        lib.avifEncoderSetCodecSpecificOption(enc, k.encode(), v.encode())
    out = (C.c_void_p * 2)()
    try:
        add(lib, enc)
        if lib.avifEncoderFinish(enc, out):
            raise RuntimeError("avifEncoderFinish")
        return C.string_at(out[0], out[1])
    finally:
        lib.avifRWDataFree(out)
        lib.avifEncoderDestroy(enc)
        for img in images:
            lib.avifImageDestroy(img)


def libavif_grid(cells: list, cols: int, depth: int, ss: str,
                 quantizer: int, options: dict = (), speed: int = 6,
                 **kw) -> bytes:
    """A ``grid`` AVIF of ``cells`` (raster order, ``cols`` per row)."""
    lib = _libavif()
    images = [avif_image(lib, px, depth, ss, **kw) for px in cells]

    def add(lib, enc):
        lib.avifEncoderAddImageGrid.argtypes = [
            C.c_void_p, C.c_uint32, C.c_uint32, C.c_void_p, C.c_uint32]
        ptrs = (C.c_void_p * len(images))(*images)
        # AVIF_ADD_IMAGE_FLAG_SINGLE
        if lib.avifEncoderAddImageGrid(enc, cols, len(images) // cols, ptrs,
                                       2):
            raise RuntimeError("avifEncoderAddImageGrid")

    return _encode(images, quantizer, speed, options, add)


def libavif_sequence(frames: list, depth: int, ss: str, quantizer: int,
                     options: dict = ()) -> bytes:
    """An image sequence, one frame a timescale unit long."""
    lib = _libavif()
    images = [avif_image(lib, px, depth, ss) for px in frames]

    def add(lib, enc):
        lib.avifEncoderAddImage.argtypes = [C.c_void_p, C.c_void_p,
                                            C.c_uint64, C.c_uint32]
        for img in images:
            if lib.avifEncoderAddImage(enc, img, 1, 0):
                raise RuntimeError("avifEncoderAddImage")

    return _encode(images, quantizer, 6, options, add)


def crop_grid(data: bytes, rows: int, cols: int, cell: tuple,
              out: tuple) -> bytes:
    """``data`` with its grid descriptor's output size (16-bit fields) and
    the grid item's ``ispe`` changed from the cells' full canvas to
    ``out`` (width, height)."""
    cw, ch = cell
    full = (cw * cols, ch * rows)
    desc = struct.pack(">BBBBHH", 0, 0, rows - 1, cols - 1, *full)
    ispe = struct.pack(">4sII", b"\0" * 4, *full)
    for old, new in ((desc, struct.pack(">BBBBHH", 0, 0, rows - 1, cols - 1,
                                        *out)),
                     (ispe, struct.pack(">4sII", b"\0" * 4, *out))):
        assert data.count(old) == 1
        data = data.replace(old, new)
    return data


# --- Pillow -------------------------------------------------------------------


def pillow_sequence(frames: list, **kw) -> bytes:
    buf = io.BytesIO()
    mode = "RGBA" if frames[0].shape[2] == 4 else "RGB"
    ims = [Image.fromarray(px, mode) for px in frames]
    ims[0].save(buf, "AVIF", save_all=True, append_images=ims[1:],
                max_threads=1, **kw)
    return buf.getvalue()


def without_meta(data: bytes) -> bytes:
    """``data`` with its top-level ``meta`` box renamed ``free`` (every
    chunk offset stays valid, and the track is the file's only image) and
    its compatible brand ``avif`` renamed ``avis``: libavif 1.3 wants a
    ``meta`` box in a file of the ``avif`` brand."""
    at = data.index(b"meta")
    assert struct.unpack_from(">I", data, at - 4)[0] > 8 and at < 64
    data = data[:at] + b"free" + data[at + 4:]
    at = data.index(b"avif", 12)
    assert at < 44
    return data[:at] + b"avis" + data[at + 4:]


def _primary_type(data: bytes, typ: bytes) -> bytes:
    """``data`` with its primary item (the first ``infe``) typed ``typ``."""
    at = data.index(b"av01Color")
    return data[:at] + typ + data[at + 4:]


def _full(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(typ, bytes([version]) + flags.to_bytes(3, "big") + payload)


def two_items(colour, alpha) -> bytes:
    """An 8-bit AVIF of two items: ``colour`` (id 1, primary) and
    ``alpha`` (id 2, ``auxl`` to 1), each with its ``ispe``, ``av1C`` and
    ``pixi`` (which libavif 0.11.1 requires), the colour with its
    ``colr``."""
    ftyp = _box(b"ftyp", b"avif" + b"\0\0\0\0" + b"mif1avifmiaf")
    hdlr = _full(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13)
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", 1))
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", 2) + b"".join(
        _full(b"infe", 2, 0, struct.pack(">HH", i, 0) + b"av01\0")
        for i in (1, 2)))
    iref = _full(b"iref", 0, 0, _box(b"auxl", struct.pack(">HHH", 2, 1, 1)))
    urn = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"
    cp, tc, mc, full = colour.nclx
    props = [_full(b"ispe", 0, 0, struct.pack(">II", colour.width,
                                               colour.height)),
             _box(b"av1C", colour.av1c),
             _box(b"colr", b"nclx" + struct.pack(">HHHB", cp, tc, mc,
                                                 0x80 if full else 0)),
             _box(b"av1C", alpha.av1c), _full(b"auxC", 0, 0, urn),
             _full(b"pixi", 0, 0, bytes([3, 8, 8, 8])),
             _full(b"pixi", 0, 0, bytes([1, 8]))]
    ipma = _full(b"ipma", 0, 0, struct.pack(">I", 2)
                 + struct.pack(">HB", 1, 4) + bytes([1, 2 | 0x80, 3, 6])
                 + struct.pack(">HB", 2, 4) + bytes([1, 4 | 0x80, 5, 7]))
    iprp = _box(b"iprp", _box(b"ipco", b"".join(props)) + ipma)

    def meta(off):
        body = struct.pack(">BBH", 0x44, 0, 2)
        for i, it in ((1, colour), (2, alpha)):
            body += struct.pack(">HHHII", i, 0, 1, off, len(it.payload))
            off += len(it.payload)
        return _full(b"meta", 0, 0, hdlr + pitm + _full(b"iloc", 0, 0, body)
                     + iinf + iref + iprp)

    start = len(ftyp) + len(meta(0)) + 8
    return ftyp + meta(start) + _box(b"mdat", colour.payload + alpha.payload)


def construction_method(data: bytes, method: int) -> bytes:
    """A single-item AVIF with ``data``'s primary item, its ``iloc`` of
    version 1 locating the payload by construction ``method``."""
    it = read_container(data).color
    ftyp = _box(b"ftyp", b"avif" + b"\0\0\0\0" + b"mif1avifmiaf")
    hdlr = _full(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13)
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", 1))
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", 1)
                 + _full(b"infe", 2, 0, struct.pack(">HH", 1, 0)
                         + b"av01Color\0"))
    cp, tc, mc, full = it.nclx
    props = [_full(b"ispe", 0, 0, struct.pack(">II", it.width, it.height)),
             _box(b"av1C", it.av1c),
             _box(b"colr", b"nclx" + struct.pack(">HHHB", cp, tc, mc,
                                                 0x80 if full else 0))]
    ipma = _full(b"ipma", 0, 0, struct.pack(">IHB", 1, 1, 3)
                 + bytes([1, 2 | 0x80, 3]))
    iprp = _box(b"iprp", _box(b"ipco", b"".join(props)) + ipma)

    def meta(off):
        iloc = _full(b"iloc", 1, 0, struct.pack(">BBHHHHHII", 0x44, 0, 1, 1,
                                                method, 0, 1, off,
                                                len(it.payload)))
        return _full(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iprp)

    start = len(ftyp) + len(meta(0)) + 8
    return ftyp + meta(start) + _box(b"mdat", it.payload)


# --- the files ----------------------------------------------------------------


def files() -> dict:
    """name -> (bytes, how it was written)"""
    im = bench_images(256)
    big = bench_images(512)
    out = {}

    def grid(name, cells, cols, depth, ss, q, **kw):
        h, w = cells[0].shape[:2]
        how = {"writer": LIBAVIF, "grid": [len(cells) // cols, cols],
               "cell": [h, w], "depth": depth, "subsampling": ss,
               "quantizer": q, **{k: v for k, v in kw.items()
                                  if k != "options"},
               **dict(kw.get("options", {}))}
        if kw.get("premultiplied"):
            how["premultiplied"] = True
        out[name] = (libavif_grid(cells, cols, depth, ss, q, **kw), how)

    def tiles(src, rows, cols, h, w):
        return [src[r * h:(r + 1) * h, c * w:(c + 1) * w]
                for r in range(rows) for c in range(cols)]

    grid("grid2x2_420.avif", tiles(im["mixed"], 2, 2, 64, 64), 2, 8,
         "4:2:0", 24)
    grid("grid1x3_422.avif", [im["fractal"][:64, i * 64:i * 64 + 128]
                              for i in range(3)], 3, 8, "4:2:2", 24)
    grid("grid2x1_444_10bit.avif", [im["sinusoid"][:96, :128],
                                    im["oriented"][:96, :128]], 2, 10,
         "4:4:4", 20)
    grid("grid2x2_420_12bit.avif", tiles(im["edges"], 2, 2, 64, 64), 2, 12,
         "4:2:0", 24)
    rgba = alpha_mix(im["mixed"])
    grid("grid2x1_rgba.avif", [rgba[:64, :64], rgba[-64:, -64:]], 2, 8,
         "4:2:0", 24)
    grid("grid2x1_rgba_prem.avif", [rgba[:64, :64], rgba[-64:, -64:]],
         2, 8, "4:4:4", 24, premultiplied=True)
    grid("grid2x1_420_grain.avif", [im["sinusoid"][:128, :128],
                                    im["sinusoid"][-128:, -128:]], 2, 8,
         "4:2:0", 30, options={"denoise-noise-level": "25"})
    cells = [im["text"][(i // 3) * 64:(i // 3) * 64 + 64,
                        (i % 3) * 64:(i % 3) * 64 + 64] for i in range(6)]
    data = libavif_grid(cells, 3, 8, "4:2:0", 24)
    out["grid3x2_420_crop.avif"] = (
        crop_grid(data, 2, 3, (64, 64), (176, 112)),
        {"writer": LIBAVIF, "grid": [2, 3], "cell": [64, 64], "depth": 8,
         "subsampling": "4:2:0", "quantizer": 24,
         "output": [112, 176]})
    f4k = frame_4k()
    grid("grid4k_420.avif", [f4k[:1080, :1920], f4k[:1080, 1920:],
                             f4k[1080:, :1920], f4k[1080:, 1920:]], 2, 8,
         "4:2:0", 28)

    src = alpha_mix(im["fractal"][:96, :128])
    for depth in (8, 10, 12):
        for ss in ("4:4:4", "4:2:0"):
            out[f"prem{depth}_{_ss(ss)}.avif"] = (
                libavif_encode(src, depth, ss, 20, premultiplied=True),
                {"writer": LIBAVIF, "depth": depth, "subsampling": ss,
                 "quantizer": 20, "premultiplied": True})
    out["prem8_420_mc4.avif"] = (
        libavif_encode(src, 8, "4:2:0", 20, cicp=(1, 13, 4),
                       premultiplied=True),
        {"writer": LIBAVIF, "depth": 8, "subsampling": "4:2:0",
         "quantizer": 20, "premultiplied": True, "cicp": [1, 13, 4]})

    def seq(name, frames, **kw):
        adv = kw.get("advanced", [])
        how = {"writer": PILLOW, "frames": len(frames),
               "size": list(frames[0].shape[:2]),
               "channels": frames[0].shape[2],
               **{k: v for k, v in kw.items() if k != "advanced"},
               **dict(adv)}
        out[name] = (pillow_sequence(frames, **kw), how)

    mixed = im["mixed"][:96, :128]
    two = [mixed, mixed[::-1].copy()]
    seq("seq_420.avif", two, quality=60)
    seq("seq_444.avif", two, quality=60, subsampling="4:4:4")
    seq("seq_rgba.avif", [with_alpha(f) for f in two], quality=60)
    data, how = out["seq_420.avif"]
    out["seq_420_nometa.avif"] = (without_meta(data),
                                  {**how, "meta": "renamed free"})
    tenbit = [im["oriented"][:128, :128], im["oriented"][:128, 128:]]
    out["seq_444_10bit.avif"] = (
        libavif_sequence(tenbit, 10, "4:4:4", 20),
        {"writer": LIBAVIF, "frames": 2, "depth": 10,
         "subsampling": "4:4:4", "quantizer": 20})

    # segmentation: the key frame of a sequence under aq-mode=1 (a still
    # gets none); the second frame repeats the first, so costs little
    for q in (30, 60, 90):
        for ss in ("4:2:0", "4:4:4"):
            px = im["mixed"] if q != 90 else im["mixed"][:128]
            seq(f"seg_{_ss(ss)}_q{q}.avif", [px, px], quality=q,
                subsampling=ss, advanced=[AQ])
    seq("seg512_420_q60.avif", [big["fractal"]] * 2, quality=60,
        advanced=[AQ])
    # libavif 1.3 writes no segmentation into a sequence with alpha (nor
    # libavif 0.11.1 such a sequence at all): the segmented key frame of
    # an RGB sequence and the alpha item of an RGBA still, muxed as items
    px = alpha_mix(im["text"])
    colour = read_container(pillow_sequence([px[..., :3]] * 2, quality=60,
                                            advanced=[AQ])).color
    buf = io.BytesIO()
    Image.fromarray(px, "RGBA").save(buf, "AVIF", quality=60, max_threads=1)
    alpha = read_container(buf.getvalue()).alpha
    out["seg_rgba_420_q60.avif"] = (
        two_items(colour, alpha),
        {"writer": PILLOW, "size": [256, 256], "quality": 60,
         "aq-mode": "1", "mux": "the key frame of an RGB sequence and the "
         "alpha item of an RGBA still, as items"})
    seq("seg_deltaq_420_q60.avif", [im["edges"]] * 2, quality=60,
        advanced=[AQ, ("deltaq-mode", "1")])
    for depth in (10, 12):
        px = im["fractal"][:128]
        out[f"seg_{depth}bit_420.avif"] = (
            libavif_sequence([px, px], depth, "4:2:0", 30,
                             options=dict([AQ])),
            {"writer": LIBAVIF, "frames": 2, "depth": depth,
             "subsampling": "4:2:0", "quantizer": 30, "aq-mode": "1"})

    still = io.BytesIO()
    Image.fromarray(im["edges"][:64, :64]).save(still, "AVIF", quality=60,
                                                max_threads=1)
    still = still.getvalue()
    out["refuse_iovl.avif"] = (_primary_type(still, b"iovl"),
                               {"writer": PILLOW, "edit": "primary item "
                                "typed iovl", "refuses": "'iovl'"})
    out["refuse_iloc_method2.avif"] = (
        construction_method(still, 2),
        {"writer": PILLOW, "edit": "iloc construction method 2",
         "refuses": "iloc construction method 2"})
    return out


# --- manifest -----------------------------------------------------------------


def manifest_entry(name: str, how: dict):
    """The file's manifest entry, or None where the reference cannot read
    a file it should."""
    from oavif_tpu.io.image import decode_avif_to_rgb8, load_avif
    from oavif_tpu_torch.io import avif as A
    from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv

    path = os.path.join(HERE, name)
    with open(path, "rb") as f:
        data = f.read()
    if "refuses" in how:
        try:
            load_avif(path)
        except Exception as e:
            print(f"  the reference refuses {name}: {e}")
        else:
            return None
        try:
            A.decode_avif(data)
        except A.UnsupportedAvif as e:
            assert how["refuses"] in str(e), e
        else:
            return None
        return {"bytes": len(data), "written": how,
                "refuses": how["refuses"]}
    try:
        img = load_avif(path)
        rgb8 = decode_avif_to_rgb8(data)
        planes, depth, _ = decode_to_yuv(data)
    except Exception as e:  # the reference cannot read it: no fixture
        print(f"  the reference cannot read {name}: {e}")
        return None
    box, port, alpha = A.decode_avif(data)
    return {"bytes": len(data), "written": how,
            "load_shape": list(img.data.shape), "load_hbd": img.hbd,
            "load_crc": crc(img.data), "icc": len(img.icc or b""),
            "rgb8_crc": crc(rgb8), "depth": depth,
            "yuv_crc": crc(np.concatenate(
                [p.astype("<u2").reshape(-1) for p in planes
                 if p is not None])),
            "tools": port.tools,
            "alpha_tools": alpha.tools if alpha else None,
            "source": box.source,
            "grid": list(box.color.grid[:2]) if box.color.grid else None,
            "alpha": alpha is not None,
            "premultiplied": box.premultiplied}


def main() -> None:
    manifest = {}
    for name, (data, how) in files().items():
        print(name, len(data), flush=True)
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        entry = manifest_entry(name, how)
        if entry is None:
            os.remove(path)
        else:
            manifest[name] = entry
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
