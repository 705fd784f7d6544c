"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_tools.py`` and
``chip_smoke.py``: files that use the AV1 tools and AVIF properties
libaom and libavif write on request, and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_tools/make_avif_tools.py

Pillow's AVIF plugin (libavif 1.3 with libaom) writes 8-bit files:

- quantizer matrices (``enable-qm``, and ``tune=iq``, libaom's tune for
  still images, which adds delta q and chroma quantizer deltas);
- delta q (``deltaq-mode=2``) and delta LF (with ``delta-lf-mode=1``,
  and with ``tune=iq``, where DeltaLF changes from superblock to
  superblock);
- film grain from libaom's test vectors (``film-grain-test``: with and
  without overlap, chroma scaled from luma, no chroma points, each lag
  and grain scale) and estimated from the image (``denoise-noise-level``);
- the chroma palette (``tune-content=screen`` with ``enable-intrabc=0``)
  on ``text``, ``edges`` and ``mixed`` at quality 90, and ``edges`` in
  4:2:2;
- limited-range Y'UV (``range="limited"``), with and without alpha;
- every EXIF orientation, which Pillow writes as ``irot`` and ``imir``;
  and a ``clap`` box added to a file afterwards (``add_property``);
- ``tune-content=screen`` alone, which turns intrabc on at 256x256
  (still refused);
- a 3840x2160 4:2:0 frame (``chip_smoke.frame_4k``) at ``tune=iq`` with
  ``denoise-noise-level``, for the card to time quantizer matrices and
  film grain at a real size.

The system's ``libavif.so.15`` (0.11.1, with libaom) writes, through
ctypes (``libavif_encode``), the 10-bit film grain, 10-bit limited-range
(with and without alpha), 12-bit (4:2:0, 4:2:2, 4:4:4) and 10- and
12-bit chroma palette files.

The manifest holds, per file: how it was written; the CRC32 of dav1d's
Y'UV planes (the system libavif, each plane at its own size, as
little-endian uint16, concatenated); the shape, ``hbd`` flag and CRC32 of
the reference's ``load_avif`` pixels and the CRC32 of its
``decode_avif_to_rgb8`` pixels; and the count of each tool the port's
decoder met (``oavif_tpu_torch.io.avif.TOOL_NAMES``) or, for a refusal,
the tool it names. A file the reference cannot read is not written.
"""

from __future__ import annotations

import ctypes as C
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)

from chip_smoke import frame_4k, with_alpha  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

CROP = 128
SUBSAMPLINGS = ("4:2:0", "4:2:2", "4:4:4")
# libaom's film grain test vectors: 1 (no overlap, lag 2), 3 (grain scale
# shift 1), 6 (luma only), 10 (scaling shift 10), 15 (chroma from luma),
# 16 (grain scale shift 2)
GRAIN_TESTS = ("1", "3", "6", "10", "15", "16")


def _ss(ss: str) -> str:
    return ss.replace(":", "")


def pillow_files() -> dict:
    """name -> (RGB or RGBA pixels, Pillow save keywords)"""
    im = bench_images(256)
    crop = {k: v[:CROP, :CROP] for k, v in im.items()}
    files = {}
    for ss in SUBSAMPLINGS:
        files[f"qm_{_ss(ss)}_fractal.avif"] = (
            crop["fractal"], dict(subsampling=ss, quality=60,
                                  advanced={"enable-qm": "1"}))
        files[f"iq_{_ss(ss)}_mixed.avif"] = (
            im["mixed"][:CROP, 64:64 + CROP],
            dict(subsampling=ss, quality=70, advanced={"tune": "iq"}))
        files[f"grain_dnl_{_ss(ss)}_sinusoid.avif"] = (
            crop["sinusoid"], dict(subsampling=ss, quality=60,
                                   advanced={"denoise-noise-level": "20"}))
    for i, t in enumerate(GRAIN_TESTS):
        ss = SUBSAMPLINGS[i % 3]
        files[f"grain_test{t}_{_ss(ss)}_oriented.avif"] = (
            crop["oriented"][:96 + 8 * i, :112], dict(
                subsampling=ss, quality=60,
                advanced={"film-grain-test": t}))
    # libaom clips the grained samples to the restricted range in a
    # limited-range file
    files["grain_test1_limited_444_sinusoid.avif"] = (
        crop["sinusoid"], dict(subsampling="4:4:4", quality=60,
                               range="limited",
                               advanced={"film-grain-test": "1"}))
    for ss in ("4:2:0", "4:4:4"):
        for speed in (4, 6):
            files[f"deltaq_{_ss(ss)}_s{speed}_fractal.avif"] = (
                im["fractal"][:CROP, :256 - 32], dict(
                    subsampling=ss, quality=50, speed=speed,
                    advanced={"deltaq-mode": "2"}))
            files[f"deltalf_{_ss(ss)}_s{speed}_mixed.avif"] = (
                im["mixed"][64:64 + CROP, :256 - 32], dict(
                    subsampling=ss, quality=50, speed=speed,
                    advanced={"deltaq-mode": "2", "delta-lf-mode": "1"}))
    # libaom changes DeltaLF from superblock to superblock only under
    # tune=iq (deltaq-mode=2 moves it once, at the first superblock)
    for ss, cls in (("4:2:0", "mixed"), ("4:4:4", "sinusoid")):
        files[f"iq_deltalf_{_ss(ss)}_{cls}.avif"] = (
            im[cls], dict(subsampling=ss, quality=20,
                          advanced={"tune": "iq", "delta-lf-mode": "1"}))
    screen = {"tune-content": "screen", "enable-intrabc": "0"}
    for cls in ("text", "edges", "mixed"):
        for ss in ("4:2:0", "4:4:4"):
            files[f"uvpal_{_ss(ss)}_q90_{cls}.avif"] = (
                crop[cls], dict(subsampling=ss, quality=90, advanced=screen))
    files["uvpal_422_q90_edges.avif"] = (
        bench_images(128, ("edges",))["edges"],
        dict(subsampling="4:2:2", quality=90, advanced=screen))
    files["uvpal_444_q60_edges.avif"] = (
        crop["edges"], dict(subsampling="4:4:4", quality=60, advanced=screen))
    files["refuse_intrabc_444_edges.avif"] = (
        im["edges"], dict(subsampling="4:4:4", quality=60,
                          advanced={"tune-content": "screen"}))
    for ss in ("4:2:0", "4:4:4"):
        files[f"limited_{_ss(ss)}_mixed.avif"] = (
            crop["mixed"][:112], dict(subsampling=ss, quality=60,
                                      range="limited"))
        files[f"limited_{_ss(ss)}_rgba.avif"] = (
            with_alpha(crop["edges"][:104, :120]),
            dict(subsampling=ss, quality=60, range="limited"))
    for o in range(2, 9):
        files[f"orient{o}_420_fractal.avif"] = (
            crop["fractal"][:96], dict(subsampling="4:2:0", quality=60,
                                       exif=_orientation(o)))
    files["limited_512_orient6_420_mixed.avif"] = (
        bench_images(512, ("mixed",))["mixed"], dict(
            quality=60, range="limited", exif=_orientation(6)))
    files["iq_grain_photo4k_420.avif"] = (
        frame_4k(), dict(quality=60, advanced={
            "tune": "iq", "denoise-noise-level": "20"}))
    return files


def _orientation(o: int) -> bytes:
    exif = Image.Exif()
    exif[0x0112] = o
    return exif.tobytes()


# --- a property added to a written file ---------------------------------------


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), typ) + payload


def _children(data: bytes, start: int, end: int):
    pos = start
    while pos < end:
        size, typ = struct.unpack_from(">I4s", data, pos)
        yield typ, data[pos + 8:pos + size]
        pos += size


def _shift_iloc(payload: bytes, delta: int) -> bytes:
    """An iloc payload with every file offset of construction method 0
    moved by ``delta``."""
    b = bytearray(payload)
    version = b[0]
    off_size, len_size = b[4] >> 4, b[4] & 15
    base_size, index_size = b[5] >> 4, (b[5] & 15 if version else 0)
    pos = 6
    idsz = 2 if version < 2 else 4
    count = int.from_bytes(b[pos:pos + idsz], "big")
    pos += idsz

    def add(at, n):
        v = int.from_bytes(b[at:at + n], "big") + delta
        b[at:at + n] = v.to_bytes(n, "big")

    for _ in range(count):
        pos += idsz
        method = 0
        if version:
            method = int.from_bytes(b[pos:pos + 2], "big") & 15
            pos += 2
        pos += 2  # data_reference_index
        base_at = pos
        pos += base_size
        n = int.from_bytes(b[pos:pos + 2], "big")
        pos += 2
        if method == 0 and base_size:
            add(base_at, base_size)
        for _ in range(n):
            pos += index_size
            if method == 0 and not base_size:
                add(pos, off_size)
            pos += off_size + len_size
    return bytes(b)


def add_property(data: bytes, prop: bytes, essential: bool = False) -> bytes:
    """``data`` (ftyp, meta, mdat, as libavif writes them) with ``prop``
    appended to ``ipco`` and associated with the primary item."""
    top = list(_children(data, 0, len(data)))
    assert [t for t, _ in top][:2] == [b"ftyp", b"meta"]
    meta = top[1][1]
    kids = list(_children(meta, 4, len(meta)))
    primary = next(int.from_bytes(p[4:6], "big") for t, p in kids
                   if t == b"pitm")
    grown = len(prop) + 1
    out = []
    for typ, p in kids:
        if typ == b"iprp":
            sub = []
            for t2, p2 in _children(p, 0, len(p)):
                if t2 == b"ipco":
                    nprops = len(list(_children(p2, 0, len(p2))))
                    p2 = p2 + prop
                elif t2 == b"ipma":
                    version, flags = p2[0], int.from_bytes(p2[1:4], "big")
                    assert version == 0 and not flags & 1
                    q = bytearray(p2[:8])
                    pos = 8
                    for _ in range(int.from_bytes(p2[4:8], "big")):
                        item = int.from_bytes(p2[pos:pos + 2], "big")
                        n = p2[pos + 2]
                        entry = bytearray(p2[pos:pos + 3 + n])
                        if item == primary:
                            entry[2] += 1
                            entry.append((0x80 if essential else 0)
                                         | (nprops + 1))
                        q += entry
                        pos += 3 + n
                    p2 = bytes(q)
                sub.append(_box(t2, p2))
            p = b"".join(sub)
        out.append((typ, p))
    head = top[0]
    out = [(t, _shift_iloc(p, grown) if t == b"iloc" else p) for t, p in out]
    new_meta = _box(b"meta", meta[:4] + b"".join(_box(t, p) for t, p in out))
    assert len(new_meta) == 8 + len(meta) + grown
    return (_box(head[0], head[1]) + new_meta
            + b"".join(_box(t, p) for t, p in top[2:]))


def clap_files() -> dict:
    """name -> bytes: a Pillow file with a clean aperture added, centred
    and off centre (offsets as signed 32-bit fractions)."""
    src = bench_images(256, ("edges",))["edges"][:96, :128]
    out = {}
    for name, fields in (("clap_centred", (100, 1, 80, 1, 0, 1, 0, 1)),
                         ("clap_offset", (64, 1, 48, 1, -8 & 0xFFFFFFFF, 1,
                                          12, 2))):
        buf = io.BytesIO()
        Image.fromarray(src).save(buf, "AVIF", max_threads=1, quality=60)
        clap = _box(b"clap", struct.pack(">8I", *fields))
        out[f"{name}_420_edges.avif"] = add_property(buf.getvalue(), clap,
                                                     essential=True)
    return out


# --- libavif 0.11.1 through ctypes ------------------------------------------

_FORMATS = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3}


def _libavif() -> C.CDLL:
    """The system libavif 0.11.1 with the signatures both writers use."""
    lib = C.CDLL("libavif.so.15")
    lib.avifImageCreate.restype = C.c_void_p
    lib.avifImageCreate.argtypes = [C.c_int, C.c_int, C.c_int, C.c_int]
    lib.avifRGBImageSetDefaults.argtypes = [C.c_void_p, C.c_void_p]
    lib.avifImageRGBToYUV.argtypes = [C.c_void_p, C.c_void_p]
    lib.avifEncoderCreate.restype = C.c_void_p
    lib.avifEncoderDestroy.argtypes = [C.c_void_p]
    lib.avifImageDestroy.argtypes = [C.c_void_p]
    lib.avifRWDataFree.argtypes = [C.c_void_p]
    return lib


def avif_image(lib: C.CDLL, px: np.ndarray, depth: int, ss: str,
               cicp=(2, 2, 6), full: bool = True,
               premultiplied: bool = False) -> int:
    """An avifImage (the caller destroys it) of 8-bit RGB or RGBA at
    ``depth`` bits in ``ss``, with the given CICP and range; with
    ``premultiplied`` the colour is premultiplied by the alpha as it is
    converted (a file written from it carries ``prem``)."""
    h, w, ch = px.shape
    img = lib.avifImageCreate(w, h, depth, _FORMATS[ss])
    # avifImage (0.11): yuvRange at byte 16, alphaPremultiplied at 80
    u32 = C.cast(C.c_void_p(img), C.POINTER(C.c_uint32))
    u32[4] = int(full)
    u32[20] = int(premultiplied)
    # avifImage (0.11): colorPrimaries, transferCharacteristics and
    # matrixCoefficients are the uint16 at byte 104
    u16 = C.cast(C.c_void_p(img), C.POINTER(C.c_uint16))
    u16[52], u16[53], u16[54] = cicp
    px = np.ascontiguousarray(px)
    rgbimg = (C.c_uint8 * 128)()
    lib.avifRGBImageSetDefaults(C.addressof(rgbimg), img)
    fields = np.frombuffer(rgbimg, dtype=np.uint32)
    fields[2] = 8  # depth
    fields[3] = 0 if ch == 3 else 1  # AVIF_RGB_FORMAT_RGB / _RGBA
    C.c_void_p.from_buffer(rgbimg, 40).value = px.ctypes.data
    fields[48 // 4] = ch * w
    if lib.avifImageRGBToYUV(img, C.addressof(rgbimg)):
        lib.avifImageDestroy(img)
        raise RuntimeError("avifImageRGBToYUV")
    return img


def libavif_encode(px: np.ndarray, depth: int, ss: str, quantizer: int,
                   speed: int = 6, cicp=(2, 2, 6), full: bool = True,
                   options: dict = (), premultiplied: bool = False) -> bytes:
    """An AVIF of 8-bit RGB or RGBA at ``depth`` bits in ``ss``, written
    by libavif 0.11.1 with libaom at one quantizer, with the given CICP,
    range, libaom options (avifEncoderSetCodecSpecificOption) and alpha
    premultiplication."""
    lib = _libavif()
    lib.avifEncoderSetCodecSpecificOption.argtypes = [
        C.c_void_p, C.c_char_p, C.c_char_p]
    lib.avifEncoderWrite.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p]
    img = avif_image(lib, px, depth, ss, cicp, full, premultiplied)
    enc = lib.avifEncoderCreate()
    e32 = C.cast(C.c_void_p(enc), C.POINTER(C.c_int32))
    # avifEncoder (0.11): codecChoice, maxThreads, speed, keyframeInterval,
    # timescale (u64), minQuantizer, maxQuantizer, minQuantizerAlpha,
    # maxQuantizerAlpha
    e32[0], e32[1], e32[2] = 1, 1, speed  # AVIF_CODEC_CHOICE_AOM
    e32[6] = e32[7] = quantizer
    e32[8] = e32[9] = 0
    for k, v in dict(options).items():
        lib.avifEncoderSetCodecSpecificOption(enc, k.encode(), v.encode())
    out = (C.c_void_p * 2)()
    try:
        if lib.avifEncoderWrite(enc, img, out):
            raise RuntimeError("avifEncoderWrite")
        data = C.string_at(out[0], out[1])
    finally:
        lib.avifRWDataFree(out)
        lib.avifEncoderDestroy(enc)
        lib.avifImageDestroy(img)
    return data


def libavif_files() -> dict:
    """name -> (bytes, how it was written)"""
    im = bench_images(256)
    src = im["mixed"][:CROP, :CROP]
    out = {}

    def add(name, px, depth, ss, q, **kw):
        how = {"writer": "libavif 0.11.1 (libaom)", "depth": depth,
               "subsampling": ss, "quantizer": q, "speed": kw.get("speed", 6),
               **{k: v for k, v in kw.items() if k != "options"},
               **dict(kw.get("options", {}))}
        out[name] = (libavif_encode(px, depth, ss, q, **kw), how)

    for ss in SUBSAMPLINGS:
        add(f"grain10_test{3 if ss == '4:2:2' else 4}_{_ss(ss)}.avif",
            im["oriented"][:96, :CROP], 10, ss, 30,
            options={"film-grain-test": "3" if ss == "4:2:2" else "4"})
        add(f"grain10_dnl_{_ss(ss)}.avif", im["sinusoid"][:CROP, :96], 10,
            ss, 30, options={"denoise-noise-level": "25"})
        add(f"twelve_{_ss(ss)}_mixed.avif", src, 12, ss, 24)
    add("twelve_444_qm_fractal.avif", im["fractal"][:CROP, :CROP], 12,
        "4:4:4", 28, options={"enable-qm": "1"})
    add("twelve_420_grain_fractal.avif", im["fractal"][:96, :96], 12,
        "4:2:0", 28, options={"film-grain-test": "2"})
    screen = {"tune-content": "screen", "enable-intrabc": "0"}
    edges = bench_images(128, ("edges",))["edges"]
    add("uvpal10_422_edges.avif", edges, 10, "4:2:2", 10, options=screen)
    add("uvpal12_444_edges.avif", edges, 12, "4:4:4", 10, options=screen)
    for ss in ("4:2:0", "4:4:4"):
        add(f"limited10_{_ss(ss)}_mixed.avif", src[:120], 10, ss, 24,
            full=False)
        add(f"limited10_{_ss(ss)}_rgba.avif", with_alpha(im["edges"][:96, :112]),
            10, ss, 24, full=False)
    return out


# --- manifest -----------------------------------------------------------------


def crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def manifest_entry(name: str, how: dict):
    """The file's manifest entry, or None where the reference cannot
    read it."""
    from oavif_tpu.io.image import decode_avif_to_rgb8, load_avif
    from oavif_tpu_torch.io import avif as A
    from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv

    path = os.path.join(HERE, name)
    with open(path, "rb") as f:
        data = f.read()
    try:
        img = load_avif(path)
        rgb8 = decode_avif_to_rgb8(data)
        planes, depth, _ = decode_to_yuv(data)
    except Exception as e:  # the reference cannot read it: no fixture
        print(f"  the reference cannot read {name}: {e}")
        return None
    entry = {"bytes": len(data), "written": how,
             "load_shape": list(img.data.shape), "load_hbd": img.hbd,
             "load_crc": crc(img.data), "icc": len(img.icc or b""),
             "rgb8_crc": crc(rgb8), "depth": depth,
             "yuv_crc": crc(np.concatenate(
                 [p.astype("<u2").reshape(-1) for p in planes
                  if p is not None]))}
    try:
        _, port, _ = A.decode_avif(data)
        entry["tools"] = port.tools
    except A.UnsupportedAvif as e:
        entry["refuses"] = str(e).split(": ", 1)[1].split(" is not")[0]
    return entry


def main() -> None:
    manifest = {}

    def keep(name, data, how):
        print(name, flush=True)
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        entry = manifest_entry(name, how)
        if entry is None:
            os.remove(path)
        else:
            manifest[name] = entry

    for name, (px, kw) in pillow_files().items():
        buf = io.BytesIO()
        mode = "RGBA" if px.shape[2] == 4 else "RGB"
        Image.fromarray(px, mode).save(buf, "AVIF", max_threads=1, **kw)
        how = {"writer": "Pillow (libavif 1.3, libaom)",
               **{k: v for k, v in kw.items() if k not in ("advanced", "exif")},
               **kw.get("advanced", {})}
        if "exif" in kw:
            e = Image.Exif()
            e.load(kw["exif"])
            how["orientation"] = int(e[0x0112])
        keep(name, buf.getvalue(), how)
    for name, data in clap_files().items():
        keep(name, data, {"writer": "Pillow (libavif 1.3, libaom)",
                          "quality": 60, "clap": name.split("_")[1]})
    for name, (data, how) in libavif_files().items():
        keep(name, data, how)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
