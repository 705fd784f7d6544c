"""Regenerate the libaom-written AVIF fixtures of
``tests/test_torch_avif_aom.py`` and ``chip_smoke.py`` and their
``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_aom/make_avif_aom.py

Pillow's AVIF plugin (libavif 1.3 with libaom) writes 8-bit streams:

- the grid: 4:2:0, 4:2:2 and 4:4:4 at speeds 0, 2, 4, 6, 8 and 10 and
  qualities 30, 60 and 95, each on a 96x96 crop of one of the six bench
  classes (the class turns with the cell);
- CDEF with a strength set per 64x64 (libaom's ``enable-cdef``, which
  libavif 1.3 leaves off by default) on a 512x512 crop of ``mixed`` in
  each subsampling;
- the six bench classes at 512x512, a 509x383 frame, an RGBA frame
  (``chip_smoke.with_alpha``) and ``chip_smoke.frame_4k()`` at Pillow's
  defaults (4:2:0, speed 6) and quality 60 (``chip_smoke.py`` runs the
  CLI on the classes and the 3840x2160 frame).

The system's ``libavif.so.15`` (0.11.1, with libaom's encoder) writes,
through ctypes, 10-bit 4:2:0 and 4:2:2 streams and a 12-bit one (which the
port refused, naming 12-bit, until it learned 12-bit; the file keeps its
name).

The manifest holds, per file: how it was written; the CRC32 of dav1d's
Y'UV planes (the system libavif, each plane at its own size, as
little-endian uint16, concatenated); the shape, ``hbd`` flag and CRC32 of
the reference's ``load_avif`` pixels and the CRC32 of its
``decode_avif_to_rgb8`` pixels; and the count of each tool the port's
decoder met (``oavif_tpu_torch.io.avif.TOOL_NAMES``) or, for a refusal,
the tool it names.
"""

from __future__ import annotations

import ctypes as C
import io
import json
import os
import sys
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)

from chip_smoke import frame_4k, with_alpha  # noqa: E402
from oavif_tpu_torch.scripts.corpus import CLASSES, bench_images  # noqa: E402

CROP = 96
SUBSAMPLINGS = ("4:2:0", "4:2:2", "4:4:4")
SPEEDS = (0, 2, 4, 6, 8, 10)
QUALITIES = (30, 60, 95)


def pillow_files() -> dict:
    """name -> (RGB or RGBA pixels, Pillow save keywords)"""
    images = bench_images(256)
    big = bench_images(512, ("mixed",))["mixed"]
    files = {}
    i = 0
    for ss in SUBSAMPLINGS:
        for speed in SPEEDS:
            for q in QUALITIES:
                cls = CLASSES[i % len(CLASSES)]
                i += 1
                name = f"g{ss.replace(':', '')}_s{speed}_q{q}_{cls}.avif"
                files[name] = (images[cls][:CROP, :CROP],
                               dict(subsampling=ss, speed=speed, quality=q))
    for ss in SUBSAMPLINGS:
        files[f"cdef64_{ss.replace(':', '')}_mixed512.avif"] = (
            big, dict(subsampling=ss, speed=6, quality=75,
                      advanced={"enable-cdef": "1"}))
    classes = bench_images(512)
    for cls in CLASSES:
        files[f"class_{cls}_420.avif"] = (classes[cls], dict(quality=60))
    mixed = classes["mixed"]
    files["odd_509x383_420.avif"] = (mixed[:383, :509],
                                     dict(subsampling="4:2:0", quality=60))
    files["rgba_420.avif"] = (with_alpha(images["mixed"][:128, :128]),
                              dict(subsampling="4:2:0", quality=60))
    files["photo4k_420_q60.avif"] = (frame_4k(), dict(quality=60))
    return files


# --- libavif 0.11.1 through ctypes ------------------------------------------

_FORMATS = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3}


def libavif_encode(rgb: np.ndarray, depth: int, ss: str, quantizer: int,
                   speed: int = 6, cicp=(2, 2, 6)) -> bytes:
    """An AVIF of 8-bit RGB at ``depth`` bits in ``ss``, full range, with
    the given CICP (libavif's own default 2/2/6), written by libavif
    0.11.1 with libaom at one quantizer."""
    lib = C.CDLL("libavif.so.15")
    lib.avifImageCreate.restype = C.c_void_p
    lib.avifImageCreate.argtypes = [C.c_int, C.c_int, C.c_int, C.c_int]
    lib.avifRGBImageSetDefaults.argtypes = [C.c_void_p, C.c_void_p]
    lib.avifImageRGBToYUV.argtypes = [C.c_void_p, C.c_void_p]
    lib.avifEncoderCreate.restype = C.c_void_p
    lib.avifEncoderWrite.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p]
    lib.avifEncoderDestroy.argtypes = [C.c_void_p]
    lib.avifImageDestroy.argtypes = [C.c_void_p]
    lib.avifRWDataFree.argtypes = [C.c_void_p]
    h, w = rgb.shape[:2]
    img = lib.avifImageCreate(w, h, depth, _FORMATS[ss])
    C.cast(C.c_void_p(img), C.POINTER(C.c_uint32))[4] = 1  # yuvRange full
    # avifImage (0.11): colorPrimaries, transferCharacteristics and
    # matrixCoefficients are the uint16 at byte 104
    u16 = C.cast(C.c_void_p(img), C.POINTER(C.c_uint16))
    u16[52], u16[53], u16[54] = cicp
    px = np.ascontiguousarray(rgb[..., :3])
    rgbimg = (C.c_uint8 * 128)()
    lib.avifRGBImageSetDefaults(C.addressof(rgbimg), img)
    fields = np.frombuffer(rgbimg, dtype=np.uint32)
    fields[2] = 8  # depth
    fields[3] = 0  # AVIF_RGB_FORMAT_RGB
    C.c_void_p.from_buffer(rgbimg, 40).value = px.ctypes.data
    fields[48 // 4] = 3 * w
    if lib.avifImageRGBToYUV(img, C.addressof(rgbimg)):
        raise RuntimeError("avifImageRGBToYUV")
    enc = lib.avifEncoderCreate()
    e32 = C.cast(C.c_void_p(enc), C.POINTER(C.c_int32))
    # avifEncoder (0.11): codecChoice, maxThreads, speed, keyframeInterval,
    # timescale (u64), minQuantizer, maxQuantizer
    e32[0], e32[1], e32[2] = 1, 1, speed  # AVIF_CODEC_CHOICE_AOM
    e32[6] = e32[7] = quantizer
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
    """name -> (bytes, how it was written, refused tool or None)"""
    src = bench_images(256, ("mixed",))["mixed"][:160, :176]
    out = {}
    for depth, ss in ((10, "4:2:0"), (10, "4:2:2"), (12, "4:2:0")):
        name = (f"tenbit_{ss.replace(':', '')}.avif" if depth == 10
                else "refuse_12bit_420.avif")
        how = {"writer": "libavif 0.11.1 (libaom)", "depth": depth,
               "subsampling": ss, "quantizer": 24, "speed": 6}
        out[name] = (libavif_encode(src, depth, ss, 24), how, None)
    return out


# --- manifest -----------------------------------------------------------------


def crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def manifest_entry(name: str, how: dict, refuses) -> dict:
    from oavif_tpu.io.image import decode_avif_to_rgb8, load_avif
    from oavif_tpu_torch.io import avif as A
    from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv

    path = os.path.join(HERE, name)
    with open(path, "rb") as f:
        data = f.read()
    img = load_avif(path)
    planes, depth, _ = decode_to_yuv(data)
    entry = {"bytes": len(data), "written": how,
             "load_shape": list(img.data.shape), "load_hbd": img.hbd,
             "load_crc": crc(img.data), "icc": len(img.icc or b""),
             "rgb8_crc": crc(decode_avif_to_rgb8(data)), "depth": depth,
             "yuv_crc": crc(np.concatenate(
                 [p.astype("<u2").reshape(-1) for p in planes
                  if p is not None]))}
    if refuses:
        entry["refuses"] = refuses
    else:
        _, port, _ = A.decode_avif(data)
        entry["tools"] = port.tools
    return entry


def main() -> None:
    manifest = {}
    for name, (px, kw) in pillow_files().items():
        print(name, flush=True)
        buf = io.BytesIO()
        mode = "RGBA" if px.shape[2] == 4 else "RGB"
        Image.fromarray(px, mode).save(buf, "AVIF", max_threads=1, **kw)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(buf.getvalue())
        how = {"writer": "Pillow (libavif 1.3, libaom)",
               **{k: v for k, v in kw.items() if k != "advanced"},
               **kw.get("advanced", {})}
        manifest[name] = manifest_entry(name, how, None)
    for name, (data, how, refuses) in libavif_files().items():
        print(name, flush=True)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = manifest_entry(name, how, refuses)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
