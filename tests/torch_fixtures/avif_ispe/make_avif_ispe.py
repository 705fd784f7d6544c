"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_ispe.py`` and
``chip_smoke.py``: frames whose ``ispe`` differs from their coded size,
which libavif 1.3 scales to the ``ispe`` size (avifImageScale, libyuv's
ScalePlane in its box filter mode), and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_ispe/make_avif_ispe.py

libaom 3.6.0 writes each frame through ctypes
(``avif_superres/make_avif_superres.aom_encode``, all-intra usage) and
the port's ``mux_avif`` wraps it; then every ``ispe`` of the file (the
colour item's and the alpha item's) is rewritten, and where asked the
``colr`` box's matrix. The set, 256x256 frames unless named otherwise:
4:2:0 8-bit at 128x128 (libyuv's 2x2 box), 512x512 (its 2x bilinear),
256x255 (its vertical filter) and 300x200 (its bilinear up in width,
down in height, columns with the SIMD filter's 7-bit fractions); alpha
at 200x300; 4:2:0 10-bit at 384x384 and 4:4:4 10-bit at 192x160; odd
sizes with subsampled chroma (255x257); and each of libyuv's box-mode
routes past those (``ROUTES``): the box filter proper (a frame more than
twice as tall and as wide as its ``ispe``: 96x64, 64x96, 97x61 in
4:2:2), 3/4 (192x192), 3/8 (96x96), 1/4 (64x64) and point sampling (a
384x256 frame at 128x256), at 8 bits in 4:2:0, at 10 bits in 4:4:4
full-range BT.601 without alpha (the reference's high-bit-depth route
through the system libavif 0.11.1), at 10 bits with alpha or BT.709
(Pillow's route) and at 12 bits; a 1040x1040 frame of the mixed class
at 512x512 (the box filter) for the CLI; and an ``ispe`` past libavif's
size limits (65536x1), which neither reader opens (``raises``: the
reference's and the port's exceptions). ``refuse_box_96x64.avif`` keeps
the name it had while the port refused the box filter.

The manifest also holds ``REWRITES``: two 3840x2160 files of other
folders (8-bit 4:2:0 on Pillow's route, 10-bit 4:4:4 on the system's),
each at four ``ispe`` sizes rewritten in memory (1280x720: the box
filter; 2880x1620: 3/4; 1440x810: 3/8; 960x540: 1/4), with no bytes of
their own (``source`` and ``ispe`` name them).

The manifest holds, per file, how it was written; the libyuv route its
luma plane takes (``route``) and the reference reader's (``reader``:
``system`` where ``load_avif`` takes the system libavif's high-bit-depth
route, else ``pillow``); the CRC32 of dav1d's Y'UV planes (the system
libavif 0.11.1, which scales to ``ispe`` too), the shape, ``hbd`` flag
and CRC32 of the reference's ``load_avif`` pixels and the CRC32 of its
``decode_avif_to_rgb8`` pixels, and the coded size.
"""

from __future__ import annotations

import functools
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "avif_superres"))

from chip_smoke import with_alpha, with_ispe  # noqa: E402
from make_avif_superres import LIBAOM, encode_avif  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402


def with_matrix(data: bytes, mc: int) -> bytes:
    """``data`` with its ``colr`` box's nclx stating primaries and matrix
    ``mc`` (the transfer and range kept)."""
    out = bytearray(data)
    at = out.index(b"nclx") + 4
    out[at:at + 2] = struct.pack(">H", mc)
    out[at + 4:at + 6] = struct.pack(">H", mc)
    return bytes(out)


def _frame(cls: str, w: int, h: int) -> np.ndarray:
    return bench_images(max(w, h), (cls,))[cls][:h, :w]


# libyuv's routes past the bilinear ones: name -> (frame w, h, ispe w, h)
ROUTES = {"box": (256, 256, 96, 64), "34": (256, 256, 192, 192),
          "38": (256, 256, 96, 96), "14": (256, 256, 64, 64),
          "point": (384, 256, 128, 256)}


@functools.lru_cache(maxsize=1)
def files() -> dict:
    """name -> (pixels, encode_avif's arguments, ispe[, matrix])"""
    im = bench_images(256)
    out = {
        "ispe_128x128.avif": (im["mixed"], dict(depth=8, ss="4:2:0",
                                                quantizer=24), (128, 128)),
        "ispe_512x512.avif": (im["mixed"], dict(depth=8, ss="4:2:0",
                                                quantizer=24), (512, 512)),
        "ispe_256x255.avif": (im["edges"], dict(depth=8, ss="4:2:0",
                                                quantizer=30), (256, 255)),
        "ispe_300x200.avif": (im["fractal"], dict(depth=8, ss="4:2:0",
                                                  quantizer=30), (300, 200)),
        "ispe_255x257_odd.avif": (im["text"], dict(depth=8, ss="4:2:0",
                                                   quantizer=20), (255, 257)),
        "alpha_ispe_200x300.avif": (with_alpha(im["oriented"]), dict(
            depth=8, ss="4:2:0", quantizer=28), (200, 300)),
        "ispe_384x384_10bit.avif": (im["sinusoid"], dict(
            depth=10, ss="4:2:0", quantizer=26), (384, 384)),
        "ispe_192x160_444_10bit.avif": (im["mixed"], dict(
            depth=10, ss="4:4:4", quantizer=26), (192, 160)),
        "refuse_box_96x64.avif": (im["mixed"], dict(depth=8, ss="4:2:0",
                                                    quantizer=24), (96, 64)),
        "huge_ispe_65536x1.avif": (im["mixed"], dict(
            depth=8, ss="4:2:0", quantizer=24), (65536, 1)),
        "ispe_64x96_box.avif": (im["oriented"], dict(
            depth=8, ss="4:2:0", quantizer=24), (64, 96)),
        "ispe_97x61_422_box.avif": (im["fractal"], dict(
            depth=8, ss="4:2:2", quantizer=28), (97, 61)),
        "class_mixed_512_box.avif": (_frame("mixed", 1040, 1040), dict(
            depth=8, ss="4:2:0", quantizer=30), (512, 512)),
    }
    # each route at 8 bits (4:2:0), on the reference's system route (10
    # bits, 4:4:4, BT.601, no alpha) and on Pillow's at 10 bits (alpha,
    # or BT.709: matrix 1), the 3/4 route at 12 bits as well
    classes = dict(zip(ROUTES, ("edges", "fractal", "text", "sinusoid",
                                "mixed")))
    for route, (fw, fh, w, h) in ROUTES.items():
        px = _frame(classes[route], fw, fh)
        out[f"r8_{route}_{w}x{h}.avif"] = (px, dict(
            depth=8, ss="4:2:0", quantizer=26), (w, h))
        out[f"sys10_{route}_{w}x{h}.avif"] = (px, dict(
            depth=10, ss="4:4:4", quantizer=26), (w, h))
        if route in ("34", "14"):
            out[f"bt709_10_{route}_{w}x{h}.avif"] = (px, dict(
                depth=10, ss="4:4:4", quantizer=30), (w, h), 1)
        else:
            out[f"alpha10_{route}_{w}x{h}.avif"] = (with_alpha(px), dict(
                depth=10, ss="4:4:4" if route != "38" else "4:2:0",
                quantizer=30), (w, h))
    out["sys12_34_192x192.avif"] = (im["oriented"], dict(
        depth=12, ss="4:4:4", quantizer=26), (192, 192))
    return out


# 3840x2160 files of other folders, their ispe rewritten in memory:
# name -> (path under tests/torch_fixtures, ispe)
REWRITES = {
    f"{stem}@{w}x{h}": (path, (w, h))
    for stem, path in (("photo4k_420_q60", "avif_aom/photo4k_420_q60.avif"),
                       ("photo4k_q60_10bit", "avif/photo4k_q60.avif"))
    for w, h in ((1280, 720), (2880, 1620), (1440, 810), (960, 540))}


def write(name: str) -> bytes:
    """The bytes of fixture ``name`` (of ``files``) or of rewrite ``name``
    (of ``REWRITES``)."""
    if name in REWRITES:
        path, (w, h) = REWRITES[name]
        with open(os.path.join(os.path.dirname(HERE), path), "rb") as f:
            return with_ispe(f.read(), w, h)
    px, kw, (w, h), *matrix = files()[name]
    data = with_ispe(encode_avif(px, **kw), w, h)
    return with_matrix(data, matrix[0]) if matrix else data


def crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def manifest_entry(name: str, data: bytes, how: dict) -> dict:
    import tempfile

    from oavif_tpu.io.image import decode_avif_to_rgb8, load_avif
    from oavif_tpu_torch.io import avif as A
    from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv
    from oavif_tpu_torch.io.yuv_scale import route

    entry = {"bytes": len(data), "written": how}
    av1 = A.parse_av1(A.read_container(data).color.payload)
    entry["coded"] = [av1.frame.width, av1.frame.height]
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, name.split("@")[0])
        with open(path, "wb") as f:
            f.write(data)
        try:
            img = load_avif(path)
        except Exception as e:
            try:
                A.decode_avif(data)
            except OSError as p:
                entry.update(raises=str(e).replace(path, name),
                             port=type(p).__name__, port_says=str(p))
                return entry
            raise RuntimeError(f"{name}: the reference raises, the port "
                               f"reads")
    planes, depth, _ = decode_to_yuv(data)
    w, h = how["ispe"]
    entry.update(load_shape=list(img.data.shape), load_hbd=img.hbd,
                 load_crc=crc(img.data), icc=len(img.icc or b""),
                 rgb8_crc=crc(decode_avif_to_rgb8(data)), depth=depth,
                 yuv_crc=crc(np.concatenate(
                     [p.astype("<u2").reshape(-1) for p in planes
                      if p is not None])),
                 route=route(*entry["coded"], w, h),
                 reader="system" if img.hbd else "pillow")
    return entry


def main() -> None:
    manifest = {}
    for name, (px, kw, (w, h), *matrix) in files().items():
        data = write(name)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        how = {"writer": LIBAOM, **kw, "ispe": [w, h]}
        if matrix:
            how["matrix"] = matrix[0]
        manifest[name] = manifest_entry(name, data, how)
        print(name, len(data), manifest[name].get("raises", "reads"),
              flush=True)
    for name, (path, (w, h)) in REWRITES.items():
        manifest[name] = manifest_entry(name, write(name), {
            "source": path, "ispe": [w, h]})
        print(name, manifest[name]["route"], flush=True)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
