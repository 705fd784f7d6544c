"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_ispe.py`` and
``chip_smoke.py``: frames whose ``ispe`` differs from their coded size,
which libavif 1.3 scales to the ``ispe`` size (avifImageScale, libyuv's
ScalePlane in its box filter mode), and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_ispe/make_avif_ispe.py

libaom 3.6.0 writes each 256x256 frame through ctypes
(``avif_superres/make_avif_superres.aom_encode``, all-intra usage) and
the port's ``mux_avif`` wraps it; then every ``ispe`` of the file (the
colour item's and the alpha item's) is rewritten. The set: 4:2:0 8-bit
at 128x128 (libyuv's 2x2 box), 512x512 (its 2x bilinear), 256x255 (its
vertical filter) and 300x200 (its bilinear up in width, down in height,
columns with the SIMD filter's 7-bit fractions); alpha at 200x300; 4:2:0
10-bit at 384x384 and 4:4:4 10-bit at 192x160 (the reference's 10-bit
route through the system libavif 0.11.1, which scales the same way);
odd sizes with subsampled chroma (255x257); a frame more than twice
as tall as its ``ispe`` (96x64: libyuv's box filter proper, which the
port refuses, ``refuses``); and an ``ispe`` past libavif's size limits
(65536x1), which neither reader opens (``raises``: the reference's and
the port's exceptions).

The manifest holds, per file, how it was written; the CRC32 of dav1d's
Y'UV planes (the system libavif 0.11.1, which scales to ``ispe`` too),
the shape, ``hbd`` flag and CRC32 of the reference's ``load_avif``
pixels and the CRC32 of its ``decode_avif_to_rgb8`` pixels, and the
coded size.
"""

from __future__ import annotations

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

from chip_smoke import with_alpha  # noqa: E402
from make_avif_superres import LIBAOM, encode_avif  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402


def with_ispe(data: bytes, width: int, height: int) -> bytes:
    """``data`` with every ``ispe`` property saying width x height."""
    out = bytearray(data)
    at = 0
    while (at := out.find(b"ispe", at)) >= 0:
        out[at + 8:at + 16] = struct.pack(">II", width, height)
        at += 4
    return bytes(out)


def files() -> dict:
    """name -> (pixels, encode_avif's arguments, ispe)"""
    im = bench_images(256)
    return {
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
    }


def crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def manifest_entry(name: str, data: bytes, how: dict) -> dict:
    from oavif_tpu.io.image import decode_avif_to_rgb8, load_avif
    from oavif_tpu_torch.io import avif as A
    from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv

    path = os.path.join(HERE, name)
    entry = {"bytes": len(data), "written": how}
    av1 = A.parse_av1(A.read_container(data).color.payload)
    entry["coded"] = [av1.frame.width, av1.frame.height]
    try:
        img = load_avif(path)
    except Exception as e:
        try:
            A.decode_avif(data)
        except (A.UnsupportedAvif, OSError) as p:
            entry.update(raises=str(e).replace(path, name),
                         port=type(p).__name__, port_says=str(p))
            return entry
        raise RuntimeError(f"{name}: the reference raises, the port reads")
    planes, depth, _ = decode_to_yuv(data)
    entry.update(load_shape=list(img.data.shape), load_hbd=img.hbd,
                 load_crc=crc(img.data), icc=len(img.icc or b""),
                 rgb8_crc=crc(decode_avif_to_rgb8(data)), depth=depth,
                 yuv_crc=crc(np.concatenate(
                     [p.astype("<u2").reshape(-1) for p in planes
                      if p is not None])))
    try:
        A.decode_avif(data)
    except A.UnsupportedAvif as e:
        entry["refuses"] = "box downscale"
        assert entry["refuses"] in str(e), e
    return entry


def main() -> None:
    manifest = {}
    for name, (px, kw, (w, h)) in files().items():
        data = with_ispe(encode_avif(px, **kw), w, h)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = manifest_entry(name, data, {
            "writer": LIBAOM, **kw, "ispe": [w, h]})
        print(name, len(data), manifest[name].get("raises", "reads"),
              flush=True)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
