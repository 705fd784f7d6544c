"""Regenerate the JPEG fixtures of ``tests/test_torch_jpeg.py`` and
``chip_smoke.py`` and their ``manifest.json``.

    python tests/torch_fixtures/jpeg/make_jpeg.py [--writer PATH]

Pillow writes the six bench classes at 512x512 (q85, 4:2:0, baseline),
the ``text`` class in the variants below (at 512x512, 256x256 or
509x383: the directory stays under 2 MB), and ``chip_smoke.frame_4k()`` as
a 3840x2160 q75 4:2:0 baseline file. The variants Pillow cannot write
(4:4:0, 4:1:1, one component per sequential scan, YCCK, arithmetic coding
sequential and progressive with DAC conditioning, and progressive scan
scripts that leave coefficients unrefined, which libjpeg block-smooths)
come from ``jpeg_writer.c`` beside this script, a libjpeg-turbo program:
build it
(``cc -O2 -o jpeg_writer jpeg_writer.c -ljpeg``) and pass it as
``--writer`` to write them again; without it the files in the directory
are kept. The manifest holds, for every file, the shape and channels of
Pillow's decode (gray stays 1 channel, everything else is converted to
RGB, as the reference's ``load_jpeg`` does), the CRC32 of those pixels
and of the ICC profile.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from chip_smoke import frame_4k  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

VARIANT_CLASS = "text"
ICC_BYTES = 70000  # over 65,519 bytes: two APP2 chunks


def pillow_files() -> dict:
    """name -> (pixels, Pillow's save keywords)"""
    images = bench_images()
    files = {f"{n}.jpg": (rgb, dict(quality=85, subsampling=2))
             for n, rgb in images.items()}
    src = images[VARIANT_CLASS]
    v = VARIANT_CLASS
    icc = np.random.default_rng(41).integers(0, 256, ICC_BYTES,
                                             dtype=np.uint8).tobytes()
    odd = bench_images(512, (VARIANT_CLASS,))[VARIANT_CLASS][:383, :509]
    small = src[:256, :256]
    cmyk = np.concatenate([255 - small,
                           np.min(small, -1, keepdims=True) // 2], -1)
    files.update({
        f"{v}_444_progressive_q95.jpg": (src, dict(
            quality=95, subsampling=0, progressive=True)),
        f"{v}_422_optimize.jpg": (src, dict(quality=85, subsampling=1,
                                            optimize=True)),
        f"{v}_restart.jpg": (src, dict(quality=85, subsampling=2,
                                       restart_marker_blocks=5)),
        f"{v}_restart_progressive.jpg": (small, dict(
            quality=85, subsampling=2, progressive=True,
            restart_marker_blocks=3)),
        f"{v}_gray.jpg": (small[..., 1], dict(quality=85)),
        f"{v}_cmyk.jpg": (cmyk, dict(quality=85)),
        f"{v}_icc.jpg": (small, dict(quality=85, icc_profile=icc)),
        f"{v}_odd_509x383.jpg": (odd, dict(quality=85, subsampling=2)),
        "photo4k.jpg": (frame_4k(), dict(quality=75, subsampling=2)),
    })
    return files


# name -> the writer's variant, at 256x256 of the variant class (the
# last two at 128x128); smoothed: no luma AC refinement; smoothed_dc: the
# DC left at Al = 1 and no chroma AC at all (libjpeg then estimates the
# DC from a 5x5 neighbourhood)
WRITER_FILES = {f"{VARIANT_CLASS}_440.jpg": "440",
                f"{VARIANT_CLASS}_411.jpg": "411",
                f"{VARIANT_CLASS}_noninterleaved.jpg": "noninterleaved",
                f"{VARIANT_CLASS}_ycck.jpg": "ycck",
                f"{VARIANT_CLASS}_arith_restart.jpg": "arith+rst+baseline",
                f"{VARIANT_CLASS}_arith_progressive_dac.jpg":
                    "dac+progressive",
                f"{VARIANT_CLASS}_smoothed.jpg": "progressive_unrefined",
                f"{VARIANT_CLASS}_smoothed_dc.jpg":
                    "scans:0,1,2:0-0:0:1;0:1-63:0:0"}
SMALL = ("_smoothed.jpg", "_smoothed_dc.jpg")


def write_with(writer: str) -> None:
    src = bench_images()[VARIANT_CLASS][:256, :256]
    cmyk = np.concatenate([255 - src, np.min(src, -1, keepdims=True) // 2],
                          -1)
    with tempfile.TemporaryDirectory() as td:
        for name, variant in WRITER_FILES.items():
            px = cmyk if variant == "ycck" else src
            if name.endswith(SMALL):
                px = px[:128, :128]
            raw = os.path.join(td, "in.raw")
            with open(raw, "wb") as f:
                f.write(np.ascontiguousarray(px).tobytes())
            subprocess.run([writer, raw, str(px.shape[1]), str(px.shape[0]),
                            str(px.shape[2]), "85", variant,
                            os.path.join(HERE, name)], check=True)


def pillow_decode(path: str):
    """(pixels, icc) as the reference's load_jpeg has them."""
    im = Image.open(path)
    im.load()
    icc = im.info.get("icc_profile")
    arr = np.asarray(im)[..., None] if im.mode == "L" else \
        np.asarray(im.convert("RGB"))
    return arr, icc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--writer", help="the built jpeg_writer.c")
    args = ap.parse_args(argv)
    for name, (px, kw) in pillow_files().items():
        mode = "L" if px.ndim == 2 else ("CMYK" if px.shape[2] == 4
                                         else "RGB")
        Image.fromarray(px, mode).save(os.path.join(HERE, name), "JPEG",
                                       **kw)
    if args.writer:
        write_with(args.writer)
    manifest = {}
    for name in sorted(os.listdir(HERE)):
        if not name.endswith(".jpg"):
            continue
        arr, icc = pillow_decode(os.path.join(HERE, name))
        manifest[name] = {
            "shape": list(arr.shape), "channels": int(arr.shape[2]),
            "crc32": zlib.crc32(arr.tobytes()),
            "icc_crc32": None if icc is None else zlib.crc32(icc),
            "writer": "jpeg_writer.c" if name in WRITER_FILES else "Pillow"}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
