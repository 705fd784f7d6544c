"""Regenerate the WebP fixtures of ``tests/test_torch_webp.py`` and
``chip_smoke.py`` and their ``manifest.json``.

    python tests/torch_fixtures/webp/make_webp.py [--writer PATH]

Pillow (libwebp 1.6.0) writes the six bench classes at 512x512 as lossy
q80, ``chip_smoke.frame_4k()`` as a 3840x2160 lossy q75 file, the
``text`` class lossless at 512x512 and 128x128 crops of the other five
classes lossless (at 512x512 those take 426-531 KB each), and variants
of ``text``: lossy with alpha at two alpha qualities, lossless with
alpha, a 509x383 lossy file and a two-frame animation. The variants
Pillow cannot set (token partitions, segments, the simple loop filter,
filter sharpness 7 and strength 0, raw and filtered alpha planes,
near-lossless) come from ``webp_writer.c`` beside this script, a libwebp
program: build it (``cc -O2 -o webp_writer webp_writer.c -lwebp``) and
pass it as ``--writer`` to write them again; without it the files in the
directory are kept. The manifest holds, for every file, the shape and
channels of the reference's decode (RGBA where Pillow's mode has alpha,
else RGB) and the CRC32 of those pixels.
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


def with_alpha(rgb: np.ndarray) -> np.ndarray:
    """The image with an alpha plane: a diagonal ramp, fully transparent
    in its top-left quarter."""
    h, w = rgb.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    a = ((xx + yy) * 255 // max(h + w - 2, 1)).astype(np.uint8)
    a[: h // 4, : w // 4] = 0
    return np.concatenate([rgb, a[..., None]], -1)


def pillow_files() -> dict:
    """name -> (pixels or a list of frames, Pillow's save keywords)"""
    images = bench_images()
    files = {f"{n}.webp": (rgb, dict(quality=80))
             for n, rgb in images.items()}
    v = VARIANT_CLASS
    src = images[v]
    small = src[:256, :256]
    files.update({
        f"{v}_lossless.webp": (src, dict(lossless=True)),
        f"{v}_alpha_q80.webp": (with_alpha(small), dict(quality=80)),
        f"{v}_alpha_q80_aq50.webp": (with_alpha(small),
                                    dict(quality=80, alpha_quality=50)),
        f"{v}_lossless_alpha.webp": (with_alpha(small), dict(lossless=True)),
        f"{v}_odd_509x383.webp": (
            bench_images(512, (v,))[v][:383, :509], dict(quality=80)),
        f"{v}_anim.webp": ([small, images["mixed"][:256, :256]],
                           dict(quality=80, duration=[100, 100])),
        "photo4k.webp": (frame_4k(), dict(quality=75)),
    })
    for n, rgb in images.items():
        if n != v:
            files[f"{n}_lossless_128.webp"] = (rgb[:128, :128],
                                               dict(lossless=True))
    return files


# name -> the writer's settings, on a 256x256 crop of the variant class
# (with its alpha plane where an alpha setting is given)
WRITER_FILES = {
    f"{VARIANT_CLASS}_partitions3.webp": ["partitions=3"],
    f"{VARIANT_CLASS}_segments1.webp": ["segments=1"],
    f"{VARIANT_CLASS}_segments4.webp": ["segments=4", "sns_strength=100"],
    f"{VARIANT_CLASS}_simple_filter.webp": ["filter_type=0",
                                            "filter_strength=60"],
    f"{VARIANT_CLASS}_sharpness7.webp": ["filter_sharpness=7",
                                         "filter_strength=80"],
    f"{VARIANT_CLASS}_no_filter.webp": ["filter_strength=0"],
    f"{VARIANT_CLASS}_alpha_raw.webp": ["alpha_compression=0"],
    f"{VARIANT_CLASS}_alpha_filter1.webp": ["alpha_filtering=1"],
    f"{VARIANT_CLASS}_alpha_filter2.webp": ["alpha_filtering=2"],
    f"{VARIANT_CLASS}_near_lossless.webp": ["lossless=1",
                                            "near_lossless=60"],
}


def write_with(writer: str) -> None:
    src = bench_images()[VARIANT_CLASS][:256, :256]
    with tempfile.TemporaryDirectory() as td:
        for name, settings in WRITER_FILES.items():
            px = with_alpha(src) if any(s.startswith("alpha")
                                        for s in settings) else src
            raw = os.path.join(td, "in.raw")
            with open(raw, "wb") as f:
                f.write(np.ascontiguousarray(px).tobytes())
            subprocess.run([writer, raw, str(px.shape[1]), str(px.shape[0]),
                            str(px.shape[2]), os.path.join(HERE, name),
                            *settings], check=True)


def pillow_decode(path: str) -> np.ndarray:
    """The pixels as the reference's load_webp has them."""
    im = Image.open(path)
    im.load()
    alpha = "A" in im.mode or "transparency" in im.info
    return np.asarray(im.convert("RGBA" if alpha else "RGB"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--writer", help="the built webp_writer.c")
    args = ap.parse_args(argv)
    for name, (px, kw) in pillow_files().items():
        path = os.path.join(HERE, name)
        if isinstance(px, list):
            frames = [Image.fromarray(p) for p in px]
            frames[0].save(path, "WEBP", save_all=True,
                           append_images=frames[1:], **kw)
        else:
            Image.fromarray(px).save(path, "WEBP", **kw)
    if args.writer:
        write_with(args.writer)
    manifest = {}
    for name in sorted(os.listdir(HERE)):
        if not name.endswith(".webp"):
            continue
        arr = pillow_decode(os.path.join(HERE, name))
        manifest[name] = {
            "shape": list(arr.shape), "channels": int(arr.shape[2]),
            "crc32": zlib.crc32(arr.tobytes()),
            "writer": "webp_writer.c" if name in WRITER_FILES else "Pillow"}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
