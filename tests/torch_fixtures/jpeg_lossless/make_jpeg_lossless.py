"""Regenerate the lossless JPEG fixtures (SOF3) of
``tests/test_torch_jpeg_lossless.py`` and ``chip_smoke.py`` and their
``manifest.json``.

    python tests/torch_fixtures/jpeg_lossless/make_jpeg_lossless.py

The numpy writer ``tests/torch_fixtures/jpeg/lossless_jpeg.py`` writes
them from the bench classes (the system's libjpeg-turbo has no lossless
encoder): the ``text`` class at 512x512 for the CLI, and smaller crops
with each predictor, point transforms, restart intervals, subsampled
components, one scan per component, CMYK and an Adobe marker. The
manifest holds, for every file, the writer's parameters, the shape and
channels of Pillow's decode as the reference's ``load_jpeg`` takes it,
the CRC32 of those pixels, and whether they equal the source (with a
point transform, or where libjpeg-turbo restarts the prediction at the
first row of an iMCU row and not at the restart marker's, they do not).
"""

from __future__ import annotations

import json
import os
import sys
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures", "jpeg"))

from lossless_jpeg import encode  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402


def _planes(px: np.ndarray, sampling) -> list:
    """Each channel subsampled by its factors (the top-left sample of each
    box), at the sizes a frame of px's size gives it."""
    h, w = px.shape[:2]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    return [np.ascontiguousarray(
        px[::vmax // v, ::hmax // hx, c][: -(-h * v // vmax),
                                         : -(-w * hx // hmax)])
            for c, (hx, v) in enumerate(sampling)]


def files() -> dict:
    """name -> (source pixels, the writer's keywords)"""
    im = bench_images()
    cmyk = np.concatenate([im["sinusoid"][:128, :128],
                           im["sinusoid"][:128, :128, :1] // 2], -1)
    odd = im["text"][:93, :127]
    return {
        "text_p1.jpg": (im["text"], dict(predictor=1)),
        "mixed_p7_pt2_rst4.jpg": (im["mixed"][:256, :256],
                                  dict(predictor=7, pt=2, restart_rows=4)),
        "fractal_gray_p4.jpg": (im["fractal"][:256, :256, 1],
                                dict(predictor=4)),
        "edges_h2v2_p6.jpg": (im["edges"][:128, :128], dict(
            predictor=6, sampling=((2, 2), (1, 1), (1, 1)))),
        "sinusoid_cmyk_p5.jpg": (cmyk, dict(predictor=5)),
        "oriented_adobe0_scans_p3_rst3.jpg": (im["oriented"][:128, :128],
                                              dict(predictor=3,
                                                   marker="adobe0",
                                                   interleaved=False,
                                                   shared_table=False,
                                                   restart_rows=3)),
        "text_h1v2_scans_rst1.jpg": (im["text"][:128, :128], dict(
            predictor=2, sampling=((1, 2), (1, 1), (1, 1)),
            interleaved=False, restart_rows=1)),
        "text_odd_127x93_h2v1_rst5.jpg": (odd, dict(
            predictor=1, sampling=((2, 1), (1, 1), (1, 1)),
            restart_rows=5)),
    }


def lossless(px: np.ndarray, kw: dict) -> bytes:
    """The writer's file of px with these keywords."""
    if kw.get("sampling"):
        return encode(_planes(px, kw["sampling"]), size=px.shape[:2], **kw)
    return encode(px, **kw)


def pillow_decode(path: str) -> np.ndarray:
    """The pixels as the reference's load_jpeg has them."""
    im = Image.open(path)
    im.load()
    return np.asarray(im)[..., None] if im.mode == "L" else \
        np.asarray(im.convert("RGB"))


def main() -> int:
    manifest = {}
    for name, (px, kw) in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(lossless(px, kw))
        arr = pillow_decode(os.path.join(HERE, name))
        src = px[..., None] if px.ndim == 2 else px
        manifest[name] = {
            "shape": list(arr.shape), "channels": int(arr.shape[2]),
            "crc32": zlib.crc32(arr.tobytes()),
            "equals_source": bool(src.shape == arr.shape
                                  and np.array_equal(src, arr)),
            "writer": {k: (list(map(list, v)) if k == "sampling" else v)
                       for k, v in kw.items()}}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
