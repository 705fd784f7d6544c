"""Regenerate the cut JPEG fixtures of ``tests/test_torch_jpeg_cut.py`` and
``chip_smoke.py`` and their ``manifest.json``.

    python tests/torch_fixtures/jpeg_cut/make_jpeg_cut.py

Each fixture is a prefix of a whole JPEG: it ends before the file's
``EOI`` marker. The whole files are crops of the bench classes written by
Pillow (baseline 4:2:0 and 4:4:4, gray, restart markers, progressive), by
the numpy lossless writer beside the JPEG fixtures (RGB, and gray with
restart markers) and by ``jpeg_writer.c`` (arithmetic coding, built here
with ``cc ... -ljpeg``). Each is cut where Pillow raises (in the marker
segments, in the middle of the scan, after its last byte but one, on
the 0xFF of the ``EOI``) and right before the ``EOI``, where Pillow
decodes some files and not others: the crops of the files that should
decode there are searched until Pillow does (a progressive file never
does, nor an arithmetic one). ``text256_noeoi.jpg`` is a 256x256 crop,
cut before its ``EOI``, that Pillow decodes, for the CLI.

Two more files are whole: Pillow hands libjpeg-turbo the data 64 KiB at
a time, and an arithmetic scan cannot wait for the next block.
``arith_block_past.jpg`` is the arithmetic file behind a comment segment
that puts its end just past the first block (Pillow raises; the port,
which has the whole file, decodes it: a difference kept on purpose);
``arith_block_progressive.jpg`` a progressive arithmetic file whose
first block ends inside the markers before a scan, where libjpeg waits,
so that every scan lies in the data it has (Pillow decodes it).

The manifest holds, for every file, its source and cut (``keep``: the
bytes kept), and either the shape, channels and CRC32 of Pillow's decode
as the reference's ``load_jpeg`` takes it, or ``raises``: the error
Pillow raises. A whole file that Pillow refuses also has ``libjpeg``:
the shape, channels and CRC32 of Pillow's decode when it reads the whole
file in one block, which the port gives.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
JPEG_DIR = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")
sys.path.insert(0, ROOT)
sys.path.insert(0, JPEG_DIR)

from lossless_jpeg import encode  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

SIZE = 48  # the crops' side, but for the CLI's file
# (source, class, Pillow's keywords or a writer); "decodes": whether the
# search wants a crop whose file Pillow decodes without its EOI
SOURCES = {
    "base420": ("text", dict(quality=85), True),
    "base444": ("mixed", dict(quality=90, subsampling=0), True),
    "gray": ("fractal", dict(quality=80), True),
    "rst": ("edges", dict(quality=85, restart_marker_blocks=2), True),
    "progressive": ("sinusoid", dict(quality=85, progressive=True), False),
    "lossless": ("text", dict(lossless=dict(predictor=1)), True),
    "lossless_gray_rst": ("oriented", dict(lossless=dict(
        predictor=4, restart_rows=2)), True),
    "arith": ("mixed", dict(writer="arith+baseline"), False),
}


def _whole(px: np.ndarray, kw: dict, writer) -> bytes:
    """The whole JPEG of px from the source's writer."""
    kw = dict(kw)
    if "lossless" in kw:
        return encode(px, **kw["lossless"])
    if "writer" in kw:
        return writer(px, kw["writer"])
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pillow(data: bytes, block: int = 0):
    """Pillow's pixels as the reference's load_jpeg has them, or the
    error it raises: (array or None, error or None). A ``block`` reads
    the data to libjpeg that many bytes at a time, not Pillow's 64 KiB."""
    try:
        im = Image.open(io.BytesIO(data))
        if block:
            im.decodermaxblock = block
        im.load()
    except OSError as e:
        return None, f"{type(e).__name__}: {e}"
    arr = (np.asarray(im)[..., None] if im.mode == "L"
           else np.asarray(im.convert("RGB")))
    return arr, None


def _crop(img: np.ndarray, k: int, size: int, gray: bool) -> np.ndarray:
    """The k-th crop of a 512x512 class image, on a 16-pixel lattice."""
    steps = (512 - size) // 16 + 1
    y, x = 16 * (k // steps % steps), 16 * (k % steps)
    px = img[y: y + size, x: x + size]
    return np.ascontiguousarray(px[..., 1] if gray else px)


def _cuts(data: bytes) -> dict:
    """Cut name -> bytes kept of a whole file ending in its EOI."""
    sos = data.index(b"\xff\xda")
    return {"sos": sos + 6, "half": (sos + len(data)) // 2,
            "lastbyte": len(data) - 3, "ff": len(data) - 1,
            "noeoi": len(data) - 2}


def files(writer) -> dict:
    """name -> (whole file, bytes kept); writer(px, variant) -> bytes
    writes with ``jpeg_writer.c``."""
    classes = bench_images()
    out = {}
    for src, (cls, kw, decodes) in SOURCES.items():
        gray = "gray" in src
        for k in range(400):
            whole = _whole(_crop(classes[cls], k, SIZE, gray), kw, writer)
            if (pillow(whole[:-2])[0] is not None) == decodes:
                break
        else:
            raise RuntimeError(f"{src}: no crop found")
        for cut, keep in _cuts(whole).items():
            out[f"{src}_{cut}.jpg"] = (whole, keep)
    for k in range(400):
        whole = _whole(_crop(classes["text"], k, 256, False),
                       dict(quality=90), writer)
        if pillow(whole[:-2])[0] is not None:
            break
    else:
        raise RuntimeError("text256: no crop found")
    out["text256_noeoi.jpg"] = (whole, len(whole) - 2)
    px = _crop(classes["mixed"], 0, SIZE, False)
    whole = with_comment(writer(px, "arith+baseline"),
                         BLOCK + 1 - len(writer(px, "arith+baseline")))
    out["arith_block_past.jpg"] = (whole, len(whole))
    prog = writer(px, "arith+progressive")
    for pad in range(BLOCK - len(prog), BLOCK):
        whole = with_comment(prog, pad)
        if len(whole) > BLOCK and pillow(whole)[0] is not None:
            break
    else:
        raise RuntimeError("arith_block_progressive: no padding found")
    out["arith_block_progressive.jpg"] = (whole, len(whole))
    return out


BLOCK = 65536  # Pillow's ImageFile.MAXBLOCK


def with_comment(data: bytes, size: int) -> bytes:
    """data with a COM segment of ``size`` bytes in all (at least 4)
    after its SOI."""
    return data[:2] + b"\xff\xfe" + (size - 2).to_bytes(2, "big") + \
        bytes(size - 4) + data[2:]


def build_writer(folder: str) -> str:
    """``jpeg_writer.c`` built against the system's libjpeg into folder."""
    exe = os.path.join(folder, "jpeg_writer")
    subprocess.run(["cc", "-O2", "-o", exe,
                    os.path.join(JPEG_DIR, "jpeg_writer.c"), "-ljpeg"],
                   check=True)
    return exe


def libjpeg_writer(exe: str, folder: str):
    def write(px: np.ndarray, variant: str) -> bytes:
        arr = px if px.ndim == 3 else px[..., None]
        raw, out = os.path.join(folder, "in.raw"), os.path.join(folder,
                                                                "o.jpg")
        arr.tofile(raw)
        subprocess.run([exe, raw, str(arr.shape[1]), str(arr.shape[0]),
                        str(arr.shape[2]), "85", variant, out], check=True)
        with open(out, "rb") as f:
            return f.read()
    return write


def main() -> int:
    manifest = {}
    with tempfile.TemporaryDirectory() as td:
        made = files(libjpeg_writer(build_writer(td), td))
    for old in os.listdir(HERE):
        if old.endswith(".jpg"):
            os.remove(os.path.join(HERE, old))
    for name, (whole, keep) in made.items():
        data = whole[:keep]
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        arr, err = pillow(data)
        entry = {"keep": keep, "whole": len(whole)}
        if err is None:
            entry.update(shape=list(arr.shape), channels=int(arr.shape[2]),
                         crc32=zlib.crc32(arr.tobytes()))
        else:
            entry["raises"] = err
            if keep == len(whole):
                arr, _ = pillow(data, block=len(data))
                entry["libjpeg"] = dict(shape=list(arr.shape),
                                        channels=int(arr.shape[2]),
                                        crc32=zlib.crc32(arr.tobytes()))
        manifest[name] = entry
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in manifest)
    decodes = sum("crc32" in e for e in manifest.values())
    print(f"{len(manifest)} files ({decodes} decode in Pillow), "
          f"{total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
