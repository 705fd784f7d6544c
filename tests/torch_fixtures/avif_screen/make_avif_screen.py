"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_intrabc.py`` and
``chip_smoke.py``: screen content, which libaom codes with intra block
copy (intrabc) at its default options, and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_screen/make_avif_screen.py

libaom detects screen content by itself (few colours, repeated shapes)
and turns intrabc on from 256x256 at every speed up to 7; the frames are
``screen``'s: white, lines of seeded glyphs in one or three colours, and
optionally a grid of one repeated 32x32 icon, as file browsers and slides
show. Pillow's AVIF plugin (libavif 1.3 with libaom) writes 8-bit files at
its defaults but for the setting a file's name gives:

- 4:2:0 at speeds 2, 4, 6 and 7, 4:4:4 and 4:2:2 at speed 6;
- qualities 30, 60 and 90, and 100 (which codes the frame lossless);
- RGBA, whose alpha item libaom codes with intrabc too;
- two tile columns (``tile_cols=1``), 128-pixel superblocks
  (``advanced={"sb-size": "128"}``; libaom picks them itself from 512x512
  at speed 6) and the reduced transform set
  (``advanced={"reduced-tx-type-set": "1"}``, where intrabc blocks take
  TX_SET_INTER_3);
- a 512x512 frame, and a 3840x2160 one at Pillow's defaults (which tile
  it) for the card.

The system's ``libavif.so.15`` (0.11.1, with libaom) writes, through
ctypes, 10- and 12-bit files in 4:4:4 and 4:2:0 (``libavif_encode`` of
``avif_tools``), and one ``grid`` image of two cells
(``avifEncoderAddImageGrid``, ``libavif_grid`` of ``avif_container``).

The manifest holds, per file, ``avif_tools``' fields: how it was written;
the CRC32 of dav1d's Y'UV planes (the system libavif); the shape, ``hbd``
flag and CRC32 of the reference's ``load_avif`` pixels and the CRC32 of
its ``decode_avif_to_rgb8`` pixels; and the count of each tool the port's
decoder met (``oavif_tpu_torch.io.avif.TOOL_NAMES``) or, for a refusal,
the tool it names. Besides: whether the colour item is coded lossless,
with 128-pixel superblocks, its tile grid, and the alpha item's intrabc
blocks.
"""

from __future__ import annotations

import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "avif_tools"))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "avif_container"))

from make_avif_container import libavif_grid  # noqa: E402
from make_avif_tools import crc, libavif_encode  # noqa: E402

PILLOW = "Pillow (libavif 1.3, libaom)"
LIBAVIF = "libavif 0.11.1 (libaom)"
PALETTE = ((20, 20, 20), (30, 60, 200), (200, 40, 40))


def screen(h: int, w: int, colours: int = 3, seed: int = 0,
           icons: bool = True) -> np.ndarray:
    """A (h, w, 3) uint8 screen: lines of twelve seeded 7x9 glyphs drawn
    at twice their size on white, each line in one of ``colours`` colours,
    and, with ``icons``, one textured 32x32 icon repeated on a grid."""
    rng = np.random.default_rng(seed)
    glyphs = rng.random((12, 9, 7)) < 0.42
    glyphs[:, :, 0] = glyphs[:, 0, :] = False
    icon = None
    if icons:
        yy, xx = np.mgrid[0:32, 0:32]
        icon = np.stack([128 + 100 * np.sin(xx / 5 + c) * np.cos(yy / 7)
                         for c in range(3)], -1)
        icon = np.clip(icon + rng.normal(0, 12, icon.shape), 0,
                       255).astype(np.uint8)
    img = np.full((h, w, 3), 255, np.uint8)
    pal = np.array(PALETTE[:colours], np.uint8)
    gh, gw = 18, 14
    y = 6
    while y + gh < h:
        x = 4 + 2 * int(rng.integers(0, 3))
        colour = pal[int(rng.integers(0, colours))]
        while x + gw < w:
            k = int(rng.integers(0, len(glyphs) + 2))  # 2 in 14: a space
            if k < len(glyphs):
                mask = np.kron(glyphs[k], np.ones((2, 2), bool))
                img[y:y + gh, x:x + gw][mask] = colour
            x += gw + 2
        y += gh + 6
    if icon is not None:
        for y in range(8, h - 40, 72):
            for x in range(8 + (y // 72) % 2 * 16, w - 40, 56):
                img[y:y + 32, x:x + 32] = icon
    return img


def pillow_files() -> dict:
    """name -> (RGB or RGBA pixels, Pillow save keywords)"""
    files = {}
    for speed in (2, 4, 6, 7):
        files[f"s{speed}_420_q60.avif"] = (
            screen(256, 256, seed=speed), dict(speed=speed, quality=60))
    for ss in ("4:4:4", "4:2:2"):
        files[f"s6_{ss.replace(':', '')}_q60.avif"] = (
            screen(256, 256, seed=10 + len(files)),
            dict(subsampling=ss, quality=60))
    for q in (30, 90):
        files[f"s6_420_q{q}.avif"] = (screen(256, 256, seed=q),
                                      dict(quality=q))
    files["s6_444_q100.avif"] = (screen(256, 256, colours=1, seed=100,
                                        icons=False),
                                 dict(subsampling="4:4:4", quality=100))
    # a translucent background behind opaque glyphs and icons: screen
    # content in the alpha item too
    px = screen(256, 256, seed=20)
    alpha = np.where(px.min(-1) == 255, 64, 255).astype(np.uint8)
    files["rgba_420_q60.avif"] = (np.concatenate([px, alpha[..., None]], -1),
                                  dict(quality=60))
    files["tiles2_420_q60.avif"] = (screen(256, 512, seed=21),
                                    dict(quality=60, tile_cols=1))
    # TX_SET_INTER_3 for every intrabc transform
    files["reduced_tx_420_q60.avif"] = (
        screen(256, 256, seed=2),
        dict(quality=60, advanced={"reduced-tx-type-set": "1"}))
    files["sb128_420_q60.avif"] = (screen(256, 256, seed=22),
                                   dict(quality=60,
                                        advanced={"sb-size": "128"}))
    files["screen512.avif"] = (screen(512, 512, seed=23), {})
    files["screen4k.avif"] = (screen(2160, 3840, seed=24), {})
    return files


def libavif_files() -> dict:
    """name -> (bytes, how it was written)"""
    out = {}
    for depth in (10, 12):
        for ss in ("4:4:4", "4:2:0"):
            px = screen(256, 256, seed=depth * 10 + len(ss))
            out[f"d{depth}_{ss.replace(':', '')}_q24.avif"] = (
                libavif_encode(px, depth, ss, 24),
                {"writer": LIBAVIF, "depth": depth, "subsampling": ss,
                 "quantizer": 24, "speed": 6})
    out["grid2x1_420.avif"] = (
        libavif_grid([screen(128, 128, seed=s) for s in (30, 31)], 2, 8,
                     "4:2:0", 24),
        {"writer": LIBAVIF, "grid": [2, 1], "subsampling": "4:2:0",
         "quantizer": 24, "speed": 6})
    return out


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
        box, port, alpha = A.decode_avif(data)
    except A.UnsupportedAvif as e:
        entry["refuses"] = str(e)
        return entry
    fh = A.parse_av1(box.color.payload).frame
    entry.update(tools=port.tools, lossless=fh.lossless,
                 sb128=A.parse_av1(box.color.payload).seq.sb128,
                 tiles=[len(fh.tile_col_starts) - 1,
                        len(fh.tile_row_starts) - 1],
                 alpha_intrabc=alpha.tools["intrabc"] if alpha else None)
    return entry


def main() -> None:
    manifest = {}

    def keep(name, data, how):
        print(name, len(data), flush=True)
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
        how = {"writer": PILLOW, "size": list(px.shape[:2]), "speed": 6,
               "quality": 75, "subsampling": "4:2:0",
               **{k: v for k, v in kw.items() if k != "advanced"},
               **kw.get("advanced", {})}
        keep(name, buf.getvalue(), how)
    for name, (data, how) in libavif_files().items():
        keep(name, data, how)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
