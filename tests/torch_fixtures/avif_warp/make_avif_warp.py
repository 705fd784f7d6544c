"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_warp.py`` and
``chip_smoke.py``: layered and progressive items whose inter frames use
the motion modes OBMC and LOCALWARP, and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_warp/make_avif_warp.py

libaom 3.6 (``libaom.so.3``) writes most streams through ctypes with
``avif_layers/make_avif_layers.aom_encode_layers`` (realtime usage, one
spatial layer per quantizer) at ``cpu-used`` 5 and 6, where its realtime
usage turns OBMC and warped motion on: both tools, OBMC alone
(``enable-warped-motion`` 0) and local warps alone (``enable-obmc`` 0);
4:2:0, 4:2:2, 4:4:4 and monochrome at 8, 10 and 12 bits; three layers
(``enable-ref-frame-mvs`` 0: the port refuses reference MVs on an inter
frame); an alpha item; two tile columns; the six 512x512 bench classes;
and two progressive items at 8 bits
(``avif_progressive/make_avif_progressive.scaling``: layer 0 at 1/2 and
at 4/5), whose scaled reference reads OBMC only (libaom 3.6 crashes on a
scaled layer above 8 bits).

libaom picks a local warp only where it is valid, and never writes OBMC
beside two filters: ``avif_layers/inter_writer.py`` writes layer 1 of the
``written_*`` files symbol by symbol over libaom's layer 0 (``WRITTEN``):
local warps whose samples leave the least squares singular (LocalValid
0) and whose shear the warp filter cannot follow, each predicted by
translation instead; OBMC under neighbours with two filters; OBMC on
4:2:2 blocks whose chroma is 4 wide; and a 3840x2160 4:2:0 frame for
the card, at which libaom's realtime usage writes neither tool.

The manifest holds what ``avif_layers/make_avif_layers.manifest_entry``
holds (dav1d's Y'UV CRC through the system libavif 0.11.1, the
reference's ``load_avif`` and ``decode_avif_to_rgb8`` CRCs, the frames,
the layer shown and the tool counts) and each frame's coded width,
upscaled width and height.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
LAYERS = os.path.join(os.path.dirname(HERE), "avif_layers")
PROGRESSIVE = os.path.join(os.path.dirname(HERE), "avif_progressive")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "avif_superres"))
sys.path.insert(0, LAYERS)
sys.path.insert(0, PROGRESSIVE)

from chip_smoke import frame_4k, with_alpha  # noqa: E402
from make_avif_layers import (LIBAOM, aom_encode_layers,  # noqa: E402
                              container, encode_avif)
from make_avif_progressive import entry, scaling  # noqa: E402
from make_avif_superres import to_yuv  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

FULL = ("1", "1")


def files() -> dict:
    """name -> (pixels, layer scales, encode_avif's other arguments)"""
    im = bench_images(256)
    big = bench_images(512)
    out = {}
    names = list(im)
    grid = (("4:2:0", 8, 5, (52, 28)), ("4:2:2", 8, 6, (44, 20)),
            ("4:4:4", 8, 5, (56, 32)), ("mono", 8, 6, (40, 16)),
            ("4:2:0", 10, 6, (48, 24)), ("4:2:2", 10, 5, (60, 36)),
            ("4:4:4", 10, 6, (36, 12)), ("mono", 10, 5, (52, 30)),
            ("4:2:0", 12, 5, (44, 22)), ("4:2:2", 12, 6, (56, 30)),
            ("4:4:4", 12, 5, (40, 20)), ("mono", 12, 6, (48, 26)))
    for i, (ss, depth, speed, qs) in enumerate(grid):
        mono = ss == "mono"
        out[f"s{speed}_{ss.replace(':', '')}_{depth}bit.avif"] = (
            im[names[i % 6]], [FULL, FULL], dict(
                depth=depth, ss="4:2:0" if mono else ss, mono=mono,
                quantizers=qs, options={"cpu-used": speed}))
    out.update({
        "obmc_only_s5_420.avif": (im["fractal"], [FULL, FULL], dict(
            depth=8, ss="4:2:0", quantizers=(48, 24),
            options={"cpu-used": 5, "enable-warped-motion": 0})),
        "warp_only_s6_420.avif": (im["oriented"], [FULL, FULL], dict(
            depth=8, ss="4:2:0", quantizers=(48, 24),
            options={"cpu-used": 6, "enable-obmc": 0})),
        "three_layers_420.avif": (im["mixed"], [FULL, FULL, FULL], dict(
            depth=8, ss="4:2:0", quantizers=(56, 36, 16),
            options={"cpu-used": 5, "enable-ref-frame-mvs": 0})),
        "alpha_420.avif": (with_alpha(im["edges"]), [FULL, FULL], dict(
            depth=8, ss="4:2:0", quantizers=(40, 20),
            options={"cpu-used": 6})),
        "tiles2_420.avif": (big["oriented"], [FULL, FULL], dict(
            depth=8, ss="4:2:0", quantizers=(44, 28),
            options={"cpu-used": 5, "tile-columns": 1})),
        "progressive_half_420.avif": (im["text"], [("1/2", "1/2"), FULL],
                                      dict(depth=8, ss="4:2:0",
                                           quantizers=(44, 20),
                                           options={"cpu-used": 5})),
        "progressive_four_fifths_420.avif": (
            im["sinusoid"], [("4/5", "4/5"), FULL], dict(
                depth=8, ss="4:2:0", quantizers=(40, 20),
                options={"cpu-used": 6})),
    })
    for j, (name, px) in enumerate(big.items()):
        out[f"class_{name}_512.avif"] = (px, [FULL, FULL], dict(
            depth=8, ss="4:2:0", quantizers=(44, 28),
            options={"cpu-used": 5 + j % 2}))
    return out


# streams whose layer 1 ``inter_writer`` writes over libaom's layer 0:
# name -> (class, depth, subsampling, size, write_layered's arguments,
# seed, the block size of each superblock row (log2 of its width in 4x4
# units), the motion modes' weights (SIMPLE, OBMC, and LOCALWARP of each
# kind: valid, singular, shear), the MVs' spread about a smooth field)
WRITTEN = {
    # local warps that fall back to translation: the first row's blocks
    # see one neighbour whose MV is far off (LocalValid 0), the others
    # ask for a shear the warp filter cannot follow among valid warps
    "written_warp_invalid_420.avif": ("mixed", 8, "4:2:0", (256, 256),
                                      dict(filt=4), 1, (2, 2, 2, 2),
                                      (1, 1, 2, 1, 2), 24),
    # OBMC whose above and left neighbours predict with two filters
    "written_obmc_dual_420.avif": ("fractal", 8, "4:2:0", (256, 256),
                                   dict(filt=4, dual=True), 2, (3, 2, 1, 2),
                                   (1, 4, 1, 0, 0), 12),
    # OBMC on 4:2:2 blocks of 8x8, whose chroma is 4 wide
    "written_obmc_422_10bit.avif": ("edges", 10, "4:2:2", (256, 256),
                                    dict(filt=4), 3, (1, 1, 2, 1),
                                    (1, 4, 1, 0, 0), 12),
    # local warps below 4x4 blocks: every 4-wide neighbour a sample
    "written_warp_4x4_above_444_12bit.avif": ("oriented", 12, "4:4:4",
                                              (256, 256), dict(filt=4), 4,
                                              (0, 1, 0, 1), (1, 1, 4, 0, 0),
                                              10),
    # the 3840x2160 frame for the card: libaom's realtime usage writes no
    # OBMC or local warp at this size, so the motion modes come in the
    # shares libaom gave the inter blocks of the six class_*_512 files
    # here at cpu-used 5 and 6 (3205 translation, 964 OBMC, 415 local
    # warp); every block is a NEWMV with no residual, unlike libaom's.
    # Its last superblock row lies past the frame's edge, so it is one
    # block each
    "photo4k_420.avif": ("photo4k", 8, "4:2:0", (3840, 2160), dict(filt=4),
                         5, (2, 3) * 16 + (2, 4), (3205, 964, 415, 0, 0),
                         16),
}


def motion_sbs(rng: np.random.Generator, size, leaves, weights,
               spread: int) -> list:
    """The superblocks of a ``WRITTEN`` frame of ``size``: superblock row
    i cut into blocks of ``leaves[i % len(leaves)]``, each block's MV a smooth
    field plus noise of ``spread`` (1/8 sample), its filters random and
    its motion mode drawn by ``weights``; the first block row's local
    warps of a kind, with one neighbour each, ask for a singular warp."""
    from inter_writer import LOCALWARP, InterBlock

    kinds = (None, None, "valid", "singular", "shear")
    modes = (0, 1, LOCALWARP, LOCALWARP, LOCALWARP)
    p = np.array(weights, float) / sum(weights)
    sb_cols, sb_rows = -(-size[0] // 64), -(-size[1] // 64)
    out = []
    for sr in range(sb_rows):
        leaf = leaves[sr % len(leaves)]
        n = 1 << (4 - leaf)
        for sc in range(sb_cols):
            blocks = []
            for i in range(n * n):
                # coding order: the quadtree's Z order
                y = x = 0
                for b in range(4 - leaf):
                    y |= ((i >> (2 * b + 1)) & 1) << b
                    x |= ((i >> (2 * b)) & 1) << b
                py = sr * 64 + (y << (leaf + 2))
                px = sc * 64 + (x << (leaf + 2))
                field = (int(24 * np.sin(px / 97)), int(24 * np.cos(py / 83)))
                mv = tuple(int(f + rng.integers(-spread, spread + 1))
                           for f in field)
                k = int(rng.choice(5, p=p))
                kind = kinds[k]
                if kind and py == 0:
                    kind = "singular"
                blocks.append(InterBlock(
                    mv, (int(rng.integers(3)), int(rng.integers(3))),
                    modes[k], kind))
            out.append((leaf, blocks))
    return out


def written(name: str) -> Tuple[bytes, dict]:
    """A ``WRITTEN`` file and how it was made."""
    from inter_writer import write_layered

    cls, depth, ss, size, kw, seed, leaves, weights, spread = WRITTEN[name]
    px = frame_4k() if cls == "photo4k" else bench_images(256)[cls]
    # 64x64 superblocks, which inter_writer writes (libaom's dynamic
    # choice is 128x128 at 3840x2160)
    key = aom_encode_layers(to_yuv(px, depth, ss), depth, ss, (40, 20),
                            options={"cpu-used": 8, "sb-size": 64})
    rng = np.random.default_rng(seed)
    warps = {}
    data = container(write_layered(
        key, motion_sbs(rng, size, leaves, weights, spread), motion=True,
        warps=warps, **kw), *size, depth)
    how = {"writer": f"{LIBAOM} layer 0, inter_writer.py layer 1",
           "class": cls, "depth": depth, "ss": ss, "seed": seed,
           "leaves": list(leaves), "weights": list(weights),
           "spread": spread, "warps": warps,
           **{k: (list(v) if isinstance(v, tuple) else v)
              for k, v in kw.items()}}
    return data, how


def main() -> None:
    manifest = {}
    only = set(sys.argv[1:])
    for name, (px, modes, kw) in files().items():
        if only and name not in only:
            continue
        print(name, flush=True)
        data = encode_avif(px, before_layer=scaling(modes), **kw)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        how = {"writer": LIBAOM, "usage": 1,
               "scales": [list(m) for m in modes],
               **{k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in kw.items() if k != "options"},
               **{k: str(v) for k, v in dict(kw.get("options", {})).items()}}
        manifest[name] = entry(data, how)
    for name in WRITTEN:
        if only and name not in only:
            continue
        print(name, flush=True)
        data, how = written(name)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = entry(data, how)
    path = os.path.join(HERE, "manifest.json")
    if only and os.path.exists(path):
        with open(path) as f:
            manifest = {**json.load(f), **manifest}
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(e["bytes"] for e in manifest.values())
    print(f"{len(manifest)} files, {total} bytes")


if __name__ == "__main__":
    main()
