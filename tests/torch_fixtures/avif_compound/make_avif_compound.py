"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_compound.py``
and ``chip_smoke.py``: items whose inter frames hold compound blocks
(two references, spec 5.11.25-27, 7.11.3.1, 7.11.3.11-15), and their
``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_compound/make_avif_compound.py [NAME ...]

Names rewrite only those files and merge into the manifest. libaom 3.6
(``libaom.so.3``) writes the ``four_*``, ``tiles2``, ``sb128``,
``alpha``, ``progressive``, ``class_*`` and ``photo4k`` files through
ctypes with ``avif_layers/make_avif_layers.aom_encode_layers`` (realtime
usage 1, four spatial layers of one quantizer each, libaom's defaults past
the options named, no reference flags): from 1280x720 libaom's defaults
turn ``reference_select`` on in layer 3 of four and write compound blocks
there, in its realtime usage only GLOBAL_GLOBALMV (rarely
NEAREST_NEARESTMV) blocks on a bidirectional pair, averaged
(``enable_masked_compound`` is 1, so each reads comp_group_idx 0;
``enable_jnt_comp`` is 0). libaom writes none into monochrome 12-bit
layers (1280x720 and 1920x1080 at ``cpu-used`` 8 to 10, quantizers up to
63; below ``cpu-used`` 8 its monochrome encode crashes), nor into the
progressive item.

``avif_layers/inter_writer.py`` writes the ``written_*`` files' last
frame, every block a compound block on one pair of references (or, in
the ``written_mixed`` files, a single-reference block on either of them),
in every compound mode and type, over libaom's first layer or two (judged
by dav1d): the distance-weighted type under a sequence header written again
with ``enable_jnt_comp`` 1, wedges and difference weights, the
unidirectional pairs (LAST with LAST3 or GOLDEN; BWDREF with ALTREF) and
bidirectional ones, sides through a reference of another size (one side
or both), two references at different distances (the frame written as
layer 2 over libaom's layers 0 and 1, LAST on layer 1 and GOLDEN on the
key frame, so Quant_Dist's lookup leaves its equal-distance branch), and
references on both sides of the frame (order hint 65 over hints 0 and 1
in seven bits: sign biases that differ, for the extra searches), and
single-reference blocks beside compound ones (every neighbour site of
the decoder meets both kinds).

The manifest holds what ``make_avif_progressive.entry`` holds (dav1d's
Y'UV CRC through the system libavif 0.11.1, the reference's ``load_avif``
and ``decode_avif_to_rgb8`` CRCs, the frames, the layer shown, the tool
counts, each frame's coded width, upscaled width and height) and each
frame's count of compound blocks (``compound``).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
for _sub in ("avif_superres", "avif_layers", "avif_progressive"):
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), _sub))

from chip_smoke import frame_4k, with_alpha  # noqa: E402
from make_avif_layers import (LIBAOM, aom_encode_layers,  # noqa: E402
                              container, encode_avif)
from make_avif_progressive import entry, scaling  # noqa: E402
from make_avif_superres import to_yuv  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

FULL = ("1", "1")
HALF = ("1/2", "1/2")
Q = (60, 52, 44, 36)
# the compound modes' counters, NEAREST_NEARESTMV .. NEW_NEWMV
MODES = ("nearest_nearestmv", "near_nearmv", "nearest_newmv",
         "new_nearestmv", "near_newmv", "new_nearmv", "global_globalmv",
         "new_newmv")


def files() -> dict:
    """name -> (pixels, layer scales, encode_avif's other arguments); the
    pixels of the 1280x720 and larger frames come from a function, made
    when written"""
    out = {}

    def crop(h, w):
        return lambda: frame_4k()[:h, :w]

    # every subsampling at 8, 10 and 12 bits: 1280x720 at cpu-used 7 to
    # 10, 1920x1080 at 5 and 6
    grid = (("4:2:0", 8, 5), ("4:4:4", 10, 6), ("4:2:2", 8, 7),
            ("4:4:4", 8, 9), ("mono", 8, 10), ("4:2:0", 10, 7),
            ("4:2:2", 10, 9), ("mono", 10, 9), ("4:2:0", 12, 7),
            ("4:2:2", 12, 7), ("4:4:4", 12, 7), ("mono", 12, 8))
    for ss, depth, speed in grid:
        mono = ss == "mono"
        size = (1080, 1920) if speed < 7 else (720, 1280)
        out[f"four_{ss.replace(':', '')}_{depth}bit_s{speed}.avif"] = (
            crop(*size), [FULL] * 4, dict(
                depth=depth, ss="4:2:0" if mono else ss, mono=mono,
                quantizers=Q, options={"cpu-used": speed}))
    out.update({
        "tiles2_420.avif": (crop(720, 1280), [FULL] * 4, dict(
            depth=8, ss="4:2:0", quantizers=Q,
            options={"cpu-used": 8, "tile-columns": 1})),
        "sb128_420.avif": (crop(720, 1280), [FULL] * 4, dict(
            depth=8, ss="4:2:0", quantizers=Q,
            options={"cpu-used": 7, "sb-size": 128})),
        "alpha_420.avif": (lambda: with_alpha(frame_4k()[:720, :1280]),
                           [FULL] * 4, dict(depth=8, ss="4:2:0",
                                            quantizers=Q,
                                            options={"cpu-used": 9})),
        "progressive_420.avif": (crop(720, 1280), [HALF] + [FULL] * 3,
                                 dict(depth=8, ss="4:2:0", quantizers=Q,
                                      options={"cpu-used": 8})),
        "photo4k_420.avif": (frame_4k, [FULL] * 4, dict(
            depth=8, ss="4:2:0", quantizers=(56, 48, 40, 32),
            options={"cpu-used": 9})),
    })
    for j, (name, px) in enumerate(bench_images(512).items()):
        out[f"class_{name}_512.avif"] = (px, [FULL] * 4, dict(
            depth=8, ss="4:2:0", quantizers=(56, 46, 36, 26),
            options={"cpu-used": 5 + j}))
    return out


LAST, LAST2, LAST3, GOLDEN, BWDREF, ALTREF2, ALTREF = range(1, 8)
# slots of LAST .. ALTREF over two libaom layers: layer 1 (slot 1, order
# hint 1) or the key frame (slot 0, order hint 0)
TWO = (1, 0, 1, 0, 1, 0, 0)
# streams whose last frame ``inter_writer`` writes: name -> (class, depth,
# subsampling, the size of libaom's layers (scales as
# ``make_avif_progressive.scaling`` takes them), write_layered's
# arguments, seed, the blocks' log2 sizes[, random_compound_sbs' other
# arguments])
WRITTEN = {
    "written_dist_420.avif": ("fractal", 8, "4:2:0", [FULL, FULL], dict(
        pair=(LAST, GOLDEN), masked=True, jnt=True, base_layers=2,
        ref_slots=TWO), 1, (1, 2, 3, 4)),
    "written_bidir_444_10bit.avif": ("oriented", 10, "4:4:4", [FULL],
                                     dict(pair=(LAST2, ALTREF2), masked=True,
                                          jnt=True, dual=True), 2,
                                     (1, 2, 3)),
    "written_bwd_422_12bit.avif": ("edges", 12, "4:2:2", [FULL], dict(
        pair=(BWDREF, ALTREF), masked=True, filt=2), 3, (1, 2, 3, 4)),
    "written_last3_mono_12bit.avif": ("mixed", 12, "mono", [FULL], dict(
        pair=(LAST, LAST3), jnt=True, hp=False), 4, (1, 2, 3)),
    "written_scaled_side_420.avif": ("text", 8, "4:2:0", [HALF, FULL],
                                     dict(pair=(LAST, GOLDEN), masked=True,
                                          jnt=True, base_layers=2,
                                          ref_slots=TWO), 5, (1, 2, 3, 4)),
    "written_scaled_420_10bit.avif": ("sinusoid", 10, "4:2:0", [HALF],
                                      dict(pair=(LAST, ALTREF), masked=True,
                                           jnt=True), 6, (1, 2, 3)),
    # the compound extra search takes RefDiffMvs (negated across the sign
    # biases) where a block's stack holds one pair of a single neighbour:
    # mostly 64x64 blocks, whose neighbours share one pair, and NEARMV
    # sides, which read the search's second entry
    "written_signs_420.avif": ("mixed", 8, "4:2:0", [FULL, FULL], dict(
        pair=(GOLDEN, BWDREF), masked=True, jnt=True, base_layers=2,
        ref_slots=(1, 0, 1, 1, 0, 0, 0), order_hint=65), 7, (2, 4, 4, 4),
        dict(mode_weights=(0.1, 0.2, 0.05, 0.1, 0.2, 0.2, 0.05, 0.1))),
    # single-reference blocks among compound ones: each neighbour site
    # (the stacks' matches of either list, the single extra search over a
    # compound neighbour's two lists, the contexts that count both
    # references) meets both kinds, here with sign biases that differ
    "written_mixed_420.avif": ("fractal", 8, "4:2:0", [FULL, FULL], dict(
        pair=(LAST, ALTREF), masked=True, jnt=True, base_layers=2,
        ref_slots=(1, 0, 1, 0, 1, 0, 0), order_hint=65), 8, (1, 2, 3, 4),
        dict(single=0.4, pair=(LAST, ALTREF))),
    "written_mixed_444_10bit.avif": ("edges", 10, "4:4:4", [FULL], dict(
        pair=(LAST3, BWDREF), masked=True, jnt=True, dual=True), 9,
        (1, 2, 3, 4, 4), dict(single=0.5, pair=(LAST3, BWDREF))),
}


def written(name: str) -> Tuple[bytes, dict]:
    """A ``WRITTEN`` file and how it was made: libaom's layers of the
    picture (of the asked scales of 256x256; with the written layer at
    256x256 the maximum), its last one replaced by the written frame."""
    from inter_writer import random_compound_sbs, write_layered

    cls, depth, ss, modes, kw, seed, leaves, *sbs_kw = WRITTEN[name]
    mono = ss == "mono"
    px = bench_images(256)[cls]
    scaled = modes[0] != FULL
    if scaled and depth > 8:  # libaom's scaled encode is 8-bit only
        px, modes = px[::2, ::2], [FULL]
    yuv = to_yuv(px, depth, "4:2:0" if mono else ss)
    key = aom_encode_layers(
        yuv[:1] if mono else yuv, depth, "4:2:0" if mono else ss,
        (40, 30, 20)[:len(modes) + 1], options={"cpu-used": 8},
        before_layer=scaling(modes + [FULL]),
        cfg_words=dict(forced_max_frame_width=256,
                       forced_max_frame_height=256) if scaled else ())
    rng = np.random.default_rng(seed)
    counts = {}
    stream = write_layered(key, random_compound_sbs(
        rng, 16, leaves, 24, kw.get("hp", True), **dict(*sbs_kw)),
        size=(256, 256), counts=counts, **kw)
    data = container(stream, 256, 256, depth)
    how = {"writer": f"{LIBAOM} layers 0..{len(modes) - 1}, inter_writer.py "
                     f"layer {len(modes)}",
           "class": cls, "depth": depth, "ss": "4:2:0" if mono else ss,
           "mono": mono, "scales": [list(m) for m in modes], "seed": seed,
           "leaves": list(leaves), "counts": counts,
           **{k: (list(v) if isinstance(v, tuple) else v)
              for k, v in dict(*sbs_kw).items()},
           **{k: (list(v) if isinstance(v, tuple) else v)
              for k, v in kw.items()}}
    return data, how


def make(px, modes, kw) -> tuple:
    """A libaom file's bytes and how it was written."""
    data = encode_avif(px() if callable(px) else px,
                       before_layer=scaling(modes), **kw)
    how = {"writer": LIBAOM, "usage": 1,
           "scales": [list(m) for m in modes],
           **{k: (list(v) if isinstance(v, tuple) else v)
              for k, v in kw.items() if k != "options"},
           **{k: str(v) for k, v in dict(kw.get("options", {})).items()}}
    return data, how


def compound_entry(data: bytes, how: dict) -> dict:
    """``entry`` and each frame's count of compound blocks."""
    from oavif_tpu_torch.io import avif as A

    out = entry(data, how)
    img = A.decode_avif(data)[1]
    out["compound"] = [sum(t[m] for m in MODES) for t in img.frame_tools]
    return out


def main() -> None:
    manifest = {}
    only = set(sys.argv[1:])
    todo = {**{n: ("libaom", v) for n, v in files().items()},
            **{n: ("written", None) for n in WRITTEN}}
    for name, (kind, args) in todo.items():
        if only and name not in only:
            continue
        print(name, flush=True)
        data, how = make(*args) if kind == "libaom" else written(name)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = compound_entry(data, how)
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
