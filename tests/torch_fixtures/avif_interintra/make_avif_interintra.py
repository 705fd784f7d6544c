"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_interintra.py``
and ``chip_smoke.py``: items whose inter frames hold inter-intra blocks
(spec 5.11.24, 7.11.3.13-14: the four interintra_modes with the smooth
mask and the wedge mask) and segment ids predicted from the previous map
(spec 5.9.14, 5.11.9, 7.20-21: segmentation_update_map 0 and
segmentation_temporal_update 1 with seg_id_predicted), and their
``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_interintra/make_avif_interintra.py [NAME ...]

Names rewrite only those files and merge into the manifest. libaom 3.6's
realtime usage writes enable_interintra_compound 0, and its good-quality
usage codes a second spatial layer as a key frame, so every inter-intra
frame is ``avif_layers/inter_writer.py``'s, written over libaom's first
layer (``make_avif_layers.aom_encode_layers``, realtime usage 1, through
ctypes). libaom's cyclic refresh (``aq-mode`` 3) codes the map of a
layered realtime encode against the previous one (temporal update 1, in
two tile columns at ``tile-columns`` 1) and never keeps it
(update_map 0), so ``aq_temporal_420.avif`` is libaom's own and the
other segmentation files are written. dav1d (the system libavif 0.11.1)
judges each at its first decode. The set:

- every interintra_mode smooth and by wedge at 8x8, 16x16 and 32x32 (the
  sizes that may carry it: 8x32 and 32x8 lie past BLOCK_32X32 and may
  not) beside 4x4 and 64x64 blocks, in 4:2:0, 4:2:2, 4:4:4 and
  monochrome at 8, 10 and 12 bits;
- GLOBALMV inter-intra blocks on a ROTZOOM reference (warped), OBMC and
  local warp blocks beside inter-intra neighbours (which are no warp
  sample), inter-intra blocks on a reference of half the size
  (progressive: scaled prediction) and under 128-pixel superblocks;
- a chained frame whose primary_ref_frame is a frame with inter-intra
  that saved its CDFs (disable_frame_end_update_cdf 0), so the new CDFs
  are inherited adapted;
- segment ids before skip (a REF_FRAME and a SKIP segment beside ALT_LF
  ones, whose deblocking levels make the ids visible): a chained frame
  that keeps the map (update_map 0), one that codes it against it
  (temporal update 1, predicted and coded ids) in four rows of tiles,
  and a chained frame of another size, whose previous map is zeros;
- ``class_mixed_512.avif``, the 512x512 mixed class, and
  ``photo4k_420.avif``, a 3840x2160 frame pair, each with both tools.

The manifest holds what ``make_avif_progressive.entry`` holds (dav1d's
Y'UV CRC, the reference's ``load_avif`` and ``decode_avif_to_rgb8`` CRCs,
the frames, the layer shown, the tool counts, each frame's sizes) and
each frame's count of inter-intra blocks (``interintra``), of those by a
wedge (``interintra_wedge``), of blocks that took the predicted segment
id (``seg_id_predicted``), and whether it kept the map (``seg_map_kept``)
or coded it against it (``seg_temporal``).
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
for _sub in ("avif_superres", "avif_layers", "avif_progressive",
             "avif_compound", "avif_globalmv"):
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), _sub))

from chip_smoke import frame_4k  # noqa: E402
from make_avif_globalmv import RZ, gm_of  # noqa: E402
from make_avif_layers import LIBAOM, aom_encode_layers, container  # noqa: E402
from make_avif_progressive import entry, scaling  # noqa: E402
from make_avif_superres import to_yuv  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

FULL = ("1", "1")
HALF = ("1/2", "1/2")
LAST, LAST2, LAST3, GOLDEN, BWDREF, ALTREF2, ALTREF = range(1, 8)
# the single modes' weights (new, nearest, near, global)
SINGLE = (0.4, 0.2, 0.2, 0.2)
# segmentation of the written frames: ALT_LF of segments 1 and 2 (their
# deblocking levels), REF_FRAME GOLDEN on segment 3 and SKIP on segment 4
# (either puts the ids before skip)
FEATS = {1: {1: -20, 2: -20}, 2: {1: 25, 3: 10, 4: 10}, 3: {5: GOLDEN},
         4: {6: 0}}
FEATS2 = {1: {1: 30, 2: 30}, 2: {1: -30}, 3: {5: GOLDEN}, 4: {6: 0}}
# a chained frame's slots: LAST the first written frame, the rest the key
# frame
CHAIN_SLOTS = (1, 0, 0, 0, 1, 0, 0)
# per counter of the manifest's per-frame lists
PER_FRAME = ("interintra", "interintra_wedge", "seg_id_predicted",
             "seg_map_kept", "seg_temporal")

# name -> (class, depth, subsampling, the scales of libaom's layers,
# write_layered's arguments, seed, the blocks' log2 sizes, ii_sbs' other
# arguments[, chain: the second frame's write_layered arguments and
# ii_sbs' ones[, libaom's options]])
WRITTEN = {
    "ii_smooth_420.avif": ("fractal", 8, "4:2:0", [FULL], dict(),
                           1, (1, 2, 3), dict(ii=0.7, wedge=0.2)),
    "ii_wedge_422_10bit.avif": ("oriented", 10, "4:2:2", [FULL], dict(
        dual=True), 2, (1, 2, 3, 4), dict(ii=0.7, wedge=0.7)),
    "ii_444_12bit.avif": ("edges", 12, "4:4:4", [FULL], dict(), 3,
                          (0, 1, 2, 3), dict(ii=0.6, wedge=0.4)),
    "ii_mono_10bit.avif": ("sinusoid", 10, "mono", [FULL], dict(hp=False),
                           4, (1, 2, 3), dict(ii=0.6, wedge=0.4)),
    "ii_global_rotzoom_420.avif": ("text", 8, "4:2:0", [FULL], dict(
        gm=gm_of(LAST=RZ)), 5, (1, 2, 3), dict(
            ii=0.6, wedge=0.4, modes=(0.1, 0.1, 0.1, 0.7))),
    "ii_obmc_444.avif": ("mixed", 8, "4:4:4", [FULL], dict(motion=True), 6,
                         (1, 2, 3), dict(ii=0.4, wedge=0.4,
                                         motion=(0.3, 0.5, 0.2))),
    "ii_scaled_420.avif": ("oriented", 8, "4:2:0", [HALF], dict(), 7,
                           (1, 2, 3), dict(ii=0.6, wedge=0.4)),
    "ii_sb128_422.avif": ("fractal", 8, "4:2:2", [FULL], dict(), 8,
                          (1, 2, 3, 4), dict(ii=0.6, wedge=0.4), None,
                          {"sb-size": 128}),
    "chain_ii_cdf_420_10bit.avif": ("edges", 10, "4:2:0", [FULL], dict(
        end_cdf=True), 9, (1, 2, 3), dict(ii=0.7, wedge=0.4), (dict(
            ref_slots=CHAIN_SLOTS, primary=0), dict(ii=0.7, wedge=0.4))),
    "seg_keep_420_12bit.avif": ("fractal", 12, "4:2:0", [FULL], dict(
        seg=dict(features=FEATS), end_cdf=True), 10, (0, 1, 2, 3), dict(
            ii=0.3, segs=5), (dict(ref_slots=CHAIN_SLOTS, primary=0, seg=dict(
                map="keep", data=False)), dict(ii=0.3))),
    "seg_temporal_tiles_444_10bit.avif": ("text", 10, "4:4:4", [FULL], dict(
        seg=dict(features=FEATS), tile_rows=2), 11, (0, 1, 2, 3), dict(
            ii=0.3, segs=5), (dict(ref_slots=CHAIN_SLOTS, primary=0, seg=dict(
                map="temporal", features=FEATS2)), dict(
                    ii=0.3, segs=5, seg_pred=0.5))),
    "seg_resized_422.avif": ("oriented", 8, "4:2:2", [FULL], dict(
        seg=dict(features=FEATS)), 12, (1, 2, 3), dict(ii=0.3, segs=5), (
            dict(ref_slots=CHAIN_SLOTS, primary=0, size=(192, 192),
                 seg=dict(map="keep", features=FEATS2)), dict(ii=0.3))),
    "class_mixed_512.avif": ("mixed", 8, "4:2:0", [FULL], dict(
        seg=dict(features=FEATS), end_cdf=True), 13, (1, 2, 3, 4), dict(
            ii=0.5, wedge=0.4, segs=5), (dict(
                ref_slots=CHAIN_SLOTS, primary=0, tile_rows=1, seg=dict(
                    map="temporal", features=FEATS2)), dict(
                        ii=0.5, wedge=0.4, segs=5, seg_pred=0.5))),
    "photo4k_420.avif": ("photo4k", 8, "4:2:0", [FULL], dict(
        seg=dict(features=FEATS), end_cdf=True), 14, (2, 3, 4), dict(
            ii=0.5, wedge=0.4, segs=5), (dict(
                ref_slots=CHAIN_SLOTS, primary=0, tile_rows=1, seg=dict(
                    map="temporal", features=FEATS2)), dict(
                        ii=0.5, wedge=0.4, segs=5, seg_pred=0.5))),
}
# the written frames' size by class (256x256 unless named)
SIZES = {"class_mixed_512.avif": (512, 512),
         "photo4k_420.avif": (3840, 2160)}
# libaom's own: cyclic refresh in three layers, two tile columns
LIBAOM_FILES = {
    "aq_temporal_420.avif": ("mixed", 256, (40, 30, 20), {
        "aq-mode": 3, "cpu-used": 7, "tile-columns": 1}),
}


def ii_sbs(rng: np.random.Generator, n_sb: int, leaves, hp: bool,
           ii: float = 0.5, wedge: float = 0.3, modes=SINGLE, motion=None,
           segs: int = 0, seg_pred: float = 0.0, last_row=()) -> list:
    """Superblocks of square blocks of a size drawn from ``leaves``, each
    a single-reference block on LAST in a mode drawn by ``modes`` (NEWMV,
    NEARESTMV, NEARMV, GLOBALMV) with random filters and NEWMV MVs within
    24 (1/8 sample); one of 8x8 to 32x32 inter-intra with probability
    ``ii`` (a random interintra_mode, by a random wedge with probability
    ``wedge``); where ``motion`` gives the weights of SIMPLE, OBMC and
    LOCALWARP, a motion mode (LOCALWARP for NEWMV only); with ``segs``, a
    segment id below it, and the predicted one with probability
    ``seg_pred``. The superblocks numbered in ``last_row`` are one block
    each."""
    from inter_writer import LOCALWARP, InterBlock

    step = 1 if hp else 2
    names = ("new", "nearest", "near", "global")
    out = []

    def mv():
        return tuple(int(step * rng.integers(-24, 25)) for _ in range(2))

    for i in range(n_sb):
        leaf = 4 if i in last_row else int(rng.choice(leaves))

        def block():
            mode = str(rng.choice(names, p=modes))
            m = int(rng.choice(3, p=motion)) if motion else 0
            if m == LOCALWARP and mode != "new":
                m = 0
            blk_ii = None
            if 1 <= leaf <= 3 and rng.random() < ii:
                blk_ii = (int(rng.integers(4)), int(rng.integers(16))
                          if rng.random() < wedge else None)
            return InterBlock(mv(), (int(rng.integers(3)),
                                     int(rng.integers(3))), m, None, LAST,
                              mode, blk_ii,
                              int(rng.integers(segs)) if segs else 0,
                              bool(rng.random() < seg_pred))

        out.append((leaf, [block() for _ in range(1 << 2 * (4 - leaf))]))
    return out


def _sb_grid(size, sb: int = 64):
    """Superblock columns and rows of ``size``, and the numbers of a last
    superblock row past the frame's edge (one block each)."""
    cols, rows = -(-size[0] // sb), -(-size[1] // sb)
    last = range((rows - 1) * cols, rows * cols) if size[1] % sb else ()
    return cols * rows, last


def written(name: str) -> Tuple[bytes, dict]:
    """A ``WRITTEN`` file and how it was made: libaom's first layer of the
    picture (of the asked scale of its size), the rest replaced by the
    written frames."""
    from inter_writer import write_layered

    cls, depth, ss, modes, kw, seed, leaves, sbs_kw, *more = WRITTEN[name]
    chain = more[0] if more else None
    options = {"cpu-used": 8, "sb-size": 64, **(more[1] if len(more) > 1
                                                 else {})}
    mono = ss == "mono"
    size = SIZES.get(name, (256, 256))
    px = frame_4k() if cls == "photo4k" else bench_images(size[0])[cls]
    yuv = to_yuv(px, depth, "4:2:0" if mono else ss)
    n_written = 1 + (chain is not None)
    scaled = modes[0] != FULL
    key = aom_encode_layers(
        yuv[:1] if mono else yuv, depth, "4:2:0" if mono else ss,
        (40, 30, 20)[:len(modes) + n_written], options=options,
        before_layer=scaling(modes + [FULL] * n_written),
        cfg_words=dict(forced_max_frame_width=size[0],
                       forced_max_frame_height=size[1]) if scaled else ())
    rng = np.random.default_rng(seed)
    hp = kw.get("hp", True)
    sb = 128 if options["sb-size"] == 128 else 64

    def sbs(extra, at):
        n, last = _sb_grid(at, sb)
        # a 128x128 superblock is four 64x64 entries
        n *= (sb // 64) ** 2
        return ii_sbs(rng, n, leaves, hp, last_row=last, **extra)

    counts = {}
    extra = {}
    if chain is not None:
        extra["chain"] = {**chain[0], "sbs": sbs(chain[1], chain[0].get(
            "size", size))}
    stream = write_layered(key, sbs(sbs_kw, size), size=size, counts=counts,
                           interintra=True, **kw, **extra)
    data = container(stream, *size, depth)

    def plain(v):
        if isinstance(v, dict):
            return {str(k): plain(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return [plain(x) for x in v]
        return v

    how = {"writer": f"{LIBAOM} layers 0..{len(modes) - 1}, inter_writer.py "
                     f"layers {len(modes)}..{len(modes) + n_written - 1}",
           "class": cls, "depth": depth, "ss": "4:2:0" if mono else ss,
           "mono": mono, "scales": plain(modes), "seed": seed,
           "leaves": list(leaves), "counts": counts,
           "options": {k: str(v) for k, v in options.items()},
           **{k: plain(v) for k, v in sbs_kw.items()},
           **{k: plain(v) for k, v in kw.items()},
           **({"chain": plain(chain[0])} if chain else {})}
    return data, how


def libaom_file(name: str) -> Tuple[bytes, dict]:
    """A ``LIBAOM_FILES`` file: libaom's layers of the class picture."""
    cls, size, qs, options = LIBAOM_FILES[name]
    yuv = to_yuv(bench_images(size)[cls], 8, "4:2:0")
    stream = aom_encode_layers(yuv, 8, "4:2:0", qs, options=options)
    how = {"writer": f"{LIBAOM} layers 0..{len(qs) - 1}", "class": cls,
           "depth": 8, "ss": "4:2:0", "quantizers": list(qs),
           "options": {k: str(v) for k, v in options.items()}}
    return container(stream, size, size, 8), how


def interintra_entry(data: bytes, how: dict) -> dict:
    """``entry`` and each frame's ``PER_FRAME`` counts."""
    from oavif_tpu_torch.io import avif as A

    out = entry(data, how)
    img = A.decode_avif(data)[1]
    for k in PER_FRAME:
        out[k] = [t[k] for t in img.frame_tools]
    return out


def main() -> None:
    manifest = {}
    only = set(sys.argv[1:])
    for name in [*WRITTEN, *LIBAOM_FILES]:
        if only and name not in only:
            continue
        print(name, flush=True)
        data, how = (written if name in WRITTEN else libaom_file)(name)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = interintra_entry(data, how)
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
