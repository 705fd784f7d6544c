"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_globalmv.py``
and ``chip_smoke.py``: items whose last inter frame holds global motion of
every type (spec 5.9.24, 7.10.2.1, 7.11.3.1: TRANSLATION, ROTZOOM and
AFFINE references with GLOBALMV and GLOBAL_GLOBALMV blocks) and skip_mode
blocks (spec 5.9.22, 5.11.10, 5.11.18-25), and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_globalmv/make_avif_globalmv.py [NAME ...]

Names rewrite only those files and merge into the manifest. libaom 3.6
writes neither tool into the layered streams the port reads (its realtime
usage leaves skip_mode_present 0 and every reference IDENTITY; its
good-quality usage codes a second spatial layer as a key frame), so
``avif_layers/inter_writer.py`` writes each file's last frame (or two)
over libaom's first layer or two (``make_avif_layers.aom_encode_layers``,
realtime usage 1, through ctypes), and dav1d (the system libavif 0.11.1)
judges it:

- each global type on single-reference blocks, GLOBALMV beside NEARESTMV,
  NEARMV and NEWMV blocks (4x4 to 64x64, so GLOBALMV under 8x8 too):
  TRANSLATION with unequal x and y translations of opposite signs under
  ``allow_high_precision_mv`` 1 and 0, ROTZOOM and AFFINE, a ROTZOOM
  whose shear the warp filter cannot follow (predicted by translation),
  and OBMC and LOCALWARP blocks beside global ones;
- GLOBAL_GLOBALMV blocks with both sides warped, a warped side beside a
  translated one (TRANSLATION), and a side through a reference of another
  size (a progressive item: translation);
- a written frame that refreshes a slot and a second one whose
  ``primary_ref_frame`` is that slot, so that its ``gm_params`` are coded
  against PrevGmParams that are not the identity;
- skip_mode on a forward and a backward reference (order hint 65 over
  hints 1 and 0 in seven bits) and on two forward ones (order hint 2 over
  1 and 0), skip_mode blocks of 8x8 and more beside compound and single
  blocks, one frame with ``delta_q_present``, one with 128-pixel
  superblocks, and frames with both tools;
- every subsampling at 8, 10 and 12 bits (libaom's scaled encode is
  8-bit only); ``class_mixed_512.avif``, the 512x512 mixed class with both
  tools; ``photo4k_420.avif``, a 3840x2160 frame with both tools over
  libaom's two layers of 64x64 superblocks.

The manifest holds what ``make_avif_progressive.entry`` holds (dav1d's
Y'UV CRC, the reference's ``load_avif`` and ``decode_avif_to_rgb8`` CRCs,
the frames, the layer shown, the tool counts, each frame's sizes), each
frame's count of compound blocks (``compound``, as
``make_avif_compound`` counts them: skip_mode blocks apart), of global
sides (``global``: the global_translation, _rotzoom and _affine
counters) and of skip_mode blocks (``skip_mode``).
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
             "avif_compound"):
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), _sub))

from chip_smoke import frame_4k  # noqa: E402
from make_avif_compound import MODES  # noqa: E402
from make_avif_layers import LIBAOM, aom_encode_layers, container  # noqa: E402
from make_avif_progressive import entry, scaling  # noqa: E402
from make_avif_superres import to_yuv  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

FULL = ("1", "1")
HALF = ("1/2", "1/2")
LAST, LAST2, LAST3, GOLDEN, BWDREF, ALTREF2, ALTREF = range(1, 8)
IDENTITY, TRANSLATION, ROTZOOM, AFFINE = 0, 1, 2, 3
ONE = 1 << 16
GM_NONE = (IDENTITY, (0, 0, ONE, 0, 0, ONE))
# the global counters, by GmType past IDENTITY
GLOBAL = ("global_translation", "global_rotzoom", "global_affine")


def translation(x: int, y: int, hp: bool = True):
    """TRANSLATION by (x, y) in 1/8 sample (even without hp): gm_params[0]
    is x, [1] y (the MV's row is read from [0], the spec's order)."""
    shift = 13 if hp else 14
    k = 1 if hp else 2
    return (TRANSLATION, (x // k << shift, y // k << shift, ONE, 0, 0, ONE))


def rotzoom(a: int, b: int, x: int, y: int):
    """ROTZOOM: gm_params[2] = 1 + 2a, [3] = 2b (in 1/2^16), its
    translation (x, y) in 1/64 sample."""
    return (ROTZOOM, (x << 10, y << 10, ONE + 2 * a, 2 * b, -2 * b,
                      ONE + 2 * a))


def affine(a: int, b: int, c: int, e: int, x: int, y: int):
    return (AFFINE, (x << 10, y << 10, ONE + 2 * a, 2 * b, 2 * c,
                     ONE + 2 * e))


def gm_of(**refs) -> tuple:
    """The global motion of LAST..ALTREF: those named, identity else."""
    names = ("LAST", "LAST2", "LAST3", "GOLDEN", "BWDREF", "ALTREF2",
             "ALTREF")
    return tuple(refs.get(n, GM_NONE) for n in names)


T_HP = translation(37, -90)
T_LOWHP = translation(38, -90, hp=False)
RZ = rotzoom(150, -230, 300, -500)
AF = affine(120, 90, -60, -200, -400, 250)
# 4|alpha| + 7|beta| past 1 << 16: setupShear refuses it
RZ_BAD = rotzoom(4096, 4096, 100, 100)
AF2 = affine(-90, -40, 70, 110, 200, 180)
# slots of LAST .. ALTREF over two libaom layers (layer i in slot i, order
# hint i): LAST on layer 1, LAST2 on the key frame, and so on
TWO = (1, 0, 1, 0, 1, 0, 0)
MIXED_TWO = (0, 0, 1, 1, 0, 0, 1)
# the single modes' and compound modes' weights
SINGLE = (0.3, 0.2, 0.15, 0.35)  # new, nearest, near, global
COMPOUND = (0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.3, 0.1)

# name -> (class, depth, subsampling, the scales of libaom's layers (the
# written frames' are full), write_layered's arguments, seed, the blocks'
# log2 sizes, global_sbs' other arguments[, chain: the second frame's
# write_layered arguments and global_sbs' ones])
WRITTEN = {
    "translation_420.avif": ("fractal", 8, "4:2:0", [FULL], dict(
        gm=gm_of(LAST=T_HP)), 1, (0, 1, 2, 3, 4), dict()),
    "translation_nohp_422_10bit.avif": ("oriented", 10, "4:2:2", [FULL],
                                        dict(gm=gm_of(LAST=T_LOWHP,
                                                      GOLDEN=RZ), hp=False),
                                        2, (0, 1, 2, 3), dict(
                                            refs=(LAST, GOLDEN))),
    "rotzoom_444_12bit.avif": ("edges", 12, "4:4:4", [FULL], dict(
        gm=gm_of(LAST=RZ), dual=True), 3, (0, 1, 2, 3, 4), dict()),
    "affine_motion_mono.avif": ("sinusoid", 8, "mono", [FULL], dict(
        gm=gm_of(LAST=AF), motion=True), 4, (1, 2, 3), dict(
            motion=(0.5, 0.25, 0.25))),
    "invalid_shear_420_10bit.avif": ("text", 10, "4:2:0", [FULL], dict(
        gm=gm_of(LAST=RZ_BAD, ALTREF=AF)), 5, (0, 1, 2, 3), dict(
            refs=(LAST, ALTREF))),
    "compound_warp_444.avif": ("mixed", 8, "4:4:4", [FULL], dict(
        gm=gm_of(LAST=RZ, ALTREF=AF), pair=(LAST, ALTREF), masked=True,
        jnt=True), 6, (1, 2, 3, 4), dict(compound=0.7, pair=(LAST, ALTREF))),
    "compound_mixed_422_12bit.avif": ("fractal", 12, "4:2:2", [FULL], dict(
        gm=gm_of(LAST=AF2, BWDREF=T_HP), pair=(LAST, BWDREF), masked=True),
        7, (1, 2, 3), dict(compound=0.7, pair=(LAST, BWDREF))),
    "compound_scaled_420.avif": ("oriented", 8, "4:2:0", [HALF, FULL], dict(
        gm=gm_of(LAST=RZ, GOLDEN=AF), pair=(LAST, GOLDEN), base_layers=2,
        ref_slots=TWO), 8, (1, 2, 3, 4), dict(compound=0.7,
                                              pair=(LAST, GOLDEN))),
    "chain_prev_gm_420.avif": ("edges", 8, "4:2:0", [FULL], dict(
        gm=gm_of(LAST=RZ, GOLDEN=AF, BWDREF=T_HP)), 9, (1, 2, 3), dict(
            refs=(LAST, GOLDEN, BWDREF)), (dict(
                gm=gm_of(LAST=rotzoom(170, -200, 310, -480), GOLDEN=AF,
                         BWDREF=translation(-20, 44)),
                ref_slots=(1, 0, 0, 1, 1, 0, 0), primary=0), dict(
                    refs=(LAST, GOLDEN, BWDREF)))),
    "skip_bidir_444_10bit.avif": ("text", 10, "4:4:4", [FULL, FULL], dict(
        pair=(LAST, ALTREF), masked=True, base_layers=2, ref_slots=TWO,
        order_hint=65, skip_mode=True), 10, (1, 2, 3, 4), dict(
            skip=0.4, compound=0.3, pair=(LAST, ALTREF),
            refs=(LAST, ALTREF), modes=(0.6, 0.2, 0.2, 0.0))),
    "skip_fwd_mono_12bit.avif": ("mixed", 12, "mono", [FULL, FULL], dict(
        pair=(LAST, LAST3), jnt=True, base_layers=2, ref_slots=MIXED_TWO,
        skip_mode=True), 11, (1, 2, 3), dict(
            skip=0.4, compound=0.3, pair=(LAST, LAST3), refs=(LAST, LAST3),
            modes=(0.6, 0.2, 0.2, 0.0))),
    "skip_delta_q_420_12bit.avif": ("sinusoid", 12, "4:2:0", [FULL, FULL],
                                    dict(pair=(LAST, ALTREF), base_layers=2,
                                         ref_slots=TWO, order_hint=65,
                                         skip_mode=True, delta_q=True,
                                         gm=gm_of(LAST=AF2, ALTREF=T_HP)),
                                    12, (1, 2, 3), dict(
                                        skip=0.4, compound=0.3,
                                        pair=(LAST, ALTREF))),
    "skip_sb128_422.avif": ("edges", 8, "4:2:2", [FULL, FULL], dict(
        pair=(LAST, GOLDEN), masked=True, base_layers=2, ref_slots=TWO,
        skip_mode=True, gm=gm_of(LAST=RZ, GOLDEN=T_HP)), 13, (1, 2, 3, 4),
        dict(skip=0.4, compound=0.3, pair=(LAST, GOLDEN)),
        None, {"sb-size": 128}),
    "both_mono_10bit.avif": ("fractal", 10, "mono", [FULL, FULL], dict(
        pair=(LAST, ALTREF), jnt=True, base_layers=2, ref_slots=TWO,
        order_hint=65, skip_mode=True, gm=gm_of(LAST=AF, ALTREF=RZ)), 14,
        (0, 1, 2, 3), dict(skip=0.3, compound=0.3, pair=(LAST, ALTREF))),
    "class_mixed_512.avif": ("mixed", 8, "4:2:0", [FULL, FULL], dict(
        pair=(LAST, ALTREF), masked=True, base_layers=2, ref_slots=TWO,
        order_hint=65, skip_mode=True, gm=gm_of(LAST=RZ, ALTREF=AF)), 15,
        (1, 2, 3, 4), dict(skip=0.3, compound=0.3, pair=(LAST, ALTREF))),
    "photo4k_420.avif": ("photo4k", 8, "4:2:0", [FULL, FULL], dict(
        pair=(LAST, ALTREF), masked=True, base_layers=2, ref_slots=TWO,
        order_hint=65, skip_mode=True, gm=gm_of(LAST=RZ, ALTREF=AF)), 16,
        (3, 4), dict(skip=0.3, compound=0.3, pair=(LAST, ALTREF))),
}
# the written frames' size by class (256x256 unless named)
SIZES = {"class_mixed_512.avif": (512, 512),
         "photo4k_420.avif": (3840, 2160)}


def global_sbs(rng: np.random.Generator, n_sb: int, leaves, hp: bool,
               modes=SINGLE, refs=(LAST,), compound: float = 0.0,
               pair=None, skip: float = 0.0, motion=None,
               last_row=()) -> list:
    """Superblocks of square blocks of a size drawn from ``leaves``: with
    probability ``skip`` a skip_mode block, else ``compound`` a compound
    block on ``pair`` (GLOBAL_GLOBALMV the likeliest mode), else a
    single-reference block on one of ``refs`` in a mode drawn by ``modes``
    (NEWMV, NEARESTMV, NEARMV, GLOBALMV), with random filters, NEWMV MVs
    within 24 (1/8 sample) and, where ``motion`` gives the weights of
    SIMPLE, OBMC and LOCALWARP, a motion mode (LOCALWARP for NEWMV only).
    The superblocks numbered in ``last_row`` are one block each."""
    from inter_writer import (LOCALWARP, CompoundBlock, InterBlock,
                              SkipModeBlock)

    step = 1 if hp else 2
    names = ("new", "nearest", "near", "global")
    out = []

    def mv():
        return tuple(int(step * rng.integers(-24, 25)) for _ in range(2))

    def filt():
        return (int(rng.integers(3)), int(rng.integers(3)))

    for i in range(n_sb):
        leaf = 4 if i in last_row else int(rng.choice(leaves))

        def block():
            u = rng.random()
            if leaf >= 1 and u < skip:
                return SkipModeBlock()
            if leaf >= 1 and pair and u < skip + compound:
                return CompoundBlock(
                    int(rng.choice(8, p=COMPOUND)),
                    str(rng.choice(("average", "distance", "wedge",
                                    "diffwtd"))), mv(), mv(), filt(),
                    int(rng.integers(16)), int(rng.integers(2)))
            mode = str(rng.choice(names, p=modes))
            m = int(rng.choice(3, p=motion)) if motion else 0
            if m == LOCALWARP and mode != "new":
                m = 0
            return InterBlock(mv(), filt(), m, None,
                              int(rng.choice(refs)), mode)

        out.append((leaf, [block() for _ in range(1 << 2 * (4 - leaf))]))
    return out


def written(name: str) -> Tuple[bytes, dict]:
    """A ``WRITTEN`` file and how it was made: libaom's layers of the
    picture (of the asked scales of its size), its last one (or two)
    replaced by the written frames."""
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
        (40, 30, 20, 10)[:len(modes) + n_written], options=options,
        before_layer=scaling(modes + [FULL] * n_written),
        cfg_words=dict(forced_max_frame_width=size[0],
                       forced_max_frame_height=size[1]) if scaled else ())
    rng = np.random.default_rng(seed)
    sb_cols, sb_rows = -(-size[0] // 64), -(-size[1] // 64)
    # a superblock row past the frame's edge is one block each
    last = range((sb_rows - 1) * sb_cols, sb_rows * sb_cols) \
        if size[1] % 64 else ()
    hp = kw.get("hp", True)

    def sbs(extra):
        return global_sbs(rng, sb_cols * sb_rows, leaves, hp,
                          last_row=last, **extra)

    counts = {}
    extra = {}
    if chain is not None:
        extra["chain"] = {**chain[0], "sbs": sbs(chain[1])}
    stream = write_layered(key, sbs(sbs_kw), size=size, counts=counts,
                           **kw, **extra)
    data = container(stream, *size, depth)

    def plain(v):
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
           **({"chain": {k: plain(v) for k, v in chain[0].items()}}
              if chain else {})}
    return data, how


def globalmv_entry(data: bytes, how: dict) -> dict:
    """``entry`` and each frame's count of compound blocks, of global
    sides and of skip_mode blocks."""
    from oavif_tpu_torch.io import avif as A

    out = entry(data, how)
    img = A.decode_avif(data)[1]
    out["compound"] = [sum(t[m] for m in MODES) for t in img.frame_tools]
    out["global"] = [sum(t[k] for k in GLOBAL) for t in img.frame_tools]
    out["skip_mode"] = [t["skip_mode"] for t in img.frame_tools]
    return out


def main() -> None:
    manifest = {}
    only = set(sys.argv[1:])
    for name in WRITTEN:
        if only and name not in only:
            continue
        print(name, flush=True)
        data, how = written(name)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = globalmv_entry(data, how)
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
