"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_refmvs.py`` and
``chip_smoke.py``: items in three and four spatial layers whose inter
frames set ``use_ref_frame_mvs`` (libaom's default
``enable-ref-frame-mvs``), and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_refmvs/make_avif_refmvs.py [NAME ...]

Names rewrite only those files and merge into the manifest. libaom 3.6
(``libaom.so.3``) writes every stream through ctypes with
``avif_layers/make_avif_layers.aom_encode_layers`` (realtime usage 1, one
spatial layer per quantizer, the options at libaom's defaults past those
named), progressive ones with ``avif_progressive/make_avif_progressive.
scaling`` (``AOME_SET_SCALEMODE`` before each layer; only at 8 bits:
libaom 3.6 crashes on a scaled layer above 8 bits).

libaom's layers reference each other so (``ref_frame_idx`` of LAST..ALTREF,
the slot refreshed, the order hint): layer 1 all slot 0, refreshing slot
1; layer 2 GOLDEN slot 1, refreshing slot 2; layer 3 LAST slot 1 and
GOLDEN slot 2, refreshing slot 3; layer i has order hint i. Motion field
estimation (spec 7.9.1) projects from LAST, from LAST2 and from later
references, never from GOLDEN, and a key frame stores no MV: layer 2
projects nothing, and layer 3 of four projects layer 1's MVs (LAST, whose
saved ALTREF hint 0 is not the current GOLDEN's 2). So the three-layer
files read the temporal candidates' empty case, the four-layer ones the
projection and its candidates; a progressive item at 1/2, 1, 1, 1
projects layer 1's MVs, which point into the scaled key frame, and one at
1/2, 1/2, 1, 1 passes over layer 1 (LAST of another size).

At 1280x720 from ``cpu-used`` 7, at every speed above that size, and on
the 512x512 mixed class at ``cpu-used`` 10, libaom's defaults turn
``reference_select`` on in layer 3 of four and write compound blocks
there, which the port once refused by name (``compound_720p_420.avif``
held that refusal; it now decodes, and ``avif_compound/
make_avif_compound.py`` writes the set of compound blocks). The 3840x2160
frame for the card and the mixed class code layer 3 with LAST alone: the
encode flags ``AOM_EFLAG_NO_REF_LAST2`` .. ``_NO_REF_ARF2``
(``LAST_ONLY``), which leave the frame header's references, and so the
projection, as they are.

The set: three and four layers of the same size on 4:2:0, 4:2:2, 4:4:4
and monochrome at 8, 10 and 12 bits over ``cpu-used`` 5 to 10 (OBMC and
local warps on below 7, as libaom's defaults have them), two tile
columns, 128-pixel superblocks, an alpha item in four layers, the six
512x512 bench classes in four layers, the two progressive items, the
3840x2160 four-layer frame and the 1280x720 one with a compound block.

The manifest holds what ``make_avif_progressive.entry`` holds (dav1d's
Y'UV CRC through the system libavif 0.11.1, the reference's ``load_avif``
and ``decode_avif_to_rgb8`` CRCs, the frames, the layer shown, the tool
counts or the refused tool, each frame's coded width, upscaled width and
height) and each frame's ``use_ref_frame_mvs``.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "avif_superres"))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "avif_layers"))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "avif_progressive"))

from chip_smoke import frame_4k, with_alpha  # noqa: E402
from make_avif_layers import LIBAOM, encode_avif  # noqa: E402
from make_avif_progressive import entry, scaling  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

FULL = ("1", "1")
HALF = ("1/2", "1/2")
# AOM_EFLAG_NO_REF_LAST2 .. AOM_EFLAG_NO_REF_ARF2: LAST the one reference
LAST_ONLY = sum(1 << b for b in range(17, 23))
FOUR_Q = (56, 44, 32, 20)
THREE_Q = (52, 36, 20)


def files() -> dict:
    """name -> (pixels, layer scales, encode_avif's other arguments); the
    3840x2160 frame's pixels come from a function, made when written"""
    im = bench_images(256)
    big = bench_images(512)
    names = list(im)
    out = {}
    grid = (("4:2:0", 8, 5, 4), ("4:2:2", 8, 6, 4), ("4:4:4", 8, 7, 4),
            ("mono", 8, 8, 4), ("4:2:0", 10, 9, 4), ("4:2:2", 10, 10, 4),
            ("4:4:4", 10, 5, 4), ("mono", 10, 6, 4), ("4:2:0", 12, 7, 4),
            ("4:2:2", 12, 8, 4), ("4:4:4", 12, 9, 4), ("mono", 12, 10, 4),
            ("4:2:0", 8, 8, 3), ("4:4:4", 10, 6, 3), ("4:2:2", 12, 9, 3),
            ("mono", 8, 10, 3))
    for i, (ss, depth, speed, layers) in enumerate(grid):
        mono = ss == "mono"
        qs = FOUR_Q if layers == 4 else THREE_Q
        out[f"{('three', 'four')[layers - 3]}_{ss.replace(':', '')}_"
            f"{depth}bit_s{speed}.avif"] = (
            im[names[i % 6]], [FULL] * layers, dict(
                depth=depth, ss="4:2:0" if mono else ss, mono=mono,
                quantizers=qs, options={"cpu-used": speed}))
    out.update({
        "tiles2_420.avif": (big["oriented"], [FULL] * 4, dict(
            depth=8, ss="4:2:0", quantizers=FOUR_Q,
            options={"cpu-used": 7, "tile-columns": 1})),
        "sb128_420.avif": (im["fractal"], [FULL] * 4, dict(
            depth=8, ss="4:2:0", quantizers=FOUR_Q,
            options={"cpu-used": 6, "sb-size": 128})),
        "alpha_420.avif": (with_alpha(im["edges"]), [FULL] * 4, dict(
            depth=8, ss="4:2:0", quantizers=FOUR_Q,
            options={"cpu-used": 8})),
        "progressive_half_420.avif": (im["mixed"], [HALF] + [FULL] * 3,
                                      dict(depth=8, ss="4:2:0",
                                           quantizers=FOUR_Q,
                                           options={"cpu-used": 8})),
        "progressive_skip_420.avif": (im["text"], [HALF] * 2 + [FULL] * 2,
                                      dict(depth=8, ss="4:2:0",
                                           quantizers=FOUR_Q,
                                           options={"cpu-used": 9})),
        "compound_720p_420.avif": (
            lambda: frame_4k()[:720, :1280], [FULL] * 4, dict(
                depth=8, ss="4:2:0", quantizers=(60, 52, 44, 36),
                options={"cpu-used": 8})),
        "photo4k_420.avif": (frame_4k, [FULL] * 4, dict(
            depth=8, ss="4:2:0", quantizers=(56, 48, 40, 32),
            options={"cpu-used": 9}, layer_flags={3: LAST_ONLY})),
    })
    for j, (name, px) in enumerate(big.items()):
        out[f"class_{name}_512.avif"] = (px, [FULL] * 4, dict(
            depth=8, ss="4:2:0", quantizers=(56, 46, 36, 26),
            options={"cpu-used": 5 + j},
            **({"layer_flags": {3: LAST_ONLY}} if name == "mixed" else {})))
    return out


def make(px, modes, kw) -> tuple:
    """A file's bytes and how it was written."""
    data = encode_avif(px() if callable(px) else px,
                       before_layer=scaling(modes), **kw)
    how = {"writer": LIBAOM, "usage": 1,
           "scales": [list(m) for m in modes],
           **{k: (list(v) if isinstance(v, tuple) else v)
              for k, v in kw.items() if k not in ("options", "layer_flags")},
           **{k: str(v) for k, v in dict(kw.get("options", {})).items()}}
    if "layer_flags" in kw:
        how["layer_flags"] = {str(k): "AOM_EFLAG_NO_REF_LAST2..ARF2"
                              for k in kw["layer_flags"]}
    return data, how


def main() -> None:
    from oavif_tpu_torch.io import avif as A

    manifest = {}
    only = set(sys.argv[1:])
    for name, (px, modes, kw) in files().items():
        if only and name not in only:
            continue
        print(name, flush=True)
        data, how = make(px, modes, kw)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = entry(data, how)
        manifest[name]["refmvs"] = [
            f.frame.use_ref_frame_mvs for f in A.parse_av1(
                A.read_container(data).color.payload).frames]
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
