"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_progressive.py``
and ``chip_smoke.py``: progressive items, whose later spatial layers are
inter frames predicted from a layer of another size (spec 7.11.3.3
scaled prediction), inter frames under superres, and their
``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_progressive/make_avif_progressive.py

libaom 3.6 (``libaom.so.3``) writes most streams through ctypes with
``make_avif_layers.aom_encode_layers`` (realtime usage, one spatial layer
per quantizer), sending ``AOME_SET_SCALEMODE`` (control 11, an
``aom_scaling_mode_t`` of two ``int``: the horizontal and vertical
``AOM_SCALING_MODE``) before each layer's encode, as libavif's layered
encoding codes a first layer smaller than the image; ``aom_codec_control``
is variadic, so the pointer goes through a ``CFUNCTYPE`` prototype of its
own. Superres inter frames come from libaom's fixed superres mode
(``rc_superres_mode`` 1) over layers.

libaom 3.6 crashes (SIGSEGV) when it encodes a scaled layer above 8 bits,
so the 10- and 12-bit files take libaom's key frame coded at the smaller
size under a larger maximum frame size (``g_forced_max_frame_width`` and
``_height``) and ``avif_layers/inter_writer.py`` writes the larger inter
frame over it, as it writes the reference larger than its frame and the
references past the spec's limits (more than 2x larger, more than 16x
smaller), which every decoder must refuse.

The set: layer 0 at each of libaom's six scaling modes and at half the
width only, 4:2:2, 4:4:4 and monochrome, ``cpu-used`` 6 to 10 (below 7
with OBMC and warped motion off), three layers at 1/4, 1/2 and 1, an
alpha item in scaled layers, two tile columns, the six 512x512 bench
classes at 1/2, a 3840x2160 4:2:0 frame on a 1920x1080 layer 0 for the
card, superres inter frames, the written files, ``cpu-used`` 5 (OBMC,
the one motion mode a scaled reference reads) and the references past
the limits (``broken``).

The manifest holds what ``make_avif_layers.manifest_entry`` holds (dav1d's
Y'UV CRC through the system libavif 0.11.1, the reference's ``load_avif``
and ``decode_avif_to_rgb8`` CRCs, the frames, the layer shown, the tool
counts or the refused tool) and each frame's coded width, upscaled width
and height; for a broken file, the port's message.
"""

from __future__ import annotations

import ctypes as C
import json
import os
import sys
from typing import Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
LAYERS = os.path.join(os.path.dirname(HERE), "avif_layers")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "avif_superres"))
sys.path.insert(0, LAYERS)

from chip_smoke import frame_4k, with_alpha  # noqa: E402
from make_avif_layers import (LIBAOM, aom_encode_layers,  # noqa: E402
                              container, encode_avif, manifest_entry)
from make_avif_superres import to_yuv  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

_SET_SCALEMODE = 11  # AOME_SET_SCALEMODE
# AOM_SCALING_MODE by the scale it codes a layer at
MODES = {"1": 0, "4/5": 1, "3/5": 2, "3/4": 3, "1/4": 4, "1/8": 5, "1/2": 6}


def scaling(modes) -> callable:
    """``aom_encode_layers``' ``before_layer``: layer i coded at the
    (horizontal, vertical) scales ``modes[i]``."""
    def send(lib, ctx, layer):
        control = C.CFUNCTYPE(C.c_int, C.c_void_p, C.c_int, C.c_void_p)(
            ("aom_codec_control", lib))
        mode = (C.c_int * 2)(*(MODES[m] for m in modes[layer]))
        if control(C.addressof(ctx), _SET_SCALEMODE, mode):
            raise RuntimeError("libaom refuses the scaling mode")
    return send


def files() -> dict:
    """name -> (pixels, layer scales, encode_avif's other arguments)"""
    im = bench_images(256)
    big = bench_images(512)
    half = ("1/2", "1/2")
    full = ("1", "1")
    out = {}
    for name, cls, ss, mode, speed in (
            ("half_420", "mixed", "4:2:0", "1/2", 8),
            ("quarter_420", "edges", "4:2:0", "1/4", 9),
            ("eighth_420", "fractal", "4:2:0", "1/8", 10),
            ("three_quarters_420", "oriented", "4:2:0", "3/4", 7),
            ("four_fifths_420", "sinusoid", "4:2:0", "4/5", 6),
            ("three_fifths_420", "text", "4:2:0", "3/5", 8),
            ("half_422", "edges", "4:2:2", "1/2", 10),
            ("half_444", "fractal", "4:4:4", "1/2", 7),
            ("half_mono", "oriented", "mono", "1/2", 6)):
        opts = {"cpu-used": speed}
        if speed < 7:  # OBMC and warped motion off (avif_warp has them)
            opts.update({"enable-obmc": 0, "enable-warped-motion": 0})
        out[f"{name}.avif"] = (im[cls], [(mode, mode), full], dict(
            depth=8, ss="4:2:0" if ss == "mono" else ss, mono=ss == "mono",
            quantizers=(40, 20), options=opts))
    out.update({
        "half_width_420.avif": (im["text"], [("1/2", "1"), full], dict(
            depth=8, ss="4:2:0", quantizers=(36, 16),
            options={"cpu-used": 9})),
        "three_layers_420.avif": (im["fractal"], [
            ("1/4", "1/4"), half, full], dict(
                depth=8, ss="4:2:0", quantizers=(50, 30, 12),
                options={"cpu-used": 8, "enable-ref-frame-mvs": 0})),
        "alpha_420.avif": (with_alpha(im["edges"]), [half, full], dict(
            depth=8, ss="4:2:0", quantizers=(36, 20),
            options={"cpu-used": 8})),
        "tiles2_420.avif": (big["oriented"], [half, full], dict(
            depth=8, ss="4:2:0", quantizers=(40, 24),
            options={"cpu-used": 7, "tile-columns": 1})),
        # the inter frame coded at 8/16 of its width from a 128x128 layer
        # 0, and a superres key frame under a superres inter frame
        "superres_420.avif": (im["mixed"], [half, full], dict(
            depth=8, ss="4:2:0", quantizers=(40, 20),
            options={"cpu-used": 8}, cfg_words=dict(
                superres_mode=1, superres_denominator=16,
                superres_kf_denominator=8))),
        "superres_both_420.avif": (im["sinusoid"], [full, full], dict(
            depth=8, ss="4:2:0", quantizers=(40, 20),
            options={"cpu-used": 9}, cfg_words=dict(
                superres_mode=1, superres_denominator=12,
                superres_kf_denominator=16))),
        # libaom's default at cpu-used 5 on a scaled layer: OBMC
        "obmc_s5_420.avif": (im["mixed"], [half, full], dict(
            depth=8, ss="4:2:0", quantizers=(50, 20),
            options={"cpu-used": 5})),
        "photo4k_420.avif": (frame_4k(), [half, full], dict(
            depth=8, ss="4:2:0", quantizers=(40, 24),
            options={"cpu-used": 9})),
    })
    for j, (name, px) in enumerate(big.items()):
        out[f"class_{name}_512.avif"] = (px, [half, full], dict(
            depth=8, ss="4:2:0", quantizers=(44 - 4 * j, 24 - 2 * j),
            options={"cpu-used": 7 + j % 3}))
    return out


# streams whose inter frame ``inter_writer`` writes over libaom's key
# frame: name -> (class, depth, subsampling, the key frame's size, the
# inter frame's size, write_layered's arguments, seed, every how many
# superblocks one is split into 4x4 blocks); the writer codes every
# partition symbol, so the inter frame's superblocks lie inside it (or,
# unsplit, reach past its edge by less than half)
WRITTEN = {
    "written_half_420_10bit.avif": ("mixed", 10, "4:2:0", (128, 128),
                                    (256, 256), dict(filt=4, dual=True), 1,
                                    3),
    "written_three_fifths_444_12bit.avif": ("fractal", 12, "4:4:4",
                                            (154, 154), (256, 256),
                                            dict(filt=2), 2, 0),
    "written_larger_ref_420.avif": ("oriented", 8, "4:2:0", (256, 256),
                                    (128, 128), dict(filt=4), 3, 2),
    "written_larger_ref_422_10bit.avif": ("edges", 10, "4:2:2", (256, 256),
                                          (192, 128), dict(filt=3), 4, 0),
}
# references past the spec's limits (2 * FrameWidth >= RefUpscaledWidth,
# FrameWidth <= 16 * RefUpscaledWidth)
BROKEN = {
    "broken_ref_over_2x.avif": ("mixed", 8, "4:2:0", (256, 256),
                                (120, 128), dict(filt=0), 5, 0),
    "broken_ref_under_16th.avif": ("mixed", 8, "4:2:0", (15, 15),
                                   (256, 256), dict(filt=0), 6, 0),
}


def written(name: str) -> Tuple[bytes, dict]:
    """A ``WRITTEN`` or ``BROKEN`` file and how it was made: libaom's two
    layers of the key frame's size at the larger of the two sizes as the
    maximum, the inter frame of layer 1 written over its layer 0."""
    from inter_writer import random_sbs, write_layered

    cls, depth, ss, key_size, size, kw, seed, split = {**WRITTEN,
                                                       **BROKEN}[name]
    kw_, kh = key_size
    top = (max(kw_, size[0]), max(kh, size[1]))
    px = bench_images(256)[cls][:kh, :kw_]
    key = aom_encode_layers(to_yuv(px, depth, ss), depth, ss, (40, 20),
                            options={"cpu-used": 8}, cfg_words=dict(
                                forced_max_frame_width=top[0],
                                forced_max_frame_height=top[1])
                            if top != key_size else ())
    rng = np.random.default_rng(seed)
    n_sb = -(-size[0] // 64) * -(-size[1] // 64)
    sbs = random_sbs(rng, n_sb, split, 40, 3, kw.get("hp", True))
    data = container(write_layered(key, sbs, size=size, **kw), *size, depth)
    how = {"writer": f"{LIBAOM} layer 0, inter_writer.py layer 1",
           "class": cls, "depth": depth, "ss": ss,
           "key_size": list(key_size), "size": list(size), "seed": seed,
           "split_every": split,
           **{k: (list(v) if isinstance(v, tuple) else v)
              for k, v in kw.items()}}
    return data, how


def entry(data: bytes, how: dict) -> dict:
    """``manifest_entry`` and each frame's (coded width, upscaled width,
    height)."""
    from oavif_tpu_torch.io import avif as A

    out = manifest_entry(data, how)
    av1 = A.parse_av1(A.read_container(data).color.payload)
    out["sizes"] = [[f.frame.coded_width, f.frame.width, f.frame.height]
                    for f in av1.frames]
    return out


def broken_entry(data: bytes, how: dict) -> dict:
    """A file past the scaling limits: the port's message."""
    from oavif_tpu_torch.io import avif as A

    try:
        A.decode_avif(data)
    except OSError as e:
        return {"bytes": len(data), "written": how, "broken": str(e)}
    raise AssertionError("the port decodes a reference past the limits")


def main() -> None:
    manifest = {}
    for name, (px, modes, kw) in files().items():
        print(name, flush=True)
        data = encode_avif(px, before_layer=scaling(modes), **kw)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        how = {"writer": LIBAOM, "usage": 1,
               "scales": [list(m) for m in modes],
               **{k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in kw.items() if k not in ("options",
                                                      "cfg_words")},
               **{k: str(v) for k, v in dict(kw.get("options", {})).items()},
               **dict(kw.get("cfg_words", {}))}
        manifest[name] = entry(data, how)
    for name in [*WRITTEN, *BROKEN]:
        print(name, flush=True)
        data, how = written(name)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = (broken_entry if name in BROKEN else entry)(
            data, how)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(e["bytes"] for e in manifest.values())
    print(f"{len(manifest)} files, {total} bytes")


if __name__ == "__main__":
    main()
