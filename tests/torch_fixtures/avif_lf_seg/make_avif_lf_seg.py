"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_lf_seg.py`` and
``chip_smoke.py``: key frames with the segmentation features other than
ALT_Q, ``delta_lf_multi`` and the loop filter settings around them, and
their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_lf_seg/make_avif_lf_seg.py

libaom 3.6 puts none of these tools into a key frame, so
``keyframe_writer.py`` beside this script writes the streams symbol by
symbol (64x64 blocks whose DC levels step by up to about 80 pixel values
from block to block, so that the deblocking levels decide what is
smoothed) and muxes each into a one-item AVIF. The streams:

- each of the seven features alone: ALT_LF_Y_V, ALT_LF_Y_H, ALT_LF_U and
  ALT_LF_V (raising one segment's level and lowering another's), SKIP,
  REF_FRAME and GLOBALMV (which in a key frame only put the segment id
  before ``skip``);
- ALT_LF_V on segment 7 (LastActiveSegId 7), the feature whose bit is
  the sign bit of the decoder's 32-bit ALT_LF mask;
- ``delta_lf_multi`` at ``delta_lf_res`` 0, 1 and 2, each superblock moving
  its four DeltaLF (two in the monochrome frame) by its own deltas;
- all eight features at once over six segments (LastActiveSegId 5),
  SKIP segments beside coded ones, with ``delta_lf_multi``, CDEF and
  ``loop_filter_delta_enabled``;
- luma levels 0 with positive ALT_LF, where no plane is deblocked;
- 512x512 and 3840x2160 frames with ALT_LF, SKIP and ``delta_lf_multi``.

They span 4:2:0, 4:4:4 and monochrome, 8 and 10 bits, 64 and 128 pixel
superblocks, ``loop_filter_delta_enabled`` with the default intra
reference delta, with an update to -6 and with one to 0. Each stream
that has something to prove is made from the first seed for which dav1d
(the system libavif 0.11.1) shows it: for an ALT_LF feature and for
``delta_lf_multi``, the stream with that feature's values set to 0
decodes to other pixels in the planes the feature filters; for SKIP,
REF_FRAME and GLOBALMV, the same tile under a header whose features do
not set SegIdPreSkip (the feature moved to ALT_LF_Y_V 0) fails to decode
or decodes to other pixels.

The manifest holds, per file, the fields of the other AVIF folders (how
it was written, with its seed and what it proves; the CRC32 of dav1d's
Y'UV; the shape, ``hbd`` flag, ICC length and CRC32 of the reference's
``load_avif`` pixels and the CRC32 of its ``decode_avif_to_rgb8`` pixels;
the count of each tool the port's decoder met).
"""

from __future__ import annotations

import copy
import json
import os
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from keyframe_writer import (ALT_LF, PRESKIP_FEATURES, Block,  # noqa: E402
                             Frame, avif_still, frame_obus)

MULTI = "delta_lf_multi"
PRESKIP = "preskip"
SEARCH = 200  # seeds tried for a stream's proof


def features(**on) -> list:
    """8 segments x 8 features from ``s<segment>f<feature>=value``."""
    f = [[None] * 8 for _ in range(8)]
    for key, v in on.items():
        seg, feat = key[1:].split("f")
        f[int(seg)][int(feat)] = v
    return f


# name -> (the frame without its blocks, what it proves)
SPECS = {
    "alt_lf_y_v_420.avif": (Frame(256, 192, lf=(8, 8, 8, 8), features=features(
        s1f1=40, s2f1=-8, s3f0=0)), 1),
    "alt_lf_y_h_444_10b.avif": (Frame(256, 192, ss=(0, 0), bitdepth=10,
                                      lf=(8, 8, 8, 8), lf_delta=True,
                                      features=features(s1f2=40, s2f2=-8,
                                                        s3f0=0)), 2),
    "alt_lf_u_420_sb128.avif": (Frame(384, 256, sb128=True, lf=(8, 8, 8, 8),
                                      lf_delta=-6, features=features(
                                          s1f3=40, s2f3=-8, s3f0=0)), 3),
    "alt_lf_v_444.avif": (Frame(256, 192, ss=(0, 0), lf=(8, 8, 8, 8),
                                lf_delta=0, features=features(
                                    s1f4=40, s2f4=-8, s3f0=0)), 4),
    "alt_lf_v_seg7_420.avif": (Frame(384, 256, lf=(8, 8, 8, 8),
                                     features=features(s7f4=40, s3f4=-8)),
                               4),
    "skip_444.avif": (Frame(256, 192, ss=(0, 0), lf=(20, 20, 12, 12),
                            features=features(s1f6=0, s2f0=0)), PRESKIP),
    "ref_frame_mono.avif": (Frame(256, 192, mono=True, lf=(20, 20, 0, 0),
                                  features=features(s2f5=3)), PRESKIP),
    "globalmv_420_10b.avif": (Frame(256, 192, bitdepth=10,
                                    lf=(20, 20, 12, 12),
                                    features=features(s1f7=0, s2f0=0)),
                              PRESKIP),
    "multi_420_res0.avif": (Frame(256, 192, lf=(10, 10, 10, 10),
                                  delta_q_res=0, delta_lf=(0, True)), MULTI),
    "multi_444_10b_sb128_res2.avif": (Frame(384, 256, ss=(0, 0), bitdepth=10,
                                            sb128=True, lf=(10, 10, 10, 10),
                                            delta_q_res=1,
                                            delta_lf=(2, True)), MULTI),
    "multi_mono_res1.avif": (Frame(256, 192, mono=True, lf=(10, 10, 0, 0),
                                   delta_q_res=0, delta_lf=(1, True)), MULTI),
    "combined_420_10b_sb128.avif": (Frame(
        384, 256, sb128=True, bitdepth=10, lf=(10, 14, 8, 9),
        lf_delta=True, delta_q_res=0, delta_lf=(0, True),
        cdef=(4, 2, ((3, 1, 2, 1), (8, 2, 4, 3), (0, 0, 0, 0), (15, 3, 15, 3))),
        features=features(s0f1=10, s1f0=-20, s1f2=-5, s2f3=30, s2f4=-63,
                          s3f6=0, s4f5=1, s4f1=20, s5f7=0, s5f4=12)), None),
    "zero_luma_alt_lf_420.avif": (Frame(256, 192, lf=(0, 0, 0, 0),
                                        features=features(
                                            s1f1=40, s1f2=40, s1f3=40,
                                            s1f4=40)), None),
    "lf_seg512_420.avif": (Frame(512, 512, lf=(10, 12, 8, 8),
                                 delta_q_res=0, delta_lf=(0, True),
                                 features=features(s1f1=30, s1f2=20, s2f3=-8,
                                                   s3f6=0, s4f4=25)), None),
    "lf_seg4k_420.avif": (Frame(3840, 2160, sb128=True, lf=(10, 12, 8, 8),
                                delta_q_res=0, delta_lf=(1, True),
                                cdef=(3, 1, ((4, 1, 2, 1), (9, 2, 3, 2))),
                                features=features(s1f1=30, s1f2=20, s2f3=-8,
                                                  s3f6=0, s4f4=25)), None),
}


def frame(name: str, seed: int) -> Frame:
    """The named stream's frame with the blocks of this seed: DC levels
    up to 80 in each plane (base_q_idx 160), one in eight skipped, ids over
    the active segments, random luma modes, deltas of -2 to 2 and CDEF
    indices."""
    fr = copy.deepcopy(SPECS[name][0])
    fr.base_q = 160
    rng = np.random.default_rng(seed)
    rows, cols = -(-fr.height // 64), -(-fr.width // 64)
    n = fr.last_active + 1
    nsets = 1 << fr.cdef[1] if fr.cdef else 1

    def block():
        return Block(dc=tuple(int(v) for v in rng.integers(-80, 81, 3)),
                     skip=int(rng.random() < 0.125),
                     seg=int(rng.integers(0, n)), mode=int(rng.integers(0, 3)),
                     dq=int(rng.integers(-2, 3)),
                     dlf=tuple(int(v) for v in rng.integers(-2, 3, 4)),
                     cdef=int(rng.integers(0, nsets)))
    fr.blocks = [[block() for _ in range(cols)] for _ in range(rows)]
    return fr


def zeroed(fr: Frame, what) -> Frame:
    """The frame with a feature's values set to 0: ALT_LF feature ``what``
    in every segment, or every block's DeltaLF deltas."""
    z = copy.deepcopy(fr)
    if what == MULTI:
        for row in z.blocks:
            for b in row:
                b.dlf = (0, 0, 0, 0)
    else:
        for seg in z.features:
            if seg[what] is not None:
                seg[what] = 0
    return z


def misread_header(fr: Frame) -> Frame:
    """The frame's headers with REF_FRAME, SKIP and GLOBALMV moved to
    ALT_LF_Y_V 0 of the same segment: SegIdPreSkip 0, the rest equal."""
    h = copy.deepcopy(fr)
    for seg in h.features:
        if any(seg[j] is not None for j in PRESKIP_FEATURES):
            for j in PRESKIP_FEATURES:
                seg[j] = None
            seg[ALT_LF[0]] = 0
    return h


def dav1d_planes(data: bytes):
    """dav1d's Y'UV of an AVIF file, or None where it fails."""
    from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv

    try:
        planes, _, _ = decode_to_yuv(data)
    except Exception:
        return None
    return [p for p in planes if p is not None]


def changed_planes(fr: Frame, other: bytes) -> list:
    """The planes in which dav1d's decode of ``other`` (an AV1 stream of
    fr's size) differs from its decode of fr; all where it fails."""
    a = dav1d_planes(avif_still(frame_obus(fr), fr))
    b = dav1d_planes(avif_still(other, fr))
    if b is None:
        return list(range(fr.nplanes))
    return [p for p in range(fr.nplanes) if not np.array_equal(a[p], b[p])]


def proven(name: str, fr: Frame) -> bool:
    """Whether dav1d shows what the stream is to prove."""
    what = SPECS[name][1]
    if what is None:
        return True
    if what == PRESKIP:
        return bool(changed_planes(fr, frame_obus(fr, misread_header(fr))))
    planes = changed_planes(fr, frame_obus(zeroed(fr, what)))
    if what == MULTI:
        return 0 in planes and (fr.mono or 1 in planes or 2 in planes)
    return {1: 0, 2: 0, 3: 1, 4: 2}[what] in planes


def files() -> dict:
    """name -> (AVIF bytes, how it was written)"""
    out = {}
    for name in SPECS:
        for seed in range(SEARCH):
            fr = frame(name, seed)
            if proven(name, fr):
                break
        else:
            raise RuntimeError(f"{name}: no seed proves it")
        how = {"writer": "keyframe_writer.py", "seed": seed,
               "proves": SPECS[name][1], "size": [fr.width, fr.height],
               "depth": fr.bitdepth, "sb128": fr.sb128,
               "subsampling": "4:0:0" if fr.mono else
               ("4:2:0" if fr.ss == (1, 1) else "4:4:4")}
        out[name] = (avif_still(frame_obus(fr), fr), how)
    return out


def crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def manifest_entry(name: str, data: bytes, how: dict) -> dict:
    from oavif_tpu.io.image import decode_avif_to_rgb8, load_avif
    from oavif_tpu_torch.io import avif as A

    path = os.path.join(HERE, name)
    img = load_avif(path)
    planes = dav1d_planes(data)
    box, port, alpha = A.decode_avif(data)
    return {"bytes": len(data), "written": how,
            "load_shape": list(img.data.shape), "load_hbd": img.hbd,
            "load_crc": crc(img.data), "icc": len(img.icc or b""),
            "rgb8_crc": crc(decode_avif_to_rgb8(data)),
            "depth": how["depth"],
            "yuv_crc": crc(np.concatenate([p.astype("<u2").reshape(-1)
                                           for p in planes])),
            "tools": port.tools, "alpha_tools": None, "source": box.source,
            "grid": None, "alpha": False, "premultiplied": False}


def main() -> None:
    manifest = {}
    for name, (data, how) in files().items():
        print(name, len(data), how["seed"], flush=True)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = manifest_entry(name, data, how)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
