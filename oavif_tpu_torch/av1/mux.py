"""AVIF (HEIF/ISOBMFF) still-image muxer.

Mirrors the box layout libavif emits for a single-item AVIF
(ftyp / meta[hdlr pitm iloc iinf iprp] / mdat), reference behavior at
oavif src/io.zig:544-636 (avifEncoderAddImage + Finish). ICC
profiles attach as a 'colr'(prof) property alongside the nclx CICP one
(io.zig:556-560 passthrough behavior).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _fullbox(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(typ, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def mux_avif(
    av1_payload: bytes,
    width: int,
    height: int,
    bit_depth: int = 8,
    seq_profile: int = 1,
    seq_level_idx: int = 0,
    high_bitdepth: bool = False,
    monochrome: bool = False,
    cicp: Tuple[int, int, int] = (2, 2, 2),
    full_range: bool = True,
    icc: Optional[bytes] = None,
    alpha_payload: Optional[bytes] = None,
) -> bytes:
    """Assemble a single-item (plus optional alpha item) AVIF file."""
    have_alpha = alpha_payload is not None

    ftyp = _box(b"ftyp", b"avif" + struct.pack(">I", 0) + b"avifmif1miafMA1B")

    hdlr = _fullbox(b"hdlr", 0, 0, struct.pack(">I4s3I", 0, b"pict", 0, 0, 0) + b"\x00")
    pitm = _fullbox(b"pitm", 0, 0, struct.pack(">H", 1))

    # --- items -------------------------------------------------------------
    items: List[Tuple[int, bytes, bytes]] = [(1, b"av01", av1_payload)]
    if have_alpha:
        items.append((2, b"av01", alpha_payload))

    # iinf
    infes = b""
    for item_id, item_type, _ in items:
        name = b"Color\x00" if item_id == 1 else b"Alpha\x00"
        infes += _fullbox(
            b"infe", 2, 0, struct.pack(">HH4s", item_id, 0, item_type) + name
        )
    iinf = _fullbox(b"iinf", 0, 0, struct.pack(">H", len(items)) + infes)

    # iref (alpha → auxl referencing color item)
    iref = b""
    if have_alpha:
        auxl = _box(b"auxl", struct.pack(">HHH", 2, 1, 1))
        iref = _fullbox(b"iref", 0, 0, auxl)

    # --- properties ----------------------------------------------------------
    def ispe():
        return _fullbox(b"ispe", 0, 0, struct.pack(">II", width, height))

    def pixi(nplanes):
        return _fullbox(
            b"pixi", 0, 0, bytes([nplanes]) + bytes([bit_depth] * nplanes)
        )

    def av1c(mono):
        b0 = 0x80 | 1  # marker | version
        b1 = (seq_profile << 5) | seq_level_idx
        b2 = (
            (0 << 7)  # seq_tier
            | ((1 if high_bitdepth else 0) << 6)
            | (0 << 5)  # twelve_bit
            | ((1 if mono else 0) << 4)
            | ((1 if mono else 0) << 3)  # chroma_subsampling_x
            | ((1 if mono else 0) << 2)  # chroma_subsampling_y
            | 0  # chroma_sample_position
        )
        return _box(b"av1C", bytes([b0, b1, b2, 0]))

    def colr_nclx():
        cp, tc, mc = cicp
        return _box(
            b"colr",
            b"nclx"
            + struct.pack(">HHHB", cp, tc, mc, 0x80 if full_range else 0),
        )

    props: List[bytes] = [ispe(), pixi(1 if monochrome else 3), av1c(monochrome)]
    color_assoc = [1, 2, 3 | 0x80]  # av1C essential
    if icc:
        props.append(_box(b"colr", b"prof" + icc))
        color_assoc.append(len(props))
    props.append(colr_nclx())
    color_assoc.append(len(props))

    alpha_assoc: List[int] = []
    if have_alpha:
        props.append(ispe())
        alpha_assoc.append(len(props))
        props.append(pixi(1))
        alpha_assoc.append(len(props))
        props.append(av1c(True))
        alpha_assoc.append(len(props) | 0x80)
        props.append(
            _fullbox(
                b"auxC", 0, 0, b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\x00"
            )
        )
        alpha_assoc.append(len(props))

    ipco = _box(b"ipco", b"".join(props))
    ipma_entries = struct.pack(">I", len(items))
    ipma_entries += struct.pack(">HB", 1, len(color_assoc)) + bytes(color_assoc)
    if have_alpha:
        ipma_entries += struct.pack(">HB", 2, len(alpha_assoc)) + bytes(alpha_assoc)
    ipma = _fullbox(b"ipma", 0, 0, ipma_entries)
    iprp = _box(b"iprp", ipco + ipma)

    # --- iloc (needs final offsets; compute via fixed-point iteration) ------
    def build_iloc(offsets):
        payload = struct.pack(">BBH", 0x44, 0x00, len(items))
        for (item_id, _, data), off in zip(items, offsets):
            payload += struct.pack(">HHH", item_id, 0, 1)
            payload += struct.pack(">II", off, len(data))
        return _fullbox(b"iloc", 0, 0, payload)

    # sizes are offset-independent (4-byte offset fields), so one pass to
    # measure then one to fill
    probe_iloc = build_iloc([0] * len(items))
    meta_payload = hdlr + pitm + probe_iloc + iinf + iref + iprp
    meta = _fullbox(b"meta", 0, 0, meta_payload)
    mdat_start = len(ftyp) + len(meta) + 8
    offsets = []
    pos = mdat_start
    for _, _, data in items:
        offsets.append(pos)
        pos += len(data)
    iloc = build_iloc(offsets)
    meta = _fullbox(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref + iprp)
    mdat = _box(b"mdat", b"".join(d for _, _, d in items))
    return ftyp + meta + mdat
