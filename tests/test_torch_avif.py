"""The port's AVIF reader (``oavif_tpu_torch/io/avif.py``, with the AV1
decoder in ``io/av1_decode.c``) on the CPU, against the reference's
``load_avif`` and ``decode_avif_to_rgb8`` (Pillow's AVIF plugin: libavif
1.3 with dav1d and libyuv), with no tolerance:

- the committed fixtures (``tests/torch_fixtures/avif``, written by the
  JAX package's CLI and, three of them, by Pillow's libaom encoder in
  4:2:0, 4:2:2 and 4:4:4 with the intra edge filter): each decodes to its
  manifest CRCs (dav1d's Y'UV, the reference's ``load_avif`` and
  ``decode_avif_to_rgb8`` pixels) and equals the reference live;
- the conversion to RGB: lossless AVIFs built by the port's writers from
  chosen Y'UV samples, for every matrix the CLI lets a user write (and
  matrix 12 under every primaries value), at 8 and 10 bits, with and
  without alpha, against Pillow; the matrices libavif refuses raise;
- ``load_avif`` on the 16-bit path, alpha and ICC against the reference;
- the container: ``iloc`` versions 1 and 2 with ``idat`` and split
  extents, ``infe`` version 3, 32-bit ids, 64-bit box sizes and ``mdat``
  before ``meta``; the full-form sequence and frame headers (equal to
  dav1d's decode); refusals of derived items other than ``grid`` and of
  AV1 tools outside the toolset, and what the reader learned since it
  refused it (transforms, premultiplied alpha, a ``moov`` beside an
  ``avif`` file's items, segmentation); a grid without its descriptor,
  broken and truncated files raise ``OSError`` here and fail in the
  reference too;
- the CLI on AVIF input: the reference CLI's q, passes and bytes, and the
  bytes of the port's CLI on the decoded pixels as PAM.
"""

from __future__ import annotations

import json
import re
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from oavif_tpu import cli as ref_cli  # noqa: E402
from oavif_tpu.io.image import decode_avif_to_rgb8 as ref_rgb8  # noqa: E402
from oavif_tpu.io.image import load_avif as ref_load_avif  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.av1.frame import encode_frame_planes  # noqa: E402
from oavif_tpu_torch.av1.mux import mux_avif  # noqa: E402
from oavif_tpu_torch.av1.obu import (OBU_FRAME, BitWriter,  # noqa: E402
                                     FrameConfig, SequenceConfig,
                                     _choose_level, assemble_av1_stream,
                                     obu, write_frame_header_bits,
                                     write_sequence_header)
from oavif_tpu_torch.io import avif as A  # noqa: E402
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "avif"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_to_its_manifest(name):
    entry = MANIFEST[name]
    path = FIXTURES / name
    data = path.read_bytes()
    assert len(data) == entry["bytes"]
    ref = ref_load_avif(str(path))
    assert [list(ref.data.shape), ref.hbd, _crc(ref.data)] == [
        entry["load_shape"], entry["load_hbd"], entry["load_crc"]]
    assert _crc(ref_rgb8(data)) == entry["rgb8_crc"]
    _, img, _ = A.decode_avif(data)
    yuv = np.concatenate([p.astype("<u2").reshape(-1) for p in img.planes])
    assert _crc(yuv) == entry["yuv_crc"]
    got = load_avif(str(path))
    assert (got.data.dtype, got.hbd, got.channels) == (ref.data.dtype,
                                                        ref.hbd,
                                                        ref.channels)
    np.testing.assert_array_equal(got.data, ref.data)
    assert len(got.icc or b"") == entry["icc"]
    assert got.icc == ref.icc
    assert _crc(decode_avif_to_rgb8(data)) == entry["rgb8_crc"]


def test_fixtures_fit_their_budget():
    files = [p for p in FIXTURES.iterdir() if p.suffix == ".avif"]
    assert sorted(p.name for p in files) == sorted(MANIFEST)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 1_500_000


# ---------------------------------------------------------------------------
# streams built by the port's writers
# ---------------------------------------------------------------------------


def _stream(planes, q=0, bd=8, cicp=(2, 2, 2), alpha=None, icc=None,
            full=False):
    """AVIF of Y'UV planes through the port's frame coder, with no
    post-filters (q 0 is lossless); ``full`` writes the full-form
    sequence and frame headers."""
    h, w = planes[0].shape
    payloads, _, _ = encode_frame_planes(
        [np.ascontiguousarray(p, np.int32) for p in planes], q, bitdepth=bd)
    seq = SequenceConfig(width=w, height=h, bit_depth=bd,
                         color_primaries=cicp[0],
                         transfer_characteristics=cicp[1],
                         matrix_coefficients=cicp[2])
    fr = FrameConfig(width=w, height=h, base_q_idx=q)
    av1 = (_full_form(seq, fr, payloads) if full
           else assemble_av1_stream(seq, fr, payloads))
    ap = None
    if alpha is not None:
        apay, _, _ = encode_frame_planes([alpha.astype(np.int32)], 0,
                                         bitdepth=bd)
        aseq = SequenceConfig(width=w, height=h, bit_depth=bd,
                              monochrome=True, seq_profile=0)
        ap = assemble_av1_stream(aseq, FrameConfig(width=w, height=h,
                                                   base_q_idx=0), apay)
    return mux_avif(av1, w, h, bit_depth=bd, high_bitdepth=bd == 10,
                    cicp=cicp, icc=icc, alpha_payload=ap)


def _bits(w: BitWriter):
    n = len(w.bytes) * 8 - ((8 - w.bitpos) % 8)
    return [(w.bytes[i >> 3] >> (7 - (i & 7))) & 1 for i in range(n)]


def _write_bits(bits) -> BitWriter:
    w = BitWriter()
    for b in bits:
        w.f(b, 1)
    return w


def _seq_header(seq: SequenceConfig, full=False, profile=None, twelve=False,
                superres=False, film_grain=False, mono=False):
    high = seq.bit_depth > 8 or twelve
    """A sequence header OBU in the reduced or the full form."""
    w = BitWriter()
    prof = seq.seq_profile if profile is None else profile
    level = _choose_level(seq.width, seq.height)
    w.f(prof, 3)
    w.f(1, 1)
    w.f(0 if full else 1, 1)
    if full:
        w.f(0, 1)   # timing_info_present_flag
        w.f(0, 1)   # initial_display_delay_present_flag
        w.f(0, 5)   # operating_points_cnt_minus_1
        w.f(0, 12)  # operating_point_idc[0]
        w.f(level, 5)
        if level > 7:
            w.f(0, 1)
    else:
        w.f(level, 5)
    w.f(15, 4)
    w.f(15, 4)
    w.f(seq.width - 1, 16)
    w.f(seq.height - 1, 16)
    if full:
        w.f(0, 1)   # frame_id_numbers_present_flag
    w.f(int(seq.use_128x128_superblock), 1)
    w.f(int(seq.enable_filter_intra), 1)
    w.f(0, 1)       # enable_intra_edge_filter
    if full:
        w.f(0, 4)   # interintra, masked, warped, dual filter
        w.f(0, 1)   # enable_order_hint
        w.f(1, 1)   # seq_choose_screen_content_tools
        w.f(1, 1)   # seq_choose_integer_mv
    w.f(int(superres), 1)
    w.f(int(seq.enable_cdef), 1)
    w.f(int(seq.enable_restoration), 1)
    w.f(int(high), 1)
    if prof == 2 and high:
        w.f(int(twelve), 1)
    if prof != 1:
        w.f(int(mono), 1)
    w.f(1, 1)
    w.f(seq.color_primaries, 8)
    w.f(seq.transfer_characteristics, 8)
    w.f(seq.matrix_coefficients, 8)
    w.f(1, 1)       # color_range
    if not mono:
        if prof == 2 and twelve:
            w.f(0, 1)   # subsampling_x
        w.f(0, 1)   # separate_uv_delta_q
    w.f(int(film_grain), 1)
    w.trailing_bits()
    return obu(1, w.data())


def _full_form(seq, fr, payloads):
    """Full-form sequence header and the frame header of a shown key
    frame with show_existing_frame, frame_type, show_frame,
    frame_size_override_flag and disable_frame_end_update_cdf written."""
    reduced = _bits(write_frame_header_bits(fr))
    head = 3 if fr.screen_content_tools else 2
    mid = 2 if fr.screen_content_tools else 1
    bits = ([0, 0, 0, 1] + reduced[:head] + [0] + reduced[head:head + mid]
            + [0] + reduced[head + mid:])
    w = _write_bits(bits)
    w.byte_align()
    assert len(payloads) == 1
    return (_seq_header(seq, full=True)
            + obu(OBU_FRAME, w.data() + payloads[0]))


def _yuv_probe(bd, h=128, w=128, seed=0):
    rng = np.random.default_rng(seed)
    hi = (1 << bd) - 1
    return [rng.integers(0, hi + 1, (h, w)) for _ in range(3)]


MATRICES = ([(2, mc) for mc in (0, 1, 2, 4, 5, 6, 7, 8, 9)]
            + [(cp, 12) for cp in (1, 3, 4, 5, 7, 9, 10, 11, 22)])


@pytest.mark.parametrize("alpha", (False, True), ids=("rgb", "rgba"))
@pytest.mark.parametrize("bd", (8, 10))
@pytest.mark.parametrize("cp,mc", MATRICES)
def test_conversion_equals_pillow(cp, mc, bd, alpha):
    planes = _yuv_probe(bd, seed=mc * 31 + cp)
    a = (np.arange(128 * 128).reshape(128, 128) * 7) % (1 << bd) \
        if alpha else None
    data = _stream(planes, bd=bd, cicp=(cp, 2, mc), alpha=a)
    got = decode_avif_to_rgb8(data)
    np.testing.assert_array_equal(got, ref_rgb8(data))


def test_conversion_full_8bit_grid_equals_pillow():
    """Every (Y, V) pair and a spread of U for matrix 2 at 8 bits."""
    y, v = np.mgrid[0:256, 0:256]
    data = _stream([y, (y * 7 + v * 3) % 256, v], bd=8)
    np.testing.assert_array_equal(decode_avif_to_rgb8(data), ref_rgb8(data))


@pytest.mark.parametrize("mc", (3, 10, 11, 13, 14))
def test_refused_matrices_raise_in_both(mc):
    data = _stream(_yuv_probe(8, 16, 16), cicp=(2, 2, mc))
    with pytest.raises(ValueError, match=f"matrix coefficients {mc}"):
        decode_avif_to_rgb8(data)
    with pytest.raises(Exception):
        ref_rgb8(data)


@pytest.mark.parametrize("case", ("10bit_mc2", "10bit_mc6", "10bit_mc1",
                                  "8bit", "alpha_10bit", "icc"))
def test_load_avif_equals_reference(case, tmp_path):
    bd = 8 if case == "8bit" else 10
    mc = {"10bit_mc6": 6, "10bit_mc1": 1}.get(case, 2)
    alpha = (np.arange(96 * 80).reshape(80, 96) % (1 << bd)
             if case == "alpha_10bit" else None)
    icc = b"\x00\x00\x02\x0cICC-test-profile" * 5 if case == "icc" else None
    data = _stream(_yuv_probe(bd, 80, 96, seed=3), q=60, bd=bd,
                   cicp=(2, 2, mc), alpha=alpha, icc=icc)
    path = tmp_path / "in.avif"
    path.write_bytes(data)
    got, ref = load_avif(str(path)), ref_load_avif(str(path))
    assert (got.hbd, got.channels, got.data.dtype) == (ref.hbd, ref.channels,
                                                        ref.data.dtype)
    assert got.hbd == (case in ("10bit_mc2", "10bit_mc6", "icc"))
    np.testing.assert_array_equal(got.data, ref.data)
    assert got.icc == ref.icc == icc


# ---------------------------------------------------------------------------
# container and headers
# ---------------------------------------------------------------------------


def _box(typ, payload):
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ, version, flags, payload):
    return _box(typ, bytes([version]) + flags.to_bytes(3, "big") + payload)


def _rewrap(item, idat=False, iloc_version=1, infe_version=3,
            large_mdat=False, mdat_first=False, extra_prop=None,
            item_type=b"av01", moov=False, method=None):
    """A single-item AVIF holding ``item`` (an AV1 payload) in other
    container forms than the port's muxer writes."""
    wide = iloc_version == 2  # 32-bit item ids everywhere
    ids = 4 if wide else 2
    item_id = 70000 if wide else 7
    infe_ids = 4 if infe_version == 3 else 2
    enc = (lambda v: v.to_bytes(ids, "big"))
    ftyp = _box(b"ftyp", b"avif" + b"\0\0\0\0" + b"mif1avifmiaf")
    hdlr = _full(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13)
    pitm = _full(b"pitm", 0 if ids == 2 else 1, 0, enc(item_id))
    infe = _full(b"infe", infe_version, 0,
                 item_id.to_bytes(infe_ids, "big") + b"\0\0" + item_type
                 + b"Color\0")
    iinf = _full(b"iinf", 0 if ids == 2 else 1, 0,
                 (1).to_bytes(2 if ids == 2 else 4, "big") + infe)
    w, h = item["w"], item["h"]
    props = [_full(b"ispe", 0, 0, struct.pack(">II", w, h)),
             _box(b"av1C", item["av1c"]),
             _box(b"colr", b"nclx" + struct.pack(">HHHB", 2, 2, 2, 0x80))]
    if extra_prop is not None:
        props.append(extra_prop)
    ipco = _box(b"ipco", b"".join(props))
    assoc = [1, 2 | 0x80, 3] + ([4 | 0x80] if extra_prop else [])
    ipma = _full(b"ipma", 0 if ids == 2 else 1, 0,
                 struct.pack(">I", 1) + enc(item_id) + bytes([len(assoc)])
                 + bytes(assoc))
    iprp = _box(b"iprp", ipco + ipma)
    data = item["payload"]
    cut = len(data) // 3

    def iloc(base):
        # two extents; offsets relative to base (file or idat)
        body = bytes([0x44, 0x40])
        body += (1).to_bytes(2 if iloc_version < 2 else 4, "big")
        body += (item_id.to_bytes(2 if iloc_version < 2 else 4, "big"))
        if iloc_version:
            body += struct.pack(">H", (1 if idat else 0) if method is None
                                else method)
        body += struct.pack(">H", 0)  # data_reference_index
        body += struct.pack(">I", base)  # base_offset (4 bytes)
        body += struct.pack(">H", 2)
        body += struct.pack(">II", 0, cut) + struct.pack(">II", cut,
                                                         len(data) - cut)
        return _full(b"iloc", iloc_version, 0, body)

    def build(base):
        children = hdlr + pitm + iloc(base) + iinf + iprp
        if idat:
            children += _box(b"idat", data)
        return _full(b"meta", 0, 0, children)

    def mdat_box(payload):
        if large_mdat:
            return struct.pack(">I", 1) + b"mdat" + struct.pack(
                ">Q", 16 + len(payload)) + payload
        return _box(b"mdat", payload)

    tail = _box(b"moov", b"") if moov else b""
    if idat:
        return ftyp + build(0) + tail
    hdr = 16 if large_mdat else 8
    if mdat_first:
        return ftyp + mdat_box(data) + build(len(ftyp) + hdr) + tail
    meta = build(0)
    return ftyp + build(len(ftyp) + len(meta) + hdr) + mdat_box(data) + tail


@pytest.fixture(scope="module")
def item():
    data = (FIXTURES / "tool_tiles4.avif").read_bytes()
    box = A.read_container(data)
    return {"payload": box.color.payload, "av1c": box.color.av1c,
            "w": box.color.width, "h": box.color.height, "file": data}


@pytest.mark.parametrize("form", (
    dict(), dict(iloc_version=0, infe_version=2), dict(iloc_version=2),
    dict(idat=True), dict(large_mdat=True), dict(mdat_first=True),
    dict(extra_prop=_box(b"pasp", struct.pack(">II", 1, 1)))),
    ids=("iloc1", "iloc0_infe2", "iloc2", "idat", "mdat64", "mdat_first",
         "pasp"))
def test_container_forms_decode_like_the_original(item, form):
    data = _rewrap(item, **form)
    want = A.decode_avif(item["file"])[1].planes
    got = A.decode_avif(data)[1].planes
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(decode_avif_to_rgb8(data), ref_rgb8(data))


# properties the reader refused before it learned them: their files now
# decode to the original's pixels as coded, as the reference's do (an
# empty ``moov`` too: libavif 1.3 reads an ``avif`` file's primary item)
READ_NOW = ("rotation (irot)", "mirroring (imir)", "clean aperture (clap)",
            "image sequences")
# a ``grid`` item whose data is an AV1 payload, not a grid descriptor:
# broken, in the reference too
BROKEN_NOW = {"grid": "grid version"}


@pytest.mark.parametrize("what,kw", (
    ("grid", dict(item_type=b"grid")),
    ("rotation (irot)", dict(extra_prop=_box(b"irot", b"\x01"))),
    ("mirroring (imir)", dict(extra_prop=_box(b"imir", b"\x00"))),
    ("clean aperture (clap)", dict(clap=True)),
    ("image sequences", dict(moov=True)),
    ("essential property 'zzzz'", dict(extra_prop=_box(b"zzzz", b""))),
    ("'iovl'", dict(item_type=b"iovl")),
    ("iloc construction method 2", dict(method=2)),
), ids=("grid", "irot", "imir", "clap", "moov", "essential", "iovl",
        "iloc_method2"))
def test_container_refusals_name_the_feature(item, what, kw):
    if kw.pop("clap", False):  # the whole frame, centred
        kw["extra_prop"] = _box(b"clap", struct.pack(
            ">8I", item["w"], 1, item["h"], 1, 0, 1, 0, 1))
    data = _rewrap(item, **kw)
    if what in READ_NOW:
        want = A.decode_avif(item["file"])[1].planes
        for a, b in zip(A.decode_avif(data)[1].planes, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(decode_avif_to_rgb8(data),
                                      ref_rgb8(data))
        return
    if what in BROKEN_NOW:
        with pytest.raises(OSError, match=BROKEN_NOW[what]):
            A.decode_avif(data)
        with pytest.raises(Exception):
            ref_rgb8(data)
        return
    with pytest.raises(ValueError, match=re.escape(what)):
        A.decode_avif(data)


def _two_items(color, alpha, refs):
    """An AVIF with a colour item (id 1) and an alpha item (id 2), the
    given ``iref`` boxes and iloc version 0."""
    ftyp = _box(b"ftyp", b"avif" + b"\0\0\0\0" + b"mif1avifmiaf")
    hdlr = _full(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13)
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", 1))
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", 2) + b"".join(
        _full(b"infe", 2, 0, struct.pack(">HH", i, 0) + b"av01\0")
        for i in (1, 2)))
    iref = _full(b"iref", 0, 0, b"".join(
        _box(t, struct.pack(">HHH", a, 1, b)) for t, a, b in refs))
    urn = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"
    props = [_full(b"ispe", 0, 0, struct.pack(">II", color.width,
                                               color.height)),
             _box(b"av1C", color.av1c), _box(b"av1C", alpha.av1c),
             _full(b"auxC", 0, 0, urn)]
    ipma = _full(b"ipma", 0, 0, struct.pack(">I", 2)
                 + struct.pack(">HB", 1, 2) + bytes([1, 2 | 0x80])
                 + struct.pack(">HB", 2, 3) + bytes([1, 3 | 0x80, 4]))
    iprp = _box(b"iprp", _box(b"ipco", b"".join(props)) + ipma)

    def meta(off):
        body = struct.pack(">BBH", 0x44, 0, 2)
        pos = off
        for i, it in ((1, color), (2, alpha)):
            body += struct.pack(">HHHII", i, 0, 1, pos, len(it.payload))
            pos += len(it.payload)
        return _full(b"meta", 0, 0, hdlr + pitm + _full(b"iloc", 0, 0, body)
                     + iinf + iref + iprp)

    start = len(ftyp) + len(meta(0)) + 8
    return ftyp + meta(start) + _box(b"mdat", color.payload + alpha.payload)


def test_premultiplied_alpha_is_refused():
    """Refused until the reader learned ``prem``: the same items with a
    ``prem`` reference now decode, un-premultiplied as Pillow's are."""
    box = A.read_container((FIXTURES / "tool_alpha_q50.avif").read_bytes())
    plain = _two_items(box.color, box.alpha, [(b"auxl", 2, 1)])
    _, _, alpha = A.decode_avif(plain)
    assert alpha is not None
    prem = _two_items(box.color, box.alpha,
                      [(b"auxl", 2, 1), (b"prem", 1, 2)])
    assert A.read_container(prem).premultiplied
    assert not np.array_equal(decode_avif_to_rgb8(prem),
                              decode_avif_to_rgb8(plain))
    np.testing.assert_array_equal(decode_avif_to_rgb8(prem), ref_rgb8(prem))


def test_full_form_headers_decode_to_dav1d():
    """The full-form sequence header (operating points, screen-content
    and integer-mv choices) and the full frame header of a shown key
    frame."""
    for bd, q in ((8, 60), (10, 0), (10, 90)):
        data = _stream(_yuv_probe(bd, 72, 88, seed=bd + q), q=q, bd=bd,
                       full=True)
        theirs, _, _ = decode_to_yuv(data)
        ours = A.decode_avif(data)[1].planes
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def _refusal_streams():
    planes = _yuv_probe(8, 64, 64, seed=1)
    payloads, _, _ = encode_frame_planes([p.astype(np.int32) for p in planes],
                                         60, bitdepth=8)
    seq = SequenceConfig(width=64, height=64)
    fr = FrameConfig(width=64, height=64, base_q_idx=60)
    good_frame = assemble_av1_stream(seq, fr, payloads)[
        len(write_sequence_header(seq)):]

    def frame(bits):
        w = _write_bits(bits + [0] * 64)
        return obu(OBU_FRAME, w.data())

    # reduced header of a 64x64 frame: disable_cdf_update, screen tools,
    # render_and_frame_size_different, uniform tile spacing, base_q_idx,
    # three delta-q flags, then using_qmatrix, segmentation, delta_q
    pre = [0, 0, 0, 1] + [0, 0, 1, 1, 1, 1, 0, 0] + [0, 0, 0]
    w = write_frame_header_bits(fr)
    w.f(1, 1)  # apply_grain
    # film_grain_params of a 4:4:4 frame, all zero: grain_seed, no
    # scaling points (y, cb, cr), lag 0, shifts, no overlap or clipping
    for n in (16, 4, 1, 4, 4, 2, 2, 2, 2, 1, 1):
        w.f(0, n)
    w.byte_align()
    grain = obu(OBU_FRAME, w.data() + payloads[0])
    full = _seq_header(seq, full=True)
    return {
        "12-bit": _seq_header(seq, profile=2, twelve=True) + good_frame,
        "superres": _seq_header(seq, superres=True) + frame([0, 0, 1]),
        # screen tools, force_integer_mv, allow_intrabc, then as pre: the
        # header reads no loop filter, CDEF or restoration fields
        "intrabc": _seq_header(seq) + frame([0, 1, 1, 0, 1] + pre[3:]),
        "quantizer matrices": _seq_header(seq) + frame(pre + [1]),
        # segmentation_enabled, then no feature in any segment
        "segmentation": _seq_header(seq) + frame(pre + [0, 1] + [0] * 64),
        "delta q": _seq_header(seq) + frame(pre + [0, 0, 1]),
        # loop filter levels 0 0, sharpness, no deltas, damping, cdef_bits 1
        "cdef_bits > 0": _seq_header(SequenceConfig(64, 64, enable_cdef=True))
        + frame(pre + [0, 0, 0] + [0] * 12 + [0, 0, 0, 0] + [0, 0, 0, 1]),
        "film grain": _seq_header(seq, film_grain=True) + grain,
        "more than one frame": _seq_header(seq) + good_frame + good_frame,
        "non-uniform tile spacing": _seq_header(seq) + frame([0, 0, 0, 0]),
        # delta_q_present, delta_q_res, delta_lf_present, delta_lf_res,
        # delta_lf_multi
        "delta_lf_multi": _seq_header(seq) + frame(
            pre + [0, 0, 1, 0, 0, 1, 0, 0, 1]),
        "not a key frame": full + frame([0, 0, 1, 1]),
        "show_existing_frame": full + frame([1]),
    }


# tools the decoder refused before it learned them: their streams now
# parse, with the header fields the tool sets
LEARNED = {
    "cdef_bits > 0": lambda av1: (av1.frame.cdef_bits,
                                  len(av1.frame.cdef_strengths)) == (1, 2),
    "12-bit": lambda av1: av1.seq.bit_depth == 12,
    "quantizer matrices": lambda av1: av1.frame.qm == (0, 0, 0),
    "delta q": lambda av1: (av1.frame.delta_q_res,
                            av1.frame.delta_lf_res) == (0, -1),
    # delta_q_res 0, delta_lf_res 0, delta_lf_multi 1
    "delta_lf_multi": lambda av1: (av1.frame.delta_q_res,
                                   av1.frame.delta_lf_res,
                                   av1.frame.delta_lf_multi) == (0, 0, True),
    "film grain": lambda av1: av1.frame.grain is not None,
    # two shown key frames and no spatial layers: dav1d, as libavif
    # drives it, shows the first, which is all the reader decodes
    "more than one frame": lambda av1: (len(av1.frames), av1.frame.show_frame,
                                        av1.frames[0] is av1) == (1, True,
                                                                  True),
    "segmentation": lambda av1: (av1.frame.segmentation == [[None] * 8] * 8
                                 and av1.frame.seg_last_active == 0),
    "intrabc": lambda av1: (av1.frame.allow_intrabc, av1.frame.base_q,
                            av1.frame.lf_levels, av1.frame.cdef_bits,
                            av1.frame.lr_types, av1.frame.tx_mode) == (
        True, 60, (0, 0, 0, 0), 0, (0, 0, 0), 1),
    # use_superres, coded_denom 0: SuperresDenom 9, the 64-wide frame
    # coded (64 * 8 + 4) // 9 = 57 wide; its one tile is read non-uniform
    "superres": lambda av1: (av1.frame.superres_denom, av1.frame.coded_width,
                             av1.frame.width, av1.frame.mi_cols,
                             av1.frame.tile_col_starts) == (
        9, 57, 64, 16, [0, 16]),
    # uniform_tile_spacing_flag 0: one superblock column and row, each
    # width_in_sbs_minus_1 an ns(1) of no bits
    "non-uniform tile spacing": lambda av1: (
        av1.frame.tile_col_starts, av1.frame.tile_row_starts,
        av1.frame.tile_cols_log2, av1.frame.tile_rows_log2,
        av1.frame.superres_denom) == ([0, 16], [0, 16], 0, 0, 8),
}


# forms the reader once refused by name that it now reads, whose streams
# here are broken: a first frame that is an inter frame names empty
# slots, and a show_existing_frame shows one (dav1d refuses both,
# tests/test_torch_avif_frametypes.py holds it to them)
BROKEN = {"not a key frame": "an inter frame names an empty reference slot",
          "show_existing_frame": "show_existing_frame of an empty slot"}


@pytest.mark.parametrize("tool", sorted(_refusal_streams()))
def test_av1_refusals_name_the_tool(tool):
    if tool in LEARNED:
        assert LEARNED[tool](A.parse_av1(_refusal_streams()[tool]))
        return
    if tool in BROKEN:
        with pytest.raises(OSError, match=re.escape(BROKEN[tool])):
            A.decode_av1(_refusal_streams()[tool])
        return
    with pytest.raises(ValueError, match=re.escape(tool)):
        A.decode_av1(_refusal_streams()[tool])


def _broken_files():
    data = (FIXTURES / "tool_palette_text.avif").read_bytes()
    big = bytearray(data)
    big[0:4] = struct.pack(">I", len(data) + 50)  # ftyp past the end
    bad_av1c = bytearray(data)
    i = bad_av1c.index(b"av1C")
    bad_av1c[i + 4] = 0x42  # marker and version
    no_pitm = bytearray(data)
    i = no_pitm.index(b"pitm")
    no_pitm[i:i + 4] = b"free"
    obu_size = bytearray(data)
    mdat = obu_size.index(b"mdat") + 4
    obu_size[mdat + 1] = 0xFF  # the sequence header OBU claims 127+ bytes
    return {"garbage": b"not an AVIF file at all" * 4,
            "ftyp_only": data[:28], "cut_10": data[:10],
            "cut_in_meta": data[:200], "cut_half": data[: len(data) // 2],
            "cut_last_byte": data[:-1], "box_past_end": bytes(big),
            "bad_av1c": bytes(bad_av1c), "no_pitm": bytes(no_pitm),
            "obu_size_past_end": bytes(obu_size)}


@pytest.mark.parametrize("case", sorted(_broken_files()))
def test_broken_files_raise_oserror(case, tmp_path):
    path = tmp_path / "in.avif"
    path.write_bytes(_broken_files()[case])
    with pytest.raises(OSError):
        load_avif(str(path))
    with pytest.raises(Exception):
        ref_load_avif(str(path))


# ---------------------------------------------------------------------------
# the CLI on AVIF input
# ---------------------------------------------------------------------------


def _write_pam(path, arr):
    h, w, ch = arr.shape
    tt = {3: "RGB", 4: "RGB_ALPHA"}[ch]
    path.write_bytes(f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {ch}\nMAXVAL 255\n"
                     f"TUPLTYPE {tt}\nENDHDR\n".encode() + arr.tobytes())


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


@pytest.mark.parametrize("name,args", (("tool_sb64.avif", ["-t", "80"]),
                                       ("tool_alpha_q50.avif", ["-q", "60"])),
                         ids=("hbd_t80", "alpha_q60"))
def test_cli_on_avif_matches_reference_and_pam(tmp_path, capsys, name, args):
    src = FIXTURES / name
    ref, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found == ref_found
    assert got == ref
    img = load_avif(str(src))
    if not img.hbd:
        pam = tmp_path / "in.pam"
        _write_pam(pam, img.data)
        via_pam, pam_found = _run(port_cli, args, pam, tmp_path / "pam.avif",
                                  capsys)
        assert (got, found) == (via_pam, pam_found)


# every CICP the CLI tests of this file and the fixtures write: the port's
# bytes equal the reference CLI's for each; 1/13/0 alone differs (below)
CLI_CICPS = sorted({(2, 2, 2), (1, 13, 1), (1, 13, 6), (2, 2, 0)}
                   | {(cp, 2, mc) for cp, mc in MATRICES if mc != 0})


def _cicp_args(cicp):
    return ["--color-primaries", str(cicp[0]), "--transfer-characteristics",
            str(cicp[1]), "--matrix-coefficients", str(cicp[2])]


@pytest.mark.parametrize("cicp", CLI_CICPS, ids=lambda c: "%d_%d_%d" % c)
def test_cli_bytes_equal_reference_for_each_cicp(cicp, tmp_path):
    from chip_smoke import write_pam

    rng = np.random.default_rng(sum(cicp))
    src = tmp_path / "in.pam"
    write_pam(src, rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    out = []
    for cli in (ref_cli, port_cli):
        dst = tmp_path / f"{cli.__name__}.avif"
        assert cli.run(["-q", "60", *_cicp_args(cicp), str(src),
                        str(dst)]) == 0
        out.append(dst.read_bytes())
    assert out[0] == out[1]


def test_cicp_1_13_0_decodes_to_recon(tmp_path):
    """BT.709 primaries, sRGB transfer and the identity matrix: the
    sequence header carries no color_range bit (spec color_config), so
    dav1d and the port's reader decode the stream, both to the recon's
    Y'UV. (The reference writes the bit, and no decoder reads its
    stream.)"""
    from chip_smoke import _recon_planes
    from oavif_tpu_torch.av1.encode import encode_avif_with_recon
    from oavif_tpu_torch.backend import EncCtx
    from oavif_tpu_torch.io.image import Image
    from oavif_tpu_torch.options import EncOptions

    rgb = np.random.default_rng(7).integers(0, 256, (72, 88, 3),
                                            dtype=np.uint8)
    ctx = EncCtx(o=EncOptions(color_primaries=1, transfer_characteristics=13,
                              matrix_coefficients=0),
                 src=Image(width=88, height=72, channels=3, hbd=False,
                           data=rgb), rgb=rgb, w=88, h=72)
    ctx.q = 60
    seen, restore = _recon_planes()
    try:
        data, _ = encode_avif_with_recon(ctx)
    finally:
        restore()
    recon = seen[data]
    theirs, _, _ = decode_to_yuv(data)
    _, img, _ = A.decode_avif(data)
    assert img.cicp == (1, 13, 0) and img.full_range
    for ours, dav1d, want in zip(img.planes, theirs, recon):
        np.testing.assert_array_equal(dav1d, want)
        np.testing.assert_array_equal(ours, want)
