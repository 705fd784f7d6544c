"""The port's AV1 decoder on segmentation (spec 5.9.14, 5.11.9), on the
CPU and with no tolerance:

- the segmentation fixtures of ``tests/torch_fixtures/avif_container``
  (``make_avif_container.py``): the key frames libaom codes with
  segmentation under ``aq-mode=1`` in Pillow's sequences (qualities 30, 60
  and 90, 4:2:0 and 4:4:4, 256x256 and 512x512, with ``deltaq-mode=1``,
  and a segmented key frame muxed beside an alpha item) and in libavif
  0.11.1's 10- and 12-bit sequences: each decodes to dav1d's Y'UV and
  equals the reference live and its manifest;
- streams written here bit by bit, for what libaom never writes into a
  key frame: a skipped block, which takes the predicted segment id
  (``seg_pred_skip``), against dav1d; and the segmentation features
  other than ALT_Q, which the decoder refuses by name;
- each segmentation counter in ``tools`` occurs in some file.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from oavif_tpu_torch.av1.consts import coeff_q_ctx  # noqa: E402
from oavif_tpu_torch.av1.entropy.rangecoder import (RangeEncoder,  # noqa: E402
                                                    update_cdf)
from oavif_tpu_torch.av1.frame import CdfBank, _adaptive  # noqa: E402
from oavif_tpu_torch.av1.mux import mux_avif  # noqa: E402
from oavif_tpu_torch.av1.obu import BitWriter, obu  # noqa: E402
from oavif_tpu_torch.io import avif as A  # noqa: E402
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from test_torch_avif_container import FIXTURES, MANIFEST  # noqa: E402
from test_torch_avif_container import check_fixture  # noqa: E402

SEGMENTED = sorted(n for n in MANIFEST if n.startswith("seg"))
COUNTERS = ("segmentation", "seg_alt_q", "seg_preskip", "seg_pred_skip")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("name", SEGMENTED)
def test_fixture_decodes_to_its_manifest(name):
    check_fixture(FIXTURES, name, MANIFEST[name])


def test_fixtures_cover_the_writers_settings():
    """Every file codes segment ids with ALT_Q segments; the files span
    the qualities, subsamplings, sizes, depths and options promised."""
    e = {n: MANIFEST[n] for n in SEGMENTED}
    assert all(x["tools"]["segmentation"] > 0 for x in e.values())
    av1 = {n: A.parse_av1(A.read_container(
        (FIXTURES / n).read_bytes()).color.payload).frame for n in e}
    assert all(f.segmentation is not None and not f.seg_preskip
               and any(s[0] is not None for s in f.segmentation)
               for f in av1.values())
    pillow = [x["written"] for x in e.values()
              if x["written"]["writer"].startswith("Pillow")]
    assert {w["quality"] for w in pillow} >= {30, 60, 90}
    assert {w.get("subsampling", "4:2:0") for w in pillow} == {"4:2:0",
                                                               "4:4:4"}
    assert {tuple(w["size"]) for w in pillow} >= {(256, 256), (512, 512)}
    assert any(x["alpha"] for x in e.values())
    assert any(w.get("deltaq-mode") == "1" for w in pillow)
    assert {x["depth"] for x in e.values()} == {8, 10, 12}


@pytest.mark.parametrize("counter", COUNTERS)
def test_each_segmentation_counter_occurs(counter):
    """``segmentation`` and ``seg_alt_q`` in the fixtures; a skipped
    block's predicted id only in the stream written here (libaom codes no
    skipped block in a key frame); ``seg_preskip`` in no stream, since
    SegIdPreSkip needs a feature the decoder refuses (REF_FRAME, SKIP or
    GLOBALMV) and it stays 0 everywhere."""
    total = sum(e["tools"][counter] for e in MANIFEST.values()
                if "tools" in e)
    written = A.decode_av1(_stream([(0, 1, 0), (1, None, 1),
                                    (0, 0, 2)])).tools[counter]
    if counter == "seg_preskip":
        assert total == written == 0
    elif counter == "seg_pred_skip":
        assert (total, written) == (0, 1)
    else:
        assert total > 0 and written > 0


# ---------------------------------------------------------------------------
# streams written bit by bit: a monochrome frame of 64x64 blocks in a row
# ---------------------------------------------------------------------------


def _neg_deinterleave(diff: int, ref: int, mx: int) -> int:
    if not ref:
        return diff
    if ref >= mx - 1:
        return mx - diff - 1
    if 2 * ref < mx:
        if diff <= 2 * ref:
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
    return mx - (diff + 1)


def _stream(blocks, alt_q=(0, -40, 30), base_q=100, features=None) -> bytes:
    """A reduced-header AV1 key frame, 8-bit monochrome, 64 pixels high
    and one 64x64 block (PARTITION_NONE) per entry of ``blocks``: (skip,
    segment_id or None where skipped, luma mode), DC, V or H. Segment i
    has ALT_Q ``alt_q[i]`` (LastActiveSegId is the last); ``features``
    replaces the feature table (8 lists of 8 values or None). No
    coefficient is coded: an unskipped block reads all_zero."""
    n = len(blocks)
    seq = BitWriter()
    for v, bits in ((0, 3), (1, 1), (1, 1), (0, 5), (15, 4), (15, 4),
                    (64 * n - 1, 16), (63, 16), (0, 3), (0, 3), (0, 1),
                    (1, 1), (0, 1), (1, 1), (0, 1)):
        # profile 0, still, reduced, level 0, 16-bit sizes, no 128 SB,
        # filter intra or edge filter, no superres, CDEF or restoration,
        # 8-bit, monochrome, no colour description, full range, no grain
        seq.f(v, bits)
    seq.trailing_bits()
    if features is None:
        features = [[alt_q[i] if i < len(alt_q) else None] + [None] * 7
                    for i in range(8)]
    fh = BitWriter()
    # disable_cdf_update, screen tools, render_size, uniform tiles (and one
    # increment bit where the row has two SBs or more), base_q_idx, no
    # DeltaQYDc, no qmatrix, segmentation on
    for v, bits in ((0, 1), (0, 1), (0, 1), (1, 1)):
        fh.f(v, bits)
    if n > 1:
        fh.f(0, 1)
    fh.f(base_q, 8)
    fh.f(0, 1)
    fh.f(0, 1)
    fh.f(1, 1)
    for row in features:
        for j, v in enumerate(row):
            fh.f(v is not None, 1)
            if v is not None:
                nb = A._SEG_BITS[j]
                if A._SEG_SIGNED[j]:
                    fh.f(v & ((1 << (nb + 1)) - 1), nb + 1)
                else:
                    fh.f(v, nb)
    # no delta q; unless every segment is lossless (CodedLossless), loop
    # filter levels 0 0, sharpness 0, no deltas and no tx_mode_select
    # (TX_MODE_LARGEST); no reduced tx set
    fh.f(0, 1)
    if not all(base_q + (row[0] or 0) <= 0 for row in features):
        for v, bits in ((0, 6), (0, 6), (0, 3), (0, 1), (0, 1)):
            fh.f(v, bits)
    fh.f(0, 1)
    fh.byte_align()
    last = max([i for i, row in enumerate(features)
                if any(v is not None for v in row)] or [0])
    bank = CdfBank(coeff_q_ctx(base_q))
    seg_cdf = _adaptive(A._tool_tables()["segment_id"])
    enc = RangeEncoder()

    def put(cdf, s, nsym):
        enc.encode_symbol(s, cdf, nsym)
        update_cdf(cdf, s, nsym)

    left_seg, left_mode, left_skip = -1, 0, 0
    ctx_of = (0, 1, 2)  # INTRA_MODE_CONTEXT of DC, V and H
    for skip, seg, mode in blocks:
        put(bank.partition[64][0], 0, 10)  # PARTITION_NONE, context 0
        put(bank.skip[left_skip], skip, 2)
        if not skip:
            pred = max(left_seg, 0)
            coded = next(v for v in range(8)
                         if _neg_deinterleave(v, pred, last + 1) == seg)
            put(seg_cdf[0], coded, 8)  # no above row: context 0
        else:
            seg = max(left_seg, 0)
        put(bank.kf_y[0][ctx_of[left_mode]], mode, 13)
        if mode:  # V_PRED, H_PRED: angle delta 0
            put(bank.angle_delta[mode - 1], 3, 7)
        if not skip:
            put(bank.txb_skip[4][0], 1, 2)  # TX_64X64, all zero
        left_seg, left_mode, left_skip = seg, mode, skip
    tile = enc.done()
    return obu(1, seq.data()) + obu(6, fh.data() + tile)


@pytest.mark.parametrize("blocks", [
    [(0, 1, 0), (1, None, 1), (0, 0, 2)],
    [(1, None, 0), (0, 2, 1), (1, None, 2), (1, None, 0)],
    [(0, 2, 0), (0, 1, 2), (0, 2, 1)],
], ids=["pred_from_left", "skip_first", "coded_each"])
def test_written_stream_equals_dav1d(blocks):
    """Segment ids coded against the left block's, and skipped blocks
    that take it, decode as dav1d decodes them (through the system
    libavif); the ids land where the stream puts them."""
    av1 = _stream(blocks)
    n = len(blocks)
    img = A.decode_av1(av1)
    data = mux_avif(av1, 64 * n, 64, seq_profile=0, monochrome=True)
    planes, depth, _ = decode_to_yuv(data)
    np.testing.assert_array_equal(img.planes[0], planes[0])
    skips = sum(s for s, _, _ in blocks)
    assert (img.tools["segmentation"], img.tools["seg_pred_skip"],
            img.tools["seg_preskip"]) == (n - skips, skips, 0)
    moved = sum(1 for i, (s, seg, _) in enumerate(blocks)
                if _ids(blocks)[i] in (1, 2))
    assert img.tools["seg_alt_q"] == moved
    fh = A.parse_av1(av1).frame
    assert fh.seg_last_active == 2 and not fh.seg_preskip
    assert fh.segmentation[1][0] == -40 and fh.segmentation[2][0] == 30


def _ids(blocks):
    out, left = [], -1
    for skip, seg, _ in blocks:
        left = max(left, 0) if skip else seg
        out.append(left)
    return out


def test_lossless_segment_array():
    """LosslessArray and CodedLossless over the segments: a segment whose
    ALT_Q takes base_q_idx to 0 is lossless, the frame is not until every
    segment is."""
    fh = A.parse_av1(_stream([(0, 1, 0)], alt_q=(0, -100), base_q=100)).frame
    assert fh.seg_lossless == (False, True) + (False,) * 6
    assert not fh.lossless
    fh = A.parse_av1(_stream([(1, None, 0)], alt_q=(-100,) * 8,
                             base_q=100)).frame
    assert all(fh.seg_lossless) and fh.lossless


@pytest.mark.parametrize("feature", [1, 2, 3, 4, 5, 6, 7])
def test_other_segmentation_features_are_refused(feature):
    """ALT_LF (four of them), REF_FRAME, SKIP and GLOBALMV: no writer here
    sets them, and the refusal names the feature."""
    feats = [[None] * 8 for _ in range(8)]
    feats[3][feature] = 1 if A._SEG_BITS[feature] else 0
    with pytest.raises(A.UnsupportedAvif, match=A._SEG_NAMES[feature]):
        A.parse_av1(_stream([(0, 1, 0)], features=feats))
