"""The port's AV1 decoder on segmentation (spec 5.9.14, 5.11.9), on the
CPU and with no tolerance:

- the segmentation fixtures of ``tests/torch_fixtures/avif_container``
  (``make_avif_container.py``): the key frames libaom codes with
  segmentation under ``aq-mode=1`` in Pillow's sequences (qualities 30, 60
  and 90, 4:2:0 and 4:4:4, 256x256 and 512x512, with ``deltaq-mode=1``,
  and a segmented key frame muxed beside an alpha item) and in libavif
  0.11.1's 10- and 12-bit sequences: each decodes to dav1d's Y'UV and
  equals the reference live and its manifest;
- streams written symbol by symbol (``keyframe_writer.py`` of
  ``tests/torch_fixtures/avif_lf_seg``), for what libaom never writes into
  a key frame: a skipped block, which takes the predicted segment id
  (``seg_pred_skip``), against dav1d; and the segmentation features
  other than ALT_Q, each in a stream of its own that equals dav1d and the
  reference (``test_torch_avif_lf_seg.py`` holds the rest of them);
- each segmentation counter in ``tools`` occurs in some file.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
LF_SEG = ROOT / "tests" / "torch_fixtures" / "avif_lf_seg"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(LF_SEG))

from keyframe_writer import (SEG_NAMES, Block, Frame,  # noqa: E402
                             avif_still, frame_obus)
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
    skipped block in a key frame); ``seg_preskip`` in none of these, since
    libaom never sets REF_FRAME, SKIP or GLOBALMV, which SegIdPreSkip
    needs (``tests/torch_fixtures/avif_lf_seg`` has it)."""
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
# streams written symbol by symbol: a monochrome frame of 64x64 blocks in a
# row, no coefficient coded
# ---------------------------------------------------------------------------


def _frame(blocks, alt_q=(0, -40, 30), base_q=100, features=None) -> Frame:
    """A monochrome frame 64 pixels high and one 64x64 block per entry of
    ``blocks``: (skip, segment_id or None where skipped, luma mode), DC,
    V or H. Segment i has ALT_Q ``alt_q[i]`` (LastActiveSegId is the
    last); ``features`` replaces the feature table (8 lists of 8 values
    or None). Loop filter levels 0; an unskipped block reads all_zero."""
    if features is None:
        features = [[alt_q[i] if i < len(alt_q) else None] + [None] * 7
                    for i in range(8)]
    return Frame(64 * len(blocks), 64, mono=True, base_q=base_q,
                 features=features,
                 blocks=[[Block(skip=skip, seg=seg or 0, mode=mode)
                          for skip, seg, mode in blocks]])


def _stream(blocks, **kw) -> bytes:
    return frame_obus(_frame(blocks, **kw))


@pytest.mark.parametrize("blocks", [
    [(0, 1, 0), (1, None, 1), (0, 0, 2)],
    [(1, None, 0), (0, 2, 1), (1, None, 2), (1, None, 0)],
    [(0, 2, 0), (0, 1, 2), (0, 2, 1)],
], ids=["pred_from_left", "skip_first", "coded_each"])
def test_written_stream_equals_dav1d(blocks):
    """Segment ids coded against the left block's, and skipped blocks
    that take it, decode as dav1d decodes them (through the system
    libavif); the ids land where the stream puts them."""
    fr = _frame(blocks)
    av1 = frame_obus(fr)
    n = len(blocks)
    img = A.decode_av1(av1)
    planes, depth, _ = decode_to_yuv(avif_still(av1, fr))
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


LF_SEG_MANIFEST = json.loads((LF_SEG / "manifest.json").read_text())
ALONE = {1: "alt_lf_y_v_420.avif", 2: "alt_lf_y_h_444_10b.avif",
         3: "alt_lf_u_420_sb128.avif", 4: "alt_lf_v_444.avif",
         5: "ref_frame_mono.avif", 6: "skip_444.avif",
         7: "globalmv_420_10b.avif"}


@pytest.mark.parametrize("feature", [1, 2, 3, 4, 5, 6, 7])
def test_other_segmentation_features_are_refused(feature):
    """ALT_LF (four of them), REF_FRAME, SKIP and GLOBALMV, which the
    decoder refused by name until it learned them: each feature's written
    stream (``tests/torch_fixtures/avif_lf_seg``) now decodes to dav1d's
    Y'UV and the reference's pixels, and its header holds the feature."""
    name = ALONE[feature]
    fh = A.parse_av1(A.read_container(
        (LF_SEG / name).read_bytes()).color.payload).frame
    assert any(seg[feature] is not None for seg in fh.segmentation), \
        SEG_NAMES[feature]
    assert fh.seg_preskip == (feature >= 5)
    check_fixture(LF_SEG, name, LF_SEG_MANIFEST[name])
