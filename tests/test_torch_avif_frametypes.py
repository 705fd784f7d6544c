"""The port's AVIF reader on items of every frame type and frame-header
form of spec 5.9.2: frame ids (current_frame_id, delta_frame_id,
display_frame_id, mark_ref_frames), SWITCH frames, INTRA_ONLY frames
(intrabc among them), hidden key and inter frames shown by
show_existing_frame (spec 7.21 then 7.20; the film grain it loads),
frame_refs_short_signaling (set_frame_refs, spec 7.8) and a first frame
that is not a key frame, on the fixtures of
``tests/torch_fixtures/avif_frametypes`` (libaom 3.6's error-resilient
and S-frame layers, libaom's frames under headers written again and
``avif_layers/inter_writer.py``'s frames, judged by dav1d), on the CPU
and with no tolerance:

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1) and
  the port's ``load_avif`` and ``decode_avif_to_rgb8`` pixels are the
  reference's, held live to the reference and to the manifest, with the
  frames the port decodes, their headers, the layer it shows and its
  tool counts (the 3840x2160 file decoded by the port once);
- each refusal (an inter or a SWITCH frame first, a reference frame id
  or a display_frame_id altered, a show_existing_frame of an empty slot)
  is refused by the port, dav1d and the reference alike;
- two small files regenerate byte for byte from the maker;
- set_frame_refs and mark_ref_frames equal hand-worked cases;
- the CLI ``-t 80`` on the 512x512 mixed class in error-resilient layers
  with an S-frame on top gives the reference CLI's q and passes, and the
  bytes of the port's CLI on its pixels as PAM.
"""

from __future__ import annotations

import json
import re
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import write_pam  # noqa: E402
from oavif_tpu import cli as ref_cli  # noqa: E402
from oavif_tpu.io.image import decode_avif_to_rgb8 as ref_rgb8  # noqa: E402
from oavif_tpu.io.image import load_avif as ref_load_avif  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.io import avif as A  # noqa: E402
from oavif_tpu_torch.io.av1_refs import RefHeaders, set_frame_refs  # noqa: E402
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)

FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_frametypes"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
DECODED = sorted(n for n, e in MANIFEST.items() if "broken" not in e)
REFUSED = sorted(n for n, e in MANIFEST.items() if "broken" in e)

sys.path.insert(0, str(FIXTURES))
import make_avif_frametypes as MK  # noqa: E402

KEY, INTER, INTRA_ONLY, SWITCH = (A.KEY_FRAME, A.INTER_FRAME,
                                 A.INTRA_ONLY_FRAME, A.SWITCH_FRAME)


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _yuv_crc(planes) -> int:
    return _crc(np.concatenate([p.astype("<u2").reshape(-1)
                                for p in planes if p is not None]))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("name", DECODED)
def test_fixture_decodes_to_dav1d_and_the_reference(name):
    path, entry = FIXTURES / name, MANIFEST[name]
    data = path.read_bytes()
    assert len(data) == entry["bytes"]
    planes, depth, _ = decode_to_yuv(data)
    assert (_yuv_crc(planes), depth) == (entry["yuv_crc"], entry["depth"])
    ref = ref_load_avif(str(path))
    assert [list(ref.data.shape), ref.hbd, _crc(ref.data)] == [
        entry["load_shape"], entry["load_hbd"], entry["load_crc"]]
    assert _crc(ref_rgb8(data)) == entry["rgb8_crc"]
    box, img, alpha = A.decode_avif(data)
    av1 = A.parse_av1(box.color.payload)
    assert [[f.spatial_id, f.frame.frame_type] for f in av1.frames] == \
        entry["frames"]
    assert MK.headers(data) == entry["headers"]
    assert av1.spatial_id == entry["shows_layer"]
    assert [[f.frame.coded_width, f.frame.width, f.frame.height]
            for f in av1.frames] == entry["sizes"]
    want = [p for p in planes if p is not None]
    assert len(img.planes) == len(want)
    for i, (got, p) in enumerate(zip(img.planes, want)):
        np.testing.assert_array_equal(got, p.astype(np.int32),
                                      err_msg=f"plane {i}")
    assert img.tools == entry["tools"]
    assert (alpha.tools if alpha else None) == entry["alpha_tools"]
    if entry["load_shape"][1] >= 3840:
        # load_avif's and decode_avif_to_rgb8's pixels of this one decode
        arr, hbd, _ = A.avif_pixels(box, img, alpha)
        rgb8 = A.yuv_to_rgb8(img, rgba=alpha is not None,
                             prem=alpha if box.premultiplied else None)
    else:
        got = load_avif(str(path))
        arr, hbd, rgb8 = got.data, got.hbd, decode_avif_to_rgb8(data)
    assert (arr.dtype, hbd) == (ref.data.dtype, ref.hbd)
    np.testing.assert_array_equal(arr, ref.data)
    assert _crc(rgb8) == entry["rgb8_crc"]


@pytest.mark.parametrize("name", REFUSED)
def test_refusals_alike(name):
    """A first frame that is an inter or a SWITCH frame (its slots empty),
    a reference frame id and a display_frame_id that are not their
    slot's, and a show_existing_frame of an empty slot: the port raises
    its broken-file error, and dav1d and the reference refuse too."""
    data = (FIXTURES / name).read_bytes()
    for read in (A.decode_avif, lambda d: load_avif(str(FIXTURES / name))):
        with pytest.raises(OSError) as e:
            read(data)
        assert str(e.value) == MANIFEST[name]["broken"]
    with pytest.raises(RuntimeError, match="avifDecoderNextImage"):
        decode_to_yuv(data)
    with pytest.raises(Exception):
        ref_load_avif(str(FIXTURES / name))


@pytest.mark.parametrize("name", ["hidden_grain_420_10bit.avif",
                                  "short_fallback_420.avif"])
def test_fixture_regenerates(name):
    assert MK.written(name)[0] == (FIXTURES / name).read_bytes()


def _frames(name):
    return A.parse_av1(A.read_container(
        (FIXTURES / name).read_bytes()).color.payload).frames


def test_fixtures_cover_the_set():
    """libaom's error-resilient layers (frame ids) in two, three and four
    layers and its S-frames on top and in the middle, with error
    resilience too; every subsampling at 8, 10 and 12 bits; INTRA_ONLY
    frames shown, as a GOLDEN reference, first, with intrabc and
    refreshing every slot; a hidden layer-1 frame shown from layer 0 and
    a key frame that is not showable shown all the same; a
    hidden key frame and a hidden inter frame with film grain, each shown
    by show_existing_frame (the key frame's with display_frame_id); short
    signaling over backward and forward slots and falling back to the
    earliest, once with frame ids; the mixed class and a 3840x2160 frame
    for the card."""
    M = MANIFEST
    types = {n: [t for _, t in e["frames"]] for n, e in M.items()
             if "frames" in e}
    for name in ("er_420_8bit.avif", "er3_422_10bit.avif",
                 "er4_mono_8bit.avif", "short_fwd_ids_444.avif",
                 "hidden_key_420.avif", "class_mixed_512.avif"):
        assert _frames(name)[0].seq.frame_ids, name
    assert {len(types[n]) for n in ("er_420_8bit.avif", "er3_422_10bit.avif",
                                    "er4_mono_8bit.avif")} == {2, 3, 4}
    assert types["s_top_444_12bit.avif"][-1] == SWITCH
    assert types["s_mid_420_10bit.avif"] == [KEY, SWITCH, INTER]
    assert types["er_s_top_422_8bit.avif"][-1] == SWITCH
    cells = {(e["written"]["depth"], e["written"]["ss"])
             for n, e in M.items() if n in MK.LIBAOM_FILES}
    assert cells >= {(8, "4:2:0"), (10, "4:2:2"), (8, "mono"),
                     (12, "4:4:4"), (10, "4:2:0"), (8, "4:2:2"),
                     (10, "mono")}
    golden = M["intra_only_golden_420.avif"]["headers"]
    assert golden[1][:2] == [INTRA_ONLY, 1] and golden[2][4][3] == 1
    assert M["intra_only_intrabc_444.avif"]["headers"][-1][0] == INTRA_ONLY
    assert M["intra_only_intrabc_444.avif"]["tools"]["intrabc"] > 0
    assert [h[0] for h in M["first_intra_only_420.avif"]["headers"]] == [
        INTRA_ONLY]
    assert M["intra_only_refresh_all_420.avif"]["headers"][-1][:4] == [
        INTRA_ONLY, 1, None, 0xFF]
    assert not _frames("show_not_showable_420.avif")[0].frame.showable_frame
    assert M["show_not_showable_420.avif"]["headers"][1][2] == 3
    # a hidden layer-1 frame shown from an OBU of layer 0 is shown as a
    # frame of layer 1
    layer0 = M["shown_in_layer0_420.avif"]
    assert layer0["headers"][-1][2] == 1 and layer0["shows_layer"] == 1
    assert layer0["frames"][-1][0] == 1
    hidden = M["hidden_key_420.avif"]["headers"]
    assert hidden[0][:2] == [KEY, 0] and hidden[1][2] == 3
    assert hidden[0][3] == 0x08 and hidden[1][3] == 0xFF
    grain = M["hidden_grain_420_10bit.avif"]["headers"]
    assert grain[1][:2] == [INTER, 0] and grain[2][2] == 1
    assert M["hidden_grain_420_10bit.avif"]["tools"]["film_grain"] > 0
    refs = {n: M[n]["headers"][-1][4] for n in (
        "short_back_420.avif", "short_fwd_ids_444.avif",
        "short_fallback_420.avif")}
    assert refs == {"short_back_420.avif": [0, 7, 6, 3, 1, 5, 2],
                    "short_fwd_ids_444.avif": [0, 2, 1, 3, 7, 6, 5],
                    "short_fallback_420.avif": [2, 1, 1, 1, 0, 3, 7]}
    assert M["photo4k_420.avif"]["load_shape"] == [2160, 3840, 3]
    assert types["photo4k_420.avif"][-1] == SWITCH
    assert M["class_mixed_512.avif"]["load_shape"] == [512, 512, 3]
    assert types["class_mixed_512.avif"][-1] == SWITCH
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 300_000
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == sorted(M)


# set_frame_refs (spec 7.8) by hand, OrderHintBits 7 (curFrameHint 64):
# shiftedOrderHints are 64 + get_relative_dist(hint, cur); a slot is
# backward at 64 or more. ALTREF takes the latest unused backward slot
# (the last of equals), BWDREF and then ALTREF2 the earliest (the first
# of equals), LAST2, LAST3, BWDREF, ALTREF2, ALTREF where still unset the
# latest unused forward slot, and the rest the earliest slot of all.
SET_FRAME_REFS = [
    # hints 0, 1, 2, then 0: at 1, slots 1 (64) and 2 (65) are backward,
    # the rest forward at 63. ALTREF 2, BWDREF 1, ALTREF2 none backward;
    # LAST2 7, LAST3 6, ALTREF2 5 forward
    ((0, 3, [0, 1, 2, 0, 0, 0, 0, 0], 1), [0, 7, 6, 3, 1, 5, 2]),
    # at 3 every slot is forward: 0 and 3..7 at 61, 1 at 62, 2 at 63;
    # LAST2 2, LAST3 1, BWDREF 7, ALTREF2 6, ALTREF 5
    ((0, 3, [0, 1, 2, 0, 0, 0, 0, 0], 3), [0, 2, 1, 3, 7, 6, 5]),
    # hints 30, 1, 2, then 30: at 25 slots 0 and 3..7 are backward (69),
    # 1 and 2 forward (40, 41) and coded: ALTREF 7, BWDREF 0, ALTREF2 3;
    # no forward slot is left, so LAST2 and LAST3 take the earliest, 1
    ((2, 1, [30, 1, 2, 30, 30, 30, 30, 30], 25), [2, 1, 1, 1, 0, 3, 7]),
    # the order hints wrap: 126 and 127 before 1, 3 after it (7 bits);
    # slots 4..7 at hint 1 are backward (64). LAST 0 (126 -> 61), GOLDEN 1
    # (127 -> 62); ALTREF the latest backward: 2 (3 -> 66); BWDREF the
    # earliest: 4 (64); ALTREF2: 5; LAST2 and LAST3 the latest forward:
    # none is left but 3 (0 -> 63): LAST2 3, LAST3 the earliest of all, 0
    ((0, 1, [126, 127, 3, 0, 1, 1, 1, 1], 1), [0, 3, 0, 1, 4, 5, 2]),
]


@pytest.mark.parametrize("args,want", SET_FRAME_REFS)
def test_set_frame_refs_by_hand(args, want):
    last, gold, hints, cur = args
    assert set_frame_refs(last, gold, hints, cur, 7) == want


def test_mark_ref_frames_by_hand():
    """mark_ref_frames with idLen 4 and a delta length of 2 (a window of
    the 4 ids before the current one): at id 9 the slots of ids 5 .. 9
    stay valid, those of 4 and 10 are lost; at id 2 (not past the window)
    a slot is lost where its id lies above 2 and below 16 + 2 - 4 = 14,
    so 14 and 15 stay, as do 0 .. 2."""
    refs = RefHeaders(valid=0xFF)
    refs.frame_id = [5, 9, 4, 10, 8, 6, 7, 9]
    refs.mark(9, 4, 2)
    assert refs.valid == 0b11110011
    refs = RefHeaders(valid=0xFF)
    refs.frame_id = [14, 15, 0, 2, 3, 13, 1, 12]
    refs.mark(2, 4, 2)
    assert refs.valid == 0b01001111


def test_show_existing_grain_is_the_hidden_frames():
    """The hidden inter frame's film grain, its seed included, comes back
    with show_existing_frame: the frame shown takes it, and without it
    the planes are the hidden frame's own."""
    data = (FIXTURES / "hidden_grain_420_10bit.avif").read_bytes()
    av1 = A.parse_av1(A.read_container(data).color.payload)
    hidden, shown = av1.frames[1].frame, av1.frames[2].frame
    assert shown.grain == hidden.grain_params and shown.grain is not None
    img = A.decode_avif(data)[1]
    assert img.frame_tools[-1]["film_grain"] > 0
    assert img.frame_tools[1]["film_grain"] == 0


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_frametypes_avif_matches_reference_and_pam(tmp_path, capsys):
    """``-t 80`` on the 512x512 mixed class in error-resilient layers
    (frame ids) with an S-frame on top."""
    args = ["-t", "80"]
    src = FIXTURES / "class_mixed_512.avif"
    _, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found is not None and found == ref_found
    pam = tmp_path / "px.pam"
    write_pam(pam, load_avif(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)
