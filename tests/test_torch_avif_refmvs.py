"""The port's AVIF reader on items in three and four spatial layers whose
inter frames set ``use_ref_frame_mvs`` (libaom's default): motion field
estimation (spec 7.9) and the MV stack's temporal candidates (spec
7.10.2.5-6), on the fixtures of ``tests/torch_fixtures/avif_refmvs``
(libaom 3.6's realtime usage through ctypes), on the CPU and with no
tolerance:

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1) and
  ``load_avif`` and ``decode_avif_to_rgb8`` give the reference's pixels,
  held live to the reference and to the manifest, with the frames the
  port decodes, the layer it shows, each frame's ``use_ref_frame_mvs``
  and its tool counts, the compound block libaom writes into layer 3 of
  four from 1280x720 among them (``tests/test_torch_avif_compound.py``
  holds the set of compound blocks);
- two small files regenerate byte for byte from the maker;
- both counters occur, the grid is covered, and the projection runs where
  spec 7.9 projects (layer 3 of four, from LAST) and nowhere else (three
  layers, a LAST of another size);
- the choice of the frames projected (``av1_refs.motion_field``) follows
  libaom's ``av1_setup_motion_field`` on the cases libaom's layers do not
  reach: an overlay LAST, later references, a key frame and a frame of
  another size;
- the time of the projection comes back for the frame that projects;
- the CLI ``-t 80`` on a 512x512 four-layer file gives the reference
  CLI's q and passes, and the bytes of the port's CLI on its pixels as
  PAM.
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
from oavif_tpu_torch.io.av1_refs import RefFrame, motion_field  # noqa: E402
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)

FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_refmvs"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
LAYERS = ROOT / "tests" / "torch_fixtures" / "avif_layers"
ONCE_REFUSED = "three_layers_refmvs_420.avif"

sys.path.insert(0, str(FIXTURES))
import make_avif_refmvs as MK  # noqa: E402

COUNTERS = ("mf_projected", "temporal_mv")


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _yuv_crc(planes) -> int:
    return _crc(np.concatenate([p.astype("<u2").reshape(-1)
                                for p in planes if p is not None]))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


def _holds(path: Path, entry: dict) -> None:
    """``path`` against dav1d, the reference and its manifest ``entry``."""
    data = path.read_bytes()
    assert len(data) == entry["bytes"]
    planes, depth, _ = decode_to_yuv(data)
    assert (_yuv_crc(planes), depth) == (entry["yuv_crc"], entry["depth"])
    ref = ref_load_avif(str(path))
    assert [list(ref.data.shape), ref.hbd, _crc(ref.data)] == [
        entry["load_shape"], entry["load_hbd"], entry["load_crc"]]
    assert _crc(ref_rgb8(data)) == entry["rgb8_crc"]
    av1 = A.parse_av1(A.read_container(data).color.payload)
    assert [[f.spatial_id, f.frame.frame_type] for f in av1.frames] == \
        entry["frames"]
    assert av1.spatial_id == entry["shows_layer"]
    if "refmvs" in entry:
        assert [f.frame.use_ref_frame_mvs for f in av1.frames] == \
            entry["refmvs"]
    if "refuses" in entry:
        with pytest.raises(A.UnsupportedAvif,
                           match=re.escape(entry["refuses"])):
            A.decode_avif(data)
        return
    times = {}
    _, img, alpha = A.decode_avif(data, times)
    want = [p for p in planes if p is not None]
    assert len(img.planes) == len(want)
    for i, (got, p) in enumerate(zip(img.planes, want)):
        np.testing.assert_array_equal(got, p.astype(np.int32),
                                      err_msg=f"plane {i}")
    assert img.tools == entry["tools"]
    assert (alpha.tools if alpha else None) == entry["alpha_tools"]
    for i in range(len(entry["frames"])):
        assert times[f"tiles_f{i}"] > 0 and f"filters_f{i}" in times
    got = load_avif(str(path))
    assert (got.data.dtype, got.hbd, got.channels) == (ref.data.dtype,
                                                        ref.hbd,
                                                        ref.channels)
    np.testing.assert_array_equal(got.data, ref.data)
    assert _crc(decode_avif_to_rgb8(data)) == entry["rgb8_crc"]


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_to_dav1d_and_the_reference(name):
    _holds(FIXTURES / name, MANIFEST[name])


@pytest.mark.parametrize("name", ["four_mono_12bit_s10.avif",
                                  "three_420_8bit_s8.avif"])
def test_fixture_regenerates(name):
    px, modes, kw = MK.files()[name]
    assert MK.make(px, modes, kw)[0] == (FIXTURES / name).read_bytes()


@pytest.mark.parametrize("tool", COUNTERS)
def test_each_counter_occurs(tool):
    assert sum(e.get("tools", {}).get(tool, 0)
               for e in MANIFEST.values()) > 0


def test_fixtures_cover_the_grid():
    """Three and four layers on every subsampling at 8, 10 and 12 bits,
    ``cpu-used`` 5 to 10, two tiles, 128-pixel superblocks, alpha, the
    two progressive items, the six classes, the 3840x2160 frame and the
    1280x720 frame whose layer 3 holds a compound block, once refused;
    OBMC and local warps beside the projection."""
    e = {n: x for n, x in MANIFEST.items() if "tools" in x}
    written = {n: x["written"] for n, x in e.items()}
    for depth in (8, 10, 12):
        for ss, mono in (("4:2:0", False), ("4:2:2", False),
                         ("4:4:4", False), ("4:2:0", True)):
            cell = [n for n, w in written.items() if w["depth"] == depth
                    and w["ss"] == ss and bool(w.get("mono")) == mono]
            assert any(len(e[n]["frames"]) == 4 for n in cell), \
                (depth, ss, mono)
    assert {len(x["frames"]) for x in e.values()} == {3, 4}
    assert {int(w["cpu-used"]) for w in written.values()} == \
        set(range(5, 11))
    assert all(x["refmvs"] == [False] + [True] * (len(x["frames"]) - 1)
               for x in MANIFEST.values())
    assert sum(x["tools"]["obmc"] for x in e.values()) > 0
    assert sum(x["tools"]["local_warp"] for x in e.values()) > 0
    assert MANIFEST["alpha_420.avif"]["alpha_tools"]["mf_projected"] > 0
    tiles = A.parse_av1(A.read_container(
        (FIXTURES / "tiles2_420.avif").read_bytes()).color.payload).frame
    assert len(tiles.tile_col_starts) == 3
    sb128 = A.parse_av1(A.read_container(
        (FIXTURES / "sb128_420.avif").read_bytes()).color.payload)
    assert sb128.seq.sb128
    for name in ("progressive_half_420.avif", "progressive_skip_420.avif"):
        assert e[name]["tools"]["scaled_pred"] > 0
        assert e[name]["sizes"][0][1] * 2 == e[name]["sizes"][-1][1]
    assert e["progressive_skip_420.avif"]["sizes"][1][1] * 2 == \
        e["progressive_skip_420.avif"]["sizes"][-1][1]
    assert all(f"class_{c}_512.avif" in e for c in (
        "sinusoid", "fractal", "edges", "oriented", "text", "mixed"))
    assert MANIFEST["photo4k_420.avif"]["load_shape"] == [2160, 3840, 3]
    assert MANIFEST["photo4k_420.avif"]["bytes"] < 400_000
    assert MANIFEST["compound_720p_420.avif"]["tools"][
        "compound_average"] > 0
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 1_000_000
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == \
        sorted(MANIFEST)


@pytest.mark.parametrize("name", sorted(
    [n for n, x in MANIFEST.items() if "tools" in x] + [ONCE_REFUSED]))
def test_projection_runs_where_spec_projects(name):
    """Layer 3 of four projects layer 1's MVs (LAST); three layers project
    nothing (every projected slot holds the key frame), nor does a layer
    3 whose LAST is of another size; where nothing is projected no
    temporal candidate joins a stack. ``avif_layers``' three layers,
    refused before the decoder read reference MVs (its decode is held by
    ``tests/test_torch_avif_layers.py``), project nothing either."""
    folder = LAYERS if name == ONCE_REFUSED else FIXTURES
    entry = json.loads((folder / "manifest.json").read_text())[name]
    tools = entry["tools"]
    if len(entry["frames"]) == 4 and name != "progressive_skip_420.avif":
        assert tools["mf_projected"] > 0 and tools["temporal_mv"] > 0
    else:
        assert tools["mf_projected"] == tools["temporal_mv"] == 0


def _ref(frame_type=1, order_hint=1, saved=(0,) * 7, mi=(64, 64)):
    return RefFrame([], 8, (1, 1), 256, 256, [], frame_type=frame_type,
                    order_hint=order_hint, saved_order_hints=tuple(saved),
                    mi_rows=mi[0], mi_cols=mi[1])


def _header(order_hint, ref_frame_idx, ref_order_hints, mi=(64, 64)):
    fh = A.FrameHeader()
    fh.frame_type, fh.use_ref_frame_mvs = 1, True
    fh.order_hint, fh.ref_frame_idx = order_hint, tuple(ref_frame_idx)
    fh.ref_order_hints = tuple(ref_order_hints)
    fh.mi_rows, fh.mi_cols = mi
    return fh


@pytest.mark.parametrize("case", ["layer3", "overlay", "later", "sizes",
                                  "key", "far"])
def test_frames_projected_follow_libaom(case):
    """``motion_field``'s picks, each source's sign, its distance to the
    frame and to its references, against libaom's
    ``av1_setup_motion_field`` worked by hand: LAST unless an overlay,
    BWDREF and ALTREF2 after the frame, ALTREF and LAST2 while fewer than
    MFMV_STACK_SIZE ran, LAST counted whether it ran or not; a key frame
    or one of another size passed over uncounted."""
    key = _ref(frame_type=0, order_hint=0)
    if case == "layer3":  # libaom's layer 3 of four
        slots = [key, _ref(order_hint=1), _ref(order_hint=2)]
        fh = _header(3, (1, 0, 0, 2, 0, 0, 0), (1, 0, 0, 2, 0, 0, 0))
        want = [(1, -1, 2)]
    elif case == "overlay":  # LAST's ALTREF is the GOLDEN: LAST2 instead
        slots = [_ref(order_hint=2), _ref(order_hint=4, saved=(2,) * 7),
                 _ref(order_hint=3, saved=(2,) * 7)]
        fh = _header(5, (1, 2, 0, 0, 0, 0, 0), (4, 3, 2, 2, 2, 2, 2))
        want = [(2, -1, 2)]
    elif case == "later":  # LAST, BWDREF, ALTREF2; no room for ALTREF
        slots = [_ref(order_hint=2), _ref(order_hint=6, saved=(2,) * 7),
                 _ref(order_hint=8, saved=(6,) * 7),
                 _ref(order_hint=7, saved=(6,) * 7)]
        fh = _header(4, (0, 0, 0, 0, 1, 3, 2), (2, 2, 2, 2, 6, 7, 8))
        want = [(0, -1, 2), (1, 1, 2), (3, 1, 3)]
    elif case == "sizes":  # LAST of another size: BWDREF and ALTREF run
        slots = [_ref(order_hint=2, mi=(32, 32)),
                 _ref(order_hint=6, saved=(2,) * 7),
                 _ref(order_hint=8, saved=(6,) * 7)]
        fh = _header(4, (0, 0, 0, 0, 1, 0, 2), (2, 2, 2, 2, 6, 2, 8))
        want = [(1, 1, 2), (2, 1, 4)]
    elif case == "key":  # a key frame BWDREF, passed over, leaves room
        slots = [_ref(order_hint=2), _ref(frame_type=0, order_hint=5),
                 _ref(order_hint=7, saved=(2,) * 7),
                 _ref(order_hint=8, saved=(7,) * 7)]
        fh = _header(4, (0, 0, 0, 0, 1, 2, 3), (2, 2, 2, 2, 5, 7, 8))
        want = [(0, -1, 2), (2, 1, 3), (3, 1, 4)]
    else:  # a source 40 frames away: no distance within reach
        slots = [_ref(order_hint=0, saved=(1,) * 7),
                 _ref(order_hint=45, saved=(44,) * 7), key]
        fh = _header(5, (0, 2, 0, 0, 1, 0, 0), (0, 0, 0, 0, 45, 0, 0))
        want = [(0, -1, 5), (1, 1, 40)]
    seq = A.SequenceHeader()
    seq.order_hint_bits = 7
    pack, sources = motion_field(fh, seq, slots)
    assert pack[1] == len(sources) == len(want)
    for k, (slot, sign, num) in enumerate(want):
        assert sources[k] is slots[slot]
        p = pack[10 + 10 * k:20 + 10 * k]
        assert (p[0], p[1]) == (sign, num)
        src = slots[slot]
        offs = [src.order_hint - h for h in src.saved_order_hints]
        assert list(p[3:]) == [d if 0 < d <= 31 and abs(num) <= 31 else 0
                               for d in offs]
    # the store mask: the references before the frame in order
    assert pack[0] == sum(1 << (r + 1) for r, h in
                          enumerate(fh.ref_order_hints) if h < fh.order_hint)
    assert list(pack[3:10]) == [fh.order_hint - h
                                for h in fh.ref_order_hints]


def test_projection_time_leaves_the_decode_alone():
    """``decode_avif``'s times (chip_smoke's split of the 3840x2160 read)
    take the time of motion field estimation in the frame that projects
    (layer 3 of four) and in no other, without changing a sample."""
    data = (FIXTURES / "four_420_8bit_s5.avif").read_bytes()
    want = A.decode_avif(data)[1].planes
    times = {}
    got = A.decode_avif(data, times)[1].planes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < times["project_f3"] < times["tiles_f3"]
    assert not {"project_f0", "project_f1", "project_f2"} & set(times)


@pytest.mark.parametrize("name", ["four_420_8bit_s5.avif",
                                  "progressive_half_420.avif",
                                  "three_420_8bit_s8.avif"])
def test_frame_tools_split_the_counts(name):
    """``DecodedImage.frame_tools`` (chip_smoke's per-frame counts) add up
    to the item's tools, and the projection and its temporal candidates
    fall in the frame that projects, layer 3 of four."""
    img = A.decode_avif((FIXTURES / name).read_bytes())[1]
    assert len(img.frame_tools) == len(MANIFEST[name]["frames"])
    assert {k: sum(t[k] for t in img.frame_tools) for k in A.TOOL_NAMES} \
        == img.tools
    for i, t in enumerate(img.frame_tools):
        if i != 3:
            assert t["mf_projected"] == t["temporal_mv"] == 0
    assert [t["inter_frame"] for t in img.frame_tools] == \
        [0] + [1] * (len(img.frame_tools) - 1)


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_refmvs_avif_matches_reference_and_pam(tmp_path, capsys):
    """``-t 80`` on the 512x512 mixed class in four layers, whose layer 3
    reads temporal candidates."""
    args = ["-t", "80"]
    src = FIXTURES / "class_mixed_512.avif"
    _, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found is not None and found == ref_found
    pam = tmp_path / "px.pam"
    write_pam(pam, load_avif(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)
