"""The port's AVIF reader on items whose AV1 stream holds a second
sequence header (the fixtures of ``tests/torch_fixtures/avif_seqhdr``:
libaom 3.6's stills and layers with headers spliced in, judged by dav1d),
on the CPU and with no tolerance. As dav1d reads them (under Pillow's
libavif 1.3 and the system libavif 0.11.1), a header that repeats the one
in force apart from its operating parameter info changes nothing, and
one that differs starts a new coded video sequence: the reference slots
are emptied and every later frame is parsed and decoded under it.

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1) and the
  port's ``load_avif`` and ``decode_avif_to_rgb8`` pixels are the
  reference's, held live to the reference and to the manifest, with the
  frames the port decodes, the sequence each belongs to, the layer it
  shows and its tool counts: another encode's header before, between
  and after the item's own (a 64x64 frame then, scaled to the ``ispe``),
  decoder model info with other operating parameters repeated between
  two layers, a change of ``enable_order_hint``, of the frame id lengths
  or of the superblock size before layer 1, a header at 10 bits or
  monochrome where ``av1C`` says 8-bit 4:2:0, on the reference's
  high-bit-depth route too, and an alpha item's;
- a new sequence before an inter frame, and one whose operating point
  drops the layer the first one waits for, are refused by the port,
  dav1d and the reference alike;
- ``a1op``, ``lsel`` and ``a1lx`` on the layered files pick as Pillow;
- the sequence header's key leaves out only the operating parameters;
- three files regenerate byte for byte from the maker;
- the CLI ``-t 80`` on the 512x512 mixed class with another header
  between two of its own gives the reference CLI's q and passes, and the
  bytes of the port's CLI on its pixels as PAM.
"""

from __future__ import annotations

import io
import json
import re
import struct
import sys
import zlib
from dataclasses import replace
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
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)

FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_seqhdr"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
DECODED = sorted(n for n, e in MANIFEST.items() if "broken" not in e)
REFUSED = sorted(n for n, e in MANIFEST.items() if "broken" in e)
LAYERED = sorted(n for n in DECODED if len(MANIFEST[n]["frames"]) > 1)

sys.path.insert(0, str(FIXTURES))
sys.path.insert(0, str(FIXTURES.parent / "avif_tools"))
import make_avif_seqhdr as MK  # noqa: E402


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
    assert [f.sequence for f in av1.frames] == entry["sequences"]
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
    got = load_avif(str(path))
    assert (got.data.dtype, got.hbd) == (ref.data.dtype, ref.hbd)
    np.testing.assert_array_equal(got.data, ref.data)
    assert _crc(decode_avif_to_rgb8(data)) == entry["rgb8_crc"]


@pytest.mark.parametrize("name", REFUSED)
def test_refusals_alike(name):
    """An inter frame after a new sequence header (its slots emptied),
    and a new header whose operating point drops the layer the frame
    before it waits for (no frame put out): the port raises its
    broken-file error, and dav1d and the reference refuse too."""
    data = (FIXTURES / name).read_bytes()
    for read in (A.decode_avif, lambda d: load_avif(str(FIXTURES / name))):
        with pytest.raises(OSError) as e:
            read(data)
        assert str(e.value) == MANIFEST[name]["broken"]
    with pytest.raises(RuntimeError, match="avifDecoderNextImage"):
        decode_to_yuv(data)
    with pytest.raises(Exception):
        ref_load_avif(str(FIXTURES / name))


def test_fixtures_cover_the_set():
    """Another header first, between two of the item's own and governing
    the frame (a 64x64 frame scaled to the 256x256 ``ispe``); the same on
    the reference's 10-bit 4:4:4 route; decoder model info repeated with
    other operating parameters (one sequence); each per-sequence change
    before a key frame of layer 1 (a second sequence); 10 bits and
    monochrome against ``av1C``; alpha; the 512x512 class; the two
    refusals; and no refusal by name."""
    M = MANIFEST
    assert M["other_first_420.avif"]["sequences"] == [1]
    assert M["other_between_420.avif"]["sequences"] == [2]
    assert M["class_mixed_512.avif"]["sequences"] == [2]
    assert M["class_mixed_512.avif"]["load_shape"] == [512, 512, 3]
    assert M["other_governs_420.avif"]["sizes"] == [[64, 64, 64]]
    assert M["other_governs_420.avif"]["load_shape"] == [256, 256, 3]
    assert M["op_params_420.avif"]["sequences"] == [0, 0]
    assert M["op_params_420.avif"]["frames"] == [[0, A.KEY_FRAME],
                                                 [1, A.INTER_FRAME]]
    for name in ("order_hint_off_420.avif", "frame_id_len_420.avif",
                 "sb_size_420.avif", "layers_new_key_420.avif",
                 "layers_ops_one_420.avif"):
        assert M[name]["sequences"] == [0, 1], name
        assert M[name]["shows_layer"] == 1, name
    seqs = {n: [f.seq for f in A.parse_av1(A.read_container(
        (FIXTURES / n).read_bytes()).color.payload).frames]
        for n in ("order_hint_off_420.avif", "frame_id_len_420.avif",
                  "sb_size_420.avif", "op_params_420.avif")}
    assert [s.order_hint_bits > 0 for s in
            seqs["order_hint_off_420.avif"]] == [True, False]
    a, b = seqs["frame_id_len_420.avif"]
    assert a.frame_ids and b.frame_ids and (a.id_len, a.delta_id_len) != (
        b.id_len, b.delta_id_len)
    assert [s.sb128 for s in seqs["sb_size_420.avif"]] == [False, True]
    assert all(s.decoder_model_info for s in seqs["op_params_420.avif"])
    assert M["depth_second_420.avif"]["depth"] == 10
    assert M["depth_first_420.avif"]["depth"] == 8
    assert M["mono_second_420.avif"]["written"]["changed"] == "monochrome"
    assert M["depth_second_444.avif"]["load_hbd"]
    assert M["deep_other_first_444.avif"]["load_hbd"]
    assert M["alpha_other_first_420.avif"]["load_shape"] == [256, 256, 4]
    assert M["layers_new_inter_420.avif"]["broken"].endswith(
        "(an inter frame names an empty reference slot)")
    assert M["layers_ops_drop_420.avif"]["broken"].endswith(
        "(no shown frame)")
    assert not any("refuses" in e for e in M.values())
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 100_000
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == sorted(M)


def test_sequence_key_leaves_out_only_the_operating_parameters():
    """Two headers written from one parsed header: other operating
    parameters give the same key, another level or another inter tool a
    different one."""
    data = (FIXTURES / "op_params_420.avif").read_bytes()
    s = A.parse_av1(A.read_container(data).color.payload).seq
    n = len(s.op_idcs)
    key = MK.parsed(MK.sequence_header(s, op_params=[(1, 1, 0)] * n)).key
    assert MK.parsed(MK.sequence_header(
        s, op_params=[(9, 4, 1)] * n)).key == key
    assert MK.parsed(MK.sequence_header(
        s, levels=[8] * n, op_params=[(1, 1, 0)] * n)).key != key
    assert MK.parsed(MK.sequence_header(
        replace(s, masked_compound=not s.masked_compound),
        op_params=[(1, 1, 0)] * n)).key != key


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), typ) + payload


WRAPPINGS = ("a1op 0", "a1op 1", "a1op 2", "lsel 0", "lsel 1",
             "lsel 65535", "a1lx")


def _wrapped(src: bytes, case: str) -> bytes:
    """``src`` with an ``a1op``, an ``lsel`` (both essential) or an
    ``a1lx`` property of the item's layer sizes."""
    from make_avif_tools import add_property

    kind, v = case.split(" ") if " " in case else (case, "0")
    if kind == "a1op":
        return add_property(src, _box(b"a1op", bytes([int(v)])), True)
    if kind == "lsel":
        return add_property(src, _box(b"lsel", struct.pack(">H", int(v))),
                            True)
    size = len(A.read_container(src).color.payload)
    return add_property(src, _box(b"a1lx", bytes([0]) + struct.pack(
        ">HHH", size // 2, 0, 0)))


@pytest.mark.parametrize("name", LAYERED)
def test_layer_properties_select_as_pillow(name):
    """Each operating point and layer that ``a1op`` and ``lsel`` pick, and
    ``a1lx``, on the layered files: the port's RGB is Pillow's, or both
    refuse."""
    from PIL import Image

    src = (FIXTURES / name).read_bytes()
    for case in WRAPPINGS:
        data = _wrapped(src, case)
        try:
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception:  # Pillow refuses the file or fails its frame
            with pytest.raises(OSError):
                A.decode_avif_rgb8(data)
            continue
        np.testing.assert_array_equal(A.decode_avif_rgb8(data), want,
                                      err_msg=case)


@pytest.mark.parametrize("name", ["other_between_420.avif",
                                  "op_params_420.avif",
                                  "frame_id_len_420.avif"])
def test_fixture_regenerates(name):
    assert MK.written(name)[0] == (FIXTURES / name).read_bytes()


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_seqhdr_avif_matches_reference_and_pam(tmp_path, capsys):
    """``-t 80`` on the 512x512 mixed class with another encode's header
    between two of its own."""
    args = ["-t", "80"]
    src = FIXTURES / "class_mixed_512.avif"
    _, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found is not None and found == ref_found
    pam = tmp_path / "px.pam"
    write_pam(pam, load_avif(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)
