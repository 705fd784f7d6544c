"""The port's AVIF reader on progressive items, whose later spatial layers
are inter frames predicted from a layer of another size, and on inter
frames under superres (the fixtures of
``tests/torch_fixtures/avif_progressive``: libaom 3.6's realtime layers
with ``AOME_SET_SCALEMODE`` through ctypes, and inter frames written
symbol by symbol by ``avif_layers/inter_writer.py`` over libaom's key
frame of another size), on the CPU and with no tolerance:

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1) and
  ``load_avif`` and ``decode_avif_to_rgb8`` give the reference's pixels,
  held live to the reference and to the manifest, with the frames the
  port decodes, their sizes, the layer it shows and its tool counts; a
  file with a tool the port refuses raises ``UnsupportedAvif`` naming it,
  and a reference past the spec's 2x and 1/16 limits raises ``OSError``
  in both packages;
- a few files regenerate byte for byte from the maker;
- scaled prediction occurs, at every scaling mode, subsampling and depth
  of the set;
- at a scale of exactly 1 the scaled prediction gives the unscaled loop's
  samples, part for part, over the same-size layers of
  ``avif_layers`` (the decoder's ``av1_scaled_parity`` hook);
- ``lsel`` picks each layer of a progressive file as Pillow's libavif 1.3
  does, the smaller ones scaled to the ``ispe``;
- the CLI ``-t 80`` on a 512x512 progressive file gives the reference
  CLI's q and passes, and the bytes of the port's CLI on its pixels as
  PAM.
"""

from __future__ import annotations

import ctypes as C
import io
import json
import re
import struct
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
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)

FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_progressive"
LAYERS = FIXTURES.parent / "avif_layers"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())

sys.path.insert(0, str(FIXTURES))
sys.path.insert(0, str(FIXTURES.parent / "avif_tools"))
import make_avif_progressive as MK  # noqa: E402


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _yuv_crc(planes) -> int:
    return _crc(np.concatenate([p.astype("<u2").reshape(-1)
                                for p in planes if p is not None]))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


DECODED = sorted(n for n, e in MANIFEST.items() if "broken" not in e)


@pytest.mark.parametrize("name", DECODED)
def test_fixture_decodes_to_dav1d_and_the_reference(name):
    entry = MANIFEST[name]
    path = FIXTURES / name
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
    assert [[f.frame.coded_width, f.frame.width, f.frame.height]
            for f in av1.frames] == entry["sizes"]
    assert av1.spatial_id == entry["shows_layer"]
    if "refuses" in entry:
        with pytest.raises(A.UnsupportedAvif, match=re.escape(
                entry["refuses"])):
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


@pytest.mark.parametrize("name", sorted(n for n, e in MANIFEST.items()
                                        if "broken" in e))
def test_references_past_the_limits_raise_in_both(name, tmp_path):
    """A reference more than 2x larger or 16x smaller than its frame
    (spec 7.11.3.3): dav1d and Pillow's libavif refuse the frame, the
    port's tile decoder raises ``OSError`` before its tiles."""
    data = (FIXTURES / name).read_bytes()
    path = tmp_path / "x.avif"
    path.write_bytes(data)
    with pytest.raises(Exception):
        ref_load_avif(str(path))
    with pytest.raises(Exception):
        ref_rgb8(data)
    with pytest.raises(Exception):
        decode_to_yuv(data)
    with pytest.raises(OSError, match=re.escape(MANIFEST[name]["broken"])):
        load_avif(str(path))
    with pytest.raises(OSError, match="scaling limits"):
        decode_avif_to_rgb8(data)


@pytest.mark.parametrize("name", sorted(n for n, e in MANIFEST.items()
                                        if "broken" in e))
def test_tile_decoder_checks_the_limits_itself(name):
    """The C decoder's check (which also bounds its intermediate rows)
    holds the reference's size to the later frame's coded size as
    ``parse_av1`` reads them, after layer 0 decoded and before any tile
    of the frame that names the reference."""
    data = (FIXTURES / name).read_bytes()
    first, later = (f.frame for f in
                    A.parse_av1(A.read_container(data).color.payload).frames)
    times = {}
    with pytest.raises(OSError) as e:
        A.decode_avif(data, times)
    assert str(e.value) == (
        f"broken AVIF file (AV1: a reference frame of {first.width}x"
        f"{first.height} for a frame of {later.coded_width}x{later.height}, "
        f"beyond the 2x and 16x scaling limits)")
    assert "tiles_f0" in times and "tiles_f1" not in times


@pytest.mark.parametrize("name", ["half_420.avif", "superres_420.avif",
                                  "written_larger_ref_420.avif",
                                  "broken_ref_over_2x.avif"])
def test_fixture_regenerates(name):
    if name in {**MK.WRITTEN, **MK.BROKEN}:
        data, _ = MK.written(name)
    else:
        px, modes, kw = MK.files()[name]
        data = MK.encode_avif(px, before_layer=MK.scaling(modes), **kw)
    assert data == (FIXTURES / name).read_bytes()


def test_fixtures_cover_the_set():
    e = {n: x for n, x in MANIFEST.items() if "tools" in x}
    assert all(x["tools"]["scaled_pred"] > 0 for x in e.values())
    written = [x["written"] for x in e.values()]
    scales = {s for w in written for m in w.get("scales", ())
              for s in m}
    assert scales == set(MK.MODES)
    assert ["1/2", "1"] in [m for w in written for m in w.get("scales", ())]
    assert {w.get("ss") for w in written} >= {"4:2:0", "4:2:2", "4:4:4"}
    assert any(w.get("mono") for w in written)
    assert {w.get("depth") for w in written} == {8, 10, 12}
    # cpu-used 5 is the OBMC file, which decodes since OBMC does
    assert {int(w["cpu-used"]) for w in written if "cpu-used" in w} == \
        set(range(5, 11))
    assert any(x["alpha_tools"] and x["alpha_tools"]["scaled_pred"]
               for x in e.values())
    assert any(len(x["frames"]) == 3 and x["shows_layer"] == 2
               for x in e.values())
    # a reference larger than its frame, and inter frames under superres
    assert any(x["sizes"][0][1] > x["sizes"][1][1] for x in e.values())
    assert any(x["sizes"][-1][0] < x["sizes"][-1][1] for x in e.values())
    assert MANIFEST["photo4k_420.avif"]["sizes"] == [[1920, 1920, 1080],
                                                     [3840, 3840, 2160]]
    # a scaled reference reads use_obmc only: OBMC, never a local warp
    tools = MANIFEST["obmc_s5_420.avif"]["tools"]
    assert tools["obmc"] > 0 and tools["scaled_pred"] > 0
    assert tools["local_warp"] == 0
    assert sorted(n for n, x in MANIFEST.items() if "broken" in x) == \
        sorted(MK.BROKEN)
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 1_000_000
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == \
        sorted(MANIFEST)


# ---------------------------------------------------------------------------
# the scaled path at scale 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(
    n for n, e in json.loads((LAYERS / "manifest.json").read_text()).items()
    if "tools" in e))
def test_scaled_prediction_at_scale_one_is_the_unscaled_loop(name):
    """Every unscaled inter part of the same-size layers, predicted again
    by the scaled path at xScale = yScale = 1 << 14: the same samples."""
    lib = A._host_lib()
    counts = np.zeros(2, dtype=np.int64)
    lib.av1_scaled_parity(counts.ctypes.data_as(C.c_void_p))
    try:
        img = A.decode_avif((LAYERS / name).read_bytes())[1]
    finally:
        lib.av1_scaled_parity(None)
    assert img.tools["scaled_pred"] == 0
    assert counts[0] > 0 and counts[1] == 0, counts


# ---------------------------------------------------------------------------
# lsel on a progressive file
# ---------------------------------------------------------------------------


def _lsel(src: bytes, v) -> bytes:
    from make_avif_tools import add_property

    return src if v is None else add_property(
        src, struct.pack(">I4sH", 10, b"lsel", v), True)


def _pillow(data: bytes):
    from PIL import Image

    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # Pillow refuses the file or fails its frame
        return type(e)


@pytest.mark.parametrize("src,lsel", [
    ("three_layers_420.avif", v) for v in (None, 0, 1, 2, 3, 0xFFFF)] + [
    ("half_width_420.avif", v) for v in (0, 1)] + [
    ("alpha_420.avif", 0), ("written_larger_ref_420.avif", 0),
    ("written_half_420_10bit.avif", 0)])
def test_lsel_picks_each_layer_as_pillow(src, lsel):
    """``lsel`` names a layer: the smaller layers shown at the ``ispe``,
    scaled as libavif 1.3 scales them (libyuv's ScalePlane)."""
    data = _lsel((FIXTURES / src).read_bytes(), lsel)
    want = _pillow(data)
    if isinstance(want, type):
        with pytest.raises(OSError):
            A.decode_avif_rgb8(data)
        return
    got = A.decode_avif_rgb8(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_lsel_zero_shows_the_small_layer():
    src = (FIXTURES / "three_layers_420.avif").read_bytes()
    times = {}
    img = A.decode_avif(_lsel(src, 0), times)[1]
    assert img.planes[0].shape == (256, 256) and "scale" in times
    assert img.tools["inter_frame"] == 0
    assert A.decode_avif(_lsel(src, 1))[1].tools["inter_frame"] == 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_progressive_avif_matches_reference_and_pam(tmp_path, capsys):
    """``-t 80`` on the 512x512 mixed class, layer 0 at half its size."""
    args = ["-t", "80"]
    src = FIXTURES / "class_mixed_512.avif"
    _, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found is not None and found == ref_found
    pam = tmp_path / "px.pam"
    write_pam(pam, load_avif(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)
