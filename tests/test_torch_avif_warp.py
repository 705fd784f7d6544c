"""The port's AVIF reader on inter frames whose blocks use the motion
modes OBMC and LOCALWARP (the fixtures of
``tests/torch_fixtures/avif_warp``: libaom 3.6's realtime usage through
ctypes at ``cpu-used`` 5 and 6, and layer 1 written symbol by symbol by
``avif_layers/inter_writer.py`` for what libaom does not write), on the
CPU and with no tolerance:

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1) and
  ``load_avif`` and ``decode_avif_to_rgb8`` give the reference's pixels,
  held live to the reference and to the manifest, with the frames the
  port decodes, the layer it shows and its tool counts;
- the files libaom 3.6 writes by default below ``cpu-used`` 7, once
  refused, decode the same way;
- two small files regenerate byte for byte from the maker;
- each motion mode counter occurs, on every depth and subsampling;
- the written local warps fall back to translation exactly where the
  writer's own model of the spec's least squares and shear says;
- the CLI ``-t 80`` on a 512x512 file of both tools gives the reference
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
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)

FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_warp"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())

sys.path.insert(0, str(FIXTURES))
import make_avif_warp as MK  # noqa: E402

MOTION_TOOLS = ("obmc", "local_warp", "local_warp_invalid")
# libaom 3.6's defaults at cpu-used 5, which the decoder once refused
ONCE_REFUSED = ("avif_layers/obmc_s5_420.avif",
                "avif_layers/warp_s5_420.avif",
                "avif_progressive/obmc_s5_420.avif")


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


@pytest.mark.parametrize("name", ONCE_REFUSED)
def test_once_refused_fixture_decodes(name):
    """libaom's cpu-used 5 files, whose manifests kept Pillow's and
    dav1d's CRCs while the port refused them, and now hold its tools."""
    folder, file = name.split("/")
    entry = json.loads((FIXTURES.parent / folder / "manifest.json")
                       .read_text())[file]
    assert "refuses" not in entry
    assert entry["tools"]["obmc"] + entry["tools"]["local_warp"] > 0
    _holds(FIXTURES.parent / folder / file, entry)


@pytest.mark.parametrize("name", ["s5_420_8bit.avif",
                                  "written_warp_invalid_420.avif"])
def test_fixture_regenerates(name):
    if name in MK.WRITTEN:
        data, _ = MK.written(name)
    else:
        px, modes, kw = MK.files()[name]
        data = MK.encode_avif(px, before_layer=MK.scaling(modes), **kw)
    assert data == (FIXTURES / name).read_bytes()


@pytest.mark.parametrize("tool", MOTION_TOOLS)
def test_each_motion_tool_occurs(tool):
    assert sum(e["tools"][tool] for e in MANIFEST.values()) > 0


def test_fixtures_cover_the_grid():
    """Both tools at 8, 10 and 12 bits and on every subsampling (libaom's
    files), three layers, alpha, two tiles, the classes, the 3840x2160
    frame; OBMC alone on a scaled reference; each tool alone."""
    written = {n: x["written"] for n, x in MANIFEST.items()}
    for depth in (8, 10, 12):
        for ss, mono in (("4:2:0", False), ("4:2:2", False),
                         ("4:4:4", False), ("4:2:0", True)):
            cell = [n for n, w in written.items() if w.get("depth") == depth
                    and w.get("ss") == ss and bool(w.get("mono")) == mono
                    and "cpu-used" in w]
            assert cell, (depth, ss, mono)
            for tool in ("obmc", "local_warp"):
                assert sum(MANIFEST[n]["tools"][tool] for n in cell) > 0, \
                    (depth, ss, mono, tool)
            if mono:  # luma only
                assert all(len(A.decode_avif((FIXTURES / n).read_bytes())[1]
                               .planes) == 1 for n in cell)
    assert {int(w["cpu-used"]) for w in written.values()
            if "cpu-used" in w} == {5, 6}
    tools = {n: x["tools"] for n, x in MANIFEST.items()}
    assert tools["obmc_only_s5_420.avif"]["local_warp"] == 0 < \
        tools["obmc_only_s5_420.avif"]["obmc"]
    assert tools["warp_only_s6_420.avif"]["obmc"] == 0 < \
        tools["warp_only_s6_420.avif"]["local_warp"]
    for name in ("progressive_half_420.avif",
                 "progressive_four_fifths_420.avif"):
        assert tools[name]["obmc"] > 0 and tools[name]["scaled_pred"] > 0
        assert tools[name]["local_warp"] == 0
    assert len(MANIFEST["three_layers_420.avif"]["frames"]) == 3
    assert MANIFEST["alpha_420.avif"]["alpha_tools"]["inter_frame"] == 1
    assert all(tools[f"class_{c}_512.avif"][t] > 0 for c in (
        "sinusoid", "fractal", "edges", "oriented", "text", "mixed")
        for t in ("obmc", "local_warp"))
    assert MANIFEST["photo4k_420.avif"]["load_shape"] == [2160, 3840, 3]
    assert tools["photo4k_420.avif"]["obmc"] > 0
    assert tools["photo4k_420.avif"]["local_warp"] > 0
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 1_000_000
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == \
        sorted(MANIFEST)


@pytest.mark.parametrize("name", sorted(MK.WRITTEN))
def test_written_warps_fall_back_as_the_model_says(name):
    """Each written file's LOCALWARP blocks by the writer's model of
    warpEstimation and setupShear: the decoder counts the singular and
    the sheared ones as the blocks it predicted by translation."""
    warps = MANIFEST[name]["written"]["warps"]
    tools = MANIFEST[name]["tools"]
    assert tools["local_warp"] == sum(warps.values())
    assert tools["local_warp_invalid"] == warps.get("singular", 0) + \
        warps.get("shear", 0)


def test_written_files_hold_each_fallback():
    """A local warp left singular (LocalValid 0) and one whose shear the
    warp filter cannot follow; OBMC under two filters, on 4:2:2."""
    w = MANIFEST["written_warp_invalid_420.avif"]["written"]["warps"]
    assert w["singular"] > 0 and w["shear"] > 0 and w["valid"] > 0
    dual = MANIFEST["written_obmc_dual_420.avif"]
    assert dual["written"]["dual"] and dual["tools"]["dual_filter"] > 0
    assert dual["tools"]["obmc"] > 0
    e422 = MANIFEST["written_obmc_422_10bit.avif"]
    assert e422["written"]["ss"] == "4:2:2" and 1 in e422["written"]["leaves"]
    assert e422["tools"]["obmc"] > 0


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_warp_avif_matches_reference_and_pam(tmp_path, capsys):
    """``-t 80`` on the 512x512 mixed class, whose layer 1 has OBMC and
    local warps."""
    args = ["-t", "80"]
    src = FIXTURES / "class_mixed_512.avif"
    _, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found is not None and found == ref_found
    pam = tmp_path / "px.pam"
    write_pam(pam, load_avif(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)


def test_motion_times_leave_the_decode_alone():
    """``decode_avif``'s times (chip_smoke's split of the 3840x2160 read)
    take the time of OBMC and of the local warp in the tile decode of the
    inter frame that uses them, and of no other frame, without changing
    a sample."""
    data = (FIXTURES / "written_obmc_dual_420.avif").read_bytes()
    want = A.decode_avif(data)[1].planes
    times = {}
    got = A.decode_avif(data, times)[1].planes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < times["obmc_f1"] + times["warp_f1"] < times["tiles_f1"]
    assert not {"obmc_f0", "warp_f0"} & set(times)
    # an inter frame of neither tool gains neither key
    times = {}
    A.decode_avif((ROOT / "tests" / "torch_fixtures" / "avif_layers"
                   / "s7_420_12bit.avif").read_bytes(), times)
    assert "tiles_f1" in times
    assert not [k for k in times if k.startswith(("obmc_f", "warp_f"))]


def test_the_3840x2160_frame_draws_libaom_s_motion_modes():
    """libaom's realtime usage writes neither OBMC nor a local warp at
    3840x2160, so the written frame for the card draws its motion modes
    in the shares libaom gave the inter blocks of the six 512x512 class
    files of this folder, and its counts follow them."""
    inter = dict.fromkeys(("all", "obmc", "local_warp"), 0)
    for name, entry in MANIFEST.items():
        if name.startswith("class_"):
            t = entry["tools"]
            inter["all"] += sum(t[k] for k in ("newmv", "nearestmv",
                                               "nearmv", "globalmv"))
            inter["obmc"] += t["obmc"]
            inter["local_warp"] += t["local_warp"]
    weights = MK.WRITTEN["photo4k_420.avif"][7]
    assert weights == (inter["all"] - inter["obmc"] - inter["local_warp"],
                       inter["obmc"], inter["local_warp"], 0, 0)
    tools = MANIFEST["photo4k_420.avif"]["tools"]
    for k in ("obmc", "local_warp"):
        assert abs(tools[k] / tools["newmv"] - inter[k] / inter["all"]) \
            < 0.01
