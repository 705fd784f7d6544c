"""The port's AVIF reader on items whose inter frames hold compound
blocks (two references: spec 5.11.25-27, 7.10.2, 7.11.3.1, 7.11.3.11-15),
on the fixtures of ``tests/torch_fixtures/avif_compound`` (libaom 3.6's
realtime usage through ctypes, and frames ``avif_layers/inter_writer.py``
writes in every compound mode and type), on the CPU and with no
tolerance:

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1) and
  ``load_avif`` and ``decode_avif_to_rgb8`` give the reference's pixels,
  held live to the reference and to the manifest, with the frames the
  port decodes, the layer it shows, its tool counts and each frame's
  count of compound blocks;
- two small files regenerate byte for byte from the maker;
- every compound counter occurs (the eight modes, the four types, both
  kinds of reference pair, a side through a reference of another size),
  and the grid is covered;
- the compound tables the reader carries are libaom's, read live, and
  dav1d's distance weights;
- the time of the compound blends comes back for the frames that hold
  compound blocks and for no other;
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
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)
from oavif_tpu_torch.scripts import extract_av1_tool_tables as X  # noqa: E402

FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_compound"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())

sys.path.insert(0, str(FIXTURES))
import make_avif_compound as MK  # noqa: E402

# the compound counters (the global motion and skip_mode ones that follow
# are tests/test_torch_avif_globalmv.py's)
COUNTERS = A.TOOL_NAMES[A.TOOL_NAMES.index("nearest_nearestmv"):
                        A.TOOL_NAMES.index("global_translation")]


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _yuv_crc(planes) -> int:
    return _crc(np.concatenate([p.astype("<u2").reshape(-1)
                                for p in planes if p is not None]))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("name", sorted(MANIFEST))
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
    av1 = A.parse_av1(A.read_container(data).color.payload)
    assert [[f.spatial_id, f.frame.frame_type] for f in av1.frames] == \
        entry["frames"]
    assert av1.spatial_id == entry["shows_layer"]
    assert [[f.frame.coded_width, f.frame.width, f.frame.height]
            for f in av1.frames] == entry["sizes"]
    _, img, alpha = A.decode_avif(data)
    want = [p for p in planes if p is not None]
    assert len(img.planes) == len(want)
    for i, (got, p) in enumerate(zip(img.planes, want)):
        np.testing.assert_array_equal(got, p.astype(np.int32),
                                      err_msg=f"plane {i}")
    assert img.tools == entry["tools"]
    assert (alpha.tools if alpha else None) == entry["alpha_tools"]
    assert [sum(t[m] for m in MK.MODES) for t in img.frame_tools] == \
        entry["compound"]
    got = load_avif(str(path))
    assert (got.data.dtype, got.hbd, got.channels) == (ref.data.dtype,
                                                        ref.hbd,
                                                        ref.channels)
    np.testing.assert_array_equal(got.data, ref.data)
    assert _crc(decode_avif_to_rgb8(data)) == entry["rgb8_crc"]


@pytest.mark.parametrize("name", ["four_mono_12bit_s8.avif",
                                  "written_last3_mono_12bit.avif"])
def test_fixture_regenerates(name):
    if name in MK.WRITTEN:
        data = MK.written(name)[0]
    else:
        data = MK.make(*MK.files()[name])[0]
    assert data == (FIXTURES / name).read_bytes()


@pytest.mark.parametrize("tool", COUNTERS)
def test_each_counter_occurs(tool):
    assert sum(e["tools"][tool] for e in MANIFEST.values()) > 0


def test_fixtures_cover_the_grid():
    """Four layers of libaom on every subsampling at 8, 10 and 12 bits,
    1280x720 at ``cpu-used`` 7 to 10 and 1920x1080 at 5 and 6, with
    compound blocks in every cell but monochrome 12-bit (where libaom
    writes none); two tiles, 128-pixel superblocks, alpha with compound
    blocks, the progressive item, the six classes and the 3840x2160
    frame; the written frames in every mode and type, each on its pair,
    unidirectional and bidirectional, with a scaled side, at different
    distances, on both sides of the frame and beside single-reference
    blocks."""
    libaom = {n: e for n, e in MANIFEST.items()
              if e["written"]["writer"] == MK.LIBAOM}
    for depth in (8, 10, 12):
        for ss, mono in (("4:2:0", False), ("4:2:2", False),
                         ("4:4:4", False), ("4:2:0", True)):
            cell = [e for e in libaom.values() if e["written"]["depth"] ==
                    depth and e["written"]["ss"] == ss and
                    bool(e["written"].get("mono")) == mono and
                    len(e["frames"]) == 4]
            assert cell, (depth, ss, mono)
            if (depth, mono) != (12, True):
                assert any(e["compound"][3] for e in cell), (depth, ss)
    speeds = {int(e["written"]["cpu-used"]): e["sizes"][0][1]
              for n, e in libaom.items() if n.startswith("four_")}
    assert set(speeds) == set(range(5, 11))
    assert all(w == (1920 if s < 7 else 1280) for s, w in speeds.items())
    tiles = A.parse_av1(A.read_container(
        (FIXTURES / "tiles2_420.avif").read_bytes()).color.payload).frame
    assert len(tiles.tile_col_starts) == 3
    sb128 = A.parse_av1(A.read_container(
        (FIXTURES / "sb128_420.avif").read_bytes()).color.payload)
    assert sb128.seq.sb128
    assert MANIFEST["alpha_420.avif"]["alpha_tools"]["compound_average"] > 0
    prog = MANIFEST["progressive_420.avif"]
    assert prog["tools"]["scaled_pred"] > 0
    assert prog["sizes"][0][1] * 2 == prog["sizes"][-1][1]
    assert all(f"class_{c}_512.avif" in MANIFEST for c in (
        "sinusoid", "fractal", "edges", "oriented", "text", "mixed"))
    assert MANIFEST["class_mixed_512.avif"]["compound"][3] > 0
    photo = MANIFEST["photo4k_420.avif"]
    assert photo["load_shape"] == [2160, 3840, 3]
    assert photo["bytes"] < 400_000 and photo["compound"][3] > 0
    written = {n: e for n, e in MANIFEST.items() if n.startswith("written")}
    for e in written.values():
        t = e["tools"]
        assert e["compound"][-1] == sum(t[m] for m in MK.MODES) > 0
        assert all(t[m] for m in MK.MODES)
    assert all(written["written_dist_420.avif"]["tools"][f"compound_{k}"]
               for k in ("average", "distance", "wedge", "diffwtd"))
    for name in ("written_mixed_420.avif", "written_mixed_444_10bit.avif"):
        assert written[name]["written"]["counts"]["single"] > 0
    assert written["written_scaled_side_420.avif"]["sizes"][0][1] == 128
    assert written["written_scaled_side_420.avif"]["sizes"][1][1] == 256
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 1_000_000
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == \
        sorted(MANIFEST)


def test_compound_tables_are_libaom_and_dav1d():
    """The compound CDFs, wedge codebook and master rows and the distance
    weights the reader carries (``av1_tool_tables.npz``) against the
    system libaom, read live, and dav1d's distance weights (uint8 in its
    ``.rodata``); every wedge mask falls from 0 to 64 across its edge and
    its two signs are complements."""
    t = A._tool_tables()
    data = X.section(X.LIBAOM)
    live = {**X.compound_cdfs(data, X.section(X.LIBAOM, ".text")),
            **X.wedge_tables(data), **X.quant_dist(data)}
    for k, v in live.items():
        np.testing.assert_array_equal(t[k], v, err_msg=k)
    dav1d = X.section(str(Path(X.LIBAOM).with_name("libdav1d.so.6")))
    for k in ("quant_dist_weight", "quant_dist_lookup"):
        rows = t[k][:3] if k == "quant_dist_weight" else t[k]
        assert dav1d.count(rows.astype(np.uint8).tobytes()) == 1
    masks = A._wedge_masks(t["wedge_codebook"], t["wedge_master"])
    at = 0
    for w, h in A._WEDGE_SIZES:
        m = masks[at:at + 2 * 16 * w * h].reshape(2, 16, h, w)
        at += m.size
        assert np.array_equal(m[0] + m[1], np.full(m[0].shape, 64))
        assert m.min() == 0 and m.max() == 64
    assert at == masks.size


def test_compound_time_leaves_the_decode_alone():
    """``decode_avif``'s times (chip_smoke's split of the 3840x2160 read)
    take the time of the compound blends in the frame that holds compound
    blocks (layer 3 of four) and in no other, without changing a
    sample."""
    data = (FIXTURES / "four_444_10bit_s6.avif").read_bytes()
    want = A.decode_avif(data)[1].planes
    times = {}
    got = A.decode_avif(data, times)[1].planes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < times["compound_f3"] < times["tiles_f3"]
    assert not {"compound_f0", "compound_f1", "compound_f2"} & set(times)


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_compound_avif_matches_reference_and_pam(tmp_path, capsys):
    """``-t 80`` on the 512x512 mixed class in four layers, whose layer 3
    holds compound blocks."""
    args = ["-t", "80"]
    src = FIXTURES / "class_mixed_512.avif"
    _, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found is not None and found == ref_found
    pam = tmp_path / "px.pam"
    write_pam(pam, load_avif(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)
