"""The port's AVIF reader on items whose inter frames hold inter-intra
blocks (spec 5.11.24, 7.11.3.13-14: the four interintra_modes, the smooth
and the wedge mask) and segment ids predicted from the previous map (spec
5.9.14, 5.11.9, 7.20-21: segmentation_update_map 0, and
segmentation_temporal_update 1 with seg_id_predicted), on the fixtures of
``tests/torch_fixtures/avif_interintra`` (frames ``avif_layers/
inter_writer.py`` writes over libaom 3.6's layers, and libaom's own cyclic
refresh layers, judged by dav1d), on the CPU and with no tolerance:

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1) and
  the port's ``load_avif`` and ``decode_avif_to_rgb8`` pixels are the
  reference's, held live to the reference and to the manifest, with the
  frames the port decodes, the layer it shows, its tool counts and each
  frame's count of inter-intra blocks, wedge ones and predicted segment
  ids and its map mode (the 3840x2160 file decoded by the port once);
- two small files regenerate byte for byte from the maker;
- every new counter occurs, and the set is covered;
- the inter-intra and seg_id_predicted CDFs and Ii_Weights_1d the reader
  carries are libaom's, read live;
- the segment_id symbol the writer codes is the one the spec's
  neg_deinterleave reads back;
- inter-intra's time comes back for the frames that blend and for no
  other;
- the CLI ``-t 80`` on the 512x512 mixed class with both tools gives the
  reference CLI's q and passes, and the bytes of the port's CLI on its
  pixels as PAM.
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

FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_interintra"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())

sys.path.insert(0, str(FIXTURES))
import make_avif_interintra as MK  # noqa: E402
import inter_writer as W  # noqa: E402

COUNTERS = A.TOOL_NAMES[A.TOOL_NAMES.index("interintra"):]


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
    box, img, alpha = A.decode_avif(data)
    av1 = A.parse_av1(box.color.payload)
    assert [[f.spatial_id, f.frame.frame_type] for f in av1.frames] == \
        entry["frames"]
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
    for k in MK.PER_FRAME:
        assert [t[k] for t in img.frame_tools] == entry[k], k
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


@pytest.mark.parametrize("name", ["ii_mono_10bit.avif",
                                  "seg_keep_420_12bit.avif"])
def test_fixture_regenerates(name):
    assert MK.written(name)[0] == (FIXTURES / name).read_bytes()


@pytest.mark.parametrize("tool", COUNTERS)
def test_each_counter_occurs(tool):
    assert sum(e["tools"][tool] for e in MANIFEST.values()) > 0


def _frames(name):
    return A.parse_av1(A.read_container(
        (FIXTURES / name).read_bytes()).color.payload).frames


def test_fixtures_cover_the_set():
    """Every interintra_mode smooth and by wedge at 8x8, 16x16 and 32x32;
    GLOBALMV inter-intra blocks warped on a ROTZOOM reference; OBMC and
    local warps beside inter-intra blocks; inter-intra on a scaled
    reference and under 128-pixel superblocks; a chained frame on the
    adapted CDFs of a frame with inter-intra; the map kept, the map coded
    against the previous one in several tiles (predicted and coded ids,
    ids before skip), a kept map of another size than its primary
    reference's (zeros), libaom's own temporal update; every subsampling
    at 8, 10 and 12 bits; the mixed class and the 3840x2160 frame with
    both tools."""
    M = MANIFEST
    for name, e in M.items():
        if name.startswith("ii_"):
            assert e["interintra"][-1] > 0, name
            assert e["written"]["leaves"] and set(
                e["written"]["leaves"]) & {1, 2, 3}, name
    assert all(sum(M[n]["tools"][k] for n in M) > 0
               for k in ("ii_dc", "ii_v", "ii_h", "ii_smooth"))
    assert M["ii_global_rotzoom_420.avif"]["tools"]["global_warp"] > 0
    motion = M["ii_obmc_444.avif"]["tools"]
    assert motion["obmc"] and motion["local_warp"] and motion["interintra"]
    scaled = M["ii_scaled_420.avif"]
    assert scaled["sizes"][0][1] * 2 == scaled["sizes"][-1][1]
    assert scaled["tools"]["scaled_pred"] and scaled["tools"]["interintra"]
    assert _frames("ii_sb128_422.avif")[0].seq.sb128
    first, second = _frames("chain_ii_cdf_420_10bit.avif")[1:]
    prim = second.frame.primary_ref_frame
    assert prim != 7 and first.frame.refresh_frame_flags >> \
        second.frame.ref_frame_idx[prim] & 1
    assert not first.frame.disable_frame_end_update_cdf
    assert all(v > 0 for v in M["chain_ii_cdf_420_10bit.avif"][
        "interintra"][1:])
    keep = M["seg_keep_420_12bit.avif"]
    assert keep["seg_map_kept"] == [0, 0, 1] and keep["sizes"][1] == \
        keep["sizes"][2]
    assert keep["tools"]["seg_preskip"] and keep["tools"]["seg_skip"]
    tiles = M["seg_temporal_tiles_444_10bit.avif"]
    assert tiles["seg_temporal"] == [0, 0, 1]
    assert tiles["seg_id_predicted"][-1] > 0 and tiles["tools"][
        "segmentation"] > tiles["tools"]["seg_preskip"] // 2
    last = _frames("seg_temporal_tiles_444_10bit.avif")[-1].frame
    assert len(last.tile_row_starts) - 1 == 4
    resized = M["seg_resized_422.avif"]
    assert resized["seg_map_kept"][-1] and resized["sizes"][1] != \
        resized["sizes"][2]
    aq = M["aq_temporal_420.avif"]
    assert "inter_writer" not in aq["written"]["writer"]
    assert 1 in aq["seg_temporal"]
    assert len(_frames("aq_temporal_420.avif")[aq["seg_temporal"].index(
        1)].frame.tile_col_starts) - 1 == 2
    both = [n for n, e in M.items() if e["interintra"][-1] and
            e["seg_temporal"][-1]]
    assert {"class_mixed_512.avif", "photo4k_420.avif"} <= set(both)
    cells = {(e["written"]["depth"], "mono" if e["written"].get("mono")
              else e["written"]["ss"]) for e in M.values()}
    assert cells >= {(d, s) for d in (8, 10, 12)
                     for s in ("4:2:0", "4:4:4")} | {
        (8, "4:2:2"), (10, "4:2:2"), (10, "mono")}
    photo = M["photo4k_420.avif"]
    assert photo["load_shape"] == [2160, 3840, 3]
    assert photo["bytes"] < 400_000
    assert M["class_mixed_512.avif"]["load_shape"] == [512, 512, 3]
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 400_000
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == sorted(M)


@pytest.mark.parametrize("table", ["interintra_mode", "wedge_interintra",
                                   "segment_id_predicted", "ii_weights"])
def test_new_tables_are_libaom(table):
    """Each new table the reader carries (``av1_tool_tables.npz``) against
    the system libaom, read live, and the CDFs in the reader's pack."""
    data = X.section(X.LIBAOM)
    live = {"interintra_mode": lambda: X.interintra_cdfs(
                data, X.section(X.LIBAOM, ".text"))["interintra_mode"],
            "wedge_interintra": lambda: X.interintra_cdfs(
                data, X.section(X.LIBAOM, ".text"))["wedge_interintra"],
            "segment_id_predicted": lambda: X.segment_id_predicted_cdf(data),
            "ii_weights": lambda: X.ii_weights(data)}[table]()
    np.testing.assert_array_equal(A._tool_tables()[table], live)
    if table != "ii_weights":
        pack = A._reader_cdfs()[table]
        np.testing.assert_array_equal(pack[:, :live.shape[1]], live)


def test_segment_id_symbol_reads_back():
    """The writer's neg_interleave against the spec's neg_deinterleave (the
    decoder's, here in Python as avif.py's header reader has none), for
    every id, prediction and count of segments."""
    def deinterleave(diff, ref, n):
        if not ref:
            return diff
        if ref >= n - 1:
            return n - diff - 1
        if 2 * ref < n:
            if diff <= 2 * ref:
                return ref + ((diff + 1) >> 1) if diff & 1 else \
                    ref - (diff >> 1)
            return diff
        if diff <= 2 * (n - ref - 1):
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return n - (diff + 1)

    for n in range(1, 9):
        for ref in range(n):
            syms = [W.neg_interleave(x, ref, n) for x in range(n)]
            assert sorted(syms) == list(range(n))
            assert [deinterleave(s, ref, n) for s in syms] == list(range(n))


def test_interintra_time_leaves_the_decode_alone():
    """``decode_avif``'s times take inter-intra's intra predictions and
    blends in the frames with inter-intra blocks (both written frames of
    the chained file) and in no other, without changing a sample."""
    data = (FIXTURES / "chain_ii_cdf_420_10bit.avif").read_bytes()
    want = A.decode_avif(data)[1].planes
    times = {}
    got = A.decode_avif(data, times)[1].planes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i in (1, 2):
        assert 0 < times[f"ii_f{i}"] < times[f"tiles_f{i}"]
    assert "ii_f0" not in times


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_interintra_avif_matches_reference_and_pam(tmp_path, capsys):
    """``-t 80`` on the 512x512 mixed class whose frames hold inter-intra
    blocks and a map coded against the previous one."""
    args = ["-t", "80"]
    src = FIXTURES / "class_mixed_512.avif"
    _, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found is not None and found == ref_found
    pam = tmp_path / "px.pam"
    write_pam(pam, load_avif(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)
