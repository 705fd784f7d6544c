"""The port's AVIF reader on intra block copy (intrabc), which libaom
writes into screen content at its default options (the fixtures of
``tests/torch_fixtures/avif_screen``, from ``make_avif_screen.py``), on
the CPU and with no tolerance:

- every stream decodes to dav1d's Y'UV planes (their CRC in the
  manifest): Pillow's 8-bit files in 4:4:4, 4:2:2 and 4:2:0 at speeds 2-7
  and qualities 30-100 (100 codes the frame lossless), with alpha, two
  tiles, 128-pixel superblocks and the reduced transform set, 512x512 and
  3840x2160 frames, and the system libavif's 10- and 12-bit files;
- ``load_avif`` and ``decode_avif_to_rgb8`` give the reference's pixels,
  shape and ``hbd`` flag, held live to the reference and to the manifest;
- the decoder counts each intrabc tool in some fixture; the ``grid`` file
  (two 128x128 cells, too small for libaom's intrabc), refused until the
  reader learned grids, decodes like the others;
- files the tests write themselves at the smallest sizes libaom codes
  with intrabc (it writes none at 96x96 or 128x128) equal the
  reference's pixels.
"""

from __future__ import annotations

import io
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from oavif_tpu.io.image import decode_avif_to_rgb8 as ref_rgb8  # noqa: E402
from oavif_tpu.io.image import load_avif as ref_load_avif  # noqa: E402
from oavif_tpu_torch.io import avif as A  # noqa: E402
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "avif_screen"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
NEW_TOOLS = ("intrabc", "intrabc_default_dv", "intrabc_chroma_subpel",
             "vartx_split", "tx_inter_set1", "tx_inter_set2",
             "tx_inter_set3", "tx_flip", "intrabc_sub8x8_chroma")

sys.path.insert(0, str(FIXTURES))
from make_avif_screen import screen  # noqa: E402


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _yuv_crc(planes) -> int:
    return _crc(np.concatenate([p.astype("<u2").reshape(-1)
                                for p in planes if p is not None]))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_to_its_manifest(name):
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
    if "refuses" in entry:
        with pytest.raises(A.UnsupportedAvif, match=entry["refuses"]):
            load_avif(str(path))
        with pytest.raises(A.UnsupportedAvif, match=entry["refuses"]):
            decode_avif_to_rgb8(data)
        return
    box, img, alpha = A.decode_avif(data)
    assert [p.shape for p in img.planes] == [p.shape for p in planes]
    assert _yuv_crc(img.planes) == entry["yuv_crc"]
    assert img.tools == entry["tools"]
    assert (alpha.tools["intrabc"] if alpha else None) == \
        entry["alpha_intrabc"]
    av1 = A.parse_av1(box.color.payload)
    assert [av1.frame.lossless, av1.seq.sb128,
            [len(av1.frame.tile_col_starts) - 1,
             len(av1.frame.tile_row_starts) - 1]] == [
        entry["lossless"], entry["sb128"], entry["tiles"]]
    got = load_avif(str(path))
    assert (got.data.dtype, got.hbd, got.channels) == (ref.data.dtype,
                                                        ref.hbd,
                                                        ref.channels)
    np.testing.assert_array_equal(got.data, ref.data)
    assert _crc(decode_avif_to_rgb8(data)) == entry["rgb8_crc"]


@pytest.mark.parametrize("tool", NEW_TOOLS)
def test_each_intrabc_tool_occurs_in_a_fixture(tool):
    assert sum(e.get("tools", {}).get(tool, 0)
               for e in MANIFEST.values()) > 0


def test_fixtures_cover_the_writers_settings():
    """Each file codes intrabc, and the files span the settings the
    folder promises."""
    coded = {n: e for n, e in MANIFEST.items() if "tools" in e}
    assert all(e["tools"]["intrabc"] > 0 for e in coded.values()
               if "grid" not in e["written"])
    pillow = [e["written"] for e in coded.values()
              if e["written"]["writer"].startswith("Pillow")]
    assert {w["subsampling"] for w in pillow} == {"4:4:4", "4:2:2", "4:2:0"}
    assert {w["speed"] for w in pillow} >= {2, 4, 6, 7}
    assert {w["quality"] for w in pillow} >= {30, 60, 90, 100}
    assert all(e["lossless"] == (e["written"].get("quality") == 100)
               for e in coded.values())
    assert any(e["alpha_intrabc"] for e in coded.values())
    assert [2, 1] in [e["tiles"] for e in coded.values()]
    assert any(e["sb128"] and e["written"].get("sb-size") == "128"
               for e in coded.values())
    assert any(e["written"].get("reduced-tx-type-set") == "1"
               for e in coded.values())
    deep = {(e["depth"], e["written"]["subsampling"])
            for e in coded.values() if e["depth"] > 8}
    assert deep == {(d, ss) for d in (10, 12) for ss in ("4:4:4", "4:2:0")}
    sizes = {tuple(w["size"]) for w in pillow}
    assert {(512, 512), (2160, 3840)} <= sizes
    big = coded["screen4k.avif"]
    assert big["tiles"] != [1, 1] and big["written"].keys() == {
        "writer", "size", "speed", "quality", "subsampling"}
    assert not [e for e in MANIFEST.values() if "refuses" in e]
    grid = coded["grid2x1_420.avif"]
    assert (grid["load_crc"], grid["rgb8_crc"], grid["yuv_crc"]) == (
        2263136336, 2263136336, 1715138384)


def test_fixtures_fit_their_budget():
    files = [p for p in FIXTURES.iterdir() if p.suffix == ".avif"]
    assert sorted(p.name for p in files) == sorted(MANIFEST)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 1_000_000


@pytest.mark.parametrize("h,w,ss,seed", [(128, 256, "4:2:0", 1),
                                         (128, 256, "4:4:4", 2),
                                         (64, 512, "4:2:2", 3),
                                         (192, 192, "4:2:0", 1)])
def test_live_screen_equals_reference(h, w, ss, seed, tmp_path):
    """Screens Pillow writes here at its defaults, at the smallest sizes
    libaom codes with intrabc."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(screen(h, w, seed=seed)).save(
        buf, "AVIF", max_threads=1, subsampling=ss)
    data = buf.getvalue()
    assert A.decode_avif(data)[1].tools["intrabc"] > 0
    path = tmp_path / "x.avif"
    path.write_bytes(data)
    ref, got = ref_load_avif(str(path)), load_avif(str(path))
    assert (got.data.dtype, got.hbd) == (ref.data.dtype, ref.hbd)
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(decode_avif_to_rgb8(data), ref_rgb8(data))
    planes, _, _ = decode_to_yuv(data)
    assert _yuv_crc(A.decode_avif(data)[1].planes) == _yuv_crc(planes)
