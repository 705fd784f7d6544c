"""The port's AVIF reader on AV1 superres and non-uniform tile spacing
(the fixtures of ``tests/torch_fixtures/avif_superres``, which libaom
3.6.0 writes through ctypes in ``make_avif_superres.py``), on the CPU and
with no tolerance:

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1), plane
  by plane, and ``load_avif`` and ``decode_avif_to_rgb8`` give the
  reference's pixels, shape and ``hbd`` flag, held live to the reference
  and to the manifest: superres denominators 9, 12 and 16 on 4:2:0, 4:2:2
  and 4:4:4 at 8, 10 and 12 bits, loop restoration on the upscaled frame
  with CDEF on and off, two tile columns, an odd coded width, alpha (also
  coded in the limited range, which the reference widens to the full
  range as it decodes), film grain, non-uniform tiles in both directions
  with and without superres, and a 3840x2160 frame;
- the upscale filter the reader carries is libaom's
  ``av1_resize_filter_normative`` and dav1d's ``dav1d_resize_filter``,
  read live from the system libraries;
- the CLI ``-t 80`` on a 512x512 superres AVIF gives the q, passes and
  bytes of the CLI on its pixels written as PAM.
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
from oavif_tpu.io.image import decode_avif_to_rgb8 as ref_rgb8  # noqa: E402
from oavif_tpu.io.image import load_avif as ref_load_avif  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.io import avif as A  # noqa: E402
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)
from oavif_tpu_torch.scripts import extract_av1_tool_tables as X  # noqa: E402

FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_superres"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())

sys.path.insert(0, str(FIXTURES))
import make_avif_superres as MK  # noqa: E402


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
    entry = MANIFEST[name]
    path = FIXTURES / name
    data = path.read_bytes()
    assert len(data) == entry["bytes"]
    assert MK.header(data) == entry["header"]
    planes, depth, _ = decode_to_yuv(data)
    assert (_yuv_crc(planes), depth) == (entry["yuv_crc"], entry["depth"])
    ref = ref_load_avif(str(path))
    assert [list(ref.data.shape), ref.hbd, _crc(ref.data),
            len(ref.icc or b"")] == [entry["load_shape"], entry["load_hbd"],
                                     entry["load_crc"], entry["icc"]]
    assert _crc(ref_rgb8(data)) == entry["rgb8_crc"]
    times = {}
    _, img, alpha = A.decode_avif(data, times)
    want = [p for p in planes if p is not None]
    assert len(img.planes) == len(want)
    for i, (got, p) in enumerate(zip(img.planes, want)):
        assert got.shape == p.shape, i
        np.testing.assert_array_equal(got, p.astype(np.int32),
                                      err_msg=f"plane {i}")
    assert img.tools == entry["tools"]
    assert (alpha.tools if alpha else None) == entry["alpha_tools"]
    upscaled = entry["header"]["superres_denom"] != 8
    assert img.tools["superres"] == (len(want) if upscaled else 0)
    assert (times["upscale"] > 0) == upscaled
    got = load_avif(str(path))
    assert (got.data.dtype, got.hbd, got.channels) == (ref.data.dtype,
                                                        ref.hbd,
                                                        ref.channels)
    np.testing.assert_array_equal(got.data, ref.data)
    assert got.icc == ref.icc
    assert _crc(decode_avif_to_rgb8(data)) == entry["rgb8_crc"]


def test_fixtures_cover_superres_and_tiles():
    """The files span what the folder promises."""
    e = {n: (x["header"], x["written"], x) for n, x in MANIFEST.items()}
    sr = {n: v for n, v in e.items() if v[0]["superres_denom"] != 8}
    assert {(h["superres_denom"], w["ss"], w["depth"])
            for h, w, _ in sr.values()} >= {
        (9, "4:2:0", 8), (9, "4:2:2", 10), (9, "4:4:4", 12),
        (12, "4:2:0", 10), (12, "4:2:2", 12), (12, "4:4:4", 8),
        (16, "4:2:0", 12), (16, "4:2:2", 8), (16, "4:4:4", 10)}
    # every plane restored somewhere under superres, with CDEF on and off
    for p in range(3):
        assert any(h["lr_types"][p] for h, _, _ in sr.values())
    assert any(any(h["lr_types"]) and any(map(any, h["cdef_strengths"]))
               for h, _, _ in sr.values())
    assert any(any(h["lr_types"]) and not h["cdef_strengths"]
               for h, _, _ in sr.values())
    assert any(len(h["tile_col_starts"]) == 3 for h, _, _ in sr.values())
    assert any(h["coded_width"] % 2 for h, _, _ in sr.values())
    assert any(x["alpha_tools"] and x["alpha_tools"]["superres"]
               for _, _, x in sr.values())
    # alpha coded in the limited range, with superres and without it
    limited = {n for n, (_, w, _) in e.items()
               if w.get("alpha_range") == "limited"}
    assert {e[n][0]["superres_denom"] == 8 for n in limited} == {True, False}
    assert any(h["grain"] and x["tools"]["film_grain"]
               for h, _, x in sr.values())
    # non-uniform: tiles of two or three sizes in both directions
    uneven = {n for n, (h, _, _) in e.items()
              if len(set(np.diff(h["tile_col_starts"]))) > 1
              and len(set(np.diff(h["tile_row_starts"]))) > 1}
    assert any(e[n][0]["superres_denom"] != 8 for n in uneven)
    assert any(e[n][0]["superres_denom"] == 8 for n in uneven)
    h4k = e["photo4k_d16_420.avif"][0]
    assert (h4k["width"], h4k["height"], h4k["coded_width"],
            h4k["superres_denom"]) == (3840, 2160, 1920, 16)
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 1_000_000
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == \
        sorted(MANIFEST)


def test_upscale_filter_is_libaom_and_dav1d():
    """The table the reader carries (``av1_tool_tables.npz``) against the
    system libraries, read live: libaom's int16 rows, and dav1d's, which
    stores each tap negated as int8."""
    table = A._tool_tables()["upscale_filter"]
    assert table.shape == (64, 8) and table.dtype == np.int16
    aom = X.upscale_filter(X.section(X.LIBAOM))
    np.testing.assert_array_equal(table, aom)
    dav1d = X.section(str(Path(X.LIBAOM).with_name("libdav1d.so.6")))
    neg = (-table.astype(np.int32)).astype(np.int8).tobytes()
    assert dav1d.count(neg) == 1


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_superres_avif_matches_pam(tmp_path, capsys):
    """``-t 80`` on the 512x512 class coded at denominator 12: the q,
    passes and bytes of the CLI on its pixels as PAM."""
    src = FIXTURES / "class_mixed_d12_420.avif"
    args = ["-t", "80"]
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found is not None and got[4:12] == b"ftypavif"
    pam = tmp_path / "mixed.pam"
    write_pam(pam, load_avif(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)
