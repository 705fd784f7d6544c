"""The port's AVIF reader on AVIF as libaom writes it (the fixtures of
``tests/torch_fixtures/avif_aom``, written by Pillow's libavif 1.3 and by
the system's libavif 0.11.1, both with libaom), on the CPU and with no
tolerance:

- every stream decodes to dav1d's Y'UV planes (their CRC in the
  manifest), each plane at its own size: 4:2:0, 4:2:2 and 4:4:4 at every
  speed and quality of the grid, CDEF strengths per 64x64, 10-bit;
- ``load_avif`` gives the reference's pixels, shape and ``hbd`` flag, and
  ``decode_avif_to_rgb8`` the reference's RGB (libavif's conversion with
  libyuv's bilinear chroma upsampling), both held live to the reference
  and to the manifest;
- the decoder meets each tool it counts as often as the manifest says,
  and every tool in at least one fixture (the tools libaom writes only on
  request, in ``tests/torch_fixtures/avif_tools``, and intrabc, in
  ``tests/torch_fixtures/avif_screen``);
- the 12-bit stream decodes (it was refused, naming 12-bit, before the
  decoder learned 12-bit).
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

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "avif_aom"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())


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
    _, img, _ = A.decode_avif(data)
    assert [p.shape for p in img.planes] == [p.shape for p in planes]
    assert _yuv_crc(img.planes) == entry["yuv_crc"]
    assert img.tools == entry["tools"]
    got = load_avif(str(path))
    assert (got.data.dtype, got.hbd, got.channels) == (ref.data.dtype,
                                                        ref.hbd,
                                                        ref.channels)
    np.testing.assert_array_equal(got.data, ref.data)
    assert got.icc == ref.icc
    assert _crc(decode_avif_to_rgb8(data)) == entry["rgb8_crc"]


TOOLS_MADE = {**json.loads((FIXTURES.parent / "avif_tools"
                            / "manifest.json").read_text()),
              **json.loads((FIXTURES.parent / "avif_screen"
                            / "manifest.json").read_text()),
              **json.loads((FIXTURES.parent / "avif_container"
                            / "manifest.json").read_text()),
              **json.loads((FIXTURES.parent / "avif_superres"
                            / "manifest.json").read_text()),
              # written symbol by symbol: what libaom never puts into a
              # key frame (a skipped block's predicted segment id, ids
              # read before skip, ALT_LF, SKIP, delta_lf_multi)
              **json.loads((FIXTURES.parent / "avif_lf_seg"
                            / "manifest.json").read_text()),
              # inter frames: libaom's realtime layers, and layer 1 written
              # symbol by symbol for the filters, dual filters, 4x4 inter
              # blocks and mode deltas libaom does not write
              **json.loads((FIXTURES.parent / "avif_layers"
                            / "manifest.json").read_text()),
              # progressive: a later layer predicted from a smaller one,
              # and superres inter frames
              **json.loads((FIXTURES.parent / "avif_progressive"
                            / "manifest.json").read_text()),
              # OBMC and local warps, libaom's and written ones that fall
              # back to translation
              **{f"avif_warp/{n}": e for n, e in json.loads(
                  (FIXTURES.parent / "avif_warp" / "manifest.json")
                  .read_text()).items()},
              # motion field estimation and temporal MV candidates: four
              # layers with use_ref_frame_mvs
              **{f"avif_refmvs/{n}": e for n, e in json.loads(
                  (FIXTURES.parent / "avif_refmvs" / "manifest.json")
                  .read_text()).items()},
              # compound blocks: libaom's four layers from 1280x720 and
              # written frames in every compound mode and type
              **{f"avif_compound/{n}": e for n, e in json.loads(
                  (FIXTURES.parent / "avif_compound" / "manifest.json")
                  .read_text()).items()},
              # global motion of every type and skip_mode: written frames
              # over libaom's layers
              **{f"avif_globalmv/{n}": e for n, e in json.loads(
                  (FIXTURES.parent / "avif_globalmv" / "manifest.json")
                  .read_text()).items()},
              # inter-intra and segmentation map prediction: libaom's
              # cyclic refresh layers and written frames over libaom's
              **{f"avif_interintra/{n}": e for n, e in json.loads(
                  (FIXTURES.parent / "avif_interintra" / "manifest.json")
                  .read_text()).items()}}


@pytest.mark.parametrize("tool", A.TOOL_NAMES)
def test_each_ported_tool_occurs_in_a_fixture(tool):
    assert sum(e.get("tools", {}).get(tool, 0)
               for e in [*MANIFEST.values(), *TOOLS_MADE.values()]) > 0


def test_grid_covers_every_subsampling_speed_and_quality():
    written = [e["written"] for e in MANIFEST.values()]
    cells = {(w.get("subsampling", "4:2:0"), w.get("speed", 6),
              w.get("quality")) for w in written}
    for ss in ("4:2:0", "4:2:2", "4:4:4"):
        for speed in (0, 2, 4, 6, 8, 10):
            for q in (30, 60, 95):
                assert (ss, speed, q) in cells
    assert {w["depth"] for w in written if "depth" in w} == {10, 12}


def test_float_path_upsampling_equals_pillow():
    """The matrices libavif converts itself (4, 7, 8 and 12 under
    primaries 4) with subsampled chroma, at 8 and 10 bits and odd sizes:
    libavif's own bilinear weights, against Pillow, on streams the
    system libavif writes."""
    from PIL import Image

    sys.path.insert(0, str(FIXTURES))
    from make_avif_aom import libavif_encode
    from oavif_tpu_torch.scripts.corpus import bench_images

    src = bench_images(256, ("fractal",))["fractal"][:33, :47]
    for cp, mc in ((1, 4), (1, 7), (1, 8), (4, 12)):
        for ss in ("4:2:0", "4:2:2"):
            for depth in (8, 10):
                data = libavif_encode(src, depth, ss, 20, cicp=(cp, 13, mc))
                pil = Image.open(io.BytesIO(data)).convert("RGB")
                np.testing.assert_array_equal(A.decode_avif_rgb8(data),
                                              np.asarray(pil))


def test_header_pack_and_counters_match_the_c_enums():
    """``avif._HDR_FIELDS`` and ``avif.TOOL_NAMES`` name the C enums of
    ``io/av1_header.h`` in their order (the strength sets fill the tail
    of the header pack)."""
    import re

    text = (Path(A.__file__).parent / "av1_header.h").read_text()
    h = re.findall(r"\bH_([A-Z0-9_]+)\b", text)
    t = re.findall(r"\bT_([A-Z0-9_]+)\b", text)
    fields = [n.lower() for n in dict.fromkeys(h) if n != "NFIELDS"]
    assert fields[:-1] == list(A._HDR_FIELDS[:len(fields) - 1])
    assert fields[-1] == "cdef_strengths"
    assert len(A._HDR_FIELDS) == len(fields) - 1 + 32
    assert [n.lower() for n in t if n != "NCOUNTERS"] == list(A.TOOL_NAMES)


def test_fixtures_fit_their_budget():
    files = [p for p in FIXTURES.iterdir() if p.suffix == ".avif"]
    assert sorted(p.name for p in files) == sorted(MANIFEST)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 2_000_000
