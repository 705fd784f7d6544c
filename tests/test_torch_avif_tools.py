"""The port's AVIF reader on the AV1 tools and AVIF properties libaom and
libavif write on request (the fixtures of ``tests/torch_fixtures/
avif_tools``, from ``make_avif_tools.py``), on the CPU and with no
tolerance:

- every stream decodes to dav1d's Y'UV planes (their CRC in the
  manifest): quantizer matrices (``enable-qm``, ``tune=iq``), delta q and
  delta LF, film grain (libaom's test vectors and estimated grain, 8 and
  10 bits), 12-bit 4:2:0, 4:2:2 and 4:4:4, and the chroma palette;
- ``load_avif`` and ``decode_avif_to_rgb8`` give the reference's pixels,
  shape and ``hbd`` flag, held live to the reference and to the manifest;
  that covers limited-range Y'UV and the ``irot``, ``imir`` and ``clap``
  properties, whose pixels the reference returns as coded;
- files the tests write themselves, held live to the reference: every
  EXIF orientation in each subsampling, centred and off-centre clean
  apertures, limited range at 8 and 10 bits with and without alpha, and
  lossless limited-range streams on every matrix libavif converts;
- the decoder meets each new tool it counts as often as the manifest
  says, and each in at least one fixture; the intrabc file, once
  refused, decodes (``test_torch_avif_intrabc.py`` holds intrabc itself).
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

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "avif_tools"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
NEW_TOOLS = ("qm", "delta_q", "delta_lf", "film_grain", "uv_palette",
             "twelve_bit")

sys.path.insert(0, str(FIXTURES))
from make_avif_tools import _box, add_property, libavif_encode  # noqa: E402


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


@pytest.mark.parametrize("tool", NEW_TOOLS)
def test_each_new_tool_occurs_in_a_fixture(tool):
    assert sum(e.get("tools", {}).get(tool, 0)
               for e in MANIFEST.values()) > 0


def test_fixtures_cover_the_repairs_and_bit_depths():
    written = [e["written"] for e in MANIFEST.values()]
    assert {w["orientation"] for w in written if "orientation" in w} == \
        set(range(2, 9))
    assert {w["clap"] for w in written if "clap" in w} == {"centred",
                                                          "offset"}
    limited = {(w.get("depth", 8), "rgba" in n) for n, w in
               zip(MANIFEST, written) if n.startswith("limited")}
    assert limited == {(8, False), (8, True), (10, False), (10, True)}
    twelve = {w["subsampling"] for w in written if w.get("depth") == 12}
    assert twelve == {"4:2:0", "4:2:2", "4:4:4"}
    grain = {e["depth"] for e in MANIFEST.values()
             if e.get("tools", {}).get("film_grain")}
    assert grain == {8, 10, 12}
    assert [e["refuses"] for e in MANIFEST.values() if "refuses" in e] == []
    assert MANIFEST["refuse_intrabc_444_edges.avif"]["tools"]["intrabc"] > 0


def test_fixtures_fit_their_budget():
    files = [p for p in FIXTURES.iterdir() if p.suffix == ".avif"]
    assert sorted(p.name for p in files) == sorted(MANIFEST)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 1_000_000


# ---------------------------------------------------------------------------
# files written here, held live to the reference
# ---------------------------------------------------------------------------


def _pillow(px, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(px, "RGBA" if px.shape[2] == 4 else "RGB").save(
        buf, "AVIF", max_threads=1, **kw)
    return buf.getvalue()


def _src(h, w, seed=0, alpha=False):
    from oavif_tpu_torch.scripts.corpus import bench_images

    px = bench_images(128, ("mixed",))["mixed"][:h, :w]
    if alpha:
        yy, xx = np.mgrid[0:h, 0:w]
        a = ((xx * 3 + yy * 5 + seed) % 256).astype(np.uint8)
        px = np.concatenate([px, a[..., None]], -1)
    return np.ascontiguousarray(px)


def _same_as_reference(data: bytes, tmp_path):
    path = tmp_path / "x.avif"
    path.write_bytes(data)
    ref, got = ref_load_avif(str(path)), load_avif(str(path))
    assert (got.data.dtype, got.hbd, got.channels) == (ref.data.dtype,
                                                        ref.hbd, ref.channels)
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(decode_avif_to_rgb8(data), ref_rgb8(data))


@pytest.mark.parametrize("ss", ("4:2:0", "4:2:2", "4:4:4"))
@pytest.mark.parametrize("orientation", range(2, 9))
def test_orientation_gives_the_pixels_as_coded(orientation, ss, tmp_path):
    """Pillow writes EXIF orientations 2-8 as ``irot`` (90, 180, 270) and
    ``imir`` (either axis); the reference returns the coded pixels."""
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = orientation
    data = _pillow(_src(72, 88), subsampling=ss, quality=70,
                   exif=exif.tobytes())
    item = A.read_container(data).color
    assert (item.irot, item.imir) != (0, None)
    _same_as_reference(data, tmp_path)


@pytest.mark.parametrize("fields", ((88, 1, 72, 1, 0, 1, 0, 1),
                                    (40, 1, 32, 1, 2 ** 32 - 12, 1, 8, 2),
                                    (60, 2, 50, 2, 7, 1, 0, 1)),
                         ids=("centred", "offset", "halves"))
def test_clean_aperture_gives_the_pixels_as_coded(fields, tmp_path):
    import struct

    data = add_property(_pillow(_src(72, 88), quality=70),
                        _box(b"clap", struct.pack(">8I", *fields)),
                        essential=True)
    assert A.read_container(data).color.clap == fields
    _same_as_reference(data, tmp_path)


@pytest.mark.parametrize("alpha", (False, True), ids=("rgb", "rgba"))
@pytest.mark.parametrize("ss", ("4:2:0", "4:2:2", "4:4:4"))
def test_limited_range_8bit_equals_reference(ss, alpha, tmp_path):
    data = _pillow(_src(64, 80, alpha=alpha), subsampling=ss, quality=70,
                   range="limited")
    assert not A.decode_avif(data)[1].full_range
    _same_as_reference(data, tmp_path)


@pytest.mark.parametrize("alpha", (False, True), ids=("rgb", "rgba"))
@pytest.mark.parametrize("ss", ("4:2:0", "4:4:4"))
@pytest.mark.parametrize("mc", (1, 6, 9))
def test_limited_range_10bit_equals_reference(mc, ss, alpha, tmp_path):
    data = libavif_encode(_src(56, 72, seed=mc, alpha=alpha), 10, ss, 20,
                          cicp=(1, 13, mc), full=False)
    _same_as_reference(data, tmp_path)


def _lossless(planes, bd, cicp, full, alpha=None):
    """A lossless 4:4:4 AVIF of the given Y'UV planes through the port's
    frame coder, marked with the CICP and range."""
    from oavif_tpu_torch.av1.frame import encode_frame_planes
    from oavif_tpu_torch.av1.mux import mux_avif
    from oavif_tpu_torch.av1.obu import (FrameConfig, SequenceConfig,
                                         assemble_av1_stream)

    h, w = planes[0].shape

    def stream(pl, **kw):
        payloads, _, _ = encode_frame_planes(
            [np.ascontiguousarray(p, np.int32) for p in pl], 0, bitdepth=bd)
        seq = SequenceConfig(width=w, height=h, bit_depth=bd, **kw)
        return assemble_av1_stream(seq, FrameConfig(width=w, height=h,
                                                    base_q_idx=0), payloads)

    av1 = stream(planes, color_primaries=cicp[0],
                 transfer_characteristics=cicp[1],
                 matrix_coefficients=cicp[2], color_range=int(full))
    ap = None if alpha is None else stream([alpha], monochrome=True,
                                           seq_profile=0)
    return mux_avif(av1, w, h, bit_depth=bd, high_bitdepth=bd > 8,
                    cicp=cicp, alpha_payload=ap, full_range=full)


MATRICES = ([(2, mc) for mc in (0, 1, 2, 4, 5, 6, 7, 9)]
            + [(cp, 12) for cp in (1, 4, 5, 9, 10)])


@pytest.mark.parametrize("alpha", (False, True), ids=("rgb", "rgba"))
@pytest.mark.parametrize("bd", (8, 10))
@pytest.mark.parametrize("cp,mc", MATRICES)
def test_limited_range_conversion_equals_pillow(cp, mc, bd, alpha):
    """libyuv's limited-range constants (matrices 1, 2, 5, 6, 9 and 12 by
    primaries) and libavif's float path with its range scaling (the
    rest), on lossless streams of random Y'UV."""
    rng = np.random.default_rng(mc * 31 + cp + bd)
    planes = [rng.integers(0, 1 << bd, (40, 48)) for _ in range(3)]
    a = (np.arange(40 * 48).reshape(40, 48) * 7) % (1 << bd) \
        if alpha else None
    data = _lossless(planes, bd, (cp, 2, mc), False, a)
    np.testing.assert_array_equal(decode_avif_to_rgb8(data), ref_rgb8(data))


def test_limited_range_ycgco_is_refused_like_the_reference():
    rng = np.random.default_rng(8)
    data = _lossless([rng.integers(0, 256, (16, 16)) for _ in range(3)], 8,
                     (2, 2, 8), False)
    with pytest.raises(ValueError, match="limited range"):
        decode_avif_to_rgb8(data)
    with pytest.raises(Exception):
        ref_rgb8(data)


@pytest.mark.parametrize("ss", ("4:2:0", "4:2:2", "4:4:4"))
def test_12bit_conversion_equals_reference(ss, tmp_path):
    """libavif 1.3's conversion of 12-bit Y'UV to 8-bit RGB and RGBA,
    and ``load_avif``'s 16-bit route where the reference takes it, on
    near-lossless streams of the system libavif. (72 columns: at 64 or
    fewer the reference's ``decode_to_yuv`` reads each subsampled chroma
    plane as if it were full size, past its end in dav1d's picture
    buffer, and its 16-bit route stacks those rows; the port cannot
    reproduce memory past a plane and takes the 8-bit route there.)"""
    for alpha in (False, True):
        data = libavif_encode(_src(48, 72, seed=int(ss[-1]), alpha=alpha),
                              12, ss, 2)
        assert A.decode_avif(data)[1].bit_depth == 12
        _same_as_reference(data, tmp_path)


def test_grain_pack_matches_the_c_enum():
    """``avif._GRAIN_FIELDS`` lays out the film grain pack as
    ``io/av1_header.h``'s G_* enum does: each field at its offset."""
    import re

    text = (Path(A.__file__).parent / "av1_header.h").read_text()
    body = text[text.index("G_SEED"):text.index("G_NFIELDS") + 9]
    offsets, at = {}, 0
    for name, expr in re.findall(r"\bG_([A-Z_]+)(?:\s*=\s*([A-Z_]+ \+ \d+))?",
                                 body):
        if expr:
            base, n = expr.split(" + ")
            at = offsets[base[2:]] + int(n)
        offsets[name] = at
        at += 1
    want, at = {}, 0
    for name, n in A._GRAIN_FIELDS:
        want[name.upper()] = at
        at += n
    want["NFIELDS"] = at
    assert offsets == want
