"""The port's AVIF reader on grids, premultiplied alpha and image
sequences (the fixtures of ``tests/torch_fixtures/avif_container``, from
``make_avif_container.py``; its segmentation files are
``test_torch_avif_segmentation.py``'s), on the CPU and with no tolerance:

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1, which
  stitches a grid and takes a sequence's first frame), and ``load_avif``
  and ``decode_avif_to_rgb8`` give the reference's pixels, shape and
  ``hbd`` flag, held live to the reference (Pillow's libavif 1.3, or the
  system libavif on its 16-bit route) and to the manifest: grids in 4:2:0,
  4:2:2 and 4:4:4 at 8, 10 and 12 bits, with alpha, premultiplied, film
  grain, a cropped canvas and 3840x2160; premultiplied alpha at 8, 10 and
  12 bits; Pillow's sequences (RGB, RGBA, without ``meta``) and a 10-bit
  one;
- the reference and the port both refuse an ``iovl`` item and ``iloc``
  construction method 2, the port naming the feature, while the same
  files unedited decode in both;
- libavif 1.3's grid checks, hand-edited into written grids, raise in the
  reference and in the port; a grid's colour description comes from its
  own ``colr``, else from its first cell's sequence header, as in Pillow;
- premultiplied alpha is un-premultiplied on each of libavif 1.3's
  routes, as Pillow's RGBA: libyuv's ARGBUnattenuate after libyuv or a
  fast path, the float division on the slow path;
- a grid of 64x64 cells, a two-frame sequence and a premultiplied RGBA
  file that the tests write themselves equal the reference.
"""

from __future__ import annotations

import io
import json
import struct
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
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

FIXTURES = (Path(__file__).resolve().parent / "torch_fixtures"
            / "avif_container")
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
CONTAINER = sorted(n for n in MANIFEST if not n.startswith("seg"))

sys.path.insert(0, str(FIXTURES))
import make_avif_container as MK  # noqa: E402


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _yuv_crc(planes) -> int:
    return _crc(np.concatenate([p.astype("<u2").reshape(-1)
                                for p in planes if p is not None]))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


def check_fixture(folder: Path, name: str, entry: dict) -> None:
    """One fixture against the system libavif's Y'UV, the reference live
    and its manifest entry (shared with the segmentation tests)."""
    path = folder / name
    data = path.read_bytes()
    assert len(data) == entry["bytes"]
    if "refuses" in entry:
        with pytest.raises(Exception):
            ref_load_avif(str(path))
        with pytest.raises(Exception):
            ref_rgb8(data)
        for read in (lambda: load_avif(str(path)),
                     lambda: decode_avif_to_rgb8(data)):
            with pytest.raises(A.UnsupportedAvif) as e:
                read()
            assert entry["refuses"] in str(e.value)
        return
    planes, depth, _ = decode_to_yuv(data)
    assert (_yuv_crc(planes), depth) == (entry["yuv_crc"], entry["depth"])
    ref = ref_load_avif(str(path))
    assert [list(ref.data.shape), ref.hbd, _crc(ref.data),
            len(ref.icc or b"")] == [entry["load_shape"], entry["load_hbd"],
                                     entry["load_crc"], entry["icc"]]
    assert _crc(ref_rgb8(data)) == entry["rgb8_crc"]
    box, img, alpha = A.decode_avif(data)
    assert [p.shape for p in img.planes] == [p.shape for p in planes
                                             if p is not None]
    assert _yuv_crc(img.planes) == entry["yuv_crc"]
    assert img.tools == entry["tools"]
    assert (alpha.tools if alpha else None) == entry["alpha_tools"]
    assert [box.source, list(box.color.grid[:2]) if box.color.grid else None,
            alpha is not None, box.premultiplied] == [
        entry["source"], entry["grid"], entry["alpha"],
        entry["premultiplied"]]
    got = load_avif(str(path))
    assert (got.data.dtype, got.hbd, got.channels) == (ref.data.dtype,
                                                        ref.hbd,
                                                        ref.channels)
    np.testing.assert_array_equal(got.data, ref.data)
    assert got.icc == ref.icc
    assert _crc(decode_avif_to_rgb8(data)) == entry["rgb8_crc"]


@pytest.mark.parametrize("name", CONTAINER)
def test_fixture_decodes_to_its_manifest(name):
    check_fixture(FIXTURES, name, MANIFEST[name])


def test_fixtures_cover_the_container_features():
    """The files span what the folder promises: each grid form, ``prem``
    at every depth and subsampling, each kind of sequence."""
    e = {n: MANIFEST[n] for n in CONTAINER}
    grids = {n: x for n, x in e.items() if x.get("grid")}
    how = {n: x["written"] for n, x in grids.items()}
    assert {(tuple(x["grid"]), tuple(how[n]["cell"]), how[n]["subsampling"])
            for n, x in grids.items()} >= {((2, 2), (64, 64), "4:2:0"),
                                           ((1, 3), (64, 128), "4:2:2"),
                                           ((2, 2), (1080, 1920), "4:2:0")}
    assert any(x["load_hbd"] and how[n]["subsampling"] == "4:4:4"
               for n, x in grids.items())
    assert {x["depth"] for x in grids.values()} == {8, 10, 12}
    assert any(x["alpha"] and not x["premultiplied"] for x in grids.values())
    assert any(x["premultiplied"] for x in grids.values())
    assert any(x["tools"]["film_grain"] for x in grids.values())
    crop = e["grid3x2_420_crop.avif"]
    assert crop["load_shape"][:2] == [112, 176] != [2 * 64, 3 * 64]
    assert e["grid4k_420.avif"]["load_shape"] == [2160, 3840, 3]
    prem = {(x["depth"], x["written"]["subsampling"]) for x in e.values()
            if x.get("premultiplied") and not x.get("grid")}
    assert prem == {(d, s) for d in (8, 10, 12) for s in ("4:4:4", "4:2:0")}
    tracks = [x for x in e.values() if x.get("source") == "track"]
    assert {(x["alpha"], x["written"]["writer"].startswith("Pillow"))
            for x in tracks} == {(False, True), (True, True), (False, False)}
    assert e["seq_420_nometa.avif"]["rgb8_crc"] == \
        e["seq_420.avif"]["rgb8_crc"]
    assert e["seq_444_10bit.avif"]["load_hbd"]
    assert sorted(x["refuses"] for x in e.values() if "refuses" in x) == [
        "'iovl'", "iloc construction method 2"]


def test_fixtures_fit_their_budget():
    files = [p for p in FIXTURES.iterdir() if p.suffix == ".avif"]
    assert sorted(p.name for p in files) == sorted(MANIFEST)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 1_000_000


def test_grid2x1_of_the_screen_folder_decodes():
    """libavif 0.11.1's ``grid`` of two screens, refused until grids were
    read, gives its manifest's pixels."""
    data = (FIXTURES.parent / "avif_screen" / "grid2x1_420.avif").read_bytes()
    _, img, _ = A.decode_avif(data)
    assert (_yuv_crc(img.planes), _crc(decode_avif_to_rgb8(data))) == (
        1715138384, 2263136336)


# ---------------------------------------------------------------------------
# refusals the reference shares
# ---------------------------------------------------------------------------


def _still() -> bytes:
    buf = io.BytesIO()
    from PIL import Image

    Image.fromarray(bench_images(64, ("edges",))["edges"]).save(
        buf, "AVIF", quality=60, max_threads=1)
    return buf.getvalue()


@pytest.mark.parametrize("edit,feature", [
    (lambda d: MK._primary_type(d, b"iovl"), "'iovl'"),
    (lambda d: MK.construction_method(d, 2), "iloc construction method 2"),
], ids=["iovl", "iloc_method2"])
def test_refusals_are_shared_with_the_reference(edit, feature, tmp_path):
    """Each edit alone makes the reference raise and the port refuse,
    naming the feature: undone (``av01``, method 0), both decode alike."""
    still = _still()
    undone = edit(still).replace(b"iovlColor", b"av01Color") \
        if feature == "'iovl'" else MK.construction_method(still, 0)
    for data, refused in ((edit(still), True), (undone, False)):
        path = tmp_path / "x.avif"
        path.write_bytes(data)
        if refused:
            with pytest.raises(Exception):
                ref_load_avif(str(path))
            with pytest.raises(A.UnsupportedAvif, match=feature):
                load_avif(str(path))
        else:
            np.testing.assert_array_equal(load_avif(str(path)).data,
                                          ref_load_avif(str(path)).data)


def _grid(cells=4, cols=2, size=64, ss="4:2:0", **kw) -> bytes:
    px = bench_images(256, ("mixed",))["mixed"]
    return MK.libavif_grid([px[i * 32:i * 32 + size, i * 16:i * 16 + size]
                            for i in range(cells)], cols, 8, ss, 24, **kw)


def _edit_desc(data: bytes, rows, cols, w, h, new) -> bytes:
    old = struct.pack(">BBBBHH", 0, 0, rows - 1, cols - 1, w, h)
    assert data.count(old) == 1
    return data.replace(old, new)


# libavif 1.3's grid checks, each broken in a written 2x2 grid of 64x64
# 4:2:0 cells (128x128): the descriptor's version, its cell count, an
# output size the cells do not cover, one that leaves the last column
# outside the canvas, an odd one under 4:2:0
GRID_FAULTS = {
    "version": struct.pack(">BBBBHH", 1, 0, 1, 1, 128, 128),
    "cell_count": struct.pack(">BBBBHH", 0, 0, 2, 1, 128, 128),
    "not_covered": struct.pack(">BBBBHH", 0, 0, 1, 1, 130, 128),
    "past_canvas": struct.pack(">BBBBHH", 0, 0, 1, 1, 64, 128),
    "odd_size": struct.pack(">BBBBHH", 0, 0, 1, 1, 127, 128),
}


@pytest.mark.parametrize("fault", sorted(GRID_FAULTS))
def test_grid_faults_raise_in_both(fault, tmp_path):
    good = _grid()
    path = tmp_path / "x.avif"
    path.write_bytes(good)
    np.testing.assert_array_equal(load_avif(str(path)).data,
                                  ref_load_avif(str(path)).data)
    data = _edit_desc(good, 2, 2, 128, 128, GRID_FAULTS[fault])
    path.write_bytes(data)
    with pytest.raises(Exception):
        ref_load_avif(str(path))
    with pytest.raises(Exception):
        ref_rgb8(data)
    with pytest.raises(OSError, match="broken AVIF"):
        load_avif(str(path))


# grid2x2_420.avif's 64x64 cells under another shared ``ispe`` (the box
# whose type is at byte 435), in two cases with the grid's own ``ispe``
# (at byte 380) moved too: libavif 1.3 scales each cell to its ispe before
# the grid's checks, and then refuses ("Invalid image grid") or reads
CELL_ISPE = {
    "cells_128x128": ((128, 128), None),
    "cells_32x32": ((32, 32), None),
    "cells_64x63": ((64, 63), None),
    "cells_128x128_grid_256x256": ((128, 128), (256, 256)),
    "cells_32x32_grid_64x64": ((32, 32), (64, 64)),
    "cells_96x64": ((96, 64), None),
}


@pytest.mark.parametrize("case", sorted(CELL_ISPE))
def test_grid_cells_of_another_ispe_as_pillow(case, tmp_path):
    data = bytearray((FIXTURES / "grid2x2_420.avif").read_bytes())
    for at, size in zip((435, 380), CELL_ISPE[case]):
        assert data[at:at + 4] == b"ispe"
        if size is not None:
            data[at + 8:at + 16] = struct.pack(">II", *size)
    data = bytes(data)
    path = tmp_path / "x.avif"
    path.write_bytes(data)
    if case == "cells_96x64":
        ref = ref_load_avif(str(path))
        assert ref.data.shape == (128, 128, 3)
        np.testing.assert_array_equal(load_avif(str(path)).data, ref.data)
        np.testing.assert_array_equal(decode_avif_to_rgb8(data),
                                      ref_rgb8(data))
        return
    with pytest.raises(Exception, match="Invalid image grid"):
        ref_load_avif(str(path))
    with pytest.raises(Exception, match="Invalid image grid"):
        ref_rgb8(data)
    with pytest.raises(OSError, match="broken AVIF"):
        load_avif(str(path))


@pytest.mark.parametrize("colr", ["grid_nclx", "none"])
def test_grid_colour_description_equals_pillow(colr, tmp_path):
    """The grid's own ``nclx`` sets the matrix (here BT.709, against the
    cells' BT.601 sequence headers); without it, the first cell's
    sequence header does."""
    data = _grid()
    old = b"nclx" + struct.pack(">HHHB", 2, 2, 6, 0x80)
    assert data.count(old) == 1
    new = (b"nclx" + struct.pack(">HHHB", 1, 13, 1, 0x80)
           if colr == "grid_nclx" else b"zzzz" + old[4:])
    data = data.replace(old, new)
    box, img, _ = A.decode_avif(data)
    assert img.cicp == ((1, 13, 1) if colr == "grid_nclx" else (2, 2, 6))
    np.testing.assert_array_equal(decode_avif_to_rgb8(data), ref_rgb8(data))


def test_metaless_file_needs_its_brands(tmp_path):
    """A sequence without ``meta`` reads (its track) once its ``avif``
    compatible brand is gone, and raises in both while the brand stays."""
    data = (FIXTURES / "seq_420.avif").read_bytes()
    at = data.index(b"meta")
    kept = data[:at] + b"free" + data[at + 4:]
    with pytest.raises(Exception):
        ref_rgb8(kept)
    with pytest.raises(OSError, match="'avif' brand without a 'meta'"):
        A.decode_avif(kept)
    ok = MK.without_meta(data)
    np.testing.assert_array_equal(decode_avif_to_rgb8(ok), ref_rgb8(ok))
    np.testing.assert_array_equal(decode_avif_to_rgb8(ok),
                                  decode_avif_to_rgb8(data))


# ---------------------------------------------------------------------------
# premultiplied alpha on libavif 1.3's conversion routes
# ---------------------------------------------------------------------------

# (depth, subsampling, CICP, full range): libyuv at 8, 10 (I410ToARGB)
# and 12 bits (I012ToARGB, and narrowed), limited range; the fast paths
# (matrix 4 and 8-bit identity in 4:4:4, monochrome matrices); the slow
# path (subsampled matrix 4 and 7, YCgCo, 10-bit identity)
PREM_ROUTES = [
    (8, "4:4:4", (2, 2, 6), True), (8, "4:2:0", (2, 2, 6), True),
    (10, "4:2:0", (2, 2, 6), False), (12, "4:2:0", (1, 13, 1), True),
    (12, "4:4:4", (9, 16, 9), True), (8, "4:2:2", (1, 13, 1), True),
    (10, "4:4:4", (1, 13, 4), True), (8, "4:4:4", (1, 13, 0), True),
    (8, "4:2:0", (1, 13, 4), True), (10, "4:2:2", (1, 13, 7), True),
    (8, "4:4:4", (1, 13, 8), True), (10, "4:4:4", (1, 13, 0), True),
    (12, "4:2:0", (9, 16, 12), True),
]


@pytest.mark.parametrize("depth,ss,cicp,full", PREM_ROUTES,
                         ids=[f"{d}bit_{s.replace(':', '')}_mc{c[2]}"
                              f"{'' if f else '_limited'}"
                              for d, s, c, f in PREM_ROUTES])
def test_premultiplied_alpha_on_each_route_equals_pillow(depth, ss, cicp,
                                                         full, tmp_path):
    """A 64x64 file whose alpha takes every value 0-255 (each 16 times),
    premultiplied by libavif 0.11.1: Pillow's RGBA (libavif 1.3) and its
    RGB after dropping the alpha."""
    rng = np.random.default_rng(depth + len(ss) + cicp[2])
    rgb = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    a = rng.permutation(np.arange(64 * 64) % 256).reshape(64, 64)
    px = np.concatenate([rgb, a.astype(np.uint8)[..., None]], -1)
    data = MK.libavif_encode(px, depth, ss, 10, cicp=cicp, full=full,
                            premultiplied=True)
    assert A.read_container(data).premultiplied
    path = tmp_path / "x.avif"
    path.write_bytes(data)
    ref = ref_load_avif(str(path))
    assert ref.channels == 4
    np.testing.assert_array_equal(load_avif(str(path)).data, ref.data)
    np.testing.assert_array_equal(decode_avif_to_rgb8(data), ref_rgb8(data))


def test_unattenuate_table_is_libyuvs():
    """The reciprocal table equals the one in Pillow's libavif's
    ``.rodata`` (libyuv's fixed_invtbl8, 1.0 in each entry's upper half),
    where it is one of a kind."""
    import subprocess
    import tempfile

    import PIL

    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    so = next(libs.glob("libavif-*.so*"))
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        subprocess.run(["objcopy", "-O", "binary", "--only-section=.rodata",
                        str(so), f.name], check=True)
        ro = Path(f.name).read_bytes()
    table = (A._INVTBL8 | 0x01000000).astype("<u4").tobytes()
    assert ro.count(table) == 1


# ---------------------------------------------------------------------------
# files the tests write themselves, at the smallest sizes
# ---------------------------------------------------------------------------


def test_live_grid_of_64_cells_equals_reference(tmp_path):
    """The smallest cells libavif 1.3 accepts: 3x2 of 64x64, 4:2:0."""
    data = _grid(cells=6, cols=3)
    path = tmp_path / "x.avif"
    path.write_bytes(data)
    box, img, _ = A.decode_avif(data)
    assert box.color.grid == (2, 3, 192, 128)
    planes, _, _ = decode_to_yuv(data)
    assert _yuv_crc(img.planes) == _yuv_crc(planes)
    np.testing.assert_array_equal(load_avif(str(path)).data,
                                  ref_load_avif(str(path)).data)
    np.testing.assert_array_equal(decode_avif_to_rgb8(data), ref_rgb8(data))


def test_live_two_frame_sequence_equals_reference(tmp_path):
    """Pillow's first frame of two that differ."""
    px = bench_images(64, ("fractal", "text"))
    data = MK.pillow_sequence([px["fractal"], px["text"]], quality=60)
    assert A.read_container(data).source == "track"
    np.testing.assert_array_equal(decode_avif_to_rgb8(data), ref_rgb8(data))
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    assert im.n_frames == 2
    np.testing.assert_array_equal(decode_avif_to_rgb8(data),
                                  np.asarray(im.convert("RGB")))


def test_live_premultiplied_rgba_equals_reference(tmp_path):
    px = MK.alpha_mix(bench_images(128, ("mixed",))["mixed"][:64, :96])
    data = MK.libavif_encode(px, 8, "4:2:0", 24, premultiplied=True)
    path = tmp_path / "x.avif"
    path.write_bytes(data)
    got, ref = load_avif(str(path)), ref_load_avif(str(path))
    assert got.channels == ref.channels == 4
    np.testing.assert_array_equal(got.data, ref.data)
