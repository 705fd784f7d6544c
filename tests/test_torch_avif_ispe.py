"""The port's AVIF reader on frames whose ``ispe`` differs from their
coded size (the fixtures of ``tests/torch_fixtures/avif_ispe``), on the
CPU and with no tolerance. libavif 1.3 (Pillow's) and the system libavif
0.11.1 (the reference's high-bit-depth route) both scale such a frame to
its ``ispe`` with libyuv's ScalePlane in its box filter mode, and their
two libyuvs give the same planes on every route:

- every file decodes to dav1d's scaled Y'UV (the system libavif 0.11.1)
  and ``load_avif`` and ``decode_avif_to_rgb8`` give the reference's
  pixels, held live to the reference and to the manifest: a 2x2 box down,
  a 2x bilinear up, a vertical filter, a bilinear scale up in one
  direction and down in the other, odd sizes, alpha, 10-bit 4:2:0 and the
  reference's 10-bit 4:4:4 route, and each of libyuv's box-mode routes
  (the box filter proper, 3/4, 3/8, 1/4, point sampling) at 8 bits, at
  10 bits on both reference routes and at 12 bits;
- two 3840x2160 files of other folders, their ``ispe`` rewritten to each
  of the box, 3/4, 3/8 and 1/4 routes, decode to dav1d's Y'UV and the
  reference's pixels (by the manifest's CRCs, and live);
- an ``ispe`` past libavif's size limits raises ``OSError`` where the
  reference cannot open the file either;
- the scaler holds to Pillow live over a grid of sizes that reaches
  every route, on lossless 8-bit frames whose Y'UV it scales and the
  port converts as Pillow does, and to the system libavif's Y'UV at 10
  and 12 bits;
- the files regenerate byte for byte from the maker.
"""

from __future__ import annotations

import io
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from oavif_tpu.io.image import decode_avif_to_rgb8 as ref_rgb8  # noqa: E402
from oavif_tpu.io.image import load_avif as ref_load_avif  # noqa: E402
from oavif_tpu_torch.io import avif as A  # noqa: E402
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)
from oavif_tpu_torch.io.yuv_scale import scale_plane  # noqa: E402

FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_ispe"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
# the fixtures with bytes of their own, and the 3840x2160 rewrites
FILES = sorted(n for n, e in MANIFEST.items() if "source" not in
               e["written"])
REWRITES = sorted(n for n, e in MANIFEST.items() if "source" in e["written"])

sys.path.insert(0, str(FIXTURES))
sys.path.insert(0, str(FIXTURES.parent / "avif_superres"))
import make_avif_ispe as MK  # noqa: E402


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


def _yuv_crc(planes) -> int:
    return _crc(np.concatenate([p.astype("<u2").reshape(-1) for p in planes
                                if p is not None]))


@pytest.mark.parametrize("name", FILES)
def test_fixture_decodes_to_dav1d_and_the_reference(name):
    entry = MANIFEST[name]
    path = FIXTURES / name
    data = path.read_bytes()
    assert len(data) == entry["bytes"]
    av1 = A.parse_av1(A.read_container(data).color.payload)
    assert [av1.frame.width, av1.frame.height] == entry["coded"]
    if "raises" in entry:
        with pytest.raises(Exception) as e:
            ref_load_avif(str(path))
        assert str(e.value).replace(str(path), name) == entry["raises"]
        with pytest.raises(OSError) as e:
            load_avif(str(path))
        assert (type(e.value).__name__, str(e.value)) == (entry["port"],
                                                          entry["port_says"])
        return
    planes, depth, _ = decode_to_yuv(data)
    assert (_crc(np.concatenate([p.astype("<u2").reshape(-1) for p in planes
                                 if p is not None])), depth) == (
        entry["yuv_crc"], entry["depth"])
    ref = ref_load_avif(str(path))
    assert [list(ref.data.shape), ref.hbd, _crc(ref.data)] == [
        entry["load_shape"], entry["load_hbd"], entry["load_crc"]]
    assert _crc(ref_rgb8(data)) == entry["rgb8_crc"]
    assert list(ref.data.shape[:2]) == entry["written"]["ispe"][::-1]
    times = {}
    _, img, _ = A.decode_avif(data, times)
    assert times["scale"] > 0
    for i, (got, p) in enumerate(zip(img.planes, [p for p in planes
                                                  if p is not None])):
        np.testing.assert_array_equal(got, p.astype(np.int32),
                                      err_msg=f"plane {i}")
    got = load_avif(str(path))
    assert (got.data.dtype, got.hbd, got.channels) == (ref.data.dtype,
                                                        ref.hbd,
                                                        ref.channels)
    np.testing.assert_array_equal(got.data, ref.data)
    assert _crc(decode_avif_to_rgb8(data)) == entry["rgb8_crc"]


@pytest.mark.parametrize("name", REWRITES)
def test_rewritten_4k_decodes_to_dav1d_and_the_reference(name, tmp_path):
    """A 3840x2160 frame of another folder with its ``ispe`` rewritten:
    the port's Y'UV is dav1d's and its ``load_avif`` and
    ``decode_avif_to_rgb8`` pixels the reference's (one decode)."""
    entry = MANIFEST[name]
    data = MK.write(name)
    path = tmp_path / "in.avif"
    path.write_bytes(data)
    ref = ref_load_avif(str(path))
    assert [list(ref.data.shape), ref.hbd, _crc(ref.data)] == [
        entry["load_shape"], entry["load_hbd"], entry["load_crc"]]
    assert _crc(ref_rgb8(data)) == entry["rgb8_crc"]
    times = {}
    box, img, alpha = A.decode_avif(data, times)
    assert times["scale"] > 0
    assert (_yuv_crc(img.planes), img.bit_depth) == (entry["yuv_crc"],
                                                      entry["depth"])
    arr, hbd, _ = A.avif_pixels(box, img, alpha)
    assert [list(arr.shape), hbd, _crc(arr)] == [
        entry["load_shape"], entry["load_hbd"], entry["load_crc"]]
    assert _crc(A.yuv_to_rgb8(img, rgba=alpha is not None)) == \
        entry["rgb8_crc"]


def test_fixtures_cover_each_scaler_route():
    """Every route of libyuv's ScalePlane with kFilterBox that a frame
    scaled down or up by its ``ispe`` takes is in the manifest at 8 bits
    and at 10 bits on both reference routes (the system libavif's
    high-bit-depth route and Pillow's); the 3840x2160 rewrites take the
    box, 3/4, 3/8 and 1/4 routes on both; alpha, 12 bits, 4:2:2 and odd
    sizes are there; no file is refused, and one ``ispe`` past libavif's
    limits raises."""
    files = [MANIFEST[n] for n in FILES if "raises" not in MANIFEST[n]]
    routes = {"down2", "up2_bilinear", "vertical", "bilinear_up",
              "bilinear_down", "box", "down34", "down38", "down4",
              "simple"}
    assert {e["route"] for e in files if e["depth"] == 8} == routes
    new = {"box", "down34", "down38", "down4", "simple"}
    for reader in ("system", "pillow"):
        assert {e["route"] for e in files if e["depth"] == 10
                and e["reader"] == reader} >= new, reader
        assert {MANIFEST[n]["route"] for n in REWRITES
                if MANIFEST[n]["reader"] == reader} == new - {"simple"}
    assert all(e["reader"] == ("system" if e["load_hbd"] else "pillow")
               for e in files)
    assert any(e["depth"] == 12 for e in files)
    assert any(e["written"]["ss"] == "4:2:2" for e in files)
    assert any(e["load_shape"][2:] == [4] and e["depth"] == 10
               for e in files)
    assert any(e.get("written", {}).get("matrix") == 1 for e in files)
    assert MANIFEST["refuse_box_96x64.avif"]["route"] == "box"
    assert MANIFEST["class_mixed_512_box.avif"]["load_shape"] == [512, 512,
                                                                  3]
    assert not any("refuses" in e for e in MANIFEST.values())
    assert sum("raises" in e for e in MANIFEST.values()) == 1
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == FILES
    assert {MANIFEST[n]["written"]["source"] for n in REWRITES} == {
        "avif_aom/photo4k_420_q60.avif", "avif/photo4k_q60.avif"}


@pytest.mark.parametrize("name", ["ispe_300x200.avif",
                                  "ispe_192x160_444_10bit.avif",
                                  "r8_38_96x96.avif",
                                  "bt709_10_14_64x64.avif"])
def test_fixture_regenerates(name):
    assert MK.write(name) == (FIXTURES / name).read_bytes()


@pytest.mark.parametrize("depth,ss,mc,ispe", [
    (10, "4:4:4", 6, None), (10, "4:4:4", 0, None), (12, "4:4:4", 4, None),
    (10, "4:2:0", 4, None), (12, "4:2:0", 6, None), (12, "4:2:0", 6, (96, 64)),
    (10, "4:4:4", 0, (64, 96))])
def test_deep_alpha_narrowed_as_pillow(depth, ss, mc, ispe, monkeypatch):
    """A 10- or 12-bit alpha plane in Pillow's RGBA: shifted to 8 bits
    where libyuv converts the colour with it (matrix 6 at 10 bits),
    rounded by libavif's float otherwise (matrix 0 and 4: libavif's own
    conversion; 12-bit 4:2:0: libyuv's I012ToARGB, which takes no
    alpha), scaled to an ``ispe`` or not."""
    import make_avif_superres as SR
    from PIL import Image

    from chip_smoke import with_alpha

    monkeypatch.setattr(SR, "CICP", (1, 13, mc))
    px = with_alpha(MK.bench_images(128, ("fractal",))["fractal"])
    data = SR.encode_avif(px, depth=depth, ss=ss, quantizer=24)
    if ispe:
        data = MK.with_ispe(data, *ispe)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    got, hbd, _ = A.read_avif(data)
    assert not hbd
    np.testing.assert_array_equal(got, want)


_BASES: dict = {}


def _lossless(w: int, h: int, depth: int = 8):
    """A lossless 4:4:4 frame of w x h at ``depth`` bits, a noisy ramp in
    each plane: its Y'UV planes and its AVIF."""
    from make_avif_superres import aom_encode, container

    key = (w, h, depth)
    if key not in _BASES:
        rng = np.random.default_rng(1)
        top = (1 << depth) - 1
        planes = []
        for k in range(3):
            ramp = np.add.outer(np.arange(h), (k + 1) * np.arange(w))
            noise = rng.integers(-40, 40, (h, w)) << (depth - 8)
            planes.append(np.clip(ramp % 256 * (top // 255) + noise, 0,
                                  top).astype(np.uint16 if depth > 8
                                              else np.uint8))
        stream = aom_encode(planes, depth, "4:4:4", 0,
                            options={"cpu-used": 9})
        _BASES[key] = planes, container(stream, w, h, depth, "4:4:4")
    return _BASES[key]


# the grid: every route of ScalePlane's box mode, on 256x256 frames,
# (point sampling: a width cut to a third) 384x256, and 200x200, where
# the 3/4 and 3/8 widths end in C rows past the SSSE3 rows' multiples
SIZES = [(128, 128), (512, 512), (256, 255), (300, 200), (255, 256),
         (129, 130), (200, 160), (384, 192), (257, 257), (60, 256),
         (96, 64), (64, 96), (100, 100), (192, 192), (96, 96), (64, 64),
         ((384, 256), (128, 256)), ((200, 200), (150, 150)),
         ((200, 200), (75, 75))]


def _base_and_size(size):
    return size if isinstance(size[0], tuple) else ((256, 256), size)


@pytest.mark.parametrize("size", SIZES, ids=str)
def test_scaler_equals_pillow(size):
    """Each plane of a lossless 8-bit 4:4:4 frame scaled by ``scale_plane``
    and converted as the port converts is Pillow's RGB of the frame with
    that ``ispe``."""
    from PIL import Image

    (bw, bh), (w, h) = _base_and_size(size)
    planes, base = _lossless(bw, bh)
    want = np.asarray(Image.open(io.BytesIO(MK.with_ispe(base, w, h)))
                      .convert("RGB"))
    img = A.decode_avif(base)[1]
    np.testing.assert_array_equal(np.stack(img.planes), np.stack(planes))
    img.planes = [scale_plane(p, w, h, False) for p in planes]
    np.testing.assert_array_equal(A.yuv_to_rgb8(img), want)


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("size", SIZES[10:], ids=str)
def test_deep_scaler_equals_the_system_libavif(size, depth):
    """``scale_plane``'s deep routes (ScalePlane_12) on each plane of a
    lossless 4:4:4 frame are the system libavif's Y'UV of the frame with
    that ``ispe`` (the reference's high-bit-depth route)."""
    (bw, bh), (w, h) = _base_and_size(size)
    planes, base = _lossless(bw, bh, depth)
    want, got_depth, _ = decode_to_yuv(MK.with_ispe(base, w, h))
    assert got_depth == depth
    for p, q in zip(planes, want):
        np.testing.assert_array_equal(scale_plane(p, w, h, True), q)
