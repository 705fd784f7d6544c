"""The port's AVIF reader on frames whose ``ispe`` differs from their
coded size (the fixtures of ``tests/torch_fixtures/avif_ispe``), on the
CPU and with no tolerance. libavif 1.3 (Pillow's) and the system libavif
0.11.1 (the reference's 10-bit route) both scale such a frame to its
``ispe`` with libyuv's ScalePlane in its box filter mode:

- every file decodes to dav1d's scaled Y'UV (the system libavif 0.11.1)
  and ``load_avif`` and ``decode_avif_to_rgb8`` give the reference's
  pixels, held live to the reference and to the manifest: a 2x2 box down,
  a 2x bilinear up, a vertical filter, a bilinear scale up in one
  direction and down in the other, odd sizes, alpha, 10-bit 4:2:0 and the
  reference's 10-bit 4:4:4 route;
- a frame more than twice as tall as its ``ispe`` (libyuv's box filter
  proper) raises ``UnsupportedAvif`` naming the box downscale, and an
  ``ispe`` past libavif's size limits raises ``OSError`` where the
  reference cannot open the file either;
- the scaler holds to Pillow live over a grid of sizes, on a lossless
  frame whose luma Pillow returns unchanged as grey;
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

sys.path.insert(0, str(FIXTURES))
sys.path.insert(0, str(FIXTURES.parent / "avif_superres"))
import make_avif_ispe as MK  # noqa: E402


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("name", sorted(MANIFEST))
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
    if "refuses" in entry:
        with pytest.raises(A.UnsupportedAvif, match=entry["refuses"]):
            load_avif(str(path))
        return
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


def test_fixtures_cover_each_scaler_route():
    sizes = {tuple(e["written"]["ispe"]) for e in MANIFEST.values()}
    assert sizes >= {(128, 128), (512, 512), (256, 255), (300, 200)}
    assert any(e.get("load_hbd") for e in MANIFEST.values())
    assert any(e.get("load_shape", [0, 0, 0])[2:] == [4]
               for e in MANIFEST.values())
    assert sum("refuses" in e for e in MANIFEST.values()) == 1
    assert sum("raises" in e for e in MANIFEST.values()) == 1
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == \
        sorted(MANIFEST)


@pytest.mark.parametrize("name", ["ispe_300x200.avif",
                                  "ispe_192x160_444_10bit.avif"])
def test_fixture_regenerates(name):
    px, kw, (w, h) = MK.files()[name]
    data = MK.with_ispe(MK.encode_avif(px, **kw), w, h)
    assert data == (FIXTURES / name).read_bytes()


@pytest.fixture(scope="module")
def _lossless():
    """A lossless 256x256 4:2:0 frame of a noisy ramp and flat chroma,
    whose luma Pillow's conversion returns as grey unchanged."""
    from make_avif_superres import aom_encode, container

    rng = np.random.default_rng(1)
    y = (np.add.outer(np.arange(256), np.arange(256)) % 256).astype(int)
    y = np.clip(y + rng.integers(-40, 40, y.shape), 0, 255).astype(np.uint8)
    flat = np.full((128, 128), 128, np.uint8)
    return y, container(aom_encode([y, flat, flat], 8, "4:2:0", 0), 256, 256,
                        8, "4:2:0")


@pytest.mark.parametrize("size", [(128, 128), (512, 512), (256, 255),
                                  (300, 200), (255, 256), (129, 130),
                                  (200, 160), (384, 192), (257, 257),
                                  (60, 256)])
def test_scaler_equals_pillow(_lossless, size):
    from PIL import Image

    y, base = _lossless
    want = np.asarray(Image.open(io.BytesIO(MK.with_ispe(base, *size)))
                      .convert("RGB"))[..., 0]
    np.testing.assert_array_equal(scale_plane(y, *size, False), want)
