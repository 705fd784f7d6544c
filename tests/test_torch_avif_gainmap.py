"""The port's AVIF reader on gain-map files (a ``tmap`` derived item over
a base image and a gain map image, in an ``altr`` group), read as
Pillow's libavif 1.3 reads them when it decodes the colour image only,
on the CPU and with no tolerance.

The fixtures (``tests/torch_fixtures/avif_gainmap``, from
``make_avif_gainmap.py``) hold the layouts libavif writes (the base image
primary, with and without the ``altr`` group, a grid base image, a 10-bit
4:4:4 one, a multichannel ``tmap`` with its own ``colr``), the ``tmap``
contents a gain-map decoder checks and Pillow does not (metadata
versions, a denominator of 0, ``ispe`` missing or mismatched,
transformative properties, one or three ``dimg`` entries, a gain map
that is no AV1 image), and the files Pillow refuses (the ``tmap`` as the
primary item, ``dimg`` lists that repeat an item or share one, two
``dimg`` boxes from one item, entity groups of the wrong size, two
``grpl`` boxes, a transformative property not marked essential, ``ipma``
out of item id order). Where the reference reads a file the port reads
it with equal pixels (and dav1d's Y'UV of its base image); where the
reference raises the port raises ``UnsupportedAvif`` or ``OSError``
naming the reason.
"""

from __future__ import annotations

import json
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_gainmap"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(FIXTURES))

import make_avif_gainmap as MK  # noqa: E402
from oavif_tpu.io.image import decode_avif_to_rgb8 as ref_rgb8  # noqa: E402
from oavif_tpu.io.image import load_avif as ref_load_avif  # noqa: E402
from oavif_tpu_torch.io import avif as A  # noqa: E402
from oavif_tpu_torch.io.image import (decode_avif_to_rgb8,  # noqa: E402
                                      load_avif)

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
MADE = MK.files()


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_gain_map_file_as_reference(name):
    entry = MANIFEST[name]
    path = FIXTURES / name
    data = path.read_bytes()
    assert data == MADE[name][0] and len(data) == entry["bytes"]
    if "raises" in entry:
        with pytest.raises(Exception):
            ref_load_avif(str(path))
        want = {"UnsupportedAvif": A.UnsupportedAvif,
                "OSError": OSError}[entry["port"]]
        for read in (lambda: load_avif(str(path)),
                     lambda: decode_avif_to_rgb8(data)):
            with pytest.raises(want) as e:
                read()
            assert str(e.value) == entry["port_says"]
        return
    assert MK.base_yuv_crc(data) == entry["yuv_crc"]
    ref = ref_load_avif(str(path))
    assert [list(ref.data.shape), ref.hbd, _crc(ref.data),
            len(ref.icc or b"")] == [entry["load_shape"], entry["load_hbd"],
                                     entry["load_crc"], entry["icc"]]
    assert _crc(ref_rgb8(data)) == entry["rgb8_crc"]
    box, img, _ = A.decode_avif(data)
    assert _crc(np.concatenate([p.astype("<u2").reshape(-1)
                                for p in img.planes])) == entry["yuv_crc"]
    assert (img.tools, box.color.grid is not None) == (entry["tools"],
                                                        entry["grid"])
    got = load_avif(str(path))
    assert (got.data.dtype, got.hbd, got.channels) == (ref.data.dtype,
                                                        ref.hbd, ref.channels)
    np.testing.assert_array_equal(got.data, ref.data)
    assert _crc(decode_avif_to_rgb8(data)) == entry["rgb8_crc"]


def test_both_primary_layouts_and_every_refusal():
    """The base image primary (read) and the tmap primary (refused in
    both packages); each refusal kind once."""
    assert "raises" not in MANIFEST["base_primary.avif"]
    assert "raises" in MANIFEST["tmap_primary.avif"]
    assert "tmap" in MANIFEST["tmap_primary.avif"]["port_says"]
    refused = {n for n, e in MANIFEST.items() if "raises" in e}
    assert refused == {
        "tmap_primary.avif", "tmap_primary_no_altr.avif",
        "dimg_base_twice.avif", "dimg_in_two_tmaps.avif",
        "dimg_two_boxes.avif", "altr_count_past_end.avif",
        "altr_trailing_bytes.avif", "two_grpl.avif",
        "ipma_not_increasing.avif", "tmap_irot_not_essential.avif"}
    assert {MANIFEST[n]["port"] for n in refused} == {"UnsupportedAvif",
                                                      "OSError"}


def test_gain_map_read_leaves_the_colour_item():
    """A file with a gain map and the same file without its tmap and gain
    map items decode to the same pixels."""
    with_gm = MK.gain_map_file()
    without = MK.gain_map_file(dimg=None, groups=())
    a = A.decode_avif(with_gm)[1].planes
    b = A.decode_avif(without)[1].planes
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert A.read_container(with_gm).color.item_id == MK.BASE


def test_fixtures_fit_their_budget():
    files = [p for p in FIXTURES.iterdir() if p.suffix == ".avif"]
    assert sorted(p.name for p in files) == sorted(MANIFEST)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 100_000
