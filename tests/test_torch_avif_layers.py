"""The port's AVIF reader on items coded in spatial layers of the same
size (the fixtures of ``tests/torch_fixtures/avif_layers``: libaom 3.6's
realtime usage through ctypes, and layer 1 written symbol by symbol by
``inter_writer.py`` for the tools libaom does not write), on the CPU and
with no tolerance:

- every file decodes to dav1d's Y'UV (the system libavif 0.11.1) and
  ``load_avif`` and ``decode_avif_to_rgb8`` give the reference's pixels,
  held live to the reference and to the manifest, with the frames the
  port decodes, the layer it shows and its tool counts; a file with a
  tool the port refuses raises ``UnsupportedAvif`` naming it;
- a few files regenerate byte for byte from the maker;
- every inter tool counter occurs in the set;
- ``a1op``, ``lsel`` and ``a1lx`` select and check as Pillow's libavif
  1.3 does, over a grid of wrappings of a two- and a three-layer stream;
- the tools the decoder refuses raise naming them;
- the CLI ``-t 80`` on a 512x512 layered file gives the reference CLI's q
  and passes, and the bytes of the port's CLI on its pixels as PAM.
"""

from __future__ import annotations

import io
import json
import re
import struct
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

FIXTURES = ROOT / "tests" / "torch_fixtures" / "avif_layers"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())

sys.path.insert(0, str(FIXTURES))
sys.path.insert(0, str(FIXTURES.parent / "avif_tools"))
import make_avif_layers as MK  # noqa: E402

# the inter counters of same-size layers (a scaled reference's is held by
# tests/test_torch_avif_progressive.py)
INTER_TOOLS = A.TOOL_NAMES[A.TOOL_NAMES.index("inter_frame"):
                           A.TOOL_NAMES.index("scaled_pred")]


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
    if "refuses" in entry:
        with pytest.raises(A.UnsupportedAvif, match=re.escape(
                entry["refuses"])):
            A.decode_avif(data)
        return
    times = {}
    _, img, alpha = A.decode_avif(data, times)
    want = [p for p in planes if p is not None]
    assert len(img.planes) == len(want)
    for i, (got, p) in enumerate(zip(img.planes, want)):
        np.testing.assert_array_equal(got, p.astype(np.int32),
                                      err_msg=f"plane {i}")
    assert img.tools == entry["tools"]
    assert (alpha.tools if alpha else None) == entry["alpha_tools"]
    for i in range(len(entry["frames"])):
        assert times[f"tiles_f{i}"] > 0 and f"filters_f{i}" in times
    got = load_avif(str(path))
    assert (got.data.dtype, got.hbd, got.channels) == (ref.data.dtype,
                                                        ref.hbd,
                                                        ref.channels)
    np.testing.assert_array_equal(got.data, ref.data)
    assert _crc(decode_avif_to_rgb8(data)) == entry["rgb8_crc"]


@pytest.mark.parametrize("name", ["probe_256_420.avif", "s9_mono_8bit.avif",
                                  "written_dual_sub8x8_420.avif"])
def test_fixture_regenerates(name):
    if name in MK.WRITTEN:
        data, _ = MK.written(name)
    else:
        px, kw = MK.files()[name]
        data = MK.encode_avif(px, **kw)
    assert data == (FIXTURES / name).read_bytes()


@pytest.mark.parametrize("tool", INTER_TOOLS)
def test_each_inter_tool_occurs(tool):
    assert sum(e.get("tools", {}).get(tool, 0)
               for e in MANIFEST.values()) > 0


def test_fixtures_cover_the_grid():
    e = {n: x for n, x in MANIFEST.items() if "tools" in x}
    written = [x["written"] for x in e.values()]
    assert {w.get("ss") for w in written} >= {"4:2:0", "4:2:2", "4:4:4"}
    assert any(w.get("mono") for w in written)
    assert {w.get("depth") for w in written} == {8, 10, 12}
    assert {int(w["cpu-used"]) for w in written if "cpu-used" in w} == \
        set(range(5, 11))
    assert any(x["alpha_tools"] and x["alpha_tools"]["inter_frame"]
               for x in e.values())
    assert any(len(x["frames"]) == 3 and x["shows_layer"] == 2
               for x in e.values())
    assert MANIFEST["photo4k_420.avif"]["load_shape"] == [2160, 3840, 3]
    # libaom's defaults at cpu-used 5, once refused, now decode: OBMC and
    # local warps (alone where OBMC is off)
    assert MANIFEST["obmc_s5_420.avif"]["tools"]["obmc"] > 0
    assert MANIFEST["warp_s5_420.avif"]["tools"]["local_warp"] > 0
    # three layers with use_ref_frame_mvs, once refused, now decode
    # (tests/test_torch_avif_refmvs.py holds them): no file is refused
    assert {x["refuses"] for x in MANIFEST.values() if "refuses" in x} == \
        set()
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 1_000_000
    assert sorted(p.name for p in FIXTURES.glob("*.avif")) == \
        sorted(MANIFEST)


# ---------------------------------------------------------------------------
# a1op, lsel and a1lx
# ---------------------------------------------------------------------------


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), typ) + payload


def _wrappings(src: bytes) -> dict:
    from make_avif_tools import add_property

    size = len(A.read_container(src).color.payload)
    def a1lx(*sizes):
        return _box(b"a1lx", bytes([0]) + struct.pack(">HHH", *sizes))

    def lsel(v):
        return _box(b"lsel", struct.pack(">H", v))

    def a1op(v):
        return _box(b"a1op", bytes([v]))

    out = {"none": src, "a1lx": add_property(src, a1lx(100, 0, 0)),
           "a1lx zero first": add_property(src, a1lx(0, 100, 0)),
           "a1lx past the item": add_property(src, a1lx(size, 10, 0)),
           "a1lx the whole item": add_property(src, a1lx(size - 100, 100, 0)),
           "a1lx essential": add_property(src, a1lx(0, 0, 0), True),
           "a1op not essential": add_property(src, a1op(1)),
           "lsel not essential": add_property(src, lsel(0)),
           "a1op 1 lsel 0": add_property(add_property(src, a1op(1), True),
                                         lsel(0), True),
           "a1op 1 lsel 1": add_property(add_property(src, a1op(1), True),
                                         lsel(1), True)}
    for v in range(3):
        out[f"a1op {v}"] = add_property(src, a1op(v), True)
    for v in (0, 1, 2, 3, 5, 0xFFFF):
        out[f"lsel {v}"] = add_property(src, lsel(v), True)
    return out


def _pillow(data: bytes):
    from PIL import Image

    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # Pillow refuses the file or fails its frame
        return type(e)


GRID = [(src, k) for src in ("probe_256_420.avif", "three_layers_420.avif")
        for k in _wrappings((FIXTURES / src).read_bytes())]


@pytest.mark.parametrize("src,case", GRID)
def test_layer_properties_select_as_pillow(src, case):
    data = _wrappings((FIXTURES / src).read_bytes())[case]
    want = _pillow(data)
    if isinstance(want, type):
        with pytest.raises(OSError):
            A.decode_avif_rgb8(data)
        return
    np.testing.assert_array_equal(A.decode_avif_rgb8(data), want)


def test_layer_properties_pick_each_layer():
    """The three-layer stream: ``lsel`` names each layer, ``a1op`` 1 and 2
    the operating points of two layers and one, and each pick differs."""
    src = (FIXTURES / "three_layers_420.avif").read_bytes()
    w = _wrappings(src)
    got = [A.decode_avif(w[k])[1].planes[0] for k in
           ("lsel 0", "lsel 1", "lsel 2")]
    for a, b in ((0, 1), (1, 2), (0, 2)):
        assert not np.array_equal(got[a], got[b])
    np.testing.assert_array_equal(A.decode_avif(w["a1op 1"])[1].planes[0],
                                  got[1])
    np.testing.assert_array_equal(A.decode_avif(w["a1op 2"])[1].planes[0],
                                  got[0])
    np.testing.assert_array_equal(A.decode_avif(w["none"])[1].planes[0],
                                  got[2])


# ---------------------------------------------------------------------------
# refusals and the CLI
# ---------------------------------------------------------------------------


def test_frame_level_refusals_name_the_tool():
    """Global motion other than IDENTITY and skip_mode, once refused at the
    frame level by name: a frame ``inter_writer`` writes with each (a
    ROTZOOM LAST under GLOBALMV, NEARESTMV and NEWMV blocks; skip_mode
    blocks beside compound ones on a forward and a backward reference)
    now decodes to dav1d's planes."""
    from inter_writer import (CompoundBlock, InterBlock, SkipModeBlock,
                              write_layered)

    yuv = MK.to_yuv(MK.bench_images(256)["fractal"], 8, "4:2:0")
    one = 1 << 16
    rotzoom = (2, (300 << 10, -500 << 10, one + 300, -460, 460, one + 300))
    rng = np.random.default_rng(6)
    for tool in ("global motion", "skip_mode"):
        base = 1 if tool == "global motion" else 2
        key = MK.aom_encode_layers(yuv, 8, "4:2:0", (40, 30, 20)[:base + 1],
                                   options={"cpu-used": 8})
        if tool == "global motion":
            sbs = [(2, [InterBlock(tuple(int(v) for v in rng.integers(
                -20, 21, 2)), mode=("global", "nearest", "new")[i % 3])
                for i in range(16)]) for _ in range(16)]
            stream = write_layered(key, sbs, gm=(rotzoom,) + (
                (0, (0, 0, one, 0, 0, one)),) * 6)
            counter = "global_warp"
        else:
            sbs = [(2, [(SkipModeBlock(), CompoundBlock(6), InterBlock(
                (4 * (i % 5), -6))) [i % 3] for i in range(16)])
                for _ in range(16)]
            stream = write_layered(key, sbs, pair=(1, 7), base_layers=2,
                                   ref_slots=(1, 0, 1, 0, 1, 0, 0),
                                   order_hint=65, skip_mode=True)
            counter = "skip_mode"
        data = MK.container(stream, 256, 256, 8)
        planes, _, _ = decode_to_yuv(data)
        img = A.decode_avif(data)[1]
        assert img.tools[counter] > 0, tool
        assert len(img.planes) == 3
        for got, want in zip(img.planes, planes):
            np.testing.assert_array_equal(got, want, err_msg=tool)


@pytest.mark.parametrize("refuse,tool", [
    ("compound", "a compound block"),
    ("seg_map", "segmentation map prediction (a segmentation_update_map"),
    ("seg_temporal", "segmentation map prediction (a "
                     "segmentation_temporal_update"),
    ("scaled", "a reference frame of another size (scaled prediction)")])
def test_written_refusals_name_the_tool(refuse, tool):
    """Inter frames ``inter_writer`` writes with a tool the decoder once
    refused (``tool`` names it as the refusal did): a chained frame whose
    segment ids are kept from the frame before it (update_map 0) or coded
    against them (temporal update, some predicted), over a frame whose ids
    come before skip; a frame of 128x128 on a reference of 256x256
    (scaled prediction) and a frame of compound blocks; each now decodes
    to dav1d's planes."""
    from dataclasses import replace

    from inter_writer import random_compound_sbs, random_sbs, write_layered

    seg = refuse.startswith("seg")
    key = MK.aom_encode_layers(MK.to_yuv(
        MK.bench_images(256)["fractal"], 8, "4:2:0"), 8, "4:2:0",
        (40, 20, 10) if seg else (40, 20), options={"cpu-used": 8})
    rng = np.random.default_rng(5)
    scaled, compound = refuse == "scaled", refuse == "compound"
    if compound:
        stream = write_layered(key, random_compound_sbs(
            rng, 16, (1, 2, 3, 4), 20, True), pair=(1, 7), masked=True)
        counter = "comp_ref_bidir"
    elif seg:
        # ids 0 .. 3 in turn, every other one predicted; segment 3 skips
        feats = {1: {1: -20, 2: -20}, 2: {1: 20}, 3: {6: 0}}
        sbs = [(split, [replace(b, seg=(i + k) % 4, seg_pred=bool(i & 1))
                        for k, b in enumerate(blks)])
               for i, (split, blks) in enumerate(random_sbs(
                   rng, 16, 4, 20, 3, True))]
        stream = write_layered(key, sbs, seg=dict(features=feats),
                               chain=dict(sbs=sbs, primary=0,
                                          ref_slots=(1,) + (0,) * 6,
                                          seg=dict(map={
                                              "seg_map": "keep",
                                              "seg_temporal": "temporal"}[
                                                  refuse], features=feats)))
        counter = {"seg_map": "seg_map_kept",
                   "seg_temporal": "seg_id_predicted"}[refuse]
    else:
        sbs = random_sbs(rng, 16, 0, 20, 3, True)
        stream = write_layered(key, sbs[:4], size=(128, 128))
        counter = "scaled_pred"
    data = MK.container(stream, *((128, 128) if scaled else (256, 256)), 8)
    planes, _, _ = decode_to_yuv(data)
    img = A.decode_avif(data)[1]
    assert img.tools[counter] > 0, tool
    assert len(img.planes) == 3
    for got, want in zip(img.planes, planes):
        np.testing.assert_array_equal(got, want)


def test_refusal_files_name_their_tools():
    for name, entry in MANIFEST.items():
        if "refuses" in entry:
            with pytest.raises(A.UnsupportedAvif,
                               match=re.escape(entry["refuses"])):
                load_avif(str(FIXTURES / name))


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_layered_avif_matches_reference_and_pam(tmp_path, capsys):
    """``-t 80`` on the 512x512 mixed class coded in two layers."""
    args = ["-t", "80"]
    src = FIXTURES / "class_mixed_512.avif"
    _, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found is not None and found == ref_found
    pam = tmp_path / "px.pam"
    write_pam(pam, load_avif(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("alpha", [False, True])
def test_deep_monochrome_converts_as_pillow(depth, alpha):
    """A monochrome frame (as ``s8_mono_10bit.avif`` showed): libavif 1.3
    converts 10- and 12-bit monochrome in float32 to RGB, and through
    libyuv at 8 bits to RGBA (with alpha), as it does 8-bit monochrome."""
    from PIL import Image
    from make_avif_superres import aom_encode, container

    px = MK.bench_images(128)["mixed"]
    dt = np.uint16 if depth > 8 else np.uint8
    luma = MK.to_yuv(px, depth, "4:2:0")[:1]
    data = container(aom_encode(luma, depth, "4:2:0", 20), 128, 128, depth,
                     "4:2:0", alpha=aom_encode(
                         [np.full((128, 128), (1 << depth) - 200, dt)],
                         depth, "4:2:0", 20) if alpha else None)
    data = bytearray(data)
    at = data.index(b"av1C") + 6
    data[at] |= 0x10  # the colour item is monochrome
    want = np.asarray(Image.open(io.BytesIO(bytes(data))).convert(
        "RGBA" if alpha else "RGB"))[..., :3]
    np.testing.assert_array_equal(A.decode_avif_rgb8(bytes(data)), want)
