"""The port's JPEG reader (``oavif_tpu_torch/io/jpeg.py`` and its C,
``io/jpeg_decode.c``) against the reference's ``load_jpeg`` (Pillow, so
libjpeg-turbo's default decompression), on the CPU: equal samples,
channels and ICC profile, with no tolerance, on a grid of Pillow-written
files (4:4:4, 4:2:2 and 4:2:0; baseline and progressive; optimized
tables or not; q30 and q95; sizes from 1x1 to 129x67), on grayscale,
CMYK, restart markers, multi-chunk ICC and DHT-less files, on
arithmetic-coded files (sequential and progressive, 4:2:0, 4:4:4 and
gray, with and without restart markers, with default and with written
``DAC`` conditioning) and on progressive files whose scan scripts leave
low coefficients unrefined, which libjpeg block-smooths (both written by
``tests/torch_fixtures/jpeg/jpeg_writer.c``, a libjpeg program built here
with gcc), and on the committed fixtures (``tests/torch_fixtures/jpeg``,
which add 4:4:0, 4:1:1, one component per sequential scan and YCCK from
libjpeg-turbo's encoder), each also held to its manifest CRC. Truncated
files and garbage raise in both packages; unsupported variants raise
``ValueError`` naming them, and the reference raises too.
End to end, the port's CLI on a 256x256 JPEG gives the reference CLI's q
and passes, and the bytes of the port's CLI on the decoded pixels as PAM.
"""

from __future__ import annotations

import io
import json
import re
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image as PILImage

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import bench_images, write_pam  # noqa: E402
from oavif_tpu import cli as ref_cli  # noqa: E402
from oavif_tpu.io.image import load_jpeg as ref_load_jpeg  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.io import jpeg  # noqa: E402
from oavif_tpu_torch.io.image import load_jpeg  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "jpeg"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
SIZES = ((1, 1), (7, 9), (17, 13), (64, 64), (129, 67))  # (h, w)


def _image(h: int, w: int, channels: int = 3, seed: int = 0) -> np.ndarray:
    """Smooth waves under noise: both the DC and the AC coefficients and
    the chroma edges carry content."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    wave = np.sin(xx / 5.0)[..., None] * np.cos(yy / 7.0)[..., None]
    tint = np.linspace(-40, 40, channels) * np.cos(xx / 13.0)[..., None]
    px = 128 + 80 * wave + tint + rng.normal(0, 20, (h, w, channels))
    return np.clip(px, 0, 255).astype(np.uint8)


def _jpeg(px: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    PILImage.fromarray(px, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _assert_equal(path: Path) -> None:
    want, got = ref_load_jpeg(str(path)), load_jpeg(str(path))
    assert (got.width, got.height, got.channels, got.hbd) == \
        (want.width, want.height, want.channels, want.hbd)
    assert got.data.dtype == want.data.dtype == np.uint8
    assert got.data.shape == want.data.shape
    assert np.array_equal(got.data, want.data), \
        int(np.abs(got.data.astype(int) - want.data).max())
    assert got.icc == want.icc


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("quality", (30, 95))
@pytest.mark.parametrize("optimize", (False, True))
@pytest.mark.parametrize("progressive", (False, True))
@pytest.mark.parametrize("subsampling", (0, 1, 2),
                         ids=("444", "422", "420"))
def test_jpeg_equals_reference(tmp_path, subsampling, progressive, optimize,
                               quality, size):
    h, w = size
    path = tmp_path / "in.jpg"
    path.write_bytes(_jpeg(_image(h, w, seed=h * w + quality),
                           quality=quality, subsampling=subsampling,
                           progressive=progressive, optimize=optimize))
    _assert_equal(path)


def _without_dht(data: bytes) -> bytes:
    """The file with its DHT segments taken out (as Motion-JPEG frames
    leave out the standard tables)."""
    out, pos = bytearray(data[:2]), 2
    while True:
        marker, at = jpeg._next_marker(data, pos)
        if marker == 0xDA:
            return bytes(out + data[pos:])
        _, end = jpeg._segment(data, at)
        if marker != 0xC4:
            out += data[pos:end]
        pos = end


@pytest.mark.parametrize("progressive", (False, True))
@pytest.mark.parametrize("variant", ("gray", "cmyk", "restart_blocks",
                                     "restart_rows", "icc", "no_dht"))
def test_jpeg_variant_equals_reference(tmp_path, variant, progressive):
    """The variants beside the grid. A sequential file without DHT takes
    libjpeg's standard tables (Pillow writes exactly those unoptimized); a
    progressive one (always optimized) raises in both packages."""
    px = _image(83, 101, 4, seed=5)
    icc = np.random.default_rng(6).integers(0, 256, 150000,
                                            dtype=np.uint8).tobytes()
    data = {
        "gray": lambda: _jpeg(px[..., 0], "L", progressive=progressive),
        "cmyk": lambda: _jpeg(px, "CMYK", progressive=progressive),
        "restart_blocks": lambda: _jpeg(px[..., :3], progressive=progressive,
                                        restart_marker_blocks=3),
        "restart_rows": lambda: _jpeg(px[..., :3], progressive=progressive,
                                      subsampling=2, restart_marker_rows=1),
        "icc": lambda: _jpeg(px[..., :3], progressive=progressive,
                             icc_profile=icc),
        "no_dht": lambda: _without_dht(_jpeg(px[..., :3],
                                             progressive=progressive)),
    }[variant]()
    path = tmp_path / "in.jpg"
    path.write_bytes(data)
    if variant == "no_dht" and progressive:
        with pytest.raises(OSError):
            ref_load_jpeg(str(path))
        with pytest.raises(ValueError, match="undefined Huffman table"):
            load_jpeg(str(path))
        return
    _assert_equal(path)
    if variant == "icc":
        assert data.count(b"ICC_PROFILE\0") == 3
        assert load_jpeg(str(path)).icc == icc


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_to_its_manifest(name):
    entry = MANIFEST[name]
    path = FIXTURES / name
    for img in (load_jpeg(str(path)), ref_load_jpeg(str(path))):
        assert list(img.data.shape) == entry["shape"]
        assert img.channels == entry["channels"]
        assert zlib.crc32(img.data.tobytes()) == entry["crc32"]
        assert (None if img.icc is None else zlib.crc32(img.icc)) == \
            entry["icc_crc32"]
    _assert_equal(path)


def test_fixtures_fit_their_budget():
    files = [p for p in FIXTURES.iterdir() if p.suffix == ".jpg"]
    assert sorted(p.name for p in files) == sorted(MANIFEST)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 2_000_000


def _truncations():
    base = _jpeg(_image(40, 50, seed=7))
    prog = _jpeg(_image(40, 50, seed=7), progressive=True,
                 restart_marker_blocks=2)
    return {"garbage": b"definitely not a JPEG file" * 10,
            "soi_only": b"\xff\xd8",
            "header_cut": base[:200],
            "scan_cut": base[: len(base) // 2],
            "no_eoi": base[:-2],
            "progressive_scan_cut": prog[: len(prog) // 2],
            "progressive_no_eoi": prog[:-2]}


@pytest.mark.parametrize("case", sorted(_truncations()))
def test_broken_files_raise_in_both_packages(tmp_path, case):
    path = tmp_path / "in.jpg"
    path.write_bytes(_truncations()[case])
    with pytest.raises((OSError, ValueError)):
        ref_load_jpeg(str(path))
    with pytest.raises(ValueError if case == "garbage" else OSError):
        load_jpeg(str(path))


def _with_sof(marker: int, precision: int = 8) -> bytes:
    data = bytearray(_jpeg(_image(16, 16, seed=8)))
    at = data.index(b"\xff\xc0")
    data[at + 1] = marker
    data[at + 4] = precision
    return bytes(data)


@pytest.mark.parametrize("data,variant", [
    (_with_sof(0xC3), "bad JPEG lossless scan (Ss=0 Se=63 Ah=0 Al=0)"),
    (_with_sof(0xCB), "arithmetic-coded lossless JPEG (SOF11)"),
    (_with_sof(0xCD), "arithmetic-coded hierarchical JPEG (SOF13)"),
    (_with_sof(0xC5), "hierarchical JPEG (SOF5)"),
    (_with_sof(0xC0, 12), "12-bit JPEG"),
], ids=("sof3", "sof11", "sof13", "sof5", "12bit"))
def test_unsupported_variant_raises_naming_it(tmp_path, data, variant):
    """Variants the reference refuses too. A DCT file relabelled as
    lossless (SOF3) is read as one, and its scan (Ss=0, Se=63) is no
    lossless scan: libjpeg-turbo refuses it as well
    (``tests/test_torch_jpeg_lossless.py`` holds real lossless files)."""
    path = tmp_path / "in.jpg"
    path.write_bytes(data)
    with pytest.raises((OSError, ValueError, SyntaxError)):
        ref_load_jpeg(str(path))
    with pytest.raises(ValueError, match=re.escape(variant)):
        load_jpeg(str(path))


def _scans(data: bytes):
    """(start, end) of each SOS marker and its entropy-coded data."""
    out, pos = [], 2
    while True:
        marker, pos = jpeg._next_marker(data, pos)
        if marker == 0xD9:
            return out
        start, end = jpeg._segment(data, pos)
        if marker == 0xDA:
            m = jpeg._SEGMENT_END.search(data, end)
            out.append((pos - 2, m.start()))
            end = m.start()
        pos = end


def test_unrefined_progression_is_smoothed_as_libjpeg(tmp_path):
    """A progressive file without its last scan (jpeg_simple_progression's
    final luma AC refinement) leaves the first AC coefficients at Al = 1:
    libjpeg smooths such blocks, and so does this reader."""
    data = _jpeg(_image(32, 48, seed=9), progressive=True)
    start, end = _scans(data)[-1]
    cut = data[:start] + data[end:]
    path = tmp_path / "in.jpg"
    path.write_bytes(cut)
    r = jpeg._Reader(cut)
    r.read()
    assert r.smoothed()
    _assert_equal(path)
    # with the last scan the same file is not smoothed
    path.write_bytes(data)
    r = jpeg._Reader(data)
    r.read()
    assert not r.smoothed()
    _assert_equal(path)


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    """``jpeg_writer.c`` built against the system's libjpeg."""
    exe = tmp_path_factory.mktemp("writer") / "jpeg_writer"
    subprocess.run(["gcc", "-O2", "-o", str(exe),
                    str(FIXTURES / "jpeg_writer.c"), "-ljpeg"], check=True)
    return exe


def _written(writer, tmp_path, px: np.ndarray, variant: str) -> Path:
    raw = tmp_path / "in.raw"
    raw.write_bytes(np.ascontiguousarray(px).tobytes())
    path = tmp_path / "in.jpg"
    h, w, ch = px.shape
    subprocess.run([str(writer), str(raw), str(w), str(h), str(ch), "85",
                    variant, str(path)], check=True)
    return path


def _dac(data: bytes) -> list:
    """The payloads of the file's DAC segments."""
    out, pos = [], 2
    while True:
        marker, pos = jpeg._next_marker(data, pos)
        if marker == 0xDA:
            return out
        start, end = jpeg._segment(data, pos)
        if marker == 0xCC:
            out.append(data[start:end])
        pos = end


ARITH = {"seq_420": "arith+baseline", "seq_444": "arith+444",
         "seq_420_restart": "arith+rst+baseline",
         "seq_444_restart": "arith+rst+444",
         "progressive": "arith+progressive",
         "progressive_restart": "arith+rst+progressive",
         "gray": "arith+baseline", "gray_progressive": "arith+progressive",
         "dac": "dac+baseline", "dac_progressive": "dac+progressive"}


@pytest.mark.parametrize("size", ((61, 97), (1, 1), (33, 47)),
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("case", sorted(ARITH))
def test_arithmetic_equals_reference(tmp_path, writer, case, size):
    """SOF9 and SOF10 files from libjpeg's arithmetic encoder, which
    writes a DAC marker before every scan: the default conditioning, and
    in the ``dac`` cases L, U and K other than the defaults."""
    h, w = size
    px = _image(h, w, 1 if "gray" in case else 3, seed=h * w + 3)
    path = _written(writer, tmp_path, px, ARITH[case])
    data = path.read_bytes()
    sof = b"\xff\xca" if "progressive" in case else b"\xff\xc9"
    assert sof in data
    dac = b"".join(_dac(data))
    assert dac
    assert (b"\x00\x62" in dac) == case.startswith("dac")  # L=2, U=6
    _assert_equal(path)


SMOOTHED = {
    "no_refinement": "progressive_unrefined",
    "ac_al2": "scans:0,1,2:0-0:0:0;0:1-63:0:2;1:1-63:0:2;2:1-63:0:2",
    "luma_6_63_al1": "scans:0,1,2:0-0:0:0;0:1-5:0:0;0:6-63:0:1;"
                     "1:1-63:0:0;2:1-63:0:0",
    "luma_1_9_missing": "scans:0,1,2:0-0:0:0;0:10-63:0:0;1:1-63:0:1;"
                        "2:1-63:0:1",
    "refined_to_al1": "scans:0,1,2:0-0:0:1;0:1-63:0:2;0:1-63:2:1;"
                      "1:1-63:0:1;2:1-63:0:1;0,1,2:0-0:1:0",
    "dc_al1_no_chroma_ac": "scans:0,1,2:0-0:0:1;0:1-63:0:0",
    "dc_only": "scans:0,1,2:0-0:0:0",
    "dc_al1_444": "444+scans:0,1,2:0-0:0:1;0:1-63:0:0",
    "arith_ac_al2": "arith+scans:0,1,2:0-0:0:1;0:1-63:0:2;1:1-63:0:2;"
                    "2:1-63:0:2",
    "gray_ac_al2": "scans:0:0-0:0:1;0:1-63:0:2",
}


@pytest.mark.parametrize("size", ((61, 97), (1, 1), (33, 47), (100, 130)),
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("case", sorted(SMOOTHED))
def test_block_smoothing_equals_reference(tmp_path, writer, case, size):
    """Progressive scan scripts that leave one of the first nine AC
    coefficients unrefined, so that libjpeg smooths the blocks: at Al = 1
    or 2, or never sent (with the DC then estimated from a 5x5
    neighbourhood where a component has no AC data at all, and the DC
    itself left at Al = 1 in some); heights whose last iMCU row is
    partial."""
    h, w = size
    px = _image(h, w, 1 if "gray" in case else 3, seed=h * w + 4)
    path = _written(writer, tmp_path, px, SMOOTHED[case])
    r = jpeg._Reader(path.read_bytes())
    r.read()
    assert r.smoothed()
    no_ac = [all(b == -1 for b in c.coef_bits[1:10]) for c in r.comps]
    assert any(no_ac) == (case.startswith(("dc_", "luma_1_9")))
    _assert_equal(path)


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


@pytest.mark.parametrize("args", (["-t", "80"], ["-q", "60"]),
                         ids=("t80", "q60"))
def test_cli_on_jpeg_matches_reference_and_pam(tmp_path, capsys,
                                               monkeypatch, args):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")
    rgb = bench_images(256, ("mixed",))["mixed"]
    src = tmp_path / "mixed.jpg"
    src.write_bytes(_jpeg(rgb, quality=85, subsampling=2))
    ref, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found == ref_found
    assert ref[4:12] == got[4:12] == b"ftypavif"
    pam = tmp_path / "mixed.pam"
    write_pam(pam, load_jpeg(str(src)).data)
    via_pam, pam_found = _run(port_cli, args, pam, tmp_path / "pam.avif",
                              capsys)
    assert (got, found) == (via_pam, pam_found)
