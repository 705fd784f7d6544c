"""JPEG files that end before their ``EOI`` marker: the port's reader
(``oavif_tpu_torch/io/jpeg.py`` and ``io/jpeg_decode.c``) against the
reference's ``load_jpeg`` (Pillow, so libjpeg-turbo behind a suspending
source), on the CPU, with no tolerance. Where Pillow decodes such a file
the port gives its pixels; where Pillow raises the port raises
``OSError``.

The committed fixtures (``tests/torch_fixtures/jpeg_cut``, written by
``make_jpeg_cut.py`` beside them) cut baseline 4:2:0 and 4:4:4, gray,
restart-marker, progressive, lossless and arithmetic files in their
headers, in their scans, after their last byte but one, on the 0xFF of
the ``EOI`` and right before it; a grid cuts seeded files of each kind
at every point of their last bytes, live against Pillow. Pillow hands
libjpeg the data 64 KiB at a time and an arithmetic scan cannot wait
for more, so Pillow refuses a whole arithmetic file whose scan crosses
that edge; the port, which has the whole file, decodes it to libjpeg's
pixels (Pillow's, read in one block), a difference kept on purpose. Two
whole arithmetic files around that edge are fixtures, and a sweep moves
the edge across whole arithmetic files, live. End to end,
the port's CLI on a cut file that Pillow decodes gives the q, passes and
bytes of its CLI on those pixels as PAM, and the reference CLI's q and
passes.
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

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests" / "torch_fixtures" / "jpeg"))
sys.path.insert(0, str(ROOT / "tests" / "torch_fixtures" / "jpeg_cut"))

import make_jpeg_cut  # noqa: E402
from chip_smoke import write_pam  # noqa: E402
from lossless_jpeg import encode  # noqa: E402
from oavif_tpu import cli as ref_cli  # noqa: E402
from oavif_tpu.io.image import load_jpeg as ref_load_jpeg  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.io import jpeg  # noqa: E402
from oavif_tpu_torch.io.image import load_jpeg  # noqa: E402

FIXTURES = ROOT / "tests" / "torch_fixtures" / "jpeg_cut"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())


def _image(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    wave = np.sin(xx / 5.0)[..., None] * np.cos(yy / 7.0)[..., None]
    px = 128 + 80 * wave + rng.normal(0, 20, (h, w, channels))
    return np.clip(px, 0, 255).astype(np.uint8)


def _pillow_file(px: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    PILImage.fromarray(px[..., 0] if px.shape[2] == 1 else px).save(
        buf, "JPEG", **kw)
    return buf.getvalue()


def _one_block(data: bytes) -> np.ndarray:
    """Pillow's RGB pixels when it hands libjpeg the whole file at
    once."""
    im = PILImage.open(io.BytesIO(data))
    im.decodermaxblock = len(data)
    im.load()
    return np.asarray(im.convert("RGB"))


def _held_to_reference(tmp_path: Path, data: bytes,
                       whole: bool = False) -> bool:
    """Both packages decode data to equal pixels (True), or both raise,
    the port with OSError (False). For ``whole`` data that Pillow refuses
    the port gives the pixels of Pillow's read in one block (False)."""
    path = tmp_path / "in.jpg"
    path.write_bytes(data)
    try:
        want = ref_load_jpeg(str(path))
    except OSError:
        if whole:
            assert np.array_equal(load_jpeg(str(path)).data,
                                  _one_block(data))
            return False
        with pytest.raises(OSError):
            load_jpeg(str(path))
        return False
    got = load_jpeg(str(path))
    assert got.data.shape == want.data.shape
    assert np.array_equal(got.data, want.data)
    return True


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_cut_fixture_equals_manifest_and_reference(name):
    entry = MANIFEST[name]
    path = FIXTURES / name
    assert len(path.read_bytes()) == entry["keep"] <= entry["whole"]
    assert (entry["keep"] == entry["whole"]) == name.startswith("arith_block")
    loads = [load_jpeg, ref_load_jpeg]
    if "raises" in entry:
        with pytest.raises(OSError):
            ref_load_jpeg(str(path))
        loads.pop()
        if "libjpeg" not in entry:
            with pytest.raises(OSError):
                load_jpeg(str(path))
            return
        entry = entry["libjpeg"]
        px = _one_block(path.read_bytes())
        assert zlib.crc32(px.tobytes()) == entry["crc32"]
    for img in (load(str(path)) for load in loads):
        assert list(img.data.shape) == entry["shape"]
        assert img.channels == entry["channels"]
        assert zlib.crc32(img.data.tobytes()) == entry["crc32"]


def test_cut_fixtures_cover_the_cases():
    """Lossy and lossless files that Pillow decodes without their EOI,
    progressive and arithmetic ones, which it never decodes, and whole
    arithmetic files on either side of Pillow's 64 KiB edge: the one
    past it only the port decodes."""
    decodes = {n for n, e in MANIFEST.items() if "crc32" in e}
    assert {"base420_noeoi.jpg", "lossless_noeoi.jpg",
            "rst_noeoi.jpg", "text256_noeoi.jpg",
            "arith_block_progressive.jpg"} <= decodes
    assert "arith_block_past.jpg" not in decodes
    assert [n for n, e in MANIFEST.items() if "libjpeg" in e] == \
        ["arith_block_past.jpg"]
    assert not any(n.startswith(("progressive", "arith_"))
                   and not n.startswith("arith_block") for n in decodes)
    assert {n.rsplit("_", 1)[0] for n in MANIFEST} == \
        set(make_jpeg_cut.SOURCES) | {"text256", "arith_block"}
    assert all(e["whole"] > make_jpeg_cut.BLOCK for n, e in MANIFEST.items()
               if n.startswith("arith_block"))




def test_cut_fixtures_fit_their_budget():
    files = [p for p in FIXTURES.iterdir() if p.suffix == ".jpg"]
    assert sorted(p.name for p in files) == sorted(MANIFEST)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 250_000


KINDS = {
    "420": lambda px: _pillow_file(px, quality=85),
    "444": lambda px: _pillow_file(px, quality=90, subsampling=0),
    "gray": lambda px: _pillow_file(px[..., :1], quality=80),
    "rst": lambda px: _pillow_file(px, quality=85, restart_marker_blocks=1),
    "progressive": lambda px: _pillow_file(px, quality=85,
                                           progressive=True),
    "lossless": lambda px: encode(px, predictor=1),
    "lossless_rst": lambda px: encode(px[..., 0], predictor=7,
                                      restart_rows=2),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cut_grid_as_reference(tmp_path, kind):
    """Seeded files of each kind, cut at every one of their last 12 bytes
    and in the middle: wherever Pillow decodes, the port gives its pixels;
    wherever it raises, the port raises OSError. A progressive file is
    read whole before its rows: it never decodes without its EOI."""
    decoded = 0
    for seed in range(20):
        data = KINDS[kind](_image(16 + seed % 9, 16 + seed % 7, 3, seed))
        for keep in (len(data) // 2, *range(len(data) - 12, len(data))):
            decoded += _held_to_reference(tmp_path, data[:keep])
    if kind == "progressive":
        assert decoded == 0


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    """``jpeg_writer.c`` built against the system's libjpeg."""
    exe = tmp_path_factory.mktemp("writer") / "jpeg_writer"
    subprocess.run(["gcc", "-O2", "-o", str(exe),
                    str(ROOT / "tests" / "torch_fixtures" / "jpeg"
                        / "jpeg_writer.c"), "-ljpeg"], check=True)
    return exe


@pytest.mark.parametrize("variant", ("arith+rst+baseline",
                                     "arith+progressive"))
def test_arithmetic_scans_within_pillow_blocks(tmp_path, writer, variant):
    """A whole arithmetic file behind comments that move Pillow's 64 KiB
    block edge across it, from before its first scan to past its EOI:
    wherever Pillow decodes, the port gives its pixels; wherever it
    raises, the port, which has the whole file, gives the pixels of
    Pillow's read in one block. Pillow decodes where the edge falls in
    the markers before a scan and no scan crosses it."""
    px = _image(96, 96, 3, seed=6)
    raw = tmp_path / "in.raw"
    px.tofile(raw)
    out = tmp_path / "a.jpg"
    subprocess.run([str(writer), str(raw), "96", "96", "3", "90", variant,
                    str(out)], check=True)
    data = out.read_bytes()
    block = make_jpeg_cut.BLOCK
    sizes = range(block - len(data) - 8, block - 4, 61)
    decoded = 0
    for size in sizes:
        decoded += _held_to_reference(
            tmp_path, make_jpeg_cut.with_comment(data, size), whole=True)
    assert 0 < decoded < len(sizes)


def test_cut_fixtures_are_prefixes_of_their_writers_files(tmp_path, writer):
    """Every fixture regenerates byte for byte: Pillow's, the numpy
    writer's and the libjpeg writer's files, cut where the generator
    cuts them."""
    made = make_jpeg_cut.files(make_jpeg_cut.libjpeg_writer(str(writer),
                                                            str(tmp_path)))
    assert sorted(made) == sorted(MANIFEST)
    for name, (whole, keep) in made.items():
        assert (FIXTURES / name).read_bytes() == whole[:keep], name


def test_single_scan_tail_is_read_as_libjpeg_finishes(tmp_path):
    """After a single-scan file's scan Pillow's decoder has its rows and
    jpeg_finish_decompress reads on to the EOI: the end of the data
    there is no error, a marker it cannot take is, and raises OSError
    in both."""
    data = _pillow_file(_image(20, 20, 3, 5), quality=80)[:-2]
    sos = data.index(b"\xff\xda")
    for tail, decodes in ((b"\xff\xfe\x00", True),
                          (b"\xff\xc4\x00\x40\x00", True),
                          (b"junk\xff\xd0\xff\xd9", True),
                          (data[sos:], False),
                          (b"\xff\xc5\x00\x03\x00", False),
                          (b"\xff\x02\x00\x02", False)):
        path = tmp_path / "in.jpg"
        path.write_bytes(data + tail)
        if decodes:
            _held_to_reference(tmp_path, data + tail)
            continue
        with pytest.raises(OSError):
            ref_load_jpeg(str(path))
        with pytest.raises(OSError):
            jpeg.decode_jpeg(data + tail)


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_cut_jpeg_matches_reference_and_pam(tmp_path, capsys,
                                                   monkeypatch):
    """``-t 80`` on a 64x64 baseline file cut before its EOI that Pillow
    decodes: the reference CLI's q and passes, and the bytes of the
    port's CLI on the same pixels as PAM."""
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")
    for seed in range(200):
        whole = _pillow_file(_image(64, 64, 3, seed), quality=90)
        if _held_to_reference(tmp_path, whole[:-2]):
            break
    args = ["-t", "80"]
    src = tmp_path / "cut.jpg"
    src.write_bytes(whole[:-2])
    ref, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found == ref_found
    pam = tmp_path / "cut.pam"
    write_pam(pam, load_jpeg(str(src)).data)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)
