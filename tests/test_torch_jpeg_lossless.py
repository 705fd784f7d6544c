"""The port's lossless JPEG reader (``SOF3``, Huffman-coded: the lossless
scans of ``oavif_tpu_torch/io/jpeg_decode.c``) against the reference's
``load_jpeg`` (Pillow, so libjpeg-turbo), on the CPU, with no tolerance.

The files come from the numpy writer
``tests/torch_fixtures/jpeg/lossless_jpeg.py`` (the system's libjpeg-turbo
cannot write lossless files): predictors 1-7, point transforms 0 and 2,
1, 3 and 4 components, sizes from 1x1, with and without restart markers;
subsampled components in one interleaved scan or one scan each; the
``JFIF`` and Adobe markers and component ids that pick the colour space;
and the committed fixtures of ``tests/torch_fixtures/jpeg_lossless``. With
point transform 0 the pixels are also the source's: libjpeg-turbo
upsamples lossless files by boxes and converts no colours, and a file it
would have to convert from YCbCr raises in both packages. Broken scans
raise in both.
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
sys.path.insert(0, str(ROOT / "tests" / "torch_fixtures" / "jpeg"))
sys.path.insert(0, str(ROOT / "tests" / "torch_fixtures" / "jpeg_lossless"))

import make_jpeg_lossless  # noqa: E402
from chip_smoke import write_pam  # noqa: E402
from lossless_jpeg import encode  # noqa: E402
from oavif_tpu import cli as ref_cli  # noqa: E402
from oavif_tpu.io.image import load_jpeg as ref_load_jpeg  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.io import jpeg  # noqa: E402
from oavif_tpu_torch.io.image import load_jpeg  # noqa: E402

FIXTURES = ROOT / "tests" / "torch_fixtures" / "jpeg_lossless"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
SIZES = ((1, 1), (7, 9), (17, 13), (40, 33))  # (h, w)
REFUSED = (OSError, ValueError, SyntaxError)


def _image(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """Waves under noise, so every difference category up to 8 shows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    wave = np.sin(xx / 5.0)[..., None] * np.cos(yy / 7.0)[..., None]
    px = 128 + 80 * wave + rng.normal(0, 25, (h, w, channels))
    return np.clip(px, 0, 255).astype(np.uint8)


def _write(tmp_path: Path, data: bytes) -> Path:
    path = tmp_path / "in.jpg"
    path.write_bytes(data)
    return path


def _assert_equal(path: Path) -> np.ndarray:
    want, got = ref_load_jpeg(str(path)), load_jpeg(str(path))
    assert (got.width, got.height, got.channels, got.hbd, got.icc) == \
        (want.width, want.height, want.channels, want.hbd, want.icc)
    assert got.data.dtype == want.data.dtype == np.uint8
    assert np.array_equal(got.data, want.data), \
        int(np.abs(got.data.astype(int) - want.data).max())
    return got.data


def _as_loaded(px: np.ndarray) -> np.ndarray:
    """The source as load_jpeg gives it back: gray as one channel, CMYK
    samples (Adobe's inverted convention) through Pillow's conversion."""
    if px.shape[2] == 4:
        return jpeg.cmyk_to_rgb(px)
    return px


@pytest.mark.parametrize("restart_rows", (0, 2), ids=("norst", "rst2"))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("channels", (1, 3, 4))
@pytest.mark.parametrize("pt", (0, 2))
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_equals_reference(tmp_path, predictor, pt, channels, size,
                                   restart_rows):
    h, w = size
    px = _image(h, w, channels, seed=h * w + 7 * predictor + channels)
    data = encode(px if channels > 1 else px[..., 0], predictor=predictor,
                  pt=pt, restart_rows=restart_rows)
    assert data[2:4] == b"\xff\xc3"
    got = _assert_equal(_write(tmp_path, data))
    want = px if pt == 0 else (px >> pt) << pt
    assert np.array_equal(got, _as_loaded(want))


SAMPLINGS = {"444": ((1, 1),) * 3, "h2v2": ((2, 2), (1, 1), (1, 1)),
             "h2v1": ((2, 1), (1, 1), (1, 1)),
             "h1v2": ((1, 2), (1, 1), (1, 1)),
             "chroma_h2v2": ((1, 1), (2, 2), (1, 1)),
             "h4v1_h2v1": ((4, 1), (1, 1), (2, 1)),
             "cmyk_h2v2_h1v2": ((2, 2), (1, 1), (1, 1), (1, 2))}


@pytest.mark.parametrize("restart_rows", (0, 1, 3),
                         ids=("norst", "rst1", "rst3"))
@pytest.mark.parametrize("interleaved", (True, False),
                         ids=("interleaved", "scans"))
@pytest.mark.parametrize("case", sorted(SAMPLINGS))
def test_lossless_sampling_equals_reference(tmp_path, case, interleaved,
                                            restart_rows):
    """Subsampled components, upsampled by boxes. One scan per component
    with restart markers inside an iMCU row (a component of 2 rows per
    iMCU row, restarted every row or every 3): libjpeg-turbo undifferences
    a whole iMCU row once it is decoded, so it starts the first-row
    prediction again at the iMCU row's first row and not at the marker's
    row, and its pixels are not the source's there; the port's are
    libjpeg-turbo's."""
    sampling = SAMPLINGS[case]
    h, w = 13, 21
    px = _image(h, w, len(sampling), seed=len(case) + restart_rows)
    planes = make_jpeg_lossless._planes(px, sampling)
    data = encode(planes, predictor=5, sampling=sampling, size=(h, w),
                  interleaved=interleaved, restart_rows=restart_rows)
    got = _assert_equal(_write(tmp_path, data))
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    boxes = np.stack([np.repeat(np.repeat(p, vmax // v, 0), hmax // hx,
                                1)[:h, :w]
                      for p, (hx, v) in zip(planes, sampling)], -1)
    quirk = not interleaved and restart_rows % 2 and vmax > 1 and \
        any(v > 1 for _, v in sampling)
    assert np.array_equal(got, _as_loaded(boxes)) != quirk


MARKERS = (None, "jfif", "adobe0", "adobe1", "adobe2")


@pytest.mark.parametrize("channels", (1, 3, 4))
@pytest.mark.parametrize("marker", MARKERS, ids=lambda m: m or "none")
def test_lossless_colour_space_as_reference(tmp_path, marker, channels):
    """Without a marker, 3 components are RGB whatever their ids; a JFIF
    marker or an Adobe transform other than 0 names YCbCr (or YCCK), which
    libjpeg-turbo does not convert in a lossless file: both packages
    raise."""
    px = _image(9, 11, channels, seed=channels)
    data = encode(px if channels > 1 else px[..., 0], predictor=1,
                  marker=marker, ids=(5, 6, 7, 8)[:channels])
    path = _write(tmp_path, data)
    ycc = channels > 1 and marker in ("jfif", "adobe1", "adobe2") and \
        not (channels == 4 and marker == "jfif")
    if ycc:
        with pytest.raises(REFUSED):
            ref_load_jpeg(str(path))
        with pytest.raises(ValueError, match="unsupported lossless JPEG in "
                                             "(YCbCr|YCCK)"):
            load_jpeg(str(path))
        return
    assert np.array_equal(_assert_equal(path), _as_loaded(px))


@pytest.mark.parametrize("ids", ((1, 2, 3), (82, 71, 66), (0, 1, 2)))
@pytest.mark.parametrize("shared_table", (True, False),
                         ids=("one_table", "table_each"))
def test_lossless_ids_and_tables_equal_reference(tmp_path, ids,
                                                 shared_table):
    px = _image(31, 45, 3, seed=sum(ids))
    data = encode(px, predictor=4, ids=ids, shared_table=shared_table,
                  restart_rows=4)
    assert np.array_equal(_assert_equal(_write(tmp_path, data)), px)


def _scan_params(data: bytes, params: bytes) -> bytes:
    """The file with its (first) scan header's Ss, Se and Ah|Al."""
    at = data.index(b"\xff\xda")
    end = at + 2 + ((data[at + 2] << 8) | data[at + 3])
    return data[: end - 3] + params + data[end:]


def _broken() -> dict:
    px = _image(20, 10, 3, seed=11)
    base = encode(px, predictor=1, restart_rows=1)
    no_dht = bytearray()
    pos = 2
    no_dht += base[:2]
    while True:
        marker, at = jpeg._next_marker(base, pos)
        if marker == 0xDA:
            no_dht += base[pos:]
            break
        _, end = jpeg._segment(base, at)
        if marker != 0xC4:
            no_dht += base[pos:end]
        pos = end
    dht = base.index(b"\xff\xc4")
    n = sum(base[dht + 5: dht + 21])
    sym17 = bytearray(base)
    sym17[dht + 21 + n - 1] = 17  # the table's last symbol
    return {
        "predictor_0": _scan_params(base, b"\x00\x00\x00"),
        "predictor_8": _scan_params(base, b"\x08\x00\x00"),
        "se_1": _scan_params(base, b"\x01\x01\x00"),
        "ah_1": _scan_params(base, b"\x01\x00\x10"),
        "pt_8": _scan_params(base, b"\x01\x00\x08"),
        "restart_half_row": base.replace(b"\xff\xdd\x00\x04\x00\x0a",
                                         b"\xff\xdd\x00\x04\x00\x05"),
        "no_dht": bytes(no_dht),
        "dc_symbol_17": bytes(sym17),
        "sof11": base.replace(b"\xff\xc3", b"\xff\xcb", 1),
        "sof7": base.replace(b"\xff\xc3", b"\xff\xc7", 1),
        "12bit": base.replace(b"\xff\xc3\x00\x11\x08", b"\xff\xc3\x00\x11\x0c",
                              1),
        "cut": base[: len(base) // 2],
    }


@pytest.mark.parametrize("case", sorted(_broken()))
def test_broken_lossless_raises_in_both_packages(tmp_path, case):
    data = _broken()[case]
    assert data != encode(_image(20, 10, 3, seed=11), predictor=1,
                          restart_rows=1)
    path = _write(tmp_path, data)
    with pytest.raises(REFUSED) as raised:
        ref_load_jpeg(str(path))
    want = ValueError
    if case == "cut":  # Pillow's suspending source runs dry in the scan
        assert isinstance(raised.value, OSError)
        want = OSError  # test_torch_jpeg_cut.py: cut files Pillow decodes
    with pytest.raises(want):
        load_jpeg(str(path))


@pytest.mark.parametrize("restart_rows", (0, 3), ids=("norst", "rst3"))
def test_lossless_out_of_data_as_reference(tmp_path, restart_rows):
    """Scan data cut short before the EOI marker: libjpeg-turbo decodes
    zeros and starts the prediction again at the next MCU row, so the
    rest of the interval is the initial predictor (128); with restart
    markers lost as well, every row after the cut."""
    px = _image(30, 30, 3, seed=12)
    data = encode(px, predictor=1, restart_rows=restart_rows)
    short = data[: len(data) // 2] + b"\xff\xd9"
    got = _assert_equal(_write(tmp_path, short))
    assert (got[-1] == 128).all() and np.array_equal(got[0], px[0])


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_lossless_fixture_decodes_to_its_manifest(name):
    entry = MANIFEST[name]
    path = FIXTURES / name
    px, kw = make_jpeg_lossless.files()[name]
    assert path.read_bytes() == make_jpeg_lossless.lossless(px, kw)
    for img in (load_jpeg(str(path)), ref_load_jpeg(str(path))):
        assert list(img.data.shape) == entry["shape"]
        assert img.channels == entry["channels"]
        assert zlib.crc32(img.data.tobytes()) == entry["crc32"]
    got = _assert_equal(path)
    src = px[..., None] if px.ndim == 2 else px
    assert (src.shape == got.shape and np.array_equal(src, got)) == \
        entry["equals_source"]


def test_lossless_fixtures_fit_their_budget():
    files = [p for p in FIXTURES.iterdir() if p.suffix == ".jpg"]
    assert sorted(p.name for p in files) == sorted(MANIFEST)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 600_000


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


def test_cli_on_lossless_jpeg_matches_reference_and_pam(tmp_path, capsys,
                                                        monkeypatch):
    """``-t 80`` on a 256x256 lossless JPEG of the text class: the
    reference CLI's q and passes, and the bytes of the port's CLI on the
    same pixels as PAM."""
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")
    args = ["-t", "80"]
    src = tmp_path / "text.jpg"
    px = make_jpeg_lossless.files()["text_p1.jpg"][0][:256, :256]
    src.write_bytes(encode(px, predictor=1))
    ref, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found == ref_found
    assert got[4:12] == b"ftypavif"
    pam = tmp_path / "text.pam"
    write_pam(pam, px)
    assert (got, found) == _run(port_cli, args, pam, tmp_path / "pam.avif",
                                capsys)
