"""The port's WebP reader (``oavif_tpu_torch/io/webp.py`` and its C,
``io/webp_decode.c``) against the reference's ``load_webp`` (Pillow, so
libwebp's animation decoder in ``MODE_RGBA``), on the CPU: equal shape,
channels and pixels, with no tolerance, and no ICC profile, on a grid of
Pillow-written lossy files (quality x method x sizes from 1x1 to
509x383), lossless files (gradients, noise and 2-, 4-, 16- and
256-colour images, with and without alpha and ``exact``), lossy files
with alpha at several alpha qualities, files from
``tests/torch_fixtures/webp/webp_writer.c`` (a libwebp program built here
with gcc) for what Pillow cannot set (token partitions, segments, the
simple filter, sharpness 7, no filter, raw and filtered alpha planes,
near-lossless), animations (Pillow's, and hand-made ones whose first
frame lies at an offset on a larger canvas), ``ICCP``, ``EXIF`` and
unknown chunks, and the committed fixtures, each also held to its
manifest CRC. The VP8 decoder's Y'UV planes are first held to libwebp's
own (``WebPDecodeYUV`` through ctypes, in this test only). Broken and
truncated files raise ``OSError`` in both packages; a VP8 inter frame
raises ``UnsupportedWebP``, an ``OSError`` and a ``ValueError``. End to
end, the port's CLI on a 256x256 WebP gives the reference CLI's q and
passes, and the bytes of the port's CLI on the decoded pixels as PAM.
"""

from __future__ import annotations

import ctypes
import ctypes.util
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
from oavif_tpu.io.image import load_webp as ref_load_webp  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.av1.entropy.fast import get_lib  # noqa: E402
from oavif_tpu_torch.io import webp  # noqa: E402
from oavif_tpu_torch.io.image import load_webp  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "webp"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
SIZES = ((1, 1), (7, 9), (17, 13), (64, 64), (383, 509))  # (h, w)


def _image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth waves under noise, with a tint that moves across."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    wave = np.sin(xx / 5.0)[..., None] * np.cos(yy / 7.0)[..., None]
    tint = np.linspace(-40, 40, 3) * np.cos(xx / 13.0)[..., None]
    px = 128 + 80 * wave + tint + rng.normal(0, 20, (h, w, 3))
    return np.clip(px, 0, 255).astype(np.uint8)


def _with_alpha(rgb: np.ndarray, seed: int = 1) -> np.ndarray:
    """A ramp of alpha with noise, zero in the top-left quarter."""
    h, w = rgb.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    a = xx * 5 + yy * 3 + np.random.default_rng(seed).normal(0, 10, (h, w))
    a = np.clip(a, 0, 255).astype(np.uint8)
    a[: h // 2, : w // 3] = 0
    return np.concatenate([rgb, a[..., None]], -1)


def _webp(px, **kw) -> bytes:
    buf = io.BytesIO()
    if isinstance(px, list):
        frames = [PILImage.fromarray(p) for p in px]
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                       **kw)
    else:
        PILImage.fromarray(px).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _assert_equal(path: Path) -> None:
    want, got = ref_load_webp(str(path)), load_webp(str(path))
    assert (got.width, got.height, got.channels, got.hbd) == \
        (want.width, want.height, want.channels, want.hbd)
    assert got.data.dtype == want.data.dtype == np.uint8
    assert got.data.shape == want.data.shape
    assert np.array_equal(got.data, want.data), \
        int(np.abs(got.data.astype(int) - want.data).max())
    assert got.icc is None and want.icc is None


def _check(tmp_path, data: bytes) -> Path:
    path = tmp_path / "in.webp"
    path.write_bytes(data)
    _assert_equal(path)
    return path


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("method", (0, 4, 6))
@pytest.mark.parametrize("quality", (10, 80, 100))
def test_lossy_equals_reference(tmp_path, quality, method, size):
    h, w = size
    _check(tmp_path, _webp(_image(h, w, seed=h * w + quality),
                           quality=quality, method=method))


def _lossless_images(h: int, w: int) -> dict:
    rng = np.random.default_rng(h + w)
    yy, xx = np.mgrid[0:h, 0:w]
    out = {
        "gradient": np.stack([xx * 255 // max(w - 1, 1),
                              yy * 255 // max(h - 1, 1), (xx + yy) % 256],
                             -1).astype(np.uint8),
        "noise": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        "smooth": _image(h, w, seed=3),
    }
    for n in (2, 4, 16, 256):
        pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        out[f"colours{n}"] = pal[(xx // 3 + yy // 5 + rng.integers(
            0, 2, (h, w))) % n]
    return out


@pytest.mark.parametrize("size", ((1, 1), (17, 33), (64, 64)),
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("alpha", ("none", "alpha", "alpha_exact"))
@pytest.mark.parametrize("kind", ("gradient", "noise", "smooth", "colours2",
                                  "colours4", "colours16", "colours256"))
def test_lossless_equals_reference(tmp_path, kind, alpha, size):
    """Colour indexing with 1, 2 and 4 bits a pixel and the full palette,
    the predictor, cross-colour and subtract-green transforms and the
    colour cache, as libwebp's encoder picks them; with alpha, the RGB
    under alpha 0 as the encoder left it (zeroed unless ``exact``)."""
    h, w = size
    px = _lossless_images(h, w)[kind]
    kw = dict(lossless=True, quality=100 if kind == "smooth" else 50,
              method=6 if kind in ("gradient", "colours16") else 4)
    if alpha != "none":
        px = _with_alpha(px)
        kw["exact"] = alpha == "alpha_exact"
    _check(tmp_path, _webp(px, **kw))


@pytest.mark.parametrize("size", ((1, 1), (33, 47), (64, 64)),
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("alpha_quality", (0, 50, 100))
@pytest.mark.parametrize("quality", (30, 90))
def test_lossy_with_alpha_equals_reference(tmp_path, quality, alpha_quality,
                                           size):
    """VP8 with an ALPH chunk: the RGB under alpha 0 decoded as it is."""
    h, w = size
    path = _check(tmp_path, _webp(_with_alpha(_image(h, w, seed=w)),
                                  quality=quality,
                                  alpha_quality=alpha_quality))
    assert b"ALPH" in path.read_bytes()
    assert load_webp(str(path)).channels == 4


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    """``webp_writer.c`` built against the system's libwebp."""
    exe = tmp_path_factory.mktemp("writer") / "webp_writer"
    subprocess.run(["gcc", "-O2", "-o", str(exe),
                    str(FIXTURES / "webp_writer.c"), "-lwebp"], check=True)
    return exe


WRITER = {
    "partitions0": ["partitions=0"], "partitions1": ["partitions=1"],
    "partitions2": ["partitions=2"], "partitions3": ["partitions=3"],
    "segments1": ["segments=1"], "segments2": ["segments=2"],
    "segments3": ["segments=3"],
    "segments4": ["segments=4", "sns_strength=100"],
    "simple_filter": ["filter_type=0", "filter_strength=60"],
    "normal_filter": ["filter_type=1", "filter_strength=60"],
    "no_filter": ["filter_strength=0"],
    "sharpness7": ["filter_sharpness=7", "filter_strength=80"],
    "simple_sharpness5": ["filter_type=0", "filter_sharpness=5",
                          "filter_strength=100"],
    "alpha_raw": ["alpha_compression=0"],
    "alpha_filter0": ["alpha_filtering=0"],
    "alpha_filter1": ["alpha_filtering=1"],
    "alpha_filter2": ["alpha_filtering=2"],
    "alpha_raw_filter2": ["alpha_compression=0", "alpha_filtering=2"],
    "near_lossless40": ["lossless=1", "near_lossless=40"],
    "near_lossless80_exact": ["lossless=1", "near_lossless=80", "exact=1"],
    "q5_m6_seg4_part3": ["quality=5", "method=6", "segments=4",
                         "partitions=3"],
}


@pytest.mark.parametrize("size", ((1, 1), (33, 47), (130, 100)),
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("case", sorted(WRITER))
def test_writer_variant_equals_reference(tmp_path, writer, case, size):
    h, w = size
    settings = WRITER[case]
    px = _image(h, w, seed=h + w)
    if any(s.startswith("alpha") for s in settings):
        px = _with_alpha(px, seed=w)
    raw = tmp_path / "in.raw"
    raw.write_bytes(px.tobytes())
    path = tmp_path / "in.webp"
    subprocess.run([str(writer), str(raw), str(w), str(h), str(px.shape[2]),
                    str(path), *settings], check=True)
    _assert_equal(path)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + len(payload).to_bytes(4, "little") + payload + \
        b"\0" * (len(payload) & 1)


def _riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def _image_chunks(data: bytes) -> bytes:
    """The ALPH and image chunks of a WebP file."""
    out, pos = b"", 12
    while pos < len(data):
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        nxt = pos + 8 + size + (size & 1)
        if data[pos:pos + 4] in (b"ALPH", b"VP8 ", b"VP8L"):
            out += data[pos:nxt]
        pos = nxt
    return out


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0])
                  + (w - 1).to_bytes(3, "little")
                  + (h - 1).to_bytes(3, "little"))


def _anmf(x: int, y: int, w: int, h: int, image: bytes) -> bytes:
    return _chunk(b"ANMF", (x // 2).to_bytes(3, "little")
                  + (y // 2).to_bytes(3, "little")
                  + (w - 1).to_bytes(3, "little")
                  + (h - 1).to_bytes(3, "little")
                  + (100).to_bytes(3, "little") + b"\0" + image)


def _made(case: str) -> bytes:
    """Files put together chunk by chunk: animations whose first frame
    lies at an offset, and extended stills with extra chunks."""
    px = _image(20, 26, seed=9)
    lossy = _image_chunks(_webp(px, quality=70))
    alpha = _image_chunks(_webp(_with_alpha(px), quality=70))
    lossless = _image_chunks(_webp(_with_alpha(px), lossless=True))
    anim = _chunk(b"ANIM", b"\xff\xff\xff\xff\0\0")
    second = _anmf(0, 0, 26, 20, lossy)
    if case == "anim_offset_lossy":
        return _riff(_vp8x(0x02, 40, 30), anim, _anmf(6, 4, 26, 20, lossy),
                     second)
    if case == "anim_offset_alpha":
        return _riff(_vp8x(0x12, 41, 31), anim, _anmf(14, 10, 26, 20, alpha),
                     second)
    if case == "anim_offset_lossless":
        return _riff(_vp8x(0x12, 30, 25), anim,
                     _anmf(4, 4, 26, 20, lossless), second)
    if case == "still_extra_chunks":
        return _riff(_vp8x(0x2C, 26, 20), _chunk(b"ICCP", b"icc" * 101),
                     _chunk(b"ABCD", b"unknown"), lossy,
                     _chunk(b"EXIF", b"Exif\0\0" + b"e" * 31),
                     _chunk(b"XMP ", b"<x/>"))
    if case == "alph_without_flag":  # libwebp drops the plane, not the mode
        return _riff(_vp8x(0x00, 26, 20), alpha)
    if case == "alpha_flag_no_alph":
        return _riff(_vp8x(0x10, 26, 20), lossy)
    raise KeyError(case)


@pytest.mark.parametrize("case", ("anim_offset_lossy", "anim_offset_alpha",
                                  "anim_offset_lossless",
                                  "still_extra_chunks", "alph_without_flag",
                                  "alpha_flag_no_alph"))
def test_made_file_equals_reference(tmp_path, case):
    _check(tmp_path, _made(case))


@pytest.mark.parametrize("kind", ("lossy", "lossless", "alpha"))
def test_pillow_animation_is_its_first_frame(tmp_path, kind):
    a, b = _image(48, 64, seed=1), _image(48, 64, seed=2)[::-1]
    if kind == "alpha":
        a, b = _with_alpha(a), _with_alpha(b, seed=3)
    kw = dict(lossless=True) if kind == "lossless" else dict(quality=80)
    path = _check(tmp_path, _webp([a, np.ascontiguousarray(b)],
                                  duration=[100, 100], **kw))
    assert b"ANMF" in path.read_bytes()


def test_icc_and_exif_are_dropped(tmp_path):
    icc = np.random.default_rng(6).integers(0, 256, 3000,
                                            dtype=np.uint8).tobytes()
    data = _webp(_image(40, 50), quality=80, icc_profile=icc,
                 exif=b"Exif\0\0" + b"x" * 64)
    assert b"ICCP" in data and b"EXIF" in data
    path = _check(tmp_path, data)
    assert load_webp(str(path)).icc is None


def _libwebp():
    lib = ctypes.CDLL(ctypes.util.find_library("webp") or "libwebp.so.7")
    lib.WebPDecodeYUV.restype = ctypes.c_void_p
    lib.WebPDecodeYUV.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + \
        [ctypes.c_void_p] * 6
    lib.WebPFree.argtypes = [ctypes.c_void_p]
    return lib


def _libwebp_planes(data: bytes):
    """libwebp's own Y', U and V planes of a lossy file."""
    lib = _libwebp()
    w, h, stride, uv_stride = (ctypes.c_int() for _ in range(4))
    u, v = ctypes.c_void_p(), ctypes.c_void_p()
    y = lib.WebPDecodeYUV(data, len(data), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(u), ctypes.byref(v),
                          ctypes.byref(stride), ctypes.byref(uv_stride))
    assert y
    planes = []
    for ptr, rows, cols, st in ((y, h.value, w.value, stride.value),
                                (u.value, (h.value + 1) // 2,
                                 (w.value + 1) // 2, uv_stride.value),
                                (v.value, (h.value + 1) // 2,
                                 (w.value + 1) // 2, uv_stride.value)):
        buf = (ctypes.c_uint8 * (rows * st)).from_address(ptr)
        planes.append(np.frombuffer(buf, np.uint8).reshape(rows, st)[:, :cols]
                      .copy())
    lib.WebPFree(y)
    return planes


@pytest.mark.parametrize("size", ((1, 1), (17, 13), (64, 64), (383, 509)),
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("quality", (5, 60, 99))
def test_vp8_planes_equal_libwebp(quality, size):
    """The decode is normative: the Y'UV planes before the conversion to
    RGB are libwebp's exactly."""
    h, w = size
    data = _webp(_image(h, w, seed=quality), quality=quality, method=4)
    dmx = webp._Demux(data)
    f = dmx.frames[0]
    got = webp.decode_vp8(get_lib(), dmx.data, *f.image, f.width, f.height)
    for mine, theirs in zip(got, _libwebp_planes(data)):
        assert np.array_equal(mine, theirs)


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_to_its_manifest(name):
    entry = MANIFEST[name]
    path = FIXTURES / name
    for img in (load_webp(str(path)), ref_load_webp(str(path))):
        assert list(img.data.shape) == entry["shape"]
        assert img.channels == entry["channels"]
        assert zlib.crc32(img.data.tobytes()) == entry["crc32"]
    _assert_equal(path)


def test_fixtures_fit_their_budget():
    files = [p for p in FIXTURES.iterdir() if p.suffix == ".webp"]
    assert sorted(p.name for p in files) == sorted(MANIFEST)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 1_500_000


def _broken():
    lossy = _webp(_image(40, 50, seed=7), quality=80)
    lossless = _webp(_image(40, 50, seed=7), lossless=True)
    alpha = _webp(_with_alpha(_image(40, 50, seed=7)), quality=80)
    xored = bytearray(lossless)
    for i in range(30, len(xored)):
        xored[i] ^= 0x5A
    riff_big = bytearray(lossy)
    riff_big[4:8] = (len(lossy) + 100).to_bytes(4, "little")
    return {"garbage": b"definitely not a WebP file" * 10,
            "riff_only": b"RIFF\x04\x00\x00\x00WEBP",
            "bad_first_chunk": b"RIFF\x10\x00\x00\x00WEBPVP8 garbage!",
            "lossy_half": lossy[: len(lossy) // 2],
            "lossy_no_last_byte": lossy[:-1],
            "lossless_half": lossless[: len(lossless) // 2],
            "alpha_cut_in_alph": alpha[:40],
            "lossless_scrambled": bytes(xored),
            "riff_size_past_end": bytes(riff_big)}


@pytest.mark.parametrize("case", sorted(_broken()))
def test_broken_files_raise_in_both_packages(tmp_path, case):
    path = tmp_path / "in.webp"
    path.write_bytes(_broken()[case])
    with pytest.raises(OSError):
        ref_load_webp(str(path))
    with pytest.raises(OSError):
        load_webp(str(path))


def test_trailing_bytes_after_the_riff_are_ignored(tmp_path):
    _check(tmp_path, _webp(_image(40, 50), quality=80) + b"\0" * 10)


def test_inter_frame_raises_naming_it(tmp_path):
    data = bytearray(_webp(_image(16, 16), quality=80))
    data[20] |= 1  # the VP8 frame tag's inter-frame bit
    path = tmp_path / "in.webp"
    path.write_bytes(bytes(data))
    with pytest.raises(OSError):
        ref_load_webp(str(path))
    with pytest.raises(ValueError, match="VP8 inter frame") as e:
        load_webp(str(path))
    assert isinstance(e.value, OSError)


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return out.read_bytes(), (found.group(1), found.group(3)) if found \
        else None


@pytest.mark.parametrize("args", (["-t", "80"], ["-q", "60"]),
                         ids=("t80", "q60"))
def test_cli_on_webp_matches_reference_and_pam(tmp_path, capsys,
                                               monkeypatch, args):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")
    rgb = bench_images(256, ("mixed",))["mixed"]
    src = tmp_path / "mixed.webp"
    src.write_bytes(_webp(rgb, quality=80))
    ref, ref_found = _run(ref_cli, args, src, tmp_path / "ref.avif", capsys)
    got, found = _run(port_cli, args, src, tmp_path / "port.avif", capsys)
    assert found == ref_found
    assert ref[4:12] == got[4:12] == b"ftypavif"
    pam = tmp_path / "mixed.pam"
    write_pam(pam, load_webp(str(src)).data)
    via_pam, pam_found = _run(port_cli, args, pam, tmp_path / "pam.avif",
                              capsys)
    assert (got, found) == (via_pam, pam_found)
