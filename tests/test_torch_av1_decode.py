"""The port's AV1 key-frame decoder (``oavif_tpu_torch/io/avif.py`` and
its C, ``io/av1_decode.c``) on the CPU, held with no tolerance to the
system libavif's dav1d (``io/avif_ctypes.decode_to_yuv``, a yardstick in
the tests only) and to the encoder's own reconstruction.

- The tool grid: the port's CPU encoder on 128x128 and 130x98 crops of
  the bench classes at q 1, 20, 60, 90 and 100, with each of
  ``OAVIF_PALETTE``, ``OAVIF_FILTER_INTRA``, ``OAVIF_LR``, ``OAVIF_SGR``,
  ``OAVIF_SB128``, ``OAVIF_RECT``, ``OAVIF_IDTX``, 8 or 10 bits and 1 or
  2 tile columns taken on and off at every q (a fixed, seeded sample of
  the cross product: at each q two complementary pairs of cases). Every
  stream's decoded Y'UV equals dav1d's and the recon the encoder scored,
  and its RGB equals the reference backend's (Pillow's).
- The reference's constructions: the streams of the reference's
  ``*_decodes_exact`` tests (``test_palette.py``, ``test_filter_intra.py``,
  ``test_sb128.py``, ``test_lossless.py``, ``test_restoration.py``,
  ``test_conformance.py``), rebuilt through the port's copies of the
  writers (the Python ``TileEncoder`` where a test forces a decision, the
  C tile coder otherwise), each decoded by the port to dav1d's Y'UV.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from oavif_tpu.backend.tpu import TpuBackend
from oavif_tpu_torch.av1 import encode as EN
from oavif_tpu_torch.av1 import frame as PF
from oavif_tpu_torch.av1.entropy.fast import (cdef_frame_native,
                                              loop_filter_native,
                                              tile_encode_native)
from oavif_tpu_torch.av1.mux import mux_avif
from oavif_tpu_torch.av1.obu import (FrameConfig, SequenceConfig,
                                     assemble_av1_stream)
from oavif_tpu_torch.av1.restoration import (SGR_PARAMS, apply_restoration,
                                             count_units, unit_size)
from oavif_tpu_torch.av1.yuv import rgb_to_yuv444
from oavif_tpu_torch.backend import EncCtx
from oavif_tpu_torch.backend.cuda import CudaBackend
from oavif_tpu_torch.io.avif import decode_avif
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv
from oavif_tpu_torch.io.image import Image
from oavif_tpu_torch.options import EncOptions
from oavif_tpu_torch.scripts.corpus import CLASSES, bench_images

SWITCHES = ("OAVIF_PALETTE", "OAVIF_FILTER_INTRA", "OAVIF_LR", "OAVIF_SGR",
            "OAVIF_SB128", "OAVIF_RECT", "OAVIF_IDTX")
QUALITIES = (1, 20, 60, 90, 100)


def _grid_cases():
    """At each q two complementary pairs of on/off vectors over the seven
    switches, the bit depth and the tile count, with a class and a size
    each: every switch is on in one case of a pair and off in the
    other."""
    rng = np.random.default_rng(2024)
    cases = []
    for q in QUALITIES:
        for pair in range(2):
            v = rng.integers(0, 2, len(SWITCHES) + 2)
            for flip in (0, 1):
                bits = v ^ flip
                cls = CLASSES[int(rng.integers(0, len(CLASSES)))]
                shape = ((128, 128), (98, 130))[int(rng.integers(0, 2))]
                cases.append((q, tuple(int(b) for b in bits), cls, shape))
    return cases


def _case_id(case):
    q, bits, cls, shape = case
    on = "".join(str(b) for b in bits)
    return f"q{q}-{on}-{cls}-{shape[1]}x{shape[0]}"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")
    for s in SWITCHES:
        monkeypatch.delenv(s, raising=False)


@pytest.fixture(scope="module")
def classes():
    return bench_images(128, CLASSES)


def _port_decode(data):
    _, img, alpha = decode_avif(data)
    return img.planes, alpha


def _assert_yuv_equal(data, recon=None):
    """The port's planes equal dav1d's and, where given, the recon's."""
    ours, _ = _port_decode(data)
    theirs, _, _ = decode_to_yuv(data)
    assert len(ours) == len([p for p in theirs if p is not None])
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(a, b, err_msg=f"plane {i} vs dav1d")
    if recon is not None:
        for i, (a, b) in enumerate(zip(ours, recon)):
            h, w = a.shape
            np.testing.assert_array_equal(a, np.asarray(b)[:h, :w],
                                          err_msg=f"plane {i} vs recon")


@pytest.mark.parametrize("case", _grid_cases(), ids=_case_id)
def test_tool_grid_decodes_to_dav1d_and_recon(case, classes, monkeypatch):
    q, bits, cls, (h, w) = case
    for name, on in zip(SWITCHES, bits):
        monkeypatch.setenv(name, str(on))
    tenbit, two_tiles = bits[len(SWITCHES)], bits[len(SWITCHES) + 1]
    rgb = np.ascontiguousarray(classes[cls][:h, :w])
    seen, last = {}, threading.local()
    mux, to_rgb = EN.mux_avif, EN.yuv444_to_rgb

    def spy_mux(*a, **k):
        last.avif = mux(*a, **k)
        return last.avif

    def spy_rgb(planes, *a, **k):
        seen[last.avif] = [np.array(p) for p in planes]
        return to_rgb(planes, *a, **k)

    monkeypatch.setattr(EN, "mux_avif", spy_mux)
    monkeypatch.setattr(EN, "yuv444_to_rgb", spy_rgb)
    ctx = EncCtx(o=EncOptions(tenbit=bool(tenbit), auto_tiling=False,
                              tile_cols_log2=two_tiles),
                 src=Image(width=w, height=h, channels=3, hbd=False,
                           data=rgb), rgb=rgb, w=w, h=h)
    ctx.q = q
    data, _ = EN.encode_avif_with_recon(ctx)
    _assert_yuv_equal(data, seen[data])
    ours = CudaBackend().decode_to_rgb8(data)
    np.testing.assert_array_equal(ours, TpuBackend().decode_to_rgb8(data))


# ---------------------------------------------------------------------------
# the reference's constructions, through the port's writers
# ---------------------------------------------------------------------------


def _mux(payloads, w, h, q, bd=8, nplanes=3, **frame_kw):
    seq_kw = {k: frame_kw[k] for k in ("enable_cdef", "enable_restoration",
                                       "use_128x128_superblock")
              if k in frame_kw}
    fi = frame_kw.pop("enable_filter_intra", False)
    seq = SequenceConfig(width=w, height=h, bit_depth=bd,
                         enable_filter_intra=fi,
                         monochrome=nplanes == 1,
                         seq_profile=0 if nplanes == 1 else 1, **seq_kw)
    fr = FrameConfig(width=w, height=h, base_q_idx=q, **frame_kw)
    return mux_avif(assemble_av1_stream(seq, fr, payloads), w, h,
                    bit_depth=bd, high_bitdepth=bd == 10,
                    monochrome=nplanes == 1)


def _py_tile(planes, q, bd=8, speed=9, screen=False, fi=False, sb128=False,
             patch=None):
    """(AVIF, recon) of the Python TileEncoder, after ``patch(te)``."""
    h, w = planes[0].shape
    te = PF.TileEncoder([p.copy() for p in planes], q, bd, speed,
                        screen_tools=screen, filter_intra=fi, sb128=sb128)
    if patch:
        patch(te)
    payload = te.encode()
    data = _mux([payload], w, h, q, bd, screen_content_tools=screen,
                enable_filter_intra=fi, use_128x128_superblock=sb128)
    return data, [r[:h, :w] for r in te.recon]


def _force_palette(te):
    orig = te._try_palette_y

    def spy(x, y, size):
        r = orig(x, y, size)
        return None if r is None else (r[0], r[1], 0, 0)

    te._try_palette_y = spy


def _palette_sizes():
    xx = np.arange(16)[None, :] + np.arange(16)[:, None]
    out = []
    for n in range(2, 9):
        g = np.linspace(20, 220, n).astype(int)[xx % n].astype(float)
        rgb = np.stack([g, g, g], -1).astype(np.uint8)
        out.append(_py_tile(_planes(rgb), 60, screen=True,
                            patch=_force_palette))
    return out


def _planes(rgb, bd=8):
    return [p.astype(np.int32) for p in rgb_to_yuv444(rgb, bd)]


def _palette_cache():
    rng = np.random.default_rng(3)
    gm = np.array([20, 80, 150, 220])[rng.integers(0, 4, (8, 8))]
    gm = gm.repeat(8, 0).repeat(8, 1)
    rgb = np.stack([gm, 255 - gm, gm // 2 + 40], -1).astype(np.uint8)
    return [_py_tile(_planes(rgb), 60, screen=True, patch=_force_palette)]


def _palette_screen_duel():
    yy, xx = np.mgrid[0:128, 0:128]
    ge = np.where((xx // 37 + yy // 23) % 2 == 0, 205.0, 70.0)
    ge += np.where((xx + 2 * yy) % 97 < 8, 40.0, 0.0)
    rgb = np.clip(np.stack([ge, 0.85 * ge + 20, 255 - 0.7 * ge], -1), 0,
                  255).astype(np.uint8)
    return [_py_tile(_planes(rgb), 60, screen=s) for s in (True, False)]


def _text_on_gradient(h=128, w=128, seed=19, density=24):
    rng = np.random.default_rng(seed)
    yy = np.mgrid[0:h, 0:w][0].astype(np.float64)
    img = np.stack([200 + 40 * yy / h, 210 + 30 * yy / h,
                    225 + 20 * yy / h], -1)
    for _ in range(density):
        x0, y0 = rng.integers(4, w - 12), rng.integers(4, h - 14)
        glyph = rng.random((10, 7)) > 0.5
        col = float(rng.integers(0, 70))
        for c in range(3):
            img[y0:y0 + 10, x0:x0 + 7, c][glyph] = col
    return np.clip(img, 0, 255).astype(np.uint8)


def _palette_lossy_10bit():
    rgb10 = EN._depth_convert(_text_on_gradient(), False, 10)
    planes = _planes(rgb10, 10)
    h, w = planes[0].shape
    payload, recon, _ = tile_encode_native(planes, 60, 10, 9, None, 0,
                                           screen_tools=True)
    return [(_mux([payload], w, h, 60, 10, screen_content_tools=True),
             [r[:h, :w] for r in recon])]


def _palette_delta_shrink():
    rr, cc = np.mgrid[0:16, 0:16]
    out = []
    for colors in ([0, 239, 243], [0, 223, 230],
                   [37, 233, 234, 235, 236, 237, 239, 240]):
        y = np.asarray(colors, np.int32)[cc % len(colors)]
        planes = [y, np.full((16, 16), 128, np.int32),
                  np.full((16, 16), 128, np.int32)]
        out.append(_py_tile(planes, 12, screen=True, patch=_force_palette))
    return out


def _fi_texture(h, w, seed=5, bd=8):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    g = 90 + 1.2 * xx + 0.8 * yy
    hh, hw = h // 2, w // 2
    g[:hh, :hw] += 50 * np.sin(xx[:hh, :hw] / 2.5) * np.cos(yy[:hh, :hw] / 3)
    hi, sc = (1 << bd) - 1, 4 if bd == 10 else 1
    g = np.clip(sc * (g + rng.normal(0, 4, (h, w))), 0, hi)
    return [np.round(g).astype(np.int32),
            np.clip(np.round(g * 0.5 + 60 * sc), 0, hi).astype(np.int32),
            np.full((h, w), 130 * sc, np.int32)]


def _force_fi(mode):
    def patch(te):
        te._force_fi_test = mode
    return patch


def _fi_all_modes():
    rng = np.random.default_rng(11)
    g = np.clip(128 + rng.normal(0, 35, (16, 16)), 0, 255)
    planes = [np.round(g).astype(np.int32), np.full((16, 16), 120, np.int32),
              np.full((16, 16), 130, np.int32)]
    return [_py_tile(planes, 30, fi=True, patch=_force_fi(m))
            for m in range(5)]


def _fi_sizes_splits():
    planes = _fi_texture(96, 96)
    return [_py_tile(planes, q, speed=sp, fi=True, patch=_force_fi(m))
            for q, sp, m in ((40, 8, 0), (80, 9, 2), (40, 8, 4))]


def _fi_10bit_and_screen():
    vals = np.array([20, 80, 150, 220])
    rng = np.random.default_rng(3)
    gm = vals[rng.integers(0, 4, (8, 8))].repeat(8, 0).repeat(8, 1)
    screen = [gm.astype(np.int32), (255 - gm).astype(np.int32),
              (gm // 2 + 40).astype(np.int32)]
    yy, xx = np.mgrid[0:64, 0:64]
    g = np.where((yy // 16) % 2 == 0, 180.0, 70.0) + 2.0 * np.sin(xx / 3.0)
    stripes = [np.clip(g, 0, 255).astype(np.int32),
               np.full((64, 64), 120, np.int32),
               np.full((64, 64), 130, np.int32)]
    return [_py_tile(_fi_texture(64, 64, bd=10), 60, bd=10, fi=True,
                     patch=_force_fi(1)),
            _py_tile(screen, 60, fi=True, screen=True),
            _py_tile(stripes, 70, speed=6, fi=True)]


def _sb128_none(te):
    te._force_sb128_none_test = True


def _sb128_shapes():
    out = []
    for h, w in ((128, 128), (128, 256), (256, 128)):
        yy = np.mgrid[0:h, 0:w][0]
        planes = [np.asarray(100 + yy // 8, np.int32)] * 3
        out.append(_py_tile(planes, 60, sb128=True, patch=_sb128_none))
    yy = np.mgrid[0:256, 0:256][0]
    planes = [np.asarray(400 + yy // 8 + p * 30, np.int32) for p in range(3)]
    out.append(_py_tile(planes, 90, bd=10, sb128=True, patch=_sb128_none))
    return out


def _native(planes, q, bd=8, **kw):
    """(payload, padded recon planes, block records) of the C tile coder
    on one tile."""
    return tile_encode_native(planes, q, bd, 9, None, 0, **kw)


def _sb128_partial():
    rng = np.random.default_rng(4)
    out = []
    for h, w in ((200, 136), (160, 320), (192, 192)):
        planes = [np.asarray(128 + rng.integers(-50, 50, (h, w)), np.int32)
                  for _ in range(3)]
        payload, recon, _ = _native(planes, 80, sb128=True)
        out.append((_mux([payload], w, h, 80, use_128x128_superblock=True),
                    [r[:h, :w] for r in recon]))
    return out


def _sb128_filters():
    rgb = np.full((128, 128, 3), 120, np.uint8)
    rgb[64:, :, 0] = 180
    planes = _planes(rgb)
    payload, recon, blocks = _native(planes, 152, sb128=True)
    assert any(b[2] == 128 for b in blocks)
    loop_filter_native(recon, blocks, (12, 12, 12, 12), 0, 8, 128, 128)
    cdef_frame_native(recon, blocks, (4, 2, 4, 2), 3, 8)
    data = _mux([payload], 128, 128, 152, use_128x128_superblock=True,
                enable_cdef=True, filter_levels=(12, 12, 12, 12),
                cdef_damping=3, cdef_strengths=((4, 2, 4, 2),))
    return [(data, [r[:128, :128] for r in recon])]


def _lossless(tenbit=False):
    rng = np.random.default_rng(6)
    out = []
    for shape in ((16, 16), (40, 56), (64, 64)):
        img = np.clip(rng.normal(128, 40, shape + (3,)), 0, 255).astype(
            np.uint8)
        h, w = shape
        ctx = EncCtx(o=EncOptions(tenbit=tenbit),
                     src=Image(width=w, height=h, channels=3, hbd=False,
                               data=img), rgb=img, w=w, h=h)
        ctx.q = 100
        out.append((EN.encode_avif_with_recon(ctx)[0],
                    _planes(img) if not tenbit else None))
    rgba = np.clip(rng.normal(128, 40, (32, 48, 4)), 0, 255).astype(np.uint8)
    ctx = EncCtx(o=EncOptions(tenbit=False, quality_alpha=100),
                 src=Image(width=48, height=32, channels=4, hbd=False,
                           data=rgba), rgb=rgba[..., :3], w=48, h=32)
    ctx.q = 100
    out.append((EN.encode_avif_with_recon(ctx)[0], _planes(rgba[..., :3])))
    return out


def _noise(h, w, seed, bd=8, amp=60):
    rng = np.random.default_rng(seed)
    mid = 1 << (bd - 1)
    base = np.linspace(-amp, amp, w)
    return [np.clip(mid + base[None, :] * ((p % 2) * 2 - 1)
                    + rng.integers(-amp, amp, (h, w)), 0,
                    (1 << bd) - 1).astype(np.int32) for p in range(3)]


def _lr_stream(planes, lr, q=60, bd=8, cdef=None, flv=0):
    """The reference's restoration round trip through the C coder: LR
    units coded in the tile, then the same deblocking, CDEF and
    restoration the decoder applies."""
    h, w = planes[0].shape
    payload, recon, blocks = _native(planes, q, bd, lr=lr)
    if flv:
        loop_filter_native(recon, blocks, (flv,) * 4, 0, bd, h, w)
    deblk = [r[:h, :w].copy() for r in recon]
    if cdef is not None:
        cdef_frame_native(recon, blocks, cdef[0], cdef[1], bd)
    out = apply_restoration([r[:h, :w] for r in recon], deblk, h, w,
                            lr["types"], lr["unit_shift"],
                            lr.get("wiener"), lr.get("sgrproj"), bd)
    data = _mux([payload], w, h, q, bd, enable_restoration=True,
                lr_types=lr["types"], lr_unit_shift=lr["unit_shift"],
                filter_levels=(flv,) * 4, enable_cdef=cdef is not None,
                cdef_damping=cdef[1] if cdef else 3,
                cdef_strengths=(cdef[0],) if cdef else ((0, 0, 0, 0),))
    return data, out


def _lr_wiener():
    rng = np.random.default_rng(3)
    size = unit_size(0)
    grid = [[None if (ur + uc) % 3 == 2 else
             [int(rng.integers(-5, 11)), int(rng.integers(-23, 9)),
              int(rng.integers(-17, 47)), int(rng.integers(-5, 11)),
              int(rng.integers(-23, 9)), int(rng.integers(-17, 47))]
             for uc in range(count_units(192, size))]
            for ur in range(count_units(160, size))]
    chroma = [[[0, -7, 15, 0, -7, 15]]]
    return [
        _lr_stream(_noise(32, 32, 11), {"types": (2, 0, 0), "unit_shift": 2,
                                        "wiener": {0: [[[0] * 6]]}}),
        _lr_stream(_noise(48, 48, 6), {"types": (2, 0, 0), "unit_shift": 2,
                                       "wiener": {0: [[[-5, -23, -17, 10, 8,
                                                        46]]]}}),
        _lr_stream(_noise(160, 192, 7), {"types": (2, 0, 0), "unit_shift": 0,
                                         "wiener": {0: grid}},
                   q=70, cdef=((4, 2, 4, 2), 3), flv=8),
        _lr_stream(_noise(64, 64, 8), {"types": (0, 2, 2), "unit_shift": 2,
                                       "wiener": {1: chroma, 2: chroma}}),
        _lr_stream(_noise(64, 64, 9, bd=10, amp=240),
                   {"types": (2, 0, 0), "unit_shift": 2,
                    "wiener": {0: [[[3, -7, 15, 3, -7, 15]]]}}, bd=10),
    ]


def _lr_sgr():
    out = []
    rng = np.random.default_rng(3)
    planes = [np.asarray(128 + rng.integers(-60, 60, (48, 48)), np.int32)
              for _ in range(3)]
    for s in range(16):
        r0, _, r1, _ = SGR_PARAMS[s]
        entry = (s, -33 if r0 else 0, 52 if r1 else 95)
        out.append(_lr_stream(planes, {"types": (3, 0, 0), "unit_shift": 2,
                                       "sgrproj": {0: [[entry]]}}))
    h, w = 160, 192
    planes = [np.asarray(128 + rng.integers(-60, 60, (h, w)), np.int32)
              for _ in range(3)]
    size = unit_size(0)
    urows, ucols = count_units(h, size), count_units(w, size)
    entries = [(0, -33, 52), (9, 10, 64), (12, 0, 0), None, (14, -70, 95),
               (5, 31, -32), (11, 0, 95), (3, -96, 90), (7, 5, 5)]
    grid = [[entries[(ur * ucols + uc) % len(entries)] for uc in range(ucols)]
            for ur in range(urows)]
    out.append(_lr_stream(planes, {"types": (3, 0, 0), "unit_shift": 0,
                                   "sgrproj": {0: grid}}))
    wcfg, scfg = {}, {}
    for p in range(3):
        wg = [[None] * ucols for _ in range(urows)]
        sg = [[None] * ucols for _ in range(urows)]
        k = p
        for ur in range(urows):
            for uc in range(ucols):
                m, k = k % 3, k + 1
                if m == 0:
                    wg[ur][uc] = [0 if p else 2, -5, 20, 0 if p else -1, 3,
                                  30]
                elif m == 1:
                    sg[ur][uc] = ((9, -33, 52), (12, 0, 0),
                                  (14, -70, 95))[(ur + uc) % 3]
        wcfg[p], scfg[p] = wg, sg
    out.append(_lr_stream(planes, {"types": (1, 1, 1), "unit_shift": 0,
                                   "wiener": wcfg, "sgrproj": scfg}))
    return out


def _conformance():
    d_rng = np.random.default_rng(77)
    out = []

    def enc(rgb, q, speed=9, tenbit=False, **o):
        h, w = rgb.shape[:2]
        ctx = EncCtx(o=EncOptions(speed=speed, tenbit=tenbit, **o),
                     src=Image(width=w, height=h, channels=rgb.shape[2],
                               hbd=False, data=rgb), rgb=rgb[..., :3], w=w,
                     h=h)
        ctx.q = q
        return EN.encode_avif_with_recon(ctx)[0], None

    for shape in ((16, 16), (48, 48), (96, 80), (64, 129)):
        out.append(enc(np.full(shape + (3,), 128, np.uint8), 60))
    h, w = 120, 152
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 128 + 80 * np.sin(xx / 7) * np.cos(yy / 5)
    rgb = np.clip(np.stack([base, base * 0.8 + 30, 255 - base], -1)
                  + d_rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)
    for q in (88, 94):
        out.append(enc(rgb, q))
    out.append(enc(rgb, 60, tenbit=True))
    out.append(enc(rgb[:98, :130], 60, tile_cols_log2=1, auto_tiling=False))
    rgba = np.concatenate([rgb, rgb[..., :1]], -1)
    out.append(enc(rgba, 60, tenbit=True, quality_alpha=40))
    # CFL: chroma tied to luma with both signs
    g = np.clip(128 + 60 * np.sin(xx / 5) * np.cos(yy / 9), 0, 255)
    cfl = np.stack([g, 255 - g, 0.5 * g + 60], -1).astype(np.uint8)
    out.append(enc(cfl, 60))
    for q, (hh, ww) in ((85, (96, 96)), (60, (130, 98)), (90, (64, 64))):
        out.append(enc(np.ascontiguousarray(rgb[:hh, :ww]), q))
    # HORZ 32x16 rect partitions: horizontal stripes
    yy2, xx2 = np.mgrid[0:64, 0:64]
    st = np.where((yy2 // 16) % 2 == 0, 190.0, 60.0) + 3 * np.sin(xx2 / 4)
    out.append(enc(np.clip(np.stack([st] * 3, -1), 0, 255).astype(np.uint8),
                   50))
    return out


CONSTRUCTIONS = {
    "palette_sizes_2_to_8": _palette_sizes,
    "palette_cache_reuse": _palette_cache,
    "palette_screen_duel": _palette_screen_duel,
    "palette_lossy_10bit": _palette_lossy_10bit,
    "palette_delta_shrink_pow2": _palette_delta_shrink,
    "filter_intra_all_modes": _fi_all_modes,
    "filter_intra_sizes_and_splits": _fi_sizes_splits,
    "filter_intra_10bit_screen_rect": _fi_10bit_and_screen,
    "sb128_none_all_shapes_and_10bit": _sb128_shapes,
    "sb128_partial_superblocks": _sb128_partial,
    "sb128_loop_filter_and_cdef": _sb128_filters,
    "lossless_color_and_alpha": _lossless,
    "lossless_10bit": lambda: _lossless(tenbit=True),
    "restoration_wiener": _lr_wiener,
    "restoration_sgr_and_switchable": _lr_sgr,
    "conformance_streams": _conformance,
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTIONS))
def test_reference_construction_decodes_to_dav1d(name):
    streams = CONSTRUCTIONS[name]()
    assert streams
    for data, recon in streams:
        _assert_yuv_equal(data, recon)


def test_the_grid_takes_every_switch_both_ways():
    cases = _grid_cases()
    for q in QUALITIES:
        at_q = [bits for qq, bits, _, _ in cases if qq == q]
        for i in range(len(SWITCHES) + 2):
            assert {bits[i] for bits in at_q} == {0, 1}, (q, i)
