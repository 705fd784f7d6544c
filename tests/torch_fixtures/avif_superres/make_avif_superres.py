"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_superres.py``
and ``chip_smoke.py``: frames coded with AV1 superres and with non-uniform
tile spacing, and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_superres/make_avif_superres.py

Neither Pillow's libavif 1.3 nor the system's libavif 0.11.1 passes
``superres-mode`` on to libaom, so the system's libaom
(``libaom.so.3``, 3.6.0) writes every file itself, through ctypes
(``aom_encode``). Superres and non-uniform tiles are words of its
``aom_codec_enc_cfg_t``, taken as an array of uint32: 19-23
``rc_superres_mode`` (1: FIXED), ``rc_superres_denominator``,
``rc_superres_kf_denominator`` (9-16; a still is a key frame),
``rc_superres_qthresh`` and ``rc_superres_kf_qthresh``; 55 and 56
``tile_width_count`` and ``tile_height_count``, then ``tile_widths[64]``
from 57 and ``tile_heights[64]`` from 121, in superblocks. The other
settings go through ``aom_codec_set_option``. Each stream, without its
temporal delimiter, is wrapped by the port's ``mux_avif`` with its
``av1C`` set from the sequence header and ``ispe`` at the upscaled size;
alpha is a monochrome ``auxl`` item coded with the same settings.

The set: denominators 9, 12 and 16 on 4:2:0, 4:2:2 and 4:4:4 at 8, 10
and 12 bits (usage 2, all-intra, which under superres writes loop
restoration on some planes and, unless told, no CDEF); usage 0 at
``cpu-used`` 4 with ``enable-restoration`` 1, with CDEF on (``cdef_bits``
1) and two tile columns, and with CDEF off; an odd coded
width (203 shown, 135 coded), alpha (and alpha coded in the limited
range, which libavif 1.3 widens), film grain (``film-grain-test``),
non-uniform tiles in both directions with superres and without it, a
512x512 class for the CLI and a 3840x2160 4:2:0 frame at denominator 16
for the card.

The manifest holds, per file, how it was written; the CRC32 of dav1d's
Y'UV planes (the system libavif through ``io/avif_ctypes``), the shape,
``hbd`` flag and CRC32 of the reference's ``load_avif`` pixels and the
CRC32 of its ``decode_avif_to_rgb8`` pixels, as ``avif_container``'s
manifest does; the frame's header as the port reads it (coded width,
superres denominator, tile starts, loop restoration types, CDEF bits);
and the count of each tool the port's decoder met.
"""

from __future__ import annotations

import ctypes as C
import json
import os
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)

from chip_smoke import frame_4k, with_alpha  # noqa: E402
from oavif_tpu_torch.av1.mux import mux_avif  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

LIBAOM = "libaom 3.6.0 (ctypes)"
# aom_img_fmt_t of 8-bit planar Y'UV; | 0x800 for 16-bit samples
_FMT = {"4:2:0": 0x102, "4:2:2": 0x105, "4:4:4": 0x106}
_SHIFT = {"4:2:0": (1, 1), "4:2:2": (1, 0), "4:4:4": (0, 0)}
CICP = (1, 13, 6)  # BT.709 primaries, sRGB transfer, BT.601 matrix
# aom_codec_enc_cfg_t words (uint32)
_CFG = dict(threads=1, profile=2, w=3, h=4, limit=5,
            forced_max_frame_width=6, forced_max_frame_height=7, bit_depth=8,
            input_bit_depth=9, error_resilient=12, lag=14, superres_mode=19,
            superres_denominator=20, superres_kf_denominator=21,
            end_usage=24, min_q=35, max_q=36, monochrome=52,
            tile_width_count=55, tile_height_count=56, tile_widths=57,
            tile_heights=121)
_AOM_Q = 3
_USE_HIGHBITDEPTH = 0x40000
_ABI = 25  # AOM_ENCODER_ABI_VERSION of libaom 3.6
_SET_COLOR_RANGE = 52  # AV1E_SET_COLOR_RANGE (no string option sets it)
# the sequence header's CICP, as libaom's option values name CICP
_CICP_OPTIONS = {"color-primaries": "bt709",
                 "transfer-characteristics": "srgb",
                 "matrix-coefficients": "bt601"}


def _libaom() -> C.CDLL:
    lib = C.CDLL("libaom.so.3")
    lib.aom_codec_av1_cx.restype = C.c_void_p
    lib.aom_codec_enc_config_default.argtypes = [C.c_void_p, C.c_void_p,
                                                 C.c_uint]
    lib.aom_codec_enc_init_ver.argtypes = [C.c_void_p, C.c_void_p,
                                           C.c_void_p, C.c_long, C.c_int]
    lib.aom_img_alloc.restype = C.c_void_p
    lib.aom_img_alloc.argtypes = [C.c_void_p, C.c_int, C.c_uint, C.c_uint,
                                  C.c_uint]
    lib.aom_img_free.argtypes = [C.c_void_p]
    lib.aom_codec_encode.argtypes = [C.c_void_p, C.c_void_p, C.c_int64,
                                     C.c_ulong, C.c_long]
    lib.aom_codec_get_cx_data.restype = C.c_void_p
    lib.aom_codec_get_cx_data.argtypes = [C.c_void_p, C.c_void_p]
    lib.aom_codec_set_option.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p]
    lib.aom_codec_control.argtypes = [C.c_void_p, C.c_int, C.c_int]
    lib.aom_codec_destroy.argtypes = [C.c_void_p]
    lib.aom_codec_error_detail.restype = C.c_char_p
    lib.aom_codec_error_detail.argtypes = [C.c_void_p]
    return lib


def aom_encode(planes: list, depth: int, ss: str, quantizer: int,
               usage: int = 2, superres: int = 8, options: dict = (),
               tile_widths=(), tile_heights=(),
               full_range: bool = True) -> bytes:
    """One key frame of Y'UV ``planes`` (uint8 or uint16 arrays, one for a
    monochrome frame) at ``depth`` bits in ``ss``, written by libaom at one
    quantizer (end usage AOM_Q) with the usage (0 good quality, 2
    all-intra), the superres denominator (8: none), libaom options, the
    tile sizes in superblocks (each list may be empty: one tile) and the
    range its sequence header states (with ``CICP``). Returns its OBUs,
    the temporal delimiter left out."""
    lib = _libaom()
    mono = len(planes) == 1
    h, w = planes[0].shape
    iface = lib.aom_codec_av1_cx()
    cfg = (C.c_uint32 * 4096)()
    if lib.aom_codec_enc_config_default(iface, cfg, usage):
        raise RuntimeError("aom_codec_enc_config_default")
    k = _CFG
    cfg[k["threads"]] = 1
    cfg[k["profile"]] = 2 if ss == "4:2:2" or depth == 12 else \
        int(ss == "4:4:4" and not mono)
    cfg[k["w"]], cfg[k["h"]], cfg[k["limit"]], cfg[k["lag"]] = w, h, 1, 0
    cfg[k["bit_depth"]] = cfg[k["input_bit_depth"]] = depth
    if superres != 8:
        cfg[k["superres_mode"]] = 1
        cfg[k["superres_denominator"]] = superres
        cfg[k["superres_kf_denominator"]] = superres
    cfg[k["end_usage"]] = _AOM_Q
    cfg[k["min_q"]] = cfg[k["max_q"]] = quantizer
    cfg[k["monochrome"]] = int(mono)
    if tile_widths or tile_heights:
        # both counts must be non-zero: one tile of the largest size
        widths, heights = tile_widths or (64,), tile_heights or (64,)
        cfg[k["tile_width_count"]] = len(widths)
        cfg[k["tile_height_count"]] = len(heights)
        for i, v in enumerate(widths):
            cfg[k["tile_widths"] + i] = v
        for i, v in enumerate(heights):
            cfg[k["tile_heights"] + i] = v
    ctx = (C.c_uint8 * 512)()
    if lib.aom_codec_enc_init_ver(ctx, iface, cfg,
                                  _USE_HIGHBITDEPTH if depth > 8 else 0,
                                  _ABI):
        raise RuntimeError(f"aom_codec_enc_init_ver: "
                           f"{lib.aom_codec_error_detail(ctx)}")
    img = None
    try:
        for key, val in {**_CICP_OPTIONS, **dict(options)}.items():
            if lib.aom_codec_set_option(ctx, key.encode(), str(val).encode()):
                raise RuntimeError(f"libaom refuses {key}={val}")
        if lib.aom_codec_control(ctx, _SET_COLOR_RANGE, int(full_range)):
            raise RuntimeError("libaom refuses the colour range")
        fmt = _FMT["4:2:0" if mono else ss] | (0x800 if depth > 8 else 0)
        img = lib.aom_img_alloc(None, fmt, w, h, 16)
        # aom_image_t: monochrome at word 4, bit_depth at word 9;
        # planes[3] at byte 64, stride[3] at 88
        u32 = C.cast(C.c_void_p(img), C.POINTER(C.c_uint32))
        u32[4], u32[9] = int(mono), depth
        ptrs = C.cast(C.c_void_p(img + 64), C.POINTER(C.c_void_p))
        strides = C.cast(C.c_void_p(img + 88), C.POINTER(C.c_int32))
        sx, sy = _SHIFT["4:2:0" if mono else ss]
        dt = np.dtype(np.uint16 if depth > 8 else np.uint8)
        for p in range(3):
            ph, pw = (h, w) if p == 0 else ((h + sy) >> sy, (w + sx) >> sx)
            src = planes[p] if p < len(planes) else \
                np.full((ph, pw), 1 << (depth - 1))
            assert src.shape == (ph, pw), (src.shape, ph, pw)
            buf = (C.c_uint8 * (strides[p] * ph)).from_address(ptrs[p])
            np.frombuffer(buf, dt).reshape(ph, -1)[:, :pw] = src
        out = bytearray()

        def drain():
            it = C.c_void_p(0)
            while True:
                pkt = lib.aom_codec_get_cx_data(ctx, C.byref(it))
                if not pkt:
                    return
                if C.c_int.from_address(pkt).value == 0:  # a frame
                    buf = C.c_void_p.from_address(pkt + 8).value
                    size = C.c_size_t.from_address(pkt + 16).value
                    out.extend(C.string_at(buf, size))

        if lib.aom_codec_encode(ctx, img, 0, 1, 0):
            raise RuntimeError(f"aom_codec_encode: "
                               f"{lib.aom_codec_error_detail(ctx)}")
        drain()  # the next call clears the packet list
        while True:  # flush
            n = len(out)
            if lib.aom_codec_encode(ctx, None, 0, 1, 0):
                raise RuntimeError("aom_codec_encode (flush)")
            drain()
            if len(out) == n:
                break
    finally:
        if img:
            lib.aom_img_free(img)
        lib.aom_codec_destroy(ctx)
    return _without_delimiter(bytes(out))


def _without_delimiter(data: bytes) -> bytes:
    """The OBUs less the temporal delimiters (an AVIF item has none)."""
    out, pos = bytearray(), 0
    while pos < len(data):
        head = data[pos]
        p = pos + 1 + ((head >> 2) & 1)
        size = shift = 0
        while True:
            byte = data[p]
            p += 1
            size |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        if (head >> 3) & 15 != 2:  # OBU_TEMPORAL_DELIMITER
            out += data[pos:p + size]
        pos = p + size
    return bytes(out)


def _av1c(payload: bytes, depth: int, ss: str, mono: bool) -> bytes:
    """The av1C box's four bytes for a stream with a reduced still-picture
    sequence header (libaom writes one for a single frame)."""
    at = 1 + ((payload[0] >> 2) & 1)  # past the OBU header
    while payload[at] & 0x80:
        at += 1
    seq = payload[at + 1:]
    profile = seq[0] >> 5
    assert (seq[0] >> 3) & 3 == 3, "not a reduced still-picture header"
    level = ((seq[0] & 7) << 2) | (seq[1] >> 6)
    sx, sy = (1, 1) if mono else _SHIFT[ss]
    return bytes([0x81, profile << 5 | level,
                  (depth > 8) << 6 | (depth == 12) << 5 | mono << 4
                  | sx << 3 | sy << 2, 0])


def container(colour: bytes, width: int, height: int, depth: int, ss: str,
              alpha: bytes = None) -> bytes:
    """The AVIF of one colour item (and an alpha one) of the upscaled
    size, with each item's av1C from its stream."""
    data = bytearray(mux_avif(colour, width, height, depth,
                              high_bitdepth=depth > 8, cicp=CICP,
                              full_range=True, alpha_payload=alpha))
    at = data.index(b"av1C") + 4
    data[at:at + 4] = _av1c(colour, depth, ss, False)
    if alpha is not None:
        at = data.index(b"av1C", at) + 4
        data[at:at + 4] = _av1c(alpha, depth, ss, True)
    return bytes(data)


def to_yuv(rgb: np.ndarray, depth: int, ss: str) -> list:
    """Full-range BT.601 Y'UV of 8-bit RGB at ``depth`` bits, the chroma
    averaged over each subsampled box."""
    f = rgb[..., :3].astype(np.float64)
    y = f @ (0.299, 0.587, 0.114)
    u = (f[..., 2] - y) / 1.772 + 128
    v = (f[..., 0] - y) / 1.402 + 128
    sx, sy = _SHIFT[ss]
    h, w = y.shape

    def down(c):
        c = np.pad(c, ((0, h % 2 * sy), (0, w % 2 * sx)), mode="edge")
        c = c.reshape(c.shape[0] >> sy, 1 << sy, c.shape[1] >> sx, 1 << sx)
        return c.mean((1, 3))

    scale = ((1 << depth) - 1) / 255
    dt = np.uint16 if depth > 8 else np.uint8
    return [np.clip(np.rint(c * scale), 0, (1 << depth) - 1).astype(dt)
            for c in (y, down(u), down(v))]


def encode_avif(px: np.ndarray, depth: int, ss: str, quantizer: int,
                alpha_range: str = "full", **kw) -> bytes:
    """The AVIF of 8-bit RGB or RGBA ``px``: libaom's streams of its Y'UV
    and of its alpha, with the same settings; the alpha full range as
    libavif writes it, or, with ``alpha_range="limited"``, squeezed into
    the limited range and its sequence header saying so."""
    h, w = px.shape[:2]
    colour = aom_encode(to_yuv(px, depth, ss), depth, ss, quantizer, **kw)
    alpha = None
    if px.shape[2] == 4:
        a = px[..., 3].astype(np.float64) / 255
        if alpha_range == "limited":
            a = (16 + 219 * a) / 255
        alpha = aom_encode([np.rint(a * ((1 << depth) - 1)).astype(
            np.uint16 if depth > 8 else np.uint8)], depth, ss, quantizer,
            full_range=alpha_range == "full", **kw)
    return container(colour, w, h, depth, ss, alpha)


LR = {"cpu-used": 4, "enable-restoration": 1}


def files() -> dict:
    """name -> (pixels, encode_avif's arguments)"""
    im = bench_images(256)
    big = bench_images(512, ("mixed", "fractal"))
    out = {}
    for i, (den, ss) in enumerate((d, s) for d in (9, 12, 16)
                                  for s in ("4:2:0", "4:2:2", "4:4:4")):
        depth = (8, 10, 12)[(i + i // 3) % 3]
        src = list(im.values())[i % 6][:128, :192]
        out[f"d{den}_{ss.replace(':', '')}_{depth}bit.avif"] = (
            src, dict(depth=depth, ss=ss, quantizer=28, superres=den))
    out.update({
        "lr_d10_420_cdef_tiles2.avif": (big["mixed"][:256], dict(
            depth=8, ss="4:2:0", quantizer=32, usage=0, superres=10,
            options={**LR, "enable-cdef": 1, "tile-columns": 1})),
        "lr_d16_444_nocdef.avif": (im["sinusoid"][:128], dict(
            depth=8, ss="4:4:4", quantizer=24, usage=0, superres=16,
            options={**LR, "enable-cdef": 0})),
        "lr_d12_422_10bit.avif": (im["edges"][:128], dict(
            depth=10, ss="4:2:2", quantizer=30, usage=0, superres=12,
            options=LR)),
        "lr_d9_420_12bit_cdef.avif": (im["oriented"][:128], dict(
            depth=12, ss="4:2:0", quantizer=34, usage=0, superres=9,
            options={**LR, "enable-cdef": 1})),
        "odd_203x97_d12_420.avif": (im["text"][:97, :203], dict(
            depth=8, ss="4:2:0", quantizer=28, superres=12,
            options={"enable-cdef": 1})),
        "odd_203x97_d12_422_lr.avif": (im["fractal"][:97, :203], dict(
            depth=8, ss="4:2:2", quantizer=28, usage=0, superres=12,
            options=LR)),
        "alpha_d12_420.avif": (with_alpha(im["mixed"][:128, :192]), dict(
            depth=8, ss="4:2:0", quantizer=28, superres=12)),
        "alpha_d16_444_10bit_lr.avif": (with_alpha(im["edges"][:96, :160]),
                                        dict(depth=10, ss="4:4:4",
                                             quantizer=28, usage=0,
                                             superres=16, options=LR)),
        "alpha_limited_420.avif": (with_alpha(im["text"][:96, :128]), dict(
            depth=8, ss="4:2:0", quantizer=28, alpha_range="limited")),
        "alpha_limited_d12_444_10bit.avif": (
            with_alpha(im["fractal"][:96, :128]),
            dict(depth=10, ss="4:4:4", quantizer=28, superres=12,
                 alpha_range="limited")),
        "grain_d12_420.avif": (im["oriented"][:128, :192], dict(
            depth=8, ss="4:2:0", quantizer=28, superres=12,
            options={"film-grain-test": 1})),
        "grain_d9_444_10bit.avif": (im["sinusoid"][:128, :192], dict(
            depth=10, ss="4:4:4", quantizer=28, superres=9,
            options={"film-grain-test": 3})),
        "tiles_nonuniform_d12_420.avif": (big["fractal"][:, :], dict(
            depth=8, ss="4:2:0", quantizer=32, superres=12,
            options={"sb-size": 64}, tile_widths=(2, 3, 1),
            tile_heights=(3, 1, 4))),
        "tiles_nonuniform_d16_444_lr.avif": (big["mixed"][:384], dict(
            depth=8, ss="4:4:4", quantizer=32, usage=0, superres=16,
            options={**LR, "sb-size": 64}, tile_widths=(3, 1),
            tile_heights=(2, 4))),
        "tiles_nonuniform_420.avif": (big["mixed"][:256, :448], dict(
            depth=8, ss="4:2:0", quantizer=32,
            options={"sb-size": 64}, tile_widths=(1, 4, 2),
            tile_heights=(1, 3))),
        "class_mixed_d12_420.avif": (big["mixed"], dict(
            depth=8, ss="4:2:0", quantizer=30, superres=12)),
        "photo4k_d16_420.avif": (frame_4k(), dict(
            depth=8, ss="4:2:0", quantizer=20, superres=16)),
    })
    return out


def crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def header(data: bytes) -> dict:
    """The colour item's frame header as the port reads it."""
    from oavif_tpu_torch.io import avif as A

    av1 = A.parse_av1(A.read_container(data).color.payload)
    fh = av1.frame
    return {"coded_width": fh.coded_width, "width": fh.width,
            "height": fh.height, "superres_denom": fh.superres_denom,
            "tile_col_starts": fh.tile_col_starts,
            "tile_row_starts": fh.tile_row_starts,
            "lr_types": list(fh.lr_types), "cdef_bits": fh.cdef_bits,
            "cdef_strengths": [list(s) for s in fh.cdef_strengths],
            "sb128": av1.seq.sb128, "grain": fh.grain is not None}


def manifest_entry(data: bytes, how: dict) -> dict:
    """The file's entry: the reference's and dav1d's CRCs, the header and
    the port's tool counts."""
    import tempfile

    from oavif_tpu.io.image import decode_avif_to_rgb8, load_avif
    from oavif_tpu_torch.io import avif as A
    from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "in.avif")
        with open(path, "wb") as f:
            f.write(data)
        img = load_avif(path)
    rgb8 = decode_avif_to_rgb8(data)
    planes, depth, _ = decode_to_yuv(data)
    _, colour, alpha = A.decode_avif(data)
    return {"bytes": len(data), "written": how,
            "load_shape": list(img.data.shape), "load_hbd": img.hbd,
            "load_crc": crc(img.data), "icc": len(img.icc or b""),
            "rgb8_crc": crc(rgb8), "depth": depth,
            "yuv_crc": crc(np.concatenate(
                [p.astype("<u2").reshape(-1) for p in planes
                 if p is not None])),
            "header": header(data), "tools": colour.tools,
            "alpha_tools": alpha.tools if alpha else None}


def main() -> None:
    manifest = {}
    for name, (px, kw) in files().items():
        print(name, flush=True)
        data = encode_avif(px, **kw)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        how = {"writer": LIBAOM, **{k: v for k, v in kw.items()
                                    if k != "options"},
               **{k: str(v) for k, v in dict(kw.get("options", {})).items()}}
        for k in ("tile_widths", "tile_heights"):
            if k in how:
                how[k] = list(how[k])
        manifest[name] = manifest_entry(data, how)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(e["bytes"] for e in manifest.values())
    print(f"{len(manifest)} files, {total} bytes")


if __name__ == "__main__":
    main()
