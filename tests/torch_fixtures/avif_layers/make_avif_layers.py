"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_layers.py`` and
``chip_smoke.py``: items coded in two or three spatial layers of the same
size, each layer past the first an AV1 inter frame, and their
``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_layers/make_avif_layers.py

The system's libaom (``libaom.so.3``, 3.6.0) writes every stream through
ctypes, with the helpers of ``avif_superres/make_avif_superres.py``:
``aom_codec_enc_config_default`` with usage 1 (realtime; usage 0 writes
the second layer as another key frame), ``AOME_SET_NUMBER_SPATIAL_LAYERS``
(control 27) and, before each layer, ``AOME_SET_SPATIAL_LAYER_ID``
(control 12); layer 0 at pts 0 with ``AOM_EFLAG_FORCE_KF``, each later
layer the same picture at the next pts, its own quantizer set through
``aom_codec_enc_config_set``. libaom then writes a full sequence header
with one operating point per layer count (``operating_point_idc`` 0x301
and 0x101 for two layers). Each stream, without its temporal delimiters,
is wrapped by the port's ``mux_avif`` with its ``av1C`` set from the
sequence header and no layer property; alpha is a monochrome ``auxl``
item coded in layers the same way.

The set: ``cpu-used`` 5 to 10 on 4:2:0, 4:2:2, 4:4:4 and monochrome at 8
and 10 bits (and 4:2:0 at 12), base and refinement quantizers spread
over the range, two tile columns, the six 512x512 bench classes, an alpha item in two
layers, three layers (the third an inter frame on the second), and a
3840x2160 4:2:0 frame for the card; below ``cpu-used`` 7 with OBMC and
warped motion off, which libaom's realtime usage writes there, except in
two files of its defaults at ``cpu-used`` 5 (OBMC and a local warp; with
OBMC off, local warps alone; ``avif_warp/make_avif_warp.py`` writes the
set of both tools). A file whose stream uses a tool the port refuses
held a refusal (``refuses`` in the manifest) until the decoder learned
its tool: three layers with ``use_ref_frame_mvs`` on an inter frame
(libaom's default ``enable-ref-frame-mvs``), which now decodes
(``avif_refmvs/make_avif_refmvs.py`` writes the set of three and four
layers).

libaom's realtime usage writes neither the sharp nor the bilinear filter,
two filters in a block, 4x4 inter blocks (whose chroma mixes several
MVs) nor loop filter mode deltas: ``inter_writer.py`` writes layer 1 of
the ``written_*`` files symbol by symbol over libaom's layer 0
(``WRITTEN``).

The manifest holds, per file, how it was written; the CRC32 of dav1d's
Y'UV planes (the system libavif 0.11.1 through ``io/avif_ctypes``); the
shape, ``hbd`` flag and CRC32 of the reference's ``load_avif`` pixels and
the CRC32 of its ``decode_avif_to_rgb8`` pixels; the frames the port
decodes and the spatial layer it shows; and the count of each tool its
decoder met.
"""

from __future__ import annotations

import ctypes as C
import json
import os
import sys
import zlib

from typing import Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "avif_superres"))

from chip_smoke import frame_4k, with_alpha  # noqa: E402
from make_avif_superres import (  # noqa: E402
    _ABI, _AOM_Q, _CFG, _CICP_OPTIONS, _FMT, _SET_COLOR_RANGE, _SHIFT,
    _USE_HIGHBITDEPTH, CICP, _libaom, _without_delimiter, to_yuv)
from oavif_tpu_torch.av1.mux import mux_avif  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

LIBAOM = "libaom 3.6.0 (ctypes)"
_SET_NUMBER_SPATIAL_LAYERS = 27  # AOME_SET_NUMBER_SPATIAL_LAYERS
_SET_SPATIAL_LAYER_ID = 12  # AOME_SET_SPATIAL_LAYER_ID
_FORCE_KF = 1  # AOM_EFLAG_FORCE_KF


def aom_encode_layers(planes: list, depth: int, ss: str, quantizers,
                      usage: int = 1, options: dict = (),
                      full_range: bool = True, before_layer=None,
                      cfg_words: dict = (), layer_flags: dict = ()) -> bytes:
    """One picture of Y'UV ``planes`` (one plane for monochrome) coded by
    libaom in ``len(quantizers)`` spatial layers of its size, layer i at
    quantizer ``quantizers[i]`` (end usage AOM_Q). ``before_layer(lib,
    ctx, layer)``, where given, sends more controls before each layer's
    encode; ``cfg_words`` sets more words of the configuration by name
    (``make_avif_superres._CFG``); ``layer_flags`` maps a layer to more
    ``aom_codec_encode`` flags (``AOM_EFLAG_*``) for it. Returns the OBUs,
    the temporal delimiters left out."""
    lib = _libaom()
    lib.aom_codec_enc_config_set.argtypes = [C.c_void_p, C.c_void_p]
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
    cfg[k["w"]], cfg[k["h"]] = w, h
    cfg[k["limit"]], cfg[k["lag"]] = len(quantizers), 0
    for name, v in dict(cfg_words).items():
        cfg[k[name]] = v
    cfg[k["bit_depth"]] = cfg[k["input_bit_depth"]] = depth
    cfg[k["end_usage"]] = _AOM_Q
    cfg[k["monochrome"]] = int(mono)
    ctx = (C.c_uint8 * 512)()
    if lib.aom_codec_enc_init_ver(ctx, iface, cfg,
                                  _USE_HIGHBITDEPTH if depth > 8 else 0,
                                  _ABI):
        raise RuntimeError(f"aom_codec_enc_init_ver: "
                           f"{lib.aom_codec_error_detail(ctx)}")
    out = bytearray()
    try:
        for key, val in {**_CICP_OPTIONS, **dict(options)}.items():
            if lib.aom_codec_set_option(ctx, key.encode(), str(val).encode()):
                raise RuntimeError(f"libaom refuses {key}={val}")
        if lib.aom_codec_control(ctx, _SET_COLOR_RANGE, int(full_range)):
            raise RuntimeError("libaom refuses the colour range")
        if lib.aom_codec_control(ctx, _SET_NUMBER_SPATIAL_LAYERS,
                                 len(quantizers)):
            raise RuntimeError("libaom refuses the spatial layers")
        fmt = _FMT["4:2:0" if mono else ss] | (0x800 if depth > 8 else 0)
        sx, sy = _SHIFT["4:2:0" if mono else ss]
        dt = np.dtype(np.uint16 if depth > 8 else np.uint8)
        for layer, q in enumerate(quantizers):
            if lib.aom_codec_control(ctx, _SET_SPATIAL_LAYER_ID, layer):
                raise RuntimeError("libaom refuses the layer id")
            cfg[k["min_q"]] = cfg[k["max_q"]] = q
            if lib.aom_codec_enc_config_set(ctx, cfg):
                raise RuntimeError("aom_codec_enc_config_set")
            if before_layer is not None:
                before_layer(lib, ctx, layer)
            img = lib.aom_img_alloc(None, fmt, w, h, 16)
            try:
                # aom_image_t: monochrome at word 4, bit_depth at word 9;
                # planes[3] at byte 64, stride[3] at 88
                u32 = C.cast(C.c_void_p(img), C.POINTER(C.c_uint32))
                u32[4], u32[9] = int(mono), depth
                ptrs = C.cast(C.c_void_p(img + 64), C.POINTER(C.c_void_p))
                strides = C.cast(C.c_void_p(img + 88), C.POINTER(C.c_int32))
                for p in range(3):
                    ph, pw = (h, w) if p == 0 else \
                        ((h + sy) >> sy, (w + sx) >> sx)
                    src = planes[p] if p < len(planes) else \
                        np.full((ph, pw), 1 << (depth - 1))
                    buf = (C.c_uint8 * (strides[p] * ph)).from_address(ptrs[p])
                    np.frombuffer(buf, dt).reshape(ph, -1)[:, :pw] = src
                flags = (_FORCE_KF if layer == 0 else 0) \
                    | dict(layer_flags).get(layer, 0)
                if lib.aom_codec_encode(ctx, img, layer, 1, flags):
                    raise RuntimeError(f"aom_codec_encode: "
                                       f"{lib.aom_codec_error_detail(ctx)}")
            finally:
                lib.aom_img_free(img)
            it = C.c_void_p(0)
            while True:
                pkt = lib.aom_codec_get_cx_data(ctx, C.byref(it))
                if not pkt:
                    break
                if C.c_int.from_address(pkt).value == 0:  # a frame
                    buf = C.c_void_p.from_address(pkt + 8).value
                    size = C.c_size_t.from_address(pkt + 16).value
                    out.extend(C.string_at(buf, size))
    finally:
        lib.aom_codec_destroy(ctx)
    return _without_delimiter(bytes(out))


def _av1c(payload: bytes) -> bytes:
    """The av1C box's four bytes from a stream's sequence header (its
    first operating point's level)."""
    assert payload[0] >> 3 == 1 and not payload[0] & 4, "a sequence header"
    at = 1
    while payload[at] & 0x80:
        at += 1
    bits = "".join(f"{b:08b}" for b in payload[at + 1:at + 24])
    pos = 0

    def f(n):
        nonlocal pos
        v = int(bits[pos:pos + n], 2)
        pos += n
        return v

    profile, _, reduced = f(3), f(1), f(1)
    if reduced:
        level = f(5)
    else:
        if f(1):
            raise ValueError("timing info in a layered stream")
        f(1)  # initial_display_delay_present_flag
        f(5)
        f(12)
        level = f(5)
    from oavif_tpu_torch.io import avif as A

    size = 0
    for i in range(8):  # the sequence header OBU's leb128 size
        size |= (payload[1 + i] & 0x7F) << (7 * i)
        if not payload[1 + i] & 0x80:
            break
    s = A.parse_sequence_header(A._Bits(payload, 2 + i, 2 + i + size))
    sx, sy = (1, 1) if s.mono else s.ss
    return bytes([0x81, profile << 5 | level,
                  (s.bit_depth > 8) << 6 | (s.bit_depth == 12) << 5
                  | s.mono << 4 | sx << 3 | sy << 2, 0])


def container(colour: bytes, width: int, height: int, depth: int,
              alpha: bytes = None) -> bytes:
    data = bytearray(mux_avif(colour, width, height, depth,
                              high_bitdepth=depth > 8, cicp=CICP,
                              full_range=True, alpha_payload=alpha))
    at = data.index(b"av1C") + 4
    data[at:at + 4] = _av1c(colour)
    if alpha is not None:
        at = data.index(b"av1C", at) + 4
        data[at:at + 4] = _av1c(alpha)
    return bytes(data)


def encode_avif(px: np.ndarray, depth: int, ss: str, quantizers,
                mono: bool = False, **kw) -> bytes:
    """The AVIF of 8-bit RGB or RGBA ``px`` in layers: libaom's layered
    streams of its Y'UV (its luma alone where ``mono``) and of its alpha."""
    h, w = px.shape[:2]
    yuv = to_yuv(px, depth, "4:2:0" if mono else ss)
    colour = aom_encode_layers(yuv[:1] if mono else yuv, depth, ss,
                               quantizers, **kw)
    alpha = None
    if px.shape[2] == 4:
        a = px[..., 3].astype(np.float64) / 255
        alpha = aom_encode_layers([np.rint(a * ((1 << depth) - 1)).astype(
            np.uint16 if depth > 8 else np.uint8)], depth, ss, quantizers,
            **kw)
    return container(colour, w, h, depth, alpha)


def files() -> dict:
    """name -> (pixels, encode_avif's arguments)"""
    im = bench_images(256)
    big = bench_images(512)
    out = {"probe_256_420.avif": (im["mixed"], dict(
        depth=8, ss="4:2:0", quantizers=(40, 20),
        options={"cpu-used": 8}))}
    grid = (("4:2:0", 10, 5, (52, 30)), ("4:2:2", 8, 6, (36, 12)),
            ("4:4:4", 10, 7, (60, 44)), ("mono", 8, 9, (24, 4)),
            ("4:4:4", 8, 10, (48, 16)), ("4:2:0", 8, 6, (8, 2)),
            ("mono", 10, 8, (44, 28)), ("4:2:2", 10, 9, (30, 20)),
            ("4:2:0", 12, 7, (36, 14)))
    names = list(im)
    for i, (ss, depth, speed, qs) in enumerate(grid):
        mono = ss == "mono"
        opts = {"cpu-used": speed}
        if speed < 7:  # OBMC and warped motion off (avif_warp has them)
            opts.update({"enable-obmc": 0, "enable-warped-motion": 0})
        if speed == 5:  # screen tuning picks later candidates (drl)
            opts["tune-content"] = "screen"
        out[f"s{speed}_{ss.replace(':', '')}_{depth}bit.avif"] = (
            im[names[i % 6]], dict(depth=depth, ss="4:2:0" if mono else ss,
                                   mono=mono, quantizers=qs, options=opts))
    out.update({
        "tiles2_420.avif": (big["oriented"], dict(
            depth=8, ss="4:2:0", quantizers=(40, 24),
            options={"cpu-used": 7, "tile-columns": 1})),
        "alpha_420.avif": (with_alpha(im["edges"]), dict(
            depth=8, ss="4:2:0", quantizers=(36, 20),
            options={"cpu-used": 8})),
        "three_layers_420.avif": (im["fractal"], dict(
            depth=8, ss="4:2:0", quantizers=(50, 30, 12),
            options={"cpu-used": 8, "enable-ref-frame-mvs": 0})),
        "three_layers_refmvs_420.avif": (im["fractal"], dict(
            depth=8, ss="4:2:0", quantizers=(50, 30, 12),
            options={"cpu-used": 8})),
        # libaom's defaults at cpu-used 5: OBMC; without it, local warps
        "obmc_s5_420.avif": (im["mixed"], dict(
            depth=8, ss="4:2:0", quantizers=(50, 20),
            options={"cpu-used": 5})),
        "warp_s5_420.avif": (im["mixed"], dict(
            depth=8, ss="4:2:0", quantizers=(50, 20),
            options={"cpu-used": 5, "enable-obmc": 0})),
        "photo4k_420.avif": (frame_4k(), dict(
            depth=8, ss="4:2:0", quantizers=(40, 24),
            options={"cpu-used": 9})),
    })
    for j, (name, px) in enumerate(big.items()):
        out[f"class_{name}_512.avif"] = (px, dict(
            depth=8, ss="4:2:0", quantizers=(44 - 4 * j, 24 - 2 * j),
            options={"cpu-used": 7 + j % 3}))
    return out


# streams whose layer 1 ``inter_writer`` writes over libaom's layer 0:
# name -> (class, depth, subsampling, write_layered's arguments, seed,
# every how many superblocks one is split into 4x4 blocks)
WRITTEN = {
    "written_sharp_420.avif": ("fractal", 8, "4:2:0", dict(filt=2), 1, 0),
    "written_bilinear_444_10bit.avif": ("oriented", 10, "4:4:4",
                                        dict(filt=3), 2, 0),
    "written_dual_sub8x8_420.avif": ("mixed", 8, "4:2:0", dict(
        filt=4, dual=True, mode_deltas=(3, -2),
        ref_deltas=(1, 2, 0, 0, -1, 0, -1, -1)), 3, 3),
    "written_sub8x8_422_nohp.avif": ("edges", 10, "4:2:2", dict(
        filt=4, hp=False), 4, 2),
}


def written(name: str) -> Tuple[bytes, dict]:
    """A ``WRITTEN`` file and how it was made."""
    from inter_writer import random_sbs, write_layered

    cls, depth, ss, kw, seed, split = WRITTEN[name]
    px = bench_images(256)[cls]
    key = aom_encode_layers(to_yuv(px, depth, ss), depth, ss, (40, 20),
                            options={"cpu-used": 8})
    rng = np.random.default_rng(seed)
    sbs = random_sbs(rng, 16, split, 40, 3, kw.get("hp", True))
    data = container(write_layered(key, sbs, **kw), 256, 256, depth)
    how = {"writer": f"{LIBAOM} layer 0, inter_writer.py layer 1",
           "class": cls, "depth": depth, "ss": ss, "seed": seed,
           "split_every": split,
           **{k: (list(v) if isinstance(v, tuple) else v)
              for k, v in kw.items()}}
    return data, how


def crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def manifest_entry(data: bytes, how: dict) -> dict:
    """The file's entry: the reference's and dav1d's CRCs, the frames and
    layer the port decodes and shows, and its tool counts; for a stream
    the port refuses, the tool it names."""
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
    entry = {"bytes": len(data), "written": how,
             "load_shape": list(img.data.shape), "load_hbd": img.hbd,
             "load_crc": crc(img.data), "icc": len(img.icc or b""),
             "rgb8_crc": crc(rgb8),
             "depth": depth,
             "yuv_crc": crc(np.concatenate(
                 [p.astype("<u2").reshape(-1) for p in planes
                  if p is not None]))}
    box = A.read_container(data)
    av1 = A.parse_av1(box.color.payload)
    entry["frames"] = [[f.spatial_id, f.frame.frame_type]
                       for f in av1.frames]
    entry["shows_layer"] = av1.spatial_id
    try:
        _, colour, alpha = A.decode_avif(data)
    except A.UnsupportedAvif as e:
        entry["refuses"] = str(e).split(": ", 1)[1].split(" is not")[0]
        return entry
    entry["tools"] = colour.tools
    entry["alpha_tools"] = alpha.tools if alpha else None
    return entry


def main() -> None:
    manifest = {}
    for name, (px, kw) in files().items():
        print(name, flush=True)
        data = encode_avif(px, **kw)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        how = {"writer": LIBAOM, "usage": 1,
               **{k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in kw.items() if k != "options"},
               **{k: str(v) for k, v in dict(kw.get("options", {})).items()}}
        manifest[name] = manifest_entry(data, how)
    sys.path.insert(0, HERE)
    for name in WRITTEN:
        print(name, flush=True)
        data, how = written(name)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = manifest_entry(data, how)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(e["bytes"] for e in manifest.values())
    print(f"{len(manifest)} files, {total} bytes")


if __name__ == "__main__":
    main()
