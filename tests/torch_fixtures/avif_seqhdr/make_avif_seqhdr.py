"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_seqhdr.py`` and
``chip_smoke.py``: items whose AV1 stream holds more than one sequence
header, and their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_seqhdr/make_avif_seqhdr.py [NAME ...]

Names rewrite only those files and merge into the manifest. The system
libaom 3.6.0 writes every stream through ctypes (a still in all-intra
usage, ``make_avif_superres.aom_encode``; two spatial layers,
``make_avif_layers.aom_encode_layers``: realtime usage codes layer 1 as
an inter frame on layer 0, good-quality usage as a key frame of its
own, each after a copy of the sequence header); this maker splices
sequence headers into them: libaom's headers of other encodes, and
headers it writes itself (``sequence_header``: every field of spec 5.5,
the timing and decoder model info and the operating parameters of each
operating point among them, from a parsed header and changes to it).
The set (256x256 frames unless named otherwise):

- a still's stream with the header of another encode (64x64) before its
  own (``other_first``), between two copies of its own
  (``other_between``), and after its own, so that the other header
  governs the frame (``other_governs``: dav1d decodes the tile data as a
  64x64 frame, which libavif then scales to the ``ispe``); the mixed
  512x512 class in the middle order for the CLI;
- two layers (realtime: layer 1 an inter frame on layer 0) under headers
  with decoder model info, the header repeated before layer 1 with other
  operating parameters (``op_params``): one coded video sequence;
- two layers whose second header changes ``enable_order_hint``
  (``order_hint_off``), the frame id lengths (``frame_id_len``: layer 1's
  frame header written again with its id at the new length) or the
  superblock size (``sb_size``) before layer 1, a key frame (good-quality
  usage); another change (``layers_new_key``: the header written again
  with inter-intra on) before such a key frame, and the same before a
  realtime layer 1, an inter frame whose slots the new sequence emptied
  (``layers_new_inter``), which every reader refuses; a second header
  before such a key frame whose one operating point spans every layer
  (``layers_ops_one``: dav1d puts out layer 1, the frame it held back
  from layer 0 never shown), and one whose operating point 0 holds only
  layer 0 (``layers_ops_drop``: layer 1's OBUs dropped, layer 0 held
  back for a layer that never comes, no frame put out, which every
  reader refuses);
- a second header at 10 bits, where ``av1C`` and the first say 8, that
  governs the frame (``depth_second``), and the same first
  (``depth_first``); a second header that says monochrome governing a
  4:2:0 frame (``mono_second``);
- an alpha item whose stream has another encode's header first
  (``alpha_other_first``).

Pillow (libavif 1.3 with dav1d 1.5.1) and the system libavif 0.11.1
judge each at its first decode. The manifest holds what
``make_avif_progressive.entry`` holds (dav1d's Y'UV CRC, the
reference's ``load_avif`` and ``decode_avif_to_rgb8`` CRCs, the frames,
the layer shown, the tool counts, each frame's sizes), the coded video
sequence of each frame as the port reads them (``sequences``), and for a
refusal the port's message (``broken``), which dav1d and Pillow refuse
too.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import replace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
for _sub in ("avif_superres", "avif_layers", "avif_progressive",
             "avif_frametypes"):
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), _sub))

from chip_smoke import with_alpha  # noqa: E402
from inter_writer import _leb128, _obus  # noqa: E402
from make_avif_frametypes import (Obu, _emit, _frame_obu,  # noqa: E402
                                  _prefix, walk)
from make_avif_layers import _av1c, aom_encode_layers  # noqa: E402
from make_avif_progressive import entry  # noqa: E402
from make_avif_superres import (CICP, LIBAOM, aom_encode,  # noqa: E402
                                to_yuv)
from oavif_tpu_torch.av1.mux import mux_avif  # noqa: E402
from oavif_tpu_torch.av1.obu import BitWriter  # noqa: E402
from oavif_tpu_torch.io import avif as A  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

NAMES = ("other_first_420.avif", "other_between_420.avif",
         "deep_other_first_444.avif", "depth_second_444.avif",
         "other_governs_420.avif", "class_mixed_512.avif",
         "op_params_420.avif", "order_hint_off_420.avif",
         "frame_id_len_420.avif", "sb_size_420.avif",
         "layers_new_key_420.avif", "layers_ops_one_420.avif",
         "depth_second_420.avif",
         "depth_first_420.avif", "mono_second_420.avif",
         "alpha_other_first_420.avif")
BROKEN = ("layers_new_inter_420.avif", "layers_ops_drop_420.avif")
# the timing and decoder model info of ``sequence_header``'s
# ``decoder_model``: (num_units_in_display_tick, time_scale,
# num_ticks_per_picture_minus_1, buffer_delay_length_minus_1,
# num_units_in_decoding_tick, buffer_removal_time_length_minus_1,
# frame_presentation_time_length_minus_1)
TIMING = (1, 30, 0, 15, 1, 9, 9)


def _obu(typ: int, payload: bytes) -> bytes:
    """An OBU with no extension header."""
    return bytes([(typ << 3) | 0x02]) + _leb128(len(payload)) + payload


def sequence_header(s: A.SequenceHeader, levels=None,
                    op_params=None) -> bytes:
    """The sequence header OBU of ``s`` (its reduced still-picture form
    where ``s.reduced``), each operating point at ``levels`` (31, no
    level's limits, unless given); with ``op_params`` (each operating
    point's (decoder_buffer_delay, encoder_buffer_delay,
    low_delay_mode_flag)) timing info (``TIMING``, equal picture
    intervals) and decoder model info, each operating point's
    operating_parameters_info present."""
    w = BitWriter()
    w.f(s.profile, 3)
    w.f(int(s.reduced), 1)  # still_picture
    w.f(int(s.reduced), 1)  # reduced_still_picture_header
    levels = levels or [31] * len(s.op_idcs)
    if s.reduced:
        w.f(levels[0], 5)
    else:
        w.f(int(op_params is not None), 1)  # timing_info_present_flag
        if op_params is not None:
            units, scale, ticks, delay, dec_units, removal, pres = TIMING
            w.f(units, 32)
            w.f(scale, 32)
            w.f(1, 1)  # equal_picture_interval
            n = (ticks + 1).bit_length() - 1  # uvlc of ticks
            w.f(0, n)
            w.f(ticks + 1, n + 1)
            w.f(1, 1)  # decoder_model_info_present_flag
            w.f(delay, 5)
            w.f(dec_units, 32)
            w.f(removal, 5)
            w.f(pres, 5)
        w.f(0, 1)  # initial_display_delay_present_flag
        w.f(len(s.op_idcs) - 1, 5)
        for i, idc in enumerate(s.op_idcs):
            w.f(idc, 12)
            w.f(levels[i], 5)
            if levels[i] > 7:
                w.f(0, 1)  # seq_tier
            if op_params is not None:
                w.f(1, 1)  # decoder_model_present_for_this_op
                dec, enc, low = op_params[i]
                w.f(dec, TIMING[3] + 1)
                w.f(enc, TIMING[3] + 1)
                w.f(low, 1)
    w.f(s.width_bits - 1, 4)
    w.f(s.height_bits - 1, 4)
    w.f(s.width - 1, s.width_bits)
    w.f(s.height - 1, s.height_bits)
    if not s.reduced:
        w.f(int(s.frame_ids), 1)
        if s.frame_ids:
            w.f(s.delta_id_len - 2, 4)
            w.f(s.id_len - s.delta_id_len - 1, 3)
    w.f(int(s.sb128), 1)
    w.f(int(s.filter_intra), 1)
    w.f(int(s.intra_edge), 1)
    if not s.reduced:
        for v in (s.interintra, s.masked_compound, s.warped_motion,
                  s.dual_filter):
            w.f(int(v), 1)
        w.f(int(s.order_hint_bits > 0), 1)  # enable_order_hint
        if s.order_hint_bits:
            w.f(int(s.jnt_comp), 1)
            w.f(int(s.ref_frame_mvs), 1)
        w.f(int(s.screen_tools == 2), 1)  # seq_choose_screen_content_tools
        if s.screen_tools != 2:
            w.f(s.screen_tools, 1)
        if s.screen_tools:
            w.f(int(s.integer_mv == 2), 1)  # seq_choose_integer_mv
            if s.integer_mv != 2:
                w.f(s.integer_mv, 1)
        if s.order_hint_bits:
            w.f(s.order_hint_bits - 1, 3)
    w.f(int(s.superres), 1)
    w.f(int(s.cdef), 1)
    w.f(int(s.restoration), 1)
    # color_config
    w.f(int(s.bit_depth > 8), 1)
    if s.profile == 2 and s.bit_depth > 8:
        w.f(int(s.bit_depth == 12), 1)
    if s.profile != 1:
        w.f(int(s.mono), 1)
    w.f(1, 1)  # color_description_present_flag
    for v in s.cicp:
        w.f(v, 8)
    if s.mono:
        w.f(int(s.full_range), 1)
    elif s.cicp != (1, 13, 0):
        w.f(int(s.full_range), 1)
        if s.profile == 2 and s.bit_depth == 12:
            w.f(s.ss[0], 1)
            if s.ss[0]:
                w.f(s.ss[1], 1)
        if s.ss == (1, 1):
            w.f(0, 2)  # chroma_sample_position
    if not s.mono:
        w.f(int(s.separate_uv_delta_q), 1)
    w.f(int(s.film_grain), 1)
    w.trailing_bits()
    return _obu(1, w.data())


def _picture(cls: str, size: int, crop: int = 0) -> np.ndarray:
    px = bench_images(size, (cls,))[cls]
    return px[:crop, :crop] if crop else px


def still(cls: str, size: int, q: int = 30, crop: int = 0,
          depth: int = 8, mono: bool = False, ss: str = "4:2:0") -> bytes:
    """libaom's still of a class picture (its luma alone where ``mono``):
    a reduced sequence header and one frame OBU."""
    yuv = to_yuv(_picture(cls, size, crop), depth, ss)
    return aom_encode(yuv[:1] if mono else yuv, depth, ss, q)


def layers(cls: str, usage: int, options: dict = (),
           cfg_words: dict = ()) -> bytes:
    """libaom's two spatial layers of a 256x256 class picture."""
    return aom_encode_layers(to_yuv(_picture(cls, 256), 8, "4:2:0"), 8,
                             "4:2:0", (44, 28), usage=usage,
                             options={"cpu-used": 8, **dict(options)},
                             cfg_words=cfg_words)


def split(stream: bytes) -> list:
    """The stream's OBUs, each its raw bytes."""
    return [raw for _, raw, _, _ in _obus(stream)]


def parsed(seq_obu: bytes) -> A.SequenceHeader:
    typ, _, p, e = next(_obus(seq_obu))
    assert typ == 1
    return A.parse_sequence_header(A._Bits(seq_obu, p, e))


def avif(payload: bytes, own: bytes, size: int, depth: int = 8,
         alpha: bytes = None, alpha_own: bytes = None) -> bytes:
    """The AVIF of an item of ``payload`` (and an alpha item), each
    ``av1C`` from its stream's own sequence header (``own``, the first
    OBU of a stream as libaom wrote it)."""
    data = bytearray(mux_avif(payload, size, size, depth,
                              high_bitdepth=depth > 8, cicp=CICP,
                              full_range=True, alpha_payload=alpha))
    at = data.index(b"av1C") + 4
    data[at:at + 4] = _av1c(own)
    if alpha is not None:
        at = data.index(b"av1C", at) + 4
        data[at:at + 4] = _av1c(alpha_own)
    return bytes(data)


def _with_dm_bit(o: Obu, s: A.SequenceHeader) -> bytes:
    """Frame ``o`` (of a header without decoder model info) under a header
    with it (``TIMING``, equal picture intervals): its
    buffer_removal_time_present_flag, 0, after primary_ref_frame."""
    d, at = _prefix(o.bits, s)
    bits = _emit(d, s)
    intra = d["frame_type"] in (A.KEY_FRAME, A.INTRA_ONLY_FRAME)
    forced = d["frame_type"] == A.SWITCH_FRAME or (
        d["frame_type"] == A.KEY_FRAME and d["show"])
    # the emitted tail after primary_ref_frame: refresh_frame_flags and
    # the slots' order hints
    tail = 0 if forced else 8
    if (not intra or d["refresh"] != 0xFF) and d["err"] \
            and s.order_hint_bits:
        tail += 8 * s.order_hint_bits
    cut = len(bits) - tail
    return _frame_obu(o, bits[:cut] + [0] + bits[cut:] + o.bits[at:])


def written(name: str):
    """(bytes, how) of fixture ``name``."""
    im = "mixed"
    if name.startswith(("other_", "class_")):
        size = 512 if name.startswith("class_") else 256
        own = split(still(im, size, q=30))
        other = split(still("fractal", 128, q=40, crop=64))[0]
        seq, frame = own
        order = {"other_first_420.avif": [other, seq, frame],
                 "other_between_420.avif": [seq, other, seq, frame],
                 "other_governs_420.avif": [seq, other, frame],
                 "class_mixed_512.avif": [seq, other, seq, frame]}[name]
        how = {"writer": f"{LIBAOM} still", "class": im, "size": size,
               "order": ["own" if o is seq else "other" if o is other
                         else "frame" for o in order]}
        return avif(b"".join(order), seq, size), how
    if name == "op_params_420.avif":
        stream = layers(im, 1)
        s, _, obus = walk(stream)
        a = sequence_header(s, op_params=[(3, 5, 0)] * len(s.op_idcs))
        b = sequence_header(s, op_params=[(7, 2, 1)] * len(s.op_idcs))
        s_dm = parsed(a)
        frames = [o for o in obus if o.typ == 6]
        payload = a + _with_dm_bit(frames[0], s) + b \
            + _with_dm_bit(frames[1], s)
        assert s_dm.key == parsed(b).key and s_dm.decoder_model_info
        return avif(payload, obus[0].raw, 256), {
            "writer": f"{LIBAOM} layers 0..1, realtime", "class": im,
            "headers": "decoder model info, operating parameters (3, 5, "
                       "0) then (7, 2, 1)"}
    if name in ("order_hint_off_420.avif", "sb_size_420.avif"):
        change = {"order_hint_off_420.avif": {"enable-order-hint": 0},
                  "sb_size_420.avif": {"sb-size": 128}}[name]
        first = split(layers(im, 0))
        second = split(layers(im, 0, options=change))
        how = {"writer": f"{LIBAOM} layers 0..1, good quality",
               "class": im, "layer 1 from": change}
        return avif(b"".join(first[:2] + second[2:]), first[0], 256), how
    if name in ("layers_new_key_420.avif", "layers_ops_one_420.avif",
                "layers_ops_drop_420.avif", "layers_new_inter_420.avif"):
        # the second header written again with inter-intra on, over
        # good-quality layers (layer 1 a key frame) or realtime ones
        first = split(layers(im, 1 if "inter" in name else 0))
        s = parsed(first[0])
        ops = {"layers_ops_one_420.avif": (0,),
               "layers_ops_drop_420.avif": tuple(reversed(s.op_idcs))}.get(
                   name, s.op_idcs)
        new = sequence_header(replace(s, op_idcs=ops, interintra=True))
        frames = [o for o in first if o[0] >> 3 == 6]
        how = {"writer": f"{LIBAOM} layers 0..1, "
                         f"{'realtime' if 'inter' in name else 'good quality'}",
               "class": im, "second header": f"operating points "
                                             f"{[hex(v) for v in ops]}, "
                                             f"enable_interintra_compound "
                                             f"1, levels 31"}
        return avif(b"".join([first[0], frames[0], new, frames[1]]),
                    first[0], 256), how
    if name == "frame_id_len_420.avif":
        first = split(layers(im, 0, cfg_words={"error_resilient": 1}))
        s, _, obus = walk(b"".join(first))
        assert s.frame_ids
        s2 = replace(s, delta_id_len=s.delta_id_len - 3,
                     id_len=s.id_len - 2)
        d, at = _prefix(obus[3].bits, s)
        d["frame_id"] &= (1 << s2.id_len) - 1
        frame = _frame_obu(obus[3], _emit(d, s2) + obus[3].bits[at:])
        how = {"writer": f"{LIBAOM} layers 0..1, good quality, error "
                         "resilient", "class": im,
               "second header": f"frame ids {s2.delta_id_len}, "
                                f"{s2.id_len} bits"}
        return avif(b"".join(first[:2] + [sequence_header(s2), frame]),
                    first[0], 256), how
    if name == "deep_other_first_444.avif":
        seq, frame = split(still(im, 256, q=30, depth=10, ss="4:4:4"))
        other = split(still("fractal", 128, q=40, crop=64, depth=10,
                            ss="4:4:4"))[0]
        how = {"writer": f"{LIBAOM} still", "class": im,
               "order": ["other", "own", "frame"]}
        return avif(other + seq + frame, seq, 256, depth=10), how
    if name in ("depth_second_420.avif", "depth_first_420.avif",
                "mono_second_420.avif", "depth_second_444.avif"):
        ss = "4:4:4" if name.endswith("444.avif") else "4:2:0"
        seq, frame = split(still(im, 256, q=30, ss=ss))
        s = parsed(seq)
        other = sequence_header(replace(s, mono=True) if name.startswith(
            "mono") else replace(s, bit_depth=10))
        order = [other, seq, frame] if name == "depth_first_420.avif" \
            else [seq, other, frame]
        how = {"writer": f"{LIBAOM} still", "class": im,
               "order": ["own" if o is seq else "changed" if o is other
                         else "frame" for o in order],
               "changed": "monochrome" if name.startswith("mono")
               else "10 bits"}
        return avif(b"".join(order), seq, 256), how
    if name == "alpha_other_first_420.avif":
        px = with_alpha(_picture(im, 256))
        yuv = to_yuv(px, 8, "4:2:0")
        colour = aom_encode(yuv, 8, "4:2:0", 30)
        a = np.rint(px[..., 3].astype(np.float64)).astype(np.uint8)
        aseq, aframe = split(aom_encode([a], 8, "4:2:0", 30))
        other = split(still("fractal", 128, q=40, crop=64, mono=True))[0]
        how = {"writer": f"{LIBAOM} still", "class": im,
               "alpha order": ["other", "own", "frame"]}
        return avif(colour, split(colour)[0], 256,
                    alpha=other + aseq + aframe, alpha_own=aseq), how
    raise KeyError(name)


def seqhdr_entry(data: bytes, how: dict) -> dict:
    out = entry(data, how)
    av1 = A.parse_av1(A.read_container(data).color.payload)
    out["sequences"] = [f.sequence for f in av1.frames]
    return out


def main() -> None:
    from make_avif_frametypes import broken_entry

    manifest = {}
    only = set(sys.argv[1:])
    for name in [*NAMES, *BROKEN]:
        if only and name not in only:
            continue
        print(name, flush=True)
        data, how = written(name)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = (broken_entry if name in BROKEN
                          else seqhdr_entry)(data, how)
    path = os.path.join(HERE, "manifest.json")
    if only and os.path.exists(path):
        with open(path) as f:
            manifest = {**json.load(f), **manifest}
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(e["bytes"] for e in manifest.values())
    print(f"{len(manifest)} files, {total} bytes")


if __name__ == "__main__":
    main()
