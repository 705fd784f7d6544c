"""Regenerate the AVIF fixtures of ``tests/test_torch_avif_frametypes.py``
and ``chip_smoke.py``: items whose frames are of every type and header
form of spec 5.9.2 (frame ids, SWITCH frames, INTRA_ONLY frames, hidden
key and inter frames shown by show_existing_frame,
frame_refs_short_signaling, a first frame that is not a key frame), and
their ``manifest.json``.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/avif_frametypes/make_avif_frametypes.py [NAME ...]

Names rewrite only those files and merge into the manifest. The system
libaom 3.6.0 writes every stream through ctypes
(``make_avif_layers.aom_encode_layers``):

- its own files: layers in realtime usage with ``g_error_resilient`` 1
  (cfg word 12; libaom then codes frame ids: frame_id_numbers_present_flag
  in the sequence header, current_frame_id and each reference's
  delta_frame_id in the frame headers) and ``AOM_EFLAG_SET_S_FRAME`` on a
  layer (a SWITCH frame), in 4:2:0, 4:2:2, 4:4:4 and monochrome at 8, 10
  and 12 bits, two to four layers, an S-frame on top and in the middle;
  the 512x512 mixed class and a 3840x2160 frame, each in error-resilient
  layers with an S-frame on top;
- written files: libaom's frames with their uncompressed headers written
  again (``reframe``: a key frame as an INTRA_ONLY frame or as a hidden
  key frame, an inter frame hidden; the tile data as libaom coded it),
  show_existing_frame headers (``show_existing``), and inter frames of
  ``avif_layers/inter_writer.py`` over libaom's layers (on an INTRA_ONLY
  GOLDEN, and under frame_refs_short_signaling with order hints chosen
  so that set_frame_refs takes each of its branches, once with frame
  ids). libaom's good-quality usage codes every layer past the first as
  another key frame, whose tiles an INTRA_ONLY frame takes as they are
  (both are FrameIsIntra, with the default CDFs), intrabc included in
  screen content; its realtime usage writes film grain into layers
  (``film-grain-test``).

dav1d (the system libavif 0.11.1) judges each at its first decode. The
refusals: an inter frame and a SWITCH frame first (libaom's layers with
the key frame left out), a reference frame id and a display_frame_id
altered, and a show_existing_frame of an empty slot; dav1d, the
reference and the port refuse each as a broken stream. Read by all
three: an INTRA_ONLY frame first, one that refreshes every slot and a
show_existing_frame of a key frame that is not showable (both of which
the spec forbids), and a hidden layer-1 frame shown from an OBU of
layer 0 (dav1d shows the frame as of its own layer, the highest).

The manifest holds what ``make_avif_progressive.entry`` holds (dav1d's
Y'UV CRC, the reference's ``load_avif`` and ``decode_avif_to_rgb8`` CRCs,
the frames, the layer shown, the tool counts, each frame's sizes), each
frame's header (``headers``: frame_type, show_frame, the slot a
show_existing_frame shows or None, refresh_frame_flags, and the slots of
LAST..ALTREF), and for a refusal the port's message (``broken``).
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
for _sub in ("avif_superres", "avif_layers", "avif_progressive",
             "avif_screen"):
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), _sub))

from chip_smoke import frame_4k  # noqa: E402
from inter_writer import (_obu_ext, _obus,  # noqa: E402
                          InterBlock, write_layered)
from make_avif_layers import LIBAOM, aom_encode_layers, container  # noqa: E402
from make_avif_progressive import entry  # noqa: E402
from make_avif_screen import screen  # noqa: E402
from make_avif_superres import to_yuv  # noqa: E402
from oavif_tpu_torch.av1.obu import BitWriter  # noqa: E402
from oavif_tpu_torch.io import avif as A  # noqa: E402
from oavif_tpu_torch.io.av1_refs import RefHeaders  # noqa: E402
from oavif_tpu_torch.scripts.corpus import bench_images  # noqa: E402

S_FRAME = 1 << 29  # AOM_EFLAG_SET_S_FRAME
KEY, INTER, INTRA_ONLY, SWITCH = (A.KEY_FRAME, A.INTER_FRAME,
                                 A.INTRA_ONLY_FRAME, A.SWITCH_FRAME)
ER = {"error_resilient": 1}

# libaom's own: name -> (class, size, depth, subsampling, quantizers,
# error resilience, the layers coded as S-frames, libaom's options)
LIBAOM_FILES = {
    "er_420_8bit.avif": ("mixed", 256, 8, "4:2:0", (40, 30), True, (), {}),
    "er3_422_10bit.avif": ("oriented", 256, 10, "4:2:2", (44, 32, 20), True,
                           (), {}),
    "er4_mono_8bit.avif": ("sinusoid", 256, 8, "mono", (50, 40, 30, 20),
                           True, (), {}),
    "s_top_444_12bit.avif": ("edges", 256, 12, "4:4:4", (40, 28), False,
                             (1,), {}),
    "s_mid_420_10bit.avif": ("fractal", 256, 10, "4:2:0", (48, 36, 24),
                             False, (1,), {}),
    "er_s_top_422_8bit.avif": ("text", 256, 8, "4:2:2", (40, 30, 20), True,
                               (2,), {}),
    "s_top_mono_10bit.avif": ("fractal", 256, 10, "mono", (36, 24), False,
                              (1,), {}),
    "class_mixed_512.avif": ("mixed", 512, 8, "4:2:0", (40, 30), True, (1,),
                             {}),
    "photo4k_420.avif": ("photo4k", 2160, 8, "4:2:0", (60, 50), True,
                         (1,), {}),
}
WRITTEN = ("intra_only_golden_420.avif", "intra_only_shown_422_10bit.avif",
           "intra_only_intrabc_444.avif", "hidden_key_420.avif",
           "hidden_grain_420_10bit.avif", "short_back_420.avif",
           "short_fwd_ids_444.avif", "short_fallback_420.avif",
           "first_intra_only_420.avif", "intra_only_refresh_all_420.avif",
           "shown_in_layer0_420.avif", "show_not_showable_420.avif")
BROKEN = ("first_inter_420.avif", "first_switch_420.avif",
          "frame_id_mutated_420.avif", "display_id_mutated_420.avif",
          "show_existing_empty_420.avif")


def _picture(cls: str, size: int) -> np.ndarray:
    if cls == "photo4k":
        return frame_4k()
    if cls == "screen":
        return screen(size, size)
    return bench_images(size)[cls]


def encode(cls: str, size: int, depth: int, ss: str, qs, er: bool = False,
           s_frames=(), usage: int = 1, options: dict = ()) -> bytes:
    """libaom's layers of a class picture (``cpu-used`` 8 unless
    ``options`` say), the temporal delimiters left out."""
    mono = ss == "mono"
    yuv = to_yuv(_picture(cls, size), depth, "4:2:0" if mono else ss)
    return aom_encode_layers(
        yuv[:1] if mono else yuv, depth, "4:2:0" if mono else ss, qs,
        usage=usage, options={"cpu-used": 8, **dict(options)},
        cfg_words=ER if er else (),
        layer_flags={i: S_FRAME for i in s_frames})


# ---------------------------------------------------------------------------
# frame headers written again
# ---------------------------------------------------------------------------


class Obu:
    """One OBU of a stream: its raw bytes, type and layer ids, and for a
    frame header its uncompressed header's bits and what follows them (a
    frame OBU's tile group, after the byte alignment)."""

    def __init__(self, raw: bytes, typ: int) -> None:
        self.raw, self.typ = raw, typ
        ext = (raw[0] >> 2) & 1
        self.tid, self.sid = (raw[1] >> 5, (raw[1] >> 3) & 3) if ext \
            else (0, 0)
        self.bits: Optional[List[int]] = None
        self.tail = b""
        self.fh: Optional[A.FrameHeader] = None


def walk(stream: bytes) -> Tuple[A.SequenceHeader, bytes, List[Obu]]:
    """The stream's sequence header (parsed, and its OBU) and its OBUs,
    each frame header read by the port's parser over the slots as the
    frames before it left them."""
    seq, seq_obu, out = None, b"", []
    refs = RefHeaders()
    for typ, raw, p, e in _obus(stream):
        o = Obu(raw, typ)
        if typ == 1:
            seq = A.parse_sequence_header(A._Bits(stream, p, e))
            seq_obu = raw
        elif typ in (3, 6):
            b = A._Bits(stream, p, e)
            o.fh = A.parse_frame_header(b, seq, o.tid, o.sid, refs)
            refs.update(o.fh)
            n = b.pos - 8 * p
            o.bits = [stream[p + i // 8] >> (7 - i % 8) & 1
                      for i in range(n)]
            assert typ == 6, "a frame header OBU with its own tile groups"
            o.tail = stream[p + (n + 7) // 8:e]
        out.append(o)
    return seq, seq_obu, out


def _uint(v: int, n: int) -> List[int]:
    return [v >> (n - 1 - i) & 1 for i in range(n)]


def _prefix(bits: List[int], s: A.SequenceHeader) -> Tuple[dict, int]:
    """The fields of an uncompressed header up to its references (spec
    5.9.2; no decoder model) and where the rest begins: frame_size() in an
    intra frame, frame_refs_short_signaling in another."""
    at = [1]

    def f(n):
        v = 0
        for _ in range(n):
            v = v << 1 | bits[at[0]]
            at[0] += 1
        return v

    assert bits[0] == 0, "not a show_existing_frame header"
    d = dict(frame_type=f(2), show=f(1))
    assert not s.decoder_model_info
    d["showable"] = d["frame_type"] != KEY if d["show"] else f(1)
    forced = d["frame_type"] == SWITCH or (d["frame_type"] == KEY
                                           and d["show"])
    d["err"] = 1 if forced else f(1)
    d["disable_cdf"] = f(1)
    d["screen"] = f(1) if s.screen_tools == 2 else None
    screen_on = s.screen_tools if d["screen"] is None else d["screen"]
    d["int_mv"] = f(1) if screen_on and s.integer_mv == 2 else None
    d["frame_id"] = f(s.id_len) if s.frame_ids else 0
    d["override"] = 1 if d["frame_type"] == SWITCH else f(1)
    d["order_hint"] = f(s.order_hint_bits)
    intra = d["frame_type"] in (KEY, INTRA_ONLY)
    d["primary"] = 7 if intra or d["err"] else f(3)
    d["refresh"] = 0xFF if forced else f(8)
    d["ref_hints"] = None
    if (not intra or d["refresh"] != 0xFF) and d["err"] \
            and s.order_hint_bits:
        d["ref_hints"] = [f(s.order_hint_bits) for _ in range(8)]
    return d, at[0]


def _emit(d: dict, s: A.SequenceHeader) -> List[int]:
    """``_prefix``'s fields as bits."""
    ft = d["frame_type"]
    out = [0] + _uint(ft, 2) + [d["show"]]
    if not d["show"]:
        out.append(d["showable"])
    forced = ft == SWITCH or (ft == KEY and d["show"])
    if not forced:
        out.append(d["err"])
    out.append(d["disable_cdf"])
    for k in ("screen", "int_mv"):
        if d[k] is not None:
            out.append(d[k])
    if s.frame_ids:
        out += _uint(d["frame_id"], s.id_len)
    if ft != SWITCH:
        out.append(d["override"])
    out += _uint(d["order_hint"], s.order_hint_bits)
    intra = ft in (KEY, INTRA_ONLY)
    if not (intra or d["err"]):
        out += _uint(d["primary"], 3)
    if not forced:
        out += _uint(d["refresh"], 8)
    if (not intra or d["refresh"] != 0xFF) and d["err"] \
            and s.order_hint_bits:
        for h in d["ref_hints"]:
            out += _uint(h, s.order_hint_bits)
    return out


def _frame_obu(o: Obu, bits: List[int], sid: Optional[int] = None) -> bytes:
    """A frame OBU of header ``bits`` and ``o``'s tile group, in layer
    ``sid`` (``o``'s where None)."""
    w = BitWriter()
    for v in bits:
        w.f(v, 1)
    w.byte_align()
    return _obu_ext(6, w.data() + o.tail, o.sid if sid is None else sid)


def reframe(o: Obu, s: A.SequenceHeader, slot_hints=None, sid=None,
            **edits) -> bytes:
    """``o``'s frame with its header's leading fields (``_prefix``'s
    names) changed by ``edits``; ``slot_hints`` are the ref_order_hint
    values an error-resilient frame then writes (the slots' order hints,
    zeros where None)."""
    d, at = _prefix(o.bits, s)
    d.update(edits)
    intra = d["frame_type"] in (KEY, INTRA_ONLY)
    if (not intra or d["refresh"] != 0xFF) and d["err"] \
            and s.order_hint_bits and d["ref_hints"] is None:
        d["ref_hints"] = list(slot_hints or [0] * 8)
    return _frame_obu(o, _emit(d, s) + o.bits[at:], sid)


def show_existing(s: A.SequenceHeader, slot: int, sid: int,
                  frame_id: Optional[int] = None) -> bytes:
    """A show_existing_frame header OBU of ``slot`` in layer ``sid``,
    with its display_frame_id under frame ids."""
    w = BitWriter()
    w.f(1, 1)
    w.f(slot, 3)
    assert not s.decoder_model_info
    if s.frame_ids:
        w.f(frame_id, s.id_len)
    w.trailing_bits()
    return _obu_ext(3, w.data(), sid)


def _frames(obus: List[Obu]) -> List[Obu]:
    return [o for o in obus if o.typ in (3, 6)]


def _ref_sbs(rng: np.random.Generator, n_sb: int, refs,
             hp: bool = True) -> list:
    """Superblocks of 16x16 to 64x64 single-reference blocks, each on a
    reference drawn from ``refs`` (LAST 1 .. ALTREF 7) in a random mode
    (NEWMV within 24, NEARESTMV, NEARMV, GLOBALMV) and filters."""
    step = 1 if hp else 2
    out = []
    for _ in range(n_sb):
        leaf = int(rng.choice((2, 3, 4)))
        out.append((leaf, [InterBlock(
            tuple(int(step * rng.integers(-24, 25)) for _ in range(2)),
            (int(rng.integers(3)), int(rng.integers(3))),
            ref=int(rng.choice(refs)),
            mode=str(rng.choice(("new", "nearest", "near", "global"))))
            for _ in range(1 << 2 * (4 - leaf))]))
    return out


def written(name: str) -> Tuple[bytes, dict]:
    """A ``WRITTEN`` or ``BROKEN`` file and how it was made."""
    how = {"writer": f"{LIBAOM}, headers written again"}
    depth, size = 8, 256
    if name == "intra_only_golden_420.avif":
        # good-quality layers: key frames; layer 1 an INTRA_ONLY frame of
        # slot 1, layer 2 written on LAST the key frame and GOLDEN it
        stream = encode("mixed", 256, 8, "4:2:0", (40, 20, 30), usage=0)
        s, seq_obu, obus = walk(stream)
        f = _frames(obus)
        base = seq_obu + f[0].raw + reframe(
            f[1], s, frame_type=INTRA_ONLY, refresh=0x02, err=0,
            order_hint=1)
        rng = np.random.default_rng(1)
        out = write_layered(base + f[2].raw, _ref_sbs(rng, 16, (1, 4)),
                            base_layers=2, ref_slots=(0, 0, 0, 1, 0, 0, 0))
        how.update(layers="good usage: key, INTRA_ONLY (refresh 0x02), "
                          "inter_writer.py on LAST slot 0, GOLDEN slot 1",
                   usage=0, quantizers=[40, 20, 30])
    elif name in ("intra_only_shown_422_10bit.avif",
                  "intra_only_intrabc_444.avif",
                  "first_intra_only_420.avif"):
        cls, depth, ss, opts = {
            "intra_only_shown_422_10bit.avif": ("oriented", 10, "4:2:2", {}),
            "intra_only_intrabc_444.avif": ("screen", 8, "4:4:4",
                                            {"cpu-used": 6}),
            "first_intra_only_420.avif": ("edges", 8, "4:2:0", {})}[name]
        stream = encode(cls, 256, depth, ss, (40, 24), usage=0,
                        options=opts)
        s, seq_obu, obus = walk(stream)
        f = _frames(obus)
        first = name.startswith("first")
        # error resilient: its ref_order_hint[] the slots' hints (zeros)
        body = reframe(f[1], s, frame_type=INTRA_ONLY, refresh=0x06,
                       err=int(not first), order_hint=1)
        out = seq_obu + (b"" if first else f[0].raw) + body
        how.update(layers=("layer 0 left out, " if first else "key, ")
                   + "INTRA_ONLY shown (refresh 0x06)", usage=0,
                   quantizers=[40, 24], options=opts, **{"class": cls})
    elif name == "hidden_key_420.avif":
        # error-resilient layers (frame ids): the key frame hidden in slot
        # 3 alone, shown by show_existing_frame, which fills every slot;
        # layer 1 reads slot 0
        stream = encode("fractal", 256, 8, "4:2:0", (40, 30), er=True)
        s, seq_obu, obus = walk(stream)
        f = _frames(obus)
        key = f[0].fh
        out = seq_obu + reframe(f[0], s, show=0, showable=1, err=1,
                                refresh=0x08) \
            + show_existing(s, 3, 0, key.frame_id) + f[1].raw
        how.update(layers="error-resilient: key hidden (refresh 0x08), "
                          "show_existing_frame of slot 3, layer 1",
                   quantizers=[40, 30])
    elif name == "hidden_grain_420_10bit.avif":
        stream = encode("oriented", 256, 10, "4:2:0", (40, 30),
                        options={"film-grain-test": 2})
        s, seq_obu, obus = walk(stream)
        f = _frames(obus)
        out = seq_obu + f[0].raw + reframe(f[1], s, show=0, showable=1) \
            + show_existing(s, 1, 1)
        how.update(layers="key, layer 1 hidden with its film grain, "
                          "show_existing_frame of slot 1",
                   quantizers=[40, 30], options={"film-grain-test": 2})
        depth = 10
    elif name.startswith("short_"):
        # four layers, the fourth written under frame_refs_short_signaling
        ids = name == "short_fwd_ids_444.avif"
        ss = "4:4:4" if ids else "4:2:0"
        stream = encode({"short_back_420.avif": "text",
                         "short_fwd_ids_444.avif": "edges",
                         "short_fallback_420.avif": "oriented"}[name], 256, 8,
                        ss, (40, 30, 20, 10), er=ids)
        s, seq_obu, obus = walk(stream)
        f = _frames(obus)
        base = stream
        if name == "short_fallback_420.avif":
            # the key frame at order hint 30 (slots 0, 3..7), layers 1 and
            # 2 at 1 and 2: before the frame at 25 only slots 1 and 2,
            # both coded, so LAST2 and LAST3 fall back to the earliest
            base = seq_obu + reframe(f[0], s, order_hint=30) + b"".join(
                o.raw for o in f[1:])
        hint, short = {"short_back_420.avif": (1, (0, 3)),
                       "short_fwd_ids_444.avif": (3, (0, 3)),
                       "short_fallback_420.avif": (25, (2, 1))}[name]
        rng = np.random.default_rng(len(name))
        out = write_layered(base, _ref_sbs(rng, 16, range(1, 8)),
                            base_layers=3, order_hint=hint, short=short)
        how.update(layers=f"libaom layers 0..2, inter_writer.py layer 3 at "
                          f"order hint {hint}, short signaling of LAST "
                          f"slot {short[0]} and GOLDEN slot {short[1]}",
                   quantizers=[40, 30, 20], error_resilient=ids)
    elif name == "intra_only_refresh_all_420.avif":
        # an INTRA_ONLY frame that refreshes every slot: the spec forbids
        # it, dav1d and the reference read it
        stream = encode("sinusoid", 256, 8, "4:2:0", (60, 44), usage=0)
        s, seq_obu, obus = walk(stream)
        f = _frames(obus)
        out = seq_obu + f[0].raw + reframe(
            f[1], s, frame_type=INTRA_ONLY, refresh=0xFF, err=1,
            order_hint=1)
        how.update(layers="key, INTRA_ONLY shown (refresh 0xFF)", usage=0,
                   quantizers=[60, 44])
    elif name == "shown_in_layer0_420.avif":
        # layer 1 hidden, shown by a show_existing_frame in an OBU of
        # layer 0: the frame shown is of layer 1, the highest
        stream = encode("text", 256, 8, "4:2:0", (56, 40))
        s, seq_obu, obus = walk(stream)
        f = _frames(obus)
        out = seq_obu + f[0].raw + reframe(f[1], s, show=0, showable=1) \
            + show_existing(s, 1, 0)
        how.update(layers="key, layer 1 hidden, show_existing_frame of "
                          "slot 1 in layer 0", quantizers=[56, 40])
    elif name in ("display_id_mutated_420.avif",
                  "show_existing_empty_420.avif",
                  "show_not_showable_420.avif"):
        stream = encode("fractal", 256, 8, "4:2:0", (60, 50), er=True)
        s, seq_obu, obus = walk(stream)
        f = _frames(obus)
        fid = f[0].fh.frame_id
        slot, fid = (3, fid + 1) if name.startswith("display") else \
            (2, fid) if name.startswith("show_existing") else (3, fid)
        showable = int(name != "show_not_showable_420.avif")
        out = seq_obu + reframe(f[0], s, show=0, showable=showable, err=1,
                                refresh=0x08) \
            + show_existing(s, slot, 0, fid) + f[1].raw
        how.update(layers=f"error-resilient: key hidden (refresh 0x08, "
                          f"showable_frame {showable}), show_existing_frame "
                          f"of slot {slot} with display_frame_id "
                          + ("one past the slot's" if fid != f[0].fh.frame_id
                             else "the key frame's"),
                   quantizers=[60, 50])
    elif name in ("first_inter_420.avif", "first_switch_420.avif"):
        stream = encode("mixed", 256, 8, "4:2:0", (40, 30),
                        s_frames=(1,) if "switch" in name else ())
        s, seq_obu, obus = walk(stream)
        out = seq_obu + _frames(obus)[1].raw
        how.update(layers="layer 0 left out", quantizers=[40, 30])
    elif name == "frame_id_mutated_420.avif":
        stream = encode("mixed", 256, 8, "4:2:0", (40, 30), er=True)
        s, seq_obu, obus = walk(stream)
        f = _frames(obus)
        out = seq_obu + f[0].raw + reframe(
            f[1], s, frame_id=f[1].fh.frame_id + 1)
        how.update(layers="error-resilient, layer 1's current_frame_id "
                          "one past libaom's", quantizers=[40, 30])
    else:
        raise KeyError(name)
    return container(out, size, size, depth), how


def libaom_file(name: str) -> Tuple[bytes, dict]:
    cls, size, depth, ss, qs, er, s_frames, opts = LIBAOM_FILES[name]
    stream = encode(cls, size, depth, ss, qs, er=er, s_frames=s_frames,
                    options=opts)
    w, h = (3840, 2160) if cls == "photo4k" else (size, size)
    how = {"writer": f"{LIBAOM} layers 0..{len(qs) - 1}", "class": cls,
           "depth": depth, "ss": ss, "quantizers": list(qs),
           "error_resilient": er, "s_frames": list(s_frames),
           "options": {k: str(v) for k, v in {"cpu-used": 8,
                                               **opts}.items()}}
    return container(stream, w, h, depth), how


def headers(data: bytes) -> list:
    av1 = A.parse_av1(A.read_container(data).color.payload)
    return [[f.frame.frame_type, int(f.frame.show_frame),
             f.frame.show_existing, f.frame.refresh_frame_flags,
             list(f.frame.ref_frame_idx)] for f in av1.frames]


def broken_entry(data: bytes, how: dict) -> dict:
    """A stream all three refuse: the port's message."""
    import io

    from PIL import Image

    from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv

    try:
        A.decode_avif(data)
    except OSError as e:
        msg = str(e)
    else:
        raise AssertionError("the port decodes a broken stream")
    for read in (decode_to_yuv,
                 lambda d: Image.open(io.BytesIO(d)).convert("RGB")):
        try:
            read(data)
        except Exception:
            continue
        raise AssertionError("dav1d or Pillow reads a broken stream")
    return {"bytes": len(data), "written": how, "broken": msg}


def frametypes_entry(data: bytes, how: dict) -> dict:
    out = entry(data, how)
    out["headers"] = headers(data)
    return out


def main() -> None:
    manifest = {}
    only = set(sys.argv[1:])
    for name in [*LIBAOM_FILES, *WRITTEN, *BROKEN]:
        if only and name not in only:
            continue
        print(name, flush=True)
        data, how = (libaom_file if name in LIBAOM_FILES else written)(name)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = (broken_entry if name in BROKEN
                          else frametypes_entry)(data, how)
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
