"""AVIF decoder without Pillow or libavif.

Three parts, all on the host:

- the ISOBMFF container (``read_container``): ``ftyp``, ``meta`` with
  ``hdlr``, ``pitm``, ``iloc`` (versions 0-2, construction methods 0 and
  1), ``iinf``/``infe`` (versions 2 and 3), ``iref`` (``auxl``,
  ``prem``, ``dimg``), ``grpl`` (entity groups such as ``altr``), ``idat``
  and ``iprp``/``ipco``/``ipma``; the properties
  ``ispe``, ``av1C``, ``colr`` (``nclx``, ``prof``/``rICC``) and ``auxC``,
  and the display transforms ``irot``, ``imir`` and ``clap``, which are
  recorded and not applied (the reference returns the pixels as coded);
  and the item data in ``mdat`` or ``idat``. A gain map (a ``tmap``
  derived item over the colour item and the gain map image, in an
  ``altr`` group with the colour item) is read as libavif 1.3 reads it
  when it decodes the colour image only, which is what Pillow asks for:
  the colour item is the image, and neither the ``tmap`` item, its
  properties and metadata, nor the gain map image is read or checked;
  only the ``grpl`` boxes and the ``dimg`` references must be well formed
  (each entity group exactly its entities; one ``dimg`` box per derived
  item, and an item in one derived item's list once), and a primary
  ``tmap`` item raises, as libavif finds no colour item then;
- the layer properties ``a1op``, ``lsel`` and ``a1lx``, which pick and
  check an item's operating point and spatial layer as libavif 1.3 does;
- the OBU layer (``parse_av1``): the sequence header in its reduced
  still-picture form and its full form, repeated, or differing and so
  starting a new coded video sequence, the operating point's frames
  (shown key frames and inter frames: the uncompressed header with
  superres, the reference frames, the inter fields, global motion and
  film grain loaded from a reference, kept across frames in
  ``av1_refs.RefHeaders``), the tile info with uniform or non-uniform
  spacing and the tile groups (spec sections 5.3-5.9 and 5.11.1);
- the tile decode and reconstruction in C (``av1_decode.c``, in the host
  library), frame by frame into the eight reference slots
  (``av1_refs.RefFrames``), for 4:4:4, 4:2:2, 4:2:0 and monochrome
  streams at 8, 10 and 12 bits with the intra tools libaom writes, inter
  blocks of a single reference (the MV stack, every single-reference
  mode, the subpel filters, sub-8x8 chroma, the motion modes OBMC and
  LOCALWARP) of the frame's size or, as a
  progressive image's later layers and a superres inter frame read
  theirs, of another scale within the spec's 2x and 1/16 limits, quantizer
  matrices, delta q
  and delta LF (``delta_lf_multi`` too), segmentation with every feature
  (ALT_Q, the four ALT_LF, SKIP, and REF_FRAME and GLOBALMV, which in a
  key frame only move the segment id before ``skip``), the chroma
  palette and intra block copy included, then the post-filters in
  C on each plane's own grid (``av1_postfilter.c``): deblocking at each
  block's level (its DeltaLF and segment), CDEF with the strength set of each 64x64, superres
  upscaling and loop restoration over the upscaled width; film grain
  synthesis (``av1_grain.c``); the scaling of a frame to its ``ispe``
  (``yuv_scale.py``, libyuv's ScalePlane); and the conversion to 8-bit
  RGB as libavif 1.3 converts (libyuv's fixed-point matrices,
  full or limited range, and bilinear chroma upsampling where libavif
  hands the conversion to libyuv, its own float path elsewhere;
  ``yuv_to_rgb8``).

A file that ends early or holds a broken box or header raises ``OSError``;
a stream or container feature outside the decoder's toolset raises
``UnsupportedAvif`` (a ``ValueError``) naming it. Nothing falls back to
another decoder.
"""

from __future__ import annotations

import ctypes as C
import struct
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")


class UnsupportedAvif(ValueError):
    """An AVIF feature or AV1 tool that this decoder does not handle."""


def _broken(what: str) -> OSError:
    return OSError(f"broken AVIF file ({what})")


# ---------------------------------------------------------------------------
# ISOBMFF container
# ---------------------------------------------------------------------------


def _boxes(data: bytes, start: int, end: int):
    """Yield (type, payload start, payload end) for the boxes in
    data[start:end]."""
    pos = start
    while pos < end:
        if end - pos < 8:
            raise _broken("truncated box header")
        size, typ = struct.unpack_from(">I4s", data, pos)
        hdr = 8
        if size == 1:
            if end - pos < 16:
                raise _broken("truncated box header")
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if typ == b"uuid":
            hdr += 16
        if size < hdr:
            raise _broken(f"box {typ!r} size {size}")
        if pos + size > end:
            raise _broken(f"truncated box {typ!r}")
        yield typ, pos + hdr, pos + size
        pos += size


class _Reader:
    """Big-endian field reader over one box payload."""

    def __init__(self, data: bytes, pos: int, end: int, box: str) -> None:
        self.data, self.pos, self.end, self.box = data, pos, end, box

    def take(self, n: int) -> bytes:
        if self.pos + n > self.end:
            raise _broken(f"truncated {self.box}")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0

    def fullbox(self) -> Tuple[int, int]:
        v = self.u(1)
        return v, self.u(3)

    def cstring(self) -> bytes:
        i = self.data.find(b"\x00", self.pos, self.end)
        if i < 0:
            raise _broken(f"unterminated string in {self.box}")
        s = self.data[self.pos:i]
        self.pos = i + 1
        return s


@dataclass
class Av1Item:
    """One image item (or a sequence's track): its coded payload and its
    properties. A ``grid`` item keeps its descriptor in ``grid`` and its
    cells, in raster order, in ``cells``; its ``payload`` and ``av1c``
    are those of its first cell."""

    item_id: int
    payload: bytes
    width: int = 0
    height: int = 0
    av1c: bytes = b""
    nclx: Optional[Tuple[int, int, int, bool]] = None
    icc: Optional[bytes] = None
    # the display transforms, recorded and not applied: the reference
    # (libavif 1.3 through Pillow) returns the pixels as coded
    irot: int = 0  # anticlockwise quarter turns
    imir: Optional[int] = None  # mirror axis: 0 vertical, 1 horizontal
    clap: Optional[Tuple[int, ...]] = None  # the 8 fields of the box
    grid: Optional[Tuple[int, int, int, int]] = None  # rows, cols, w, h
    cells: List["Av1Item"] = field(default_factory=list)
    # a layered item: the operating point ``a1op`` names, the spatial
    # layer ``lsel`` names (None: the highest, as 0xFFFF), and the layer
    # sizes of ``a1lx``
    op: int = 0
    layer: Optional[int] = None
    layer_sizes: Tuple[int, ...] = ()


@dataclass
class AvifContainer:
    """The image an AVIF file shows, as libavif 1.3 picks it: the primary
    item, or sample 0 of the colour track where the major brand is
    ``avis`` (``source`` says which); its alpha, and whether the colour
    is premultiplied by it (``prem``)."""

    color: Av1Item
    alpha: Optional[Av1Item] = None
    premultiplied: bool = False
    source: str = "item"


@dataclass
class _Meta:
    primary: Optional[int] = None
    types: Dict[int, bytes] = field(default_factory=dict)
    locs: Dict[int, tuple] = field(default_factory=dict)
    refs: List[Tuple[bytes, int, List[int]]] = field(default_factory=list)
    props: List[Tuple[bytes, int, int]] = field(default_factory=list)
    assoc: Dict[int, List[Tuple[int, bool]]] = field(default_factory=dict)
    idat: Tuple[int, int] = (0, 0)
    groups: Optional[List[Tuple[bytes, int, List[int]]]] = None  # grpl


def _parse_iloc(r: _Reader, m: _Meta) -> None:
    version, _ = r.fullbox()
    if version > 2:
        raise UnsupportedAvif(f"AVIF: iloc version {version}")
    b = r.u(1)
    off_size, len_size = b >> 4, b & 15
    b = r.u(1)
    base_size = b >> 4
    index_size = b & 15 if version in (1, 2) else 0
    for s in (off_size, len_size, base_size, index_size):
        if s not in (0, 4, 8):
            raise _broken("iloc field size")
    count = r.u(2) if version < 2 else r.u(4)
    for _ in range(count):
        item_id = r.u(2) if version < 2 else r.u(4)
        method = r.u(2) & 15 if version in (1, 2) else 0
        dref = r.u(2)
        base = r.u(base_size)
        extents = []
        for _ in range(r.u(2)):
            if index_size:
                r.u(index_size)
            extents.append((r.u(off_size), r.u(len_size)))
        m.locs[item_id] = (method, dref, base, extents)


def _parse_meta(data: bytes, start: int, end: int) -> _Meta:
    m = _Meta()
    r = _Reader(data, start, end, "meta")
    r.fullbox()
    seen_hdlr = False
    for typ, ps, pe in _boxes(data, r.pos, end):
        b = _Reader(data, ps, pe, typ.decode("latin-1"))
        if typ == b"hdlr":
            b.fullbox()
            b.u(4)
            if b.take(4) != b"pict":
                raise _broken("meta handler is not 'pict'")
            seen_hdlr = True
        elif typ == b"pitm":
            v, _ = b.fullbox()
            m.primary = b.u(2) if v == 0 else b.u(4)
        elif typ == b"iloc":
            _parse_iloc(b, m)
        elif typ == b"iinf":
            v, _ = b.fullbox()
            n = b.u(2) if v == 0 else b.u(4)
            for ityp, ips, ipe in _boxes(data, b.pos, pe):
                if ityp != b"infe":
                    continue
                e = _Reader(data, ips, ipe, "infe")
                iv, flags = e.fullbox()
                if iv < 2:
                    raise UnsupportedAvif(f"AVIF: infe version {iv}")
                item_id = e.u(2) if iv == 2 else e.u(4)
                e.u(2)
                m.types[item_id] = e.take(4)
                n -= 1
            if n > 0:
                raise _broken("iinf entry count")
        elif typ == b"iref":
            v, _ = b.fullbox()
            idsz = 2 if v == 0 else 4
            for rtyp, rps, rpe in _boxes(data, b.pos, pe):
                e = _Reader(data, rps, rpe, "iref")
                src = e.u(idsz)
                m.refs.append((rtyp, src, [e.u(idsz) for _ in range(e.u(2))]))
        elif typ == b"grpl":
            if m.groups is not None:
                raise _broken("two grpl boxes")
            m.groups = []
            for gtyp, gps, gpe in _boxes(data, ps, pe):
                g = _Reader(data, gps, gpe, gtyp.decode("latin-1"))
                g.fullbox()
                gid = g.u(4)
                ids = [g.u(4) for _ in range(g.u(4))]
                if g.pos != gpe:
                    raise _broken(f"{g.box} entity group size")
                m.groups.append((gtyp, gid, ids))
        elif typ == b"idat":
            m.idat = (ps, pe)
        elif typ == b"iprp":
            for ptyp, pps, ppe in _boxes(data, ps, pe):
                if ptyp == b"ipco":
                    m.props = list(_boxes(data, pps, ppe))
                elif ptyp == b"ipma":
                    e = _Reader(data, pps, ppe, "ipma")
                    v, flags = e.fullbox()
                    last = -1
                    for _ in range(e.u(4)):
                        item_id = e.u(2) if v < 1 else e.u(4)
                        if item_id <= last:  # libavif 1.3 refuses it
                            raise _broken("ipma item IDs are not in "
                                          "increasing order")
                        last = item_id
                        lst = m.assoc.setdefault(item_id, [])
                        for _ in range(e.u(1)):
                            if flags & 1:
                                x = e.u(2)
                                lst.append((x & 0x7FFF, bool(x >> 15)))
                            else:
                                x = e.u(1)
                                lst.append((x & 0x7F, bool(x >> 7)))
    if not seen_hdlr:
        raise _broken("no hdlr box")
    for item_id, lst in m.assoc.items():
        for idx, essential in lst:
            ptyp = m.props[idx - 1][0] if 0 < idx <= len(m.props) else b""
            if ptyp in (b"irot", b"imir", b"clap") and not essential:
                # libavif 1.3 wants transformative properties essential,
                # on any item, the tmap and the gain map included
                raise _broken(f"item {item_id}'s {ptyp.decode()} property "
                              f"is not marked essential")
    _check_dimg(m)
    return m


def _check_dimg(m: _Meta) -> None:
    """libavif 1.3 records one derived item per ``dimg`` target: one
    ``dimg`` box per derived item, and an item in one derived item's list
    once (it refuses a repeat as an invalid grid, and an item of two
    derived items as not implemented), whatever the derived items are."""
    owner: Dict[int, int] = {}
    sources = set()
    for rtyp, src, dst in m.refs:
        if rtyp != b"dimg":
            continue
        if src in sources:
            raise _broken(f"two dimg boxes from item {src}")
        sources.add(src)
        for d in dst:
            if owner.get(d) == src:
                raise _broken(f"item {d} twice in the dimg of item {src}")
            if d in owner:
                raise UnsupportedAvif(
                    f"AVIF: item {d} in the dimg of items {owner[d]} and "
                    f"{src} (libavif 1.3 does not implement it)")
            owner[d] = src


def _item_payload(data: bytes, m: _Meta, item_id: int) -> bytes:
    if item_id not in m.locs:
        raise _broken(f"item {item_id} has no iloc entry")
    method, dref, base, extents = m.locs[item_id]
    if dref:
        raise UnsupportedAvif("AVIF: item data in an external file")
    if method == 1:
        src0, src1 = m.idat
    elif method == 0:
        src0, src1 = 0, len(data)
    else:
        raise UnsupportedAvif(f"AVIF: iloc construction method {method}")
    out = bytearray()
    for off, length in extents:
        a = src0 + base + off
        b = src1 if length == 0 else a + length
        if a > src1 or b > src1:
            raise _broken("item data past the end of the file")
        out += data[a:b]
    return bytes(out)


_KNOWN = {b"ispe", b"pixi", b"av1C", b"colr", b"auxC", b"pasp", b"a1lx",
          b"clli", b"mdcv", b"cclv", b"amve", b"irot", b"imir", b"clap",
          b"a1op", b"lsel"}
# libavif 1.3's limits on an image's size (a grid's output, a frame scaled
# to its ispe: imageSizeLimit,
# imageDimensionLimit)
_GRID_MAX_PIXELS = 16384 * 16384
_GRID_MAX_SIDE = 32768


def _properties(data: bytes, m: _Meta, it: Av1Item, what: str) -> None:
    """Fill ``it`` from the properties ``ipma`` associates with it."""
    for idx, essential in m.assoc.get(it.item_id, []):
        if idx == 0:
            continue
        if idx > len(m.props):
            raise _broken("ipma property index")
        ptyp, ps, pe = m.props[idx - 1]
        p = _Reader(data, ps, pe, ptyp.decode("latin-1"))
        if ptyp == b"irot":
            it.irot = p.u(1) & 3
        elif ptyp == b"imir":
            it.imir = p.u(1) & 1
        elif ptyp == b"clap":
            it.clap = tuple(p.u(4) for _ in range(8))
        elif ptyp == b"ispe":
            p.fullbox()
            it.width, it.height = p.u(4), p.u(4)
        elif ptyp == b"av1C":
            it.av1c = data[ps:pe]
            if len(it.av1c) < 4 or it.av1c[0] != 0x81:
                raise _broken("av1C")
        elif ptyp == b"colr":
            _colr(data, p, pe, it)
        elif ptyp in (b"a1op", b"lsel", b"a1lx"):
            _layer_property(p, ptyp, essential, it)
        elif essential and ptyp not in _KNOWN:
            raise UnsupportedAvif(f"AVIF: essential property "
                                  f"{ptyp.decode('latin-1')!r} of the "
                                  f"{what} item")


def _layer_property(p: _Reader, ptyp: bytes, essential: bool,
                    it: Av1Item) -> None:
    """``a1op``, ``lsel`` and ``a1lx`` as libavif 1.3 reads them: the
    first two must be essential, the third must not; ``lsel`` names a
    layer below 4 or 0xFFFF (every layer: the highest shown)."""
    name = ptyp.decode()
    if (ptyp == b"a1lx") == essential:
        raise _broken(f"the {name} property is "
                      f"{'' if essential else 'not '}marked essential")
    if ptyp == b"a1op":
        it.op = p.u(1)
    elif ptyp == b"lsel":
        layer = p.u(2)
        if layer != 0xFFFF and layer >= 4:
            raise _broken(f"lsel layer {layer}")
        it.layer = None if layer == 0xFFFF else layer
    else:
        n = 4 if p.u(1) & 1 else 2
        it.layer_sizes = tuple(p.u(n) for _ in range(3))


def _check_layer_sizes(it: Av1Item) -> None:
    """libavif 1.3's check of ``a1lx``: the sizes before the first 0 leave
    the last layer some of the item's data."""
    total = 0
    for size in it.layer_sizes:
        if not size:
            break
        total += size
    if it.layer_sizes and total >= len(it.payload):
        raise _broken(f"a1lx layer sizes of {total} bytes in an item of "
                      f"{len(it.payload)}")


def _colr(data: bytes, p: _Reader, end: int, it: Av1Item) -> None:
    """A ``colr`` box: the first ``nclx`` and the first ICC profile."""
    kind = p.take(4)
    if kind == b"nclx":
        cp, tc, mc, fr = p.u(2), p.u(2), p.u(2), p.u(1)
        if it.nclx is None:
            it.nclx = (cp, tc, mc, bool(fr >> 7))
    elif kind in (b"prof", b"rICC"):
        if it.icc is None:
            it.icc = data[p.pos:end]


def _av1_item(data: bytes, m: _Meta, item_id: int, what: str) -> Av1Item:
    typ = m.types.get(item_id)
    if typ is None:
        raise _broken(f"{what} item {item_id} has no infe entry")
    if typ == b"grid":
        return _grid_item(data, m, item_id, what)
    if typ == b"tmap":
        raise UnsupportedAvif(
            f"AVIF: {what} item of type 'tmap' (libavif 1.3 decodes a gain "
            f"map's colour item only where that item is the primary one, "
            f"and finds no image item here)")
    if typ != b"av01":
        raise UnsupportedAvif(
            f"AVIF: {what} item of type {typ.decode('latin-1')!r} (libavif "
            f"1.3 decodes no derived item but 'grid' and no image item but "
            f"AV1)")
    it = Av1Item(item_id, _item_payload(data, m, item_id))
    _properties(data, m, it, what)
    _check_layer_sizes(it)
    if not it.av1c:
        raise _broken(f"{what} item without av1C")
    if not it.width or not it.height:
        raise _broken(f"{what} item without ispe")
    return it


def _grid_item(data: bytes, m: _Meta, item_id: int, what: str) -> Av1Item:
    """A ``grid`` derived item (ISO/IEC 23008-12 6.6.2.3): its descriptor,
    its own properties and its ``dimg`` cells, each an AV1 item, with
    libavif 1.3's checks of the descriptor and the cells' types,
    properties and ``av1C``."""
    desc = _item_payload(data, m, item_id)
    r = _Reader(desc, 0, len(desc), "grid")
    version = r.u(1)
    if version != 0:
        raise _broken(f"grid version {version}")
    flags = r.u(1)
    rows, cols = r.u(1) + 1, r.u(1) + 1
    n = 4 if flags & 1 else 2
    ow, oh = r.u(n), r.u(n)
    if r.pos != r.end:
        raise _broken("grid descriptor size")
    if not ow or not oh:
        raise _broken(f"grid output size {ow}x{oh}")
    if ow * oh > _GRID_MAX_PIXELS or max(ow, oh) > _GRID_MAX_SIDE:
        raise _broken(f"grid output size {ow}x{oh} is too large")
    ids = [d for rtyp, src, dst in m.refs if rtyp == b"dimg" and src == item_id
           for d in dst]
    if len(ids) != rows * cols:
        raise _broken(f"grid of {rows}x{cols} cells with {len(ids)} dimg "
                      "references")
    cells = [_av1_item(data, m, i, f"{what} grid cell") for i in ids]
    if any(c.av1c[1:3] != cells[0].av1c[1:3] for c in cells):
        raise _broken("the av1C of the grid cells differ")
    it = Av1Item(item_id, cells[0].payload, ow, oh,
                 grid=(rows, cols, ow, oh), cells=cells)
    _properties(data, m, it, what)
    if (it.width, it.height) != (ow, oh):
        raise _broken(f"grid ispe {it.width}x{it.height}, output size "
                      f"{ow}x{oh}")
    it.av1c = cells[0].av1c  # libavif adopts the first cell's
    return it


def _read_items(data: bytes, top: list) -> AvifContainer:
    metas = [(s, e) for t, s, e in top if t == b"meta"]
    if len(metas) != 1:
        raise _broken("no meta box" if not metas else "two meta boxes")
    m = _parse_meta(data, *metas[0])
    if m.primary is None:
        raise _broken("no pitm box")
    color = _av1_item(data, m, m.primary, "primary")
    alpha_id = None
    for rtyp, src, dst in m.refs:
        if rtyp == b"auxl" and m.primary in dst:
            for idx, _ in m.assoc.get(src, []):
                if idx and idx <= len(m.props) and m.props[idx - 1][0] == b"auxC":
                    _, ps, pe = m.props[idx - 1]
                    urn = _Reader(data, ps + 4, pe, "auxC").cstring()
                    if urn in ALPHA_URNS and alpha_id is None:
                        alpha_id = src
    if alpha_id is None:
        return AvifContainer(color)
    prem = any(rtyp == b"prem" and src == m.primary and alpha_id in dst
               for rtyp, src, dst in m.refs)
    return AvifContainer(color, _av1_item(data, m, alpha_id, "alpha"), prem)


# ---------------------------------------------------------------------------
# Image sequences: sample 0 of the colour track
# ---------------------------------------------------------------------------


@dataclass
class _Track:
    track_id: int = 0
    width: int = 0
    height: int = 0
    refs: Dict[bytes, List[int]] = field(default_factory=dict)
    entry: Optional[Av1Item] = None  # the av01 sample entry's properties
    aux_urn: Optional[bytes] = None
    chunk0: Optional[int] = None  # the first chunk's offset
    first_run: int = 0  # samples in the first chunk
    size0: int = 0  # sample 0's size


def _child(data: bytes, start: int, end: int, typ: bytes):
    for t, s, e in _boxes(data, start, end):
        if t == typ:
            return s, e
    return None


def _parse_trak(data: bytes, start: int, end: int) -> _Track:
    """What libavif reads of a ``trak`` to find its sample 0: ``tkhd``,
    ``tref``, and ``mdia``/``minf``/``stbl`` (``stsd`` with the ``av01``
    sample entry, ``stsc``, ``stco`` or ``co64``, ``stsz``)."""
    t = _Track()
    for typ, s, e in _boxes(data, start, end):
        if typ == b"tkhd":
            r = _Reader(data, s, e, "tkhd")
            v, _ = r.fullbox()
            r.take(16 if v == 1 else 8)
            t.track_id = r.u(4)
            r.take(4 + (8 if v == 1 else 4) + 8 + 8 + 36)
            t.width, t.height = r.u(4) >> 16, r.u(4) >> 16
        elif typ == b"tref":
            for rtyp, rs, re_ in _boxes(data, s, e):
                r = _Reader(data, rs, re_, "tref")
                t.refs.setdefault(rtyp, []).extend(
                    r.u(4) for _ in range((re_ - rs) // 4))
        elif typ == b"mdia":
            minf = _child(data, s, e, b"minf")
            stbl = minf and _child(data, *minf, b"stbl")
            if stbl:
                _parse_stbl(data, *stbl, t)
    return t


def _parse_stbl(data: bytes, start: int, end: int, t: _Track) -> None:
    for typ, s, e in _boxes(data, start, end):
        r = _Reader(data, s, e, typ.decode("latin-1"))
        if typ == b"stsd":
            r.fullbox()
            r.u(4)
            for etyp, es, ee in _boxes(data, r.pos, e):
                if etyp != b"av01" or t.entry is not None:
                    continue
                if ee - es < 78:
                    raise _broken("av01 sample entry size")
                it = Av1Item(0, b"")
                for ptyp, ps, pe in _boxes(data, es + 78, ee):
                    if ptyp == b"av1C":
                        it.av1c = data[ps:pe]
                        if len(it.av1c) < 4 or it.av1c[0] != 0x81:
                            raise _broken("av1C")
                    elif ptyp == b"colr":
                        _colr(data, _Reader(data, ps, pe, "colr"), pe, it)
                    elif ptyp == b"auxi":
                        t.aux_urn = _Reader(data, ps + 4, pe, "auxi").cstring()
                t.entry = it
        elif typ == b"stsc":
            r.fullbox()
            n = r.u(4)
            if n:
                first, per = r.u(4), r.u(4)
                if first != 1 or per == 0:
                    raise _broken("sample table: the first chunk holds no "
                                  "sample")
                t.first_run = per
        elif typ in (b"stco", b"co64"):
            r.fullbox()
            if r.u(4):
                t.chunk0 = r.u(4 if typ == b"stco" else 8)
        elif typ == b"stsz":
            r.fullbox()
            size, count = r.u(4), r.u(4)
            if count:
                t.size0 = size or r.u(4)


def _track_item(data: bytes, t: _Track, what: str) -> Av1Item:
    if not t.width or not t.height:
        raise _broken(f"{what} track {t.track_id} size {t.width}x{t.height}")
    if not t.entry.av1c:
        raise _broken(f"{what} track without av1C")
    if t.chunk0 is None or not t.first_run or not t.size0:
        raise _broken(f"{what} track without a sample")
    if t.chunk0 + t.size0 > len(data):
        raise _broken("sample data past the end of the file")
    it = t.entry
    it.item_id, it.width, it.height = t.track_id, t.width, t.height
    it.payload = data[t.chunk0:t.chunk0 + t.size0]
    return it


def _read_tracks(data: bytes, top: list) -> AvifContainer:
    """Sample 0 of the colour track (the first AV1 track that is no
    auxiliary of another) and of its alpha track (an AV1 track whose
    ``tref`` ``auxl`` names it and whose sample entry's ``auxi`` names
    alpha), as libavif 1.3 reads an image sequence's first frame."""
    moov = [(s, e) for t, s, e in top if t == b"moov"]
    if len(moov) != 1:
        raise _broken("no moov box" if not moov else "two moov boxes")
    tracks = [_parse_trak(data, s, e) for t, s, e in _boxes(data, *moov[0])
              if t == b"trak"]
    usable = [t for t in tracks if t.track_id and t.entry is not None
              and t.chunk0 is not None]
    colors = [t for t in usable if not t.refs.get(b"auxl")]
    if not colors:
        raise _broken("no AV1 colour track")
    color = colors[0]
    alphas = [t for t in usable if color.track_id in t.refs.get(b"auxl", [])
              and t.aux_urn in (None,) + ALPHA_URNS]
    alpha = _track_item(data, alphas[0], "alpha") if alphas else None
    prem = bool(alphas) and alphas[0].track_id in color.refs.get(b"prem", [])
    return AvifContainer(_track_item(data, color, "colour"), alpha, prem,
                         "track")


def read_container(data: bytes) -> AvifContainer:
    """The image an AVIF file shows and its alpha, if any: libavif 1.3's
    automatic source takes the colour track's sample 0 where the major
    brand is ``avis`` and the primary item where it is ``avif``; under
    another major brand, the track where the file has one."""
    top = list(_boxes(data, 0, len(data)))
    if not top or top[0][0] != b"ftyp":
        raise _broken("no ftyp box")
    _, fs, fe = top[0]
    if fe - fs < 8 or (fe - fs) % 4:
        raise _broken("ftyp size")
    major = data[fs:fs + 4]
    brands = {major} | {data[i:i + 4] for i in range(fs + 8, fe, 4)}
    if not brands & {b"avif", b"avis"}:
        raise _broken("not an AVIF brand")
    types = {t for t, _, _ in top}
    # libavif 1.3 wants the box each brand promises
    for brand, box in ((b"avif", b"meta"), (b"avis", b"moov")):
        if brand in brands and box not in types:
            raise _broken(f"the {brand.decode()!r} brand without a "
                          f"{box.decode()!r} box")
    if major == b"avis" or (major != b"avif" and b"moov" in types):
        return _read_tracks(data, top)
    return _read_items(data, top)


# ---------------------------------------------------------------------------
# OBUs: sequence header, frame header, tile groups
# ---------------------------------------------------------------------------


class _Bits:
    """MSB-first bit reader (spec 4.10 descriptors)."""

    def __init__(self, data: bytes, start: int = 0, end: Optional[int] = None):
        self.data = data
        self.pos = start * 8
        self.end = (len(data) if end is None else end) * 8

    def f(self, n: int) -> int:
        if self.pos + n > self.end:
            raise _broken("truncated AV1 header")
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v >> (n - 1) else v

    def ns(self, n: int) -> int:
        """A value below n in a non-symmetric code (spec 4.10.7)."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        lz = 0
        while not self.f(1):
            lz += 1
            if lz >= 32:
                return (1 << 32) - 1
        return self.f(lz) + (1 << lz) - 1

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def le(self, n: int) -> int:
        v = 0
        for i in range(n):
            v |= self.f(8) << (8 * i)
        return v


def _leb128(data: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    for i in range(8):
        if pos >= len(data):
            raise _broken("truncated OBU size")
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return v, pos
    raise _broken("OBU size")


@dataclass
class SequenceHeader:
    profile: int = 0
    reduced: bool = False
    width: int = 0
    height: int = 0
    width_bits: int = 16
    height_bits: int = 16
    op_idc: int = 0
    decoder_model_info: bool = False
    equal_picture_interval: bool = False
    buffer_removal_time_length: int = 0
    presentation_time_length: int = 0
    op_decoder_model: Tuple[bool, ...] = ()
    op_idcs: Tuple[int, ...] = ()
    frame_ids: bool = False
    id_len: int = 0  # idLen
    delta_id_len: int = 0  # delta_frame_id_length_minus_2 + 2
    sb128: bool = False
    filter_intra: bool = False
    intra_edge: bool = False
    order_hint_bits: int = 0
    screen_tools: int = 2
    integer_mv: int = 2
    superres: bool = False
    cdef: bool = False
    restoration: bool = False
    bit_depth: int = 8
    mono: bool = False
    cicp: Tuple[int, int, int] = (2, 2, 2)
    full_range: bool = False
    ss: Tuple[int, int] = (1, 1)
    separate_uv_delta_q: bool = False
    film_grain: bool = False
    # the inter tools a frame may switch on
    interintra: bool = False
    masked_compound: bool = False
    warped_motion: bool = False
    dual_filter: bool = False
    jnt_comp: bool = False
    ref_frame_mvs: bool = False
    # the header's bits up to film_grain_params_present less its
    # operating_parameters_info: two headers of one coded video sequence
    # have the same (spec 7.5; dav1d compares its parsed fields so)
    key: bytes = field(default=b"", repr=False)


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def parse_sequence_header(b: _Bits) -> SequenceHeader:
    s = SequenceHeader()
    start = b.pos
    skipped = []  # the bit ranges of operating_parameters_info
    s.profile = b.f(3)
    if s.profile > 2:
        raise _broken(f"seq_profile {s.profile}")
    b.f(1)  # still_picture
    s.reduced = bool(b.f(1))
    if s.reduced:
        b.f(5)
        s.op_idcs = (0,)
        s.op_decoder_model = (False,)
    else:
        if b.f(1):  # timing_info_present_flag
            b.f(32)
            b.f(32)
            s.equal_picture_interval = bool(b.f(1))
            if s.equal_picture_interval:
                b.uvlc()
            s.decoder_model_info = bool(b.f(1))
            if s.decoder_model_info:
                buffer_delay_len = b.f(5) + 1
                b.f(32)
                s.buffer_removal_time_length = b.f(5) + 1
                s.presentation_time_length = b.f(5) + 1
        else:
            buffer_delay_len = 0
        display_delay = b.f(1)
        idcs, models = [], []
        for _ in range(b.f(5) + 1):
            idcs.append(b.f(12))
            if b.f(5) > 7:
                b.f(1)
            present = False
            if s.decoder_model_info:
                present = bool(b.f(1))
                if present:
                    at = b.pos
                    b.f(buffer_delay_len)
                    b.f(buffer_delay_len)
                    b.f(1)
                    skipped.append((at, b.pos))
            models.append(present)
            if display_delay and b.f(1):
                b.f(4)
        s.op_idcs, s.op_decoder_model = tuple(idcs), tuple(models)
    s.op_idc = s.op_idcs[0]
    s.width_bits, s.height_bits = b.f(4) + 1, b.f(4) + 1
    s.width = b.f(s.width_bits) + 1
    s.height = b.f(s.height_bits) + 1
    if not s.reduced:
        s.frame_ids = bool(b.f(1))
        if s.frame_ids:
            s.delta_id_len = b.f(4) + 2
            s.id_len = b.f(3) + 1 + s.delta_id_len
    s.sb128 = bool(b.f(1))
    s.filter_intra = bool(b.f(1))
    s.intra_edge = bool(b.f(1))
    if not s.reduced:
        s.interintra = bool(b.f(1))
        s.masked_compound = bool(b.f(1))
        s.warped_motion = bool(b.f(1))
        s.dual_filter = bool(b.f(1))
        order_hint = b.f(1)
        if order_hint:
            s.jnt_comp = bool(b.f(1))
            s.ref_frame_mvs = bool(b.f(1))
        s.screen_tools = 2 if b.f(1) else b.f(1)
        if s.screen_tools > 0:
            s.integer_mv = 2 if b.f(1) else b.f(1)
        else:
            s.integer_mv = 2
        if order_hint:
            s.order_hint_bits = b.f(3) + 1
    s.superres = bool(b.f(1))
    s.cdef = bool(b.f(1))
    s.restoration = bool(b.f(1))
    # color_config
    high = b.f(1)
    if s.profile == 2 and high:
        s.bit_depth = 12 if b.f(1) else 10
    else:
        s.bit_depth = 10 if high else 8
    s.mono = False if s.profile == 1 else bool(b.f(1))
    if b.f(1):
        s.cicp = (b.f(8), b.f(8), b.f(8))
    if s.mono:
        s.full_range = bool(b.f(1))
        s.ss = (1, 1)
    else:
        if s.cicp == (1, 13, 0):
            s.full_range = True
            s.ss = (0, 0)
        else:
            s.full_range = bool(b.f(1))
            if s.profile == 0:
                s.ss = (1, 1)
            elif s.profile == 1:
                s.ss = (0, 0)
            elif s.bit_depth == 12:
                sx = b.f(1)
                s.ss = (sx, b.f(1) if sx else 0)
            else:
                s.ss = (1, 0)
            if s.ss == (1, 1):
                b.f(2)
        s.separate_uv_delta_q = bool(b.f(1))
    s.film_grain = bool(b.f(1))
    keep = [(start, b.pos)]
    for lo, hi in skipped:
        keep[-1:] = [(keep[-1][0], lo), (hi, keep[-1][1])]
    s.key = bytes(b.data[i >> 3] >> (7 - (i & 7)) & 1
                  for lo, hi in keep for i in range(lo, hi))
    return s


@dataclass
class FrameHeader:
    # the upscaled (visible) width; under superres the frame is coded
    # ``coded_width`` wide, ``superres_denom`` / 8 narrower (spec
    # UpscaledWidth, FrameWidth, SuperresDenom)
    width: int = 0
    height: int = 0
    coded_width: int = 0
    superres_denom: int = 8
    disable_cdf_update: bool = False
    screen_tools: bool = False
    mi_rows: int = 0
    mi_cols: int = 0
    tile_col_starts: List[int] = field(default_factory=list)
    tile_row_starts: List[int] = field(default_factory=list)
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    tile_size_bytes: int = 4
    base_q: int = 0
    dq: Tuple[int, int, int, int, int] = (0, 0, 0, 0, 0)  # ydc udc uac vdc vac
    lossless: bool = False
    lf_levels: Tuple[int, int, int, int] = (0, 0, 0, 0)
    lf_sharpness: int = 0
    lf_delta_enabled: bool = False
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_strengths: List[Tuple[int, int, int, int]] = field(default_factory=list)
    lr_types: Tuple[int, int, int] = (0, 0, 0)
    lr_unit_shift: int = 0
    lr_uv_shift: int = 0
    tx_mode: int = 0
    reduced_tx_set: bool = False
    qm: Tuple[int, int, int] = (15, 15, 15)  # qm_y, qm_u, qm_v; 15 flat
    delta_q_res: int = -1  # log2 of the delta q step; -1 without delta q
    delta_lf_res: int = -1  # likewise for delta LF
    delta_lf_multi: bool = False  # a DeltaLF per plane and direction
    allow_intrabc: bool = False
    grain: Optional["FilmGrain"] = None
    # segmentation_params (spec 5.9.14): the FeatureData of each segment's
    # enabled features (None where off), SegIdPreSkip, LastActiveSegId
    # and LosslessArray; ``lossless`` above is CodedLossless
    segmentation: Optional[List[List[Optional[int]]]] = None
    seg_preskip: bool = False
    seg_last_active: int = 0
    seg_lossless: Tuple[bool, ...] = (False,) * 8
    # segmentation_update_map and segmentation_temporal_update (an inter
    # frame with a primary reference frame may keep its reference's map,
    # or code its own against it)
    seg_update_map: bool = True
    seg_temporal: bool = False
    # the frame and its references (spec 5.9.2): KEY_FRAME 0, INTER_FRAME
    # 1, INTRA_ONLY_FRAME 2, SWITCH_FRAME 3; the slots it refreshes and,
    # for an inter or switch frame, the slot of each of LAST..ALTREF,
    # their order hints and sign biases (by reference frame, 0 for
    # INTRA_FRAME); its current_frame_id under frame ids. A
    # show_existing_frame header names the slot it shows
    # (``show_existing``) and takes that slot's frame type, sizes, order
    # hint and film grain (spec 7.21)
    frame_type: int = 0
    frame_id: int = 0
    show_existing: Optional[int] = None
    show_frame: bool = True
    showable_frame: bool = False
    error_resilient: bool = True
    primary_ref_frame: int = 7  # PRIMARY_REF_NONE
    refresh_frame_flags: int = 0xFF
    order_hint: int = 0
    ref_frame_idx: Tuple[int, ...] = ()
    ref_order_hints: Tuple[int, ...] = ()
    sign_bias: Tuple[int, ...] = (0,) * 8
    render_size: Tuple[int, int] = (0, 0)
    force_integer_mv: bool = True
    allow_hp: bool = False
    interp_filter: int = 0  # 0-3 one filter for the frame, 4 SWITCHABLE
    motion_switchable: bool = False
    use_ref_frame_mvs: bool = False
    disable_frame_end_update_cdf: bool = True
    context_update_tile_id: int = 0
    # loop_filter_ref_deltas[8] and loop_filter_mode_deltas[2], loaded
    # from the primary reference frame, then updated
    lf_ref_deltas: Tuple[int, ...] = (1, 0, 0, 0, -1, 0, -1, -1)
    lf_mode_deltas: Tuple[int, int] = (0, 0)
    reference_select: bool = False
    skip_mode_present: bool = False
    # SkipModeFrame[0..1] where skip mode is allowed (spec 5.9.22)
    skip_mode_frames: Optional[Tuple[int, int]] = None
    allow_warped_motion: bool = False
    # GmType and gm_params of LAST..ALTREF (0 IDENTITY, 1 TRANSLATION,
    # 2 ROTZOOM, 3 AFFINE)
    gm_type: Tuple[int, ...] = (0,) * 7
    gm_params: Tuple[Tuple[int, ...], ...] = (
        (0, 0, 1 << 16, 0, 0, 1 << 16),) * 7
    # the frame's film_grain_params where it applies grain (what
    # load_grain_params reads back from a reference slot)
    grain_params: Optional["FilmGrain"] = None


@dataclass
class FilmGrain:
    """film_grain_params (spec 5.9.30) of a frame that applies grain."""

    seed: int = 0
    y_points: List[Tuple[int, int]] = field(default_factory=list)
    chroma_from_luma: bool = False
    cb_points: List[Tuple[int, int]] = field(default_factory=list)
    cr_points: List[Tuple[int, int]] = field(default_factory=list)
    scaling_shift: int = 8
    ar_lag: int = 0
    ar_y: List[int] = field(default_factory=list)
    ar_cb: List[int] = field(default_factory=list)
    ar_cr: List[int] = field(default_factory=list)
    ar_shift: int = 6
    scale_shift: int = 0
    cb_mult: Tuple[int, int, int] = (0, 0, 0)  # mult, luma mult, offset
    cr_mult: Tuple[int, int, int] = (0, 0, 0)
    overlap: bool = False
    clip_restricted: bool = False


KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = 0, 1, 2, 3
PRIMARY_REF_NONE = 7
# loop_filter_ref_deltas after setup_past_independence
_LF_REF_DELTAS = (1, 0, 0, 0, -1, 0, -1, -1)
_GM_IDENTITY = (0, 0, 1 << 16, 0, 0, 1 << 16)


def _relative_dist(s: SequenceHeader, a: int, b: int) -> int:
    """get_relative_dist of two order hints."""
    if not s.order_hint_bits:
        return 0
    diff = a - b
    m = 1 << (s.order_hint_bits - 1)
    return (diff & (m - 1)) - (diff & m)


def parse_frame_header(b: _Bits, s: SequenceHeader, tid: int, sid: int,
                       refs: Optional["RefHeaders"] = None) -> FrameHeader:
    """uncompressed_header (spec 5.9.2) of a frame of any type, shown or
    not, or of a show_existing_frame (which ends after the slot it shows);
    ``refs`` holds what the eight reference slots keep of the frames
    before (frame types and ids, sizes, order hints, loop filter deltas,
    segmentation and film grain parameters, global motion), which a frame
    reads and whose update the caller applies (``RefHeaders.update``)."""
    from .av1_refs import RefHeaders, set_frame_refs

    refs = refs if refs is not None else RefHeaders()
    fh = FrameHeader()
    nplanes = 1 if s.mono else 3
    if not s.reduced:
        if b.f(1):  # show_existing_frame
            return _show_existing_frame(b, s, fh, refs)
        fh.frame_type = b.f(2)
        fh.show_frame = bool(b.f(1))
        if fh.show_frame and s.decoder_model_info \
                and not s.equal_picture_interval:
            b.f(s.presentation_time_length)  # temporal_point_info
        fh.showable_frame = fh.frame_type != KEY_FRAME if fh.show_frame \
            else bool(b.f(1))
        fh.error_resilient = True if fh.frame_type == SWITCH_FRAME or (
            fh.frame_type == KEY_FRAME and fh.show_frame) else bool(b.f(1))
    intra = fh.frame_type in (KEY_FRAME, INTRA_ONLY_FRAME)  # FrameIsIntra
    if fh.frame_type == KEY_FRAME and fh.show_frame:
        refs.reset()
    fh.disable_cdf_update = bool(b.f(1))
    screen = b.f(1) if s.screen_tools == 2 else s.screen_tools
    fh.screen_tools = bool(screen)
    fh.force_integer_mv = True
    if screen:
        force = b.f(1) if s.integer_mv == 2 else s.integer_mv
        fh.force_integer_mv = bool(force) or intra
    elif not intra:
        fh.force_integer_mv = False
    if s.frame_ids:
        fh.frame_id = b.f(s.id_len)  # current_frame_id
        refs.mark(fh.frame_id, s.id_len, s.delta_id_len)
    override = 1 if fh.frame_type == SWITCH_FRAME else \
        0 if s.reduced else b.f(1)
    fh.order_hint = b.f(s.order_hint_bits)
    if not (intra or fh.error_resilient):
        fh.primary_ref_frame = b.f(3)
    if s.decoder_model_info:
        if b.f(1):  # buffer_removal_time_present_flag
            for idc, present in zip(s.op_idcs, s.op_decoder_model):
                if present:
                    in_t = (idc >> tid) & 1
                    in_s = (idc >> (sid + 8)) & 1
                    if idc == 0 or (in_t and in_s):
                        b.f(s.buffer_removal_time_length)
    if fh.frame_type == SWITCH_FRAME or (fh.frame_type == KEY_FRAME
                                         and fh.show_frame):
        fh.refresh_frame_flags = 0xFF
    else:
        fh.refresh_frame_flags = b.f(8)
    if (not intra or fh.refresh_frame_flags != 0xFF) \
            and fh.error_resilient and s.order_hint_bits:
        for i in range(8):  # ref_order_hint[i]: a slot that differs is lost
            hint = b.f(s.order_hint_bits)
            if hint != refs.order_hint[i]:
                refs.order_hint[i] = hint
                refs.valid &= ~(1 << i)
    if intra:
        _frame_size(b, s, fh, override)
        fh.allow_intrabc = bool(screen and fh.coded_width == fh.width
                                and b.f(1))
    else:
        short = bool(s.order_hint_bits and b.f(1))
        if short:  # frame_refs_short_signaling: LAST and GOLDEN coded
            last, gold = b.f(3), b.f(3)
            if refs.filled != 0xFF:
                raise _broken("frame_refs_short_signaling with an empty "
                              "reference slot")
            idx = set_frame_refs(last, gold, refs.order_hint,
                                 fh.order_hint, s.order_hint_bits)
        else:
            idx = [0] * 7
        for i in range(7):
            if not short:
                idx[i] = b.f(3)
            if s.frame_ids:  # delta_frame_id_minus_1: the slot's frame id
                delta = b.f(s.delta_id_len) + 1
                want = (fh.frame_id - delta) % (1 << s.id_len)
                if refs.valid >> idx[i] & 1 and refs.frame_id[idx[i]] != want:
                    raise _broken("a reference frame id that is not its "
                                  "slot's")
        fh.ref_frame_idx = tuple(idx)
        if any(not refs.valid >> i & 1 for i in idx):
            raise _broken("an inter frame names an empty reference slot")
        found = False
        if override and not fh.error_resilient:
            for i in idx:  # frame_size_with_refs
                if b.f(1):
                    fh.width, fh.height = refs.size[i]
                    fh.render_size = refs.render[i]
                    found = True
                    break
        if found:
            _superres_params(b, s, fh)
        else:
            _frame_size(b, s, fh, override)
        fh.allow_hp = False if fh.force_integer_mv else bool(b.f(1))
        fh.interp_filter = 4 if b.f(1) else b.f(2)
        fh.motion_switchable = bool(b.f(1))
        fh.use_ref_frame_mvs = bool(not fh.error_resilient
                                    and s.ref_frame_mvs and b.f(1))
        fh.ref_order_hints = tuple(refs.order_hint[i] for i in idx)
        fh.sign_bias = (0,) + tuple(
            int(_relative_dist(s, h, fh.order_hint) > 0)
            for h in fh.ref_order_hints)
    if s.reduced or fh.disable_cdf_update:
        fh.disable_frame_end_update_cdf = True
    else:
        fh.disable_frame_end_update_cdf = bool(b.f(1))
    # load_previous: the primary reference's loop filter deltas,
    # segmentation FeatureData and global motion (PrevGmParams)
    prev = None
    if fh.primary_ref_frame != PRIMARY_REF_NONE:
        prev = fh.ref_frame_idx[fh.primary_ref_frame]
    fh.mi_cols = 2 * ((fh.coded_width + 7) >> 3)
    fh.mi_rows = 2 * ((fh.height + 7) >> 3)
    _tile_info(b, s, fh)
    # quantization_params
    fh.base_q = b.f(8)

    def delta_q():
        return b.su(7) if b.f(1) else 0

    ydc = delta_q()
    udc = uac = vdc = vac = 0
    if nplanes > 1:
        diff = b.f(1) if s.separate_uv_delta_q else 0
        udc, uac = delta_q(), delta_q()
        vdc, vac = (delta_q(), delta_q()) if diff else (udc, uac)
    fh.dq = (ydc, udc, uac, vdc, vac)
    qm = None
    if b.f(1):  # using_qmatrix
        qy, qu = b.f(4), b.f(4)
        qm = (qy, qu, b.f(4) if s.separate_uv_delta_q else qu)
    if b.f(1):  # segmentation_enabled
        _segmentation_params(b, fh, prev is not None,
                             None if prev is None else refs.segmentation[prev])
    # LosslessArray and CodedLossless over the segments' get_qindex(1, i)
    alt_q = [f[0] if fh.segmentation and f[0] is not None else 0
             for f in (fh.segmentation or [[None]] * 8)]
    fh.seg_lossless = tuple(min(max(fh.base_q + a, 0), 255) == 0
                            and not any(fh.dq) for a in alt_q)
    fh.lossless = all(fh.seg_lossless)
    if qm is not None and not fh.lossless:
        fh.qm = qm
    if fh.base_q > 0 and b.f(1):  # delta_q_present
        fh.delta_q_res = b.f(2)
        if not fh.allow_intrabc and b.f(1):  # delta_lf_present
            fh.delta_lf_res = b.f(2)
            fh.delta_lf_multi = bool(b.f(1))
    # loop_filter_params and cdef_params keep their defaults (levels 0,
    # CDEF off) in a lossless frame and under intrabc, lr_params (no
    # restoration) in one lossless at its full width (AllLossless) and
    # under intrabc
    ref_deltas = list(_LF_REF_DELTAS if prev is None
                      else refs.lf_ref_deltas[prev])
    mode_deltas = list((0, 0) if prev is None else refs.lf_mode_deltas[prev])
    if not (fh.lossless or fh.allow_intrabc):
        l0, l1 = b.f(6), b.f(6)
        l2 = l3 = 0
        if nplanes > 1 and (l0 or l1):
            l2, l3 = b.f(6), b.f(6)
        fh.lf_levels = (l0, l1, l2, l3)
        fh.lf_sharpness = b.f(3)
        fh.lf_delta_enabled = bool(b.f(1))
        if fh.lf_delta_enabled and b.f(1):
            for i in range(8):
                if b.f(1):
                    ref_deltas[i] = b.su(7)
            for i in range(2):
                if b.f(1):
                    mode_deltas[i] = b.su(7)
    else:
        ref_deltas, mode_deltas = list(_LF_REF_DELTAS), [0, 0]
    fh.lf_ref_deltas, fh.lf_mode_deltas = tuple(ref_deltas), \
        tuple(mode_deltas)
    if not (fh.lossless or fh.allow_intrabc) and s.cdef:
        fh.cdef_damping = b.f(2) + 3
        fh.cdef_bits = b.f(2)
        for _ in range(1 << fh.cdef_bits):
            yp, ys = b.f(4), b.f(2)
            up = us = 0
            if nplanes > 1:
                up, us = b.f(4), b.f(2)
            fh.cdef_strengths.append(
                (yp, 4 if ys == 3 else ys, up, 4 if us == 3 else us))
    all_lossless = fh.lossless and fh.coded_width == fh.width
    if not (all_lossless or fh.allow_intrabc):
        if s.restoration:
            fh.lr_types = tuple(b.f(2) for _ in range(nplanes)) + \
                (0,) * (3 - nplanes)
            if any(fh.lr_types):
                if s.sb128:
                    fh.lr_unit_shift = b.f(1) + 1
                else:
                    fh.lr_unit_shift = b.f(1)
                    if fh.lr_unit_shift:
                        fh.lr_unit_shift += b.f(1)
                if s.ss == (1, 1) and any(fh.lr_types[1:]):
                    fh.lr_uv_shift = b.f(1)
    fh.tx_mode = 0 if fh.lossless else (2 if b.f(1) else 1)
    if not intra:
        fh.reference_select = bool(b.f(1))
        fh.skip_mode_frames = _skip_mode_frames(s, fh)
        fh.skip_mode_present = bool(fh.skip_mode_frames and b.f(1))
        fh.allow_warped_motion = bool(not fh.error_resilient
                                      and s.warped_motion and b.f(1))
    fh.reduced_tx_set = bool(b.f(1))
    if not intra:
        _global_motion_params(b, fh, None if prev is None
                              else refs.gm_params[prev])
    if s.film_grain and (fh.show_frame or fh.showable_frame) and b.f(1):
        fh.grain = fh.grain_params = _film_grain_params(b, s, fh, refs)
    return fh


def _show_existing_frame(b: _Bits, s: SequenceHeader, fh: FrameHeader,
                         refs: "RefHeaders") -> FrameHeader:
    """The rest of a show_existing_frame header: frame_to_show_map_idx,
    temporal_point_info and display_frame_id; the header then takes the
    slot's frame type, sizes, order hint and film grain (load_grain_params,
    its seed included), and refreshes every slot where the slot holds a
    key frame (spec 7.21, then 7.20)."""
    idx = b.f(3)
    if s.decoder_model_info and not s.equal_picture_interval:
        b.f(s.presentation_time_length)  # temporal_point_info
    if not refs.valid >> idx & 1:
        raise _broken("show_existing_frame of an empty slot")
    if s.frame_ids and b.f(s.id_len) != refs.frame_id[idx]:
        raise _broken("a display_frame_id that is not its slot's")
    fh.show_existing = idx
    fh.frame_type = refs.frame_type[idx]
    fh.frame_id = refs.frame_id[idx]
    fh.refresh_frame_flags = 0xFF if fh.frame_type == KEY_FRAME else 0
    fh.order_hint = refs.order_hint[idx]
    fh.width, fh.height = refs.size[idx]
    fh.render_size = refs.render[idx]
    if s.film_grain:
        fh.grain = fh.grain_params = refs.grain[idx]
    return fh


def _frame_size(b: _Bits, s: SequenceHeader, fh: FrameHeader,
                override: int) -> None:
    """frame_size, superres_params and render_size."""
    if override:
        fh.width = b.f(s.width_bits) + 1
        fh.height = b.f(s.height_bits) + 1
    else:
        fh.width, fh.height = s.width, s.height
    _superres_params(b, s, fh)
    fh.render_size = (fh.width, fh.height)
    if b.f(1):
        fh.render_size = (b.f(16) + 1, b.f(16) + 1)


def _superres_params(b: _Bits, s: SequenceHeader, fh: FrameHeader) -> None:
    fh.coded_width = fh.width
    if s.superres and b.f(1):  # use_superres
        fh.superres_denom = b.f(3) + 9
        fh.coded_width = (fh.width * 8 + fh.superres_denom // 2) \
            // fh.superres_denom


def _skip_mode_frames(s: SequenceHeader,
                      fh: FrameHeader) -> Optional[Tuple[int, int]]:
    """skip_mode_params: SkipModeFrame[0..1], the reference frames (LAST
    + index) of the nearest forward reference and the nearest backward
    one, or without a backward one the second nearest forward one, the
    smaller index first; None where skip mode is not allowed."""
    if not (fh.reference_select and s.order_hint_bits):
        return None
    rel = lambda a, b: _relative_dist(s, a, b)  # noqa: E731
    hints = fh.ref_order_hints
    fwd = bwd = None
    for i, h in enumerate(hints):
        if rel(h, fh.order_hint) < 0:
            if fwd is None or rel(h, hints[fwd]) > 0:
                fwd = i
        elif rel(h, fh.order_hint) > 0:
            if bwd is None or rel(h, hints[bwd]) < 0:
                bwd = i
    if fwd is None:
        return None
    if bwd is None:
        for i, h in enumerate(hints):
            if rel(h, hints[fwd]) < 0 and (
                    bwd is None or rel(h, hints[bwd]) > 0):
                bwd = i
        if bwd is None:
            return None
    return 1 + min(fwd, bwd), 1 + max(fwd, bwd)


def _decode_subexp(b: _Bits, num_syms: int) -> int:
    i = mk = 0
    k = 3
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return b.ns(num_syms - mk) + mk
        if not b.f(1):
            return b.f(b2) + mk
        i += 1
        mk += a


def _inverse_recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    return r - ((v + 1) >> 1) if v & 1 else r + (v >> 1)


def _global_motion_params(b: _Bits, fh: FrameHeader,
                          prev: Optional[Tuple]) -> None:
    """global_motion_params (spec 5.9.24) of LAST..ALTREF, each parameter
    coded against the primary reference's (PrevGmParams)."""
    prev = prev or (_GM_IDENTITY,) * 7
    types, params = [], []
    for ref in range(7):
        typ = 0
        if b.f(1):  # is_global
            typ = 2 if b.f(1) else (1 if b.f(1) else 3)
        p = list(_GM_IDENTITY)

        def read(idx):
            abs_bits, prec_bits = 12, 15  # GM_ABS_ALPHA_BITS, _PREC_BITS
            if idx < 2:
                if typ == 1:
                    abs_bits = 9 - (not fh.allow_hp)
                    prec_bits = 3 - (not fh.allow_hp)
                else:
                    abs_bits, prec_bits = 12, 6
            prec_diff = 16 - prec_bits
            rnd = (1 << 16) if idx % 3 == 2 else 0
            sub = (1 << prec_bits) if idx % 3 == 2 else 0
            mx = 1 << abs_bits
            r = (prev[ref][idx] >> prec_diff) - sub
            # decode_signed_subexp_with_ref(-mx, mx + 1, r)
            low, high = -mx, mx + 1
            n, rr = high - low, r - low
            v = _decode_subexp(b, n)
            x = _inverse_recenter(rr, v) if (rr << 1) <= n \
                else n - 1 - _inverse_recenter(n - 1 - rr, v)
            p[idx] = ((x + low) << prec_diff) + rnd

        if typ >= 2:
            read(2)
            read(3)
            if typ == 3:
                read(4)
                read(5)
            else:
                p[4], p[5] = -p[3], p[2]
        if typ >= 1:
            read(0)
            read(1)
        types.append(typ)
        params.append(tuple(p))
    fh.gm_type, fh.gm_params = tuple(types), tuple(params)


# spec Segmentation_Feature_Bits, _Signed and _Max of the SEG_LVL_*
# features: ALT_Q, ALT_LF_Y_V, ALT_LF_Y_H, ALT_LF_U, ALT_LF_V, REF_FRAME,
# SKIP, GLOBALMV
_SEG_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
_SEG_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
_SEG_MAX = (255, 63, 63, 63, 63, 7, 0, 0)


def _segmentation_params(b: _Bits, fh: FrameHeader, primary: bool,
                         prev: Optional[List[List[Optional[int]]]]) -> None:
    """segmentation_params after segmentation_enabled. Without a primary
    reference frame the map and the data are updated; with one
    (``primary``) the flags say which, and a frame that keeps the data
    takes its reference's (``prev``, None where it had no segmentation).
    Each value read is clipped to its limit. ALT_Q moves the segment's
    qindex, the four ALT_LF its deblocking levels, SKIP skips its blocks;
    REF_FRAME, SKIP and GLOBALMV put the segment id before ``skip``
    (SegIdPreSkip). The map flags are the frame's
    (``seg_update_map``, ``seg_temporal``): the map kept from the primary
    reference frame, or coded against it, where the sizes agree
    (``av1_decode.c``)."""
    update = (True, False, True)
    if primary:
        umap = bool(b.f(1))
        update = (umap, bool(umap and b.f(1)), bool(b.f(1)))
    fh.seg_update_map, fh.seg_temporal = update[:2]
    feats = [[None] * 8 for _ in range(8)]
    if update[2]:
        for i in range(8):
            for j in range(8):
                if b.f(1):
                    lim = _SEG_MAX[j]
                    if _SEG_SIGNED[j]:
                        feats[i][j] = min(max(b.su(1 + _SEG_BITS[j]), -lim),
                                          lim)
                    else:
                        feats[i][j] = min(b.f(_SEG_BITS[j]), lim)
    else:
        feats = [list(f) for f in (prev or feats)]
    on = [(i, j) for i in range(8) for j in range(8)
          if feats[i][j] is not None]
    fh.segmentation = feats
    fh.seg_last_active = max((i for i, _ in on), default=0)
    fh.seg_preskip = any(j >= 5 for _, j in on)


def _film_grain_params(b: _Bits, s: SequenceHeader, fh: FrameHeader,
                       refs: "RefHeaders") -> Optional[FilmGrain]:
    """film_grain_params after apply_grain (spec 5.9.30): a key frame
    always updates them, an inter frame may load a reference's
    (``update_grain`` 0) with its own seed."""
    seed = b.f(16)
    if fh.frame_type == INTER_FRAME and not b.f(1):  # update_grain
        idx = b.f(3)
        if idx not in fh.ref_frame_idx:
            raise _broken("film grain loaded from a slot that is no "
                          "reference")
        loaded = refs.grain[idx]
        if loaded is None:
            return None
        return replace(loaded, seed=seed)
    g = FilmGrain(seed=seed)

    def points(n_max):
        n = b.f(4)
        if n > n_max:
            raise _broken("film grain: too many scaling points")
        pts = [(b.f(8), b.f(8)) for _ in range(n)]
        if any(pts[i][0] <= pts[i - 1][0] for i in range(1, n)):
            raise _broken("film grain: scaling points out of order")
        return pts

    g.y_points = points(14)
    g.chroma_from_luma = False if s.mono else bool(b.f(1))
    if not (s.mono or g.chroma_from_luma
            or (s.ss == (1, 1) and not g.y_points)):
        g.cb_points = points(10)
        g.cr_points = points(10)
    g.scaling_shift = b.f(2) + 8
    g.ar_lag = b.f(2)
    n_luma = 2 * g.ar_lag * (g.ar_lag + 1)
    n_chroma = n_luma + 1 if g.y_points else n_luma
    if g.y_points:
        g.ar_y = [b.f(8) - 128 for _ in range(n_luma)]
    if g.chroma_from_luma or g.cb_points:
        g.ar_cb = [b.f(8) - 128 for _ in range(n_chroma)]
    if g.chroma_from_luma or g.cr_points:
        g.ar_cr = [b.f(8) - 128 for _ in range(n_chroma)]
    g.ar_shift = b.f(2) + 6
    g.scale_shift = b.f(2)
    if g.cb_points:
        g.cb_mult = (b.f(8), b.f(8), b.f(9))
    if g.cr_points:
        g.cr_mult = (b.f(8), b.f(8), b.f(9))
    g.overlap = bool(b.f(1))
    g.clip_restricted = bool(b.f(1))
    return g


def _tile_info(b: _Bits, s: SequenceHeader, fh: FrameHeader) -> None:
    sb_shift = 5 if s.sb128 else 4
    sb_size = sb_shift + 2
    sb_cols = (fh.mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (fh.mi_rows + (1 << sb_shift) - 1) >> sb_shift
    max_w_sb = 4096 >> sb_size
    max_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_w_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols, _tile_log2(max_area_sb,
                                                   sb_rows * sb_cols))
    if b.f(1):  # uniform_tile_spacing_flag
        cl = min_log2_cols
        while cl < max_log2_cols and b.f(1):
            cl += 1
        tw = (sb_cols + (1 << cl) - 1) >> cl
        fh.tile_col_starts = [i << sb_shift for i in range(0, sb_cols, tw)]
        rl = max(min_log2_tiles - cl, 0)
        while rl < max_log2_rows and b.f(1):
            rl += 1
        th = (sb_rows + (1 << rl) - 1) >> rl
        fh.tile_row_starts = [i << sb_shift for i in range(0, sb_rows, th)]
    else:  # each tile's width, then height, in superblocks
        widest = start = 0
        fh.tile_col_starts = []
        while start < sb_cols:
            fh.tile_col_starts.append(start << sb_shift)
            size = b.ns(min(sb_cols - start, max_w_sb)) + 1
            widest = max(widest, size)
            start += size
        area = (sb_rows * sb_cols) >> (min_log2_tiles + 1) \
            if min_log2_tiles else sb_rows * sb_cols
        max_h_sb = max(area // widest, 1)
        start = 0
        fh.tile_row_starts = []
        while start < sb_rows:
            fh.tile_row_starts.append(start << sb_shift)
            start += b.ns(min(sb_rows - start, max_h_sb)) + 1
        cl = _tile_log2(1, len(fh.tile_col_starts))
        rl = _tile_log2(1, len(fh.tile_row_starts))
        if len(fh.tile_col_starts) > 64 or len(fh.tile_row_starts) > 64:
            raise _broken("more than 64 tile columns or rows")
    fh.tile_cols_log2, fh.tile_rows_log2 = cl, rl
    fh.tile_col_starts.append(fh.mi_cols)
    fh.tile_row_starts.append(fh.mi_rows)
    if cl or rl:
        fh.context_update_tile_id = b.f(cl + rl)
        fh.tile_size_bytes = b.f(2) + 1


def _read_tiles(b: _Bits, fh: FrameHeader, end: int,
                tiles: List[Optional[bytes]]) -> None:
    """tile_group_obu: fill tiles[] from one tile group ending at byte
    ``end``."""
    n = len(tiles)
    start_end = b.f(1) if n > 1 else 0
    if start_end:
        bits = fh.tile_cols_log2 + fh.tile_rows_log2
        tg_start, tg_end = b.f(bits), b.f(bits)
    else:
        tg_start, tg_end = 0, n - 1
    b.byte_align()
    pos = b.pos >> 3
    data = b.data
    if tg_end >= n or tg_start > tg_end:
        raise _broken("tile group range")
    for t in range(tg_start, tg_end + 1):
        if t == tg_end:
            size = end - pos
        else:
            if pos + fh.tile_size_bytes > end:
                raise _broken("truncated tile size")
            size = int.from_bytes(data[pos:pos + fh.tile_size_bytes],
                                  "little") + 1
            pos += fh.tile_size_bytes
        if size <= 0 or pos + size > end:
            raise _broken("truncated tile")
        tiles[t] = data[pos:pos + size]
        pos += size


@dataclass
class Av1Frame:
    """One frame of an AV1 item: its sequence header, frame header, tiles
    and layer ids. The frame ``parse_av1`` returns, the one shown, also
    lists in ``frames`` every frame to decode for it, in order, itself
    last."""

    seq: SequenceHeader
    frame: FrameHeader
    tiles: List[bytes]
    spatial_id: int = 0
    temporal_id: int = 0
    frames: List["Av1Frame"] = field(default_factory=list)
    # the coded video sequence the frame belongs to: 0, and one more at
    # each sequence header that differs from the one before it
    sequence: int = 0


def parse_av1(payload: bytes, operating_point: int = 0,
              layer: Optional[int] = None) -> Av1Frame:
    """The frames of an AV1 item (low-overhead OBU format) and the one it
    shows, as dav1d picks it for libavif: the OBUs of ``operating_point``
    (the first where the sequence header has fewer), frames of every type,
    shown or hidden, and show_existing_frame headers (frames with no
    tiles, which show a slot, of the spatial layer of the frame in that
    slot). The frame shown is the first picture dav1d puts out as libavif
    runs it (one frame thread; all layers only under ``lsel``, ``layer``,
    where it is the first shown frame of that spatial layer): a shown
    frame goes out at once where the operating point in force spans one
    spatial layer, else it waits in dav1d's cache until a frame of that
    point's highest layer follows it or the data ends (so, with one
    sequence header, the first shown frame of the highest layer present);
    the OBUs after it are not read.

    Each sequence header chooses the operating point again. One that
    repeats the header in force, apart from its operating parameter info,
    changes nothing else. One that differs starts a new coded video
    sequence, as dav1d reads it: every reference slot is emptied and a
    frame whose tiles are still to come is dropped; every later frame is
    parsed under (and carries as ``seq``) the header in force, and its
    ``sequence`` counts the headers that differed before it."""
    from .av1_refs import RefHeaders

    pos = 0
    seq: Optional[SequenceHeader] = None
    sequence = 0
    op_idc = 0
    refs = RefHeaders()
    # the spatial layer of each slot's frame: a show_existing_frame shows
    # its slot's frame as of that layer (dav1d's picture keeps the header
    # it was decoded with), whichever layer its own OBU is of
    slot_layer = [0] * 8
    frames: List[Av1Frame] = []
    cur: Optional[Av1Frame] = None
    tiles: List[Optional[bytes]] = []
    # dav1d's output (dav1d_lib.c output_picture_ready, output_image):
    # the frames in its c->out and c->cache, and the highest spatial layer
    # of the operating point in force
    out: Optional[int] = None
    cache: Optional[int] = None
    top = 0

    def ready(drain: bool) -> bool:
        nonlocal out, cache
        if layer is None and top:
            if out is not None and cache is not None:
                if frames[cache].spatial_id == top:
                    return True
                cache, out = out, None
                return False
            if cache is not None and drain:
                return True
            if out is not None:
                cache, out = out, None
                return False
        return out is not None

    def shown(drain: bool) -> Optional[int]:
        """The frame libavif takes, once dav1d puts it out."""
        nonlocal out, cache
        while ready(drain):
            if layer is not None or not top:
                pic, out = out, None
            else:
                pic, cache, out = cache, out, None
            if layer is None or frames[pic].spatial_id == layer:
                return pic
        return None

    pick = None
    while pos < len(payload) and pick is None:
        h = payload[pos]
        if h & 0x80:
            raise _broken("OBU forbidden bit")
        typ, ext, has_size = (h >> 3) & 15, (h >> 2) & 1, (h >> 1) & 1
        p = pos + 1
        tid = sid = 0
        if ext:
            if p >= len(payload):
                raise _broken("truncated OBU header")
            tid, sid = payload[p] >> 5, (payload[p] >> 3) & 3
            p += 1
        if has_size:
            size, p = _leb128(payload, p)
        else:
            size = len(payload) - p
        end = p + size
        if end > len(payload):
            raise _broken("truncated OBU")
        pos = end
        if typ not in (1, 2, 8, 15) and ext and op_idc:
            if not ((op_idc >> tid) & 1 and (op_idc >> (sid + 8)) & 1):
                continue
        if typ == 1:
            new = parse_sequence_header(_Bits(payload, p, end))
            if seq is not None and new.key != seq.key:
                sequence += 1
                refs = RefHeaders()
                slot_layer = [0] * 8
                cur, tiles = None, []
            seq = new
            op = operating_point if operating_point < len(seq.op_idcs) else 0
            op_idc = seq.op_idcs[op]
            top = max((op_idc >> 8).bit_length() - 1, 0)
        elif typ in (3, 6):
            if seq is None:
                raise _broken("frame before the sequence header")
            if cur is not None:
                raise _broken("a frame header before the previous frame's "
                              "tiles")
            b = _Bits(payload, p, end)
            fh = parse_frame_header(b, seq, tid, sid, refs)
            refs.update(fh)
            if fh.show_existing is not None:  # a frame with no tiles
                if typ == 6:
                    raise _broken("show_existing_frame in a frame OBU")
                sid = slot_layer[fh.show_existing]
                slot_layer = [sid if fh.refresh_frame_flags >> i & 1
                              else v for i, v in enumerate(slot_layer)]
                frames.append(Av1Frame(seq, fh, [], sid, tid,
                                       sequence=sequence))
                out = len(frames) - 1
                pick = shown(False)
                continue
            slot_layer = [sid if fh.refresh_frame_flags >> i & 1 else v
                          for i, v in enumerate(slot_layer)]
            tiles = [None] * ((len(fh.tile_col_starts) - 1)
                              * (len(fh.tile_row_starts) - 1))
            cur = Av1Frame(seq, fh, [], sid, tid, sequence=sequence)
            if typ == 6:
                b.byte_align()
                _read_tiles(b, fh, end, tiles)
        elif typ == 4:
            if cur is None:
                raise _broken("tile group before the frame header")
            _read_tiles(_Bits(payload, p, end), cur.frame, end, tiles)
        if cur is not None and tiles and all(t is not None for t in tiles):
            cur.tiles = list(tiles)
            frames.append(cur)
            if cur.frame.show_frame:
                out = len(frames) - 1
            cur = None
        pick = shown(False)
    if pick is None:
        if seq is None:
            raise _broken("no sequence header")
        if cur is not None:
            raise _broken("missing tiles")
        if not frames:
            raise _broken("no frame")
        pick = shown(True)
    if pick is None:
        raise _broken("no shown frame" if layer is None
                      else f"no frame of spatial layer {layer}")
    frames[pick].frames = frames[:pick + 1]
    return frames[pick]


# ---------------------------------------------------------------------------
# Tile decode and post-filters
# ---------------------------------------------------------------------------

_CDF_ORDER = (
    "part8", "part16", "part32", "part64", "part128", "skip", "kf_y",
    "uv_mode", "uv_mode_cfl", "angle_delta", "cfl_sign", "cfl_alpha",
    "tx_size", "intra_ext_tx1", "intra_ext_tx2", "txb_skip", "eob16",
    "eob32", "eob64", "eob128", "eob256", "eob512", "eob1024", "eob_extra",
    "coeff_base_eob", "coeff_base", "coeff_br", "dc_sign", "pal_y_mode",
    "pal_uv_mode", "pal_y_size", "pal_y_ci2", "pal_y_ci3", "pal_y_ci4",
    "pal_y_ci5", "pal_y_ci6", "pal_y_ci7", "pal_y_ci8", "fi_use", "fi_mode",
    "wiener_restore", "sgrproj_restore", "switchable_restore", "delta_q",
    "delta_lf", "pal_uv_size", "pal_uv_ci2", "pal_uv_ci3", "pal_uv_ci4",
    "pal_uv_ci5", "pal_uv_ci6", "pal_uv_ci7", "pal_uv_ci8", "intrabc",
    "mv_joints", "mv_sign", "mv_classes", "mv_class0", "mv_bits",
    "txfm_split", "inter_tx1", "inter_tx2", "inter_tx3", "segment_id",
    "delta_lf_multi", "y_mode", "is_inter", "comp_mode", "single_ref",
    "new_mv", "zero_mv", "ref_mv", "drl", "interp_filter", "motion_mode",
    "obmc", "interintra", "mv0_joints", "mv0_sign", "mv0_classes",
    "mv0_class0", "mv0_bits", "mv0_class0_fr", "mv0_fr", "mv0_class0_hp",
    "mv0_hp", "comp_ref_type", "uni_comp_ref", "comp_ref", "comp_bwdref",
    "compound_mode", "compound_type", "wedge_index", "comp_group_idx",
    "compound_idx", "skip_mode", "interintra_mode", "wedge_interintra",
    "segment_id_predicted",
)
# the header pack's fields in the order of av1_header.h's H_* enum
_HDR_FIELDS = (
    "mi_rows", "mi_cols", "nplanes", "bitdepth", "sb128", "tile_cols",
    "tile_rows", "base_q", "lossless", "tx_mode", "reduced_tx_set",
    "screen_tools", "filter_intra", "cdef_on", "cdef_bits",
    "disable_cdf_update", "dq_y_dc", "dq_u_dc", "dq_u_ac", "dq_v_dc",
    "dq_v_ac", "lr_type0", "lr_type1", "lr_type2", "lr_unit0", "lr_unit1",
    "lr_unit2", "lr_urows0", "lr_urows1", "lr_urows2", "lr_ucols0",
    "lr_ucols1", "lr_ucols2", "lr_rstride", "lr_cstride", "ss_x", "ss_y",
    "edge_filter", "width", "height", "lf_y0", "lf_y1", "lf_u", "lf_v",
    "lf_sharpness", "cdef_damping", "qm_y", "qm_u", "qm_v", "delta_q_res",
    "delta_lf_res", "delta_lf_multi", "lf_delta_enabled",
    "lf_ref_delta_intra", "allow_intrabc",
    "seg_enabled", "seg_preskip", "seg_last_active", "seg_alt_q_mask",
) + tuple(f"seg_alt_q{i}" for i in range(8)) + (
    "seg_lossless_mask", "seg_alt_lf_mask") \
    + tuple(f"seg_alt_lf{i}" for i in range(8)) + (
    "seg_skip_mask", "superres_denom", "upscaled_width",
    "frame_type", "allow_hp", "force_integer_mv", "interp_filter",
    "motion_switchable", "use_ref_frame_mvs", "reference_select",
    "allow_warped", "dual_filter", "interintra", "sign_bias",
    "context_tile") + tuple(f"lf_ref_delta{i}" for i in range(1, 8)) + (
    "lf_mode_delta0", "lf_mode_delta1", "seg_ref_mask", "seg_ref_frames",
    "seg_globalmv_mask", "masked_compound", "jnt_comp",
    "skip_mode_present", "skip_mode_frame0", "skip_mode_frame1") \
    + tuple(f"gm_type{r}" for r in range(1, 8)) \
    + tuple(f"gm{r}_{i}" for r in range(1, 8) for i in range(6)) \
    + ("seg_update_map", "seg_temporal") \
    + tuple(f"cdef_{k}{i}" for i in range(8)
            for k in ("y_pri", "y_sec", "uv_pri", "uv_sec"))
# the decoder's tool counters in the order of av1_header.h's T_* enum
TOOL_NAMES = (
    "chroma_of_4xn", "cfl_subsampled", "edge_filter", "edge_upsample",
    "tx_v_dct", "tx_h_dct", "tx_4to1", "tx_64", "tx_depth1", "tx_depth2",
    "part_horz_a", "part_horz_b", "part_vert_a", "part_vert_b",
    "part_horz_4", "part_vert_4", "cdef_idx_read", "cdef_units_varied",
    "lr_chroma_subsampled", "qm", "delta_q", "delta_lf", "film_grain",
    "uv_palette", "twelve_bit", "intrabc", "intrabc_default_dv",
    "intrabc_chroma_subpel", "vartx_split", "tx_inter_set1",
    "tx_inter_set2", "tx_inter_set3", "tx_flip", "intrabc_sub8x8_chroma",
    "segmentation", "seg_alt_q", "seg_preskip", "seg_pred_skip", "superres",
    "seg_alt_lf", "seg_skip", "delta_lf_multi", "inter_frame", "newmv",
    "nearestmv", "nearmv", "globalmv", "drl", "subpel_mv", "filter_regular",
    "filter_smooth", "filter_sharp", "filter_bilinear", "dual_filter",
    "intra_in_inter", "sub8x8_chroma_mvs", "lf_ref_delta", "lf_mode_delta",
    "scaled_pred", "obmc", "local_warp", "local_warp_invalid",
    "mf_projected", "temporal_mv", "nearest_nearestmv", "near_nearmv",
    "nearest_newmv", "new_nearestmv", "near_newmv", "new_nearmv",
    "global_globalmv", "new_newmv", "compound_average", "compound_distance",
    "compound_wedge", "compound_diffwtd", "comp_ref_unidir",
    "comp_ref_bidir", "compound_scaled", "global_translation",
    "global_rotzoom", "global_affine", "global_warp", "global_warp_invalid",
    "skip_mode", "interintra", "interintra_wedge", "ii_dc", "ii_v", "ii_h",
    "ii_smooth", "seg_map_kept", "seg_temporal", "seg_id_predicted",
)
# the film grain pack (av1_header.h's G_* enum): field, length
_GRAIN_FIELDS = (
    ("seed", 1), ("num_y", 1), ("y_value", 14), ("y_scaling", 14),
    ("chroma_from_luma", 1), ("num_cb", 1), ("cb_value", 10),
    ("cb_scaling", 10), ("num_cr", 1), ("cr_value", 10), ("cr_scaling", 10),
    ("scaling_shift", 1), ("ar_lag", 1), ("ar_y", 24), ("ar_cb", 25),
    ("ar_cr", 25), ("ar_shift", 1), ("scale_shift", 1), ("cb_mult", 1),
    ("cb_luma_mult", 1), ("cb_offset", 1), ("cr_mult", 1),
    ("cr_luma_mult", 1), ("cr_offset", 1), ("overlap", 1),
    ("clip_restricted", 1), ("mc_identity", 1),
)
_CDF_CACHE: Dict[int, tuple] = {}
_CONST_CACHE: list = []
_TOOL_CACHE: dict = {}


def _cdf_pack(qctx: int):
    """The default CDFs at coefficient context ``qctx`` as contiguous
    uint16 arrays in ``_CDF_ORDER`` (each row with its counter)."""
    if qctx not in _CDF_CACHE:
        from ..av1.frame import CdfBank

        bank = CdfBank(qctx)
        src = {
            **{f"part{w}": bank.partition[w] for w in (8, 16, 32, 64, 128)},
            "skip": bank.skip, "kf_y": bank.kf_y, "uv_mode": bank.uv_mode,
            "uv_mode_cfl": bank.uv_mode_cfl,
            "angle_delta": bank.angle_delta, "cfl_sign": bank.cfl_sign,
            "cfl_alpha": bank.cfl_alpha, "tx_size": bank.tx_size,
            "intra_ext_tx1": bank.intra_ext_tx1,
            "intra_ext_tx2": bank.intra_ext_tx2, "txb_skip": bank.txb_skip,
            **{f"eob{n}": bank.eob_pt[n]
               for n in (16, 32, 64, 128, 256, 512, 1024)},
            "eob_extra": bank.eob_extra,
            "coeff_base_eob": bank.coeff_base_eob,
            "coeff_base": bank.coeff_base, "coeff_br": bank.coeff_br,
            "dc_sign": bank.dc_sign, "pal_y_mode": bank.palette_y_mode,
            "pal_uv_mode": bank.palette_uv_mode,
            "pal_y_size": bank.palette_y_size,
            **{f"pal_y_ci{n}": bank.palette_y_ci[n] for n in range(2, 9)},
            "fi_use": bank.filter_intra_use,
            "fi_mode": bank.filter_intra_mode,
            "wiener_restore": bank.wiener_restore,
            "sgrproj_restore": bank.sgrproj_restore,
            "switchable_restore": bank.switchable_restore,
            **_reader_cdfs(),
        }
        arrs = [np.ascontiguousarray(src[k], dtype=np.uint16).reshape(-1)
                for k in _CDF_ORDER]
        ptrs = (C.POINTER(C.c_uint16) * len(arrs))(
            *[a.ctypes.data_as(C.POINTER(C.c_uint16)) for a in arrs])
        lens = np.array([a.size for a in arrs], dtype=np.int64)
        rows = [np.shape(src[k])[-1] for k in _CDF_ORDER]
        _CDF_CACHE[qctx] = (arrs, ptrs, lens, rows)
    return _CDF_CACHE[qctx]


def _tool_tables():
    """The reader's own tables (``av1_tool_tables.npz``, written by
    ``scripts/extract_av1_tool_tables.py``)."""
    if not _TOOL_CACHE:
        import os

        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "av1_tool_tables.npz")
        with np.load(path) as t:
            _TOOL_CACHE.update({k: t[k] for k in t.files})
        _TOOL_CACHE["qm"] = np.ascontiguousarray(_TOOL_CACHE["qm"])
        for k in ("gaussian_sequence", "upscale_filter", "subpel_filters"):
            _TOOL_CACHE[k] = np.ascontiguousarray(_TOOL_CACHE[k],
                                                  dtype=np.int16)
        # av1_decode.c's TAB_* pack of the inter prediction tables
        _TOOL_CACHE["inter_tables"] = np.concatenate(
            [_TOOL_CACHE[k].reshape(-1).astype(np.int16) for k in (
                "subpel_filters", "warped_filter", "div_lut", "obmc_mask",
                "div_mult", "quant_dist_weight", "quant_dist_lookup",
                "ii_weights")]
            + [_wedge_masks(_TOOL_CACHE["wedge_codebook"],
                            _TOOL_CACHE["wedge_master"]).astype(np.int16)])
    return _TOOL_CACHE


# the block sizes with wedges (spec Wedge_Bits 4) in BLOCK_SIZES order, as
# (width, height)
_WEDGE_SIZES = ((8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
                (32, 32), (8, 32), (32, 8))


def _wedge_masks(codebook: np.ndarray, master: np.ndarray) -> np.ndarray:
    """Spec 7.11.3.11's WedgeMasks of each block size with wedges
    (``_WEDGE_SIZES``), each [wedge_sign][wedge_index][h][w], flattened:
    the MasterMask of each direction (HORIZONTAL, VERTICAL, OBLIQUE27, 63,
    117, 153) from the master rows (``wedge_master``: oblique even, odd,
    vertical), each wedge's window of it at the codebook's offsets, and
    its sign flipped where the window's first row and column average below
    32."""
    even, odd, vert = (m.astype(np.int64) for m in master)
    j = np.arange(64)
    m63 = np.empty((64, 64), np.int64)
    for i in range(0, 64, 2):
        shift = 16 - i // 2
        m63[i] = even[np.clip(j - shift, 0, 63)]
        m63[i + 1] = odd[np.clip(j - shift + 1, 0, 63)]
    mv = np.tile(vert, (64, 1))
    masters = [mv.T, mv, m63.T, m63, 64 - m63[:, ::-1], (64 - m63).T[::-1]]
    out = []
    for w, h in _WEDGE_SIZES:
        book = codebook[0 if h > w else (1 if h < w else 2)]
        masks = np.empty((2, 16, h, w), np.int64)
        for k, (dirn, xo, yo) in enumerate(book.astype(int)):
            x0, y0 = 32 - ((xo * w) >> 3), 32 - ((yo * h) >> 3)
            win = masters[dirn][y0:y0 + h, x0:x0 + w]
            avg = (int(win[0].sum() + win[1:, 0].sum()) + (w + h - 1) // 2) \
                // (w + h - 1)
            flip = int(avg < 32)
            masks[flip, k] = win
            masks[1 - flip, k] = 64 - win
        out.append(masks.reshape(-1))
    return np.concatenate(out)


def _reader_cdfs() -> dict:
    """The default CDFs only the reader needs: delta q, delta LF (and the
    four of delta_lf_multi, which start from it), the chroma palette's,
    intra block copy's (use_intrabc, the DV's MV CDFs, the var-tx split
    and the inter transform types), segment_id's and the inter frames'
    (mode info, reference frames, filters, motion modes, the MV CDFs of
    MvCtx 0, the compound blocks' references, modes and types, skip_mode,
    inter-intra's and seg_id_predicted's)."""
    from ..av1.frame import _adaptive
    from ..av1.tables import TABLES

    t = _tool_tables()
    return {"delta_q": _adaptive(t["delta_q"]),
            "delta_lf": _adaptive(t["delta_lf"]),
            "delta_lf_multi": _adaptive(np.tile(t["delta_lf"], (4, 1))),
            "pal_uv_size": _adaptive(TABLES["palette_uv_size"]),
            **{f"pal_uv_ci{n}": _adaptive(TABLES[f"palette_uv_color_index_{n}"])
               for n in range(2, 9)},
            **{k: _adaptive(t[k]) for k in (
                "intrabc", "mv_joints", "mv_sign", "mv_classes", "mv_class0",
                "mv_bits", "txfm_split", "inter_tx1", "inter_tx2",
                "inter_tx3", "segment_id", "y_mode", "is_inter",
                "comp_mode", "single_ref", "new_mv", "zero_mv", "ref_mv",
                "drl", "interp_filter", "motion_mode", "obmc",
                "interintra", "comp_ref_type", "uni_comp_ref", "comp_ref",
                "comp_bwdref", "compound_mode", "compound_type",
                "wedge_index", "comp_group_idx", "compound_idx",
                "skip_mode", "interintra_mode", "wedge_interintra",
                "segment_id_predicted")},
            # MvCtx 0 starts from the same defaults as intrabc's context
            **{f"mv0_{k[3:]}": _adaptive(t[k]) for k in (
                "mv_joints", "mv_sign", "mv_classes", "mv_class0", "mv_bits",
                "mv_class0_fr", "mv_fr", "mv_class0_hp", "mv_hp")}}


def _constants():
    """Scans, smooth weights, directional derivatives and filter-intra
    taps from the AV1 tables, as the C decoder takes them."""
    if not _CONST_CACHE:
        from ..av1.tables import TABLES

        p32 = C.POINTER(C.c_int32)
        names = ["scan_4x4", "scan_8x8", "scan_16x16", "scan_32x32",
                 "scan_4x8", "scan_8x4", "scan_8x16", "scan_16x8",
                 "scan_16x32", "scan_32x16"]
        scans = [np.ascontiguousarray(TABLES[n], dtype=np.int32)
                 for n in names]
        smw = [np.ascontiguousarray(TABLES[f"sm_weights_{n}"], dtype=np.int32)
               for n in (4, 8, 16, 32, 64)]
        dr = np.ascontiguousarray(TABLES["dr_intra_derivative"], np.int32)
        taps = np.ascontiguousarray(
            TABLES["filter_intra_taps"].reshape(-1), dtype=np.int32)
        _CONST_CACHE.extend([
            scans, (p32 * 10)(*[a.ctypes.data_as(p32) for a in scans]),
            smw, (p32 * 5)(*[a.ctypes.data_as(p32) for a in smw]), dr, taps])
    return _CONST_CACHE


def _host_lib():
    from ..av1.entropy.fast import get_lib

    lib = get_lib()
    if lib is None:
        raise OSError("AVIF decode needs the port's host library, which "
                      "failed to build (oavif_tpu_torch/av1/entropy/fast.py)")
    return lib


@dataclass
class DecodedImage:
    """One decoded AV1 image: Y'UV planes (one for monochrome) of the
    visible size (the chroma ones subsampled by ``ss``), their bit depth
    and colour description, and how often the decoder met each tool
    (``TOOL_NAMES``), over the frames it decoded and, for one AV1 item
    (not a grid's stitch), frame by frame (``frame_tools``)."""

    planes: List[np.ndarray]
    bit_depth: int
    cicp: Tuple[int, int, int]
    full_range: bool
    mono: bool
    ss: Tuple[int, int] = (0, 0)
    tools: Dict[str, int] = field(default_factory=dict)
    frame_tools: List[Dict[str, int]] = field(default_factory=list)


def _grain_pack(g: FilmGrain, mc_identity: bool) -> np.ndarray:
    """The film grain parameters as av1_grain.c reads them (G_*)."""
    vals = dict(
        seed=[g.seed], num_y=[len(g.y_points)],
        y_value=[v for v, _ in g.y_points], y_scaling=[c for _, c in g.y_points],
        chroma_from_luma=[int(g.chroma_from_luma)], num_cb=[len(g.cb_points)],
        cb_value=[v for v, _ in g.cb_points],
        cb_scaling=[c for _, c in g.cb_points], num_cr=[len(g.cr_points)],
        cr_value=[v for v, _ in g.cr_points],
        cr_scaling=[c for _, c in g.cr_points],
        scaling_shift=[g.scaling_shift], ar_lag=[g.ar_lag], ar_y=g.ar_y,
        ar_cb=g.ar_cb, ar_cr=g.ar_cr, ar_shift=[g.ar_shift],
        scale_shift=[g.scale_shift], cb_mult=[g.cb_mult[0]],
        cb_luma_mult=[g.cb_mult[1]], cb_offset=[g.cb_mult[2]],
        cr_mult=[g.cr_mult[0]], cr_luma_mult=[g.cr_mult[1]],
        cr_offset=[g.cr_mult[2]], overlap=[int(g.overlap)],
        clip_restricted=[int(g.clip_restricted)],
        mc_identity=[int(mc_identity)])
    out = []
    for name, n in _GRAIN_FIELDS:
        out += vals[name] + [0] * (n - len(vals[name]))
    return np.array(out, dtype=np.int32)


def decode_av1(payload: bytes, times: Optional[dict] = None,
               operating_point: int = 0,
               layer: Optional[int] = None) -> DecodedImage:
    """Decode one AV1 item payload to the visible Y'UV planes (int32) of
    the frame it shows (``parse_av1``), decoding in order every frame
    before it, each into the reference slots it refreshes (a
    show_existing_frame shows its slot's frame). ``times``,
    where given, gains the seconds of "parse" (headers and the tile
    decode), "filters" (deblocking, CDEF, loop restoration), "upscale"
    (superres), "grain" (film grain synthesis) and "refs" (keeping a
    frame in its reference slots), summed over the frames,
    and each frame's tile decode and post-filters apart ("tiles_f0",
    "filters_f0", ...), and of that tile decode, where a frame used them,
    OBMC's ("obmc_f1", ...), the local warp's ("warp_f1", ...), motion
    field estimation's ("project_f3", ...: a frame that projected the MVs
    of another), the compound blocks' blends and masks ("compound_f3",
    ...), the global warp's ("gwarp_f1", ...: blocks warped by global
    motion) and inter-intra's intra predictions and blends ("ii_f1",
    ...). The tool counts are those of every frame, and each
    frame's apart (``frame_tools``)."""
    from .av1_refs import RefFrames

    t0 = time.perf_counter()
    lib = _host_lib()
    out = parse_av1(payload, operating_point, layer)
    refs = RefFrames()
    counts = np.zeros(len(TOOL_NAMES), dtype=np.int32)
    if times is not None:
        times["parse"] = times.get("parse", 0.0) + time.perf_counter() - t0
    img, frame_tools = None, []
    for i, f in enumerate(out.frames):
        if i and f.sequence != out.frames[i - 1].sequence:
            refs = RefFrames()  # a new coded video sequence
        before = counts.copy()
        img = _decode_frame(lib, f, refs, counts, times, i,
                            f is out.frames[-1])
        frame_tools.append(dict(zip(TOOL_NAMES, (counts - before).tolist())))
    img.tools = dict(zip(TOOL_NAMES, counts.tolist()))
    img.frame_tools = frame_tools
    return img


def _saved_segment_ids(fh: FrameHeader, segs: np.ndarray,
                       prev: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """The SegmentIds a reference slot keeps of a frame (spec 7.4, 7.20):
    its blocks' ids; PrevSegmentIds where it kept the map
    (segmentation_update_map 0); None (zeros) without segmentation."""
    if fh.segmentation is None:
        return None
    return segs if fh.seg_update_map else prev


def _check_inter(f: "Av1Frame", refs) -> None:
    """The reference slots of an inter or switch frame: filled, and of the
    frame's depth and format."""
    fh = f.frame
    for i in fh.ref_frame_idx:
        ref = refs.slots[i]
        if ref is None:
            raise _broken("an inter frame names an empty reference slot")
        ss = (0, 0) if f.seq.mono else f.seq.ss
        if (ref.bit_depth, ref.ss) != (f.seq.bit_depth, ss):
            raise _broken("a reference frame of another depth or format")


def _decode_frame(lib, f: "Av1Frame", refs, counts: np.ndarray,
                  times: Optional[dict], index: int,
                  last: bool) -> DecodedImage:
    """One frame of ``decode_av1``: tiles, post-filters, the reference
    slots it refreshes, and (for the frame shown) film grain."""
    from ..av1.consts import coeff_q_ctx
    from ..av1.restoration import count_units, unit_size
    from ..av1.tables import TABLES
    from .av1_refs import RefFrame, clear_counters, motion_field

    t0 = time.perf_counter()
    s, fh = f.seq, f.frame
    if fh.show_existing is not None:
        return _show_existing(lib, f, refs, counts, times, last)
    if fh.frame_type & 1:  # not FrameIsIntra
        _check_inter(f, refs)
    nplanes = 1 if s.mono else 3
    ssx, ssy = (0, 0) if s.mono else s.ss
    bd = s.bit_depth
    sb = 128 if s.sb128 else 64
    sb4 = sb // 4
    rows = ((fh.mi_rows + sb4 - 1) // sb4) * sb
    # the coded superblocks, and under superres the upscaled frame
    stride = -(-max(fh.mi_cols * 4, fh.width) // sb) * sb
    planes = [np.zeros((rows, stride), dtype=np.int32) for _ in range(nplanes)]
    qlut = np.ascontiguousarray(np.concatenate(
        [TABLES[f"dc_q{bd}"], TABLES[f"ac_q{bd}"]]), dtype=np.int32)
    qm = _tool_tables()["qm"] if min(fh.qm) < 15 else None
    h, w = fh.height, fh.width
    luma_unit = unit_size(fh.lr_unit_shift) if any(fh.lr_types) else 64
    units, urows, ucols = [], [], []
    for p in range(3):
        sx, sy = (ssx, ssy) if p else (0, 0)
        u = luma_unit >> (fh.lr_uv_shift if p else 0)
        units.append(u)
        urows.append(count_units((h + sy) >> sy, u))
        ucols.append(count_units((w + sx) >> sx, u))
    strengths = [0] * 32
    for i, st in enumerate(fh.cdef_strengths):
        strengths[4 * i:4 * i + 4] = st
    seg = fh.segmentation or [[None] * 8] * 8
    fields = dict(
        mi_rows=fh.mi_rows, mi_cols=fh.mi_cols, nplanes=nplanes, bitdepth=bd,
        sb128=int(s.sb128), tile_cols=len(fh.tile_col_starts) - 1,
        tile_rows=len(fh.tile_row_starts) - 1, base_q=fh.base_q,
        lossless=int(fh.lossless), tx_mode=fh.tx_mode,
        reduced_tx_set=int(fh.reduced_tx_set),
        screen_tools=int(fh.screen_tools), filter_intra=int(s.filter_intra),
        cdef_on=int(s.cdef and not (fh.lossless or fh.allow_intrabc)),
        cdef_bits=fh.cdef_bits,
        disable_cdf_update=int(fh.disable_cdf_update),
        **dict(zip(("dq_y_dc", "dq_u_dc", "dq_u_ac", "dq_v_dc", "dq_v_ac"),
                   fh.dq)),
        **{f"lr_type{p}": fh.lr_types[p] for p in range(3)},
        **{f"lr_unit{p}": units[p] for p in range(3)},
        **{f"lr_urows{p}": urows[p] for p in range(3)},
        **{f"lr_ucols{p}": ucols[p] for p in range(3)},
        lr_rstride=max(urows), lr_cstride=max(ucols), ss_x=ssx, ss_y=ssy,
        edge_filter=int(s.intra_edge), width=fh.coded_width, height=h,
        **dict(zip(("lf_y0", "lf_y1", "lf_u", "lf_v"), fh.lf_levels)),
        lf_sharpness=fh.lf_sharpness, cdef_damping=fh.cdef_damping,
        **dict(zip(("qm_y", "qm_u", "qm_v"), fh.qm)),
        delta_q_res=fh.delta_q_res, delta_lf_res=fh.delta_lf_res,
        delta_lf_multi=int(fh.delta_lf_multi),
        lf_delta_enabled=int(fh.lf_delta_enabled),
        lf_ref_delta_intra=fh.lf_ref_deltas[0],
        allow_intrabc=int(fh.allow_intrabc),
        seg_enabled=int(fh.segmentation is not None),
        seg_preskip=int(fh.seg_preskip), seg_last_active=fh.seg_last_active,
        seg_alt_q_mask=sum(1 << i for i, f_ in enumerate(seg)
                           if f_[0] is not None),
        **{f"seg_alt_q{i}": (f_[0] or 0) for i, f_ in enumerate(seg)},
        seg_lossless_mask=sum(int(v) << i
                              for i, v in enumerate(fh.seg_lossless)),
        # 32 bits: segment 7's ALT_LF_V is the sign bit of the int32 word
        seg_alt_lf_mask=int(np.uint32(sum(
            1 << (4 * i + k) for i, f_ in enumerate(seg)
            for k in range(4) if f_[1 + k] is not None)).view(np.int32)),
        **{f"seg_alt_lf{i}": int.from_bytes(
            bytes((v or 0) & 0xFF for v in f_[1:5]), "little", signed=True)
           for i, f_ in enumerate(seg)},
        seg_skip_mask=sum(1 << i for i, f_ in enumerate(seg)
                          if f_[6] is not None),
        superres_denom=fh.superres_denom, upscaled_width=w,
        frame_type=fh.frame_type, allow_hp=int(fh.allow_hp),
        force_integer_mv=int(fh.force_integer_mv),
        interp_filter=fh.interp_filter,
        motion_switchable=int(fh.motion_switchable),
        use_ref_frame_mvs=int(fh.use_ref_frame_mvs),
        reference_select=int(fh.reference_select),
        allow_warped=int(fh.allow_warped_motion),
        dual_filter=int(s.dual_filter), interintra=int(s.interintra),
        sign_bias=sum(b << r for r, b in enumerate(fh.sign_bias)),
        context_tile=fh.context_update_tile_id,
        **{f"lf_ref_delta{i}": fh.lf_ref_deltas[i] for i in range(1, 8)},
        lf_mode_delta0=fh.lf_mode_deltas[0],
        lf_mode_delta1=fh.lf_mode_deltas[1],
        seg_ref_mask=sum(1 << i for i, f_ in enumerate(seg)
                         if f_[5] is not None),
        seg_ref_frames=sum((f_[5] or 0) << (3 * i)
                           for i, f_ in enumerate(seg)),
        seg_globalmv_mask=sum(1 << i for i, f_ in enumerate(seg)
                              if f_[7] is not None),
        masked_compound=int(s.masked_compound), jnt_comp=int(s.jnt_comp),
        skip_mode_present=int(fh.skip_mode_present),
        **dict(zip(("skip_mode_frame0", "skip_mode_frame1"),
                   fh.skip_mode_frames or (0, 0))),
        **{f"gm_type{r}": t for r, t in enumerate(fh.gm_type, 1)},
        **{f"gm{r}_{i}": v for r, p in enumerate(fh.gm_params, 1)
           for i, v in enumerate(p)},
        seg_update_map=int(fh.seg_update_map),
        seg_temporal=int(fh.seg_temporal),
        **{name: v for name, v in zip(_HDR_FIELDS[-32:], strengths)})
    hdr = np.array([fields[k] for k in _HDR_FIELDS], dtype=np.int32)
    starts = np.array(fh.tile_col_starts + fh.tile_row_starts, dtype=np.int32)
    defaults, _, cdf_lens, cdf_rows = _cdf_pack(coeff_q_ctx(fh.base_q))
    if fh.primary_ref_frame == 7:
        start_cdfs = defaults
    else:  # load_cdfs of the primary reference frame
        start_cdfs = refs.slots[fh.ref_frame_idx[fh.primary_ref_frame]].cdfs
    pu16 = C.POINTER(C.c_uint16)
    cdf_ptrs = (pu16 * len(start_cdfs))(
        *[a.ctypes.data_as(pu16) for a in start_cdfs])
    cdf_out = np.zeros(int(cdf_lens.sum()), dtype=np.uint16)
    scans, scan_ptrs, smw, smw_ptrs, dr, taps = _constants()
    ntiles = len(f.tiles)
    tile_bufs = [C.create_string_buffer(t, len(t)) for t in f.tiles]
    tile_ptrs = (C.POINTER(C.c_uint8) * ntiles)(
        *[C.cast(t, C.POINTER(C.c_uint8)) for t in tile_bufs])
    tile_sizes = np.array([len(t) for t in f.tiles], dtype=np.int64)
    p32, p8 = C.POINTER(C.c_int32), C.POINTER(C.c_uint8)
    plane_ptrs = (p32 * 3)(*[p.ctypes.data_as(p32) for p in planes])
    txmaps = [np.zeros((fh.mi_rows, fh.mi_cols), dtype=np.uint8)
              for _ in range(nplanes)]
    tx_ptrs = (p8 * 3)(*[t.ctypes.data_as(p8) for t in txmaps])
    skips = np.zeros((fh.mi_rows, fh.mi_cols), dtype=np.uint8)
    cdef_idx = np.zeros(((fh.mi_rows + 15) // 16, (fh.mi_cols + 15) // 16),
                        dtype=np.int8)
    lr_units = np.zeros((3, max(urows), max(ucols), 7), dtype=np.int32)
    delta_lf = np.zeros((fh.mi_rows, fh.mi_cols, 4), dtype=np.int8)
    segs = np.zeros((fh.mi_rows, fh.mi_cols), dtype=np.uint8)
    # PrevSegmentIds (spec 7.21): the primary reference frame's map where
    # it is of the frame's MiRows and MiCols, else zeros (None)
    prev_segs = None
    if fh.segmentation is not None and fh.primary_ref_frame != 7:
        p_ = refs.slots[fh.ref_frame_idx[fh.primary_ref_frame]]
        if (p_.mi_rows, p_.mi_cols) == (fh.mi_rows, fh.mi_cols):
            prev_segs = p_.seg_ids
    mi_lf = np.zeros((fh.mi_rows, fh.mi_cols), dtype=np.uint8)
    mi_bsz = np.zeros((fh.mi_rows, fh.mi_cols), dtype=np.uint8)
    # the planes of LAST..ALTREF and their stride, width and height
    ref_ptrs = (p32 * 21)()
    ref_info = np.zeros(21, dtype=np.int32)
    for r, i in enumerate(fh.ref_frame_idx):
        ref = refs.slots[i]
        for p in range(nplanes):
            ref_ptrs[3 * r + p] = ref.planes[p].ctypes.data_as(p32)
        ref_info[3 * r:3 * r + 3] = (ref.planes[0].shape[1], ref.width,
                                     ref.height)
    # motion field estimation: what the frame projects, and the MVs it
    # stores for later frames
    mf, sources = motion_field(fh, s, refs.slots)
    mf_src_refs = (C.c_void_p * 3)(*[f_.mf_refs.ctypes.data
                                     for f_ in sources])
    mf_src_mvs = (C.c_void_p * 3)(*[f_.mf_mvs.ctypes.data for f_ in sources])
    mf_refs = np.zeros((fh.mi_rows // 2, fh.mi_cols // 2), dtype=np.int8)
    mf_mvs = np.zeros((fh.mi_rows // 2, fh.mi_cols // 2, 2), dtype=np.int16)
    msg = C.create_string_buffer(256)
    vp = C.c_void_p
    # the ns of OBMC, of the local warp, of motion field estimation, of
    # compound blends and masks, of the global warp and of inter-intra's
    # intra predictions and blends, taken where times are
    motion = np.zeros(6, dtype=np.int64) if times is not None else None
    rc = lib.av1_decode_frame(
        C.cast(tile_ptrs, vp), tile_sizes.ctypes.data, hdr.ctypes.data,
        starts.ctypes.data, C.cast(cdf_ptrs, vp), cdf_lens.ctypes.data,
        C.cast(scan_ptrs, vp), C.cast(smw_ptrs, vp), dr.ctypes.data,
        taps.ctypes.data, qlut.ctypes.data,
        None if qm is None else qm.ctypes.data, C.cast(plane_ptrs, vp),
        stride, C.cast(tx_ptrs, vp), skips.ctypes.data, cdef_idx.ctypes.data,
        delta_lf.ctypes.data, segs.ctypes.data,
        None if prev_segs is None else prev_segs.ctypes.data,
        lr_units.ctypes.data,
        counts.ctypes.data, C.cast(ref_ptrs, vp), ref_info.ctypes.data,
        _tool_tables()["inter_tables"].ctypes.data, cdf_out.ctypes.data,
        mi_lf.ctypes.data, mi_bsz.ctypes.data,
        None if motion is None else motion.ctypes.data, mf.ctypes.data,
        C.cast(mf_src_refs, vp), C.cast(mf_src_mvs, vp), mf_refs.ctypes.data,
        mf_mvs.ctypes.data, msg, 256)
    if rc:
        raise _broken(msg.value.decode() or "tile data")
    t1 = time.perf_counter()
    upscale = C.c_double(0.0)
    if lib.av1_postfilter(C.cast(plane_ptrs, vp), stride, hdr.ctypes.data,
                          C.cast(tx_ptrs, vp), skips.ctypes.data,
                          cdef_idx.ctypes.data, delta_lf.ctypes.data,
                          segs.ctypes.data, mi_lf.ctypes.data,
                          mi_bsz.ctypes.data, lr_units.ctypes.data,
                          _tool_tables()["upscale_filter"].ctypes.data,
                          counts.ctypes.data, C.byref(upscale)):
        raise MemoryError("AVIF post-filters: out of memory")
    t2 = time.perf_counter()
    if fh.refresh_frame_flags:
        # the frame as later frames read it: before film grain, with the
        # CDFs of its context tile (or those it started from), their
        # counters cleared
        if fh.disable_frame_end_update_cdf:
            saved = [a.copy() for a in start_cdfs]
        else:
            saved = np.split(cdf_out, np.cumsum(cdf_lens)[:-1])
            clear_counters(saved, cdf_rows)
        kept = [p.copy() for p in planes] if fh.grain is not None and last \
            else planes
        refs.update(fh.refresh_frame_flags,
                    RefFrame(kept, bd, (ssx, ssy), w, h, saved,
                             fh.frame_type, fh.order_hint,
                             fh.ref_order_hints or (0,) * 7, fh.mi_rows,
                             fh.mi_cols, mf_refs, mf_mvs,
                             _saved_segment_ids(fh, segs, prev_segs), hdr))
    ts = time.perf_counter()
    if fh.grain is not None and last:
        _film_grain(lib, planes, hdr, fh.grain, s, counts)
    t3 = time.perf_counter()
    out = _visible(planes, h, w, (ssx, ssy))
    if times is not None:
        # the crop to the visible size counts with the filters
        filt = t2 - t1 - upscale.value + time.perf_counter() - t3
        for k, v in (("parse", t1 - t0), ("grain", t3 - ts), ("refs", ts - t2),
                     ("upscale", upscale.value), ("filters", filt),
                     (f"tiles_f{index}", t1 - t0),
                     (f"filters_f{index}", t2 - t1),
                     *((f"{tool}_f{index}", motion[k] * 1e-9)
                       for k, tool in ((0, "obmc"), (1, "warp"),
                                       (3, "compound"), (4, "gwarp"),
                                       (5, "ii"))
                       if motion[k]),
                     *(((f"project_f{index}", motion[2] * 1e-9),)
                       if sources else ())):
            times[k] = times.get(k, 0.0) + v
    return DecodedImage(out, bd, s.cicp, s.full_range, s.mono, (ssx, ssy))


def _show_existing(lib, f: "Av1Frame", refs, counts: np.ndarray,
                   times: Optional[dict], last: bool) -> DecodedImage:
    """A show_existing_frame of ``decode_av1``: a key frame's slot first
    fills every slot (spec 7.21, 7.20); the frame shown is the slot's,
    copied where it takes the film grain its header loaded."""
    t0 = time.perf_counter()
    s, fh = f.seq, f.frame
    ref = refs.slots[fh.show_existing]
    if ref is None:
        raise _broken("show_existing_frame of an empty slot")
    refs.update(fh.refresh_frame_flags, ref)
    planes = ref.planes
    if fh.grain is not None and last:
        planes = [p.copy() for p in planes]
        _film_grain(lib, planes, ref.hdr, fh.grain, s, counts)
        if times is not None:
            times["grain"] = times.get("grain", 0.0) \
                + time.perf_counter() - t0
    return DecodedImage(_visible(planes, ref.height, ref.width, ref.ss),
                        ref.bit_depth, s.cicp, s.full_range, s.mono, ref.ss)


def _film_grain(lib, planes: List[np.ndarray], hdr: np.ndarray,
                grain: FilmGrain, s: SequenceHeader,
                counts: np.ndarray) -> None:
    """Film grain synthesis in place on a frame's planes (``av1_grain.c``;
    ``hdr`` the frame's header pack)."""
    pack = _grain_pack(grain, s.cicp[2] == 0)
    p32 = C.POINTER(C.c_int32)
    ptrs = (p32 * 3)(*[p.ctypes.data_as(p32) for p in planes])
    if lib.av1_film_grain(C.cast(ptrs, C.c_void_p), planes[0].shape[1],
                          hdr.ctypes.data, pack.ctypes.data,
                          _tool_tables()["gaussian_sequence"].ctypes.data,
                          counts.ctypes.data):
        raise MemoryError("AVIF film grain: out of memory")


def _visible(planes: List[np.ndarray], h: int, w: int,
             ss: Tuple[int, int]) -> List[np.ndarray]:
    """The planes cropped to the visible ``h`` x ``w`` frame."""
    ssx, ssy = ss
    return [np.ascontiguousarray(p[:(h + sy) >> sy, :(w + sx) >> sx])
            for p, (sy, sx) in zip(planes, [(0, 0)] + [(ssy, ssx)] * 2)]


# ---------------------------------------------------------------------------
# Y'UV to RGB as libavif 1.3 converts
# ---------------------------------------------------------------------------

# libyuv's YuvConstants (row_common.cc), (UB, UG, VG, VR, YG, YB): full
# range kYuvJPEGConstants, kYuvF709Constants, kYuvV2020Constants; limited
# range kYuvI601Constants, kYuvH709Constants, kYuv2020Constants (UB capped
# at 128 as libyuv builds it by default)
_LIBYUV = {(601, True): (113, 22, 46, 90, 16320, 32),
           (709, True): (119, 12, 30, 101, 16320, 32),
           (2020, True): (120, 11, 37, 94, 16320, 32),
           (601, False): (128, 25, 52, 102, 18997, -1160),
           (709, False): (128, 14, 34, 115, 18997, -1160),
           (2020, False): (128, 12, 42, 107, 19003, -1160)}
# (kr, kb) of libavif's matrix table for the matrices it converts itself
_KRKB = {4: (0.30, 0.11), 7: (0.212, 0.087)}
# ITU-T H.273 colour primaries (rx, ry, gx, gy, bx, by, wx, wy); libavif
# takes BT.709's for any other value
_PRIMARIES = {
    1: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290),
}


def _krkb_from_primaries(cp: int):
    """libavif's avifColorPrimariesComputeYCoeffs, in float32."""
    f = np.float32
    rx, ry, gx, gy, bx, by, wx, wy = (f(v) for v in
                                      _PRIMARIES.get(cp, _PRIMARIES[1]))
    one = f(1.0)
    rz, gz, bz, wz = one - (rx + ry), one - (gx + gy), one - (bx + by), \
        one - (wx + wy)
    den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz)
                + bx * (ry * gz - gy * rz))
    kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz)
                + wz * (gx * by - bx * gy))) / den
    kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz)
                + wz * (rx * gy - gx * ry))) / den
    return kr, kb


def _conversion(cicp: Tuple[int, int, int], full: bool = True):
    """("libyuv", constants) | ("float", (kr, kb)) | ("identity", None) |
    ("ycgco", None) for a CICP and range, as libavif 1.3 picks; raises for
    the matrices libavif refuses."""
    cp, _, mc = cicp
    std = {2: 601, 5: 601, 6: 601, 1: 709, 9: 2020}.get(mc)
    if mc == 12:
        std = {1: 709, 2: 709, 5: 601, 6: 601, 9: 2020}.get(cp)
    if std is not None:
        return "libyuv", _LIBYUV[std, full]
    if mc == 0:
        return "identity", None
    if mc == 8:
        if not full:
            raise UnsupportedAvif("AVIF: matrix coefficients 8 (YCgCo) "
                                  "with limited range, which libavif does "
                                  "not convert to RGB")
        return "ycgco", None
    if mc in _KRKB:
        return "float", tuple(np.float32(v) for v in _KRKB[mc])
    if mc == 12:
        return "float", _krkb_from_primaries(cp)
    raise UnsupportedAvif(f"AVIF: matrix coefficients {mc}, which libavif "
                          "does not convert to RGB")


def _up2_linear(c: np.ndarray, w: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear (its _Any_ wrapper) on each row: the
    first and last samples copied, the others (3, 1) / 4 rounded."""
    out = np.empty(c.shape[:-1] + (w,), dtype=np.int32)
    k = ((w - 1) & ~1) // 2
    a, b = c[..., :k], c[..., 1:k + 1]
    out[..., 1:1 + 2 * k:2] = (3 * a + b + 2) >> 2
    out[..., 2:2 + 2 * k:2] = (a + 3 * b + 2) >> 2
    out[..., 0] = c[..., 0]
    out[..., w - 1] = c[..., (w - 1) // 2]
    return out


def _up2_bilinear(sa: np.ndarray, sb: np.ndarray, w: int):
    """libyuv's ScaleRowUp2_Bilinear (its _Any_ wrapper): two output rows
    from chroma rows sa and sb below it, (9, 3, 3, 1) / 16 rounded inside,
    (3, 1) / 4 down the first and last columns."""
    da = np.empty(sa.shape[:-1] + (w,), dtype=np.int32)
    db = np.empty_like(da)
    k = ((w - 1) & ~1) // 2
    a0, a1, b0, b1 = sa[..., :k], sa[..., 1:k + 1], sb[..., :k], sb[..., 1:k + 1]
    da[..., 1:1 + 2 * k:2] = (9 * a0 + 3 * a1 + 3 * b0 + b1 + 8) >> 4
    da[..., 2:2 + 2 * k:2] = (3 * a0 + 9 * a1 + b0 + 3 * b1 + 8) >> 4
    db[..., 1:1 + 2 * k:2] = (3 * a0 + a1 + 9 * b0 + 3 * b1 + 8) >> 4
    db[..., 2:2 + 2 * k:2] = (a0 + 3 * a1 + 3 * b0 + 9 * b1 + 8) >> 4
    for j in (0, w - 1):
        m = (w - 1) // 2 if j else 0
        da[..., j] = (3 * sa[..., m] + sb[..., m] + 2) >> 2
        db[..., j] = (sa[..., m] + 3 * sb[..., m] + 2) >> 2
    return da, db


def _libyuv_upsample(c: np.ndarray, h: int, w: int,
                     ss: Tuple[int, int]) -> np.ndarray:
    """A chroma plane at full size as libyuv's I420/I422 ...MatrixFilter
    (kFilterBilinear) upsamples it: 4:2:2 linear along each row; 4:2:0
    linear on the first row (and the last of an even height), the rows
    between bilinear from each pair of chroma rows."""
    c = c.astype(np.int32)
    if ss == (1, 0):
        return _up2_linear(c, w)
    out = np.empty((h, w), dtype=np.int32)
    out[0] = _up2_linear(c[0], w)
    n = (h - 1) // 2  # pairs of chroma rows
    if n:
        da, db = _up2_bilinear(c[:n], c[1:n + 1], w)
        out[1:2 * n + 1:2] = da
        out[2:2 * n + 2:2] = db
    if h % 2 == 0 and h > 1:
        out[h - 1] = _up2_linear(c[h // 2 - 1], w)
    return out


def _float_chroma(t: np.ndarray, c: np.ndarray, h: int, w: int,
                  ss: Tuple[int, int]) -> np.ndarray:
    """libavif's own bilinear chroma upsampling (avifImageYUVAnyToRGB
    AnySlow): the unorm values of the nearest chroma sample and of its
    neighbours away from the luma sample, weighted (9, 3, 3, 1) / 16 in
    float32; for 4:2:2 the row neighbour is the sample itself (so the
    weights add up to (3, 1) / 4, rounded as the four products are)."""
    f = np.float32
    i = np.arange(w)
    adj_c = np.where((i == 0) | ((i == w - 1) & (i % 2 == 1)), 0,
                     np.where(i % 2 == 1, 1, -1))
    j = np.arange(h)
    if ss == (1, 0):
        cj, adj_r = j, np.zeros_like(j)
    else:
        cj = j >> 1
        adj_r = np.where((j == 0) | ((j == h - 1) & (j % 2 == 1)), 0,
                         np.where(j % 2 == 1, 1, -1))
    u = t[c]
    r0, r1 = cj[:, None], (cj + adj_r)[:, None]
    c0, c1 = (i >> 1)[None, :], ((i >> 1) + adj_c)[None, :]
    return ((u[r0, c0] * f(9.0 / 16.0)) + (u[r0, c1] * f(3.0 / 16.0))
            + (u[r1, c0] * f(3.0 / 16.0)) + (u[r1, c1] * f(1.0 / 16.0)))


def yuv_to_rgb8(img: DecodedImage, rgba: bool = False,
                prem: Optional[DecodedImage] = None) -> np.ndarray:
    """(h, w, 3) uint8 RGB of a decoded image, as libavif 1.3 (with
    libyuv) converts it for an 8-bit RGB target, or for an RGBA target
    where ``rgba`` (as Pillow asks for images with alpha): there libyuv
    converts 10-bit Y'UV directly (I410ToARGB, luma kept at 16 bits) and
    12-bit 4:2:0 through I012ToARGB (chroma not filtered), where for RGB
    (and 12-bit 4:2:2 and 4:4:4) it first narrows every plane to 8 bits.
    Subsampled chroma is otherwise upsampled as libavif's default
    (automatic) upsampling does: libyuv's bilinear filter where libyuv
    converts, libavif's own bilinear weights on the float path. Limited
    range takes libyuv's limited-range constants, or the float path's
    range scaling.

    ``prem``, where given, is the alpha image the colour is premultiplied
    by (``prem``; ``rgba`` is then implied): the colour is un-premultiplied
    as libavif 1.3 does for an 8-bit RGBA target, by libyuv's
    ARGBUnattenuate after a libyuv or fast-path conversion
    (``_unattenuate``), inside the conversion in float32 on libavif's
    slow path (``_slow_path``)."""
    rgba = rgba or prem is not None
    bd = img.bit_depth
    y = img.planes[0]
    h, w = y.shape
    sub = not img.mono and img.ss != (0, 0)
    if img.mono:
        mid = np.full_like(y, 1 << (bd - 1))
        u = v = mid
    else:
        u, v = img.planes[1], img.planes[2]
    kind, k = _conversion(img.cicp, img.full_range)
    if kind == "libyuv" and img.mono and bd > 8 and not rgba:
        # deep monochrome to RGB: libavif converts in float32, its chroma
        # 0 leaving R = G = B = Y (the matrix unused); to RGBA it narrows
        # the planes to 8 bits for libyuv, as below
        kind, k = "float", (np.float32(0.299), np.float32(0.114))
    if kind == "libyuv":
        if bd == 10 and rgba and not img.mono:
            # libyuv YuvPixel10 (I010/I210/I410ToARGB)
            y32 = (y << 6) | (y >> 4)
            if sub:
                u, v = (_libyuv_upsample(c, h, w, img.ss) for c in (u, v))
            u, v = u >> 2, v >> 2
        elif bd == 12 and rgba and img.ss == (1, 1) and not img.mono:
            # libyuv I012ToARGBMatrix (YuvPixel12), which has no
            # filtering variant: each chroma sample covers its 2x2
            y32 = (y << 4) | (y >> 8)
            u, v = (np.repeat(np.repeat(c >> 4, 2, 0), 2, 1)[:h, :w]
                    for c in (u, v))
        else:
            if bd > 8:  # libyuv Convert16To8Plane, then the 8-bit matrix
                y, u, v = y >> (bd - 8), u >> (bd - 8), v >> (bd - 8)
            if sub:
                u, v = (_libyuv_upsample(c, h, w, img.ss) for c in (u, v))
            y32 = y * 0x0101
        ub, ug, vg, vr, yg, yb = k
        y1 = ((y32.astype(np.int64) * yg) >> 16) + yb
        uc = u.astype(np.int32) - 128
        vc = v.astype(np.int32) - 128
        out = np.empty(y.shape + (3,), dtype=np.uint8)
        for i, c in enumerate((y1 + vc * vr, y1 - uc * ug - vc * vg,
                               y1 + uc * ub)):
            c >>= 6
            np.clip(c, 0, 255, out=c)
            out[..., i] = c
        return out if prem is None else \
            _unattenuate(out, alpha_to_8(prem, _alpha_shifted(img)))
    f = np.float32
    mx = (1 << bd) - 1
    # libavif's unorm tables: (sample - bias) / range, the limited range's
    # bias 16 and ranges 219 (luma) and 224 (chroma) at 8 bits
    bias_y, range_y, range_uv = ((0, mx, mx) if img.full_range else
                                 (16 << (bd - 8), 219 << (bd - 8),
                                  224 << (bd - 8)))
    cp = np.arange(mx + 1, dtype=f)
    ty = (cp - f(bias_y)) / f(range_y)
    tuv = (cp - f(1 << (bd - 1))) / f(range_uv)
    yf = ty[y]
    if sub:
        if kind == "identity":
            raise _broken("identity matrix with subsampled chroma")
        cb, cr = (_float_chroma(tuv, c, h, w, img.ss) for c in (u, v))
    else:
        cb, cr = tuv[u], tuv[v]
    if kind == "identity":
        r, g, b = ty[v], yf, ty[u]
    elif kind == "ycgco":
        t = yf - cb
        g, b, r = yf + cb, t - cr, t + cr
    else:
        kr, kb = k
        kg = f(1) - kr - kb
        r = yf + (f(2) * (f(1) - kr)) * cr
        b = yf + (f(2) * (f(1) - kb)) * cb
        g = yf - ((f(2) * ((kr * (f(1) - kr) * cr)
                          + (kb * (f(1) - kb) * cb))) / kg)
    rgb = [np.clip(c, f(0), f(1)) for c in (r, g, b)]
    slow = _slow_path(img, kind)
    if prem is not None and slow:
        # libavif's avifImageYUVAnyToRGBAnySlow: each clamped channel
        # divided by the unorm alpha below 1, clamped to 1 again, 0 where
        # the alpha is 0
        a = np.minimum(prem.planes[0], mx).astype(f) / f(mx)
        part = a < f(1)
        safe = np.where(a > f(0), a, f(1))
        rgb = [np.where(a == f(0), f(0),
                        np.where(part, np.minimum(c / safe, f(1)), c))
               for c in rgb]
    out = np.stack([(f(0.5) + c * f(255)).astype(np.uint8) for c in rgb],
                   axis=-1)
    if prem is not None and not slow:
        out = _unattenuate(out, alpha_to_8(prem, False))
    return out


def _slow_path(img: DecodedImage, kind: str) -> bool:
    """Whether libavif 1.3 converts ``img`` on its slow path
    (avifImageYUVAnyToRGBAnySlow) where libyuv does not: everything but
    its fast paths, which need unsubsampled chroma (4:4:4 or monochrome)
    and take the matrix coefficients, or the identity matrix on 8-bit
    full-range 4:4:4."""
    if not (img.mono or img.ss == (0, 0)):
        return True
    if kind == "identity":
        return not (img.bit_depth == 8 and img.full_range and not img.mono)
    return kind == "ycgco"


# libyuv's fixed_invtbl8 (row_common.cc), as Pillow's libavif carries it:
# 1.0 in the upper half, 65536 / a in the lower (0 for a = 0, 0xffff for 1,
# 256 for 255)
_INVTBL8 = np.array([0, 0xFFFF] + [0x10000 // a for a in range(2, 255)]
                    + [0x100], dtype=np.int64)


def _unattenuate(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """libyuv's ARGBUnattenuate on 8-bit RGB under the 8-bit alpha ``a``:
    each channel widened to 16 bits (c * 257), times the reciprocal's
    lower half, the high 16 bits kept and clamped to 255."""
    ia = _INVTBL8[a][..., None]
    return np.minimum((rgb.astype(np.int64) * 257 * ia) >> 16,
                      255).astype(np.uint8)


def alpha_to_8(img: DecodedImage, shift: bool = True) -> np.ndarray:
    """The alpha item's plane at 8 bits, as libavif 1.3 narrows it: by a
    shift where libyuv converts the colour with its alpha (I010/I210/
    I410AlphaToARGB, or every plane narrowed to 8 bits first: ``shift``);
    else (libavif's float conversion, and libyuv's I012ToARGB, which
    takes no alpha) by avifReformatAlpha's float32 ``0.5 + a / max *
    255``."""
    a = img.planes[0]
    if shift or img.bit_depth == 8:
        return (a >> (img.bit_depth - 8)).astype(np.uint8)
    f = np.float32
    a = a.astype(f) / f((1 << img.bit_depth) - 1)
    return np.clip((f(0.5) + a * f(255)).astype(np.int32), 0,
                   255).astype(np.uint8)


def _alpha_shifted(color: DecodedImage) -> bool:
    """Whether libavif 1.3 narrows a deep alpha plane by libyuv's shift
    when it converts ``color`` to 8-bit RGBA (``alpha_to_8``)."""
    kind, _ = _conversion(color.cicp, color.full_range)
    return kind == "libyuv" and not (color.bit_depth == 12 and not color.mono
                                     and color.ss == (1, 1))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _stitch(it: Av1Item, cells: List[DecodedImage]) -> DecodedImage:
    """A grid's cells placed in raster order on its canvas and cropped to
    its output size, Y'UV before any conversion, as libavif 1.3 fills its
    grid image; with libavif's checks of the cells' sizes and of their
    agreement (size, depth, format, range, CICP)."""
    rows, cols, ow, oh = it.grid
    first = cells[0]
    ch, cw = first.planes[0].shape
    if cw * cols < ow or ch * rows < oh:
        raise _broken("the grid's cells do not cover the image")
    if cw * (cols - 1) >= ow or ch * (rows - 1) >= oh:
        raise _broken("the grid's right column or bottom row lies past "
                      "the canvas")
    if cw < 64 or ch < 64:
        raise _broken(f"grid cells of {cw}x{ch}, smaller than 64")
    ssx, ssy = (0, 0) if first.mono else first.ss
    if (ssx and (ow % 2 or cw % 2)) or (ssy and (oh % 2 or ch % 2)):
        raise _broken("odd grid or cell size with subsampled chroma")
    key = (lambda c: (c.planes[0].shape, c.bit_depth, c.mono, c.ss,
                      c.full_range, c.cicp))
    if any(key(c) != key(first) for c in cells):
        raise _broken("the grid's cells differ in size, depth, format, "
                      "range or CICP")
    out = [np.empty((oh, ow), np.int32)]
    if not first.mono:
        out += [np.empty(((oh + ssy) >> ssy, (ow + ssx) >> ssx), np.int32)
                for _ in range(2)]
    tools = dict.fromkeys(first.tools, 0)
    for i, cell in enumerate(cells):
        y0, x0 = ch * (i // cols), cw * (i % cols)
        h, w = min(ch, oh - y0), min(cw, ow - x0)
        for k, (dst, src) in enumerate(zip(out, cell.planes)):
            sx, sy = (ssx, ssy) if k else (0, 0)
            dst[y0 >> sy:(y0 + h + sy) >> sy, x0 >> sx:(x0 + w + sx) >> sx] = \
                src[:(h + sy) >> sy, :(w + sx) >> sx]
        for name, v in cell.tools.items():
            tools[name] += v
    return DecodedImage(out, first.bit_depth, first.cicp, first.full_range,
                        first.mono, first.ss, tools)


def _scale_to_ispe(img: DecodedImage, w: int, h: int) -> DecodedImage:
    """A frame whose size differs from its ``ispe``, scaled to it as
    libavif 1.3 does (avifImageScale: libyuv's ScalePlane with its box
    filter mode on each plane, the chroma to the subsampled size), within
    libavif's image size limits."""
    from .yuv_scale import scale_plane

    if w * h > _GRID_MAX_PIXELS or max(w, h) > _GRID_MAX_SIDE:
        raise _broken(f"ispe {w}x{h} is too large")
    ssx, ssy = (0, 0) if img.mono else img.ss
    out = []
    for k, p in enumerate(img.planes):
        sx, sy = (ssx, ssy) if k else (0, 0)
        out.append(scale_plane(p, (w + sx) >> sx, (h + sy) >> sy,
                               img.bit_depth > 8))
    return DecodedImage(out, img.bit_depth, img.cicp, img.full_range,
                        img.mono, img.ss, img.tools, img.frame_tools)


def _decode_item(it: Av1Item, times: Optional[dict]) -> DecodedImage:
    """An item's (or a track sample's) Y'UV: one AV1 payload, or a grid's
    cells, each decoded (film grain included) and then stitched."""
    decoded = []
    for cell in it.cells or [it]:
        img = decode_av1(cell.payload, times, cell.op, cell.layer)
        if img.planes[0].shape != (cell.height, cell.width):
            t0 = time.perf_counter()
            img = _scale_to_ispe(img, cell.width, cell.height)
            if times is not None:
                times["scale"] = times.get("scale", 0.0) \
                    + time.perf_counter() - t0
        decoded.append(img)
    if not it.cells:
        return decoded[0]
    t0 = time.perf_counter()
    img = _stitch(it, decoded)
    if times is not None:
        times["stitch"] = times.get("stitch", 0.0) + time.perf_counter() - t0
    return img


def _alpha_to_full(a: np.ndarray, depth: int) -> np.ndarray:
    """An alpha plane its sequence header calls limited range, widened to
    the full range as libavif 1.3 does when it decodes one
    (avifLimitedToFullY: 16-235 to 0-255 at 8 bits, 64-940 and 256-3760
    at 10 and 12, rounded, the division truncated toward zero as in C,
    then clamped)."""
    lo, hi = 16 << (depth - 8), 235 << (depth - 8)
    top = (1 << depth) - 1
    num = (a.astype(np.int64) - lo) * top + (hi - lo) // 2
    q = np.where(num >= 0, num // (hi - lo), -(-num // (hi - lo)))
    return np.clip(q, 0, top).astype(a.dtype)


def decode_avif(data: bytes, times: Optional[dict] = None):
    """(container, colour image, alpha image or None). ``times`` gains
    "parse" (the container, the headers and the tile decode), "filters",
    "upscale" (superres), "grain" and, for a grid, "stitch"."""
    t0 = time.perf_counter()
    box = read_container(data)
    if times is not None:
        times["parse"] = times.get("parse", 0.0) + time.perf_counter() - t0
    color = _decode_item(box.color, times)
    alpha = _decode_item(box.alpha, times) if box.alpha else None
    if alpha is not None:
        if not alpha.mono:
            raise _broken("the alpha item is not monochrome")
        if alpha.planes[0].shape != color.planes[0].shape:
            raise _broken("alpha and colour sizes differ")
        if not alpha.full_range:
            alpha.planes[0] = _alpha_to_full(alpha.planes[0],
                                             alpha.bit_depth)
            alpha.full_range = True
    if box.color.nclx is not None:
        cp, tc, mc, full = box.color.nclx
        color.cicp, color.full_range = (cp, tc, mc), full
    return box, color, alpha


def decode_avif_rgb8(data: bytes, times: Optional[dict] = None) -> np.ndarray:
    """(h, w, 3) uint8 RGB, alpha dropped."""
    box, color, alpha = decode_avif(data, times)
    t0 = time.perf_counter()
    rgb = yuv_to_rgb8(color, rgba=alpha is not None,
                      prem=alpha if box.premultiplied else None)
    if times is not None:
        times["convert"] = times.get("convert", 0.0) + time.perf_counter() - t0
    return rgb


def read_avif(data: bytes, times: Optional[dict] = None):
    """(pixels, high bit depth, ICC profile) as the reference's loader
    reads an AVIF: 10- and 12-bit full-range BT.601 (matrix 2, 5 or 6)
    4:4:4 streams without alpha go to 16-bit RGB through the float
    matrix; everything else (limited range too) is 8-bit RGB, or RGBA
    with an alpha item. (The reference stacks the Y'UV planes for its
    16-bit path; subsampled planes do not stack, and it falls back to the
    8-bit conversion, except at 64 columns or fewer, where it stacks rows
    read past the chroma planes, which this reader does not reproduce.)"""
    return avif_pixels(*decode_avif(data, times), times)


def avif_pixels(box: AvifContainer, color: DecodedImage,
                alpha: Optional[DecodedImage], times: Optional[dict] = None):
    """``read_avif``'s (pixels, high bit depth, ICC profile) of what
    ``decode_avif`` returned; ``times`` gains "convert"."""
    t0 = time.perf_counter()
    bd = color.bit_depth
    if (bd > 8 and color.full_range and color.cicp[2] in (2, 5, 6)
            and alpha is None and not color.mono and color.ss == (0, 0)):
        from ..av1.yuv import _INV

        maxv = (1 << bd) - 1
        h, w = color.planes[0].shape
        yuv = np.stack([p.reshape(-1) for p in color.planes],
                       axis=1).astype(np.float32)
        yuv[:, 1:] -= np.float32((maxv + 1) / 2)
        rgb = np.clip(np.floor(yuv @ _INV + 0.5), 0, maxv)
        out = (rgb.astype(np.uint16) << (16 - bd)).reshape(h, w, 3)
        hbd = True
    else:
        out = yuv_to_rgb8(color, rgba=alpha is not None,
                          prem=alpha if box.premultiplied else None)
        if alpha is not None:
            out = np.concatenate(
                [out, alpha_to_8(alpha, _alpha_shifted(color))[..., None]],
                axis=-1)
        hbd = False
    if times is not None:
        times["convert"] = times.get("convert", 0.0) + time.perf_counter() - t0
    return out, hbd, box.color.icc
