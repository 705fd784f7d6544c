"""JPEG decoder for 8-bit DCT and lossless files, without Pillow.

Baseline, extended-sequential (``SOF1``, ``SOF9``) and progressive
(``SOF2``, ``SOF10``) frames, Huffman- or arithmetic-coded (with the
``DAC`` conditioning), of 1, 3 or 4 components with any sampling factors
from 1 to 4, restart intervals, 8- and 16-bit quantization tables, and
the ICC profile of the ``APP2`` chunks, and Huffman-coded lossless
(``SOF3``) frames with any predictor and point transform. This module
walks the markers, picks the colour space and builds the Huffman look-up
tables; the C side (``jpeg_decode.c``, in the host library) decodes the
scans and turns the coefficients into samples. The samples are
libjpeg-turbo's in its default
decompression (JDCT_ISLOW, fancy upsampling, block smoothing of the
progressive files whose scans leave low coefficients unrefined), which is
what Pillow, and so the reference's loader, returns; a 4-component file
goes to RGB as Pillow's ``convert("RGB")`` takes it
(``tests/test_torch_jpeg.py`` holds both equal).

Lossless files are libjpeg-turbo's too: their samples as the scans give
them, boxes for the upsampling, and, as libjpeg-turbo converts no colours
of a lossless file, RGB or CMYK only (a ``JFIF`` marker or an Adobe
transform that names YCbCr raise).

12-bit samples, arithmetic-coded lossless and hierarchical frames, 2 or
more than 4 components and fractional sampling ratios raise
``ValueError``.

A file that ends before its ``EOI`` marker decodes where Pillow decodes
it and raises ``OSError`` where Pillow's ``load`` raises. Pillow feeds
libjpeg-turbo from a suspending source, so the rule is where libjpeg
would have to wait for bytes that never come:

- a file of several scans (progressive, or a first scan without every
  component: libjpeg's ``has_multiple_scans``) is read whole, up to its
  ``EOI``, before a row is given out, so it raises if the ``EOI`` is
  missing;
- a file of one scan decodes if its scan does: the Huffman bit reader
  refills below 8 bits for a code (below 9 for a longer one) and below n
  for n extra bits, loading up to 57 bits, and a refill, or a search for
  a restart marker, that meets the end of the data before a marker
  suspends, and so raises. What follows the scan is read as libjpeg's
  ``jpeg_finish_decompress`` reads it: its errors raise ``OSError``, as
  libjpeg's error exit does in Pillow's ``load``; its end of data does
  not raise (Pillow has all the rows by then);
- an arithmetic-coded scan reads ahead whole bytes and cannot suspend
  (``jdarith.c``, ``get_byte``): a byte wanted past the end raises.

One difference is kept on purpose: Pillow hands libjpeg a file 64 KiB at
a time, so a whole arithmetic file whose scan crosses the edge of the
block Pillow has handed over raises there (``get_byte`` cannot wait for
the next block). This reader has the whole file and decodes it, with
the pixels libjpeg gives when it has all the data at once.
"""

from __future__ import annotations

import ctypes
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

# zigzag index -> natural (row-major) index
NATURAL = np.array(
    [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
     40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
     36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
     60, 61, 54, 47, 55, 62, 63], dtype=np.int64)

# markers this reader refuses, by the variant they start
_REFUSED = {
    0xC5: "hierarchical JPEG (SOF5)",
    0xC6: "hierarchical progressive JPEG (SOF6)",
    0xC7: "hierarchical lossless JPEG (SOF7)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive JPEG (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)",
    0xDE: "hierarchical JPEG (DHP marker)",
    0xDF: "hierarchical JPEG (EXP marker)",
}

# the tables libjpeg-turbo loads into slots 0 and 1 when a sequential
# file defines none there (ITU T.81 Annex K.3; Motion-JPEG frames omit
# them): (bits[1..16], symbols)
_STD_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
_STD_DC_CHROMA_BITS = (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)
_STD_AC_LUMA_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
_STD_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433"
    "627282090a161718191a25262728292a3435363738393a434445464748494a535455"
    "565758595a636465666768696a737475767778797a838485868788898a9293949596"
    "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4"
    "d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_STD_AC_CHROMA_BITS = (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77)
_STD_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f01562"
    "72d10a162434e125f11718191a262728292a35363738393a434445464748494a5354"
    "55565758595a636465666768696a737475767778797a82838485868788898a929394"
    "95969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2"
    "d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
_STD_TABLES = {
    (0, 0): (_STD_DC_BITS, bytes(range(12))),
    (0, 1): (_STD_DC_CHROMA_BITS, bytes(range(12))),
    (1, 0): (_STD_AC_LUMA_BITS, _STD_AC_LUMA_VALS),
    (1, 1): (_STD_AC_CHROMA_BITS, _STD_AC_CHROMA_VALS),
}

# the C side's layouts (jpeg_decode.c): words of one Huffman table, of one
# scan descriptor (an arithmetic scan's conditioning from word 20) and of
# one component's geometry
_LOOK_BITS = 9
_HT_WORDS = (1 << _LOOK_BITS) + 18 + 17 + 256
_S_WORDS = 24
_S_COND = 20
_C_WORDS = 8
# (progressive, arithmetic, lossless)
_SOF = {0xC0: (False, False, False), 0xC1: (False, False, False),
        0xC2: (True, False, False), 0xC3: (False, False, True),
        0xC9: (False, True, False), 0xCA: (True, True, False)}
_CS = {"gray": 0, "ycc": 1, "rgb": 2, "cmyk": 3, "ycck": 4}

# a marker that ends an entropy-coded segment: 0xFF, then neither a
# stuffed zero, nor RSTn, nor a fill byte
_SEGMENT_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")


def _truncated() -> OSError:
    return OSError("JPEG file is truncated")


def huffman_table(bits, vals: bytes, dc: bool,
                  max_dc: int = 15) -> np.ndarray:
    """The C side's look-up table for one DHT table (libjpeg's
    jpeg_make_d_derived_tbl): the 9-bit look-ahead, maxcode, valoffset and
    the symbols. Raises ValueError for a table no prefix code fits, or a
    DC symbol above ``max_dc`` (16 in a lossless file)."""
    t = np.zeros(_HT_WORDS, dtype=np.int32)
    look = t[: 1 << _LOOK_BITS]
    maxcode = t[1 << _LOOK_BITS: (1 << _LOOK_BITS) + 18]
    valoff = t[(1 << _LOOK_BITS) + 18: (1 << _LOOK_BITS) + 35]
    t[(1 << _LOOK_BITS) + 35: (1 << _LOOK_BITS) + 35 + len(vals)] = \
        np.frombuffer(vals, np.uint8)
    if dc and any(v > max_dc for v in vals):
        raise ValueError(f"bad JPEG Huffman table (DC symbol above "
                         f"{max_dc})")
    code = 0
    p = 0
    for length in range(1, 17):
        n = bits[length - 1]
        if n:
            valoff[length] = p - code
            for _ in range(n):
                if length <= _LOOK_BITS:
                    lo = code << (_LOOK_BITS - length)
                    look[lo: lo + (1 << (_LOOK_BITS - length))] = \
                        (length << 8) | vals[p]
                code += 1
                p += 1
            if code >= 1 << length:  # no code may be all ones
                raise ValueError("bad JPEG Huffman table")
            maxcode[length] = code - 1
        else:
            maxcode[length] = -1
        code <<= 1
    maxcode[17] = 0xFFFFF
    return t


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "quant", "coef_bits")

    def __init__(self, cid: int, h: int, v: int, tq: int) -> None:
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None  # latched at its 1st scan
        self.coef_bits = [-1] * 64  # progressive: the last Al per coefficient


def _segment(data: bytes, pos: int) -> Tuple[int, int]:
    """The marker segment at ``pos`` (its length word): (payload start,
    end). Raises OSError where the file ends inside it."""
    if pos + 2 > len(data):
        raise _truncated()
    length = (data[pos] << 8) | data[pos + 1]
    if length < 2:
        raise ValueError("bad JPEG marker length")
    if pos + length > len(data):
        raise _truncated()
    return pos + 2, pos + length


def _next_marker(data: bytes, pos: int) -> Tuple[int, int]:
    """libjpeg's next_marker: skip bytes to an 0xFF, fill bytes and 0xFF00;
    returns (marker, position after it)."""
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise _truncated()
        if data[pos] != 0:
            return data[pos], pos + 1
        pos += 1


def _dqt(seg: bytes, tables: Dict[int, np.ndarray]) -> None:
    i = 0
    while i < len(seg):
        prec, slot = seg[i] >> 4, seg[i] & 15
        i += 1
        size = 128 if prec else 64
        if slot >= 4 or prec > 1 or i + size > len(seg):
            raise ValueError("bad JPEG quantization table")
        if prec:
            vals = np.frombuffer(seg[i: i + size], ">u2").astype(np.int64)
        else:
            vals = np.frombuffer(seg[i: i + size], np.uint8).astype(np.int64)
        q = np.zeros(64, dtype=np.int64)
        q[NATURAL] = vals
        # libjpeg keeps its IDCT multipliers as 16-bit signed integers
        tables[slot] = q.astype(np.uint16).view(np.int16)
        i += size


def _dht(seg: bytes, huff: Dict[Tuple[int, int], tuple]) -> None:
    i = 0
    while i < len(seg):
        if i + 17 > len(seg):
            raise ValueError("bad JPEG Huffman table")
        cls, slot = seg[i] >> 4, seg[i] & 15
        bits = tuple(seg[i + 1: i + 17])
        count = sum(bits)
        i += 17
        if cls > 1 or slot >= 4 or count > 256 or i + count > len(seg):
            raise ValueError("bad JPEG Huffman table")
        huff[cls, slot] = (bits, bytes(seg[i: i + count]))
        i += count


class _Reader:
    """One pass over the markers: the frame, the scans and what the
    decoder needs of them."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.progressive = False
        self.arith = False
        self.lossless = False
        # the arithmetic conditioning per table slot (libjpeg's defaults)
        self.dc_l, self.dc_u, self.ac_k = [0] * 16, [1] * 16, [5] * 16
        self.width = self.height = 0
        self.comps: List[_Component] = []
        self.jfif = False
        self.adobe: Optional[int] = None
        self.icc_chunks: List[bytes] = []
        self.icc: Optional[bytes] = None
        self.scans: List[List[int]] = []
        # libjpeg's has_multiple_scans, set by the first scan
        self.multi_scan = False
        # the last scan's data runs to the end of the file, no marker after
        self.open_end = False
        self.tables: List[np.ndarray] = []
        self._table_ids: Dict[tuple, int] = {}

    def table(self, key: tuple, dc: bool) -> int:
        """The index of this Huffman table's look-up table, built once."""
        if (key, dc) not in self._table_ids:
            self._table_ids[key, dc] = len(self.tables)
            self.tables.append(huffman_table(key[0], key[1], dc,
                                             16 if self.lossless else 15))
        return self._table_ids[key, dc]

    def read(self) -> None:
        try:
            self._read()
        except ValueError as e:
            if self.scans and not self.multi_scan:
                # met by jpeg_finish_decompress, after the rows are out:
                # libjpeg's error exit, which Pillow's load raises
                raise OSError(f"broken data stream when reading image "
                              f"file ({e})") from e
            raise

    def _read(self) -> None:
        data = self.data
        if data[:2] != b"\xff\xd8":
            raise ValueError("not a JPEG file (no SOI marker)")
        pos = 2
        quant: Dict[int, np.ndarray] = {}
        huff: Dict[Tuple[int, int], tuple] = {}
        restart = 0
        seen_sof = False
        while True:
            try:
                marker, pos = _next_marker(data, pos)
                if marker == 0xD9:  # EOI
                    break
                if 0xD0 <= marker <= 0xD7 or marker == 0x01:
                    continue  # RSTn and TEM carry no length
                if marker in _REFUSED:
                    raise ValueError(f"unsupported {_REFUSED[marker]}")
                start, end = _segment(data, pos)
            except OSError:
                if self.scans and not self.multi_scan:
                    break  # jpeg_finish_decompress suspends: rows are out
                raise
            seg = data[start:end]
            pos = end
            if marker in _SOF:
                if seen_sof:
                    raise ValueError("JPEG file with two frame headers")
                seen_sof = True
                self._sof(marker, seg)
            elif marker == 0xDB:
                _dqt(seg, quant)
            elif marker == 0xC4:
                _dht(seg, huff)
            elif marker == 0xCC:
                self._dac(seg)
            elif marker == 0xDD:
                if len(seg) < 2:
                    raise ValueError("bad JPEG DRI marker")
                restart = (seg[0] << 8) | seg[1]
            elif marker == 0xDA:
                if not seen_sof:
                    raise ValueError("JPEG scan before its frame header")
                if self.scans and not self.multi_scan:
                    raise ValueError("JPEG scan after the only scan of a "
                                     "sequential frame (EOI expected)")
                self._sos(seg, quant, huff, restart, pos)
                if len(self.scans) == 1:
                    self.multi_scan = (self.progressive
                                       or seg[0] < len(self.comps))
                m = _SEGMENT_END.search(data, pos)
                stop = m.start() if m else len(data)
                self.open_end = m is None
                self.scans[-1][1] = stop - pos
                pos = stop
            elif 0xE0 <= marker <= 0xEF:
                self._app(marker, seg, seen_sof, bool(self.scans))
            elif marker in (0xFE, 0xDC):
                pass  # COM; DNL (the height is in the frame header)
            else:
                raise ValueError(f"unknown JPEG marker 0x{marker:02X}")
        if not self.scans:
            raise ValueError("JPEG file has no image (no scan)")

    def _app(self, marker: int, seg: bytes, seen_sof: bool,
             seen_sos: bool) -> None:
        if seen_sos:
            return  # libjpeg and Pillow read these before the first scan
        if marker == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\0":
            self.jfif = True
        elif marker == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            self.adobe = seg[11]
        elif (marker == 0xE2 and not seen_sof
              and seg.startswith(b"ICC_PROFILE\0")):
            self.icc_chunks.append(bytes(seg))

    def _dac(self, seg: bytes) -> None:
        """libjpeg's get_dac: (class << 4 | slot, value) pairs; a DC
        slot's L and U, an AC slot's K."""
        if len(seg) % 2:
            raise ValueError("bad JPEG DAC marker")
        for i in range(0, len(seg), 2):
            index, val = seg[i], seg[i + 1]
            if index >= 32:
                raise ValueError("bad JPEG DAC marker (table index)")
            if index >= 16:
                self.ac_k[index - 16] = val
            else:
                self.dc_l[index], self.dc_u[index] = val & 15, val >> 4
                if self.dc_l[index] > self.dc_u[index]:
                    raise ValueError("bad JPEG DAC marker (L above U)")

    def _sof(self, marker: int, seg: bytes) -> None:
        if len(seg) < 6:
            raise ValueError("bad JPEG frame header")
        precision = seg[0]
        self.height = (seg[1] << 8) | seg[2]
        self.width = (seg[3] << 8) | seg[4]
        n = seg[5]
        if precision != 8:
            raise ValueError(f"unsupported {precision}-bit JPEG")
        if n not in (1, 3, 4):
            raise ValueError(f"unsupported JPEG with {n} components")
        if self.height == 0:
            raise ValueError("unsupported JPEG with its height in a DNL "
                             "marker")
        if self.width == 0:
            raise ValueError("empty JPEG image")
        if len(seg) < 6 + 3 * n:
            raise ValueError("bad JPEG frame header")
        self.progressive, self.arith, self.lossless = _SOF[marker]
        for c in range(n):
            cid, hv, tq = seg[6 + 3 * c: 9 + 3 * c]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq >= 4:
                raise ValueError("bad JPEG sampling factors")
            self.comps.append(_Component(cid, h, v, tq))
        hmax = max(c.h for c in self.comps)
        vmax = max(c.v for c in self.comps)
        if any(hmax % c.h or vmax % c.v for c in self.comps):
            raise ValueError("unsupported JPEG with a fractional sampling "
                             "ratio")
        # Pillow's fixup: APP2 chunks ordered by sequence number
        if self.icc_chunks:
            chunks = sorted(self.icc_chunks)
            if chunks[0][13] == len(chunks):
                self.icc = b"".join(c[14:] for c in chunks)

    def _sos(self, seg: bytes, quant, huff, restart: int, pos: int) -> None:
        if not seg:
            raise ValueError("bad JPEG scan header")
        n = seg[0]
        if not 1 <= n <= 4 or len(seg) < 4 + 2 * n:
            raise ValueError("bad JPEG scan header")
        desc = [0] * _S_WORDS
        desc[0], desc[2] = pos, n
        ids = [c.cid for c in self.comps]
        members = []
        for k in range(n):
            cid, tbl = seg[1 + 2 * k], seg[2 + 2 * k]
            if cid not in ids or ids.index(cid) in members:
                raise ValueError("bad JPEG component id in a scan")
            members.append(ids.index(cid))
            desc[3 + k] = members[-1]
            desc[7 + k] = desc[11 + k] = -1
        ss, se, ahal = seg[1 + 2 * n: 4 + 2 * n]
        ah, al = ahal >> 4, ahal & 15
        desc[15:20] = [ss, se, ah, al, restart]
        if n > 1 and sum(self.comps[i].h * self.comps[i].v
                         for i in members) > 10:
            raise ValueError("bad JPEG scan (more than 10 blocks in an MCU)")
        if self.progressive:
            self._progression(members, ss, se, ah, al)
        if self.lossless:
            self._lossless_scan(members, ss, se, ah, al, restart)
        for k, ci in enumerate(members):
            comp = self.comps[ci]
            if comp.quant is None and not self.lossless:
                if comp.tq not in quant:
                    raise ValueError("JPEG component without its "
                                     "quantization table")
                comp.quant = quant[comp.tq].copy()
            tbl = seg[2 + 2 * k]
            dc_slot, ac_slot = tbl >> 4, tbl & 15
            if self.arith:  # conditioning slots, read as the scan starts
                desc[7 + k], desc[11 + k] = dc_slot, ac_slot
                desc[_S_COND + k] = (self.dc_l[dc_slot]
                                     | self.dc_u[dc_slot] << 4
                                     | self.ac_k[ac_slot] << 8)
                continue
            if dc_slot >= 4 or ac_slot >= 4:
                raise ValueError("bad JPEG Huffman table selector")
            uses_dc = not self.progressive or (ss == 0 and ah == 0)
            uses_ac = not self.lossless and (not self.progressive or ss > 0)
            for cls, slot, used, word in ((0, dc_slot, uses_dc, 7),
                                          (1, ac_slot, uses_ac, 11)):
                if not used:
                    continue
                spec = huff.get((cls, slot))
                if spec is None and not (self.progressive
                                         or self.lossless):
                    spec = _STD_TABLES.get((cls, slot))
                if spec is None:
                    raise ValueError("JPEG scan uses an undefined Huffman "
                                     "table")
                desc[word + k] = self.table(spec, cls == 0)
        self.scans.append(desc)

    def _progression(self, members, ss: int, se: int, ah: int,
                     al: int) -> None:
        """libjpeg's checks of a progressive scan (jdphuff.c), and each
        coefficient's successive-approximation state."""
        bad = (se != 0) if ss == 0 else (ss > se or se > 63
                                          or len(members) != 1)
        if (ah and al != ah - 1) or al > 13 or bad:
            raise ValueError(f"bad JPEG progression (Ss={ss} Se={se} "
                             f"Ah={ah} Al={al})")
        for ci in members:
            bits = self.comps[ci].coef_bits
            for k in range(ss, se + 1):
                bits[k] = al

    def _lossless_scan(self, members, ss: int, se: int, ah: int, al: int,
                       restart: int) -> None:
        """libjpeg-turbo's checks of a lossless scan (jdlossls.c): the
        predictor Ss from 1 to 7, Se and Ah zero, the point transform Al
        below the precision, and restart intervals of whole MCU rows."""
        if not 1 <= ss <= 7 or se or ah or al >= 8:
            raise ValueError(f"bad JPEG lossless scan (Ss={ss} Se={se} "
                             f"Ah={ah} Al={al})")
        if len(members) == 1:
            c = self.comps[members[0]]
            hmax = max(d.h for d in self.comps)
            cols = -(-self.width * c.h // hmax)
        else:
            cols = -(-self.width // max(d.h for d in self.comps))
        if restart % cols:
            raise ValueError(f"bad JPEG lossless restart interval ({restart} "
                             f"MCUs, rows of {cols})")

    def smoothed(self) -> bool:
        """Whether libjpeg smooths the blocks of this progressive file
        (jdcoefct.c, smoothing_ok, on the state the last scan left): its
        scans leave one of the first nine AC coefficients unrefined."""
        if not self.progressive:
            return False
        useful = False
        for c in self.comps:
            if c.quant is None or c.coef_bits[0] < 0:
                return False
            if any(c.quant[p] == 0 for p in (0, 1, 8, 16, 9, 2, 3, 10, 17,
                                             24)):
                return False
            useful |= any(b != 0 for b in c.coef_bits[1:10])
        return useful

    def colorspace(self) -> str:
        """The colour space libjpeg assumes (jdapimin.c,
        default_decompress_parms)."""
        n = len(self.comps)
        if n == 1:
            return "gray"
        if n == 3:
            if self.jfif:
                return "ycc"
            if self.adobe is not None:
                return "rgb" if self.adobe == 0 else "ycc"
            ids = tuple(c.cid for c in self.comps)
            # a lossless file without either marker is RGB
            return "rgb" if ids == (82, 71, 66) or self.lossless else "ycc"
        if self.adobe is not None and self.adobe != 0:
            return "ycck"
        return "cmyk"


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """libjpeg's CMYK samples to RGB as Pillow gives them: opened as
    ``CMYK;I`` (inverted), then ``convert("RGB")``."""
    inv = 255 - cmyk.astype(np.int32)
    nk = 255 - inv[..., 3:]
    t = inv[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _ptrs(arrays) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def decode_jpeg(data: bytes) -> Tuple[np.ndarray, Optional[bytes]]:
    """Decode a JPEG to ((h, w, 1) uint8 for one component, else (h, w, 3)
    uint8 RGB, icc_or_None)."""
    from ..av1.entropy.fast import get_lib

    r = _Reader(bytes(data))
    r.read()
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable: the C runtime "
                           "(oavif_tpu_torch/av1/entropy) failed to build")
    space = r.colorspace()
    if r.lossless and space in ("ycc", "ycck"):
        raise ValueError(f"unsupported lossless JPEG in "
                         f"{'YCbCr' if space == 'ycc' else 'YCCK'} "
                         f"(libjpeg-turbo converts no colours of a lossless "
                         f"file)")
    hmax = max(c.h for c in r.comps)
    vmax = max(c.v for c in r.comps)
    unit = 1 if r.lossless else 8  # samples per block side
    mcux = -(-r.width // (unit * hmax))
    mcuy = -(-r.height // (unit * vmax))
    geom = np.zeros((len(r.comps), _C_WORDS), dtype=np.int32)
    coefs = []
    for i, c in enumerate(r.comps):
        bw, bh = mcux * c.h, mcuy * c.v
        geom[i, :6] = (c.h, c.v, bw,
                       -(-r.width * c.h // (unit * hmax)),
                       -(-r.height * c.v // (unit * vmax)), bh)
        coefs.append(np.zeros(bw * bh * unit * unit, dtype=np.int16))
    scans = np.ascontiguousarray(r.scans, dtype=np.int32)
    tables = (np.stack(r.tables) if r.tables  # none in arithmetic files
              else np.zeros((1, _HT_WORDS), dtype=np.int32))
    cptrs = _ptrs(coefs)
    rc = lib.jpeg_entropy(r.data, scans.ctypes.data, len(scans),
                          tables.ctypes.data, cptrs, geom.ctypes.data,
                          mcux, mcuy, int(r.progressive) | 2 * r.arith
                          | 4 * r.lossless | 8 * r.open_end)
    if rc == -1:
        raise OSError("image file is truncated")
    if rc == -2:
        raise OSError("broken data stream when reading image file")
    if rc:
        raise ValueError(f"bad JPEG scan {rc - 1}")
    quant = np.stack([c.quant if c.quant is not None
                      else np.zeros(64, np.int16) for c in r.comps])
    nout = {"gray": 1, "ycc": 3, "rgb": 3}.get(space, 4)
    out = np.empty((r.height, r.width, nout), dtype=np.uint8)
    bits = (np.array([c.coef_bits[:10] for c in r.comps], dtype=np.int32)
            if r.smoothed() else None)
    rc = lib.jpeg_pixels(cptrs, geom.ctypes.data, len(r.comps),
                         quant.ctypes.data, r.width,
                         r.height, hmax, vmax, _CS[space], int(r.lossless),
                         None if bits is None else bits.ctypes.data,
                         out.ctypes.data)
    if rc:
        raise ValueError("unsupported JPEG with a fractional sampling ratio")
    if nout == 4:
        out = cmyk_to_rgb(out)
    return out, r.icc
