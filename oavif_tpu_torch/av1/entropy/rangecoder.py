"""AV1 multi-symbol adaptive range coder (daala entropy coder).

Implements the normative symbol decoder of the AV1 spec (§8.2: init_symbol /
decode_symbol / exit_symbol, EC_PROB_SHIFT=6, EC_MIN_PROB=4, complemented
bit window) and the matching encoder (carry-less range encoder with
pre-carry buffer). CDFs use the inverse-CDF Q15 convention: ``icdf[s]`` is
32768 minus the cumulative probability through symbol s, strictly
decreasing to icdf[nsym-1] == 0 — the same convention as the extracted
default tables (tools/extract_av1_tables.py).

The reference delegates all of this to libaom inside avifEncoderAddImage
(oavif src/io.zig:629-632); here it is the host-side byte
emitter fed by device-side tokenization. Correctness is anchored two ways:
encoder↔decoder round-trip property tests, and full-bitstream decode
through the independent dav1d/libavif oracle (tests/test_conformance.py).
"""

from __future__ import annotations

from typing import List, Sequence

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
PROB_TOP = 1 << 15  # 32768
WIN_SIZE = 32


def _ilog_nz(x: int) -> int:
    """Index of the highest set bit plus one (OD_ILOG_NZ)."""
    return x.bit_length()


class RangeEncoder:
    """Range encoder producing AV1-conformant symbol bytes.

    Streaming formulation derived from the decoder's interval arithmetic
    rather than from libaom's fixed-width-window internals. Invariant:
    ``low + rng <= 2**(15 + pending)`` at all times (initially 0 + 2^15 =
    2^15; each symbol replaces the interval with a sub-interval; each
    renormalization shifts both by d). Consequently byte flushes never
    carry, and only the final round-up in :meth:`done` can carry once.
    """

    def __init__(self) -> None:
        self.low = 0  # exact integer, < 2**(15 + pending)
        self.rng = 0x8000
        self.pending = 0  # renormalization shifts not yet flushed
        self.out = bytearray()

    # -- core interval update -------------------------------------------------

    def _carry(self) -> None:
        """Ripple a +1 carry into the already-flushed bytes."""
        i = len(self.out) - 1
        while i >= 0:
            if self.out[i] != 0xFF:
                self.out[i] += 1
                return
            self.out[i] = 0
            i -= 1
        raise AssertionError("carry out of stream start")

    def _normalize(self, low: int, rng: int) -> None:
        # A symbol can push low past the flushed byte boundary (the current
        # interval straddles it — with pending == 0 the 16-bit range can
        # straddle two boundaries), each overflow unit is one carry.
        bound = 1 << (15 + self.pending)
        while low >= bound:
            low -= bound
            self._carry()
        d = 16 - _ilog_nz(rng)
        low <<= d
        rng <<= d
        pending = self.pending + d
        while pending >= 8:
            shift = 15 + pending - 8
            b = low >> shift
            assert b < 256
            self.out.append(b)
            low &= (1 << shift) - 1
            pending -= 8
        self.low = low
        self.rng = rng
        self.pending = pending

    def _encode_q15(self, fl: int, fh: int, s: int, nsyms: int) -> None:
        """Encode symbol s where fl=icdf[s-1] (32768 if s==0), fh=icdf[s]."""
        l = self.low
        r = self.rng
        assert 32768 <= r <= 65535
        assert fh <= fl <= 32768
        n = nsyms - 1
        if fl < PROB_TOP:
            u = (((r >> 8) * (fl >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + (
                EC_MIN_PROB * (n - (s - 1))
            )
            v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + (
                EC_MIN_PROB * (n - s)
            )
            l += r - u
            r = u - v
        else:
            r -= (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + (
                EC_MIN_PROB * (n - s)
            )
        self._normalize(l, r)

    # -- public API -----------------------------------------------------------

    def encode_symbol(self, s: int, icdf: Sequence[int], nsyms: int) -> None:
        """Code symbol ``s`` against an inverse CDF (no adaptation)."""
        fl = PROB_TOP if s == 0 else int(icdf[s - 1])
        fh = int(icdf[s])
        self._encode_q15(fl, fh, s, nsyms)

    def encode_bool_q15(self, val: int, f: int) -> None:
        """Code a boolean where ``f`` is the Q15 inverse-CDF split
        (probability of val==0 is f/32768)."""
        l = self.low
        r = self.rng
        v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        if val:
            l += r - v
            r = v
        else:
            r -= v
        self._normalize(l, r)

    def encode_literal(self, value: int, bits: int) -> None:
        """MSB-first equiprobable literal (spec L(n))."""
        for i in range(bits - 1, -1, -1):
            self.encode_bool_q15((value >> i) & 1, 16384)

    def done(self) -> bytes:
        """Flush the final code value; any zero-bit continuation decodes to
        the same symbol sequence (round-up to 14 bits below the window top
        plus a guaranteed set bit, as the spec's decoder zero-pads)."""
        m = 0x3FFF
        e = ((self.low + m) & ~m) | (m + 1)
        bits = 15 + self.pending
        nbytes = (bits + 7) // 8
        e <<= nbytes * 8 - bits
        out = bytearray(self.out)
        if e >> (nbytes * 8):  # single possible carry from the round-up
            e &= (1 << (nbytes * 8)) - 1
            i = len(out) - 1
            while i >= 0:
                if out[i] != 0xFF:
                    out[i] += 1
                    break
                out[i] = 0
                i -= 1
            else:
                raise AssertionError("carry out of stream start")
        out.extend(e.to_bytes(nbytes, "big"))
        return bytes(out)


class RangeDecoder:
    """Normative AV1 symbol decoder (spec §8.2.2-8.2.6, dav1d msac model)."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.dif = (1 << (WIN_SIZE - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self._refill()

    def _refill(self) -> None:
        c = WIN_SIZE - self.cnt - 24
        while c >= 0:
            if self.pos < len(self.data):
                self.dif ^= self.data[self.pos] << c
                self.pos += 1
            # else: implicit zero byte — complemented zeros are ones, which
            # dif already holds (initialized all-ones, XOR only where bytes
            # exist), matching the spec's zero-padded trailing bits.
            c -= 8
        self.cnt = WIN_SIZE - c - 24

    def _norm(self, dif: int, rng: int) -> None:
        d = 16 - _ilog_nz(rng)
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & ((1 << WIN_SIZE) - 1)
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()

    def decode_symbol(self, icdf: Sequence[int], nsyms: int) -> int:
        c = self.dif >> (WIN_SIZE - 16)
        r = self.rng >> 8
        u = self.rng
        v = self.rng
        val = -1
        n = nsyms - 1
        while True:
            val += 1
            u = v
            v = (r * (int(icdf[val]) >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)
            v += EC_MIN_PROB * (n - val)
            if c >= v:
                break
        self.rng = u - v
        dif = self.dif - (v << (WIN_SIZE - 16))
        self._norm(dif, u - v)
        return val

    def decode_bool_q15(self, f: int) -> int:
        r = self.rng
        v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        vw = v << (WIN_SIZE - 16)
        if self.dif >= vw:
            # high region → symbol 0 per spec interval layout? No: the
            # encoder maps val==1 to the top interval (l += r - v), and dif
            # is the complemented window, so dif >= vw decodes val == 0.
            self._norm(self.dif - vw, r - v)
            return 0
        self._norm(self.dif, v)
        return 1

    def decode_literal(self, bits: int) -> int:
        x = 0
        for _ in range(bits):
            x = (x << 1) | self.decode_bool_q15(16384)
        return x


def update_cdf(icdf, val: int, nsyms: int) -> None:
    """Normative CDF adaptation (spec update_cdf, inverse-CDF form).

    ``icdf`` must be a mutable sequence of length nsyms + 1; the final
    element is the adaptation counter.
    """
    count = icdf[nsyms]
    # nsymbs2speed: 2-3 symbols → 1, 4+ → 2 (libaom/spec adaptation rate)
    rate = 3 + (1 if count > 15 else 0) + (1 if count > 31 else 0) + (
        1 if nsyms <= 3 else 2
    )
    tmp = PROB_TOP
    for i in range(nsyms - 1):
        if i == val:
            tmp = 0
        if tmp < icdf[i]:
            icdf[i] -= (icdf[i] - tmp) >> rate
        else:
            icdf[i] += (tmp - icdf[i]) >> rate
    icdf[nsyms] = count + (1 if count < 32 else 0)
