"""A lossless JPEG writer (ITU T.81 Annex H, SOF3, Huffman-coded) in numpy.

    from lossless_jpeg import encode
    data = encode(px, predictor=1, pt=0)

The system's libjpeg-turbo cannot write these files (it has no
``jpeg_enable_lossless``), so the tests and ``chip_smoke.py`` write them
here. Everything is vectorised: the differences of a whole plane, the
Huffman codes of a whole scan and their bit packing, so a 3840x2160 RGB
file takes about ten seconds.

``px`` is an (h, w) or (h, w, c) uint8 array, or a list of per-component
planes when the components are subsampled (``sampling`` then gives each
one's (h, v) factors and the planes are
``ceil(w * h / hmax) x ceil(h * v / vmax)``). Options: the predictor
(1-7) and point transform ``pt`` of every scan, ``restart_rows`` (a
restart marker every that many MCU rows), one interleaved scan or one scan
per component (``interleaved``), one Huffman table for all components or
one each (``shared_table``), the component ids and a ``JFIF`` or ``Adobe``
marker (``marker="jfif"``, ``"adobe0"``, ``"adobe1"``...).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

PRECISION = 8


def _predict(x: np.ndarray, predictor: int, pt: int,
             first_rows: np.ndarray) -> np.ndarray:
    """The prediction of every sample of ``x`` (already shifted right by
    ``pt``), as T.81 H.1.2.1 and libjpeg-turbo's jdlossls.c make it: the
    first row of the scan and of each restart interval from the left
    neighbour (its first sample from ``1 << (P - Pt - 1)``), the first
    column of the other rows from the sample above."""
    x = x.astype(np.int64)
    ra = np.zeros_like(x)
    rb = np.zeros_like(x)
    rc = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb[1:, :] = x[:-1, :]
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
            5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
            7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    pred[first_rows, 1:] = ra[first_rows, 1:]
    pred[first_rows, 0] = 1 << (PRECISION - pt - 1)
    return pred


def _categories(diff: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(category, extra bits) of each difference, taken modulo 2**16 as
    T.81 H.1.2.2 does; category 16 (a difference of 32768) has no extra
    bits."""
    d = diff.astype(np.int64) & 0xFFFF
    d = np.where(d > 32768, d - 65536, d)
    mag = np.abs(d)
    cat = np.zeros(d.shape, np.int64)
    nz = mag > 0
    cat[nz] = np.floor(np.log2(mag[nz])).astype(np.int64) + 1
    cat[mag == 32768] = 16
    extra = np.where(d < 0, d + (1 << cat) - 1, d) & ((1 << cat) - 1)
    extra[cat == 16] = 0
    return cat, extra


def huffman_lengths(freq: np.ndarray) -> np.ndarray:
    """Code lengths of the 17 symbols (0 for unused ones), limited to 16
    bits with no all-ones code: libjpeg's jpeg_gen_optimal_table."""
    f = [int(v) for v in freq] + [1]  # the reserved symbol 256
    n = len(f)
    codesize = [0] * n
    others = [-1] * n
    while True:
        live = [i for i in range(n) if f[i] > 0]
        if len(live) < 2:
            break
        c1 = min(live, key=lambda i: (f[i], -i))
        c2 = min((i for i in live if i != c1), key=lambda i: (f[i], -i))
        f[c1] += f[c2]
        f[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for s in codesize:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # take the reserved code out
    # hand the lengths out again, shortest to the most frequent symbol
    order = sorted(range(n - 1), key=lambda s: (-freq[s], s))
    order = [s for s in order if freq[s] > 0]
    lengths = np.zeros(17, np.int64)
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length]):
            lengths[order[k]] = length
            k += 1
    return lengths


def _canonical(lengths: np.ndarray) -> Tuple[List[int], bytes, np.ndarray]:
    """(BITS, HUFFVAL, code of each symbol) of a canonical code."""
    syms = sorted((int(lengths[s]), s) for s in range(17) if lengths[s])
    bits = [0] * 16
    for length, _ in syms:
        bits[length - 1] += 1
    codes = np.zeros(17, np.int64)
    code, prev = 0, syms[0][0]
    for length, s in syms:
        code <<= length - prev
        prev = length
        codes[s] = code
        code += 1
    return bits, bytes(s for _, s in syms), codes


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """The codes (each up to 32 bits, most significant first) packed into
    bytes, the last one padded with ones, 0xFF bytes stuffed with 0x00."""
    values = values.astype(np.uint64)
    lengths = lengths.astype(np.int64)
    keep = lengths > 0
    values, lengths = values[keep], lengths[keep]
    total = int(lengths.sum())
    pad = -total % 8
    if pad:
        values = np.append(values, np.uint64((1 << pad) - 1))
        lengths = np.append(lengths, pad)
        total += pad
    if total == 0:
        return b""
    end = np.cumsum(lengths)
    start = end - lengths
    word = start >> 6
    off = start & 63
    over = off + lengths - 64  # bits that spill into the next word
    head = np.where(over > 0, values >> np.maximum(over, 0).astype(np.uint64),
                    values << np.maximum(-over, 0).astype(np.uint64))
    tail = np.where(over > 0,
                    values << (64 - np.maximum(over, 1)).astype(np.uint64),
                    np.uint64(0))
    idx = np.empty(2 * len(values), np.int64)
    idx[0::2] = word
    idx[1::2] = word + (over > 0)
    parts = np.empty(2 * len(values), np.uint64)
    parts[0::2] = head
    parts[1::2] = tail
    cuts = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
    words = np.add.reduceat(parts, cuts)  # disjoint bits: a sum is an OR
    raw = words.astype(">u8").tobytes()[: total // 8]
    out = np.frombuffer(raw, np.uint8)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def _dht(slot: int, bits: Sequence[int], vals: bytes) -> bytes:
    return _segment(0xC4, bytes([slot]) + bytes(bits) + vals)


def encode(px, predictor: int = 1, pt: int = 0, restart_rows: int = 0,
           sampling: Optional[Sequence[Tuple[int, int]]] = None,
           interleaved: bool = True, shared_table: bool = True,
           ids: Optional[Sequence[int]] = None,
           marker: Optional[str] = None, size: Optional[Tuple[int, int]]
           = None) -> bytes:
    """The lossless JPEG of ``px`` (see the module's docstring); ``size``
    is (height, width) when the planes are subsampled."""
    if isinstance(px, np.ndarray):
        arr = px if px.ndim == 3 else px[..., None]
        planes = [arr[..., c] for c in range(arr.shape[2])]
        height, width = arr.shape[:2]
    else:
        planes = list(px)
        height, width = size
    n = len(planes)
    sampling = list(sampling or [(1, 1)] * n)
    ids = list(ids or range(1, n + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    for p, (h, v) in zip(planes, sampling):
        assert p.shape == (-(-height * v // vmax), -(-width * h // hmax))
    out = bytearray(b"\xff\xd8")
    if marker == "jfif":
        out += _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\0\0")
    elif marker and marker.startswith("adobe"):
        out += _segment(0xEE, b"Adobe\0\x64\0\0\0\0"
                        + bytes([int(marker[5:])]))
    sof = bytes([PRECISION]) + height.to_bytes(2, "big") \
        + width.to_bytes(2, "big") + bytes([n])
    for cid, (h, v) in zip(ids, sampling):
        sof += bytes([cid, h << 4 | v, 0])
    out += _segment(0xC3, sof)
    scans = [list(range(n))] if interleaved else [[c] for c in range(n)]
    for members in scans:
        out += _scan(planes, sampling, members, ids, predictor, pt,
                     restart_rows, shared_table, width, height, hmax, vmax)
    return bytes(out + b"\xff\xd9")


def _scan(planes, sampling, members, ids, predictor, pt, restart_rows,
          shared_table, width, height, hmax, vmax) -> bytes:
    """DHT, DRI, SOS and the entropy-coded data of one scan."""
    one = len(members) == 1
    if one:  # a non-interleaved scan: one sample per MCU
        c = members[0]
        mcuy, mcux = planes[c].shape
        geom = {c: (1, 1)}
    else:
        mcux, mcuy = -(-width // hmax), -(-height // vmax)
        geom = {c: sampling[c] for c in members}
    cats, extras = [], []
    for c in members:
        h, v = geom[c]
        x = planes[c].astype(np.int64) >> pt
        first = np.zeros(x.shape[0], bool)
        step = (restart_rows or mcuy) * v
        first[::step] = True
        cat, extra = _categories(x - _predict(x, predictor, pt, first))
        # the MCU grid, with dummy samples (a zero difference) past the
        # plane's edges
        grid = (mcuy * v, mcux * h)
        cg = np.zeros(grid, np.int64)
        eg = np.zeros(grid, np.int64)
        cg[: x.shape[0], : x.shape[1]] = cat
        eg[: x.shape[0], : x.shape[1]] = extra
        cats.append(cg.reshape(mcuy, v, mcux, h).transpose(0, 2, 1, 3)
                    .reshape(mcuy, mcux, v * h))
        extras.append(eg.reshape(mcuy, v, mcux, h).transpose(0, 2, 1, 3)
                      .reshape(mcuy, mcux, v * h))
    slots = [0] * len(members) if shared_table else list(range(len(members)))
    codes_of = {}
    head = bytearray()
    for slot in sorted(set(slots)):
        freq = sum(np.bincount(cats[k].ravel(), minlength=17)
                   for k in range(len(members)) if slots[k] == slot)
        if freq.sum() and (freq > 0).sum() == 1:
            freq[(np.argmax(freq) + 1) % 17] = 1  # a code needs 2 symbols
        lengths = huffman_lengths(freq)
        bits, vals, codes = _canonical(lengths)
        codes_of[slot] = (codes, lengths)
        head += _dht(slot, bits, vals)
    if restart_rows:
        head += _segment(0xDD, (restart_rows * mcux).to_bytes(2, "big"))
    sos = bytes([len(members)])
    for k, c in enumerate(members):
        sos += bytes([ids[c], slots[k] << 4])
    head += _segment(0xDA, sos + bytes([predictor, 0, pt]))
    # one code per sample: the Huffman code, then the extra bits
    code_v, code_l = [], []
    for k in range(len(members)):
        codes, lengths = codes_of[slots[k]]
        s = cats[k]
        code_l.append(lengths[s] + s)
        code_v.append((codes[s] << s) | extras[k])
    val = np.concatenate(code_v, axis=2)
    ln = np.concatenate(code_l, axis=2)
    body = bytearray()
    step = restart_rows or mcuy
    for i, r in enumerate(range(0, mcuy, step)):
        if i:
            body += bytes([0xFF, 0xD0 + (i - 1) % 8])
        body += _pack(val[r: r + step].ravel(), ln[r: r + step].ravel())
    return bytes(head + body)
