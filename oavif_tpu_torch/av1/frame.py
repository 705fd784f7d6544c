"""Frame encode over tiles with the GPU planner; the counterpart of the
planner cache, ``_encode_one_tile`` and ``encode_frame_planes`` in
oavif_tpu/av1/frame.py.

The tile coder itself is the reference's: the native C tile encoder
(``tile_encode_native``), or the Python ``TileEncoder`` under
``OAVIF_PY_TILE=1``, with the reference's cross-probe decision cache.
Unlike the reference, planning is not wrapped in a fallback: a planner
that fails raises instead of degrading to a host-only search.
"""

from __future__ import annotations

import os
import threading
import weakref
import zlib
from typing import List

import numpy as np

from oavif_tpu.av1.entropy.fast import tile_encode_native
from oavif_tpu.av1.frame import _DEC_CACHE, TileEncoder, _get_dec, _store_dec
from oavif_tpu.av1.obu import tile_grid

from ..device import resolve_device
from .encode_tpu import FramePlanner

_PLANNER_CACHE: dict = {}
_PLANNER_CACHE_LOCK = threading.Lock()
_DIGEST_CACHE: dict = {}


def reset_planners() -> None:
    """Drop every cached planner (and its device planes) and the
    cross-probe decision cache keyed by their plans, so that the next
    encode uploads, plans and decides afresh. (The decision cache clears
    itself whenever it passes 16 entries, dead plans' included, so what it
    holds changes which later probes replay decisions.)"""
    with _PLANNER_CACHE_LOCK:
        _PLANNER_CACHE.clear()
        _DIGEST_CACHE.clear()
        _DEC_CACHE.clear()


def planners() -> List[FramePlanner]:
    """The cached planners, oldest first."""
    with _PLANNER_CACHE_LOCK:
        return list(_PLANNER_CACHE.values())


def get_planner(tile_planes, bitdepth, nmodes=13,
                duel_level=0) -> FramePlanner:
    """Planner per tile content and device: the TQ loop re-encodes the
    same planes at several quantizers, and the planes (device-resident in
    the planner) don't change with q. Keyed by a full-content digest (crc32
    of the Y bytes), LRU over 8 entries. Get-or-create is serialized: a
    duplicate planner would break the decision cache's id(plan) binding.

    Plane buffers handed to the encoder are never written in place after
    creation, so the digest is memoized by buffer identity
    (weakref-guarded); OAVIF_DEBUG=1 recomputes and asserts."""
    device = resolve_device()
    y = np.ascontiguousarray(tile_planes[0])
    with _PLANNER_CACHE_LOCK:
        ent = _DIGEST_CACHE.get(id(y))
        if ent is not None and ent[0]() is y:
            digest = ent[1]
            if os.environ.get("OAVIF_DEBUG"):
                assert digest == zlib.crc32(y.tobytes()), \
                    "plane buffer mutated in place (digest memo stale)"
        else:
            digest = zlib.crc32(y.tobytes())
            if len(_DIGEST_CACHE) > 64:
                _DIGEST_CACHE.clear()
            _DIGEST_CACHE[id(y)] = (weakref.ref(y), digest)
        key = (y.shape, len(tile_planes), bitdepth, nmodes, duel_level,
               str(device), digest)
        fp = _PLANNER_CACHE.pop(key, None)  # re-inserted below: LRU order
        if fp is None:
            while len(_PLANNER_CACHE) >= 8:
                _PLANNER_CACHE.pop(next(iter(_PLANNER_CACHE)))
            fp = FramePlanner(tile_planes, bitdepth, nmodes=nmodes,
                              duel_level=duel_level, device=device)
        _PLANNER_CACHE[key] = fp
        return fp


def _encode_one_tile(args):
    (tile_planes, qindex, bitdepth, speed, u_ac_delta_q, screen_tools,
     filter_intra, lr, sb128) = args
    plan = None
    # The planner arms on real frames only (at least 256x256 pixels);
    # smaller tiles take the coder's own host search, as in the reference.
    # It also stays off below speed 6, where the reference gets no plan
    # either: its duel level 2 packs a 32-grid runner-up that its
    # unpack_plan cannot index, and the IndexError is swallowed into a
    # host-only search.
    if (os.environ.get("OAVIF_TPU_PLANNER", "1") != "0"
            and qindex > 0 and 6 <= speed <= 9
            and np.asarray(tile_planes[0]).size >= 256 * 256):
        # 7 modes + directional nomination; speed 6 adds host runner-up
        # duels at the 16 grid
        duel_level = 1 if speed <= 6 else 0
        planner = get_planner(tile_planes, bitdepth, 13, duel_level)
        plan = planner.plan(qindex, exact=speed <= 4)
        if (plan is not None and os.environ.get("OAVIF_PY_TILE") == "1"
                and os.environ.get("OAVIF_DEVICE_LEVELS", "0") != "0"):
            raise NotImplementedError(
                "device levels (OAVIF_DEVICE_LEVELS) are not ported to "
                "oavif_tpu_torch yet")

    dec, record = _get_dec(plan, tile_planes, qindex, speed)

    if os.environ.get("OAVIF_PY_TILE") != "1":
        # production path: the whole per-tile serial loop in C
        res = tile_encode_native(tile_planes, qindex, bitdepth, speed, plan,
                                 u_ac_delta_q, dec=dec,
                                 screen_tools=screen_tools,
                                 filter_intra=filter_intra, lr=lr,
                                 sb128=sb128)
        if res is None:
            raise RuntimeError(
                "native tile coder unavailable: the C runtime "
                "(oavif_tpu/av1/entropy) failed to build")
        if record and dec is not None:
            _store_dec(plan, dec)
        return res

    te = TileEncoder(tile_planes, qindex, bitdepth, speed, plan=plan,
                     u_ac_delta_q=u_ac_delta_q, dec=dec,
                     screen_tools=screen_tools, filter_intra=filter_intra,
                     lr=lr, sb128=sb128)
    payload = te.encode()
    if record and dec is not None:
        _store_dec(plan, dec)
    return payload, [r.copy() for r in te.recon], te.blocks


def encode_frame_planes(
    planes: List[np.ndarray],
    qindex: int,
    bitdepth: int = 8,
    speed: int = 9,
    tile_cols_log2: int = 0,
    tile_rows_log2: int = 0,
    max_threads: int = 1,
    u_ac_delta_q: int = 0,
    screen_tools: bool = False,
    filter_intra: bool = False,
    lr=None,
    sb128: bool = False,
):
    """Encode YUV444 planes -> (list of tile payloads, padded recon planes,
    coded blocks).

    Tiles are AV1's parallel axis: each tile encodes as an isolated
    region, across host threads when max_threads > 1 (the native coder
    releases the GIL). Each tile's partition and mode search is planned on
    the device. OAVIF_TPU_PLANNER=0 turns the planner off (host search
    only), as in the reference."""
    h, w = planes[0].shape
    col_starts, row_starts = tile_grid(w, h, tile_cols_log2, tile_rows_log2)
    jobs = []
    bounds = []
    for r0, r1 in zip(row_starts[:-1], row_starts[1:]):
        for c0, c1 in zip(col_starts[:-1], col_starts[1:]):
            y0, y1 = r0 * 64, min(r1 * 64, h)
            x0, x1 = c0 * 64, min(c1 * 64, w)
            tile_planes = [
                np.ascontiguousarray(p[y0:y1, x0:x1]) for p in planes
            ]
            jobs.append((tile_planes, qindex, bitdepth, speed, u_ac_delta_q,
                         screen_tools, filter_intra, lr, sb128))
            bounds.append((y0, y1, x0, x1))

    if max_threads > 1 and len(jobs) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(max_threads, len(jobs))) as ex:
            results = list(ex.map(_encode_one_tile, jobs))
    else:
        results = [_encode_one_tile(j) for j in jobs]

    # assemble the PADDED mi-grid reconstruction: the loop filter operates
    # on the padded plane (the decoder filters the whole mi grid; edges in
    # the padding write into visible pixels). Callers crop to (h, w).
    mi_rows, mi_cols = 2 * ((h + 7) >> 3), 2 * ((w + 7) >> 3)
    recon = [np.zeros((mi_rows * 4, mi_cols * 4), dtype=np.int32)
             for _ in planes]
    payloads = []
    blocks = []
    for (payload, tile_recon, tile_blocks), (y0, y1, x0, x1) in zip(
        results, bounds
    ):
        payloads.append(payload)
        th, tw = tile_recon[0].shape
        for pi in range(len(planes)):
            recon[pi][y0 : y0 + th, x0 : x0 + tw] = tile_recon[pi]
        mi_r0, mi_c0 = y0 // 4, x0 // 4
        blocks += [(mi_r0 + b[0], mi_c0 + b[1]) + tuple(b[2:])
                   for b in tile_blocks]
    return payloads, recon, blocks
