"""The eight reference frame slots of the port's AV1 decoder (spec 7.20
reference frame update, 7.21 reference frame loading).

Two views of one state, filled at two times:

- ``RefHeaders``: what a frame header reads of the frames before it, kept
  while ``avif.parse_av1`` walks the OBUs: each slot's frame type, frame
  id, order hint, upscaled size and render size, loop filter deltas,
  segmentation FeatureData, global motion parameters and film grain
  parameters;
- ``RefFrames``: what the tile decode reads, kept while ``avif.decode_av1``
  decodes the frames in order: each slot's frame after deblocking, CDEF,
  superres and loop restoration (before film grain), with its bit depth,
  subsampling and size, and the CDFs it saved at its end (those of its
  ``context_update_tile_id`` tile, or its starting ones under
  ``disable_frame_end_update_cdf``), their adaptation counters cleared,
  its frame type, and what motion field estimation reads of it (spec
  7.19-7.21: its order hint, the order hints of its references
  ``SavedOrderHints``, its size in 4x4 units and its saved MVs and their
  references per 8x8), and its segment ids per 4x4 (``SavedSegmentIds``,
  which a later frame of that size may keep or predict its own from).

``motion_field`` picks the frames a frame projects (spec 7.9.1) and packs
what ``av1_decode_frame`` needs to project them; ``set_frame_refs`` is
the reference choice of frame_refs_short_signaling (spec 7.8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

_GM_IDENTITY = ((0, 0, 1 << 16, 0, 0, 1 << 16),) * 7


@dataclass
class RefHeaders:
    valid: int = 0  # RefValid, a bit per slot
    order_hint: List[int] = field(default_factory=lambda: [0] * 8)
    size: List[Tuple[int, int]] = field(default_factory=lambda: [(0, 0)] * 8)
    render: List[Tuple[int, int]] = field(
        default_factory=lambda: [(0, 0)] * 8)
    lf_ref_deltas: List[Tuple[int, ...]] = field(
        default_factory=lambda: [(1, 0, 0, 0, -1, 0, -1, -1)] * 8)
    lf_mode_deltas: List[Tuple[int, int]] = field(
        default_factory=lambda: [(0, 0)] * 8)
    segmentation: List[Optional[list]] = field(
        default_factory=lambda: [None] * 8)
    gm_params: List[tuple] = field(default_factory=lambda: [_GM_IDENTITY] * 8)
    grain: list = field(default_factory=lambda: [None] * 8)
    frame_type: List[int] = field(default_factory=lambda: [0] * 8)
    frame_id: List[int] = field(default_factory=lambda: [0] * 8)

    # the slots any frame has refreshed, which frame_refs_short_signaling
    # needs all of (dav1d reads the order hint of every slot's frame)
    filled: int = 0

    def reset(self) -> None:
        """A shown key frame empties every slot (RefValid, RefOrderHint)."""
        self.valid = 0
        self.order_hint = [0] * 8

    def mark(self, cur: int, id_len: int, delta_len: int) -> None:
        """mark_ref_frames: after current_frame_id ``cur``, a slot whose
        frame id lies outside the window of the last 1 << ``delta_len``
        ids before it is invalid."""
        d = 1 << delta_len
        for i in range(8):
            fid = self.frame_id[i]
            if (fid > cur or fid < cur - d) if cur > d else \
                    cur < fid < (1 << id_len) + cur - d:
                self.valid &= ~(1 << i)

    def update(self, fh) -> None:
        """The reference frame update process for the header fields: each
        slot in ``refresh_frame_flags`` takes the frame's; a
        show_existing_frame of a key frame loads its slot and refreshes
        every slot with it (spec 7.21, 7.20)."""
        if fh.show_existing is not None:
            src = fh.show_existing
            for i in range(8):
                if fh.refresh_frame_flags >> i & 1:
                    self.valid |= 1 << i
                    self.filled |= 1 << i
                    for name in ("order_hint", "size", "render",
                                 "lf_ref_deltas", "lf_mode_deltas",
                                 "segmentation", "gm_params", "grain",
                                 "frame_type", "frame_id"):
                        getattr(self, name)[i] = getattr(self, name)[src]
            return
        for i in range(8):
            if not fh.refresh_frame_flags >> i & 1:
                continue
            self.valid |= 1 << i
            self.filled |= 1 << i
            self.frame_type[i] = fh.frame_type
            self.frame_id[i] = fh.frame_id
            self.order_hint[i] = fh.order_hint
            self.size[i] = (fh.width, fh.height)
            self.render[i] = fh.render_size
            self.lf_ref_deltas[i] = fh.lf_ref_deltas
            self.lf_mode_deltas[i] = fh.lf_mode_deltas
            self.segmentation[i] = fh.segmentation
            self.gm_params[i] = fh.gm_params
            self.grain[i] = fh.grain_params


@dataclass
class RefFrame:
    """One slot's decoded frame: the planes (int32, the buffers the decoder
    wrote, of ``stride`` columns) after the post-filters and before film
    grain, their bit depth and subsampling, the upscaled width and the
    height, and the saved CDFs (one flat uint16 array per ``_CDF_ORDER``
    entry)."""

    planes: List[np.ndarray]
    bit_depth: int
    ss: Tuple[int, int]
    width: int
    height: int
    cdfs: List[np.ndarray]
    frame_type: int = 0
    # motion field estimation's view (spec 7.20 SavedOrderHints,
    # RefMiRows/RefMiCols, SavedRefFrames/SavedMvs): the frame's order
    # hint and its references' (LAST..ALTREF; zeros for a key frame), its
    # MiRows and MiCols, and per 8x8 the reference (int8, 0 for none) and
    # MV (int16 row, column) that ``av1_decode_frame`` stored
    order_hint: int = 0
    saved_order_hints: Tuple[int, ...] = (0,) * 7
    mi_rows: int = 0
    mi_cols: int = 0
    mf_refs: Optional[np.ndarray] = None
    mf_mvs: Optional[np.ndarray] = None
    # SavedSegmentIds (spec 7.20): the frame's segment id per 4x4 (uint8,
    # MiRows x MiCols; None for zeros), which a later frame of that size
    # predicts its own from
    seg_ids: Optional[np.ndarray] = None
    # the frame's header pack (``avif._HDR_FIELDS``), which film grain
    # reads where a show_existing_frame outputs the slot
    hdr: Optional[np.ndarray] = None


class RefFrames:
    def __init__(self) -> None:
        self.slots: List[Optional[RefFrame]] = [None] * 8

    def update(self, refresh: int, frame: RefFrame) -> None:
        """Each slot in ``refresh`` takes ``frame`` (spec 7.20; a
        show_existing_frame of a key frame passes its slot's frame and
        every slot, 7.21)."""
        for i in range(8):
            if refresh >> i & 1:
                self.slots[i] = frame


MAX_FRAME_DISTANCE = 31
MFMV_STACK_SIZE = 3
LAST, LAST2, LAST3, GOLDEN, BWDREF, ALTREF2, ALTREF = range(7)


def set_frame_refs(last: int, gold: int, slot_hints: List[int], cur: int,
                   bits: int) -> List[int]:
    """set_frame_refs (spec 7.8): the slots of LAST..ALTREF of a frame of
    order hint ``cur`` under frame_refs_short_signaling, from the coded
    slots of LAST (``last``) and GOLDEN (``gold``) and the order hints of
    the eight slots (``bits`` OrderHintBits). ALTREF takes the latest
    backward slot, BWDREF and then ALTREF2 the earliest backward ones,
    LAST2, LAST3, BWDREF, ALTREF2 and ALTREF where still unset the latest
    forward ones, and any reference still unset the earliest slot; a slot
    taken is not taken again."""
    mid = 1 << (bits - 1)

    def rel(a: int, b: int) -> int:
        diff = a - b
        return (diff & (mid - 1)) - (diff & mid)

    hints = [mid + rel(h, cur) for h in slot_hints]
    refs = [-1] * 7
    refs[LAST], refs[GOLDEN] = last, gold
    used = [False] * 8
    used[last] = used[gold] = True

    def find(backward: bool, latest: bool) -> int:
        ref = -1
        for i, h in enumerate(hints):
            if used[i] or (h >= mid) != backward:
                continue
            if ref < 0 or (h >= hints[ref] if latest else h < hints[ref]):
                ref = i
        return ref

    for r, backward, latest in ((ALTREF, True, True), (BWDREF, True, False),
                                (ALTREF2, True, False)):
        ref = find(backward, latest)
        if ref >= 0:
            refs[r] = ref
            used[ref] = True
    for r in (LAST2, LAST3, BWDREF, ALTREF2, ALTREF):
        if refs[r] < 0:
            ref = find(False, True)
            if ref >= 0:
                refs[r] = ref
                used[ref] = True
    earliest = min(range(8), key=lambda i: (hints[i], i))
    return [earliest if r < 0 else r for r in refs]


def motion_field(fh, seq, slots: List[Optional[RefFrame]]
                 ) -> Tuple[np.ndarray, List[RefFrame]]:
    """``av1_decode_frame``'s int32 ``mf`` pack for the frame of header
    ``fh`` in sequence ``seq`` (see av1_decode.c) and the frames it
    projects, in order.

    The store mask holds each reference before the frame in order (spec
    7.19 keeps only MVs toward those, libaom's ``ref_frame_side`` 0). Under
    use_ref_frame_mvs the projections follow spec 7.9.1 as libaom's
    ``av1_setup_motion_field`` and dav1d's ``dav1d_refmvs_init_frame`` run
    them: LAST unless its saved ALTREF hint is the current GOLDEN's (an
    overlay), BWDREF and ALTREF2 where they come after the frame, ALTREF
    likewise and LAST2 while fewer than ``MFMV_STACK_SIZE`` have run (LAST
    counts whether it ran or not). A source projects only where it is an
    inter or switch frame (a key or intra-only frame stores no MV) of the
    frame's MiRows and MiCols, else it is passed over and not counted. A
    key or intra-only frame projects nothing and stores no MV."""
    from .avif import _relative_dist

    def rel(a: int, b: int) -> int:
        return _relative_dist(seq, a, b)

    pack = np.zeros(10 + 10 * MFMV_STACK_SIZE, dtype=np.int32)
    if not fh.frame_type & 1:  # FrameIsIntra: a key or intra-only frame
        return pack, []
    cur, hints = fh.order_hint, fh.ref_order_hints
    pack[0] = sum(1 << (r + 1) for r, h in enumerate(hints)
                  if rel(h, cur) < 0)
    pack[3:10] = [rel(cur, h) for h in hints]
    sources: List[RefFrame] = []

    def project(r: int, sign: int) -> bool:
        src = slots[fh.ref_frame_idx[r]]
        if not src.frame_type & 1 or (src.mi_rows, src.mi_cols) != (
                fh.mi_rows, fh.mi_cols):
            return False
        num = rel(src.order_hint, cur) * sign
        p = pack[10 + 10 * len(sources):20 + 10 * len(sources)]
        p[0], p[1] = sign, num
        if abs(num) <= MAX_FRAME_DISTANCE:
            for rf, h in enumerate(src.saved_order_hints, 1):
                d = rel(src.order_hint, h)
                p[2 + rf] = d if 0 < d <= MAX_FRAME_DISTANCE else 0
        sources.append(src)
        return True

    if fh.use_ref_frame_mvs:
        stamp = MFMV_STACK_SIZE - 1
        if slots[fh.ref_frame_idx[LAST]].saved_order_hints[ALTREF] \
                != hints[GOLDEN]:
            project(LAST, -1)
        stamp -= 1
        for r in (BWDREF, ALTREF2, ALTREF):
            if rel(hints[r], cur) > 0 and (r != ALTREF or stamp >= 0) \
                    and project(r, 1):
                stamp -= 1
        if stamp >= 0:
            project(LAST2, -1)
    pack[1] = len(sources)
    return pack, sources


def clear_counters(cdfs: List[np.ndarray], rows: List[int]) -> None:
    """Zero the adaptation counter of every CDF row in place: each array
    is rows of ``rows[k]`` entries, the symbols' inverse CDF ending in 0
    and then the counter (rows that code fewer symbols than their width,
    as tx_size's first category, end in zeros past the counter)."""
    for a, n in zip(cdfs, rows):
        r = a.reshape(-1, n)
        first0 = np.argmax(r == 0, axis=1)
        r[np.arange(r.shape[0]), np.minimum(first0 + 1, n - 1)] = 0
