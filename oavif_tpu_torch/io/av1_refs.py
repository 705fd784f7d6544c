"""The eight reference frame slots of the port's AV1 decoder (spec 7.20
reference frame update, 7.21 reference frame loading).

Two views of one state, filled at two times:

- ``RefHeaders``: what a frame header reads of the frames before it, kept
  while ``avif.parse_av1`` walks the OBUs: each slot's order hint,
  upscaled size and render size, loop filter deltas, segmentation
  FeatureData, global motion parameters and film grain parameters;
- ``RefFrames``: what the tile decode reads, kept while ``avif.decode_av1``
  decodes the frames in order: each slot's frame after deblocking, CDEF,
  superres and loop restoration (before film grain), with its bit depth,
  subsampling and size, and the CDFs it saved at its end (those of its
  ``context_update_tile_id`` tile, or its starting ones under
  ``disable_frame_end_update_cdf``), their adaptation counters cleared,
  and its frame type.
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

    def reset(self) -> None:
        """A shown key frame empties every slot (RefValid, RefOrderHint)."""
        self.valid = 0
        self.order_hint = [0] * 8

    def update(self, fh) -> None:
        """The reference frame update process for the header fields: each
        slot in ``refresh_frame_flags`` takes the frame's."""
        for i in range(8):
            if not fh.refresh_frame_flags >> i & 1:
                continue
            self.valid |= 1 << i
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


class RefFrames:
    def __init__(self) -> None:
        self.slots: List[Optional[RefFrame]] = [None] * 8

    def update(self, refresh: int, frame: RefFrame) -> None:
        for i in range(8):
            if refresh >> i & 1:
                self.slots[i] = frame


def clear_counters(cdfs: List[np.ndarray], rows: List[int]) -> None:
    """Zero the adaptation counter of every CDF row in place: each array
    is rows of ``rows[k]`` entries, the symbols' inverse CDF ending in 0
    and then the counter (rows that code fewer symbols than their width,
    as tx_size's first category, end in zeros past the counter)."""
    for a, n in zip(cdfs, rows):
        r = a.reshape(-1, n)
        first0 = np.argmax(r == 0, axis=1)
        r[np.arange(r.shape[0]), np.minimum(first0 + 1, n - 1)] = 0
