"""Width-sharded Wiener loop restoration over ranks: the counterpart of
oavif_tpu/av1/restoration_sharded.py (the encode side of the multi-device
dry run).

Each rank filters its column slice of the frame. The 7-tap horizontal
pass reaches 3 columns into each neighbour's slice: ``parallel.
halo_exchange`` brings them in once per plane, for the CDEF and the
deblocked planes together, with edge replication at the frame's two ends
(the filter's clamp of x to the frame). Rows are not sharded, so the
stripe sandwich (out-of-stripe rows read the pre-CDEF deblocked frame)
stays local. The filter is the hand-written kernel ``wiener_bands``
(``csrc/wiener.cu``), one block per stripe band and column tile; its plain
version ``wiener_bands_plain`` repeats the reference's int32 operations,
and ``wiener_bands_simple`` launches the first Wiener kernel, kept as the
yardstick (on no path).
All arithmetic is int32, so the result equals the host filter
(``restoration.apply_wiener``) bit for bit. As in the reference, one tap
set filters the whole plane.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import parallel
from ..device import resolve_device
from ..kernels import launch
from .restoration import FILTER_BITS, _band_rows, _coeffs7

HALO = 3
_ROUND0, _ROUND1 = 3, 11


def wiener_bands_plain(cdef: torch.Tensor, deblk: torch.Tensor,
                       vf: Sequence[int], hf: Sequence[int],
                       bitdepth: int) -> torch.Tensor:
    """cdef, deblk (h, w + 6) int32: a width slice of the frame's CDEF and
    deblocked planes with 3 halo columns each side -> the Wiener-filtered
    slice (h, w) int32, band by band (the reference's filter_plane)."""
    h, we = cdef.shape
    w = we - 2 * HALO
    offset = 1 << (bitdepth + FILTER_BITS - _ROUND0 - 1)
    limit = (1 << (bitdepth + 1 + FILTER_BITS - _ROUND0)) - 1
    hi = (1 << bitdepth) - 1
    out = torch.empty((h, w), dtype=torch.int32, device=cdef.device)
    for r0, r1, ss, se in _band_rows(0, h):
        bh = r1 - r0
        rows = torch.arange(r0 - 3, r1 + 3, device=cdef.device).clamp(0, h - 1)
        above, below = rows < ss, rows > se
        rsel = torch.where(above, rows.clamp_min(ss - 2),
                           torch.where(below, rows.clamp_max(se + 2), rows))
        src = torch.where((above | below)[:, None], deblk[rsel], cdef[rsel])
        s = torch.zeros((bh + 6, w), dtype=torch.int32, device=cdef.device)
        for t in range(7):
            s += int(hf[t]) * src[:, t : t + w]
        inter = ((s + (1 << (_ROUND0 - 1))) >> _ROUND0).clamp(
            -offset, limit - offset)
        s2 = torch.zeros((bh, w), dtype=torch.int32, device=cdef.device)
        for t in range(7):
            s2 += int(vf[t]) * inter[t : t + bh]
        out[r0:r1] = ((s2 + (1 << (_ROUND1 - 1))) >> _ROUND1).clamp(0, hi)
    return out


@functools.lru_cache(maxsize=None)
def _taps_tensor(vf: tuple, hf: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor([*vf, *hf], dtype=torch.int32, device=device)


def _launch_wiener(wrapper, cdef: torch.Tensor, deblk: torch.Tensor,
                   vf: Sequence[int], hf: Sequence[int],
                   bitdepth: int) -> torch.Tensor:
    """Check the CUDA planes and taps, and launch ``wrapper``'s C entry
    (named like the wrapper; the two Wiener entries share their
    arguments)."""
    name = wrapper.__name__
    for t in (cdef, deblk):
        if (t.device != cdef.device or t.device.type != "cuda"
                or t.dtype != torch.int32 or t.dim() != 2
                or not t.is_contiguous()):
            raise ValueError(f"{name}: cdef and deblk must be contiguous "
                             "2-D int32 tensors on one CUDA device")
    if cdef.shape != deblk.shape or cdef.shape[1] <= 2 * HALO:
        raise ValueError(f"{name}: planes {tuple(cdef.shape)} and "
                         f"{tuple(deblk.shape)}")
    if bitdepth not in (8, 10) or len(vf) != 7 or len(hf) != 7:
        raise ValueError(f"{name}: 8 or 10 bits and two 7-tap filters")
    h, we = cdef.shape
    out = torch.empty((h, we - 2 * HALO), dtype=torch.int32,
                      device=cdef.device)
    taps = _taps_tensor(tuple(int(v) for v in vf), tuple(int(v) for v in hf),
                        cdef.device)
    launch(wrapper, name, cdef, cdef.data_ptr(), deblk.data_ptr(), h,
           we - 2 * HALO, bitdepth, taps.data_ptr(), out.data_ptr())
    return out


def wiener_bands(cdef: torch.Tensor, deblk: torch.Tensor,
                 vf: Sequence[int], hf: Sequence[int],
                 bitdepth: int) -> torch.Tensor:
    """wiener_bands_plain's result; on CUDA tensors from the Wiener kernel
    (counted in ``wiener_bands.launches``), on CPU tensors from the plain
    version."""
    if cdef.device.type == "cpu":
        return wiener_bands_plain(cdef, deblk, vf, hf, bitdepth)
    return _launch_wiener(wiener_bands, cdef, deblk, vf, hf, bitdepth)


wiener_bands.launches = 0


def wiener_bands_simple(cdef: torch.Tensor, deblk: torch.Tensor,
                        vf: Sequence[int], hf: Sequence[int],
                        bitdepth: int) -> torch.Tensor:
    """``wiener_bands`` through the first Wiener kernel, which the source
    keeps as the yardstick (both passes through shared memory, one thread
    per element); all arithmetic is int32, so the two give the same bits.
    No path calls it; the card tests and ``chip_smoke.py`` hold
    ``wiener_bands`` to it and time the two in one call. Counted in
    ``wiener_bands_simple.launches``."""
    if cdef.device.type == "cpu":
        return wiener_bands_plain(cdef, deblk, vf, hf, bitdepth)
    return _launch_wiener(wiener_bands_simple, cdef, deblk, vf, hf, bitdepth)


wiener_bands_simple.launches = 0


def shard_planes(cdef: np.ndarray, deblk: np.ndarray, vis_h: int,
                 vis_w: int, group=None, device=None) -> torch.Tensor:
    """(2, vis_h, w/n + 6) int32 on the device: this rank's column slice of
    the visible CDEF and deblocked planes with the neighbours' 3 columns
    each side (this rank's edge column repeated at the frame's ends)."""
    i, n = parallel.group_rank(group)
    if vis_w % n:
        raise ValueError(f"sharded Wiener: width {vis_w} does not split "
                         f"into {n} slices")
    ws = vis_w // n
    cols = slice(i * ws, (i + 1) * ws)
    dev = resolve_device(device)
    local = torch.from_numpy(np.stack([
        np.ascontiguousarray(p[:vis_h, cols], np.int32)
        for p in (cdef, deblk)])).to(dev)
    return parallel.halo_exchange(local, HALO, group, "edge")


def apply_wiener_sharded(cdef_planes: List[np.ndarray],
                         deblk_planes: List[np.ndarray], vis_h: int,
                         vis_w: int, taps_per_plane: Dict[int, Optional[tuple]],
                         bitdepth: int, group=None,
                         device=None) -> List[np.ndarray]:
    """Filter every plane with its 6-tap Wiener set (v0, v1, v2, h0, h1,
    h2), or pass it through where the set is None, width-sharded over the
    ranks of ``group`` (every rank calls this with the whole planes and
    filters its slice). Returns the whole filtered planes on every rank,
    equal to the host filter bit for bit."""
    out = []
    for p, cdef in enumerate(cdef_planes):
        taps = taps_per_plane.get(p)
        if taps is None:
            out.append(np.asarray(cdef[:vis_h, :vis_w]).copy())
            continue
        ext = shard_planes(cdef, deblk_planes[p], vis_h, vis_w, group, device)
        local = wiener_bands(ext[0], ext[1], _coeffs7(*taps[0:3]),
                             _coeffs7(*taps[3:6]), bitdepth)
        out.append(parallel.all_gather_width(local, group).cpu().numpy())
    return out

