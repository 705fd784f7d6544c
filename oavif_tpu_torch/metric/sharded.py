"""Width-sharded SSIMULACRA2 over ranks: the counterpart of
oavif_tpu/metric/sharded.py (the multi-device scoring leg).

The frame is split into equal column slices, one per rank of a group.
Per scale each rank builds its slice of the pyramid with the metric's
pyramid kernel; the Gaussian's horizontal pass needs 8 columns of each
neighbour, which ``parallel.halo_exchange`` brings in (zero at the frame's
two ends, the single-device blur's padding), and the blur kernel runs
with ``halo=8``, so each slice's blur planes are the single-device
kernel's columns bit for bit. The feature norms are frame means: each rank
sums its pixels with the norms kernel (float64), and ``parallel.psum``
adds the sums and the integer pixel counts over the group. Every rank
therefore computes the same score.

Slices are even at scale 0 (a 2x2 downsample then never straddles two
ranks). Once a scale's slice is narrower than 16 columns (2 x the blur
radius) the planes are gathered and the remaining small scales computed
whole on every rank, with the zero-padded blur. Like the reference, the
sharded metric always takes the radius-8 Gaussian, whatever
``OAVIF_METRIC_BLUR`` says.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import parallel
from .ssimulacra2 import (
    _KERNEL_RADIUS,
    _num_scales,
    features_from_sums,
    score_from_features,
    ssim2_blur,
    ssim2_norms,
    ssim2_pyramid,
)

R = _KERNEL_RADIUS


def halo_blur(img1: torch.Tensor, img2: torch.Tensor, group=None):
    """(mu1, s11, mu2, s22, s12) of this rank's (1, 3, h, w/n) XYB slices:
    the neighbours' 8 columns come in by ``halo_exchange`` (zero beyond the
    frame) and the blur kernel runs over them with ``halo=8``."""
    ext = parallel.halo_exchange(torch.cat([img1, img2]), R, group, "zero")
    ext1, ext2 = ext[:1], ext[1:]
    return ssim2_blur(ext1, None, R, R) + ssim2_blur(ext1, ext2, R, R)


def ssimulacra2_sharded_body(ref_slice: torch.Tensor,
                             dist_slice: torch.Tensor, h: int, w: int,
                             group=None) -> float:
    """One rank's part: ref/dist (h, w/n, 3) uint8 slices, on this rank's
    device, of the full (h, w) frames; the slices lie in group-rank order.
    Returns the frame's score (the same on every rank of ``group``)."""
    src1, src2 = ref_slice[None], dist_slice[None]
    sharded = True
    feats = []
    for s in range(_num_scales(h, w)):
        if s and sharded and src1.shape[-1] % 2:
            raise ValueError(f"sharded metric: odd slice width "
                             f"{src1.shape[-1]} at scale {s - 1}")
        lin1, img1 = ssim2_pyramid(src1)
        lin2, img2 = ssim2_pyramid(src2)
        if sharded and lin1.shape[-1] < 2 * R:
            # narrower than the halo: gather once, finish the small scales
            # whole on every rank (XYB is per pixel, so gathering it is
            # converting the gathered linear RGB)
            lin1, img1, lin2, img2 = parallel.all_gather_width(
                torch.cat([lin1, img1, lin2, img2]), group).split(1)
            sharded = False
        if sharded:
            mu1, s11, mu2, s22, s12 = halo_blur(img1, img2, group)
        else:
            mu1, s11 = ssim2_blur(img1, None, R)
            mu2, s22, s12 = ssim2_blur(img1, img2, R)
        sums = ssim2_norms(img1, mu1, s11, img2, mu2, s22, s12)
        npix = img2.shape[2] * img2.shape[3]
        if sharded:
            sums = parallel.psum(sums, group)
            npix = int(parallel.psum(
                torch.tensor([npix], dtype=torch.int64, device=sums.device),
                group))
        feats.append(features_from_sums(sums, npix))
        src1, src2 = lin1, lin2
    return float(score_from_features(torch.stack(feats, 1))[0])


def _check_split(ref: np.ndarray, dist: np.ndarray, n: int) -> None:
    """The reference's contract: equal frames whose width splits into ``n``
    slices of an even width."""
    w = ref.shape[1]
    if ref.shape != dist.shape or w % n or (w // n) % 2:
        raise ValueError(f"sharded metric: frames {ref.shape} and "
                         f"{dist.shape} do not split into {n} even slices")


def rank_slices(ref: np.ndarray, dist: np.ndarray, index: int, n: int,
                device: torch.device):
    """Slice ``index`` of ``n`` of the (h, w, 3) uint8 frames, on
    ``device``."""
    _check_split(ref, dist, n)
    ws = ref.shape[1] // n
    cols = slice(index * ws, (index + 1) * ws)
    return [torch.from_numpy(np.ascontiguousarray(a[:, cols], np.uint8))
            .to(device) for a in (ref, dist)]


def score_shard(rk: parallel.Rank, ref: np.ndarray,
                dist: np.ndarray) -> float:
    """Rank body of ``compute_ssimulacra2_sharded``: this rank's slice of
    the (h, w, 3) uint8 frames, scored over the default group."""
    ref_s, dist_s = rank_slices(ref, dist, rk.rank, rk.world, rk.device)
    return ssimulacra2_sharded_body(ref_s, dist_s, *ref.shape[:2])


def compute_ssimulacra2_sharded(ref_rgb8, dist_rgb8, world: int, *,
                                backend: str = "gloo", device=None,
                                timeout_s: float = 120.0) -> float:
    """Score two (H, W, 3) uint8 frames with the width split over
    ``world`` spawned ranks (``parallel.spawn``); W must split into
    ``world`` even slices. Every rank must return the same score, which is
    returned."""
    ref = np.ascontiguousarray(ref_rgb8, np.uint8)
    dist = np.ascontiguousarray(dist_rgb8, np.uint8)
    _check_split(ref, dist, world)
    results, _ = parallel.spawn(score_shard, world, args=(ref, dist),
                                backend=backend, device=device,
                                timeout_s=timeout_s)
    scores = set(results)
    if len(scores) != 1:
        raise AssertionError(f"sharded metric: ranks disagree: {scores}")
    return scores.pop()
