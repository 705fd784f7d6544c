"""Checks and timings of the multi-device leg, as rank bodies for
``parallel.spawn``. The CPU tests run them on gloo ranks and
``chip_smoke.py`` on ranks that share the card; they live in the package
because a spawned rank imports the function it runs by name, and a test
file would pull in JAX. Each body runs the path it checks once with its
launches counted apart (``kernels.counting``, returned as ``launches``),
then its checks and timings, whose launches are not counted.
"""

from __future__ import annotations

import contextlib
import time
import zlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import parallel
from .av1 import restoration_sharded as WS
from .av1.restoration import _coeffs7
from .kernels import counting
from .metric import sharded as MS
from .metric.ssimulacra2 import ssim2_blur, ssim2_blur_plain, ssim2_pyramid

R = MS.R


def collectives(rk: parallel.Rank, x: np.ndarray, r: int) -> dict:
    """Every data-moving collective of ``parallel`` on this rank's slice
    of ``x`` (cut into equal slices along its last axis, one per rank of
    the default group): ``zero`` and ``edge`` (``halo_exchange`` with
    ``r`` columns), ``gather`` (``all_gather_width``), ``broadcast`` (rank
    0's slice) and ``psum``, as numpy, to hold against slices of x."""
    ws = x.shape[-1] // rk.world
    local = torch.from_numpy(
        x[..., rk.rank * ws : (rk.rank + 1) * ws].copy()).to(rk.device)
    out = {border: parallel.halo_exchange(local, r, None, border)
           for border in ("zero", "edge")}
    out.update(gather=parallel.all_gather_width(local),
               broadcast=parallel.broadcast(local), psum=parallel.psum(local))
    return {k: v.cpu().numpy() for k, v in out.items()}


@contextlib.contextmanager
def collective_clock():
    """Yields a dict whose ``s`` adds up the host wall time of the
    collectives' all_reduce calls made inside the block. Each timed call
    synchronises the card before and after it, so the time is the
    collective's alone and the block runs slower than it would untimed."""
    clock = {"s": 0.0}
    untimed = parallel._all_reduce

    def timed(t: torch.Tensor, group) -> None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        untimed(t, group)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        clock["s"] += time.perf_counter() - t0

    parallel._all_reduce = timed
    try:
        yield clock
    finally:
        parallel._all_reduce = untimed


def metric_rank(rk: parallel.Rank, ref: np.ndarray, dist_rgb8: np.ndarray,
                size: Optional[int] = None, reps: int = 0) -> Optional[dict]:
    """The width-sharded metric of the (h, w, 3) uint8 frames over the
    first ``size`` ranks (all by default; every rank calls this, and those
    outside return None). Returns ``score`` and the ``launches`` of that
    one score; ``differ``, how many elements of this slice's scale-0 halo
    blur (the body's ``halo_blur``) are not bit for bit the columns of the
    single-device blur kernel over the whole frame; ``plain_err``, the
    largest difference of that halo blur from its plain version on the
    same extended slice. With ``reps``: ``ms``, host wall per score over
    ``reps`` scores; ``clocked_ms``, the same with every all_reduce timed
    alone (``collective_clock``); and ``allreduce_ms``, the part of
    ``clocked_ms`` inside all_reduce."""
    size = size or rk.world
    group = None if size == rk.world else dist.new_group(list(range(size)))
    if rk.rank >= size:
        return None
    dev = rk.device
    ref_s, dist_s = MS.rank_slices(ref, dist_rgb8, rk.rank, size, dev)
    h, w = ref.shape[:2]
    out = {"launches": {}}
    with counting(out["launches"]):
        out["score"] = MS.ssimulacra2_sharded_body(ref_s, dist_s, h, w, group)

    img1 = ssim2_pyramid(ref_s[None])[1]
    img2 = ssim2_pyramid(dist_s[None])[1]
    got = MS.halo_blur(img1, img2, group)
    ext = parallel.halo_exchange(torch.cat([img1, img2]), R, group, "zero")
    plain = (ssim2_blur_plain(ext[:1], None, R, R)
             + ssim2_blur_plain(ext[:1], ext[1:], R, R))
    full1 = ssim2_pyramid(torch.from_numpy(ref).to(dev)[None])[1]
    full2 = ssim2_pyramid(torch.from_numpy(dist_rgb8).to(dev)[None])[1]
    full = ssim2_blur(full1, None, R) + ssim2_blur(full1, full2, R)
    ws = w // size
    cols = slice(rk.rank * ws, (rk.rank + 1) * ws)
    out["differ"] = sum(
        int((g.view(torch.int32)
             != f[..., cols].contiguous().view(torch.int32)).sum())
        for g, f in zip(got, full))
    out["plain_err"] = max(float((g - p).abs().max())
                           for g, p in zip(got, plain))
    if reps:
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else (lambda: None))

        def per_score_ms() -> float:
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                MS.ssimulacra2_sharded_body(ref_s, dist_s, h, w, group)
            sync()
            return (time.perf_counter() - t0) / reps * 1e3

        out["ms"] = per_score_ms()
        with collective_clock() as clock:
            out["clocked_ms"] = per_score_ms()
        out["allreduce_ms"] = clock["s"] / reps * 1e3
    return out


def wiener_rank(rk: parallel.Rank, cdef_planes, deblk_planes, vis_h: int,
                vis_w: int, taps_per_plane, bitdepth: int) -> dict:
    """``apply_wiener_sharded`` over the default group, once, with its
    ``launches``. Rank 0 returns the ``planes``, every rank a ``crc`` (crc32
    of each plane: all ranks must hold the same planes) and
    ``plain_equal``: whether its slice of each filtered plane equals the
    plain version on the same exchanged slice."""
    out = {"launches": {}}
    with counting(out["launches"]):
        planes = WS.apply_wiener_sharded(cdef_planes, deblk_planes, vis_h,
                                         vis_w, taps_per_plane, bitdepth,
                                         None, rk.device)
    out["crc"] = [zlib.crc32(p.tobytes()) for p in planes]
    if rk.rank == 0:
        out["planes"] = planes
    ws = vis_w // rk.world
    cols = slice(rk.rank * ws, (rk.rank + 1) * ws)
    equal = True
    for p, taps in taps_per_plane.items():
        if taps is None:
            continue
        ext = WS.shard_planes(cdef_planes[p], deblk_planes[p], vis_h, vis_w,
                              None, rk.device)
        plain = WS.wiener_bands_plain(ext[0], ext[1], _coeffs7(*taps[0:3]),
                                      _coeffs7(*taps[3:6]), bitdepth)
        equal &= np.array_equal(planes[p][:, cols], plain.cpu().numpy())
    out["plain_equal"] = bool(equal)
    return out

