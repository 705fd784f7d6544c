"""Driver entry points of the port: the counterpart of the repository's
``__graft_entry__.py`` (``entry``, ``dryrun_multichip``).

``entry`` returns the device step of the target-quality search, scoring a
batch of candidates against one reference (the metric kernels), with
example arguments. ``dryrun_multichip`` runs the reference's multi-device
dry run on spawned ranks (``parallel.spawn``) laid out as its ``(q,
tile)`` mesh: each rank plans its tile with the planner kernel and the
tile group sums a plan checksum; each q rank scores its share of the
candidates; rank 0 then encodes the frame on the host with the sharded
plans seeded into the planner cache and checks the bytes against the
unsharded encode, and the ranks score the recon with the width-sharded
metric and filter it with the width-sharded Wiener filter. It checks what
the reference asserts, raises where that fails, and returns what it
computed so that callers can compare it with other implementations.
"""

from __future__ import annotations

import contextlib
import functools
import os
import zlib
from typing import Optional

import numpy as np
import torch

from . import parallel
from .av1 import encode as EN
from .av1 import frame as FR
from .av1.cdef import cdef_frame
from .av1.device_stage import DeviceLevels
from .av1.encode_tpu import FramePlanner, plan_device, unpack_plan
from .av1.entropy.fast import tile_encode_native
from .av1.loopfilter import loop_filter_frame
from .av1.mux import mux_avif
from .av1.obu import (FrameConfig, SequenceConfig, assemble_av1_stream,
                      tile_grid)
from .av1.restoration import apply_wiener, count_units, unit_size
from .av1.restoration_sharded import apply_wiener_sharded
from .av1.yuv import rgb_to_yuv444, yuv444_to_rgb
from .device import resolve_device
from .kernels import counting
from .metric.sharded import ssimulacra2_sharded_body
from .metric.ssimulacra2 import (compute_ssimulacra2,
                                 ssimulacra2_from_precomputed,
                                 ssimulacra2_precompute_ref)

TILE_PX = 128  # the reference's tiles: 2x2 superblocks
QINDEX = 60
BITDEPTH = 8
UV_DQ = 24
LR_TAPS = {0: (3, -7, 15, -2, 4, 28), 1: (0, -9, 25, 0, 4, 18),
           2: (0, 6, 12, 0, -11, 40)}


def _test_image(h=128, w=128, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack(
        [
            128 + 100 * np.sin(xx / 17.0) * np.cos(yy / 23.0),
            120 + 80 * np.cos(xx / 29.0),
            100 + 90 * np.sin((xx + yy) / 31.0),
        ],
        -1,
    )
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def entry(device=None):
    """(step, args): ``step(ref_rgb8, dist_batch)`` scores a (N, H, W, 3)
    uint8 batch of candidates against one (H, W, 3) reference, the device
    inner loop of the target-quality search; args are the test image and
    two copies of it."""
    dev = resolve_device(device)

    def step(ref_rgb8, dist_batch):
        pyr = ssimulacra2_precompute_ref(ref_rgb8, dev)
        return ssimulacra2_from_precomputed(pyr, dist_batch)

    ref = torch.from_numpy(_test_image()).to(dev)
    return step, (ref, torch.stack([ref, ref]))


def mesh_dims(n: int):
    """The reference's (q_dim, t_dim) for n devices."""
    q_dim = 2 if (n % 2 == 0 and n >= 4) else 1
    return q_dim, n // q_dim


def _tiles(planes, w: int, h: int, t_dim: int):
    """The frame's tile columns as the encoder cuts them: (tile_cols_log2,
    per tile [y, u, v] planes)."""
    tcl = int(np.log2(t_dim)) if t_dim > 1 else 0
    if 1 << tcl != t_dim:
        raise ValueError(f"dry run: {t_dim} tiles is not a power of two")
    cols, _ = tile_grid(w, h, tcl, 0)
    bounds = [(c0 * 64, min(c1 * 64, w)) for c0, c1 in zip(cols, cols[1:])]
    if len(bounds) != t_dim or len({x1 - x0 for x0, x1 in bounds}) != 1:
        raise ValueError(f"dry run: a {w}-px frame does not cut into "
                         f"{t_dim} equal tile columns")
    return tcl, [[np.ascontiguousarray(p[:, x0:x1]) for p in planes]
                 for x0, x1 in bounds]


def _frame_encode(planes, tcl: int, tile_planes=None, seed_plans=None):
    """The port's frame encode (tiles, loop filter, CDEF, OBUs, mux) at
    QINDEX, with ``seed_plans`` (one per tile) in the planner cache first.
    Returns (AVIF bytes, the recon as RGB8, plans served from the seeds)."""
    FR.reset_planners()
    seeded = []
    for tp, plan in zip(tile_planes or [], seed_plans or []):
        fp = FR.get_planner(tp, BITDEPTH, 13, 0)
        fp.seed_plan(QINDEX, plan)
        seeded.append(fp)
    h, w = planes[0].shape
    payloads, recon, blocks = FR.encode_frame_planes(
        [p.copy() for p in planes], QINDEX, BITDEPTH, speed=9,
        tile_cols_log2=tcl, u_ac_delta_q=UV_DQ)
    flv = EN._filter_level(QINDEX)
    if flv:
        loop_filter_frame(recon, blocks, (flv,) * 4, bitdepth=BITDEPTH,
                          visible=(h, w))
    strengths, damping = EN._pick_cdef(planes, recon, blocks, QINDEX,
                                       BITDEPTH, (h, w))
    if any(strengths):
        cdef_frame(recon, blocks, strengths, damping, BITDEPTH)
    recon = [p[:h, :w] for p in recon]
    seq = SequenceConfig(width=w, height=h, bit_depth=BITDEPTH,
                         enable_cdef=True)
    frame = FrameConfig(width=w, height=h, base_q_idx=QINDEX,
                        tile_cols_log2=tcl, u_ac_delta_q=UV_DQ,
                        filter_levels=(flv,) * 4, enable_cdef=True,
                        cdef_damping=damping, cdef_strengths=(strengths,))
    avif = mux_avif(assemble_av1_stream(seq, frame, payloads), w, h,
                    bit_depth=BITDEPTH, high_bitdepth=False, cicp=(2, 2, 2))
    return (avif, yuv444_to_rgb(recon, bitdepth=BITDEPTH),
            sum(fp.seeded_hits for fp in seeded))


@contextlib.contextmanager
def _env(**values: str):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _lr_inputs(planes, tcl: int):
    """The reference's Wiener inputs: the frame encoded without the
    planner, deblocked (the deblocked copy) and CDEF-filtered with fixed
    strengths, each cropped to the frame: (cdef, deblk) int32 (2, 3, h, w)."""
    h, w = planes[0].shape
    with _env(OAVIF_TPU_PLANNER="0"):
        _, recon, blocks = FR.encode_frame_planes(
            [p.copy() for p in planes], QINDEX, BITDEPTH, speed=9,
            tile_cols_log2=tcl, u_ac_delta_q=UV_DQ)
    flv = EN._filter_level(QINDEX)
    loop_filter_frame(recon, blocks, (flv,) * 4, bitdepth=BITDEPTH,
                      visible=(h, w))
    deblk = [p.copy() for p in recon]
    cdef_frame(recon, blocks, (4, 2, 4, 2), 3, BITDEPTH)
    return np.stack([np.stack([p[:h, :w] for p in ps])
                     for ps in (recon, deblk)]).astype(np.int32)


def _dryrun_rank(rk: parallel.Rank, img: np.ndarray, q_dim: int,
                 full: bool) -> dict:
    """One rank of ``dryrun_multichip``. ``launches`` counts the kernels
    of the dry run's own steps, not those of the single-device runs it is
    checked against."""
    mesh = parallel.Mesh(q_dim, rk.world // q_dim)
    h, w = img.shape[:2]
    planes = [p.astype(np.int32) for p in rgb_to_yuv444(img, BITDEPTH)]
    tcl, tile_planes = _tiles(planes, w, h, mesh.t_dim)
    launches: dict = {}
    counted = functools.partial(counting, launches)

    # the device step: this rank plans its tile, the tile group sums a
    # plan checksum, the q group gathers the candidates' scores
    with counted():
        fp = FramePlanner(tile_planes[mesh.tile_index], BITDEPTH,
                          device=rk.device)
        packed = plan_device(*fp.dev, QINDEX, BITDEPTH)
        total = parallel.psum(packed.sum(dtype=torch.int64)[None],
                              mesh.tile_group)
        ref = torch.from_numpy(_test_image(64, 64)).to(rk.device)
        step, _ = entry(rk.device)
        scores = parallel.all_gather_width(
            step(ref, torch.stack([ref, ref])), mesh.q_group)
        plans = parallel.all_gather(packed, mesh.tile_group)
    out = {"total": int(total), "scores": scores.cpu().numpy(),
           "launches": launches}
    if scores.shape != (2 * q_dim,) or not bool(
            ((scores - 100.0).abs() < 0.1).all()):
        raise AssertionError(f"dry run: candidate scores {out['scores']}")

    if rk.rank == 0:
        # host side: the sharded plans against the single-device planner,
        # then the tile coders and the frame encode driven by them
        plans = plans.cpu().numpy()
        nby, nbx = fp.nby, fp.nbx
        sharded_plans = []
        payloads_equal = []
        for t, tp in enumerate(tile_planes):
            plan_sh = unpack_plan(plans[t], nby, nbx)
            single = FramePlanner(tp, BITDEPTH, device=rk.device).plan(QINDEX)
            for k in single:
                if not np.array_equal(plan_sh[k], single[k]):
                    raise AssertionError(f"dry run: tile {t} {k}: sharded "
                                         "plan != single-device plan")
            sharded_plans.append(plan_sh)
            if full:
                py_payload = FR.TileEncoder(
                    [p.copy() for p in tp], QINDEX, BITDEPTH, 9,
                    plan=plan_sh, u_ac_delta_q=UV_DQ).encode()
                res = tile_encode_native(tp, QINDEX, BITDEPTH, 9, plan_sh,
                                         UV_DQ)
                if res is None:
                    raise RuntimeError("dry run: the native tile coder "
                                       "failed to build")
                payloads_equal.append(res[0] == py_payload)
                if res[0] != py_payload:
                    raise AssertionError(f"dry run: tile {t} C and Python "
                                         "payloads differ")
        with counted():
            avif_sharded, recon, seeded_used = _frame_encode(
                planes, tcl, tile_planes, sharded_plans)
        avif_single, _, _ = _frame_encode(planes, tcl)
        if avif_sharded != avif_single:
            raise AssertionError("dry run: the sharded-plan encode's bytes "
                                 "differ from the unsharded encode's")
        out.update(plans=plans, avif_sharded=avif_sharded,
                   avif_single=avif_single, seeded_used=seeded_used,
                   payloads_equal=payloads_equal, recon=recon)
    if not full:
        return out

    # the recon and the Wiener inputs from rank 0 to every rank; each tile
    # group then scores and filters them width-sharded
    recon = parallel.broadcast(torch.from_numpy(
        recon if rk.rank == 0 else np.zeros((h, w, 3), np.uint8)
    ).to(rk.device)).cpu().numpy()
    lr = parallel.broadcast(torch.from_numpy(
        _lr_inputs(planes, tcl) if rk.rank == 0
        else np.zeros((2, 3, h, w), np.int32)).to(rk.device)).cpu().numpy()
    ws = w // mesh.t_dim
    cols = slice(mesh.tile_index * ws, (mesh.tile_index + 1) * ws)
    with counted():
        score_sh = ssimulacra2_sharded_body(
            *(torch.from_numpy(np.ascontiguousarray(a[:, cols])).to(rk.device)
              for a in (img, recon)), h, w, mesh.tile_group)
        lr_sharded = apply_wiener_sharded(list(lr[0]), list(lr[1]), h, w,
                                          LR_TAPS, BITDEPTH, mesh.tile_group,
                                          rk.device)
    out["score_sharded"] = score_sh
    out["wiener_crc"] = [zlib.crc32(p.tobytes()) for p in lr_sharded]
    if rk.rank != 0:
        return out

    score_single = compute_ssimulacra2(img, recon, rk.device)
    if not (abs(score_sh - score_single) < 0.05 and 20.0 < score_sh < 100.0):
        raise AssertionError(f"dry run: sharded score {score_sh}, "
                             f"single-device {score_single}")
    usz = unit_size(2)
    urows, ucols = count_units(h, usz), count_units(w, usz)
    grids = {p: [[list(LR_TAPS[p])] * ucols for _ in range(urows)]
             for p in LR_TAPS}
    lr_host = apply_wiener(list(lr[0]), list(lr[1]), h, w, (2, 2, 2), 2,
                           grids, BITDEPTH)
    for p in range(3):
        if not np.array_equal(lr_sharded[p], lr_host[p]):
            raise AssertionError(f"dry run: sharded Wiener plane {p} differs "
                                 "from the host filter")
    out.update(score_single=score_single, wiener_sharded=lr_sharded,
               wiener_host=lr_host)

    # the device encode stage: levels for a q batch, then a frame encode
    # through the Python coder with the stage on
    fp0 = FR.get_planner(tile_planes[0], BITDEPTH, 13, 0)
    if fp0.dev is not None:
        with counted():
            dl = DeviceLevels(fp0, BITDEPTH)
            modes0 = np.zeros((fp0.sby * 4, fp0.sbx * 4), np.int32)
            lv_b, eob_b = dl.levels(modes0, [QINDEX, QINDEX + 8])
        if not (lv_b.shape[0] == 2 and eob_b.shape == lv_b.shape[:2]
                and int(eob_b[1].sum()) <= int(eob_b[0].sum())):
            raise AssertionError(f"dry run: device levels {lv_b.shape}, "
                                 f"eob {eob_b.shape}")
        with counted(), _env(OAVIF_PY_TILE="1", OAVIF_DEVICE_LEVELS="1"):
            _, recon_dev, _ = _frame_encode(planes, tcl)
        score_dev = compute_ssimulacra2(img, recon_dev, rk.device)
        if abs(score_dev - score_single) >= 2.0:
            raise AssertionError(f"dry run: device-levels score {score_dev}, "
                                 f"single-device {score_single}")
        out.update(levels_shape=lv_b.shape, eob_shape=eob_b.shape,
                   eob_sums=[int(e.sum()) for e in eob_b],
                   score_device_levels=score_dev)
    return out


def dryrun_multichip(n: int, *, backend: str = "gloo", device=None,
                     image: Optional[np.ndarray] = None,
                     q_dim: Optional[int] = None,
                     timeout_s: float = 120.0) -> dict:
    """The reference's multi-device dry run on ``n`` spawned ranks.

    Without ``image``: the reference's shapes, one frame of 128-px tiles
    (one per rank of the tile axis) of the test image, 8-bit, qindex 60,
    with every check of the reference. With ``image`` (H, W, 3) uint8: the
    frame cut into equal tile columns, one per rank of the tile axis, and
    only the plan and byte checks. ``q_dim`` defaults to the reference's
    layout (2 for an even n >= 4, else 1).

    Returns rank 0's results (``plans`` (tiles, L) packed int32,
    ``avif_sharded``/``avif_single`` bytes, ``recon`` (H, W, 3) uint8 of
    the sharded-plan encode, ``seeded_used``: plans that encode took from
    the seeds; with the reference's shapes
    also ``score_sharded``, ``score_single``, ``wiener_sharded``,
    ``wiener_host``, ``payloads_equal`` and the device-levels results),
    each rank's plan checksum (``totals``) and candidate scores
    (``scores``), and the ``launches`` of the dry run's own steps (not of
    the single-device runs it is checked against) summed over the ranks."""
    qd = mesh_dims(n)[0] if q_dim is None else q_dim
    if n % qd:
        raise ValueError(f"dry run: {n} ranks do not split into q {qd}")
    full = image is None
    img = _test_image(TILE_PX, TILE_PX * (n // qd), seed=1) if full else image
    results, _ = parallel.spawn(_dryrun_rank, n, args=(img, qd, full),
                                backend=backend, device=device,
                                timeout_s=timeout_s)
    totals = [r["total"] for r in results]
    t_dim = n // qd
    for q in range(qd):
        group = totals[q * t_dim : (q + 1) * t_dim]
        if len(set(group)) != 1:
            raise AssertionError(f"dry run: tile-group checksums {totals}")
    if full and len({tuple(r["wiener_crc"]) for r in results}) != 1:
        raise AssertionError("dry run: ranks hold different Wiener planes")
    if full and len({r["score_sharded"] for r in results}) != 1:
        raise AssertionError("dry run: ranks' sharded scores differ")
    out = dict(results[0])
    out.update(totals=totals, scores=[r["scores"] for r in results],
               launches=parallel.sum_counts([r["launches"] for r in results]))
    return out
