"""Top-level AVIF encode with the GPU planner; the counterpart of
``encode_avif`` and ``encode_avif_with_recon`` in oavif_tpu/av1/encode.py.

The same pipeline as the reference (depth conversion, YUV444, the frame
encode, deblocking, CDEF, optional Wiener/SGR restoration, OBU assembly,
ISOBMFF mux, optional alpha item), with the port's ``encode_frame_planes``
in place of the reference's, which plans through JAX. The helpers and the
q-independent per-source caches (``_chroma_stats`` to ``_cached_pre``)
are copies of the reference's.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..backend import EncCtx
from .cdef import cdef_frame
from .consts import quality_to_qindex
from .frame import encode_frame_planes, get_planner
from .loopfilter import loop_filter_frame
from .mux import mux_avif
from .obu import (FrameConfig, SequenceConfig, assemble_av1_stream,
                  clamp_tile_log2s)
from .yuv import rgb_to_yuv444, yuv444_to_rgb


def _chroma_stats(planes, bitdepth: int = 8):
    """Q-independent part of the chroma delta-q analysis: (mean local
    16x16 variance, max block-mean drift) over the chroma planes at 8-bit
    scale. Cached per source across TQ probes (see encode_avif_with_recon)."""
    h, w = planes[1].shape
    vh, vw = (h // 16) * 16, (w // 16) * 16
    if vh < 16 or vw < 16:
        return None
    lv_sum = 0.0
    mv_max = 0.0
    for pl in planes[1:]:
        blk = np.asarray(pl[:vh, :vw], dtype=np.int64).reshape(
            vh // 16, 16, vw // 16, 16
        )
        s1 = blk.sum(axis=(1, 3), dtype=np.int64)
        s2 = (blk * blk).sum(axis=(1, 3), dtype=np.int64)
        var_num = 256 * s2 - s1 * s1
        lv_sum += float(int(var_num.sum())) / (65536.0 * float(var_num.size))
        means = s1.astype(np.float64) / 256.0
        mv_max = max(mv_max, float(means.var()))
    sc2 = float(1 << (2 * (bitdepth - 8)))
    return lv_sum / (2.0 * sc2), mv_max / sc2


def _chroma_delta_q(qindex: int, tune: str = "iq", planes=None,
                    bitdepth: int = 8, stats=None) -> int:
    """u_ac_delta_q policy: shift bits from chroma AC to luma, where the
    perceptual metric concentrates (measured: libaom carries ~2x our
    chroma MSE at iso-bytes while halving luma MSE — see PARITY.md).
    Scales with base q; env override OAVIF_UV_DQ for calibration.
    tune=ssim keeps chroma at the base quantizer (SSIM is a luma
    metric, but chroma fidelity is preserved for it).

    Banding guard: smooth chroma ramps (tiny local variance but a wide
    global range — gradients) band visibly under a coarse chroma
    quantizer, so such frames keep a small delta; flat-chroma frames
    (nothing to band) and textured-chroma frames (masking) take the
    full delta. Calibrated on photo/noise/gradient/colorful probes."""
    import os

    ov = os.environ.get("OAVIF_UV_DQ")
    if ov is not None:
        return int(ov)
    if qindex == 0 or tune == "ssim":
        return 0
    # taper toward 0 near lossless: qindex 1-11 must not coarsen chroma
    # by the full 12 floor where the user asked for maximum fidelity
    # (the calibrated qindex+16 ramp is untouched above that)
    delta = min(48, max(12, qindex + 16)) if qindex >= 12 else qindex
    if stats is None and planes is not None and len(planes) == 3:
        stats = _chroma_stats(planes, bitdepth)
    if stats is not None:
        mean_local_var, mean_drift = stats
        # banding-prone = chroma is locally smooth but its BLOCK MEANS
        # drift across the frame (a ramp); noise drifts nothing, texture
        # fails the smoothness test (masking)
        if mean_local_var < 40.0 and mean_drift > 100.0:
            delta = min(delta, 12)
    return delta



def _filter_level(qindex: int) -> int:
    """Deblocking strength from the quantizer: libaom's default guess
    (level ~ Round2(ac_q * 20723 + 1015158, 18)) at HALF strength —
    measured better at iso-SSIMULACRA2 on the probe corpus (the metric
    penalizes over-smoothing more than residual blockiness at these
    rates; full strength cost ~1.4% photo bytes, zero helps gradients).
    Encoder freedom — conformance only requires the header level to
    match what the recon applies."""
    from .tables import ac_q

    if qindex == 0:
        return 0
    q = ac_q(qindex, 8)
    return max(0, min(63, (q * 20723 + 1015158 + (1 << 17)) >> 18)) // 2


def _auto_tile_log2s(w: int, h: int, max_threads: int):
    """Auto-tiling policy (reference --auto-tiling, parse_args.zig:52-54
    delegated to libaom): split toward one tile per thread, never below
    512 px per tile axis. With the reference-default 1 thread this yields a
    single tile, matching libaom's single-threaded choice."""
    cols = rows = 0
    while (1 << (cols + rows)) < max_threads:
        tw, th = w >> cols, h >> rows
        if max(tw, th) < 512:
            break
        if tw >= th:
            cols += 1
        else:
            rows += 1
    return cols, rows


def _depth_convert(src_data: np.ndarray, src_hbd: bool, out_depth: int) -> np.ndarray:
    """Reference depth-conversion formulas (io.zig:566-617)."""
    if not src_hbd and out_depth == 10:
        # (v*1023 + 127) / 255  (io.zig:572)
        return ((src_data.astype(np.uint32) * 1023 + 127) // 255).astype(np.uint16)
    if src_hbd and out_depth == 10:
        return (src_data >> 6).astype(np.uint16)  # io.zig:587
    if src_hbd and out_depth == 8:
        return (src_data >> 8).astype(np.uint8)  # io.zig:602
    return src_data


# CDEF strength candidates for the encoder-side search (one frame-wide
# set, cdef_bits = 0). Candidate 0 = off; the search returns the SSE-best
# on a 1/16 subsample of non-skip 8x8 blocks (libaom av1_cdef_search's
# fast analogue — SURVEY.md §2b N1).
_CDEF_CANDS = (
    (0, 0, 0, 0),
    (1, 0, 1, 0),
    (2, 1, 2, 1),
    (4, 2, 4, 2),
    (6, 2, 6, 2),
    (8, 2, 8, 2),
    (12, 4, 12, 2),
)


def _pick_cdef(planes, recon_planes, blocks, qindex, bitdepth, visible,
               speed=9):
    """Choose CDEF strengths by sampled SSE against the source; the
    sampling density follows the speed ladder (1/16 of 8x8 blocks at the
    default, 1/4 at speeds 6-7, every block at <= 5)."""
    from .entropy.fast import cdef_search_native

    if speed >= 10:
        # leanest preset: no CDEF search — a fixed qindex-keyed strength
        # (encoder freedom; the recon applies exactly what the header
        # signals). Measured part of the >=4x ladder wall spread.
        idx = 0 if qindex < 24 else (2 if qindex < 96 else 4)
        return _CDEF_CANDS[idx], min(6, 3 + (qindex >> 6))
    sample_log2 = 2 if speed >= 8 else (1 if speed >= 6 else 0)
    damping = min(6, 3 + (qindex >> 6))
    ph, pw = recon_planes[0].shape

    def _pad_src():
        padded = []
        for p in planes:
            buf = np.zeros((ph, pw), dtype=np.int32)
            hh, ww = p.shape
            buf[:hh, :ww] = p
            buf[:hh, ww:] = buf[:hh, ww - 1 : ww]
            buf[hh:, :] = buf[hh - 1 : hh, :]
            padded.append(buf)
        return padded

    # q-independent (source-only) pad, re-derived per pass otherwise;
    # chroma planes are validity guards (a key on the luma id alone
    # could serve stale padded chroma to a caller recombining planes)
    padded_src = _cached_pre(
        planes[0], ("cdef_pad", ph, pw, len(planes)), _pad_src,
        guards=tuple(planes[1:]))
    idx = cdef_search_native(padded_src, recon_planes, blocks, _CDEF_CANDS,
                             damping, bitdepth, visible[0], visible[1],
                             sample_log2=sample_log2)
    return _CDEF_CANDS[idx], damping


def _detect_screen_content(y_plane, qindex: int, bitdepth: int = 8) -> bool:
    """Palette-profitability gate: the fraction of 16x16 luma blocks
    with <= 8 distinct values. Screen content (text, UI, flat graphics)
    scores high; photographs with noise score ~0. Threshold 20%.

    Distinctness is measured at 8-BIT precision regardless of the coding
    depth: the default 10-bit config depth-converts an 8-bit source,
    which spreads each block's values ~4x and used to hide screen
    content from this gate entirely (the per-block lossy-palette trial
    then handles the residual spread). OAVIF_PALETTE=0 disables."""
    if qindex == 0 or os.environ.get("OAVIF_PALETTE", "1") == "0":
        return False
    y = np.asarray(y_plane)
    if bitdepth > 8:
        y = y >> (bitdepth - 8)
    h, w = y.shape
    vh, vw = (h // 16) * 16, (w // 16) * 16
    if vh < 32 or vw < 32:
        return False
    blocks = y[:vh, :vw].reshape(vh // 16, 16, vw // 16, 16)
    blocks = blocks.transpose(0, 2, 1, 3).reshape(-1, 256)
    srt = np.sort(blocks, axis=1)
    ndistinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(axis=1)
    return float((ndistinct <= 8).mean()) >= 0.20


# Per-source cache of the YUV conversion + q-independent chroma analysis:
# the TQ loop re-encodes the SAME source at several quantizers, and
# neither depends on q. Keyed by source-buffer identity, weakref-guarded.
# Capacity must exceed the corpus pipeline's images-in-flight (tq/
# pipeline.py interleaves the whole corpus over one host core; at 4
# entries a 6-image corpus evicted every pass and re-ran the YUV
# conversion + chroma analysis ~11 ms per encode).
_SRC_CACHE: dict = {}
_SRC_CACHE_CAP = 16


def _cached_planes(src_data: np.ndarray, rgb: np.ndarray, out_depth: int):
    import weakref

    key = (id(src_data), out_depth)
    ent = _SRC_CACHE.get(key)
    if ent is not None and ent[0]() is src_data:
        return ent[1], ent[2]
    planes = rgb_to_yuv444(rgb, bitdepth=out_depth)
    stats = _chroma_stats(planes, out_depth) if len(planes) == 3 else None
    while len(_SRC_CACHE) >= _SRC_CACHE_CAP:
        _SRC_CACHE.pop(next(iter(_SRC_CACHE)))
    _SRC_CACHE[key] = (weakref.ref(src_data), planes, stats)
    return planes, stats


# Same-keyed cache for the q-independent per-pass preambles: the source
# depth conversion and the screen-content gate (both pure functions of
# the source buffer; measured ~7 ms per 512² pass re-derived). Each
# image contributes 3-4 entries (rgb, alpha, screen, cdef_pad), so the
# cap is 4x the source-cache capacity to cover the same images-in-flight
# envelope (a 2x cap covered only ~8 images and thrashed on larger
# corpora — round-4 advisory).
_PRE_CACHE: dict = {}
_PRE_CACHE_CAP = 4 * _SRC_CACHE_CAP


def _cached_pre(src_data: np.ndarray, key_extra, fn, guards=()):
    """Memoize fn() keyed by source-buffer identity + key_extra.

    `guards`: extra arrays whose identity is part of the validity
    contract (e.g. the chroma planes behind a luma-keyed pad) — the hit
    path checks every guard's weakref still resolves to the same object.
    """
    import weakref

    key = (id(src_data), key_extra)
    ent = _PRE_CACHE.get(key)
    if (ent is not None and ent[0]() is src_data
            and all(r() is g for r, g in zip(ent[2], guards))):
        return ent[1]
    val = fn()
    # sweep dead entries first: weakref-dead values are unreachable by
    # hit yet pin frame-sized arrays until FIFO eviction otherwise
    dead = [k for k, e in _PRE_CACHE.items() if e[0]() is None]
    for k in dead:
        _PRE_CACHE.pop(k, None)
    while len(_PRE_CACHE) >= _PRE_CACHE_CAP:
        _PRE_CACHE.pop(next(iter(_PRE_CACHE)))
    _PRE_CACHE[key] = (weakref.ref(src_data), val,
                       tuple(weakref.ref(g) for g in guards))
    return val


def _source_rgb(src, out_depth: int) -> np.ndarray:
    """The source's colour planes at the output depth, gray replicated to
    RGB, cached per source (a cache hit pays nothing)."""
    d = src.data
    if d.ndim == 2:
        d = d[..., None]
    return _cached_pre(
        src.data, ("rgb", src.hbd, out_depth, src.channels),
        lambda: _depth_convert(
            np.repeat(d[..., :1], 3, axis=2) if src.channels in (1, 2)
            else d[..., :3], src.hbd, out_depth))


def _tile_log2s(o, w: int, h: int) -> Tuple[int, int]:
    """The frame's (tile_cols_log2, tile_rows_log2) under options ``o``."""
    if o.auto_tiling and o.tile_cols_log2 == 0 and o.tile_rows_log2 == 0:
        tcl, trl = _auto_tile_log2s(w, h, o.max_threads)
    else:
        tcl, trl = o.tile_cols_log2, o.tile_rows_log2
    return clamp_tile_log2s(w, h, tcl, trl)


def prefetch_plan(ctx: EncCtx, quality: int) -> None:
    """Warm the device planner cache for ctx's frame at ``quality``; the
    counterpart of the reference's prefetch_plan.

    The corpus pipeline (tq/pipeline.py) runs this on its device worker
    thread while the host encodes other images, so that an image's first
    probe finds its plan ready. It takes the encode path's planes and
    planner cache, and the encode path's gates (frame._encode_one_tile):
    speeds 6-9, frames of at least 256x256 pixels, duel level 1 at speed
    6. It plans single-tile frames only (the default one-thread tiling):
    a multi-tile frame's planners are per tile. A planner that fails
    raises."""
    o, src = ctx.o, ctx.src
    qindex = quality_to_qindex(quality)
    if (os.environ.get("OAVIF_TPU_PLANNER", "1") == "0" or qindex <= 0
            or not 6 <= o.speed <= 9
            or _tile_log2s(o, src.width, src.height) != (0, 0)):
        return
    out_depth = 10 if o.tenbit else (10 if src.hbd else 8)
    planes, _ = _cached_planes(src.data, _source_rgb(src, out_depth),
                               out_depth)
    if np.asarray(planes[0]).size < 256 * 256:
        return
    duel_level = 1 if o.speed <= 6 else 0
    get_planner(planes, out_depth, 13, duel_level).plan(qindex)


def encode_avif(ctx: EncCtx) -> bytes:
    data, _ = encode_avif_with_recon(ctx)
    return data


def encode_avif_with_recon(ctx: EncCtx) -> Tuple[bytes, np.ndarray]:
    """Encode per ctx options at quantizer ctx.q; returns (avif bytes,
    reconstructed 8-bit RGB for in-loop scoring). The recon equals the
    decoder's output bit-exactly."""
    o = ctx.o
    src = ctx.src
    out_depth = 10 if o.tenbit else (10 if src.hbd else 8)

    d = src.data
    if d.ndim == 2:
        d = d[..., None]
    channels = src.channels
    alpha_src = (d[..., 1] if channels == 2
                 else d[..., 3] if channels == 4 else None)
    rgb = _source_rgb(src, out_depth)
    alpha = (
        _cached_pre(src.data, ("alpha", src.hbd, out_depth),
                    lambda: _depth_convert(alpha_src, src.hbd, out_depth))
        if alpha_src is not None
        else None
    )

    qindex = quality_to_qindex(ctx.q)  # 0 => CodedLossless (WHT 4x4)

    h, w = rgb.shape[:2]
    tcl, trl = _tile_log2s(o, w, h)

    planes, ch_stats = _cached_planes(src.data, rgb, out_depth)
    uv_dq = (
        _chroma_delta_q(qindex, o.tune.value, planes, out_depth,
                        stats=ch_stats)
        if len(planes) > 1 else 0
    )
    # --tune ssim arms the identity-transform duel in both mirrored
    # encoders, as in the reference
    if o.tune.value == "ssim":
        os.environ["OAVIF_IDTX"] = "1"
    # screen-content gate: the frame's palette syntax only where the luma
    # is palette-shaped
    screen_tools = qindex > 0 and _cached_pre(
        src.data,
        ("screen", out_depth, os.environ.get("OAVIF_PALETTE", "1")),
        lambda: _detect_screen_content(planes[0], max(qindex, 1),
                                       out_depth))
    # filter-intra arms at quality speeds (OAVIF_FILTER_INTRA=0/1 overrides)
    fi_env = os.environ.get("OAVIF_FILTER_INTRA")
    filter_intra = (
        fi_env != "0" if fi_env is not None else o.speed <= 8
    ) and qindex > 0
    # 128px superblocks on single-tile frames that fit one (OAVIF_SB128)
    sb_env = os.environ.get("OAVIF_SB128")
    sb128 = (
        sb_env != "0" if sb_env is not None else True
    ) and qindex > 0 and min(h, w) >= 128 and tcl == 0 and trl == 0
    payloads, recon_planes, blocks = encode_frame_planes(
        planes,
        qindex,
        bitdepth=out_depth,
        speed=o.speed,
        tile_cols_log2=tcl,
        tile_rows_log2=trl,
        max_threads=o.max_threads,
        u_ac_delta_q=uv_dq,
        screen_tools=screen_tools,
        filter_intra=filter_intra,
        sb128=sb128,
    )
    flv = _filter_level(qindex)
    filter_levels = (flv, flv, flv, flv)
    if flv:
        loop_filter_frame(recon_planes, blocks, filter_levels,
                          bitdepth=out_depth, visible=(h, w))
    # loop restoration arms at the quality presets on single-tile frames;
    # a restoring frame re-packs the tile (recorded decisions replay)
    lr_env = os.environ.get("OAVIF_LR")
    lr_armed = (
        (lr_env != "0" if lr_env is not None else o.speed <= 6)
        and qindex > 0 and len(planes) == 3 and tcl == 0 and trl == 0
        and min(h, w) >= 64
    )
    deblk_planes = (
        [p.copy() for p in recon_planes] if lr_armed else None
    )
    cdef_on = qindex > 0 and len(planes) == 3
    cdef_strengths = (0, 0, 0, 0)
    cdef_damping = min(6, 3 + (qindex >> 6))
    if cdef_on:
        cdef_strengths, cdef_damping = _pick_cdef(
            planes, recon_planes, blocks, qindex, out_depth, (h, w),
            speed=o.speed)
        if any(cdef_strengths):
            cdef_frame(recon_planes, blocks, cdef_strengths, cdef_damping,
                       out_depth)
    recon_planes = [p[:h, :w] for p in recon_planes]

    lr_types = None
    if lr_armed:
        from .frame import RDOQ_KDEN, RDOQ_KNUM
        from .restoration import (SGR_SETS_FULL, SGR_SETS_REDUCED,
                                  apply_restoration, search_restoration,
                                  search_wiener)
        from .tables import ac_q

        dq_ac = ac_q(qindex, out_depth)
        lam_pix = float(((dq_ac * dq_ac) >> 6) * RDOQ_KNUM) / (
            RDOQ_KDEN * 128.0)
        deblk_vis = [p[:h, :w] for p in deblk_planes]
        # SGRPROJ joins the search at the slower presets (OAVIF_SGR=1/0)
        sgr_env = os.environ.get("OAVIF_SGR")
        sgr_on = (sgr_env != "0" if sgr_env is not None
                  else o.speed <= 5)
        if sgr_on:
            sets = SGR_SETS_FULL if o.speed <= 4 else SGR_SETS_REDUCED
            lr_types, lr_wiener, lr_sgr = search_restoration(
                planes, recon_planes, deblk_vis, h, w, out_depth,
                lam_pix, sgr_sets=sets)
        else:
            lr_types, lr_wiener = search_wiener(
                planes, recon_planes, deblk_vis, h, w, out_depth,
                lam_pix)
            lr_sgr = None
        if lr_types is not None:
            lr_cfg = {"types": lr_types, "unit_shift": 2,
                      "wiener": lr_wiener or {}, "sgrproj": lr_sgr or {}}
            payloads, _, _ = encode_frame_planes(
                planes, qindex, bitdepth=out_depth, speed=o.speed,
                tile_cols_log2=tcl, tile_rows_log2=trl,
                max_threads=o.max_threads, u_ac_delta_q=uv_dq,
                screen_tools=screen_tools, filter_intra=filter_intra,
                lr=lr_cfg, sb128=sb128,
            )
            recon_planes = apply_restoration(
                recon_planes, deblk_vis, h, w, lr_types, 2, lr_wiener,
                lr_sgr, out_depth)

    seq = SequenceConfig(
        width=w,
        height=h,
        bit_depth=out_depth,
        color_primaries=o.color_primaries,
        transfer_characteristics=o.transfer_characteristics,
        matrix_coefficients=o.matrix_coefficients,
        enable_cdef=cdef_on,
        enable_filter_intra=filter_intra,
        enable_restoration=lr_types is not None,
        use_128x128_superblock=sb128,
    )
    frame = FrameConfig(
        width=w, height=h, base_q_idx=qindex,
        tile_cols_log2=tcl, tile_rows_log2=trl,
        u_ac_delta_q=uv_dq,
        filter_levels=filter_levels,
        enable_cdef=cdef_on,
        screen_content_tools=screen_tools,
        cdef_damping=cdef_damping,
        cdef_strengths=(cdef_strengths,),
        enable_restoration=lr_types is not None,
        lr_types=lr_types if lr_types is not None else (0, 0, 0),
        use_128x128_superblock=sb128,
    )
    av1 = assemble_av1_stream(seq, frame, payloads)

    alpha_payload = None
    if alpha is not None:
        aq = quality_to_qindex(o.quality_alpha)  # 100 => lossless alpha
        apayloads, arecon, ablocks = encode_frame_planes(
            [alpha.astype(np.int32)],
            aq,
            bitdepth=out_depth,
            speed=o.speed,
            tile_cols_log2=tcl,
            tile_rows_log2=trl,
            max_threads=o.max_threads,
        )
        aseq = SequenceConfig(
            width=w,
            height=h,
            bit_depth=out_depth,
            monochrome=True,
            seq_profile=0,
            color_primaries=o.color_primaries,
            transfer_characteristics=o.transfer_characteristics,
            matrix_coefficients=o.matrix_coefficients,
        )
        aflv = _filter_level(aq)
        if aflv:
            loop_filter_frame(arecon, ablocks, (aflv, aflv, 0, 0),
                              bitdepth=out_depth, visible=(h, w))
        aframe = FrameConfig(
            width=w, height=h, base_q_idx=aq,
            tile_cols_log2=tcl, tile_rows_log2=trl,
            filter_levels=(aflv, aflv, 0, 0),
        )
        alpha_payload = assemble_av1_stream(aseq, aframe, apayloads)

    avif = mux_avif(
        av1,
        w,
        h,
        bit_depth=out_depth,
        high_bitdepth=out_depth == 10,
        cicp=(o.color_primaries, o.transfer_characteristics,
              o.matrix_coefficients),
        icc=src.icc,
        alpha_payload=alpha_payload,
    )
    recon_rgb = yuv444_to_rgb(recon_planes, bitdepth=out_depth)
    return avif, recon_rgb
