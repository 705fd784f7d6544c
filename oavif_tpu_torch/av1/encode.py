"""Top-level AVIF encode with the GPU planner; the counterpart of
``encode_avif`` and ``encode_avif_with_recon`` in oavif_tpu/av1/encode.py.

The same pipeline as the reference (depth conversion, YUV444, the frame
encode, deblocking, CDEF, optional Wiener/SGR restoration, OBU assembly,
ISOBMFF mux, optional alpha item), with the port's ``encode_frame_planes``
in place of the reference's, which plans through JAX. Every other helper
and the q-independent per-source caches are the reference's own.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from oavif_tpu.av1.cdef import cdef_frame
from oavif_tpu.av1.consts import quality_to_qindex
from oavif_tpu.av1.encode import (_auto_tile_log2s, _cached_planes,
                                  _cached_pre, _chroma_delta_q,
                                  _depth_convert, _detect_screen_content,
                                  _filter_level, _pick_cdef)
from oavif_tpu.av1.loopfilter import loop_filter_frame
from oavif_tpu.av1.mux import mux_avif
from oavif_tpu.av1.obu import (FrameConfig, SequenceConfig,
                               assemble_av1_stream, clamp_tile_log2s)
from oavif_tpu.av1.yuv import yuv444_to_rgb
from oavif_tpu.backend import EncCtx

from .frame import encode_frame_planes, get_planner


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
        from oavif_tpu.av1.frame import RDOQ_KDEN, RDOQ_KNUM
        from oavif_tpu.av1.restoration import (SGR_SETS_FULL,
                                               SGR_SETS_REDUCED,
                                               apply_restoration,
                                               search_restoration,
                                               search_wiener)
        from oavif_tpu.av1.tables import ac_q

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
