"""AV1 OBU assembly: sequence header + frame OBU (uncompressed header).

Implements the spec's reduced_still_picture_header profile of the syntax —
the still-image subset AVIF uses. The tool-disabling choices here are
load-bearing for the rest of the encoder:

  - enable_filter_intra = 0, enable_intra_edge_filter = 0 → predictors
    need no edge filtering / upsampling and no filter_intra symbols.
  - enable_restoration = 0; the deblocking loop filter and CDEF are
    enabled and replicated bit-exactly in the encoder
    (oavif_tpu.av1.loopfilter, oavif_tpu.av1.cdef) so recon == decoder
    output still holds.
  - allow_screen_content_tools = 0 → no palette/intrabc symbols.
  - tx_mode = TX_MODE_SELECT → per-block luma tx_depth symbols (the
    encoder RD-chooses tx == block vs a 4-way tx split; tx_type is
    signaled per luma txb <= 16).
  - disable_cdf_update = 0 (CDFs adapt within the tile as usual).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


class BitWriter:
    """MSB-first bit writer (spec f(n) fields)."""

    def __init__(self) -> None:
        self.bytes = bytearray()
        self.bitpos = 0  # bits used in the trailing partial byte

    def f(self, value: int, nbits: int) -> None:
        assert 0 <= value < (1 << nbits), (value, nbits)
        for i in range(nbits - 1, -1, -1):
            bit = (value >> i) & 1
            if self.bitpos == 0:
                self.bytes.append(0)
            self.bytes[-1] |= bit << (7 - self.bitpos)
            self.bitpos = (self.bitpos + 1) & 7

    def byte_align(self) -> None:
        self.bitpos = 0

    def trailing_bits(self) -> None:
        self.f(1, 1)
        self.byte_align()

    def data(self) -> bytes:
        return bytes(self.bytes)


def leb128(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def obu(obu_type: int, payload: bytes) -> bytes:
    """Wrap payload with an OBU header + size field."""
    header = bytes([(obu_type << 3) | 0x02])  # has_size_field
    return header + leb128(len(payload)) + payload


OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6


@dataclass
class SequenceConfig:
    width: int
    height: int
    bit_depth: int = 8  # 8 or 10
    monochrome: bool = False
    seq_profile: int = 1  # 1 = 4:4:4 8/10-bit
    seq_level_idx: int = 13
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: int = 1  # full range (oracle backend uses full too)
    enable_cdef: bool = False
    enable_filter_intra: bool = False
    enable_restoration: bool = False
    use_128x128_superblock: bool = False


def _choose_level(width: int, height: int) -> int:
    # Minimal level whose max picture size covers the frame (spec A.3).
    luma = width * height
    levels = [
        (0, 147456, 2048, 1152), (1, 278784, 2816, 1584),
        (4, 665856, 4352, 2448), (5, 1065024, 5504, 3096),
        (8, 2359296, 6144, 3456), (9, 2359296, 6144, 3456),
        (12, 8912896, 8192, 4352), (13, 8912896, 8192, 4352),
        (14, 8912896, 8192, 4352), (15, 8912896, 8192, 4352),
        (16, 35651584, 16384, 8704), (17, 35651584, 16384, 8704),
        (18, 35651584, 16384, 8704), (19, 35651584, 16384, 8704),
    ]
    for idx, area, mw, mh in levels:
        if luma <= area and width <= mw and height <= mh:
            return idx
    return 31  # LEVEL_MAX: no constraint


def write_sequence_header(cfg: SequenceConfig) -> bytes:
    w = BitWriter()
    w.f(cfg.seq_profile, 3)
    w.f(1, 1)  # still_picture
    w.f(1, 1)  # reduced_still_picture_header
    w.f(_choose_level(cfg.width, cfg.height), 5)  # seq_level_idx[0]
    w.f(15, 4)  # frame_width_bits_minus_1
    w.f(15, 4)  # frame_height_bits_minus_1
    w.f(cfg.width - 1, 16)
    w.f(cfg.height - 1, 16)
    w.f(1 if cfg.use_128x128_superblock else 0, 1)  # superblock size
    w.f(1 if cfg.enable_filter_intra else 0, 1)  # enable_filter_intra
    w.f(0, 1)  # enable_intra_edge_filter
    w.f(0, 1)  # enable_superres
    w.f(1 if cfg.enable_cdef else 0, 1)  # enable_cdef
    w.f(1 if cfg.enable_restoration else 0, 1)  # enable_restoration
    # color_config()
    w.f(1 if cfg.bit_depth == 10 else 0, 1)  # high_bitdepth
    if cfg.seq_profile != 1:
        w.f(1 if cfg.monochrome else 0, 1)
    w.f(1, 1)  # color_description_present_flag
    w.f(cfg.color_primaries, 8)
    w.f(cfg.transfer_characteristics, 8)
    w.f(cfg.matrix_coefficients, 8)
    if cfg.monochrome:
        # mono: color_range then done (spec color_config early return)
        w.f(cfg.color_range, 1)
    else:
        # BT.709 primaries, sRGB transfer and the identity matrix imply
        # full range and 4:4:4: spec color_config reads no color_range
        # there (unlike the reference's writer, whose stream for this one
        # triple no decoder reads)
        if (cfg.color_primaries, cfg.transfer_characteristics,
                cfg.matrix_coefficients) != (1, 13, 0):
            w.f(cfg.color_range, 1)
        # profile 1 → subsampling 0,0 implied; no chroma_sample_position
        w.f(0, 1)  # separate_uv_delta_q
    w.f(0, 1)  # film_grain_params_present
    w.trailing_bits()
    return obu(OBU_SEQUENCE_HEADER, w.data())


@dataclass
class FrameConfig:
    width: int
    height: int
    base_q_idx: int
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    qm: bool = False
    u_ac_delta_q: int = 0
    v_ac_delta_q: int = 0
    filter_levels: tuple = (0, 0, 0, 0)  # y_vert, y_horz, u, v
    filter_sharpness: int = 0
    enable_cdef: bool = False  # must mirror the sequence header's bit
    cdef_damping: int = 3  # 3..6
    # one strength set per 1<<cdef_bits; cdef_bits = 0 -> no per-SB signaling
    cdef_strengths: tuple = ((0, 0, 0, 0),)  # (y_pri, y_sec, uv_pri, uv_sec)
    # palette (+intrabc syntax, which we always decline): enables the
    # per-block has_palette_y/uv flags — set only when the encoder
    # detected screen content so photo streams are byte-unchanged
    screen_content_tools: bool = False
    # loop restoration (spec 5.9.20 lr_params): per-plane
    # FrameRestorationType coded values (0 NONE, 1 SWITCHABLE, 2 WIENER,
    # 3 SGRPROJ) and the luma unit-size shift (256 >> (2 - shift)).
    # enable_restoration must mirror the sequence header's bit; when set,
    # the three f(2) type fields code even if all NONE.
    enable_restoration: bool = False
    lr_types: tuple = (0, 0, 0)
    lr_unit_shift: int = 2  # unit size 256
    # mirrors the sequence header's superblock-size bit (lr_params and
    # future sb-dependent fields key off it)
    use_128x128_superblock: bool = False


def write_frame_header_bits(cfg: FrameConfig, num_planes: int = 3) -> BitWriter:
    """Uncompressed frame header under reduced_still_picture_header.

    Returned as an unaligned BitWriter so the caller can byte-align before
    appending tile data (OBU_FRAME layout).
    """
    w = BitWriter()
    w.f(0, 1)  # disable_cdf_update
    # seq forced SELECT -> the frame codes allow_screen_content_tools
    w.f(1 if cfg.screen_content_tools else 0, 1)
    if cfg.screen_content_tools:
        # seq_force_integer_mv is implicitly SELECT under the reduced
        # header, and the read is NOT intra-gated (spec 5.9.2) — the
        # value is then overridden to 1 for intra frames
        w.f(1, 1)  # force_integer_mv
    # frame_size: from sequence header (no override under reduced header)
    # superres disabled in seq → nothing
    w.f(0, 1)  # render_and_frame_size_different
    if cfg.screen_content_tools:
        w.f(0, 1)  # allow_intrabc (superres off -> coded; we decline)
    # tile_info(): superblock units follow the sequence's SB size
    sb_px_log2 = 7 if cfg.use_128x128_superblock else 6
    sb_cols = (cfg.width + (1 << sb_px_log2) - 1) >> sb_px_log2
    sb_rows = (cfg.height + (1 << sb_px_log2) - 1) >> sb_px_log2
    _write_tile_info(w, sb_cols, sb_rows, cfg.tile_cols_log2,
                     cfg.tile_rows_log2, sb_px_log2)
    # quantization_params()
    w.f(cfg.base_q_idx, 8)
    w.f(0, 1)  # DeltaQYDc coded flag
    if num_planes > 1:
        # separate_uv_delta_q == 0 → single set of U deltas applies to both
        w.f(0, 1)  # DeltaQUDc coded
        if cfg.u_ac_delta_q:
            w.f(1, 1)
            _write_su(w, cfg.u_ac_delta_q, 7)  # su(1+6)
        else:
            w.f(0, 1)  # DeltaQUAc coded
    w.f(0, 1)  # using_qmatrix
    # segmentation_params()
    w.f(0, 1)  # segmentation_enabled
    # delta_q_params(): base_q_idx > 0 → delta_q_present flag
    if cfg.base_q_idx > 0:
        w.f(0, 1)
    # delta_lf_params: only if delta_q_present → skipped
    coded_lossless = cfg.base_q_idx == 0  # all deltas are 0 here
    if not coded_lossless:
        # loop_filter_params() — skipped entirely when CodedLossless
        lv = cfg.filter_levels
        w.f(lv[0], 6)  # loop_filter_level[0] (y vertical)
        w.f(lv[1], 6)  # loop_filter_level[1] (y horizontal)
        if num_planes > 1 and (lv[0] or lv[1]):
            w.f(lv[2], 6)  # loop_filter_level[2] (u)
            w.f(lv[3], 6)  # loop_filter_level[3] (v)
        w.f(cfg.filter_sharpness, 3)
        w.f(0, 1)  # loop_filter_delta_enabled
    # cdef_params() — written iff the sequence enables CDEF and the frame
    # is not CodedLossless (spec 5.9.19; sec strength 3 is coded as 3,
    # decoder maps it to 4)
    if cfg.enable_cdef and not coded_lossless:
        nsets = len(cfg.cdef_strengths)
        cdef_bits = max(0, nsets.bit_length() - 1)
        assert nsets == 1 << cdef_bits
        w.f(cfg.cdef_damping - 3, 2)
        w.f(cdef_bits, 2)
        for (y_pri, y_sec, uv_pri, uv_sec) in cfg.cdef_strengths:
            w.f(y_pri, 4)
            w.f(3 if y_sec == 4 else y_sec, 2)
            if num_planes > 1:
                w.f(uv_pri, 4)
                w.f(3 if uv_sec == 4 else uv_sec, 2)
    # lr_params (spec 5.9.20): coded only when the sequence enables
    # restoration (AllLossless/intrabc never hold here). The per-plane
    # coded value IS the Remap_Lr_Type index.
    if cfg.enable_restoration and not coded_lossless:
        for t in cfg.lr_types[:num_planes]:
            w.f(t, 2)
        if any(cfg.lr_types[:num_planes]):
            if cfg.use_128x128_superblock:
                # 128 SBs: shift in {1, 2}, one bit (spec lr_params)
                w.f(cfg.lr_unit_shift - 1, 1)
            elif cfg.lr_unit_shift == 0:
                w.f(0, 1)
            else:
                w.f(1, 1)
                w.f(1 if cfg.lr_unit_shift == 2 else 0, 1)
            # 4:4:4 (no subsampling): no lr_uv_shift bit
    # read_tx_mode: CodedLossless → ONLY_4X4 implicit, no bit
    if not coded_lossless:
        w.f(1, 1)  # tx_mode_select = 1 → TX_MODE_SELECT (per-block tx RD)
    # frame_reference_mode: intra → nothing
    # skip_mode_params: nothing
    # reduced_tx_set
    w.f(0, 1)
    # global motion: intra → nothing; film grain: disabled
    return w


def _write_su(w: BitWriter, value: int, nbits: int) -> None:
    """su(n): n-bit two's-complement field (spec 4.10.6)."""
    w.f(value & ((1 << nbits) - 1), nbits)


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def tile_grid(width: int, height: int, tile_cols_log2: int, tile_rows_log2: int):
    """Uniform-spacing tile start positions in superblock units (spec 5.9.15).

    Returns (col_starts_sb, row_starts_sb): lists whose consecutive pairs
    bound each tile; the final element is sb_cols/sb_rows. Note the actual
    tile count along an axis can be smaller than 1 << log2 when the frame is
    narrow (ceil-division step loop, exactly as the decoder computes it).
    """
    sb_cols = (width + 63) >> 6
    sb_rows = (height + 63) >> 6
    tw = (sb_cols + (1 << tile_cols_log2) - 1) >> tile_cols_log2
    th = (sb_rows + (1 << tile_rows_log2) - 1) >> tile_rows_log2
    col_starts = list(range(0, sb_cols, tw)) + [sb_cols]
    row_starts = list(range(0, sb_rows, th)) + [sb_rows]
    return col_starts, row_starts


def clamp_tile_log2s(
    width: int, height: int, tile_cols_log2: int, tile_rows_log2: int
):
    """Clamp requested tile log2s into the spec-legal range for this frame
    (max tile width 4096 px, max tile area 4096*2304, at most 64 tiles per
    axis — spec 5.9.15 limits). Mirrors libaom's internal clamping of the
    values oavif passes through (reference parse_args.zig:69-71)."""
    sb_cols = (width + 63) >> 6
    sb_rows = (height + 63) >> 6
    max_tile_width_sb = 4096 >> 6
    max_tile_area_sb = (4096 * 2304) >> 12
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(
        min_log2_tile_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols)
    )
    cols = min(max(tile_cols_log2, min_log2_tile_cols), max_log2_tile_cols)
    rows = min(max(tile_rows_log2, max(min_log2_tiles - cols, 0)), max_log2_tile_rows)
    return cols, rows


def _write_tile_info(
    w: BitWriter, sb_cols: int, sb_rows: int, tile_cols_log2: int,
    tile_rows_log2: int, sb_px_log2: int = 6,
) -> None:
    """Uniform tile spacing (spec tile_info)."""
    max_tile_width_sb = 4096 >> sb_px_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_px_log2)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(
        min_log2_tile_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols)
    )

    w.f(1, 1)  # uniform_tile_spacing_flag
    assert min_log2_tile_cols <= tile_cols_log2 <= max_log2_tile_cols
    k = min_log2_tile_cols
    while k < max_log2_tile_cols:
        if k < tile_cols_log2:
            w.f(1, 1)
            k += 1
        else:
            w.f(0, 1)
            break
    min_log2_tile_rows = max(min_log2_tiles - tile_cols_log2, 0)
    assert min_log2_tile_rows <= tile_rows_log2 <= max_log2_tile_rows
    k = min_log2_tile_rows
    while k < max_log2_tile_rows:
        if k < tile_rows_log2:
            w.f(1, 1)
            k += 1
        else:
            w.f(0, 1)
            break
    if tile_cols_log2 > 0 or tile_rows_log2 > 0:
        w.f(0, tile_cols_log2 + tile_rows_log2)  # context_update_tile_id
        w.f(3, 2)  # tile_size_bytes_minus_1 = 3 (4-byte tile sizes)


def write_frame_obu(
    cfg: FrameConfig, tile_payloads: List[bytes], num_planes: int = 3
) -> bytes:
    """OBU_FRAME: uncompressed header, byte alignment, tile group."""
    w = write_frame_header_bits(cfg, num_planes)
    w.byte_align()
    col_starts, row_starts = tile_grid(
        cfg.width, cfg.height, cfg.tile_cols_log2, cfg.tile_rows_log2
    )
    num_tiles = (len(col_starts) - 1) * (len(row_starts) - 1)
    assert len(tile_payloads) == num_tiles
    body = bytearray(w.data())
    # tile_group_obu: NumTiles > 1 would need tile_start_and_end flag; in an
    # OBU_FRAME it is required to cover all tiles and the flag is only
    # present when NumTiles > 1 (then forced 0).
    tg = BitWriter()
    if num_tiles > 1:
        tg.f(0, 1)  # tile_start_and_end_present_flag
        tg.byte_align()
    body += tg.data()
    for i, payload in enumerate(tile_payloads):
        if i < num_tiles - 1:
            # tile_size_minus_1, le(TileSizeBytes=4)
            body += (len(payload) - 1).to_bytes(4, "little")
        body += payload
    return obu(OBU_FRAME, bytes(body))


def assemble_av1_stream(seq: SequenceConfig, frame: FrameConfig, tiles: List[bytes]) -> bytes:
    """Sequence header + frame OBU (the AVIF item payload)."""
    num_planes = 1 if seq.monochrome else 3
    return write_sequence_header(seq) + write_frame_obu(frame, tiles, num_planes)
