"""ctypes bindings to the native entropy coder (oav1ec.c).

Compiled on first use with the system toolchain; the pure-Python
implementation (rangecoder.py) remains the reference and fallback. The CDF
arena keeps all adaptive CDFs in contiguous NumPy memory shared with C.

The library builds into ``build/oavif_tpu_torch/liboavif_host.so`` at the
root of the checkout (listed in .gitignore), through a temporary file and
``os.replace`` so that concurrent test workers never load a half-written
library.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).parent / "oav1ec.c"
_SRC_TILE = Path(__file__).parent / "oav1tile.c"
_SRC_SSIMU2 = Path(__file__).parent.parent.parent / "metric" / "ssimu2.c"
_SRC_PNG = Path(__file__).parent / "png_unfilter.c"
_SRC_JPEG = Path(__file__).parent.parent.parent / "io" / "jpeg_decode.c"
_SRC_WEBP = Path(__file__).parent.parent.parent / "io" / "webp_decode.c"
_SRC_AV1 = Path(__file__).parent.parent.parent / "io" / "av1_decode.c"
_SRC_AV1_POST = Path(__file__).parent.parent.parent / "io" / "av1_postfilter.c"
_SRC_AV1_GRAIN = Path(__file__).parent.parent.parent / "io" / "av1_grain.c"
_BUILD_DIR = (Path(__file__).resolve().parent.parent.parent.parent
              / "build" / "oavif_tpu_torch")
_SO = _BUILD_DIR / "liboavif_host.so"

_lib: Optional[C.CDLL] = None
_build_failed = False


def _build() -> Optional[C.CDLL]:
    global _build_failed
    if _build_failed:
        return None
    try:
        srcs = [_SRC, _SRC_TILE, _SRC_SSIMU2, _SRC_PNG, _SRC_JPEG, _SRC_WEBP,
                _SRC_AV1, _SRC_AV1_POST, _SRC_AV1_GRAIN]
        hdrs = [_SRC.parent / "idct_ln_impl.h",
                _SRC_AV1.parent / "av1_header.h"]
        newest = max(s.stat().st_mtime for s in srcs + hdrs)
        if not _SO.exists() or _SO.stat().st_mtime < newest:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
                tmp = Path(td) / _SO.name
                subprocess.run(
                    ["gcc", "-O3", "-march=native", "-shared", "-fPIC",
                     "--param", "vect-max-version-for-alias-checks=40",
                     "-o", str(tmp)] + [str(s) for s in srcs] + ["-lm"],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _SO)
        lib = C.CDLL(str(_SO))
        lib.enc_new.restype = C.c_void_p
        lib.enc_done.restype = C.c_size_t
        lib.enc_done.argtypes = [C.c_void_p, C.POINTER(C.POINTER(C.c_uint8))]
        lib.enc_symbol_adapt.argtypes = [
            C.c_void_p, C.POINTER(C.c_uint16), C.c_int, C.c_int,
        ]
        lib.enc_bool.argtypes = [C.c_void_p, C.c_int, C.c_uint32]
        lib.enc_literal.argtypes = [C.c_void_p, C.c_uint32, C.c_int]
        lib.enc_symbol.argtypes = [
            C.c_void_p, C.POINTER(C.c_uint16), C.c_int, C.c_int,
        ]
        lib.enc_free.argtypes = [C.c_void_p]
        lib.inv_txfm2d_c.argtypes = [
            C.POINTER(C.c_int32), C.c_int, C.c_int, C.c_int,
        ]
        _p32 = C.POINTER(C.c_int32)
        _pu16 = C.POINTER(C.c_uint16)
        lib.tile_encode.restype = C.c_size_t
        lib.tile_encode.argtypes = [
            C.POINTER(_p32),   # src_planes
            C.POINTER(_p32),   # recon_out
            C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,  # nplanes,w,h,bd,speed
            C.c_int,           # qindex
            C.c_int, C.c_int, C.c_int,  # dq_dc, dq_ac, dq_ac_uv
            C.POINTER(_pu16),  # cdf_ptrs
            C.POINTER(_p32),   # scans
            C.POINTER(_p32),   # sm_weights
            C.POINTER(C.POINTER(C.c_double)),
            C.POINTER(C.POINTER(C.c_double)),  # fhs, fws (8,16,32,64)
            _p32,              # dr_deriv
            _p32, C.c_int, C.c_int,  # plan, plan_nbx, plan_nby
            _p32, _p32,        # blocks_out, n_blocks_out
            _p32, _p32, C.c_int,  # dec_buf, dec_len_io, dec_mode
            C.c_int,           # screen_tools (palette syntax)
            C.c_int,           # filter_intra (seq enable_filter_intra)
            _p32,              # fi_taps [5][8][8]
            _p32,              # lr_cfg (loop restoration) or NULL
            C.c_int,           # sb128 (seq use_128x128_superblock)
            C.POINTER(C.POINTER(C.c_uint8)),  # out_payload
        ]
        lib.tile_payload_free.argtypes = [C.POINTER(C.c_uint8)]
        lib.loop_filter_frame_c.argtypes = [
            C.POINTER(_p32), C.c_int, C.c_int, C.c_int,
            _p32, C.c_int, _p32, C.c_int, C.c_int, C.c_int, C.c_int,
        ]
        lib.cdef_search_c.restype = C.c_int
        lib.cdef_search_c.argtypes = [
            C.POINTER(_p32), C.POINTER(_p32), C.c_int, C.c_int, C.c_int,
            C.c_int, C.c_int, _p32, C.c_int, _p32, C.c_int, C.c_int,
            C.c_int, C.c_int,
        ]
        lib.cdef_frame_c.argtypes = [
            C.POINTER(_p32), C.c_int, C.c_int, C.c_int,
            _p32, C.c_int, _p32, C.c_int, C.c_int,
        ]
        lib.yuv444_to_rgb8_c.argtypes = [
            C.POINTER(_p32), C.c_int, C.c_int,
            C.POINTER(C.c_float), C.POINTER(C.c_uint8),
        ]
        lib.rgb_to_yuv444_c.argtypes = [
            C.POINTER(C.c_uint8), C.POINTER(C.c_uint16), C.c_int, C.c_int,
            C.POINTER(C.c_float), C.POINTER(_p32),
        ]
        lib.ssimu2_ref_new.restype = C.c_void_p
        lib.ssimu2_ref_new.argtypes = [
            C.POINTER(C.c_uint8), C.c_int, C.c_int,
        ]
        lib.ssimu2_ref_free.argtypes = [C.c_void_p]
        lib.ssimu2_score.restype = C.c_double
        lib.ssimu2_score.argtypes = [C.c_void_p, C.POINTER(C.c_uint8)]
        lib.ssimu2_compute.restype = C.c_double
        lib.ssimu2_compute.argtypes = [
            C.POINTER(C.c_uint8), C.POINTER(C.c_uint8), C.c_int, C.c_int,
        ]
        lib.enc_coeffs.restype = C.c_int
        lib.enc_coeffs.argtypes = [
            C.c_void_p,
            C.POINTER(C.c_int32), C.c_int,
            C.POINTER(C.c_int32),
            C.POINTER(C.c_uint16),
            C.POINTER(C.c_uint16), C.c_int,
            C.POINTER(C.c_uint16),
            C.POINTER(C.c_uint16),
            C.POINTER(C.c_uint16),
            C.POINTER(C.c_uint16),
            C.POINTER(C.c_uint16),
            C.POINTER(C.c_uint16), C.c_int, C.c_int,
            C.POINTER(C.c_int32),
        ]
        lib.png_unfilter.restype = C.c_int
        lib.png_unfilter.argtypes = [
            C.c_void_p, C.c_size_t, C.c_void_p, C.c_int, C.c_int, C.c_int,
        ]
        lib.jpeg_entropy.restype = C.c_int
        lib.jpeg_entropy.argtypes = [
            C.c_char_p, C.c_void_p, C.c_int, C.c_void_p, C.c_void_p,
            C.c_void_p, C.c_int, C.c_int, C.c_int,
        ]
        lib.jpeg_pixels.restype = C.c_int
        lib.jpeg_pixels.argtypes = [
            C.c_void_p, C.c_void_p, C.c_int, C.c_void_p, C.c_int, C.c_int,
            C.c_int, C.c_int, C.c_int, C.c_int, C.c_void_p, C.c_void_p,
        ]
        lib.webp_vp8l_decode.restype = C.c_int
        lib.webp_vp8l_decode.argtypes = [
            C.c_char_p, C.c_size_t, C.c_int, C.c_int, C.c_void_p,
        ]
        lib.webp_vp8_decode.restype = C.c_int
        lib.webp_vp8_decode.argtypes = [
            C.c_char_p, C.c_size_t, C.c_int, C.c_int, C.c_void_p,
            C.c_void_p, C.c_void_p,
        ]
        lib.webp_yuv_to_rgba.restype = None
        lib.webp_yuv_to_rgba.argtypes = [
            C.c_void_p, C.c_void_p, C.c_void_p, C.c_int, C.c_int,
            C.c_void_p, C.c_size_t,
        ]
        lib.webp_alpha_decode.restype = C.c_int
        lib.webp_alpha_decode.argtypes = [
            C.c_char_p, C.c_size_t, C.c_int, C.c_int, C.c_void_p,
        ]
        lib.av1_decode_frame.restype = C.c_int
        lib.av1_decode_frame.argtypes = (
            [C.c_void_p] * 12 + [C.c_void_p, C.c_int] + [C.c_void_p] * 20
            + [C.c_char_p, C.c_int])
        lib.av1_scaled_parity.restype = None
        lib.av1_scaled_parity.argtypes = [C.c_void_p]
        lib.av1_postfilter.restype = C.c_int
        lib.av1_postfilter.argtypes = [C.c_void_p, C.c_int] + [C.c_void_p] * 12
        lib.av1_film_grain.restype = C.c_int
        lib.av1_film_grain.argtypes = [C.c_void_p, C.c_int] + [C.c_void_p] * 4
        return lib
    except Exception:
        _build_failed = True
        return None


def get_lib() -> Optional[C.CDLL]:
    global _lib
    if _lib is None:
        _lib = _build()
    return _lib


def _u16p(arr: np.ndarray):
    return arr.ctypes.data_as(C.POINTER(C.c_uint16))


_fi_taps_cache = None


def _fi_taps_arr() -> np.ndarray:
    """filter-intra taps [5][8][8] as contiguous int32 (av1_tables.npz)."""
    global _fi_taps_cache
    if _fi_taps_cache is None:
        from ..tables import TABLES

        _fi_taps_cache = np.ascontiguousarray(
            TABLES["filter_intra_taps"].reshape(-1), dtype=np.int32
        )
    return _fi_taps_cache


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(C.POINTER(C.c_int32))


class NativeEncoder:
    """Drop-in replacement for RangeEncoder, CDFs as NumPy uint16 rows of
    shape (..., nsym+1) — last element is the adaptation counter."""

    def __init__(self) -> None:
        self.lib = get_lib()
        assert self.lib is not None
        self._enc = self.lib.enc_new()

    def __del__(self) -> None:
        try:
            if self._enc:
                self.lib.enc_free(self._enc)
                self._enc = None
        except Exception:
            pass

    def sym_adapt(self, cdf_row: np.ndarray, s: int) -> None:
        self.lib.enc_symbol_adapt(self._enc, _u16p(cdf_row), len(cdf_row) - 1, s)

    def sym_noadapt(self, cdf_row: np.ndarray, s: int) -> None:
        self.lib.enc_symbol(self._enc, _u16p(cdf_row), len(cdf_row) - 1, s)

    def bool_q15(self, val: int, f: int) -> None:
        self.lib.enc_bool(self._enc, val, f)

    def literal(self, value: int, bits: int) -> None:
        self.lib.enc_literal(self._enc, value, bits)

    def coeffs(
        self,
        levels: np.ndarray,  # (cw, cw) int32, natural order
        scan: np.ndarray,  # (cw*cw,) int32
        txb_skip_row: np.ndarray,
        eob_pt_row: np.ndarray,
        eob_extra_rows: np.ndarray,  # (9, 3)
        base_eob_rows: np.ndarray,  # (4, 4)
        base_rows: np.ndarray,  # (42, 5)
        br_rows: np.ndarray,  # (21, 5)
        dc_sign_row: np.ndarray,
        txtype_row=None,
        txtype_sym: int = 1,
    ):
        cw = levels.shape[0]
        lv = np.ascontiguousarray(levels, dtype=np.int32)
        out_ctx = np.zeros(2, dtype=np.int32)
        eob = self.lib.enc_coeffs(
            self._enc,
            _i32p(lv), cw,
            _i32p(scan),
            _u16p(txb_skip_row),
            _u16p(eob_pt_row), len(eob_pt_row) - 1,
            _u16p(eob_extra_rows),
            _u16p(base_eob_rows),
            _u16p(base_rows),
            _u16p(br_rows),
            _u16p(dc_sign_row),
            _u16p(txtype_row) if txtype_row is not None
            else C.cast(None, C.POINTER(C.c_uint16)),
            (len(txtype_row) - 1) if txtype_row is not None else 0,
            txtype_sym,
            _i32p(out_ctx),
        )
        return eob, int(out_ctx[0]), int(out_ctx[1])

    def done(self) -> bytes:
        ptr = C.POINTER(C.c_uint8)()
        n = self.lib.enc_done(self._enc, C.byref(ptr))
        return bytes(bytearray(C.cast(ptr, C.POINTER(C.c_uint8 * n))[0]))


def inv_txfm2d_native(coeffs: np.ndarray, bitdepth: int = 8) -> Optional[np.ndarray]:
    """Native inverse DCT_DCT 2D transform; None if the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = coeffs.shape
    buf = np.ascontiguousarray(coeffs, dtype=np.int32).copy()
    lib.inv_txfm2d_c(_i32p(buf), w, h, bitdepth)
    return buf.astype(np.int64)


# ---------------------------------------------------------------------------
# Whole-tile native encode (oav1tile.c): the production serial path.
# ---------------------------------------------------------------------------

# Pointer pack order — must match oav1tile.c enum CDF_*.
_CDF_ORDER = (
    "part8", "part16", "part32", "part64",
    "skip", "kf_y", "uv_mode", "uv_mode_cfl", "angle_delta", "txb_skip",
    "eob16", "eob64", "eob256", "eob1024",
    "eob_extra", "coeff_base_eob", "coeff_base", "coeff_br", "dc_sign",
    "cfl_sign", "cfl_alpha", "intra_ext_tx1", "intra_ext_tx2", "tx_size",
    "eob128", "eob512",
    "pal_y_mode", "pal_uv_mode", "pal_y_size",
    "pal_y_ci2", "pal_y_ci3", "pal_y_ci4", "pal_y_ci5", "pal_y_ci6",
    "pal_y_ci7", "pal_y_ci8",
    "fi_use", "fi_mode", "wiener_restore", "part128",
    "sgrproj_restore", "switchable_restore",
)


_FWD_MATS_CACHE = None


def _get_fwd_mats(fwd_matrices):
    """Constant forward-transform matrices for the C coder, built once.

    fwd_matrices() is ~14 ms for the 11 (size, type) pairs — rebuilt per
    tile encode it was the single largest wrapper overhead (the matrices
    depend on nothing per-call). The arrays are kept alive alongside the
    ctypes pointer packs so the C side never sees a dangling pointer.
    """
    global _FWD_MATS_CACHE
    if _FWD_MATS_CACHE is None:
        fmats = [
            tuple(np.ascontiguousarray(m, dtype=np.float64)
                  for m in fwd_matrices(w_, h_, tt))
            for w_, h_, tt in (
                (8, 8, "dct_dct"), (16, 16, "dct_dct"), (32, 32, "dct_dct"),
                (64, 64, "dct_dct"), (8, 8, "adst_adst"),
                (16, 16, "adst_adst"),
                (4, 4, "dct_dct"), (32, 16, "dct_dct"), (16, 32, "dct_dct"),
                (8, 8, "idtx"), (16, 16, "idtx"),
            )
        ]
        fh_ptrs = (C.POINTER(C.c_double) * 11)(
            *[m[0].ctypes.data_as(C.POINTER(C.c_double)) for m in fmats])
        fw_ptrs = (C.POINTER(C.c_double) * 11)(
            *[m[1].ctypes.data_as(C.POINTER(C.c_double)) for m in fmats])
        _FWD_MATS_CACHE = (fmats, fh_ptrs, fw_ptrs)
    return _FWD_MATS_CACHE


def tile_encode_native(planes, qindex, bitdepth=8, speed=9, plan=None,
                       u_ac_delta_q=0, dec=None, screen_tools=False,
                       filter_intra=False, lr=None, sb128=False):
    """Encode one tile entirely in C. Returns (payload bytes, [recon
    planes (h, w) int32]) or None when the native library is unavailable.

    Mirrors frame.py TileEncoder symbol-for-symbol (same CDFs, same mode
    search, same quantizer); conformance-tested against the independent
    decoder in tests/test_conformance.py.
    """
    lib = get_lib()
    if lib is None:
        return None

    from ..consts import coeff_q_ctx
    from ..frame import CdfBank
    from ..tables import TABLES, ac_q, dc_q
    from ..transform import fwd_matrices

    h, w = planes[0].shape
    nplanes = len(planes)
    bank = CdfBank(coeff_q_ctx(qindex))
    cdfs = {
        "part8": bank.partition[8], "part16": bank.partition[16],
        "part32": bank.partition[32], "part64": bank.partition[64],
        "skip": bank.skip, "kf_y": bank.kf_y, "uv_mode": bank.uv_mode,
        "uv_mode_cfl": bank.uv_mode_cfl, "angle_delta": bank.angle_delta,
        "txb_skip": bank.txb_skip,
        "eob16": bank.eob_pt[16], "eob64": bank.eob_pt[64],
        "eob256": bank.eob_pt[256], "eob1024": bank.eob_pt[1024],
        "eob128": bank.eob_pt[128], "eob512": bank.eob_pt[512],
        "pal_y_mode": bank.palette_y_mode,
        "pal_uv_mode": bank.palette_uv_mode,
        "pal_y_size": bank.palette_y_size,
        **{f"pal_y_ci{n}": bank.palette_y_ci[n] for n in range(2, 9)},
        "eob_extra": bank.eob_extra, "coeff_base_eob": bank.coeff_base_eob,
        "coeff_base": bank.coeff_base, "coeff_br": bank.coeff_br,
        "dc_sign": bank.dc_sign,
        "cfl_sign": bank.cfl_sign, "cfl_alpha": bank.cfl_alpha,
        "intra_ext_tx1": bank.intra_ext_tx1,
        "intra_ext_tx2": bank.intra_ext_tx2,
        "tx_size": bank.tx_size,
        "fi_use": bank.filter_intra_use,
        "fi_mode": bank.filter_intra_mode,
        "wiener_restore": bank.wiener_restore,
        "part128": bank.partition[128],
        "sgrproj_restore": bank.sgrproj_restore,
        "switchable_restore": bank.switchable_restore,
    }
    cdf_arrs = [np.ascontiguousarray(cdfs[k], dtype=np.uint16) for k in _CDF_ORDER]
    cdf_ptrs = (C.POINTER(C.c_uint16) * len(cdf_arrs))(*[_u16p(a) for a in cdf_arrs])

    src_arrs = [np.ascontiguousarray(p, dtype=np.int32) for p in planes]
    mi_rows_, mi_cols_ = 2 * ((h + 7) >> 3), 2 * ((w + 7) >> 3)
    recon_arrs = [np.zeros((mi_rows_ * 4, mi_cols_ * 4), dtype=np.int32)
                  for _ in planes]
    src_ptrs = (C.POINTER(C.c_int32) * nplanes)(*[_i32p(a) for a in src_arrs])
    recon_ptrs = (C.POINTER(C.c_int32) * nplanes)(*[_i32p(a) for a in recon_arrs])

    scan_arrs = [
        np.ascontiguousarray(TABLES[f"scan_{n}x{n}"], dtype=np.int32)
        for n in (4, 8, 16, 32)
    ] + [
        np.ascontiguousarray(TABLES["scan_32x16"], dtype=np.int32),
        np.ascontiguousarray(TABLES["scan_16x32"], dtype=np.int32),
    ]
    scan_ptrs = (C.POINTER(C.c_int32) * 6)(*[_i32p(a) for a in scan_arrs])
    sm_arrs = [
        np.ascontiguousarray(TABLES[f"sm_weights_{n}"], dtype=np.int32)
        for n in (4, 8, 16, 32, 64)
    ]
    sm_ptrs = (C.POINTER(C.c_int32) * 5)(*[_i32p(a) for a in sm_arrs])
    dr = np.ascontiguousarray(TABLES["dr_intra_derivative"], dtype=np.int32)

    fmats, fh_ptrs, fw_ptrs = _get_fwd_mats(fwd_matrices)

    plan_arr = None
    plan_ptr = C.POINTER(C.c_int32)()
    nbx = nby = 0
    if plan:
        # packed device-plan buffer (encode_tpu.FramePlanner.plan):
        # [plan64 (sby*sbx)] [mode32 (nby*nbx)] [part32] [mode16 (4x)]
        sby, sbx = plan["plan64"].shape
        nby, nbx = plan["mode32"].shape
        if nby == 2 * sby and nbx == 2 * sbx and nby and nbx:
            plan_arr = np.ascontiguousarray(
                np.concatenate(
                    [
                        plan["plan64"].reshape(-1),
                        plan["mode32"].reshape(-1),
                        plan["part32"].reshape(-1),
                        plan["mode16"].reshape(-1),
                    ]
                ).astype(np.int32)
            )
            plan_ptr = _i32p(plan_arr)
        else:
            nbx = nby = 0

    blocks_buf = np.zeros((mi_rows_ * mi_cols_, 5), dtype=np.int32)
    n_blocks = np.zeros(1, dtype=np.int32)
    out = C.POINTER(C.c_uint8)()
    quv = min(max(qindex + u_ac_delta_q, 0), 255)
    # cross-probe decision reuse: dec = {"mode": 1 record | 2 replay,
    # "buf": int32 array, "len": record capacity / replay length}
    dec_ptr = C.POINTER(C.c_int32)()
    dec_len = None
    dec_mode = 0
    if dec is not None and dec.get("mode"):
        dec_mode = int(dec["mode"])
        dec_ptr = _i32p(dec["buf"])
        dec_len = np.array([int(dec["len"])], dtype=np.int32)
    # loop restoration unit pack: [types[3], unit_shift, urows, ucols,
    # per plane urows*ucols x 7 ints keyed by [0] = unit kind
    # (0 none / 1 wiener taps6 / 2 sgr set,xqd0,xqd1)] (see oav1tile.c)
    lr_ptr = C.POINTER(C.c_int32)()
    lr_arr = None
    if lr is not None:
        from ..restoration import count_units, unit_size

        usz = unit_size(int(lr["unit_shift"]))
        urows, ucols = count_units(h, usz), count_units(w, usz)
        types3 = [int(lr["types"][p]) if p < len(lr["types"]) else 0
                  for p in range(3)]
        vals = types3 + [int(lr["unit_shift"]), urows, ucols]
        for p in range(3):
            wg = lr.get("wiener", {}).get(p) if types3[p] else None
            sg = lr.get("sgrproj", {}).get(p) if types3[p] else None
            for ur in range(urows):
                for uc in range(ucols):
                    taps = wg[ur][uc] if wg is not None else None
                    entry = sg[ur][uc] if sg is not None else None
                    if taps is not None:
                        vals += [1] + [int(x) for x in taps]
                    elif entry is not None:
                        vals += [2, int(entry[0]), int(entry[1]),
                                 int(entry[2]), 0, 0, 0]
                    else:
                        vals += [0, 0, 0, 0, 0, 0, 0]
        lr_arr = np.asarray(vals, dtype=np.int32)
        lr_ptr = _i32p(lr_arr)
    dump_dir = os.environ.get("OAVIF_DUMP_TILE_INPUTS")
    if dump_dir:
        # marshal-time dump for tools/profile_c_tile.py's gprof harness:
        # written HERE so the dump tracks the real ABI by construction
        from pathlib import Path as _P

        dd = _P(dump_dir)
        dd.mkdir(parents=True, exist_ok=True)
        for i, a in enumerate(src_arrs):
            a.tofile(dd / f"src_{i}.bin")
        for i, a in enumerate(cdf_arrs):
            a.tofile(dd / f"cdf_{i}.bin")
        for i, a in enumerate(scan_arrs):
            a.tofile(dd / f"scan_{i}.bin")
        for i, a in enumerate(sm_arrs):
            a.tofile(dd / f"sm_{i}.bin")
        for i, (fhm, fwm) in enumerate(fmats):
            fhm.tofile(dd / f"fh_{i}.bin")
            fwm.tofile(dd / f"fw_{i}.bin")
        dr.tofile(dd / "dr.bin")
        if nbx > 0:
            plan_arr.tofile(dd / "plan.bin")
        if dec_mode:
            np.ascontiguousarray(dec["buf"], np.int32).tofile(dd / "dec.bin")
        _fi_taps_arr().tofile(dd / "fi.bin")
        if lr_arr is not None:
            lr_arr.tofile(dd / "lr.bin")
        (dd / "meta.txt").write_text(
            f"{w} {h} {nplanes} {bitdepth} {speed} {qindex} "
            f"{int(dc_q(qindex, bitdepth))} {int(ac_q(qindex, bitdepth))} "
            f"{int(ac_q(quv, bitdepth))} {nbx} {nby} "
            f"{dec_mode} {int(dec['len']) if dec_mode else 0} "
            f"{1 if screen_tools else 0} {1 if filter_intra else 0} "
            f"{1 if lr_arr is not None else 0} {1 if sb128 else 0} "
            f"{len(cdf_arrs)}\n"
        )
    n = lib.tile_encode(
        src_ptrs, recon_ptrs,
        nplanes, w, h, bitdepth, speed, qindex,
        int(dc_q(qindex, bitdepth)), int(ac_q(qindex, bitdepth)),
        int(ac_q(quv, bitdepth)),
        cdf_ptrs, scan_ptrs, sm_ptrs,
        fh_ptrs, fw_ptrs,
        _i32p(dr),
        plan_ptr, nbx, nby,
        _i32p(blocks_buf), _i32p(n_blocks),
        dec_ptr,
        _i32p(dec_len) if dec_len is not None else C.POINTER(C.c_int32)(),
        dec_mode,
        1 if screen_tools else 0,
        1 if filter_intra else 0,
        _i32p(_fi_taps_arr()),
        lr_ptr,
        1 if sb128 else 0,
        C.byref(out),
    )
    if dec is not None and dec_mode == 1 and dec_len is not None:
        dec["len"] = int(dec_len[0])
    payload = bytes(bytearray(C.cast(out, C.POINTER(C.c_uint8 * n))[0]))
    lib.tile_payload_free(out)
    blocks = [tuple(map(int, row)) for row in blocks_buf[: int(n_blocks[0])]]
    return payload, recon_arrs, blocks



def _blocks_arr(blocks):
    """Normalize block records to the 5-int (r, c, size, skip, y_tx)
    layout the C post-filters read (legacy 4-tuples get y_tx = tx ==
    block, i.e. min(size, 64))."""
    if not blocks:
        return np.zeros((0, 5), np.int32)
    arr = np.array(blocks, dtype=np.int32).reshape(len(blocks), -1)
    if arr.shape[1] == 4:
        arr = np.column_stack([arr, np.minimum(arr[:, 2], 64)])
    return np.ascontiguousarray(arr)

def loop_filter_native(planes, blocks, levels, sharpness, bitdepth,
                       vis_h=0, vis_w=0) -> bool:
    """In-place native deblocking; False if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    h, w = planes[0].shape
    arrs = []
    for i, p in enumerate(planes):
        a = np.ascontiguousarray(p, dtype=np.int32)
        arrs.append(a)
    ptrs = (C.POINTER(C.c_int32) * len(arrs))(*[_i32p(a) for a in arrs])
    blk = _blocks_arr(blocks)
    lv = np.array(levels, dtype=np.int32)
    lib.loop_filter_frame_c(ptrs, len(arrs), w, h, _i32p(blk), len(blk),
                            _i32p(lv), sharpness, bitdepth, vis_h, vis_w)
    for p, a in zip(planes, arrs):
        if a is not p:
            p[:] = a
    return True


def yuv444_to_rgb8_native(planes, bitdepth, inv_mat) -> "Optional[np.ndarray]":
    """One-pass native [y,u,v] int32 planes -> (h, w, 3) uint8 RGB.
    None when the library is unavailable (caller falls back to numpy)."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = planes[0].shape
    arrs = [np.ascontiguousarray(p, dtype=np.int32) for p in planes]
    ptrs = (C.POINTER(C.c_int32) * 3)(*[_i32p(a) for a in arrs])
    inv = np.ascontiguousarray(inv_mat, dtype=np.float32)
    out = np.empty((h, w, 3), dtype=np.uint8)
    lib.yuv444_to_rgb8_c(ptrs, h * w, bitdepth,
                         inv.ctypes.data_as(C.POINTER(C.c_float)),
                         out.ctypes.data_as(C.POINTER(C.c_uint8)))
    return out


def rgb_to_yuv444_native(rgb, bitdepth, fwd_mat):
    """One-pass native (h, w, 3) uint8/uint16 RGB -> [y,u,v] int32 planes.
    None when the library is unavailable (caller falls back to numpy)."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = rgb.shape[:2]
    fwd = np.ascontiguousarray(fwd_mat, dtype=np.float32)
    outs = [np.empty((h, w), dtype=np.int32) for _ in range(3)]
    ptrs = (C.POINTER(C.c_int32) * 3)(*[_i32p(a) for a in outs])
    fp = fwd.ctypes.data_as(C.POINTER(C.c_float))
    if rgb.dtype == np.uint8:
        a = np.ascontiguousarray(rgb)
        lib.rgb_to_yuv444_c(a.ctypes.data_as(C.POINTER(C.c_uint8)),
                            C.cast(None, C.POINTER(C.c_uint16)),
                            h * w, bitdepth, fp, ptrs)
    else:
        a = np.ascontiguousarray(rgb, dtype=np.uint16)
        lib.rgb_to_yuv444_c(C.cast(None, C.POINTER(C.c_uint8)),
                            a.ctypes.data_as(C.POINTER(C.c_uint16)),
                            h * w, bitdepth, fp, ptrs)
    return outs


def cdef_frame_native(planes, blocks, strengths, damping, bitdepth) -> bool:
    """In-place native CDEF on padded planes; False if lib unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    h, w = planes[0].shape
    arrs = [np.ascontiguousarray(p, dtype=np.int32) for p in planes]
    ptrs = (C.POINTER(C.c_int32) * len(arrs))(*[_i32p(a) for a in arrs])
    blk = _blocks_arr(blocks)
    st = np.array(strengths, dtype=np.int32)
    lib.cdef_frame_c(ptrs, len(arrs), w, h, _i32p(blk), len(blk),
                     _i32p(st), damping, bitdepth)
    for p, a in zip(planes, arrs):
        if a is not p:
            p[:] = a
    return True


def cdef_search_native(src_planes, recon_planes, blocks, cands, damping,
                       bitdepth, vis_h, vis_w, sample_log2=2):
    """Pick the SSE-best CDEF strength set; returns an index into cands
    (or 0 = off when the library is unavailable)."""
    lib = get_lib()
    if lib is None:
        return 0
    h, w = recon_planes[0].shape
    sarrs = [np.ascontiguousarray(p, dtype=np.int32) for p in src_planes]
    rarrs = [np.ascontiguousarray(p, dtype=np.int32) for p in recon_planes]
    sptrs = (C.POINTER(C.c_int32) * len(sarrs))(*[_i32p(a) for a in sarrs])
    rptrs = (C.POINTER(C.c_int32) * len(rarrs))(*[_i32p(a) for a in rarrs])
    blk = _blocks_arr(blocks)
    cd = np.ascontiguousarray(np.array(cands, dtype=np.int32).reshape(-1, 4))
    return int(lib.cdef_search_c(
        sptrs, rptrs, len(rarrs), w, h, vis_w, vis_h,
        _i32p(blk), len(blk), _i32p(cd), len(cd),
        damping, bitdepth, sample_log2))
