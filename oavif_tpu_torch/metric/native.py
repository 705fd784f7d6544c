"""Host-native SSIMULACRA2 (``ssimu2.c``, a copy of the reference's) with a
reference-context cache; the counterpart of oavif_tpu/metric/native.py,
whose package imports the JAX metric eagerly.

``OAVIF_METRIC=c|jax|auto`` selects the scorer as in the reference: ``c``
(and ``auto``) the C scorer, ``jax`` the device metric
(``ssimulacra2.py``; the reference's spelling is kept so that one
environment drives both packages). A native library that fails to build
raises rather than scoring somewhere else.
"""

from __future__ import annotations

import ctypes as C
import os
import zlib

import numpy as np

from ..av1.entropy.fast import get_lib


def _lib() -> C.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "native library unavailable: the C runtime "
            "(oavif_tpu_torch/av1/entropy, metric/ssimu2.c) failed to "
            "build")
    return lib


class _RefCtx:
    """Owns one ssimu2 reference context (pyramid + ref statistics)."""

    def __init__(self, ref_rgb8: np.ndarray) -> None:
        self.lib = _lib()
        a = np.ascontiguousarray(ref_rgb8, dtype=np.uint8)
        h, w = a.shape[:2]
        self.h, self.w = h, w
        self._ctx = self.lib.ssimu2_ref_new(
            a.ctypes.data_as(C.POINTER(C.c_uint8)), w, h
        )

    def score(self, dist_rgb8: np.ndarray) -> float:
        d = np.ascontiguousarray(dist_rgb8, dtype=np.uint8)
        if d.shape[:2] != (self.h, self.w):
            raise ValueError(
                f"shape mismatch {d.shape[:2]} vs {(self.h, self.w)}")
        return float(
            self.lib.ssimu2_score(self._ctx,
                                  d.ctypes.data_as(C.POINTER(C.c_uint8)))
        )

    def __del__(self) -> None:
        if getattr(self, "_ctx", None):
            self.lib.ssimu2_ref_free(self._ctx)
            self._ctx = None


# LRU of reference contexts keyed by a full-content digest (crc32 of the
# bytes): the TQ loop scores many probes against one reference
_CTX_CACHE: dict = {}
_CTX_MAX = 4


def _get_ctx(ref_rgb8: np.ndarray) -> _RefCtx:
    a = np.ascontiguousarray(ref_rgb8, dtype=np.uint8)
    key = (a.shape, zlib.crc32(a.tobytes()))
    ctx = _CTX_CACHE.pop(key, None)  # re-inserted below: LRU order
    if ctx is None:
        while len(_CTX_CACHE) >= _CTX_MAX:
            _CTX_CACHE.pop(next(iter(_CTX_CACHE)))
        ctx = _RefCtx(a)
    _CTX_CACHE[key] = ctx
    return ctx


def compute_ssimulacra2_native(ref_rgb8, dist_rgb8) -> float:
    """Score two (H, W, 3) uint8 RGB images natively. Ref-side statistics
    are cached across calls."""
    if ref_rgb8.shape != dist_rgb8.shape:
        raise ValueError(f"shape mismatch {ref_rgb8.shape} vs {dist_rgb8.shape}")
    if ref_rgb8.shape[0] < 8 or ref_rgb8.shape[1] < 8:
        raise ValueError("SSIMULACRA2 requires images at least 8x8")
    return _get_ctx(ref_rgb8).score(dist_rgb8)


def metric_impl() -> str:
    """Selected implementation: 'c' (OAVIF_METRIC=c or auto) or 'jax' (the
    device metric, OAVIF_METRIC=jax)."""
    mode = os.environ.get("OAVIF_METRIC", "auto").lower()
    if mode == "jax":
        return "jax"
    if mode not in ("c", "auto"):
        raise ValueError(f"unknown OAVIF_METRIC {mode!r}")
    _lib()
    return "c"


def score_batch_auto(ref_rgb8, dist_batch) -> np.ndarray:
    """Score a (N, H, W, 3) batch against one reference with the selected
    implementation (the C loop, or one pass of the device kernels)."""
    if metric_impl() == "jax":
        from .ssimulacra2 import compute_ssimulacra2_batch

        return compute_ssimulacra2_batch(ref_rgb8, dist_batch)
    ctx = _get_ctx(ref_rgb8)
    return np.array([ctx.score(d) for d in dist_batch], dtype=np.float64)
