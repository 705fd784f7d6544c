"""The device encode stage on the GPU: the counterpart of
oavif_tpu/av1/device_stage.py.

Given the plan's mode of every 16x16 luma block, one launch computes the
forward DCT16 of each block's open-loop residual against its planned
intra prediction from SOURCE edges (the planner's edges); a second launch
quantizes those coefficients at a batch of quantizers with round-half
rounding and finds each block's eob in scan order. The Python tile coder
(``frame.TileEncoder``) consumes the levels of the blocks whose
recon-edge prediction still matches the source-edge one, and keeps the
exact dequantization and inverse transform, so the stream stays
conformant whatever the levels.

The kernels are hand-written CUDA (``csrc/device_stage.cu``):
``coeffs16`` (K3a) and ``quant16`` (K3b) launch them on a CUDA tensor and
run their plain PyTorch versions ``coeffs16_plain`` and ``quant16_plain``
on a CPU tensor; any other device raises. ``coeffs16_simple`` and
``quant16_simple`` launch the first K3a and K3b kernels, kept as the
yardsticks that ``coeffs16`` and ``quant16`` equal bit for bit; no path
calls them. The levels reach the host in one copy into page-locked
memory (``fetch``).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import launch
from .encode_tpu import N_MODES, _device_tables, _grid_edges, _predictions
from .tables import TABLES, ac_q, dc_q

LEVEL_MAX = 16383


@functools.lru_cache(maxsize=None)
def fwd_mats16() -> Tuple[np.ndarray, np.ndarray]:
    """(fh, fw): the 16x16 DCT_DCT forward matrices as float32, so that
    coeffs = fh @ residual @ fw.T."""
    from .transform import fwd_matrices

    fh, fw = fwd_matrices(16, 16, "dct_dct")
    return np.asarray(fh, np.float32), np.asarray(fw, np.float32)


@functools.lru_cache(maxsize=None)
def iscan16() -> np.ndarray:
    """(256,) int32: the scan position of each natural (row-major) index
    of a 16x16 block (the inverse of TABLES["scan_16x16"])."""
    scan = np.asarray(TABLES["scan_16x16"], np.int64)
    inv = np.empty(256, np.int32)
    inv[scan] = np.arange(256, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=None)
def _device_consts(device: torch.device):
    """(fh, fw, iscan) on ``device``."""
    fh, fw = fwd_mats16()
    return (torch.as_tensor(fh, device=device),
            torch.as_tensor(fw, device=device),
            torch.as_tensor(iscan16(), device=device))


def coeffs16_plain(plane: torch.Tensor, nby: int, nbx: int,
                   modes16: torch.Tensor, bitdepth: int) -> torch.Tensor:
    """Forward coefficients (n, 16, 16) float32 of every 16-block's
    open-loop residual under its planned mode; the plain PyTorch version
    of K3a and the counterpart of the reference's _coeffs_body.

    plane: the (+1,+1)-padded int16 plane of at least (16*nby+1,
    16*nbx+1); modes16: (nby, nbx) int32 mode indices 0..6. Predictions and
    residuals are exact integers; the two products run in float32."""
    p = plane.to(torch.int32)
    base = 1 << (bitdepth - 1)
    blocks, above, left, corner = _grid_edges(p, nby, nbx, 16, base)
    preds = torch.stack(list(_predictions(above, left, corner, 16, N_MODES)),
                        1)
    m = modes16.reshape(-1).long().to(preds.device)
    pred = preds[torch.arange(preds.shape[0], device=preds.device), m]
    resid = (blocks - pred).to(torch.float32)
    fh, fw, _ = _device_consts(plane.device)
    return torch.matmul(torch.matmul(fh, resid), fw.t())


@functools.lru_cache(maxsize=None)
def _host_consts() -> tuple:
    """((smooth weights int32 (16,), fh, fw) as contiguous host arrays,
    their addresses): K3a takes them in its launch's parameter block; the
    cache keeps the arrays alive."""
    fh, fw = fwd_mats16()
    arrays = (np.ascontiguousarray(TABLES["sm_weights_16"], np.int32),
              np.ascontiguousarray(fh), np.ascontiguousarray(fw))
    return arrays, tuple(a.ctypes.data for a in arrays)


def _launch_coeffs(wrapper, entry: str, plane: torch.Tensor, nby: int,
                   nbx: int, modes16: torch.Tensor, bitdepth: int,
                   consts) -> torch.Tensor:
    """Check a CUDA plane, grid and modes, and launch ``entry`` with the
    (smooth weights, fh, fw) pointers ``consts``."""
    name = wrapper.__name__
    if plane.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {plane.device}")
    if (plane.dtype != torch.int16 or plane.dim() != 2
            or not plane.is_contiguous()):
        raise ValueError(f"{name}: plane must be a contiguous 2-D int16 "
                         "tensor")
    if (nby <= 0 or nbx <= 0 or plane.shape[0] < 16 * nby + 1
            or plane.shape[1] < 16 * nbx + 1):
        raise ValueError(f"{name}: a {nby}x{nbx} grid does not fit a "
                         f"{tuple(plane.shape)} plane")
    modes = modes16.to(device=plane.device, dtype=torch.int32).contiguous()
    if modes.numel() != nby * nbx:
        raise ValueError(f"{name}: {modes.numel()} modes for a {nby}x{nbx} "
                         "grid")
    out = torch.empty((nby * nbx, 16, 16), dtype=torch.float32,
                      device=plane.device)
    launch(wrapper, entry, plane, plane.data_ptr(), plane.shape[1], nby, nbx,
           1 << (bitdepth - 1), modes.data_ptr(), *consts, out.data_ptr())
    return out


def coeffs16(plane: torch.Tensor, nby: int, nbx: int,
             modes16: torch.Tensor, bitdepth: int) -> torch.Tensor:
    """coeffs16_plain's result; on a CUDA tensor from kernel K3a
    (``dstage_coeffs16``, counted in ``coeffs16.launches``), on a CPU
    tensor from the plain version. Any other device raises."""
    if plane.device.type == "cpu":
        return coeffs16_plain(plane, nby, nbx, modes16, bitdepth)
    return _launch_coeffs(coeffs16, "dstage_coeffs16", plane, nby, nbx,
                          modes16, bitdepth, _host_consts()[1])


coeffs16.launches = 0


def coeffs16_simple(plane: torch.Tensor, nby: int, nbx: int,
                    modes16: torch.Tensor, bitdepth: int) -> torch.Tensor:
    """``coeffs16`` through the first K3a kernel (``dstage_coeffs16_simple``,
    one thread block per 16-block, both products out of shared memory),
    which the source keeps as the yardstick: each output's two FMA chains
    run in the same k order on the same operands, so the two kernels give
    the same bits. No path calls it; the card tests and ``chip_smoke.py``
    hold ``coeffs16`` to it and time the two in one call. Counted in
    ``coeffs16_simple.launches``."""
    if plane.device.type == "cpu":
        return coeffs16_plain(plane, nby, nbx, modes16, bitdepth)
    fh, fw, _ = _device_consts(plane.device)
    smw = _device_tables(16, plane.device)[0]
    return _launch_coeffs(coeffs16_simple, "dstage_coeffs16_simple", plane,
                          nby, nbx, modes16, bitdepth,
                          [t.data_ptr() for t in (smw, fh, fw)])


coeffs16_simple.launches = 0


def level_buffers(k: int, n: int, device) -> tuple:
    """One uint8 allocation holding levels (k, n, 256) int16 and eob
    (k, n) int32, so that both reach the host in one copy. Returns
    (buffer, levels view, eob view)."""
    nlv = k * n * 256 * 2
    buf = torch.empty(nlv + k * n * 4, dtype=torch.uint8, device=device)
    return (buf, buf[:nlv].view(torch.int16).view(k, n, 256),
            buf[nlv:].view(torch.int32).view(k, n))


def quant16_plain(coeffs: torch.Tensor, dq_dc: torch.Tensor,
                  dq_ac: torch.Tensor, shift: int = 0, out=None) -> tuple:
    """Round-half quantization of (n, 16, 16) float32 coefficients at k
    quantizers (dq_dc, dq_ac: (k,) float32); the plain PyTorch version of
    K3b and the counterpart of the reference's vmapped _quant_body.

    Returns levels (k, n, 256) int16 in natural order and eob (k, n) int32
    (the last nonzero level's scan position + 1, 0 when none), written into
    ``out`` = (levels, eob) when given. The reference's operation order:
    floor(|c| * 2^shift / dq + 0.5), the sign, a clip to +-16383."""
    n = coeffs.shape[0]
    cf = coeffs.reshape(1, n, 256)
    dq = dq_ac.to(torch.float32)[:, None, None].expand(-1, 1, 256).clone()
    dq[:, :, 0] = dq_dc.to(torch.float32)[:, None]
    up = torch.tensor(float(1 << shift), dtype=torch.float32,
                      device=coeffs.device)
    mag = torch.floor(cf.abs() * up / dq + 0.5)
    lv = torch.where(cf < 0, -mag, mag).clamp(-LEVEL_MAX, LEVEL_MAX)
    lv = lv.to(torch.int16)
    iscan = _device_consts(coeffs.device)[2]
    eob = torch.where(lv != 0, iscan.to(torch.int32) + 1, 0).amax(2)
    eob = eob.to(torch.int32)
    if out is None:
        return lv, eob
    out[0].copy_(lv)
    out[1].copy_(eob)
    return out


def _launch_quant(wrapper, entry: str, coeffs: torch.Tensor,
                  dq_dc: torch.Tensor, dq_ac: torch.Tensor, shift: int,
                  out) -> tuple:
    """Check CUDA coefficients, quantizers and outputs, and launch
    ``entry``. The coefficients and the levels must be 16-byte aligned
    (the kernel moves them in 16-byte words); nothing falls back."""
    name = wrapper.__name__
    if coeffs.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {coeffs.device}")
    if (coeffs.dtype != torch.float32 or coeffs.dim() != 3
            or tuple(coeffs.shape[1:]) != (16, 16)
            or not coeffs.is_contiguous()):
        raise ValueError(f"{name}: coefficients must be a contiguous "
                         "(n, 16, 16) float32 tensor")
    n, k = coeffs.shape[0], dq_ac.numel()
    dqd = dq_dc.to(device=coeffs.device, dtype=torch.float32).contiguous()
    dqa = dq_ac.to(device=coeffs.device, dtype=torch.float32).contiguous()
    if n <= 0 or k <= 0 or dqd.numel() != k:
        raise ValueError(f"{name}: {n} blocks, {dqd.numel()} DC and {k} AC "
                         "quantizers")
    if out is None:
        _, lv, eob = level_buffers(k, n, coeffs.device)
    else:
        lv, eob = out
        if (lv.shape != (k, n, 256) or lv.dtype != torch.int16
                or eob.shape != (k, n) or eob.dtype != torch.int32
                or not (lv.is_contiguous() and eob.is_contiguous())):
            raise ValueError(f"{name}: out must be contiguous (k, n, 256) "
                             "int16 and (k, n) int32 tensors")
    if coeffs.data_ptr() % 16 or lv.data_ptr() % 16:
        raise ValueError(f"{name}: coefficients and levels must be 16-byte "
                         "aligned")
    iscan = _device_consts(coeffs.device)[2]
    launch(wrapper, entry, coeffs, coeffs.data_ptr(), n, k, dqd.data_ptr(),
           dqa.data_ptr(), float(1 << shift), iscan.data_ptr(),
           lv.data_ptr(), eob.data_ptr())
    return lv, eob


def quant16(coeffs: torch.Tensor, dq_dc: torch.Tensor, dq_ac: torch.Tensor,
            shift: int = 0, out=None) -> tuple:
    """quant16_plain's result; on a CUDA tensor from kernel K3b
    (``dstage_quant16``, one warp per block, the coefficients read once for
    all k quantizers; counted in ``quant16.launches``), on a CPU tensor
    from the plain version. Any other device, or coefficients or levels
    off 16-byte alignment, raises ValueError."""
    if coeffs.device.type == "cpu":
        return quant16_plain(coeffs, dq_dc, dq_ac, shift, out)
    return _launch_quant(quant16, "dstage_quant16", coeffs, dq_dc, dq_ac,
                         shift, out)


quant16.launches = 0


def quant16_simple(coeffs: torch.Tensor, dq_dc: torch.Tensor,
                   dq_ac: torch.Tensor, shift: int = 0, out=None) -> tuple:
    """``quant16`` through the first K3b kernel
    (``dstage_quant16_simple``, one thread per coefficient and quantizer),
    which the source keeps as the yardstick: both kernels round every
    level through the same operations, so they give the same bits. No path
    calls it; the card tests and ``chip_smoke.py`` hold ``quant16`` to it
    and time the two in one call. Counted in
    ``quant16_simple.launches``."""
    if coeffs.device.type == "cpu":
        return quant16_plain(coeffs, dq_dc, dq_ac, shift, out)
    return _launch_quant(quant16_simple, "dstage_quant16_simple", coeffs,
                         dq_dc, dq_ac, shift, out)


quant16_simple.launches = 0


def fetch(buf: torch.Tensor) -> np.ndarray:
    """A 1-D uint8 buffer as a numpy array that owns its memory. From the
    card it is copied into a page-locked host tensor of PyTorch's caching
    host allocator (the array keeps that tensor alive, so a later fetch
    never reuses its block); a CPU buffer is returned as it is (the CPU
    build of torch cannot pin)."""
    if buf.device.type == "cpu":
        return buf.numpy()
    host = torch.empty(buf.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(buf)
    return host.numpy()


class DeviceLevels:
    """Holds one planner's coefficient cache on the device (per plan's
    modes) and serves per-probe, or per-probe-batch, levels.

    ``last_fetch_s`` is the host wall time of the last levels fetch: the
    device-to-host copy alone, after the launches have finished."""

    def __init__(self, planner, bitdepth: int = 8):
        self.planner = planner
        self.bitdepth = bitdepth
        self._coeff_key: Optional[bytes] = None
        self._coeffs: Optional[torch.Tensor] = None
        self.last_fetch_s = 0.0

    def _ensure_coeffs(self, modes16: np.ndarray) -> None:
        key = modes16.tobytes()
        if self._coeff_key == key:
            return
        pl = self.planner
        nby, nbx = pl.sby * 4, pl.sbx * 4
        if modes16.shape != (nby, nbx):
            raise ValueError(f"DeviceLevels: modes {modes16.shape} for a "
                             f"{nby}x{nbx} grid of 16-blocks")
        if modes16.min() < 0 or modes16.max() >= N_MODES:
            raise ValueError("DeviceLevels: mode indices outside 0..6")
        y = pl.dev[0]
        self._coeffs = coeffs16(y, nby, nbx,
                                torch.from_numpy(modes16).to(y.device),
                                self.bitdepth)
        self._coeff_key = key

    def levels(self, modes16: np.ndarray, qindexes) -> tuple:
        """modes16: (4*sby, 4*sbx) mode indices 0..6 of the planner's
        16-blocks; qindexes: iterable of qindex ints. Returns (levels
        (k, n, 256) int16 natural order, eob (k, n) int32) as numpy, from
        one host fetch into page-locked memory (``fetch``); each result
        owns its memory, so a later probe leaves it unchanged."""
        self._ensure_coeffs(np.ascontiguousarray(modes16, np.int32))
        qs = list(qindexes)
        dev = self._coeffs.device
        dqd = torch.tensor([float(dc_q(q, self.bitdepth)) for q in qs],
                           dtype=torch.float32, device=dev)
        dqa = torch.tensor([float(ac_q(q, self.bitdepth)) for q in qs],
                           dtype=torch.float32, device=dev)
        k, n = len(qs), self._coeffs.shape[0]
        buf, lv, eob = level_buffers(k, n, dev)
        quant16(self._coeffs, dqd, dqa, 0, out=(lv, eob))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # time the copy alone
        t0 = time.perf_counter()
        host = fetch(buf)
        self.last_fetch_s = time.perf_counter() - t0
        nlv = k * n * 256 * 2
        return (host[:nlv].view(np.int16).reshape(k, n, 256),
                host[nlv:].view(np.int32).reshape(k, n))


_CALIB: Optional[bool] = None


def device_levels_enabled(n_blocks: int = 1024) -> bool:
    """Whether the Python tile coder takes the device stage's levels.

    OAVIF_DEVICE_LEVELS unset or ``0``: off (the default, as in the
    reference: the C coder does not consume device levels, and the
    byte-identical C/Python invariant holds only when both coders choose
    the same levels); ``1``: on; anything else (``auto``): once per
    process, on when one timed ``fetch`` (the levels' own route) of
    n_blocks' levels from the port's device takes under 15 ms, the
    reference's threshold (the host transform and quantization it replaces
    take ~45 ms a frame)."""
    global _CALIB
    env = os.environ.get("OAVIF_DEVICE_LEVELS", "0")
    if env == "1":
        return True
    if env == "0":
        return False
    if _CALIB is None:
        x = torch.zeros(n_blocks * 256 * 2, dtype=torch.uint8,
                        device=resolve_device())
        fetch(x + 1)  # warm up the allocators and the copy path
        y = x + 1
        if y.device.type == "cuda":
            torch.cuda.synchronize(y.device)  # time the copy alone
        t0 = time.perf_counter()
        fetch(y)
        _CALIB = time.perf_counter() - t0 < 0.015
    return _CALIB
