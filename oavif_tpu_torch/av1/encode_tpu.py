"""Frame planner on the GPU: the counterpart of oavif_tpu/av1/encode_tpu.py.

One planning step per probe predicts every block at the 64, 32 and 16
grids with every candidate intra mode from source edges, scores each by
SSD, and turns the scores into the packed plan the C tile coder executes
(64-NONE with the luma and chroma flat gates, the 32-split with the q<=90
gate, argmin modes with runner-up or directional nominees).

``plan_device`` is the whole step: on a CUDA tensor one launch of the
hand-written kernel ``planner_plan`` (``csrc/planner.cu``), on a CPU tensor
its plain PyTorch version ``plan_device_plain``. Both compute the exact
integer SSD, convert it once to float32 and mirror the reference's float32
decisions, bit for bit with each other. ``mode_ssd`` (the first planner
kernel, one launch per grid and plane) stays for ``plan_device_plain(...,
ssd=mode_ssd)``, the yardstick that no path takes.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import launch
from .tables import TABLES, ac_q

# spec mode ids in search order: DC, V, H, SMOOTH, PAETH, SMOOTH_V,
# SMOOTH_H, then the 6 directional families (D45, D135, D113, D157, D203,
# D67); copied from the reference, which imports JAX at the top
MODE_IDS = np.array([0, 1, 2, 9, 12, 10, 11, 3, 4, 5, 6, 7, 8],
                    dtype=np.int32)
N_MODES = 7
N_MODES_DIR = 13
N_BASE = 5
_DIR_ANGLES = (45, 135, 113, 157, 203, 67)  # matches MODE_IDS[7:]


@functools.lru_cache(maxsize=None)
def dir_taps(n_px: int):
    """Directional prediction (spec 7.11.2.4, zero angle delta) of the 6
    non-cardinal families as two taps per output: (idx, w), each
    (6, P*P, 2), so that pred = (w0*E[i0] + w1*E[i1] + 16) >> 5 over the
    edge vector E = [corner, above, above[P-1] x P, corner, left,
    left[P-1] x P]. The same spec formulas as the reference's
    _dir_weight_matrix (tests pin the equality)."""
    P = n_px
    L = 2 * P + 1
    dr = np.asarray(TABLES["dr_intra_derivative"], dtype=np.int64)
    r = np.broadcast_to(np.arange(P)[:, None], (P, P))
    c = np.broadcast_to(np.arange(P)[None, :], (P, P))
    mx = 2 * P - 1
    idx = np.zeros((len(_DIR_ANGLES), P, P, 2), np.int64)
    w = np.zeros((len(_DIR_ANGLES), P, P, 2), np.int64)
    for mi, angle in enumerate(_DIR_ANGLES):
        if angle < 90:
            x = (r + 1) * int(dr[angle])
            b = (x >> 6) + c
            sh = (x >> 1) & 0x1F
            idx[mi, ..., 0] = np.minimum(b, mx) + 1
            idx[mi, ..., 1] = np.minimum(b + 1, mx) + 1
        elif angle > 180:
            y = (c + 1) * int(dr[270 - angle])
            b = (y >> 6) + r
            sh = (y >> 1) & 0x1F
            idx[mi, ..., 0] = L + np.minimum(b, mx) + 1
            idx[mi, ..., 1] = L + np.minimum(b + 1, mx) + 1
        else:
            x = (c << 6) - (r + 1) * int(dr[180 - angle])
            y = (r << 6) - (c + 1) * int(dr[angle - 90])
            bx, by = x >> 6, y >> 6
            use_above = bx >= -1
            i_a = np.clip(bx + 1, 0, 2 * P)
            i_l = L + np.clip(by + 1, 0, 2 * P)
            idx[mi, ..., 0] = np.where(use_above, i_a, i_l)
            idx[mi, ..., 1] = np.where(use_above, np.clip(bx + 2, 0, 2 * P),
                                       L + np.clip(by + 2, 0, 2 * P))
            sh = np.where(use_above, (x >> 1) & 0x1F, (y >> 1) & 0x1F)
        w[mi, ..., 0] = 32 - sh
        w[mi, ..., 1] = sh
    return idx.reshape(-1, P * P, 2), w.reshape(-1, P * P, 2)


@functools.lru_cache(maxsize=None)
def _device_tables(n_px: int, device: torch.device):
    """(smooth weights int32 (P,), tap idx int16, tap w int16) on device."""
    idx, w = dir_taps(n_px)
    return (
        torch.as_tensor(np.asarray(TABLES[f"sm_weights_{n_px}"]),
                        dtype=torch.int32, device=device),
        torch.as_tensor(idx, dtype=torch.int16, device=device).contiguous(),
        torch.as_tensor(w, dtype=torch.int16, device=device).contiguous(),
    )


def _grid_edges(p, nby: int, nbx: int, n_px: int, base: int):
    """Blocks (n, P, P) and source edges above/left (n, P), corner (n,)
    at an n_px grid from the (+1,+1)-padded int32 plane, with the
    decoder's unavailability fills (spec 7.11.2), filled in the
    reference's order."""
    H, W = nby * n_px, nbx * n_px
    n = nby * nbx
    blocks = (p[1 : 1 + H, 1 : 1 + W].reshape(nby, n_px, nbx, n_px)
              .permute(0, 2, 1, 3).reshape(n, n_px, n_px))
    above = p[0:H:n_px, 1 : 1 + W].reshape(nby, nbx, n_px)
    left = p[1 : 1 + H, 0:W:n_px].reshape(nby, n_px, nbx).permute(0, 2, 1)
    corner = p[0:H:n_px, 0:W:n_px]
    bi = torch.arange(nby, device=p.device)[:, None, None]
    bj = torch.arange(nbx, device=p.device)[None, :, None]
    # above row missing (i==0): left present (j>0) -> left[0], else base-1
    above = torch.where(bi == 0,
                        torch.where(bj > 0, left[..., :1], base - 1), above)
    # left col missing (j==0): above present (i>0) -> above[0], else base+1
    left = torch.where(bj == 0,
                       torch.where(bi > 0, above[..., :1], base + 1), left)
    ci, cj = bi[..., 0], bj[..., 0]
    corner = torch.where(
        (ci == 0) & (cj == 0), base,
        torch.where(ci == 0, left[..., 0],
                    torch.where(cj == 0, above[..., 0], corner)))
    return (blocks, above.reshape(n, n_px), left.reshape(n, n_px),
            corner.reshape(n))


def _predictions(above, left, corner, n_px: int, nmodes: int):
    """Yields each mode's (n, P, P) int32 prediction in mode order."""
    n = above.shape[0]
    a = above[:, None, :]
    l = left[:, :, None]
    c = corner[:, None, None]
    full = (n, n_px, n_px)
    dc = (above.sum(-1) + left.sum(-1) + n_px) // (2 * n_px)
    yield dc[:, None, None].expand(full)
    if nmodes == 1:
        return
    yield a.expand(full)
    yield l.expand(full)
    w = _device_tables(n_px, above.device)[0]
    wr, wc = w[None, :, None], w[None, None, :]
    below = left[:, -1][:, None, None]
    right = above[:, -1][:, None, None]
    yield (wr * a + (256 - wr) * below + wc * l + (256 - wc) * right
           + 256) >> 9
    pa, pl, pc = (l - c).abs(), (a - c).abs(), (a + l - 2 * c).abs()
    yield torch.where((pa <= pl) & (pa <= pc), a.expand(full),
                      torch.where(pl <= pc, l.expand(full), c.expand(full)))
    if nmodes >= 7:
        yield (wr * a + (256 - wr) * below + 128) >> 8
        yield (wc * l + (256 - wc) * right + 128) >> 8
    if nmodes >= 13:
        _, tap_idx, tap_w = _device_tables(n_px, above.device)
        P = n_px
        edge = torch.cat([corner[:, None], above, above[:, -1:].expand(n, P),
                          corner[:, None], left, left[:, -1:].expand(n, P)],
                         1)
        ti, tw = tap_idx.long(), tap_w.to(torch.int32)
        for m in range(len(_DIR_ANGLES)):
            v = (edge[:, ti[m, :, 0]] * tw[m, :, 0]
                 + edge[:, ti[m, :, 1]] * tw[m, :, 1] + 16) >> 5
            yield v.reshape(full)


def mode_ssd_plain(plane: torch.Tensor, nby: int, nbx: int, n_px: int,
                   base: int, nmodes: int) -> torch.Tensor:
    """Exact integer SSD (n, nmodes) int64 of every n_px block against each
    mode's prediction from source edges; the plain PyTorch version of the
    first planner kernel (``mode_ssd``)."""
    p = plane.to(torch.int32)
    blocks, above, left, corner = _grid_edges(p, nby, nbx, n_px, base)
    cols = []
    for pred in _predictions(above, left, corner, n_px, nmodes):
        err = pred - blocks
        cols.append((err * err).sum((1, 2), dtype=torch.int64))
    return torch.stack(cols, 1)


def mode_ssd(plane: torch.Tensor, nby: int, nbx: int, n_px: int,
             base: int, nmodes: int) -> torch.Tensor:
    """mode_ssd_plain's result; on a CUDA tensor from the planner kernel
    (counted in ``mode_ssd.launches``), on a CPU tensor from the plain
    version. Any other device raises."""
    if plane.device.type == "cpu":
        return mode_ssd_plain(plane, nby, nbx, n_px, base, nmodes)
    if plane.device.type != "cuda":
        raise ValueError(f"mode_ssd: unsupported device {plane.device}")
    if (plane.dtype != torch.int16 or plane.dim() != 2
            or not plane.is_contiguous()):
        raise ValueError("mode_ssd: plane must be a contiguous 2-D int16 "
                         "tensor")
    if (plane.shape[0] < nby * n_px + 1 or plane.shape[1] < nbx * n_px + 1
            or n_px not in (16, 32, 64) or nmodes not in (1, 5, 7, 13)):
        raise ValueError(
            f"mode_ssd: unsupported grid {nby}x{nbx}x{n_px}, nmodes "
            f"{nmodes} on a {tuple(plane.shape)} plane")
    smw, tap_idx, tap_w = _device_tables(n_px, plane.device)
    out = torch.empty((nby * nbx, nmodes), dtype=torch.int64,
                      device=plane.device)
    launch(mode_ssd, "planner_mode_ssd", plane, plane.data_ptr(),
           plane.shape[1], nby, nbx, n_px, nmodes, base, smw.data_ptr(),
           tap_idx.data_ptr(), tap_w.data_ptr(), out.data_ptr())
    return out


mode_ssd.launches = 0


def _sum2x2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Sum of each 2x2 group of a (2*rows, 2*cols) grid in the float32
    order the reference's XLA reduction takes: (a00+a01) + (a10+a11)."""
    q = x.reshape(rows, 2, cols, 2)
    return ((q[:, 0, :, 0] + q[:, 0, :, 1])
            + (q[:, 1, :, 0] + q[:, 1, :, 1])).reshape(-1)


def _runner_up(ssd: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    masked = ssd.clone()
    masked[torch.arange(ssd.shape[0], device=ssd.device), best] = torch.inf
    return torch.argmin(masked, 1)


def plan_device_plain(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      qindex: int, bitdepth: int, nmodes: int = N_MODES_DIR,
                      duel_level: int = 0,
                      ssd: Callable[..., torch.Tensor] = mode_ssd_plain
                      ) -> torch.Tensor:
    """Device planning step, the plain version of ``plan_device`` on any
    device; the counterpart of _plan_device_body.

    y/u/v: (64*sby+1, 64*sbx+1) padded int16 planes on one device. Returns
    the packed int32 plan (sby*sbx + 6*nby*nbx,) on that device: plan64,
    mode32, split32, mode16, the C runtime's plan layout. ``ssd`` computes
    the exact SSD: mode_ssd_plain, or mode_ssd for the first planner
    kernel's five launches and this epilogue in torch."""
    f32 = torch.float32
    dev = y.device
    sby, sbx = (y.shape[0] - 1) // 64, (y.shape[1] - 1) // 64
    nby, nbx = 2 * sby, 2 * sbx
    base = 1 << (bitdepth - 1)
    dq = torch.tensor(float(ac_q(qindex, bitdepth)), dtype=f32, device=dev)

    # 64 and 32 keep the 7-mode set; only the 16 grid takes the
    # directional nomination set (reference comments at the same lines)
    ssd64 = ssd(y, sby, sbx, 64, base, N_MODES).to(f32)
    ssd32 = ssd(y, nby, nbx, 32, base, N_MODES).to(f32)
    ssd16 = ssd(y, 2 * nby, 2 * nbx, 16, base, nmodes).to(f32)
    if nmodes > N_MODES:
        # directional symbol-rate premium, applied after the one rounding
        ssd16[:, N_MODES:] *= torch.tensor(1.4, dtype=f32, device=dev)

    best64_base = ssd64[:, :N_BASE].amin(1)
    best32_base = ssd32[:, :N_BASE].amin(1)
    best16_base = ssd16[:, :N_BASE].amin(1)

    # torch.argmin, like jnp.argmin, returns the first index on ties
    mode32 = torch.argmin(ssd32, 1)
    mode64 = torch.argmin(ssd64, 1)
    if duel_level >= 2:
        mode32 = mode32 + ((_runner_up(ssd32, mode32) + 1) << 8)
    mode16_nd = torch.argmin(ssd16[:, :N_MODES], 1)
    if duel_level >= 1:
        best16 = torch.argmin(ssd16, 1)
        mode16 = best16 + ((_runner_up(ssd16, best16) + 1) << 8)
    elif nmodes > N_MODES:
        dir_idx = torch.argmin(ssd16[:, N_MODES:], 1) + N_MODES
        dir_wins = (ssd16.gather(1, dir_idx[:, None])[:, 0]
                    < ssd16.gather(1, mode16_nd[:, None])[:, 0])
        mode16 = mode16_nd + torch.where(dir_wins, (dir_idx + 1) << 8, 0)
    else:
        mode16 = mode16_nd

    # partition 64: NONE only on flat SBs (luma and chroma DC flat gates)
    k32 = _sum2x2(best32_base, sby, sbx)
    penalty64 = 4.0 * dq * dq
    flat_gate = 4096.0 * dq * dq / 64.0
    uv_flat = ((ssd(u, sby, sbx, 64, base, 1)[:, 0].to(f32) <= flat_gate)
               & (ssd(v, sby, sbx, 64, base, 1)[:, 0].to(f32) <= flat_gate))
    none64 = ((best64_base <= k32 + penalty64) & (best64_base <= flat_gate)
              & uv_flat)
    plan64 = torch.where(none64, mode64 + 1, 0)

    # partition 32: NONE vs SPLIT, off above the qindex-90 gate
    k16 = _sum2x2(best16_base, nby, nbx)
    split32 = ((k16 + dq * dq) < best32_base) & (qindex <= 90)
    return torch.cat([plan64, mode32, split32.long(), mode16]).to(torch.int32)


@functools.lru_cache(maxsize=None)
def plan_gates(qindex: int, bitdepth: int):
    """The float32 gate constants of ``plan_device_plain``, as its torch
    expressions round them: (dq*dq, 4*dq*dq, 4096*dq*dq/64) with dq the AC
    quantizer step, each operation in float32 from the left. Cached: it
    runs on the host once per plan, and numpy's scalar arithmetic is slow."""
    dq = np.float32(ac_q(qindex, bitdepth))
    return (dq * dq, np.float32(4.0) * dq * dq,
            np.float32(4096.0) * dq * dq / np.float32(64.0))


def plan_taps() -> np.ndarray:
    """The P = 16 directional taps of ``dir_taps`` packed for
    ``planner_plan``: uint32 (6, 8, 32), entry [m, k, 2r + h] for pixel
    (r, 8h + k) of a 16-block (the lane that scores it), holding
    idx0 | idx1 << 8 | w1 << 16 (w0 = 32 - w1)."""
    idx, w = dir_taps(16)
    packed = (idx[..., 0] | idx[..., 1] << 8 | w[..., 1] << 16)
    # (m, r, h, k) -> (m, k, r, h)
    return np.ascontiguousarray(packed.reshape(6, 16, 2, 8)
                                .transpose(0, 3, 1, 2).reshape(6, 8, 32),
                                dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _plan_tables(device: torch.device):
    """(smooth weights at P = 64, 32, 16, packed taps) on device."""
    return (*(_device_tables(P, device)[0] for P in (64, 32, 16)),
            torch.from_numpy(plan_taps().view(np.int32)).to(device))


def plan_device(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                qindex: int, bitdepth: int, nmodes: int = N_MODES_DIR,
                duel_level: int = 0) -> torch.Tensor:
    """``plan_device_plain``'s packed plan; on a CUDA tensor from one launch
    of the fused planner kernel ``planner_plan`` (counted in
    ``plan_device.launches``), on a CPU tensor from the plain version. Any
    other device, and on the card any plane or setting the kernel does not
    take, raises."""
    if y.device.type == "cpu":
        return plan_device_plain(y, u, v, qindex, bitdepth, nmodes,
                                 duel_level)
    if y.device.type != "cuda":
        raise ValueError(f"plan_device: unsupported device {y.device}")
    planes = (y, u, v)
    if any(p.device != y.device or p.dtype != torch.int16 or p.dim() != 2
           or not p.is_contiguous() or p.shape != y.shape for p in planes):
        raise ValueError("plan_device: y, u and v must be contiguous 2-D "
                         "int16 planes of one shape on one device")
    sby, sbx = (y.shape[0] - 1) // 64, (y.shape[1] - 1) // 64
    if sby < 1 or sbx < 1:
        raise ValueError(f"plan_device: a {tuple(y.shape)} plane holds no "
                         "padded 64x64 superblock")
    if (bitdepth not in (8, 10) or nmodes not in (5, N_MODES, N_MODES_DIR)
            or duel_level not in (0, 1, 2)):
        raise ValueError(f"plan_device: unsupported bit depth {bitdepth}, "
                         f"nmodes {nmodes} or duel level {duel_level}")
    pen32, pen64, flat_gate = plan_gates(qindex, bitdepth)
    smw64, smw32, smw16, taps = _plan_tables(y.device)
    out = torch.empty(25 * sby * sbx, dtype=torch.int32, device=y.device)
    launch(plan_device, "planner_plan", y, y.data_ptr(), u.data_ptr(),
           v.data_ptr(), y.shape[1], sby, sbx, 1 << (bitdepth - 1), nmodes,
           duel_level, int(qindex <= 90), float(pen32), float(pen64),
           float(flat_gate), smw64.data_ptr(), smw32.data_ptr(),
           smw16.data_ptr(), taps.data_ptr(), out.data_ptr())
    return out


plan_device.launches = 0


class Plan(dict):
    """Plan dict that supports weak references (the cross-probe decision
    cache keys decision buffers by live plan instances)."""

    __slots__ = ("__weakref__",)


def unpack_plan(packed: np.ndarray, nby: int, nbx: int) -> Plan:
    """Packed device plan vector -> the host plan dict (spec mode ids)."""
    sby, sbx = nby // 2, nbx // 2
    n64, n32 = sby * sbx, nby * nbx
    packed = np.asarray(packed)
    ids = MODE_IDS
    p64 = packed[:n64].reshape(sby, sbx)
    m32 = packed[n64 : n64 + n32].reshape(nby, nbx)
    s32 = packed[n64 + n32 : n64 + 2 * n32].reshape(nby, nbx)
    m16 = packed[n64 + 2 * n32 :].reshape(nby * 2, nbx * 2)
    plan64 = np.where(p64 > 0, ids[np.maximum(p64 - 1, 0)] + 1, 0)
    # mode16 may carry a nominee index in the high byte; map both fields
    # to spec mode ids (nominee kept as (id+1)<<8)
    m16_low = ids[m16 & 0xFF].astype(np.int32)
    m16_high = (m16 >> 8).astype(np.int64)
    nominee = np.where(m16_high > 0, ids[np.maximum(m16_high - 1, 0)] + 1, 0)
    return Plan(
        plan64=plan64.astype(np.int32),
        mode32=ids[m32].astype(np.int32),
        part32=s32.astype(np.int32),
        mode16=(m16_low + (nominee.astype(np.int32) << 8)).astype(np.int32),
    )


def pad_plane(plane: np.ndarray, sby: int, sbx: int, bitdepth: int
              ) -> np.ndarray:
    """The full-SB crop of a plane as (64*sby+1, 64*sbx+1) int16 with the
    reference's +1 border row and column (int16: pixels fit 12 bits)."""
    base = 1 << (bitdepth - 1)
    H, W = sby * 64, sbx * 64
    p = np.empty((H + 1, W + 1), dtype=np.int16)
    p[1:, 1:] = plane[:H, :W]
    p[0, :] = base - 1
    p[:, 0] = base + 1
    p[0, 0] = base
    return p


class FramePlanner:
    """Holds the device-resident padded planes of one image and plans per
    probe (the planes don't change with the quantizer).

    Unlike the reference there is no shape bucketing: it only saved TPU
    compiles, and cropped bucket plans equal unpadded ones."""

    def __init__(self, planes, bitdepth: int = 8,
                 nmodes: int = N_MODES_DIR, duel_level: int = 0,
                 device=None):
        self.nmodes = nmodes
        self.duel_level = duel_level
        self.device = resolve_device(device)
        # serializes planning so that the returned Plan INSTANCE is stable
        # per qindex window: the decision-reuse cache binds to id(plan)
        self._plan_lock = threading.RLock()
        y = np.asarray(planes[0])
        self.h, self.w = y.shape
        self.bitdepth = bitdepth
        self.sby, self.sbx = self.h // 64, self.w // 64
        self.nby, self.nbx = self.sby * 2, self.sbx * 2
        self._plan_cache: Dict[int, Plan] = {}
        # plans made elsewhere (seed_plan), and how often plan() served one
        self._seeded: list = []
        self.seeded_hits = 0
        if self.sby == 0 or self.sbx == 0:
            self.dev = None
            return
        self.dev = [
            torch.from_numpy(pad_plane(
                np.asarray(planes[pi]) if len(planes) > 1 else y,
                self.sby, self.sbx, bitdepth)).to(self.device)
            for pi in range(3)
        ]

    def plan(self, qindex: int, exact: bool = False) -> Optional[Plan]:
        """{"plan64","mode32","part32","mode16"} numpy arrays (spec mode
        ids), or None when the frame has no full SB. exact=True (quality
        speeds <= 4) disables the cross-q window."""
        if self.dev is None:
            return None
        with self._plan_lock:
            return self._plan_locked(qindex, exact)

    def seed_plan(self, qindex: int, plan: Plan) -> None:
        """Put a plan made elsewhere for these planes (one rank's tile in
        the multi-device dry run) in the plan cache at ``qindex``; each
        time ``plan`` serves it adds one to ``seeded_hits``."""
        with self._plan_lock:
            self._plan_cache[qindex] = plan
            self._seeded.append(plan)

    def _plan_locked(self, qindex: int, exact: bool) -> Plan:
        # plans vary with q only through dq-scaled gates: probes at nearby
        # quantizers reuse the cached plan, never across the qindex-90 gate
        window = 0 if exact else 16
        for qk, cached in self._plan_cache.items():
            if abs(qk - qindex) <= window and (qk <= 90) == (qindex <= 90):
                if any(cached is p for p in self._seeded):
                    self.seeded_hits += 1
                return cached
        packed = plan_device(*self.dev, qindex, self.bitdepth, self.nmodes,
                             self.duel_level)
        plan = unpack_plan(packed.cpu().numpy(), self.nby, self.nbx)
        if len(self._plan_cache) >= 8:
            self._plan_cache.clear()
        self._plan_cache[qindex] = plan
        return plan


def planner_from_reference(dev_planes, bitdepth: int, nmodes: int,
                           duel_level: int, device, shape) -> FramePlanner:
    """The port's planner over the reference FramePlanner's device planes
    (``fp.dev`` as numpy, bucket-padded), cropped to the frame ``shape``
    (h, w), so that both plan from identical state."""
    h, w = shape
    H, W = h // 64 * 64, w // 64 * 64
    planes = [np.asarray(p)[1 : 1 + H, 1 : 1 + W] for p in dev_planes]
    return FramePlanner(planes, bitdepth, nmodes=nmodes,
                        duel_level=duel_level, device=device)
