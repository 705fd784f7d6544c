"""SSIMULACRA2 on the GPU: the counterpart of oavif_tpu/metric/ssimulacra2.py.

The same published SSIMULACRA 2.1 algorithm and the same constants as the
reference (copied: the reference module imports JAX at its top), with the
reference's layouts at the public functions: uint8 ``(H, W, 3)`` images
in, planar ``(3, H, W)`` float32 inside, a candidate batch as a leading
``N``.

Five hand-written CUDA kernels (``csrc/ssimulacra2.cu``) do the device
work, each with its candidate batch ``N`` as a grid dimension (the
reference's vmapped ``_score_batch``):

- ``ssim2_pyramid``: sRGB bytes to linear RGB and positive XYB at scale 0,
  or a 2x2 box downsample of linear RGB and its XYB at each further scale;
- ``ssim2_blur``: the separable zero-padded Gaussian, sigma 1.5, as
  ``(mu1, s11)`` on the reference side or ``(mu2, s22, s12)`` on the
  distorted side; with ``halo`` extra columns on each side, the blur of a
  width shard (``metric/sharded.py``). By its bytes it is bound by device
  memory, but a naive stencil is bound by shared-memory loads long before
  that, so the kernel tiles in registers (a thread slides the unrolled
  taps over a window it reads once), marches a block down a strip of
  columns with the last filtered rows in a ring of shared memory (a row is
  filtered across once, not once per tile) and keeps the next rows in
  flight by ``cp.async`` while it filters. ``ssim2_blur_simple`` is the
  first kernel, one output per thread and pass with the same arithmetic:
  the exact yardstick (``torch.equal``) and the time to beat, on no path;
- ``ssim2_blur_iir``: the same five blurs through the reference's
  recursive (Young-van Vliet) Gaussian, under ``OAVIF_METRIC_BLUR=iir``. A
  chain of dependent operations per row and column, bound by device
  memory: keeping the reference's order of operations costs eight trips
  per output element, so the kernel makes every trip a coalesced one (the
  W pass moves 32 rows at a time through a padded tile of shared memory;
  its intermediates are stored as 32x32 tiles);
- ``ssim2_norms``: the SSIM error, artifact and detail-lost maps reduced
  to their sums and sums of 4th powers per channel, in float64, in a fixed
  order (no atomics), so a repeated score is bit-identical;
- ``ssim2_blur_norms``: the candidates' side of a scale in one pass, the
  blur's march whose vertical pass hands the three maps to the norms in
  registers, so that mu2, s22 and s12 never reach device memory. Its maps
  are ``ssim2_blur``'s bits and its sums ``ssim2_norms``'s in another
  order. The score takes it under the Gaussian; ``blur_iir`` and
  ``ssim2_norms`` stay for the recursive blur, and the pair for the
  width-sharded metric (``metric/sharded.py``).

Each sits beside its plain PyTorch version (``*_plain``), which a CPU
tensor takes; a CUDA tensor takes the kernel or raises. The feature
assembly and the final nonlinearity are float32 torch ops on ``(N, 108)``.

``OAVIF_METRIC_BLUR=fir_rN`` truncates the Gaussian to radius N (at most 8
in the kernel); ``OAVIF_METRIC_BLUR=iir`` takes the recursive Gaussian.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import launch

NUM_SCALES = 6
_C2 = 0.0009
_SIGMA = 1.5
_KERNEL_RADIUS = 8  # exp(-r²/2σ²) < 3e-7 beyond r=8 at σ=1.5
_MAX_KERNEL_RADIUS = 8  # the largest radius the blur kernels are built for
_NORM_CHUNK = 4096  # pixels per block of the norms kernel's first pass
# a blur block's columns and rows (kStripW, kSegRows in csrc/ssimulacra2.cu):
# the fused kernel writes one partial sum per block
_STRIP_W = 64
_SEG_ROWS = 128

# SSIMULACRA 2.1 fitted weights, channel-major (X, Y, B), then scale 0..5,
# then [ssim_1, artifact_1, detail_1, ssim_4, artifact_4, detail_4]
WEIGHTS = np.array(
    [
        # X channel, scales 0..5
        0.0, 0.0007376606707406586, 0.0, 0.0, 0.0007793481682867309, 0.0,
        0.0, 0.0004371155730107379, 0.0, 1.1041726426657346,
        0.00066284834129271, 0.00015231632783718752,
        0.0, 0.0016406437456599754, 0.0, 1.8422455520539298,
        11.441172603757666, 0.0,
        0.0007989109436015163, 0.000176816438078653, 0.0,
        1.8787594979546387, 10.94906990605142, 0.0,
        0.0007289346991508072, 0.9677937080626833, 0.0,
        0.00014003424285435884, 0.9981766977854967, 0.00031949755934435053,
        0.0004550992113792063, 0.0, 0.0, 0.0013648766163243398, 0.0, 0.0,
        # Y channel, scales 0..5
        7.466890328078848, 0.0, 17.445833984131262, 0.0006235601634041466,
        0.0, 0.0,
        6.683678146179332, 0.00037724407979611296, 1.027889937768264,
        225.20515300849274, 0.0, 0.0,
        19.213238186143016, 0.0011401524586618361, 0.001237755635509985,
        176.39317598450694, 0.0, 0.0,
        24.43300999870476, 0.28520802612117757, 0.0004485436923833408,
        0.0, 0.0, 0.0,
        34.77906344483772, 44.835625328877896, 0.0, 0.0008680556573291698,
        0.0005313191874358747, 0.0,
        0.00016533814161379112, 0.0, 0.0, 0.0, 0.0, 0.0005895391724029294,
        # B channel, scales 0..5
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
        0.0004179171803251336, 0.0017290828234722833, 0.0,
        0.0020827005846636437, 0.0, 0.0,
        8.826982764996862, 23.19243343998926, 0.0, 95.1080498811086,
        0.9863978034400682, 0.9834382792465353,
        0.0012286405048278493, 171.2667255897307, 0.9807858872435379,
        0.0, 0.0, 0.0,
        0.0005130064588990679, 0.0, 0.00010854057858411537, 0.0, 0.0, 0.0,
    ],
    dtype=np.float64,
)

_FINAL_POW = 0.6276336467831387
_FINAL_SCALE = 0.9562382616834844
_CUBIC = (2.326765642916932, -0.020884521182843837, 6.248496625763138e-05)

_OPSIN_BIAS = 0.0037930732552754493
_CBRT_OPSIN_BIAS = _OPSIN_BIAS ** (1.0 / 3.0)
# JPEG XL opsin absorbance matrix (rows: L, M, S mix of linear RGB)
_OPSIN_M = np.array(
    [
        [0.30, 0.622, 0.078],
        [0.23, 0.692, 0.078],
        [0.24342268924547819, 0.20476744424496821, 0.55180986650955360],
    ],
    dtype=np.float32,
)
# MakePositiveXYB offsets of X', Y', B'
_XYB_OFFSETS = (0.42, 0.01, 0.55)


def _finalize_score(dot: torch.Tensor) -> torch.Tensor:
    """Published v2.1 Score() tail: scale, cubic, then 100 - 10·d^p."""
    d = dot * _FINAL_SCALE
    d = _CUBIC[0] * d + _CUBIC[1] * d * d + _CUBIC[2] * d * d * d
    return torch.where(
        d > 0.0, 100.0 - 10.0 * torch.pow(torch.clamp_min(d, 0.0), _FINAL_POW),
        torch.full_like(d, 100.0))


# ---------------------------------------------------------------------------
# Plain building blocks (torch ops on any device, batched over leading dims)
# ---------------------------------------------------------------------------


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """sRGB EOTF on [0,1]."""
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


@functools.lru_cache(maxsize=None)
def _srgb8_table(device: torch.device) -> torch.Tensor:
    """The linear value of each of the 256 sRGB bytes, float32 on
    ``device``. A table keeps every pixel's value independent of where it
    lies in a batch (CPU torch takes vectorized and scalar pow paths by
    position) and is what the pyramid kernel reads."""
    return srgb_to_linear(torch.arange(256, dtype=torch.float32,
                                       device=device) * (1.0 / 255.0))


def rgb8_to_linear(rgb8: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W, 3) sRGB → planar linear RGB (..., 3, H, W)
    float32. The pyramid is built in this space and each scale converted
    to XYB afterwards, as upstream."""
    return (_srgb8_table(rgb8.device)[rgb8.long()].movedim(-1, -3)
            .contiguous())


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of non-negative float32 values, computed in float64 and
    rounded once (torch has no cbrt; a float32 pow(x, 1/3) rounds its
    exponent and drifts a few ulp from the reference's jnp.cbrt)."""
    return x.double().pow(1.0 / 3.0).to(x.dtype)


def _fma(a: torch.Tensor, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·x + c of float32 values with one rounding to float32 (through
    float64, where the product is exact)."""
    return (a.double() * x.double() + c.double()).to(torch.float32)


def linear_rgb_to_xyb_positive(rgb: torch.Tensor) -> torch.Tensor:
    """Planar linear RGB (..., 3, H, W) → positive-shifted XYB (..., 3, H, W).

    The opsin mix is fma(m2, b, fma(m1, g, m0·r)) in float32, the order in
    which XLA evaluates the reference's einsum on the CPU; the kernel takes
    the same order."""
    m = torch.from_numpy(_OPSIN_M).to(rgb.device)
    r, g, b = rgb.unbind(-3)
    lms = [_cbrt(torch.clamp_min(
        _fma(m[i, 2], b, _fma(m[i, 1], g, m[i, 0] * r)) + _OPSIN_BIAS, 0.0))
        - _CBRT_OPSIN_BIAS for i in range(3)]
    l, mm, s = lms
    x = (l - mm) * 0.5
    y = (l + mm) * 0.5
    # MakePositiveXYB (ssimulacra2.cc): B-Y+0.55 uses the unshifted Y
    return torch.stack([x * 14.0 + _XYB_OFFSETS[0], y + _XYB_OFFSETS[1],
                        (s - y) + _XYB_OFFSETS[2]], -3)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2×2 box downsample of (..., H, W) with edge replication on odd sizes
    (ssimulacra2.cc Downsample), summed as (a00 + a01) + (a10 + a11)."""
    h, w = img.shape[-2:]
    if h % 2:
        img = torch.cat([img, img[..., -1:, :]], -2)
    if w % 2:
        img = torch.cat([img, img[..., :, -1:]], -1)
    q = img.reshape(*img.shape[:-2], (h + 1) // 2, 2, (w + 1) // 2, 2)
    return ((q[..., 0, :, 0] + q[..., 0, :, 1])
            + (q[..., 1, :, 0] + q[..., 1, :, 1])) * 0.25


@functools.lru_cache(maxsize=None)
def _gauss_kernel(radius: int = _KERNEL_RADIUS) -> np.ndarray:
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / _SIGMA) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def kernel_l1_error(radius: int) -> float:
    """L1 distance between the radius-``radius`` normalized kernel and the
    (effectively exact) radius-8 one."""
    full = _gauss_kernel(_KERNEL_RADIUS).astype(np.float64)
    trunc = _gauss_kernel(radius).astype(np.float64)
    pad = np.zeros_like(full)
    off = _KERNEL_RADIUS - radius
    pad[off : off + len(trunc)] = trunc
    return float(np.abs(full - pad).sum())


@functools.lru_cache(maxsize=None)
def _yvv_coeffs():
    """Young-van Vliet 3rd-order recursive Gaussian coefficients, sigma 1.5
    (the q-polynomial fit): (B, b1/b0, b2/b0, b3/b0) as float32, copied
    from the reference."""
    sigma = _SIGMA
    q = 3.97156 - 4.14554 * np.sqrt(1.0 - 0.26891 * sigma)
    b0 = 1.57825 + 2.44413 * q + 1.4281 * q * q + 0.422205 * q ** 3
    b1 = 2.44413 * q + 2.85619 * q * q + 1.26661 * q ** 3
    b2 = -(1.4281 * q * q + 1.26661 * q ** 3)
    b3 = 0.422205 * q ** 3
    B = 1.0 - (b1 + b2 + b3) / b0
    return (np.float32(B), np.float32(b1 / b0), np.float32(b2 / b0),
            np.float32(b3 / b0))


@functools.lru_cache(maxsize=None)
def _yvv_tensor(device: torch.device) -> torch.Tensor:
    return torch.tensor(_yvv_coeffs(), dtype=torch.float32, device=device)


def _iir_pass_1d(x: torch.Tensor) -> torch.Tensor:
    """Forward then backward YvV recursion along the last axis from a zero
    state, y = ((B*x + a1*y1) + a2*y2) + a3*y3 in float32, each operation
    rounded (the reference's order; torch never fuses them)."""
    B, a1, a2, a3 = _yvv_tensor(x.device).unbind()
    xt = x.movedim(-1, 0)
    out = torch.empty_like(xt)
    for order in (range(xt.shape[0]), range(xt.shape[0] - 1, -1, -1)):
        y1 = y2 = y3 = torch.zeros_like(xt[0])
        for t in order:
            y = B * xt[t] + a1 * y1 + a2 * y2 + a3 * y3
            y1, y2, y3 = y, y1, y2
            out[t] = y
        xt, out = out, torch.empty_like(out)
    return xt.movedim(0, -1)


def blur_iir(img: torch.Tensor) -> torch.Tensor:
    """Recursive Gaussian sigma 1.5 over (..., H, W): the reference's
    blur_iir, along W then along H."""
    return (_iir_pass_1d(_iir_pass_1d(img).transpose(-1, -2))
            .transpose(-1, -2).contiguous())


def blur_radius() -> Optional[int]:
    """The Gaussian under OAVIF_METRIC_BLUR: radius 8 by default, N for
    ``fir_rN``, None for ``iir`` (the recursive Gaussian)."""
    sel = os.environ.get("OAVIF_METRIC_BLUR", "")
    if sel == "iir":
        return None
    if sel.startswith("fir_r"):
        return int(sel[5:])
    if sel:
        raise ValueError(f"unknown OAVIF_METRIC_BLUR {sel!r}")
    return _KERNEL_RADIUS


@functools.lru_cache(maxsize=None)
def _taps(radius: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_gauss_kernel(radius)).to(device)


def blur(img: torch.Tensor, radius: Optional[int] = None,
         halo: int = 0) -> torch.Tensor:
    """Separable Gaussian σ=1.5 over (..., H, W), zero-padded borders,
    horizontal then vertical; ``radius`` defaults to ``blur_radius()``,
    and without a radius there (``iir``) this is ``blur_iir``. With
    ``halo`` > 0 the input is (..., H, W + 2*halo), a width shard between
    its neighbours' columns, and the output (..., H, W): the horizontal
    pass takes those columns in place of padding (zero beyond them).

    On a CUDA tensor cuDNN must not round to TF32 (``resolve_device``
    turns it off): TF32 would break the identical-image score of 100."""
    if radius is None:
        radius = blur_radius()
        if radius is None:
            if halo:
                raise ValueError("blur: the recursive Gaussian takes no halo")
            return blur_iir(img)
    if img.is_cuda and torch.backends.cudnn.allow_tf32:
        raise RuntimeError("blur: cuDNN TF32 is on; the metric needs float32 "
                           "convolutions (device.resolve_device turns it off)")
    k = _taps(radius, img.device)
    h, win = img.shape[-2:]
    x = img.reshape(-1, 1, h, win)
    if halo >= radius:  # VALID over the halo's innermost radius columns
        x = x[..., halo - radius : win - (halo - radius)]
    else:
        x = F.pad(x, (radius - halo, radius - halo))
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    x = F.conv2d(x, k.view(1, 1, -1, 1), padding=(radius, 0))
    return x.reshape(*img.shape[:-1], win - 2 * halo)


def _num_scales(h: int, w: int) -> int:
    """Scales computed: scale s (s ≥ 1) runs whenever the scale s−1 image
    is ≥ 8 px on both sides (an 8×8 input gets 2 scales)."""
    n = 0
    for s in range(NUM_SCALES):
        if h < 8 or w < 8:
            break
        if s:
            h, w = (h + 1) // 2, (w + 1) // 2
        n += 1
    return n


# ---------------------------------------------------------------------------
# The kernels, each beside its plain version
# ---------------------------------------------------------------------------


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


@functools.lru_cache(maxsize=None)
def _pyramid_consts(device: torch.device) -> torch.Tensor:
    """The pyramid kernel's float32 constants on ``device``: the plain
    version's sRGB table (so scale 0 equals it exactly), the opsin matrix
    row-major, the opsin bias and its cube root, and the X', Y', B'
    offsets."""
    lut = _srgb8_table(device)
    rest = np.concatenate([_OPSIN_M.ravel(), np.array(
        [_OPSIN_BIAS, _CBRT_OPSIN_BIAS, *_XYB_OFFSETS], dtype=np.float32)])
    return torch.cat([lut, torch.from_numpy(rest).to(device)]).contiguous()


def ssim2_pyramid_plain(src: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(linear RGB, XYB), each (N, 3, h, w) float32, of one pyramid scale:
    from uint8 (N, H, W, 3) sRGB at scale 0, or by downsampling the
    previous scale's linear RGB (N, 3, 2h, 2w)."""
    lin = rgb8_to_linear(src) if src.dtype == torch.uint8 else downsample2(src)
    return lin, linear_rgb_to_xyb_positive(lin)


def ssim2_pyramid(src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """ssim2_pyramid_plain's result; on a CUDA tensor from the pyramid
    kernel (counted in ``ssim2_pyramid.launches``), on a CPU tensor from
    the plain version."""
    if src.device.type == "cpu":
        return ssim2_pyramid_plain(src)
    _check_cuda("ssim2_pyramid", src)
    if src.dtype == torch.uint8 and src.dim() == 4 and src.shape[3] == 3:
        n, h, w = src.shape[:3]
        oh, ow, entry = h, w, "ssim2_pyramid_rgb8"
    elif src.dtype == torch.float32 and src.dim() == 4 and src.shape[1] == 3:
        n, _, h, w = src.shape
        oh, ow, entry = (h + 1) // 2, (w + 1) // 2, "ssim2_pyramid_down"
    else:
        raise ValueError(
            "ssim2_pyramid: expects uint8 (N, H, W, 3) or float32 "
            f"(N, 3, H, W), got {src.dtype} {tuple(src.shape)}")
    if min(n, h, w) < 1:
        raise ValueError(f"ssim2_pyramid: empty input {tuple(src.shape)}")
    lin = torch.empty((n, 3, oh, ow), dtype=torch.float32, device=src.device)
    xyb = torch.empty_like(lin)
    consts = _pyramid_consts(src.device)
    launch(ssim2_pyramid, entry, src, src.data_ptr(), n, h, w,
           consts.data_ptr(), lin.data_ptr(), xyb.data_ptr())
    return lin, xyb


ssim2_pyramid.launches = 0


def ssim2_blur_plain(img1: torch.Tensor, img2: Optional[torch.Tensor] = None,
                     radius: int = _KERNEL_RADIUS, halo: int = 0):
    """Reference side (img2 None): (mu1, s11) = blur(img1), blur(img1²).
    Distorted side: (mu2, s22, s12) = blur(img2), blur(img2²),
    blur(img1·img2), with img1 (1 or N, 3, h, w) against img2 (N, 3, h, w).
    With ``halo``, the inputs are w + 2*halo wide and the outputs w
    (``blur``)."""
    if img2 is None:
        return blur(img1, radius, halo), blur(img1 * img1, radius, halo)
    return (blur(img2, radius, halo), blur(img2 * img2, radius, halo),
            blur(img1 * img2, radius, halo))


def _ref_batched(name: str, ref: torch.Tensor, dist: torch.Tensor) -> int:
    """1 when the reference planes carry the batch, 0 when one (1, 3, h, w)
    reference serves every candidate (read with batch stride 0)."""
    if (ref.dim() != 4 or dist.dim() != 4 or ref.shape[1:] != dist.shape[1:]
            or ref.shape[0] not in (1, dist.shape[0])):
        raise ValueError(
            f"{name}: reference {tuple(ref.shape)} does not match candidates "
            f"{tuple(dist.shape)}")
    return int(ref.shape[0] == dist.shape[0] and dist.shape[0] > 1)


def _check_planes(name: str, *planes: torch.Tensor) -> None:
    for t in planes:
        if (t.dtype != torch.float32 or t.dim() != 4 or t.shape[1] != 3
                or min(t.shape) < 1):
            raise ValueError(f"{name}: expects float32 (N, 3, H, W) planes, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.shape[0] * 3 > 65535:
            raise ValueError(f"{name}: batch {t.shape[0]} too large")


def _launch_blur(wrapper, img1: torch.Tensor, img2: Optional[torch.Tensor],
                 radius: int, halo: int):
    """Check the planes and launch ``wrapper``'s C entry (named like the
    wrapper; the blur's entries share their arguments)."""
    name = wrapper.__name__
    planes = (img1,) if img2 is None else (img1, img2)
    _check_cuda(name, *planes)
    _check_planes(name, *planes)
    if not 0 <= radius <= _MAX_KERNEL_RADIUS:
        raise ValueError(f"{name}: radius {radius} outside "
                         f"0..{_MAX_KERNEL_RADIUS}")
    dist = img1 if img2 is None else img2
    if not 0 <= halo <= _MAX_KERNEL_RADIUS or dist.shape[3] <= 2 * halo:
        raise ValueError(f"{name}: halo {halo} outside "
                         f"0..{_MAX_KERNEL_RADIUS} or wider than the input")
    batched = 1 if img2 is None else _ref_batched(name, img1, img2)
    n, _, h, win = dist.shape
    w = win - 2 * halo
    outs = [dist.new_empty((n, 3, h, w))
            for _ in range(2 if img2 is None else 3)]
    taps = _taps(radius, dist.device)
    launch(wrapper, name, dist, img1.data_ptr(), batched,
           None if img2 is None else img2.data_ptr(), n, h, w, halo,
           taps.data_ptr(), radius, outs[0].data_ptr(), outs[1].data_ptr(),
           outs[2].data_ptr() if len(outs) == 3 else None)
    return tuple(outs)


def ssim2_blur(img1: torch.Tensor, img2: Optional[torch.Tensor] = None,
               radius: int = _KERNEL_RADIUS, halo: int = 0):
    """ssim2_blur_plain's result; on CUDA tensors from the blur kernel
    (counted in ``ssim2_blur.launches``), on CPU tensors from the plain
    version."""
    if img1.device.type == "cpu":
        return ssim2_blur_plain(img1, img2, radius, halo)
    return _launch_blur(ssim2_blur, img1, img2, radius, halo)


ssim2_blur.launches = 0


def ssim2_blur_simple(img1: torch.Tensor, img2: Optional[torch.Tensor] = None,
                      radius: int = _KERNEL_RADIUS, halo: int = 0):
    """``ssim2_blur`` through the first blur kernel, which the source
    keeps as the exact yardstick: one output per thread and pass, the same
    arithmetic per output, so the two give the same bits. No path calls
    it; the card tests and ``chip_smoke.py`` hold ``ssim2_blur`` to it with
    ``torch.equal`` and time the two in one call. Counted in
    ``ssim2_blur_simple.launches``."""
    if img1.device.type == "cpu":
        return ssim2_blur_plain(img1, img2, radius, halo)
    return _launch_blur(ssim2_blur_simple, img1, img2, radius, halo)


ssim2_blur_simple.launches = 0


def ssim2_blur_iir_plain(img1: torch.Tensor,
                         img2: Optional[torch.Tensor] = None):
    """ssim2_blur_plain's five blurs through the recursive Gaussian:
    (mu1, s11) on the reference side, (mu2, s22, s12) on the distorted
    side. The inputs go through one recursion together (each element's
    arithmetic is its own)."""
    if img2 is None:
        return tuple(blur_iir(torch.stack([img1, img1 * img1])).unbind(0))
    return tuple(blur_iir(torch.stack([img2, img2 * img2, img1 * img2]))
                 .unbind(0))


def ssim2_blur_iir(img1: torch.Tensor, img2: Optional[torch.Tensor] = None):
    """ssim2_blur_iir_plain's result; on CUDA tensors from the recursive
    blur kernel (two launches, the W pass then the H pass, counted once in
    ``ssim2_blur_iir.launches``), on CPU tensors from the plain version."""
    if img1.device.type == "cpu":
        return ssim2_blur_iir_plain(img1, img2)
    planes = (img1,) if img2 is None else (img1, img2)
    _check_cuda("ssim2_blur_iir", *planes)
    _check_planes("ssim2_blur_iir", *planes)
    dist = img1 if img2 is None else img2
    batched = 1 if img2 is None else _ref_batched("ssim2_blur_iir", img1,
                                                  img2)
    n, _, h, w = dist.shape
    k = 2 if img2 is None else 3
    outs = [torch.empty_like(dist) for _ in range(k)]
    # the forward pass's scratch and the W pass's output, per output and
    # plane as 32x32 tiles (the kernel's own layout)
    scratch = dist.new_empty((k, n, 3, -(-h // 32), -(-w // 32), 32, 32))
    tmp = torch.empty_like(scratch)
    coef = _yvv_tensor(dist.device)
    launch(ssim2_blur_iir, "ssim2_blur_iir", dist, img1.data_ptr(), batched,
           None if img2 is None else img2.data_ptr(), n, h, w,
           coef.data_ptr(), scratch.data_ptr(), tmp.data_ptr(),
           outs[0].data_ptr(), outs[1].data_ptr(),
           outs[2].data_ptr() if k == 3 else None)
    return tuple(outs)


ssim2_blur_iir.launches = 0


def ssim2_norms_plain(img1, mu1, s11, img2, mu2, s22, s12) -> torch.Tensor:
    """Per candidate and channel, the sums over pixels of the SSIM error
    map d, the artifact map and the detail-lost map, then of their 4th
    powers: (N, 3, 6) float64 in the feature order [d, artifact, detail,
    d⁴, artifact⁴, detail⁴]. The maps are float32 as in the reference; the
    sums are float64."""
    mu11 = mu1 * mu1
    mu22 = mu2 * mu2
    mu12 = mu1 * mu2
    mu_diff = mu1 - mu2
    num_m = 1.0 - mu_diff * mu_diff
    num_s = 2.0 * (s12 - mu12) + _C2
    denom_s = (s11 - mu11) + (s22 - mu22) + _C2
    d = torch.clamp_min(1.0 - (num_m * num_s) / denom_s, 0.0)
    d1 = (1.0 + (img2 - mu2).abs()) / (1.0 + (img1 - mu1).abs()) - 1.0
    maps = torch.stack([d, torch.clamp_min(d1, 0.0), torch.clamp_min(-d1, 0.0)],
                       2).flatten(3).double()
    sq = maps * maps
    return torch.cat([maps.sum(-1), (sq * sq).sum(-1)], -1)


def ssim2_norms(img1, mu1, s11, img2, mu2, s22, s12) -> torch.Tensor:
    """ssim2_norms_plain's result; on CUDA tensors from the norms kernel
    (two launches: per-block partial sums, then a fold in a fixed order;
    counted once in ``ssim2_norms.launches``), on CPU tensors from the
    plain version. The reference planes (img1, mu1, s11) may be (1, 3, h,
    w) for a whole batch."""
    if img1.device.type == "cpu":
        return ssim2_norms_plain(img1, mu1, s11, img2, mu2, s22, s12)
    planes = (img1, mu1, s11, img2, mu2, s22, s12)
    _check_cuda("ssim2_norms", *planes)
    _check_planes("ssim2_norms", *planes)
    if not (img1.shape == mu1.shape == s11.shape
            and img2.shape == mu2.shape == s22.shape == s12.shape):
        raise ValueError("ssim2_norms: plane shapes differ")
    batched = _ref_batched("ssim2_norms", img1, img2)
    n, _, h, w = img2.shape
    nblk = -(-h * w // _NORM_CHUNK)
    partial = torch.empty((n * 3, nblk, 6), dtype=torch.float64,
                          device=img2.device)
    out = torch.empty((n, 3, 6), dtype=torch.float64, device=img2.device)
    launch(ssim2_norms, "ssim2_norms", img2, img1.data_ptr(),
           mu1.data_ptr(), s11.data_ptr(), batched, img2.data_ptr(),
           mu2.data_ptr(), s22.data_ptr(), s12.data_ptr(), n, h, w, _C2,
           partial.data_ptr(), nblk, out.data_ptr())
    return out


ssim2_norms.launches = 0


def ssim2_blur_norms_plain(img1, mu1, s11, img2,
                           radius: int = _KERNEL_RADIUS) -> torch.Tensor:
    """ssim2_norms_plain over ssim2_blur_plain's distorted-side maps: the
    (N, 3, 6) float64 sums of one scale's candidates against the reference
    planes img1, mu1, s11 (1 or N, 3, h, w)."""
    return ssim2_norms_plain(img1, mu1, s11, img2,
                             *ssim2_blur_plain(img1, img2, radius))


def ssim2_blur_norms(img1, mu1, s11, img2,
                     radius: int = _KERNEL_RADIUS) -> torch.Tensor:
    """ssim2_blur_norms_plain's result; on CUDA tensors from the fused
    kernel (two launches: the blur's march with the norms in its vertical
    pass, one partial per block, then a fold in a fixed order; counted once
    in ``ssim2_blur_norms.launches``), on CPU tensors from the plain
    version. Tensors on both raise."""
    planes = (img1, mu1, s11, img2)
    if all(t.device.type == "cpu" for t in planes):
        return ssim2_blur_norms_plain(img1, mu1, s11, img2, radius)
    name = "ssim2_blur_norms"
    _check_cuda(name, *planes)
    _check_planes(name, *planes)
    if not img1.shape == mu1.shape == s11.shape:
        raise ValueError(f"{name}: reference plane shapes differ")
    if not 0 <= radius <= _MAX_KERNEL_RADIUS:
        raise ValueError(f"{name}: radius {radius} outside "
                         f"0..{_MAX_KERNEL_RADIUS}")
    batched = _ref_batched(name, img1, img2)
    n, _, h, w = img2.shape
    nblk = -(-w // _STRIP_W) * -(-h // _SEG_ROWS)
    partial = torch.empty((n * 3, nblk, 6), dtype=torch.float64,
                          device=img2.device)
    out = torch.empty((n, 3, 6), dtype=torch.float64, device=img2.device)
    taps = _taps(radius, img2.device)
    launch(ssim2_blur_norms, name, img2, img1.data_ptr(), mu1.data_ptr(),
           s11.data_ptr(), batched, img2.data_ptr(), n, h, w,
           taps.data_ptr(), radius, _C2, partial.data_ptr(), nblk,
           out.data_ptr())
    return out


ssim2_blur_norms.launches = 0


class MetricOps(NamedTuple):
    """The device steps the metric runs: the kernels, or their plain
    versions (to hold one against the other on the card). ``blur_iir``
    takes the place of ``blur`` under OAVIF_METRIC_BLUR=iir. The
    candidates' side of a scale is ``blur_norms`` under the Gaussian, and
    ``blur_iir`` then ``norms`` under the recursive blur."""

    pyramid: Callable
    blur: Callable
    norms: Callable
    blur_iir: Callable
    blur_norms: Callable

    def blurs(self, img1):
        """The reference side's blurs of a scale under OAVIF_METRIC_BLUR:
        (mu1, s11)."""
        radius = blur_radius()
        if radius is None:
            return self.blur_iir(img1)
        return self.blur(img1, None, radius)


KERNELS = MetricOps(ssim2_pyramid, ssim2_blur, ssim2_norms, ssim2_blur_iir,
                    ssim2_blur_norms)
PLAIN = MetricOps(ssim2_pyramid_plain, ssim2_blur_plain, ssim2_norms_plain,
                  ssim2_blur_iir_plain, ssim2_blur_norms_plain)


# ---------------------------------------------------------------------------
# The metric
# ---------------------------------------------------------------------------


def _as_rgb8(img, device: torch.device) -> torch.Tensor:
    if isinstance(img, torch.Tensor):
        if img.dtype != torch.uint8:
            raise ValueError(f"expected a uint8 image, got {img.dtype}")
        return img.to(device).contiguous()
    return torch.from_numpy(np.ascontiguousarray(img, dtype=np.uint8)).to(
        device)


def _check_size(shape) -> None:
    if len(shape) != 3 or shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {tuple(shape)}")
    if shape[0] < 8 or shape[1] < 8:
        raise ValueError("SSIMULACRA2 requires images at least 8x8")


def features_from_sums(sums: torch.Tensor, npix: int) -> torch.Tensor:
    """(N, 3, 6) float64 sums → the (N, 3, 6) float32 features of one
    scale: the three means (1-norms) and the 4th roots of the three means
    of 4th powers (4-norms)."""
    means = (sums / npix).to(torch.float32)
    return torch.cat([means[..., :3], means[..., 3:].sqrt().sqrt()], -1)


Pyramid = List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def ssimulacra2_precompute_ref(ref_rgb8, device=None,
                               ops: MetricOps = KERNELS) -> Pyramid:
    """The reference-side pyramid: per scale (img1, mu1, s11), each
    (3, h, w) float32 on ``device`` (``resolve_device()`` by default)."""
    ref = _as_rgb8(ref_rgb8, resolve_device(device))
    h, w = ref.shape[:2]
    out = []
    src = ref[None]
    for _ in range(_num_scales(h, w)):
        src, img1 = ops.pyramid(src)
        mu1, s11 = ops.blurs(img1)
        out.append((img1[0], mu1[0], s11[0]))
    return out


def pyramid_from_reference(ref_pyr, device=None) -> Pyramid:
    """The reference package's ``ssimulacra2_precompute_ref`` output (per
    scale (img1, mu1, s11), as numpy) as the port's tensors on ``device``,
    so that the tests can feed one side of the metric from the other."""
    dev = resolve_device(device)
    return [tuple(torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=dev) for a in scale)
            for scale in ref_pyr]


def scale_features(ref_pyr: Pyramid, dist: torch.Tensor,
                   ops: MetricOps = KERNELS) -> torch.Tensor:
    """(N, scales, 3, 6) float32 features of uint8 candidates (N, H, W, 3)
    against a reference pyramid."""
    feats = []
    src = dist
    radius = blur_radius()
    for img1, mu1, s11 in ref_pyr:
        src, img2 = ops.pyramid(src)
        ref = (img1[None], mu1[None], s11[None])
        if radius is None:
            sums = ops.norms(*ref, img2, *ops.blur_iir(img1[None], img2))
        else:
            sums = ops.blur_norms(*ref, img2, radius)
        feats.append(features_from_sums(sums, img2.shape[2] * img2.shape[3]))
    return torch.stack(feats, 1)


def score_from_features(feats: torch.Tensor) -> torch.Tensor:
    """(N, scales, 3, 6) features → (N,) float32 scores."""
    n, nsc = feats.shape[:2]
    f = feats.permute(0, 2, 1, 3).reshape(n, -1).abs()
    wts = torch.from_numpy(
        WEIGHTS.reshape(3, NUM_SCALES, 6)[:, :nsc, :].reshape(-1)
        .astype(np.float32)).to(f.device)
    return _finalize_score((f * wts).sum(1))


def ssimulacra2_from_precomputed(ref_pyr: Pyramid, dist_rgb8,
                                 ops: MetricOps = KERNELS) -> torch.Tensor:
    """Score a distorted uint8 image (H, W, 3), or a batch (N, H, W, 3),
    against a precomputed reference pyramid: a 0-dim, or (N,), float32
    tensor on the pyramid's device."""
    if not ref_pyr:
        raise ValueError("empty reference pyramid")
    img1 = ref_pyr[0][0]
    dist = _as_rgb8(dist_rgb8, img1.device)
    single = dist.dim() == 3
    if single:
        dist = dist[None]
    if dist.dim() != 4 or dist.shape[1:] != (*img1.shape[1:], 3):
        raise ValueError(f"shape mismatch {tuple(dist.shape)} vs reference "
                         f"{tuple(img1.shape[1:])}")
    scores = score_from_features(scale_features(ref_pyr, dist, ops))
    return scores[0] if single else scores


def compute_ssimulacra2(ref_rgb8, dist_rgb8, device=None) -> float:
    """Score two (H, W, 3) uint8 RGB images."""
    if tuple(ref_rgb8.shape) != tuple(dist_rgb8.shape):
        raise ValueError(
            f"shape mismatch {tuple(ref_rgb8.shape)} vs "
            f"{tuple(dist_rgb8.shape)}")
    _check_size(ref_rgb8.shape)
    pyr = ssimulacra2_precompute_ref(ref_rgb8, device)
    return float(ssimulacra2_from_precomputed(pyr, dist_rgb8))


def make_ref_scorer(ref_rgb8, device=None):
    """A scorer ``score(_ref_ignored, dist_rgb8) -> float`` with the
    reference pyramid resident on the device: each probe computes only the
    distorted side."""
    _check_size(ref_rgb8.shape)
    pyr = ssimulacra2_precompute_ref(ref_rgb8, device)

    def score(_ref_ignored, dist_rgb8) -> float:
        return float(ssimulacra2_from_precomputed(pyr, dist_rgb8))

    return score


def compute_ssimulacra2_batch(ref_rgb8, dist_batch, device=None) -> np.ndarray:
    """Score a (N, H, W, 3) batch of candidates against one reference in
    one pass of the kernels; (N,) float32."""
    _check_size(ref_rgb8.shape)
    if tuple(dist_batch.shape[1:]) != tuple(ref_rgb8.shape):
        raise ValueError(
            f"shape mismatch {tuple(dist_batch.shape)} vs "
            f"{tuple(ref_rgb8.shape)}")
    pyr = ssimulacra2_precompute_ref(ref_rgb8, device)
    return ssimulacra2_from_precomputed(pyr, dist_batch).cpu().numpy()
