"""The planner (the fused plan and the first SSD kernel), metric,
encode-stage, recursive-blur and Wiener kernels on an NVIDIA GPU: build,
launch, and equality with their plain PyTorch versions; the blur, the
encode-stage coefficients and quantization and the Wiener filter against
the first kernel of each (kept as yardsticks), bit for bit; the halo blur against the
single-device blur's columns, and the width-sharded metric on two ranks
sharing the card. Skipped without CUDA.

Imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import QUANT_WARPS, quant_cases  # noqa: E402
from oavif_tpu_torch.av1 import device_stage as DS  # noqa: E402
from oavif_tpu_torch.av1 import encode_tpu as ET  # noqa: E402
from oavif_tpu_torch.device import resolve_device  # noqa: E402
from oavif_tpu_torch.metric import ssimulacra2 as M  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # as every entry point does: this also turns cuDNN's TF32 off, which
    # the plain blur refuses to run with
    return resolve_device("cuda")


def _planes(cuda, bitdepth, h=320, w=448, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(ET.pad_plane(
        rng.integers(0, 1 << bitdepth, (h, w)), h // 64, w // 64,
        bitdepth)).to(cuda) for _ in range(3)]


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("n_px", [16, 32, 64])
def test_kernel_equals_plain(cuda, bitdepth, n_px):
    y = _planes(cuda, bitdepth)[0]
    nby, nbx = 320 // 64 * 64 // n_px, 448 // 64 * 64 // n_px
    base = 1 << (bitdepth - 1)
    for nmodes in (1, 5, 7, 13):
        launches = ET.mode_ssd.launches
        got = ET.mode_ssd(y, nby, nbx, n_px, base, nmodes)
        assert ET.mode_ssd.launches == launches + 1
        want = ET.mode_ssd_plain(y, nby, nbx, n_px, base, nmodes)
        torch.cuda.synchronize()
        assert got.device.type == "cuda" and got.dtype == torch.int64
        assert torch.equal(got, want)


@pytest.mark.parametrize("duel_level", [0, 1, 2])
def test_packed_plan_equals_plain(cuda, duel_level):
    """The fused kernel against the plain plan and against the first
    planner kernel's five SSD launches with the torch epilogue."""
    dev = _planes(cuda, 10, seed=duel_level)
    for q in (40, 120):
        got = ET.plan_device(*dev, q, 10, 13, duel_level)
        want = ET.plan_device_plain(*dev, q, 10, 13, duel_level)
        assert torch.equal(got, want)
        assert torch.equal(got, ET.plan_device_plain(
            *dev, q, 10, 13, duel_level, ssd=ET.mode_ssd))


def _crafted(kind, bitdepth, h, w):
    """A flat plane (every mode ties: DC must win), one bright pixel, a
    horizontal or a vertical ramp, or random pixels."""
    hi = 1 << bitdepth
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "flat":
        return np.full((h, w), hi // 3)
    if kind == "bright":
        return np.where((yy == h // 2 + 5) & (xx == w // 3), hi - 1, 7)
    if kind == "hramp":
        return xx * (hi - 1) // (w - 1)
    if kind == "vramp":
        return yy * (hi - 1) // (h - 1)
    return np.random.default_rng(bitdepth).integers(0, hi, (h, w))


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("kind,h,w", [
    ("flat", 320, 448), ("bright", 320, 448), ("hramp", 320, 448),
    ("vramp", 320, 448), ("random", 320, 448), ("random", 2160, 3840)])
def test_fused_plan_equals_plain(cuda, kind, bitdepth, h, w):
    """planner_plan == plan_device_plain bit for bit for every nmodes and
    duel level at q around the qindex-90 gate, on a 5x7 SB grid and on
    3840x2160 (33x60 SBs, its last 48 rows outside the full SBs)."""
    rng = np.random.default_rng(bitdepth)
    arrs = [_crafted(kind, bitdepth, h, w)]
    arrs += [rng.integers(0, 1 << bitdepth, (h, w)) for _ in range(2)]
    dev = [torch.from_numpy(ET.pad_plane(a, h // 64, w // 64, bitdepth))
           .to(cuda) for a in arrs]
    for nmodes in (5, 7, 13):
        for duel_level in (0, 1, 2):
            for q in (40, 88, 90, 91, 120, 255):
                launches = ET.plan_device.launches
                got = ET.plan_device(*dev, q, bitdepth, nmodes, duel_level)
                assert ET.plan_device.launches == launches + 1
                want = ET.plan_device_plain(*dev, q, bitdepth, nmodes,
                                            duel_level)
                assert got.dtype == torch.int32 and got.device == dev[0].device
                assert torch.equal(got, want), (nmodes, duel_level, q)


def test_planner_planes_live_on_the_card(cuda):
    rng = np.random.default_rng(1)
    planes = [rng.integers(0, 1024, (256, 256)) for _ in range(3)]
    fp = ET.FramePlanner(planes, 10, device=cuda)
    assert all(t.device.type == "cuda" and t.dtype == torch.int16
               for t in fp.dev)
    launches, old = ET.plan_device.launches, ET.mode_ssd.launches
    assert fp.plan(60) is fp.plan(70)
    assert ET.plan_device.launches == launches + 1
    assert ET.mode_ssd.launches == old


def test_plan_device_rejects_bad_input(cuda):
    y, u, v = _planes(cuda, 10)
    with pytest.raises(ValueError):
        ET.plan_device(y.to(torch.int32), u, v, 60, 10)
    with pytest.raises(ValueError):
        ET.plan_device(y, u, v, 60, 12)
    with pytest.raises(ValueError):  # no full superblock
        ET.plan_device(y[:60].contiguous(), u[:60].contiguous(),
                       v[:60].contiguous(), 60, 10)
    with pytest.raises(ValueError):  # chroma smaller than luma
        ET.plan_device(y, u[:65].contiguous(), v, 60, 10)
    with pytest.raises(ValueError):
        ET.plan_device(y, u, v, 60, 10, nmodes=1)


def test_kernel_rejects_bad_input(cuda):
    y = _planes(cuda, 8)[0]
    with pytest.raises(ValueError):
        ET.mode_ssd(y.to(torch.int32), 5, 7, 64, 128, 7)
    with pytest.raises(ValueError):
        ET.mode_ssd(y, 5, 7, 8, 128, 7)
    with pytest.raises(ValueError):
        ET.mode_ssd(y, 50, 7, 64, 128, 7)


# ---------------------------------------------------------------------------
# The metric kernels (csrc/ssimulacra2.cu) against their plain versions.
# Tolerances: linear RGB exact (a table built by the plain function; the
# same roundings in the downsample); XYB 2e-6 (cbrtf is within 1 ulp of
# the plain version's float64 cube root, and X' = 7 (l - m) + 0.42); blur
# 1e-5 (float32 taps summed in another order than cuDNN's); norms rtol
# 1e-10 (the same float32 maps, float64 sums in another order); scores
# 0.01; identity exactly 100.
# ---------------------------------------------------------------------------

def _batch(cuda, n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ref = np.clip(np.stack([128 + 90 * np.sin(xx / 9.0) * np.cos(yy / 7.0),
                            120 + 60 * np.cos(xx / 13.0),
                            100 + 80 * np.sin((xx + yy) / 11.0)], -1)
                  + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)
    dist = [np.clip(ref + rng.normal(0, s, ref.shape), 0, 255)
            .astype(np.uint8) for s in (0, 2, 6, 20)[:n]]
    return (torch.from_numpy(ref).to(cuda),
            torch.from_numpy(np.stack(dist)).to(cuda))


@pytest.mark.parametrize("h,w", [(8, 8), (37, 53), (256, 320)])
def test_pyramid_kernel_equals_plain(cuda, h, w):
    _, src = _batch(cuda, 4, h, w)
    for _ in range(M._num_scales(h, w)):
        launches = M.ssim2_pyramid.launches
        lin, xyb = M.ssim2_pyramid(src)
        assert M.ssim2_pyramid.launches == launches + 1
        plin, pxyb = M.ssim2_pyramid_plain(src)
        torch.cuda.synchronize()
        assert torch.equal(lin, plin)
        assert float((xyb - pxyb).abs().max()) <= 2e-6
        src = lin


@pytest.mark.parametrize("radius", [0, 5, 8])
@pytest.mark.parametrize("h,w", [(8, 8), (37, 53), (256, 320)])
def test_blur_kernel_equals_plain(cuda, radius, h, w):
    ref, dist = _batch(cuda, 4, h, w)
    img1 = M.ssim2_pyramid(ref[None])[1]
    img2 = M.ssim2_pyramid(dist)[1]
    for got, want in ((M.ssim2_blur(img1, None, radius),
                       M.ssim2_blur_plain(img1, None, radius)),
                      (M.ssim2_blur(img1, img2, radius),
                       M.ssim2_blur_plain(img1, img2, radius))):
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            assert float((g - p).abs().max()) <= 1e-5
    # the identical candidate (index 0) gives the reference side's bits
    mu1, s11 = M.ssim2_blur(img1, None, radius)
    mu2, s22, s12 = M.ssim2_blur(img1, img2, radius)
    assert torch.equal(mu2[0], mu1[0]) and torch.equal(s22[0], s11[0])
    assert torch.equal(s12[0], s11[0])


def _assert_blur_equals_simple(img1, img2, radius, halo=0):
    """ssim2_blur == ssim2_blur_simple bit for bit, reference side and
    distorted side, each counted on its own wrapper."""
    for second in (None, img2):
        c0, s0 = M.ssim2_blur.launches, M.ssim2_blur_simple.launches
        got = M.ssim2_blur(img1, second, radius, halo)
        want = M.ssim2_blur_simple(img1, second, radius, halo)
        torch.cuda.synchronize()
        assert (M.ssim2_blur.launches, M.ssim2_blur_simple.launches) == (
            c0 + 1, s0 + 1)
        assert len(got) == len(want) == (2 if second is None else 3)
        for g, s in zip(got, want):
            assert g.shape == s.shape
            assert torch.equal(g.view(torch.int32), s.view(torch.int32))


# 150x270 is wider and taller than any tile, with a width that is no
# multiple of 4 (4-byte staging loads) and ragged tiles on both edges
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("radius", [0, 3, 5, 8])
@pytest.mark.parametrize("h,w", [(8, 8), (37, 53), (256, 320), (150, 270)])
def test_blur_kernel_equals_simple_kernel(cuda, h, w, radius, n):
    ref, dist = _batch(cuda, n, h, w)
    img1 = M.ssim2_pyramid(ref[None])[1]
    img2 = M.ssim2_pyramid(dist)[1]
    _assert_blur_equals_simple(img1, img2, radius)
    if n > 1:  # a reference per candidate
        _assert_blur_equals_simple(img2.flip(0).contiguous(), img2, radius)


@pytest.mark.parametrize("h,win", [(64, 80), (135, 256), (70, 149)])
def test_halo_blur_kernel_equals_simple_kernel(cuda, h, win):
    """Halo 8 at shard shapes (16-byte staging loads) and at an odd width
    (4-byte loads)."""
    ref, dist = _batch(cuda, 4, h, win)
    img1 = M.ssim2_pyramid(ref[None])[1]
    img2 = M.ssim2_pyramid(dist)[1]
    _assert_blur_equals_simple(img1, img2, 8, halo=8)
    _assert_blur_equals_simple(img1, img2, 5, halo=8)
    _assert_blur_equals_simple(img1, img2, 8, halo=3)


def test_blur_kernel_equals_simple_kernel_on_many_segments(cuda):
    """A plane of 60 strips and 9 segments of rows, the last one ragged."""
    ref, dist = _batch(cuda, 4, 1030, 3840)
    img1 = M.ssim2_pyramid(ref[None])[1]
    img2 = M.ssim2_pyramid(dist)[1]
    _assert_blur_equals_simple(img1, img2, 8)


def test_blur_kernel_takes_planes_off_16_byte_alignment(cuda):
    """A contiguous view that starts 4 bytes into its storage takes the
    4-byte staging loads and gives the same bits."""
    ref, dist = _batch(cuda, 2, 40, 72)
    img1 = M.ssim2_pyramid(ref[None])[1]
    img2 = M.ssim2_pyramid(dist)[1]
    want = M.ssim2_blur(img1, img2, 8)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4 and view.is_contiguous()
        return view

    got = M.ssim2_blur(shifted(img1), shifted(img2), 8)
    torch.cuda.synchronize()
    assert all(torch.equal(g, s) for g, s in zip(got, want))


@pytest.mark.parametrize("h,w", [(8, 8), (37, 53), (256, 320)])
def test_norms_kernel_equals_plain(cuda, h, w):
    ref, dist = _batch(cuda, 4, h, w)
    img1 = M.ssim2_pyramid(ref[None])[1]
    img2 = M.ssim2_pyramid(dist)[1]
    mu1, s11 = M.ssim2_blur(img1, None, 8)
    planes = (img1, mu1, s11, img2, *M.ssim2_blur(img1, img2, 8))
    got = M.ssim2_norms(*planes)
    want = M.ssim2_norms_plain(*planes)
    torch.cuda.synchronize()
    assert got.shape == (4, 3, 6) and got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-10, atol=0)
    assert torch.count_nonzero(got[0]) == 0  # identity: every map is 0


@pytest.mark.parametrize("h,w", [(8, 8), (37, 53), (256, 320)])
def test_score_kernels_equal_plain_identity_and_repeat(cuda, h, w):
    ref, dist = _batch(cuda, 4, h, w)
    pyr = M.ssimulacra2_precompute_ref(ref, cuda)
    got = M.ssimulacra2_from_precomputed(pyr, dist)
    again = M.ssimulacra2_from_precomputed(
        M.ssimulacra2_precompute_ref(ref, cuda), dist)
    plain = M.ssimulacra2_from_precomputed(
        M.ssimulacra2_precompute_ref(ref, cuda, M.PLAIN), dist, M.PLAIN)
    torch.cuda.synchronize()
    assert float(got[0]) == 100.0
    assert torch.equal(got, again)
    assert float((got - plain).abs().max()) <= 0.01


def test_metric_kernels_reject_bad_input(cuda):
    ref, dist = _batch(cuda, 2, 37, 53)
    xyb = M.ssim2_pyramid(dist)[1]
    with pytest.raises(ValueError):
        M.ssim2_pyramid(dist.to(torch.int16))
    with pytest.raises(ValueError):
        M.ssim2_pyramid(dist.permute(0, 2, 1, 3))
    with pytest.raises(ValueError):
        M.ssim2_blur(xyb, xyb.cpu(), 8)
    with pytest.raises(ValueError):
        M.ssim2_blur(xyb, None, 9)
    with pytest.raises(ValueError):
        M.ssim2_blur(xyb.transpose(2, 3), None, 8)
    with pytest.raises(ValueError):
        M.ssim2_blur(xyb.double(), None, 8)
    with pytest.raises(ValueError):
        M.ssim2_norms(xyb, xyb, xyb, xyb[:, :, :-1].contiguous(), xyb, xyb,
                      xyb)


# ---------------------------------------------------------------------------
# The encode-stage kernels (csrc/device_stage.cu) against their plain
# versions. K3a: |diff| <= 1e-6 * max|c| of the block + 1e-3, because the
# two float32 products sum in another order (the kernel's FMAs against
# cuBLAS) while predictions and residuals are exact. K3b: bit-identical
# (the same float32 operations, rounded alike, on the same coefficients).
# ---------------------------------------------------------------------------

def _coeff_excess(got, want):
    """max over blocks of |got - want| - the K3a bound (<= 0 passes)."""
    bound = 1e-6 * want.abs().amax((1, 2)) + 1e-3
    return float(((got - want).abs().amax((1, 2)) - bound).max())


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_coeffs16_kernel_equals_plain(cuda, bitdepth):
    y = _planes(cuda, bitdepth, seed=bitdepth)[0]
    nby, nbx = 320 // 16, 448 // 16
    rng = np.random.default_rng(bitdepth)
    for modes in (torch.zeros((nby, nbx), dtype=torch.int32),
                  torch.from_numpy(rng.integers(0, 7, (nby, nbx))
                                   .astype(np.int32))):
        modes = modes.to(cuda)
        launches = DS.coeffs16.launches
        got = DS.coeffs16(y, nby, nbx, modes, bitdepth)
        assert DS.coeffs16.launches == launches + 1
        want = DS.coeffs16_plain(y, nby, nbx, modes, bitdepth)
        torch.cuda.synchronize()
        assert got.shape == (nby * nbx, 16, 16) and got.dtype == torch.float32
        assert _coeff_excess(got, want) <= 0


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("nby,nbx", [(21, 27), (1, 5), (3, 33), (24, 32)])
def test_coeffs16_kernel_equals_simple_kernel(cuda, bitdepth, nby, nbx):
    """The strip kernel against the first K3a kernel bit for bit, and
    within K3a's bound of the plain version: odd block counts both ways,
    strips short of 16 blocks (27 = 16 + 11, 5, 33 = 2 x 16 + 1), the first
    block row and column (the fills), every mode alone and mixed, on random
    pixels and on a flat plane (every residual 0)."""
    rng = np.random.default_rng(nby * 100 + nbx + bitdepth)
    hi = 1 << bitdepth
    for arr in (rng.integers(0, hi, (384, 576)), np.full((384, 576), hi // 3)):
        y = torch.from_numpy(ET.pad_plane(arr, 6, 9, bitdepth)).to(cuda)
        mode_sets = [np.full((nby, nbx), m) for m in range(7)]
        mode_sets.append(rng.integers(0, 7, (nby, nbx)))
        for modes in mode_sets:
            m = torch.from_numpy(modes.astype(np.int32)).to(cuda)
            launches = (DS.coeffs16.launches, DS.coeffs16_simple.launches)
            got = DS.coeffs16(y, nby, nbx, m, bitdepth)
            want = DS.coeffs16_simple(y, nby, nbx, m, bitdepth)
            assert (DS.coeffs16.launches, DS.coeffs16_simple.launches) == (
                launches[0] + 1, launches[1] + 1)
            plain = DS.coeffs16_plain(y, nby, nbx, m, bitdepth)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            assert _coeff_excess(got, plain) <= 0


def _quant_all(cf, dqd, dqa, shift=0):
    """quant16, quant16_simple and quant16_plain, each launch counted."""
    launches = (DS.quant16.launches, DS.quant16_simple.launches)
    got = DS.quant16(cf, dqd, dqa, shift)
    simple = DS.quant16_simple(cf, dqd, dqa, shift)
    assert (DS.quant16.launches, DS.quant16_simple.launches) == (
        launches[0] + 1, launches[1] + 1)
    plain = DS.quant16_plain(cf, dqd, dqa, shift)
    torch.cuda.synchronize()
    for a, b in ((got, plain), (got, simple)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    return got


def _level_dq(qs, cuda):
    return (torch.tensor([float(DS.dc_q(q, 10)) for q in qs], device=cuda),
            torch.tensor([float(DS.ac_q(q, 10)) for q in qs], device=cuda))


def test_quant16_kernel_equals_plain(cuda):
    y = _planes(cuda, 10, seed=3)[0]
    modes = torch.from_numpy(np.random.default_rng(3).integers(
        0, 7, (20, 28)).astype(np.int32)).to(cuda)
    cf = DS.coeffs16(y, 20, 28, modes, 10)
    dqd, dqa = _level_dq([30, 60, 90], cuda)
    lv, eob = _quant_all(cf, dqd, dqa)
    assert int((lv != 0).sum()) > 0
    for k in range(3):
        one = _quant_all(cf, dqd[k : k + 1], dqa[k : k + 1])
        assert torch.equal(one[0][0], lv[k]) and torch.equal(one[1][0],
                                                             eob[k])


@pytest.mark.parametrize("case", sorted(quant_cases()))
def test_quant16_kernel_equals_plain_on_edge(cuda, case):
    """The crafted edges (chip_smoke.quant_cases): exact halves, the clip,
    negative zeros, eob 0, 256 and 1."""
    c, dqd, dqa, shift = quant_cases()[case]
    _quant_all(*(torch.from_numpy(x).to(cuda) for x in (c, dqd, dqa)),
               shift)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [1, QUANT_WARPS - 1, QUANT_WARPS + 1])
def test_quant16_kernel_equals_plain_at_k_and_n(cuda, k, n):
    """Any count of quantizers; a CTA's last warps masked."""
    rng = np.random.default_rng(10 * k + n)
    cf = torch.from_numpy(rng.normal(0, 300, (n, 16, 16)).astype(
        np.float32)).to(cuda)
    lv, _ = _quant_all(cf, *_level_dq((30, 60, 90, 120, 200)[:k], cuda))
    assert lv.shape == (k, n, 256)


def test_quant16_kernel_refuses_misaligned_levels(cuda):
    cf = torch.zeros((5, 16, 16), device=cuda)
    dqd, dqa = _level_dq([30], cuda)
    raw = torch.empty(5 * 256 + 1, dtype=torch.int16, device=cuda)
    eob = torch.empty((1, 5), dtype=torch.int32, device=cuda)
    launches = DS.quant16.launches
    with pytest.raises(ValueError, match="aligned"):
        DS.quant16(cf, dqd, dqa, out=(raw[1:].view(1, 5, 256), eob))
    flat = torch.empty(5 * 256 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        DS.quant16(flat[1:].view(5, 16, 16), dqd, dqa)
    assert DS.quant16.launches == launches


def test_device_levels_fetch_pinned_and_survive_the_next_probe(cuda):
    rng = np.random.default_rng(6)
    planes = [rng.integers(0, 1024, (256, 256)) for _ in range(3)]
    dl = DS.DeviceLevels(ET.FramePlanner(planes, 10, device=cuda), 10)
    modes = rng.integers(0, 7, (16, 16)).astype(np.int32)
    lv, eob = dl.levels(modes, [40])
    assert torch.from_numpy(lv).is_pinned()
    kept = lv.copy(), eob.copy()
    lv2, _ = dl.levels(modes, [200])
    assert not np.array_equal(lv2, kept[0])
    assert np.array_equal(lv, kept[0]) and np.array_equal(eob, kept[1])


def test_device_levels_launch_the_kernels(cuda):
    rng = np.random.default_rng(5)
    planes = [rng.integers(0, 1024, (256, 320)) for _ in range(3)]
    fp = ET.FramePlanner(planes, 10, device=cuda)
    dl = DS.DeviceLevels(fp, 10)
    modes = rng.integers(0, 7, (16, 20)).astype(np.int32)
    c0, q0 = DS.coeffs16.launches, DS.quant16.launches
    lv, eob = dl.levels(modes, [40, 80])
    dl.levels(modes, [60])
    assert (DS.coeffs16.launches, DS.quant16.launches) == (c0 + 1, q0 + 2)
    assert lv.shape == (2, 320, 256) and eob.shape == (2, 320)
    plv, peob = DS.quant16_plain(
        DS.coeffs16(fp.dev[0], 16, 20, torch.from_numpy(modes).to(cuda), 10),
        torch.tensor([float(DS.dc_q(q, 10)) for q in (40, 80)], device=cuda),
        torch.tensor([float(DS.ac_q(q, 10)) for q in (40, 80)], device=cuda))
    assert np.array_equal(lv, plv.cpu().numpy())
    assert np.array_equal(eob, peob.cpu().numpy())


def test_encode_stage_kernels_reject_bad_input(cuda):
    y = _planes(cuda, 8)[0]
    modes = torch.zeros((20, 28), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        DS.coeffs16(y.to(torch.int32), 20, 28, modes, 8)
    with pytest.raises(ValueError):
        DS.coeffs16(y, 21, 28, modes, 8)
    with pytest.raises(ValueError):
        DS.coeffs16(y, 20, 27, modes, 8)
    cf = DS.coeffs16(y, 20, 28, modes, 8)
    dq = torch.ones(2, device=cuda)
    with pytest.raises(ValueError):
        DS.quant16(cf.double(), dq, dq)
    with pytest.raises(ValueError):
        DS.quant16(cf, dq[:1], dq)
    with pytest.raises(ValueError):
        DS.quant16(cf.transpose(1, 2), dq, dq)
    with pytest.raises(ValueError):
        DS.quant16_simple(cf.transpose(1, 2), dq, dq)


# ---------------------------------------------------------------------------
# The multi-device leg's kernels and the recursive blur. The halo blur of a
# width slice must be the single-device blur's columns bit for bit (the
# same taps summed in the same order); the recursive blur and the Wiener
# filter must equal their plain versions bit for bit (the same float32
# operations in the same order; int32 arithmetic).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_halo_blur_kernel_equals_single_device_columns(cuda, n):
    ref, dist = _batch(cuda, 4, 64, 128)
    img1 = M.ssim2_pyramid(ref[None])[1]
    img2 = M.ssim2_pyramid(dist)[1]
    full = M.ssim2_blur(img1, None, 8) + M.ssim2_blur(img1, img2, 8)
    pad1 = torch.nn.functional.pad(img1, (8, 8))
    pad2 = torch.nn.functional.pad(img2, (8, 8))
    ws = 128 // n
    for i in range(n):
        e1 = pad1[..., i * ws : i * ws + ws + 16].contiguous()
        e2 = pad2[..., i * ws : i * ws + ws + 16].contiguous()
        got = M.ssim2_blur(e1, None, 8, 8) + M.ssim2_blur(e1, e2, 8, 8)
        plain = (M.ssim2_blur_plain(e1, None, 8, 8)
                 + M.ssim2_blur_plain(e1, e2, 8, 8))
        torch.cuda.synchronize()
        for g, f, p in zip(got, full, plain):
            cols = f[..., i * ws : (i + 1) * ws].contiguous()
            assert torch.equal(g.view(torch.int32), cols.view(torch.int32))
            assert float((g - p).abs().max()) <= 1e-5


@pytest.mark.parametrize("h,w", [(8, 8), (37, 53), (256, 320), (9, 31),
                                 (31, 9), (33, 65), (70, 100)])
def test_iir_kernel_equals_plain(cuda, h, w):
    ref, dist = _batch(cuda, 4, h, w)
    img1 = M.ssim2_pyramid(ref[None])[1]
    img2 = M.ssim2_pyramid(dist)[1]
    launches = M.ssim2_blur_iir.launches
    got = M.ssim2_blur_iir(img1, None) + M.ssim2_blur_iir(img1, img2)
    assert M.ssim2_blur_iir.launches == launches + 2
    want = M.ssim2_blur_iir_plain(img1, None) + M.ssim2_blur_iir_plain(img1,
                                                                       img2)
    torch.cuda.synchronize()
    assert all(torch.equal(g, p) for g, p in zip(got, want))
    # the identical candidate gives the reference side's bits
    assert torch.equal(got[2][0], got[0][0])


def _wiener_ext(cuda, bitdepth, h=130, w=197, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 1 << bitdepth, (h, w)).astype(np.int32)
    d = np.clip(c + rng.integers(-4, 5, (h, w)), 0, (1 << bitdepth) - 1)
    return (torch.from_numpy(c).to(cuda),
            torch.from_numpy(d.astype(np.int32)).to(cuda))


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_wiener_kernel_equals_plain(cuda, bitdepth):
    from oavif_tpu_torch.av1 import restoration_sharded as WS

    cdef, deblk = _wiener_ext(cuda, bitdepth, seed=bitdepth)
    vf, hf = (3, -7, 15, 106, 15, -7, 3), (-2, 4, 28, 68, 28, 4, -2)
    launches = WS.wiener_bands.launches
    got = WS.wiener_bands(cdef, deblk, vf, hf, bitdepth)
    assert WS.wiener_bands.launches == launches + 1
    want = WS.wiener_bands_plain(cdef, deblk, vf, hf, bitdepth)
    torch.cuda.synchronize()
    assert got.shape == (130, 191) and torch.equal(got, want)


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("h,we", [(40, 64), (56, 130), (57, 96), (130, 197),
                                  (130, 198), (200, 250), (183, 70)])
def test_wiener_kernel_equals_simple_kernel(cuda, bitdepth, h, we):
    """The register-window kernel against the first Wiener kernel and the
    plain version, bit for bit: one band (h <= 56), partial last bands
    (57, 130, 183, 200 rows), widths short of a 64-column tile (58, 64 + 60,
    90, 191, 192, 244 columns), odd widths (scalar rows) and even ones
    (int2 rows), and even ones 4 bytes off 8-byte alignment (scalar rows
    again)."""
    from oavif_tpu_torch.av1 import restoration_sharded as WS

    cdef, deblk = _wiener_ext(cuda, bitdepth, h, we, seed=h + we)
    cases = [(cdef, deblk)]
    if we % 2 == 0:  # the same planes 4 bytes past an 8-byte boundary
        off = []
        for t in (cdef, deblk):
            buf = torch.empty(t.numel() + 1, dtype=torch.int32, device=cuda)
            buf[1:].copy_(t.reshape(-1))
            off.append(buf[1:].view(h, we))
        cases.append(tuple(off))
    taps = [((3, -7, 15, 106, 15, -7, 3), (-2, 4, 28, 68, 28, 4, -2)),
            ((-5, 10, -17, 152, -17, 10, -5), (3, -14, 34, 82, 34, -14, 3))]
    for c, d in cases:
        for vf, hf in taps:
            launches = (WS.wiener_bands.launches,
                        WS.wiener_bands_simple.launches)
            got = WS.wiener_bands(c, d, vf, hf, bitdepth)
            simple = WS.wiener_bands_simple(c, d, vf, hf, bitdepth)
            assert (WS.wiener_bands.launches,
                    WS.wiener_bands_simple.launches) == (launches[0] + 1,
                                                         launches[1] + 1)
            want = WS.wiener_bands_plain(c, d, vf, hf, bitdepth)
            torch.cuda.synchronize()
            assert got.shape == (h, we - 6)
            assert torch.equal(got, simple) and torch.equal(got, want)


def test_wiener_kernel_rejects_bad_input(cuda):
    from oavif_tpu_torch.av1 import restoration_sharded as WS

    cdef, deblk = _wiener_ext(cuda, 8)
    taps = (0, 0, 0, 128, 0, 0, 0)
    with pytest.raises(ValueError):
        WS.wiener_bands(cdef.float(), deblk, taps, taps, 8)
    with pytest.raises(ValueError):
        WS.wiener_bands(cdef, deblk[:, 1:].contiguous(), taps, taps, 8)
    with pytest.raises(ValueError):
        WS.wiener_bands(cdef, deblk, taps, taps, 12)


def test_sharded_metric_on_the_card(cuda):
    from oavif_tpu_torch.metric.sharded import compute_ssimulacra2_sharded

    ref, dist = _batch(cuda, 2, 128, 256)
    ref, dist = ref.cpu().numpy(), dist[1].cpu().numpy()
    single = M.compute_ssimulacra2(ref, dist, cuda)
    got = compute_ssimulacra2_sharded(ref, dist, 2, device="cuda",
                                      timeout_s=120)
    assert abs(got - single) < 1e-3, (got, single)


def test_sharded_checks_on_the_card(cuda):
    """The multi-device check body on two ranks sharing the card: the
    sharded score launches the metric kernels, counted apart from the
    checks', and its halo blur is the single-device kernel's columns bit
    for bit and within the blur's plain bound."""
    from oavif_tpu_torch import parallel, shard_checks
    from oavif_tpu_torch.kernels import kernel_key

    ref, dist = _batch(cuda, 2, 128, 256)
    ref, dist = ref.cpu().numpy(), dist[1].cpu().numpy()
    results, counts = parallel.spawn(shard_checks.metric_rank, 2,
                                     args=(ref, dist), device="cuda",
                                     timeout_s=120)
    for r, c in zip(results, counts):
        assert r["differ"] == 0 and r["plain_err"] <= 1e-5
        for wrapper in (M.ssim2_pyramid, M.ssim2_blur, M.ssim2_norms):
            key = kernel_key(wrapper)
            assert 0 < r["launches"][key] <= c[key]
        # the checks launch the pyramid and the blur again, not the norms
        for wrapper in (M.ssim2_pyramid, M.ssim2_blur):
            key = kernel_key(wrapper)
            assert r["launches"][key] < c[key]


def _cli(args, src, out):
    import contextlib
    import io

    from oavif_tpu_torch import cli
    from oavif_tpu_torch.av1 import frame

    frame.reset_planners()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.run(args + [str(src), str(out)])
    assert rc == 0, err.getvalue()
    return err.getvalue(), out.read_bytes()


@pytest.mark.parametrize("name", ["sinusoid", "mixed"])
def test_png_input_gives_the_pam_bytes_on_the_card(cuda, tmp_path, name):
    from oavif_tpu_torch.scripts.corpus import (bench_images, write_pam,
                                                write_png)

    rgb = bench_images(256, (name,))[name]
    write_pam(str(tmp_path / "a.pam"), rgb)
    write_png(str(tmp_path / "a.png"), rgb)
    pam_log, pam = _cli(["-t", "80"], tmp_path / "a.pam", tmp_path / "1.avif")
    png_log, png = _cli(["-t", "80"], tmp_path / "a.png", tmp_path / "2.avif")
    assert png == pam
    assert pam_log.splitlines()[-2:] == png_log.splitlines()[-2:]


def test_trace_holds_the_planner_kernel_on_the_card(cuda, tmp_path,
                                                    monkeypatch):
    """``OAVIF_TRACE`` on CUDA: the search's Chrome trace holds the fused
    planner kernel's records on the device, and the bytes do not move."""
    import json

    from oavif_tpu_torch.scripts.corpus import bench_images, write_pam

    write_pam(str(tmp_path / "a.pam"),
              bench_images(512, ("mixed",))["mixed"])
    _, plain = _cli(["-t", "80"], tmp_path / "a.pam", tmp_path / "1.avif")
    monkeypatch.setenv("OAVIF_TRACE", str(tmp_path / "trace"))
    log, traced = _cli(["-t", "80"], tmp_path / "a.pam", tmp_path / "2.avif")
    assert f"Profiler trace written to {tmp_path / 'trace'}" in log
    assert traced == plain
    (path,) = (tmp_path / "trace").glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert any("plan_kernel" in e["name"] for e in kernels), (
        sorted({e["name"] for e in kernels})[:20])


def test_harness_two_ranks_on_the_card(cuda, tmp_path):
    """The corpus harness on two ranks sharing the card (gloo), each
    taking its shard from the process group; the planner kernel launches
    in the ranks."""
    import csv

    from oavif_tpu_torch import parallel
    from oavif_tpu_torch.kernels import kernel_key
    from oavif_tpu_torch.scripts import measure
    from oavif_tpu_torch.scripts.corpus import bench_images, write_png

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for name, rgb in bench_images(256, ("edges", "text", "mixed")).items():
        write_png(str(corpus / f"{name}.png"), rgb)
    csvs = [tmp_path / f"shard{k}.csv" for k in (0, 1)]
    argv = [[str(corpus), "module:oavif_tpu_torch", str(c)] for c in csvs]
    rcs, counts = parallel.spawn(measure.shard_rank, 2, args=(argv,),
                                 device="cuda", timeout_s=300)
    assert rcs == [0, 0]
    names = []
    for c in csvs:
        with open(c) as f:
            rows = list(csv.DictReader(f))
        assert all(r["Status"] == "ok" for r in rows), rows
        names.append([r["Image"] for r in rows])
    assert names == [["edges.png", "text.png"], ["mixed.png"]]
    assert all(c[kernel_key(ET.plan_device)] > 0 for c in counts)
