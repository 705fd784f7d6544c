"""The port's SSIMULACRA2 (oavif_tpu_torch.metric.ssimulacra2) against the
JAX reference (oavif_tpu.metric.ssimulacra2) and the C scorer, on the CPU,
where every kernel wrapper takes its plain PyTorch version.

Tolerances, with their reasons:
- constants: equal;
- rgb8_to_linear, linear_rgb_to_xyb_positive, downsample2: atol 1e-6.
  Both sides round in float32; the port's cube root is correctly rounded
  (float64, rounded once) where XLA's ``jnp.cbrt`` is off by up to 1 ulp,
  which X' = 7 (l - m) + 0.42 amplifies to at most ~9e-7;
- blur: atol 1e-5 (17x17 float32 taps summed in another order);
- the 108 features: rtol 1e-3, and atol 1e-6 for the edge features
  (artifact, detail lost) but 1e-5 for the SSIM error features. The SSIM
  map divides local variances, differences s11 - mu1² of float32 blurs near
  0.5; blurs that differ by 1e-7 (the order of the taps' sum) move a local
  variance of 1e-4 by 1e-3 relative, which leaves up to ~5e-6 of absolute
  noise on the SSIM features of near-identical images (measured on these
  fixtures at noise sigma 1-20); the score bound below covers its effect;
- scores: within 0.01 of the JAX score, and within 0.5 of the reference's
  self-goldens (tests/test_metric.py);
- identity: 100 within 1e-6; batch against single: 1e-3;
- against the C scorer: 0.05 (the bound tests/test_metric.py holds the JAX
  metric to);
- the recursive blur (``OAVIF_METRIC_BLUR=iir``): atol 1e-5 against the
  JAX ``blur_iir`` (observed at most 2.98e-7 on these planes: XLA rounds
  the recursion's products and sums otherwise than the port's separately
  rounded float32 operations), and scores within 0.01.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import oavif_tpu.metric.ssimulacra2 as R
import oavif_tpu_torch.metric.ssimulacra2 as P
from oavif_tpu_torch.metric import native

CPU = torch.device("cpu")
SIZES = [(96, 128), (37, 53), (8, 8)]


def _image(h: int, w: int, test_rgb8) -> np.ndarray:
    if (h, w) == test_rgb8.shape[:2]:
        return test_rgb8
    return np.random.default_rng(h * 1000 + w).integers(
        0, 256, (h, w, 3), dtype=np.uint8)


def _noisy(img: np.ndarray, sigma: float, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(img.astype(np.float64) + rng.normal(0, sigma, img.shape),
                   0, 255).astype(np.uint8)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _reference_features(ref: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """(scales, 3, 6) features of the reference's own functions, in the
    order of ssimulacra2_from_precomputed."""
    pyr = R.ssimulacra2_precompute_ref(ref)
    lin2 = R.rgb8_to_linear(dist)
    feats = []
    for s, (img1, mu1, s11) in enumerate(pyr):
        if s:
            lin2 = R.downsample2(lin2)
        img2 = R.linear_rgb_to_xyb_positive(lin2)
        mu2, s22, s12 = R.blur(img2), R.blur(img2 * img2), R.blur(img1 * img2)
        ssim1, ssim4 = R._ssim_map_norms(mu1, mu2, s11, s22, s12)
        a1, a4, l1, l4 = R._edge_diff_norms(img1, mu1, img2, mu2)
        feats.append(np.stack([ssim1, a1, l1, ssim4, a4, l4], -1))
    return np.stack(feats)


@pytest.mark.parametrize("name", [
    "WEIGHTS", "_OPSIN_M", "_OPSIN_BIAS", "_CBRT_OPSIN_BIAS", "_FINAL_POW",
    "_FINAL_SCALE", "_CUBIC", "_C2", "_SIGMA", "_KERNEL_RADIUS",
    "NUM_SCALES"])
def test_constants_equal(name):
    ref, port = getattr(R, name), getattr(P, name)
    assert np.asarray(port).dtype == np.asarray(ref).dtype
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


@pytest.mark.parametrize("radius", [0, 3, 5, 8])
def test_gauss_kernel_and_l1_error_equal(radius):
    np.testing.assert_array_equal(P._gauss_kernel(radius),
                                  R._gauss_kernel(radius))
    assert P.kernel_l1_error(radius) == R.kernel_l1_error(radius)


@pytest.mark.parametrize("h,w", [(8, 8), (9, 8), (32, 32), (37, 53),
                                 (96, 128), (512, 512), (7, 512), (2160, 3840)])
def test_num_scales_match(h, w):
    assert P._num_scales(h, w) == R._num_scales(h, w)


@pytest.mark.parametrize("h,w", SIZES)
def test_colour_and_downsample_per_scale(h, w, test_rgb8):
    img = _image(h, w, test_rgb8)
    lin_r = np.asarray(R.rgb8_to_linear(img))
    np.testing.assert_allclose(P.rgb8_to_linear(_t(img)).numpy(), lin_r,
                               rtol=0, atol=1e-6)
    for s in range(R._num_scales(h, w)):
        if s:
            down = P.downsample2(_t(lin_r)).numpy()
            lin_r = np.asarray(R.downsample2(lin_r))
            np.testing.assert_allclose(down, lin_r, rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            P.linear_rgb_to_xyb_positive(_t(lin_r)).numpy(),
            np.asarray(R.linear_rgb_to_xyb_positive(lin_r)), rtol=0,
            atol=1e-6)


@pytest.mark.parametrize("h,w", SIZES)
def test_blur_per_scale(h, w, test_rgb8):
    for img1, _, _ in R.ssimulacra2_precompute_ref(_image(h, w, test_rgb8)):
        img1 = np.asarray(img1)
        for x in (img1, img1 * img1):
            np.testing.assert_allclose(P.blur(_t(x)).numpy(),
                                       np.asarray(R.blur(x)), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("h,w", SIZES)
def test_features_match_reference(h, w, test_rgb8):
    ref = _image(h, w, test_rgb8)
    dist = _noisy(ref, 6)
    want = _reference_features(ref, dist)
    pyr = P.ssimulacra2_precompute_ref(ref, CPU)
    got = P.scale_features(pyr, _t(dist)[None])[0].numpy()
    assert got.shape == want.shape == (P._num_scales(h, w), 3, 6)
    ssim, edge = [0, 3], [1, 2, 4, 5]
    np.testing.assert_allclose(got[..., ssim], want[..., ssim], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got[..., edge], want[..., edge], rtol=1e-3,
                               atol=1e-6)
    # the reference-side pyramid itself, scale by scale
    for mine, theirs in zip(pyr, R.ssimulacra2_precompute_ref(ref)):
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("sigma", [2, 8])
def test_pyramid_from_reference_feeds_the_port(sigma, test_rgb8):
    dist = _noisy(test_rgb8, sigma)
    ref_pyr = R.ssimulacra2_precompute_ref(test_rgb8)
    got = float(P.ssimulacra2_from_precomputed(
        P.pyramid_from_reference(ref_pyr, CPU), dist))
    want = float(R.ssimulacra2_from_precomputed(ref_pyr, dist))
    assert abs(got - want) < 0.01, (got, want)


def _golden_fixtures(img):
    d_rng = np.random.default_rng(99)
    return {
        "shift8": (np.clip(img.astype(np.int16) + 8, 0, 255)
                   .astype(np.uint8), 79.663),
        "noise3": (np.clip(img.astype(np.float64)
                           + d_rng.normal(0, 3, img.shape), 0, 255)
                   .astype(np.uint8), 74.265),
        "blur1": (np.clip(gaussian_filter(img.astype(np.float64),
                                          (1.0, 1.0, 0)), 0, 255)
                  .astype(np.uint8), 61.817),
        "quant32": (((img.astype(np.int16) // 32) * 32 + 16)
                    .astype(np.uint8), -5.804),
        "chroma_swap": (img[:, :, [0, 2, 1]], -239.329),
    }


@pytest.mark.parametrize("name", ["shift8", "noise3", "blur1", "quant32",
                                  "chroma_swap"])
def test_self_goldens(name, test_rgb8):
    dist, golden = _golden_fixtures(test_rgb8)[name]
    got = P.compute_ssimulacra2(test_rgb8, dist, CPU)
    want = R.compute_ssimulacra2(test_rgb8, dist)
    assert abs(got - want) < 0.01, (got, want)
    assert abs(got - golden) < 0.5, (got, golden)


@pytest.mark.parametrize("h,w", SIZES)
def test_identity_scores_100(h, w, test_rgb8):
    img = _image(h, w, test_rgb8)
    assert abs(P.compute_ssimulacra2(img, img, CPU) - 100.0) < 1e-6
    assert abs(P.make_ref_scorer(img, CPU)(None, img) - 100.0) < 1e-6


def test_batch_matches_single(test_rgb8):
    dists = np.stack([_noisy(test_rgb8, s, seed=s) for s in (2, 8, 20)])
    batch = P.compute_ssimulacra2_batch(test_rgb8, dists, CPU)
    assert batch.shape == (3,) and batch.dtype == np.float32
    singles = [P.compute_ssimulacra2(test_rgb8, d, CPU) for d in dists]
    np.testing.assert_allclose(batch, singles, rtol=0, atol=1e-3)
    scorer = P.make_ref_scorer(test_rgb8, CPU)
    np.testing.assert_allclose([scorer(None, d) for d in dists], singles,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        batch, np.asarray(R.compute_ssimulacra2_batch(test_rgb8, dists)),
        rtol=0, atol=0.01)


def test_monotone_under_noise(test_rgb8):
    scores = [P.compute_ssimulacra2(test_rgb8, _noisy(test_rgb8, s), CPU)
              for s in (1, 4, 10, 25)]
    assert all(a > b for a, b in zip(scores, scores[1:])), scores
    assert scores[-1] < 60.0


@pytest.mark.parametrize("case", ["small", "mismatch", "batch_mismatch",
                                  "not_rgb"])
def test_bad_shapes_rejected(case, test_rgb8):
    tiny = np.zeros((4, 7, 3), np.uint8)
    with pytest.raises(ValueError):
        if case == "small":
            P.compute_ssimulacra2(tiny, tiny, CPU)
        elif case == "mismatch":
            P.compute_ssimulacra2(test_rgb8, test_rgb8[:-8], CPU)
        elif case == "batch_mismatch":
            P.compute_ssimulacra2_batch(test_rgb8, test_rgb8[None, :-8], CPU)
        else:
            P.make_ref_scorer(test_rgb8[..., :2], CPU)


def test_fir_r5_within_half_point(test_rgb8, monkeypatch):
    dist = _noisy(test_rgb8, 5)
    base = P.compute_ssimulacra2(test_rgb8, dist, CPU)
    monkeypatch.setenv("OAVIF_METRIC_BLUR", "fir_r5")
    assert P.blur_radius() == 5
    r5 = P.compute_ssimulacra2(test_rgb8, dist, CPU)
    assert r5 != base and abs(r5 - base) < 0.5, (base, r5)


@pytest.mark.parametrize("value,error", [("gauss", ValueError)])
def test_blur_selection_refuses(value, error, test_rgb8, monkeypatch):
    monkeypatch.setenv("OAVIF_METRIC_BLUR", value)
    with pytest.raises(error):
        P.compute_ssimulacra2(test_rgb8, test_rgb8, CPU)


def test_yvv_coefficients_equal():
    got, want = P._yvv_coeffs(), R._yvv_coeffs()
    assert [type(c) for c in got] == [np.float32] * 4
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 37, 53), (3, 96, 128)])
def test_blur_iir_matches_reference(shape):
    x = np.random.default_rng(shape[1]).random(shape).astype(np.float32)
    got = P.blur_iir(_t(x)).numpy()
    want = np.asarray(R.blur_iir(x))
    err = float(np.abs(got - want).max())
    print(f"blur_iir {shape}: max |port - JAX| {err:.3g}")
    assert got.dtype == np.float32 and err <= 1e-5


def test_iir_selection(test_rgb8, monkeypatch):
    monkeypatch.setenv("OAVIF_METRIC_BLUR", "iir")
    assert P.blur_radius() is None
    x = _t(np.random.default_rng(5).random((3, 20, 30)).astype(np.float32))
    assert torch.equal(P.blur(x), P.blur_iir(x))
    # the CPU wrapper takes the plain version and counts nothing
    launches = P.ssim2_blur_iir.launches
    img1, img2 = x[None], x[None] * 0.5
    for got, want in ((P.ssim2_blur_iir(img1),
                       (P.blur_iir(img1), P.blur_iir(img1 * img1))),
                      (P.ssim2_blur_iir(img1, img2),
                       (P.blur_iir(img2), P.blur_iir(img2 * img2),
                        P.blur_iir(img1 * img2)))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert P.ssim2_blur_iir.launches == launches
    assert P.compute_ssimulacra2(test_rgb8, test_rgb8, CPU) == 100.0


@pytest.mark.parametrize("sigma", [3, 12])
def test_iir_scores_match_reference(sigma, test_rgb8, monkeypatch):
    """Under OAVIF_METRIC_BLUR=iir both metrics take the recursive blur.
    The reference reads the setting when it traces, so its compiled
    functions are dropped before and after."""
    dist = _noisy(test_rgb8, sigma, seed=sigma)
    fir = P.compute_ssimulacra2(test_rgb8, dist, CPU)
    monkeypatch.setenv("OAVIF_METRIC_BLUR", "iir")
    got = P.compute_ssimulacra2(test_rgb8, dist, CPU)
    jax.clear_caches()
    try:
        want = R.compute_ssimulacra2(test_rgb8, dist)
    finally:
        jax.clear_caches()
    assert got != fir
    assert abs(got - want) < 0.01, (got, want)


@pytest.mark.parametrize("sigma", [2, 8, 30])
def test_matches_c_scorer(sigma, test_rgb8):
    dist = _noisy(test_rgb8, sigma, seed=sigma)
    c = native.compute_ssimulacra2_native(test_rgb8, dist)
    port = P.compute_ssimulacra2(test_rgb8, dist, CPU)
    assert abs(c - port) < 0.05, (sigma, c, port)


@pytest.mark.parametrize("mode", ["jax", "c", "auto"])
def test_metric_selection(mode, test_rgb8, monkeypatch):
    monkeypatch.setenv("OAVIF_METRIC", mode)
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")
    assert native.metric_impl() == ("jax" if mode == "jax" else "c")
    dists = np.stack([_noisy(test_rgb8, 4), _noisy(test_rgb8, 12)])
    got = native.score_batch_auto(test_rgb8, dists)
    if mode == "jax":
        want = P.compute_ssimulacra2_batch(test_rgb8, dists, CPU)
    else:
        want = [native.compute_ssimulacra2_native(test_rgb8, d)
                for d in dists]
    np.testing.assert_array_equal(got, want)


def test_unknown_metric_rejected(monkeypatch):
    monkeypatch.setenv("OAVIF_METRIC", "fast")
    with pytest.raises(ValueError):
        native.metric_impl()


def test_cpu_wrappers_take_the_plain_versions(test_rgb8):
    counts = [f.launches for f in P.KERNELS]
    rgb = _t(np.stack([test_rgb8, _noisy(test_rgb8, 3)]))
    lin, xyb = P.ssim2_pyramid(rgb)
    want = P.ssim2_pyramid_plain(rgb)
    assert torch.equal(lin, want[0]) and torch.equal(xyb, want[1])
    lin2, xyb2 = P.ssim2_pyramid(lin)
    assert lin2.shape == (2, 3, 48, 64)
    assert torch.equal(xyb2, P.ssim2_pyramid_plain(lin)[1])
    ref = xyb[:1]
    mu1, s11 = P.ssim2_blur(ref, None, 8)
    dist = P.ssim2_blur(ref, xyb, 8)
    for a, b in zip(dist, P.ssim2_blur_plain(ref, xyb, 8)):
        assert torch.equal(a, b)
    sums = P.ssim2_norms(ref, mu1, s11, xyb, *dist)
    assert sums.shape == (2, 3, 6) and sums.dtype == torch.float64
    assert torch.equal(sums, P.ssim2_norms_plain(ref, mu1, s11, xyb, *dist))
    # the identical candidate: every map is exactly zero
    assert torch.count_nonzero(sums[0]) == 0 and torch.all(sums[1] > 0)
    assert [f.launches for f in P.KERNELS] == counts
