"""The candidates' side of a scale in one step, ``ssim2_blur_norms`` (the
distorted side's blur and norms, fused into one kernel on the card),
against the JAX reference (oavif_tpu.metric.ssimulacra2) on the CPU,
where the wrapper takes its plain version: the JAX ``blur``,
``_ssim_map_norms`` and ``_edge_diff_norms`` on the same XYB planes, and
``scale_features`` and the score through ``KERNELS`` against ``PLAIN`` and
the JAX ``ssimulacra2_from_precomputed``.

Tolerances, with their reasons (those of tests/test_torch_metric.py):
- the six features of a scale: rtol 1e-3, and atol 1e-5 for the SSIM error
  features but 1e-6 for the edge features (artifact, detail lost). The
  blurs sum their float32 taps in another order than XLA's convolution,
  which moves the SSIM map's local variances near zero most;
- KERNELS against PLAIN on the CPU: equal (the wrappers take the plain
  versions);
- scores: within 0.01 of the JAX score; identity exactly 100.0.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import oavif_tpu.metric.ssimulacra2 as R
import oavif_tpu_torch.metric.ssimulacra2 as P
from oavif_tpu_torch.kernels import build

CPU = torch.device("cpu")
SSIM, EDGE = [0, 3], [1, 2, 4, 5]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _images(h: int, w: int, n: int, seed: int):
    """A reference (h, w, 3) uint8 and n candidates: the reference itself,
    then the reference under Gaussian noise of growing sigma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ref = np.clip(np.stack([128 + 90 * np.sin(xx / 5.0) * np.cos(yy / 4.0),
                            120 + 60 * np.cos(xx / 7.0),
                            100 + 80 * np.sin((xx + yy) / 6.0)], -1)
                  + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)
    dist = [ref] + [np.clip(ref + rng.normal(0, s, ref.shape), 0, 255)
                    .astype(np.uint8) for s in (3, 12)[:n - 1]]
    return ref, np.stack(dist)


def _xyb(rgb8: np.ndarray) -> np.ndarray:
    """Scale 0's XYB planes (3, h, w) by the reference's own functions."""
    return np.asarray(R.linear_rgb_to_xyb_positive(R.rgb8_to_linear(rgb8)))


def _jax_features(img1, mu1, s11, img2) -> np.ndarray:
    """(3, 6) features of one candidate's XYB planes img2 by the JAX
    functions, in the port's order [d, artifact, detail, d^4, ...]."""
    mu2, s22, s12 = R.blur(img2), R.blur(img2 * img2), R.blur(img1 * img2)
    ssim1, ssim4 = R._ssim_map_norms(mu1, mu2, s11, s22, s12)
    a1, a4, l1, l4 = R._edge_diff_norms(img1, mu1, img2, mu2)
    return np.stack([ssim1, a1, l1, ssim4, a4, l4], -1)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("h,w", [(8, 8), (37, 53), (64, 96)])
def test_blur_norms_plain_matches_reference(h, w, n):
    ref, dist = _images(h, w, n, seed=h * 100 + w)
    img1 = _xyb(ref)
    img2 = np.stack([_xyb(d) for d in dist])
    # each side blurs the same planes with its own Gaussian
    mu1, s11 = P.ssim2_blur_plain(_t(img1)[None], None, 8)
    sums = P.ssim2_blur_norms_plain(_t(img1)[None], mu1, s11, _t(img2), 8)
    assert sums.shape == (n, 3, 6) and sums.dtype == torch.float64
    got = P.features_from_sums(sums, h * w).numpy()
    jmu1, js11 = R.blur(img1), R.blur(img1 * img1)
    want = np.stack([_jax_features(img1, jmu1, js11, x) for x in img2])
    np.testing.assert_allclose(got[..., SSIM], want[..., SSIM], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got[..., EDGE], want[..., EDGE], rtol=1e-3,
                               atol=1e-6)
    # candidate 0 is the reference: every map is exactly 0
    assert torch.count_nonzero(sums[0]) == 0
    if n > 1:
        assert torch.all(sums[1:, :, [1, 2]] > 0)


@pytest.mark.parametrize("radius", [0, 5, 8])
def test_blur_norms_wrapper_takes_the_plain_version_on_the_cpu(radius):
    """On CPU tensors the wrapper is ssim2_norms over ssim2_blur's maps,
    bit for bit, with a batched reference too, and launches nothing."""
    _, dist = _images(24, 40, 3, seed=radius)
    img2 = P.ssim2_pyramid(_t(dist))[1]
    launches = P.ssim2_blur_norms.launches
    for img1 in (img2[:1], img2.flip(0).contiguous()):
        mu1, s11 = P.ssim2_blur(img1, None, radius)
        got = P.ssim2_blur_norms(img1, mu1, s11, img2, radius)
        want = P.ssim2_norms(img1, mu1, s11, img2,
                             *P.ssim2_blur(img1, img2, radius))
        assert torch.equal(got, want)
        assert torch.equal(got, P.ssim2_blur_norms_plain(img1, mu1, s11,
                                                         img2, radius))
    assert P.ssim2_blur_norms.launches == launches


@pytest.mark.parametrize("h,w", [(37, 53), (96, 128)])
def test_scale_features_and_score_match_plain_and_reference(h, w):
    ref, dist = _images(h, w, 3, seed=h + w)
    counts = [f.launches for f in P.KERNELS]
    pyr_k = P.ssimulacra2_precompute_ref(ref, CPU)
    pyr_p = P.ssimulacra2_precompute_ref(ref, CPU, P.PLAIN)
    feats = P.scale_features(pyr_k, _t(dist))
    assert feats.shape == (3, P._num_scales(h, w), 3, 6)
    assert torch.equal(feats, P.scale_features(pyr_p, _t(dist), P.PLAIN))
    got = P.ssimulacra2_from_precomputed(pyr_k, dist)
    assert torch.equal(got, P.ssimulacra2_from_precomputed(pyr_p, dist,
                                                           P.PLAIN))
    assert [f.launches for f in P.KERNELS] == counts
    assert float(got[0]) == 100.0
    jax_pyr = R.ssimulacra2_precompute_ref(ref)
    want = [float(R.ssimulacra2_from_precomputed(jax_pyr, d)) for d in dist]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.01)
    assert float(P.ssimulacra2_from_precomputed(pyr_k, ref)) == 100.0


class _Recording:
    """PLAIN's steps, each call recorded by its field name."""

    def __init__(self):
        self.calls = []

    def ops(self) -> P.MetricOps:
        def recorded(name, fn):
            def call(*args):
                self.calls.append(name)
                return fn(*args)
            return call
        return P.MetricOps(*(recorded(name, fn) for name, fn in
                             zip(P.MetricOps._fields, P.PLAIN)))


@pytest.mark.parametrize("blur", ["", "fir_r5", "iir"])
def test_scale_features_route_by_blur(blur, monkeypatch):
    """Under the Gaussian each scale's candidates take blur_norms alone;
    under OAVIF_METRIC_BLUR=iir they take blur_iir, then norms."""
    monkeypatch.setenv("OAVIF_METRIC_BLUR", blur)
    ref, dist = _images(20, 24, 2, seed=5)
    pyr = P.ssimulacra2_precompute_ref(ref, CPU, P.PLAIN)
    rec = _Recording()
    feats = P.scale_features(pyr, _t(dist), rec.ops())
    scales = P._num_scales(20, 24)
    assert feats.shape == (2, scales, 3, 6)
    if blur == "iir":
        want = ["pyramid", "blur_iir", "norms"] * scales
    else:
        want = ["pyramid", "blur_norms"] * scales
    assert rec.calls == want
    assert torch.equal(feats, P.scale_features(pyr, _t(dist), P.PLAIN))
    assert torch.count_nonzero(feats[0]) == 0


def test_block_shape_matches_the_kernel_source():
    """The wrapper sizes the fused kernel's partial sums by the blur's
    strip and segment (one partial per block), which the source fixes."""
    src = (build.CSRC / "ssimulacra2.cu").read_text()
    strip = re.search(r"constexpr int kStripW = (\d+)", src)
    seg = re.search(r"constexpr int kSegRows = (\d+);", src)
    assert strip and seg
    assert (int(strip.group(1)), int(seg.group(1))) == (P._STRIP_W,
                                                        P._SEG_ROWS)
    assert "ssim2_blur_norms" in build.entries
