"""The port's multi-device leg on the CPU: its collectives
(oavif_tpu_torch.parallel), the width-sharded metric
(oavif_tpu_torch.metric.sharded) and the width-sharded Wiener filter
(oavif_tpu_torch.av1.restoration_sharded), against hand-sliced
neighbours, the port's single-device functions and the JAX package's
sharded functions on the same number of virtual devices.

The port's ranks are processes that ``parallel.spawn`` starts (gloo on the
CPU, a ``file://`` rendezvous in a fresh temporary directory, a deadline
of 120 s per spawn); one spawn per world size runs every rank body
(``parallel.in_turn``). The JAX side runs in this process on the virtual
devices of tests/conftest.py.

Tolerances, with their reasons:
- halos, gathers, broadcasts and the Wiener filter: exact (moves of data;
  int32 arithmetic);
- the halo blur's plain version against the full-frame blur's columns:
  exact (the same conv2d taps over the same values);
- sharded metric against the port's single-device score: 1e-3 (the norm
  sums add per-rank float64 partials in another order);
- against the JAX sharded metric: 0.02 (the two single-device metrics
  already differ by up to 0.013 on flat content, tests/test_torch_metric.py).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from oavif_tpu.av1.restoration_sharded import (
    apply_wiener_sharded as jax_wiener_sharded)
from oavif_tpu.metric.sharded import (
    compute_ssimulacra2_sharded as jax_sharded_score)
from oavif_tpu_torch import kernels, parallel, shard_checks
from oavif_tpu_torch.av1 import restoration_sharded as WS
from oavif_tpu_torch.av1.restoration import (apply_wiener, count_units,
                                             unit_size)
from oavif_tpu_torch.metric import sharded as MS
from oavif_tpu_torch.metric import ssimulacra2 as P

CPU = torch.device("cpu")
WORLDS = (2, 4)
TIMEOUT_S = 120
TAPS = {0: (3, -7, 15, -2, 4, 28), 1: (0, -9, 25, 0, 4, 18), 2: None}


def _metric_images():
    """tests/test_multidevice.py's 256x512 frame and its distortion."""
    rng = np.random.default_rng(11)
    img = np.clip(
        np.kron(rng.integers(30, 225, (16, 64, 3)), np.ones((16, 8, 1)))
        + rng.normal(0, 6, (256, 512, 3)), 0, 255).astype(np.uint8)
    dist = np.clip(img.astype(np.int16) + rng.integers(-9, 10, img.shape),
                   0, 255).astype(np.uint8)
    return img, dist


def _wiener_planes(bitdepth: int):
    """tests/test_multidevice.py's 200x512 Wiener fixture, scaled from 8 bits
    to ``bitdepth``."""
    rng = np.random.default_rng(7)
    s = 1 << (bitdepth - 8)
    cdef = [np.asarray(128 * s + rng.integers(-80 * s, 80 * s, (200, 512)),
                       np.int32) for _ in range(3)]
    deblk = [np.asarray(c + rng.integers(-4 * s, 4 * s + 1, c.shape),
                        np.int32) for c in cdef]
    return cdef, deblk


def _collective_input():
    x = np.random.default_rng(3).normal(size=(2, 5, 32)).astype(np.float32)
    x[0, 0, 7] = -0.0  # a signed zero must arrive as sent
    return x


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def ranks(request):
    """One spawn of ``n`` CPU ranks running every rank body of this file."""
    n = request.param
    img, dist = _metric_images()
    calls = [(shard_checks.collectives, (_collective_input(), 3)),
             (shard_checks.metric_rank, (img, dist))]
    for bitdepth in (8, 10):
        cdef, deblk = _wiener_planes(bitdepth)
        calls.append((shard_checks.wiener_rank,
                      (cdef, deblk, 200, 512, TAPS, bitdepth)))
    results, counts = parallel.spawn(parallel.in_turn, n, args=calls,
                                     device="cpu", timeout_s=TIMEOUT_S)
    return n, results, counts


def _rank_part(results, i):
    return [r[i] for r in results]


@pytest.mark.parametrize("border", ["zero", "edge"])
def test_halo_exchange_matches_neighbour_columns(ranks, border):
    n, results, _ = ranks
    x = _collective_input()
    ws, r = x.shape[-1] // n, 3
    mode = "constant" if border == "zero" else "edge"
    padded = np.pad(x, ((0, 0), (0, 0), (r, r)), mode=mode)
    for i, got in enumerate(_rank_part(results, 0)):
        want = padded[..., i * ws : i * ws + ws + 2 * r]
        assert got[border].dtype == np.float32
        np.testing.assert_array_equal(got[border].view(np.int32),
                                      want.view(np.int32))


def test_gather_broadcast_psum_exact(ranks):
    n, results, _ = ranks
    x = _collective_input()
    ws = x.shape[-1] // n
    for got in _rank_part(results, 0):
        np.testing.assert_array_equal(got["gather"].view(np.int32),
                                      x.view(np.int32))
        np.testing.assert_array_equal(got["broadcast"].view(np.int32),
                                      x[..., :ws].view(np.int32))
        want = sum(x[..., i * ws : (i + 1) * ws] for i in range(n))
        np.testing.assert_allclose(got["psum"], want, rtol=1e-6, atol=1e-6)


def test_no_kernel_launches_on_cpu_ranks(ranks):
    _, results, counts = ranks
    assert counts and all(c == {} for c in counts)
    assert all(part["launches"] == {} for r in results for part in r[1:])


def test_counting_adds_the_block_launches_only(monkeypatch):
    monkeypatch.setattr(kernels, "_launched", {})

    def wrapper():
        pass

    wrapper.launches = 0
    kernels.count_launch(wrapper)  # before the block: not counted
    acc = {}
    with kernels.counting(acc):
        kernels.count_launch(wrapper)
        kernels.count_launch(wrapper)
    kernels.count_launch(wrapper)  # after the block: not counted
    with kernels.counting(acc):
        kernels.count_launch(wrapper)
    assert acc == {kernels.kernel_key(wrapper): 3}
    assert wrapper.launches == 5


@pytest.mark.parametrize("halo,radius", [(8, 8), (8, 5), (8, 0)])
@pytest.mark.parametrize("n", WORLDS)
def test_halo_blur_plain_equals_full_frame_columns(n, halo, radius):
    """The halo blur of each slice, its neighbours' columns (zero beyond
    the frame) on each side, equals the full-frame blur's columns."""
    img = torch.from_numpy(np.random.default_rng(n).random(
        (2, 3, 40, 64)).astype(np.float32))
    ref = img[:1]
    full = P.ssim2_blur(ref, None, radius) + P.ssim2_blur(ref, img, radius)
    ws = 64 // n
    pad1 = torch.nn.functional.pad(ref, (halo, halo))
    pad2 = torch.nn.functional.pad(img, (halo, halo))
    for i in range(n):
        cols = slice(i * ws, i * ws + ws + 2 * halo)
        got = (P.ssim2_blur(pad1[..., cols], None, radius, halo)
               + P.ssim2_blur(pad1[..., cols], pad2[..., cols], radius, halo))
        for g, f in zip(got, full):
            assert g.shape == (f.shape[0], 3, 40, ws)
            assert torch.equal(g, f[..., i * ws : (i + 1) * ws])


def test_sharded_metric_matches_single_device(ranks):
    n, results, _ = ranks
    img, dist = _metric_images()
    single = P.compute_ssimulacra2(img, dist, CPU)
    parts = _rank_part(results, 1)
    assert len({p["score"] for p in parts}) == 1
    assert abs(parts[0]["score"] - single) < 1e-3, (parts[0]["score"], single)
    assert all(p["differ"] == 0 for p in parts)  # blur planes bit for bit
    assert all(p["plain_err"] == 0.0 for p in parts)


def test_sharded_metric_matches_jax(ranks):
    n, results, _ = ranks
    img, dist = _metric_images()
    want = jax_sharded_score(img, dist, Mesh(np.array(jax.devices()[:n]),
                                             ("tile",)))
    got = results[0][1]["score"]
    assert abs(got - want) < 0.02, (got, want)


def _host_wiener(cdef, deblk, bitdepth):
    size = unit_size(2)
    ur, uc = count_units(200, size), count_units(512, size)
    grids = {p: [[list(TAPS[p])] * uc for _ in range(ur)]
             for p in TAPS if TAPS[p]}
    types = tuple(2 if TAPS[p] else 0 for p in range(3))
    return apply_wiener(cdef, deblk, 200, 512, types, 2, grids, bitdepth)


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_sharded_wiener_equals_host_filter(ranks, bitdepth):
    n, results, _ = ranks
    cdef, deblk = _wiener_planes(bitdepth)
    parts = _rank_part(results, 2 if bitdepth == 8 else 3)
    assert len({tuple(p["crc"]) for p in parts}) == 1
    assert all(p["plain_equal"] for p in parts)
    for got, want in zip(parts[0]["planes"], _host_wiener(cdef, deblk,
                                                          bitdepth)):
        np.testing.assert_array_equal(got, want)
    # the plane without taps passes through
    np.testing.assert_array_equal(parts[0]["planes"][2], cdef[2])


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_sharded_wiener_equals_jax(ranks, bitdepth):
    n, results, _ = ranks
    cdef, deblk = _wiener_planes(bitdepth)
    want = jax_wiener_sharded(cdef, deblk, 200, 512, TAPS, bitdepth,
                              Mesh(np.array(jax.devices()[:n]), ("tile",)),
                              axis="tile")
    got = results[0][2 if bitdepth == 8 else 3]["planes"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_wiener_wrapper_takes_plain_on_cpu(bitdepth):
    cdef, deblk = _wiener_planes(bitdepth)
    ext = [torch.from_numpy(np.pad(p[0][:, :131], ((0, 0), (3, 0)),
                                   mode="edge")) for p in (cdef, deblk)]
    vf, hf = (3, -7, 15, 106, 15, -7, 3), (-2, 4, 28, 68, 28, 4, -2)
    launches = WS.wiener_bands.launches
    got = WS.wiener_bands(ext[0], ext[1], vf, hf, bitdepth)
    assert WS.wiener_bands.launches == launches
    assert got.shape == (200, 128) and got.dtype == torch.int32
    assert torch.equal(got, WS.wiener_bands_plain(ext[0], ext[1], vf, hf,
                                                  bitdepth))
    host = _host_wiener(cdef, deblk, bitdepth)[0]
    np.testing.assert_array_equal(got.numpy(), host[:, :128])


def test_spawn_raises_when_a_rank_fails():
    img, dist = _metric_images()
    with pytest.raises(RuntimeError, match="do not split into 3"):
        parallel.spawn(MS.score_shard, 3, args=(img, dist), device="cpu",
                       timeout_s=TIMEOUT_S)


def test_spawn_refuses_nccl_without_cards():
    with pytest.raises(ValueError, match="nccl"):
        parallel.spawn(MS.score_shard, 2, backend="nccl", device="cpu",
                       timeout_s=5)
    with pytest.raises(ValueError, match="world"):
        parallel.spawn(MS.score_shard, 0, timeout_s=5)


def test_spawn_defaults_to_cuda(monkeypatch):
    """Like every entry point of the port, spawn computes on CUDA unless
    the CPU is asked for, and raises without it."""
    monkeypatch.delenv("OAVIF_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.spawn(MS.score_shard, 2, timeout_s=5)
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")
    img, dist = _metric_images()
    results, counts = parallel.spawn(MS.score_shard, 2, args=(img, dist),
                                     timeout_s=TIMEOUT_S)
    assert results[0] == results[1] and counts == [{}, {}]
