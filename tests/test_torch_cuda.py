"""The planner kernel on an NVIDIA GPU: build, launch, and equality with
its plain PyTorch version. Skipped without CUDA.

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

from oavif_tpu_torch.av1 import encode_tpu as ET  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
    dev = _planes(cuda, 10, seed=duel_level)
    for q in (40, 120):
        got = ET.plan_device(*dev, q, 10, 13, duel_level)
        want = ET.plan_device(*dev, q, 10, 13, duel_level,
                              ssd=ET.mode_ssd_plain)
        assert torch.equal(got, want)


def test_planner_planes_live_on_the_card(cuda):
    rng = np.random.default_rng(1)
    planes = [rng.integers(0, 1024, (256, 256)) for _ in range(3)]
    fp = ET.FramePlanner(planes, 10, device=cuda)
    assert all(t.device.type == "cuda" and t.dtype == torch.int16
               for t in fp.dev)
    launches = ET.mode_ssd.launches
    assert fp.plan(60) is fp.plan(70)
    assert ET.mode_ssd.launches == launches + 5


def test_kernel_rejects_bad_input(cuda):
    y = _planes(cuda, 8)[0]
    with pytest.raises(ValueError):
        ET.mode_ssd(y.to(torch.int32), 5, 7, 64, 128, 7)
    with pytest.raises(ValueError):
        ET.mode_ssd(y, 5, 7, 8, 128, 7)
    with pytest.raises(ValueError):
        ET.mode_ssd(y, 50, 7, 64, 128, 7)
