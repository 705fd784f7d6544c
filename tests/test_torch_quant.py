"""The port's K3b, the round-half quantization of the device encode stage
(``oavif_tpu_torch.av1.device_stage.quant16_plain``, the plain version the
CUDA kernels are held to), against the JAX reference's vmapped
``_quant_body`` (``oavif_tpu.av1.device_stage._quant_batch``) on the CPU,
and the levels' fetch.

The edges are ``chip_smoke.quant_cases``, the same ones the card holds
``dstage_quant16`` and ``dstage_quant16_simple`` to: exact halves after
the division, +-16383 and beyond (with products that overflow to inf),
negative zeros, an all-zero block, only the last scan position nonzero,
DC only. Tolerance: none. Both sides round |c| * 2^shift, / dq and + 0.5
once each in float32 (XLA's CPU code does not contract or take a
reciprocal here), so levels and eob must be equal.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import QUANT_WARPS, quant_cases  # noqa: E402
from oavif_tpu.av1 import device_stage as RD  # noqa: E402
from oavif_tpu_torch.av1 import device_stage as PD  # noqa: E402
from oavif_tpu_torch.av1 import encode_tpu as PT  # noqa: E402
from oavif_tpu_torch.av1.tables import ac_q, dc_q  # noqa: E402

CASES = quant_cases()


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


def _both(c, dqd, dqa, shift):
    """(port levels, port eob, reference levels, reference eob) as numpy."""
    lv, eob = PD.quant16_plain(torch.from_numpy(c), torch.from_numpy(dqd),
                               torch.from_numpy(dqa), shift)
    rlv, reob = RD._quant_batch(jnp.asarray(c), jnp.asarray(dqd),
                                jnp.asarray(dqa), shift)
    return lv.numpy(), eob.numpy(), np.asarray(rlv), np.asarray(reob)


@pytest.mark.parametrize("case", sorted(CASES))
def test_quant16_plain_equals_jax_on_edge(case):
    c, dqd, dqa, shift = CASES[case]
    lv, eob, rlv, reob = _both(c, dqd, dqa, shift)
    assert lv.dtype == np.int16 and eob.dtype == np.int32
    assert lv.shape == (dqd.size, c.shape[0], 256)
    np.testing.assert_array_equal(lv, rlv)
    np.testing.assert_array_equal(eob, reob)


def test_edge_cases_reach_their_edges():
    """Each crafted case gives the eob and levels it was made for."""
    def eob_of(case):
        return _both(*CASES[case])[1]

    assert (eob_of("zero") == 0).all() and (eob_of("-0.0") == 0).all()
    assert (eob_of("last scan") == 256).all()
    assert (eob_of("dc only") == 1).all()
    lv = _both(*CASES["clip"])[0]
    assert np.abs(lv).max() == PD.LEVEL_MAX and (lv == -PD.LEVEL_MAX).any()
    c, dqd, dqa, shift = CASES["half"]
    lv = _both(c, dqd, dqa, shift)[0]
    # block 0 at dq 3 holds exact halves, |c| / 3 = j + 0.5: they round up
    j = np.abs(c[0].reshape(256)) / 3.0 - 0.5
    np.testing.assert_array_equal(np.abs(lv[0, 0]), j + 1)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [1, QUANT_WARPS - 1, QUANT_WARPS + 1])
def test_quant16_plain_equals_jax_at_k_and_n(k, n):
    rng = np.random.default_rng(10 * k + n)
    c = rng.normal(0, 300, (n, 16, 16)).astype(np.float32)
    qs = (30, 60, 90, 120, 200)[:k]
    dqd = np.asarray([dc_q(q, 10) for q in qs], np.float32)
    dqa = np.asarray([ac_q(q, 10) for q in qs], np.float32)
    lv, eob, rlv, reob = _both(c, dqd, dqa, 0)
    np.testing.assert_array_equal(lv, rlv)
    np.testing.assert_array_equal(eob, reob)
    assert (lv != 0).any()


def test_quant16_simple_on_the_cpu_is_the_plain_version():
    c, dqd, dqa, shift = CASES["half"]
    args = (torch.from_numpy(c), torch.from_numpy(dqd),
            torch.from_numpy(dqa), shift)
    n0 = PD.quant16_simple.launches
    got = PD.quant16_simple(*args)
    want = PD.quant16_plain(*args)
    assert PD.quant16_simple.launches == n0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        PD.quant16_simple(args[0].to("meta"), *args[1:])


def _device_levels():
    rng = np.random.default_rng(6)
    planes = [rng.integers(0, 1024, (256, 256)) for _ in range(3)]
    fp = PT.FramePlanner(planes, 10, device="cpu")
    modes = rng.integers(0, 7, (16, 16)).astype(np.int32)
    return PD.DeviceLevels(fp, 10), modes


def test_device_levels_survive_the_next_probe():
    """Each probe's arrays own their memory: a later probe at another
    quantizer leaves them as they were."""
    dl, modes = _device_levels()
    lv, eob = dl.levels(modes, [40])
    kept = lv.copy(), eob.copy()
    lv2, eob2 = dl.levels(modes, [200])
    assert not np.array_equal(lv2, kept[0])
    np.testing.assert_array_equal(lv, kept[0])
    np.testing.assert_array_equal(eob, kept[1])
    assert not np.shares_memory(lv, lv2) and not np.shares_memory(eob, eob2)
    assert dl.last_fetch_s >= 0


def test_fetch_gives_the_buffer_bytes():
    buf = torch.arange(300, dtype=torch.int64).to(torch.uint8)
    got = PD.fetch(buf)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, buf.numpy())


def test_calibration_times_the_levels_fetch(monkeypatch):
    """``auto`` times the route the levels take, ``fetch``."""
    sizes = []
    real = PD.fetch

    def counted(buf):
        sizes.append(buf.numel())
        return real(buf)

    monkeypatch.setattr(PD, "fetch", counted)
    monkeypatch.setattr(PD, "_CALIB", None)
    monkeypatch.setenv("OAVIF_DEVICE_LEVELS", "auto")
    assert PD.device_levels_enabled(64)
    assert sizes == [64 * 256 * 2] * 2  # a warm-up and the timed fetch
