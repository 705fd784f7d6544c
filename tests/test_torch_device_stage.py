"""The port's device encode stage (oavif_tpu_torch.av1.device_stage and the
Python tile coder that consumes it) against the JAX reference
(oavif_tpu.av1.device_stage), on the CPU, at 256x256 (the reference
test's ``_fractal``, seeds 7/11/13), at 8 and 10 bits.

Tolerances:
- coefficients (the port's plain K3a against JAX's ``_coeffs_jit``):
  |diff| <= 1e-6 * max|c| of the block + 1e-3. The float32 sums run in
  another order (XLA against torch's CPU matmul); the predictions and
  residuals are exact integers on both sides.
- levels: equal, except where the reference's |c| / dq lies within (the
  coefficient bound above) / dq of k + 0.5; there they differ by exactly 1,
  at no more than 4 positions of a block (the reference's own bound
  against float64, tests/test_device_stage.py). eob: equal wherever a
  block's levels are equal.
The port is held to the JAX package, not to float64, except in the float64
host recompute, which keeps the reference test's own bound.

Every test starts from empty planner and decision caches in both
packages.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import write_pam  # noqa: E402
from oavif_tpu import cli as ref_cli  # noqa: E402
from oavif_tpu.av1 import device_stage as RD  # noqa: E402
from oavif_tpu.av1 import encode_tpu as RT  # noqa: E402
from oavif_tpu.av1 import frame as ref_frame  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.av1 import device_stage as PD  # noqa: E402
from oavif_tpu_torch.av1 import encode_tpu as PT  # noqa: E402
from oavif_tpu_torch.av1 import frame as port_frame  # noqa: E402
from oavif_tpu_torch.av1.encode import _depth_convert  # noqa: E402
from oavif_tpu_torch.av1.mux import mux_avif  # noqa: E402
from oavif_tpu_torch.av1.obu import (FrameConfig, SequenceConfig,  # noqa: E402
                                     assemble_av1_stream)
from oavif_tpu_torch.av1.tables import ac_q, dc_q  # noqa: E402
from oavif_tpu_torch.av1.yuv import rgb_to_yuv444  # noqa: E402
from test_device_stage import _fractal  # noqa: E402

SEEDS = (7, 11, 13)
QS = (30, 60, 90)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")
    for var in ("OAVIF_PY_TILE", "OAVIF_DEVICE_LEVELS", "OAVIF_DEC_REUSE",
                "OAVIF_METRIC", "OAVIF_TQ_BATCH"):
        monkeypatch.delenv(var, raising=False)
    port_frame.reset_planners()
    ref_frame._PLANNER_CACHE.clear()
    ref_frame._DEC_CACHE.clear()


def _planes(seed, bitdepth):
    rgb = _fractal(256, 256, seed)
    return [p.astype(np.int32) for p in
            rgb_to_yuv444(_depth_convert(rgb, False, bitdepth),
                          bitdepth=bitdepth)]


def _planners(seed, bitdepth):
    """The reference planner and the port's over its device planes."""
    planes = _planes(seed, bitdepth)
    fp = RT.FramePlanner(planes, bitdepth)
    pp = PT.planner_from_reference([np.asarray(d) for d in fp.dev], bitdepth,
                                   13, 0, "cpu", planes[0].shape)
    return fp, pp


def _plan_modes(plan):
    """Mode indices 0..6 of the plan's base-mode 16-blocks (others 0)."""
    m16 = np.asarray(plan["mode16"])
    idx = np.zeros_like(m16)
    for i, s in enumerate(PT.MODE_IDS[:7]):
        idx[m16 == s] = i
    return idx.astype(np.int32)


def _modes(kind, fp, pp, seed):
    nby, nbx = pp.sby * 4, pp.sbx * 4
    if kind == "random":
        rng = np.random.default_rng(seed)
        return rng.integers(0, 7, (nby, nbx)).astype(np.int32)
    return _plan_modes(fp.plan(40))


def _ref_pad(fp, modes):
    out = np.zeros((fp.psby * 4, fp.psbx * 4), np.int32)
    out[: modes.shape[0], : modes.shape[1]] = modes
    return out


def _ref_crop(fp, x, shape):
    """Rows of the reference's bucket-padded 16-grid cropped to shape."""
    k = x.shape[0]
    x = x.reshape(k, fp.psby * 4, fp.psbx * 4, *x.shape[2:])
    return x[:, : shape[0], : shape[1]].reshape(k, shape[0] * shape[1],
                                                *x.shape[3:])


def _coeff_bound(c):
    """The per-block coefficient tolerance (module docstring)."""
    return 1e-6 * np.abs(c).reshape(c.shape[0], -1).max(1) + 1e-3


def _assert_levels_close(lv, ref_lv, eob, ref_eob, ref_c, dq):
    """Levels (n, 256) and eob (n,) against the reference's, with the
    reference's coefficients (n, 256) and the quantizers dq (256,)."""
    d = np.abs(lv.astype(np.int64) - ref_lv.astype(np.int64))
    assert d.max() <= 1
    assert (d > 0).sum(1).max() <= 4
    if d.any():
        blk, pos = np.nonzero(d)
        frac = np.abs(ref_c[blk, pos]) / dq[pos]
        near = np.abs(frac - np.floor(frac) - 0.5)
        assert (near <= _coeff_bound(ref_c)[blk] / dq[pos]).all()
    same = ~d.any(1)
    assert np.array_equal(eob[same], ref_eob[same])


@pytest.mark.parametrize("kind", ["plan", "random"])
@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("seed", SEEDS)
def test_coeffs16_plain_matches_jax(seed, bitdepth, kind):
    fp, pp = _planners(seed, bitdepth)
    modes = _modes(kind, fp, pp, seed)
    nby, nbx = modes.shape
    want = _ref_crop(fp, np.asarray(RD._coeffs_jit(
        fp.dev[0], fp.psby * 4, fp.psbx * 4, jnp.asarray(_ref_pad(fp, modes)),
        bitdepth))[None], (nby, nbx))[0]
    got = PD.coeffs16(pp.dev[0], nby, nbx, torch.from_numpy(modes),
                      bitdepth).numpy()
    assert got.shape == (nby * nbx, 16, 16) and got.dtype == np.float32
    err = np.abs(got - want).reshape(got.shape[0], -1).max(1)
    assert (err <= _coeff_bound(want)).all()
    assert np.abs(want).max() > 100  # real coefficients, not zeros


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("seed", SEEDS)
def test_levels_match_reference(seed, bitdepth):
    fp, pp = _planners(seed, bitdepth)
    modes = _modes("plan", fp, pp, seed)
    shape = modes.shape
    ref_c = _ref_crop(fp, np.asarray(RD._coeffs_jit(
        fp.dev[0], fp.psby * 4, fp.psbx * 4, jnp.asarray(_ref_pad(fp, modes)),
        bitdepth))[None], shape)[0].reshape(-1, 256)
    ref_lv, ref_eob = RD.DeviceLevels(fp, bitdepth).levels(
        _ref_pad(fp, modes), QS)
    ref_lv, ref_eob = _ref_crop(fp, ref_lv, shape), _ref_crop(fp, ref_eob,
                                                              shape)
    dl = PD.DeviceLevels(pp, bitdepth)
    lv, eob = dl.levels(modes, QS)
    assert lv.shape == (3, shape[0] * shape[1], 256) and lv.dtype == np.int16
    assert eob.shape == (3, shape[0] * shape[1]) and eob.dtype == np.int32
    for k, q in enumerate(QS):
        dq = np.full(256, float(ac_q(q, bitdepth)))
        dq[0] = float(dc_q(q, bitdepth))
        _assert_levels_close(lv[k], ref_lv[k], eob[k], ref_eob[k], ref_c, dq)
        # the q-batch's slice equals the single-q call
        one_lv, one_eob = dl.levels(modes, [q])
        assert np.array_equal(one_lv[0], lv[k])
        assert np.array_equal(one_eob[0], eob[k])
    # coarser quantizers keep (weakly) fewer coefficients
    assert int(eob[2].sum()) <= int(eob[0].sum())
    assert int(eob[0].sum()) > 0


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_levels_match_float64_host_recompute(bitdepth):
    """Interior planned blocks' levels equal a float64 recompute through
    the port's own intra prediction and transform, up to the float32
    rounding at exact .5 boundaries (the reference test's bound)."""
    from oavif_tpu_torch.av1.intra import build_edges, predict
    from oavif_tpu_torch.av1.transform import fwd_matrices

    planes = _planes(7, bitdepth)
    planner = port_frame.get_planner(planes, bitdepth, 13, 0)
    plan = planner.plan(40)
    port_frame._attach_device_levels(planner, plan, 40, bitdepth)
    lv, mask, m16 = plan["lv16"], plan["lv16_mask"], plan["mode16"]
    fh, fw = fwd_matrices(16, 16, "dct_dct")
    dq = np.full(256, float(ac_q(40, bitdepth)))
    dq[0] = float(dc_q(40, bitdepth))
    y = planes[0]
    checked = 0
    for i, j in zip(*np.nonzero(mask)):
        x0, y0 = j * 16, i * 16
        a, l = build_edges(y, x0, y0, 16, 16, True, True, bitdepth)
        pred = predict(int(m16[i, j]) & 0xFF, a, l, 16, 16, True, True,
                       bitdepth=bitdepth)
        resid = (y[y0 : y0 + 16, x0 : x0 + 16] - pred).astype(np.float64)
        cf = (fh @ resid @ fw.T).reshape(-1)
        mag = np.floor(np.abs(cf) / dq + 0.5)
        want = np.where(cf < 0, -mag, mag).astype(np.int64)
        d = np.abs(want - lv[i, j].astype(np.int64))
        assert d.max() <= 1 and (d > 0).sum() <= 4, (i, j)
        checked += 1
    assert checked > 50


def _encode_tile(pkg, planes, qindex, bitdepth):
    if pkg == "port":
        return port_frame._encode_one_tile(
            (planes, qindex, bitdepth, 9, 0, False, False, None, False))
    return ref_frame._encode_one_tile(
        (planes, qindex, bitdepth, 9, True, 0, 0, False, False, None, False))


@pytest.fixture
def _levels_env(monkeypatch):
    monkeypatch.setenv("OAVIF_PY_TILE", "1")
    monkeypatch.setenv("OAVIF_DEVICE_LEVELS", "1")
    monkeypatch.setenv("OAVIF_DEC_REUSE", "0")


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_stream_with_device_levels_decodes_to_recon(bitdepth, _levels_env):
    """A stream that consumed device levels decodes to the encoder's
    reconstruction (the levels are encoder freedom; recon takes the exact
    dequantization and inverse either way)."""
    from oavif_tpu.io.avif_ctypes import decode_to_yuv

    planes = _planes(11, bitdepth)
    h, w = planes[0].shape
    before = port_frame.lv16_consumed
    payload, recon, _ = _encode_tile("port", planes, 40, bitdepth)
    assert port_frame.lv16_consumed > before, "no device levels consumed"
    seq = SequenceConfig(width=w, height=h, bit_depth=bitdepth)
    frame = FrameConfig(width=w, height=h, base_q_idx=40)
    avif = mux_avif(assemble_av1_stream(seq, frame, [payload]), w, h,
                    bit_depth=bitdepth, high_bitdepth=bitdepth == 10,
                    cicp=(2, 2, 2))
    yuv, _, _ = decode_to_yuv(avif)
    for pi, (ours, dec) in enumerate(zip(recon, yuv)):
        np.testing.assert_array_equal(ours[:h, :w], dec, err_msg=str(pi))


@pytest.mark.parametrize("seed,qindex", [(7, 28), (13, 40)])
def test_tile_payload_equals_reference_when_levels_equal(seed, qindex,
                                                         _levels_env):
    planes = _planes(seed, 10)
    before = port_frame.lv16_consumed
    got = _encode_tile("port", planes, qindex, 10)
    want = _encode_tile("ref", planes, qindex, 10)
    assert port_frame.lv16_consumed > before
    pplan = port_frame.planners()[-1].plan(qindex)
    rplan = ref_frame._get_planner(planes, 10, 13, 0, 0).plan(qindex)
    assert np.array_equal(pplan["lv16_mask"], rplan["lv16_mask"])
    d = np.abs(pplan["lv16"].astype(np.int64)
               - rplan["lv16"].astype(np.int64))
    assert d.max() <= 1
    if not d.any():
        assert got[0] == want[0]
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("env", [None, "0", "1", "auto"])
def test_device_levels_enabled_matches_reference(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("OAVIF_DEVICE_LEVELS", raising=False)
    else:
        monkeypatch.setenv("OAVIF_DEVICE_LEVELS", env)
    monkeypatch.setattr(PD, "_CALIB", None)
    monkeypatch.setattr(RD, "_CALIB", None)
    got = PD.device_levels_enabled()
    assert got == RD.device_levels_enabled()
    assert got == (env in ("1", "auto"))  # a CPU "fetch" is fast


def test_encode_stage_rejects_bad_input():
    fp, pp = _planners(7, 8)
    dl = PD.DeviceLevels(pp, 8)
    with pytest.raises(ValueError):
        dl.levels(np.zeros((15, 16), np.int32), [40])
    with pytest.raises(ValueError):
        dl.levels(np.full((16, 16), 7, np.int32), [40])
    with pytest.raises(ValueError):
        PD.coeffs16(pp.dev[0].to("meta"), 16, 16,
                    torch.zeros((16, 16), dtype=torch.int32), 8)


def _cli(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return int(found.group(1)), int(found.group(3)), out.read_bytes()


def test_cli_search_with_device_levels_matches_reference(
        tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OAVIF_PY_TILE", "1")
    monkeypatch.setenv("OAVIF_DEVICE_LEVELS", "1")
    src = tmp_path / "in.pam"
    write_pam(src, _fractal(256, 256, 13))
    rq, rpasses, _ = _cli(ref_cli, ["-t", "80"], src, tmp_path / "ref.avif",
                          capsys)
    before = port_frame.lv16_consumed
    q, passes, data = _cli(port_cli, ["-t", "80"], src,
                           tmp_path / "port.avif", capsys)
    assert (q, passes) == (rq, rpasses)
    assert data[4:12] == b"ftypavif"
    assert port_frame.lv16_consumed > before
