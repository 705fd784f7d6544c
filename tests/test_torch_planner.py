"""The port's frame planner (oavif_tpu_torch.av1.encode_tpu) against the
JAX reference planner (oavif_tpu.av1.encode_tpu), on the CPU.

Tolerance: exact, with one stated exception. The port scores modes by the
EXACT integer SSD, converted once to float32; the reference sums err^2 in
float32, in an order XLA picks, and is off from the exact sum by a few
units in the last place (ulp) on large sums. Where two candidates tie or
nearly tie, the two planners can pick differently. ``plan_mismatches``
finds every plan entry where they differ and requires each to be such a
near-tie: the two competing values within ``MAX_ULPS`` ulp of each other
in the reference's float32, or in the port's (exactly rounded) float32.
The second covers exact integer ties, which the reference's rounding noise
breaks either way (e.g. V or H against PAETH on frame-edge blocks, where
their predictions are identical). The tests assert that and print the
count; tests/test_torch_encode.py uses the same helpers.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oavif_tpu.av1 import encode_tpu as RT
from oavif_tpu.av1.tables import ac_q
from oavif_tpu_torch.av1 import encode_tpu as PT
from oavif_tpu_torch.av1.tables import ac_q as port_ac_q
from oavif_tpu_torch.device import resolve_device

MAX_ULPS = 4
_ssd = jax.jit(RT._mode_ssd, static_argnums=(1, 2, 3, 4, 5))
_FIELDS = ("plan64", "mode32", "split32", "mode16")


def ulps(a, b) -> int:
    """Distance in float32 units in the last place (non-negative a, b)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(abs(ia - ib))


def sections(packed, sby, sbx, psby=None, psbx=None) -> dict:
    """A packed plan vector of a (psby, psbx) SB grid as its four fields,
    cropped to (sby, sbx) SBs. Modes stay raw indices into MODE_IDS."""
    psby, psbx = psby or sby, psbx or sbx
    packed = np.asarray(packed)
    n64, n32 = psby * psbx, 4 * psby * psbx
    grids = (packed[:n64].reshape(psby, psbx)[:sby, :sbx],
             packed[n64 : n64 + n32].reshape(2 * psby, 2 * psbx),
             packed[n64 + n32 : n64 + 2 * n32].reshape(2 * psby, 2 * psbx),
             packed[n64 + 2 * n32 :].reshape(4 * psby, 4 * psbx))
    out = dict(zip(_FIELDS, grids))
    for k, m in (("mode32", 2), ("split32", 2), ("mode16", 4)):
        out[k] = out[k][: m * sby, : m * sbx]
    return out


def reference_packed(fp, qindex: int) -> dict:
    """The reference's jitted _plan_device on its own (bucketed) device
    planes, cropped to the frame."""
    pnby, pnbx = 2 * fp.psby, 2 * fp.psbx
    packed = RT._plan_device(
        fp.dev[0], fp.dev[1], fp.dev[2],
        jnp.float32(ac_q(qindex, fp.bitdepth)), jnp.float32(qindex),
        pnby, pnbx, fp.bitdepth, fp.nmodes, fp.duel_level)
    return sections(packed, fp.sby, fp.sbx, fp.psby, fp.psbx)


def reference_floats(fp) -> dict:
    """The reference planner's float32 SSD rows per grid, cropped from its
    bucket padding to the frame's blocks."""
    y, u, v = (jnp.asarray(d).astype(jnp.float32) for d in fp.dev)
    base = float(1 << (fp.bitdepth - 1))
    ps, pb = fp.psby, fp.psbx

    def rows(p, k, P, nm):
        s = np.asarray(_ssd(p, k * ps, k * pb, P, base, nm)[0])
        return s.reshape(k * ps, k * pb, -1)[: k * fp.sby, : k * fp.sbx]

    return {"J64": rows(y, 1, 64, RT.N_MODES),
            "J32": rows(y, 2, 32, RT.N_MODES),
            "J16": rows(y, 4, 16, fp.nmodes),
            "dcU": rows(u, 1, 64, 1)[..., 0],
            "dcV": rows(v, 1, 64, 1)[..., 0]}


def port_floats(pp) -> dict:
    """The same rows from the port: exact SSD, rounded once to float32,
    with the directional premium."""
    base = 1 << (pp.bitdepth - 1)

    def rows(p, k, P, nm):
        s = PT.mode_ssd_plain(p, k * pp.sby, k * pp.sbx, P, base, nm)
        s = s.numpy().astype(np.float32)
        s[:, RT.N_MODES:] *= np.float32(1.4)
        return s.reshape(k * pp.sby, k * pp.sbx, -1)

    y, u, v = pp.dev
    return {"J64": rows(y, 1, 64, RT.N_MODES),
            "J32": rows(y, 2, 32, RT.N_MODES),
            "J16": rows(y, 4, 16, pp.nmodes),
            "dcU": rows(u, 1, 64, 1)[..., 0],
            "dcV": rows(v, 1, 64, 1)[..., 0]}


def _sum2x2(x):
    h, w = x.shape
    q = x.reshape(h // 2, 2, w // 2, 2)
    return (q[:, 0, :, 0] + q[:, 0, :, 1]) + (q[:, 1, :, 0] + q[:, 1, :, 1])


def _mode_pairs(J, a: int, b: int) -> List[Tuple[float, float]]:
    """Competing reference values behind two packed mode entries (low
    byte: mode index; high byte: runner-up or nominee index + 1)."""
    pairs = []
    if a & 0xFF != b & 0xFF:
        pairs.append((J[a & 0xFF], J[b & 0xFF]))
    ha, hb = a >> 8, b >> 8
    if ha != hb:
        if ha and hb:
            pairs.append((J[ha - 1], J[hb - 1]))
        else:  # directional nominee against the non-directional winner
            pairs.append((J[max(ha, hb) - 1], J[a & 0xFF]))
    return pairs


def _competing(R: dict, key: str, rc, a: int, b: int, qindex: int,
               bitdepth: int) -> List[Tuple[float, float]]:
    """The pairs of values (from R) whose comparison decides plan entry
    ``key`` at ``rc`` between the values a and b."""
    f32 = np.float32
    dq = f32(ac_q(qindex, bitdepth))
    if key == "mode16":
        return _mode_pairs(R["J16"][rc], a, b)
    if key == "mode32":
        return _mode_pairs(R["J32"][rc], a, b)
    if key == "split32":
        i, j = rc
        k16 = _sum2x2(R["J16"][2 * i : 2 * i + 2, 2 * j : 2 * j + 2, :5]
                      .min(-1))[0, 0]
        return [(k16 + dq * dq, R["J32"][rc][:5].min())]
    if a and b:
        return [(R["J64"][rc][a - 1], R["J64"][rc][b - 1])]
    # 64-NONE gate: one of its comparisons flipped
    i, j = rc
    best64 = R["J64"][rc][:5].min()
    k32 = _sum2x2(R["J32"][2 * i : 2 * i + 2, 2 * j : 2 * j + 2, :5]
                  .min(-1))[0, 0]
    gate = f32(4096) * dq * dq / f32(64)
    gates = [(best64, k32 + f32(4) * dq * dq), (best64, gate),
             (R["dcU"][rc], gate), (R["dcV"][rc], gate)]
    return [min(gates, key=lambda p: ulps(*p))]


def plan_mismatches(ref: dict, got: dict, floats, qindex: int,
                    bitdepth: int):
    """(entries where two sectioned plans differ, those among them that
    are near-ties in none of the float32 row sets ``floats``)."""
    n_diff, bad = 0, []
    for key in _FIELDS:
        for rc in map(tuple, np.argwhere(ref[key] != got[key])):
            n_diff += 1
            a, b = int(ref[key][rc]), int(got[key][rc])
            cands = [_competing(R, key, rc, a, b, qindex, bitdepth)
                     for R in floats]
            if not any(p and all(ulps(x, y) <= MAX_ULPS for x, y in p)
                       for p in cands):
                bad.append((key, rc, a, b, cands))
    return n_diff, bad


def assert_plans_match(fp, pp, qindexes) -> int:
    """The port planner's packed plans against the reference planner's at
    each qindex, exact up to reference near-ties; returns how many plan
    entries differ."""
    R = None
    total = 0
    for q in qindexes:
        ref = reference_packed(fp, q)
        got = sections(PT.plan_device(*pp.dev, q, pp.bitdepth, pp.nmodes,
                                      pp.duel_level), pp.sby, pp.sbx)
        if all(np.array_equal(ref[k], got[k]) for k in _FIELDS):
            continue
        R = R if R is not None else (reference_floats(fp), port_floats(pp))
        n_diff, bad = plan_mismatches(ref, got, R, q, fp.bitdepth)
        assert not bad, f"q{q}: plan entries differ beyond a near-tie: {bad}"
        total += n_diff
    print(f"{total} plan entries differ, all float32 near-ties within "
          f"{MAX_ULPS} ulp")
    return total


# --- tests -----------------------------------------------------------------


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


def _random_planes(h, w, bitdepth, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << bitdepth, (h, w)).astype(np.int32)
            for _ in range(3)]


def _bench_planes(name, bitdepth):
    import bench
    from oavif_tpu.av1.encode import _depth_convert
    from oavif_tpu.av1.yuv import rgb_to_yuv444

    rgb = getattr(bench, f"_img_{name}")(512, 512)
    return rgb_to_yuv444(_depth_convert(rgb, False, bitdepth),
                         bitdepth=bitdepth)


def _planners(planes, bitdepth, nmodes=13, duel_level=0):
    fp = RT.FramePlanner(planes, bitdepth, nmodes=nmodes,
                         duel_level=duel_level)
    pp = PT.planner_from_reference([np.asarray(d) for d in fp.dev],
                                   bitdepth, nmodes, duel_level, "cpu",
                                   planes[0].shape)
    return fp, pp


@pytest.mark.parametrize("h,w,bitdepth", [(256, 256, 8), (320, 448, 10)])
def test_padded_planes_equal_reference(h, w, bitdepth):
    planes = _random_planes(h, w, bitdepth, 3)
    fp = RT.FramePlanner(planes, bitdepth)
    pp = PT.planner_from_reference([np.asarray(d) for d in fp.dev],
                                   bitdepth, 13, 0, "cpu", (h, w))
    direct = PT.FramePlanner(planes, bitdepth, device="cpu")
    for i in range(3):
        H, W = pp.dev[i].shape
        assert (H, W) == (h // 64 * 64 + 1, w // 64 * 64 + 1)
        ref = np.asarray(fp.dev[i])[:H, :W]
        np.testing.assert_array_equal(pp.dev[i].numpy(), ref)
        np.testing.assert_array_equal(direct.dev[i].numpy(), ref)
        assert pp.dev[i].dtype == torch.int16
        assert pp.dev[i].device.type == "cpu"


@pytest.mark.parametrize("n_px", [16, 32, 64])
def test_dir_taps_realize_reference_weight_matrix(n_px):
    idx, w = PT.dir_taps(n_px)
    W = np.zeros((2 * (2 * n_px + 1), 6 * n_px * n_px), np.float32)
    cols = np.arange(6 * n_px * n_px)
    for k in range(2):
        np.add.at(W, (idx[..., k].reshape(-1), cols),
                  w[..., k].reshape(-1).astype(np.float32))
    np.testing.assert_array_equal(W, RT._dir_weight_matrix(n_px))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _reference_predictions(p, nb, n_px, base):
    blocks, above, left, corner = RT._grid_edges(p, nb[0], nb[1], n_px,
                                                 base)
    return blocks, RT._predict_modes(above, left, corner, n_px, 13)


@pytest.mark.parametrize("n_px", [16, 32, 64])
@pytest.mark.parametrize("bitdepth", [8, 10])
def test_mode_ssd_plain_is_exact(bitdepth, n_px):
    """mode_ssd_plain equals the exact int64 SSD of the reference's
    (integer-valued) predictions, summed in numpy, for every mode set."""
    planes = _random_planes(256, 320, bitdepth, 5)
    base = 1 << (bitdepth - 1)
    p = PT.pad_plane(planes[0], 4, 5, bitdepth)
    nby, nbx = 256 // n_px, 320 // n_px
    blocks, preds = _reference_predictions(
        jnp.asarray(p, jnp.float32), (nby, nbx), n_px, float(base))
    err = (np.asarray(preds).astype(np.int64)
           - np.asarray(blocks).astype(np.int64)[:, None])
    exact = (err * err).sum((2, 3))
    for nmodes in (1, 5, 7, 13):
        got = PT.mode_ssd_plain(torch.from_numpy(p), nby, nbx, n_px, base,
                                nmodes)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), exact[:, :nmodes])
        np.testing.assert_array_equal(
            PT.mode_ssd(torch.from_numpy(p), nby, nbx, n_px, base, nmodes)
            .numpy(), exact[:, :nmodes])


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("duel_level", [0, 1, 2])
@pytest.mark.parametrize("nmodes", [5, 13])
def test_packed_plan_matches_reference_random(nmodes, duel_level, bitdepth):
    planes = _random_planes(256, 256, bitdepth, 7 + nmodes + duel_level)
    fp, pp = _planners(planes, bitdepth, nmodes, duel_level)
    assert_plans_match(fp, pp, (40, 88, 120))


@pytest.mark.parametrize("name", ["sinusoid", "edges", "text"])
def test_packed_plan_matches_reference_bench(name):
    """The default CLI configuration (10-bit, 13 modes, no duels) on the
    512x512 bench classes."""
    fp, pp = _planners(_bench_planes(name, 10), 10)
    assert_plans_match(fp, pp, (40, 88, 120))


@pytest.mark.parametrize("duel_level", [0, 1])
def test_unpacked_plan_matches_reference(duel_level):
    """FramePlanner.plan (unpacked to spec mode ids, windowed cache) on the
    reference's state. duel_level 2 is left out: the reference's
    unpack_plan cannot unpack its 32-grid runner-up (see frame.py)."""
    fp, pp = _planners(_random_planes(320, 448, 10, 9), 10, 13, duel_level)
    for q in (40, 120):
        ref, got = fp.plan(q), pp.plan(q)
        if not all(np.array_equal(ref[k], got[k]) for k in ref):
            assert_plans_match(fp, pp, (q,))  # differences are near-ties
        assert all(got[k].dtype == np.int32 for k in got)
        assert isinstance(got, PT.Plan)


def test_plan_window_returns_same_instance():
    """Probes within 16 qindex of a cached plan, on the same side of the
    qindex-90 gate, get the same Plan INSTANCE (decision replay keys on
    id(plan)); exact=True replans per qindex."""
    pp = PT.FramePlanner(_random_planes(256, 256, 8, 11), 8, device="cpu")
    first = pp.plan(60)
    assert pp.plan(60) is first
    assert pp.plan(76) is first and pp.plan(44) is first
    second = pp.plan(77)
    assert second is not first and pp.plan(90) is second
    above = pp.plan(91)  # across the qindex-90 partition gate
    assert above is not second and pp.plan(100) is above
    exact = pp.plan(62, exact=True)
    assert exact is not first and pp.plan(62, exact=True) is exact


def test_planner_without_full_superblock_plans_nothing():
    pp = PT.FramePlanner(_random_planes(48, 300, 8, 1), 8, device="cpu")
    assert pp.dev is None and pp.plan(60) is None


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.delenv("OAVIF_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")
    assert resolve_device() == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_mode_ssd_rejects_other_devices():
    p = torch.zeros((65, 65), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        PT.mode_ssd(p, 1, 1, 64, 128, 7)


# --- the fused planner's host side (the kernel itself runs on the card:
# tests/test_torch_cuda.py) --------------------------------------------------


@pytest.mark.parametrize("nmodes,duel_level", [(5, 0), (7, 2), (13, 0),
                                               (13, 1)])
def test_plan_device_on_cpu_is_the_plain_version(nmodes, duel_level):
    """On a CPU tensor plan_device is plan_device_plain and launches no
    kernel."""
    dev = [torch.from_numpy(PT.pad_plane(p, 4, 5, 10))
           for p in _random_planes(256, 320, 10, 21)]
    launches, old = PT.plan_device.launches, PT.mode_ssd.launches
    for q in (40, 90, 91):
        got = PT.plan_device(*dev, q, 10, nmodes, duel_level)
        assert got.dtype == torch.int32 and got.shape == (25 * 4 * 5,)
        assert torch.equal(got, PT.plan_device_plain(*dev, q, 10, nmodes,
                                                     duel_level))
    assert PT.plan_device.launches == launches
    assert PT.mode_ssd.launches == old


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_plan_gates_equal_the_torch_expressions(bitdepth):
    """The float32 gate constants the host hands the fused kernel are
    plan_device_plain's torch expressions, bit for bit, at every qindex."""
    for q in range(256):
        dq = torch.tensor(float(port_ac_q(q, bitdepth)), dtype=torch.float32)
        want = (dq * dq, 4.0 * dq * dq, 4096.0 * dq * dq / 64.0)
        for got, w in zip(PT.plan_gates(q, bitdepth), want):
            assert isinstance(got, np.float32)
            assert got.tobytes() == w.numpy().tobytes(), q


def test_plan_taps_pack_dir_taps():
    """The packed taps hold dir_taps(16) at the lane that scores each
    pixel: entry [m, k, 2r + h] is pixel (r, 8h + k)."""
    idx, w = PT.dir_taps(16)
    t = PT.plan_taps().astype(np.int64)
    assert t.shape == (6, 8, 32)
    lane = np.arange(32)
    for k in range(8):
        pix = 16 * (lane // 2) + 8 * (lane % 2) + k
        np.testing.assert_array_equal(t[:, k] & 0xFF, idx[:, pix, 0])
        np.testing.assert_array_equal((t[:, k] >> 8) & 0xFF, idx[:, pix, 1])
        np.testing.assert_array_equal(t[:, k] >> 16, w[:, pix, 1])
        np.testing.assert_array_equal(32 - (t[:, k] >> 16), w[:, pix, 0])


def test_plan_device_rejects_other_devices():
    p = torch.zeros((65, 65), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        PT.plan_device(p, p, p, 60, 10)
