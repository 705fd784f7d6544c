"""The port's driver entry points (oavif_tpu_torch.graft_entry) against the
repository's JAX ones (__graft_entry__.py), on the CPU.

``dryrun_multichip`` runs on spawned CPU ranks (gloo, a deadline of 120 s);
the JAX side runs in this process. What the dry run returns is compared
here: plans per tile against the JAX planner's ``_plan_device_body``
(exact except at proven float32 near-ties, tests/test_torch_planner.py),
the sharded-plan encode's bytes against the unsharded encode's and against
the JAX package's own frame encode, scores within 0.05 (sharded against
single-device, as the reference asserts) and 0.01 (the port's
single-device score against the JAX metric's), and the Wiener planes
exactly.

The reference's 128-px tiles are below the planner's 256x256 arming size,
so its seeded plans are never consumed (``seeded_used`` is 0); a frame of
256-px tiles shows the seeds consumed.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__ as ge  # noqa: E402
from oavif_tpu.av1 import encode as REN  # noqa: E402
from oavif_tpu.av1 import encode_tpu as RT  # noqa: E402
from oavif_tpu.av1 import frame as RFR  # noqa: E402
from oavif_tpu.av1.cdef import cdef_frame  # noqa: E402
from oavif_tpu.av1.loopfilter import loop_filter_frame  # noqa: E402
from oavif_tpu.av1.mux import mux_avif  # noqa: E402
from oavif_tpu.av1.obu import (FrameConfig, SequenceConfig,  # noqa: E402
                               assemble_av1_stream)
from oavif_tpu.av1.tables import ac_q  # noqa: E402
from oavif_tpu.av1.yuv import rgb_to_yuv444  # noqa: E402
from oavif_tpu.metric import compute_ssimulacra2 as jax_score  # noqa: E402
from oavif_tpu_torch import graft_entry as PG  # noqa: E402
from oavif_tpu_torch.av1 import encode_tpu as PT  # noqa: E402
from test_torch_planner import (plan_mismatches, port_floats,  # noqa: E402
                                reference_floats, sections)

TIMEOUT_S = 120
Q = PG.QINDEX


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"world{n}")
def dryrun(request):
    n = request.param
    return n, PG.dryrun_multichip(n, device="cpu", timeout_s=TIMEOUT_S)


def _tile_planes(n):
    t_dim = PG.mesh_dims(n)[1]
    img = ge._test_image(128, 128 * t_dim, seed=1)
    planes = [p.astype(np.int32) for p in rgb_to_yuv444(img, 8)]
    return img, planes, [[np.ascontiguousarray(p[:, t * 128 : (t + 1) * 128])
                          for p in planes] for t in range(t_dim)]


def test_constants_and_test_image_equal():
    assert (PG.QINDEX, PG.BITDEPTH, PG.UV_DQ, PG.TILE_PX) == (60, 8, 24, 128)
    for args in ((), (64, 64), (128, 256, 1)):
        np.testing.assert_array_equal(PG._test_image(*args),
                                      ge._test_image(*args))
    assert [PG.mesh_dims(n) for n in (1, 2, 4, 8)] == [(1, 1), (1, 2),
                                                      (2, 2), (2, 4)]


def test_entry_scores_match_jax():
    step, (ref, dists) = PG.entry("cpu")
    got = step(ref, dists).numpy()
    fn, args = ge.entry()
    want = np.asarray(jax.jit(fn)(*args))
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(args[0]))


def test_dryrun_plans_match_jax_planner(dryrun):
    """Each tile's packed plan from the dry run against the JAX
    _plan_device_body on the same tile, exact up to float32 near-ties."""
    n, r = dryrun
    _, _, tiles = _tile_planes(n)
    assert r["plans"].shape[0] == len(tiles)
    n_diff = 0
    for t, tp in enumerate(tiles):
        fp = RT.FramePlanner(tp, 8)
        ref = sections(RT._plan_device_body(
            *fp.dev, jnp.float32(ac_q(Q, 8)), jnp.float32(Q), 4, 4, 8),
            2, 2)
        got = sections(r["plans"][t], 2, 2)
        floats = (reference_floats(fp),
                  port_floats(PT.FramePlanner(tp, 8, device="cpu")))
        diff, bad = plan_mismatches(ref, got, floats, Q, 8)
        assert not bad, bad
        n_diff += diff
    print(f"{n_diff} plan entries differ, all float32 near-ties")


def _reference_frame_encode(planes, tcl):
    """The JAX package's frame encode as __graft_entry__.py's
    product_frame_encode runs it, without seeds."""
    RFR._PLANNER_CACHE.clear()
    RFR._DEC_CACHE.clear()
    h, w = planes[0].shape
    payloads, recon, blocks = RFR.encode_frame_planes(
        [p.copy() for p in planes], Q, 8, speed=9, tile_cols_log2=tcl,
        use_tpu_planner=True, u_ac_delta_q=24)
    flv = REN._filter_level(Q)
    loop_filter_frame(recon, blocks, (flv,) * 4, bitdepth=8, visible=(h, w))
    strengths, damping = REN._pick_cdef(planes, recon, blocks, Q, 8, (h, w))
    if any(strengths):
        cdef_frame(recon, blocks, strengths, damping, 8)
    seq = SequenceConfig(width=w, height=h, bit_depth=8, enable_cdef=True)
    frame = FrameConfig(width=w, height=h, base_q_idx=Q, tile_cols_log2=tcl,
                        u_ac_delta_q=24, filter_levels=(flv,) * 4,
                        enable_cdef=True, cdef_damping=damping,
                        cdef_strengths=(strengths,))
    return mux_avif(assemble_av1_stream(seq, frame, payloads), w, h,
                    bit_depth=8, high_bitdepth=False, cicp=(2, 2, 2))


def test_dryrun_bytes_equal_unsharded_and_reference(dryrun):
    n, r = dryrun
    _, planes, tiles = _tile_planes(n)
    assert r["avif_sharded"] == r["avif_single"]
    assert r["avif_sharded"][4:12] == b"ftypavif"
    tcl = int(np.log2(len(tiles)))
    assert r["avif_single"] == _reference_frame_encode(planes, tcl)
    # 128-px tiles never arm the planner: the seeds are not consumed
    assert r["seeded_used"] == 0
    assert r["payloads_equal"] == [True] * len(tiles)


def test_dryrun_checksums_and_candidate_scores(dryrun):
    n, r = dryrun
    assert r["totals"] == [r["totals"][0]] * n
    q_dim = PG.mesh_dims(n)[0]
    for scores in r["scores"]:
        assert scores.shape == (2 * q_dim,)
        np.testing.assert_allclose(scores, 100.0, rtol=0, atol=0.1)


def test_dryrun_sharded_score(dryrun):
    n, r = dryrun
    img, _, _ = _tile_planes(n)
    assert abs(r["score_sharded"] - r["score_single"]) < 0.05
    assert 20.0 < r["score_sharded"] < 100.0
    want = jax_score(img, r["recon"])
    assert abs(r["score_single"] - want) < 0.01, (r["score_single"], want)


def test_dryrun_wiener_equals_host(dryrun):
    _, r = dryrun
    assert len(r["wiener_sharded"]) == len(r["wiener_host"]) == 3
    for got, want in zip(r["wiener_sharded"], r["wiener_host"]):
        np.testing.assert_array_equal(got, want)


def test_dryrun_device_levels(dryrun):
    n, r = dryrun
    assert r["levels_shape"] == (2, 64, 256)
    assert r["eob_shape"] == (2, 64)
    assert r["eob_sums"][1] <= r["eob_sums"][0]
    assert abs(r["score_device_levels"] - r["score_single"]) < 2.0


def test_dryrun_consumes_seeded_plans_on_armed_tiles():
    """256-px tiles arm the planner: the sharded plans seeded into the
    planner cache drive the encode, which still gives the unsharded
    bytes."""
    img = PG._test_image(256, 512, seed=3)
    r = PG.dryrun_multichip(2, device="cpu", image=img, timeout_s=TIMEOUT_S)
    assert r["seeded_used"] == 2
    assert r["avif_sharded"] == r["avif_single"]
    assert r["plans"].shape == (2, 16 + 6 * 64)  # 4x4 SBs per tile
    assert "score_sharded" not in r
