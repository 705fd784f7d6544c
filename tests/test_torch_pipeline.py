"""The port's corpus pipeline (oavif_tpu_torch.tq.pipeline) and its device
metric paths on the CPU, against the port's sequential driver and the
reference (oavif_tpu.tq.pipeline, oavif_tpu.cli), on two 256x256 images
with the planner armed.

With the host C scorer the pipeline is a pure scheduling change: the same
q, passes and bytes as the sequential driver. With the device metric
(``jax`` mode; on the CPU the kernels' plain versions) it takes the same
q and passes as the reference pipeline's JAX mode, and every probe's score
is within 0.02 of the reference's. Not 0.01: on the flat ``blocks`` image
the SSIM features' float32 cancellation (see tests/test_torch_metric.py),
under Y weights of up to 225, leaves the three implementations up to 0.013
apart on identical recons (port against JAX at q87; the C scorer sits
between them), only because their blurs sum the taps in different orders.

Every test starts from empty planner and decision caches in both packages:
the cross-probe decision cache replays decisions recorded by an earlier
encode of the same plan, so state left by another test changes the bytes.
"""

from __future__ import annotations

import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import write_pam  # noqa: E402
from oavif_tpu import cli as ref_cli  # noqa: E402
from oavif_tpu.av1 import frame as ref_frame  # noqa: E402
from oavif_tpu import backend as ref_backend  # noqa: E402
from oavif_tpu import options as ref_options  # noqa: E402
from oavif_tpu.backend.tpu import TpuBackend  # noqa: E402
from oavif_tpu.io import image as ref_image  # noqa: E402
from oavif_tpu.tq import pipeline as ref_pipeline  # noqa: E402
from oavif_tpu_torch import backend as port_backend  # noqa: E402
from oavif_tpu_torch import options as port_options  # noqa: E402
from oavif_tpu_torch.io import image as port_image  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.av1 import encode as port_encode  # noqa: E402
from oavif_tpu_torch.av1 import encode_tpu as ET  # noqa: E402
from oavif_tpu_torch.av1 import frame as port_frame  # noqa: E402
from oavif_tpu_torch.backend.cuda import CudaBackend  # noqa: E402
from oavif_tpu_torch.kernels import count_launch  # noqa: E402
from oavif_tpu_torch.tq import pipeline  # noqa: E402
from oavif_tpu_torch.tq.driver import search_encode  # noqa: E402


def _mk_ctx(img, pkg="port", **opt):
    """An encoder context of the port's own types, or of the reference's
    (pkg="ref") from the same arguments."""
    be, im, op = ((port_backend, port_image, port_options) if pkg == "port"
                  else (ref_backend, ref_image, ref_options))
    h, w = img.shape[:2]
    return be.EncCtx(o=op.EncOptions(**{"speed": 9, **opt}),
                     src=im.Image(width=w, height=h, channels=3, hbd=False,
                                  data=img),
                     rgb=img, w=w, h=h)


def _imgs():
    """tests/test_pipeline.py's two images: smooth texture, flat blocks."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float64)
    smooth = np.clip(
        np.stack([128 + 90 * np.sin(xx / 23) * np.cos(yy / 17),
                  120 + 70 * np.cos(xx / 31),
                  110 + 80 * np.sin((xx + yy) / 29)], -1)
        + rng.normal(0, 5, (256, 256, 3)), 0, 255).astype(np.uint8)
    blocks = np.full((256, 256, 3), 220, np.uint8)
    for _ in range(8):
        x0, y0 = rng.integers(0, 200, 2)
        blocks[y0 : y0 + 48, x0 : x0 + 48] = rng.integers(0, 255, 3)
    return [smooth, blocks]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("OAVIF_METRIC", raising=False)
    monkeypatch.delenv("OAVIF_TQ_BATCH", raising=False)
    port_frame.reset_planners()
    ref_frame._PLANNER_CACHE.clear()
    ref_frame._DEC_CACHE.clear()


def _corpus(mode, monkeypatch, imgs=None, **opt):
    monkeypatch.setenv("OAVIF_PIPELINE_METRIC", mode)
    imgs = _imgs() if imgs is None else imgs
    return pipeline.search_encode_corpus([_mk_ctx(i, **opt) for i in imgs],
                                         CudaBackend())


def test_c_mode_matches_sequential_driver_and_reference(monkeypatch):
    imgs = _imgs()
    seq = [search_encode(_mk_ctx(img), CudaBackend()) for img in imgs]
    piped = _corpus("c", monkeypatch, imgs)
    ref = ref_pipeline.search_encode_corpus(
        [_mk_ctx(i, "ref") for i in imgs], TpuBackend())
    assert pipeline.search_encode_corpus.last_mode == "c"
    for (sr, sdata), (pr, pdata), (rr, _) in zip(seq, piped, ref):
        assert (pr.q, pr.num_pass) == (sr.q, sr.num_pass) == (rr.q,
                                                               rr.num_pass)
        assert pdata == sdata
    assert port_frame.planners(), "the planner did not arm"


def test_jax_mode_matches_reference_pipeline(monkeypatch):
    imgs = _imgs()
    got = _corpus("jax", monkeypatch, imgs)
    assert pipeline.search_encode_corpus.last_mode == "jax"
    want = ref_pipeline.search_encode_corpus(
        [_mk_ctx(i, "ref") for i in imgs], TpuBackend())
    for (g, gdata), (w, _) in zip(got, want):
        assert (g.q, g.num_pass) == (w.q, w.num_pass)
        assert [h.q for h in g.history] == [h.q for h in w.history]
        for gh, wh in zip(g.history, w.history):
            assert abs(gh.score - wh.score) < 0.02, (gh, wh)
        assert gdata[4:12] == b"ftypavif"


@pytest.mark.parametrize("mode", ["c", "jax"])
def test_single_image_and_empty(mode, monkeypatch):
    assert _corpus(mode, monkeypatch, []) == []
    out = _corpus(mode, monkeypatch, _imgs()[:1])
    assert len(out) == 1
    r, data = out[0]
    assert abs(r.score - 80.0) <= 2.0 or r.score >= 80.0
    assert len(data) > 100


@pytest.mark.parametrize("mode", ["c", "jax"])
def test_respects_max_pass(mode, monkeypatch):
    out = _corpus(mode, monkeypatch, _imgs()[:1], max_pass=1)
    assert out[0][0].num_pass == 1


@pytest.mark.parametrize("mode", ["c", "jax", "hybrid"])
def test_deterministic_across_runs(mode, monkeypatch):
    a = _corpus(mode, monkeypatch)
    b = _corpus(mode, monkeypatch)
    for (ra, da), (rb, db) in zip(a, b):
        assert ra.q == rb.q and ra.num_pass == rb.num_pass
        assert da == db


@pytest.mark.parametrize("env,want", [(None, "c"), ("auto", "c"),
                                      ("jax", "jax"), ("HYBRID", "hybrid")])
def test_scorer_mode(env, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("OAVIF_PIPELINE_METRIC", raising=False)
    else:
        monkeypatch.setenv("OAVIF_PIPELINE_METRIC", env)
    assert pipeline._pick_scorer_mode() == want


def test_unknown_scorer_mode_rejected(monkeypatch):
    monkeypatch.setenv("OAVIF_PIPELINE_METRIC", "gpu")
    with pytest.raises(ValueError):
        pipeline._pick_scorer_mode()


def test_prefetch_plan_warms_the_planner_cache():
    ctx = _mk_ctx(_imgs()[0])
    port_encode.prefetch_plan(ctx, 80)
    planners = port_frame.planners()
    assert len(planners) == 1 and len(planners[0]._plan_cache) == 1
    # the encode at the same quality finds that planner and its plan
    plan = next(iter(planners[0]._plan_cache.values()))
    ctx.q = 80
    CudaBackend().encode_with_recon(ctx)
    assert port_frame.planners() == planners
    assert next(iter(planners[0]._plan_cache.values())) is plan


def test_prefetch_plan_skips_small_frames_low_speeds_and_tiled_frames():
    port_encode.prefetch_plan(_mk_ctx(_imgs()[0][:128, :128]), 80)
    port_encode.prefetch_plan(_mk_ctx(_imgs()[0], speed=5), 80)
    port_encode.prefetch_plan(_mk_ctx(_imgs()[0], tile_cols_log2=1), 80)
    assert port_frame.planners() == []


def test_prefetch_plan_raises_when_planning_fails(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("planner failed")

    monkeypatch.setattr(ET, "plan_device", broken)
    with pytest.raises(RuntimeError, match="planner failed"):
        port_encode.prefetch_plan(_mk_ctx(_imgs()[0]), 80)


def test_failed_prefetch_raises_from_the_corpus(monkeypatch):
    def broken(ctx, quality):
        raise RuntimeError("prefetch failed")

    monkeypatch.setattr(port_encode, "prefetch_plan", broken)
    with pytest.raises(RuntimeError, match="prefetch failed"):
        _corpus("c", monkeypatch, _imgs()[:1])


def test_launch_count_is_safe_across_threads(monkeypatch):
    """The pipeline's worker thread and the encoding thread count launches
    at once; no increment may be lost."""
    monkeypatch.setattr(ET.mode_ssd, "launches", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    per_thread, threads = 20000, 4
    try:
        with ThreadPoolExecutor(max_workers=threads - 1) as worker:
            futures = [worker.submit(
                lambda: [count_launch(ET.mode_ssd) for _ in range(per_thread)])
                for _ in range(threads - 1)]
            for _ in range(per_thread):
                count_launch(ET.mode_ssd)
            for f in futures:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert ET.mode_ssd.launches == threads * per_thread


def _cli(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return int(found.group(1)), float(found.group(2)), int(found.group(3))


# The batched search encodes its candidates on concurrent threads; which of
# two candidates that share a plan records the decision cache first depends
# on timing, in both packages, so there q and passes are compared, and not
# the score.
@pytest.mark.parametrize("batch", ["0", "1"])
def test_cli_device_metric_matches_reference(batch, tmp_path, capsys,
                                             monkeypatch):
    monkeypatch.setenv("OAVIF_METRIC", "jax")
    monkeypatch.setenv("OAVIF_TQ_BATCH", batch)
    src = tmp_path / "in.pam"
    write_pam(src, _imgs()[0])
    rq, rscore, rpasses = _cli(ref_cli, ["-t", "80"], src,
                               tmp_path / "ref.avif", capsys)
    q, score, passes = _cli(port_cli, ["-t", "80"], src,
                            tmp_path / "port.avif", capsys)
    assert (q, passes) == (rq, rpasses)
    assert 0.0 < score <= 100.0
