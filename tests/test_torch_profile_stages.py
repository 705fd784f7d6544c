"""The port's stage profile (``oavif_tpu_torch/scripts/profile_stages.py``)
on the CPU: every label of the reference's tool and ``metric-host`` in
its JSON line, the stages entered from outside every other within the
wall, the wrappers removed afterwards, and the profiled searches' q,
passes and bytes equal to the JAX package's searches on the same images.
"""

from __future__ import annotations

import json

import pytest

from oavif_tpu.backend import EncCtx as RefCtx
from oavif_tpu.backend.tpu import TpuBackend
from oavif_tpu.io.image import Image as RefImage
from oavif_tpu.options import EncOptions as RefOptions
from oavif_tpu.tq.driver import search_encode as ref_search_encode
from oavif_tpu_torch.av1 import encode as port_encode
from oavif_tpu_torch.scripts import profile_stages as PS
from oavif_tpu_torch.scripts.corpus import bench_images


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


def test_profile_json_line_labels_and_wall(capsys):
    before = port_encode.loop_filter_frame
    rows = PS.profile(bench_images(256, ("edges", "mixed")))
    assert port_encode.loop_filter_frame is before  # wrappers removed
    PS.report(rows)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [r["image"] for r in lines] == ["edges", "mixed"]
    for r in lines:
        assert set(r) >= {"image", "size", "speed", "device", "wall_ms",
                          "outer_ms", "q", "score", "passes", "bytes", "ms",
                          "calls"}
        assert r["size"] == "256x256" and r["device"] == "cpu"
        assert set(r["ms"]) == set(r["calls"]) == set(PS.LABELS)
        assert 0 < r["outer_ms"] <= r["wall_ms"]
        nested = sum(r["ms"][k] for k in PS.NESTED_IN_FRAME)
        assert nested <= r["ms"]["TOTAL-frame-encode"]
        # the default search: one frame encode, tile coder, recon
        # conversion and host score per pass, and the planner armed
        for label in ("TOTAL-frame-encode", "C-tile-encode",
                      "yuv->rgb(recon)", "metric-host", "planner.plan",
                      "loopfilter", "mux", "obu-assemble", "cdef-search"):
            assert r["calls"][label] == r["passes"], label
        assert r["calls"]["rgb->yuv"] == 1
        assert r["calls"]["metric-batch"] == 0


def test_profile_batched_search_times_the_device_metric(monkeypatch):
    monkeypatch.setenv("OAVIF_METRIC", "jax")
    (r,) = PS.profile(bench_images(256, ("edges",)))
    assert r["calls"]["metric-batch"] >= 1
    assert r["calls"]["metric-host"] == 0
    assert r["calls"]["TOTAL-frame-encode"] == r["passes"]


@pytest.mark.parametrize("name", ["sinusoid", "text"])
def test_profiled_search_equals_the_reference_search(name):
    """Below the planner's arming size both packages search alike."""
    images = bench_images(128, (name,))
    (r,) = PS.profile(images)
    rgb = images[name]
    ctx = RefCtx(o=RefOptions(), src=RefImage(width=128, height=128,
                                              channels=3, hbd=False,
                                              data=rgb),
                 rgb=rgb, w=128, h=128)
    res, data = ref_search_encode(ctx, TpuBackend())
    assert (r["q"], r["passes"], r["bytes"]) == (res.q, ctx.num_pass,
                                                 len(data))
