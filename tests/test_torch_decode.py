"""Decoding the port's streams on the CPU: ``CudaBackend.decode_to_rgb8``
(the port's own AVIF reader, ``io/avif.py``, with libavif's conversion to
RGB reproduced) against the reference's ``TpuBackend.decode_to_rgb8``
(Pillow's AVIF plugin) on the same bytes; and the port's own streams that
no other decode covers: the ``edges`` near-tie plan, a seeded dry run of
``graft_entry`` at two ranks, and a result of the batched search on the
device metric (``OAVIF_METRIC=jax``). Each is decoded by
``decode_to_yuv`` (the system libavif's dav1d, a test yardstick) and by
the port to exactly the YUV of its encoder's reconstruction (the bar of
``tests/test_conformance.py``); the recon's own conversion of the port's
planes gives the recon RGB exactly, and the port's RGB equals Pillow's.

The port's RGB equals Pillow's exactly at 8 and at 10 bits: at 10 bits
libavif 1.3 (Pillow's) narrows the Y'UV planes to 8 bits through libyuv
before its fixed-point matrix, which the port reproduces. At 8 bits that
RGB stays within 1 of the recon's float conversion; at 10 bits Pillow's
is further from it (up to 3 on these streams), so there the recon is
held through its own conversion of the decoded planes instead. No
libavif is on the port's decode path.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from oavif_tpu.backend.tpu import TpuBackend
from oavif_tpu_torch import graft_entry as PG
from oavif_tpu_torch.av1 import encode as EN
from oavif_tpu_torch.av1.yuv import yuv444_to_rgb
from oavif_tpu_torch.av1.encode_tpu import unpack_plan
from oavif_tpu_torch.backend import EncCtx
from oavif_tpu_torch.backend.cuda import CudaBackend
from oavif_tpu_torch.io import avif_ctypes
from oavif_tpu_torch.io.avif import decode_avif
from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv
from oavif_tpu_torch.io.image import Image
from oavif_tpu_torch.options import EncOptions
from oavif_tpu_torch.scripts.corpus import bench_images
from oavif_tpu_torch.tq.driver import search_encode

TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


def _ctx(rgb, **opts):
    h, w = rgb.shape[:2]
    return EncCtx(o=EncOptions(**opts), src=Image(width=w, height=h,
                                                  channels=3, hbd=False,
                                                  data=rgb),
                  rgb=rgb, w=w, h=h)


@pytest.fixture
def recon_planes(monkeypatch):
    """{AVIF bytes: the recon YUV planes its encode converted to RGB},
    for every ``encode_avif_with_recon`` in the test (threads included)."""
    seen, last = {}, threading.local()
    mux, to_rgb = EN.mux_avif, EN.yuv444_to_rgb

    def mux_avif(*a, **k):
        last.avif = mux(*a, **k)
        return last.avif

    def yuv444_to_rgb(planes, *a, **k):
        seen[last.avif] = [np.array(p) for p in planes]
        return to_rgb(planes, *a, **k)

    monkeypatch.setattr(EN, "mux_avif", mux_avif)
    monkeypatch.setattr(EN, "yuv444_to_rgb", yuv444_to_rgb)
    return seen


def _assert_decodes_to_recon(avif: bytes, planes, recon_rgb):
    yuv, depth, _ = decode_to_yuv(avif)
    _, port, _ = decode_avif(avif)
    assert len(yuv) == len(planes) == len(port.planes) == 3
    for i, (dec, mine, ours) in enumerate(zip(yuv, port.planes, planes)):
        np.testing.assert_array_equal(dec, ours, err_msg=f"plane {i}")
        np.testing.assert_array_equal(mine, ours, err_msg=f"plane {i}")
    np.testing.assert_array_equal(yuv444_to_rgb(port.planes, bitdepth=depth),
                                  recon_rgb)
    np.testing.assert_array_equal(CudaBackend().decode_to_rgb8(avif),
                                  TpuBackend().decode_to_rgb8(avif))


@pytest.mark.parametrize("tenbit", [False, True], ids=["8bit", "10bit"])
@pytest.mark.parametrize("name", ["sinusoid", "text"])
def test_decode_to_rgb8_against_the_reference_backend(name, tenbit):
    rgb = bench_images(128, (name,))[name]
    ctx = _ctx(rgb, tenbit=tenbit)
    ctx.q = 60
    data, recon = CudaBackend().encode_with_recon(ctx)
    ours = CudaBackend().decode_to_rgb8(data)
    ref = TpuBackend().decode_to_rgb8(data)
    assert ours.shape == ref.shape == rgb.shape and ours.dtype == np.uint8
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() == 0, f"{int((diff > 0).sum())} pixels differ"
    if tenbit:
        _, port, _ = decode_avif(data)
        np.testing.assert_array_equal(
            yuv444_to_rgb(port.planes, bitdepth=10), recon)
    else:
        assert np.abs(ours.astype(int) - recon.astype(int)).max() <= 1


def test_decode_without_libavif_says_so(monkeypatch):
    """With libavif unloadable the port still decodes (nothing of libavif
    is on its path), and a file that is no AVIF says so. Only
    ``avif_ctypes`` loses libavif: ``ctypes.CDLL`` itself stays, so the
    port's host library still loads if this test is the process's first."""
    def refuse():
        raise OSError("libavif.so.15: cannot open shared object file")

    monkeypatch.setattr(avif_ctypes, "_lib", None)
    monkeypatch.setattr(avif_ctypes, "_load", refuse)
    with pytest.raises(OSError, match="libavif"):
        decode_to_yuv(b"\x00" * 64)
    rgb = bench_images(64, ("text",))["text"]
    ctx = _ctx(rgb)
    ctx.q = 60
    data, _ = CudaBackend().encode_with_recon(ctx)
    np.testing.assert_array_equal(CudaBackend().decode_to_rgb8(data),
                                  TpuBackend().decode_to_rgb8(data))
    with pytest.raises(OSError, match="broken AVIF"):
        CudaBackend().decode_to_rgb8(b"\x00" * 64)


def test_edges_near_tie_stream_decodes_to_recon(recon_planes):
    """``edges`` at 512x512, ``-t 80``: the stream whose plan differs from
    the JAX planner's at float32 near-ties (53462 bytes, PERF.md §5)."""
    rgb = bench_images(512, ("edges",))["edges"]
    ctx = _ctx(rgb)
    res, data = search_encode(ctx, CudaBackend())
    assert (res.q, ctx.num_pass, len(data)) == (87, 1, 53462)
    _, recon = CudaBackend().encode_with_recon(ctx)
    _assert_decodes_to_recon(data, recon_planes[data], recon)


def test_seeded_dry_run_stream_decodes_to_recon(monkeypatch):
    """The dry run at two ranks on 256-px tiles (the seeded plans drive
    its encode); the same encode, seeded with the ranks' plans, is run
    here to see its recon planes."""
    img = PG._test_image(256, 512, seed=3)
    r = PG.dryrun_multichip(2, device="cpu", image=img, timeout_s=TIMEOUT_S)
    assert r["seeded_used"] == 2
    seen = {}
    to_rgb = PG.yuv444_to_rgb

    def yuv444_to_rgb(planes, *a, **k):
        seen["planes"] = [np.array(p) for p in planes]
        return to_rgb(planes, *a, **k)

    monkeypatch.setattr(PG, "yuv444_to_rgb", yuv444_to_rgb)
    planes = [p.astype(np.int32) for p in PG.rgb_to_yuv444(img, PG.BITDEPTH)]
    tcl, tiles = PG._tiles(planes, 512, 256, 2)
    seeds = [unpack_plan(p, 256 // 32, 256 // 32) for p in r["plans"]]
    avif, recon, used = PG._frame_encode(planes, tcl, tiles, seeds)
    assert used == 2
    assert avif == r["avif_sharded"]
    np.testing.assert_array_equal(recon, r["recon"])
    _assert_decodes_to_recon(avif, seen["planes"], recon)


def test_batched_device_metric_result_decodes_to_recon(recon_planes,
                                                       monkeypatch):
    monkeypatch.setenv("OAVIF_METRIC", "jax")
    rgb = bench_images(256, ("mixed",))["mixed"]
    ctx = _ctx(rgb)
    res, data = search_encode(ctx, CudaBackend())
    assert ctx.num_rounds >= 1 and ctx.num_pass >= 1
    planes = recon_planes[data]
    recon = yuv444_to_rgb(planes, bitdepth=10)
    _assert_decodes_to_recon(data, planes, recon)
