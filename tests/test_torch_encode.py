"""The port's CLI (oavif_tpu_torch.cli) against the reference CLI
(oavif_tpu.cli), end to end on the CPU: 10-bit, speed 9, one tile, the
planner armed (frames of at least 256x256 pixels).

``-q 60`` must give byte-identical AVIF. ``-t 80`` must reach the same q
in the same number of passes with the same bytes and score. Bytes may
differ only where the two planners break a float32 near-tie differently
(see tests/test_torch_planner.py): then their plans must differ, and only
in such near-ties.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
from chip_smoke import frame_4k, write_pam  # noqa: E402
from oavif_tpu import cli as ref_cli  # noqa: E402
from oavif_tpu.av1 import encode_tpu as RT  # noqa: E402
from oavif_tpu.av1.consts import quality_to_qindex  # noqa: E402
from oavif_tpu.av1.encode import _depth_convert  # noqa: E402
from oavif_tpu.av1.yuv import rgb_to_yuv444  # noqa: E402
from oavif_tpu_torch import cli as port_cli  # noqa: E402
from oavif_tpu_torch.av1 import encode_tpu as PT  # noqa: E402
from oavif_tpu_torch.av1 import frame as port_frame  # noqa: E402
from test_torch_planner import assert_plans_match  # noqa: E402

FIXTURES = {
    "sinusoid": lambda: bench._img_sinusoid(512, 512),
    "edges": lambda: bench._img_edges(512, 512),
    "text": lambda: bench._img_text(512, 512),
    "oriented_320x448": lambda: bench._img_oriented(320, 448),
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")


def _run(cli, args, src, out, capsys):
    capsys.readouterr()
    assert cli.run(args + [str(src), str(out)]) == 0
    err = capsys.readouterr().err
    data = out.read_bytes()
    assert data[4:12] == b"ftypavif"
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", err)
    return data, found.groups() if found else None


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixed_q_bytes_equal_reference(name, tmp_path, capsys):
    src = tmp_path / f"{name}.pam"
    write_pam(src, FIXTURES[name]())
    ref, _ = _run(ref_cli, ["-q", "60"], src, tmp_path / "ref.avif", capsys)
    port_frame.reset_planners()
    got, _ = _run(port_cli, ["-q", "60"], src, tmp_path / "port.avif",
                  capsys)
    assert got == ref
    assert port_frame.planners(), "the planner did not arm"


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_search_matches_reference(name, tmp_path, capsys):
    rgb = FIXTURES[name]()
    src = tmp_path / f"{name}.pam"
    write_pam(src, rgb)
    ref, (rq, rscore, rpasses) = _run(ref_cli, ["-t", "80"], src,
                                      tmp_path / "ref.avif", capsys)
    got, (q, score, passes) = _run(port_cli, ["-t", "80"], src,
                                   tmp_path / "port.avif", capsys)
    assert (q, passes) == (rq, rpasses)
    if got == ref:
        assert score == rscore
        return
    # the bytes may differ only through reference near-ties in the plan
    planes = rgb_to_yuv444(_depth_convert(rgb, False, 10), bitdepth=10)
    fp = RT.FramePlanner(planes, 10)
    pp = PT.planner_from_reference([np.asarray(d) for d in fp.dev], 10, 13,
                                   0, "cpu", rgb.shape[:2])
    qindexes = sorted({quality_to_qindex(x) for x in range(100)})
    assert assert_plans_match(fp, pp, qindexes) > 0, \
        "bytes differ but the plans are identical"


def test_photo_search_ends_where_the_reference_does(tmp_path, capsys):
    """chip_smoke's photo-like frame at 1920x1088: both packages'
    sequential ``-t 80`` search end at the same q after the same passes
    with scores within 0.02, and both end outside 80 +- 2: when no probe
    lands inside the tolerance, the search keeps the lowest q that meets
    the target (oavif's tq.zig policy). This is the reference's behaviour,
    as the port's on the 3840x2160 frame (score 83.14 at q92)."""
    src = tmp_path / "photo.pam"
    write_pam(src, frame_4k(1088, 1920))
    _, (rq, rscore, rpasses) = _run(ref_cli, ["-t", "80"], src,
                                    tmp_path / "ref.avif", capsys)
    _, (q, score, passes) = _run(port_cli, ["-t", "80"], src,
                                 tmp_path / "port.avif", capsys)
    assert (q, passes) == (rq, rpasses)
    assert abs(float(score) - float(rscore)) <= 0.02
    assert abs(float(rscore) - 80.0) > 2.0


def test_decision_cache_keeps_options_apart(tmp_path, capsys):
    """Three option sets in one process (speed 8, speed 5, ``--tune
    ssim``) each give the bytes of the same encode in a fresh process, and
    every stream decodes by dav1d: the cross-probe decision cache never
    replays decisions recorded under other options."""
    from oavif_tpu_torch.io.avif_ctypes import decode_to_yuv

    src = tmp_path / "mixed.pam"
    write_pam(src, bench._img_mixed(256, 256))
    options = [["-q", "60", "-s", "8"], ["-q", "60", "-s", "5"],
               ["-q", "60", "--tune", "ssim"]]
    port_frame.reset_planners()
    in_turn = [_run(port_cli, o, src, tmp_path / "a.avif", capsys)[0]
               for o in options]
    assert port_frame.planners(), "the planner did not arm"
    for o, data in zip(options, in_turn):
        port_frame.reset_planners()
        alone, _ = _run(port_cli, o, src, tmp_path / "b.avif", capsys)
        assert data == alone, o
        decode_to_yuv(data)
