"""``OAVIF_TRACE=<dir>`` on the port's CLI, on the CPU: the search runs
under ``torch.profiler``, the reference's line ``Profiler trace written
to <dir>`` is printed, a Chrome trace that parses as JSON lands in the
directory, and the bytes are those of the run without the trace. A
fixed-quality run is not traced, as in the reference (its CLI wraps only
the search)."""

from __future__ import annotations

import contextlib
import io
import json
import os

import pytest

from oavif_tpu_torch import cli
from oavif_tpu_torch.av1 import frame
from oavif_tpu_torch.scripts.corpus import bench_images, write_pam


@pytest.fixture
def src(tmp_path, monkeypatch):
    monkeypatch.setenv("OAVIF_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("OAVIF_TRACE", raising=False)
    path = tmp_path / "in.pam"
    write_pam(str(path), bench_images(256, ("mixed",))["mixed"])
    return path


def _run(args, src, out):
    err = io.StringIO()
    frame.reset_planners()
    with contextlib.redirect_stderr(err):
        rc = cli.run(args + [str(src), str(out)])
    return rc, err.getvalue(), out.read_bytes()


def test_trace_written_and_bytes_unchanged(src, tmp_path, monkeypatch):
    rc, log, plain = _run(["-t", "80"], src, tmp_path / "plain.avif")
    assert rc == 0 and "Profiler trace" not in log
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("OAVIF_TRACE", str(trace_dir))
    rc, log, traced = _run(["-t", "80"], src, tmp_path / "traced.avif")
    assert rc == 0, log
    assert frame.planners(), "the planner did not arm"
    assert f"Profiler trace written to {trace_dir}" in log.splitlines()
    assert traced == plain
    files = sorted(trace_dir.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]


def test_fixed_quality_is_not_traced(src, tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("OAVIF_TRACE", str(trace_dir))
    rc, log, data = _run(["-q", "60"], src, tmp_path / "q.avif")
    assert rc == 0 and data[4:12] == b"ftypavif"
    assert "Profiler trace" not in log
    assert not trace_dir.exists()


def test_trace_line_is_the_reference_line():
    """The port prints the line the reference's CLI prints."""
    import inspect

    from oavif_tpu import cli as ref_cli

    line = 'f"Profiler trace written to {trace_dir}"'
    assert line in inspect.getsource(ref_cli.run)
    assert line in inspect.getsource(cli.run)


@pytest.mark.parametrize("user", (None, "1"), ids=("unset", "user_set"))
def test_trace_keeps_cupti_attached_unless_the_user_chose(src, tmp_path,
                                                          monkeypatch, user):
    """The traced CLI sets ``TEARDOWN_CUPTI=0`` before its profiler
    session, so that a process that runs several traced searches (the
    harness) keeps the card's records in each; a value the user set
    stays."""
    if user is None:
        monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    else:
        monkeypatch.setenv("TEARDOWN_CUPTI", user)
    monkeypatch.setenv("OAVIF_TRACE", str(tmp_path / "trace"))
    rc, log, _ = _run(["-t", "80"], src, tmp_path / "traced.avif")
    assert rc == 0 and "Profiler trace written" in log
    assert os.environ["TEARDOWN_CUPTI"] == ("0" if user is None else user)
