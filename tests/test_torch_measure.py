"""The port's corpus harness (``oavif_tpu_torch/scripts/measure.py``)
against the reference's ``scripts/measure.py``, on the CPU: the five
tests of ``tests/test_measure.py`` (pass regex, in-process run, static
shards and ``--merge``, ``--resume``, the pipelined ``--window``) and the
two-process test of ``tests/test_multihost.py`` mirrored against the
port, the two processes being gloo ranks from ``parallel.spawn`` whose
shard comes from the process group; and the port's CSV against the
reference harness's on the same corpus.
"""

from __future__ import annotations

import contextlib
import csv
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image as PILImage

from oavif_tpu_torch import parallel
from oavif_tpu_torch.scripts import measure

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 300
ENV = dict(os.environ, OAVIF_TORCH_DEVICE="cpu", JAX_PLATFORMS="cpu",
           PYTHONPATH=str(REPO))


@pytest.fixture
def corpus(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        a = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        PILImage.fromarray(a).save(d / f"img{i}.png")
    return d


def _port(*args, env=ENV):
    return subprocess.run(
        [sys.executable, "-m", "oavif_tpu_torch.scripts.measure",
         *map(str, args)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_pass_regex():
    assert measure.parse_pass_count("Found q60 (score 80.1, 3 passes)") == 3
    assert measure.parse_pass_count("1 pass") == 1
    assert measure.parse_pass_count("nothing") is None


def test_corpus_run_inprocess(corpus, tmp_path):
    out_csv = tmp_path / "out.csv"
    r = _port(corpus, "module:oavif_tpu_torch -q 60", out_csv)
    assert r.returncode == 0, r.stderr[-500:]
    rows = _rows(out_csv)
    assert list(rows[0]) == measure.FIELDS
    assert len(rows) == 3
    assert all(row["Status"] == "ok" for row in rows)
    assert all(int(row["Final Bytes"]) > 0 for row in rows)
    assert "Savings" in r.stdout


def test_corpus_sharding(corpus, tmp_path):
    csvs = []
    for k in range(2):
        out_csv = tmp_path / f"shard{k}.csv"
        r = _port(corpus, "module:oavif_tpu_torch -q 60", out_csv,
                  "--shard", f"{k}/2")
        assert r.returncode == 0, r.stderr[-500:]
        csvs.append(out_csv)
    merged = tmp_path / "merged.csv"
    r = _port(".", "x", merged, "--merge", *csvs)
    assert r.returncode == 0, r.stderr[-500:]
    rows = _rows(merged)
    assert len(rows) == 3  # shards disjoint and complete
    assert len({row["Image"] for row in rows}) == 3


def test_corpus_resume(corpus, tmp_path):
    out_csv = tmp_path / "out.csv"
    r = _port(corpus, "module:oavif_tpu_torch -q 60", out_csv)
    assert r.returncode == 0, r.stderr[-500:]
    rows1 = _rows(out_csv)
    r = _port(corpus, "module:oavif_tpu_torch -q 60", out_csv, "--resume")
    assert r.returncode == 0, r.stderr[-500:]
    assert "3 done, 0 remaining" in r.stderr
    assert _rows(out_csv) == rows1


def test_corpus_run_pipelined_window(corpus, tmp_path):
    """--window N runs the searches through the port's tq.pipeline; the
    rows equal the sequential in-process run's (same searches, same
    bytes)."""
    env = dict(ENV, OAVIF_PIPELINE_METRIC="c")
    seq_csv, pipe_csv = tmp_path / "seq.csv", tmp_path / "pipe.csv"
    for out_csv, extra in ((seq_csv, []), (pipe_csv, ["--window", "3"])):
        r = _port(corpus, "module:oavif_tpu_torch -t 70", out_csv, *extra,
                  env=env)
        assert r.returncode == 0, r.stderr[-500:]
    seq, pipe = _rows(seq_csv), _rows(pipe_csv)
    assert len(pipe) == len(seq) == 3
    for a, b in zip(seq, pipe):
        assert b["Status"] == "ok"
        assert b["Image"] == a["Image"]
        assert b["Final Bytes"] == a["Final Bytes"]
        assert b["Passes"] == a["Passes"]


def test_two_ranks_shard_from_the_process_group_and_merge(tmp_path):
    """Two gloo ranks (``parallel.spawn``) run the harness with no
    --shard: each takes its strided slice of the sorted corpus from its
    rank and the world size; --merge accounts for every image."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(5)
    names = []
    for i in range(3):
        img = np.clip(128 + 60 * np.sin(np.arange(64)[:, None] / (3 + i))
                      + rng.normal(0, 5, (64, 64)), 0, 255).astype(np.uint8)
        name = f"img{i}.png"
        PILImage.fromarray(np.stack([img, img, 255 - img], -1)).save(
            corpus / name)
        names.append(name)
    csvs = [tmp_path / f"shard{k}.csv" for k in (0, 1)]
    argv = [[str(corpus), "module:oavif_tpu_torch", str(c), "--tolerance",
             "40"] for c in csvs]
    rcs, _ = parallel.spawn(measure.shard_rank, 2, args=(argv,),
                            device="cpu", timeout_s=TIMEOUT_S)
    assert rcs == [0, 0]
    assert [r["Image"] for r in _rows(csvs[0])] == [names[0], names[2]]
    assert [r["Image"] for r in _rows(csvs[1])] == [names[1]]
    assert all(r["Status"] == "ok" for c in csvs for r in _rows(c))

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = measure.main([".", "x", str(tmp_path / "merged.csv"), "--merge",
                           *map(str, csvs)])
    assert rc == 0
    assert "Images: 3/3 ok" in out.getvalue()
    assert sorted(r["Image"] for r in _rows(tmp_path / "merged.csv")) == names


def test_shard_from_the_environment(monkeypatch):
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert measure.process_shard() == (1, 3)
    monkeypatch.delenv("RANK")
    assert measure.process_shard() == (0, 1)


@pytest.mark.parametrize("flags", ["-q 60", "-t 70"])
def test_csv_equals_the_reference_harness(corpus, tmp_path, flags):
    """The same corpus through the reference's harness
    (``module:oavif_tpu``) and the port's: the same images, sizes, bytes,
    passes and status."""
    ref_csv, port_csv = tmp_path / "ref.csv", tmp_path / "port.csv"
    r = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "measure.py"), str(corpus),
         f"module:oavif_tpu {flags}", str(ref_csv)],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-500:]
    r = _port(corpus, f"module:oavif_tpu_torch {flags}", port_csv)
    assert r.returncode == 0, r.stderr[-500:]
    keys = ("Image", "Original Bytes", "Final Bytes", "Passes", "Status")
    ref = [{k: row[k] for k in keys} for row in _rows(ref_csv)]
    port = [{k: row[k] for k in keys} for row in _rows(port_csv)]
    assert len(port) == 3
    assert port == ref


def test_corpus_tool_writes_the_bench_classes(tmp_path):
    """``python -m oavif_tpu_torch.scripts.corpus``: the six classes as
    PNG (the harness's corpus on a machine without Pillow), pixel for
    pixel the generators' arrays."""
    from oavif_tpu_torch.io.image import load_png
    from oavif_tpu_torch.scripts import corpus

    assert corpus.main([str(tmp_path), "--size", "96"]) == 0
    images = corpus.bench_images(96)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"{n}.png" for n in corpus.CLASSES)
    for name, rgb in images.items():
        np.testing.assert_array_equal(
            load_png(str(tmp_path / f"{name}.png")).data, rgb)
