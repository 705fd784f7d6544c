"""The port runs without JAX, without Pillow and without the JAX package.

A subprocess refuses every import of ``jax``, ``jaxlib``, ``PIL``, the
JAX package ``oavif_tpu`` and its ``bench`` through a ``sys.meta_path``
hook, imports every module of ``oavif_tpu_torch`` and ``chip_smoke``'s
module-level code, and runs on a 256x256 PAM on the CPU, with the planner
armed: the port's CLI (target-quality search and fixed q), the CLI's
search with the device metric (``OAVIF_METRIC=jax``), the corpus pipeline
with every score on the device metric (``OAVIF_PIPELINE_METRIC=jax``),
the device encode stage through the Python tile coder (``-q 89`` with
``OAVIF_PY_TILE=1 OAVIF_DEVICE_LEVELS=1``), a score through the recursive
blur (``OAVIF_METRIC_BLUR=iir``), a width-sharded score on two spawned
ranks, the CLI on the same image as an 8-bit PNG, the corpus harness
on two PNGs, the CLI on a JPEG fixture (``tests/torch_fixtures/jpeg``),
the corpus harness on a directory holding a JPEG, ``load_jpeg`` on an
arithmetic-coded progressive fixture with a DAC marker, and the CLI on a
lossy WebP fixture with an alpha plane (``tests/torch_fixtures/webp``),
and, with ``libavif.so.15`` unloadable too (``ctypes.CDLL`` refuses any
library named for libavif), ``load_avif``, ``CudaBackend.decode_to_rgb8``
and the CLI on two AVIF fixtures with an alpha item (the port's 4:4:4
one in ``tests/torch_fixtures/avif`` and libaom's 4:2:0 one in
``tests/torch_fixtures/avif_aom``), all decoded by the port's own C. The
script runs
from a file, so the ranks (spawned processes re-import it) refuse the
same modules. Nothing may import a refused
module. A static check refuses the same imports in the sources.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import ctypes, importlib, importlib.abc, pkgutil, sys

REFUSED = ("jax", "jaxlib", "PIL", "oavif_tpu", "bench")


class NoLibavif(ctypes.CDLL):
    def __init__(self, name, *args, **kwargs):
        if name and "libavif" in str(name):
            raise OSError(f"refused library {name}")
        super().__init__(name, *args, **kwargs)


ctypes.CDLL = NoLibavif
ctypes.cdll = ctypes.LibraryLoader(NoLibavif)


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())


def main():
    import csv
    import os

    import chip_smoke  # noqa: F401  (module-level code only)
    import oavif_tpu_torch
    from oavif_tpu_torch import cli, graft_entry, parallel  # noqa: F401
    from oavif_tpu_torch.av1 import frame, restoration_sharded  # noqa: F401
    from oavif_tpu_torch.backend import EncCtx
    from oavif_tpu_torch.backend.cuda import CudaBackend
    from oavif_tpu_torch.io.image import load_image, to_rgb8
    from oavif_tpu_torch.metric import sharded, ssimulacra2
    from oavif_tpu_torch.options import EncOptions
    from oavif_tpu_torch.tq.pipeline import search_encode_corpus

    for mod in pkgutil.walk_packages(oavif_tpu_torch.__path__,
                                     "oavif_tpu_torch."):
        importlib.import_module(mod.name)

    src, out = sys.argv[1], sys.argv[2]
    assert cli.run(["-t", "80", src, out]) == 0
    assert frame.planners(), "the planner did not arm"
    assert cli.run(["-q", "60", src, out]) == 0
    os.environ["OAVIF_METRIC"] = "jax"
    assert cli.run(["-t", "80", src, out]) == 0
    del os.environ["OAVIF_METRIC"]
    os.environ["OAVIF_PIPELINE_METRIC"] = "jax"
    img = load_image(src)
    rgb = to_rgb8(img)
    (result, data), = search_encode_corpus(
        [EncCtx(o=EncOptions(), src=img, rgb=rgb, w=img.width, h=img.height)],
        CudaBackend())
    assert search_encode_corpus.last_mode == "jax" and len(data) > 100
    assert 0.0 < result.score <= 100.0, result
    del os.environ["OAVIF_PIPELINE_METRIC"]
    os.environ.update(OAVIF_PY_TILE="1", OAVIF_DEVICE_LEVELS="1")
    frame.reset_planners()  # no decisions recorded by the earlier runs
    consumed = frame.lv16_consumed
    assert cli.run(["-q", "89", src, out]) == 0
    assert frame.lv16_consumed > consumed, "no device levels consumed"
    ref = rgb[:128, :256]
    dist = (ref // 8 * 8).astype(ref.dtype)
    fir = ssimulacra2.compute_ssimulacra2(ref, dist)
    assert abs(sharded.compute_ssimulacra2_sharded(
        ref, dist, 2, timeout_s=120) - fir) < 1e-3
    os.environ["OAVIF_METRIC_BLUR"] = "iir"
    iir = ssimulacra2.compute_ssimulacra2(ref, dist)
    assert iir != fir and abs(iir - fir) < 5.0, (iir, fir)
    del os.environ["OAVIF_METRIC_BLUR"]
    png, corpus, csv_path = sys.argv[3], sys.argv[4], sys.argv[5]
    assert cli.run(["-q", "60", png, out]) == 0
    from oavif_tpu_torch.scripts import measure

    assert measure.main([corpus, "module:oavif_tpu_torch -q 60",
                         csv_path]) == 0
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    assert [r["Status"] for r in rows] == ["ok", "ok"], rows
    jpg, jpg_corpus, jpg_csv = sys.argv[6], sys.argv[7], sys.argv[8]
    assert load_image(jpg).icc, "the fixture's ICC profile was lost"
    assert cli.run(["-q", "60", jpg, out]) == 0
    assert measure.main([jpg_corpus, "module:oavif_tpu_torch -q 60",
                         jpg_csv]) == 0
    with open(jpg_csv) as f:
        rows = list(csv.DictReader(f))
    assert [(r["Image"], r["Status"]) for r in rows] == [
        ("photo.jpg", "ok")], rows
    arith, webp = sys.argv[9], sys.argv[10]
    assert load_image(arith).data.shape == (256, 256, 3)
    assert load_image(webp).channels == 4
    assert cli.run(["-q", "60", webp, out]) == 0
    for avif in sys.argv[11:]:
        img = load_image(avif)
        assert img.channels == 4 and not img.hbd
        with open(avif, "rb") as f:
            rgb = CudaBackend().decode_to_rgb8(f.read())
        assert rgb.shape == (img.height, img.width, 3)
        assert (rgb == img.data[..., :3]).all()
        assert cli.run(["-q", "60", avif, out]) == 0
    from oavif_tpu_torch.io import avif_ctypes
    try:
        avif_ctypes._load()
    except OSError:
        pass
    else:
        raise AssertionError("libavif loaded")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not loaded, loaded
    print("NO_JAX_OK")


if __name__ == "__main__":
    main()
"""


def test_port_cli_runs_without_jax_or_pillow(tmp_path):
    sys.path.insert(0, str(REPO))
    from chip_smoke import write_pam, write_png

    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:256, 0:256]
    img = (96 + 60 * np.sin(xx / 11.0)[..., None] * np.cos(yy / 7.0)[..., None]
           + rng.normal(0, 4, (256, 256, 3)))
    src = tmp_path / "in.pam"
    write_pam(src, np.clip(img, 0, 255).astype(np.uint8))
    png = tmp_path / "in.png"
    write_png(png, np.clip(img, 0, 255).astype(np.uint8))
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for i in range(2):
        write_png(corpus / f"img{i}.png",
                  rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    fixtures = REPO / "tests" / "torch_fixtures" / "jpeg"
    jpg_corpus = tmp_path / "jpg_corpus"
    jpg_corpus.mkdir()
    (jpg_corpus / "photo.jpg").write_bytes(
        (fixtures / "text_440.jpg").read_bytes())
    script = tmp_path / "run_without_jax.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, OAVIF_TORCH_DEVICE="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, str(script), str(src), str(tmp_path / "o.avif"),
         str(png), str(corpus), str(tmp_path / "corpus.csv"),
         str(fixtures / "text_icc.jpg"), str(jpg_corpus),
         str(tmp_path / "jpg_corpus.csv"),
         str(fixtures / "text_arith_progressive_dac.jpg"),
         str(REPO / "tests" / "torch_fixtures" / "webp"
             / "text_alpha_q80.webp"),
         str(REPO / "tests" / "torch_fixtures" / "avif"
             / "tool_alpha_q50.avif"),
         str(REPO / "tests" / "torch_fixtures" / "avif_aom"
             / "rgba_420.avif")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert (tmp_path / "o.avif").read_bytes()[4:12] == b"ftypavif"


def test_port_sources_do_not_import_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|oavif_tpu|bench)\b", re.M)
    files = sorted((REPO / "oavif_tpu_torch").rglob("*.py"))
    assert files
    for path in files + [REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
