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
blur (``OAVIF_METRIC_BLUR=iir``) and a width-sharded score on two spawned
ranks. The script runs from a file, so the ranks (spawned processes
re-import it) refuse the same modules. Nothing may import a refused
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
import importlib, importlib.abc, pkgutil, sys

REFUSED = ("jax", "jaxlib", "PIL", "oavif_tpu", "bench")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())


def main():
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
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not loaded, loaded
    print("NO_JAX_OK")


if __name__ == "__main__":
    main()
"""


def test_port_cli_runs_without_jax_or_pillow(tmp_path):
    sys.path.insert(0, str(REPO))
    from chip_smoke import write_pam

    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:256, 0:256]
    img = (96 + 60 * np.sin(xx / 11.0)[..., None] * np.cos(yy / 7.0)[..., None]
           + rng.normal(0, 4, (256, 256, 3)))
    src = tmp_path / "in.pam"
    write_pam(src, np.clip(img, 0, 255).astype(np.uint8))
    script = tmp_path / "run_without_jax.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, OAVIF_TORCH_DEVICE="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, str(script), str(src), str(tmp_path / "o.avif")],
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
