"""Host time of the AV1 decoder's inter tile decode with its two block
inter-prediction loops, against a build that routes every inter part
through the scaled loop (``predict_scaled`` at xScale = yScale = 1 << 14).

Builds the port's host library twice into a temporary directory from the
checkout's sources: as shipped, and with ``predict_part``'s test
``ref_is_scaled(d, ref)`` replaced by 1. Both decode the same samples
(``tests/test_torch_avif_progressive.py`` holds the scaled loop at scale 1
to the unscaled one), so only the time differs. Each round reads the file
once with each build, in the order A B B A, and the script prints one JSON
line per file: the minimum and median ``tiles_f<i>`` ms of each build over
all rounds, and the ratio of the minima.

    python -m oavif_tpu_torch.scripts.time_inter_pred [--rounds 5] \
        [tests/torch_fixtures/avif_layers/photo4k_420.avif ...]
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
DEFAULT = "tests/torch_fixtures/avif_layers/photo4k_420.avif"
ROUTE = "    if (ref_is_scaled(d, ref)) {\n        predict_scaled("


def _builds(td: Path) -> dict:
    """The host library as shipped (``unscaled``) and with every inter
    part through ``predict_scaled`` (``scaled``), each loaded through
    ``fast._build`` with its own source and output path."""
    from oavif_tpu_torch.av1.entropy import fast

    src, so = fast._SRC_AV1, fast._SO
    text = src.read_text()
    if text.count(ROUTE) != 1:
        raise SystemExit("predict_part's route to predict_scaled not found")
    libs = {}
    for name, body in (("unscaled", text),
                       ("scaled", text.replace(
                           ROUTE, "    if (1) {\n        predict_scaled("))):
        d = td / name
        d.mkdir()
        (d / src.name).write_text(body)
        shutil.copy(src.parent / "av1_header.h", d)
        fast._SRC_AV1, fast._SO = d / src.name, d / "liboavif_host.so"
        fast._lib, fast._build_failed = None, False
        libs[name] = fast.get_lib()
        if libs[name] is None:
            raise SystemExit(f"the {name} build failed")
    fast._SRC_AV1, fast._SO = src, so
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="*", default=[DEFAULT])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)

    from oavif_tpu_torch.av1.entropy import fast
    from oavif_tpu_torch.io import avif

    with tempfile.TemporaryDirectory() as td:
        libs = _builds(Path(td))
        for path in args.files:
            data = (ROOT / path).read_bytes()
            ms = {"unscaled": [], "scaled": []}
            for _ in range(args.rounds):
                for name in ("unscaled", "scaled", "scaled", "unscaled"):
                    fast._lib, t = libs[name], {}
                    avif.read_avif(data, t)
                    ms[name].append({k: v * 1e3 for k, v in t.items()
                                     if k.startswith("tiles_f")})
            keys = sorted(ms["unscaled"][0])
            out = {"file": path, "rounds": args.rounds}
            for k in keys:
                for name in ms:
                    v = [m[k] for m in ms[name]]
                    out[f"{k}_{name}_min_ms"] = round(min(v), 3)
                    out[f"{k}_{name}_median_ms"] = round(float(np.median(v)), 3)
                out[f"{k}_scaled_over_unscaled"] = round(
                    out[f"{k}_scaled_min_ms"] / out[f"{k}_unscaled_min_ms"], 4)
            print(json.dumps(out), flush=True)
    fast._lib = None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
