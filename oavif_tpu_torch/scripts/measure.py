"""Corpus harness of the port; the counterpart of the repository's
``scripts/measure.py``, with its arguments, CSV schema and summary:

    python -m oavif_tpu_torch.scripts.measure [--tolerance T] [--keep] \
        [--shard K/N] [--resume] [--window N] images_dir encoder output_csv
    python -m oavif_tpu_torch.scripts.measure . x merged.csv --merge a.csv b.csv

- collects *.png / *.jpg / *.jpeg (sorted) from images_dir;
- encodes each through ``encoder``: a command (a binary and its flags),
  or ``module:oavif_tpu_torch`` and its flags to run the port's CLI in
  this process; it times each run and scrapes "<N> pass(es)" from the
  encoder's stderr;
- ``--window N`` (``module:oavif_tpu_torch`` only) runs N images' searches
  at once through ``tq.pipeline.search_encode_corpus``, the device worker
  scoring and planning for one image while the host encodes another;
- writes one CSV row per image (``FIELDS``), checkpointed after every
  image or window (``--resume`` skips the images already ok), and prints
  the summary: throughput, overall and geomean savings, time and pass
  dispersion.

Scale-out: ``--shard K/N`` takes images[K::N] of the sorted corpus.
Without it, a process in an initialised ``torch.distributed`` group takes
its rank and the world size as K and N, and failing that ``RANK`` and
``WORLD_SIZE`` from the environment (``torchrun``'s). Each shard writes
its own CSV; ``--merge`` concatenates shard CSVs and reprints the
summary. ``shard_rank`` is the body for ranks started by
``oavif_tpu_torch.parallel.spawn``.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

PASS_RE = re.compile(r"(\d+)\s+pass(?:es)?")
MODULE = "module:oavif_tpu_torch"
FIELDS = ["Image", "Original Bytes", "Final Bytes", "Savings Bytes",
          "Savings %", "Encoding Time (ms)", "Passes", "Status", "Error"]


def parse_pass_count(stderr_text: str):
    m = None
    for m in PASS_RE.finditer(stderr_text):
        pass
    return int(m.group(1)) if m else None


def _row(in_path: Path) -> dict:
    return {"Image": in_path.name, "Original Bytes": in_path.stat().st_size,
            "Final Bytes": "", "Savings Bytes": "", "Savings %": "",
            "Encoding Time (ms)": "", "Passes": "", "Status": "ok",
            "Error": ""}


def _set_result(row: dict, final: int, elapsed_ms: float, passes) -> None:
    row["Final Bytes"] = final
    row["Savings Bytes"] = row["Original Bytes"] - final
    row["Savings %"] = round(
        100.0 * (row["Original Bytes"] - final) / row["Original Bytes"], 2)
    row["Encoding Time (ms)"] = round(elapsed_ms, 1)
    row["Passes"] = passes if passes is not None else ""


def encode_one(enc_cmd, tolerance, in_path: Path, out_path: Path) -> dict:
    """Run one encode; returns its CSV row."""
    row = _row(in_path)
    args = list(enc_cmd)
    if tolerance is not None:
        args += ["--tolerance", str(tolerance)]
    args += [str(in_path), str(out_path)]
    t0 = time.time()
    try:
        if args[0] == MODULE:
            from ..cli import run as cli_run

            buf = io.StringIO()
            with contextlib.redirect_stderr(buf):
                rc = cli_run(args[1:])
            stderr_text = buf.getvalue()
            if rc != 0:
                raise RuntimeError(f"exit {rc}: {stderr_text.strip()[-200:]}")
        else:
            proc = subprocess.run(args, capture_output=True, text=True)
            stderr_text = proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"exit {proc.returncode}: {stderr_text.strip()[-200:]}")
        _set_result(row, out_path.stat().st_size, (time.time() - t0) * 1000,
                    parse_pass_count(stderr_text))
    except Exception as e:  # a failed image is a row, as in the reference
        row["Status"] = "error"
        row["Error"] = str(e)[:200]
    return row


def encode_window(enc_cmd, tolerance, images, out_dir: Path, keep: bool):
    """Pipelined in-process encode of one window of images
    (``tq.pipeline``): an image's time is its own host encode time; the
    corpus wall is what the overlap improves (printed by summarize). The
    flags after ``module:oavif_tpu_torch`` go through the CLI's parser."""
    from ..backend import EncCtx
    from ..backend.cuda import CudaBackend
    from ..io.image import load_image, to_rgb8
    from ..options import OptionError, parse_args as parse_opts
    from ..tq.pipeline import search_encode_corpus

    flags = list(enc_cmd[1:])
    if tolerance is not None:
        flags += ["--tolerance", str(tolerance)]

    rows, ctxs, live = [], [], []
    for img in images:
        row = _row(img)
        rows.append(row)
        try:
            parsed = parse_opts(flags + [str(img), str(img) + ".avif"])
            src = load_image(str(img))
            rgb = to_rgb8(src)
            ctxs.append(EncCtx(o=parsed.options, src=src, rgb=rgb,
                               w=src.width, h=src.height))
            live.append(row)
        except (OptionError, OSError, ValueError) as e:
            row["Status"] = "error"
            row["Error"] = str(e)[:200]

    results = search_encode_corpus(ctxs, CudaBackend())
    host_s = search_encode_corpus.last_host_s
    errors = search_encode_corpus.last_errors
    for row, (res, data), hs, err in zip(live, results, host_s, errors):
        if res is None:
            row["Status"] = "error"
            row["Error"] = (err or "search failed")[:200]
            continue
        out_path = out_dir / (Path(row["Image"]).stem + ".avif")
        with open(out_path, "wb") as f:
            f.write(data)
        _set_result(row, len(data), hs * 1000, res.num_pass)
        if not keep and out_path.exists():
            out_path.unlink()
    return rows


def summarize(rows, wall_s):
    ok = [r for r in rows if r["Status"] == "ok"]
    print(f"\nImages: {len(ok)}/{len(rows)} ok in {wall_s:.1f}s "
          f"({len(ok) / wall_s:.2f} images/s)" if wall_s > 0 else "")
    if not ok:
        return
    in_bytes = sum(r["Original Bytes"] for r in ok)
    out_bytes = sum(r["Final Bytes"] for r in ok)
    print(f"Throughput: {in_bytes / wall_s / 1e6:.2f} MB/s in, "
          f"{out_bytes / wall_s / 1e6:.2f} MB/s out")
    overall = 100.0 * (in_bytes - out_bytes) / in_bytes
    ratios = [r["Final Bytes"] / r["Original Bytes"] for r in ok
              if r["Original Bytes"]]
    geo = 100.0 * (1.0 - math.exp(sum(math.log(x) for x in ratios)
                                  / len(ratios)))
    print(f"Savings: overall {overall:.2f}%, geomean {geo:.2f}%")
    times = [r["Encoding Time (ms)"] for r in ok
             if r["Encoding Time (ms)"] != ""]
    if times:
        sd = statistics.stdev(times) if len(times) > 1 else 0.0
        print(f"Time (ms): mean {statistics.mean(times):.1f}, "
              f"median {statistics.median(times):.1f}, stddev {sd:.1f}")
    passes = [r["Passes"] for r in ok if r["Passes"] != ""]
    if passes:
        sd = statistics.stdev(passes) if len(passes) > 1 else 0.0
        print(f"Passes: mean {statistics.mean(passes):.2f}, stddev {sd:.2f}, "
              f"min {min(passes)}, max {max(passes)}")


def _read_rows(path) -> list:
    """A CSV's rows with the numeric fields parsed back."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        for k in ("Original Bytes", "Final Bytes", "Savings Bytes"):
            r[k] = int(r[k]) if r[k] else ""
        r["Encoding Time (ms)"] = (float(r["Encoding Time (ms)"])
                                   if r["Encoding Time (ms)"] else "")
        r["Passes"] = int(r["Passes"]) if r["Passes"] else ""
    return rows


def _write_rows(path, rows) -> None:
    with open(path, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=FIELDS)
        wr.writeheader()
        wr.writerows(rows)


def process_shard():
    """(K, N) of this process: its rank and the world size in an
    initialised torch.distributed group, else ``RANK`` and ``WORLD_SIZE``
    from the environment, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank, world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if rank is not None and world is not None:
        return int(rank), int(world)
    return 0, 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("images_dir")
    ap.add_argument("oavif_path", help=f"encoder command, or {MODULE} "
                                       "for in-process")
    ap.add_argument("output_csv")
    ap.add_argument("--tolerance", type=float, default=None)
    ap.add_argument("--keep", action="store_true",
                    help="keep the encoded AVIF files")
    ap.add_argument("--shard", default=None,
                    help="K/N static corpus shard (defaults to the "
                         "torch.distributed rank and world size)")
    ap.add_argument("--resume", action="store_true",
                    help="skip images already present as ok rows in the "
                         "output CSV")
    ap.add_argument("--merge", nargs="*", default=None,
                    help="merge shard CSVs given as arguments instead of "
                         "encoding (images_dir/oavif_path ignored)")
    ap.add_argument("--window", type=int, default=0,
                    help=f"pipeline this many images' searches at once "
                         f"({MODULE} only); 0 = sequential")
    args = ap.parse_args(argv)

    if args.merge is not None:
        rows = [r for path in args.merge for r in _read_rows(path)]
        _write_rows(args.output_csv, rows)
        times = [r["Encoding Time (ms)"] for r in rows
                 if r["Status"] == "ok" and r["Encoding Time (ms)"] != ""]
        summarize(rows, sum(times) / 1000 if times else 1.0)
        return 0

    images = sorted(p for p in Path(args.images_dir).iterdir()
                    if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    if args.shard:
        shard_k, shard_n = (int(x) for x in args.shard.split("/"))
    else:
        shard_k, shard_n = process_shard()
    images = images[shard_k::shard_n]
    if not images:
        print("no images in shard", file=sys.stderr)
        return 1

    rows = []
    if args.resume and Path(args.output_csv).exists():
        rows = [r for r in _read_rows(args.output_csv) if r["Status"] == "ok"]
        done = {r["Image"] for r in rows}
        images = [p for p in images if p.name not in done]
        print(f"resume: {len(rows)} done, {len(images)} remaining",
              file=sys.stderr)

    enc_cmd = args.oavif_path.split()
    out_dir = Path(args.output_csv).parent
    t0 = time.time()
    if args.window > 1 and enc_cmd[0] == MODULE:
        for i in range(0, len(images), args.window):
            rows += encode_window(enc_cmd, args.tolerance,
                                  images[i : i + args.window], out_dir,
                                  args.keep)
            _write_rows(args.output_csv, rows)  # checkpoint every window
    else:
        for img in images:
            out_path = out_dir / (img.stem + ".avif")
            rows.append(encode_one(enc_cmd, args.tolerance, img, out_path))
            if not args.keep and out_path.exists():
                out_path.unlink()
            _write_rows(args.output_csv, rows)  # checkpoint every image
    wall_s = time.time() - t0
    _write_rows(args.output_csv, rows)
    summarize(rows, wall_s)
    return 0


def shard_rank(rk, argv_by_rank) -> int:
    """Rank body for ``parallel.spawn``: ``main`` with this rank's
    arguments (each rank writes its own CSV), its shard taken from the
    process group."""
    return main(list(argv_by_rank[rk.rank]))


if __name__ == "__main__":
    sys.exit(main())
