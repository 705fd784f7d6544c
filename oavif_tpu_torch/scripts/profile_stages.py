"""Per-stage wall time of the port's target-quality search; the
counterpart of the repository's ``scripts/profile_stages.py``.

Wraps the hot stages of the port with timers, under the reference tool's
labels and one more, ``metric-host`` (the host C scorer that the default
CLI search scores with), runs ``tq.driver.search_encode`` with
``CudaBackend`` on each image after one warm-up search, and prints the
reference's text breakdown and, per image, one JSON line: ms and calls
per label, the wall, q, passes and bytes.

    python -m oavif_tpu_torch.scripts.profile_stages [--size 512] \
        [--classes sinusoid,fractal,...] [--speed 9]

Stages nest (``TOTAL-frame-encode`` holds ``C-tile-encode`` and the
planner's); ``outer_ms`` sums the time spent in a labelled stage entered
from outside every other one, so ``wall_ms - outer_ms`` is the time no
label covers. Under the batched search several encodes run on threads at
once, and the labels' sums may exceed the wall.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time
from collections import defaultdict

LABELS = ("rgb->yuv", "yuv->rgb(recon)", "chroma-dq-analysis", "loopfilter",
          "cdef-search", "cdef-apply", "obu-assemble", "mux",
          "TOTAL-frame-encode", "C-tile-encode", "planner.plan",
          "planner.init(upload)", "metric-batch", "metric-host")
NESTED_IN_FRAME = ("C-tile-encode", "planner.plan", "planner.init(upload)")


class StageTimers:
    """Seconds and calls per label, and the seconds of the outermost
    labelled calls (``outer``), accumulated by the wrappers that
    ``installed`` puts in place."""

    def __init__(self):
        self.acc = defaultdict(float)
        self.cnt = defaultdict(int)
        self.outer = 0.0
        self._lock = threading.Lock()
        self._depth = threading.local()

    def reset(self) -> None:
        with self._lock:
            self.acc.clear()
            self.cnt.clear()
            self.outer = 0.0

    def timed(self, fn, label: str):
        def wrapper(*a, **k):
            depth = getattr(self._depth, "n", 0)
            self._depth.n = depth + 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                self._depth.n = depth
                with self._lock:
                    self.acc[label] += dt
                    self.cnt[label] += 1
                    if depth == 0:
                        self.outer += dt

        return wrapper

    def snapshot(self):
        with self._lock:
            return dict(self.acc), dict(self.cnt), self.outer


def _targets():
    """(owner, attribute, label) of every wrapped stage: each function is
    patched where its caller looks it up."""
    from ..av1 import encode as enc
    from ..av1 import encode_tpu
    from ..av1.entropy import fast
    from ..metric import native, ssimulacra2
    from ..tq import driver

    return [
        (enc, "rgb_to_yuv444", "rgb->yuv"),
        (enc, "yuv444_to_rgb", "yuv->rgb(recon)"),
        (enc, "_chroma_delta_q", "chroma-dq-analysis"),
        (enc, "loop_filter_frame", "loopfilter"),
        (enc, "_pick_cdef", "cdef-search"),
        (enc, "cdef_frame", "cdef-apply"),
        (enc, "assemble_av1_stream", "obu-assemble"),
        (enc, "mux_avif", "mux"),
        (enc, "encode_frame_planes", "TOTAL-frame-encode"),
        # frame.py imports it at call time
        (fast, "tile_encode_native", "C-tile-encode"),
        (encode_tpu.FramePlanner, "plan", "planner.plan"),
        (encode_tpu.FramePlanner, "__init__", "planner.init(upload)"),
        # native.score_batch_auto imports it at call time
        (ssimulacra2, "compute_ssimulacra2_batch", "metric-batch"),
        (native, "compute_ssimulacra2_native", "metric-host"),
        (driver, "compute_ssimulacra2_native", "metric-host"),
    ]


@contextlib.contextmanager
def installed(timers: StageTimers):
    """The stage wrappers in place for the block; the originals after."""
    saved = []
    try:
        for owner, name, label in _targets():
            fn = owner.__dict__[name]
            saved.append((owner, name, fn))
            setattr(owner, name, timers.timed(fn, label))
        yield timers
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def _ctx(rgb, speed: int):
    from ..backend import EncCtx
    from ..io.image import Image
    from ..options import EncOptions

    h, w = rgb.shape[:2]
    return EncCtx(o=EncOptions(speed=speed),
                  src=Image(width=w, height=h, channels=3, hbd=False,
                            data=rgb), rgb=rgb, w=w, h=h)


def profile(images: dict, speed: int = 9) -> list:
    """Profile one search per image (name -> (h, w, 3) uint8), after a
    one-pass warm-up search on the first flipped (so that no cache holds
    its planes); returns one dict per image."""
    from ..av1 import frame
    from ..backend.cuda import CudaBackend
    from ..device import resolve_device
    from ..tq.driver import search_encode

    device = resolve_device()
    backend = CudaBackend()
    timers = StageTimers()
    out = []
    with installed(timers):
        warm = _ctx(next(iter(images.values()))[::-1].copy(), speed)
        warm.o.max_pass = 1
        search_encode(warm, backend)
        for name, rgb in images.items():
            frame.reset_planners()  # each image plans afresh
            timers.reset()
            ctx = _ctx(rgb, speed)
            t0 = time.perf_counter()
            res, data = search_encode(ctx, backend)
            if device.type == "cuda":
                import torch

                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            acc, cnt, outer = timers.snapshot()
            out.append({
                "image": name, "size": f"{rgb.shape[1]}x{rgb.shape[0]}",
                "speed": speed, "device": device.type,
                "wall_ms": wall * 1e3, "outer_ms": outer * 1e3,
                "q": res.q, "score": res.score, "passes": ctx.num_pass,
                "bytes": len(data),
                "ms": {k: acc.get(k, 0.0) * 1e3 for k in LABELS},
                "calls": {k: cnt.get(k, 0) for k in LABELS}})
    return out


def report(rows: list) -> None:
    """The reference tool's text per image, then its JSON line."""
    for r in rows:
        ms = r["ms"]
        print(f"\n[{r['image']} {r['size']}, speed {r['speed']}, "
              f"{r['device']}] wall={r['wall_ms']:.0f}ms q={r['q']} "
              f"score={r['score']:.2f} passes={r['passes']} "
              f"bytes={r['bytes']}")
        for k in sorted(ms, key=lambda k: -ms[k]):
            if ms[k] >= 0.5:
                ind = "" if k == "TOTAL-frame-encode" else "  "
                print(f"  {ind}{k:24s} {ms[k]:9.1f}ms")
        inner = sum(ms[k] for k in NESTED_IN_FRAME)
        print(f"    {'frame-py-overhead':24s} "
              f"{ms['TOTAL-frame-encode'] - inner:9.1f}ms")
        print(f"    {'unaccounted':24s} "
              f"{r['wall_ms'] - r['outer_ms']:9.1f}ms")
        print(json.dumps(r), flush=True)


def main(argv=None) -> int:
    from .corpus import CLASSES, bench_images

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--classes", default=",".join(CLASSES),
                    help="comma-separated bench classes")
    ap.add_argument("--speed", type=int, default=9)
    args = ap.parse_args(argv)
    classes = [c for c in args.classes.split(",") if c]
    unknown = set(classes) - set(CLASSES)
    if unknown:
        ap.error(f"unknown classes {sorted(unknown)}; known: {CLASSES}")
    report(profile(bench_images(args.size, classes), args.speed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
