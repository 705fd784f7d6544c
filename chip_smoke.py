#!/usr/bin/env python3
"""Smoke test of oavif_tpu_torch on one NVIDIA GPU (H100, sm_90a).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. card: the ``nvidia-smi`` name and power limit; CUDA must be available;
2. build: the planner kernel with nvcc from oavif_tpu_torch/csrc/;
3. kernel against plain version: the SSD matrix of every grid (64, 32,
   16), mode set (5, 7, 13) and bit depth (8, 10) on random planes and on
   the six bench classes, and the packed plans built on it, must equal the
   plain PyTorch version on the card exactly; times from CUDA events, at
   512x512 and at 3840x2160;
4. main path: ``oavif_tpu_torch.cli.run`` with ``-t 80`` and ``-q 60`` on
   the six 512x512 bench classes and one 3840x2160 frame written as PAM;
   each run must exit 0, write an AVIF, launch the planner kernel, keep the
   planner planes on the card, and give the same bytes when repeated; the
   512x512 runs must give the same bytes as the port's CPU path.

The line before the last is a JSON object with the kernel's launches on
the main path, its largest difference from the plain version and its
times; the last line is ``{"ok": true, "device": {...}}``. Imports nothing
of JAX and no Pillow.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from oavif_tpu_torch import cli
from oavif_tpu_torch.av1 import encode_tpu as ET
from oavif_tpu_torch.av1 import frame as FR
from oavif_tpu_torch.kernels import build

KERNEL_SOURCE = "oavif_tpu_torch/csrc/planner.cu"
REPLACES = "oavif_tpu/av1/encode_tpu.py:259"
CLASSES = ("sinusoid", "fractal", "edges", "oriented", "text", "mixed")


def write_pam(path: str, rgb: np.ndarray) -> None:
    """Write an (h, w, 3) uint8 image as a Netpbm PAM (P7) file."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\n"
                f"TUPLTYPE RGB\nENDHDR\n".encode())
        f.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())


def bench_images(size: int = 512) -> dict:
    """The six bench classes at size x size (bench.py's generators)."""
    import bench

    return {name: getattr(bench, f"_img_{name}")(size, size)
            for name in CLASSES}


def yuv_planes(rgb: np.ndarray, bitdepth: int):
    from oavif_tpu.av1.encode import _depth_convert
    from oavif_tpu.av1.yuv import rgb_to_yuv444

    return rgb_to_yuv444(_depth_convert(rgb, False, bitdepth),
                         bitdepth=bitdepth)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() in ms, from CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plan_ssd(dev, bitdepth: int, nmodes: int, ssd):
    """The five SSD calls of one plan_device step."""
    y, u, v = dev
    sby, sbx = (y.shape[0] - 1) // 64, (y.shape[1] - 1) // 64
    base = 1 << (bitdepth - 1)
    return [ssd(y, sby, sbx, 64, base, ET.N_MODES),
            ssd(y, 2 * sby, 2 * sbx, 32, base, ET.N_MODES),
            ssd(y, 4 * sby, 4 * sbx, 16, base, nmodes),
            ssd(u, sby, sbx, 64, base, 1), ssd(v, sby, sbx, 64, base, 1)]


def device_planes(planes, bitdepth: int):
    h, w = planes[0].shape
    return [torch.from_numpy(ET.pad_plane(p, h // 64, w // 64, bitdepth))
            .cuda() for p in planes]


def phase_kernel(images: dict, frame4k: np.ndarray) -> dict:
    """Kernel against plain version on the card; returns the worst
    difference and the per-plan times at 512^2 and 4K."""
    rng = np.random.default_rng(2024)
    worst = 0
    cases = 0
    t_kernel = t_plain = 0.0
    for bitdepth in (8, 10):
        base = 1 << (bitdepth - 1)
        sources = {"random": [rng.integers(0, 1 << bitdepth, (512, 512))
                              for _ in range(3)]}
        sources.update({k: yuv_planes(v, bitdepth)
                        for k, v in images.items()})
        for name, planes in sources.items():
            dev = device_planes(planes, bitdepth)
            y = dev[0]
            for P in (64, 32, 16):
                nb = 512 // P
                for nmodes in (5, 7, 13):
                    got = ET.mode_ssd(y, nb, nb, P, base, nmodes)
                    want = ET.mode_ssd_plain(y, nb, nb, P, base, nmodes)
                    torch.cuda.synchronize()
                    diff = int((got - want).abs().max())
                    worst = max(worst, diff)
                    if diff:
                        raise AssertionError(
                            f"kernel != plain: {name} {bitdepth}-bit P{P} "
                            f"nmodes {nmodes}, max |diff| {diff}")
                    kms = cuda_ms(lambda: ET.mode_ssd(y, nb, nb, P, base,
                                                      nmodes))
                    pms = cuda_ms(lambda: ET.mode_ssd_plain(y, nb, nb, P,
                                                            base, nmodes))
                    t_kernel += kms
                    t_plain += pms
                    cases += 1
            for nmodes in (5, 7, 13):
                for duel in (0, 1, 2):
                    for q in (40, 88, 120):
                        a = ET.plan_device(*dev, q, bitdepth, nmodes, duel)
                        b = ET.plan_device(*dev, q, bitdepth, nmodes, duel,
                                           ssd=ET.mode_ssd_plain)
                        if not torch.equal(a, b):
                            raise AssertionError(
                                f"packed plan kernel != plain: {name} "
                                f"{bitdepth}-bit nmodes {nmodes} duel {duel} "
                                f"q {q}")
    print(f"kernel == plain on {cases} SSD cases and {cases // 9 * 27} "
          f"packed plans; sum of per-case times: kernel "
          f"{t_kernel:.3f} ms, plain {t_plain:.3f} ms", flush=True)

    times = {}
    for label, rgb in (("512x512 sinusoid", images["sinusoid"]),
                       ("3840x2160", frame4k)):
        dev = device_planes(yuv_planes(rgb, 10), 10)
        got = plan_ssd(dev, 10, 13, ET.mode_ssd)
        want = plan_ssd(dev, 10, 13, ET.mode_ssd_plain)
        for g, w in zip(got, want):
            worst = max(worst, int((g - w).abs().max()))
        if worst:
            raise AssertionError(f"kernel != plain at {label}")
        kms = cuda_ms(lambda: plan_ssd(dev, 10, 13, ET.mode_ssd), reps=10)
        pms = cuda_ms(lambda: plan_ssd(dev, 10, 13, ET.mode_ssd_plain),
                      reps=10)
        full_k = cuda_ms(lambda: ET.plan_device(*dev, 100, 10), reps=10)
        full_p = cuda_ms(lambda: ET.plan_device(
            *dev, 100, 10, ssd=ET.mode_ssd_plain), reps=10)
        times[label] = (kms, pms)
        print(f"{label} 10-bit, nmodes 13: one plan's 5 SSD launches "
              f"kernel {kms:.4f} ms, plain {pms:.4f} ms; whole plan_device "
              f"kernel {full_k:.4f} ms, plain {full_p:.4f} ms", flush=True)
    return {"worst": worst, "times": times}


def _timed_planner():
    """Accumulate the host wall time of planner creation and planning."""
    acc = {"s": 0.0}
    get_planner, plan = FR.get_planner, ET.FramePlanner.plan

    def timed_get(*a, **k):
        t0 = time.perf_counter()
        try:
            return get_planner(*a, **k)
        finally:
            acc["s"] += time.perf_counter() - t0

    def timed_plan(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return plan(self, *a, **k)
        finally:
            acc["s"] += time.perf_counter() - t0

    FR.get_planner = timed_get
    ET.FramePlanner.plan = timed_plan
    return acc


def run_cli(args, src: str, out: str, acc: dict) -> dict:
    FR.reset_planners()
    launches0 = ET.mode_ssd.launches
    acc["s"] = 0.0
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.run(args + [src, out])
    wall = time.perf_counter() - t0
    log = err.getvalue()
    if rc != 0:
        raise AssertionError(f"cli.run({args}) on {src} exited {rc}:\n{log}")
    with open(out, "rb") as f:
        data = f.read()
    if data[4:12] != b"ftypavif":
        raise AssertionError(f"{out} has no ftyp/avif header")
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes", log)
    res = {"bytes": data, "wall": wall, "planner": acc["s"],
           "launches": ET.mode_ssd.launches - launches0,
           "devices": {str(t.device) for p in FR.planners() for t in p.dev},
           "q": int(found.group(1)) if found else int(args[1]),
           "score": float(found.group(2)) if found else None,
           "passes": int(found.group(3)) if found else 1}
    if res["score"] is not None and not 0.0 < res["score"] <= 100.0:
        raise AssertionError(f"score {res['score']} out of range")
    return res


def phase_main_path(images: dict) -> int:
    """The port's CLI on every image; returns the kernel's launch count."""
    acc = _timed_planner()
    ET.mode_ssd.launches = 0
    with tempfile.TemporaryDirectory() as td:
        for name, rgb in images.items():
            src = os.path.join(td, f"{name}.pam")
            write_pam(src, rgb)
            for args in (["-t", "80"], ["-q", "60"]):
                out = os.path.join(td, f"{name}.avif")
                runs = [run_cli(args, src, out, acc) for _ in range(2)]
                for r in runs:
                    if r["launches"] <= 0:
                        raise AssertionError(
                            f"{name} {args}: planner kernel not launched")
                    if r["devices"] != {"cuda:0"}:
                        raise AssertionError(
                            f"{name} {args}: planner planes on "
                            f"{r['devices']}")
                if runs[0]["bytes"] != runs[1]["bytes"]:
                    raise AssertionError(f"{name} {args}: repeat differs")
                r = runs[0]
                line = (f"{name} {rgb.shape[1]}x{rgb.shape[0]} "
                        f"{' '.join(args)}: q{r['q']} score {r['score']} "
                        f"passes {r['passes']} bytes {len(r['bytes'])} "
                        f"wall {r['wall']:.3f} s, planner "
                        f"{r['planner']:.3f} s "
                        f"({100 * r['planner'] / r['wall']:.1f}%), "
                        f"launches {r['launches']}")
                if rgb.shape[0] <= 512:
                    os.environ["OAVIF_TORCH_DEVICE"] = "cpu"
                    try:
                        cpu = run_cli(args, src, out, acc)
                    finally:
                        del os.environ["OAVIF_TORCH_DEVICE"]
                    if cpu["bytes"] != r["bytes"]:
                        raise AssertionError(
                            f"{name} {args}: CUDA and CPU paths differ")
                    line += "; == CPU path"
                print(line, flush=True)
    return ET.mode_ssd.launches


def frame_4k() -> np.ndarray:
    """A 3840x2160 photo-like frame: 1/f texture over smooth gradients
    (not a multiple of 64 tall, so the planner crops)."""
    import bench

    fractal = bench._img_fractal(2160, 3840, seed=31).astype(np.float64)
    smooth = bench._img_sinusoid(2160, 3840, seed=37).astype(np.float64)
    return np.clip(0.5 * fractal + 0.5 * smooth, 0, 255).astype(np.uint8)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for ln in build.build_log.splitlines():
        if "registers" in ln or "smem" in ln.lower():
            print(f"  ptxas: {ln.strip()}", flush=True)

    images = bench_images()
    frame4k = frame_4k()
    t0 = time.perf_counter()
    kern = phase_kernel(images, frame4k)
    print(f"phase kernel: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    launches = phase_main_path({**images, "photo4k": frame4k})
    print(f"phase main path: {time.perf_counter() - t0:.1f} s, planner "
          f"kernel launches {launches}", flush=True)
    if launches <= 0:
        raise AssertionError("the main path launched no planner kernel")

    kms, pms = kern["times"]["3840x2160"]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "planner_mode_ssd", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": kern["worst"],
        "ms": kms, "plain_ms": pms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
