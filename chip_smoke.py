#!/usr/bin/env python3
"""Smoke test of oavif_tpu_torch on one NVIDIA GPU (H100, sm_90a).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. card: the ``nvidia-smi`` name and power limit; CUDA must be available;
2. build: the planner and metric kernels with nvcc from
   oavif_tpu_torch/csrc/, one process per source, with the ptxas lines;
3. planner kernel against plain version: the SSD matrix of every grid
   (64, 32, 16), mode set (5, 7, 13) and bit depth (8, 10) on random planes
   and on the six bench classes, and the packed plans built on it, must
   equal the plain PyTorch version on the card exactly; times from CUDA
   events, at 512x512 and at 3840x2160;
4. metric kernels against plain versions: ``ssim2_pyramid``,
   ``ssim2_blur`` and ``ssim2_norms`` scale by scale, and the whole score,
   on the six classes, a random image, 37x53, 8x8 and 3840x2160, at N=1 and
   N=4 candidates; identity must score exactly 100.0 through the kernels
   and a second run must repeat bit for bit; times of one candidate
   batch's score and of each kernel alone at 512x512x4 and 3840x2160x4;
5. main path, the CLI: ``oavif_tpu_torch.cli.run`` with ``-t 80`` and
   ``-q 60`` on the six 512x512 bench classes and one 3840x2160 frame
   written as PAM; each run must exit 0, write an AVIF, launch the planner
   kernel, keep the planner planes on the card, and give the same bytes
   when repeated; the 512x512 runs must give the same bytes as the port's
   CPU path;
6. device metric against the C scorer: within 0.05 on the six classes'
   recons at q 60 and at their ``-t 80`` quality, and on the 3840x2160
   frame at q 60;
7. main path, the corpus pipeline: ``search_encode_corpus`` over the six
   classes with every score on the device (``OAVIF_PIPELINE_METRIC=jax``)
   and at the default (``hybrid`` on CUDA), each run twice: the metric
   kernels must cover every probe in ``jax`` mode and launch in both, the
   planner kernel must launch, the bytes must repeat, every score must lie
   in (0, 100];
8. main path, the batched CLI search: ``-t 80`` with ``OAVIF_METRIC=jax``
   on the 3840x2160 frame must exit 0 and launch the metric kernels.

Each main path runs with every kernel's launch count set to 0 just before
and read just after. The line before the last is a JSON object with each
kernel's launches on the main paths, its largest difference from its plain
version and its times; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX and no Pillow.
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
from oavif_tpu_torch.device import resolve_device
from oavif_tpu_torch.kernels import build
from oavif_tpu_torch.metric import ssimulacra2 as M

CLASSES = ("sinusoid", "fractal", "edges", "oriented", "text", "mixed")
# name -> (wrapper, source, the reference function it replaces)
KERNELS = {
    "planner_mode_ssd": (ET.mode_ssd, "oavif_tpu_torch/csrc/planner.cu",
                         "oavif_tpu/av1/encode_tpu.py:259"),
    "ssim2_pyramid": (M.ssim2_pyramid, "oavif_tpu_torch/csrc/ssimulacra2.cu",
                      "oavif_tpu/metric/ssimulacra2.py:236"),
    "ssim2_blur": (M.ssim2_blur, "oavif_tpu_torch/csrc/ssimulacra2.cu",
                   "oavif_tpu/metric/ssimulacra2.py:332"),
    "ssim2_norms": (M.ssim2_norms, "oavif_tpu_torch/csrc/ssimulacra2.cu",
                    "oavif_tpu/metric/ssimulacra2.py:373"),
}
METRIC_KERNELS = ("ssim2_pyramid", "ssim2_blur", "ssim2_norms")
# kernel against plain version, with the reasons in tests/test_torch_cuda.py
TOL = {"ssim2_pyramid": 2e-6, "ssim2_blur": 1e-5, "ssim2_norms": 1e-9,
       "score": 0.01}


def reset_counts() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: k[0].launches for name, k in KERNELS.items()}


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
    found = re.search(r"Found q(\d+) \(score ([-\d.]+), (\d+) passes"
                      r"(?: in (\d+) rounds)?", log)
    res = {"bytes": data, "wall": wall, "planner": acc["s"],
           "launches": ET.mode_ssd.launches - launches0,
           "devices": {str(t.device) for p in FR.planners() for t in p.dev},
           "q": int(found.group(1)) if found else int(args[1]),
           "score": float(found.group(2)) if found else None,
           "passes": int(found.group(3)) if found else 1,
           "rounds": int(found.group(4)) if found and found.group(4) else 0}
    if res["score"] is not None and not 0.0 < res["score"] <= 100.0:
        raise AssertionError(f"score {res['score']} out of range")
    return res


def phase_main_path(images: dict, acc: dict) -> tuple:
    """The port's CLI on every image; returns the kernels' launch counts
    and each image's ``-t 80`` quality."""
    reset_counts()
    tq = {}
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
                if args[0] == "-t":
                    tq[name] = r["q"]
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
    return read_counts(), tq


def frame_4k() -> np.ndarray:
    """A 3840x2160 photo-like frame: 1/f texture over smooth gradients
    (not a multiple of 64 tall, so the planner crops)."""
    import bench

    fractal = bench._img_fractal(2160, 3840, seed=31).astype(np.float64)
    smooth = bench._img_sinusoid(2160, 3840, seed=37).astype(np.float64)
    return np.clip(0.5 * fractal + 0.5 * smooth, 0, 255).astype(np.uint8)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def noisy_batch(ref: torch.Tensor, sigmas, seed: int) -> torch.Tensor:
    """Candidates (N, H, W, 3) uint8: ref plus Gaussian noise of each
    sigma, drawn on the card from a seed."""
    g = torch.Generator(device=ref.device).manual_seed(seed)
    return torch.stack([
        (ref.float() + s * torch.randn(ref.shape, generator=g,
                                       device=ref.device))
        .round().clamp(0, 255).to(torch.uint8) for s in sigmas])


def metric_case(label: str, ref: torch.Tensor, dist: torch.Tensor) -> dict:
    """Each metric kernel against its plain version on the same inputs,
    scale by scale, then the whole score; identity through the kernels
    must give exactly 100.0 and a second run the same bits. Returns the
    largest differences."""
    h, w = ref.shape[:2]
    n = dist.shape[0]
    worst = dict.fromkeys(TOL, 0.0)
    src1, src2 = ref[None], dist
    for s in range(M._num_scales(h, w)):
        k1, p1 = M.ssim2_pyramid(src1), M.ssim2_pyramid_plain(src1)
        k2, p2 = M.ssim2_pyramid(src2), M.ssim2_pyramid_plain(src2)
        if not (torch.equal(k1[0], p1[0]) and torch.equal(k2[0], p2[0])):
            raise AssertionError(f"{label} N={n} scale {s}: linear RGB of "
                                 "the pyramid kernel != plain")
        worst["ssim2_pyramid"] = max(worst["ssim2_pyramid"],
                                     max_abs(k1[1], p1[1]),
                                     max_abs(k2[1], p2[1]))
        img1, img2 = k1[1], k2[1]
        kb = M.ssim2_blur(img1, None, 8) + M.ssim2_blur(img1, img2, 8)
        pb = (M.ssim2_blur_plain(img1, None, 8)
              + M.ssim2_blur_plain(img1, img2, 8))
        worst["ssim2_blur"] = max(worst["ssim2_blur"],
                                  *(max_abs(a, b) for a, b in zip(kb, pb)))
        planes = (img1, kb[0], kb[1], img2, *kb[2:])
        sums = M.ssim2_norms(*planes)
        if not torch.equal(sums, M.ssim2_norms(*planes)):
            raise AssertionError(f"{label} N={n} scale {s}: norms repeat "
                                 "differs")
        npix = img2.shape[2] * img2.shape[3]
        worst["ssim2_norms"] = max(worst["ssim2_norms"], max_abs(
            M.features_from_sums(sums, npix),
            M.features_from_sums(M.ssim2_norms_plain(*planes), npix)))
        src1, src2 = k1[0], k2[0]
    pyr = M.ssimulacra2_precompute_ref(ref, ref.device)
    got = M.ssimulacra2_from_precomputed(pyr, dist)
    again = M.ssimulacra2_from_precomputed(
        M.ssimulacra2_precompute_ref(ref, ref.device), dist)
    plain = M.ssimulacra2_from_precomputed(
        M.ssimulacra2_precompute_ref(ref, ref.device, M.PLAIN), dist,
        M.PLAIN)
    ident = M.ssimulacra2_from_precomputed(
        pyr, ref[None].expand(n, -1, -1, -1).contiguous())
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label} N={n}: a repeated score differs")
    if not bool((ident == 100.0).all()):
        raise AssertionError(f"{label} N={n}: identity scored "
                             f"{ident.tolist()}, not 100.0")
    worst["score"] = max_abs(got, plain)
    print(f"  {label} N={n}: scores {[round(x, 4) for x in got.tolist()]}; "
          f"max |kernel - plain| pyramid {worst['ssim2_pyramid']:.3g}, "
          f"blur {worst['ssim2_blur']:.3g}, norms {worst['ssim2_norms']:.3g},"
          f" score {worst['score']:.3g}; identity 100.0, repeat identical",
          flush=True)
    for key, tol in TOL.items():
        if worst[key] > tol:
            raise AssertionError(f"{label} N={n}: {key} kernel - plain "
                                 f"{worst[key]} > {tol}")
    return worst


def metric_times(label: str, ref: torch.Tensor, dist: torch.Tensor) -> dict:
    """CUDA-event ms of one candidate batch's score (all scales, the
    reference pyramid precomputed) and of each kernel alone at scale 0,
    kernel against plain version."""
    pyr_k = M.ssimulacra2_precompute_ref(ref, ref.device)
    pyr_p = M.ssimulacra2_precompute_ref(ref, ref.device, M.PLAIN)
    img1, mu1, s11 = (t[None] for t in pyr_k[0])
    img2 = M.ssim2_pyramid(dist)[1]
    dist_stats = M.ssim2_blur(img1, img2, 8)
    planes = (img1, mu1, s11, img2, *dist_stats)
    reps = 5 if ref.numel() > 1 << 22 else 20
    pairs = {
        "score": (lambda: M.ssimulacra2_from_precomputed(pyr_k, dist),
                  lambda: M.ssimulacra2_from_precomputed(pyr_p, dist,
                                                         M.PLAIN)),
        "ssim2_pyramid": (lambda: M.ssim2_pyramid(dist),
                          lambda: M.ssim2_pyramid_plain(dist)),
        "ssim2_blur": (lambda: M.ssim2_blur(img1, img2, 8),
                       lambda: M.ssim2_blur_plain(img1, img2, 8)),
        "ssim2_norms": (lambda: M.ssim2_norms(*planes),
                        lambda: M.ssim2_norms_plain(*planes)),
    }
    times = {}
    for key, (kernel, plain) in pairs.items():
        # plain, kernel, kernel, plain: the mean of each pair
        p0, k0 = cuda_ms(plain, reps), cuda_ms(kernel, reps)
        k1, p1 = cuda_ms(kernel, reps), cuda_ms(plain, reps)
        times[key] = ((k0 + k1) / 2, (p0 + p1) / 2)
        print(f"  {label}x{dist.shape[0]} {key}: kernel "
              f"{times[key][0]:.4f} ms, plain {times[key][1]:.4f} ms",
              flush=True)
    return times


def phase_metric(images: dict, frame4k: np.ndarray) -> dict:
    """The metric kernels against their plain versions on the card."""
    rng = np.random.default_rng(77)
    cases = {f"{name} 512x512": rgb for name, rgb in images.items()}
    cases["random 512x512"] = rng.integers(0, 256, (512, 512, 3),
                                           dtype=np.uint8)
    cases["random 37x53"] = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    cases["random 8x8"] = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    cases["photo 3840x2160"] = frame4k
    worst = dict.fromkeys(TOL, 0.0)
    dists = {}
    for i, (label, rgb) in enumerate(cases.items()):
        ref = torch.from_numpy(rgb).cuda()
        dist = noisy_batch(ref, (1.5, 3.0, 6.0, 12.0), seed=i)
        dists[label] = (ref, dist)
        for n in (1, 4):
            case = metric_case(label, ref, dist[:n])
            worst = {k: max(worst[k], case[k]) for k in worst}
    times = {}
    for label in ("sinusoid 512x512", "photo 3840x2160"):
        times[label] = metric_times(label, *dists[label])
    return {"worst": worst, "times": times}


def make_ctx(rgb: np.ndarray):
    from oavif_tpu.backend import EncCtx
    from oavif_tpu.io.image import Image
    from oavif_tpu.options import EncOptions

    h, w = rgb.shape[:2]
    return EncCtx(o=EncOptions(),
                  src=Image(width=w, height=h, channels=3, hbd=False,
                            data=rgb), rgb=rgb, w=w, h=h)


def phase_vs_c(images: dict, frame4k: np.ndarray, tq: dict) -> float:
    """The device metric (through the kernels) against the C scorer on the
    encoder's recons; returns the largest difference."""
    from oavif_tpu_torch.backend.cuda import CudaBackend
    from oavif_tpu_torch.metric import native

    worst = 0.0
    for name, rgb in [*images.items(), ("photo4k", frame4k)]:
        scorer = M.make_ref_scorer(rgb)
        for q in ((60,) if name == "photo4k" else (60, tq[name])):
            ctx = make_ctx(rgb)
            ctx.q = q
            _, recon = CudaBackend().encode_with_recon(ctx)
            dev = scorer(None, recon)
            c = native.compute_ssimulacra2_native(rgb, recon)
            worst = max(worst, abs(dev - c))
            print(f"  {name} q{q}: device {dev:.4f}, C {c:.4f}, "
                  f"|diff| {abs(dev - c):.4f}", flush=True)
            if abs(dev - c) >= 0.05:
                raise AssertionError(f"{name} q{q}: device metric {dev} vs "
                                     f"C {c}")
    return worst


def phase_corpus(images: dict) -> dict:
    """search_encode_corpus over the six classes, in jax mode and at the
    default, each twice; returns the kernels' launches over the four
    runs."""
    from oavif_tpu_torch.backend.cuda import CudaBackend
    from oavif_tpu_torch.tq import pipeline

    total = dict.fromkeys(KERNELS, 0)
    mpix = sum(rgb.shape[0] * rgb.shape[1] for rgb in images.values()) / 1e6
    for mode in ("jax", None):
        if mode is None:
            os.environ.pop("OAVIF_PIPELINE_METRIC", None)
        else:
            os.environ["OAVIF_PIPELINE_METRIC"] = mode
        runs = []
        try:
            for _ in range(2):
                FR.reset_planners()
                ctxs = [make_ctx(rgb) for rgb in images.values()]
                reset_counts()
                t0 = time.perf_counter()
                out = pipeline.search_encode_corpus(ctxs, CudaBackend())
                wall = time.perf_counter() - t0
                counts = read_counts()
                runs.append((out, counts, wall))
        finally:
            os.environ.pop("OAVIF_PIPELINE_METRIC", None)
        got_mode = pipeline.search_encode_corpus.last_mode
        want_mode = mode or "hybrid"
        if got_mode != want_mode:
            raise AssertionError(f"pipeline mode {got_mode}, not {want_mode}")
        errors = [e for e in pipeline.search_encode_corpus.last_errors if e]
        if errors:
            raise AssertionError(f"pipeline {got_mode}: {errors}")
        (out, counts, wall), (out2, counts2, wall2) = runs
        for name, (r, data), (r2, data2) in zip(images, out, out2):
            if data != data2 or r.q != r2.q:
                raise AssertionError(f"pipeline {got_mode}: {name} repeat "
                                     "differs")
            if not all(0.0 < h.score <= 100.0 for h in r.history):
                raise AssertionError(f"pipeline {got_mode}: {name} scores "
                                     f"{r.history}")
            print(f"  {got_mode} {name}: q{r.q} score {r.score:.4f} passes "
                  f"{r.num_pass} bytes {len(data)}", flush=True)
        passes = sum(r.num_pass for r, _ in out)
        for c in (counts, counts2):
            if min(c.values()) <= 0:
                raise AssertionError(f"pipeline {got_mode}: a kernel did not "
                                     f"launch: {c}")
            # jax mode: every probe's 6 scales, and each image's reference
            if got_mode == "jax" and (
                    c["ssim2_norms"] != 6 * passes
                    or c["ssim2_blur"] != 6 * (passes + len(images))):
                raise AssertionError(f"pipeline jax: launches {c} do not "
                                     f"cover {passes} probes")
        for c in (counts, counts2):
            for k in total:
                total[k] += c[k]
        print(f"pipeline {got_mode}: corpus wall {wall:.3f} s and "
              f"{wall2:.3f} s, {mpix / wall:.3f} and {mpix / wall2:.3f} MP/s, "
              f"{passes} passes, launches {counts}; repeat identical",
              flush=True)
    return total


def phase_batched_cli(frame4k: np.ndarray, acc: dict) -> dict:
    """-t 80 with OAVIF_METRIC=jax (the batched search, scored by the
    metric kernels) on the 3840x2160 frame."""
    os.environ["OAVIF_METRIC"] = "jax"
    try:
        with tempfile.TemporaryDirectory() as td:
            src = os.path.join(td, "photo4k.pam")
            write_pam(src, frame4k)
            reset_counts()
            r = run_cli(["-t", "80"], src, os.path.join(td, "o.avif"), acc)
            counts = read_counts()
    finally:
        del os.environ["OAVIF_METRIC"]
    print(f"batched CLI 3840x2160 -t 80, OAVIF_METRIC=jax: q{r['q']} score "
          f"{r['score']} passes {r['passes']} rounds {r['rounds']} bytes "
          f"{len(r['bytes'])} wall {r['wall']:.3f} s, launches {counts}",
          flush=True)
    if min(counts.values()) <= 0:
        raise AssertionError(f"batched CLI: a kernel did not launch: {counts}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # cuDNN's TF32 off for the plain blur, as on the port's own paths
    resolve_device("cuda")
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
        if any(k in ln for k in ("entry function", "registers", "spill")):
            print(f"  ptxas: {ln.strip()}", flush=True)

    images = bench_images()
    frame4k = frame_4k()
    t0 = time.perf_counter()
    kern = phase_kernel(images, frame4k)
    print(f"phase planner kernel: {time.perf_counter() - t0:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    metric = phase_metric(images, frame4k)
    print(f"phase metric kernels: {time.perf_counter() - t0:.1f} s, worst "
          f"|kernel - plain| {metric['worst']}", flush=True)

    acc = _timed_planner()
    t0 = time.perf_counter()
    launches, tq = phase_main_path({**images, "photo4k": frame4k}, acc)
    print(f"phase main path (CLI): {time.perf_counter() - t0:.1f} s, "
          f"launches {launches}", flush=True)
    if launches["planner_mode_ssd"] <= 0:
        raise AssertionError("the CLI path launched no planner kernel")

    t0 = time.perf_counter()
    worst_c = phase_vs_c(images, frame4k, tq)
    print(f"phase device metric vs C: {time.perf_counter() - t0:.1f} s, "
          f"max |diff| {worst_c:.4f}", flush=True)

    t0 = time.perf_counter()
    for counts in (phase_corpus(images), phase_batched_cli(frame4k, acc)):
        launches = {k: launches[k] + counts[k] for k in launches}
    print(f"phase main path (pipeline, batched CLI): "
          f"{time.perf_counter() - t0:.1f} s, launches on the main paths "
          f"{launches}", flush=True)

    kms, pms = kern["times"]["3840x2160"]
    times = metric["times"]["photo 3840x2160"]
    rows = []
    for name, (_, source, replaces) in KERNELS.items():
        if name == "planner_mode_ssd":
            err, ms, plain_ms = kern["worst"], kms, pms
        else:
            (ms, plain_ms), err = times[name], metric["worst"][name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
