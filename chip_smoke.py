#!/usr/bin/env python3
"""Smoke test of oavif_tpu_torch on one NVIDIA GPU (H100, sm_90a).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. card: the ``nvidia-smi`` name and power limit; CUDA must be available;
2. build: every kernel with nvcc from oavif_tpu_torch/csrc/, one process
   per source, with the ptxas lines; then the host µs of each piece of the
   kernels' launch path (``launch_pieces``);
3. planner kernels against plain version: the fused plan
   (``planner_plan``, K1) must equal ``plan_device_plain`` exactly, both
   with the plain SSD and with the first planner kernel's five SSD launches
   (``planner_mode_ssd``, kept as the yardstick; no path may launch it),
   for every mode set (5, 7, 13), duel level and q of 40, 88, 90, 91 and
   120, at both bit depths, on random planes and on the six bench classes,
   and on the 3840x2160 frame; the yardstick's SSD matrix of every grid
   must equal the plain SSD; CUDA-event times of one plan, fused, old path
   and plain in turns, at 512x512 and at 3840x2160;
4. metric kernels against plain versions: ``ssim2_pyramid``,
   ``ssim2_blur``, ``ssim2_norms`` and ``ssim2_blur_norms`` (the
   distorted side's blur and norms fused, K2d's redesign) scale by scale,
   and the whole score, on the six classes, a random image, 37x53, 8x8 and
   3840x2160, at N=1 and N=4 candidates; ``ssim2_blur`` must also equal
   ``ssim2_blur_simple`` (the first blur kernel, kept as the exact
   yardstick) bit for bit, and ``ssim2_blur_norms`` the pair it replaces,
   ``ssim2_norms`` over ``ssim2_blur``'s maps, within rtol 1e-10, and
   repeat bit for bit; ptxas must report no spill for it;
   identity must score exactly 100.0 through the kernels and a second run
   must repeat bit for bit; times of one candidate batch's score and of
   each kernel alone at 512x512x4 and 3840x2160x4, the blur beside the
   simple kernel in the same call, and both at radius 0, 5 and 8, the
   fused kernel beside the pair in turns; the score's bound, the sum of
   its launches' bounds (``score_bound``), and the same before the fusion;
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
   kernels must cover every probe in ``jax`` mode and launch in both (the
   candidates through ``ssim2_blur_norms``, never ``ssim2_norms``), the
   planner kernel must launch, the bytes must repeat, every score must lie
   in (0, 100];
8. main path, the batched CLI search: ``-t 80`` with ``OAVIF_METRIC=jax``
   on the 3840x2160 frame must exit 0 and launch the metric kernels;
9. encode-stage kernels against plain versions: ``dstage_coeffs16`` (K3a)
   within 1e-6 * max|c| of the block + 1e-3 and bit for bit the first K3a
   kernel (``dstage_coeffs16_simple``, kept as the yardstick; no path may
   launch it), and ``dstage_quant16`` (K3b) bit for bit its plain version
   and the first K3b kernel (``dstage_quant16_simple``, the yardstick),
   levels and eob, at qindex 30, 60 and 90 at once and singly, on the six
   classes' and the 3840x2160 frame's 10-bit planes with their plan's modes
   and with random modes, on crafted edges (``quant_cases``), at k = 1, 2,
   3 and 5 quantizers and at 1, 3 and 5 blocks; levels off 16-byte
   alignment must raise, and ptxas must report no spills for K3b;
   CUDA-event times at 3840x2160 of K3a, its yardstick, K3b (1, 2 and 3
   quantizers), its yardstick and their plain versions, each kernel's
   device ms from a ``torch.profiler`` trace and host µs a call
   (``split_times``), and the host wall time of the levels fetch, with the
   same bytes copied into pageable and into page-locked memory in turns;
10. main path, the device encode stage: the CLI with ``OAVIF_PY_TILE=1
   OAVIF_DEVICE_LEVELS=1``, ``-q 89`` on the six classes and ``-t 80`` on
   fractal; the coder must consume device levels and K3a, K3b and the
   planner must launch; every probe's levels are also computed with the
   plain versions on the card, and none may differ by more than 1 or at
   more than 4 positions of a block;
11. recursive blur: ``ssim2_blur_iir`` (K2e) against its plain version, bit
   for bit, on the six classes' and the 3840x2160 frame's scale-0 XYB
   planes at N=1 and N=4, with CUDA-event times at 512x512x4 and
   3840x2160x4 beside the bytes bound, the time of the design's eight
   accesses per element at the memory rate, and each pass's time from a
   ``torch.profiler`` trace; then the main path, the CLI with
   ``OAVIF_METRIC=jax OAVIF_METRIC_BLUR=iir`` and ``-t 80`` on the six
   classes, which must launch it. Thread timing moves that search's bytes
   and sometimes its q, so each class runs again with the rounds'
   candidates encoded in turn, and that run is held to its q, passes and
   bytes;
12. multi-device (ranks spawned by ``oavif_tpu_torch.parallel``, joined by
   gloo over CUDA tensors, sharing the one card): the width-sharded metric
   (K4) on the 3840x2160 frame over 4 ranks and over 2, each slice's blur
   planes bit for bit the single-device kernel's columns and within the
   blur's tolerance of the plain halo blur, the score within 1e-3 of the
   single-device score, with ms per sharded score and, from a run that
   times every all_reduce alone, that run's ms and its all_reduce share;
   the width-sharded Wiener filter (K5, kernel
   ``wiener_bands``) on three 3840x2160 10-bit planes over 4 ranks, equal
   to the host filter and to its plain version, and on one rank's launch
   bit for bit the first Wiener kernel (``wiener_bands_simple``, kept as
   the yardstick; no path may launch it), with kernel, yardstick and plain
   times, the kernel's device ms and host µs a call, and the host filter's
   wall time; the dry run (K6)
   ``dryrun_multichip`` at 2 and 4 ranks with the reference's shapes, and
   on the 3840x2160 frame as 4 tile columns (one rank each), whose
   seeded-plan encode must give the unsharded bytes with seeded plans
   consumed; and the sharded metric at 1 rank under NCCL;
13. main path, 8-bit PNG input: the six classes and the 3840x2160 frame
   written as PNG with the package's writer (``scripts/corpus.py``) decode
   to the source's pixels exactly, and the CLI (``-t 80`` on the classes,
   ``-q 60`` on the frame) gives the q, passes and bytes of the same image
   read from PAM in phase 5;
14. main path, the corpus harness (``scripts/measure.py``) over the six
   classes as PNG: sequential ``module:oavif_tpu_torch``, ``--window 6``
   with every score on the device (``OAVIF_PIPELINE_METRIC=jax``), and two
   ranks sharing the card (``parallel.spawn``, gloo) that take their shards
   from the process group, then ``--merge``; every CSV's Final Bytes and
   Passes must be the CLI's of phase 5, and whether they are PERF.md §5's
   table is printed, with each mode's corpus wall and MP/s;
15. main path, JPEG input: every fixture of ``tests/torch_fixtures/jpeg``
   (baseline, progressive, restart markers, 4:4:4 to 4:1:1, gray, CMYK,
   YCCK, multi-chunk ICC, arithmetic-coded sequential and progressive
   with DAC conditioning, block-smoothed progressive) and of
   ``tests/torch_fixtures/jpeg_lossless`` (lossless, SOF3: predictors,
   point transforms, restarts, subsampling, CMYK) decodes with the port's
   own C to its manifest's shape and CRC32s (libjpeg-turbo's pixels,
   through Pillow when the fixtures were made), each read timed (median
   of 5); a 3840x2160 lossless RGB file written here by the numpy writer
   decodes to its source exactly (timed, median of 5); the CLI (``-t 80``
   on the six class JPEGs and the 512x512 lossless class, ``-q 60`` on
   the 3840x2160 one) gives the q, passes and bytes of the decoded pixels
   written as PAM, and the harness, sequential over the six class JPEGs,
   the CLI's bytes and passes;
16. main path, WebP input: every fixture of ``tests/torch_fixtures/webp``
   (lossy, lossless, alpha planes raw and filtered, token partitions,
   segments, both loop filters, near-lossless, an animation) decodes with
   the port's own C to its manifest's shape and CRC32 (libwebp's pixels,
   through Pillow when the fixtures were made), each read timed (median
   of 5); the CLI (``-t 80`` on the six class WebPs, ``-q 60`` on the
   3840x2160 one) gives the q, passes and bytes of the decoded pixels
   written as PAM;
17. the stage profile (``scripts/profile_stages.py``) of ``-t 80`` on the
   six classes and the 3840x2160 frame, its text and JSON lines; q must be
   the CLI's;
18. decode, on this machine without libavif or Pillow: each class at its
   ``-t 80`` q, the 3840x2160 frame at q 60 (in one tile and in four), and
   one stream per tool (filter intra at speed 8, Wiener and SGR at speed
   5, IDTX under ``--tune ssim``, palette on ``text``, lossless, 8-bit
   output, alpha lossless and at ``--quality-alpha 50``, 64-pixel
   superblocks), encoded by ``CudaBackend``, decode with the port's own
   AVIF reader (``io/avif.py``, ``io/av1_decode.c``) to exactly the
   recon's Y'UV, the recon's conversion of those planes to exactly the
   recon RGB, and a lossless alpha item to the source's alpha;
   ``decode_to_rgb8``'s distance from the recon RGB is printed;
19. main path, AVIF input: every fixture of ``tests/torch_fixtures/avif``
   (the port's toolset, written by the JAX package's CLI) decodes to its
   manifest's CRC32s (dav1d's Y'UV and the reference's ``load_avif`` and
   ``decode_avif_to_rgb8`` pixels), each file decoded as often as its
   read is timed (once; split into parse and tile decode, post-filters
   and conversion), each folder's reads in all on a line; each refusal
   fixture (4:2:0, 4:2:2, the intra edge filter) raises ``ValueError``
   naming its tool; likewise libaom's streams of ``avif_aom``,
   ``avif_tools``, ``avif_screen``, ``avif_container``,
   ``avif_superres`` (superres and non-uniform tiles), ``avif_lf_seg``,
   ``avif_gainmap``, ``avif_layers``, ``avif_ispe``,
   ``avif_progressive`` (later layers predicted from a layer of another
   size, superres inter frames; a reference past the scaling limits must
   raise ``OSError`` with the manifest's message), ``avif_warp`` and
   ``avif_refmvs`` (motion field estimation and temporal MV candidates in
   four layers), ``avif_compound`` (compound blocks) and
   ``avif_globalmv`` (global motion of every type and skip_mode blocks;
   its 3840x2160 frame read three times), the reads split into parse,
   post-filters, the superres upscale, grain and conversion (and per
   frame, tile decode, post-filters, the projection, the compound blends
   and the global warp);
   the CLI (``-t 80`` on the six class AVIFs, ``-q 60`` on the 3840x2160
   one, and on each later folder's picks) gives the q, passes and bytes
   of the same pixels (as PAM where they are 8-bit, in memory where they
   are 16-bit);
20. ``OAVIF_TRACE``: the CLI ``-t 80`` on edges and mixed under it, each
   run in a process of its own as a user runs it, must exit 0, print the
   reference's line, write one Chrome trace holding the planner kernel's
   device records (their count beside its launches) and give the
   untraced bytes; walls with and without the trace;
21. ``OAVIF_TRACE`` over the corpus harness, which runs both searches in
   one process: first under kineto's default CUPTI teardown
   (``TEARDOWN_CUPTI=1``), then as users run it; each trace's planner
   records beside its image's launches, and in the second run every trace
   must hold some;
22. planner trace: device kernels per plan of the old path and of the
   fused kernel, and the fused kernel's own device time, from one
   ``torch.profiler`` trace per size (512x512 and 3840x2160), last.

Every kernel row's time is split into its device ms (the kernel alone,
from a ``torch.profiler`` trace, or from CUDA events around each C entry
call where six traces in a row lost the kernel's records, in which case
each pass of K2e goes unsplit) and its host µs a call (the median of 200
calls, each timed alone after a synchronise), the latter through
``kernels.launch``, through ``launch_before`` (a copy of the launch path
as it was before it kept its resolved entries) and with nothing launched
(the wrapper's checks and allocations), in turns; phase 2 also times each
piece of the launch path alone.

Each main path runs with every kernel's launch count set to 0 just before
and read just after (the yardsticks' counts, ``YARDSTICKS``, must still be
0 then: no path launches them); spawned ranks report the
launches of their sharded runs apart from their checks' and timings'
(``kernels.counting``), which are added. The line before the last is a
JSON object with each kernel's launches on the main paths, its largest
difference from its plain version, its times at 3840x2160 (CUDA-event ms,
device ms and host µs a call), its bound
(bytes over the HBM rate or operations over the float32 rate, the larger;
the planner's integer operations over the rates of the integer pipes) and one PyTorch
call's time where one computes the same function; the last line is
``{"ok": true, "device": {...}}``. Prints its total time before them.
Imports nothing of JAX, nothing of the JAX package and no Pillow.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import functools
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from oavif_tpu_torch import cli, graft_entry, parallel, shard_checks
from oavif_tpu_torch.av1 import device_stage as DS
from oavif_tpu_torch.av1 import restoration_sharded as WS
from oavif_tpu_torch.av1 import encode_tpu as ET
from oavif_tpu_torch.av1 import frame as FR
from oavif_tpu_torch.av1.encode import _depth_convert
from oavif_tpu_torch.av1.yuv import rgb_to_yuv444, yuv444_to_rgb
from oavif_tpu_torch.device import resolve_device
from oavif_tpu_torch.av1.restoration import (_band_rows, _coeffs7,
                                             apply_wiener, count_units,
                                             unit_size)
from oavif_tpu_torch.kernels import build, count_launch, kernel_key, launch
from oavif_tpu_torch.metric import sharded as MS
from oavif_tpu_torch.metric import ssimulacra2 as M
from oavif_tpu_torch.scripts.corpus import (CLASSES, _img_edges,  # noqa: F401
                                            _img_fractal, _img_mixed,
                                            _img_oriented, _img_sinusoid,
                                            _img_text, bench_images,
                                            write_pam, write_png)

# name -> (wrapper, source, the reference function it replaces)
KERNELS = {
    "planner_plan": (ET.plan_device, "oavif_tpu_torch/csrc/planner.cu",
                     "oavif_tpu/av1/encode_tpu.py:259"),
    "ssim2_pyramid": (M.ssim2_pyramid, "oavif_tpu_torch/csrc/ssimulacra2.cu",
                      "oavif_tpu/metric/ssimulacra2.py:236"),
    "ssim2_blur": (M.ssim2_blur, "oavif_tpu_torch/csrc/ssimulacra2.cu",
                   "oavif_tpu/metric/ssimulacra2.py:332"),
    "ssim2_norms": (M.ssim2_norms, "oavif_tpu_torch/csrc/ssimulacra2.cu",
                    "oavif_tpu/metric/ssimulacra2.py:373"),
    "ssim2_blur_norms": (M.ssim2_blur_norms,
                         "oavif_tpu_torch/csrc/ssimulacra2.cu",
                         "oavif_tpu/metric/ssimulacra2.py:464"),
    "dstage_coeffs16": (DS.coeffs16, "oavif_tpu_torch/csrc/device_stage.cu",
                        "oavif_tpu/av1/device_stage.py:68"),
    "dstage_quant16": (DS.quant16, "oavif_tpu_torch/csrc/device_stage.cu",
                       "oavif_tpu/av1/device_stage.py:83"),
    "ssim2_blur_iir": (M.ssim2_blur_iir,
                       "oavif_tpu_torch/csrc/ssimulacra2.cu",
                       "oavif_tpu/metric/ssimulacra2.py:309"),
    "wiener_bands": (WS.wiener_bands, "oavif_tpu_torch/csrc/wiener.cu",
                     "oavif_tpu/av1/restoration_sharded.py:57"),
}
# what the names of each kernel's CUDA functions hold, and no other's
KERNEL_MATCH = {"planner_plan": "plan_kernel", "ssim2_pyramid": "pyramid_",
                "ssim2_blur": "blur_kernel", "ssim2_norms": "norms_",
                "ssim2_blur_norms": "blur_sums_",
                "dstage_coeffs16": "coeffs16_kernel",
                "dstage_quant16": "quant16_kernel",
                "ssim2_blur_iir": "iir_", "wiener_bands": "wiener_kernel"}
# the metric kernels of the paths that score on the device under the
# Gaussian: the reference side's blur, the candidates' fused blur and norms
METRIC_KERNELS = ("ssim2_pyramid", "ssim2_blur", "ssim2_blur_norms")
# the kernels of the CLI, pipeline and batched-search paths
SEARCH_KERNELS = ("planner_plan", *METRIC_KERNELS)
# the wrappers of the yardstick kernels, which no path may launch
YARDSTICKS = (M.ssim2_blur_simple, ET.mode_ssd, DS.coeffs16_simple,
              DS.quant16_simple, WS.wiener_bands_simple)
# each kernel's yardstick, by its C entry, for the kernels line
YARDSTICK_OF = {"planner_plan": "planner_mode_ssd",
                "ssim2_blur": "ssim2_blur_simple",
                "dstage_coeffs16": "dstage_coeffs16_simple",
                "dstage_quant16": "dstage_quant16_simple",
                "wiener_bands": "wiener_bands_simple"}
LEVEL_KERNELS = ("dstage_coeffs16", "dstage_quant16")
LEVEL_QS = (30, 60, 90)
# the card the encode-stage phases run on (a CPU rehearsal may set it)
DEVICE = torch.device("cuda")
# NVIDIA H100 SXM data-sheet peaks: HBM bytes/s and float32 operations/s
# outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# 32-bit integer rates of the H100 SXM at its 1.98 GHz boost clock: the
# CUDA C++ Programming Guide's throughput table gives compute capability 9.0
# 64 results a clock per SM for integer add, shift, compare, logic and
# multiply-add alike. IMAD issues to the FMA pipe and the rest (IADD3,
# LEA, SHF, IABS, ISETP, SEL) to the ALU pipe, which run side by side
# (Jia et al., "Dissecting the NVIDIA Volta / Turing GPU architecture via
# microbenchmarking", 2018-2019; not measured on Hopper here), and each of
# the four schedulers of an SM issues one warp instruction a clock. So a
# mix takes at least the largest of its ALU operations over the ALU rate,
# its IMADs over the FMA-pipe rate and all of them over the issue rate.
INT_ALU_OPS_S = 132 * 64 * 1.98e9
INT_IMAD_OPS_S = 132 * 64 * 1.98e9
ISSUE_OPS_S = 132 * 128 * 1.98e9
# (ALU, IMAD) operations that each planner mode needs at one pixel, counted
# in its formula (oavif_tpu_torch/av1/encode_tpu.py _predictions,
# csrc/planner.cu base_preds) with every term that is constant along a row
# or a column of the block hoisted out and merged instructions counted
# once, the SSD's difference (IADD) and square-and-add (IMAD) included:
# DC, V, H (1, 1); SMOOTH beside SMOOTH_V and SMOOTH_H adds their two
# numerators and shifts (3, 1), alone it is 2 IMADs and a shift (2, 3);
# PAETH |a + (l - 2 cr)|, 3 comparisons, 2 selects, |a - cr| a column's
# constant (8, 1); SMOOTH_V wr*a + row constant, SMOOTH_H wc*(l - right)
# + row constant, each an IMAD and a shift (2, 2); a directional mode
# w0*e0 + 16 and + w1*e1 in 2 IMADs and a shift (2, 3).
PLAN_MODE_OPS = ((1, 1), (1, 1), (1, 1), (3, 1), (8, 1), (2, 2), (2, 2)) \
    + ((2, 3),) * 6
PLAN_SMOOTH_ALONE = (2, 3)
# kernel against plain version, with the reasons in tests/test_torch_cuda.py
TOL = {"ssim2_pyramid": 2e-6, "ssim2_blur": 1e-5, "ssim2_norms": 1e-9,
       "score": 0.01}
# ssim2_blur_norms against the pair it replaces (the same float32 maps, the
# float64 sums in another order): rtol, atol 0; and its features against
# its plain version's, whose blur sums the taps in cuDNN's order: the
# tolerance of tests/test_torch_metric.py's features, atol per feature
# [d, artifact, detail, d^4, artifact^4, detail^4] plus rtol
PAIR_RTOL = 1e-10
FUSED_ATOL = (1e-5, 1e-6, 1e-6, 1e-5, 1e-6, 1e-6)
FUSED_RTOL = 1e-3


def reset_counts() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    for wrapper in YARDSTICKS:
        wrapper.launches = 0


def read_counts() -> dict:
    """Every kernel's launches since ``reset_counts``; the yardstick
    kernels are on no path, so their counts must still be 0."""
    for wrapper in YARDSTICKS:
        if wrapper.launches:
            raise AssertionError(f"a path launched {wrapper.__name__} "
                                 f"{wrapper.launches} times")
    return {name: k[0].launches for name, k in KERNELS.items()}


def rank_counts(counts) -> dict:
    """The launches that spawned ranks report (``parallel.spawn``), added up
    per kernel of KERNELS."""
    total = parallel.sum_counts(counts)
    for wrapper in YARDSTICKS:
        if total.get(kernel_key(wrapper), 0):
            raise AssertionError(f"a rank launched {wrapper.__name__}")
    return {name: total.get(kernel_key(k[0]), 0)
            for name, k in KERNELS.items()}


def add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def scored_fused(counts: dict, path: str) -> None:
    """A path that scores on the device under the Gaussian must score its
    candidates through ssim2_blur_norms and launch no ssim2_norms."""
    if counts["ssim2_blur_norms"] <= 0 or counts["ssim2_norms"] != 0:
        raise AssertionError(f"{path}: candidates not scored by the fused "
                             f"kernel alone: launches {counts}")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: float, ops: float, ops_s: float = F32_OPS_S,
          ops_by: str = "operations") -> dict:
    """The least time of a function on the card: the larger of its bytes
    (each input read once, each output written once) over the HBM rate and
    its operations over their rate (float32 unless ``ops_s`` says
    otherwise; ``ops_by`` names it when it bounds)."""
    t_bytes, t_ops = moved / HBM_BYTES_S * 1e3, ops / ops_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else ops_by}


def yuv_planes(rgb: np.ndarray, bitdepth: int):
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
    """The five SSD calls of one plan_device_plain step."""
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


def plan_ops(dev, nmodes: int) -> tuple:
    """The (ALU, IMAD) integer operations one plan's formulas need: every
    luma pixel of the full SBs under 7 modes at 64 and 32 and ``nmodes`` at
    16, and every chroma pixel under DC (PLAN_MODE_OPS)."""
    px = (dev[0].shape[0] - 1) * (dev[0].shape[1] - 1)
    alu = imad = 0
    for n in (ET.N_MODES, ET.N_MODES, nmodes, 1, 1):
        ops = list(PLAN_MODE_OPS[:n])
        if 3 < n < ET.N_MODES:  # SMOOTH without SMOOTH_V and SMOOTH_H
            ops[3] = PLAN_SMOOTH_ALONE
        alu += sum(a for a, _ in ops)
        imad += sum(m for _, m in ops)
    return px * alu, px * imad


def plan_bound(dev, out) -> dict:
    """K1's bound: the larger of its bytes over the HBM rate and its
    integer operations over the rates of the pipes they issue to."""
    alu, imad = plan_ops(dev, ET.N_MODES_DIR)
    t_ops = max(alu / INT_ALU_OPS_S, imad / INT_IMAD_OPS_S,
                (alu + imad) / ISSUE_OPS_S)
    return bound(nbytes(*dev, out), t_ops, 1.0, "int32")  # t_ops in s


def ptxas_of(kernel: str) -> list:
    """The ptxas lines (registers, shared memory, spills) of every
    instantiation of ``kernel`` in this process's build (none when the
    library was up to date)."""
    out, on = [], False
    for ln in build.build_log.splitlines():
        if "Compiling entry function" in ln:
            on = kernel in ln
        if on and any(k in ln for k in ("entry function", "registers",
                                         "spill")):
            out.append(ln.strip())
    return out


def phase_kernel(images: dict, frame4k: np.ndarray) -> dict:
    """The planner kernels against the plain version on the card; returns
    the fused plan's worst difference from the plain plan and one plan's
    times at 512^2 and 4K."""
    plan = KERNELS["planner_plan"][0]
    rng = np.random.default_rng(2024)
    worst = 0
    cases = plans = 0
    t_kernel = t_plain = 0.0

    def hold(dev, bitdepth, nmodes, duel, q, label):
        nonlocal worst
        got = plan(*dev, q, bitdepth, nmodes, duel)
        for ssd in (ET.mode_ssd_plain, ET.mode_ssd):
            want = ET.plan_device_plain(*dev, q, bitdepth, nmodes, duel,
                                        ssd=ssd)
            diff = int((got - want).abs().max())
            worst = max(worst, diff)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"packed plan planner_plan != plan_device_plain(ssd="
                    f"{ssd.__name__}): {label} {bitdepth}-bit nmodes "
                    f"{nmodes} duel {duel} q {q}, max |diff| {diff}")

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
                    for q in (40, 88, 90, 91, 120):
                        hold(dev, bitdepth, nmodes, duel, q, name)
                        plans += 1
    print(f"planner_mode_ssd == plain on {cases} SSD cases (sum of "
          f"per-case times: kernel {t_kernel:.3f} ms, plain {t_plain:.3f} "
          f"ms); planner_plan == plan_device_plain with the plain SSD and "
          f"with planner_mode_ssd on {plans} packed plans", flush=True)
    for ln in ptxas_of("plan_kernel"):
        print(f"  planner_plan ptxas: {ln}", flush=True)

    times = {}
    for label, rgb in (("512x512 sinusoid", images["sinusoid"]),
                       ("3840x2160", frame4k)):
        dev = device_planes(yuv_planes(rgb, 10), 10)
        for nmodes in (5, 7, 13):
            for duel in (0, 1, 2):
                for q in (40, 88, 90, 91, 120):
                    hold(dev, 10, nmodes, duel, q, label)
        ssd_k = cuda_ms(lambda: plan_ssd(dev, 10, 13, ET.mode_ssd), reps=10)
        runs = {
            "plain": lambda: ET.plan_device_plain(*dev, 100, 10),
            "old": lambda: ET.plan_device_plain(*dev, 100, 10,
                                                ssd=ET.mode_ssd),
            "fused": lambda: plan(*dev, 100, 10)}
        # plain, old, fused, fused, old, plain: the mean of each pair
        order = ("plain", "old", "fused", "fused", "old", "plain")
        got = dict.fromkeys(runs, 0.0)
        for key in order:
            got[key] += cuda_ms(runs[key], reps=10) / 2
        out = plan(*dev, 100, 10)
        times[label] = {"ms": got["fused"], "plain_ms": got["plain"],
                        "simple_ms": got["old"], "library_ms": None,
                        **plan_bound(dev, out),
                        **split_times(runs["fused"],
                                      KERNEL_MATCH["planner_plan"])}
        t = times[label]
        alu, imad = plan_ops(dev, 13)
        print(f"{label} 10-bit, nmodes 13, q 100: one plan, planner_plan "
              f"{t['ms']:.4f} ms, old path (5 planner_mode_ssd launches "
              f"{ssd_k:.4f} ms + torch epilogue) {t['simple_ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}: {nbytes(*dev, out)} bytes, {alu} ALU and "
              f"{imad} IMAD integer operations); {split_line(t)}",
              flush=True)
    return {"worst": worst, "times": times}


def phase_plan_trace(images: dict, frame4k: np.ndarray) -> None:
    """Device kernels per plan of the old path and of the fused kernel, and
    the fused kernel's own device time, from one ``torch.profiler`` trace
    per size. Runs last, so that it adds no trace before those that other
    phases check."""
    from torch.autograd import DeviceType

    plan, reps = KERNELS["planner_plan"][0], 10
    for label, rgb in (("512x512 sinusoid", images["sinusoid"]),
                       ("3840x2160", frame4k)):
        dev = device_planes(yuv_planes(rgb, 10), 10)

        def both():
            plan(*dev, 100, 10)
            ET.plan_device_plain(*dev, 100, 10, ssd=ET.mode_ssd)

        prof = trace(both, reps)
        on_card = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        n_fused = sum("plan_kernel" in e.name for e in on_card)
        fused_us = [e.device_time_total for e in prof.key_averages()
                    if e.device_time_total > 0 and "plan_kernel" in e.key]
        ms = sum(fused_us) / 1e3 / max(n_fused, 1)
        print(f"{label}: device kernels per plan from a torch.profiler "
              f"trace, planner_plan {n_fused / reps:g}, old path "
              f"{(len(on_card) - n_fused) / reps:g}; planner_plan's kernel "
              f"alone {ms:.4f} ms"
              + ("" if n_fused == reps else
                 f" (the trace holds {n_fused} of its {reps} launches)"),
              flush=True)


def trace(fn, reps: int):
    """A ``torch.profiler`` trace of ``reps`` calls of fn(), taken after a
    warm-up step of as many calls that the profiler traces and discards:
    on the card a trace without one has lost the records of its first
    milliseconds, once all of them (``main`` also keeps CUPTI attached
    between sessions, which ended such losses in a stress run)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


# the suffix of a key of ``device_ms_by_kernel`` timed by CUDA events
BY_EVENTS = " (CUDA events)"


def device_ms_by_kernel(fn, reps: int, match: str, names: int = 1) -> dict:
    """{kernel name: mean device ms per launch} of the kernels whose name
    holds ``match``, over ``reps`` calls of fn(), from a ``torch.profiler``
    trace; a trace that holds fewer than ``names`` such kernels, as one on
    the card sometimes does (none three times in a row once, after the
    multi-device leg's ranks; one of K2e's two passes once), is taken
    again after a second's pause, up to six in all. If all six lost them
    (none, once, in ``phase_iir``), the device time comes from CUDA events
    instead (``device_ms_by_entry``), keyed by C entry."""
    for attempt in range(6):
        if attempt:
            torch.cuda.synchronize()
            time.sleep(1.0)
        got = {ev.key: ev.device_time_total / 1e3 / ev.count
               for ev in trace(fn, reps).key_averages()
               if ev.device_time_total > 0 and match in ev.key}
        if len(got) >= names:
            return got
    got = device_ms_by_entry(fn, reps)
    print(f"  six torch.profiler traces held fewer than {names} kernels "
          f"holding {match!r}: device time from CUDA events, {got}",
          flush=True)
    return got


def device_ms_by_entry(fn, reps: int) -> dict:
    """{C entry + BY_EVENTS: mean device ms per launch} over ``reps`` calls
    of fn() after one call of warm-up, from a CUDA event pair recorded on
    the launch's stream around each call of ``kernels.launch``: the device
    time of the entry's kernels, whatever fn() runs between them, plus the
    host's time to launch them where the device waits for it (a 0.012 ms
    plan read 0.030 ms so on an H100; the 0.32 ms ``ssim2_blur_iir`` at
    512x512x4 within 0.01 ms of its trace)."""
    pairs: dict = {}

    def timed(wrapper, entry, tensor, *args):
        stream = torch.cuda.current_stream(tensor.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        launch(wrapper, entry, tensor, *args)
        end.record(stream)
        pairs.setdefault(entry, []).append((start, end))

    fn()
    torch.cuda.synchronize()
    with launched_by(timed):
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    return {entry + BY_EVENTS: sum(s.elapsed_time(e) for s, e in got)
            / len(got) for entry, got in pairs.items()}


def launch_before(wrapper, entry: str, tensor, *args) -> None:
    """``kernels.launch`` as it was before it kept its resolved entries:
    ``build.load()``'s lock and a ``getattr`` on the library at every call,
    the device context entered at every call, the current device's stream.
    Kept here only to time the launch path before and after in one call."""
    fn = getattr(build.load(), entry)
    with torch.cuda.device(tensor.device):
        rc = fn(*args,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    count_launch(wrapper)


def no_launch(wrapper, entry: str, tensor, *args) -> None:
    """A launch path that launches nothing: a wrapper called through it
    costs its checks and allocations alone."""


# the modules whose kernel wrappers call ``launch``
WRAPPER_MODULES = (DS, WS, M, ET)


@contextlib.contextmanager
def launched_by(path):
    """Every kernel wrapper launches through ``path`` inside the block."""
    saved = [mod.launch for mod in WRAPPER_MODULES]
    for mod in WRAPPER_MODULES:
        mod.launch = path
    try:
        yield
    finally:
        for mod, fn in zip(WRAPPER_MODULES, saved):
            mod.launch = fn


def host_us(fn, calls: int = 200) -> float:
    """Median host microseconds of one call of fn(), each call timed alone
    after a synchronise: a call returns once its kernels are enqueued, so
    this is the host's cost whatever the kernel's."""
    ts = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(ts)) * 1e6


def split_times(fn, match: str, reps: int = 20, names: int = 1) -> dict:
    """One wrapper call fn() split into device and host: ``device_ms``, the
    device time of its kernels (those whose names hold ``match``, each
    kernel's mean per launch, added up; ``names`` kernels at least) from a
    ``torch.profiler`` trace of ``reps`` calls; ``host_us``, the median host µs of a call through
    ``kernels.launch``; ``host_us_before``, the same through
    ``launch_before``; ``checks_us``, the same with nothing launched (the
    wrapper's checks and allocations). The three host paths run in turns,
    new, old, none, none, old, new, and each gives the mean of its pair."""
    paths = {"host_us": launch, "host_us_before": launch_before,
             "checks_us": no_launch}
    got = dict.fromkeys(paths, 0.0)
    for key in ("host_us", "host_us_before", "checks_us", "checks_us",
                "host_us_before", "host_us"):
        with launched_by(paths[key]):
            got[key] += host_us(fn) / 2
    # the trace last, so that no profiler state is left over the host times
    per = device_ms_by_kernel(fn, reps, match, names)
    if not per:
        raise AssertionError(f"no kernel holding {match!r} in the trace")
    return {"device_ms": sum(per.values()), **got}


def simple_text(t: dict) -> str:
    """The yardstick kernel's times in a time row, for the log."""
    if "simple_device_ms" not in t:
        return ""
    return (f", yardstick kernel {t['simple_ms']:.4f} ms (device "
            f"{t['simple_device_ms']:.4f} ms)")


def launch_pieces() -> None:
    """Host µs of each piece of ``kernels.launch`` alone, the mean of 20000
    calls: the raw stream lookup (and the Stream object's, which
    ``launch_before`` takes), the current device, the resolved entry, a
    ctypes call that returns before launching (``dstage_quant16`` with n =
    0: its 10 arguments converted), the count, and ``launch_before``'s
    device context."""
    from oavif_tpu_torch import kernels

    def per_call(fn, n=20000):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    entry = kernels._entry("dstage_quant16")
    x = torch.zeros(1, device=DEVICE)

    def wrapper():
        pass

    wrapper.launches = 0

    def device_context():
        with torch.cuda.device(x.device):
            pass

    pieces = {
        "raw current stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_stream(i).cuda_stream": lambda: torch.cuda.current_stream(
            0).cuda_stream,
        "current_device()": torch.cuda.current_device,
        "tensor.get_device()": x.get_device,
        "resolved entry": lambda: kernels._entry("dstage_quant16"),
        "ctypes call, 10 arguments, no launch": lambda: entry(
            0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0),
        "count_launch": lambda: kernels.count_launch(wrapper),
        "launch_before's device context": device_context,
    }
    print("  launch path, host us a piece: " + ", ".join(
        f"{k} {per_call(fn):.3f}" for k, fn in pieces.items()), flush=True)


def split_line(t: dict) -> str:
    """The device and host split of a time row, for the log."""
    return (f"device {t['device_ms']:.4f} ms, host {t['host_us']:.1f} us a "
            f"call (launch path before {t['host_us_before']:.1f} us, "
            f"checks and allocation alone {t['checks_us']:.1f} us)")


def _timed_planner():
    """Accumulate the host wall time of planner creation and planning,
    and list, in order, the quantizer indices that a plan was computed for
    (the others were served from the planner's cache) and those whose
    encode made its own block decisions (the others replayed the decisions
    that an earlier encode stored with their plan)."""
    acc = {"s": 0.0, "planned": [], "decided": []}
    get_planner, plan = FR.get_planner, ET.FramePlanner.plan
    plan_locked, get_dec = ET.FramePlanner._plan_locked, FR._get_dec

    def listed_get_dec(plan, tile_planes, qindex, *a, **k):
        dec, record = get_dec(plan, tile_planes, qindex, *a, **k)
        if record:
            acc["decided"].append(int(qindex))
        return dec, record

    def listed_plan_locked(self, qindex, exact):
        cached = list(self._plan_cache.values())
        got = plan_locked(self, qindex, exact)
        if not any(got is p for p in cached):
            acc["planned"].append(int(qindex))
        return got

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
    ET.FramePlanner._plan_locked = listed_plan_locked
    FR._get_dec = listed_get_dec
    return acc


def run_cli(args, src: str, out: str, acc: dict) -> dict:
    FR.reset_planners()
    launches0 = KERNELS["planner_plan"][0].launches
    acc["s"] = 0.0
    acc["planned"], acc["decided"] = [], []
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
    res = {"bytes": data, "wall": wall, "planner": acc["s"], "log": log,
           "planned": list(acc["planned"]),
           "decided": list(acc["decided"]),
           "launches": KERNELS["planner_plan"][0].launches - launches0,
           "devices": {str(t.device) for p in FR.planners() for t in p.dev},
           "q": int(found.group(1)) if found else int(args[1]),
           "score": float(found.group(2)) if found else None,
           "passes": int(found.group(3)) if found else 1,
           "rounds": int(found.group(4)) if found and found.group(4) else 0}
    if res["score"] is not None and not 0.0 < res["score"] <= 100.0:
        raise AssertionError(f"score {res['score']} out of range")
    return res


def phase_main_path(images: dict, acc: dict) -> tuple:
    """The port's CLI on every image; returns the kernels' launch counts,
    each image's ``-t 80`` quality and each run's result by (image,
    args)."""
    reset_counts()
    tq, found = {}, {}
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
                found[name, tuple(args)] = r
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
    return read_counts(), tq, found


def frame_4k(h: int = 2160, w: int = 3840) -> np.ndarray:
    """A photo-like frame, 3840x2160 unless told otherwise: 1/f texture
    over smooth gradients (2160 is not a multiple of 64, so the planner
    crops)."""
    fractal = _img_fractal(h, w, seed=31).astype(np.float64)
    smooth = _img_sinusoid(h, w, seed=37).astype(np.float64)
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


def fused_check(where: str, img1, mu1, s11, img2, pair: torch.Tensor
                ) -> float:
    """ssim2_blur_norms on the scale's planes against ``pair`` (ssim2_norms
    over ssim2_blur's maps, PAIR_RTOL), against a second run of itself (bit
    for bit) and against its plain version (FUSED_ATOL and FUSED_RTOL on
    the features); returns the largest feature difference from the plain
    version."""
    got = M.ssim2_blur_norms(img1, mu1, s11, img2, 8)
    again = M.ssim2_blur_norms(img1, mu1, s11, img2, 8)
    plain = M.ssim2_blur_norms_plain(img1, mu1, s11, img2, 8)
    torch.cuda.synchronize()
    off = float(((got - pair).abs() - PAIR_RTOL * pair.abs()).max())
    if off > 0:
        raise AssertionError(f"{where}: ssim2_blur_norms - pair exceeds "
                             f"rtol {PAIR_RTOL} by {off}")
    if not torch.equal(got, again):
        raise AssertionError(f"{where}: ssim2_blur_norms repeat differs")
    npix = img2.shape[2] * img2.shape[3]
    fk = M.features_from_sums(got, npix).double()
    fp = M.features_from_sums(plain, npix).double()
    tol = (torch.tensor(FUSED_ATOL, dtype=torch.float64, device=fp.device)
           + FUSED_RTOL * fp.abs())
    if bool(((fk - fp).abs() > tol).any()):
        raise AssertionError(f"{where}: ssim2_blur_norms features - plain "
                             f"{max_abs(fk, fp)} beyond atol {FUSED_ATOL} "
                             f"+ rtol {FUSED_RTOL}")
    return max_abs(fk, fp)


def metric_case(label: str, ref: torch.Tensor, dist: torch.Tensor) -> dict:
    """Each metric kernel against its plain version on the same inputs,
    scale by scale, the blur against the simple blur kernel bit for bit and
    the fused blur and norms against the pair it replaces (``fused_check``),
    then the whole score; identity through the kernels must give exactly
    100.0 and a second run the same bits. Returns the largest
    differences."""
    h, w = ref.shape[:2]
    n = dist.shape[0]
    worst = dict.fromkeys((*TOL, "ssim2_blur_norms"), 0.0)
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
        sb = (M.ssim2_blur_simple(img1, None, 8)
              + M.ssim2_blur_simple(img1, img2, 8))
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(kb, sb)):
            raise AssertionError(f"{label} N={n} scale {s}: ssim2_blur != "
                                 "ssim2_blur_simple")
        planes = (img1, kb[0], kb[1], img2, *kb[2:])
        sums = M.ssim2_norms(*planes)
        if not torch.equal(sums, M.ssim2_norms(*planes)):
            raise AssertionError(f"{label} N={n} scale {s}: norms repeat "
                                 "differs")
        npix = img2.shape[2] * img2.shape[3]
        worst["ssim2_norms"] = max(worst["ssim2_norms"], max_abs(
            M.features_from_sums(sums, npix),
            M.features_from_sums(M.ssim2_norms_plain(*planes), npix)))
        worst["ssim2_blur_norms"] = max(
            worst["ssim2_blur_norms"],
            fused_check(f"{label} N={n} scale {s}", *planes[:4], sums))
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
          f" blur and norms fused {worst['ssim2_blur_norms']:.3g} (== the "
          f"pair within rtol {PAIR_RTOL}), score {worst['score']:.3g}; blur "
          "== simple kernel bit for bit; identity 100.0, repeat identical",
          flush=True)
    for key, tol in TOL.items():
        if worst[key] > tol:
            raise AssertionError(f"{label} N={n}: {key} kernel - plain "
                                 f"{worst[key]} > {tol}")
    return worst


def score_bound(ref: torch.Tensor, dist: torch.Tensor,
                with_ref: bool = False, fused: bool = True) -> float:
    """The bound (ms) of one candidate batch's score: the sum over its
    launches, every scale, of each launch's bound, counted as in
    ``metric_times`` (pyramid: 27 operations per output element; blur: 68
    per map (2 passes x 17 taps x 2) and one per product, per element;
    norms: 40; the fused blur and norms: 206 + 40, its bytes the four
    planes it reads and the sums). ``with_ref`` adds the reference side's
    pyramid and blurs, which the width-sharded score computes on every
    call; ``fused`` False counts the candidates' side as the blur and norms
    launches that ssim2_blur_norms replaced."""
    total = []

    def pyramid(src):
        out = M.ssim2_pyramid(src)
        total.append(bound(nbytes(src, *out), 27 * out[1].numel()))
        return out

    def blur(img1, img2, radius):
        out = M.ssim2_blur(img1, img2, radius)
        maps = len(out)
        side = img1 if img2 is None else img2
        total.append(bound(nbytes(*(t for t in (img1, img2, *out)
                                    if t is not None)),
                           (68 * maps + maps - 1) * side.numel()))
        return out

    def norms(*planes):
        out = M.ssim2_norms(*planes)
        total.append(bound(nbytes(*planes, out), 40 * planes[3].numel()))
        return out

    def blur_norms(img1, mu1, s11, img2, radius):
        if not fused:
            return norms(img1, mu1, s11, img2, *blur(img1, img2, radius))
        out = M.ssim2_blur_norms(img1, mu1, s11, img2, radius)
        total.append(bound(nbytes(img1, mu1, s11, img2, out),
                           246 * img2.numel()))
        return out

    ops = M.MetricOps(pyramid, blur, norms, M.ssim2_blur_iir, blur_norms)
    pyr = M.ssimulacra2_precompute_ref(ref, ref.device,
                                       ops if with_ref else M.KERNELS)
    M.ssimulacra2_from_precomputed(pyr, dist, ops)
    return sum(b["bound_ms"] for b in total)


def metric_times(label: str, ref: torch.Tensor, dist: torch.Tensor) -> dict:
    """CUDA-event ms of one candidate batch's score (all scales, the
    reference pyramid precomputed) and of each kernel alone at scale 0,
    kernel against plain version, with each kernel's bound and, for the
    blur, the simple blur kernel's time in the same call and one cuDNN
    convolution's (``F.conv2d`` with the 17x17 Gaussian over the three
    distorted-side maps, their products made beforehand); for the fused
    blur and norms, the pair it replaced (``ssim2_blur`` then
    ``ssim2_norms``) between its two runs."""
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
        "ssim2_blur_norms": (
            lambda: M.ssim2_blur_norms(*planes[:4], 8),
            lambda: M.ssim2_blur_norms_plain(*planes[:4], 8)),
    }
    # operations per pixel and channel: the opsin mix, cube roots and XYB
    # combination (27); 3 maps x 2 passes x 17 taps x 2 plus 2 products
    # (206); the SSIM, artifact and detail maps and their norms (40); the
    # two fused (246)
    npx = dist.shape[0] * 3 * dist.shape[1] * dist.shape[2]
    pyr_out = M.ssim2_pyramid(dist)
    bounds = {
        "ssim2_pyramid": bound(nbytes(dist, *pyr_out), 27 * npx),
        "ssim2_blur": bound(nbytes(img1, img2, *dist_stats), 206 * npx),
        "ssim2_norms": bound(nbytes(*planes, M.ssim2_norms(*planes)),
                             40 * npx),
        "ssim2_blur_norms": bound(
            nbytes(*planes[:4], M.ssim2_blur_norms(*planes[:4], 8)),
            246 * npx),
        "score": {"bound_ms": score_bound(ref, dist),
                  "bound_by": "its launches' bounds",
                  "unfused_bound_ms": score_bound(ref, dist, fused=False),
                  "one_with_ref_bound_ms": score_bound(ref, dist[:1], True)},
    }
    h, w = img2.shape[-2:]
    k1d = M._taps(8, img2.device)
    k2d = (k1d[:, None] * k1d[None, :])[None, None]
    stack = torch.stack([img2, img2 * img2, img1 * img2]).reshape(-1, 1, h, w)
    conv = cuda_ms(lambda: torch.nn.functional.conv2d(stack, k2d, padding=8),
                   reps)
    times = {}
    for key, (kernel, plain) in pairs.items():
        # plain, kernel, kernel, plain: the mean of each pair
        p0, k0 = cuda_ms(plain, reps), cuda_ms(kernel, reps)
        if key == "ssim2_blur":  # the simple kernel between the two
            simple = [cuda_ms(lambda: M.ssim2_blur_simple(img1, img2, 8),
                              reps) for _ in range(2)]
        if key == "ssim2_blur_norms":  # the pair it replaced between them
            pair = [cuda_ms(lambda: M.ssim2_norms(
                *planes[:4], *M.ssim2_blur(img1, img2, 8)), reps)
                for _ in range(2)]
        k1, p1 = cuda_ms(kernel, reps), cuda_ms(plain, reps)
        times[key] = {"ms": (k0 + k1) / 2, "plain_ms": (p0 + p1) / 2,
                      "library_ms": conv if key == "ssim2_blur" else None,
                      **bounds.get(key, {})}
        if key in KERNEL_MATCH:
            # the fused kernel's two launches: its march and its fold
            times[key].update(split_times(
                kernel, KERNEL_MATCH[key], reps,
                2 if key == "ssim2_blur_norms" else 1))
        if key == "ssim2_blur":
            times[key]["simple_ms"] = sum(simple) / 2
        if key == "ssim2_blur_norms":
            times[key]["pair_ms"] = sum(pair) / 2
        extra = "".join(f", {k} {times[key][k]}" for k in
                        ("simple_ms", "pair_ms", "library_ms", "bound_ms",
                         "bound_by", "unfused_bound_ms",
                         "one_with_ref_bound_ms")
                        if times[key].get(k) is not None)
        if key in KERNEL_MATCH:
            extra += f"; {split_line(times[key])}"
        print(f"  {label}x{dist.shape[0]} {key}: kernel "
              f"{times[key]['ms']:.4f} ms, plain "
              f"{times[key]['plain_ms']:.4f} ms{extra}", flush=True)
    # at radius 0 each tap loop runs one tap: what staging and stores cost
    for radius in (0, 5, 8):
        by = [cuda_ms(lambda: fn(img1, img2, radius), reps)
              for fn in (M.ssim2_blur, M.ssim2_blur_simple)]
        print(f"  {label}x{dist.shape[0]} ssim2_blur at radius {radius}: "
              f"kernel {by[0]:.4f} ms, simple kernel {by[1]:.4f} ms",
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
    worst = dict.fromkeys((*TOL, "ssim2_blur_norms"), 0.0)
    dists = {}
    for i, (label, rgb) in enumerate(cases.items()):
        ref = torch.from_numpy(rgb).cuda()
        dist = noisy_batch(ref, (1.5, 3.0, 6.0, 12.0), seed=i)
        dists[label] = (ref, dist)
        for n in (1, 4):
            case = metric_case(label, ref, dist[:n])
            worst = {k: max(worst[k], case[k]) for k in worst}
    no_spills("blur_sums_kernel")
    times = {}
    for label in ("sinusoid 512x512", "photo 3840x2160"):
        times[label] = metric_times(label, *dists[label])
    return {"worst": worst, "times": times}


def make_ctx(rgb: np.ndarray):
    from oavif_tpu_torch.backend import EncCtx
    from oavif_tpu_torch.io.image import Image
    from oavif_tpu_torch.options import EncOptions

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
            if min(c[k] for k in SEARCH_KERNELS) <= 0:
                raise AssertionError(f"pipeline {got_mode}: a kernel did not "
                                     f"launch: {c}")
            scored_fused(c, f"pipeline {got_mode}")
            # jax mode: every probe's 6 scales, and each image's reference
            if got_mode == "jax" and (
                    c["ssim2_blur_norms"] != 6 * passes
                    or c["ssim2_blur"] != 6 * len(images)):
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
    if min(counts[k] for k in SEARCH_KERNELS) <= 0:
        raise AssertionError(f"batched CLI: a kernel did not launch: {counts}")
    scored_fused(counts, "batched CLI")
    return counts


def coeff_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over blocks of |got - want| less the K3a tolerance, 1e-6 * max|c|
    of the block + 1e-3 (the float32 products sum in another order; the
    predictions and residuals are exact): <= 0 passes."""
    tol = 1e-6 * want.abs().amax((1, 2)) + 1e-3
    return float(((got - want).abs().amax((1, 2)) - tol).max())


def level_dq(qs, bitdepth: int = 10):
    """(dq_dc, dq_ac) float32 tensors on the card for the qindexes qs."""
    return (torch.tensor([float(DS.dc_q(q, bitdepth)) for q in qs],
                         device=DEVICE),
            torch.tensor([float(DS.ac_q(q, bitdepth)) for q in qs],
                         device=DEVICE))


# 16-blocks (warps) per quant16_kernel CTA: kQuantWarps in
# csrc/device_stage.cu, for the grids' edge cases
QUANT_WARPS = 4


def quant_cases() -> dict:
    """K3b's crafted edges: {name: (coefficients (n, 16, 16) float32,
    dq_dc (k,) float32, dq_ac (k,) float32, shift)} as numpy. "half":
    |c| / dq exactly j + 0.5 at dq 3 (and its neighbours one float32 step
    either way), at three quantizers; "clip": +-16383 and beyond, up to the
    float32 maximum, at shift 3 (so some products overflow to inf); "-0.0":
    negative zeros and magnitudes that round to 0 (levels 0, eob 0);
    "zero": an all-zero block (eob 0); "last scan": only the last scan
    position nonzero (eob 256); "dc only": only the DC coefficient nonzero
    (eob 1), one quantizer whose AC step would zero it."""
    scan = np.asarray(DS.TABLES["scan_16x16"], np.int64)
    sign = np.where(np.arange(256) % 2, -1.0, 1.0)
    half = ((np.arange(256) % 128 + 0.5) * 3.0 * sign).astype(np.float32)
    half = np.stack([half, np.nextafter(half, np.float32(0)),
                     np.nextafter(half, np.float32(np.inf) * sign
                                  .astype(np.float32))])
    big = np.array([16383 * 4, 16383.5 * 4, 16384 * 4, 65535.9, 1e6, 1e30,
                    3.4e38, 2047.9375], np.float32)
    clip = np.resize(np.concatenate([big, -big]), 256).astype(np.float32)
    neg0 = np.stack([np.full(256, -0.0, np.float32),
                     np.resize(np.array([-0.0, 0.0, -1e-30, 1e-30, -0.49,
                                         0.49], np.float32), 256)])
    last = np.zeros(256, np.float32)
    last[scan[255]] = -50.0
    dc = np.zeros(256, np.float32)
    dc[0] = 3.0

    def f32(*x):
        return np.asarray(x, np.float32)

    cases = {"half": (half, f32(3, 4, 6), f32(3, 4, 6), 0),
             "clip": (clip[None], f32(4, 1), f32(4, 1), 3),
             "-0.0": (neg0, f32(4), f32(4), 0),
             "zero": (np.zeros((1, 256), np.float32), f32(4, 8), f32(4, 8), 0),
             "last scan": (last[None], f32(4, 8), f32(4, 8), 0),
             "dc only": (dc[None], f32(2, 4), f32(100, 4), 0)}
    return {name: (np.ascontiguousarray(c.reshape(-1, 16, 16)), d, a, sh)
            for name, (c, d, a, sh) in cases.items()}


def quant_agree(cf: torch.Tensor, dqd: torch.Tensor, dqa: torch.Tensor,
                label: str, shift: int = 0) -> tuple:
    """``quant16``, ``quant16_simple`` and ``quant16_plain`` on the same
    inputs: levels and eob must be equal, bit for bit; returns the
    kernel's (levels, eob)."""
    lv, eob = DS.quant16(cf, dqd, dqa, shift)
    slv, seob = DS.quant16_simple(cf, dqd, dqa, shift)
    plv, peob = DS.quant16_plain(cf, dqd, dqa, shift)
    if not (torch.equal(lv, plv) and torch.equal(eob, peob)):
        raise AssertionError(f"K3b {label}: dstage_quant16 != plain")
    if not (torch.equal(lv, slv) and torch.equal(eob, seob)):
        raise AssertionError(f"K3b {label}: dstage_quant16 != "
                             "dstage_quant16_simple")
    return lv, eob


def quant_edges() -> None:
    """K3b on its crafted edges (``quant_cases``), at k = 1, 2, 3 and 5
    quantizers, and at n = 1, QUANT_WARPS - 1 and QUANT_WARPS + 1 blocks
    (a CTA's last warps masked); a levels view off 16-byte alignment must
    raise."""
    for name, (c, d, a, shift) in quant_cases().items():
        lv, eob = quant_agree(torch.from_numpy(c).to(DEVICE),
                              torch.from_numpy(d).to(DEVICE),
                              torch.from_numpy(a).to(DEVICE), name, shift)
        print(f"  K3b crafted {name!r}: {c.shape[0]} blocks x {d.size} "
              f"quantizers equal; eob {eob.tolist()}", flush=True)
    rng = np.random.default_rng(8)
    cf = torch.from_numpy(rng.normal(0, 300, (QUANT_WARPS + 1, 16, 16))
                          .astype(np.float32)).to(DEVICE)
    for k in (1, 2, 3, 5):
        dqd, dqa = level_dq((30, 60, 90, 120, 200)[:k])
        for n in (1, QUANT_WARPS - 1, QUANT_WARPS + 1):
            quant_agree(cf[:n].contiguous(), dqd, dqa, f"k={k} n={n}")
    print(f"  K3b equal at k = 1, 2, 3, 5 and n = 1, {QUANT_WARPS - 1}, "
          f"{QUANT_WARPS + 1}", flush=True)
    dqd, dqa = level_dq((30,))
    raw = torch.empty(cf.shape[0] * 256 + 1, dtype=torch.int16,
                      device=DEVICE)
    eob = torch.empty((1, cf.shape[0]), dtype=torch.int32, device=DEVICE)
    off = raw[1:].view(1, cf.shape[0], 256)  # 2 bytes off
    try:
        DS.quant16(cf, dqd, dqa, out=(off, eob))
    except ValueError:
        print("  K3b refuses levels off 16-byte alignment", flush=True)
    else:
        raise AssertionError("K3b took levels off 16-byte alignment")


def no_spills(kernel: str) -> list:
    """``kernel``'s ptxas lines from this process's build; raises if
    ptxas spilled in any of its instantiations."""
    lines = ptxas_of(kernel)
    for ln in lines:
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
        if found and (int(found.group(1)) or int(found.group(2))):
            raise AssertionError(f"{kernel} spills: {ln}")
    print(f"  {kernel} ptxas: " + ("; ".join(lines) if lines else
                                   "not in this process's build (the "
                                   "library was up to date)"),
          flush=True)
    return lines


def fetch_times(buf: torch.Tensor, reps: int = 5) -> dict:
    """Host wall ms of one device-to-host copy of ``buf``, pageable
    (``.cpu()``) and page-locked (``DS.fetch``, the levels' route), each
    timed alone after a synchronise, in turns (pageable, pinned, pinned,
    pageable): the mean of each."""
    routes = {"pageable": lambda: buf.cpu(), "pinned": lambda: DS.fetch(buf)}
    got = {key: [] for key in routes}
    for key in routes:  # warm up both allocators and copy paths
        routes[key]()
    for key in ("pageable", "pinned", "pinned", "pageable"):
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[key]()
            got[key].append((time.perf_counter() - t0) * 1e3)
    return {f"{key}_ms": sum(v) / len(v) for key, v in got.items()}


def phase_levels_kernels(images: dict, frame4k: np.ndarray) -> dict:
    """K3a and K3b against their plain versions and their yardsticks on the
    card, on the six classes' and the 3840x2160 frame's 10-bit planes,
    each with its plan's modes at qindex 28 and with seeded random modes,
    and K3b on its crafted edges; times at 3840x2160, the levels' fetch
    both ways."""
    rng = np.random.default_rng(3)
    worst = {"dstage_coeffs16": 0.0, "dstage_quant16": 0}
    dqd, dqa = level_dq(LEVEL_QS)
    for name, rgb in [*images.items(), ("photo4k", frame4k)]:
        fp = ET.FramePlanner(yuv_planes(rgb, 10), 10, device=DEVICE)
        y, nby, nbx = fp.dev[0], fp.sby * 4, fp.sbx * 4
        plan_modes, mask = FR.device_level_modes(fp.plan(28))
        for kind, modes in (("plan", plan_modes),
                            ("random", rng.integers(0, 7, (nby, nbx)))):
            m = torch.from_numpy(modes.astype(np.int32)).to(DEVICE)
            cf = DS.coeffs16(y, nby, nbx, m, 10)
            simple = DS.coeffs16_simple(y, nby, nbx, m, 10)
            want = DS.coeffs16_plain(y, nby, nbx, m, 10)
            torch.cuda.synchronize()
            excess = coeff_excess(cf, want)
            err = max_abs(cf, want)
            worst["dstage_coeffs16"] = max(worst["dstage_coeffs16"], err)
            if excess > 0:
                raise AssertionError(f"K3a {name} {kind}: |kernel - plain| "
                                     f"{err} beyond tolerance by {excess}")
            if not torch.equal(cf.view(torch.int32), simple.view(torch.int32)):
                raise AssertionError(f"K3a {name} {kind}: dstage_coeffs16 != "
                                     "dstage_coeffs16_simple")
            lv, eob = quant_agree(cf, dqd, dqa, f"{name} {kind} at qindex "
                                  f"{LEVEL_QS}")
            for k in range(len(LEVEL_QS)):
                one = quant_agree(cf, dqd[k : k + 1], dqa[k : k + 1],
                                  f"{name} {kind} at qindex {LEVEL_QS[k]}")
                if not (torch.equal(one[0][0], lv[k])
                        and torch.equal(one[1][0], eob[k])):
                    raise AssertionError(f"K3b {name} {kind}: single q "
                                         f"{LEVEL_QS[k]} != its batch slice")
            print(f"  {name} {rgb.shape[1]}x{rgb.shape[0]} {kind} modes: "
                  f"{nby * nbx} blocks ({int(mask.sum())} consumable), "
                  f"max |c| {float(want.abs().max()):.1f}, K3a == yardstick "
                  f"bit for bit, max |kernel - plain| {err:.3g}; K3b == "
                  f"yardstick == plain at qindex {LEVEL_QS} and singly, "
                  f"nonzero levels {int((lv != 0).sum())}", flush=True)
    quant_edges()
    no_spills("quant16_kernel")
    # times at 3840x2160 (fp, y and plan_modes are the frame's last case)
    modes = torch.from_numpy(plan_modes).to(DEVICE)
    cf = DS.coeffs16(y, nby, nbx, modes, 10)
    n = nby * nbx
    reps = 20

    times = {}
    # plain, kernel, yardstick, yardstick, kernel, plain
    p0 = cuda_ms(lambda: DS.coeffs16_plain(y, nby, nbx, modes, 10), reps)
    k0 = cuda_ms(lambda: DS.coeffs16(y, nby, nbx, modes, 10), reps)
    sms = [cuda_ms(lambda: DS.coeffs16_simple(y, nby, nbx, modes, 10), reps)
           for _ in range(2)]
    k1 = cuda_ms(lambda: DS.coeffs16(y, nby, nbx, modes, 10), reps)
    p1 = cuda_ms(lambda: DS.coeffs16_plain(y, nby, nbx, modes, 10), reps)
    kms, pms = (k0 + k1) / 2, (p0 + p1) / 2
    # two 16x16x16 products of 2 operations per multiply-add, per block
    times["dstage_coeffs16"] = {
        "ms": kms, "plain_ms": pms, "simple_ms": sum(sms) / 2,
        "simple_device_ms": sum(device_ms_by_kernel(
            lambda: DS.coeffs16_simple(y, nby, nbx, modes, 10), reps,
            "coeffs16_simple_kernel").values()),
        "library_ms": None,
        **bound(nbytes(y, modes, cf), n * 2 * 16 ** 3 * 2),
        **split_times(lambda: DS.coeffs16(y, nby, nbx, modes, 10),
                      KERNEL_MATCH["dstage_coeffs16"])}
    for k in (1, 2, 3):
        d1, d2 = dqd[:k], dqa[:k]
        kernel = functools.partial(DS.quant16, cf, d1, d2)
        simple = functools.partial(DS.quant16_simple, cf, d1, d2)
        plain = functools.partial(DS.quant16_plain, cf, d1, d2)
        # plain, kernel, yardstick, yardstick, kernel, plain
        p0, k0 = cuda_ms(plain, reps), cuda_ms(kernel, reps)
        sms = [cuda_ms(simple, reps) for _ in range(2)]
        k1, p1 = cuda_ms(kernel, reps), cuda_ms(plain, reps)
        lv, eob = kernel()
        # |c| * up, / dq, + 0.5, floor, sign, clip (2) per coefficient
        t = {"ms": (k0 + k1) / 2, "plain_ms": (p0 + p1) / 2,
             "simple_ms": sum(sms) / 2,
             "simple_device_ms": sum(device_ms_by_kernel(
                 simple, reps, "quant16_simple_kernel").values()),
             "library_ms": None,
             **bound(nbytes(cf, d1, d2, lv, eob) + DS.iscan16().nbytes,
                     7 * n * 256 * k),
             **split_times(kernel, KERNEL_MATCH["dstage_quant16"])}
        t["share"] = t["bound_ms"] / t["device_ms"]
        t["simple_share"] = t["bound_ms"] / t["simple_device_ms"]
        times[f"dstage_quant16 k={k}"] = t
    times["dstage_quant16"] = times["dstage_quant16 k=1"]
    dl = DS.DeviceLevels(fp, 10)
    dl.levels(plan_modes, [28])
    fetch = []
    for _ in range(5):
        dl.levels(plan_modes, [28])
        fetch.append(dl.last_fetch_s * 1e3)
    times["fetch_ms"] = sum(fetch) / len(fetch)
    buf = DS.level_buffers(1, n, DEVICE)[0]
    buf.random_(0, 256)
    routes = fetch_times(buf)
    for key, t in times.items():
        if key in ("fetch_ms", "dstage_quant16"):
            continue
        share = (f", share of the bound {t['share']:.1%} (yardstick "
                 f"{t['simple_share']:.1%})" if "share" in t else "")
        print(f"  3840x2160 {key}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms{simple_text(t)}, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}){share}; "
              f"{split_line(t)}", flush=True)
    print(f"  3840x2160 DeviceLevels.levels fetch of {n * (256 * 2 + 4)} "
          f"bytes (k=1): {times['fetch_ms']:.4f} ms host wall, mean of 5 "
          f"({', '.join(f'{x:.4f}' for x in fetch)}); the same bytes "
          f"pageable {routes['pageable_ms']:.4f} ms, pinned "
          f"{routes['pinned_ms']:.4f} ms (means of 10, in turns)",
          flush=True)
    times["fetch_routes"] = routes
    return {"worst": worst, "times": times}


def _checked_levels(stats: dict):
    """DeviceLevels.levels that also computes each probe's plain levels on
    the card and counts the positions where they differ; restored by
    calling the returned function."""
    orig = DS.DeviceLevels.levels

    def levels(self, modes16, qindexes):
        lv, eob = orig(self, modes16, qindexes)
        pl = self.planner
        m = torch.from_numpy(np.ascontiguousarray(modes16, np.int32)).to(DEVICE)
        plv, _ = DS.quant16_plain(
            DS.coeffs16_plain(pl.dev[0], pl.sby * 4, pl.sbx * 4, m,
                              self.bitdepth), *level_dq(qindexes,
                                                        self.bitdepth))
        d = np.abs(lv.astype(np.int32) - plv.cpu().numpy().astype(np.int32))
        per_block = int((d > 0).sum(-1).max())
        stats["probes"] += 1
        stats["positions"] += int((d > 0).sum())
        stats["max_diff"] = max(stats["max_diff"], int(d.max()))
        stats["max_per_block"] = max(stats["max_per_block"], per_block)
        print(f"    probe qindex {list(qindexes)}: {lv.shape[1]} blocks, "
              f"{int((d > 0).sum())} level positions differ from the plain "
              f"version (max {int(d.max())}, at most {per_block} in a block)",
              flush=True)
        return lv, eob

    DS.DeviceLevels.levels = levels
    return lambda: setattr(DS.DeviceLevels, "levels", orig)


# the classes the device-levels CLI encodes at -q 89 (each encode is the
# Python tile coder's, 11-19 s at 512x512 on the card's host)
LEVELS_PATH_CLASSES = ("fractal", "edges", "mixed")


def phase_levels_path(images: dict, acc: dict) -> dict:
    """The main path of the encode stage: the port's CLI with
    OAVIF_PY_TILE=1 OAVIF_DEVICE_LEVELS=1, -q 89 on three classes
    (``LEVELS_PATH_CLASSES``) and -t 80 on fractal; returns the kernels'
    launches over these runs."""
    stats = dict.fromkeys(("probes", "positions", "max_diff",
                           "max_per_block"), 0)
    os.environ.update(OAVIF_PY_TILE="1", OAVIF_DEVICE_LEVELS="1")
    restore = _checked_levels(stats)
    consumed0 = FR.lv16_consumed
    try:
        with tempfile.TemporaryDirectory() as td:
            runs = [(name, ["-q", "89"]) for name in LEVELS_PATH_CLASSES]
            runs.append(("fractal", ["-t", "80"]))
            reset_counts()
            for name, args in runs:
                src = os.path.join(td, f"{name}.pam")
                write_pam(src, images[name])
                before, c0 = read_counts(), FR.lv16_consumed
                r = run_cli(args, src, os.path.join(td, "o.avif"), acc)
                after = read_counts()
                print(f"  {name} {' '.join(args)}: q{r['q']} passes "
                      f"{r['passes']} bytes {len(r['bytes'])} wall "
                      f"{r['wall']:.3f} s, 16-blocks with device levels "
                      f"{FR.lv16_consumed - c0}, launches K3a "
                      f"{after['dstage_coeffs16'] - before['dstage_coeffs16']}"
                      f" K3b {after['dstage_quant16'] - before['dstage_quant16']}"
                      f" K1 {r['launches']}", flush=True)
            counts = read_counts()
    finally:
        restore()
        for var in ("OAVIF_PY_TILE", "OAVIF_DEVICE_LEVELS"):
            os.environ.pop(var, None)
    consumed = FR.lv16_consumed - consumed0
    print(f"  device levels: {consumed} 16-blocks consumed, {stats['probes']} "
          f"probes, {stats['positions']} level positions differ from the "
          f"plain version (max {stats['max_diff']}, at most "
          f"{stats['max_per_block']} in a block)", flush=True)
    if consumed <= 0 or min(counts[k] for k in LEVEL_KERNELS) <= 0:
        raise AssertionError(f"device levels path: consumed {consumed}, "
                             f"launches {counts}")
    if counts["planner_plan"] <= 0:
        raise AssertionError("device levels path: no planner launch")
    if stats["max_diff"] > 1 or stats["max_per_block"] > 4:
        raise AssertionError(f"device levels vs plain: {stats}")
    return counts


def phase_iir(images: dict, frame4k: np.ndarray) -> dict:
    """K2e against its plain version on the card, bit for bit (the same
    float32 operations in the same order), on each image's scale-0 XYB
    planes against four noisy candidates; times at 512x512x4 and at
    3840x2160x4, beside the bytes bound and the time of the design's
    eight accesses per element at the memory rate, and each pass's time
    from a ``torch.profiler`` trace."""
    cases = {f"{name} 512x512": rgb for name, rgb in images.items()}
    cases["photo 3840x2160"] = frame4k
    worst = 0.0
    timed = {}
    for i, (label, rgb) in enumerate(cases.items()):
        ref = torch.from_numpy(rgb).cuda()
        img1 = M.ssim2_pyramid(ref[None])[1]
        img2 = M.ssim2_pyramid(noisy_batch(ref, (1.5, 3.0, 6.0, 12.0),
                                           seed=100 + i))[1]
        for n in (1, 4):
            got = (M.ssim2_blur_iir(img1, None)
                   + M.ssim2_blur_iir(img1, img2[:n]))
            want = (M.ssim2_blur_iir_plain(img1, None)
                    + M.ssim2_blur_iir_plain(img1, img2[:n]))
            torch.cuda.synchronize()
            err = max(max_abs(a, b) for a, b in zip(got, want))
            worst = max(worst, err)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"ssim2_blur_iir {label} N={n}: kernel "
                                     f"!= plain, max |diff| {err}")
        print(f"  {label}: ssim2_blur_iir == plain bit for bit at N=1 and "
              "N=4", flush=True)
        if label in ("sinusoid 512x512", "photo 3840x2160"):
            timed[label] = (img1, img2)
    for label, (img1, img2) in timed.items():
        outs = M.ssim2_blur_iir(img1, img2)
        reps = 5 if img2.numel() > 1 << 24 else 20
        p0 = cuda_ms(lambda: M.ssim2_blur_iir_plain(img1, img2), 1)
        k0 = cuda_ms(lambda: M.ssim2_blur_iir(img1, img2), reps)
        k1 = cuda_ms(lambda: M.ssim2_blur_iir(img1, img2), reps)
        p1 = cuda_ms(lambda: M.ssim2_blur_iir_plain(img1, img2), 1)
        # per output element: its product, then a forward and a backward
        # step of 7 operations along each axis
        times = {"ms": (k0 + k1) / 2, "plain_ms": (p0 + p1) / 2,
                 "library_ms": None,
                 **bound(nbytes(img1, img2, *outs),
                         29 * sum(t.numel() for t in outs)),
                 **split_times(lambda: M.ssim2_blur_iir(img1, img2),
                               KERNEL_MATCH["ssim2_blur_iir"], reps, 2)}
        # a reckoning, not a bound: the backward pass of an axis starts
        # where the forward pass ends, so this kernel's design reads and
        # writes every element once per direction and axis, eight accesses
        # to device memory
        eight_ms = 8 * nbytes(*outs) / HBM_BYTES_S * 1e3
        print(f"  {label}x4 ssim2_blur_iir (distorted side): kernel "
              f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, bound "
              f"{times['bound_ms']:.4f} ms ({times['bound_by']}); eight "
              f"accesses per element at the memory rate {eight_ms:.4f} ms; "
              f"{split_line(times)}", flush=True)
        passes = device_ms_by_kernel(lambda: M.ssim2_blur_iir(img1, img2),
                                     reps, "iir", 2)
        if any(key.endswith(BY_EVENTS) for key in passes):
            # one C entry launches both passes: events cannot split them
            print(f"  {label}x4 ssim2_blur_iir: each pass's time not "
                  "measured (the traces lost their records)", flush=True)
        elif len(passes) != 2:
            raise AssertionError(f"ssim2_blur_iir is two launches, the "
                                 f"trace holds {sorted(passes)}")
        for key, ms in passes.items():
            print(f"  {label}x4 ssim2_blur_iir, {key[:60]}: {ms:.4f} ms",
                  flush=True)
    # the last case timed is the 3840x2160 frame
    return {"worst": worst, "times": times}


# the batched -t 80 search on the recursive blur, per class, its rounds taken
# in turn with candidate 0 first: q, passes, bytes and their CRC-32
IIR_PATH = {"sinusoid": (93, 4, 137287, 0x50B5FBE1),
            "fractal": (89, 8, 121990, 0xA5B72733),
            "edges": (76, 8, 27350, 0x2E144F47),
            "oriented": (75, 8, 11552, 0x56CC0DF4),
            "text": (54, 15, 28634, 0x0F44E7DF),
            "mixed": (90, 8, 119424, 0x76FD943C)}


@contextlib.contextmanager
def serial_rounds(first: int):
    """Take the threads out of the batched search's rounds: the candidates
    of a round encode one after another, candidate ``first`` before the
    others, so that its plan is the one ``FramePlanner`` caches for the
    quantizers near it."""
    class InTurn:
        def __init__(self, max_workers=None):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def map(self, fn, items):
            items = list(items)
            k = first % len(items)
            outs = {i: fn(items[i])
                    for i in [*range(k, len(items)), *range(k)]}
            return [outs[i] for i in range(len(items))]

    pool = concurrent.futures.ThreadPoolExecutor
    concurrent.futures.ThreadPoolExecutor = InTurn
    try:
        yield
    finally:
        concurrent.futures.ThreadPoolExecutor = pool


def phase_iir_path(images: dict, acc: dict) -> dict:
    """The CLI's batched search on the recursive blur: OAVIF_METRIC=jax
    OAVIF_METRIC_BLUR=iir, -t 80 on the six classes; returns the launches
    of the runs as a user makes them. Those runs are held to no q or
    bytes: the candidates of a round encode on threads, the first to plan
    leaves its plan in ``FramePlanner``'s cache for the quantizers near it,
    and an encode replays the block decisions stored with its plan unless
    it started before another had stored them, so thread timing moves the
    bytes and, on some images, the q. Each class therefore runs again with
    its rounds in turn: candidate 0 first, twice, held to ``IIR_PATH``,
    and each other candidate first, printed."""
    os.environ.update(OAVIF_METRIC="jax", OAVIF_METRIC_BLUR="iir",
                      OAVIF_TQ_BATCH_WIDTH="4")

    def show(r):
        return (f"q{r['q']} score {r['score']} passes {r['passes']} bytes "
                f"{len(r['bytes'])}, planned at qindex {r['planned']}, own "
                f"decisions at {r['decided']}")

    try:
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "o.avif")
            reset_counts()
            for name, rgb in images.items():
                write_pam(os.path.join(td, f"{name}.pam"), rgb)
                r = run_cli(["-t", "80"], os.path.join(td, f"{name}.pam"),
                            out, acc)
                print(f"  {name} -t 80 (iir): {show(r)}, wall "
                      f"{r['wall']:.3f} s", flush=True)
            counts = read_counts()
            for name in images:
                src = os.path.join(td, f"{name}.pam")
                for first in (0, 0, 1, 2, 3):
                    with serial_rounds(first):
                        r = run_cli(["-t", "80"], src, out, acc)
                    got = (r["q"], r["passes"], len(r["bytes"]),
                           zlib.crc32(r["bytes"]))
                    if first == 0 and got != IIR_PATH[name]:
                        raise AssertionError(
                            f"iir CLI path, {name}, rounds in turn: {got}, "
                            f"not {IIR_PATH[name]}")
                    print(f"  {name} (iir), rounds in turn, candidate "
                          f"{first} first: {show(r)}", flush=True)
    finally:
        for var in ("OAVIF_METRIC", "OAVIF_METRIC_BLUR",
                    "OAVIF_TQ_BATCH_WIDTH"):
            os.environ.pop(var, None)
    # the recursive blur keeps blur_iir then norms; nothing of the Gaussian
    if (counts["ssim2_blur_iir"] <= 0 or counts["ssim2_norms"] <= 0
            or counts["ssim2_blur"] != 0 or counts["ssim2_blur_norms"] != 0):
        raise AssertionError(f"iir CLI path: launches {counts}")
    return counts


def wiener_planes(h: int, w: int, bitdepth: int, seed: int):
    """Synthetic CDEF and deblocked planes as tests/test_multidevice.py
    makes them at 8 bits, scaled to ``bitdepth``."""
    rng = np.random.default_rng(seed)
    s = 1 << (bitdepth - 8)
    cdef = [np.asarray(128 * s + rng.integers(-80 * s, 80 * s, (h, w)),
                       np.int32) for _ in range(3)]
    deblk = [np.asarray(c + rng.integers(-4 * s, 4 * s + 1, (h, w)), np.int32)
             for c in cdef]
    return cdef, deblk


def wiener_deblk_rows(h: int) -> int:
    """How many rows of the deblocked plane the Wiener filter reads: per
    stripe band, those above and below the stripe, at most 2 past its edge
    (the selection of ``restoration._band_rows`` and of the kernel)."""
    rows = set()
    for r0, r1, ss, se in _band_rows(0, h):
        for y in range(r0 - 3, r1 + 3):
            y = min(max(y, 0), h - 1)
            if y < ss:
                rows.add(max(ss - 2, y))
            elif y > se:
                rows.add(min(se + 2, y))
    return len(rows)


def multi_device_rank(rk: parallel.Rank, ref: np.ndarray, dist: np.ndarray,
                      seed: int) -> dict:
    """One rank of the multi-device phase: the sharded metric over all
    ranks and over the first two, each checked and timed, then the sharded
    Wiener filter over all ranks on planes made here from ``seed``. Each
    part reports the launches of its own run apart from its checks'."""
    k4 = {size: shard_checks.metric_rank(rk, ref, dist, size, reps=3)
          for size in (rk.world, 2)}
    h, w = ref.shape[:2]
    cdef, deblk = wiener_planes(h, w, 10, seed)
    k5 = shard_checks.wiener_rank(rk, cdef, deblk, h, w, graft_entry.LR_TAPS,
                                  10)
    return {"k4": k4, "k5": k5}


def wiener_times(cdef, deblk) -> dict:
    """K5 on one rank's launch (slice 0 of 4 of plane 0, with its halos)
    against its plain version, bit for bit, and its times: CUDA events of
    20 calls back to back, and the device and host split."""
    h, w = cdef[0].shape
    ws = w // 4
    ext = [torch.from_numpy(np.pad(p[0][:, : ws + 3], ((0, 0), (3, 0)),
                                   mode="edge")).cuda()
           for p in (cdef, deblk)]
    taps = graft_entry.LR_TAPS[0]
    vf, hf = _coeffs7(*taps[:3]), _coeffs7(*taps[3:])
    out = WS.wiener_bands(ext[0], ext[1], vf, hf, 10)
    worst = max_abs(out, WS.wiener_bands_plain(ext[0], ext[1], vf, hf, 10))
    if worst:
        raise AssertionError(f"K5: kernel != plain by {worst}")
    if not torch.equal(out, WS.wiener_bands_simple(ext[0], ext[1], vf, hf,
                                                   10)):
        raise AssertionError("K5: wiener_bands != wiener_bands_simple")
    kernel = functools.partial(WS.wiener_bands, ext[0], ext[1], vf, hf, 10)
    simple = functools.partial(WS.wiener_bands_simple, ext[0], ext[1], vf, hf,
                               10)
    # plain, kernel, yardstick, yardstick, kernel, plain
    p0 = cuda_ms(lambda: WS.wiener_bands_plain(ext[0], ext[1], vf, hf, 10))
    k0 = cuda_ms(kernel, 20)
    sms = [cuda_ms(simple, 20) for _ in range(2)]
    k1 = cuda_ms(kernel, 20)
    p1 = cuda_ms(lambda: WS.wiener_bands_plain(ext[0], ext[1], vf, hf, 10))
    # bytes: the CDEF plane with its halos, the deblocked rows read outside
    # the stripes, the taps and the output; per output pixel: 7
    # multiply-adds per pass on the band's rows (6 more rows per band in the
    # horizontal pass), rounding and clamps
    deblk_bytes = wiener_deblk_rows(h) * ext[1].shape[1] * 4
    times = {"ms": (k0 + k1) / 2, "plain_ms": (p0 + p1) / 2,
             "simple_ms": sum(sms) / 2,
             "simple_device_ms": sum(device_ms_by_kernel(
                 simple, 20, "wiener_simple_kernel").values()),
             "library_ms": None, "worst": worst,
             **bound(nbytes(ext[0], out) + deblk_bytes + 14 * 4,
                     36 * out.numel()),
             **split_times(kernel, KERNEL_MATCH["wiener_bands"])}
    print(f"  K5 one rank's launch at {tuple(out.shape)}: == plain and == "
          f"yardstick bit for bit; kernel {times['ms']:.4f} ms, plain "
          f"{times['plain_ms']:.4f} ms{simple_text(times)}, bound "
          f"{times['bound_ms']:.4f} ms ({times['bound_by']}); "
          f"{split_line(times)}", flush=True)
    return times


def phase_multi_device(frame4k: np.ndarray) -> dict:
    """K4, K5 and K6 on ranks sharing the card (gloo over CUDA tensors),
    and K4 at one rank under NCCL; returns the launches and the Wiener
    kernel's worst difference and times."""
    h, w = frame4k.shape[:2]
    rng = np.random.default_rng(41)
    dist = np.clip(frame4k + rng.normal(0, 3, frame4k.shape), 0,
                   255).astype(np.uint8)
    ref_t = torch.from_numpy(frame4k).cuda()
    dist_t = torch.from_numpy(dist).cuda()
    single = M.compute_ssimulacra2(frame4k, dist)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        M.ssimulacra2_from_precomputed(M.ssimulacra2_precompute_ref(ref_t),
                                       dist_t)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) / 3 * 1e3

    reset_counts()
    t0 = time.perf_counter()
    results, counts = parallel.spawn(multi_device_rank, 4,
                                     args=(frame4k, dist, 5), device="cuda",
                                     timeout_s=300)
    launches = add(read_counts(), rank_counts(
        [r["k5"]["launches"] for r in results]
        + [k4["launches"] for r in results for k4 in r["k4"].values() if k4]))
    print(f"  4 ranks (K4 over 4 and 2, K5 over 4): {time.perf_counter() - t0:.1f}"
          f" s wall, launches of the sharded runs {launches}", flush=True)
    halo_err = 0.0
    for size in (4, 2):
        rs = [r["k4"][size] for r in results[:size]]
        scores = {r["score"] for r in rs}
        if len(scores) != 1 or abs(rs[0]["score"] - single) >= 1e-3:
            raise AssertionError(f"K4 over {size}: scores {scores}, single "
                                 f"{single}")
        if any(r["differ"] for r in rs):
            raise AssertionError(f"K4 over {size}: blur planes differ from "
                                 f"the single-device kernel's columns: "
                                 f"{[r['differ'] for r in rs]}")
        err = max(r["plain_err"] for r in rs)
        if err > TOL["ssim2_blur"]:
            raise AssertionError(f"K4 over {size}: halo blur kernel != plain "
                                 f"by {err}")
        halo_err = max(halo_err, err)
        ms, clocked, ar = (sum(r[k] for r in rs) / size
                           for k in ("ms", "clocked_ms", "allreduce_ms"))
        print(f"  K4 {w}x{h} over {size} ranks: score {rs[0]['score']} "
              f"(single-device {single}), slices' scale-0 blur planes == the "
              f"single-device kernel's columns bit for bit, halo blur "
              f"kernel vs plain at (1, 3, {h}, {w // size + 16}) max |diff| "
              f"{err}; {ms:.3f} ms per sharded score (single-device "
              f"{single_ms:.3f} ms); with each all_reduce timed alone "
              f"{clocked:.3f} ms per score, {ar:.3f} ms of it in all_reduce "
              f"({100 * ar / clocked:.1f}%)", flush=True)

    cdef, deblk = wiener_planes(h, w, 10, 5)
    usz = unit_size(2)
    grids = {p: [[list(t)] * count_units(w, usz)
                 for _ in range(count_units(h, usz))]
             for p, t in graft_entry.LR_TAPS.items()}
    t0 = time.perf_counter()
    host = apply_wiener(cdef, deblk, h, w, (2, 2, 2), 2, grids, 10)
    host_s = time.perf_counter() - t0
    k5 = [r["k5"] for r in results]
    if not all(np.array_equal(a, b) for a, b in zip(k5[0]["planes"], host)):
        raise AssertionError("K5: sharded Wiener != host apply_wiener")
    if len({tuple(r["crc"]) for r in k5}) != 1 or not all(
            r["plain_equal"] for r in k5):
        raise AssertionError(f"K5: ranks disagree or kernel != plain: "
                             f"{[(r['crc'], r['plain_equal']) for r in k5]}")
    times = wiener_times(cdef, deblk)
    print(f"  K5 3x {w}x{h} 10-bit over 4 ranks: == host apply_wiener "
          f"({host_s:.3f} s wall) and == plain on every rank", flush=True)

    for n, image, q_dim in ((2, None, None), (4, None, None),
                            (4, frame4k, 1)):
        label = (f"{n} ranks, reference shapes" if image is None
                 else f"{n} ranks, {w}x{h} as {n} tile columns")
        t0 = time.perf_counter()
        r = graft_entry.dryrun_multichip(n, device="cuda", image=image,
                                         q_dim=q_dim, timeout_s=300)
        launches = add(launches, rank_counts([r["launches"]]))
        if image is not None and r["seeded_used"] <= 0:
            raise AssertionError(f"K6 {label}: no seeded plan consumed")
        extra = ("" if image is not None else
                 f", sharded score {r['score_sharded']:.4f} vs single "
                 f"{r['score_single']:.4f}, Wiener == host, device-levels "
                 f"score {r['score_device_levels']:.4f}")
        print(f"  K6 dryrun_multichip {label}: {time.perf_counter() - t0:.1f}"
              f" s wall, plans == single-device planner, {len(r['avif_sharded'])}"
              f" bytes == unsharded encode, seeded plans consumed "
              f"{r['seeded_used']}, checksums {r['totals']}{extra}",
              flush=True)

    t0 = time.perf_counter()
    res, counts = parallel.spawn(MS.score_shard, 1, args=(frame4k, dist),
                                 backend="nccl", device="cuda", timeout_s=120)
    launches = add(launches, rank_counts(counts))
    if abs(res[0] - single) >= 1e-3:
        raise AssertionError(f"K4 under NCCL: {res[0]} vs {single}")
    print(f"  K4 {w}x{h} at 1 rank under NCCL: score {res[0]} "
          f"({time.perf_counter() - t0:.1f} s wall)", flush=True)
    return {"launches": launches, "worst": times["worst"],
            "halo_err": halo_err, "times": {"wiener_bands": times}}


# The six classes' -t 80 results in PERF.md §5's table: (bytes, passes)
PERF_TABLE = {"sinusoid": (137287, 2), "fractal": (121990, 2),
              "edges": (53462, 1), "oriented": (17828, 2),
              "text": (39333, 2), "mixed": (119424, 2)}


def phase_png_input(images: dict, frame4k: np.ndarray, found: dict,
                    png_dir: str, acc: dict) -> dict:
    """The CLI on the six classes (``-t 80``) and the 3840x2160 frame
    (``-q 60``) written as 8-bit PNG with the package's writer (the
    classes into ``png_dir``, for the harness): the decoded pixels must
    be the source's exactly, and q, passes and bytes those of the same
    image read from PAM (``found``, phase 5 of this call). Returns the
    kernels' launches."""
    from oavif_tpu_torch.io.image import load_png

    reset_counts()
    with tempfile.TemporaryDirectory() as td:
        for name, rgb in [*images.items(), ("photo4k", frame4k)]:
            args = ("-q", "60") if name == "photo4k" else ("-t", "80")
            png = os.path.join(png_dir if name in images else td,
                               f"{name}.png")
            write_png(png, rgb)
            t0 = time.perf_counter()
            img = load_png(png)
            t_read = time.perf_counter() - t0
            if img.channels != 3 or img.hbd or not np.array_equal(img.data,
                                                                  rgb):
                raise AssertionError(f"{name}.png: decoded pixels differ "
                                     "from the source")
            r = run_cli(list(args), png, os.path.join(td, "o.avif"), acc)
            want = found[name, args]
            got = (r["q"], r["passes"], r["bytes"])
            if got != (want["q"], want["passes"], want["bytes"]):
                raise AssertionError(
                    f"{name} {' '.join(args)}: PNG gives q{r['q']} "
                    f"{r['passes']} passes {len(r['bytes'])} bytes, PAM "
                    f"q{want['q']} {want['passes']} passes "
                    f"{len(want['bytes'])} bytes")
            print(f"  {name} {rgb.shape[1]}x{rgb.shape[0]} PNG "
                  f"({os.path.getsize(png)} bytes, read {t_read:.3f} s) "
                  f"{' '.join(args)}: q{r['q']} passes {r['passes']} bytes "
                  f"{len(r['bytes'])} == PAM; wall {r['wall']:.3f} s "
                  f"(PAM {want['wall']:.3f} s)", flush=True)
    return read_counts()


JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "torch_fixtures", "jpeg")
JPEG_LOSSLESS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "torch_fixtures", "jpeg_lossless")
JPEG_CUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "torch_fixtures", "jpeg_cut")


def _read_jpeg_fixtures(folder: str) -> dict:
    """Every fixture of ``folder`` decodes to its manifest's shape,
    channels and CRC32s (and the ICC profile's, where the manifest has
    it), each read timed (median of 5); a fixture whose manifest says the
    reference raises must raise ``OSError``, unless the manifest also
    holds libjpeg's pixels of the whole file (``libjpeg``), which it must
    give. Returns the pixels by file name."""
    from oavif_tpu_torch.io.image import load_jpeg

    with open(os.path.join(folder, "manifest.json")) as f:
        manifest = json.load(f)
    decoded = {}
    for name, entry in sorted(manifest.items()):
        path = os.path.join(folder, name)
        if "raises" in entry and "libjpeg" not in entry:
            try:
                load_jpeg(path)
            except OSError as e:
                print(f"  {name}: raises OSError ({e}) as the reference "
                      f"({entry['raises']})", flush=True)
                continue
            raise AssertionError(f"{name}: decoded, the reference raises "
                                 f"{entry['raises']}")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            img = load_jpeg(path)
            times.append(time.perf_counter() - t0)
        icc = None if img.icc is None else zlib.crc32(img.icc)
        got = (list(img.data.shape), img.channels,
               zlib.crc32(img.data.tobytes()), icc)
        want = entry.get("libjpeg", entry)
        want = (want["shape"], want["channels"], want["crc32"],
                want.get("icc_crc32"))
        if got != want:
            raise AssertionError(f"{name}: decoded {got}, manifest {want}")
        decoded[name] = img.data
        print(f"  {name} {img.width}x{img.height}x{img.channels} "
              f"({os.path.getsize(path)} bytes): == manifest CRC; read "
              f"{np.median(times) * 1e3:.3f} ms (median of 5, "
              f"{min(times) * 1e3:.3f}-{max(times) * 1e3:.3f})", flush=True)
    return decoded


def lossless_4k(frame: np.ndarray, folder: str) -> dict:
    """The 3840x2160 frame written as a lossless JPEG (predictor 1, point
    transform 0) by the numpy writer beside the JPEG fixtures, into
    ``folder``; its decode must be the frame exactly. Returns the write
    and the reads' times."""
    from oavif_tpu_torch.io.image import load_jpeg

    sys.path.insert(0, JPEG_DIR)
    from lossless_jpeg import encode

    t0 = time.perf_counter()
    data = encode(frame, predictor=1, pt=0)
    t_write = time.perf_counter() - t0
    path = os.path.join(folder, "photo4k_lossless.jpg")
    with open(path, "wb") as f:
        f.write(data)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        img = load_jpeg(path)
        times.append(time.perf_counter() - t0)
        if not np.array_equal(img.data, frame):
            raise AssertionError("the 3840x2160 lossless JPEG does not "
                                 "decode to its source")
    print(f"  photo4k_lossless.jpg 3840x2160x3 ({len(data)} bytes, written "
          f"in {t_write:.3f} s): == its source; read "
          f"{np.median(times) * 1e3:.3f} ms (median of 5, "
          f"{min(times) * 1e3:.3f}-{max(times) * 1e3:.3f})", flush=True)
    return {"write_s": t_write, "read_ms": float(np.median(times)) * 1e3}


def phase_jpeg_input(images: dict, frame4k: np.ndarray, acc: dict) -> dict:
    """The port's JPEG reader and the CLI on JPEG input. Every fixture of
    ``tests/torch_fixtures/jpeg``, ``tests/torch_fixtures/jpeg_lossless``
    and ``tests/torch_fixtures/jpeg_cut`` (files cut before their EOI)
    must decode to its manifest's shape and CRC32s (libjpeg-turbo's
    pixels, as Pillow returned them when the fixtures were made), or raise
    ``OSError`` where Pillow raised, each read timed (median of 5); the
    3840x2160 frame written here as a lossless JPEG must decode to itself
    (``lossless_4k``). Then the CLI ``-t 80`` on the six class JPEGs, the
    512x512 lossless class and the 256x256 file cut before its EOI that
    Pillow decodes, and ``-q 60`` on the 3840x2160 one: q, passes and
    bytes must be those of the CLI on the decoded pixels written as PAM;
    and the corpus harness, sequential, over the six class JPEGs: bytes
    and passes must be the CLI's. Returns the kernels' launches."""
    import csv

    from oavif_tpu_torch.av1.entropy.fast import get_lib
    from oavif_tpu_torch.scripts import measure

    t0 = time.perf_counter()
    if get_lib() is None:  # the host library, built here if no run has
        raise AssertionError("the host C library did not build")
    print(f"  host library (JPEG decoder): {time.perf_counter() - t0:.3f} s "
          "to build or load", flush=True)
    reset_counts()
    decoded = _read_jpeg_fixtures(JPEG_DIR)
    folders = {"lossless": JPEG_LOSSLESS_DIR, "cut": JPEG_CUT_DIR}
    for key, folder in folders.items():
        decoded.update({f"{key}/{k}": v for k, v in
                        _read_jpeg_fixtures(folder).items()})
    found = {}
    with tempfile.TemporaryDirectory() as td:
        lossless_4k(frame4k, td)
        corpus = os.path.join(td, "corpus")
        os.mkdir(corpus)
        for name in [*images, "photo4k", "lossless/text_p1",
                     "cut/text256_noeoi"]:
            args = ["-q", "60"] if name == "photo4k" else ["-t", "80"]
            src = os.path.join(JPEG_DIR, f"{name}.jpg")
            if "/" in name:
                key, base = name.split("/")
                src = os.path.join(folders[key], f"{base}.jpg")
            if name in images:
                with open(src, "rb") as f, \
                        open(os.path.join(corpus, f"{name}.jpg"), "wb") as g:
                    g.write(f.read())
            r = run_cli(args, src, os.path.join(td, "o.avif"), acc)
            pam = os.path.join(td, f"{name.replace('/', '_')}.pam")
            write_pam(pam, decoded[f"{name}.jpg"])
            p = run_cli(args, pam, os.path.join(td, "o.avif"), acc)
            got = (r["q"], r["passes"], r["bytes"])
            if got != (p["q"], p["passes"], p["bytes"]):
                raise AssertionError(
                    f"{name}.jpg {' '.join(args)}: q{r['q']} {r['passes']} "
                    f"passes {len(r['bytes'])} bytes, its pixels as PAM "
                    f"q{p['q']} {p['passes']} passes {len(p['bytes'])} "
                    "bytes")
            found[f"{name}.jpg"] = (len(r["bytes"]), r["passes"])
            print(f"  {name}.jpg {' '.join(args)}: q{r['q']} passes "
                  f"{r['passes']} bytes {len(r['bytes'])} == PAM of its "
                  f"pixels; wall {r['wall']:.3f} s (PAM {p['wall']:.3f} s)",
                  flush=True)
        out = os.path.join(td, "jpeg.csv")
        FR.reset_planners()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = measure.main([corpus, "module:oavif_tpu_torch", out])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"measure over the JPEGs: exit {rc}")
        with open(out) as f:
            rows = list(csv.DictReader(f))
        got = {r["Image"]: (int(r["Final Bytes"]), int(r["Passes"]))
               for r in rows if r["Status"] == "ok"}
        want = {k: v for k, v in found.items() if k[:-4] in images}
        if got != want:
            raise AssertionError(f"measure over the JPEGs: {got}, the "
                                 f"CLI's {want}")
        print(f"  measure sequential over {len(got)} JPEGs: corpus wall "
              f"{wall:.3f} s; bytes and passes == the CLI's", flush=True)
    return read_counts()


WEBP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "torch_fixtures", "webp")


def webp_split(path: str) -> None:
    """One lossy WebP read split into its C stages, each the median of 5:
    the VP8 decode to Y'UV (with the loop filter) and the conversion to
    RGBA."""
    from oavif_tpu_torch.av1.entropy.fast import get_lib
    from oavif_tpu_torch.io import webp

    lib = get_lib()
    with open(path, "rb") as f:
        dmx = webp._Demux(f.read())
    fr = dmx.frames[0]
    planes, t_vp8, t_rgb = None, [], []
    rgba = np.empty((fr.height, fr.width, 4), np.uint8)
    for _ in range(5):
        t0 = time.perf_counter()
        planes = webp.decode_vp8(lib, dmx.data, *fr.image, fr.width,
                                 fr.height)
        t_vp8.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        lib.webp_yuv_to_rgba(*(p.ctypes.data for p in planes), fr.width,
                             fr.height, rgba.ctypes.data, fr.width * 4)
        t_rgb.append(time.perf_counter() - t0)
    print(f"  {os.path.basename(path)} split: VP8 decode to Y'UV "
          f"{np.median(t_vp8) * 1e3:.3f} ms, fancy upsampling to RGBA "
          f"{np.median(t_rgb) * 1e3:.3f} ms (medians of 5)", flush=True)


def phase_webp_input(images: dict, acc: dict) -> dict:
    """The port's WebP reader and the CLI on WebP input. Every fixture of
    ``tests/torch_fixtures/webp`` (lossy, lossless, alpha planes raw and
    filtered, partitions, segments, filters, an animation) must decode to
    its manifest's shape, channels and CRC32 (libwebp's pixels, as Pillow
    returned them when the fixtures were made), each read timed (median
    of 5). Then the CLI ``-t 80`` on the six lossy class WebPs and
    ``-q 60`` on the 3840x2160 one: q, passes and bytes must be those of
    the CLI on the decoded pixels written as PAM. Returns the kernels'
    launches."""
    from oavif_tpu_torch.io.image import load_webp

    with open(os.path.join(WEBP_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    reset_counts()
    decoded = {}
    for name, entry in sorted(manifest.items()):
        path = os.path.join(WEBP_DIR, name)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            img = load_webp(path)
            times.append(time.perf_counter() - t0)
        got = (list(img.data.shape), img.channels,
               zlib.crc32(img.data.tobytes()), img.icc)
        want = (entry["shape"], entry["channels"], entry["crc32"], None)
        if got != want:
            raise AssertionError(f"{name}: decoded {got}, manifest {want}")
        decoded[name] = img.data
        print(f"  {name} {img.width}x{img.height}x{img.channels} "
              f"({os.path.getsize(path)} bytes): == manifest CRC; read "
              f"{np.median(times) * 1e3:.3f} ms (median of 5, "
              f"{min(times) * 1e3:.3f}-{max(times) * 1e3:.3f})", flush=True)
    webp_split(os.path.join(WEBP_DIR, "photo4k.webp"))
    with tempfile.TemporaryDirectory() as td:
        for name in [*images, "photo4k"]:
            args = ["-q", "60"] if name == "photo4k" else ["-t", "80"]
            src = os.path.join(WEBP_DIR, f"{name}.webp")
            r = run_cli(args, src, os.path.join(td, "o.avif"), acc)
            pam = os.path.join(td, f"{name}.pam")
            write_pam(pam, decoded[f"{name}.webp"])
            p = run_cli(args, pam, os.path.join(td, "o.avif"), acc)
            got = (r["q"], r["passes"], r["bytes"])
            if got != (p["q"], p["passes"], p["bytes"]):
                raise AssertionError(
                    f"{name}.webp {' '.join(args)}: q{r['q']} {r['passes']} "
                    f"passes {len(r['bytes'])} bytes, its pixels as PAM "
                    f"q{p['q']} {p['passes']} passes {len(p['bytes'])} "
                    "bytes")
            print(f"  {name}.webp {' '.join(args)}: q{r['q']} passes "
                  f"{r['passes']} bytes {len(r['bytes'])} == PAM of its "
                  f"pixels; wall {r['wall']:.3f} s (PAM {p['wall']:.3f} s)",
                  flush=True)
    return read_counts()


def cli_process(args, src: str, out: str, trace_dir=None) -> dict:
    """The port's CLI as a user runs it, in a process of its own (with
    ``OAVIF_VERBOSE=1``, and ``OAVIF_TRACE=trace_dir`` when given, under
    torch.profiler's default CUPTI settings): its stderr, the bytes, the
    process's wall and the search's own ms (the pass timings' sum)."""
    env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
    env["OAVIF_VERBOSE"] = "1"
    if trace_dir is not None:
        env["OAVIF_TRACE"] = trace_dir
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "oavif_tpu_torch.cli", *args, src, out],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli {args} on {src} exited "
                             f"{proc.returncode}:\n{proc.stderr[-2000:]}")
    timings = re.search(r"Pass timings \(ms\): \[([^\]]*)\]", proc.stderr)
    with open(out, "rb") as f:
        data = f.read()
    return {"log": proc.stderr, "bytes": data, "wall": wall,
            "search_ms": sum(float(t) for t in timings.group(1).split(","))}


def phase_trace(images: dict, acc: dict) -> None:
    """The CLI ``-t 80`` on edges (1 pass) and mixed (2 passes) under
    ``OAVIF_TRACE``, each run in a process of its own as a user runs it:
    exit 0, the reference's line, one Chrome trace in the directory, the
    bytes of the same search run here, and the fused planner kernel's
    device records in the trace, counted against that search's launches;
    the process's wall and the search's ms with and without the trace. A
    trace without the planner's records is taken again, up to three in
    all, and each one's count is printed."""
    for name in ("edges", "mixed"):
        with tempfile.TemporaryDirectory() as td:
            src = os.path.join(td, f"{name}.pam")
            write_pam(src, images[name])
            out = os.path.join(td, "o.avif")
            here = run_cli(["-t", "80"], src, out, acc)
            plain = cli_process(["-t", "80"], src, out)
            for attempt in range(3):
                trace_dir = os.path.join(td, f"trace{attempt}")
                r = cli_process(["-t", "80"], src, out, trace_dir)
                if f"Profiler trace written to {trace_dir}" not in r["log"]:
                    raise AssertionError(f"trace {name}: no trace line")
                if not r["bytes"] == plain["bytes"] == here["bytes"]:
                    raise AssertionError(f"trace {name}: bytes moved")
                files = [f for f in os.listdir(trace_dir)
                         if f.endswith(".json")]
                if len(files) != 1:
                    raise AssertionError(f"trace {name}: files {files}")
                path = os.path.join(trace_dir, files[0])
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
                kernels = [e for e in events if e.get("cat") == "kernel"]
                plans = sum("plan_kernel" in e["name"] for e in kernels)
                print(f"  trace {name} -t 80 (trace {attempt + 1}): "
                      f"{here['passes']} passes, bytes {len(r['bytes'])} == "
                      f"untraced; {os.path.getsize(path)} bytes of trace, "
                      f"{len(events)} events, {len(kernels)} device kernel "
                      f"records, planner_plan {plans} of its "
                      f"{here['launches']} launches; process wall "
                      f"{r['wall']:.3f} s traced, {plain['wall']:.3f} s "
                      f"untraced; search {r['search_ms']:.1f} ms traced, "
                      f"{plain['search_ms']:.1f} ms untraced", flush=True)
                if plans:
                    break
            else:
                raise AssertionError(f"trace {name}: no planner kernel "
                                     "record in three traces")


def trace_records(trace_dir: str, match: str) -> list:
    """Per Chrome trace in the directory, oldest first: (file, device
    kernel records, those whose name holds ``match``)."""
    files = sorted((f for f in os.listdir(trace_dir)
                    if f.endswith(".json")),
                   key=lambda f: os.path.getmtime(os.path.join(trace_dir,
                                                               f)))
    out = []
    for name in files:
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        out.append((name, len(kernels),
                    sum(match in e["name"] for e in kernels)))
    return out


def phase_trace_harness(images: dict, acc: dict) -> None:
    """``OAVIF_TRACE`` over the corpus harness, which runs one search per
    image in one process (the ``module:oavif_tpu_torch`` path): edges and
    mixed as PNG, ``scripts/measure.py`` in a process of its own with the
    environment of ``cli_process``. First under kineto's default CUPTI
    teardown (``TEARDOWN_CUPTI=1``, which the CLI leaves as set: the
    behaviour before it kept CUPTI attached), then as users run it (the
    variable unset, so the CLI sets it to 0). Each trace's
    ``planner_plan`` device records are printed against that image's
    launches in this process; in the second run every trace must hold
    some."""
    want = {}
    with tempfile.TemporaryDirectory() as td:
        corpus = os.path.join(td, "corpus")
        os.mkdir(corpus)
        for name in ("edges", "mixed"):
            src = os.path.join(corpus, f"{name}.png")
            write_png(src, images[name])
            want[name] = run_cli(["-t", "80"], src,
                                 os.path.join(td, "o.avif"), acc)["launches"]
        for label, teardown in (("default CUPTI teardown", "1"),
                                ("as users run it", None)):
            trace_dir = os.path.join(td, f"trace_{teardown}")
            env = {k: v for k, v in os.environ.items()
                   if k != "TEARDOWN_CUPTI"}
            env["OAVIF_TRACE"] = trace_dir
            if teardown is not None:
                env["TEARDOWN_CUPTI"] = teardown
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "oavif_tpu_torch.scripts.measure",
                 corpus, "module:oavif_tpu_torch",
                 os.path.join(td, f"{label[:7]}.csv")],
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                capture_output=True, text=True, timeout=300)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"traced harness ({label}) exited "
                                     f"{proc.returncode}:\n"
                                     f"{proc.stderr[-2000:]}")
            traces = trace_records(trace_dir, KERNEL_MATCH["planner_plan"])
            if len(traces) != len(want):
                raise AssertionError(f"traced harness ({label}): traces "
                                     f"{[t[0] for t in traces]}")
            counts = [f"{n}: planner_plan {plans} of its {want[n]} launches "
                      f"({kernels} device kernel records)"
                      for n, (_, kernels, plans) in zip(sorted(want),
                                                         traces)]
            print(f"  traced harness over edges and mixed, {label}: "
                  f"{'; '.join(counts)}; process wall {wall:.3f} s",
                  flush=True)
            if teardown is None and not all(t[2] for t in traces):
                raise AssertionError("traced harness: a trace without the "
                                     "planner's device records")


def phase_stages(images: dict, frame4k: np.ndarray, tq: dict) -> dict:
    """The stage profile (``scripts/profile_stages.py``) of ``-t 80`` on
    the six classes and the 3840x2160 frame: its text and JSON lines; q
    must be the CLI's. Returns the kernels' launches."""
    from oavif_tpu_torch.scripts import profile_stages

    reset_counts()
    rows = profile_stages.profile({**images, "photo4k": frame4k})
    counts = read_counts()
    profile_stages.report(rows)
    for r in rows:
        if r["q"] != tq[r["image"]]:
            raise AssertionError(f"stages {r['image']}: q{r['q']}, the CLI "
                                 f"q{tq[r['image']]}")
    return counts


def phase_measure(png_dir: str, found: dict, mpix: float) -> dict:
    """The corpus harness over the six classes as PNG: sequential
    ``module:oavif_tpu_torch``, ``--window 6`` with every score on the
    device (``OAVIF_PIPELINE_METRIC=jax``), and two ranks sharing the card
    through ``parallel.spawn`` with no ``--shard``, then ``--merge``. Each
    CSV's Final Bytes and Passes must be the CLI's of this call; whether
    they are PERF.md §5's table is printed; ``mpix`` is the corpus's
    megapixels. Returns the launches."""
    import csv

    from oavif_tpu_torch.scripts import measure

    want = {f"{n}.png": (len(found[n, ("-t", "80")]["bytes"]),
                         found[n, ("-t", "80")]["passes"])
            for n in PERF_TABLE}
    total = dict.fromkeys(KERNELS, 0)

    def quiet_main(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = measure.main(argv)
        if rc != 0:
            raise AssertionError(f"measure {argv}: exit {rc}")
        return [ln for ln in buf.getvalue().splitlines()
                if ln.startswith("Images:")]

    with tempfile.TemporaryDirectory() as td:
        module = "module:oavif_tpu_torch"
        for mode in ("sequential", "window", "two ranks"):
            out = os.path.join(td, f"{mode.replace(' ', '_')}.csv")
            FR.reset_planners()
            reset_counts()
            t0 = time.perf_counter()
            if mode == "sequential":
                summary = quiet_main([png_dir, module, out])
                counts = read_counts()
            elif mode == "window":
                os.environ["OAVIF_PIPELINE_METRIC"] = "jax"
                try:
                    summary = quiet_main([png_dir, module, out, "--window",
                                          "6"])
                finally:
                    del os.environ["OAVIF_PIPELINE_METRIC"]
                counts = read_counts()
            else:
                shards = [os.path.join(td, f"shard{k}.csv") for k in (0, 1)]
                rcs, rcounts = parallel.spawn(
                    measure.shard_rank, 2,
                    args=([[png_dir, module, c] for c in shards],),
                    device="cuda", timeout_s=300)
                if rcs != [0, 0]:
                    raise AssertionError(f"measure ranks: exit {rcs}")
                counts = rank_counts(rcounts)
                summary = quiet_main([".", "x", out, "--merge", *shards])
            wall = time.perf_counter() - t0
            with open(out) as f:
                rows = list(csv.DictReader(f))
            got = {r["Image"]: (int(r["Final Bytes"]), int(r["Passes"]))
                   for r in rows if r["Status"] == "ok"}
            if got != want:
                raise AssertionError(f"measure {mode}: {got}, the CLI's "
                                     f"{want}")
            table = {f"{n}.png": v for n, v in PERF_TABLE.items()}
            moved = sorted(k for k in got if got[k] != table[k])
            if counts["planner_plan"] <= 0:
                raise AssertionError(f"measure {mode}: no planner launch")
            if mode == "window":
                scored_fused(counts, "measure window")
            total = add(total, counts)
            extra = ""
            if mode == "two ranks":
                ranks_s = []
                for c in shards:
                    with open(c) as f:
                        ranks_s.append(sum(float(r["Encoding Time (ms)"])
                                           for r in csv.DictReader(f)) / 1e3)
                extra = (f" (spawn and start-up included; the ranks' "
                         f"encodes {ranks_s[0]:.3f} and {ranks_s[1]:.3f} s)")
            print(f"  measure {mode}: corpus wall {wall:.3f} s{extra}, "
                  f"{mpix / wall:.3f} MP/s; {summary[0] if summary else ''}; "
                  f"bytes and passes == the CLI's; PERF.md §5's table: "
                  + ("equal" if not moved else f"moved for {moved} (the "
                     "CLI's of this call moved with them)")
                  + f"; launches {counts}", flush=True)
    return total


def _recon_planes():
    """Wrap the encoder's mux and recon conversion so that each encode's
    (AVIF bytes, recon YUV planes) lands in the returned dict; returns
    (dict, restore)."""
    from oavif_tpu_torch.av1 import encode as EN

    seen = {}
    mux, to_rgb = EN.mux_avif, EN.yuv444_to_rgb

    def mux_avif(*a, **k):
        seen["last"] = mux(*a, **k)
        return seen["last"]

    def yuv444_to_rgb(planes, *a, **k):
        seen[seen["last"]] = [np.array(p) for p in planes]
        return to_rgb(planes, *a, **k)

    EN.mux_avif, EN.yuv444_to_rgb = mux_avif, yuv444_to_rgb

    def restore():
        EN.mux_avif, EN.yuv444_to_rgb = mux, to_rgb

    return seen, restore


def with_alpha(rgb: np.ndarray) -> np.ndarray:
    """The image with an alpha plane: a diagonal ramp, fully transparent
    in its top-left quarter (``tests/torch_fixtures/avif/make_avif.py``
    writes its alpha fixtures with it)."""
    h, w = rgb.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    a = ((xx + yy) * 255 // max(h + w - 2, 1)).astype(np.uint8)
    a[: h // 4, : w // 4] = 0
    return np.concatenate([rgb, a[..., None]], -1)


def decode_streams(images: dict, frame4k: np.ndarray, tq: dict):
    """(name, ctx, extra environment) of ``phase_decode``'s streams: each
    class at its ``-t 80`` q, the 3840x2160 frame at q 60, and one stream
    per tool the encoder switches on."""
    from oavif_tpu_torch.backend import EncCtx
    from oavif_tpu_torch.io.image import Image
    from oavif_tpu_torch.options import EncOptions, TuneMode

    def ctx(rgb, q, **opts):
        h, w = rgb.shape[:2]
        ch = rgb.shape[2]
        c = EncCtx(o=EncOptions(**opts),
                   src=Image(width=w, height=h, channels=ch, hbd=False,
                             data=rgb), rgb=rgb[..., :3], w=w, h=h)
        c.q = q
        return c

    mixed, text = images["mixed"], images["text"]
    out = [(name, ctx(rgb, tq[name]), {}) for name, rgb in images.items()]
    out += [
        ("photo4k", ctx(frame4k, 60), {}),
        ("filter intra (speed 8)", ctx(mixed, 60, speed=8), {}),
        ("Wiener and SGR (speed 5)", ctx(mixed, 60, speed=5), {}),
        ("IDTX (--tune ssim)", ctx(mixed, 60, tune=TuneMode.SSIM), {}),
        ("palette (text)", ctx(text, 60), {}),
        ("lossless (-q 100)", ctx(text, 100), {}),
        ("8-bit output", ctx(mixed, 60, tenbit=False), {}),
        ("alpha lossless", ctx(with_alpha(mixed), 60, quality_alpha=100),
         {}),
        ("alpha --quality-alpha 50", ctx(with_alpha(mixed), 60,
                                         quality_alpha=50), {}),
        ("photo4k in 4 tiles", ctx(frame4k, 60, auto_tiling=False,
                                   tile_cols_log2=1, tile_rows_log2=1), {}),
        ("OAVIF_SB128=0", ctx(mixed, 60), {"OAVIF_SB128": "0"}),
    ]
    return out


def phase_decode(images: dict, frame4k: np.ndarray, tq: dict) -> dict:
    """The port's AVIF decoder on the port's own streams, on this
    machine (no libavif, no Pillow): each stream of ``decode_streams``,
    encoded by ``CudaBackend`` (the planner kernel launches), decodes
    through ``io.avif.decode_avif`` to exactly the recon's Y'UV; the
    recon's own conversion of the decoded planes gives the recon RGB
    exactly (the bar of ``tests/test_torch_decode.py``); an alpha item
    decodes to the source's alpha where it is lossless; and
    ``CudaBackend.decode_to_rgb8`` runs, its distance from the recon RGB
    printed (libavif's conversion, which it reproduces, narrows 10-bit
    Y'UV to 8 bits first). Returns the kernels' launches."""
    from oavif_tpu_torch.av1.encode import _depth_convert
    from oavif_tpu_torch.backend.cuda import CudaBackend
    from oavif_tpu_torch.io.avif import decode_avif

    backend = CudaBackend()
    seen, restore = _recon_planes()
    reset_counts()
    try:
        for name, ctx, env in decode_streams(images, frame4k, tq):
            saved = {k: os.environ.get(k) for k in [*env, "OAVIF_IDTX"]}
            os.environ.update(env)
            try:
                data, recon = backend.encode_with_recon(ctx)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            t0 = time.perf_counter()
            box, img, alpha = decode_avif(data)
            t_dec = time.perf_counter() - t0
            for i, (d, p) in enumerate(zip(img.planes, seen[data])):
                if not np.array_equal(d, p):
                    raise AssertionError(f"decode {name}: plane {i} != "
                                         "recon's")
            if not np.array_equal(yuv444_to_rgb(img.planes, img.bit_depth),
                                  recon):
                raise AssertionError(f"decode {name}: the recon's "
                                     "conversion of the decoded planes != "
                                     "the recon RGB")
            note = ""
            if alpha is not None:
                src = _depth_convert(ctx.src.data[..., 3], False,
                                     alpha.bit_depth)
                same = np.array_equal(alpha.planes[0], src)
                if ctx.o.quality_alpha == 100 and not same:
                    raise AssertionError(f"decode {name}: lossless alpha "
                                         "!= source")
                note = (f"; alpha item {alpha.bit_depth}-bit, "
                        f"{'== source' if same else 'lossy'}")
            dec = backend.decode_to_rgb8(data)
            diff = np.abs(dec.astype(int) - recon.astype(int))
            print(f"  decode {name} q{ctx.q}: {len(data)} bytes, "
                  f"{img.bit_depth}-bit Y'UV == recon's (decode "
                  f"{t_dec * 1e3:.3f} ms){note}; decode_to_rgb8 within "
                  f"{int(diff.max())} of the recon RGB "
                  f"({int((diff > 0).sum())} samples differ)", flush=True)
    finally:
        restore()
    counts = read_counts()
    if counts["planner_plan"] <= 0:
        raise AssertionError("the decode phase's encodes launched no "
                             "planner kernel")
    return counts


AVIF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "torch_fixtures", "avif")
AVIF_AOM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "torch_fixtures", "avif_aom")
AVIF_TOOLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "torch_fixtures", "avif_tools")
AVIF_SCREEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "torch_fixtures", "avif_screen")
AVIF_CONTAINER_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_container")
AVIF_SUPERRES_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_superres")
AVIF_LF_SEG_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_lf_seg")
AVIF_GAINMAP_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_gainmap")
AVIF_LAYERS_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_layers")
AVIF_ISPE_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_ispe")
AVIF_PROGRESSIVE_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_progressive")
AVIF_WARP_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_warp")
AVIF_REFMVS_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_refmvs")
AVIF_COMPOUND_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_compound")
AVIF_GLOBALMV_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_globalmv")
AVIF_INTERINTRA_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_interintra")
AVIF_FRAMETYPES_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_frametypes")
AVIF_SEQHDR_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
    "avif_seqhdr")
# the per-frame counts of inter-intra and segmentation map prediction
INTERINTRA_PER_FRAME = ("interintra", "interintra_wedge", "seg_id_predicted",
                        "seg_map_kept", "seg_temporal")
# the global motion counters: the global sides on each GmType past IDENTITY
GLOBAL_SIDES = ("global_translation", "global_rotzoom", "global_affine")
# the compound modes' counters, NEAREST_NEARESTMV .. NEW_NEWMV
COMPOUND_MODES = ("nearest_nearestmv", "near_nearmv", "nearest_newmv",
                  "new_nearestmv", "near_newmv", "new_nearmv",
                  "global_globalmv", "new_newmv")


def with_ispe(data: bytes, width: int, height: int) -> bytes:
    """``data`` with every ``ispe`` property saying width x height."""
    out = bytearray(data)
    at = 0
    while (at := out.find(b"ispe", at)) >= 0:
        out[at + 8:at + 16] = struct.pack(">II", width, height)
        at += 4
    return bytes(out)


def fixture_bytes(folder: str, name: str, entry: dict) -> bytes:
    """A fixture's bytes: its file, or for an entry that names a
    ``source`` file of another folder (``avif_ispe``'s 3840x2160
    rewrites), that file with its ``ispe`` rewritten in memory."""
    how = entry.get("written", {})
    if "source" in how:
        with open(os.path.join(os.path.dirname(folder), how["source"]),
                  "rb") as f:
            return with_ispe(f.read(), *how["ispe"])
    with open(os.path.join(folder, name), "rb") as f:
        return f.read()


def _read_avif_fixtures(folder: str, reps_4k: int, reps_small: int) -> dict:
    """Every fixture of ``folder`` decodes to its manifest's CRC32s
    (dav1d's Y'UV, and the reference's ``load_avif`` and
    ``decode_avif_to_rgb8`` pixels as Pillow gave them when the fixtures
    were made) and, where the manifest counts them, meets each tool the
    decoder counts as often, and where the manifest records them, the
    source libavif 1.3 reads (item or track), the grid's rows and columns,
    the alpha and its premultiplication, and where it records the frame
    header, the coded width, superres denominator and tile starts the
    port reads and the alpha's tools; each read timed (median of
    ``reps_small``, of ``reps_4k`` for a 3840x2160 file), split into
    parse and tile decode, post-filters, the superres upscale, film grain,
    a grid's stitch, the scaling to ``ispe`` and conversion, and for a
    layered item each frame's tile decode and post-filters
    (``tiles_f0``, ``filters_f0``, ...) and, where a frame used them, the
    time of OBMC and of the local warp in its tile decode (``obmc_f1``,
    ``warp_f1``, ...), of motion field estimation in the frame that
    projects (``project_f3``, ...), of the compound blocks' blends
    (``compound_f3``, ...), of the global warp (``gwarp_f2``, ...) and of
    inter-intra's intra predictions and blends (``ii_f1``, ...) with
    their shares of that frame's tile decode, and on a line before, for a
    frame that projected, the 8x8s its projection filled and the temporal
    candidates of each frame, for an item with compound blocks each
    frame's compound blocks (where the manifest counts them per frame, as
    many) and the item's count of each compound mode, type and kind of
    reference pair, and for an item with global motion or skip_mode blocks
    each frame's global sides and skip_mode blocks (where the manifest
    counts them, as many), its global warps and the blocks whose shear
    refused the warp, and for an item with inter-intra blocks or a
    segment map predicted from the previous one each frame's inter-intra
    blocks, wedge ones and blocks that took the predicted segment id and
    whether it kept or coded the map (where the manifest counts them, as
    many); a
    refusal fixture raises ``ValueError`` naming its tool, one the
    reference could not read (``raises``) the exception the manifest
    records, with its message, and one past the spec's limits
    (``broken``) ``OSError`` with the message the manifest records; where
    the manifest records each frame's coded width, upscaled width and
    height (``sizes``), the port reads them, and where it records each
    frame's header (``headers``: frame type, show_frame, the slot a
    show_existing_frame shows, refresh_frame_flags and the reference
    slots), the port reads it, and where it records each frame's coded
    video sequence (``sequences``), the port reads them. A file scaled to
    its ``ispe`` names its libyuv route (``route``) on its line, beside
    the scaling's time; an entry with a ``source`` is that file of another
    folder with its ``ispe`` rewritten in memory (``fixture_bytes``).
    Each file is decoded ``reps``
    times, and the CRCs, the counts and the loaded image are those of the
    last timed read (``decode_avif`` and the conversion ``read_avif``
    makes, ``avif_pixels``). A last line gives the folder's reads in all
    (the sum of every timed read) and its wall time. Returns the loaded
    images by file name."""
    from oavif_tpu_torch.io import avif
    from oavif_tpu_torch.io.image import Image, load_avif

    t_folder = time.perf_counter()
    with open(os.path.join(folder, "manifest.json")) as f:
        manifest = json.load(f)
    loaded = {}
    read_total, n_reads = 0.0, 0
    for name, entry in sorted(manifest.items()):
        path = os.path.join(folder, name)
        data = fixture_bytes(folder, name, entry)
        if "refuses" in entry:
            try:
                load_avif(path)
            except ValueError as e:
                if entry["refuses"] not in str(e):
                    raise AssertionError(f"{name}: refused with {e!r}, not "
                                         f"naming {entry['refuses']!r}")
                print(f"  {name}: refused ({e})", flush=True)
                continue
            raise AssertionError(f"{name}: decoded, not refused")
        if "raises" in entry:
            try:
                load_avif(path)
            except (ValueError, OSError) as e:
                if (type(e).__name__, str(e)) != (entry["port"],
                                                  entry["port_says"]):
                    raise AssertionError(f"{name}: raised {e!r}, not "
                                         f"{entry['port_says']!r}")
                print(f"  {name}: raises as the reference ({e})",
                      flush=True)
                continue
            raise AssertionError(f"{name}: decoded, the reference raises")
        if "broken" in entry:
            try:
                load_avif(path)
            except OSError as e:
                if str(e) != entry["broken"]:
                    raise AssertionError(f"{name}: raised {e!r}, not "
                                         f"{entry['broken']!r}")
                print(f"  {name}: raises ({e})", flush=True)
                continue
            raise AssertionError(f"{name}: decoded, past the limits")
        times, split = [], []
        reps = reps_4k if entry["load_shape"][1] >= 3840 else reps_small
        for _ in range(reps):
            # read_avif's work, its decode kept for the checks below
            t, t0 = {}, time.perf_counter()
            box, color, alpha = avif.decode_avif(
                fixture_bytes(folder, name, entry), t)
            arr, hbd, icc = avif.avif_pixels(box, color, alpha, t)
            times.append(time.perf_counter() - t0)
            split.append(t)
        read_total += sum(times)
        n_reads += reps
        # load_avif's image and the Y'UV, from the last read just timed
        img = Image(width=arr.shape[1], height=arr.shape[0],
                    channels=arr.shape[2], hbd=hbd, data=arr, icc=icc)
        yuv = np.concatenate([p.astype("<u2").reshape(-1)
                              for p in color.planes])
        got = (list(img.data.shape), img.hbd, len(img.icc or b""),
               zlib.crc32(img.data.tobytes()), zlib.crc32(yuv.tobytes()),
               # decode_avif_rgb8's pixels, from the same decode
               zlib.crc32(avif.yuv_to_rgb8(
                   color, rgba=alpha is not None,
                   prem=alpha if box.premultiplied else None).tobytes()),
               color.tools if "tools" in entry else None)
        want = (entry["load_shape"], entry["load_hbd"], entry["icc"],
                entry["load_crc"], entry["yuv_crc"], entry["rgb8_crc"],
                entry.get("tools"))
        if "source" in entry:
            got += (box.source, list(box.color.grid[:2]) if box.color.grid
                    else None, alpha is not None, box.premultiplied,
                    alpha.tools if alpha else None)
            want += (entry["source"], entry["grid"], entry["alpha"],
                     entry["premultiplied"], entry["alpha_tools"])
        if "header" in entry:
            fh = avif.parse_av1(box.color.payload).frame
            h = entry["header"]
            got += (fh.coded_width, fh.superres_denom, fh.tile_col_starts,
                    fh.tile_row_starts, alpha.tools if alpha else None)
            want += (h["coded_width"], h["superres_denom"],
                     h["tile_col_starts"], h["tile_row_starts"],
                     entry["alpha_tools"])
        if "frames" in entry:
            av1 = avif.parse_av1(box.color.payload)
            got += ([[f.spatial_id, f.frame.frame_type] for f in av1.frames],
                    av1.spatial_id, alpha.tools if alpha else None)
            want += (entry["frames"], entry["shows_layer"],
                     entry["alpha_tools"])
            if "sizes" in entry:
                got += ([[f.frame.coded_width, f.frame.width, f.frame.height]
                         for f in av1.frames],)
                want += (entry["sizes"],)
            if "refmvs" in entry:
                got += ([f.frame.use_ref_frame_mvs for f in av1.frames],)
                want += (entry["refmvs"],)
            if "compound" in entry:
                got += ([sum(t[m] for m in COMPOUND_MODES)
                         for t in color.frame_tools],)
                want += (entry["compound"],)
            if "global" in entry:
                got += ([sum(t[k] for k in GLOBAL_SIDES)
                         for t in color.frame_tools],
                        [t["skip_mode"] for t in color.frame_tools])
                want += (entry["global"], entry["skip_mode"])
            if "seg_temporal" in entry:
                got += tuple([t[k] for t in color.frame_tools]
                             for k in INTERINTRA_PER_FRAME)
                want += tuple(entry[k] for k in INTERINTRA_PER_FRAME)
            if "headers" in entry:
                got += ([[f.frame.frame_type, int(f.frame.show_frame),
                          f.frame.show_existing, f.frame.refresh_frame_flags,
                          list(f.frame.ref_frame_idx)] for f in av1.frames],)
                want += (entry["headers"],)
            if "sequences" in entry:
                got += ([f.sequence for f in av1.frames],)
                want += (entry["sequences"],)
        if got != want:
            raise AssertionError(f"{name}: decoded {got}, manifest {want}")
        loaded[name] = img
        per_frame = sorted(k for k in split[0] if k.startswith(
            ("tiles_f", "filters_f", "obmc_f", "warp_f", "project_f",
             "compound_f", "gwarp_f", "ii_f")))
        parts = ", ".join(
            f"{k} {np.median([t.get(k, 0.0) for t in split]) * 1e3:.3f}"
            for k in ("parse", "filters", "upscale", "grain", "refs",
                      "stitch", "scale", "convert", *per_frame))
        if color.tools["mf_projected"] or color.tools["temporal_mv"]:
            print(f"  {name}: per frame, 8x8s projected "
                  f"{[t['mf_projected'] for t in color.frame_tools]}, "
                  f"temporal candidates "
                  f"{[t['temporal_mv'] for t in color.frame_tools]}",
                  flush=True)
        if color.tools["comp_ref_unidir"] or color.tools["comp_ref_bidir"]:
            kinds = ("average", "distance", "wedge", "diffwtd")
            blocks = [sum(t[m] for m in COMPOUND_MODES)
                      for t in color.frame_tools]
            print(f"  {name}: per frame, compound blocks {blocks}; modes "
                  f"{[color.tools[m] for m in COMPOUND_MODES]}, "
                  f"types " + ", ".join(
                      f"{k} {color.tools['compound_' + k]}" for k in kinds)
                  + f", pairs unidirectional {color.tools['comp_ref_unidir']}"
                  f" bidirectional {color.tools['comp_ref_bidir']}, with a "
                  f"scaled side {color.tools['compound_scaled']}", flush=True)
        if any(color.tools[k] for k in GLOBAL_SIDES + ("skip_mode",)):
            print(f"  {name}: per frame, global sides "
                  f"{[sum(t[k] for k in GLOBAL_SIDES) for t in color.frame_tools]}"
                  f", skip_mode blocks "
                  f"{[t['skip_mode'] for t in color.frame_tools]}; sides by "
                  f"type " + ", ".join(
                      f"{k[7:]} {color.tools[k]}" for k in GLOBAL_SIDES)
                  + f", blocks warped {color.tools['global_warp']}, shear "
                  f"refused {color.tools['global_warp_invalid']}", flush=True)
        if any(color.tools[k] for k in INTERINTRA_PER_FRAME):
            print(f"  {name}: per frame, " + ", ".join(
                f"{k} {[t[k] for t in color.frame_tools]}"
                for k in INTERINTRA_PER_FRAME) + "; smooth by mode "
                + ", ".join(f"{k[3:]} {color.tools[k]}" for k in (
                    "ii_dc", "ii_v", "ii_h", "ii_smooth")), flush=True)
        # OBMC's, the warp's, the projection's, the compound blends', the
        # global warp's and inter-intra's shares of their own frame's tile
        # decode
        shares = ""
        for k in per_frame:
            used = [m + k[5:] for m in ("obmc", "warp", "project",
                                        "compound", "gwarp", "ii")
                    if k.startswith("tiles_f") and m + k[5:] in split[0]]
            if used:
                shares += f"; of {k}: " + ", ".join(
                    "{} {:.1%}".format(u, np.median(
                        [t.get(u, 0.0) / t[k] for t in split]))
                    for u in used)
        fmt = ("4:0:0" if color.mono else
               {(0, 0): "4:4:4", (1, 0): "4:2:2", (1, 1): "4:2:0"}[color.ss])
        route = f", libyuv route {entry['route']}" if "route" in entry \
            else ""
        print(f"  {name} {img.width}x{img.height}x{img.channels} "
              f"{'16' if img.hbd else '8'}-bit from {fmt} "
              f"{color.bit_depth}-bit ({len(data)} bytes{route}): == "
              f"manifest CRCs; "
              f"read {np.median(times) * 1e3:.3f} ms (median of {reps}, "
              f"{min(times) * 1e3:.3f}-{max(times) * 1e3:.3f}; {parts} ms"
              f"{shares})",
              flush=True)
    print(f"  {os.path.basename(folder)}: {n_reads} timed reads in all "
          f"{read_total:.3f} s; folder wall {time.perf_counter() - t_folder:.3f}"
          f" s", flush=True)
    return loaded


def phase_avif_input(images: dict, acc: dict) -> dict:
    """The port's AVIF reader and the CLI on AVIF input. Every fixture of
    ``tests/torch_fixtures/avif`` (the port's own streams and three of
    libaom's), of ``tests/torch_fixtures/avif_aom`` (libaom's: 4:2:0,
    4:2:2 and 4:4:4 at every speed and quality of its grid, CDEF strengths
    per 64x64, 10-bit, 12-bit, the 3840x2160 frame) and of
    ``tests/torch_fixtures/avif_tools`` (libaom's tools on request:
    quantizer matrices, delta q and delta LF, film grain, 12-bit, the
    chroma palette; limited range, ``irot``, ``imir`` and ``clap``;
    intrabc) and of ``tests/torch_fixtures/avif_screen`` (screen content,
    which libaom codes with intrabc at its defaults: every subsampling,
    speeds 2-7, qualities 30-100, alpha, two tiles, 128-pixel
    superblocks, 10 and 12 bits, 512x512 and 3840x2160, and libavif's
    ``grid`` of two cells) and of ``tests/torch_fixtures/avif_container``
    (grids, among them a cropped one and 3840x2160 of four 1920x1080
    cells; premultiplied alpha at 8, 10 and 12 bits; sequences, one
    without ``meta``; segmentation; an ``iovl`` item and ``iloc``
    construction method 2, which must raise naming the feature) and of
    ``tests/torch_fixtures/avif_superres`` (libaom's superres at
    denominators 9-16 on every subsampling and depth, with loop
    restoration, CDEF, alpha, grain and non-uniform tiles, and a
    3840x2160 frame coded 1920 wide) and of
    ``tests/torch_fixtures/avif_lf_seg`` (key frames written symbol by
    symbol with the segmentation features other than ALT_Q and
    ``delta_lf_multi``, 512x512 and 3840x2160 among them) and of
    ``tests/torch_fixtures/avif_gainmap`` (gain-map files, read as
    libavif 1.3 reads the colour image only; the ones it refuses must
    raise as the manifest says) and of ``tests/torch_fixtures/avif_layers``
    (items in two or three spatial layers: libaom's realtime inter frames
    at every subsampling, 8 and 10 bits, ``cpu-used`` 5-10, two tiles,
    alpha, the six classes and a 3840x2160 frame, layer 1 written symbol
    by symbol for the filters and 4x4 blocks libaom does not write, OBMC
    and a local warp, and three layers with reference MVs on an inter
    frame) and of ``tests/torch_fixtures/avif_ispe`` (frames
    scaled to an ``ispe`` of another size by each of libyuv's routes, the
    box filter, 3/4, 3/8, 1/4 and point sampling among them, at 8, 10
    and 12 bits, one past libavif's limits, and two 3840x2160 files of
    other folders with their ``ispe`` rewritten in memory to the box, 3/4,
    3/8 and 1/4 routes, each read once) and of ``tests/torch_fixtures/avif_progressive``
    (progressive items: layer 0 at each of libaom's scaling modes, 4:2:2,
    4:4:4, monochrome, 10 and 12 bits, three layers, alpha, two tiles,
    the six classes and a 3840x2160 frame on a 1920x1080 layer 0, a
    reference larger than its frame, superres inter frames, OBMC; and
    references past the 2x and 1/16 limits, which must raise ``OSError``)
    and of ``tests/torch_fixtures/avif_warp`` (OBMC and local warps:
    libaom's at ``cpu-used`` 5 and 6 on every subsampling at 8, 10 and 12
    bits, three layers, alpha, two tiles, the six classes and two
    progressive items; written ones that fall back to translation, OBMC
    beside two filters and on 4:2:2, and a 3840x2160 frame) and of
    ``tests/torch_fixtures/avif_refmvs`` (three and four layers with
    ``use_ref_frame_mvs``, whose fourth layer projects the second's MVs
    and reads temporal candidates: every subsampling at 8, 10 and 12 bits,
    ``cpu-used`` 5-10, two tiles, 128-pixel superblocks, alpha, the six
    classes, two progressive items and a 3840x2160 frame; a compound
    block libaom writes at 1280x720, once refused) and of
    ``tests/torch_fixtures/avif_compound`` (compound blocks: libaom's
    four layers on every subsampling at 8, 10 and 12 bits, 1280x720 at
    ``cpu-used`` 7-10 and 1920x1080 at 5-6, two tiles, 128-pixel
    superblocks, alpha, a progressive item, the six classes and a
    3840x2160 frame; frames written in every compound mode and type on
    unidirectional and bidirectional pairs, at different distances, on
    both sides of the frame, through a scaled reference and beside
    single-reference blocks) and of ``tests/torch_fixtures/avif_globalmv``
    (global motion of every type and skip_mode blocks, written over
    libaom's layers: TRANSLATION, ROTZOOM and AFFINE beside the other
    modes, a shear the warp refuses, OBMC and local warps beside global
    blocks, GLOBAL_GLOBALMV with warped, translated and scaled sides,
    gm_params coded against a primary reference's, skip_mode on
    bidirectional and forward pairs, with delta q and 128-pixel
    superblocks, every subsampling at 8, 10 and 12 bits, the mixed class
    and a 3840x2160 frame with both tools) and of
    ``tests/torch_fixtures/avif_interintra`` (inter-intra blocks of every
    interintra_mode, smooth and by wedge, and segment ids predicted from
    the previous map: written over libaom's layers, GLOBALMV inter-intra
    blocks warped, OBMC and local warps beside them, a scaled reference,
    128-pixel superblocks, inherited adapted CDFs, a kept map, a map
    coded against the previous one in four tile rows, one of another
    size, libaom's own cyclic-refresh temporal update, every subsampling
    at 8, 10 and 12 bits, the mixed class and a 3840x2160 frame pair with
    both tools) and of ``tests/torch_fixtures/avif_frametypes`` (every
    frame type and header form: libaom's error-resilient layers with
    frame ids and its S-frames on top and in the middle, at every
    subsampling and depth in two to four layers; INTRA_ONLY frames shown,
    first, with intrabc and as a GOLDEN reference; a hidden key frame and
    a hidden inter frame with film grain, each shown by
    show_existing_frame; frame_refs_short_signaling, once with frame ids;
    three refusals that must raise ``OSError``; the mixed class and a
    3840x2160 frame in error-resilient layers with an S-frame on top) and
    of ``tests/torch_fixtures/avif_seqhdr`` (a second sequence header:
    repeated with other operating parameters, or differing and so starting
    a new coded video sequence before the frame it governs; two refusals
    that must raise ``OSError``)
    decodes
    to its manifest (``_read_avif_fixtures``, each file decoded as often
    as it is timed, and each folder's reads in all on a line),
    the reads split into parse and tile decode (each frame's apart),
    post-filters, the superres upscale, film grain, a grid's stitch, the
    scaling and conversion (every file read once, to keep the phase's
    time, but ``avif_frametypes``' 3840x2160 frame, the median of 3;
    ``avif_warp``'s reads also time
    OBMC and the local warp in the tile decode, ``avif_refmvs``'s motion
    field estimation, with the per-frame counts of its projected 8x8s and
    temporal candidates, ``avif_compound``'s the compound blends, with
    each frame's compound blocks and the counts of their modes and types,
    ``avif_globalmv``'s the global warp, with each frame's global
    sides and skip_mode blocks, and ``avif_interintra``'s inter-intra's
    intra predictions and blends, with each frame's inter-intra blocks,
    wedge ones and predicted segment ids).
    Then the CLI ``-t 80`` on the six class AVIFs of the first two
    folders and ``-q 60`` on the first's 3840x2160 one, ``-t 80`` on the
    512x512 limited-range file with an ``irot``, ``-t 80`` on the 512x512
    screen, ``-t 80`` on the 512x512 segmented sequence, ``-t 80`` on the
    512x512 superres class, ``-t 80`` on the 512x512 ALT_LF, SKIP and
    ``delta_lf_multi`` frame, and ``-t 80`` on the 512x512 class of each
    inter folder (two layers, progressive, OBMC and local warps, four
    layers with reference MVs, compound blocks, global motion and
    skip_mode, inter-intra and a predicted segment map, error-resilient
    layers with frame ids and an S-frame on top), with ``-q 60`` on the
    3840x2160 frame of the last two (the other folders' 3840x2160 picks
    are read and held to their manifests, not encoded), ``-t 80`` on the
    512x512 frame scaled from 1040x1040 by libyuv's box filter and ``-q
    60`` on the 8-bit 3840x2160 frame rewritten to 1280x720:
    q, passes and bytes must be those of the CLI on the same
    pixels, written as PAM where they are 8-bit and handed over in memory
    where they are 16-bit (PAM holds 8 bits). Returns the kernels'
    launches."""
    from oavif_tpu_torch.io.image import Image

    reset_counts()
    runs = []
    for folder, picks in (
            (AVIF_DIR, [(f"{name}.avif", ["-t", "80"]) for name in images]
             + [("photo4k_q60.avif", ["-q", "60"])]),
            (AVIF_AOM_DIR, [(f"class_{name}_420.avif", ["-t", "80"])
                            for name in images]),
            (AVIF_TOOLS_DIR, [("limited_512_orient6_420_mixed.avif",
                               ["-t", "80"])]),
            (AVIF_SCREEN_DIR, [("screen512.avif", ["-t", "80"])]),
            (AVIF_CONTAINER_DIR, [("seg512_420_q60.avif", ["-t", "80"])]),
            (AVIF_SUPERRES_DIR, [("class_mixed_d12_420.avif", ["-t", "80"])]),
            (AVIF_LF_SEG_DIR, [("lf_seg512_420.avif", ["-t", "80"])]),
            (AVIF_GAINMAP_DIR, []),
            (AVIF_LAYERS_DIR, [("class_mixed_512.avif", ["-t", "80"])]),
            (AVIF_ISPE_DIR, [("class_mixed_512_box.avif", ["-t", "80"]),
                             ("photo4k_420_q60@1280x720", ["-q", "60"])]),
            (AVIF_PROGRESSIVE_DIR, [("class_mixed_512.avif", ["-t", "80"])]),
            (AVIF_WARP_DIR, [("class_mixed_512.avif", ["-t", "80"])]),
            (AVIF_REFMVS_DIR, [("class_mixed_512.avif", ["-t", "80"])]),
            (AVIF_COMPOUND_DIR, [("class_mixed_512.avif", ["-t", "80"])]),
            (AVIF_GLOBALMV_DIR, [("class_mixed_512.avif", ["-t", "80"])]),
            (AVIF_INTERINTRA_DIR, [("class_mixed_512.avif", ["-t", "80"]),
                                   ("photo4k_420.avif", ["-q", "60"])]),
            (AVIF_FRAMETYPES_DIR, [("class_mixed_512.avif", ["-t", "80"]),
                                   ("photo4k_420.avif", ["-q", "60"])]),
            (AVIF_SEQHDR_DIR, [])):
        # every file read once (the newest folder's 3840x2160 frame three
        # times), to keep the phase's time; the 3840x2160 CLI pair only in
        # the first folder and the two newest (the others' 512x512 pairs
        # drive the same CLI path on the same kind of input)
        loaded = _read_avif_fixtures(
            folder, 3 if folder == AVIF_FRAMETYPES_DIR else 1, 1)
        runs += [(folder, name, loaded[name], args) for name, args in picks]
    with tempfile.TemporaryDirectory() as td:
        for folder, pick, img, args in runs:
            src = os.path.join(folder, pick)
            name = os.path.relpath(src, os.path.dirname(AVIF_DIR))
            if not os.path.exists(src):  # an ispe rewritten in memory
                with open(os.path.join(folder, "manifest.json")) as f:
                    entry = json.load(f)[pick]
                src = os.path.join(td, "rewritten.avif")
                with open(src, "wb") as f:
                    f.write(fixture_bytes(folder, pick, entry))
            r = run_cli(args, src, os.path.join(td, "o.avif"), acc)
            if img.hbd:
                how = "the same 16-bit pixels in memory"
                load = cli.load_image
                cli.load_image = lambda _path, img=img: Image(
                    width=img.width, height=img.height,
                    channels=img.channels, hbd=True, data=img.data.copy(),
                    icc=img.icc)
                try:
                    p = run_cli(args, src, os.path.join(td, "o.avif"), acc)
                finally:
                    cli.load_image = load
            else:
                how = "PAM of its pixels"
                pam = os.path.join(td, "in.pam")
                write_pam(pam, img.data)
                p = run_cli(args, pam, os.path.join(td, "o.avif"), acc)
            if (r["q"], r["passes"], r["bytes"]) != (p["q"], p["passes"],
                                                     p["bytes"]):
                raise AssertionError(
                    f"{name} {' '.join(args)}: q{r['q']} {r['passes']} "
                    f"passes {len(r['bytes'])} bytes, {how} q{p['q']} "
                    f"{p['passes']} passes {len(p['bytes'])} bytes")
            print(f"  {name} {' '.join(args)}: q{r['q']} passes "
                  f"{r['passes']} bytes {len(r['bytes'])} == {how}; wall "
                  f"{r['wall']:.3f} s", flush=True)
    return read_counts()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # Keep CUPTI attached between torch.profiler sessions: after kineto's
    # default teardown and re-initialisation, some later sessions of a
    # process lose every device record on the card.
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
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

    launch_pieces()
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
    launches, tq, found = phase_main_path({**images, "photo4k": frame4k},
                                          acc)
    print(f"phase main path (CLI): {time.perf_counter() - t0:.1f} s, "
          f"launches {launches}", flush=True)
    if launches["planner_plan"] <= 0:
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

    t0 = time.perf_counter()
    levels = phase_levels_kernels(images, frame4k)
    print(f"phase encode-stage kernels: {time.perf_counter() - t0:.1f} s, "
          f"worst |kernel - plain| {levels['worst']}", flush=True)

    t0 = time.perf_counter()
    counts = phase_levels_path(images, acc)
    launches = {k: launches[k] + counts[k] for k in launches}
    print(f"phase main path (device levels): {time.perf_counter() - t0:.1f} "
          f"s, launches {counts}", flush=True)

    t0 = time.perf_counter()
    iir = phase_iir(images, frame4k)
    print(f"phase recursive blur kernel: {time.perf_counter() - t0:.1f} s, "
          f"worst |kernel - plain| {iir['worst']}", flush=True)
    t0 = time.perf_counter()
    counts = phase_iir_path(images, acc)
    launches = add(launches, counts)
    print(f"phase main path (recursive blur CLI): "
          f"{time.perf_counter() - t0:.1f} s, launches {counts}", flush=True)

    t0 = time.perf_counter()
    md = phase_multi_device(frame4k)
    launches = add(launches, md["launches"])
    print(f"phase multi-device: {time.perf_counter() - t0:.1f} s, launches "
          f"{md['launches']}", flush=True)

    with tempfile.TemporaryDirectory() as png_dir:
        t0 = time.perf_counter()
        counts = phase_png_input(images, frame4k, found, png_dir, acc)
        launches = add(launches, counts)
        print(f"phase PNG input: {time.perf_counter() - t0:.1f} s, launches "
              f"{counts}", flush=True)
        t0 = time.perf_counter()
        mpix = sum(rgb.shape[0] * rgb.shape[1]
                   for rgb in images.values()) / 1e6
        counts = phase_measure(png_dir, found, mpix)
        launches = add(launches, counts)
        print(f"phase measure: {time.perf_counter() - t0:.1f} s, launches "
              f"{counts}", flush=True)

    t0 = time.perf_counter()
    counts = phase_jpeg_input(images, frame4k, acc)
    launches = add(launches, counts)
    print(f"phase JPEG input: {time.perf_counter() - t0:.1f} s, launches "
          f"{counts}", flush=True)
    if counts["planner_plan"] <= 0:
        raise AssertionError("the JPEG path launched no planner kernel")

    t0 = time.perf_counter()
    counts = phase_webp_input(images, acc)
    launches = add(launches, counts)
    print(f"phase WebP input: {time.perf_counter() - t0:.1f} s, launches "
          f"{counts}", flush=True)
    if counts["planner_plan"] <= 0:
        raise AssertionError("the WebP path launched no planner kernel")

    t0 = time.perf_counter()
    counts = phase_stages(images, frame4k, tq)
    launches = add(launches, counts)
    print(f"phase stages: {time.perf_counter() - t0:.1f} s, launches "
          f"{counts}", flush=True)

    t0 = time.perf_counter()
    counts = phase_decode(images, frame4k, tq)
    launches = add(launches, counts)
    print(f"phase decode: {time.perf_counter() - t0:.1f} s, launches "
          f"{counts}", flush=True)

    t0 = time.perf_counter()
    counts = phase_avif_input(images, acc)
    launches = add(launches, counts)
    print(f"phase AVIF input: {time.perf_counter() - t0:.1f} s, launches "
          f"{counts}", flush=True)
    if counts["planner_plan"] <= 0:
        raise AssertionError("the AVIF path launched no planner kernel")

    t0 = time.perf_counter()
    phase_trace(images, acc)
    print(f"phase trace: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    phase_trace_harness(images, acc)
    print(f"phase traced harness: {time.perf_counter() - t0:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    phase_plan_trace(images, frame4k)
    print(f"phase planner trace: {time.perf_counter() - t0:.1f} s",
          flush=True)

    times = {"planner_plan": kern["times"]["3840x2160"],
             **metric["times"]["photo 3840x2160"], **levels["times"],
             "ssim2_blur_iir": iir["times"], **md["times"]}
    worst = {"planner_plan": kern["worst"], **metric["worst"],
             **levels["worst"], "ssim2_blur_iir": iir["worst"],
             "wiener_bands": md["worst"]}
    worst["ssim2_blur"] = max(worst["ssim2_blur"], md["halo_err"])
    rows = []
    for name, (_, source, replaces) in KERNELS.items():
        t = times[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": worst[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"], "host_us": t["host_us"],
                     **{k: t[k] for k in ("simple_ms", "simple_device_ms",
                                          "pair_ms", "host_us_before",
                                          "checks_us")
                        if k in t}})
        if name in YARDSTICK_OF:
            rows[-1]["yardstick"] = YARDSTICK_OF[name]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
