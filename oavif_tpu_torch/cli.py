"""CLI driver of the port; the counterpart of oavif_tpu/cli.py.

Same flags, orchestration and progress lines on stderr: banner -> -h/-v
pre-scan -> parse -> load -> (search | fixed-q bypass) -> write. Encodes
through ``CudaBackend`` on the device ``resolve_device()`` picks (CUDA,
or the CPU under OAVIF_TORCH_DEVICE=cpu).

    python -m oavif_tpu_torch.cli -t 80 in.pam out.avif
"""

from __future__ import annotations

import os
import sys
from typing import List

from . import __version__
from .backend import EncBuffer, EncCtx
from .backend.cuda import CudaBackend
from .device import resolve_device
from .io.image import load_image, to_rgb8
from .options import OptionError, parse_args, usage_text


def _perr(msg: str) -> None:
    print(msg, file=sys.stderr)


def _print_version() -> None:
    import torch

    _perr(f"oavif-tpu-torch {__version__}")
    device = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
              else "no CUDA device")
    _perr(f"torch {torch.__version__}, CUDA {torch.version.cuda} "
          f"[{device}]")


def _start_trace(device, trace_dir: str):
    """A started ``torch.profiler`` session of the host, and of the card's
    kernels on CUDA, that writes a Chrome trace into ``trace_dir`` when
    stopped. CUPTI stays attached between sessions (``TEARDOWN_CUPTI=0``,
    unless the caller set it): after kineto's default teardown, a later
    session of the same process (the harness runs one search per image)
    can lose every device record."""
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))
    prof.start()
    return prof


def run(argv: List[str]) -> int:
    _perr(f"\x1b[31moavif-tpu-torch\x1b[0m | {__version__}")

    # argv pre-scan for -h/-v
    for arg in argv:
        if arg in ("--help", "-h"):
            _perr(usage_text())
            return 0
        if arg in ("--version", "-v"):
            _print_version()
            return 0
        break

    try:
        parsed = parse_args(argv)
    except OptionError:
        return 1
    o = parsed.options

    if parsed.input_file is None or parsed.output_file is None:
        _perr("Error: missing input or output path")
        return 1
    device = resolve_device()  # no device, no encode: fail before any work

    try:
        src = load_image(parsed.input_file)
    except (OSError, ValueError) as e:
        _perr(f"Error: {e}")
        return 1

    in_depth = 16 if src.hbd else 8
    in_bytes = os.path.getsize(parsed.input_file)
    _perr(
        f"Read {src.width}x{src.height}, "
        f"{'RGBA' if src.channels > 3 else 'RGB'}, {in_depth}-bit, {in_bytes} bytes"
    )

    rgb = to_rgb8(src)
    ctx = EncCtx(o=o, src=src, rgb=rgb, w=src.width, h=src.height)
    backend = CudaBackend()
    out_depth = 10 if o.tenbit else (10 if src.hbd else 8)

    if o.quality is not None:  # bypass the search
        ctx.q = o.quality
        _perr(f"Encoding [q{o.quality}, speed {o.speed}, {out_depth}-bit]")
        data = backend.encode(ctx)
        with open(parsed.output_file, "wb") as f:
            f.write(data)
        ctx.buf = EncBuffer(q=ctx.q, data=data, size=len(data))
        bpp = len(data) * 8 / (ctx.w * ctx.h)
        _perr(f"Compressed to {len(data)} bytes ({bpp:.3f} bpp)")
        return 0

    from .tq.driver import search_encode

    _perr(
        f"Searching [tgt {o.score_tgt:g}±{o.tolerance:.1f}, "
        f"speed {o.speed}, {out_depth}-bit]"
    )
    # OAVIF_TRACE=<dir> captures a torch.profiler trace of the search (the
    # host, and the card's kernels on CUDA) as a Chrome trace in <dir>
    trace_dir = os.environ.get("OAVIF_TRACE")
    prof = _start_trace(device, trace_dir) if trace_dir else None
    try:
        result, data = search_encode(ctx, backend)
    finally:
        if prof is not None:
            prof.stop()
            _perr(f"Profiler trace written to {trace_dir}")
    if os.environ.get("OAVIF_VERBOSE") == "1":
        _perr(f"Pass timings (ms): {search_encode.last_timings}")
    rounds = ""
    if 0 < ctx.num_rounds < ctx.num_pass:
        # batched mode: several encodes share one scoring round
        rounds = f" in {ctx.num_rounds} rounds"
    _perr(
        f"Found q{result.q} (score {result.score:.2f}, "
        f"{ctx.num_pass} passes{rounds})"
    )

    with open(parsed.output_file, "wb") as f:
        f.write(data)
    bpp = len(data) * 8 / (ctx.w * ctx.h)
    _perr(f"Compressed to {len(data)} bytes ({bpp:.3f} bpp)")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
