"""Encoder options and CLI argument parsing.

Behavioral parity with the reference option system
(oavif src/parse_args.zig:48-178): same flags, same defaults, same
strict range checks, same "value may not start with '-'" rule, same positional
<in> <out> capture, same error messages on stderr.
"""

from __future__ import annotations

import enum
import math
import sys
from dataclasses import dataclass, field
from typing import List, Optional


class TuneMode(enum.Enum):
    """RD tuning mode (reference parse_args.zig:26-45).

    In the reference these are forwarded to libaom as a codec-specific
    option; in this encoder they select the perceptual rate-allocation
    model (oavif_tpu.av1.encode): SSIM enables the variance-adaptive
    (masking) lambda only; IQ (default) and SSIMULACRA2 additionally apply
    the chroma AC delta-q that concentrates rate on luma structure.
    """

    SSIM = "ssim"
    IQ = "iq"
    SSIMULACRA2 = "ssimulacra2"

    @staticmethod
    def from_string(s: str) -> "TuneMode":
        for m in TuneMode:
            if m.value == s:
                return m
        raise OptionError("invalid tune mode")


class OptionError(ValueError):
    """Raised on malformed CLI arguments (maps reference error unions)."""


@dataclass
class EncOptions:
    """All user-facing encoder options.

    Defaults mirror the reference struct defaults exactly
    (parse_args.zig:48-64). Note quality_alpha's *struct* default is 0 even
    though the reference README displays 100 — we replicate the struct.
    """

    quality_alpha: int = 0
    speed: int = 9
    max_threads: int = 1
    tile_rows_log2: int = 0
    tile_cols_log2: int = 0
    auto_tiling: bool = True
    score_tgt: float = 80.0
    tenbit: bool = True
    tune: TuneMode = TuneMode.IQ
    tolerance: float = 2.0
    max_pass: int = 6
    quality: Optional[int] = None
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2


def _value_arg(args: List[str], i: int, name: str) -> str:
    """Fetch the value token for option ``name`` (parse_args.zig:126-129).

    The reference rejects a value token whose first byte is '-'.
    """
    if i >= len(args) or (args[i] and args[i][0] == "-"):
        print(f"Error: Missing {name} value", file=sys.stderr)
        raise OptionError(f"missing {name} value")
    return args[i]


def _int_arg(args: List[str], i: int, lo: int, hi: int, name: str) -> int:
    tok = _value_arg(args, i, name)
    try:
        v = int(tok, 10)
    except ValueError:
        print(f"Error: invalid {name} value: {tok}", file=sys.stderr)
        raise OptionError(f"invalid integer for {name}: {tok!r}")
    if v < lo or v > hi:
        print(f"Error: {name} must be between {lo} and {hi}", file=sys.stderr)
        raise OptionError(f"{name} out of range")
    return v


def _float_arg(args: List[str], i: int, lo: float, hi: float, name: str) -> float:
    tok = _value_arg(args, i, name)
    try:
        v = float(tok)
    except ValueError:
        print(f"Error: invalid {name} value: {tok}", file=sys.stderr)
        raise OptionError(f"invalid float for {name}: {tok!r}")
    if v < lo or v > hi or math.isnan(v):
        print(f"Error: {name} must be between {lo} and {hi}", file=sys.stderr)
        raise OptionError(f"{name} out of range")
    return v


def _bool_arg(args: List[str], i: int, name: str) -> bool:
    tok = _value_arg(args, i, name)
    try:
        v = int(tok, 10)
    except ValueError:
        raise OptionError(f"invalid 0/1 for {name}: {tok!r}")
    if v not in (0, 1):
        print(f"Error: {name} must be 0 or 1", file=sys.stderr)
        raise OptionError(f"{name} must be 0 or 1")
    return v == 1


def _tune_arg(args: List[str], i: int, name: str) -> TuneMode:
    tok = _value_arg(args, i, name)
    try:
        return TuneMode.from_string(tok)
    except OptionError:
        print(f"Error: {name} must be one of: ssim, iq, ssimulacra2", file=sys.stderr)
        raise


@dataclass
class ParsedArgs:
    options: EncOptions = field(default_factory=EncOptions)
    input_file: Optional[str] = None
    output_file: Optional[str] = None


def parse_args(argv: List[str]) -> ParsedArgs:
    """Parse CLI arguments (reference parse_args.zig:76-122).

    ``argv`` excludes the program name. Unknown leading-dash tokens become
    positionals in the reference too (it only special-cases known flags), so
    we match: first unmatched token → input, second → output, third → error.
    """
    p = ParsedArgs()
    o = p.options
    i = 0
    while i < len(argv):
        arg = argv[i]
        i += 1
        if arg in ("-s", "--speed"):
            o.speed = _int_arg(argv, i, 0, 10, "--speed")
            i += 1
        elif arg in ("-t", "--score-tgt"):
            o.score_tgt = _float_arg(argv, i, 30.0, 100.0, "--score-tgt")
            i += 1
        elif arg == "--quality-alpha":
            # reference validates 0..99 but documents 100 = lossless
            # (parse_args.zig:88 vs the usage text); accept the documented
            # intent — 100 engages the CodedLossless alpha path
            o.quality_alpha = _int_arg(argv, i, 0, 100, "--quality-alpha")
            i += 1
        elif arg == "--max-threads":
            o.max_threads = _int_arg(argv, i, 1, 255, "--max-threads")
            i += 1
        elif arg == "--tile-rows-log2":
            o.tile_rows_log2 = _int_arg(argv, i, 0, 6, "--tile-rows-log2")
            i += 1
        elif arg == "--tile-cols-log2":
            o.tile_cols_log2 = _int_arg(argv, i, 0, 6, "--tile-cols-log2")
            i += 1
        elif arg == "--auto-tiling":
            o.auto_tiling = _bool_arg(argv, i, "--auto-tiling")
            i += 1
        elif arg == "--tune":
            o.tune = _tune_arg(argv, i, "--tune")
            i += 1
        elif arg == "--tenbit":
            o.tenbit = _bool_arg(argv, i, "--tenbit")
            i += 1
        elif arg == "--tolerance":
            o.tolerance = _float_arg(argv, i, 1.0, 100.0, "--tolerance")
            i += 1
        elif arg == "--max-pass":
            o.max_pass = _int_arg(argv, i, 1, 12, "--max-pass")
            i += 1
        elif arg in ("-q", "--quality"):
            o.quality = _int_arg(argv, i, 0, 100, "--quality")
            i += 1
        elif arg == "--color-primaries":
            o.color_primaries = _int_arg(argv, i, 1, 22, "--color-primaries")
            i += 1
        elif arg == "--transfer-characteristics":
            o.transfer_characteristics = _int_arg(
                argv, i, 1, 18, "--transfer-characteristics"
            )
            i += 1
        elif arg == "--matrix-coefficients":
            o.matrix_coefficients = _int_arg(
                argv, i, 0, 14, "--matrix-coefficients"
            )
            i += 1
        elif p.input_file is None:
            p.input_file = arg
        elif p.output_file is None:
            p.output_file = arg
        else:
            print(f"Error: Unexpected argument: {arg}", file=sys.stderr)
            raise OptionError(f"unexpected argument: {arg}")
    return p


def usage_text() -> str:
    """Help text (reference parse_args.zig:180-238, defaults live)."""
    d = EncOptions()
    return f"""
usage:  oavif-tpu [options] <in> <out.avif>

options:
 -h, --help
    show this help
 -v, --version
    show version information
 -s, --speed u8
    encoder speed (0..10) [{d.speed}]
 -t, --score-tgt f64
    target SSIMULACRA2 score (0..100) [{d.score_tgt:.0f}]
 --quality-alpha u8
    quality factor for alpha (0..100=lossless) [{d.quality_alpha}]
 --max-threads u8
    maximum number of threads to use (1..255) [{d.max_threads}]
 --tile-rows-log2 u8
    tile rows log2 (0..6) [{d.tile_rows_log2}]
 --tile-cols-log2 u8
    tile columns log2 (0..6) [{d.tile_cols_log2}]
 --auto-tiling 0/1
    enable automatic tiling [{1 if d.auto_tiling else 0}]
 --tune str
    tuning mode (ssim, iq, ssimulacra2) [{d.tune.value}]
 --tenbit 0/1
    force 10-bit AVIF output [{1 if d.tenbit else 0}]
 --tolerance f64
    target quality error tolerance (1..100) [{d.tolerance:.0f}]
 --max-pass u8
    maximum search passes (1..12) [{d.max_pass}]
 -q, --quality u8
    quantizer (0..100), bypasses search
 --color-primaries u8
    color primaries (1..22) [{d.color_primaries}]
 --transfer-characteristics u8
    transfer characteristics (1..18) [{d.transfer_characteristics}]
 --matrix-coefficients u8
    matrix coefficients (0..14) [{d.matrix_coefficients}]

\x1b[37mInput image formats: PNG, PAM, JPEG, WebP, or AVIF\x1b[0m
"""
