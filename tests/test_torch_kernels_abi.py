"""The ctypes binding of the CUDA kernels against their C sources.

``kernels/build.py`` declares each C entry's argument types by hand; a
count or a type that drifts from the source would pass a pointer cut to
32 bits or shift every later argument, and only a run on a card would
show it. This parses every ``extern "C" int name(...)`` of
``oavif_tpu_torch/csrc/*.cu`` and holds ``build.entries`` to it: the same
names, as many ``argtypes`` as the C function has parameters, pointers and
the stream as ``c_void_p``, ``int`` as ``c_int``, ``float`` as
``c_float``. Needs no card and no compiler.
"""

from __future__ import annotations

import ctypes as C
import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from oavif_tpu_torch.kernels import build  # noqa: E402

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)
_SCALARS = {"int": C.c_int, "float": C.c_float}


def _ctype(param: str):
    """The ctypes type of one C parameter declaration."""
    decl = " ".join(param.split())
    if "*" in decl or decl.startswith("cudaStream_t"):
        return C.c_void_p
    words = [w for w in decl.split(" ")[:-1] if w != "const"]
    assert len(words) == 1 and words[0] in _SCALARS, (
        f"no ctypes type known for the C parameter {decl!r}")
    return _SCALARS[words[0]]


def _c_entries() -> dict:
    """{name: [ctypes type per parameter]} of every C entry in csrc."""
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for name, params in _ENTRY.findall(src.read_text()):
            assert name not in found, f"{name} is defined twice"
            found[name] = [_ctype(p) for p in params.split(",")]
    return found


def test_entries_name_exactly_the_c_entries():
    assert sorted(build.entries) == sorted(_c_entries())
    assert len(build.entries) >= 10


@pytest.mark.parametrize("name", sorted(build.entries))
def test_entry_argtypes_match_the_c_signature(name):
    want = _c_entries()[name]
    got = build.entries[name]
    assert len(got) == len(want), (
        f"{name}: {len(got)} argtypes for {len(want)} C parameters")
    assert got == want
    # every entry ends in the stream
    assert got[-1] is C.c_void_p


def test_the_parser_reads_a_declaration():
    """The parser itself, on a declaration written here."""
    text = ('extern "C" int f(const float* a, int n, float c2,\n'
            '                 double* out, cudaStream_t stream) {')
    (name, params), = _ENTRY.findall(text)
    assert name == "f"
    assert [_ctype(p) for p in params.split(",")] == [
        C.c_void_p, C.c_int, C.c_float, C.c_void_p, C.c_void_p]
