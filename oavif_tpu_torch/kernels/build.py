"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``oavif_tpu_torch/csrc/*.cu`` for sm_90a into one shared
library with a plain C interface under ``build/oavif_tpu_torch/`` (listed
in .gitignore), rebuilt when a source is newer than the library, and
``ctypes`` loads it. Pointers go in as ``c_void_p`` from
``tensor.data_ptr()``, with ``torch.cuda.current_stream().cuda_stream``;
each entry returns ``cudaGetLastError()``. A failed build raises: there is
no fallback.
"""

from __future__ import annotations

import ctypes as C
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "oavif_tpu_torch"
LIB_PATH = BUILD_DIR / "liboavif_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[C.CDLL] = None
_lock = threading.Lock()
# nvcc's output of the last build in this process (ptxas register and
# shared-memory usage per kernel); empty when the library was up to date
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def _build() -> None:
    global build_log
    srcs = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = Path(td) / LIB_PATH.name
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        build_log = proc.stdout + proc.stderr
        os.replace(tmp, LIB_PATH)


def load() -> C.CDLL:
    """The kernels' library, built on first use in this checkout."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        newest = max(s.stat().st_mtime for s in CSRC.glob("*.cu"))
        if not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < newest:
            _build()
        lib = C.CDLL(str(LIB_PATH))
        p, i = C.c_void_p, C.c_int
        lib.planner_mode_ssd.restype = i
        lib.planner_mode_ssd.argtypes = [p, i, i, i, i, i, i, p, p, p, p, p]
        _lib = lib
        return lib
