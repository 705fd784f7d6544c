"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``oavif_tpu_torch/csrc/*.cu`` for sm_90a (with
the shared ``*.cuh`` headers beside them), one process per source, all
started together, and links the objects into one
shared library with a plain C interface under ``build/oavif_tpu_torch/``
(listed in .gitignore), rebuilt when a source is newer than the library;
``ctypes`` loads it. Pointers go in as ``c_void_p`` from
``tensor.data_ptr()`` (or a host array's address, where an entry says its
argument lives in host memory), with the raw handle of the current CUDA
stream last (``kernels.launch``); each entry returns
``cudaGetLastError()``. A failed build raises: there is no fallback.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = C.c_void_p, C.c_int, C.c_float
# every C entry of csrc/*.cu with its argument types: pointers and the
# stream as c_void_p (ctypes would cut them to 32 bits otherwise); each
# returns an int, cudaGetLastError()
entries = {
    "planner_mode_ssd": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "planner_plan": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P,
                     _P, _P, _P, _P, _P],
    "ssim2_pyramid_rgb8": [_P, _I, _I, _I, _P, _P, _P, _P],
    "ssim2_pyramid_down": [_P, _I, _I, _I, _P, _P, _P, _P],
    "ssim2_blur": [_P, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P],
    "ssim2_blur_simple": [_P, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P],
    "ssim2_blur_iir": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "ssim2_norms": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _P, _I,
                    _P, _P],
    "ssim2_blur_norms": [_P, _P, _P, _I, _P, _I, _I, _I, _P, _I, _F, _P, _I,
                         _P, _P],
    "dstage_coeffs16": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "dstage_coeffs16_simple": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "dstage_quant16": [_P, _I, _I, _P, _P, _F, _P, _P, _P, _P],
    "dstage_quant16_simple": [_P, _I, _I, _P, _P, _F, _P, _P, _P, _P],
    "wiener_bands": [_P, _P, _I, _I, _I, _P, _P, _P],
    "wiener_bands_simple": [_P, _P, _I, _I, _I, _P, _P, _P],
}

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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        objs = [Path(td) / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        logs = []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
        tmp = Path(td) / LIB_PATH.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        build_log = "".join(logs)
        os.replace(tmp, LIB_PATH)


def load() -> C.CDLL:
    """The kernels' library, built on first use in this checkout."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        newest = max(s.stat().st_mtime for s in CSRC.glob("*.cu*"))
        if not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < newest:
            _build()
        lib = C.CDLL(str(LIB_PATH))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.restype = _I
            fn.argtypes = argtypes
        _lib = lib
        return lib
