"""Build and load the hand-written CUDA kernels (``build.py``), launch
them, and count their launches.

Every kernel wrapper carries a ``launches`` integer that ``launch`` raises
by one each time it launches the wrapper's kernel, and nothing else does.
The corpus pipeline launches kernels from its device worker thread and
from the encoding thread at once, so the increment holds a lock.
"""

from __future__ import annotations

import ctypes
import threading

_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, safely across threads."""
    with _count_lock:
        wrapper.launches += 1


def launch(wrapper, entry: str, tensor, *args) -> None:
    """Call the kernel library's C entry ``entry`` with ``args`` and the
    current CUDA stream of ``tensor``'s device, raise on a non-zero CUDA
    error, and count the launch on ``wrapper``."""
    import torch

    from .build import load

    fn = getattr(load(), entry)
    with torch.cuda.device(tensor.device):
        rc = fn(*args,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    count_launch(wrapper)
