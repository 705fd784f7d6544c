"""Build and load the hand-written CUDA kernels (``build.py``), launch
them, and count their launches.

Every kernel wrapper carries a ``launches`` integer that ``launch`` raises
by one each time it launches the wrapper's kernel, and nothing else does.
The corpus pipeline launches kernels from its device worker thread and
from the encoding thread at once, so the increment holds a lock.
``launch_counts`` reads every count of this process by ``kernel_key``,
which is how spawned ranks report theirs (``parallel.spawn``);
``counting`` adds up the launches of one block.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

_count_lock = threading.Lock()
# kernel_key -> wrapper, for every wrapper that has launched in this process
_launched: dict = {}


def kernel_key(wrapper) -> str:
    """A wrapper's name across processes: ``module.function``."""
    return f"{wrapper.__module__}.{wrapper.__name__}"


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, safely across threads."""
    with _count_lock:
        wrapper.launches += 1
        _launched[kernel_key(wrapper)] = wrapper


def launch_counts() -> dict:
    """{kernel_key: launches} of every wrapper launched in this process."""
    with _count_lock:
        return {key: w.launches for key, w in _launched.items()}


@contextlib.contextmanager
def counting(acc: dict):
    """Add the launches made inside the block to ``acc`` ({kernel_key:
    launches}), so that a caller can count one path apart from the checks
    and timings around it in the same process."""
    before = launch_counts()
    try:
        yield acc
    finally:
        for key, n in launch_counts().items():
            if n != before.get(key, 0):
                acc[key] = acc.get(key, 0) + n - before.get(key, 0)


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
