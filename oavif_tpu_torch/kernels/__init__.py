"""Build and load the hand-written CUDA kernels (``build.py``), launch
them, and count their launches.

Every kernel wrapper carries a ``launches`` integer that ``launch`` raises
by one each time it launches the wrapper's kernel, and nothing else does.
The corpus pipeline launches kernels from its device worker thread and
from the encoding thread at once, so the increment holds a lock.
``launch_counts`` reads every count of this process by ``kernel_key``,
which is how spawned ranks report theirs (``parallel.spawn``);
``counting`` adds up the launches of one block.

``launch`` is on the path of every kernel call, so it does no more host
work than a launch needs: each C entry is resolved to its ctypes function
once (the library itself is built and loaded on first use, under
``build.load``'s lock), the device is switched only when the tensor lies
on another device than the current one, and the stream is the current
stream of the tensor's device, read as its raw handle.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from . import build

_count_lock = threading.Lock()
# kernel_key -> wrapper, for every wrapper that has launched in this process
_launched: dict = {}
# C entry name -> its ctypes function in the loaded library
_entries: dict = {}


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


def _entry(name: str):
    """The library's ctypes function ``name``, resolved on first use."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries.setdefault(name, getattr(build.load(), name))
    return fn


def launch(wrapper, entry: str, tensor, *args) -> None:
    """Call the kernel library's C entry ``entry`` with ``args`` and the
    current CUDA stream of ``tensor``'s device, raise on a non-zero CUDA
    error, and count the launch on ``wrapper``."""
    fn = _entry(entry)
    index = tensor.get_device()
    # torch.cuda.current_stream(index).cuda_stream without building a
    # Stream object, which costs a few microseconds a call
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    count_launch(wrapper)
