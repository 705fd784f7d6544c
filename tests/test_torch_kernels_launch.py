"""The kernels' launch path (``oavif_tpu_torch.kernels.launch``) without a
card: a stand-in library and stand-ins for ``torch.cuda``'s device
functions and the raw current-stream lookup. The C entry is resolved once
across calls, a non-zero return code raises with the entry's name, the
launch count rises by one per launch from two threads at once, and the
device context is entered only when the tensor lies on another device
than the current one.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from oavif_tpu_torch import kernels  # noqa: E402


class _Lib:
    """A kernel library whose entries record their calls and return
    ``rc``; counts how often each entry is looked up."""

    def __init__(self, rc: int = 0):
        self.rc = rc
        self.lookups: dict = {}
        self.calls: list = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        self.lookups[name] = self.lookups.get(name, 0) + 1

        def fn(*args):
            with self._lock:
                self.calls.append((name, args))
            return self.rc

        return fn


class _Tensor:
    """What ``launch`` reads of a tensor: the index of its device."""

    def __init__(self, index: int):
        self.index = index

    def get_device(self) -> int:
        return self.index


@pytest.fixture
def card(monkeypatch):
    """A stand-in library and CUDA runtime: device 0 is current, each
    device's stream handle is 1000 + its index; records the devices whose
    context was entered."""
    lib = _Lib()
    entered = []
    monkeypatch.setattr(kernels.build, "load", lambda: lib)
    monkeypatch.setattr(kernels, "_entries", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    # absent from a CPU build of torch
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)

    @contextlib.contextmanager
    def device(index):
        entered.append(index)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    return lib, entered


def _wrapper():
    def wrapper():
        pass

    wrapper.launches = 0
    return wrapper


def test_entry_is_resolved_once_across_calls(card):
    lib, _ = card
    w = _wrapper()
    for i in range(5):
        kernels.launch(w, "k_one", _Tensor(0), i, 7)
    kernels.launch(w, "k_two", _Tensor(0), 1)
    assert lib.lookups == {"k_one": 1, "k_two": 1}
    assert lib.calls[:2] == [("k_one", (0, 7, 1000)), ("k_one", (1, 7, 1000))]
    assert lib.calls[-1] == ("k_two", (1, 1000))
    assert w.launches == 6


def test_nonzero_return_code_raises_with_the_entry_name(card):
    lib, _ = card
    lib.rc = 700
    w = _wrapper()
    with pytest.raises(RuntimeError, match="k_bad.*700"):
        kernels.launch(w, "k_bad", _Tensor(0), 3)
    assert w.launches == 0


def test_count_rises_by_one_per_launch_from_two_threads(card):
    lib, _ = card
    w = _wrapper()
    per_thread = 2000
    start = threading.Barrier(2)

    def run():
        start.wait()
        for _ in range(per_thread):
            kernels.launch(w, "k_count", _Tensor(0))

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert w.launches == 2 * per_thread
    assert len(lib.calls) == 2 * per_thread
    assert kernels.launch_counts()[kernels.kernel_key(w)] == 2 * per_thread


def test_device_context_only_for_another_device(card):
    lib, entered = card
    w = _wrapper()
    kernels.launch(w, "k_dev", _Tensor(0))
    assert entered == []
    kernels.launch(w, "k_dev", _Tensor(1))
    assert entered == [1]
    # the stream is the tensor's device's, not the current device's
    assert [args[-1] for _, args in lib.calls] == [1000, 1001]
    assert w.launches == 2
