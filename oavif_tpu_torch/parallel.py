"""Ranks and collectives on torch.distributed: the counterpart of the JAX
package's device mesh, ``shard_map`` and collectives (``ppermute``,
``psum``, ``all_gather``).

``spawn`` starts ``world`` processes with the ``spawn`` start method (CUDA
cannot fork), joins them in one process group over a ``file://``
rendezvous in a fresh temporary directory (no port to clash), runs a
function in each, and returns every rank's result and every rank's kernel
launch counts (the counters of ``kernels.launch`` are per process). A rank
that raises, dies or outlives the deadline fails the whole call: every rank
is killed and the parent raises. Nothing falls back to another backend or
device.

Every collective is one ``dist.all_reduce(SUM)``, the one collective that
gloo carries for CUDA tensors as well as CPU tensors, so one code path
serves gloo on the CPU, gloo over CUDA tensors of ranks that share one
card, and NCCL with one card per rank. Moves of data (halos, gathers,
broadcasts) write each rank's part into its own slot of a zeroed buffer
and sum it as integers of the same width (float bits reinterpreted), so
what arrives is bit for bit what was sent, signed zeros included.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .device import resolve_device
from .kernels import launch_counts


@dataclass(frozen=True)
class Rank:
    """What a spawned function learns about its process: its rank in the
    default group, the world size and the device it computes on."""

    rank: int
    world: int
    device: torch.device


def _rank_main(rank: int, world: int, fn: Callable, args: Sequence,
               backend: str, device_type: str, init_method: str,
               timeout_s: float, out) -> None:
    """Body of one spawned rank: set up the device and the process group,
    run fn, and post ("ok", rank, result, launch counts) or ("error",
    rank, traceback, None)."""
    try:
        # the port's own default device in this process is the rank's
        os.environ["OAVIF_TORCH_DEVICE"] = device_type
        resolve_device(device_type)  # TF32 off, as on every path
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(Rank(rank, world, device), *args)
            if device_type == "cuda":
                torch.cuda.synchronize(device)
            out.put(("ok", rank, result, launch_counts()))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        out.put(("error", rank, traceback.format_exc(), None))


def spawn(fn: Callable, world: int, *, args: Sequence = (),
          backend: str = "gloo", device=None,
          timeout_s: float = 120.0) -> Tuple[List[Any], List[Dict[str, int]]]:
    """Run ``fn(Rank, *args)`` in ``world`` new processes joined in one
    process group; returns (results, launch counts), each indexed by rank.

    ``fn`` must be importable by name from the port (a spawned process
    starts fresh and imports it), and what it returns must pickle (numpy,
    not CUDA tensors). ``device`` is resolved as everywhere in the port
    (``resolve_device``: CUDA unless the CPU is asked for); on CUDA rank r
    computes on card r modulo the cards present, so under gloo on a
    one-card machine every rank shares card 0; ``nccl`` needs a card per
    rank and raises otherwise. The kernels are built here, once, before
    the ranks start (concurrent builds into one directory would race).
    Raises if a rank raises or dies, or if the ranks have not all finished
    ``timeout_s`` seconds after the start; every rank is killed first."""
    if world < 1:
        raise ValueError(f"spawn: world {world} < 1")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"spawn: unsupported backend {backend!r}")
    device = resolve_device(device).type
    if device == "cuda":
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(
                f"spawn: nccl needs one card per rank; world {world} > "
                f"{torch.cuda.device_count()} cards")
        from .kernels.build import load

        load()
    elif backend == "nccl":
        raise ValueError("spawn: nccl needs device='cuda'")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results: List[Any] = [None] * world
    counts: List[Optional[Dict[str, int]]] = [None] * world
    with tempfile.TemporaryDirectory(prefix="oavif_rdv_") as td:
        init_method = "file://" + os.path.join(td, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, fn, tuple(args), backend,
                                   device, init_method, timeout_s, out),
                             daemon=True)
                 for r in range(world)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            pending = world
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn: {pending} of {world} ranks still running "
                        f"after {timeout_s} s")
                try:
                    msg = out.get(timeout=min(left, 0.5))
                except queue.Empty:
                    silent = [r for r, p in enumerate(procs)
                              if p.exitcode is not None and counts[r] is None]
                    if not silent:
                        continue
                    try:  # a rank's message is flushed before it exits
                        msg = out.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"spawn: rank {silent[0]} died with exit code "
                            f"{procs[silent[0]].exitcode}") from None
                kind, r, payload, cnt = msg
                if kind == "error":
                    raise RuntimeError(f"spawn: rank {r} failed:\n{payload}")
                results[r], counts[r] = payload, cnt
                pending -= 1
            for r, p in enumerate(procs):
                p.join(timeout=max(1.0, deadline - time.monotonic()))
                if p.exitcode != 0:
                    raise RuntimeError(
                        f"spawn: rank {r} ended with exit code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join()
            out.close()
    return results, counts


def sum_counts(counts: Sequence[Dict[str, int]]) -> Dict[str, int]:
    """The launch counts of several ranks added up per kernel."""
    total: Dict[str, int] = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


class Mesh:
    """The reference's ``(q, tile)`` mesh over the ranks of the default
    group: rank r sits at q index r // t_dim and tile index r % t_dim, as
    in ``devices.reshape(q_dim, t_dim)``. ``tile_group`` holds the ranks of
    this rank's q index (the axis a frame is width-sharded over),
    ``q_group`` those of its tile index (the axis candidates are sharded
    over). Every rank must build the same mesh: each subgroup is created by
    all ranks, in one order."""

    def __init__(self, q_dim: int, t_dim: int):
        world = dist.get_world_size()
        if q_dim * t_dim != world:
            raise ValueError(f"Mesh: {q_dim} x {t_dim} != world {world}")
        self.q_dim, self.t_dim = q_dim, t_dim
        self.q_index, self.tile_index = divmod(dist.get_rank(), t_dim)
        tile_groups = [dist.new_group([q * t_dim + t for t in range(t_dim)])
                       for q in range(q_dim)]
        q_groups = [dist.new_group([q * t_dim + t for q in range(q_dim)])
                    for t in range(t_dim)]
        self.tile_group = tile_groups[self.q_index]
        self.q_group = q_groups[self.tile_index]


# ---------------------------------------------------------------------------
# Collectives, each one all_reduce(SUM)
# ---------------------------------------------------------------------------

_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def _all_reduce(t: torch.Tensor, group) -> None:
    """The one call every collective of this module makes (a measurement
    times the collectives by wrapping it)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def _exact_sum(buf: torch.Tensor, group) -> torch.Tensor:
    """all_reduce(SUM) of a buffer in which each element is non-zero on at
    most one rank, as integers of the element's width: the result is the
    sender's bits."""
    view = (buf.view(_INT_OF_WIDTH[buf.element_size()])
            if buf.is_floating_point() else buf)
    _all_reduce(view, group)
    return buf


def group_rank(group=None) -> Tuple[int, int]:
    """(this rank's index in ``group``, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``lax.psum``)."""
    y = x.clone()
    _all_reduce(y, group)
    return y


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in group-rank order, exactly.
    Every rank's ``x`` has the same shape and type."""
    i, n = group_rank(group)
    buf = x.new_zeros((n, *x.shape))
    buf[i] = x
    return _exact_sum(buf, group)


def all_gather_width(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` joined along the last axis in group-rank order
    (``lax.all_gather(..., axis=-1, tiled=True)``)."""
    return torch.cat(all_gather(x, group).unbind(0), -1)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank, exactly. The other ranks'
    ``x`` only gives the shape and type."""
    i, _ = group_rank(group)
    buf = x.clone() if i == src else torch.zeros_like(x)
    return _exact_sum(buf, group)


def halo_exchange(x: torch.Tensor, r: int, group=None,
                  border: str = "zero") -> torch.Tensor:
    """x (..., W) -> (..., W + 2r): ``r`` columns from each neighbour in
    group-rank order on each side (``lax.ppermute`` both ways), exactly.
    At the frame's two ends the halo is zero (``border="zero"``, the
    metric's zero-padded blur) or this rank's edge column repeated
    (``border="edge"``, the Wiener filter's clamp of x to the frame)."""
    if border not in ("zero", "edge"):
        raise ValueError(f"halo_exchange: unknown border {border!r}")
    if x.shape[-1] < r:
        raise ValueError(f"halo_exchange: slice of {x.shape[-1]} columns "
                         f"narrower than the halo {r}")
    i, n = group_rank(group)
    buf = x.new_zeros((n, 2, *x.shape[:-1], r))
    buf[i, 0] = x[..., :r]
    buf[i, 1] = x[..., -r:]
    _exact_sum(buf, group)
    edge_shape = (*x.shape[:-1], r)
    if i > 0:
        left = buf[i - 1, 1]
    elif border == "zero":
        left = x.new_zeros(edge_shape)
    else:
        left = x[..., :1].expand(edge_shape)
    if i < n - 1:
        right = buf[i + 1, 0]
    elif border == "zero":
        right = x.new_zeros(edge_shape)
    else:
        right = x[..., -1:].expand(edge_shape)
    return torch.cat([left, x, right], -1)


def in_turn(rk: Rank, *calls) -> list:
    """A rank body that runs several rank bodies one after the other, so
    that one ``spawn`` serves them all: ``calls`` are (fn, args) pairs, and
    the results come back in their order."""
    return [fn(rk, *args) for fn, args in calls]
