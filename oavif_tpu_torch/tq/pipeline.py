"""Corpus search pipeline: many TQ searches interleaved over one host
core, with the device metric and plan prefetch on a worker thread; the
counterpart of oavif_tpu/tq/pipeline.py, with the same scheduling.

  - every image's search is the reference's unchanged loop
    (``search.search_quality_gen``, the generator behind
    ``find_target_quality``);
  - one device worker thread takes the device work of the search: the
    per-image reference pyramids and per-probe scores of the device metric
    (``metric/ssimulacra2.py``), and the next image's plan
    (``av1/encode.prefetch_plan``);
  - the host thread round-robins over the images whose next quantizer is
    known, encoding one probe at a time (the C tile coder releases the
    GIL, so the worker's waits never block it).

Scoring (``OAVIF_PIPELINE_METRIC=c|jax|hybrid``, default by device):
``jax`` scores every probe on the device; ``c`` on the host C scorer,
inline; ``hybrid``, the default on CUDA, sends a score to the device when
another image has a probe ready to encode meanwhile, and scores inline on
the host at the corpus tail. The CPU device defaults to ``c``. The device
and C scorers agree within the tested epsilon, so a pipelined search may
settle one quantizer step away from the sequential one.

Unlike the reference, the prefetch futures are kept and read before the
corpus returns, so a failed prefetch raises.

Wall-clock accounting: per-image ``host_s`` is that image's own encode
time; corpus throughput uses the single overall wall.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..backend import EncBuffer, EncCtx
from ..device import resolve_device
from .search import SearchResult, predict_q_native, search_quality_gen


def _pick_scorer_mode() -> str:
    """OAVIF_PIPELINE_METRIC=c|jax|hybrid forces a mode; by default
    ``hybrid`` on a CUDA device and ``c`` on the CPU device, where the
    device metric would run on the same cores as the encodes."""
    mode = os.environ.get("OAVIF_PIPELINE_METRIC", "auto").lower()
    if mode in ("c", "jax", "hybrid"):
        return mode
    if mode != "auto":
        raise ValueError(f"unknown OAVIF_PIPELINE_METRIC {mode!r}")
    return "hybrid" if resolve_device().type == "cuda" else "c"


@dataclass(eq=False)
class _ImgState:
    index: int
    ctx: EncCtx
    gen: object
    scorer: Dict[str, object] = field(default_factory=dict)
    pending_q: Optional[int] = None  # next quantizer to encode
    future: Optional[Future] = None  # in-flight score
    future_q: int = -1
    result: Optional[SearchResult] = None
    error: Optional[str] = None
    cache: Dict[int, bytes] = field(default_factory=dict)
    host_s: float = 0.0
    timings: List[float] = field(default_factory=list)
    t_probe0: float = 0.0


def _make_scorer(st: _ImgState, kind: str):
    if kind == "jax":
        from ..metric.ssimulacra2 import make_ref_scorer

        fn = make_ref_scorer(st.ctx.rgb)
        return lambda d: float(fn(None, d))
    from ..metric.native import _get_ctx

    cctx = _get_ctx(st.ctx.rgb)
    return lambda d: float(cctx.score(d))


def _score_task(st: _ImgState, recon, kind: str) -> float:
    # st.scorer caches one closure per kind: the device one owns the
    # image's device-resident reference pyramid, the C one the host metric
    # context; hybrid mode may use both over one search
    if kind not in st.scorer:
        st.scorer[kind] = _make_scorer(st, kind)
    return st.scorer[kind](recon)


def _prefetch_task(st: _ImgState) -> None:
    from ..av1.encode import prefetch_plan

    prefetch_plan(st.ctx, st.pending_q if st.pending_q is not None
                  else predict_q_native(st.ctx.o.score_tgt))


def search_encode_corpus(
    ctxs: List[EncCtx], backend
) -> List[Tuple[Optional[SearchResult], bytes]]:
    """Run the target-quality search for every ctx, software-pipelined.

    Returns [(SearchResult, avif bytes)] in input order; an image whose
    encode failed gives (None, b"") and its reason in ``last_errors``.
    Per image the semantics match tq/driver.py's sequential loop (the
    same search generator, the same cached-bitstream final selection);
    only the scheduling and the scorer differ."""
    mode = _pick_scorer_mode()
    states: List[_ImgState] = []
    for idx, ctx in enumerate(ctxs):
        gen = search_quality_gen(
            ctx.o.score_tgt, ctx.o.tolerance, ctx.o.max_pass,
            seed_fn=predict_q_native, slope_prior=(2.1, 0.7),
        )
        st = _ImgState(index=idx, ctx=ctx, gen=gen)
        try:
            st.pending_q = next(gen)
        except StopIteration as stop:  # max_pass == 0
            st.result = stop.value
        states.append(st)

    def _advance(st: _ImgState, score: float) -> None:
        st.timings.append(round((time.time() - st.t_probe0) * 1000, 1))
        try:
            st.pending_q = st.gen.send(score)
        except StopIteration as stop:
            st.result = stop.value
            st.pending_q = None

    def _reap(block_on: Optional[_ImgState] = None) -> None:
        for st in states:
            if st.future is None:
                continue
            if st is block_on or st.future.done():
                score = st.future.result()
                st.future = None
                _advance(st, score)

    prefetched = [False] * len(states)
    prefetches: List[Future] = []
    with ThreadPoolExecutor(max_workers=1) as worker:
        t_corpus0 = time.perf_counter()
        # the first image's plan now; image k+1's when image k first encodes
        if states:
            prefetches.append(worker.submit(_prefetch_task, states[0]))

        while True:
            _reap()
            ready = [st for st in states
                     if st.result is None and st.error is None
                     and st.pending_q is not None and st.future is None]
            if not ready:
                waiting = [st for st in states if st.future is not None]
                if not waiting:
                    break
                _reap(block_on=waiting[0])
                continue
            st = ready[0]
            i = st.index
            if not prefetched[i]:
                prefetched[i] = True
                if i + 1 < len(states):
                    prefetches.append(
                        worker.submit(_prefetch_task, states[i + 1]))
            q = st.pending_q
            st.pending_q = None
            st.t_probe0 = time.time()
            t0 = time.perf_counter()
            ctx = st.ctx
            ctx.q = q
            try:
                data, recon = backend.encode_with_recon(ctx)
            except Exception as e:  # per-image failure: the corpus goes on
                st.error = f"{type(e).__name__}: {e}"
                st.host_s += time.perf_counter() - t0
                continue
            st.host_s += time.perf_counter() - t0
            ctx.num_pass += 1
            ctx.buf = EncBuffer(q=q, data=data, size=len(data))
            st.cache[q] = data
            st.future_q = q
            if mode == "jax":
                st.future = worker.submit(_score_task, st, recon, "jax")
            elif mode == "hybrid" and any(
                s2.pending_q is not None and s2.result is None
                and s2.error is None for s2 in states if s2 is not st
            ):
                # another image can keep the host core busy: the device
                # score hides behind that image's encode
                st.future = worker.submit(_score_task, st, recon, "jax")
            else:
                # host scorer, inline: nothing else is left to encode (the
                # hybrid corpus tail), or the C mode
                t0 = time.perf_counter()
                score = _score_task(st, recon, "c")
                st.host_s += time.perf_counter() - t0
                _advance(st, score)

        corpus_wall = time.perf_counter() - t_corpus0
    for f in prefetches:
        f.result()

    out: List[Tuple[Optional[SearchResult], bytes]] = []
    for st in states:
        r = st.result
        if r is None:  # per-image failure (st.error carries the reason)
            out.append((None, b""))
            continue
        st.ctx.q = r.q
        data = st.cache.get(r.q)
        if data is None:
            data = backend.encode(st.ctx)
        out.append((r, data))
    search_encode_corpus.last_wall = corpus_wall
    search_encode_corpus.last_errors = [st.error for st in states]
    search_encode_corpus.last_host_s = [st.host_s for st in states]
    search_encode_corpus.last_timings = [st.timings for st in states]
    search_encode_corpus.last_mode = mode
    return out
