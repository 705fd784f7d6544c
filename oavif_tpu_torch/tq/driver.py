"""Search drivers: glue between the TQ algorithms (``search.py``) and
the port's backend; the counterpart of oavif_tpu/tq/driver.py.

The sequential driver replicates the reference loop (one encode + score
per pass). The batched driver encodes a small vector of candidate
quantizers concurrently (the C tile coder releases the GIL) and scores
the batch in one call.
"""

from __future__ import annotations

import os
import time
from dataclasses import replace
from typing import Tuple

import numpy as np

from ..backend import EncBuffer, EncCtx
from ..metric.native import (compute_ssimulacra2_native, metric_impl,
                             score_batch_auto)
from ..metric.ssimulacra2 import make_ref_scorer
from .search import (
    SearchResult,
    find_target_quality,
    find_target_quality_batched,
    predict_q_native,
)


def make_probe(ctx: EncCtx, backend, metric):
    """One search pass: encode at q, score the encoder's reconstruction
    (== the decoder's output), cache the bitstream."""

    def probe(q: int) -> float:
        t0 = time.time()
        ctx.q = q
        data, decoded = backend.encode_with_recon(ctx)
        ctx.num_pass += 1
        ctx.buf = EncBuffer(q=q, data=data, size=len(data))
        probe.cache[q] = data
        score = float(metric(ctx.rgb, decoded))
        probe.timings.append(round((time.time() - t0) * 1000, 1))
        return score

    probe.cache = {}
    probe.timings = []
    return probe


def make_probe_batch(ctx: EncCtx, backend, batch_width: int):
    """Batched probe: encode each candidate concurrently, score the recon
    batch in one call. Pads the batch to a fixed width."""
    from concurrent.futures import ThreadPoolExecutor

    def probe_batch(qs):
        t0 = time.time()

        def enc(q):
            return backend.encode_with_recon(replace(ctx, q=q))

        # concurrency pays only with real cores to encode on
        workers = min(len(qs), os.cpu_count() or 1)
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                outs = list(ex.map(enc, qs))
        else:
            outs = [enc(q) for q in qs]
        recons = [r for (_, r) in outs]
        batch = np.stack(recons + [recons[-1]] * (batch_width - len(recons)))
        scores = score_batch_auto(ctx.rgb, batch)[: len(qs)]
        for q, (data, _) in zip(qs, outs):
            ctx.buf = EncBuffer(q=q, data=data, size=len(data))
            probe_batch.cache[q] = data
        # passes count ENCODES (the reference's semantics); rounds apart
        ctx.num_pass += len(qs)
        ctx.num_rounds = getattr(ctx, "num_rounds", 0) + 1
        probe_batch.timings.append(round((time.time() - t0) * 1000, 1))
        return [float(s) for s in scores]

    probe_batch.cache = {}
    probe_batch.timings = []
    return probe_batch


def search_encode(
    ctx: EncCtx, backend, metric=None
) -> Tuple[SearchResult, bytes]:
    """Run the target-quality search for ctx.o and return (result, final
    AVIF bytes), reusing a cached bitstream when the selected quantizer was
    already probed.

    Batching exists to amortize a device metric over candidate encodes:
    it is the default with the device metric (OAVIF_METRIC=jax), and the
    sequential loop with the host C metric, as in the reference.
    OAVIF_TQ_BATCH=0/1 forces either, OAVIF_TQ_BATCH_WIDTH sets candidates
    per round. The sequential loop with the device metric keeps the
    reference pyramid on the device across probes (make_ref_scorer)."""
    o = ctx.o
    batch_env = os.environ.get("OAVIF_TQ_BATCH")
    if batch_env is not None:
        use_batch = batch_env != "0"
    else:
        use_batch = metric_impl() != "c"
    if use_batch:
        default_w = "4" if (os.cpu_count() or 1) >= 4 else "2"
        bw = max(1, int(os.environ.get("OAVIF_TQ_BATCH_WIDTH", default_w)))
        probe_obj = make_probe_batch(ctx, backend, bw)
        result = find_target_quality_batched(
            probe_obj, o.score_tgt, o.tolerance, o.max_pass, batch_width=bw,
            seed_fn=predict_q_native,
        )
    else:
        if metric is None:
            metric = (compute_ssimulacra2_native if metric_impl() == "c"
                      else make_ref_scorer(ctx.rgb))
        probe_obj = make_probe(ctx, backend, metric)
        result = find_target_quality(
            probe_obj, o.score_tgt, o.tolerance, o.max_pass,
            seed_fn=predict_q_native, slope_prior=(2.1, 0.7),
        )
    ctx.q = result.q
    data = probe_obj.cache.get(result.q)
    if data is None:
        data = backend.encode(ctx)
    search_encode.last_timings = list(probe_obj.timings)
    return result, data
