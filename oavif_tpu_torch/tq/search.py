"""Target-quality quantizer search.

This is the reference's core IP, replicated exactly from
oavif src/tq.zig:124-210 (seed prediction, pass-0 error bounding,
sorted-history linear/quadratic interpolation with bisection fallback,
duplicate-Q / tolerance / range-collapse exits, and the final
lowest-q-that-meets-target selection policy) — then extended with an optional
*batched speculative* mode where each search round probes a small vector of
candidate quantizers in one device step (BASELINE.json config 2).

The search is backend-agnostic: it drives any callable ``probe(q) -> score``.
On the TPU backend a probe is encode+reconstruct+SSIMULACRA2 entirely
on-device; only the scalar score crosses back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

U32_MAX = 0xFFFFFFFF


@dataclass(frozen=True)
class PassResult:
    """One search pass: quantizer probed and score obtained (tq.zig:16-19)."""

    q: int
    score: float


@dataclass
class SearchResult:
    q: int
    score: float
    num_pass: int
    history: List[PassResult]


def predict_q_from_score(tgt: float) -> int:
    """Seed quantizer from the target score (tq.zig:40-43).

    q = round(6.83 * e^(0.0282*tgt)), capped at 100. At the default target 80
    this lands at q=65.
    """
    q = 6.83 * math.exp(0.0282 * tgt)
    return int(min(100.0, _round_half_away(q)))


def _round_half_away(x: float) -> float:
    """Zig @round semantics: round half away from zero (not banker's)."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def _linear_interpolate(
    scores: Sequence[float], qualities: Sequence[float], target: float
) -> Optional[float]:
    # tq.zig:45-51 — two lowest-score history points.
    if len(scores) < 2:
        return None
    if scores[1] == scores[0]:
        return None
    t = (target - scores[0]) / (scores[1] - scores[0])
    return qualities[0] + (qualities[1] - qualities[0]) * t


def _quadratic_interpolate(
    scores: Sequence[float], qualities: Sequence[float], target: float
) -> Optional[float]:
    # tq.zig:53-71 — Lagrange fit through the three lowest-score points.
    if len(scores) < 3:
        return None
    x0, x1, x2 = scores[0], scores[1], scores[2]
    y0, y1, y2 = qualities[0], qualities[1], qualities[2]
    denom = (x0 - x1) * (x0 - x2) * (x1 - x2)
    if abs(denom) < 0.001:
        return None
    a = (x2 * (y1 - y0) + x1 * (y0 - y2) + x0 * (y2 - y1)) / denom
    b = (
        x2 * x2 * (y0 - y1) + x1 * x1 * (y2 - y0) + x0 * x0 * (y1 - y2)
    ) / denom
    c = (
        x1 * x2 * (x1 - x2) * y0
        + x2 * x0 * (x2 - x0) * y1
        + x0 * x1 * (x0 - x1) * y2
    ) / denom
    return a * target * target + b * target + c


def _clamp_round_q(r: float) -> int:
    return int(min(max(_round_half_away(r), 0.0), 100.0))


def interpolate_quantizer(
    lo_bound: int,
    hi_bound: int,
    history: Sequence[PassResult],
    target: float,
) -> int:
    """Next-quantizer prediction from search history (tq.zig:73-122).

    History is sorted by score ascending; 1 point → bisect the bounds,
    2 points → linear through the two lowest scores, ≥3 → quadratic through
    the three lowest with linear then bisection fallbacks. Result clamps to
    [lo_bound, hi_bound].
    """
    binary_search = (lo_bound + hi_bound) // 2
    if not history:
        return binary_search

    srt = sorted(history, key=lambda h: h.score)
    scores = [h.score for h in srt]
    qualities = [float(h.q) for h in srt]

    if len(history) == 1:
        pred = binary_search
    elif len(history) == 2:
        r = _linear_interpolate(scores, qualities, target)
        pred = _clamp_round_q(r) if r is not None else binary_search
    else:
        r = _quadratic_interpolate(scores, qualities, target)
        if r is not None:
            pred = _clamp_round_q(r)
        else:
            lr = _linear_interpolate(scores, qualities, target)
            pred = _clamp_round_q(lr) if lr is not None else binary_search

    return min(max(pred, lo_bound), hi_bound)


def find_target_quality(
    probe: Callable[[int], float],
    score_tgt: float,
    tolerance: float,
    max_pass: int,
    seed_fn: Optional[Callable[[float], int]] = None,
    slope_prior: Optional[tuple] = None,
) -> SearchResult:
    """Run the full search loop (tq.zig:124-210).

    ``probe(q)`` performs one encode+decode+score cycle and returns the
    SSIMULACRA2 score at quantizer ``q``. Returns the final selected
    quantizer, its score, the number of probes executed, and the history.

    Exact reference semantics replicated, including:
      - pass-0 error bounding with err_bound = ceil(|err|)*4 (tq.zig:154-164)
      - early return (inside the loop) when |err| < tolerance, leaving the
        final q at the probed q (tq.zig:167-168)
      - unsigned wrap in the range-collapse test ``lo >= hi - 1`` when
        hi == 0 (Zig u32 arithmetic, tq.zig:179-180)
      - final selection: lowest q whose score >= target; if none, the
        last history entry maximizing max(score, 0) (tq.zig:183-209).
    """
    gen = search_quality_gen(
        score_tgt, tolerance, max_pass, seed_fn=seed_fn,
        slope_prior=slope_prior,
    )
    try:
        q = next(gen)
        while True:
            q = gen.send(probe(q))
    except StopIteration as stop:
        return stop.value


def search_quality_gen(
    score_tgt: float,
    tolerance: float,
    max_pass: int,
    seed_fn: Optional[Callable[[float], int]] = None,
    slope_prior: Optional[tuple] = None,
):
    """The search loop as a coroutine: yields the next quantizer to probe,
    receives the score via .send(), and returns the SearchResult through
    StopIteration.value.

    This IS find_target_quality's implementation (that function just
    drives this generator synchronously), factored so the corpus pipeline
    (tq/pipeline.py) can interleave many searches over one host core with
    asynchronous device scoring without duplicating the reference
    semantics (tq.zig:124-210)."""
    history: List[PassResult] = []
    lo_bound, hi_bound = 0, 100
    num_pass = 0
    q = 0

    seed_fn = seed_fn or predict_q_from_score
    for pss in range(max_pass):
        if pss == 0:
            q = seed_fn(score_tgt)
        elif pss == 1 and slope_prior is not None:
            # Native pass-1 policy: jump by the measured metric-vs-q slope
            # instead of bisecting the pass-0 bound. When the seed misses
            # low the content is in the steep class (slope ~1.9-2.6 at
            # 512^2; flat content lands inside the tolerance at pass 0),
            # so the feed-forward jump usually converges in 2 passes where
            # bisection takes 3-4. Asymmetric: the curve is much flatter
            # below the operating point than above it.
            up_slope, down_slope = slope_prior
            err = score_tgt - history[0].score
            sl = up_slope if err > 0 else down_slope
            q = _clamp_round_q(history[0].q + err / sl)
            q = min(max(q, lo_bound), hi_bound)
        else:
            q = interpolate_quantizer(lo_bound, hi_bound, history, score_tgt)

        if any(h.q == q for h in history):
            break  # quantizer already probed (tq.zig:141-148)

        score = yield q
        num_pass += 1
        history.append(PassResult(q=q, score=score))

        abs_err = abs(score - score_tgt)
        if pss == 0:
            err_bound = int(math.ceil(abs_err) * 4.0)
            if score - score_tgt > 0:
                hi_bound = q
                lo_bound = q - err_bound if q > err_bound else 0
            else:
                lo_bound = q
                hi_bound = min(100, q + err_bound)

        if abs_err < tolerance:
            return SearchResult(q=q, score=score, num_pass=num_pass, history=history)

        if pss > 0:
            if score > score_tgt:
                hi_bound = q
            else:
                lo_bound = q

        # Zig u32 wraparound: hi_bound - 1 with hi_bound == 0 wraps to 2^32-1.
        hi_minus_1 = (hi_bound - 1) & U32_MAX
        if lo_bound >= hi_minus_1:
            break

    best_q: Optional[int] = None
    best_score = 0.0
    highest_q = 0
    highest_score = 0.0
    for h in history:
        if h.score >= score_tgt and (best_q is None or h.q < best_q):
            best_q = h.q
            best_score = h.score
        if max(h.score, 0.0) >= highest_score:
            highest_score = h.score
            highest_q = h.q

    if best_q is not None:
        return SearchResult(q=best_q, score=best_score, num_pass=num_pass, history=history)
    return SearchResult(q=highest_q, score=highest_score, num_pass=num_pass, history=history)


def speculative_candidates(
    lo_bound: int, hi_bound: int, history: Sequence[PassResult], target: float, width: int
) -> List[int]:
    """Candidate quantizers for one *batched* search round.

    The reference probes one q per pass; on TPU a whole batch of candidate
    quantizers encodes+scores in a single vmapped device step, so each round
    can probe the interpolant plus a bracket around it, collapsing the
    expected number of sequential rounds. The spread is proportional to the
    remaining bracket (center, then the midpoints toward each bound, then
    quarter points) so one round both refines the estimate and shrinks the
    bracket the way two to three sequential bisection passes would.
    Candidates are unique, in-bound, and exclude already-probed quantizers.
    """
    center = interpolate_quantizer(lo_bound, hi_bound, history, target)
    probed = {h.q for h in history}
    cands = [
        center,
        (center + hi_bound + 1) // 2,
        (center + lo_bound) // 2,
        (3 * center + hi_bound + 3) // 4,
        (3 * center + lo_bound) // 4,
        center + 1,
        center - 1,
        center + 2,
        center - 2,
        center + 3,
        center - 3,
    ]
    out: List[int] = []
    for cand in cands:
        if lo_bound <= cand <= hi_bound and cand not in probed and cand not in out:
            out.append(cand)
        if len(out) >= width:
            break
    return out


def find_target_quality_batched(
    probe_batch: Callable[[Sequence[int]], Sequence[float]],
    score_tgt: float,
    tolerance: float,
    max_pass: int,
    batch_width: int = 4,
    seed_fn: Optional[Callable[[float], int]] = None,
) -> SearchResult:
    """Batched speculative variant of :func:`find_target_quality`.

    Each round evaluates up to ``batch_width`` candidate quantizers in one
    call (one vmapped device step on the TPU backend). The pass budget
    ``max_pass`` counts *rounds*, matching the reference's user-facing
    semantics of at most max_pass sequential encode waves; the selection
    policy over the accumulated history is identical to the reference.
    """
    history: List[PassResult] = []
    lo_bound, hi_bound = 0, 100
    rounds = 0

    for rnd in range(max_pass):
        if rnd == 0:
            # Seed + a symmetric spread around it: the seed formula's
            # residual error is roughly ±10 q on typical content, so ±6/±12
            # probes usually bracket the target in the very first round.
            seed = (seed_fn or predict_q_from_score)(score_tgt)
            cands = [seed]
            for off in (6, -6, 12, -12, 18, -18, 24, -24):
                c = seed + off
                if 0 <= c <= 100 and c not in cands:
                    cands.append(c)
                if len(cands) >= batch_width:
                    break
        else:
            cands = speculative_candidates(lo_bound, hi_bound, history, score_tgt, batch_width)
        cands = cands[:batch_width]
        if not cands:
            break

        scores = list(probe_batch(cands))
        rounds += 1
        for qq, ss in zip(cands, scores):
            history.append(PassResult(q=qq, score=ss))

        # Tighten bounds using every new observation.
        for qq, ss in zip(cands, scores):
            if ss > score_tgt:
                if qq < hi_bound:
                    hi_bound = qq
            else:
                if qq > lo_bound:
                    lo_bound = qq

        hit = [h for h in history if abs(h.score - score_tgt) < tolerance]
        if hit:
            best = min(
                (h for h in hit if h.score >= score_tgt),
                key=lambda h: h.q,
                default=min(hit, key=lambda h: abs(h.score - score_tgt)),
            )
            return SearchResult(q=best.q, score=best.score, num_pass=rounds, history=history)

        hi_minus_1 = (hi_bound - 1) & U32_MAX
        if lo_bound >= hi_minus_1:
            break

    best_q: Optional[int] = None
    best_score = 0.0
    highest_q = 0
    highest_score = 0.0
    for h in history:
        if h.score >= score_tgt and (best_q is None or h.q < best_q):
            best_q = h.q
            best_score = h.score
        if max(h.score, 0.0) >= highest_score:
            highest_score = h.score
            highest_q = h.q
    if best_q is not None:
        return SearchResult(q=best_q, score=best_score, num_pass=rounds, history=history)
    return SearchResult(q=highest_q, score=highest_score, num_pass=rounds, history=history)


def predict_q_native(tgt: float) -> int:
    """Seed calibrated to THIS encoder's quality→score curve (measured on
    photo/gradient/noise probes against the v2.1-reconstructed metric:
    q ≈ 0.62·tgt + 36 across tgt 60–95 for the round-3 coder; +1 after
    round 4's frequency-weighted RDOQ shifted the operating curve up —
    recalibrated with tools/calibrate_seed.py (non-screen q* clusters
    at 87..95 at tgt 80; intercepts 36/37/38 measured 14/11/13 passes
    on the bench corpus). Replaces the reference's libaom-calibrated
    exponential for the native backend."""
    q = 0.62 * tgt + 37.0
    return int(min(max(_round_half_away(q), 0.0), 100.0))
