"""Serving bucket planner: pick resolution buckets from a page corpus
(port of ``layoutdit_tpu/eval/buckets.py``, the same plans).

The serving engine (``eval/serving.py``) runs one program per
(image_size, batch) bucket and routes each page to the smallest bucket
that fits, so bucket choice trades the number of programs (each export
or first call traces one) against padded compute: too few buckets waste
operations upscaling the pad, too many waste tracing. This picks the
cost-optimal ``k`` bucket sizes for a measured corpus of page sizes by
exact dynamic programming (the 1-D segmentation is optimal, not a
heuristic).

Cost model: every page routed to bucket ``S`` costs ``cost_fn(S)``
(default ``S**2``, pixels processed; pass a measured ms-per-size table
for exact planning). Buckets snap up to multiples of the ViT patch size
so the patch grid stays exact (the ViT resamples its position
embeddings to the bucket's grid).
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence


def _snap_up(value: int, multiple: int) -> int:
    return ((max(value, 1) + multiple - 1) // multiple) * multiple


def plan_buckets(
    page_sizes: Iterable[tuple[int, int]],
    k: int,
    patch: int = 16,
    min_size: int = 224,
    max_size: int | None = None,
    cost_fn: Callable[[int], float] = lambda s: float(s) * s,
) -> list[int]:
    """Return ≤``k`` ascending bucket sizes minimizing total corpus cost.

    page_sizes: (height, width) pairs of the pages to be served.
    k: maximum number of buckets (compiled programs).
    patch: bucket sizes snap up to this multiple.
    min_size / max_size: clamp the candidate range (pages larger than
      max_size still route to the top bucket and are downscaled by the
      engine, matching ``BatchInferenceEngine._bucket_for``).
    cost_fn: per-page cost of running bucket size S (default S²).
    """
    if k < 1:
        raise ValueError("need at least one bucket")
    # Candidate sizes: each page's snapped requirement, clamped.
    needs = []
    for h, w in page_sizes:
        s = _snap_up(max(int(h), int(w)), patch)
        s = max(s, min_size)
        if max_size is not None:
            s = min(s, _snap_up(max_size, patch))
        needs.append(s)
    if not needs:
        return [min_size]
    candidates = sorted(set(needs))  # a bucket only pays at a page boundary
    n = len(candidates)
    counts = [needs.count(c) for c in candidates]
    if n <= k:
        return candidates

    # cum[i] = pages needing <= candidates[i]
    cum = [0] * (n + 1)
    for i in range(n):
        cum[i + 1] = cum[i] + counts[i]

    def seg_cost(i: int, j: int) -> float:
        """Pages in candidates(i..j] all route to candidates[j]."""
        return (cum[j + 1] - cum[i]) * cost_fn(candidates[j])

    INF = float("inf")
    # dp[b][j] = min cost covering candidates[0..j] with b buckets where
    # candidates[j] is the top of bucket b.
    dp = [[INF] * n for _ in range(k)]
    back = [[0] * n for _ in range(k)]
    for j in range(n):
        dp[0][j] = seg_cost(0, j)
    for b in range(1, k):
        for j in range(b, n):
            best, arg = INF, 0
            for i in range(b - 1, j):
                c = dp[b - 1][i] + seg_cost(i + 1, j)
                if c < best:
                    best, arg = c, i
            dp[b][j], back[b][j] = best, arg
    # The top bucket must cover the largest page: j = n-1; choose best b.
    b_best = min(range(k), key=lambda b: dp[b][n - 1])
    sizes = []
    j = n - 1
    for b in range(b_best, -1, -1):
        sizes.append(candidates[j])
        j = back[b][j]
    return sorted(sizes)


def corpus_cost(
    page_sizes: Sequence[tuple[int, int]],
    buckets: Sequence[int],
    patch: int = 16,
    cost_fn: Callable[[int], float] = lambda s: float(s) * s,
) -> float:
    """Total cost of serving ``page_sizes`` with ``buckets`` (for
    comparing plans; same routing rule as the engine — smallest bucket
    that fits, largest bucket catches oversize pages)."""
    buckets = sorted(buckets)
    total = 0.0
    for h, w in page_sizes:
        need = _snap_up(max(int(h), int(w)), patch)
        chosen = next((b for b in buckets if b >= need), buckets[-1])
        total += cost_fn(chosen)
    return total
