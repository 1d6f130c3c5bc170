"""Consistent-span analysis (paper §3, O1 / Fig. 6).

Machinery to quantify how token-level divergence propagates: run a request
once at batch size one (ground truth), once under dynamic batching, and
measure the first/second consistent spans of the output.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence


class SpanStats(NamedTuple):
    first_span: int  # leading tokens matching ground truth
    second_span: int  # matching tokens between 1st and 2nd divergence
    total: int
    match_frac: float


def consistent_spans(reference: Sequence[int], observed: Sequence[int]) -> SpanStats:
    n = min(len(reference), len(observed))
    matches = [reference[i] == observed[i] for i in range(n)]

    first = 0
    while first < n and matches[first]:
        first += 1

    second = 0
    i = first + 1  # skip the first divergent token
    while i < n and matches[i]:
        second += 1
        i += 1

    frac = sum(matches) / n if n else 1.0
    return SpanStats(first, second, n, frac)
