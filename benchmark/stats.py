"""The arithmetic of the benchmark's numbers: percentiles, rates and the
union of device intervals."""

from __future__ import annotations

import numpy as np


def percentile(values, p: float) -> float:
    """The ``p``-th percentile (0–100) of ``values``, linear between the
    closest ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), p))


def rate(work: float, seconds: float) -> float:
    """Work per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return work / seconds


def intervals(stamps_ms) -> list:
    """The intervals between consecutive completions, from ``stamps_ms``:
    the window's start, then each step's completion, in ms."""
    return [b - a for a, b in zip(stamps_ms[:-1], stamps_ms[1:])]


def union(spans) -> list:
    """The union of ``(start, end)`` spans as sorted disjoint spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(s) for s in out]


def busy(spans) -> tuple:
    """(the time the union of ``spans`` covers, the time from the first
    start to the last end)."""
    merged = union(spans)
    if not merged:
        return 0.0, 0.0
    return sum(b - a for a, b in merged), merged[-1][1] - merged[0][0]


def gaps(spans) -> list:
    """The idle gaps ``(start, end)`` between the union's spans, longest
    first."""
    merged = union(spans)
    out = [(a[1], b[0]) for a, b in zip(merged[:-1], merged[1:]) if b[0] > a[1]]
    return sorted(out, key=lambda g: g[0] - g[1])
