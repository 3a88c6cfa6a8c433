"""Bytes of one launch of B1 in its shared-adjacency mode (`csrc/lgs.cu`
with share = D, `ops.lgs.batched_lgs_multi`): the Q int8 adjacencies
[N, N] read once whatever D, the Q x D float32 weight rows and bool mask
rows read; the Q x D int8 selection rows, float32 utilities and int32
rounds written. A launch's least time is its bytes at the HBM bandwidth;
the window's is the mean over its launches, each by its Q."""

from __future__ import annotations

from typing import Sequence

from bench_h100.counts import peaks


def launch_bytes(q: int, d: int, n: int) -> int:
    return q * n * n + q * d * n * (4 + 1 + 1) + q * d * (4 + 4)


def bound_s(qs: Sequence[int], d: int, n: int) -> float:
    """The mean least time of launches of Q = qs[0], qs[1], ..."""
    return sum(peaks.bound_s(launch_bytes(q, d, n)) for q in qs) / len(qs)
