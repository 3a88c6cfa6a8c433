"""The port's program spans in a traced window: where the host was, layer
by layer, while the card sat idle.

The port marks its slot loops with spans named ``distgcn.*``
(`distgcn_tpu_torch.utils.profiling.span`), recorded as host operators
only while a profiler records. `trace._read` keeps them in `Trace.host`
with the host's other events, on the device intervals' clock. A program
without them leaves none, and every reading here is then None.

Each idle gap of the card, between two consecutive merged device
intervals (`Trace.intervals()`, the gaps `Trace.breakdown` sums), goes to
the innermost program span that holds the gap's midpoint, and through it
to a stage:

- ``gcn``: inside ``distgcn.gcn`` (the GCN's features and forward);
- ``lgs``: inside ``distgcn.lgs`` (its ``distgcn.sync`` waits included);
- ``slot``: inside ``distgcn.slot`` or ``distgcn.episode`` and in neither
  of the above (draws, utilities, queue update, stats, episode set-up);
- ``outside``: in no program span (the caller's time between calls).

A stage's idle points are the cell's idle share (`readers.idle_pct`, on
the untraced window's scale) times the stage's share of the traced idle
time, so the four stages add up to the idle share. That assumes the
profiler stretches every stage's gaps alike.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from bench_h100 import readers

PREFIX = "distgcn."
STAGES = ("gcn", "lgs", "slot", "outside")
_STAGE = {"distgcn.gcn": "gcn", "distgcn.lgs": "lgs", "distgcn.sync": "lgs",
          "distgcn.slot": "slot", "distgcn.episode": "slot"}


class Spans:
    """The program's spans of a trace, for exact "which spans hold time t"
    queries.

    Sorted by start (the outer of two spans that start together first),
    span ``up[i]`` is the nearest earlier span that ends no sooner than
    span i. For a time t, the innermost span holding t is the first span
    with an end >= t on the chain i, up[i], up[up[i]], ... from the
    latest span starting at or before t; the chain goes on through the
    spans around it.
    """

    def __init__(self, host):
        spans = sorted(((s, -e, name) for name, s, e in host
                        if name.startswith(PREFIX)))
        self.names = [name for _, _, name in spans]
        self.starts = np.array([s for s, _, _ in spans], np.int64)
        self.ends = [-ne for _, ne, _ in spans]
        self.up, stack = [], []
        for i, e in enumerate(self.ends):
            while stack and self.ends[stack[-1]] < e:
                stack.pop()
            self.up.append(stack[-1] if stack else -1)
            stack.append(i)

    def __len__(self) -> int:
        return len(self.names)

    def holding(self, t: int, i: Optional[int] = None) -> Iterator[str]:
        """Names of the spans that hold time t, the innermost first; `i`
        is the index of the latest span starting at or before t, where
        the caller has it."""
        if i is None:
            i = int(np.searchsorted(self.starts, t, side="right")) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.up[i]
        while i >= 0:
            yield self.names[i]
            i = self.up[i]

    def stage(self, t: int, i: Optional[int] = None) -> str:
        for name in self.holding(t, i):
            if name in _STAGE:
                return _STAGE[name]
        return "outside"


def idle_ns(trace) -> Optional[Dict[str, int]]:
    """Nanoseconds of the traced window's idle gaps by stage, or None
    where the trace holds no program span."""
    spans = Spans(trace.host)
    if not len(spans):
        return None
    iv = trace.intervals()
    out = dict.fromkeys(STAGES, 0)
    if len(iv) < 2:
        return out
    gap_start, gap_end = iv[:-1, 1], iv[1:, 0]
    mids = (gap_start + gap_end) // 2
    latest = np.searchsorted(spans.starts, mids, side="right") - 1
    for t, i, ns in zip(mids.tolist(), latest.tolist(),
                        (gap_end - gap_start).tolist()):
        out[spans.stage(t, i)] += ns
    return out


def idle_pct(run, stage: str) -> Optional[float]:
    """The stage's points of the cell's idle share: `readers.idle_pct`
    times the stage's share of the traced idle nanoseconds."""
    by_stage = idle_ns(run.trace)
    total = readers.idle_pct(run)
    if by_stage is None or total is None or not sum(by_stage.values()):
        return None
    return total * by_stage[stage] / sum(by_stage.values())


def count_per_slot(run, name: str) -> Optional[float]:
    """Spans called `name` over the traced slots, or None where the trace
    holds no program span (a program that no longer opens `name` reads
    0)."""
    spans = Spans(run.trace.host)
    if not len(spans):
        return None
    return spans.names.count(name) / readers.slots(run)


def sync_overhang(trace, slack_ns: int = 5000) -> Optional[float]:
    """The share of ``distgcn.sync`` spans at whose end no device interval
    runs on for more than `slack_ns`. The host leaves such a span only
    once the card has drained, so on one clock the share is 1."""
    ends = sorted(e for name, _, e in trace.host if name == "distgcn.sync")
    if not ends:
        return None
    iv = trace.intervals()
    k = np.searchsorted(iv[:, 0], np.array(ends, np.int64),
                        side="right") - 1
    over = [j >= 0 and iv[j, 1] - e > slack_ns for j, e in zip(k, ends)]
    return 1.0 - sum(over) / len(ends)
