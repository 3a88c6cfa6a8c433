"""Profiling and throughput instrumentation.

Port of `distgcn_tpu/utils/profiling.py`:
- `trace(logdir)`: context manager around `torch.profiler` (CPU, and CUDA
  where a card is present) that writes a Chrome trace into `logdir`
  (viewable in Perfetto or ``chrome://tracing``);
- `StepTimer`: rolling throughput counters (graphs/s, edges/s) with an
  exponential moving average matching the reference's `emv`
  (test_utils.py:7-10). On a CUDA device it synchronises that device
  before each reading of the clock, so a step's time includes its device
  work;
- `span(name)`: a span in the profiler's trace where a profiler records,
  else nothing. The port's slot loops mark their layers with it.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block; on exit write ``trace-<pid>-<ns>.json`` (Chrome
    trace format) into `logdir` (default: ``distgcn_torch_trace`` in the
    temporary directory). Yields `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "distgcn_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a span while a `torch.profiler`
    session records, and the one shared no-op context otherwise (one
    cheap check, so the slot loops carry their spans at no real cost).
    `trace(logdir)` around a call writes the spans beside the kernels in
    its Chrome trace, on the same clock.

    A span is recorded as a host operator (`RecordFunctionFast`), not as
    a `torch.profiler.record_function` user annotation: the profiler
    mirrors a user annotation onto the device's timeline, over the first
    to the last kernel launched inside it, and a reader of the device's
    intervals that does not tell annotations from kernels would count the
    card busy for a whole episode.

    The port's spans, each nested in the one above it on the calling
    thread:

    - ``distgcn.episode``: a call of the ``run`` of
      `sim.device_sim.make_closed_loop`, `make_closed_loop_mc` or
      `make_closed_loop_seq` (supports and scorer set-up, the slots, the
      metrics);
    - ``distgcn.slot``: one slot of those loops or of
      `large.make_large_closed_loop`'s (draws, utilities, scoring, LGS,
      queue update, stats);
    - ``distgcn.gcn``: the GCN's features and forward in a slot (and the
      dense episode's hoisted forward; in the sequential loop each
      channel's subgraph supports too);
    - ``distgcn.lgs``: the LGS of a slot (B1, or `large.bsr_lgs`; one per
      channel in the sequential loop), and the dense loop's baseline
      LGS;
    - ``distgcn.sync``: in `large.bsr_lgs`, the host blocked on the
      device's counts of the nodes left, one read per batch of rounds
      (and once before the first batch when the LGS is not given the
      graph's own mask).
    """
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def emv(sample: float, prev: Optional[float], n: int = 3) -> float:
    """Exponential moving average (test_utils.py:7-10)."""
    if prev is None:
        return sample
    k = 2.0 / (n + 1)
    return sample * k + prev * (1 - k)


@dataclass
class StepTimer:
    name: str = "step"
    device: Optional[torch.device] = None
    _t0: float = field(default=0.0, repr=False)
    count: int = 0
    graphs: int = 0
    edges: int = 0
    total_s: float = 0.0
    ema_s: Optional[float] = None

    def _clock(self) -> float:
        if self.device is not None and torch.device(self.device).type \
                == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __enter__(self):
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc):
        dt = self._clock() - self._t0
        self.count += 1
        self.total_s += dt
        self.ema_s = emv(dt, self.ema_s)
        return False

    def add(self, graphs: int = 0, edges: int = 0):
        self.graphs += graphs
        self.edges += edges

    @property
    def graphs_per_s(self) -> float:
        return self.graphs / self.total_s if self.total_s else 0.0

    @property
    def edges_per_s(self) -> float:
        return self.edges / self.total_s if self.total_s else 0.0

    def summary(self) -> str:
        return (f"{self.name}: {self.count} steps, {self.total_s:.3f}s, "
                f"{self.graphs_per_s:.1f} graphs/s, "
                f"{self.edges_per_s:.3g} edges/s, ema {self.ema_s or 0:.4f}s")
