"""The traced sub-window: a `torch.profiler` session over whole units of
work (episodes or slots), read into device intervals and host spans.

`profiled(units, step)` runs one untraced warm-up unit under the profiler
(it takes the tracer's start-up cost) and then `units` traced ones, and
returns a `Trace`: every device operation (kernels, copies, sets) with its
start and end in ns, the host's CPU ops and runtime calls, and the
seconds of the traced units (`window_s`: the span of their step
annotations, on the trace's clock; the host clock where the trace has
none). The readers of
`metrics/` take their numbers from it.
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule


@dataclass
class Trace:
    device: List[Tuple[str, int, int, bool]]     # name, start, end, kernel
    host: List[Tuple[str, int, int]]             # name, start, end
    window_s: float
    units: int
    counters: Dict[str, float] = field(default_factory=dict)

    def kernels(self, match: str) -> List[float]:
        """Seconds of each kernel whose name contains `match`."""
        return [(e - s) * 1e-9 for name, s, e, k in self.device
                if k and match in name]

    def n_kernels(self) -> int:
        return sum(1 for *_, k in self.device if k)

    def intervals(self) -> np.ndarray:
        """The union of the device operations' intervals, [m, 2] ns."""
        if not self.device:
            return np.zeros((0, 2), np.int64)
        iv = np.array(sorted((s, e) for _, s, e, _ in self.device),
                      np.int64)
        merged = [iv[0].tolist()]
        for s, e in iv[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return np.array(merged, np.int64)

    def busy_s(self) -> float:
        iv = self.intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, summed by name, and
        the idle gaps between device intervals, summed by what the host
        was doing at each gap's middle (`_host_at`)."""
        ops = defaultdict(int)
        for name, s, e, _ in self.device:
            ops[name] += e - s
        iv = self.intervals()
        gaps = defaultdict(int)
        if len(iv) > 1 and self.host:
            host = sorted(self.host, key=lambda h: h[1])
            starts = np.array([h[1] for h in host], np.int64)
            for (_, e0), (s1, _) in zip(iv[:-1], iv[1:]):
                gaps[_host_at(host, starts, (e0 + s1) // 2)] += s1 - e0
        rank = lambda d: sorted(([k, v * 1e-9] for k, v in d.items()),
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def _host_at(host, starts, t: int, walk: int = 256) -> str:
    """The latest-starting host op that contains time t (the innermost of
    nested ones); where none does, 'after <op>' for the host op that
    started last before t."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(i - walk, -1), -1):
        name, s, e = host[j]
        if s <= t <= e:
            return name
    return f"after {host[i][0]}" if i >= 0 else "before any host op"


def _ns(ev, what: str) -> int:
    get = getattr(ev, f"{what}_ns", None)
    if get is not None:
        return int(get())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _read(prof) -> Tuple[list, list, list]:
    """(device operations, host ops, the host's step annotations), each
    with its start and end in ns on the trace's one clock."""
    device, host, steps = [], [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        name = ev.name()
        if name.startswith("ProfilerStep"):
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                steps.append((start, end))    # one span per traced unit
            continue
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            kind = str(getattr(ev, "activity_type", lambda: "")()).lower()
            if kind and not any(k in kind for k in ("kernel", "memcpy",
                                                    "memset")):
                continue              # annotations on the device timeline
            is_kernel = ("kernel" in kind if kind else
                         not name.lower().startswith(("memcpy", "memset")))
            device.append((name, start, end, is_kernel))
        else:
            host.append((name, start, end))
    return device, host, steps


def profiled(units: int, step: Callable[[], None],
             counters: Optional[Callable[[], Dict[str, float]]] = None
             ) -> Trace:
    """Run step() 1 + `units` times under the profiler, the first as its
    warm-up; `counters` reads the program's counters, whose change over
    the traced units lands in `Trace.counters`."""
    out = {}

    def ready(prof):
        out["events"] = _read(prof)

    warnings.filterwarnings("ignore", message="Profiler clears events")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=units,
                                   repeat=1),
                 on_trace_ready=ready) as prof:
        step()
        prof.step()
        before = counters() if counters else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(units):
            step()
            if i < units - 1:
                prof.step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        after = counters() if counters else {}
        prof.step()
    device, host, steps = out["events"]
    if steps:                     # the window on the trace's own clock
        window_s = (max(e for _, e in steps)
                    - min(s for s, _ in steps)) * 1e-9
    return Trace(device=device, host=host, window_s=window_s, units=units,
                 counters={k: after[k] - before[k] for k in after})
