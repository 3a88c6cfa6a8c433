"""What the per-layer metrics' readers (`metrics/<name>.py`) share. Each
takes the run's `trace.Trace`, the cell driver's ``work`` (model FLOPs,
the seconds and units of the untraced part, each kernel's name and least
time a launch) and returns the metric, or None where the trace holds
nothing to read (a kernel that did not run)."""

from __future__ import annotations

from typing import Optional

from bench_h100.counts import peaks


def slots(run) -> int:
    return run.trace.units * run.work["slots_per_unit"]


def idle_pct(run) -> Optional[float]:
    """The share of the untraced window in which the device did nothing:
    the trace's device-busy seconds a unit over the untraced window's
    host-clock seconds a unit. The profiler slows the host about twofold
    and the device's operations hardly at all, so a traced window's own
    idle share (``device.busy_s`` over ``device.window_s``) overstates
    it."""
    tr, w = run.trace, run.work
    if not tr.units or not w.get("timed_units") or w["timed_s"] <= 0:
        return None
    return 100.0 * (1.0 - (tr.busy_s() / tr.units)
                    / (w["timed_s"] / w["timed_units"]))


def kernels_per_slot(run) -> Optional[float]:
    return run.trace.n_kernels() / slots(run)


def mfu_pct(run) -> Optional[float]:
    """Model FLOPs of the untraced window over its time, as a share of the
    float32 peak outside the tensor cores."""
    w = run.work
    if not w.get("gcn_flops") or w["timed_s"] <= 0:
        return None
    return 100.0 * w["gcn_flops"] / w["timed_s"] / peaks.F32_FLOPS


def roofline_pct(run, key: str) -> Optional[float]:
    """The least time of the kernel's launches over their traced time."""
    k = run.work["kernels"].get(key)
    if k is None:
        return None
    times = run.trace.kernels(k["match"])
    if not times:
        return None
    return 100.0 * k["bound_s"] * len(times) / sum(times)


def counter_per_slot(run, name: str, per: float = 1.0) -> Optional[float]:
    value = run.trace.counters.get(name)
    if value is None:
        return None
    return value / per / slots(run)
