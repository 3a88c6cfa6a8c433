"""What both drivers share: seeds, the program's build directory, the
device's name and peak memory, and what the host did over the window."""

from __future__ import annotations

import gc
import os
import statistics
import threading
import time
from typing import Optional

import numpy as np
import torch


def seed_int(*parts: int) -> int:
    """A 63-bit seed from the run's seed and a stream label."""
    ss = np.random.SeedSequence([int(p) % (1 << 64) for p in parts])
    a, b = ss.generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def rng(*parts: int) -> np.random.Generator:
    return np.random.default_rng(seed_int(*parts))


def generator(device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_int(*parts))


def program_setup(device) -> None:
    """Point the port's kernel builds at the checkout's build directory and
    build (or find) every kernel before anything is timed."""
    from distgcn_tpu_torch.utils import compile_cache
    from distgcn_tpu_torch.utils.device import set_f32_matmul_highest

    compile_cache.enable_persistent_cache()
    set_f32_matmul_highest()
    if torch.device(device).type == "cuda":
        from distgcn_tpu_torch.ops import _build
        _build.build()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_facts(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"kind": str(device), "memory_peak_bytes": 0}
    return {"kind": torch.cuda.get_device_name(0),
            "memory_peak_bytes": torch.cuda.max_memory_allocated()}


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def summary(times) -> dict:
    """How the window's units spread: count, min, quartiles, max, first,
    last, and the mean of each tenth of the window in order (seconds)."""
    q = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
    parts = np.array_split(np.asarray(times, np.float64),
                           min(10, len(times)))
    return {"n": len(times), "min": min(times), "q1": q[0], "median": q[1],
            "q3": q[2], "max": max(times), "first": times[0],
            "last": times[-1], "tenths": [float(t.mean()) for t in parts]}


def _read_proc(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def _host_snapshot() -> dict:
    """The machine's steal time (CPU seconds over all CPUs), this thread's
    time waiting for a CPU, the process's CPU time, the CPUs' mean
    clock."""
    snap = {"wall": time.perf_counter(), "cpu": time.process_time()}
    stat = _read_proc("/proc/stat")
    if stat and stat.startswith("cpu "):
        fields = stat.split("\n", 1)[0].split()
        if len(fields) > 8:
            snap["steal"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    sched = _read_proc(f"/proc/self/task/{threading.get_native_id()}"
                       "/schedstat")
    if sched:
        snap["wait"] = int(sched.split()[1]) * 1e-9
    info = _read_proc("/proc/cpuinfo")
    if info:
        mhz = [float(line.split(":")[1]) for line in info.splitlines()
               if line.startswith("cpu MHz")]
        if mhz:
            snap["mhz"] = sum(mhz) / len(mhz)
    return snap


class HostWatch:
    """What the host did over the window, to explain how runs spread: the
    machine's steal time, the timing thread's wait for a CPU, the
    process's CPU time, Python's garbage collections, the CPUs' clock at
    both ends. It reads the kernel's counters at the window's two ends
    and times the collections as they happen."""

    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1
            self._t = None

    def start(self) -> "HostWatch":
        self.a = _host_snapshot()
        gc.callbacks.append(self._gc)
        return self

    def stop(self) -> dict:
        b = _host_snapshot()
        gc.callbacks.remove(self._gc)
        a = self.a
        out = {"window_s": b["wall"] - a["wall"],
               "process_cpu_s": b["cpu"] - a["cpu"],
               "gc_s": self.gc_s, "gc_n": self.gc_n}
        for key, name in (("steal", "steal_cpu_s"),
                          ("wait", "runqueue_wait_s")):
            if key in a and key in b:
                out[name] = b[key] - a[key]
        if "mhz" in a and "mhz" in b:
            out["cpu_mhz"] = [a["mhz"], b["mhz"]]
        return out
