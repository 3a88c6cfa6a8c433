"""Readings for the limits of `correct`, on the card, many seeds in one
process:

    python3 bench_h100/calibrate.py --workload <cell> \
        [--program-seeds a,b,...] [--control-seeds c,d,e] [--seconds s] \
        [--fault tf32]

For each program seed it runs the cell as `run.py` does (window of
``--seconds``, then the check) and prints the compared numbers; for each
control seed it puts the reference, computed one precision step below the
configuration's, in the program's place and prints the same numbers
(`drivers/<driver>.control`). Each line carries the verdict a run would
give, by the same rule (`harness.verdict`): one JSON line per seed.
``--fault tf32`` runs the program with TF32 switched on inside its timed
step (the reference keeps full float32).
The benchmark's own runs never run the control or a fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=("tf32",), default=None)
    args = ap.parse_args(argv)
    os.environ["DISTGCN_TORCH_CACHE"] = str(ROOT / "build")

    from bench_h100 import harness

    cell = harness.find_cell(ROOT, args.workload)
    driver = harness.load_module(ROOT, "drivers", cell.traffic["driver"])
    side = "program"
    if args.fault == "tf32":
        tf32_in_step()
        side = "program_tf32"
    for seed in _seeds(args.program_seeds):
        t0 = time.perf_counter()
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, device=args.device)
        print(json.dumps({"side": side, "seed": seed,
                          "correct": out["correct"], "check": out["check"],
                          "metrics": out["metrics"],
                          "s": time.perf_counter() - t0}), flush=True)
    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        got = driver.control(cell, seed, args.device)
        checks = [(name, got[name], limit)
                  for name, limit in cell.limits.items()]
        print(json.dumps({"side": "control", "seed": seed,
                          "correct": harness.verdict(checks),
                          "check": {n: {"value": v, "limit": lim}
                                    for n, v, lim in checks},
                          "s": time.perf_counter() - t0}), flush=True)
    return 0


def tf32_in_step(patch=setattr) -> None:
    """TF32 switched on for the float32 matrix products at every call of
    the program's timed step, by wrapping the port's step makers through
    `patch` (setattr, or a test's monkeypatch). Set before the program's
    set-up, the flags would be put back by the port itself
    (`utils.device.resolve_device`)."""
    import torch

    from distgcn_tpu_torch import large
    from distgcn_tpu_torch.sim import device_sim

    def with_tf32(make):
        def make_broken(*args, **kwargs):
            step = make(*args, **kwargs)

            def broken(*a, **k):
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                return step(*a, **k)
            return broken
        return make_broken
    patch(device_sim, "make_closed_loop",
          with_tf32(device_sim.make_closed_loop))
    patch(large, "make_large_closed_loop",
          with_tf32(large.make_large_closed_loop))


if __name__ == "__main__":
    sys.exit(main())
