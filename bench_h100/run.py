"""One run of one benchmark cell of the PyTorch and CUDA port:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
    python3 -m bench_h100.run ...           (the same, from the root)

Loads the cell's configuration and traffic by name, builds or loads the
port's CUDA kernels from the checkout's ``build/`` (a fixed directory),
makes the graphs from the seed and loads the checkpoint, warms the cell's
shapes, measures for ``--seconds``, compares what the timed path produced
with the plain reference, and prints one JSON object as the last line of
standard output, after the compared numbers and their limits on standard
error. It exits non-zero and prints no result without a CUDA card, or if
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

os.environ["DISTGCN_TORCH_CACHE"] = str(ROOT / "build")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import distgcn_tpu_torch  # noqa: F401  (no port, no result)
    from bench_h100 import harness

    cell = harness.find_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{torch.cuda.device_count()} CUDA device(s), the cell needs "
              f"{cell.chips}", file=sys.stderr)
        return 3
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda")
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 4
    for name, c in out["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
