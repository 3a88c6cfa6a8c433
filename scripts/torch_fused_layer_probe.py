#!/usr/bin/env python3
"""Where the fused ChebGCN layer kernel's time goes on a CUDA card.

Builds `distgcn_tpu_torch/csrc/cheb_fused.cu` four times through
`ops/_build.py`, in parallel: as it is, with ``-DCHEB_FUSED_PHASES=1``
(phase 1 only: the occupancy scan and the tensor-core A-product), with
``-DCHEB_FUSED_PHASES=2`` (phase 2 only: the f32 W-products and the
epilogue) and with ``-DCHEB_FUSED_COUNT=1`` (the full layer, counting its
work). The first three run one hidden layer at the large path's shape
(N=65,536 geometric conflict graph of average degree 48, bitmap blocks of
256, F=128) and print their times from CUDA events (the mean of 50
launches, L2 flushed before each). The cut builds compute wrong layers:
they only split the time. The counting build prints how many 32-column
k-chunks of the tiles' block-rows were loaded and skipped, and how many
of the warps' 16-column MMA steps were computed: the share of the dense
work over whole blocks that the skips leave; its output must equal the
first build's.

Usage, from the repository root on a machine with a card:
    python3 scripts/torch_fused_layer_probe.py
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distgcn_tpu_torch.large import (build_large_graph,  # noqa: E402
                                     geometric_conflict_graph)
from distgcn_tpu_torch.ops import _build  # noqa: E402
from distgcn_tpu_torch.ops.cheb_fused import pad_layer_params  # noqa: E402
from distgcn_tpu_torch.ops.cheb_fused_cuda import (  # noqa: E402
    ARGTYPES, COUNT_DEFINES, read_counts)

F = 128
VARIANTS = (("full layer", ()),
            ("phase 1 only (occupancy scan + tensor-core A-product)",
             ("CHEB_FUSED_PHASES=1",)),
            ("phase 2 only (W-products + epilogue)", ("CHEB_FUSED_PHASES=2",)))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with ThreadPoolExecutor() as pool:       # one nvcc per variant
        list(pool.map(lambda d: _build.build(["cheb_fused"], d),
                      [d for _, d in VARIANTS] + [COUNT_DEFINES]))
    adj, _, _ = geometric_conflict_graph(65536, avg_degree=48.0, seed=0,
                                         order="grid")
    g = build_large_graph(adj, block_size=512, device=dev)
    ind = g.ind_bsr
    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((g.n_pad, F), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((F, F), generator=gen, device=dev) * F ** -0.5
    p = pad_layer_params({"w_0": w, "w_1": w * 0.5}, F)
    r = g.r.reshape(-1).contiguous()
    out = torch.empty((g.n_pad, F), dtype=torch.bfloat16, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # the argument list of ops.cheb_fused_cuda.fused_cheb_layer_kernel
    args = (ind.blk_vals.data_ptr(), 1, g.ind_row_ptr.data_ptr(),
            ind.blk_cols.data_ptr(), h.data_ptr(), r.data_ptr(),
            p["w1"].data_ptr(), p["w01"].data_ptr(), p["bias"].data_ptr(),
            out.data_ptr(), 0, 1, g.n_pad, ind.block_size, F,
            _build.stream_of(h))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; fused hidden layer N={g.n_pad} F={F}, "
          f"{ind.num_blocks} bitmap blocks of {ind.block_size}")
    for name, defines in VARIANTS:
        launch = _build.bind("cheb_fused", "cheb_fused_launch", ARGTYPES,
                             defines)
        for _ in range(3):
            launch(*args)
        times = []
        for _ in range(50):
            flush.zero_()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            launch(*args)
            e.record()
            times.append((s, e))
        torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in times) / len(times)
        print(f"{name}: {ms:.4f} ms")
    _build.bind("cheb_fused", "cheb_fused_launch", ARGTYPES)(*args)
    full = out.clone()
    read_counts()                               # zero the counts
    _build.bind("cheb_fused", "cheb_fused_launch", ARGTYPES,
                COUNT_DEFINES)(*args)
    c = read_counts()
    if not torch.equal(out, full):
        print("the counting build's layer differs from the full build's",
              file=sys.stderr)
        return 1
    chunks = c["chunks_loaded"] + c["chunks_skipped"]
    dense = chunks * 16        # 8 warps x 2 steps of 16 columns per chunk
    print(f"k-chunks (128 rows x 32 columns): {c['chunks_loaded']} loaded, "
          f"{c['chunks_skipped']} skipped of {chunks} "
          f"({c['chunks_loaded'] / chunks:.2%} loaded); warp MMA steps "
          f"(16 rows x 16 columns): {c['steps_computed']} computed, "
          f"{c['steps_skipped']} skipped in the loaded chunks, "
          f"{c['steps_computed'] / dense:.2%} of the {dense} steps over "
          f"whole blocks")
    total = c["cta_cycles"]
    print(f"SM cycles on thread 0 of each CTA (counting build): "
          f"occupancy scans {c['scan_cycles'] / total:.1%}, A-product "
          f"pipeline {c['pipeline_cycles'] / total:.1%}, phase 2 "
          f"{c['phase2_cycles'] / total:.1%} of {total} over the CTAs; "
          f"the largest CTA {c['max_cta_cycles']} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
