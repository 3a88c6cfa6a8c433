"""Drive the PyTorch/CUDA port (`distgcn_tpu_torch`) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. card details, then the build of every kernel in
   `distgcn_tpu_torch/csrc/` with nvcc (build time, registers, shared
   memory);
2. the LGS kernel (weights in: it ranks them itself) against its plain
   PyTorch version, on the card and on the CPU, at B=128, N=256 on seeded
   random graphs (density ~20/n): random weights, engineered ties,
   negative weights, max_rounds=1, a ragged N=100, weights with exact
   +0.0, -0.0 and NaN, all-equal weights (padding included) and bfloat16
   weights. Selections must be bit-equal, the kernel's largest per-graph
   round count must equal the plain round count, and the utility must be
   within rtol 1e-6 (one unit in the last place in bfloat16);
3. the solve pipeline with the repo's ERGDPG2 20-layer c32 checkpoint
   (gcn2_dqn) on that batch in f32: every schedule independent and
   maximal, GCN scores equal to the CPU path's on 8 graphs, and the mean
   utility ratio against the greedy baseline;
4. the main path: the closed loop at B=128, N=256, load 0.9 with the same
   model, f32 and bf16, feature modes gdpg (GCN hoisted) and dqn (GCN every
   slot). Queues finite, >= 0 and exactly 0 on padding; the LGS kernel
   launched at least once per slot; bf16 `avg_utility` within 1% of f32.
   Per-slot ms and graphs/s come from the marginal between T=100 and T=500
   episodes (host clock after `torch.cuda.synchronize()`);
5. kernel timings at B=128, N=256 with CUDA events around CUDA-graph
   replays (L2 flushed between launches): `batched_lgs_kernel` (f32 and
   bf16 weights), the bare launch, `lgs_ranks` alone as a yardstick,
   beside the plain version's time and the memory bound; the CUDA kernels
   one `batched_lgs_kernel` call enqueues (torch.profiler; must be 1) are
   counted after phase 11, since a profiler session slows the host's
   launches after it;
6. the large-graph path at `bench.py`'s size: the geometric conflict
   graph with N=65,536 and average degree 48 in serpentine order,
   `build_large_graph(block_size=512)` (bitmap structure blocks of
   256x256). Each large-graph kernel against its plain version on the
   card: the neighbour-max on bitmap and int8 streams (bit-equal,
   sentinel rows included), the SpMM on the bitmap stream (through
   `bsr_spmm_rows` and `bsr_spmm`) and on a weighted copy through its
   edge form (the structure bitmap plus per-edge values): the 512-wide
   value matrix's (`bsr_spmm_rows`, `bsr_spmm`) and the `LargeGraph`
   route's on the 256-wide structure blocks, each against
   `bsr_spmm_plain` over the value blocks and `edge_spmm_plain` over its
   edge form (rtol 2e-5, atol 1e-5), each with two launches bit-equal,
   and the fused layer of a 20-layer
   128-wide ChebGCN (K=1, glorot from a seeded generator), one hidden
   layer and the head (within 2^-6 of the largest |value|, mean relative
   difference < 1e-3, and two launches bit-equal);
7. the large-graph main path: `make_large_solve(predict="dqn")` through
   the fused route and the exact route (SpMM kernel), both schedules
   independent and maximal with utilities within 1%; `bsr_lgs` through
   the neighbour-max kernel equal to the plain `ell_lgs`; 20 fused-layer
   launches per fused solve and 2 neighbour-max launches per LGS round
   enqueued (`bsr_lgs.rounds_enqueued`, gated rounds included);
   the per-solve time as the marginal of two repeat counts, edges x
   layers / s, and the time of the solve with the GCN hoisted; then the
   weighted exact solve on phase 6's weighted copy: independent and
   maximal, utility within 1% of the same solve over `bsr_spmm_plain`
   layers, 20 SpMM launches per solve, and its per-solve marginal;
8. the large closed loop with the ERGDPG2 checkpoint (gdpg, GCN hoisted,
   load 0.9): queues finite, >= 0 and 0 on padding, the neighbour-max
   launched every slot;
9. the large-graph kernels timed at the main path's shapes (CUDA-graph
   replays, L2 flushed) beside the plain version, the bound and a PyTorch
   library call computing the same function where there is one; beside
   the SpMM, the share of nonzero bitmap words and the x bytes it reads,
   and its time on phase 6's weighted copy through the `LargeGraph` route
   (`f32_values_ms` in the kernels line, with the bound of the function,
   the bound of the f32 value blocks, the plain version's time,
   `torch.sparse.mm` on a CSR copy of the weighted matrix and the edge
   form of the 512-wide value matrix); beside the neighbour-max, its
   two launches of a large LGS round (the rank and spread passes) and
   each of them gated (the previous round's count 0); beside
   the fused layer,
   `exact_layer_ms`: the exact route's layer on the same inputs (SpMM
   kernel, two f32 matmuls, epilogue), timed the same way;
10. the sharded giant-graph path at phase 6's width: a one-rank NCCL
   group opened by `parallel.distributed.initialize` from the DISTGCN_*
   environment, the graph sharded by `shard_large_graph(adj, 1,
   block_size=256)` (the same 256x256 bitmap blocks as phase 6), and
   `make_sharded_large_solve` with the phase 6 model (predict="dqn"), whose
   selections must equal phase 7's exact route and its utility within rtol
   1e-5, and with a bias-only model (predict="mwis", scores = weights),
   whose selections must equal `bsr_lgs`. Launches: one SpMM per layer and
   one int32 and one f32 neighbour-max per LGS round per rank;
11. the int32 neighbour-max against its plain version at the solve's
   shapes (payloads up to 2^31 - 2, bit-equal), `distributed_lgs_ranks` on
   2^24 + 4096 weights with ties equal to `lgs_ranks` (where f32 ranks
   would collide), the int32 neighbour-max timed as in phase 9, and the
   sharded solve's time beside the exact route's (marginal of 2 and 6
   solves);
12. the agent: a `DQNAgent` (gcn2_dqn) loads a temporary copy of the
   ERGDPG2 l20 c32 checkpoint; `solve_mwis` on 8 ER graphs of 100..256
   nodes gives independent, maximal schedules (one LGS launch each); 32
   memorized samples are replayed once on the card and once on the CPU
   from the same params and Adam state (per-sample losses within rtol
   1e-4, each parameter within 2·lr·32 + rtol 1e-4), and the TF1 update on
   identical gradients agrees within rtol 1e-6;
13. the batched GDPG trainer: `cli.train_gdpg.main` with
   --device_batch=128 for one epoch over 512 generated ER graphs (64 test
   graphs, replay every 256 graphs, 200 samples a replay, a temporary
   model root): losses finite, params changed, at least 2 LGS launches a
   batch; one `make_train_pipeline` batch checked (schedules independent
   and maximal, head 0 of acts = rand on explored graphs); the pipeline's
   graphs/s (marginal of 1 and 5 batches), ms per replay sample (200
   samples) and the epoch's wall time;
14. the online training loop at B=128, N=256, load 0.9 with the ERGDPG2
   model in f32: T=20 and T=60 episodes give the per-slot marginal;
   losses finite, queues finite, >= 0 and 0 on padding, at least 2 LGS
   launches a slot; the peak device memory;
15. the iterative solvers: a `DQNAgent` (gcn2_dqn) with the ERGDPG2 l20
   c32 checkpoint runs DIT, CGS and rollout (b=16) on 8 ER graphs of
   100..256 nodes on the card and on the CPU: every schedule independent
   and maximal, utilities within 1% of the CPU's (the count of equal
   selections printed), one LGS launch per DIT step and one share=16
   launch per rollout step, none in CGS;
16. the diver family at full width: a `DiverAgent` with the ERUNI diver32
   l20 c32 checkpoint: head scores on 8 graphs within rtol 1e-4 of the
   CPU's; `batched_lgs_multi` (one launch of the LGS kernel with share=D)
   on the card's guided weights at Q=32, D=32, N=256, with a mask per
   variant, and at a ragged N=100, bit-equal to `batched_lgs_multi_plain`
   (sel and rounds; utility within rtol 1e-6); `solve_mwis_iterative` and
   `solve_mwis_bsf_many` (max_pops 8, batch_pops 8, group 4) on 16 graphs
   in f32 and bf16 (independent schedules, the iterative ones maximal,
   one LGS launch per pop batch, bf16 mean utility within 1% of f32);
   `eval_graphs.main` (ERDQNB) and `rollout_main` (ERUNI) on a generated
   32-graph ER set (every CSV row p > 0, graphs/s); the shared mode
   bit-equal to share=1 on a `repeat_interleave`d adjacency, and timed as
   phase 5 times B1, beside the plain version, that share=1 launch (the
   copy counted) and the byte bound;
17. the trainers: one epoch each of `train_dqn.main` (ERDQNB) and
   `train_diver.main` (ERUNI diver32) over 32 generated ER graphs with
   heuristic labels, in temporary model roots: losses finite, params
   changed;
18. the exact MWIS solver: the port's own copy of the native source built
   with g++ here (its path must not lie under `distgcn_tpu/`),
   `mwis_exact` equal to brute force on 20 graphs of 8..16 nodes and to
   `_python_bnb` on 8 graphs of 30..40 nodes (rtol 1e-9, Optimal), then
   timed on the 20 repo networks' conflict graphs with queue x rate
   weights (median and largest ms);
19. the wireless device loops over all 20 networks of
   `data/wireless_test/` in one batch (B=20, links padded to 128) with the
   ERGDPG2 l20 c32 checkpoint (`gcn_dqn`): `wireless_sim.main
   --device_loop=1` at n_ch=1 over loads 0.1..1.0 (2 B1 launches a slot)
   and at n_ch=3 on the product graph (384 nodes) at loads 0.3, 0.6, 0.9
   (1 a slot), `make_closed_loop_seq` at n_ch=3, load 0.6 (3 a slot).
   Queues finite, >= 0 and 0 on padding; B1's calls in the n_ch=1 and
   product-graph episodes held against the plain version on the same card
   tensors (phase 2's tolerances), and the product graph's schedules with
   at most one channel per link, independent, no padded node; bf16
   avg_utility of the n_ch=1 loop at load 0.9 within 1% of f32; the three
   loops again with pinned draws (constant rates, one fixed arrival array)
   on the card and on the CPU: end queues and metrics within rtol 1e-5, and
   their B1 calls against the plain version; decisions/s (B x T / wall) per
   loop and the peak device memory;
20. the host engine: `wireless_sim.main --opt=0` (Greedy, DGCN-LGS with the
   agent on the card, Benchmark with the exact solver) on the four
   smallest repo networks at loads 0.3 and 0.9, T=200; utility ratios <= 1;
   every resident solve's B1 call against the plain version; a resumed
   call adds no row; one (network, load) pair again with the agent on the
   CPU (Greedy and Benchmark identical, DGCN-LGS within rtol 1e-5, the
   slots scheduled differently counted); seconds per (network, load) split
   into exact solver and agent time; the largest network (81 links) at
   load 0.9, with the exact solves that ran the B&B's local search counted;
   one `--opt=5` (DGCN-LGS-Seq) instance at n_ch=3 with
   `--benchmark=greedy`, its B1 calls against the plain version;
21. the data-parallel train step and the multi-card dry run, in a one-rank
   NCCL group: `parallel.mesh.make_sharded_train_step` on the ERGDPG2
   l20 c32 checkpoint at B=128, N=256 (seeded graphs of 100..256 nodes,
   seeded labels), its loss and updated parameters against the unsharded
   step on the card (autograd of the same loss and one TF1 update, no
   collectives) and against the same step on the CPU (rtol 1e-5, atol
   1e-6); ms per step as the marginal of 2 and 6 steps, the kernels one
   step enqueues, a `utils.profiling.StepTimer` over 4 steps and a
   `utils.profiling.trace` of two steps (its three costliest CUDA
   kernels); then `dryrun.entry` and `dryrun.dryrun_multichip(1)`: every
   selection independent and maximal, and every call of B1 (against
   `batched_lgs_plain`), of the SpMM (bit-equal to `edge_spmm_plain` in
   the kernel's order on the CPU; `bsr_spmm_plain` within rtol 2e-5, atol
   1e-5) and of both neighbour-maxes (bit-equal to `bsr_nbr_max_plain`)
   on the run's own tensors;
22. the data-sharded closed loop, `make_closed_loop(..., mesh=make_mesh())`
   in the same one-rank group at phase 4's width, graphs and generator
   seed (B=128, N=256, load 0.9, the ERGDPG2 checkpoint): in gdpg and dqn
   f32 with the greedy baseline, T=100, queueT and every metric bit-equal
   to the unsharded loop; B1 launched 2 times a slot, every 25th call held
   against `batched_lgs_plain`; the gdpg ms a slot (marginal of T=100 and
   T=500), sharded and unsharded in turns, beside phase 4's.

The launch counts of the JSON line come from the main paths: phase 4 for the
LGS kernel, phases 7-8 for the large-graph kernels, phase 10 for the int32
neighbour-max (counts set to 0 just before, read just after); the LGS
entry's `train_launches` gives the trainer paths' main runs, each counted
the same way: phase 12's 40 solves, phase 13's `train_gdpg` epoch and phase
14's T=60 episode; `multi_launches` phase 16's diver searches (the shared
mode), `eval_launches` phases 15 and 17, and `wireless_launches` the
main paths of phases 19 (the two CLI sweeps, the sequential episode) and
20 (the host engine's first call, the largest network's pair, the
DGCN-LGS-Seq run); `dryrun_launches` phase 21's `dryrun_multichip(1)`;
`sharded_loop_launches` phase 22's two sharded episodes. `model/` is only
read: the trainers write into temporary copies. Runs of the sharded path across
several cards (D > 1 over NCCL) need a multi-card machine; this script
takes one card.

The line before the last is the card's name and power limit as nvidia-smi
reports them; the one before it a JSON object with one entry per kernel.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import scipy.io as sio
import scipy.sparse as sp
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from distgcn_tpu_torch.agents import DQNAgent, build_state_arrays
from distgcn_tpu_torch.agents_extra import DiverAgent, LegacyDQNAgent
from distgcn_tpu_torch.cli import eval_graphs, train_diver, train_dqn
from distgcn_tpu_torch import dryrun
from distgcn_tpu_torch.cli import train_gdpg, wireless_sim
from distgcn_tpu_torch.core.graph import GraphBatch
from distgcn_tpu_torch.core.prep import normalize_adj
from distgcn_tpu_torch.data.generate import er_graph, generate_graph_dataset
from distgcn_tpu_torch.data.matio import load_dataset_cached
from distgcn_tpu_torch.data.wireless import poisson_graphs_from_dict
from distgcn_tpu_torch.large import (_make_spmm, bsr_lgs, build_large_graph,
                                     geometric_conflict_graph,
                                     large_gcn_forward,
                                     make_large_closed_loop,
                                     make_large_solve, params_to_list)
from distgcn_tpu_torch.models.gcn import (ChebGCN, make_model_from_config,
                                          params_from_jax)
from distgcn_tpu_torch.models.layers import leaky_relu02
from distgcn_tpu_torch.ops import _build
from distgcn_tpu_torch.ops.cheb_fused import (fused_cheb_layer,
                                              fused_cheb_layer_plain,
                                              pad_layer_params)
from distgcn_tpu_torch.ops.cheb_fused_cuda import fused_cheb_layer_kernel
from distgcn_tpu_torch.ops.lgs import (batched_lgs, batched_lgs_multi,
                                       batched_lgs_multi_plain,
                                       batched_lgs_plain, ell_lgs,
                                       lgs_ranks)
from distgcn_tpu_torch.ops.lgs_cuda import (batched_lgs_kernel,
                                            block_threads, launch,
                                            smem_bytes)
from distgcn_tpu_torch.ops.nbr_max_cuda import (bsr_nbr_max_i32_kernel,
                                               bsr_nbr_max_kernel)
from distgcn_tpu_torch.ops.spmm import (I32_SENT, NEG_HUGE, BsrMatrix,
                                        bsr_nbr_max_plain, bsr_neighbor_max,
                                        bsr_row_ptr, bsr_spmm, bsr_spmm_plain,
                                        bsr_spmm_rows, edge_spmm_plain,
                                        lgs_round_passes, nbr_max_rows)
from distgcn_tpu_torch.ops.spmm_cuda import bsr_spmm_kernel
from distgcn_tpu_torch.parallel import distributed
from distgcn_tpu_torch.parallel.halo import distributed_lgs_ranks
from distgcn_tpu_torch.parallel import large_sharded as large_sharded_mod
from distgcn_tpu_torch.parallel.large_sharded import (make_sharded_large_solve,
                                                      shard_arrays,
                                                      shard_large_graph)
from distgcn_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step
from distgcn_tpu_torch import agents as agents_mod
from distgcn_tpu_torch import pipeline as pipeline_mod
from distgcn_tpu_torch.pipeline import (make_solve_pipeline,
                                        make_train_pipeline)
from distgcn_tpu_torch.rl.train import (apply_updates, first_layer_l2,
                                        make_optimizer)
from distgcn_tpu_torch.sim import device_sim
from distgcn_tpu_torch.sim import wireless as sim_wireless
from distgcn_tpu_torch.sim.device_sim import (make_closed_loop,
                                              make_closed_loop_mc,
                                              make_closed_loop_seq,
                                              make_online_training_loop)
from distgcn_tpu_torch.solvers import exact, iterative
from distgcn_tpu_torch.solvers.greedy import greedy_search
from distgcn_tpu_torch.utils.config import Config
from distgcn_tpu_torch.utils.directory import find_model_folder
from distgcn_tpu_torch.utils.profiling import StepTimer, trace
from distgcn_tpu_torch.utils.serialization import load_params

B, N = 128, 256
N_MIN = 100                    # smallest graph of a batch
CKPT = ("model/result_ERGDPG2_deep_ld1_c32_l20_cheb1_diver1_mwis_dqn/"
        "params.npz")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM, outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM tensor cores, dense
# the large-graph cell of bench.py:211-333
LARGE_N, LARGE_DEG, LARGE_LAYERS, LARGE_WIDTH = 65536, 48.0, 20, 128
LARGE_SLOTS = 30
ISOLATED = 1000                # nodes cut loose for the sentinel-row check
L2_FLUSH_BYTES = 64 << 20      # > the 50 MB L2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def graphs(rng, b, n_lo, n_hi, weights="random"):
    """Seeded random conflict graphs with density ~20/n (bench.py's)."""
    adjs, wtss = [], []
    for _ in range(b):
        n = int(rng.integers(n_lo, n_hi + 1))
        a = np.triu(rng.random((n, n)) < min(1.0, 20.0 / n), 1)
        adjs.append(sp.csr_matrix((a | a.T).astype(np.float32)))
        w = rng.random(n)
        if weights == "zeros_nan":        # exact +0.0, -0.0 and NaN
            w[rng.random(n) < 0.2] = 0.0
            w[rng.random(n) < 0.2] = -0.0
            w[rng.random(n) < 0.1] = np.nan
        wtss.append({"ties": np.ones(n), "negative": w - 0.5}.get(weights,
                                                                   w))
    return adjs, wtss


def independent_and_maximal(sel, adj, mask) -> bool:
    on = sel == 1
    a = adj > 0
    independent = not bool((a & on[:, :, None] & on[:, None, :]).any())
    covered = on | (a & on[:, None, :]).any(dim=-1)
    return independent and bool(covered[mask].all())


def event_ms(fn, iters, flush=None) -> float:
    """Mean device time of fn() over `iters` launches after one warm-up
    call, CUDA events around each launch; `flush` (a large buffer) is
    rewritten between launches so every launch finds a cold L2."""
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        if flush is not None:
            flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def phase_build(smi: str) -> None:
    print(f"phase 1: {smi} (name, power limit); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} "
          f"device(s)", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.3f} s",
          flush=True)
    for name, log in sorted(_build.BUILD_LOGS.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"phase 1: {name}.cu ptxas: {line.strip()}")
    print(f"phase 1: lgs dynamic shared memory at N={N}: "
          f"{smem_bytes(N, True)} bytes per CTA, {block_threads(N)} "
          "threads")


def phase_kernel_vs_plain(dev) -> float:
    rng = np.random.default_rng(0)
    # (weights, N, max_rounds); "equal": every weight 0.5, padding
    # included, so the ids decide every tie; "bf16": the random weights in
    # bfloat16, widened in the kernel
    cases = [("random", N, None), ("ties", N, None), ("negative", N, None),
             ("random", N, 1), ("random", 100, None),
             ("zeros_nan", N, None), ("equal", N, None), ("bf16", N, None)]
    worst = 0.0
    for weights, n, cap in cases:
        adjs, wtss = graphs(rng, B, min(N_MIN, n) // 2, n, weights)
        gb = GraphBatch.from_scipy(adjs, wtss, pad_to=n, device=dev)
        wts = {"equal": torch.full_like(gb.wts, 0.5),
               "bf16": gb.wts.bfloat16()}.get(weights, gb.wts)
        sel, util, rounds = batched_lgs_kernel(gb.adj, wts, gb.mask, cap)
        torch.cuda.synchronize()
        # the plain version on the card, and on the CPU (its order of
        # signed zeros and NaN is the one JAX's is held to)
        psel, putil, prounds = batched_lgs_plain(gb.adj, wts, gb.mask, cap)
        csel, cutil, crounds = batched_lgs_plain(gb.adj.cpu(), wts.cpu(),
                                                 gb.mask.cpu(), cap)
        torch.cuda.synchronize()
        err = float((sel.float() - psel.float()).abs().max())
        worst = max(worst, err)
        for where, ps, pr in (("card", psel, prounds),
                              ("CPU", csel, crounds)):
            check(torch.equal(sel.cpu(), ps.cpu()), f"sel differs from the "
                  f"plain version on the {where} ({weights}, N={n}, "
                  f"max_rounds={cap})")
            check(int(rounds.max()) == int(pr), f"rounds "
                  f"{int(rounds.max())} != {int(pr)} ({where})")
        check(util.dtype == wts.dtype, f"util dtype {util.dtype}")
        if wts.dtype == torch.bfloat16:
            ulps = int((util.view(torch.int16).int()
                        - putil.view(torch.int16).int()).abs().max())
            check(ulps <= 1, f"bf16 util {ulps} ulps from the plain one")
        else:
            torch.testing.assert_close(util, putil, rtol=1e-6, atol=1e-6,
                                       equal_nan=True)
        uerr = float((util.float() - putil.float()).abs().nan_to_num()
                     .max())
        print(f"phase 2: {weights:9s} N={n:3d} max_rounds={cap}: sel "
              f"bit-equal (card and CPU plain), rounds {int(prounds)} (per "
              f"graph {int(rounds.min())}..{int(rounds.max())}), util "
              f"{util.dtype} max abs diff {uerr:.3g}", flush=True)
    return worst


def phase_pipeline(dev, cfg, tree) -> None:
    rng = np.random.default_rng(1)
    adjs, wtss = graphs(rng, B, N_MIN, N)
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=N, device=dev)
    model = make_model_from_config(cfg, "gcn2_dqn",
                                   params=params_from_jax(tree), device=dev)
    solve = make_solve_pipeline(model, cfg, "gdpg", with_baseline=True)
    before = batched_lgs_kernel.launches
    sel, util, gutil = solve(gb.adj, gb.wts, gb.mask)
    torch.cuda.synchronize()
    check(batched_lgs_kernel.launches - before == 2,
          "solve pipeline did not launch the LGS kernel twice")
    check(tuple(sel.shape) == (B, N) and bool(torch.isfinite(util).all()),
          "pipeline outputs")
    check(independent_and_maximal(sel, gb.adj, gb.mask),
          "a pipeline schedule is not independent and maximal")
    # reference: the same forward on the CPU, first 8 graphs
    cpu_model = make_model_from_config(cfg, "gcn2_dqn",
                                       params=params_from_jax(tree),
                                       device="cpu")
    with torch.no_grad():
        feats, sups = build_state_arrays(gb.adj[:8], gb.wts[:8],
                                         gb.mask[:8], cfg.feature_size,
                                         cfg.max_degree)
        got = model(feats, sups).cpu()
        want = cpu_model(feats.cpu(), sups.cpu())
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, atol=1e-5, rtol=1e-4),
          f"GCN scores differ from the CPU path by {err}")
    ratio = float((util / gutil).mean())
    print(f"phase 3: ERGDPG2 l20 c32 solve pipeline f32, B={B} N={N}: "
          f"schedules independent+maximal, GCN vs CPU max abs diff "
          f"{err:.3g}, mean utility ratio vs greedy {ratio:.6f}",
          flush=True)


LOOP_SEED = 7                  # the closed loop's generator seed


def loop_config() -> Config:
    """The ERGDPG2 l20 c32 checkpoint's configuration in phases 3, 4 and
    22."""
    return Config(feature_size=1, hidden1=32, num_layer=20, diver_num=1,
                  max_degree=1, predict="mwis", pad_to=N, batch_size=B)


def loop_batch(dev, b=B) -> GraphBatch:
    """The closed loop's graphs: the first `b` of seed 2's stream (a larger
    batch starts with phase 4's 128), padded to N on `dev`."""
    adjs, wtss = graphs(np.random.default_rng(2), b, N_MIN, N)
    return GraphBatch.from_scipy(adjs, wtss, pad_to=N, device=dev)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def marginal_ms(work, lo: int, hi: int, dev):
    """ms a unit of work, the marginal between work(lo) and work(hi) units:
    the host clock after a synchronise and, in a process group, a barrier;
    the largest over the group's ranks. Returns (ms, {n: seconds of
    work(n)}, {n: work(n)})."""
    secs, out = {}, {}
    for n in (lo, hi):
        sync(dev)
        if dist.is_initialized():
            dist.barrier()
        t0 = time.perf_counter()
        out[n] = work(n)
        sync(dev)
        secs[n] = time.perf_counter() - t0
    ms = torch.tensor([(secs[hi] - secs[lo]) * 1e3 / (hi - lo)],
                      dtype=torch.float64, device=dev)
    if dist.is_initialized():
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
    return float(ms), secs, out


def phase_closed_loop(dev, cfg, tree) -> dict:
    """Phase 4; returns the ms a slot of each (mode, dtype)."""
    gb = loop_batch(dev)
    model = make_model_from_config(cfg, "gcn2_dqn",
                                   params=params_from_jax(tree), device=dev)
    q0 = torch.zeros((B, N), device=dev)
    avg_util, slot_ms = {}, {}
    for mode in ("gdpg", "dqn"):
        for dt in ("float32", "bfloat16"):
            cfg_d = cfg.replace(compute_dtype=dt)
            runs = {t: make_closed_loop(model, cfg_d, timeslots=t, load=0.9,
                                        feature_mode=mode)
                    for t in (3, 100, 500)}
            runs[3](gb.adj, gb.mask, q0,
                    torch.Generator(device=dev).manual_seed(0))  # warm-up

            def work(t):
                before = batched_lgs_kernel.launches
                out = runs[t](gb.adj, gb.mask, q0, torch.Generator(
                    device=dev).manual_seed(LOOP_SEED))
                check(batched_lgs_kernel.launches - before >= t,
                      f"{mode}/{dt}: fewer than {t} kernel launches")
                return out

            ms, secs, outs = marginal_ms(work, 100, 500, dev)
            for qT, metrics in outs.values():
                check(bool(torch.isfinite(qT).all())
                      and bool((qT >= 0).all()), f"{mode}/{dt}: queues")
                check(bool((qT[~gb.mask] == 0).all()),
                      f"{mode}/{dt}: padding queues not 0")
            avg_util[mode, dt] = float(metrics["avg_utility"].mean())
            slot_s = ms / 1e3
            slot_ms[mode, dt] = ms
            print(f"phase 4: closed loop {mode:4s} {dt:8s}: T=100 "
                  f"{secs[100]:.4f} s, T=500 {secs[500]:.4f} s, per slot "
                  f"{slot_s * 1e3:.4f} ms, {B / slot_s:.1f} graphs/s, "
                  f"avg_queue_len {float(metrics['avg_queue_len'].mean()):.4f}"
                  f", avg_utility {avg_util[mode, dt]:.2f}", flush=True)
        f32, bf16 = avg_util[mode, "float32"], avg_util[mode, "bfloat16"]
        rel = abs(bf16 - f32) / abs(f32)
        check(rel <= 0.01, f"{mode}: bf16 avg_utility off by {rel:.4%}")
        print(f"phase 4: {mode} bf16 vs f32 avg_utility rel diff {rel:.4%}")
    print(f"phase 4: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB",
          flush=True)
    return slot_ms


def graph_ms(fn, iters, flush=None) -> float:
    """Mean device time of fn() captured once in a CUDA graph and replayed
    between CUDA events: the host's enqueue time of fn's launches is not
    counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return event_ms(graph.replay, iters, flush)


def kernels_enqueued(fn) -> list:
    """The names of the CUDA kernels one call of fn enqueues, as
    torch.profiler traces them (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_timing(dev) -> dict:
    rng = np.random.default_rng(3)
    adjs, wtss = graphs(rng, B, N_MIN, N)
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=N, device=dev)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rounds = batched_lgs_kernel(gb.adj, gb.wts, gb.mask)[2]
    torch.cuda.reset_peak_memory_stats(dev)

    def wrapper():
        return batched_lgs_kernel(gb.adj, gb.wts, gb.mask)

    ms = graph_ms(wrapper, 200, flush)
    kernel_ms = graph_ms(lambda: launch(gb.adj, gb.wts, gb.mask, N), 200,
                         flush)
    wts16 = gb.wts.bfloat16()
    bf16_ms = graph_ms(lambda: batched_lgs_kernel(gb.adj, wts16, gb.mask),
                       200, flush)
    ranks_ms = graph_ms(lambda: lgs_ranks(gb.wts), 200, flush)
    eager_ms = event_ms(wrapper, 200, flush)
    peak = torch.cuda.max_memory_allocated(dev)
    plain_ms = event_ms(lambda: batched_lgs_plain(gb.adj, gb.wts, gb.mask),
                        20, flush)
    # least work: read adj, wts, mask once; write sel, util, rounds once
    nbytes = B * N * N + B * N * (4 + 1 + 1) + B * (4 + 4)
    # least operations: each round, a node compares at most every
    # neighbour's rank once (one per directed edge), on this run's rounds
    ops = int((gb.adj > 0).sum(dim=(1, 2)).to(torch.int64).mul(
        rounds.to(torch.int64)).sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"phase 5: lgs B={B} N={N}, L2 flushed before each launch: "
          f"batched_lgs_kernel (weights in; sel, util, rounds out) "
          f"{ms:.4f} ms (graph replay; {eager_ms:.4f} ms enqueued eagerly; "
          f"bf16 weights {bf16_ms:.4f} ms), the bare kernel launch "
          f"{kernel_ms:.4f} ms; lgs_ranks alone (a yardstick, off the "
          f"path) {ranks_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
          f"{bound_ms * 1e3:.3f} us ({nbytes} bytes; operations "
          f"{ops_ms * 1e3:.4f} us); at {bound_ms / ms:.2%} of the bound "
          f"(kernel alone {bound_ms / kernel_ms:.2%}); rounds per graph "
          f"{int(rounds.min())}..{int(rounds.max())}; peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    return {"ms": ms, "kernel_ms": kernel_ms, "bf16_ms": bf16_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "wrapper": wrapper}


def phase_enqueued(wrapper) -> int:
    """Phase 5's count, taken after every timed phase: a torch.profiler
    session leaves the launches after it slower on the host."""
    enqueued = kernels_enqueued(wrapper)
    check(len(enqueued) == 1, f"batched_lgs_kernel on f32 weights enqueued "
          f"{len(enqueued)} kernels: {enqueued}")
    print(f"phase 5 (counted after phase 11): kernels one batched_lgs_kernel "
          f"call enqueues: {len(enqueued)} ({', '.join(enqueued)})",
          flush=True)
    return len(enqueued)


# ---------------------------------------------------------------------------
# the large-graph path
# ---------------------------------------------------------------------------

def large_model_params(dev) -> list:
    """A 20-layer 128-wide ChebGCN (K=1, gcn_dqn: no bias, linear head),
    glorot-uniform from a seeded generator, as a per-layer list."""
    model = ChebGCN(in_dim=1, num_layer=LARGE_LAYERS, hidden_dim=LARGE_WIDTH,
                    out_dim=1, num_supports=2,
                    generator=torch.Generator().manual_seed(0))
    tree = {}
    for name, value in model.state_dict().items():
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = value
    return params_to_list(tree, device=dev)


def schedule_ok(sel, adj, n) -> bool:
    """Independent and maximal on the host's csr adjacency; nothing left
    undecided."""
    s = sel[:n].cpu().numpy()
    picked = np.flatnonzero(s == 1)
    independent = adj[picked][:, picked].nnz == 0
    covered = np.zeros(n, bool)
    covered[picked] = True
    covered[np.unique(adj[picked].indices)] = True
    return bool(independent and covered.all() and not (s == -1).any())


@contextlib.contextmanager
def exact_route():
    """DISTGCN_LARGE_EXACT=1: the large forward takes the f32 SpMM route."""
    old = os.environ.get("DISTGCN_LARGE_EXACT")
    os.environ["DISTGCN_LARGE_EXACT"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["DISTGCN_LARGE_EXACT"]
        else:
            os.environ["DISTGCN_LARGE_EXACT"] = old


def structure(adj, n_pad):
    s = sp.csr_matrix(adj, dtype=np.float32, copy=True)
    s.data[:] = 1.0
    s.resize(n_pad, n_pad)
    s.sort_indices()
    return s


def phase_large_setup(dev) -> SimpleNamespace:
    t0 = time.perf_counter()
    adj, wts, _ = geometric_conflict_graph(LARGE_N, avg_degree=LARGE_DEG,
                                           seed=0, order="grid")
    t1 = time.perf_counter()
    g = build_large_graph(adj, block_size=512, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ind = g.ind_bsr
    check(g.use_bsr and g.separable and g.bitmap and ind.block_size == 256,
          "the large graph is not a separable bitmap stream at 256")
    words = ind.blk_vals.numel() * 4
    print(f"phase 6: graph N={g.n} (n_pad {g.n_pad}), {adj.nnz} directed "
          f"edges, max degree {int(np.diff(adj.indptr).max())}, "
          f"{ind.num_blocks} structure blocks of 256x256 "
          f"({ind.num_blocks * 65536 / adj.nnz:.1f} cells per edge), "
          f"{words} bytes of bitmap words; graph {t1 - t0:.3f} s, build "
          f"{t2 - t1:.3f} s", flush=True)
    w = torch.zeros(g.n_pad)
    w[: g.n] = torch.from_numpy(wts)
    return SimpleNamespace(adj=adj, g=g, w=w.to(dev),
                           plist=large_model_params(dev))


def rel_mean(got, want) -> float:
    return float(((got - want).abs() / (want.abs() + 1e-2)).mean())


def phase_large_kernels(dev, L) -> dict:
    """Each large-graph kernel against its plain version at the main
    path's shapes; returns the largest |kernel - reference| per kernel."""
    g, ind = L.g, L.g.ind_bsr
    gen = torch.Generator(device=dev).manual_seed(11)
    errs = {}
    # neighbour-max: the main bitmap stream, and bitmap and int8 streams of
    # a copy whose first ISOLATED nodes have no edge (sentinel rows)
    keep = sp.diags((np.arange(g.n) >= ISOLATED).astype(np.float32))
    iso = structure(keep @ L.adj @ keep, g.n_pad)
    iso.eliminate_zeros()
    streams = [("bitmap", ind)]
    for kind, dtype in (("bitmap, isolated", "bits"),
                        ("int8, isolated", np.int8)):
        streams.append((kind, BsrMatrix.from_scipy(iso, 256, dtype=dtype,
                                                   device=dev)))
    x = torch.randn(g.n_pad, generator=gen, device=dev)
    worst = 0.0
    for kind, b in streams:
        rp = g.ind_row_ptr if b is ind else bsr_row_ptr(b)
        got = bsr_neighbor_max(b, x, rp)
        again = bsr_neighbor_max(b, x, rp)
        torch.cuda.synchronize()
        want = bsr_nbr_max_plain(b.blk_vals, rp, b.blk_cols, x, b.n_rows,
                                 256, b.bitmap)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"neighbour-max ({kind}) differs")
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"neighbour-max ({kind}): two launches differ")
        sentinel = int((want == NEG_HUGE).sum())
        if "isolated" in kind:
            check(sentinel >= ISOLATED, f"{kind}: {sentinel} sentinel rows")
        worst = max(worst, float((got - want).abs().max()))
        print(f"phase 6: bsr_nbr_max {kind}: {b.num_blocks} blocks, "
              f"bit-equal to the plain version, {sentinel} sentinel rows; "
              "two launches bit-equal", flush=True)
    errs["bsr_nbr_max"] = worst
    # SpMM: the exact route's operand r * y at F=128 on the structure
    # stream, and a weighted copy through the LargeGraph route (Anorm's
    # values as the edge form on the 256-wide structure blocks), each
    # against its plain version and the weighted one also against
    # torch.sparse.mm on a CSR copy of the same normalised matrix
    y = torch.randn((g.n_pad, LARGE_WIDTH), generator=gen, device=dev) * g.r
    rng = np.random.default_rng(12)
    wadj = sp.triu(L.adj, 1).tocsr()
    wadj.data = (rng.random(wadj.nnz) + 0.5).astype(np.float32)
    L.wadj = (wadj + wadj.T).tocsr()
    gw = build_large_graph(L.wadj, block_size=512, device=dev)
    gi = gw.ind_bsr
    check(not gw.separable and gw.edge is not None and gw.ell_cols is None
          and gw.edge.words is gi.blk_vals and gi.block_size == 256,
          "weighted edge form on the structure blocks")
    L.gw = gw
    wa = sp.csr_matrix(normalize_adj(L.wadj), dtype=np.float32)
    wa.resize(g.n_pad, g.n_pad)
    wa.sort_indices()
    L.wcsr = torch.sparse_csr_tensor(
        torch.from_numpy(wa.indptr.astype(np.int64)),
        torch.from_numpy(wa.indices.astype(np.int64)),
        torch.from_numpy(wa.data), size=(g.n_pad, g.n_pad),
        check_invariants=True).to(dev)
    anorm = _make_spmm(gw)
    cases = (
        ("bitmap", ind,
         [("plain version over the blocks", bsr_spmm_plain(
             ind.blk_vals, g.ind_row_ptr, ind.blk_cols, y, ind.n_rows, 256,
             True))],
         (("bsr_spmm_rows", lambda: bsr_spmm_rows(ind, y, g.ind_row_ptr)),
          ("bsr_spmm", lambda: bsr_spmm(ind, y)))),
        ("f32 edge form on the structure", gi,
         [("plain version over the edge form", edge_spmm_plain(
             gw.edge.words, gw.ind_row_ptr, gi.blk_cols, gw.edge.vals,
             gw.edge.off, y, g.n_pad, 256)),
          ("library call (torch.sparse.mm on the CSR)",
           torch.sparse.mm(L.wcsr, y))],
         (("the LargeGraph route", lambda: anorm(y)),
          ("the LargeGraph route", lambda: anorm(y)))))
    worst = 0.0
    for kind, b, wants, routes in cases:
        outs = []
        for route, fn in routes:
            got = fn()
            torch.cuda.synchronize()
            outs.append(got)
            for plain, want in wants:
                err = float((got - want).abs().max())
                worst = max(worst, err)
                check(torch.allclose(got, want, rtol=2e-5, atol=1e-5),
                      f"SpMM {kind} via {route}: max abs diff {err} from "
                      f"the {plain}")
                print(f"phase 6: bsr_spmm {kind} ({b.num_blocks} blocks of "
                      f"{b.block_size}) via {route}: max abs diff {err:.3g} "
                      f"from the {plain} (rtol 2e-5, atol 1e-5)", flush=True)
        check(torch.equal(*outs), f"SpMM {kind}: two launches differ")
        print(f"phase 6: bsr_spmm {kind}: the two launches bit-equal",
              flush=True)
    errs["bsr_spmm"] = worst
    # fused layer: one hidden layer and the head on the same bf16 input
    h = torch.randn((g.n_pad, LARGE_WIDTH), generator=gen,
                    device=dev).to(torch.bfloat16)
    r = g.r.reshape(-1).contiguous()
    worst = 0.0
    for li, act, dt in ((1, 1, torch.bfloat16),
                        (LARGE_LAYERS - 1, 0, torch.float32)):
        p = pad_layer_params(L.plist[li], LARGE_WIDTH)
        args = (ind.blk_vals, g.ind_row_ptr, ind.blk_cols, h, r, p["w1"],
                p["w01"], p["bias"], ind.n_rows, 256, act, dt, True)
        raw = fused_cheb_layer(*args)
        check(torch.equal(raw, fused_cheb_layer(*args)),
              f"fused layer {li + 1}: two launches differ")
        got = raw.float()
        torch.cuda.synchronize()
        want = fused_cheb_layer_plain(*args).float()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        rel = rel_mean(got, want)
        check(err <= 2.0 ** -6 * scale and rel < 1e-3,
              f"fused layer {li + 1}: max abs diff {err} (scale {scale}), "
              f"mean rel {rel}")
        worst = max(worst, err)
        print(f"phase 6: fused layer gc{li + 1} ({dt}): max abs diff "
              f"{err:.3g} <= 2^-6 x {scale:.4g}, mean rel diff {rel:.3g}; "
              "two launches bit-equal", flush=True)
    errs["cheb_fused"] = worst
    return errs


def marginal_s(fn, k_lo=2, k_hi=6, tries=2) -> float:
    """Seconds per call as the marginal between k_lo and k_hi calls
    (host clock after torch.cuda.synchronize(), best of `tries`)."""
    fn(0)
    t = {}
    for k in (k_lo, k_hi):
        best = None
        for _ in range(tries):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(k):
                fn(i)
            torch.cuda.synchronize()
            el = time.perf_counter() - t0
            best = el if best is None else min(best, el)
        t[k] = best
    return (t[k_hi] - t[k_lo]) / (k_hi - k_lo)


def phase_large_solve(dev, L) -> None:
    g, w, plist = L.g, L.w, L.plist
    m = g.mask.to(torch.float32)
    solve = make_large_solve(g, predict="dqn")
    f0, n0 = fused_cheb_layer_kernel.launches, bsr_nbr_max_kernel.launches
    e0 = bsr_lgs.rounds_enqueued
    sel_f, util_f, _ = solve(plist, w)
    torch.cuda.synchronize()
    fused_launches = fused_cheb_layer_kernel.launches - f0
    nbr_launches = bsr_nbr_max_kernel.launches - n0
    solve_enqueued = bsr_lgs.rounds_enqueued - e0
    check(fused_launches == LARGE_LAYERS,
          f"fused solve launched the fused layer {fused_launches} times")
    s0, f0 = bsr_spmm_kernel.launches, fused_cheb_layer_kernel.launches
    with exact_route():
        sel_x, util_x, _ = solve(plist, w)
        torch.cuda.synchronize()
    spmm_launches = bsr_spmm_kernel.launches - s0
    check(spmm_launches == LARGE_LAYERS
          and fused_cheb_layer_kernel.launches == f0,
          f"exact solve launched the SpMM {spmm_launches} times")
    check(schedule_ok(sel_f, L.adj, g.n), "fused schedule not valid")
    check(schedule_ok(sel_x, L.adj, g.n), "exact schedule not valid")
    util_f, util_x = float(util_f), float(util_x)
    rel = abs(util_f - util_x) / abs(util_x)
    check(rel <= 0.01, f"fused utility off the exact one by {rel:.4%}")
    flips = int((sel_f != sel_x).sum())
    # the LGS through the kernel against the plain gather LGS
    norm = (w.abs() * m).max() + 1e-9
    gcn_wts = large_gcn_forward(g, plist, (w / norm * m)[:, None])[:, 0] * m
    n1, e1 = bsr_nbr_max_kernel.launches, bsr_lgs.rounds_enqueued
    bsel, _, rounds = bsr_lgs(g, gcn_wts, g.mask)
    torch.cuda.synchronize()
    enqueued = bsr_lgs.rounds_enqueued - e1
    check(bsr_nbr_max_kernel.launches - n1 == 2 * enqueued >= 2 * int(rounds),
          "bsr_lgs did not launch the neighbour-max twice per round "
          "enqueued")
    ge = build_large_graph(L.adj, block_size=512, use_bsr=False, device=dev)
    esel, _, erounds = ell_lgs(ge.ell_cols, ge.ell_valid, gcn_wts, g.mask)
    check(torch.equal(bsel, esel) and int(rounds) == int(erounds),
          "bsr_lgs differs from the plain ell_lgs")
    check(torch.equal(bsel, sel_f), "bsr_lgs differs from the fused solve")
    check(nbr_launches == 2 * solve_enqueued, "solve's LGS launches")
    print(f"phase 7: make_large_solve dqn, {LARGE_LAYERS}x{LARGE_WIDTH} "
          f"GCN: fused and exact schedules independent and maximal; "
          f"utility fused {util_f:.6f}, exact {util_x:.6f} (rel diff "
          f"{rel:.4%}), {flips} selections differ; bsr_lgs == ell_lgs "
          f"({int(rounds)} rounds, {enqueued} enqueued); launches per "
          f"fused solve: fused layer "
          f"{fused_launches}, neighbour-max {nbr_launches}; per exact "
          f"solve: SpMM {spmm_launches}", flush=True)
    per_solve = marginal_s(lambda i: solve(plist, w * (1.0 + 0.001 * i)))
    with exact_route():
        per_exact = marginal_s(lambda i: solve(plist,
                                               w * (1.0 + 0.001 * i)))
    feats = m[:, None]                    # mwis features: 1 / F
    act = large_gcn_forward(g, plist, feats)[:, 0] * m
    per_hoisted = marginal_s(
        lambda i: bsr_lgs(g, act * w * (1.0 + 0.001 * i), g.mask))
    print(f"phase 7: per solve (marginal of 2 and 6 solves): fused dqn "
          f"{per_solve * 1e3:.4f} ms = "
          f"{L.adj.nnz * LARGE_LAYERS / per_solve / 1e9:.4f} Gedge-layers/s"
          f"; exact dqn {per_exact * 1e3:.4f} ms; GCN hoisted (LGS only) "
          f"{per_hoisted * 1e3:.4f} ms", flush=True)


def plain_weighted_solve(gw, plist, w):
    """The weighted exact dqn solve with every layer's SpMM from
    `edge_spmm_plain` over the graph's edge form: (sel, util)."""
    e, ind = gw.edge, gw.ind_bsr
    m = gw.mask.to(torch.float32)
    h = (w / ((w.abs() * m).max() + 1e-9) * m)[:, None]
    for li, layer in enumerate(plist):
        y = h @ layer["w_1"]
        y = y - edge_spmm_plain(e.words, gw.ind_row_ptr, ind.blk_cols,
                                e.vals, e.off, y, ind.n_rows, ind.block_size)
        out = h @ layer["w_0"] + y
        if "bias" in layer:
            out = out + layer["bias"]
        h = leaky_relu02(out) if li < len(plist) - 1 else out
    sel = bsr_lgs(gw, h[:, 0] * m, gw.mask)[0]
    return sel, torch.where(sel == 1, w, torch.zeros_like(w)).sum()


def phase_weighted_solve(L) -> None:
    """Phase 7's weighted solve: `make_large_solve(predict="dqn")` on phase
    6's weighted copy, whose every layer runs the SpMM kernel over the
    edge form."""
    gw, w, plist = L.gw, L.w, L.plist
    solve = make_large_solve(gw, predict="dqn")
    s0 = bsr_spmm_kernel.launches
    sel, util, _ = solve(plist, w)
    torch.cuda.synchronize()
    launches = bsr_spmm_kernel.launches - s0
    check(launches == LARGE_LAYERS,
          f"weighted solve launched the SpMM {launches} times")
    check(schedule_ok(sel, L.wadj, gw.n), "weighted schedule not valid")
    psel, putil = plain_weighted_solve(gw, plist, w)
    check(schedule_ok(psel, L.wadj, gw.n), "plain weighted schedule")
    util, putil = float(util), float(putil)
    rel = abs(util - putil) / abs(putil)
    check(rel <= 0.01, f"weighted utility off the plain layers' by {rel:.4%}")
    per_solve = marginal_s(lambda i: solve(plist, w * (1.0 + 0.001 * i)))
    print(f"phase 7: weighted make_large_solve dqn {LARGE_LAYERS}x"
          f"{LARGE_WIDTH} (edge form on {gw.ind_bsr.num_blocks} blocks of "
          f"256, {gw.edge.vals.numel()} values): schedule independent and "
          f"maximal; utility {util:.6f}, with edge_spmm_plain layers "
          f"{putil:.6f} (rel diff {rel:.4%}), "
          f"{int((sel != psel).sum())} selections differ; SpMM launches "
          f"per solve {launches}; per solve (marginal of 2 and 6 solves) "
          f"{per_solve * 1e3:.4f} ms", flush=True)


def phase_large_closed_loop(dev, L, tree) -> None:
    g = L.g
    plist = params_to_list(tree, device=dev)
    run = make_large_closed_loop(g, timeslots=LARGE_SLOTS, load=0.9)
    q0 = torch.zeros(g.n_pad, device=dev)
    n0 = bsr_nbr_max_kernel.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qT, metrics = run(plist, q0, torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nbr = bsr_nbr_max_kernel.launches - n0
    check(nbr >= 2 * LARGE_SLOTS, f"neighbour-max launched {nbr} times in "
          f"{LARGE_SLOTS} slots")
    check(bool(torch.isfinite(qT).all()) and bool((qT >= 0).all()),
          "large closed-loop queues")
    check(bool((qT[~g.mask] == 0).all()), "padding queues not 0")
    print(f"phase 8: large closed loop, ERGDPG2 l20 c32, gdpg (GCN "
          f"hoisted), load 0.9, {LARGE_SLOTS} slots: {secs:.4f} s "
          f"({secs / LARGE_SLOTS * 1e3:.4f} ms per slot, set-up included), "
          f"neighbour-max launches {nbr}, avg_queue_len "
          f"{float(metrics['avg_queue_len']):.4f}, avg_utility "
          f"{float(metrics['avg_utility']):.2f}, sched_rate "
          f"{float(metrics['sched_rate']):.6f}", flush=True)


def bound(nbytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (f32_ops / F32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_large_timing(dev, L) -> dict:
    g, ind, rp = L.g, L.g.ind_bsr, L.g.ind_row_ptr
    n, nnz, f = g.n_pad, L.adj.nnz, LARGE_WIDTH
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    words = ind.blk_vals.numel() * 4
    meta = rp.numel() * 4 + ind.blk_cols.numel() * 4
    coo = L.adj.tocoo()
    src = torch.from_numpy(coo.col.astype(np.int64)).to(dev)
    dst = torch.from_numpy(coo.row.astype(np.int64)).to(dev)
    out = {}

    def report(name, ms, plain_ms, lib_ms, bnd, what):
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     **bnd}
        lib = "null" if lib_ms is None else f"{lib_ms:.4f} ms (eager)"
        print(f"phase 9: {name} {what}, L2 flushed: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library {lib}, bound "
              f"{bnd['bound_ms'] * 1e3:.3f} us ({bnd['bound_by']}), kernel "
              f"at {bnd['bound_ms'] / ms:.2%} of the bound", flush=True)

    # neighbour-max on the LGS's rank operand
    x = lgs_ranks(L.w).to(torch.float32)
    ms = graph_ms(lambda: bsr_neighbor_max(ind, x, rp), 100, flush)
    plain_ms = event_ms(lambda: bsr_nbr_max_plain(
        ind.blk_vals, rp, ind.blk_cols, x, n, 256, True), 5, flush)
    lib_ms = event_ms(lambda: torch.full((n,), NEG_HUGE, device=dev)
                      .scatter_reduce_(0, dst, x[src], "amax"), 50, flush)
    report("bsr_nbr_max", ms, plain_ms, lib_ms,
           bound(words + meta + 2 * n * 4, f32_ops=nnz),
           "bitmap N=65,536 (library: scatter_reduce amax over the edge "
           "list, the x[src] gather counted)")
    # the large LGS round's two launches of the same kernel on the same
    # operand, each with its epilogue (the spread pass's replays find the
    # first replay's winners decided), open (counts slot 0 holds 1) and
    # gated (slot 2 holds 0); bound at each call to the capturing stream
    key, win = x.clone(), torch.empty_like(x)
    sel = torch.full((n,), -1, dtype=torch.int8, device=dev)
    counts = torch.tensor([1, 0, 0], dtype=torch.int32, device=dev)

    def passes():
        return lgs_round_passes(ind.blk_vals, rp, ind.blk_cols, key, win, sel,
                                counts, n, 256, True)

    for i, name in enumerate(("rank", "spread")):
        for gate, prev in (("", 0), ("gated_", 2)):
            kind = f"lgs_{gate}{name}_pass"
            out[kind] = {"ms": graph_ms(lambda: passes()[i](prev, 1), 100,
                                        flush)}
            print(f"phase 9: bsr_nbr_max lgs {gate}{name} pass, L2 "
                  f"flushed: kernel {out[kind]['ms']:.4f} ms (the plain "
                  f"store {ms:.4f} ms)", flush=True)
    # SpMM on the exact route's operand
    y = torch.randn((n, f), generator=gen, device=dev) * g.r
    ms = graph_ms(lambda: bsr_spmm_rows(ind, y, rp), 50, flush)
    plain_ms = event_ms(lambda: bsr_spmm_plain(
        ind.blk_vals, rp, ind.blk_cols, y, n, 256, True), 5, flush)
    a = structure(L.adj, n)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.ones(nnz), size=(n, n), check_invariants=True).to(dev)
    lib_ms = event_ms(lambda: torch.sparse.mm(csr, y), 50, flush)
    report("bsr_spmm", ms, plain_ms, lib_ms,
           bound(words + meta + 2 * n * f * 4, f32_ops=2 * nnz * f),
           "bitmap N=65,536 F=128 (library: torch.sparse.mm on a CSR copy)")
    nz = int(torch.count_nonzero(ind.blk_vals))
    print(f"phase 9: bsr_spmm bitmap: {nz} of {ind.blk_vals.numel()} words "
          f"nonzero ({nz / ind.blk_vals.numel():.2%}), "
          f"{nnz / nz:.2f} edges per nonzero word; the kernel reads x once "
          f"per nonzero word: {nz * f * 4} bytes (once per edge: "
          f"{nnz * f * 4}), kernel {ms:.4f} ms", flush=True)
    # phase 6's weighted copy through the LargeGraph route (the edge form on
    # the 256-wide structure blocks): its function's bound (words, values,
    # run offsets, block ids, x and y), and torch.sparse.mm on phase 6's
    # CSR copy of the same (normalised, weighted) matrix
    gw, ge, gi = L.gw, L.gw.edge, L.gw.ind_bsr
    anorm = _make_spmm(gw)
    vms = graph_ms(lambda: anorm(y), 50, flush)
    vplain_ms = event_ms(lambda: edge_spmm_plain(
        ge.words, gw.ind_row_ptr, gi.blk_cols, ge.vals, ge.off, y, n, 256),
        5, flush)
    ebytes = (ge.words.numel() + ge.vals.numel() + ge.off.numel()
              + gw.ind_row_ptr.numel() + gi.blk_cols.numel()) * 4
    vbnd = bound(ebytes + 2 * n * f * 4, f32_ops=2 * nnz * f)
    lib = torch.sparse.mm(L.wcsr, y)
    check(torch.allclose(anorm(y), lib, rtol=2e-5, atol=1e-5),
          "the edge-form SpMM differs from torch.sparse.mm")
    wlib_ms = event_ms(lambda: torch.sparse.mm(L.wcsr, y), 50, flush)
    out["bsr_spmm"].update(f32_values_ms=vms,
                           f32_values_bound_ms=vbnd["bound_ms"],
                           f32_values_plain_ms=vplain_ms,
                           f32_values_library_ms=wlib_ms)
    print(f"phase 9: bsr_spmm f32 edge form ({gi.num_blocks} blocks of 256, "
          f"{ge.vals.numel()} values) F=128, L2 flushed: kernel {vms:.4f} ms "
          f"(the LargeGraph route), plain {vplain_ms:.4f} ms, library "
          f"{wlib_ms:.4f} ms (torch.sparse.mm on the weighted CSR, eager), "
          f"bound {vbnd['bound_ms'] * 1e3:.3f} us ({vbnd['bound_by']}: "
          f"{ebytes} bytes of edge form), kernel at "
          f"{vbnd['bound_ms'] / vms:.2%} of the bound", flush=True)
    # fused hidden layer
    h = torch.randn((n, f), generator=gen, device=dev).to(torch.bfloat16)
    r = g.r.reshape(-1).contiguous()
    p = pad_layer_params(L.plist[1], f)
    args = (ind.blk_vals, rp, ind.blk_cols, h, r, p["w1"], p["w01"],
            p["bias"], n, 256, 1, torch.bfloat16, True)
    ms = graph_ms(lambda: fused_cheb_layer(*args), 50, flush)
    plain_ms = event_ms(lambda: fused_cheb_layer_plain(*args), 5, flush)
    # the yardstick: the exact route's layer (SpMM kernel, two f32 matmuls,
    # epilogue) on the same inputs, timed the same way
    h32 = h.float()
    exact_ms = graph_ms(lambda: large_gcn_forward(
        g, [L.plist[1]], h32, final_act=leaky_relu02, fused=False), 50,
        flush)
    report("cheb_fused", ms, plain_ms, None,
           bound(words + meta + 2 * n * f * 2 + n * 4 + 2 * f * f * 4 + f * 4,
                 f32_ops=4 * n * f * f, bf16_ops=2 * nnz * f),
           "hidden layer N=65,536 F=128 (no single PyTorch call computes "
           "the layer)")
    print(f"phase 9: cheb_fused exact_layer_ms {exact_ms:.4f} (the exact "
          f"route's hidden layer on the same inputs, graph replay, L2 "
          f"flushed): the fused kernel takes {ms / exact_ms:.2%} of it",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# the sharded giant-graph path
# ---------------------------------------------------------------------------

RANKS_N = (1 << 24) + 4096     # past f32's exact integers


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def nccl_group(dev):
    """A one-rank NCCL group opened by `parallel.distributed.initialize`
    from the DISTGCN_* environment; destroyed on exit."""
    env = {"DISTGCN_COORDINATOR": f"localhost:{free_port()}",
           "DISTGCN_NUM_PROCESSES": "1", "DISTGCN_PROCESS_ID": "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        check(distributed.initialize(device=dev),
              "initialize did not open a process group")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bias_only_params(dev):
    """One layer, zero kernels, bias 1: scores are 1 on every real node."""
    return params_to_list({"gc1": {"w_0": torch.zeros(1, 1),
                                   "w_1": torch.zeros(1, 1),
                                   "bias": torch.ones(1)}}, device=dev)


def phase_sharded(dev, L) -> SimpleNamespace:
    """The sharded main path (phase 10); returns what phase 11 needs."""
    g, w = L.g, L.w
    # the single-card references, before the counts are reset
    with exact_route():
        n0 = bsr_lgs.rounds
        xsel, xutil, _ = make_large_solve(g, predict="dqn")(L.plist, w)
        torch.cuda.synchronize()
        x_rounds = bsr_lgs.rounds - n0
    bsel, butil, b_rounds = bsr_lgs(g, w, g.mask)
    b_rounds = int(b_rounds)
    t0 = time.perf_counter()
    sg = shard_large_graph(L.adj, 1, block_size=256)
    t1 = time.perf_counter()
    ind = g.ind_bsr
    check(sg.bitmap and sg.separable and sg.nnz_blocks == ind.num_blocks
          and np.array_equal(sg.ind[0, 0, :sg.nnz_blocks],
                             ind.blk_vals.cpu().numpy()),
          "the sharded panel is not phase 6's bitmap stream")
    rank, world, _, _ = distributed.process_info()
    check(dist.get_backend() == "nccl" and (rank, world) == (0, 1),
          f"process group {dist.get_backend()} rank {rank} of {world}")
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)                 # the group's collectives run
    check(float(probe) == 1.0, "NCCL all_reduce")
    a = shard_arrays(sg, device=dev)
    w_loc = distributed.host_to_local(w.cpu().numpy(), rank, world, dev)
    m_loc = a[4]
    solve = make_sharded_large_solve(sg, predict="dqn", device=dev)
    bsolve = make_sharded_large_solve(sg, predict="mwis", device=dev)
    bplist = bias_only_params(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"phase 10: NCCL group of {world} rank(s); shard_large_graph(D=1, "
          f"bs=256) {t1 - t0:.3f} s: {sg.nnz_blocks} bitmap blocks, the "
          f"words of phase 6; shard_arrays {t2 - t1:.3f} s", flush=True)

    reset_launch_counts()
    sel, util = solve(*a[:4], L.plist, w_loc, m_loc)
    torch.cuda.synchronize()
    dqn = launch_counts()
    sel_b, util_b = bsolve(*a[:4], bplist, w_loc, m_loc)
    torch.cuda.synchronize()
    total = launch_counts()
    bias = {k: total[k] - dqn[k] for k in total}

    check(dqn["bsr_spmm"] == world * LARGE_LAYERS
          and dqn["bsr_nbr_max_i32"] == dqn["bsr_nbr_max"]
          == world * x_rounds and dqn["cheb_fused"] == 0,
          f"sharded dqn solve launches {dqn} ({x_rounds} LGS rounds)")
    check(bias["bsr_spmm"] == world and bias["bsr_nbr_max_i32"]
          == bias["bsr_nbr_max"] == world * b_rounds,
          f"sharded bias-only solve launches {bias} ({b_rounds} rounds)")
    flips = int((sel != xsel).sum())
    rel = abs(float(util) - float(xutil)) / abs(float(xutil))
    check(flips == 0 and rel <= 1e-5, f"sharded dqn solve: {flips} "
          f"selections differ from the exact route, utility rel {rel}")
    check(schedule_ok(sel, L.adj, g.n), "sharded schedule not valid")
    bflips = int((sel_b != bsel).sum())
    brel = abs(float(util_b) - float(butil)) / abs(float(butil))
    check(bflips == 0 and brel <= 1e-5, f"sharded bias-only solve: {bflips} "
          f"selections differ from bsr_lgs, utility rel {brel}")
    print(f"phase 10: make_sharded_large_solve dqn {LARGE_LAYERS}x"
          f"{LARGE_WIDTH}: {flips} selections differ from the exact route "
          f"(utility {float(util):.6f} vs {float(xutil):.6f}, rel "
          f"{rel:.3g}); launches: SpMM {dqn['bsr_spmm']}, int32 "
          f"neighbour-max {dqn['bsr_nbr_max_i32']}, f32 neighbour-max "
          f"{dqn['bsr_nbr_max']} ({x_rounds} LGS rounds)", flush=True)
    print(f"phase 10: bias-only mwis solve: {bflips} selections differ from "
          f"bsr_lgs (utility {float(util_b):.6f} vs {float(butil):.6f}); "
          f"launches: SpMM {bias['bsr_spmm']}, int32 neighbour-max "
          f"{bias['bsr_nbr_max_i32']}, f32 neighbour-max "
          f"{bias['bsr_nbr_max']} ({b_rounds} LGS rounds)", flush=True)
    return SimpleNamespace(sg=sg, a=a, w_loc=w_loc, solve=solve,
                           launches=total["bsr_nbr_max_i32"],
                           counts={"dqn": dqn, "bias": bias})


def phase_sharded_kernels(dev, L, S) -> dict:
    """Phase 11: the int32 neighbour-max against its plain version and
    timed, the distributed ranks past 2^24, the sharded solve's time."""
    n, nnz = S.sg.n_loc, L.adj.nnz
    ind, rptr, cols = S.a[0][0], S.a[1][0], S.a[2][0]
    gen = torch.Generator(device=dev).manual_seed(17)
    ranks = lgs_ranks(S.w_loc)
    remain = torch.rand(n, generator=gen, device=dev) < 0.5
    # the rank operand of an LGS round, and the same shifted to the top of
    # the int32 range (payloads past 2^24 up to 2^31 - 2)
    x_round = torch.where(remain, ranks, -1)
    x_high = torch.where(remain, ranks + (2 ** 31 - 2 - n), -1)
    worst = 0
    for kind, x in (("round operand", x_round), ("payloads to 2^31-2",
                                                 x_high)):
        got = nbr_max_rows(ind, rptr, cols, x, n, 256, True)
        torch.cuda.synchronize()
        want = bsr_nbr_max_plain(ind, rptr, cols, x, n, 256, True)
        check(torch.equal(got, want), f"int32 neighbour-max ({kind}) "
              "differs from its plain version")
        worst = max(worst, int((got.long() - want.long()).abs().max()))
        print(f"phase 11: bsr_nbr_max_i32 {kind}: bit-equal to the plain "
              f"version, max {int(got.max())}, "
              f"{int((got == I32_SENT).sum())} sentinel rows", flush=True)
    # ranks past f32's integers
    w_big = torch.rand(RANKS_N, generator=gen, device=dev)
    w_big[torch.randint(0, RANKS_N, (RANKS_N // 8,), generator=gen,
                        device=dev)] = 0.5
    t0 = time.perf_counter()
    r_dist = distributed_lgs_ranks(w_big)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r_ref = lgs_ranks(w_big)
    check(torch.equal(r_dist, r_ref) and int(r_dist.min()) == 1
          and int(r_dist.max()) == RANKS_N, "distributed_lgs_ranks differs "
          "from lgs_ranks past 2^24")
    collide = int((r_dist.float().long() != r_dist.long()).sum())
    check(collide > 0, "f32 would have kept every rank")
    print(f"phase 11: distributed_lgs_ranks n={RANKS_N} ({RANKS_N // 8} "
          f"draws tied at 0.5): equal to lgs_ranks, {collide} ranks not "
          f"exact in f32; {(t1 - t0) * 1e3:.3f} ms", flush=True)
    # the int32 neighbour-max at the solve's shapes
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    coo = L.adj.tocoo()
    src = torch.from_numpy(coo.col.astype(np.int64)).to(dev)
    dst = torch.from_numpy(coo.row.astype(np.int64)).to(dev)
    ms = graph_ms(lambda: nbr_max_rows(ind, rptr, cols, x_round, n, 256,
                                       True), 100, flush)
    plain_ms = event_ms(lambda: bsr_nbr_max_plain(ind, rptr, cols, x_round,
                                                  n, 256, True), 5, flush)
    lib_ms = event_ms(lambda: torch.full((n,), I32_SENT, dtype=torch.int32,
                                         device=dev).scatter_reduce_(
        0, dst, x_round[src], "amax"), 50, flush)
    words = S.sg.nnz_blocks * 8 * 256 * 4
    meta = (rptr.numel() + S.sg.nnz_blocks) * 4
    bnd = bound(words + meta + 2 * n * 4, f32_ops=nnz)
    print(f"phase 11: bsr_nbr_max_i32 bitmap N={n}, L2 flushed: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
          f"(scatter_reduce int32 amax over the edge list, x[src] gather "
          f"counted, eager), bound {bnd['bound_ms'] * 1e3:.3f} us "
          f"({bnd['bound_by']}: {words + meta + 2 * n * 4} bytes), kernel "
          f"at {bnd['bound_ms'] / ms:.2%} of the bound", flush=True)
    # the sharded solve beside the exact route
    per_sharded = marginal_s(lambda i: S.solve(
        *S.a[:4], L.plist, S.w_loc * (1.0 + 0.001 * i), S.a[4]))
    exact = make_large_solve(L.g, predict="dqn")
    with exact_route():
        per_exact = marginal_s(lambda i: exact(L.plist,
                                               L.w * (1.0 + 0.001 * i)))
    print(f"phase 11: per solve (marginal of 2 and 6 solves): sharded dqn "
          f"(D=1) {per_sharded * 1e3:.4f} ms, exact route "
          f"{per_exact * 1e3:.4f} ms", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, **bnd}


LARGE_KERNELS = (
    ("bsr_nbr_max", "distgcn_tpu_torch/csrc/bsr_nbr_max.cu",
     "distgcn_tpu/ops/spmm.py:614"),
    ("bsr_spmm", "distgcn_tpu_torch/csrc/bsr_spmm.cu",
     "distgcn_tpu/ops/spmm.py:203"),
    ("cheb_fused", "distgcn_tpu_torch/csrc/cheb_fused.cu",
     "distgcn_tpu/ops/cheb_fused.py:364"),
)


# ---------------------------------------------------------------------------
# the trainer paths
# ---------------------------------------------------------------------------

TRAIN_LR = 1e-4
MODEL_DIR = os.path.dirname(CKPT)


def train_config(**kw) -> Config:
    """The ERGDPG2 l20 c32 checkpoint's configuration, as `train_gdpg`
    names it (`find_model_folder` resolves to MODEL_DIR's name)."""
    return Config(feature_size=1, hidden1=32, num_layer=20, diver_num=1,
                  max_degree=1, predict="mwis", pad_to=128,
                  training_set="ERGDPG2", learning_rate=TRAIN_LR, **kw)


def model_root_copy(root: str) -> str:
    """A temporary model root holding a copy of the checkpoint: the
    trainers' checkpoint gate writes there, never into `model/`."""
    dst = os.path.join(root, os.path.basename(MODEL_DIR))
    os.makedirs(dst)
    shutil.copy(CKPT, dst)
    return root


def er_instances(rng, k):
    """k ER graphs of 100..256 nodes (average degree 5..25) from the
    port's generator, with U(0,1) weights."""
    out = []
    for _ in range(k):
        n = int(rng.integers(N_MIN, N + 1))
        out.append((er_graph(n, float(rng.uniform(0.05, 0.1)), rng),
                    rng.random(n)))
    return out


def schedule_ok_host(mwis, adj) -> bool:
    """A host schedule (set of node ids) is independent and maximal."""
    on = np.zeros(adj.shape[0], dtype=bool)
    on[list(mwis)] = True
    hit = np.asarray(adj @ on.astype(np.float64)).ravel() > 0
    return not bool((on & hit).any()) and bool((on | hit).all())


def sync_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def phase_agent(dev, tmp) -> dict:
    """Phase 12: the agent on the card, and one replay held against the
    same replay on the CPU."""
    root = model_root_copy(os.path.join(tmp, "agent_models"))
    cfg = train_config(epsilon=0.0)
    folder = find_model_folder(cfg, "dqn", root)
    agent = DQNAgent(cfg, device=dev)
    cpu = DQNAgent(cfg, device="cpu")
    check(agent.load(folder) and cpu.load(folder), "checkpoint load")
    rng = np.random.default_rng(12)
    reset_launch_counts()
    for a, w in er_instances(rng, 8):
        mwis, util = agent.solve_mwis(a, w)
        check(schedule_ok_host(mwis, a), "a solve_mwis schedule is not "
              "independent and maximal")
        check(abs(util - w[list(mwis)].sum()) <= 1e-9 * max(util, 1.0),
              "solve_mwis utility")
    solves = batched_lgs_kernel.launches
    check(solves >= 8, f"8 solves launched the LGS kernel {solves} times")
    for a, w in er_instances(rng, 32):
        agent.solve_mwis(a, w, train=True, grd=greedy_search(a, w)[1])
    launches = batched_lgs_kernel.launches
    minibatch = list(agent.memory)
    check(len(minibatch) == 32, f"{len(minibatch)} memorized samples")
    batch = agent.trainer.prepare(minibatch)
    secs, losses = sync_s(lambda: agent.trainer.step(*batch))
    closses = cpu.trainer.step(*cpu.trainer.prepare(minibatch))
    lerr = float(((losses.cpu() - closses).abs() / closses.abs()).max())
    check(bool(torch.isfinite(losses).all()) and lerr <= 1e-4,
          f"per-sample losses card vs CPU: max rel diff {lerr}")
    perr = 0.0
    cstate = cpu.model.state_dict()
    for k, v in agent.model.state_dict().items():
        want = cstate[k]
        excess = ((v.cpu() - want).abs() - 1e-4 * want.abs()).max()
        perr = max(perr, float(excess))
    check(perr <= 2 * TRAIN_LR * 32, f"params card vs CPU after the replay: "
          f"{perr} beyond rtol 1e-4 (bound {2 * TRAIN_LR * 32})")
    # the TF1 update alone on identical gradients
    gen = torch.Generator().manual_seed(5)
    params = {k: v.detach().cpu() for k, v in
              agent.model.named_parameters()}
    opt = make_optimizer(TRAIN_LR)
    states = {"card": opt.init({k: v.to(dev) for k, v in params.items()}),
              "cpu": opt.init(params)}
    uerr = 0.0
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=gen)
                 for k, v in params.items()}
        ucard, states["card"] = opt.update(
            {k: g.to(dev) for k, g in grads.items()}, states["card"])
        ucpu, states["cpu"] = opt.update(grads, states["cpu"])
        for k in grads:
            got, want = ucard[k].cpu(), ucpu[k]
            uerr = max(uerr, float(((got - want).abs()
                                    / want.abs().clamp_min(1e-30)).max()))
    check(uerr <= 1e-6, f"TF1 update card vs CPU: max rel diff {uerr}")
    print(f"phase 12: DQNAgent gcn2_dqn ERGDPG2 l20 c32 from a copy of the "
          f"checkpoint: 8 solve_mwis schedules independent+maximal "
          f"({solves} LGS launches); one replay of 32 samples, card vs CPU: "
          f"losses max rel diff {lerr:.3g}, params max excess over rtol "
          f"1e-4 {perr:.3g} (bound {2 * TRAIN_LR * 32:.3g}); TF1 update "
          f"on identical gradients max rel diff {uerr:.3g}; card replay "
          f"{secs / 32 * 1e3:.3f} ms per sample", flush=True)
    return {"launches": launches, "losses_rel_diff": lerr,
            "replay_ms_per_sample": secs / 32 * 1e3}


def phase_gdpg_cli(dev, tmp) -> dict:
    """Phase 13: one epoch of `train_gdpg.main` with --device_batch=128 on
    generated ER data, then one `make_train_pipeline` batch checked and
    the pipeline's and the replay's rates."""
    t0 = time.perf_counter()
    for sub, per, seed in (("train", 64, 13), ("test", 8, 14)):
        generate_graph_dataset(os.path.join(tmp, sub), "ER",
                               sizes=(100, 150, 200, 256), ps=(0.05, 0.1),
                               n_per_config=per, seed=seed, label=False)
    os.environ["DISTGCN_PACK_CACHE"] = os.path.join(tmp, "packs")
    root = model_root_copy(os.path.join(tmp, "cli_models"))
    gen_s = time.perf_counter() - t0
    cfg = train_config()
    agent = DQNAgent(cfg, device=dev)
    losses = []
    replay = agent.replay

    def recorded_replay(batch_size):
        losses.append(replay(batch_size))
        return losses[-1]

    agent.replay = recorded_replay
    check(agent.load(find_model_folder(cfg, "dqn", root)), "checkpoint load")
    before = {k: v.clone() for k, v in agent.model.state_dict().items()}
    argv = [f"--datapath={tmp}/train", f"--test_datapath={tmp}/test",
            f"--model_root={root}", "--training_set=ERGDPG2",
            "--num_layer=20", "--hidden1=32", "--feature_size=1",
            "--diver_num=1", "--max_degree=1", "--predict=mwis",
            f"--learning_rate={TRAIN_LR}", "--epochs=1", "--pad_to=128",
            "--device_batch=128", "--replay_every=256",
            "--replay_batch=200", "--device=cuda"]
    reset_launch_counts()
    epoch_s, best = sync_s(lambda: train_gdpg.main(argv, agent=agent))
    launches = batched_lgs_kernel.launches
    batches = 512 // 128
    check(launches >= 2 * batches, f"{launches} LGS launches for "
          f"{batches} train batches")
    check(len(losses) == 2 and all(x is not None and np.isfinite(x)
                                   for x in losses), f"losses {losses}")
    moved = max(float((v - before[k]).abs().max())
                for k, v in agent.model.state_dict().items())
    check(moved > 0, "the params did not change")

    # one train-pipeline batch, checked; then its rate and the replay's
    adjs = [i.adj for i in load_dataset_cached(os.path.join(tmp, "train"))]
    rng = np.random.default_rng(15)
    pipe = make_train_pipeline(agent.model, agent.flags)
    batch_adjs = adjs[:B]
    batch_wts = [rng.random(a.shape[0]) for a in batch_adjs]
    gb = GraphBatch.from_scipy(batch_adjs, batch_wts, pad_to=N, device=dev)
    rand = torch.rand((B, N), generator=torch.Generator().manual_seed(16)
                      ).to(dev)
    explore = torch.arange(B, device=dev) % 2 == 0
    sel, util, gutil, acts = pipe(gb.adj, gb.wts, gb.mask, rand, explore)
    check(independent_and_maximal(sel, gb.adj, gb.mask),
          "a train-pipeline schedule is not independent and maximal")
    check(torch.equal(acts[explore, :, 0], (rand * gb.mask)[explore]),
          "acts head 0 is not rand on the explored graphs")
    check(bool(torch.isfinite(util).all() and torch.isfinite(gutil).all()),
          "train-pipeline utilities")
    secs = {}
    for k in (1, 5):
        secs[k] = sync_s(lambda: [pipe(gb.adj, gb.wts, gb.mask, rand,
                                       explore) for _ in range(k)])[0]
    graphs_s = 4 * B / (secs[5] - secs[1])
    sel_h, util_h, gutil_h = sel.cpu().numpy(), util.cpu(), gutil.cpu()
    acts_h = acts.cpu().numpy()
    minibatch = []
    for j in range(200):
        a = batch_adjs[j % B]
        n = a.shape[0]
        minibatch.append((
            {"adj": a, "wts": batch_wts[j % B].astype(np.float32)},
            acts_h[j % B, :n].copy(),
            np.nonzero(sel_h[j % B, :n] == 1)[0].tolist(), {},
            float(util_h[j % B] / (gutil_h[j % B] + 1e-6))))
    replay_s, _ = sync_s(lambda: agent.trainer.train_minibatch(minibatch))
    print(f"phase 13: train_gdpg.main --device_batch=128, 512 ER train + 64 "
          f"test graphs of 100..256 nodes (generated in {gen_s:.3f} s), one "
          f"epoch: {epoch_s:.3f} s wall, {len(losses)} replays of 200, "
          f"losses {', '.join(f'{x:.6f}' for x in losses)}, params moved "
          f"by up to {moved:.3g}, {launches} LGS launches, best test ratio "
          f"{best:.6f}; make_train_pipeline B={B} N={N}: schedules "
          f"independent+maximal, head 0 = rand on explored graphs, "
          f"{graphs_s:.1f} graphs/s (marginal of 1 and 5 batches: "
          f"{secs[1] * 1e3:.3f} / {secs[5] * 1e3:.3f} ms); replay of 200 "
          f"samples {replay_s:.3f} s, {replay_s / 200 * 1e3:.3f} ms per "
          f"sample", flush=True)
    return {"launches": launches, "graphs_per_s": graphs_s,
            "replay_ms_per_sample": replay_s / 200 * 1e3,
            "epoch_s": epoch_s}


def phase_online(dev, tree) -> dict:
    """Phase 14: the online training loop at B=128, N=256, load 0.9, the
    ERGDPG2 l20 c32 model in f32."""
    cfg = train_config()
    model = make_model_from_config(cfg, "gcn2_dqn",
                                   params=params_from_jax(tree), device=dev)
    rng = np.random.default_rng(17)
    adjs, wtss = graphs(rng, B, N_MIN, N)
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=N, device=dev)
    opt = make_optimizer(TRAIN_LR)
    state = opt.init(dict(model.named_parameters()))
    q0 = torch.zeros((B, N), device=dev)
    runs = {t: make_online_training_loop(model, cfg, opt, timeslots=t,
                                         load=0.9) for t in (3, 20, 60)}
    state = runs[3](state, gb.adj, gb.mask, q0,
                    torch.Generator(device=dev).manual_seed(0))[0]
    torch.cuda.reset_peak_memory_stats(dev)
    secs = {}
    for t in (20, 60):
        gen = torch.Generator(device=dev).manual_seed(7)
        reset_launch_counts()
        secs[t], (state, qT, metrics) = sync_s(
            lambda: runs[t](state, gb.adj, gb.mask, q0, gen))
        launches = batched_lgs_kernel.launches
        check(launches >= 2 * t, f"{launches} LGS launches in {t} slots")
        check(bool(torch.isfinite(metrics["loss"]).all()), "online losses")
        check(bool(torch.isfinite(qT).all()) and bool((qT >= 0).all()),
              "online queues")
        check(bool((qT[~gb.mask] == 0).all()), "padding queues not 0")
    peak = torch.cuda.max_memory_allocated(dev)
    slot_s = (secs[60] - secs[20]) / 40
    loss = metrics["loss"].cpu().numpy()
    print(f"phase 14: online training loop, ERGDPG2 l20 c32 f32, B={B} "
          f"N={N}, load 0.9: T=20 {secs[20]:.4f} s, T=60 {secs[60]:.4f} s, "
          f"per slot {slot_s * 1e3:.4f} ms (marginal), {launches} LGS "
          f"launches in 60 slots, loss first/last {loss[0]:.6f} / "
          f"{loss[-1]:.6f}, avg_utility_ratio "
          f"{float(metrics['avg_utility_ratio'].mean()):.6f}, "
          f"avg_queue_len {float(metrics['avg_queue_len'].mean()):.4f}; "
          f"peak device memory {peak / 2**20:.1f} MiB", flush=True)
    return {"launches": launches, "ms_per_slot": slot_s * 1e3,
            "peak_mib": peak / 2**20}


# ---------------------------------------------------------------------------
# the graph-set evaluation path: iterative solvers, the diver family, CLIs
# ---------------------------------------------------------------------------

DIVER_DIR = "model/result_ERUNI_deep_ld32_c32_l20_cheb1_diver32_mwis_diver"
Q_MULTI, D_MULTI = 32, 32       # pop states x diver heads


def diver_config(**kw) -> Config:
    """The ERUNI diver32 l20 c32 checkpoint's configuration
    (`find_model_folder(cfg, "diver", "model")` resolves to DIVER_DIR)."""
    return Config(**dict(dict(
        feature_size=32, hidden1=32, num_layer=20, diver_num=32,
        max_degree=1, predict="mwis", pad_to=128, training_set="ERUNI",
        backoff_prob=0.3, diver_out=32), **kw))


@contextlib.contextmanager
def timed(obj, name, record=None):
    """Accumulates the wall seconds and calls of obj.name (looked up at
    call time) while open, and each call's seconds; appends each result to
    `record` if given."""
    fn = getattr(obj, name)
    own = name in vars(obj)
    stats = {"s": 0.0, "calls": 0, "each": []}

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        stats["s"] += dt
        stats["calls"] += 1
        stats["each"].append(dt)
        if record is not None:
            record.append(out)
        return out

    setattr(obj, name, wrapped)
    try:
        yield stats
    finally:
        if own:
            setattr(obj, name, fn)
        else:
            delattr(obj, name)


def phase_iterative(dev) -> dict:
    """Phase 15: DIT, CGS and rollout (b=16) with the ERGDPG2 l20 c32
    checkpoint on the card, held against the same agent on the CPU."""
    cfg = train_config(epsilon=0.0)
    folder = find_model_folder(cfg, "dqn", "model")
    agent = DQNAgent(cfg, device=dev)
    cpu = DQNAgent(cfg, device="cpu")
    check(agent.load(folder) and cpu.load(folder), "checkpoint load")
    insts = er_instances(np.random.default_rng(150), 8)
    solvers = {"dit": "solve_mwis_dit", "cgs": "solve_mwis_cit",
               "rollout16": "solve_mwis_rollout_wrap"}
    out = {}
    for name, method in solvers.items():
        reset_launch_counts()
        t0 = time.perf_counter()
        with timed(iterative, "_masked_forward") as steps:
            card = [getattr(agent, method)(a, w) for a, w in insts]
        secs = time.perf_counter() - t0
        launches = batched_lgs_kernel.launches
        t0 = time.perf_counter()
        ref = [getattr(cpu, method)(a, w) for a, w in insts]
        cpu_s = time.perf_counter() - t0
        for (a, w), (sel, util), (_, rutil) in zip(insts, card, ref):
            check(schedule_ok_host(sel, a), f"a {name} schedule is not "
                  "independent and maximal")
            check(abs(util - w[list(sel)].sum()) <= 1e-5 * max(util, 1.0),
                  f"{name} utility is not the schedule's weight")
            check(abs(util - rutil) <= 0.01 * abs(rutil),
                  f"{name} utility {util} vs the CPU's {rutil}")
        want = 0 if name == "cgs" else steps["calls"]
        check(launches == want, f"{name}: {launches} LGS launches in "
              f"{steps['calls']} steps (want {want})")
        equal = sum(s == r for (s, _), (r, _) in zip(card, ref))
        mean_u = float(np.mean([u for _, u in card]))
        rel = mean_u / float(np.mean([u for _, u in ref])) - 1.0
        print(f"phase 15: {name} (ERGDPG2 l20 c32, 8 ER graphs of "
              f"{N_MIN}..{N} nodes): schedules independent+maximal, "
              f"{equal}/8 selections equal to the CPU's, mean utility "
              f"{mean_u:.6f} ({rel:+.3e} vs CPU), {steps['calls']} steps, "
              f"{launches} LGS launches; card {secs:.3f} s, CPU "
              f"{cpu_s:.3f} s", flush=True)
        out[name] = {"launches": launches, "steps": steps["calls"],
                     "equal": equal, "card_s": secs}
    return out


def multi_inputs(agent, dev, n_pad, n_lo, seed):
    """Q_MULTI partial states of seeded ER graphs padded to n_pad: the
    masked adjacencies, the diver heads' guided weights [Q, D, n_pad] from
    the agent's GCN, and the remaining-node masks."""
    rng = np.random.default_rng(seed)
    adjs = []
    masks = np.zeros((Q_MULTI, n_pad), np.float32)
    wts = np.zeros((Q_MULTI, n_pad), np.float32)
    for i in range(Q_MULTI):
        n = int(rng.integers(n_lo, n_pad + 1))
        adjs.append(er_graph(n, float(rng.uniform(0.05, 0.1)), rng))
        masks[i, :n] = rng.random(n) < 0.8
        wts[i, :n] = rng.random(n)
    dense = agent._resident_adjs(adjs, n_pad)
    mask = torch.from_numpy(masks).to(dev)
    w = torch.from_numpy(wts * masks).to(dev)
    bmask = mask > 0
    madj = (dense * (bmask[:, :, None] & bmask[:, None, :]).to(torch.int8)
            ).contiguous()
    with torch.no_grad():
        _, probs = agent._bsf_eval(dense, torch.arange(Q_MULTI, device=dev),
                                   w, mask)
    guided = (probs.transpose(1, 2) * w[:, None, :]).contiguous()
    return madj, guided, bmask


def multi_vs_plain(madj, guided, mask, what) -> float:
    before = batched_lgs_kernel.launches
    sel, util, rounds = batched_lgs_multi(madj, guided, mask)
    check(batched_lgs_kernel.launches == before + 1,
          f"batched_lgs_multi ({what}) is not one kernel launch")
    psel, putil, prounds = batched_lgs_multi_plain(madj, guided, mask)
    torch.cuda.synchronize()
    check(torch.equal(sel, psel), f"shared mode ({what}): selections differ "
          "from batched_lgs_multi_plain")
    check(int(rounds) == int(prounds), f"shared mode ({what}): rounds "
          f"{int(rounds)} vs {int(prounds)}")
    check(torch.allclose(util, putil, rtol=1e-6, atol=1e-6),
          f"shared mode ({what}): utility")
    return float((util - putil).abs().max())


def phase_diver(dev, tmp) -> dict:
    """Phase 16: the diver family at full width (ERUNI diver32 l20 c32),
    the kernel's shared mode against its plain version, the diver
    searches, and the two evaluation CLIs on a generated ER set."""
    cfg = diver_config()
    folder = find_model_folder(cfg, "diver", "model")
    check(os.path.samefile(folder, DIVER_DIR), f"{folder} is not {DIVER_DIR}")
    agent = DiverAgent(cfg, device=dev)
    cpu = DiverAgent(cfg, device="cpu")
    check(agent.load(folder) and cpu.load(folder), "diver checkpoint load")
    insts = er_instances(np.random.default_rng(160), 16)
    err = 0.0
    for a, w in insts[:8]:
        got = agent.head_scores(agent.makestate(a, w.reshape(-1, 1)))
        want = cpu.head_scores(cpu.makestate(a, w.reshape(-1, 1)))
        check(got.shape == (a.shape[0], 32), "head_scores shape")
        check(np.allclose(got, want, rtol=1e-4, atol=1e-6),
              "head scores differ from the CPU's beyond rtol 1e-4")
        err = max(err, float(np.abs(got - want).max()))
    # the shared mode on the card's guided weights: shared masks, a mask
    # per variant, and a ragged N
    madj, guided, bmask = multi_inputs(agent, dev, N, N_MIN, 161)
    errs = [multi_vs_plain(madj, guided, bmask, "Q=32 D=32 N=256")]
    vmask = bmask[:, None, :] & (torch.rand(
        guided.shape, generator=torch.Generator().manual_seed(162)
    ).to(dev) < 0.7)
    errs.append(multi_vs_plain(madj, guided, vmask, "per-variant masks"))
    m100 = multi_inputs(agent, dev, 100, 60, 163)
    errs.append(multi_vs_plain(*m100, "N=100"))
    print(f"phase 16: DiverAgent ERUNI diver32 l20 c32: head scores on 8 "
          f"graphs within rtol 1e-4 of the CPU's (max abs diff {err:.3g}); "
          f"batched_lgs_multi (shared mode, one launch) bit-equal to "
          f"batched_lgs_multi_plain at Q={Q_MULTI} D={D_MULTI} N={N}, with "
          f"per-variant masks, and at N=100 (utility max abs diff "
          f"{max(errs):.3g})", flush=True)

    out = {"head_err": err}
    utils = {}
    reset_launch_counts()
    for dt in ("float32", "bfloat16"):
        ag = agent if dt == "float32" else DiverAgent(
            diver_config(compute_dtype=dt), device=dev)
        if dt != "float32":
            check(ag.load(folder), "diver checkpoint load")
        before = batched_lgs_kernel.launches
        t0 = time.perf_counter()
        it = [ag.solve_mwis_iterative(a, w) for a, w in insts]
        it_s = time.perf_counter() - t0
        it_launches = batched_lgs_kernel.launches - before
        check(len(insts) <= it_launches <= 5 * len(insts),
              f"solve_mwis_iterative: {it_launches} LGS launches")
        before = batched_lgs_kernel.launches
        with timed(ag, "_eval_heads_resident") as evals:
            t0 = time.perf_counter()
            many = ag.solve_mwis_bsf_many(insts, max_pops=8, batch_pops=8,
                                          group=4)
            many_s = time.perf_counter() - t0
        many_launches = batched_lgs_kernel.launches - before
        check(many_launches == evals["calls"], f"bsf_many: {many_launches} "
              f"LGS launches for {evals['calls']} pop batches")
        maximal = 0
        for (a, w), (s1, u1), (s2, u2) in zip(insts, it, many):
            check(schedule_ok_host(s1, a), "a solve_mwis_iterative schedule "
                  "is not independent and maximal")
            check(independent(s2, a), "a bsf schedule is not independent")
            maximal += schedule_ok_host(s2, a)
            for s, u in ((s1, u1), (s2, u2)):
                check(abs(u - w[list(s)].sum()) <= 1e-9 * max(u, 1.0),
                      "diver utility is not the schedule's weight")
        utils[dt] = (float(np.mean([u for _, u in it])),
                     float(np.mean([u for _, u in many])))
        print(f"phase 16: {dt}: solve_mwis_iterative on 16 graphs mean "
              f"utility {utils[dt][0]:.6f} ({it_launches} LGS launches, "
              f"{it_s:.3f} s); solve_mwis_bsf_many (max_pops 8, batch_pops "
              f"8, group 4) mean utility {utils[dt][1]:.6f}, "
              f"{evals['calls']} pop batches = {many_launches} LGS launches, "
              f"{maximal}/16 "
              f"schedules maximal (backoff children exclude nodes), "
              f"{many_s:.3f} s", flush=True)
    launches = batched_lgs_kernel.launches
    for k, what in enumerate(("solve_mwis_iterative", "bsf_many")):
        rel = utils["bfloat16"][k] / utils["float32"][k] - 1.0
        check(abs(rel) <= 0.01, f"bf16 {what} mean utility {rel:+.3%} "
              "from f32")
        out[f"bf16_{what}_rel"] = rel
    out["launches"] = launches

    # the two evaluation CLIs on a generated 32-graph ER set
    t0 = time.perf_counter()
    data = os.path.join(tmp, "eval_set")
    generate_graph_dataset(data, "ER", sizes=(100, 150, 200, 256),
                           ps=(0.05, 0.1), n_per_config=4, seed=164,
                           label=False)
    gen_s = time.perf_counter() - t0
    common = [f"--datapath={data}", "--model_root=model", "--max_degree=1",
              "--predict=mwis", "--num_layer=20", "--hidden1=32",
              f"--output_dir={tmp}/eval_out", f"--device={dev}"]
    runs = {
        "main": common + ["--training_set=ERDQNB", "--feature_size=1",
                          "--diver_num=1", "--batch_size=32"],
        "rollout_main": common + ["--training_set=ERUNI",
                                  "--feature_size=32", "--diver_num=32",
                                  "--rollout=1", "--max_pops=8",
                                  "--batch_pops=8", "--group=4"]}
    csvs = {"main": "result_ERDQNB_deep_ld1_c32_l20_cheb1_diver1_mwis_dqn"
                    "_eval_set.csv",
            "rollout_main": "result_ERUNI_deep_ld32_c32_l20_cheb1_diver32"
                            "_mwis_diver_rs8_eval_set.csv"}
    for name, argv in runs.items():
        secs, mean = sync_s(lambda: eval_graphs.main(argv))
        rows = eval_graphs.read_csv(os.path.join(tmp, "eval_out",
                                                 csvs[name]))
        check(len(rows) == 32 and all(p > 0 for _, p in rows),
              f"eval_graphs.{name}: CSV rows {rows}")
        out[f"{name}_graphs_per_s"] = 32 / secs
        print(f"phase 16: eval_graphs.{name} on 32 generated ER graphs of "
              f"100..256 nodes (generated in {gen_s:.3f} s): mean ratio vs "
              f"greedy {mean:.6f}, every row p > 0, {secs:.3f} s, "
              f"{32 / secs:.2f} graphs/s", flush=True)
    out["agent"] = agent
    return out


def independent(sel, adj) -> bool:
    idx = sorted(sel)
    return sp.csr_matrix(adj)[idx][:, idx].nnz == 0


def phase_multi_timing(dev, agent) -> dict:
    """B1's shared mode timed as phase 5 times B1 (CUDA-graph replays, L2
    flushed) at Q=32, D=32, N=256 beside the plain version, the kernel on a
    repeat_interleave'd [Q*D, N, N] adjacency (the copy counted) and the
    byte bound."""
    madj, guided, bmask = multi_inputs(agent, dev, N, N_MIN, 170)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = bmask[:, None, :].expand(Q_MULTI, D_MULTI, N).reshape(
        Q_MULTI * D_MULTI, N).contiguous()
    flat = guided.reshape(Q_MULTI * D_MULTI, N)
    # share=D against share=1 (the launch every other path makes) on the
    # repeated adjacency: the same outputs, bit for bit
    shared = batched_lgs_kernel(madj, flat, rows, share=D_MULTI)
    one = batched_lgs_kernel(madj.repeat_interleave(D_MULTI, dim=0), flat,
                             rows, share=1)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(shared, one)),
          "share=32 differs from share=1 on the repeated adjacency")
    ms = graph_ms(lambda: batched_lgs_multi(madj, guided, bmask), 200, flush)
    repeat_ms = graph_ms(lambda: batched_lgs_kernel(
        madj.repeat_interleave(D_MULTI, dim=0), flat, rows), 200, flush)
    plain_ms = event_ms(lambda: batched_lgs_multi_plain(madj, guided, bmask),
                        10, flush)
    nbytes = (Q_MULTI * N * N + Q_MULTI * D_MULTI * N * (4 + 1 + 1)
              + Q_MULTI * D_MULTI * (4 + 4))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 16: lgs shared mode Q={Q_MULTI} D={D_MULTI} N={N}: sel, "
          f"util and rounds bit-equal to share=1 on the repeated adjacency; "
          f"L2 flushed: batched_lgs_multi (one launch, share={D_MULTI}) "
          f"{ms:.4f} ms; batched_lgs_kernel on a repeat_interleave'd "
          f"[{Q_MULTI * D_MULTI},{N},{N}] adjacency, the copy counted, "
          f"{repeat_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
          f"{bound_ms * 1e3:.3f} us ({nbytes} bytes), at "
          f"{bound_ms / ms:.2%} of the bound", flush=True)
    return {"multi_ms": ms, "multi_repeat_ms": repeat_ms,
            "multi_plain_ms": plain_ms, "multi_bound_ms": bound_ms}


def phase_trainers(dev, tmp) -> dict:
    """Phase 17: one epoch of `train_dqn.main` and of `train_diver.main`
    over small generated ER sets (heuristic labels), each in a temporary
    model root holding a copy of its checkpoint."""
    t0 = time.perf_counter()
    for sub, per, seed in (("tr_train", 4, 171), ("tr_test", 1, 172)):
        generate_graph_dataset(os.path.join(tmp, sub), "ER",
                               sizes=(100, 150, 200, 256), ps=(0.05, 0.1),
                               n_per_config=per, seed=seed, label=True)
    gen_s = time.perf_counter() - t0
    data = [f"--datapath={tmp}/tr_train", f"--test_datapath={tmp}/tr_test",
            "--max_degree=1", "--predict=mwis", "--num_layer=20",
            "--hidden1=32", "--epochs=1", f"--learning_rate={TRAIN_LR}",
            f"--device={dev}"]
    out = {}
    # train_dqn: the ERDQNB l20 c32 checkpoint (gcn_dqn), replays of 16
    src = "model/result_ERDQNB_deep_ld1_c32_l20_cheb1_diver1_mwis_dqn"
    root = os.path.join(tmp, "dqn_models")
    shutil.copytree(src, os.path.join(root, os.path.basename(src)))
    argv = data + ["--training_set=ERDQNB", "--feature_size=1",
                   "--diver_num=1", "--epsilon=0.2", "--replay_every=16",
                   "--replay_batch=16", f"--model_root={root}"]
    agent = LegacyDQNAgent(Config.from_args(argv), device=dev)
    check(agent.load(os.path.join(root, os.path.basename(src))),
          "ERDQNB checkpoint load")
    before = {k: v.clone() for k, v in agent.model.state_dict().items()}
    losses = []
    replay = agent.replay

    def recorded_replay(batch_size):
        losses.append(replay(batch_size))
        return losses[-1]

    agent.replay = recorded_replay
    reset_launch_counts()
    secs, _ = sync_s(lambda: train_dqn.main(argv, agent=agent))
    launches = batched_lgs_kernel.launches
    check(len(losses) == 2 and all(x is not None and np.isfinite(x)
                                   for x in losses), f"losses {losses}")
    moved = max(float((v - before[k]).abs().max())
                for k, v in agent.model.state_dict().items())
    check(moved > 0, "train_dqn: the params did not change")
    check(launches >= 32, f"train_dqn: {launches} LGS launches")
    print(f"phase 17: train_dqn.main, ERDQNB l20 c32, one epoch of 32 ER "
          f"graphs (generated with heuristic labels in {gen_s:.3f} s): "
          f"{secs:.3f} s, replay losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}, params moved by up "
          f"to {moved:.3g}, {launches} LGS launches",
          flush=True)
    out["dqn_s"], out["dqn_launches"] = secs, launches
    # train_diver: the ERUNI diver32 checkpoint, batches of 16
    root = os.path.join(tmp, "diver_models")
    shutil.copytree(DIVER_DIR, os.path.join(root,
                                            os.path.basename(DIVER_DIR)))
    argv = data + ["--training_set=ERUNI", "--feature_size=32",
                   "--diver_num=32", "--device_batch=16",
                   f"--model_root={root}"]
    log = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(log):
        secs, best = sync_s(lambda: train_diver.main(argv))
    launches = batched_lgs_kernel.launches
    text = log.getvalue()
    loss = float(text.split("Loss: ")[1].split()[0])
    check(np.isfinite(loss) and np.isfinite(best), f"train_diver: {text}")
    # the epoch's checkpoint (the gate starts at 0) against the original
    before = load_params(os.path.join(DIVER_DIR, "params.npz"))
    after = load_params(os.path.join(root, os.path.basename(DIVER_DIR),
                                     "params.npz"))
    moved = max(float(np.abs(after[layer][k] - v).max())
                for layer, leaves in before.items()
                for k, v in leaves.items())
    check(moved > 0, "train_diver: the params did not change")
    check(launches >= 8, f"train_diver: {launches} LGS launches")
    print(f"phase 17: train_diver.main, ERUNI diver32 l20 c32, one epoch of "
          f"32 labeled ER graphs in batches of 16: {secs:.3f} s, loss "
          f"{loss:.6f}, best test ratio {best:.6f}, params moved by up to "
          f"{moved:.3g}, {launches} LGS launches", flush=True)
    out["diver_s"], out["diver_launches"] = secs, launches
    return out


# ---------------------------------------------------------------------------
# the wireless path (phases 18-20)
# ---------------------------------------------------------------------------

NETS = "data/wireless_test"
# the four networks with the fewest links (36, 46, 28 and 35), and the one
# with the most (81): at load 0.9 the exact B&B starts its time-budgeted
# local search (5% of the 10 s timeout) on about a sixth of the largest
# one's solves and on none of the small ones'
HOST_NETS = ("0006", "0009", "0015", "0018")
LARGEST_NET = "0013"
WIRELESS_T = wireless_sim.DEVICE_LOOP_SLOTS
PINNED_T = 40                  # slots of the card-vs-CPU pinned episodes
LOCAL_SEARCH_S = 0.1           # a solve this long ran the local search


def mwis_brute_force(adj, w) -> float:
    """The largest weight of an independent set, over all 2^n subsets."""
    n = w.size
    subsets = ((np.arange(1 << n)[:, None] >> np.arange(n)) & 1) \
        .astype(np.float64)
    clash = ((subsets @ adj.toarray()) * subsets).sum(axis=1) > 0
    return float((subsets @ w)[~clash].max())


def qr_weights(rng, n):
    """Queue x rate utilities as a loaded slot sees them: queues uniform
    in [0, 3000), rates the simulator's truncated Gaussian in [0, 100]."""
    q = np.floor(rng.random(n) * 3000)
    r = np.clip(np.trunc(rng.normal(50.0, 25.0, n)), 0, 100)
    return q * r


def phase_exact(dev) -> dict:
    """Phase 18: the port's own native exact solver, built here."""
    t0 = time.perf_counter()
    path = exact.native_library()
    build_s = time.perf_counter() - t0
    real = os.path.realpath(path)
    check(os.sep + os.path.join("distgcn_tpu", "") not in real,
          f"the exact solver loaded {real}")
    print(f"phase 18: native exact solver built and loaded in {build_s:.3f} "
          f"s: {real}", flush=True)
    rng = np.random.default_rng(180)
    for _ in range(20):
        n = int(rng.integers(8, 17))
        a, w = er_graph(n, 0.3, rng), rng.random(n)
        _, val, status = exact.mwis_exact(a, w, 10.0)
        want = mwis_brute_force(a, w)
        check(status == "Optimal" and abs(val - want) <= 1e-9 * want,
              f"mwis_exact {val} ({status}) vs brute force {want}")
    for _ in range(8):
        n = int(rng.integers(30, 41))
        a = er_graph(n, 0.15, rng)
        w = rng.random(n)
        _, val, status = exact.mwis_exact(a, w, 10.0)
        _, pval, pstatus = exact._python_bnb(exact._csr(a), w, 60.0)
        check(status == pstatus == "Optimal"
              and abs(val - pval) <= 1e-9 * pval,
              f"mwis_exact {val} ({status}) vs _python_bnb {pval}")
    ms, statuses = [], []
    for f in sorted(os.listdir(NETS)):
        m = sio.loadmat(os.path.join(NETS, f))
        adj = poisson_graphs_from_dict(m["gdict"][0, 0])[2]
        w = qr_weights(rng, adj.shape[0])
        t0 = time.perf_counter()
        _, _, status = exact.mwis_exact(adj, w, 10.0)
        ms.append((time.perf_counter() - t0) * 1e3)
        statuses.append(status)
    print(f"phase 18: mwis_exact equal to brute force on 20 graphs of 8..16 "
          f"nodes and to _python_bnb on 8 ER graphs of 30..40 nodes (rtol "
          f"1e-9, all Optimal); on the 20 repo networks' conflict graphs "
          f"(28..81 links) with queue x rate weights, timeout 10 s: median "
          f"{np.median(ms):.3f} ms, largest {max(ms):.3f} ms, "
          f"{statuses.count('Optimal')}/20 Optimal", flush=True)
    return {"build_s": build_s, "median_ms": float(np.median(ms)),
            "max_ms": float(max(ms))}


def wireless_argv(datapath, n_ch, lo, hi, step, out, *extra) -> list:
    """`wireless_sim` flags for the ERGDPG2 l20 c32 checkpoint."""
    return [f"--test_datapath={datapath}", "--wt_sel=qr",
            f"--load_min={lo}", f"--load_max={hi}", f"--load_step={step}",
            f"--num_channels={n_ch}", "--training_set=ERGDPG2",
            "--num_layer=20", "--hidden1=32", "--feature_size=1",
            "--diver_num=1", "--max_degree=1", "--predict=mwis",
            "--model_root=model", f"--output={out}", *extra]


def wireless_agent(dev) -> DQNAgent:
    """The ERGDPG2 l20 c32 checkpoint as `wireless_sim` loads it."""
    cfg = train_config(epsilon=0.0)
    agent = DQNAgent(cfg, model_family="gcn_dqn", device=dev)
    check(agent.load(find_model_folder(cfg, "dqn", "model")),
          "ERGDPG2 checkpoint load")
    return agent


def cli_lines(fn, phase):
    """Runs fn with its standard output captured; prints the CLI's lines
    under the phase's name. Returns (seconds, result)."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        secs, out = sync_s(fn)
    for line in log.getvalue().splitlines():
        if line.startswith(("load ", "net ")):
            print(f"phase {phase}: {line}")
    return secs, out


def queues_ok(q, mask, what):
    check(bool(torch.isfinite(q).all()) and bool((q >= 0).all()),
          f"{what}: queues")
    check(bool((q[~mask] == 0).all()), f"{what}: padding queues not 0")


@contextlib.contextmanager
def lgs_calls(modules, every=1):
    """Records the inputs and outputs of every `every`-th `batched_lgs`
    call that `modules` make while open. The real call runs, so the launch
    counts stay those of the path."""
    real = [(mod, mod.batched_lgs) for mod in modules]
    calls, seen = [], [0]

    def recorded(adj, wts, mask, max_rounds=None):
        out = batched_lgs(adj, wts, mask, max_rounds)
        if seen[0] % every == 0:
            calls.append(SimpleNamespace(
                adj=adj.clone(), wts=wts.clone(), mask=mask.clone(),
                max_rounds=max_rounds, sel=out[0].clone(),
                util=out[1].clone(), rounds=out[2].clone()))
        seen[0] += 1
        return out

    for mod in modules:
        mod.batched_lgs = recorded
    try:
        yield calls
    finally:
        for mod, fn in real:
            mod.batched_lgs = fn


def lgs_vs_plain(calls, what) -> int:
    """Holds each recorded B1 call against `batched_lgs_plain` on the same
    card tensors, with phase 2's tolerances: selections bit-equal, the
    round count equal, the utility within rtol 1e-6. Calls of one shape go
    through one plain call. Returns the number of graphs checked."""
    check(len(calls) > 0, f"{what}: no B1 call recorded")
    groups = {}
    for c in calls:
        key = (tuple(c.adj.shape[1:]), c.adj.dtype, c.wts.dtype,
               c.max_rounds)
        groups.setdefault(key, []).append(c)
    graphs = 0
    for (_, _, _, cap), group in groups.items():
        cat = {k: torch.cat([getattr(c, k) for c in group])
               for k in ("adj", "wts", "mask", "sel", "util")}
        psel, putil, prounds = batched_lgs_plain(cat["adj"], cat["wts"],
                                                 cat["mask"], cap)
        check(torch.equal(cat["sel"], psel),
              f"{what}: B1's selections differ from the plain version's")
        rounds = max(int(c.rounds) for c in group)
        check(rounds == int(prounds),
              f"{what}: B1 ran {rounds} rounds, the plain version "
              f"{int(prounds)}")
        check(bool(torch.allclose(cat["util"], putil, rtol=1e-6,
                                  atol=1e-6)),
              f"{what}: B1's utility differs from the plain version's")
        graphs += cat["sel"].shape[0]
    return graphs


@contextlib.contextmanager
def pinned_arrivals(arrivals: torch.Tensor):
    """The device loops made while open draw `arrivals` ([B, Nf]) in every
    slot: `_traffic` looks the sampler's factory up when a loop is made."""
    real = device_sim.make_poisson_arrivals
    device_sim.make_poisson_arrivals = lambda lam: (
        lambda generator, shape, dtype=torch.float32:
        arrivals.to(generator.device, dtype))
    try:
        yield
    finally:
        device_sim.make_poisson_arrivals = real


def pinned_card_vs_cpu(agent, cpu, make, adj, mask, every, dev):
    """One loop (`make(model)`) with pinned draws, constant rates and one
    fixed integer arrival array, on the card and on the CPU. Returns
    whether the end queues and every metric agree within rtol 1e-5, the
    graphs whose end queues differ, the largest deviation of each metric
    relative to its largest CPU value, and the number of graphs whose B1
    calls (every `every`-th) were held against the plain version."""
    arrivals = torch.from_numpy(np.floor(np.random.default_rng(19).random(
        mask.shape) * 60).astype(np.float32))
    with pinned_arrivals(arrivals):
        on_card, on_cpu = make(agent.model), make(cpu.model)
    with lgs_calls([device_sim], every) as calls:
        q, m = on_card(adj, mask, torch.zeros(mask.shape, device=dev),
                       torch.Generator(device=dev).manual_seed(0))
    cq, cm = on_cpu(adj.cpu(), mask.cpu(), torch.zeros(mask.shape),
                    torch.Generator().manual_seed(0))
    q = q.cpu()
    agree = bool(torch.allclose(q, cq, rtol=1e-5, atol=0.0))
    dev_rel = {}
    for k, want in cm.items():
        got = m[k].cpu()
        agree &= bool(torch.allclose(got, want, rtol=1e-5, atol=0.0))
        dev_rel[k] = float((got - want).abs().max() / want.abs().max())
    differ = int((q != cq).any(dim=-1).sum())
    return agree, differ, dev_rel, lgs_vs_plain(calls, "pinned loop")


def twin_ties(agent, adj, mask) -> tuple:
    """(adjacent link pairs, pairs whose hoisted gdpg GCN scores agree
    within 1e-5 relative, pairs whose scores are bit-equal) on the card."""
    supports, scores = device_sim._episode_scorer(
        agent.model, agent.flags, "gdpg", adj, mask)
    act = scores(supports, torch.ones(mask.shape, device=mask.device), mask)
    act = act.double()
    edge = torch.triu((adj > 0) & mask[:, :, None] & mask[:, None, :], 1)
    diff = (act[:, :, None] - act[:, None, :]).abs()
    return (int(edge.sum()),
            int((edge & (diff <= 1e-5 * act.abs().amax())).sum()),
            int((edge & (diff == 0)).sum()))


def phase_wireless_loops(dev, tmp) -> dict:
    """Phase 19: the device loops over all 20 repo networks in one batch
    (B=20, links padded to 128) with the ERGDPG2 l20 c32 checkpoint."""
    base = torch.cuda.memory_allocated(dev)    # what earlier phases hold
    torch.cuda.reset_peak_memory_stats(dev)
    agent = wireless_agent(dev)
    out, launches = {}, {}
    b = len(os.listdir(NETS))
    # n_ch = 1 over the load sweep, through the CLI (2 launches a slot)
    argv = wireless_argv(NETS, 1, 0.1, 1.0, 0.1, os.path.join(tmp, "dl1"),
                         "--device_loop=1", f"--device={dev}")
    reset_launch_counts()
    secs, res = cli_lines(lambda: wireless_sim.main(argv, agent=agent), 19)
    launches["device_loop_1ch"] = batched_lgs_kernel.launches
    check(launches["device_loop_1ch"] == 2 * WIRELESS_T * 10,
          f"n_ch=1: {launches['device_loop_1ch']} B1 launches")
    check(len(res.rows) == b * 10, f"n_ch=1: {len(res.rows)} rows")
    out["sweep_1ch_decisions_s"] = b * WIRELESS_T * 10 / secs
    print(f"phase 19: main_device_loop n_ch=1, B={b}, Nf 128, T="
          f"{WIRELESS_T}, loads 0.1..1.0: {secs:.3f} s, "
          f"{out['sweep_1ch_decisions_s']:.1f} decisions/s (set-up "
          f"included), {launches['device_loop_1ch']} B1 launches",
          flush=True)
    # n_ch = 3 on the product graph, through the CLI (1 launch a slot)
    argv = wireless_argv(NETS, 3, 0.3, 0.9, 0.3, os.path.join(tmp, "dl3"),
                         "--device_loop=1", f"--device={dev}")
    reset_launch_counts()
    secs, res = cli_lines(lambda: wireless_sim.main(argv, agent=agent), 19)
    launches["device_loop_mc"] = batched_lgs_kernel.launches
    check(launches["device_loop_mc"] == WIRELESS_T * 3,
          f"mc: {launches['device_loop_mc']} B1 launches")
    check(len(res.rows) == b * 3, f"mc: {len(res.rows)} rows")
    out["sweep_mc_decisions_s"] = b * WIRELESS_T * 3 / secs
    print(f"phase 19: main_device_loop n_ch=3 (product graph, 384 nodes), "
          f"loads 0.3, 0.6, 0.9: {secs:.3f} s, "
          f"{out['sweep_mc_decisions_s']:.1f} decisions/s, "
          f"{launches['device_loop_mc']} B1 launches", flush=True)
    # single episodes at load 0.9: queues, bf16 against f32; B1's calls of
    # the f32 warm-up (both kinds: the GCN's and the baseline's) recorded
    cfg1 = agent.flags.replace(test_datapath=NETS, num_channels=1)
    _, adj, mask, _ = wireless_sim.pack_networks(cfg1)
    adj, mask = torch.from_numpy(adj).to(dev), torch.from_numpy(mask).to(dev)
    q0 = torch.zeros(mask.shape, device=dev)
    util, checked = {}, {}
    for dt in ("float32", "bfloat16"):
        run = make_closed_loop(agent.model, agent.flags.replace(
            compute_dtype=dt), timeslots=WIRELESS_T, load=0.9,
            with_baseline=True)
        with (lgs_calls([device_sim], 25) if dt == "float32"
              else contextlib.nullcontext()) as calls:
            run(adj, mask, q0, torch.Generator(device=dev).manual_seed(1))
        if calls is not None:
            checked["n_ch=1"] = lgs_vs_plain(calls, "n_ch=1 loop")
        secs, (q, m) = sync_s(lambda: run(
            adj, mask, q0, torch.Generator(device=dev).manual_seed(900)))
        queues_ok(q, mask, f"n_ch=1 {dt}")
        util[dt] = float(m["avg_utility"].mean())
        out[f"1ch_{dt}_decisions_s"] = b * WIRELESS_T / secs
        print(f"phase 19: n_ch=1 episode {dt}, load 0.9, T={WIRELESS_T}: "
              f"{secs:.4f} s, {b * WIRELESS_T / secs:.1f} decisions/s, "
              f"{secs / WIRELESS_T * 1e3:.4f} ms a slot, avg_utility "
              f"{util[dt]:.4f}, utility ratio to greedy "
              f"{float(m['avg_utility_ratio'].mean()):.6f}", flush=True)
    rel = abs(util["bfloat16"] - util["float32"]) / abs(util["float32"])
    check(rel <= 0.01, f"n_ch=1 bf16 avg_utility off by {rel:.4%}")
    # the product graph: one episode, whose warm-up's B1 calls are recorded
    # and their schedules checked
    cfg3 = agent.flags.replace(test_datapath=NETS, num_channels=3)
    _, gk, mask3, adj_ch = wireless_sim.pack_networks(cfg3)
    gk, mask3 = torch.from_numpy(gk).to(dev), torch.from_numpy(mask3).to(dev)
    run = make_closed_loop_mc(agent.model, agent.flags, WIRELESS_T, 3,
                              load=0.9)
    with lgs_calls([device_sim], 25) as calls:
        run(gk, mask3, q0, torch.Generator(device=dev).manual_seed(1))
    checked["mc"] = lgs_vs_plain(calls, "mc loop")
    on = torch.cat([c.sel for c in calls]) == 1
    mask_k = torch.cat([c.mask for c in calls])
    adj_k = torch.cat([c.adj for c in calls])
    check(not bool((on & ~mask_k).any()), "mc: a padded node scheduled")
    check(int(on.reshape(on.shape[0], 3, -1).sum(dim=1).max()) <= 1,
          "mc: two channels of one link on")
    check(not bool((adj_k & on[:, :, None] & on[:, None, :]).any()),
          "mc: a schedule is not independent")
    secs, (q, m) = sync_s(lambda: run(
        gk, mask3, q0, torch.Generator(device=dev).manual_seed(900)))
    queues_ok(q, mask3, "mc")
    out["mc_decisions_s"] = b * WIRELESS_T / secs
    print(f"phase 19: n_ch=3 episode f32, load 0.9: {secs:.4f} s, "
          f"{out['mc_decisions_s']:.1f} decisions/s, "
          f"{secs / WIRELESS_T * 1e3:.4f} ms a slot, avg_utility "
          f"{float(m['avg_utility'].mean()):.4f}; {len(calls)} slots of the "
          f"warm-up: at most one channel per link, independent, no padded "
          f"node", flush=True)
    # the sequential loop on the per-channel graphs (the product graph's
    # diagonal blocks), n_ch launches a slot
    adj_ch = torch.from_numpy(adj_ch).to(dev)
    run = make_closed_loop_seq(agent.model, agent.flags, WIRELESS_T, 3,
                               load=0.6)
    reset_launch_counts()
    secs, (q, m) = sync_s(lambda: run(
        adj_ch, mask3, q0, torch.Generator(device=dev).manual_seed(600)))
    launches["seq"] = batched_lgs_kernel.launches
    check(launches["seq"] == 3 * WIRELESS_T,
          f"seq: {launches['seq']} B1 launches")
    queues_ok(q, mask3, "seq")
    out["seq_decisions_s"] = b * WIRELESS_T / secs
    print(f"phase 19: make_closed_loop_seq n_ch=3, load 0.6: {secs:.4f} s "
          f"(first call), {out['seq_decisions_s']:.1f} decisions/s, "
          f"{secs / WIRELESS_T * 1e3:.4f} ms a slot, avg_utility "
          f"{float(m['avg_utility'].mean()):.4f}, {launches['seq']} B1 "
          f"launches; bf16 vs f32 avg_utility (n_ch=1, load 0.9) rel diff "
          f"{rel:.4%}; peak device memory of the phase "
          f"{(torch.cuda.max_memory_allocated(dev) - base) / 2**20:.1f} MiB "
          f"above the {base / 2**20:.1f} MiB that earlier phases hold",
          flush=True)
    # the three loops again at these shapes with pinned draws (constant
    # rates, one fixed integer arrival array), card vs CPU: on the links'
    # own utilities within rtol 1e-5; with the GCN the deviation is printed,
    # since twin links (structurally equal) get GCN scores that agree in
    # exact arithmetic, and with equal utilities the last bit of each
    # device's rounding picks between them
    cpu = wireless_agent("cpu")
    pinned = dict(rate_lo=50.0, rate_hi=50.0)
    loops = (
        ("n_ch=1", lambda model, g: make_closed_loop(
            model, agent.flags, PINNED_T, with_baseline=True, use_gcn=g,
            **pinned), adj, mask, 25),
        ("mc", lambda model, g: make_closed_loop_mc(
            model, agent.flags, PINNED_T, 3, use_gcn=g, **pinned), gk, mask3,
         5),
        ("seq", lambda model, g: make_closed_loop_seq(
            model, agent.flags, PINNED_T, 3, use_gcn=g, **pinned), adj_ch,
         mask3, 7))
    t0 = time.perf_counter()
    checked["pinned"], gcn_dev = 0, []
    for what, make, a, msk, every in loops:
        for use_gcn in (False, True):
            agree, differ, rel_dev, graphs = pinned_card_vs_cpu(
                agent, cpu, lambda model: make(model, use_gcn), a, msk,
                every, dev)
            checked["pinned"] += graphs
            if use_gcn:
                gcn_dev.append(f"{what}: {differ} of {b} graphs' end queues "
                               f"differ, metrics by up to "
                               f"{max(rel_dev.values()):.3g}")
            else:
                check(agree, f"{what} pinned, no GCN: card vs CPU {differ} "
                      f"graphs' end queues differ, metrics {rel_dev}")
    pairs, near, equal = twin_ties(agent, adj, mask)
    print(f"phase 19: pinned draws (rates 50, one fixed integer arrival "
          f"array), T={PINNED_T}, on the links' own utilities: the n_ch=1, "
          f"mc and seq loops on the card equal to the CPU's within rtol "
          f"1e-5 (end queues, avg_queue_len, avg_utility, sched_rate); with "
          f"the GCN, card vs CPU ({'; '.join(gcn_dev)}; relative to each "
          f"metric's largest value; {near} of the {pairs} conflicting link pairs of the 20 "
          f"networks have GCN scores equal within 1e-5 relative, {equal} "
          f"bit-equal on the card); in {time.perf_counter() - t0:.3f} s. "
          f"B1 held against the plain version on the same card tensors "
          f"(sel bit-equal, rounds equal, util rtol 1e-6) at the loops' "
          f"shapes: {checked} graphs", flush=True)
    out["launches"] = launches
    return out


def ratios_ok(rows, what):
    for row in rows:
        if row["name"] != "Benchmark":
            check(row["avg_utility"] <= 1 + 1e-9,
                  f"{what}: {row['name']} utility ratio {row['avg_utility']}")


def phase_host_engine(dev, tmp) -> dict:
    """Phase 20: the host engine (`wireless_sim.main`, --opt=0: Greedy,
    DGCN-LGS on the card, Benchmark with the exact solver) on four repo
    networks at loads 0.3 and 0.9, T=200; one pair again with the agent on
    the CPU; the largest network at load 0.9; one DGCN-LGS-Seq instance at
    n_ch=3. Every resident solve's B1 call is held against the plain
    version."""
    nets = os.path.join(tmp, "host_nets")
    os.makedirs(nets)
    for name in HOST_NETS:
        shutil.copy(os.path.join(NETS, f"poisson_net_{name}.mat"), nets)
    card, cpu = wireless_agent(dev), wireless_agent("cpu")
    argv = wireless_argv(nets, 1, 0.3, 0.9, 0.6, os.path.join(tmp, "host"),
                         "--opt=0", f"--device={dev}")
    sched = []
    reset_launch_counts()
    with timed(sim_wireless.exact_mod, "mwis_exact") as ex, \
            timed(card, "solve_mwis_resident", sched) as ag, \
            lgs_calls([pipeline_mod]) as calls:
        secs, res = cli_lines(lambda: wireless_sim.main(argv, agent=card),
                              20)
    launches = {"host_engine": batched_lgs_kernel.launches}
    pairs = len(HOST_NETS) * 2
    check(len(res.rows) == 3 * pairs, f"host: {len(res.rows)} rows")
    check(launches["host_engine"] == pairs * (WIRELESS_T - 1),
          f"host: {launches['host_engine']} B1 launches")
    ratios_ok(res.rows, "host")
    checked = lgs_vs_plain(calls, "host engine resident solves")
    # again, resumed: no new rows, no launches
    reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        again = wireless_sim.main(argv, agent=card)
    check(len(again.rows) == len(res.rows)
          and batched_lgs_kernel.launches == 0, "host: the resume re-ran")
    # the last pair (poisson_net_0018 at load 0.9) with the agent on the CPU
    one = os.path.join(tmp, "host_one")
    os.makedirs(one)
    shutil.copy(os.path.join(nets, f"poisson_net_{HOST_NETS[-1]}.mat"), one)
    cpu_sched = []
    with timed(cpu, "solve_mwis_resident", cpu_sched), \
            contextlib.redirect_stdout(io.StringIO()):
        ref = wireless_sim.main(wireless_argv(
            one, 1, 0.9, 0.9, 1.0, os.path.join(tmp, "host_cpu"), "--opt=0",
            "--device=cpu"), agent=cpu)
    mine = {r["name"]: r for r in res.rows
            if r["graph"] == ref.rows[0]["graph"] and r["load"] == 0.9}
    for row in ref.rows:
        for k in ("avg_queue_len", "med_queue_len", "95p_queue_len",
                  "5p_queue_len", "avg_utility"):
            got, want = mine[row["name"]][k], row[k]
            if row["name"] == "DGCN-LGS":
                check(abs(got - want) <= 1e-5 * abs(want),
                      f"DGCN-LGS {k} card {got} vs CPU {want}")
            else:
                check(got == want, f"{row['name']} {k} card {got} vs CPU "
                      f"{want}")
    differ = sum(a[0] != b[0] for a, b in
                 zip(sched[-(WIRELESS_T - 1):], cpu_sched))
    out = {"s_per_pair": secs / pairs, "exact_s_per_pair": ex["s"] / pairs,
           "agent_s_per_pair": ag["s"] / pairs}
    slow = sum(t > LOCAL_SEARCH_S for t in ex["each"])
    print(f"phase 20: wireless_sim.main --opt=0 on {len(HOST_NETS)} networks "
          f"(28..46 links) x loads 0.3, 0.9, T={WIRELESS_T}: {secs:.3f} s, "
          f"{out['s_per_pair']:.4f} s per (network, load): exact solver "
          f"{out['exact_s_per_pair']:.4f} s ({ex['calls']} solves, {slow} "
          f"over {LOCAL_SEARCH_S} s, the longest "
          f"{max(ex['each']) * 1e3:.3f} ms), agent "
          f"{out['agent_s_per_pair']:.4f} s ({ag['calls']} resident solves, "
          f"{launches['host_engine']} B1 launches, each held against the "
          f"plain version: {checked} graphs); utility ratios <= 1; resumed "
          f"call added no row; card vs CPU agent on poisson_net_"
          f"{HOST_NETS[-1]} at 0.9: Greedy and Benchmark identical, DGCN-LGS "
          f"within rtol 1e-5, {differ} of {WIRELESS_T - 1} slots scheduled "
          f"differently", flush=True)
    # the largest network at load 0.9, where the exact solver's local
    # search starts
    big = os.path.join(tmp, "host_largest")
    os.makedirs(big)
    shutil.copy(os.path.join(NETS, f"poisson_net_{LARGEST_NET}.mat"), big)
    argv_big = wireless_argv(big, 1, 0.9, 0.9, 1.0, os.path.join(
        tmp, "host_largest_out"), "--opt=0", f"--device={dev}")
    reset_launch_counts()
    with timed(sim_wireless.exact_mod, "mwis_exact") as ex, \
            timed(card, "solve_mwis_resident") as ag, \
            lgs_calls([pipeline_mod]) as calls:
        secs, res = cli_lines(
            lambda: wireless_sim.main(argv_big, agent=card), 20)
    launches["host_engine_largest"] = batched_lgs_kernel.launches
    check(len(res.rows) == 3, f"host, largest: {len(res.rows)} rows")
    check(launches["host_engine_largest"] == WIRELESS_T - 1,
          f"host, largest: {launches['host_engine_largest']} B1 launches")
    ratios_ok(res.rows, "host, largest")
    checked = lgs_vs_plain(calls, "host engine resident solves, largest")
    slow = sum(t > LOCAL_SEARCH_S for t in ex["each"])
    out.update(largest_s=secs, largest_exact_s=ex["s"],
               largest_agent_s=ag["s"], largest_local_search_solves=slow)
    print(f"phase 20: wireless_sim.main --opt=0 on poisson_net_{LARGEST_NET} "
          f"(81 links) at load 0.9, T={WIRELESS_T}: {secs:.3f} s: exact "
          f"solver {ex['s']:.4f} s ({ex['calls']} solves, {slow} over "
          f"{LOCAL_SEARCH_S} s, i.e. with the local search; the longest "
          f"{max(ex['each']) * 1e3:.3f} ms, the median "
          f"{np.median(ex['each']) * 1e3:.3f} ms), agent {ag['s']:.4f} s "
          f"({ag['calls']} resident solves; B1 held against the plain "
          f"version: {checked} graphs); utility ratios <= 1", flush=True)
    # DGCN-LGS-Seq at n_ch=3: one solve_mwis a channel with live links
    argv = wireless_argv(nets, 3, 0.6, 0.6, 1.0, os.path.join(tmp, "seq"),
                         "--opt=5", "--benchmark=greedy", f"--device={dev}")
    reset_launch_counts()
    with lgs_calls([agents_mod]) as calls:
        secs, res = cli_lines(lambda: wireless_sim.main(
            argv, agent=card, max_networks=1), 20)
    launches["host_seq"] = batched_lgs_kernel.launches
    check(len(res.rows) == 1 and 0 < launches["host_seq"]
          <= 3 * (WIRELESS_T - 1), f"seq: {launches['host_seq']} launches")
    checked = lgs_vs_plain(calls, "DGCN-LGS-Seq solves")
    out["seq_s"] = secs
    print(f"phase 20: wireless_sim.main --opt=5 (DGCN-LGS-Seq) n_ch=3 on "
          f"poisson_net_{HOST_NETS[0]} at load 0.6: {secs:.3f} s, "
          f"{launches['host_seq']} B1 launches (each held against the plain "
          f"version: {checked} graphs), avg_queue_len "
          f"{res.rows[0]['avg_queue_len']:.3f}", flush=True)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# the data-parallel train step and the multi-card dry run (phase 21)
# ---------------------------------------------------------------------------

STEP_RTOL, STEP_ATOL = 1e-5, 1e-6


def unsharded_step(model, cfg, opt, state, adj, wts, maskf, labels):
    """The JAX step's loss (`distgcn_tpu/parallel/mesh.py:70-83`) on the
    whole batch, autograd and one `opt` update: no collectives."""
    feats, sups = build_state_arrays(adj, wts, maskf > 0, cfg.feature_size,
                                     cfg.max_degree, cfg.predict)
    out = model(feats, sups)
    err = (out[..., :1] - labels) ** 2
    mse = (err[..., 0] * maskf).sum(-1) / maskf.sum(-1).clamp(min=1.0)
    loss = torch.sqrt(mse).mean() + cfg.weight_decay * first_layer_l2(model)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    updates, state = opt.update(dict(zip(params, grads)), state)
    apply_updates(params, updates)
    return state, loss.detach()


def params_diff(got, want) -> float:
    """The largest |got - want| beyond rtol x |want| over the parameters
    (<= STEP_ATOL passes)."""
    worst = 0.0
    ref = want.state_dict()
    for k, v in got.state_dict().items():
        w = ref[k].to(v.device)
        worst = max(worst, float(((v - w).abs()
                                  - STEP_RTOL * w.abs()).max()))
    return worst


def top_kernels(logdir: str, k: int = 3):
    """The k CUDA kernels with the most device time in the Chrome trace
    `utils.profiling.trace` wrote into `logdir`, as (name, ms, calls), and
    the ms of every kernel in the trace."""
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    check(len(files) == 1, f"trace files in {logdir}: {files}")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    tot = {}
    for e in events:
        if e.get("cat") == "kernel":
            ms, n = tot.get(e["name"], (0.0, 0))
            tot[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    check(len(tot) > 0, "the trace holds no CUDA kernel")
    top = sorted(((n, ms, c) for n, (ms, c) in tot.items()),
                 key=lambda t: -t[1])[:k]
    return top, sum(ms for ms, _ in tot.values())


def step_batch(dev):
    """Phase 21's batch: B seeded graphs of 100..256 nodes padded to 256
    and seeded labels, as (adj, wts, mask float, labels [B, N, 1]) on
    `dev`."""
    rng = np.random.default_rng(21)
    adjs, wtss = graphs(rng, B, N_MIN, N)
    gb = GraphBatch.from_scipy(adjs, wtss, pad_to=N, device=dev)
    labels = torch.from_numpy(rng.random((B, N, 1)).astype(np.float32))
    return gb.adj, gb.wts, gb.mask.to(torch.float32), labels.to(dev)


def phase_train_step(dev, tree, tmp) -> dict:
    """Phase 21a: the sharded train step at full width against the
    unsharded step on the card and the same step on the CPU; its time."""
    cfg = train_config()
    batch = step_batch(dev)
    cpu_batch = tuple(t.cpu() for t in batch)
    opt = make_optimizer(TRAIN_LR)
    mesh = make_mesh()
    check(mesh.shape == {"data": 1, "model": 1} and dist.is_initialized(),
          f"mesh {mesh.shape} in the one-rank group")
    models = {where: make_model_from_config(
        cfg, "gcn2_dqn", params=params_from_jax(tree), device=d)
        for where, d in (("card", dev), ("plain", dev), ("cpu", "cpu"))}
    states = {k: opt.init(dict(m.named_parameters()))
              for k, m in models.items()}
    step = make_sharded_train_step(models["card"], cfg, opt, mesh)
    states["card"], loss = step(states["card"], *batch)
    states["plain"], ploss = unsharded_step(models["plain"], cfg, opt,
                                            states["plain"], *batch)
    states["cpu"], closs = make_sharded_train_step(
        models["cpu"], cfg, opt, mesh)(states["cpu"], *cpu_batch)
    torch.cuda.synchronize()
    lrel = {k: abs(float(loss) - float(v)) / abs(float(v))
            for k, v in (("plain", ploss), ("cpu", closs))}
    pdiff = {k: params_diff(models["card"], models[k])
             for k in ("plain", "cpu")}
    check(np.isfinite(float(loss)) and max(lrel.values()) <= STEP_RTOL,
          f"sharded step loss {float(loss)} vs unsharded card / CPU: "
          f"rel {lrel}")
    check(max(pdiff.values()) <= STEP_ATOL, f"sharded step parameters vs "
          f"unsharded card / CPU: beyond rtol {STEP_RTOL} by {pdiff}")

    def one(i=0):
        states["card"], _ = step(states["card"], *batch)

    per_s = marginal_s(one)
    timer = StepTimer("sharded train step", device=dev)
    edges = int((batch[0] > 0).sum()) // 2
    for _ in range(4):
        with timer:
            one()
        timer.add(graphs=B, edges=edges)
    enqueued = len(kernels_enqueued(one))
    logdir = os.path.join(tmp, "trace")
    with trace(logdir):
        one()
        one()
        torch.cuda.synchronize()
    top, busy_ms = top_kernels(logdir)
    print(f"phase 21: make_sharded_train_step gcn2_dqn ERGDPG2 l20 c32, "
          f"B={B} N={N}, mesh {mesh.shape}: loss {float(loss):.6f}, rel "
          f"diff vs the unsharded card step {lrel['plain']:.3g}, vs the CPU "
          f"{lrel['cpu']:.3g}; parameters beyond rtol {STEP_RTOL}: card "
          f"{pdiff['plain']:.3g}, CPU {pdiff['cpu']:.3g} (atol "
          f"{STEP_ATOL}); per step {per_s * 1e3:.4f} ms (marginal of 2 and "
          f"6 steps), {enqueued} kernels enqueued per step", flush=True)
    print(f"phase 21: {timer.summary()}", flush=True)
    print(f"phase 21: trace of two steps: {busy_ms / 2:.4f} ms of CUDA "
          f"kernels a step; costliest: "
          + "; ".join(f"{name[:60]} {ms:.4f} ms in {c} calls"
                      for name, ms, c in top), flush=True)
    return {"ms_per_step": per_s * 1e3, "kernels_per_step": enqueued,
            "kernel_ms_per_step": busy_ms / 2, "loss_rel": lrel,
            "params_excess": pdiff}


@contextlib.contextmanager
def sharded_calls():
    """Records the inputs and outputs of every SpMM and neighbour-max call
    `parallel.large_sharded` makes while open (the real calls run)."""
    calls = []
    real = {name: getattr(large_sharded_mod, name)
            for name in ("spmm_rows", "nbr_max_rows")}

    def recorder(name):
        def call(*args):
            out = real[name](*args)
            calls.append((name, tuple(a.clone() if torch.is_tensor(a)
                                      else a for a in args), out.clone()))
            return out
        return call

    for name in real:
        setattr(large_sharded_mod, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(large_sharded_mod, name, fn)


def sharded_vs_plain(calls) -> dict:
    """Each recorded kernel call against its plain version on the same
    tensors: the neighbour-maxes bit-equal to `bsr_nbr_max_plain`; the
    SpMM bit-equal to `edge_spmm_plain` (each row's edges summed in the
    kernel's order, run on the CPU, whose `index_add_` adds in that order)
    and within phase 6's rtol 2e-5 / atol 1e-5 of `bsr_spmm_plain`.
    Returns the calls checked per kernel and the SpMM's largest
    difference."""
    seen = {"bsr_spmm": 0, "bsr_nbr_max": 0, "bsr_nbr_max_i32": 0}
    worst = 0.0
    for name, (words, rptr, cols, x, n, bs, bitmap), got in calls:
        check(bitmap and got.is_cuda, f"dry run {name}: bitmap {bitmap}")
        if name == "nbr_max_rows":
            want = bsr_nbr_max_plain(words, rptr, cols, x, n, bs, bitmap)
            bits = (got, want) if x.dtype == torch.int32 else (
                got.view(torch.int32), want.view(torch.int32))
            check(torch.equal(*bits), f"dry run neighbour-max ({x.dtype}) "
                  "differs from its plain version")
            seen["bsr_nbr_max_i32" if x.dtype == torch.int32
                 else "bsr_nbr_max"] += 1
            continue
        ordered = edge_spmm_plain(words.cpu(), rptr.cpu(), cols.cpu(), None,
                                  None, x.cpu(), n, bs)
        check(torch.equal(got.cpu(), ordered), "dry run SpMM differs from "
              "edge_spmm_plain in the kernel's order")
        want = bsr_spmm_plain(words, rptr, cols, x, n, bs, bitmap)
        worst = max(worst, float((got - want).abs().max()))
        check(torch.allclose(got, want, rtol=2e-5, atol=1e-5),
              f"dry run SpMM: max abs diff {worst} from bsr_spmm_plain")
        seen["bsr_spmm"] += 1
    return {"calls": seen, "spmm_max_abs_err": worst}


def phase_dryrun(dev) -> dict:
    """Phase 21b: `dryrun.entry` and `dryrun.dryrun_multichip(1)` on the
    card; every selection valid, every kernel call against its plain
    version, the dry run's launch counts."""
    with lgs_calls([pipeline_mod]) as entry_calls:
        fn, (adj, wts, mask) = dryrun.entry(dev)
        sel, util, gutil = fn(adj, wts, mask)
        torch.cuda.synchronize()
    check(independent_and_maximal(sel, adj, mask),
          "entry: a schedule is not independent and maximal")
    entry_graphs = lgs_vs_plain(entry_calls, "entry")
    with lgs_calls([pipeline_mod]) as b1, sharded_calls() as kernels:
        reset_launch_counts()
        out = dryrun.dryrun_multichip(1, device=dev)
        torch.cuda.synchronize()
        counts = launch_counts()
    check(counts["lgs"] > 0 and counts["bsr_spmm"] > 0
          and counts["bsr_nbr_max"] > 0 and counts["cheb_fused"] == 0,
          f"dry run launches {counts}")
    check(independent_and_maximal(out["sel"], out["adj"], out["mask"]),
          "dry run: a batch schedule is not independent and maximal")
    gsel = out["giant_sel"].cpu().numpy()
    check(schedule_ok(torch.from_numpy(gsel), out["giant_adj"],
                      gsel.size), "dry run: the giant-graph schedule")
    graphs_b1 = lgs_vs_plain(b1, "dry run")
    held = sharded_vs_plain(kernels)
    check(held["calls"]["bsr_spmm"] == counts["bsr_spmm"]
          and held["calls"]["bsr_nbr_max"] == counts["bsr_nbr_max"]
          and held["calls"]["bsr_nbr_max_i32"] == counts["bsr_nbr_max_i32"],
          f"held {held['calls']} of the launches {counts}")
    print(f"phase 21: dryrun.entry: 8 schedules independent and maximal, "
          f"mean utility {float(util.mean()):.6f} (greedy "
          f"{float(gutil.mean()):.6f}), B1 equal to its plain version on "
          f"{entry_graphs} graphs", flush=True)
    print(f"phase 21: dryrun_multichip(1): mesh {out['mesh']}, loss "
          f"{out['loss']:.6f}, mean_util {out['mean_util']:.6f}, "
          f"giant_graph_util {out['giant_graph_util']:.6f}; launches "
          f"{counts}; B1 equal to its plain version on {graphs_b1} graphs; "
          f"calls held against their plain versions {held['calls']} (SpMM "
          f"bit-equal in the kernel's order, max abs diff "
          f"{held['spmm_max_abs_err']:.3g} from bsr_spmm_plain)",
          flush=True)
    return {"launches": counts, "held": held}


# ---------------------------------------------------------------------------
# the data-sharded closed loop (phase 22)
# ---------------------------------------------------------------------------

SHARDED_T = 100


def loop_slot_ms(runs, adj, mask, queue0):
    """ms a slot of a closed loop (``runs``: {T: run} at two episode
    lengths) on LOOP_SEED's generator, by `marginal_ms`. Returns (ms,
    {T: (queueT, metrics)})."""
    dev = queue0.device

    def work(t):
        gen = torch.Generator(device=dev).manual_seed(LOOP_SEED)
        return runs[t](adj, mask, queue0, gen)

    ms, _, out = marginal_ms(work, *sorted(runs), dev)
    return ms, out


def episodes_equal(got, want) -> bool:
    """Two (queueT, metrics) results bit for bit."""
    return (torch.equal(got[0], want[0]) and got[1].keys() == want[1].keys()
            and all(torch.equal(got[1][k], v) for k, v in want[1].items()))


def phase_sharded_loop(dev, cfg, tree, phase4_ms) -> dict:
    """Phase 22: `make_closed_loop(..., mesh=make_mesh())` at phase 4's
    width in the one-rank group, bit-equal to the unsharded loop in gdpg
    and dqn f32 with the greedy baseline; B1's launches on that path, a
    sample of its calls against the plain version, and its ms a slot
    beside the unsharded loop's."""
    gb = loop_batch(dev)
    model = make_model_from_config(cfg, "gcn2_dqn",
                                   params=params_from_jax(tree), device=dev)
    mesh = make_mesh()
    check(mesh.shape == {"data": 1, "model": 1} and dist.is_initialized(),
          f"mesh {mesh.shape} in the one-rank group")
    q0 = torch.zeros((B, N), device=dev)

    def loop(t, mode, sharded):
        return make_closed_loop(model, cfg, t, load=0.9, feature_mode=mode,
                                with_baseline=True,
                                mesh=mesh if sharded else None)

    def episode(mode, sharded):
        return loop(SHARDED_T, mode, sharded)(
            gb.adj, gb.mask, q0,
            torch.Generator(device=dev).manual_seed(LOOP_SEED))

    modes = ("gdpg", "dqn")
    want = {mode: episode(mode, False) for mode in modes}
    torch.cuda.synchronize()
    reset_launch_counts()
    with lgs_calls([device_sim], every=25) as calls:
        got = {mode: episode(mode, True) for mode in modes}
        torch.cuda.synchronize()
    counts = launch_counts()
    launches = counts["lgs"]
    check(launches == 2 * SHARDED_T * len(modes),
          f"the sharded loop launched B1 {launches} times")
    check(all(n == 0 for k, n in counts.items() if k != "lgs"),
          f"the sharded loop launched other kernels: {counts}")
    for mode in modes:
        check(episodes_equal(got[mode], want[mode]),
              f"sharded {mode} episode differs from the unsharded one")
        queues_ok(got[mode][0], gb.mask, f"sharded {mode}")
    graphs_held = lgs_vs_plain(calls, "sharded loop")
    runs = {s: {t: loop(t, "gdpg", s) for t in (100, 500)}
            for s in (False, True)}
    loop(3, "gdpg", True)(gb.adj, gb.mask, q0,
                          torch.Generator(device=dev).manual_seed(0))
    ms = {False: [], True: []}
    for s in (False, True, True, False) * 2:
        ms[s].append(loop_slot_ms(runs[s], gb.adj, gb.mask, q0)[0])
    m = want["gdpg"][1]
    print(f"phase 22: make_closed_loop(mesh=make_mesh()) gcn2_dqn ERGDPG2 "
          f"l20 c32 f32, B={B} N={N} load 0.9, mesh {mesh.shape}, "
          f"T={SHARDED_T} with the greedy baseline: queueT and metrics "
          f"bit-equal to the unsharded loop in gdpg and dqn; B1 launches "
          f"{launches} (2 a slot), {len(calls)} calls held against the "
          f"plain version ({graphs_held} graphs); gdpg avg_queue_len "
          f"{float(m['avg_queue_len'].mean()):.4f}, avg_utility_ratio "
          f"{float(m['avg_utility_ratio'].mean()):.6f}", flush=True)
    print(f"phase 22: gdpg f32 with the baseline, ms a slot (marginal of "
          f"T=100 and T=500; twice in turns unsharded, sharded, sharded, "
          f"unsharded): sharded median {np.median(ms[True]):.4f} ("
          + " / ".join(f"{x:.4f}" for x in ms[True]) + "), unsharded "
          f"median {np.median(ms[False]):.4f} ("
          + " / ".join(f"{x:.4f}" for x in ms[False]) + f"); phase 4 (no "
          f"baseline; before phase 21's profiler sessions) "
          f"{phase4_ms['gdpg', 'float32']:.4f}", flush=True)
    return {"launches": counts, "graphs_held": graphs_held,
            "sharded_ms_per_slot": ms[True],
            "unsharded_ms_per_slot": ms[False]}


COUNTED = {"lgs": batched_lgs_kernel, "bsr_nbr_max": bsr_nbr_max_kernel,
           "bsr_nbr_max_i32": bsr_nbr_max_i32_kernel,
           "bsr_spmm": bsr_spmm_kernel, "cheb_fused": fused_cheb_layer_kernel}


def reset_launch_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase_build(smi)
    cfg = loop_config()
    tree = load_params(CKPT)
    max_err = phase_kernel_vs_plain(dev)
    phase_pipeline(dev, cfg, tree)
    reset_launch_counts()
    phase4_ms = phase_closed_loop(dev, cfg, tree)
    launches = batched_lgs_kernel.launches
    check(launches > 0, "the closed loop never launched the LGS kernel")
    timing = phase_timing(dev)
    wrapper = timing.pop("wrapper")
    kernels = [{"name": "lgs", "route": "cuda",
                "source": "distgcn_tpu_torch/csrc/lgs.cu",
                "replaces": "distgcn_tpu/ops/lgs_pallas.py:48",
                "launches": launches, "max_abs_err": max_err, **timing,
                "library_ms": None}]

    large = phase_large_setup(dev)
    errs = phase_large_kernels(dev, large)
    reset_launch_counts()
    phase_large_solve(dev, large)
    phase_weighted_solve(large)
    phase_large_closed_loop(dev, large, tree)
    counts = launch_counts()
    for name, _, _ in LARGE_KERNELS:
        check(counts[name] > 0, f"the large-graph path never launched {name}")
    timings = phase_large_timing(dev, large)
    for name, source, replaces in LARGE_KERNELS:
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": errs[name], **timings[name]})

    with nccl_group(dev):
        sharded = phase_sharded(dev, large)
        check(sharded.launches > 0,
              "the sharded path never launched the int32 neighbour-max")
        kernels.append({"name": "bsr_nbr_max_i32", "route": "cuda",
                        "source": "distgcn_tpu_torch/csrc/bsr_nbr_max.cu",
                        "replaces": "distgcn_tpu/ops/spmm.py:521",
                        "launches": sharded.launches,
                        **phase_sharded_kernels(dev, large, sharded)})
    # each phase counts the LGS launches of its own main path: the solves
    # (12), the train_gdpg epoch (13), the T=60 episode (14)
    train = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, phase, arg in (("agent", phase_agent, tmp),
                                 ("gdpg_cli", phase_gdpg_cli, tmp),
                                 ("online", phase_online, tree)):
            t0 = time.perf_counter()
            result = phase(dev, arg)
            train[name] = result["launches"]
            check(train[name] > 0, f"the {name} path never launched the "
                  "LGS kernel")
            print(f"phase {12 + len(train) - 1}: "
                  f"{time.perf_counter() - t0:.3f} s wall; {result}",
                  flush=True)
    kernels[0]["train_launches"] = train
    # the graph-set evaluation path: each phase counts its own main path
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        it = phase_iterative(dev)
        print(f"phase 15: {time.perf_counter() - t0:.3f} s wall", flush=True)
        t0 = time.perf_counter()
        diver = phase_diver(dev, tmp)
        check(diver["launches"] > 0, "the diver path never launched the "
              "LGS kernel")
        kernels[0].update(phase_multi_timing(dev, diver.pop("agent")))
        kernels[0]["multi_launches"] = diver["launches"]
        print(f"phase 16: {time.perf_counter() - t0:.3f} s wall; {diver}",
              flush=True)
        t0 = time.perf_counter()
        trainers = phase_trainers(dev, tmp)
        print(f"phase 17: {time.perf_counter() - t0:.3f} s wall; "
              f"{trainers}", flush=True)
    kernels[0]["eval_launches"] = {
        **{k: v["launches"] for k, v in it.items()},
        "train_dqn": trainers["dqn_launches"],
        "train_diver": trainers["diver_launches"]}
    # the wireless path: each main path counted on its own
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ex = phase_exact(dev)
        print(f"phase 18: {time.perf_counter() - t0:.3f} s wall; {ex}",
              flush=True)
        t0 = time.perf_counter()
        loops = phase_wireless_loops(dev, tmp)
        print(f"phase 19: {time.perf_counter() - t0:.3f} s wall; {loops}",
              flush=True)
        t0 = time.perf_counter()
        host = phase_host_engine(dev, tmp)
        print(f"phase 20: {time.perf_counter() - t0:.3f} s wall; {host}",
              flush=True)
    kernels[0]["wireless_launches"] = {**loops["launches"],
                                       **host["launches"]}
    # the data-parallel train step and the dry run in a one-rank group
    with tempfile.TemporaryDirectory() as tmp, nccl_group(dev):
        t0 = time.perf_counter()
        step = phase_train_step(dev, tree, tmp)
        dry = phase_dryrun(dev)
        print(f"phase 21: {time.perf_counter() - t0:.3f} s wall; {step}",
              flush=True)
        t0 = time.perf_counter()
        loop = phase_sharded_loop(dev, cfg, tree, phase4_ms)
        print(f"phase 22: {time.perf_counter() - t0:.3f} s wall; {loop}",
              flush=True)
    for k in kernels:
        k["dryrun_launches"] = dry["launches"][k["name"]]
        k["sharded_loop_launches"] = loop["launches"][k["name"]]
    kernels[0]["kernels_enqueued"] = phase_enqueued(wrapper)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
