"""Hand-written CUDA LGS kernel for Hopper (`csrc/lgs.cu`).

Counterpart of `distgcn_tpu/ops/lgs_pallas.py`, with the boundary of
`ops.lgs.batched_lgs`: weights in; selection, per-graph utility and rounds
out, in one launch. One CTA per graph ranks its nodes from the weights (the
order of `ops.lgs.lgs_ranks`), packs the adjacency into a rank-ordered row
bitmask, runs every round over it and sums the selected weights. The
bitmask lives in shared memory while it fits there (`rows_in_smem`, N up
to 1,312); above that the wrapper gives the kernel a device-memory scratch
for it. Selections and rounds are bit-identical to
`ops.lgs.batched_lgs_plain`.

With ``share`` = D > 1 the kernel solves D weight rows on each adjacency
(weight row g reads adjacency g // D): `ops.lgs.batched_lgs_multi`'s D
variants of one graph with no D-fold copy of it.

`batched_lgs_kernel.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from distgcn_tpu_torch.ops import _build
from distgcn_tpu_torch.ops.lgs import lgs_ranks

SMEM_BYTES = 232448   # a CTA's shared memory on sm_90 (csrc/lgs.cu kMaxSmem)
# weight types the kernel reads (csrc/lgs.cu WeightType); float64 weights
# take the ranked-keys route of `batched_lgs_kernel`
WEIGHT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def smem_bytes(n: int, rows: bool) -> int:
    """csrc/lgs.cu's shared memory for an n-node graph: the keys (padded
    to whole words of 32 nodes), the remain x2, win and chosen words, and
    the order map and the row bitmask when `rows`."""
    words = (n + 31) // 32
    small = 36 * words
    return 4 * (small + (n + n * (words | 1) if rows else 0))


def rows_in_smem(n: int) -> bool:
    """True iff the kernel keeps an n-node graph's row bitmask in shared
    memory; above that it reads it from a device-memory scratch."""
    return smem_bytes(n, True) <= SMEM_BYTES


def block_threads(n: int) -> int:
    """csrc/lgs.cu's threads per CTA: four per node up to N=256, one per
    node up to 1024, else 1024."""
    span = (n + 31) // 32 * 32
    return 4 * span if n <= 256 else min(span, 1024)


# the largest N whose keys and state words fit shared memory
MAX_N = SMEM_BYTES // 4 // 36 * 32


def batched_lgs_kernel(adj: torch.Tensor, wts: torch.Tensor,
                       mask: torch.Tensor, max_rounds: Optional[int] = None,
                       share: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LGS over a padded batch on the card.

    Args:
      adj:  [B / share, N, N] int8 or bool, contiguous, CUDA (> 0 is an
        edge).
      wts:  [B, N] float32, bfloat16, float16 or float64 node weights.
      mask: [B, N] bool, contiguous, True for real nodes.
      max_rounds: optional round cap (None = until no node remains).
      share: weight rows per adjacency: row g is solved on adjacency
        g // share.

    Returns (sel [B, N] int8 in {-1, 0, 1}, util [B] in the weights' dtype,
    rounds [B] int32 — per graph, where `batched_lgs` returns the batch
    max). One kernel launch for float32, bfloat16 and float16 weights;
    float64 weights cannot be narrowed without merging values, so their
    `lgs_ranks` go in as float32 keys and the utility is a torch sum in
    float64. Launches on the current stream without synchronising.
    """
    if adj.dim() != 3 or wts.dim() != 2 or mask.dim() != 2:
        raise ValueError("expected adj [B, N, N], wts [B, N], mask [B, N]")
    b, n = wts.shape
    share = int(share)
    if share < 1 or adj.shape[0] * share != b:
        raise ValueError(f"adj holds {adj.shape[0]} graphs: share={share} "
                         f"needs adj.shape[0] * share == {b} weight rows")
    if adj.shape[1:] != (n, n) or mask.shape != (b, n):
        raise ValueError(f"shape mismatch: adj {tuple(adj.shape)}, wts "
                         f"{tuple(wts.shape)}, mask {tuple(mask.shape)}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"N={n} outside the kernel's range 1..{MAX_N}")
    if adj.dtype not in (torch.int8, torch.bool):
        raise ValueError(f"adj must be int8 or bool, got {adj.dtype}")
    if mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool, got {mask.dtype}")
    if wts.dtype not in WEIGHT_TYPES and wts.dtype != torch.float64:
        raise ValueError("wts must be float32, bfloat16, float16 or "
                         f"float64, got {wts.dtype}")
    if not (adj.is_contiguous() and mask.is_contiguous()):
        raise ValueError("adj and mask must be contiguous")
    if not (adj.is_cuda and wts.device == adj.device
            and mask.device == adj.device):
        raise ValueError("batched_lgs_kernel needs adj, wts and mask on one "
                         f"CUDA device (got {adj.device}, {wts.device}, "
                         f"{mask.device})")
    cap = n if max_rounds is None else max(0, min(int(max_rounds), n))
    if wts.dtype != torch.float64:
        return launch(adj, wts.contiguous(), mask, cap, share=share)
    sel, _, rounds = launch(adj, lgs_ranks(wts).float(), mask, cap,
                            with_util=False, share=share)
    util = torch.where(sel == 1, wts, torch.zeros_like(wts)).sum(dim=-1)
    return sel, util, rounds


def launch(adj: torch.Tensor, wts: torch.Tensor, mask: torch.Tensor,
           cap: int, with_util: bool = True, defines: Tuple[str, ...] = (),
           share: int = 1
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """The bare kernel launch on checked inputs: int8/bool adj
    [B / share, N, N], float32/bfloat16/float16 weights [B, N] and bool
    mask [B, N], contiguous, on one card -> (sel [B, N] int8, util [B] in
    the weights' dtype or None when not `with_util`, rounds [B] int32).
    Counts the launch. `defines` selects a build of the source
    (`CLOCK_DEFINES`)."""
    b, n = wts.shape
    dev = adj.device
    sel = torch.empty((b, n), dtype=torch.int8, device=dev)
    util = (torch.empty((b,), dtype=wts.dtype, device=dev) if with_util
            else None)
    rounds = torch.empty((b,), dtype=torch.int32, device=dev)
    # past shared memory: the row bitmasks and the position -> node map,
    # u32 words in int32 storage
    scratch = (None if rows_in_smem(n) else
               torch.empty((b, n * (((n + 31) // 32) | 1) + n),
                           dtype=torch.int32, device=dev))
    launch_fn = _build.bind("lgs", "lgs_launch",
                            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                            + [ctypes.c_void_p], defines)
    with torch.cuda.device(dev):
        launch_fn(adj.data_ptr(), wts.data_ptr(), mask.data_ptr(),
                  sel.data_ptr(), None if util is None else util.data_ptr(),
                  rounds.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), b, n, cap,
                  WEIGHT_TYPES[wts.dtype], share, _build.stream_of(adj))
    batched_lgs_kernel.launches += 1
    return sel, util, rounds


batched_lgs_kernel.launches = 0


CLOCK_DEFINES = ("LGS_CLOCKS=1",)   # the build that times its phases
PHASES = ("issue", "keys", "ranks", "position map", "arrival", "rows",
          "states", "rounds", "outputs")


def read_clocks() -> dict:
    """The phase cycles of the ``LGS_CLOCKS=1`` build since the last read
    (which zeroes them): SM clock cycles of thread 0 between the kernel's
    barriers, summed over the CTAs, per phase of `PHASES`; the
    CTAs counted ("ctas"), the largest CTA's cycles ("max_cta") and the ns
    from the first CTA's start to the last CTA's end on the global timer
    ("span_ns"). Synchronises."""
    lib = _build.load("lgs", CLOCK_DEFINES)
    sums = (ctypes.c_ulonglong * (len(PHASES) + 4))()
    lib.lgs_clocks.argtypes = [ctypes.c_void_p]
    lib.lgs_clocks.restype = ctypes.c_int
    err = lib.lgs_clocks(ctypes.addressof(sums))
    if err:
        raise RuntimeError(f"lgs_clocks failed ({err})")
    out = dict(zip(PHASES + ("ctas", "max_cta"), sums))
    first, last = (1 << 64) - 1 - sums[len(PHASES) + 2], sums[len(PHASES) + 3]
    out["span_ns"] = last - first if sums[len(PHASES)] else 0
    return out
