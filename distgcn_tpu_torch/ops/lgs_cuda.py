"""Hand-written CUDA LGS kernel for Hopper (`csrc/lgs.cu`).

Counterpart of `distgcn_tpu/ops/lgs_pallas.py`: one CTA per graph runs the
whole multi-round solve over the adjacency packed into a row bitmask, and
each graph stops after its own rounds. The bitmask lives in shared memory
while it fits there (`rows_in_smem`, N up to about 1,300); above that the
wrapper gives the kernel a device-memory scratch for it. Ranks come from
`ops.lgs.lgs_ranks` before the launch and the utility is a torch sum after
it — the boundary of `batched_lgs_pallas`. Selections and rounds are
bit-identical to `ops.lgs.batched_lgs_plain`.

`batched_lgs_kernel.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from distgcn_tpu_torch.ops import _build
from distgcn_tpu_torch.ops.lgs import lgs_ranks

SMEM_BYTES = 232448   # a CTA's shared memory on sm_90 (csrc/lgs.cu kMaxSmem)


def smem_bytes(n: int, rows: bool) -> int:
    """csrc/lgs.cu's shared memory for an n-node graph: ranks, remain and
    win words, int8 states, and the row bitmask when `rows`."""
    words = (n + 31) // 32
    small = n + 2 * words + (n + 3) // 4
    return 4 * (small + (n * (words | 1) if rows else 0))


def rows_in_smem(n: int) -> bool:
    """True iff the kernel keeps an n-node graph's row bitmask in shared
    memory; above that it reads it from a device-memory scratch."""
    return smem_bytes(n, True) <= SMEM_BYTES


# the largest N whose ranks, states and remain/win words fit shared memory
MAX_N = next(n for n in range(SMEM_BYTES // 5, 0, -1)
             if smem_bytes(n, False) <= SMEM_BYTES)


def batched_lgs_kernel(adj: torch.Tensor, wts: torch.Tensor,
                       mask: torch.Tensor, max_rounds: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LGS over a padded batch on the card.

    Args:
      adj:  [B, N, N] int8 or bool, contiguous, CUDA (> 0 is an edge).
      wts:  [B, N] float node weights.
      mask: [B, N] bool, contiguous, True for real nodes.
      max_rounds: optional round cap (None = until no node remains).

    Returns (sel [B, N] int8 in {-1, 0, 1}, util [B], rounds [B] int32 —
    per graph, where `batched_lgs` returns the batch max). Launches on the
    current stream without synchronising.
    """
    if adj.dim() != 3 or wts.dim() != 2 or mask.dim() != 2:
        raise ValueError("expected adj [B, N, N], wts [B, N], mask [B, N]")
    b, n = wts.shape
    if adj.shape != (b, n, n) or mask.shape != (b, n):
        raise ValueError(f"shape mismatch: adj {tuple(adj.shape)}, wts "
                         f"{tuple(wts.shape)}, mask {tuple(mask.shape)}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"N={n} outside the kernel's range 1..{MAX_N}")
    if adj.dtype not in (torch.int8, torch.bool):
        raise ValueError(f"adj must be int8 or bool, got {adj.dtype}")
    if mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool, got {mask.dtype}")
    if not wts.is_floating_point():
        raise ValueError(f"wts must be floating point, got {wts.dtype}")
    if not (adj.is_contiguous() and mask.is_contiguous()):
        raise ValueError("adj and mask must be contiguous")
    if not (adj.is_cuda and wts.device == adj.device
            and mask.device == adj.device):
        raise ValueError("batched_lgs_kernel needs adj, wts and mask on one "
                         f"CUDA device (got {adj.device}, {wts.device}, "
                         f"{mask.device})")
    cap = n if max_rounds is None else max(0, min(int(max_rounds), n))
    sel, rounds = launch(adj, lgs_ranks(wts), mask, cap)
    util = torch.where(sel == 1, wts, torch.zeros_like(wts)).sum(dim=-1)
    return sel, util, rounds


def launch(adj: torch.Tensor, ranks: torch.Tensor, mask: torch.Tensor,
           cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bare kernel launch on checked inputs: int8/bool adj [B, N, N],
    int32 ranks [B, N] and bool mask [B, N], contiguous, on one card ->
    (sel [B, N] int8, rounds [B] int32). Counts the launch."""
    b, n = ranks.shape
    sel = torch.empty((b, n), dtype=torch.int8, device=adj.device)
    rounds = torch.empty((b,), dtype=torch.int32, device=adj.device)
    # the row bitmasks past shared memory: u32 words in int32 storage
    scratch = (None if rows_in_smem(n) else
               torch.empty((b, n, ((n + 31) // 32) | 1), dtype=torch.int32,
                           device=adj.device))
    launch_fn = _build.bind("lgs", "lgs_launch",
                            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                            + [ctypes.c_void_p])
    with torch.cuda.device(adj.device):
        launch_fn(adj.data_ptr(), ranks.data_ptr(), mask.data_ptr(),
                  sel.data_ptr(), rounds.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), b, n, cap,
                  _build.stream_of(adj))
    batched_lgs_kernel.launches += 1
    return sel, rounds


batched_lgs_kernel.launches = 0
