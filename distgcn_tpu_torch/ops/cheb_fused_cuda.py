"""Hand-written CUDA fused ChebGCN layer for Hopper (`csrc/cheb_fused.cu`).

Counterpart of the JAX package's `_fused_layer_kernel`,
`_fused_panel_kernel` and `_fused_gwin_kernel`
(`distgcn_tpu/ops/cheb_fused.py`): one whole K=1 layer
``act(h@(W0+W1) + b - bf16(r)*bf16((A(r*h))@W1))`` per launch, with the
A-product and both W-products inside the kernel.
`ops.cheb_fused.fused_cheb_layer` launches it for CUDA tensors;
`ops.cheb_fused.fused_cheb_layer_plain` is its plain version. The
A-product runs on the tensor cores over the structure blocks' occupied
32-column chunks; the W-products are f32 on the CUDA cores.

`fused_cheb_layer_kernel.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from distgcn_tpu_torch.ops import _build
from distgcn_tpu_torch.ops.spmm_cuda import check_bsr

WIDTHS = (32, 64, 96, 128)     # feature widths the kernel is built for
# cheb_fused_launch(ind, bitmap, row_ptr, blk_cols, x, r, w1, w01, bias, out,
#                   out_f32, act_mode, n_rows, bs, f, stream)
ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def fused_cheb_layer_kernel(ind_vals: torch.Tensor, row_ptr: torch.Tensor,
                            blk_cols: torch.Tensor, x: torch.Tensor,
                            r: torch.Tensor, w1: torch.Tensor,
                            w01: torch.Tensor, bias: torch.Tensor,
                            n_rows: int, block_size: int, act_mode: int,
                            out_dtype: torch.dtype = torch.bfloat16,
                            bitmap: bool = False) -> torch.Tensor:
    """One fused layer on the card. ind_vals: int8 [nb, bs, bs] or bitmap
    int32 [nb, bs//32, bs] 0/1 structure; row_ptr [R+1], blk_cols [nb]
    int32; x: [n_rows, F] bf16 with F in `WIDTHS`; r: [n_rows] f32;
    w1, w01: [F, F] f32; bias: [F] f32. Returns [n_rows, F] `out_dtype`
    (bf16 or f32). Launches on the current stream without synchronising."""
    f = x.shape[1] if x.dim() == 2 else -1
    if f not in WIDTHS:
        raise ValueError(f"fused_cheb_layer_kernel: x must be [n_rows, F] "
                         f"with F in {WIDTHS}, got {tuple(x.shape)}")
    check_bsr(ind_vals, row_ptr, blk_cols, n_rows, block_size, bitmap,
              (torch.int8,), n_rows, "fused_cheb_layer_kernel")
    shapes = {"x": (x, (n_rows, f), torch.bfloat16),
              "r": (r, (n_rows,), torch.float32),
              "w1": (w1, (f, f), torch.float32),
              "w01": (w01, (f, f), torch.float32),
              "bias": (bias, (f,), torch.float32)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fused_cheb_layer_kernel: {name} must be "
                             f"{dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != ind_vals.device or not t.is_contiguous():
            raise ValueError(f"fused_cheb_layer_kernel: {name} must be "
                             "contiguous, on the blocks' device")
    for name, t in (("ind_vals", ind_vals), *((k, v[0]) for k, v in
                                               shapes.items())):
        if t.data_ptr() % 16:            # the kernel's cp.async copies
            raise ValueError(f"fused_cheb_layer_kernel: {name} must be "
                             "16-byte aligned")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if act_mode not in (0, 1):
        raise ValueError(f"act_mode must be 0 or 1, got {act_mode}")
    out = torch.empty((n_rows, f), dtype=out_dtype, device=x.device)
    launch = _build.bind("cheb_fused", "cheb_fused_launch", ARGTYPES)
    with torch.cuda.device(x.device):
        launch(ind_vals.data_ptr(), int(bitmap), row_ptr.data_ptr(),
               blk_cols.data_ptr(), x.data_ptr(), r.data_ptr(),
               w1.data_ptr(), w01.data_ptr(), bias.data_ptr(),
               out.data_ptr(), int(out_dtype == torch.float32), act_mode,
               n_rows, block_size, f, _build.stream_of(x))
    fused_cheb_layer_kernel.launches += 1
    return out


fused_cheb_layer_kernel.launches = 0


COUNT_DEFINES = ("CHEB_FUSED_COUNT=1",)   # the counting build


def read_counts() -> dict:
    """The counts of a ``CHEB_FUSED_COUNT=1`` build of the kernel since the
    last read (which zeroes them): the 32-column k-chunks of the tiles'
    block-rows loaded and skipped, the warps' 16-column MMA steps computed
    and skipped inside the loaded chunks, and SM clock cycles summed over
    the CTAs (thread 0 of each) in occupancy scans, in the A-product
    pipeline, in phase 2 and in the whole CTA, with the largest CTA's
    cycles. Synchronises."""
    lib = _build.load("cheb_fused", COUNT_DEFINES)
    counts = (ctypes.c_ulonglong * 9)()
    lib.cheb_fused_counts.argtypes = [ctypes.c_void_p]
    lib.cheb_fused_counts.restype = ctypes.c_int
    err = lib.cheb_fused_counts(ctypes.addressof(counts))
    if err:
        raise RuntimeError(f"cheb_fused_counts failed ({err})")
    return dict(zip(("chunks_loaded", "chunks_skipped", "steps_computed",
                     "steps_skipped", "scan_cycles", "pipeline_cycles",
                     "phase2_cycles", "cta_cycles", "max_cta_cycles"),
                    counts))
