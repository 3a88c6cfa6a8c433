"""Device selection and the f32 matmul settings of the parity path.

Every entry point of the port takes a ``device`` argument that defaults to
CUDA. Nothing falls back to the CPU on its own: with no card present,
`resolve_device` raises unless the caller asked for the CPU.

The JAX package runs its f32 layers under ``Precision.HIGHEST``; the H100
form of that rule is full-f32 matmuls (no TF32 in cuBLAS or cuDNN).
"""

from __future__ import annotations

import torch


def set_f32_matmul_highest() -> None:
    """Full-precision f32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    set_f32_matmul_highest()
    return dev
