"""distgcn_tpu_torch — PyTorch/CUDA port of `distgcn_tpu` for NVIDIA Hopper.

The JAX package `distgcn_tpu` stays the reference; this package re-implements
its device code in PyTorch, module for module under the same names, and
replaces each of its Pallas TPU kernels with a CUDA kernel written by hand
for `sm_90a`. It imports neither JAX nor anything of `distgcn_tpu`.

Package layout
--------------
core/      GraphBatch (int8 dense padded batches) and dense support builders
ops/       LGS solver: plain PyTorch version + hand-written CUDA kernel
           (`csrc/lgs.cu`, built with nvcc at first use by `ops/_build.py`)
models/    ChebGCN (gcn_dqn / gcn2_dqn families) and its layers
agents     State construction (`build_state_arrays`, `build_features`)
pipeline   Batched GCN -> LGS solve pipelines and `BatchedEvaluator`
sim/       The closed-loop slot scheduler (`make_closed_loop`)
utils/     Config, device selection, `::`-keyed npz parameter io

Every entry point that creates tensors takes a `device` argument and
defaults to CUDA; with no card present it raises unless the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"

from distgcn_tpu_torch.utils.config import Config  # noqa: F401
