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
agents     State construction and the `MWISSolver` / `DQNAgent` agents
pipeline   Batched GCN -> LGS solve and train pipelines, `BatchedEvaluator`
sim/       The closed-loop slot scheduler and the online training loop
rl/        Losses, TF1-exact Adam, the replay trainer, training checkpoints
cli/       `train_gdpg` (the GDPG trainer's command line)
large.py   The large-graph path; parallel/ the sharded paths
data/, solvers/, compat/
           Own copies of the JAX package's host modules (.mat io and
           dataset generation, greedy MWIS heuristics, the TF1 importer)
utils/     Config, device selection, `::`-keyed npz parameter io, model
           directory names

Every entry point that creates tensors takes a `device` argument and
defaults to CUDA; with no card present it raises unless the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"

from distgcn_tpu_torch.utils.config import Config  # noqa: F401
