"""The plain side of the benchmark's comparison.

Plain PyTorch written from the published semantics of the scheduler: the
ChebGCN forward (dense supports, and the edge-list form of the large
path), the local greedy search on (weight, -index) keys, and the slot's
arrival, rate, utility and queue arithmetic, with the generator's draws
made again here. Nothing in this package imports the program under test
(`distgcn_tpu_torch`), JAX or the JAX package, and nothing here reads what
the program made: the weights come from the checkpoint file, the graph
from the benchmark's own generator.
"""
