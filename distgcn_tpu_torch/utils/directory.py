"""Model / result directory naming conventions.

The port's own copy of `distgcn_tpu/utils/directory.py` (the port imports
nothing of the JAX package).

Re-specifies the reference's `directory.py:5-40` naming scheme so that the
trained model zoo in the reference's `model/` directory resolves identically
(e.g. ``result_IS4SAT_deep_ld1_c32_l1_cheb1_diver1_mwis_dqn``).
"""

from __future__ import annotations

import os

from distgcn_tpu_torch.utils.config import Config


def find_model_folder(cfg: Config, postfix: str, model_root: str = "./model") -> str:
    """Reference: directory.py:33-40."""
    name = "result_{}_deep_ld{}_c{}_l{}_cheb{}_diver{}_{}_{}".format(
        cfg.training_set, cfg.feature_size, cfg.hidden1, cfg.num_layer,
        cfg.max_degree, cfg.diver_num, cfg.predict, postfix)
    path = os.path.join(model_root, name)
    if cfg.snapshot:
        path = os.path.join(path, cfg.snapshot)
    return path


def create_result_folder(cfg: Config, postfix: str) -> str:
    """Reference: directory.py:5-30."""
    if cfg.greedy == 1:
        greedy_string = "_greedy"
    elif cfg.greedy == 2:
        greedy_string = "_greedy_snr{}".format(cfg.snr_db)
    else:
        greedy_string = "_" + cfg.predict
    initstr = "zeros" if cfg.wts_init == "zeros" else ""
    skipstr = "_skip" if cfg.skip else "_no_skip"
    outputfolder = "./res_{:04d}_{}_{}_{}_{}_{}{}{}_{}".format(
        cfg.timeout, cfg.training_set + initstr, cfg.diver_num, cfg.diver_out,
        cfg.backoff_prob, cfg.datapath.split("/")[-1], greedy_string, skipstr,
        postfix)
    os.makedirs(outputfolder, exist_ok=True)
    return outputfolder
