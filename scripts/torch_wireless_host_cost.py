"""Seconds per (network, load) of the port's host wireless engine on every
network of `data/wireless_test/`.

Runs `distgcn_tpu_torch.cli.wireless_sim.main --opt=0` (Greedy, DGCN-LGS
with the agent on --device, Benchmark with the exact solver; T=200 slots)
on each network at loads 0.3 and 0.9 with the ERGDPG2 l20 c32 checkpoint,
and prints for each pair the wall seconds, the agent's seconds, the exact
solver's seconds and solves, and how many solves took longer than 0.1 s:
at the engine's 10 s timeout the B&B gives its local search 5% of the
timeout (0.5 s) on every connected core of 40 or more live nodes, and no
solve without it comes near 0.1 s. The last line is one JSON object.

    python scripts/torch_wireless_host_cost.py [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distgcn_tpu_torch.agents import DQNAgent  # noqa: E402
from distgcn_tpu_torch.cli import wireless_sim  # noqa: E402
from distgcn_tpu_torch.sim import wireless as sim_wireless  # noqa: E402
from distgcn_tpu_torch.utils.config import Config  # noqa: E402
from distgcn_tpu_torch.utils.directory import find_model_folder  # noqa: E402

NETS = "data/wireless_test"
LOADS = (0.3, 0.9)
LOCAL_SEARCH_S = 0.1


def argv_for(datapath, load, out, device) -> list:
    return [f"--test_datapath={datapath}", "--wt_sel=qr",
            f"--load_min={load}", f"--load_max={load}", "--load_step=1.0",
            "--num_channels=1", "--training_set=ERGDPG2", "--num_layer=20",
            "--hidden1=32", "--feature_size=1", "--diver_num=1",
            "--max_degree=1", "--predict=mwis", "--model_root=model",
            f"--output={out}", "--opt=0", f"--device={device}"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    names = sorted(f[len("poisson_net_"):-len(".mat")]
                   for f in os.listdir(NETS) if f.endswith(".mat"))
    cfg = Config.from_args(argv_for(NETS, 0.9, ".", args.device))
    agent = DQNAgent(cfg, model_family="gcn_dqn", device=args.device)
    if not agent.load(find_model_folder(cfg, "dqn", "model")):
        raise SystemExit("the ERGDPG2 l20 c32 checkpoint did not load")
    exact_fn = sim_wireless.exact_mod.mwis_exact
    agent_fn = agent.solve_mwis_resident
    pairs = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            for load in LOADS:
                nets = os.path.join(tmp, f"{name}_{load}")
                os.makedirs(nets)
                shutil.copy(os.path.join(NETS, f"poisson_net_{name}.mat"),
                            nets)
                solves, agent_s = [], [0.0]

                def exact_timed(*a, **k):
                    t0 = time.perf_counter()
                    out = exact_fn(*a, **k)
                    solves.append(time.perf_counter() - t0)
                    return out

                def agent_timed(*a, **k):
                    t0 = time.perf_counter()
                    out = agent_fn(*a, **k)
                    agent_s[0] += time.perf_counter() - t0
                    return out

                sim_wireless.exact_mod.mwis_exact = exact_timed
                agent.solve_mwis_resident = agent_timed
                try:
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(io.StringIO()):
                        wireless_sim.main(argv_for(
                            nets, load, os.path.join(nets, "out"),
                            args.device), agent=agent)
                    wall = time.perf_counter() - t0
                finally:
                    sim_wireless.exact_mod.mwis_exact = exact_fn
                    agent.solve_mwis_resident = agent_fn
                s = np.asarray(solves)
                pair = {"net": name, "load": load, "s": wall,
                        "agent_s": agent_s[0], "exact_s": float(s.sum()),
                        "solves": int(s.size),
                        "local_search_solves":
                            int((s > LOCAL_SEARCH_S).sum()),
                        "exact_max_ms": float(s.max() * 1e3)}
                pairs.append(pair)
                print(f"net {name} load {load}: {wall:.3f} s, agent "
                      f"{pair['agent_s']:.4f} s, exact {pair['exact_s']:.4f}"
                      f" s ({pair['solves']} solves, "
                      f"{pair['local_search_solves']} over "
                      f"{LOCAL_SEARCH_S} s, the longest "
                      f"{pair['exact_max_ms']:.3f} ms)", flush=True)
    walls = [p["s"] for p in pairs]
    print(json.dumps({"device": args.device, "pairs": len(pairs),
                      "s_per_pair_median": float(np.median(walls)),
                      "s_per_pair_mean": float(np.mean(walls)),
                      "s_per_pair_max": float(max(walls)),
                      "local_search_solves": sum(
                          p["local_search_solves"] for p in pairs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
