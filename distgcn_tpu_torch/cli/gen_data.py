"""Dataset generation CLI — port of `distgcn_tpu/cli/gen_data.py`
(the reference's `Data_Generation.py` CLI). Host code only: it calls the
port's `data.generate`, so the files are those of the JAX package for the
same seed.

    python -m distgcn_tpu_torch.cli.gen_data --datapath=./data/out \
        --type=ER --sizes=100,150 --ps=0.05,0.1 --n=10 --dist=uniform \
        [--nbs=10,20]
    python -m distgcn_tpu_torch.cli.gen_data --wireless \
        --datapath=./data/nets --n=20
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True)
    p.add_argument("--type", default="ER", choices=["ER", "BA", "PPP"])
    p.add_argument("--dist", default="uniform")
    p.add_argument("--sizes", default="100")
    p.add_argument("--ps", default="")
    p.add_argument("--nbs", default="", help="avg neighbor counts; p = nb/N")
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--no_label", action="store_true")
    p.add_argument("--wireless", action="store_true",
                   help="generate wireless network gdict instances instead")
    ns, _ = p.parse_known_args(argv)

    if ns.wireless:
        from distgcn_tpu_torch.data.generate import generate_wireless_network
        n = generate_wireless_network(ns.datapath, n_networks=ns.n,
                                      seed=ns.seed)
        print(f"wrote {n} wireless networks to {ns.datapath}")
        return n

    from distgcn_tpu_torch.data.generate import generate_graph_dataset
    sizes = [int(s) for s in ns.sizes.split(",") if s]
    total = 0
    if ns.nbs:
        # Data_Generation.py:224-228: p derived per-size from avg nb count
        nbs = [float(s) for s in ns.nbs.split(",") if s]
        for n_nodes in sizes:
            ps = [round(nb / n_nodes, 3) for nb in nbs]
            total += generate_graph_dataset(
                ns.datapath, ns.type, sizes=[n_nodes], ps=ps,
                n_per_config=ns.n, dist=ns.dist, seed=ns.seed,
                label=not ns.no_label)
    else:
        ps = [float(s) for s in ns.ps.split(",") if s] or [0.1]
        total = generate_graph_dataset(
            ns.datapath, ns.type, sizes=sizes, ps=ps, n_per_config=ns.n,
            dist=ns.dist, seed=ns.seed, label=not ns.no_label)
    print(f"wrote {total} instances to {ns.datapath}")
    return total


if __name__ == "__main__":
    main()
