#!/usr/bin/env python3
"""Leiden subcluster structure at scale on the port, a port of
scripts/leiden_fidelity.py.

For each size: synthetic residual-like rows with planted subclones go
through step 15's Leiden route as the port runs it (``pca_embed`` and
``knn_indices`` on the device, ``snn_graph`` and the native ``leiden`` on
the host), and the script reports

* gamma = the reference auto resolution (11.98/n)^(1/1.165),
* SNN connected components (a hard lower bound on the partition count for
  any CPM Leiden: merging disconnected communities changes CPM by
  -gamma*n1*n2 < 0),
* the Leiden partition count and its CPM score against the component
  partition's and the planted truth's (a higher score is a partition
  igraph's cluster_leiden would also prefer),
* the purity of the partition with respect to the planted subclones,
* the seconds each size took, the data's synthesis included.

It asserts, at every size, that the Leiden CPM is at least the
components' and the planted partition's.  Prints the reference's table,
then one JSON line with the device and every size's numbers.  Runs on the
CUDA card unless given --device cpu.

    python3 scripts/torch_leiden_fidelity.py [--sizes 1000,5000,20000]
        [--k_planted 6] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from scipy import sparse

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from infercnv_tpu_torch.device import resolve_device  # noqa: E402
from infercnv_tpu_torch.subcluster.distance import knn_indices  # noqa: E402
from infercnv_tpu_torch.subcluster.leiden import (  # noqa: E402
    auto_resolution,
    leiden,
    snn_graph,
)
from infercnv_tpu_torch.subcluster.pca import pca_embed  # noqa: E402

SIZES = "1000,5000,20000"
K_PLANTED = 6
#: neighbours of the kNN graph (run()'s default k_nn)
K_NN = 20


def cpm_score(A, memb, gamma):
    memb = np.asarray(memb)
    score = 0.0
    for m in set(memb.tolist()):
        sel = np.nonzero(memb == m)[0]
        w_in = A[np.ix_(sel, sel)].sum() / 2.0
        nc = sel.size
        score += w_in - gamma * nc * (nc - 1) / 2.0
    return float(score)


def synth(n, k_planted, G=600, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.08, (n, G)).astype(np.float32) + 1.0
    per = n // k_planted
    planted = np.zeros(n, int)
    for c in range(k_planted):
        lo = c * per
        hi = n if c == k_planted - 1 else lo + per
        b0 = (c * 97) % (G - 120)
        x[lo:hi, b0:b0 + 100] += 0.55
        planted[lo:hi] = c
    return x, planted


def measure(n: int, k_planted: int, dev: torch.device) -> dict:
    """One size through the route (leiden_fidelity.py:73-92); the card's
    work ends in a synchronise before the clock is read."""
    t0 = time.perf_counter()
    x, planted = synth(n, k_planted)
    emb = pca_embed(x, n_components=10, device=dev)
    nn = knn_indices(emb, K_NN).cpu().numpy()
    A = snn_graph(nn, n)
    gamma = auto_resolution(n)
    n_comp, comp = sparse.csgraph.connected_components(A, directed=False)
    part = leiden(A, gamma, objective="CPM", seed=0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    pure = all(len(set(planted[part == m].tolist())) == 1 for m in set(part.tolist()))
    row = dict(n=n, gamma=gamma, snn_components=int(n_comp),
               leiden_clusters=len(set(part.tolist())), pure=pure,
               cpm_leiden=cpm_score(A, part, gamma), cpm_components=cpm_score(A, comp, gamma),
               cpm_planted=cpm_score(A, planted, gamma))
    row["seconds"] = time.perf_counter() - t0
    return row


def passed(row: dict) -> bool:
    """The reference's assertion: the Leiden CPM is at least the
    components' and the planted partition's."""
    return (row["cpm_leiden"] >= row["cpm_components"] - 1e-6
            and row["cpm_leiden"] >= row["cpm_planted"] - 1e-6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default=SIZES)
    ap.add_argument("--k_planted", type=int, default=K_PLANTED)
    ap.add_argument("--device", default=None, help="the CUDA card by default; 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"{'n':>7} {'gamma':>10} {'snn_comp':>8} {'k_leiden':>8} "
          f"{'pure':>5} {'cpm_ours':>12} {'cpm_comp':>12} {'cpm_planted':>12} {'sec':>6}")
    rows = []
    for n in [int(s) for s in args.sizes.split(",")]:
        r = measure(n, args.k_planted, dev)
        rows.append(r)
        print(f"{n:>7} {r['gamma']:>10.3e} {r['snn_components']:>8} {r['leiden_clusters']:>8} "
              f"{str(r['pure']):>5} {r['cpm_leiden']:>12.1f} {r['cpm_components']:>12.1f} "
              f"{r['cpm_planted']:>12.1f} {r['seconds']:>6.1f}", flush=True)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"device": device, "sizes": rows}), flush=True)
    failed = [r["n"] for r in rows if not passed(r)]
    if failed:
        print(f"CPM assertion failed at sizes {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
