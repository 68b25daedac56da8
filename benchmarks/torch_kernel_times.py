#!/usr/bin/env python3
"""Times of the one-row smooth (TPU kernels 3 and 4) and the Viterbi (TPU
kernel 2) of one checkout, on one CUDA card, each the same way, so that two
checkouts can be compared in one call.

    python3 benchmarks/torch_kernel_times.py [CHECKOUT]

CHECKOUT (default: this repository) is the root of a checkout whose
infercnv_tpu_torch and chip_smoke.py are imported (its kernels built in its
own build/ directory), e.g. an unpacked `git archive` of an earlier commit.
Inputs are made from chip_smoke.SEED on the card: the smooth at [256, 8448]
and [16384, 8448] (bench.py's genome, pyramidal window 101, f32 and bf16
weights); the Viterbi (i6, bench.py's means, sigma 0.25) on the group means
of 16 subclusters packed as the engine packs them, on bench.py's genome
(B = 208, L = 678) and on a 60,000-gene genome (B = 160, L = 6460), and in
cells mode on a 32,768-cell chunk (B = 425,984): the wrapper alone
(`viterbi`, with whatever layout passes it makes) and the engine's packed
call (`viterbi_packed`: gather, wrapper, inverse gather).  Calls of tens of
microseconds are timed as 20 calls in a CUDA graph (device time, "_graph")
and one at a time ("_one_call", host time included); the others with CUDA
events, median of 5 (3 in cells mode).  Prints one JSON line and the card's
name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parents[1]).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np

    import chip_smoke as cs
    from infercnv_tpu_torch.ops import _build, smoothing, viterbi_pack
    from infercnv_tpu_torch.ops import viterbi_kernel as vk
    from infercnv_tpu_torch.ops.layout import smoothing_operator
    from infercnv_tpu_torch.ops.viterbi_pack import PackedLayout

    dev = torch.device("cuda", 0)
    _build.library()

    def graph_ms(fn, n: int = 20) -> float:
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            fn()
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(n):
                fn()
        return cs.time_ms(g.replay) / n

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    res = {"checkout": tree.name, "card": cs.nvidia_smi()}
    go = cs.bench_genome()
    op = smoothing_operator(go, 101)
    x = torch.randn((cs.N_REF, go.num_genes), generator=gen, device=dev)
    xl = torch.randn((16384, go.num_genes), generator=gen, device=dev)
    for bf16 in (False, True):
        w = smoothing.BandWeights.from_operator(op, dev, bf16=bf16)
        k = "bf16" if bf16 else "f32"
        res[f"smooth_{k}_256_graph"] = graph_ms(lambda: smoothing.apply_banded(x, w))
        res[f"smooth_{k}_256_one_call"] = cs.time_ms(lambda: smoothing.apply_banded(x, w))
        res[f"smooth_{k}_16384"] = cs.time_ms(lambda: smoothing.apply_banded(xl, w))
    del xl

    hmm = cs.bench_hmm()
    log_diag, log_off, log_delta = vk.transition_logs(hmm.num_states, hmm.t)
    h = (np.asarray(hmm.means), log_delta, log_diag, log_off)

    def packed(genome, C):
        lay = PackedLayout.from_gene_order(genome)
        gather = torch.as_tensor(lay.gather, dtype=torch.int64, device=dev)
        n_bins, L = gather.shape
        r = 1.0 + 0.2 * torch.randn((C, genome.num_genes), generator=gen, device=dev)
        r[C // 2:, :genome.num_genes // 8] += 0.6
        args = (r[:, gather].reshape(C * n_bins, L).contiguous(),
                torch.as_tensor(lay.valid.sum(axis=1), dtype=torch.int32,
                                device=dev).repeat(C),
                torch.full((C * n_bins,), 0.25, device=dev),
                torch.as_tensor(lay.boundaries, device=dev).repeat(C, 1))
        return args, r, lay

    a, _, _ = packed(go, cs.N_SUB)
    res["viterbi_B208_L678_graph"] = graph_ms(lambda: vk.viterbi(*a, *h))
    res["viterbi_B208_L678_one_call"] = cs.time_ms(lambda: vk.viterbi(*a, *h))
    a, _, _ = packed(cs.human_like_genome(cs.WIDE_GENES), cs.N_SUB)
    res["viterbi_B160_L6460_graph"] = graph_ms(lambda: vk.viterbi(*a, *h), n=5)
    a, r, lay = packed(go, cs.CHUNK)
    sig = torch.full((cs.CHUNK,), 0.25, device=dev)
    res["viterbi_cells_mode_wrapper"] = cs.time_ms(lambda: vk.viterbi(*a, *h), reps=3)
    res["viterbi_cells_mode_packed"] = cs.time_ms(
        lambda: viterbi_pack.viterbi_packed(r, lay, hmm.means, sig, hmm.t), reps=3)
    print(json.dumps(res), flush=True)
    print(res["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
